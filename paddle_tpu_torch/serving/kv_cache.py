"""Paged KV cache: block pools with per-request block tables.

Counterpart of ``paddle_tpu/serving/kv_cache.py``. Per layer the pools
are ``k_pool, v_pool : (num_blocks, H_kv, block_size, D)``; a request's
block table (max_blocks,) int32 says that logical position p lives in
pool block ``table[p // block_size]`` at row ``p % block_size``. Length is
data (positions and tables), never shape. Block 0 is the reserved NULL
block: table padding and masked-token writes land there, and attention
never reads it.

``paged_attention`` routes CUDA tensors to the hand-written kernel and
CPU tensors to the plain version (``ops/cuda/paged.py``), and nothing
else chooses between them. ``write_block_kv`` writes the pools in place,
and so does ``write_block_kv_quant`` for int8 pools: it quantizes each
written row (absmax over D, one f32 scale per row) into the codes pool
and its (N, H_kv, bs) scale pool.

This slice ports the functional ops and the allocator half of
``PagedKVCache`` with its dense and int8 pools; the host tier, sibling
caches, copy-on-write, fleet transfer and meshes wait.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda.paged import (NEG_INF, NULL_BLOCK, gather_block_kv,
                              gather_block_kv_pair, gather_block_scales,
                              paged_attention_cuda,
                              paged_attention_reference)

__all__ = ["PagedKVCache", "paged_attention", "paged_attention_reference",
           "gather_block_kv", "gather_block_kv_pair", "gather_block_scales",
           "write_block_kv", "write_block_kv_quant", "quantize_kv_rows",
           "NULL_BLOCK", "NEG_INF", "KV_QMAX"]

KV_QMAX = 127.0         # symmetric int8 range; -128 is never produced,
                        # so negation stays exact under quantization


def paged_attention(q, k_pool, v_pool, block_table, q_positions,
                    k_scale=None, v_scale=None):
    """Paged attention dispatcher: CUDA tensors launch the hand-written
    kernel (which raises on operands it does not take), CPU tensors take
    the plain version. Nothing else chooses between them.

    q (B, H, C, D); k/v_pool (N, H_kv, bs, D); table (B, M) int32;
    positions (B, C) int32; k/v_scale (N, H_kv, bs) f32 for int8 pools
    -> (B, H, C, D) in the pool dtype (int8 pools: in q's dtype)."""
    if q.is_cuda:
        return paged_attention_cuda(q, k_pool, v_pool, block_table,
                                    q_positions, k_scale, v_scale)
    return paged_attention_reference(q, k_pool, v_pool, block_table,
                                     q_positions, k_scale, v_scale)


def quantize_kv_rows(vals):
    """Symmetric absmax int8 quantization over the LAST axis: one f32
    scale per leading-index row. vals (..., D) float -> (int8 (..., D),
    f32 scales (...)). An all-zero row gets scale 1.0 (not 0: dequant
    must not produce NaN through 0 * inf or 0/0) and quantizes to exact
    zeros either way. torch.round rounds half to even, as jnp.round does,
    so the codes are the JAX package's bit for bit."""
    v = vals.float()
    absmax = v.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / KV_QMAX,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(v / scale[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale


def write_block_kv(pool, vals, block_idx, offset):
    """Scatter vals (S, C, H, D) into pool (N, H, bs, D) at
    (block_idx (S, C), :, offset (S, C), :), IN PLACE, and return the
    pool. The two index tensors are separated by a slice, so the indexed
    view is (S, C, H, D), as in JAX. Masked tokens should be routed to
    (NULL_BLOCK, 0) by the caller; the pool dtype wins."""
    pool[block_idx.long(), :, offset.long(), :] = vals.to(pool.dtype)
    return pool


def write_block_kv_quant(pool, scale_pool, vals, block_idx, offset):
    """write_block_kv for int8 pools, IN PLACE: vals (S, C, H, D) float
    are absmax-quantized per (lane, column, head) row; the int8 codes land
    in pool (N, H, bs, D) and the f32 scales in scale_pool (N, H, bs) at
    the same (block, row) address, so a block id names both halves of its
    data. Returns (pool, scale_pool). Masked tokens route to
    (NULL_BLOCK, 0) like the dense write; the NULL block's codes and
    scales are garbage by design and never read."""
    q, s = quantize_kv_rows(vals)
    bidx, off = block_idx.long(), offset.long()
    pool[bidx, :, off, :] = q
    scale_pool[bidx, :, off] = s
    return pool, scale_pool


class PagedKVCache:
    """Device block pools (one k/v pair per layer) + a host free list.

    Allocation is host-side bookkeeping (ints in a list); the pools keep
    their shapes for the cache's lifetime. Every allocated block carries
    a refcount: `free` is the single-owner release and refuses double
    frees and frees of shared blocks; `unref` returns a block to the
    free list when its last reference drops.

    `num_kv_heads` (GQA) gives the pools H_kv <= H heads; `num_heads`
    stays the query head count. `kv_dtype` selects the pool storage on
    top of `dtype` (the compute dtype the dense path uses):

    - None: dense pools in `dtype`;
    - "bf16": dense bf16 pools, whatever `dtype` says;
    - "int8": int8 pools plus per-row f32 scale pools ("k_scale" and
      "v_scale" beside "k" and "v" in every layer dict, shape
      (num_blocks, H_kv, block_size)). Reads dequantize to `dtype`.

    Every byte count (pool_bytes, scale_bytes, dense_pool_bytes) is at
    the cache's own H_kv geometry, scales included.

    `device` None means the card, and raises without CUDA (as every entry
    point of the port does); pass "cpu" for CPU pools."""

    def __init__(self, num_layers, num_heads, head_dim, num_blocks,
                 block_size=16, dtype=torch.float32, device=None,
                 num_kv_heads=None, kv_dtype=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved NULL)")
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(
                f"kv_dtype {kv_dtype!r}: expected None, 'bf16' or 'int8'")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_kv_heads = (int(num_kv_heads) if num_kv_heads
                             else self.num_heads)
        if self.num_kv_heads < 1 or self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_kv_heads={self.num_kv_heads} must divide "
                f"num_heads={self.num_heads}")
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        # what a dequantized read yields (and what dense pools store)
        self.compute_dtype = (torch.bfloat16 if kv_dtype == "bf16"
                              else dtype)
        self.dtype = torch.int8 if self.quantized else self.compute_dtype
        self.device = resolve_device(device)
        shape = (self.num_blocks, self.num_kv_heads, self.block_size,
                 self.head_dim)

        def make_layer():
            layer = {"k": torch.zeros(shape, dtype=self.dtype,
                                      device=self.device),
                     "v": torch.zeros(shape, dtype=self.dtype,
                                      device=self.device)}
            if self.quantized:
                # scale 1.0, not 0: an unwritten row dequantizes to exact
                # zeros either way, but a zero scale would turn a NaN
                # poisoning of the codes into 0 * NaN = NaN in rows the
                # mask is supposed to neutralize
                for name in ("k_scale", "v_scale"):
                    layer[name] = torch.ones(shape[:3], dtype=torch.float32,
                                             device=self.device)
            return layer

        self.pools = [make_layer() for _ in range(self.num_layers)]
        # LIFO free list; block 0 (NULL) is never handed out
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = {}      # block -> live references (absent = free)

    @property
    def usable_blocks(self):
        return self.num_blocks - 1

    def pool_bytes(self):
        """Bytes of every block pool (k+v across layers), the f32 scale
        pools of int8 pools included."""
        return self.dense_pool_bytes(self.dtype) + self.scale_bytes()

    def scale_bytes(self):
        """Bytes of the (N, H_kv, bs) f32 scale pools across k+v and
        every layer; 0 for dense pools."""
        if not self.quantized:
            return 0
        return (2 * self.num_layers * self.num_blocks * self.num_kv_heads
                * self.block_size * 4)

    def dense_pool_bytes(self, dtype=None):
        """What the same block count would cost dense in `dtype` (default:
        the compute dtype) at this cache's own H_kv geometry: the
        denominator of the quantization ratio. The GQA saving is a
        separate factor, num_heads / num_kv_heads."""
        dt = dtype if dtype is not None else self.compute_dtype
        return (2 * self.num_layers * self.num_blocks * self.num_kv_heads
                * self.block_size * self.head_dim * dt.itemsize)

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_used(self):
        return self.usable_blocks - len(self._free)

    def utilization(self):
        return self.num_used / self.usable_blocks

    def blocks_for_tokens(self, n_tokens):
        return -(-int(n_tokens) // self.block_size)

    def allocate(self, n):
        """n blocks or None (caller backs off; nothing partial)."""
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        for b in taken:
            self._ref[b] = 1
        return taken

    def free(self, blocks):
        """Single-owner release; shared blocks go through unref()."""
        for b in blocks:
            b = int(b)
            if b == NULL_BLOCK:
                raise ValueError("freeing the reserved NULL block")
            c = self._ref.get(b, 0)
            if c == 0:
                raise ValueError(
                    f"double free of block {b}: it is already on the "
                    f"free list")
            if c > 1:
                raise ValueError(
                    f"freeing block {b} while {c - 1} other "
                    f"reference(s) are live; shared blocks are released "
                    f"with unref()")
            del self._ref[b]
            self._free.append(b)

    def ref(self, block):
        """One more reference to an allocated block."""
        block = int(block)
        if block == NULL_BLOCK:
            raise ValueError("ref of the reserved NULL block")
        if block not in self._ref:
            raise ValueError(f"ref of free block {block}")
        self._ref[block] += 1

    def unref(self, block):
        """Drop one reference; True when that freed the block."""
        block = int(block)
        c = self._ref.get(block, 0)
        if c == 0:
            raise ValueError(f"unref of free block {block}")
        if c == 1:
            del self._ref[block]
            self._free.append(block)
            return True
        self._ref[block] = c - 1
        return False

    def refcount(self, block):
        return self._ref.get(int(block), 0)

    def make_table(self, blocks, max_blocks):
        """Host block list -> fixed-width numpy int32 row, NULL-padded
        (the scheduler builds each step's tables on the host)."""
        t = np.full((max_blocks,), NULL_BLOCK, np.int32)
        t[:len(blocks)] = blocks
        return t
