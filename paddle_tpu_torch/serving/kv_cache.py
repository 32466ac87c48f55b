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

Blocks are refcounted, so tables may share them: the prefix cache and
fork groups alias blocks across requests (``fork_table``,
``unref_blocks``), and a write into a shared block goes through
``cow_copy`` first, which copies the block's rows in place across every
layer of this cache and of its siblings (the draft model's pools, which
share its block ids).

The host tier (``enable_host_tier``, a ``HostKVTier``) is a pool of
blocks in host memory with the device pools' geometry: prefix eviction
spills an idle chain's block there instead of destroying it, and
preemption parks a paused request's blocks there. ``spill_block`` and
``swap_in_block`` copy one block's rows, every layer of every holder,
between the tiers in place: no allocation per call.

The fleet moves blocks between caches: ``adopt_block_from`` copies one
block's rows from another cache in place (the disaggregated handoff
between in-process replicas), and ``serialize_block`` /
``deserialize_block`` carry them across processes (the worker
transport), both geometry-checked, scales beside int8 codes.

With ``mesh=`` (a 1-D tensor-parallel mesh, ``parallel/mesh.py``) the
pools shard on the KV head axis: each rank's shard is a contiguous
(N, H_kv/tp, bs, D) tensor of its own (the kernel takes no strided
view), its int8 scale pools (N, H_kv/tp, bs) beside it, held in
``shards`` for the ranks this process computes (every rank of a local
mesh, its own in a world). Only the device layout moves: the free list,
the refcounts and the block tables stay replicated host state, so a
block id names the same rows on every shard, and every block op above
covers every held shard. A block crosses the wire in the JAX package's
head-major (H_kv, bs, D) layout whatever the sender's tp.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda.paged import (NEG_INF, NULL_BLOCK, gather_block_kv,
                              gather_block_kv_pair, gather_block_scales,
                              paged_attention_cuda,
                              paged_attention_reference)

__all__ = ["PagedKVCache", "HostKVTier", "paged_attention",
           "paged_attention_reference",
           "gather_block_kv", "gather_block_kv_pair", "gather_block_scales",
           "write_block_kv", "write_block_kv_quant", "quantize_kv_rows",
           "PagedDecodeLayer", "build_paged_decode_cache",
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


def _dtype_name(dtype):
    """A torch dtype's numpy-style name ("float32", "bfloat16", "int8")."""
    return str(dtype).removeprefix("torch.")


def _one_shard(shards):
    if len(shards) != 1:
        raise ValueError(
            f"this cache holds {len(shards)} head shards (a local "
            f"tensor-parallel mesh): read `shards`, one per-layer pool "
            f"list a rank")
    return shards[0]


def _host_tensor(a):
    """A received blob as a CPU tensor: tensors pass through (the
    transport reads a bf16 blob as one); numpy arrays are wrapped."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class HostKVTier:
    """Host-memory block pool mirroring one PagedKVCache's geometry.

    The same per-layer dict keys as the device pools ("k"/"v", plus
    "k_scale"/"v_scale" for int8) and the same (N, H_kv, bs, D) block
    shape, as host tensors of the device pools' dtype (bf16 stays bf16):
    pinned when the cache lives on the card, so the copies are DMA
    transfers, and plain on the CPU. Eviction under memory pressure
    becomes a device-to-host copy (``PagedKVCache.spill_block``) that
    keeps a prefix chain's KV alive, and a later hit swaps the block
    back in (``swap_in_block``) instead of re-prefilling. Preemption
    parks a paused request's blocks here too: its host blocks are its
    reservation.

    Host block ids are a private namespace: they never enter a block
    table and are never attended, so there is no NULL block and every
    id (0 included) is usable. Single-owner accounting (a host block has
    one owner: a spilled prefix entry or a preempted request), a LIFO
    free list, and a double free raises.

    `_reads` keeps, per host block, the CUDA event recorded after the
    last host-to-device copy that read it: a spill into that block waits
    for it on the launching stream first, so a block freed right after
    its swap-in is never overwritten before the copy has read it."""

    def __init__(self, cache, num_blocks):
        if int(num_blocks) < 1:
            raise ValueError("host tier needs >= 1 block")
        self.num_blocks = int(num_blocks)
        self.block_size = cache.block_size
        shape = (self.num_blocks, cache.num_kv_heads // cache.tp,
                 cache.block_size, cache.head_dim)
        pin = cache.device.type == "cuda"

        def make_layer():
            layer = {name: torch.zeros(shape, dtype=cache.dtype,
                                       pin_memory=pin)
                     for name in ("k", "v")}
            if cache.quantized:
                # scale 1.0 like the device pools: an unwritten row
                # dequantizes to exact zeros without a 0 * NaN hazard
                for name in ("k_scale", "v_scale"):
                    layer[name] = torch.ones(shape[:3],
                                             dtype=torch.float32,
                                             pin_memory=pin)
            return layer

        # one host shard for each device shard the cache holds
        self.shards = [[make_layer() for _ in range(cache.num_layers)]
                       for _ in cache.shards]
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._used = set()
        self._reads = {}

    @property
    def num_free(self):
        return len(self._free)

    @property
    def num_used(self):
        return len(self._used)

    def allocate(self, n):
        """n host blocks or None (nothing partial)."""
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        self._used.update(taken)
        return taken

    def free(self, blocks):
        for b in blocks:
            b = int(b)
            if b not in self._used:
                raise ValueError(
                    f"double free of host block {b}: it is already on "
                    f"the free list")
            self._used.discard(b)
            self._free.append(b)

    @property
    def pools(self):
        """The per-layer host pools of the one shard held (see
        PagedKVCache.pools)."""
        return _one_shard(self.shards)

    def pool_bytes(self):
        """Host bytes of every block pool (k+v across layers, the f32
        scale pools included for int8) of the shards held."""
        return sum(t.numel() * t.element_size() for pools in self.shards
                   for layer in pools for t in layer.values())


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
    the cache's own H_kv geometry, scales included, and logical: what
    the whole mesh holds. `shard_pool_bytes` is one rank's share.

    `mesh` (a 1-D mesh) and `axis` shard the pools on the KV head axis:
    `shards` holds the per-layer pool lists of the ranks this process
    computes (`ranks`), each tensor a contiguous (N, H_kv/tp, bs, D) (or
    (N, H_kv/tp, bs) scale) tensor; `pools` is the one shard a cache
    without a mesh, or a world rank, holds.

    `device` None means the card, and raises without CUDA (as every entry
    point of the port does); pass "cpu" for CPU pools."""

    def __init__(self, num_layers, num_heads, head_dim, num_blocks,
                 block_size=16, dtype=torch.float32, device=None,
                 num_kv_heads=None, kv_dtype=None, mesh=None, axis="tp"):
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
        self.mesh = mesh
        self.axis = axis if mesh is not None else None
        if mesh is not None and len(mesh.axis_names) != 1:
            # one head axis: the per-device ledger rows and the shard byte
            # math (pool / tp each) hold on a 1-D mesh only; data
            # parallelism is separate servers
            raise ValueError(
                f"serving mesh must be 1-D (the head axis); got axes "
                f"{mesh.axis_names}: run data-parallel replicas as "
                f"separate GenerationServers instead")
        if mesh is not None and axis not in mesh.axis_names:
            raise ValueError(
                f"axis {axis!r} is not a mesh axis (mesh has "
                f"{mesh.axis_names}): pass axis=<the mesh's axis name>")
        self.tp = int(mesh.shape[axis]) if mesh is not None else 1
        if self.num_kv_heads % self.tp:
            raise ValueError(
                f"mesh axis {axis!r} size {self.tp} must divide "
                f"num_kv_heads={self.num_kv_heads} (head-sharded pools "
                f"shard the KV heads; with GQA that is H_kv, not the "
                f"{self.num_heads} query heads)")
        self.ranks = mesh.held(axis) if mesh is not None else [0]
        self.heads_local = self.num_kv_heads // self.tp
        shape = (self.num_blocks, self.heads_local, self.block_size,
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

        self.shards = [[make_layer() for _ in range(self.num_layers)]
                       for _ in self.ranks]
        # LIFO free list; block 0 (NULL) is never handed out
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = {}      # block -> live references (absent = free)
        # caches whose pools share this cache's block ids (the draft
        # model's pools under speculative decoding): cow_copy copies
        # their rows too
        self._siblings = []
        self.cow_copies = 0
        # the host tier (enable_host_tier): None until enabled
        self.host = None
        self.host_spills = 0
        self.host_swap_ins = 0

    @property
    def pools(self):
        """The per-layer pool dicts ({"k", "v"[, "k_scale", "v_scale"]})
        of the one shard this cache holds: every head without a mesh,
        this rank's in a world. A local mesh holds one shard a rank, and
        this raises: read `shards`."""
        return _one_shard(self.shards)

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

    def shard_pool_bytes(self):
        """Bytes ONE rank's device commits to the pools: pool_bytes() / tp
        (the head axis divides exactly), the whole pool without a mesh:
        the unit admission watermarks protect."""
        return self.pool_bytes() // self.tp

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

    def fork_table(self, blocks):
        """One more reference on every listed block: a forked lane's
        table adopting another lane's live blocks (the prompt at a group
        fork, a parent beam's table at a beam reorder). No pool bytes
        move. Returns the blocks as a fresh list for the new holder's
        release set."""
        out = [int(b) for b in blocks]
        for b in out:
            self.ref(b)
        return out

    def unref_blocks(self, blocks):
        """unref() each block (releasing a forked lane, whose table mixes
        private blocks with blocks others still hold). Returns how many
        were freed."""
        freed = 0
        for b in blocks:
            if self.unref(b):
                freed += 1
        return freed

    def is_shared(self, block):
        """True when more than one reference is live: a write must copy
        the block first."""
        return self._ref.get(int(block), 0) >= 2

    def attach_sibling(self, sibling):
        """Register a cache whose pools share this cache's block ids (the
        draft pools of speculative decoding): cow_copy keeps its rows
        consistent with every repointed table."""
        if sibling.num_blocks != self.num_blocks \
                or sibling.block_size != self.block_size:
            raise ValueError("a sibling cache needs the same num_blocks "
                             "and block_size")
        self._siblings.append(sibling)
        if self.host is not None:
            # a tier already on: the sibling gets host pools at the same
            # ids, so a spill carries its draft KV along
            sibling.host = HostKVTier(sibling, self.host.num_blocks)

    def cow_copy(self, src, dst):
        """Copy block `src`'s rows into block `dst`, in place, in every
        layer of this cache's pools and of every sibling's: k and v, and
        for int8 pools the k_scale/v_scale rows with them, so a
        repointed block keeps its dequantization state. The NULL block
        is never a source or a destination."""
        src, dst = int(src), int(dst)
        if NULL_BLOCK in (src, dst):
            raise ValueError("copy-on-write of the reserved NULL block")
        for holder in [self] + self._siblings:
            for pools in holder.shards:
                for layer in pools:
                    for arr in layer.values():
                        arr[dst].copy_(arr[src])
        self.cow_copies += 1

    # -- fleet handoff -----------------------------------------------------
    def _geometry(self):
        return (self.num_layers, self.num_heads, self.num_kv_heads,
                self.head_dim, self.block_size)

    def _format(self):
        return ("int8+scales" if self.quantized
                else f"dense {_dtype_name(self.dtype)}")

    def _block_rows(self, block):
        """Block `block`'s rows at full head width: per layer {name:
        (H_kv, bs, D) or (H_kv, bs) scale tensor}, the shards' head
        slices concatenated in rank order. Needs every shard."""
        if len(self.shards) != self.tp:
            raise NotImplementedError(
                f"this cache holds {len(self.shards)} of the {self.tp} "
                f"head shards of its mesh (a world rank): its blocks' "
                f"full rows live across processes, and gathering them is "
                f"not supported")
        if self.tp == 1:
            # one shard: its rows as they lie, no device copy
            return [{n: a[block] for n, a in layer.items()}
                    for layer in self.shards[0]]
        return [{n: torch.cat([pools[li][n][block] for pools in self.shards])
                 for n in self.shards[0][li]}
                for li in range(self.num_layers)]

    def _write_block_rows(self, block, rows):
        """Copy full-width rows (per layer {name: (H_kv, ...) tensor}, as
        _block_rows gives them) into block `block` of every held shard:
        each rank takes its slice of the head axis."""
        hl = self.heads_local
        for pools, r in zip(self.shards, self.ranks):
            for layer, row in zip(pools, rows):
                for name, arr in layer.items():
                    arr[block].copy_(row[name][r * hl:(r + 1) * hl])

    def adopt_block_from(self, src_cache, src_block, dst_block):
        """Pool-slice transfer between caches: copy block `src_block`'s
        rows out of `src_cache`'s pools into this cache's `dst_block`,
        in place, across every layer: the disaggregated prefill/decode
        KV handoff (serving/router.py). One indexed copy per (layer,
        pool entry); k and v, and for int8 pools the k_scale/v_scale
        rows beside the codes. Geometry (layers, heads, KV heads, head
        dim, block size) must match; num_blocks may differ. Sibling
        (draft) pools are not transferred: greedy speculation stays
        exact with a cold draft cache.

        Quantization must match on both sides: int8 codes are
        meaningless without their scale rows, and there is no implicit
        requantize. A dense pair of different float dtypes (a bf16
        prefill tier feeding an f32 decode tier) is a cast. The copies
        are queued on the current stream, behind whatever wrote the
        source rows and ahead of any later write into them, so the
        caller may unpin the source block as soon as this returns."""
        src_kv = getattr(src_cache, "num_kv_heads", src_cache.num_heads)
        if (src_cache.num_layers, src_cache.num_heads, src_kv,
                src_cache.head_dim, src_cache.block_size) != \
                self._geometry():
            raise ValueError(
                f"adopt_block_from needs matching pool geometry; got "
                f"src (L={src_cache.num_layers}, H={src_cache.num_heads},"
                f" H_kv={src_kv}, D={src_cache.head_dim}, "
                f"bs={src_cache.block_size}) vs "
                f"dst (L={self.num_layers}, H={self.num_heads}, "
                f"H_kv={self.num_kv_heads}, D={self.head_dim}, "
                f"bs={self.block_size})")
        if getattr(src_cache, "quantized", False) != self.quantized:
            raise ValueError(
                f"adopt_block_from cannot transfer between a quantized "
                f"and a dense pool: src is {src_cache._format()}, dst is "
                f"{self._format()}: int8 codes are meaningless without "
                f"their scale rows and there is no implicit requantize "
                f"path. Build both tiers with the same kv_dtype")
        self._write_block_rows(int(dst_block),
                               src_cache._block_rows(int(src_block)))

    def wire_geometry(self):
        """The block-shape contract a serialized block travels with:
        receivers validate it before touching their pools (the tuple
        adopt_block_from checks in-process)."""
        return {"num_layers": self.num_layers,
                "num_heads": self.num_heads,
                "num_kv_heads": self.num_kv_heads,
                "head_dim": self.head_dim,
                "block_size": self.block_size,
                "quantized": bool(self.quantized)}

    def serialize_block(self, block):
        """-> (meta, arrays) for block `block`: meta carries the
        wire_geometry and the pool-entry names, arrays is one CPU tensor
        per (layer, name) in that order (int8 codes next to their f32
        scale rows when quantized; bf16 rows stay bf16, which the wire
        format writes under the dtype string "bfloat16"). The byte
        payload of a cross-process adopt_block_from; deserialize_block
        is the receiving half. A tp cache sends the full (H_kv, ...)
        rows, its shards' head slices joined in rank order."""
        names = sorted(self.shards[0][0].keys())
        rows = self._block_rows(int(block))
        arrays = [row[name].to("cpu", copy=True)
                  for row in rows for name in names]
        return {"geometry": self.wire_geometry(), "names": names}, arrays

    def deserialize_block(self, dst_block, meta, arrays):
        """Write a serialize_block payload (tensors, or numpy arrays as
        the wire format reads them) into local block `dst_block`, in
        place, geometry-validated first: a mismatched layout or a
        quantized/dense mix raises adopt_block_from's errors rather than
        writing garbage KV. A dense payload of another float dtype is
        cast."""
        g = meta.get("geometry", {})
        src_geo = (g.get("num_layers"), g.get("num_heads"),
                   g.get("num_kv_heads"), g.get("head_dim"),
                   g.get("block_size"))
        if src_geo != self._geometry():
            raise ValueError(
                f"deserialize_block needs matching pool geometry; got "
                f"src (L={g.get('num_layers')}, H={g.get('num_heads')}, "
                f"H_kv={g.get('num_kv_heads')}, D={g.get('head_dim')}, "
                f"bs={g.get('block_size')}) vs "
                f"dst (L={self.num_layers}, H={self.num_heads}, "
                f"H_kv={self.num_kv_heads}, D={self.head_dim}, "
                f"bs={self.block_size})")
        if bool(g.get("quantized", False)) != self.quantized:
            src_fmt = ("int8+scales" if g.get("quantized")
                       else "dense float")
            raise ValueError(
                f"deserialize_block cannot transfer between a "
                f"quantized and a dense pool: src is {src_fmt}, dst is "
                f"{self._format()}: int8 codes are meaningless without "
                f"their scale rows and there is no implicit requantize "
                f"path. Build both tiers with the same kv_dtype")
        names = list(meta.get("names", ()))
        want = sorted(self.shards[0][0].keys())
        if names != want:
            raise ValueError(
                f"deserialize_block payload names {names} do not match "
                f"this pool's entries {want}")
        expect = self.num_layers * len(names)
        if len(arrays) != expect:
            raise ValueError(
                f"deserialize_block expected {expect} arrays "
                f"({self.num_layers} layers x {len(names)} entries), "
                f"got {len(arrays)}: truncated handoff payload")
        rows = [{name: _host_tensor(arrays[li * len(names) + ni])
                 for ni, name in enumerate(names)}
                for li in range(self.num_layers)]
        self._write_block_rows(int(dst_block), rows)

    # -- host tier ---------------------------------------------------------
    def enable_host_tier(self, num_blocks):
        """Attach a HostKVTier of `num_blocks` host blocks to this cache,
        and one at the same ids to every sibling (a spilled block carries
        its draft KV with it). Host block ids are allocated from this
        cache's tier only; the siblings' tiers are storage at mirrored
        ids. One tier per cache lifetime, like the pools."""
        if self.host is not None:
            raise ValueError(
                "host tier already enabled: it is sized once for the "
                "cache lifetime, like the device pools")
        self.host = HostKVTier(self, num_blocks)
        for sib in self._siblings:
            sib.host = HostKVTier(sib, num_blocks)
        return self.host

    def _holders(self):
        return [h for h in [self] + self._siblings if h.host is not None]

    def _tier_layers(self):
        """(device layer dict, host layer dict) pairs: every layer of
        every held shard of every holder with a tier."""
        for h in self._holders():
            for dev_pools, host_pools in zip(h.shards, h.host.shards):
                yield from zip(dev_pools, host_pools)

    def spill_block(self, block):
        """Device-to-host copy of block `block`'s rows (every layer of
        every holder, scales beside codes for int8) into a fresh host
        block, in place. Returns the host block id, or None when the
        host tier is full (the caller sheds instead). The device block's
        refcount is not touched: the caller decides whether it dies
        (prefix eviction) or the request parks (preemption). The copies
        run on the current stream (behind any swap-in that still reads
        the host block) and have landed when this returns, so the host
        rows can be read at once."""
        if self.host is None:
            raise ValueError("spill_block without enable_host_tier")
        hb = self.host.allocate(1)
        if hb is None:
            return None
        hb = hb[0]
        block = int(block)
        cuda = self.device.type == "cuda"
        if cuda:
            read = self.host._reads.pop(hb, None)
            if read is not None:
                torch.cuda.current_stream(self.device).wait_event(read)
        for dev_layer, host_layer in self._tier_layers():
            for name, arr in dev_layer.items():
                host_layer[name][hb].copy_(arr[block], non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        self.host_spills += 1
        return hb

    def swap_in_block(self, host_block, dst_block):
        """Host-to-device copy of host block `host_block`'s rows into
        device block `dst_block` (every layer of every holder), in
        place, on the current stream. Does not free the host block: its
        owner (a prefix entry or a preemption record) does; the event
        recorded here makes the next spill into it wait for this read."""
        if self.host is None:
            raise ValueError("swap_in_block without enable_host_tier")
        host_block, dst_block = int(host_block), int(dst_block)
        cuda = self.device.type == "cuda"
        for dev_layer, host_layer in self._tier_layers():
            for name, arr in dev_layer.items():
                arr[dst_block].copy_(host_layer[name][host_block],
                                     non_blocking=cuda)
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.host._reads[host_block] = ev
        self.host_swap_ins += 1

    def host_pool_bytes(self):
        """Host bytes of the attached tiers (this cache's and every
        sibling's); 0 with no tier."""
        return sum(h.host.pool_bytes() for h in self._holders())

    def make_table(self, blocks, max_blocks):
        """Host block list -> fixed-width numpy int32 row, NULL-padded
        (the scheduler builds each step's tables on the host)."""
        t = np.full((max_blocks,), NULL_BLOCK, np.int32)
        t[:len(blocks)] = blocks
        return t


# ---------------------------------------------------------------------------
# dense-interface adapter for inference/decoding.py step_fns
# ---------------------------------------------------------------------------

class PagedDecodeLayer:
    """One layer's paged cache behind the dense {"k", "v"} mapping of
    inference/decoding.py's step_fns: ``layer["k"]`` gathers the table's
    blocks into a dense (B, H, M*bs, D) view (positions past t are NULL-
    block rows, masked by the step_fn's own cache_attention_bias), and
    ``decoding.update_kv_cache`` routes to ``paged_update``, which writes
    this step's K/V into its (block, row) slot of the pools IN PLACE, as
    the port's dense update does. A plain class: the JAX adapter is a
    pytree because it rides ``lax.scan`` carries; the port's decode loops
    are Python loops.

    int8 pools compose: with the k/v scale pools attached, ``layer["k"]``
    dequantizes its gathered view to `compute_dtype` (so the step_fn's
    dense math never sees int8) and ``paged_update`` quantizes at write
    (``write_block_kv_quant``)."""

    def __init__(self, k_pool, v_pool, block_table, k_scale=None,
                 v_scale=None, compute_dtype=None):
        self.k_pool = k_pool
        self.v_pool = v_pool
        self.block_table = block_table          # (B, M) int32
        self.k_scale = k_scale                  # (N, H, bs) f32 or None
        self.v_scale = v_scale
        # what a dequantized read yields
        self.compute_dtype = compute_dtype

    def __getitem__(self, key):
        if key not in ("k", "v"):
            raise KeyError(key)
        pool = self.k_pool if key == "k" else self.v_pool
        g = gather_block_kv(pool, self.block_table)
        scale = self.k_scale if key == "k" else self.v_scale
        if scale is None:
            return g
        gs = gather_block_scales(scale, self.block_table)
        cdt = self.compute_dtype or torch.float32
        return (g.float() * gs[..., None]).to(cdt)

    def paged_update(self, k_t, v_t, t):
        """Write this step's K/V (B, H, 1, D) at logical position t (the
        same t for every lane, the decode loops' contract) into the pools
        and return this adapter. The pool dtype wins, as on the dense
        path; int8 pools quantize at write."""
        bs = self.k_pool.shape[2]
        block_idx = self.block_table[:, t // bs].long()      # (B,)
        off = t % bs
        if self.k_scale is not None:
            # (B, H, 1, D) -> the (B, C=1, H, D) rows the shared quantized
            # write takes, at (B, 1) addresses
            bi = block_idx[:, None]
            offs = torch.full_like(bi, off)
            write_block_kv_quant(self.k_pool, self.k_scale,
                                 k_t.transpose(1, 2), bi, offs)
            write_block_kv_quant(self.v_pool, self.v_scale,
                                 v_t.transpose(1, 2), bi, offs)
            return self
        self.k_pool[block_idx, :, off, :] = k_t[:, :, 0, :].to(
            self.k_pool.dtype)
        self.v_pool[block_idx, :, off, :] = v_t[:, :, 0, :].to(
            self.v_pool.dtype)
        return self


def build_paged_decode_cache(cache, batch, max_len):
    """Allocate `batch` rows of `max_len` logical positions out of a
    PagedKVCache (one without a local mesh) and return (layers, tables,
    blocks): `layers` is a list of PagedDecodeLayer, one a layer, a drop-
    in for ``decoding.init_kv_cache``'s under greedy_decode /
    sample_decode step_fns; `tables` the (batch, M) int32 block tables on
    the cache's device; `blocks` the flat allocation to hand back to
    ``cache.free`` afterwards. Raises MemoryError, allocating nothing,
    when the pool cannot hold them."""
    m = cache.blocks_for_tokens(max_len)
    rows, flat = [], []
    for _ in range(batch):
        blocks = cache.allocate(m)
        if blocks is None:
            cache.free(flat)
            raise MemoryError(
                f"paged pool exhausted: {batch} x {m} blocks requested, "
                f"{cache.num_free} free")
        rows.append(cache.make_table(blocks, m))
        flat.extend(blocks)
    tables = torch.from_numpy(np.stack(rows)).to(cache.device)
    layers = [PagedDecodeLayer(p["k"], p["v"], tables, p.get("k_scale"),
                               p.get("v_scale"),
                               compute_dtype=cache.compute_dtype)
              for p in cache.pools]
    return layers, tables, flat
