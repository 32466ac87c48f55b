"""GenerationServer: continuous-batching generation on one device.

Counterpart of ``paddle_tpu/serving/engine.py``. The whole serve loop is
ONE fused prefill/decode step

    fused(pools, tokens (S, C), positions (S, C), valid (S, C),
          tables (S, M), rng, temperature, do_sample, top_k, top_p[, mask])
        -> (next_ids (S,), next_logps (S,), logp rows (S, V))

over S decode slots x C chunk columns whose shapes are fixed for the
server's lifetime: a prefilling lane feeds up to C prompt tokens per
iteration, a decoding lane its one in-flight token (or, in speculative
mode, its token plus up to k draft proposals to verify in the same call,
when every output is per column), an idle lane is masked. Requests of
any length mix in one step, because length is data (positions and
tables). The step is a function of fixed-shape tensors, so it can later
be captured in one CUDA graph.

On the same step: the prefix cache (`prefix_cache=True`, shared prompt
blocks by content hash), speculative decoding (`spec=SpecDecodeConfig`,
a draft model whose pools share the target's tables), fork groups
(`submit(n=K)`: K lanes over one prefill's blocks), paged beam search
(`submit(beam=BeamParams(K))`) and guided decoding
(`submit(guided=<Constraint>)`, an additive mask on the logits). Every
one of them reads KV through the same paged-attention dispatcher.

Around the step: the host KV tier (`host_kv_blocks=N`: lazy admission,
preemption to host memory and resume, prefix spills), request telemetry
(`telemetry=`: span trees, SLO digests, the flight recorder dumped on a
fault), chaos hooks (`chaos=ChaosInjector`), the HBM ledger's rows for
this server (`get_stats()["memory"]`, `/memory`), the ``serving.*``
metrics and a stdlib HTTP endpoint (`serve_metrics`). A non-finite logit
on a live lane fails every request with a ``NonFiniteError`` and closes
the server.

Tensor parallel (``mesh=``, a 1-D mesh of ``parallel/mesh.py``): the
model's params take the Megatron serving layout (``gpt.shard_params``),
the pools shard on the KV head axis, and the one step body runs once for
each rank this process holds (every rank of a local mesh in turn, its
own in a world) on that rank's heads, its pool shard and the paged
kernel; the replicated parts (embeddings, layer norms, LM head, the
choice of ids) run once, and the mesh's ``reduce_fn`` finishes the
o-proj and ffn-down products, two reductions a layer. The scheduler,
the free list and the tables stay replicated host state: in a world,
every rank runs the same submits and steps in lockstep. A mesh server is
greedy: sampling, fork groups, beam, guided decoding, speculation and
int8 weights raise ``NotImplementedError``, as in the JAX package.

``GPTServingModel`` adapts the GPT params (models/gpt.py layout) with
the math of ``gpt.build_kv_step`` over (S, C) ragged lanes; KV goes
through ``kv_cache.write_block_kv`` (or ``write_block_kv_quant`` for int8
pools) and ``kv_cache.paged_attention``, which launches the hand-written
CUDA kernel for CUDA tensors. The q/k/v/o projections, FFN and LM head
are plain products left to ``torch.matmul``; int8 weights
(``GPTServingModel.quantize_int8``) are dequantized inline before them,
as the JAX package leaves that dequant to XLA.
"""

import itertools
import math
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.gpt import (_cast_params, _check_tp, _ln, _one_rank,
                          _to_device, gpt_tp_shardings, load_params,
                          shard_params)
from ..observability import _help
from ..observability.compile_insight import array_nbytes, hbm_ledger
from ..observability.metrics import global_registry
from ..observability.tracing import get_recorder
from ..ops.cuda import paged as _paged
from ..robustness.guard import NonFiniteError
from .decode_strategies import (GroupFuture, RequestGroup, SamplingParams,
                                gumbel_noise)
from .kv_cache import (NEG_INF, NULL_BLOCK, PagedKVCache, paged_attention,
                       write_block_kv, write_block_kv_quant)
from .prefix_cache import PrefixCacheIndex
from .scheduler import ContinuousBatchingScheduler, RequestCancelled, _Request
from .spec_decode import build_draft_step

__all__ = ["GenerationServer", "GenerationFuture", "GPTServingModel",
           "NonFiniteError"]

# HBM-ledger component ids ("serving0", ...): monotonic, never recycled
_SERVER_SEQ = itertools.count()


def _sample_rows(base, rng, temperature, do_top_k, top_p):
    """Stochastic token choice over (S, V) log-prob rows inside the
    fused step: temperature scale, top-k / nucleus filtering, and a
    Gumbel-argmax draw from per-lane counter keys. Every control is data
    ((S,) tensors, 0 meaning top-k off and 2.0 meaning top-p off). The
    filters drop entries strictly below the threshold (`<`), so ties at
    the threshold are kept, as in the reference. Returns (sampled ids
    (S,), their logp under the filtered distribution)."""
    s, v = base.shape
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=base.device)
    scaled = base / temperature.clamp_min(1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(do_top_k > 0, do_top_k,
                        torch.full_like(do_top_k, v)).clamp(1, v)
    kth = torch.gather(sorted_desc, 1, (k_eff - 1).long()[:, None])
    filt = torch.where(scaled < kth, neg, scaled)
    # nucleus over the top-k survivors
    sd = torch.sort(filt, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sd, dim=-1), dim=-1)
    keep = torch.cat([torch.ones((s, 1), dtype=torch.bool,
                                 device=base.device),
                      cum[:, :-1] < top_p[:, None]], dim=-1)
    inf = torch.tensor(float("inf"), device=base.device)
    thresh = torch.where(keep, sd, inf).min(dim=-1, keepdim=True).values
    filt = torch.where(filt < thresh, neg, filt)
    samp = torch.argmax(filt + gumbel_noise(rng, v), dim=-1)
    samp_lp = torch.gather(torch.log_softmax(filt, dim=-1), 1,
                           samp[:, None])[:, 0]
    return samp.to(torch.int32), samp_lp


def _fused_step_body(params, cfg, block_size, h_count, kv_count, d,
                     reduce_fn, pools, tokens, positions, valid, tables,
                     attention, sample_ctl=None, per_column=False,
                     mask=None):
    """The one fused prefill/decode step (build_kv_step's math over
    (S, C) ragged lanes with paged KV), shared by the single-device and
    the tensor-parallel step as gpt._prefill_forward is. `params` is one
    tree and `pools` its per-layer pool list, or on a mesh the held
    ranks' trees (gpt.shard_params) and their pool shards, one list a
    rank; `h_count` / `kv_count` are the query / KV heads one of them
    computes (H and H_kv, or H/tp and H_kv/tp), and `reduce_fn` (None on
    one device) finishes the row-parallel o-proj and ffn-down products
    from the ranks' partials, the only state the ranks share; the
    replicated biases are added after it, once. Writes this step's K/V
    into the pools in place, then projects through the tied LM head:

    - `per_column=False` (plain serving): each lane's LAST valid column
      only, one (S, H) @ (H, V) product. Returns (next_ids (S,) int32,
      chosen logps (S,), logp rows (S, V), None).
    - `per_column=True` (speculative verify): every column, one
      (S*C, H) @ (H, V) product. Returns (next_ids (S, C), chosen logps
      (S, C), logp rows (S, C, V), fed (S, C)): `fed[s, i]` is the target
      logp of the token fed at column i+1 (the draft under verification;
      the last column's value wraps and means nothing).

    `mask` (None, or (S, V) / (S, C, V) f32) is the guided-decoding
    additive mask, 0 / NEG_INF, added to the logits before the
    log-softmax. `sample_ctl` = (rng keys (S, 2), temperature, do_sample,
    top_k, top_p) turns on in-step sampling: lanes with `do_sample` take
    `_sample_rows`' draw (per-column: at column 0, since sampled lanes
    plan no drafts); None is greedy everywhere.

    A layer dict carrying "k_scale"/"v_scale" pools takes the
    quantize-at-write path and hands the scales to `attention`; a layer
    params dict carrying "<w>@q8"/"<w>@scale" entries
    (GPTServingModel.quantize_int8) gets that weight dequantized inline:
    int8 codes times the per-output-channel f32 scale, cast to the
    activation dtype."""
    s, c = tokens.shape
    if not isinstance(params, list):
        params, pools = [params], [pools]
    reduce_fn = reduce_fn or _one_rank
    rep = params[0]                     # the replicated leaves
    wdt = rep["word_emb"].dtype         # activation/compute dtype

    def w(container, name):
        # int8 weight entry -> inline dequant; plain entry -> as-is
        q8 = container.get(name + "@q8")
        if q8 is None:
            return container[name]
        return (q8.float() * container[name + "@scale"]).to(wdt)

    pos = torch.where(valid, positions, torch.zeros_like(positions))
    x = rep["word_emb"][tokens.long()] + rep["pos_emb"][pos.long()]
    # write targets: masked lanes route to the NULL block
    bidx = torch.gather(tables, 1, (pos // block_size).long())
    bidx = torch.where(valid, bidx, torch.full_like(bidx, NULL_BLOCK))
    off = torch.where(valid, pos % block_size, torch.zeros_like(pos))
    for i in range(cfg.num_layers):
        lp0 = rep[f"l{i}"]
        hn = _ln(x, lp0["ln1_s"], lp0["ln1_b"])
        parts = []
        for rp, shard in zip(params, pools):
            lp, layer = rp[f"l{i}"], shard[i]
            kp, vp = layer["k"], layer["v"]
            ks, vs = layer.get("k_scale"), layer.get("v_scale")
            q = (hn @ w(lp, "wq") + lp["bq"]).reshape(s, c, h_count, d)
            k = (hn @ w(lp, "wk") + lp["bk"]).reshape(s, c, kv_count, d)
            v = (hn @ w(lp, "wv") + lp["bv"]).reshape(s, c, kv_count, d)
            if ks is not None:
                write_block_kv_quant(kp, ks, k, bidx, off)
                write_block_kv_quant(vp, vs, v, bidx, off)
            else:
                write_block_kv(kp, k, bidx, off)
                write_block_kv(vp, v, bidx, off)
            o = attention(q.transpose(1, 2).contiguous(), kp, vp, tables,
                          pos, k_scale=ks, v_scale=vs)
            # bf16 pools under an f32 model return bf16: promote, as JAX
            # does
            o = o.transpose(1, 2).reshape(s, c, h_count * d).to(wdt)
            parts.append(o @ w(lp, "wo"))
        x = x + (reduce_fn(parts) + lp0["bo"]).to(x.dtype)
        hn = _ln(x, lp0["ln2_s"], lp0["ln2_b"])
        # exact (erf) gelu
        parts = [F.gelu(hn @ w(rp[f"l{i}"], "f0w") + rp[f"l{i}"]["f0b"])
                 @ w(rp[f"l{i}"], "f1w") for rp in params]
        x = x + (reduce_fn(parts) + lp0["f1b"]).to(x.dtype)
    x = _ln(x, rep["lnf_s"], rep["lnf_b"])
    if per_column:
        # each row of the wide product holds one column's dot products,
        # what the narrow product computes for a last column (the GEMM
        # may sum in another order at another shape)
        vocab = rep["word_emb"].shape[0]
        logits = (x.reshape(s * c, -1) @ rep["word_emb"].T).reshape(
            s, c, vocab)
    else:
        # next token comes from each lane's LAST valid column only
        last = (valid.sum(1) - 1).clamp(0, c - 1)
        xl = x[torch.arange(s, device=x.device), last]
        logits = xl @ rep["word_emb"].T
    logitsf = logits.float()
    if mask is not None:
        logitsf = logitsf + mask
    logp = torch.log_softmax(logitsf, dim=-1)
    nxt = torch.argmax(logp, dim=-1)
    chosen = torch.gather(logp, -1, nxt[..., None])[..., 0]
    nxt = nxt.to(torch.int32)
    fed = None
    if per_column:
        # the target logp of the NEXT fed column's token
        nt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
        fed = torch.gather(logp, -1, nt.long()[..., None])[..., 0]
    if sample_ctl is not None:
        rng, temperature, do_sample, top_k, top_p = sample_ctl
        base = logp[:, 0] if per_column else logp
        samp, samp_lp = _sample_rows(base, rng, temperature, top_k, top_p)
        if per_column:
            nxt[:, 0] = torch.where(do_sample, samp, nxt[:, 0])
            chosen[:, 0] = torch.where(do_sample, samp_lp, chosen[:, 0])
        else:
            nxt = torch.where(do_sample, samp, nxt)
            chosen = torch.where(do_sample, samp_lp, chosen)
    return nxt, chosen, logp, fed


def _narrow(row):
    """A guided mask row narrowed to its lowest allowed token (the chaos
    mask starve)."""
    allowed = np.flatnonzero(row > NEG_INF / 2)
    out = np.full_like(row, np.float32(NEG_INF))
    if allowed.size:
        out[allowed[0]] = 0.0
    return out


class GPTServingModel:
    """models/gpt.py parameters behind the engine's model interface. The
    params (the port's dict of tensors, see gpt.params_from_numpy) are
    cast to `dtype` and moved to `device`; None means the card.
    `attention` is the attention op of the fused step: None is
    kv_cache.paged_attention (the kernel on the card); a test may pass
    the plain version to hold the kernel against it end to end. Its
    signature is paged_attention's, k_scale/v_scale included.

    `shard(mesh, axis)` (the server calls it for `mesh=`) moves the model
    to the tensor-parallel layout: `tp_params` holds the held ranks'
    trees and `params` becomes None (one model per server layout)."""

    def __init__(self, params, cfg, device=None, dtype=None,
                 attention=None):
        self.device = resolve_device(device)
        self.params = _to_device(_cast_params(params, dtype), self.device)
        self.cfg = cfg
        self.num_layers = cfg.num_layers
        self.num_heads = cfg.num_heads
        self.num_kv_heads = getattr(cfg, "kv_heads", None) or cfg.num_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"kv_heads={self.num_kv_heads} must divide "
                f"num_heads={self.num_heads}")
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.max_position = cfg.max_position
        self.kv_dtype = self.params["word_emb"].dtype
        self.attention = attention or paged_attention
        self._int8_weights = 0
        self.mesh = self.mesh_axis = self.tp_params = None
        self.tp = 1

    @classmethod
    def from_scope(cls, scope, cfg, device=None, dtype=None,
                   attention=None):
        """The model over a scope's gpt_* parameters (``gpt.load_params``:
        a trained or loaded Program's scope, a Predictor's)."""
        return cls(load_params(scope, cfg), cfg, device=device, dtype=dtype,
                   attention=attention)

    # the matmul weights a quantize_int8'd layer dict carries as int8
    # codes + scales in place of each (the fused step dequantizes inline)
    INT8_WEIGHT_NAMES = ("wq", "wk", "wv", "wo", "f0w", "f1w")

    def quantize_int8(self):
        """Per-output-channel absmax int8 quantization of every layer's
        matmul weights: each (in, out) weight w becomes "w@q8" int8 codes
        and a "w@scale" (1, out) f32 scale, the absmax over the input
        axis / 127. Embeddings (the word embedding is the LM head too),
        biases and layer norms stay float. Idempotent; never mutates the
        caller's dicts. Returns self."""
        if self._int8_weights:
            return self
        if self.mesh is not None:
            raise NotImplementedError(
                "int8 weights under a mesh are not supported: quantize "
                "before serving single-device")
        self.params = dict(self.params)
        n = 0
        for i in range(self.num_layers):
            lp = dict(self.params[f"l{i}"])
            for name in self.INT8_WEIGHT_NAMES:
                wf = lp.pop(name).float()
                absmax = wf.abs().amax(dim=0, keepdim=True)
                scale = torch.where(absmax > 0, absmax / 127.0,
                                    torch.ones_like(absmax))
                lp[name + "@q8"] = torch.clamp(
                    torch.round(wf / scale), -127, 127).to(torch.int8)
                lp[name + "@scale"] = scale
                n += 1
            self.params[f"l{i}"] = lp
        self._int8_weights = n
        return self

    @property
    def int8_weights(self):
        """Quantized weight-tensor count (0 = dense weights)."""
        return self._int8_weights

    def shard(self, mesh, axis="tp"):
        """The mesh branch of the JAX package's build_fused_step: cut the
        params into the Megatron serving layout (gpt.shard_params) for
        the ranks this process holds along `axis`, and drop the unsharded
        tree. int8 weights raise NotImplementedError (the shard rules
        name the dense weights; int8 KV pools do shard); tp must divide
        the heads, the ffn inner size and the KV heads (ValueError).
        Returns self; a second call with the same mesh is a no-op."""
        if self.mesh is not None:
            if self.mesh is mesh and self.mesh_axis == axis:
                return self
            raise ValueError(
                "this model is already sharded over another mesh: build "
                "one GPTServingModel per server layout")
        if self._int8_weights:
            raise NotImplementedError(
                "int8 weights under a mesh are not supported: the tp "
                "shard rules name the dense weight keys; run int8-weight "
                "servers single-device (int8 KV pools do shard)")
        tp = int(mesh.shape[axis])
        _check_tp(self.cfg, tp)
        self._leaf_bytes = self._tree_leaf_bytes()
        self.tp_params = shard_params(self.params, self.cfg, tp,
                                      mesh.held(axis))
        self.params = None
        self.mesh, self.mesh_axis, self.tp = mesh, axis, tp
        self._reduce = mesh.reduce_fn(axis)
        return self

    def _tree_leaf_bytes(self):
        """(bytes, tp mark) of every leaf of the unsharded tree."""
        marks = gpt_tp_shardings(self.cfg)
        out = []
        for k, v in self.params.items():
            if isinstance(v, dict):
                out += [(array_nbytes(a), marks[k].get(kk, "rep"))
                        for kk, a in v.items()]
            else:
                out.append((array_nbytes(v), marks[k]))
        return out

    def param_bytes(self):
        """Bytes of the whole parameter tree, summed over ranks on a mesh
        (what the mesh holds in total)."""
        leaves = (self._leaf_bytes if self.params is None
                  else self._tree_leaf_bytes())
        return sum(n for n, _m in leaves)

    def param_bytes_per_device(self, mesh=None, axis="tp"):
        """Bytes of the parameter tree ONE device holds under the serving
        layout over `mesh`'s `axis`: sharded leaves split by tp,
        replicated leaves whole. Without a mesh: the whole tree."""
        if mesh is None:
            return self.param_bytes()
        tp = int(mesh.shape[axis])
        leaves = (self._leaf_bytes if self.params is None
                  else self._tree_leaf_bytes())
        return sum(n if m == "rep" else n // tp for n, m in leaves)

    def fused_step(self, block_size, pools, tokens, positions, valid,
                   tables, rng=None, temperature=None, do_sample=None,
                   top_k=None, top_p=None, per_column=False, mask=None):
        """The fused step (`_fused_step_body`): (next_ids, chosen logps,
        logp rows), plus the fed-token logps when `per_column`. `rng`
        (with temperature, do_sample, top_k, top_p) turns on in-step
        sampling; None is greedy. On a mesh (`shard`) `pools` is the
        cache's `shards` and the step is greedy and last-column only:
        sampling, a guided mask and `per_column` raise
        NotImplementedError, as in the JAX package."""
        sample_ctl = (None if rng is None
                      else (rng, temperature, do_sample, top_k, top_p))
        params, reduce_fn = self.params, None
        h, kv = self.num_heads, self.num_kv_heads
        if self.mesh is not None:
            if sample_ctl is not None or mask is not None:
                raise NotImplementedError(
                    "the sampling/guided step under a mesh is not "
                    "supported: run sampled, fork-group and guided "
                    "servers single-device")
            if per_column:
                raise NotImplementedError(
                    "per-column outputs (speculative verify) are not "
                    "supported under a mesh")
            params, reduce_fn = self.tp_params, self._reduce
            h, kv = h // self.tp, kv // self.tp
        with torch.inference_mode():
            out = _fused_step_body(
                params, self.cfg, block_size, h, kv, self.head_dim,
                reduce_fn, pools, tokens, positions, valid, tables,
                self.attention, sample_ctl=sample_ctl,
                per_column=per_column, mask=mask)
        return out if per_column else out[:3]


class GenerationFuture(Future):
    """A Future whose cancel() also tells the scheduler to reclaim the
    request's slot and blocks (generation requests are cancellable
    mid-stream)."""

    def __init__(self, server, request_id):
        super().__init__()
        self._server = server
        self.request_id = request_id

    def cancel(self):
        if self.done():
            return False
        self._server._request_cancel(self.request_id)
        if not super().cancel():
            return False
        self.set_running_or_notify_cancel()     # notify waiters now
        return True


class GenerationServer:
    """Continuous-batching generation engine: submit() from any thread,
    a single worker pumps scheduler iterations, results arrive as
    GenerationResult futures, tokens stream via per-request callbacks.

        server = GenerationServer(GPTServingModel(params, cfg))
        fut = server.submit(prompt_ids, max_new_tokens=32, eos_id=2)
        out = fut.result()          # GenerationResult
        server.close()              # graceful drain

    `device` None means the card and raises without CUDA; it must match
    the model's device. `start=False` skips the worker thread; tests then
    pump `step()` manually. `kv_dtype` selects the KV pool storage
    (PagedKVCache): None stores the model dtype, "int8" stores int8 codes
    with per-row f32 scales and reads them back in the model dtype, and
    "bf16" stores bf16 pools under any model: an f32 model's attention
    scores f32 q against the bf16 keys and returns bf16, which the output
    projection promotes back to f32, as in the JAX package.

    `prefix_cache=True` builds a PrefixCacheIndex over the pool (a built
    one may be passed): prompts that share full chunks share their
    blocks. `spec=SpecDecodeConfig(draft_model, k)` turns on speculative
    decoding; the draft's pools are a PagedKVCache of their own (the
    draft's head geometry, the target's kv_dtype and block ids) that
    shares the target's tables.

    `host_kv_blocks=N` attaches a host tier of N blocks (pinned host
    memory on the card), after the draft's pools so that it mirrors onto
    them: admission turns lazy, a decode lane may be preempted to the
    host and resumed, and prefix eviction spills instead of destroying.
    `telemetry` True (the default) builds a ServingTelemetry from
    `slo_window_s`, `flight_dir`, `flight_capacity` and `deadline_storm`
    (deadline cancels in one iteration that dump the flight recorder);
    False serves without it; an instance is used as given. `chaos=` a
    ChaosInjector whose plan the scheduler and step() consume; when it
    drives the clock and `clock` is None, its clock is the server's.

    `mesh` (a 1-D mesh, parallel/mesh.py) and `mesh_axis` serve tensor
    parallel: the model is sharded (GPTServingModel.shard), the pools
    shard on the KV head axis, and each step runs every held rank's part
    (module docstring). The ledger then has one kv_pool/shard{i} row a
    mesh position, the serving.mesh.* gauges are set, and get_stats()
    gains "mesh" and the scheduler's free_shard_bytes. A world mesh's
    servers, one a process, must get the same submits and steps."""

    def __init__(self, model, *, num_slots=4, block_size=16,
                 num_blocks=None, max_context=None, chunk=4, clock=None,
                 watermark_blocks=0, chaos=None, start=True,
                 telemetry=True, slo_window_s=60.0, flight_dir=None,
                 flight_capacity=256, deadline_storm=3, device=None,
                 kv_dtype=None, prefix_cache=False, spec=None,
                 host_kv_blocks=0, mesh=None, mesh_axis="tp"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.mesh = mesh
        self.mesh_axis = mesh_axis if mesh is not None else None
        if mesh is not None:
            # before anything allocates: the pools, the scheduler
            if mesh_axis not in mesh.axis_names:
                raise ValueError(
                    f"mesh_axis {mesh_axis!r} is not a mesh axis (mesh has "
                    f"{mesh.axis_names}): pass mesh_axis=<the axis name>")
            _check_tp(model.cfg, int(mesh.shape[mesh_axis]))
            if spec is not None:
                raise NotImplementedError(
                    "speculative decoding on a mesh is not supported: run "
                    "spec servers single-device")
        self.block_size = int(block_size)
        max_context = int(max_context or model.max_position)
        if max_context > model.max_position:
            raise ValueError(
                f"max_context {max_context} exceeds the model's "
                f"max_position {model.max_position}")
        if spec is not None:
            dm = spec.draft_model
            if dm.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    f"draft model vocab {dm.cfg.vocab_size} != target "
                    f"vocab {model.cfg.vocab_size}: proposals are fed "
                    f"straight into the target's verify step")
            if dm.device != self.device:
                raise ValueError(f"draft model lives on {dm.device}, "
                                 f"server on {self.device}")
        blocks_per_seq = -(-max_context // self.block_size)
        if num_blocks is None:
            num_blocks = num_slots * blocks_per_seq + 1   # +1: NULL block
        self.cache = PagedKVCache(model.num_layers, model.num_heads,
                                  model.head_dim, num_blocks,
                                  block_size=self.block_size,
                                  dtype=model.kv_dtype, device=self.device,
                                  num_kv_heads=model.num_kv_heads,
                                  kv_dtype=kv_dtype, mesh=mesh,
                                  axis=mesh_axis)
        if mesh is not None:
            model.shard(mesh, mesh_axis)
        if chaos is not None and clock is None and chaos.drives_clock():
            clock = chaos.serving_clock
        # the HBM-ledger component id; the prefix index labels its gauge
        # series with it too
        self._ledger_id = f"serving{next(_SERVER_SEQ)}"
        self._prefix = None
        if prefix_cache:
            self._prefix = (prefix_cache
                            if isinstance(prefix_cache, PrefixCacheIndex)
                            else PrefixCacheIndex(self.cache, chaos=chaos,
                                                  label=self._ledger_id))
        if telemetry is True:
            from ..observability.serving_telemetry import ServingTelemetry
            telemetry = ServingTelemetry(
                clock=clock, window_s=slo_window_s, flight_dir=flight_dir,
                flight_capacity=flight_capacity,
                deadline_storm=deadline_storm)
        elif telemetry is False:
            telemetry = None
        self._tel = telemetry
        self._chaos = chaos
        self._prompt_poison_fired = set()   # chaos prompt plans applied
        self._exporter = None
        self._sched = ContinuousBatchingScheduler(
            self.cache, num_slots=num_slots, chunk=chunk,
            max_context=max_context, clock=clock,
            watermark_blocks=watermark_blocks, chaos=chaos,
            telemetry=telemetry, prefix_cache=self._prefix,
            spec_k=spec.k if spec is not None else 0,
            spec_mode=spec.mode if spec is not None else "greedy",
            spec_seed=spec.seed if spec is not None else 0)
        self._spec = spec
        self._draft = None
        self._draft_cache = None
        self._draft_launches = 0
        # the (shape, dtype) signatures the fused step was called with:
        # the scheduler's static plan shapes keep it at one
        self._signatures = set()
        self._last_signature = None
        if spec is not None:
            # the draft pools mirror the target's block ids (same
            # num_blocks and block_size, the draft's head geometry): one
            # host allocation drives both, and cow_copy copies both
            dm = spec.draft_model
            self._draft_cache = PagedKVCache(
                dm.num_layers, dm.num_heads, dm.head_dim,
                self.cache.num_blocks, block_size=self.block_size,
                dtype=dm.kv_dtype, device=self.device,
                num_kv_heads=dm.num_kv_heads, kv_dtype=kv_dtype)
            self.cache.attach_sibling(self._draft_cache)
            self._draft = build_draft_step(dm, self.block_size, spec.k)
        # the host tier, after the draft attaches: it mirrors onto the
        # draft pools (a parked speculative request keeps its draft KV)
        if host_kv_blocks:
            self.cache.enable_host_tier(int(host_kv_blocks))
        self._vocab = model.cfg.vocab_size
        self.max_context = max_context
        self._register_ledger(num_slots, chunk, kv_dtype)
        self._fault = None
        self._next_rid = 0
        self._rid_lock = threading.Lock()
        self._closed = False
        self._step_lock = threading.Lock()
        self._cv = threading.Condition()
        self._iterations = 0
        reg = global_registry()
        self._m = {name: getattr(reg, kind)(f"serving.{name}",
                                            _help(f"serving.{name}"))
                   for name, kind in (("requests", "counter"),
                                      ("iterations", "counter"),
                                      ("step_ms", "histogram"),
                                      ("queue_depth", "gauge"),
                                      ("active_slots", "gauge"),
                                      ("blocks_in_use", "gauge"))}
        self._worker = None
        if start:
            self._worker = threading.Thread(target=self._serve,
                                            daemon=True)
            self._worker.start()

    def _register_ledger(self, num_slots, chunk, kv_dtype):
        """This server's HBM-ledger rows: the block pools ("kv_pool",
        kind kv_cache), the host tier ("kv_pool_host", kind host_ram:
        host memory, never summed into the resident total), the model's
        parameters, the draft's pools and parameters under speculation,
        and a static peak estimate of the fused step (pools + params +
        S x C x hidden activations per layer). Also the int8 pools'
        serving.kv.quant.* gauges and the tier's serving.kv.tier.*
        gauges, server-labeled. close() retires all of them."""
        model, cache = self.model, self.cache
        kv_bytes = cache.pool_bytes()
        shard_bytes = cache.shard_pool_bytes()
        param_bytes = model.param_bytes()
        param_dev_bytes = model.param_bytes_per_device(self.mesh,
                                                       self.mesh_axis)
        hidden = model.num_heads * model.head_dim
        act_est = num_slots * chunk * hidden * 4 * (2 * model.num_layers
                                                    + 4)
        led = hbm_ledger()
        # "heads" is the pools' physical head count (H_kv under GQA);
        # "q_heads" the model's
        kv_detail = {"layers": model.num_layers,
                     "num_blocks": cache.num_blocks,
                     "block_size": self.block_size,
                     "heads": cache.num_kv_heads,
                     "q_heads": model.num_heads,
                     "head_dim": model.head_dim,
                     "dtype": str(cache.dtype).removeprefix("torch."),
                     "kv_dtype": kv_dtype,
                     "tier": "device"}
        if cache.quantized:
            kv_detail["scale_bytes"] = cache.scale_bytes()
            kv_detail["dense_equiv_bytes"] = cache.dense_pool_bytes()
        if self.mesh is None:
            led.register(self._ledger_id, "kv_pool", "kv_cache", kv_bytes,
                         detail=kv_detail)
        else:
            # one row a mesh position, each its shard's bytes: the rows
            # sum to the pool's logical bytes, never tp x over
            for i, dev in enumerate(self.mesh.devices.flat):
                led.register(self._ledger_id, f"kv_pool/shard{i}",
                             "kv_cache", shard_bytes,
                             detail=dict(kv_detail, device=str(dev),
                                         mesh_index=i, axis=self.mesh_axis,
                                         heads_local=cache.heads_local))
        if cache.host is not None:
            led.register(self._ledger_id, "kv_pool_host", "host_ram",
                         cache.host_pool_bytes(),
                         detail=dict(kv_detail, tier="host",
                                     num_blocks=cache.host.num_blocks))
        led.register(self._ledger_id, "model_params", "params",
                     param_bytes, detail={"source": "serving model",
                                          "per_device_bytes":
                                              param_dev_bytes})
        draft_bytes = 0
        if self._spec is not None:
            dm = self._spec.draft_model
            draft_pool_bytes = self._draft_cache.pool_bytes()
            draft_param_bytes = dm.param_bytes()
            led.register(self._ledger_id, "draft_kv_pool", "kv_cache",
                         draft_pool_bytes,
                         detail={"layers": dm.num_layers,
                                 "num_blocks": cache.num_blocks,
                                 "block_size": self.block_size,
                                 "heads": self._draft_cache.num_kv_heads,
                                 "q_heads": dm.num_heads,
                                 "head_dim": dm.head_dim,
                                 "spec_k": self._spec.k})
            led.register(self._ledger_id, "draft_params", "params",
                         draft_param_bytes,
                         detail={"source": "spec draft model"})
            draft_bytes = draft_pool_bytes + draft_param_bytes
        # per device: one rank's params and pool shard, the replicated
        # activations
        led.register(self._ledger_id, "fused_step", "peak_hbm",
                     param_dev_bytes + shard_bytes + act_est + draft_bytes,
                     detail={"source": "static",
                             "activation_bytes_est": act_est,
                             "per_device": True})
        reg = global_registry()
        # the mesh's capacity facts: the tp degree, what one device
        # commits to the pools, the reductions a step pays
        self._mesh_gauges = None
        if self.mesh is not None:
            self._mesh_gauges = {
                "serving.mesh.axis_size": cache.tp,
                "serving.mesh.shard_pool_bytes": shard_bytes,
                "serving.mesh.psums_per_step": 2 * model.num_layers}
            for name, val in self._mesh_gauges.items():
                reg.gauge(name, _help(name)).labels(
                    server=self._ledger_id).set(val)
        self._quant_gauges = None
        if cache.quantized:
            self._quant_gauges = {
                "serving.kv.quant.pool_bytes": kv_bytes,
                "serving.kv.quant.bytes_saved":
                    cache.dense_pool_bytes() - kv_bytes}
            for name, val in self._quant_gauges.items():
                reg.gauge(name, _help(name)).labels(
                    server=self._ledger_id).set(val)
        self._tier_gauges = None
        if cache.host is not None:
            self._tier_gauges = {
                name: reg.gauge(name, _help(name)).labels(
                    server=self._ledger_id)
                for name in ("serving.kv.tier.host_blocks",
                             "serving.kv.tier.spills",
                             "serving.kv.tier.swap_ins",
                             "serving.kv.tier.preempts",
                             "serving.kv.tier.resumes",
                             "serving.kv.tier.reprefills_avoided")}
            self._tier_gauges["serving.kv.tier.host_blocks"].set(
                cache.host.num_blocks)
            self._publish_tier_gauges()

    # -- client surface ----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=32, eos_id=None,
               priority=0, deadline_ms=None, stream=None, trace_ctx=None,
               tenant=None, n=1, sampling=None, beam=None, guided=None):
        """prompt_ids: 1-D int token ids. Returns a GenerationFuture
        resolving to a GenerationResult (or raising DeadlineExceeded /
        RequestCancelled). `stream(request_id, token)` fires on the
        serve thread for every generated token. Lower `priority` values
        run first (FIFO within a priority). `trace_ctx` (an object with
        `trace_id`, `hop` and `sampled`) puts a caller's trace id on the
        request's span tree, and its sampling verdict wins over this
        server's. `tenant` is an opaque cost-attribution identity
        (get_stats()["tenants"], /tenants); it never affects scheduling
        or ids.

        - `sampling=SamplingParams(...)`: stochastic decode (temperature,
          top-k, nucleus; counter-keyed, so replays resample alike).
        - `n=K` (or SamplingParams(n=K)) forks the request into K lanes
          sharing the prompt's KV: one prefill, K streams. Returns a
          GroupFuture resolving to a GroupResult (lane rank r's stream
          callbacks fire with GroupFuture.lane_rids[r]).
        - `beam=BeamParams(beam_size=K)`: paged beam search (requires
          eos_id; excludes sampling, n and stream; its ids are the dense
          inference.decoding.beam_decode's).
        - `guided=<Constraint>` (serving.guided) masks every emission to
          the constraint's allowed set (requires eos_id; composes with
          sampling and fork groups)."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = int(prompt.size) + int(max_new_tokens)
        if total > self.max_context:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) = {total} exceeds max_context "
                f"{self.max_context}")
        need = self.cache.blocks_for_tokens(total)
        if need > self.cache.usable_blocks:
            raise ValueError(
                f"request needs {need} blocks but the pool only has "
                f"{self.cache.usable_blocks}")
        if sampling is not None and not isinstance(sampling,
                                                   SamplingParams):
            raise TypeError("sampling must be a SamplingParams")
        n = int(n)
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if beam is not None:
            if sampling is not None or n != 1:
                raise ValueError(
                    "beam search excludes sampling/n: beams are ranked "
                    "deterministically by cumulative logprob")
            if stream is not None:
                raise ValueError(
                    "beam search cannot stream: a beam reorder rewrites "
                    "lane streams retroactively")
            if eos_id is None:
                raise ValueError(
                    "beam search requires eos_id (finished-hypothesis "
                    "masking is defined by it)")
            if self._spec is not None and self._spec.mode == "rejection":
                raise NotImplementedError(
                    "beam search composes with greedy speculative "
                    "verification only")
        if n > 1:
            if sampling is None:
                sampling = SamplingParams(n=n)
            elif sampling.n not in (1, n):
                raise ValueError(
                    f"n={n} conflicts with SamplingParams(n="
                    f"{sampling.n})")
        k = beam.beam_size if beam is not None else \
            max(n, sampling.n if sampling is not None else 1)
        if self.mesh is not None and (
                beam is not None or guided is not None or k > 1
                or (sampling is not None and sampling.do_sample)):
            raise NotImplementedError(
                "decode strategies (sampling, n > 1, beam, guided) are "
                "not supported on a mesh: its step is greedy; run them "
                "on a single-device server")
        if guided is not None and eos_id is None:
            raise ValueError(
                "guided decoding requires eos_id (constraint completion "
                "is signalled by unmasking eos)")
        if k > 1:
            if k > self._sched.num_slots:
                raise ValueError(
                    f"fork group of {k} lanes exceeds num_slots="
                    f"{self._sched.num_slots}: the group admits "
                    f"atomically and could never fit")
            m_prompt = self.cache.blocks_for_tokens(int(prompt.size))
            worst = need + (k - 1) * (need - m_prompt) + k
            if worst > self.cache.usable_blocks:
                raise ValueError(
                    f"fork group needs up to {worst} blocks but the "
                    f"pool only has {self.cache.usable_blocks}")
            return self._submit_group(
                prompt, int(max_new_tokens), eos_id, priority,
                deadline_ms, stream, trace_ctx, tenant, k,
                sampling if beam is None else None, beam, guided)
        rid = self._take_rids(1)[0]
        if self._tel is not None:
            # before the enqueue: the worker may admit the request at
            # once, and on_admit needs the submit stamp
            self._tel.on_submit(rid, ctx=trace_ctx, tenant=tenant)
        fut = GenerationFuture(self, rid)
        now = self._sched.now()
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        req = _Request(rid, prompt, int(max_new_tokens), eos_id, priority,
                       deadline, stream, fut, now, tenant=tenant,
                       sampling=sampling, guided=guided)
        if guided is not None:
            req.guided_state = guided.initial_state()
        self._enqueue(req)
        return fut

    def _take_rids(self, k):
        with self._rid_lock:
            if self._closed:
                raise RuntimeError("GenerationServer is closed")
            rids = list(range(self._next_rid, self._next_rid + k))
            self._next_rid += k
        return rids

    def _enqueue(self, req):
        self._sched.enqueue(req)
        with self._rid_lock:
            raced_closed = self._closed
        if raced_closed:
            # lost the race with close(): its queue sweep may have run
            # before this enqueue landed
            self._sched.drop_queued_request(
                req.rid, self._fault or
                RequestCancelled("GenerationServer is closed"))
            raise RuntimeError("GenerationServer is closed")
        self._m["requests"].inc()
        with self._cv:
            self._cv.notify()

    def _submit_group(self, prompt, max_new_tokens, eos_id, priority,
                      deadline_ms, stream, trace_ctx, tenant, k, sampling,
                      beam, guided):
        """Build and enqueue one RequestGroup: K lane requests (rank 0,
        the leader, is the only one queued; the scheduler admits the
        whole group off it) and one GroupFuture. Beam lanes carry eos on
        the group, never on the lane (finished hypotheses pad with forced
        eos instead of retiring, as the dense reference does), and never
        stream."""
        kind = "beam" if beam is not None else "sample"
        rids = self._take_rids(k)
        if self._tel is not None:
            for rid in rids:
                # one on_submit a lane: tenant billing counts every
                # lane's tokens
                self._tel.on_submit(rid, ctx=trace_ctx, tenant=tenant)
        group = RequestGroup(rids[0], kind, k, eos_id, max_new_tokens,
                             sampling=sampling, beam=beam)
        fut = GroupFuture(rids[0], rids,
                          cancel_fn=lambda: [self._request_cancel(r)
                                             for r in rids])
        group.future = fut
        now = self._sched.now()
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        for rank, rid in enumerate(rids):
            req = _Request(rid, prompt, max_new_tokens,
                           None if kind == "beam" else eos_id, priority,
                           deadline, None if kind == "beam" else stream,
                           Future(), now, tenant=tenant, group=group,
                           lane=rank, sampling=sampling, guided=guided)
            if guided is not None:
                req.guided_state = guided.initial_state()
            group.lanes.append(req)
        self._enqueue(group.lanes[0])
        return fut

    def _request_cancel(self, rid):
        self._sched.request_cancel(rid)
        with self._cv:
            self._cv.notify()

    def pending(self):
        return self._sched.queue_depth + self._sched.active_count

    # -- serve loop --------------------------------------------------------
    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def step(self):
        """Run one scheduler iteration + fused device step. Returns True
        if any lane did work."""
        with self._step_lock:
            tel = self._tel
            if tel is not None:
                # before plan(): the iteration's deadline cancels fire
                # inside it and belong to this iteration's flight entry
                tel.begin_iteration(self._sched.iteration + 1)
            admitted0 = self._sched.counts["admitted"]
            it0 = self._sched.iteration
            plan = self._sched.plan()
            self._publish_gauges()
            if plan is None:
                it = self._sched.iteration
                if it > it0:
                    self._idle_iteration(it, admitted0)
                return False
            it = self._sched.iteration
            lanes = plan.lanes_detail
            t0 = time.perf_counter()
            with get_recorder().span(
                    "serving.iteration", cat="serving",
                    args={"iteration": it, "lanes": len(plan.slot_ids),
                          "prefill_tokens": plan.prefill_tokens}):
                if self._chaos is not None:
                    self._chaos_poison(it, lanes)
                # speculative mode: the draft step runs every iteration
                # (its KV tracks prefill chunks too) and its proposals
                # land in plan.tokens columns 1..q-1 before the target
                # verifies them
                draft_logps = None
                if self._draft is not None:
                    draft_logps = self._run_draft(plan)
                per_column = self._spec is not None
                host = (plan.tokens, plan.positions, plan.valid,
                        plan.tables)
                # recorded only when the plan's shapes change
                sig = tuple((a.shape, a.dtype) for a in host)
                if sig != self._last_signature:
                    self._last_signature = sig
                    self._signatures.add(tuple((shape, dtype.str)
                                               for shape, dtype in sig))
                feed = [self._tensor(a) for a in host]
                if self.mesh is None:
                    do_sample, temperature, top_k, top_p, keys = \
                        plan.sample_ctl
                    out = self.model.fused_step(
                        self.block_size, self.cache.pools, *feed,
                        self._tensor(keys.astype(np.int64)),
                        self._tensor(temperature), self._tensor(do_sample),
                        self._tensor(top_k), self._tensor(top_p),
                        per_column=per_column,
                        mask=self._guided_mask(plan))
                else:
                    # the greedy step over every held rank's pool shard
                    out = self.model.fused_step(self.block_size,
                                                self.cache.shards, *feed)
                nxt, logps = out[0].cpu().numpy(), out[1].cpu().numpy()
                if not per_column:
                    # commit() reads per-column arrays; a broadcast view
                    # puts the last-valid-column value at every column
                    s, c = plan.tokens.shape
                    nxt = np.broadcast_to(nxt[:, None], (s, c))
                    logps = np.broadcast_to(logps[:, None], (s, c))
                # the fed-token logps matter to rejection acceptance
                # only, and the full logp rows to a group's fork or a
                # beam step: each is copied to the host only when asked
                fed = (out[3].cpu().numpy() if per_column
                       and self._spec.mode == "rejection" else None)
                rows = out[2].cpu().numpy() if plan.needs_rows else None
            # non-finite logits guard: one reduce on the hot path; the
            # per-slot triage runs only on a trip, before commit()
            # streams garbage tokens to clients. It runs with telemetry
            # off too (only the flight dump needs telemetry)
            if not math.isfinite(float(logps.sum())):
                if not np.all(np.isfinite(logps[plan.slot_ids])):
                    self._on_engine_fault(plan, it, logps, lanes)
            retired = self._sched.commit(plan, nxt, logps, fed_logps=fed,
                                         draft_logps=draft_logps,
                                         rows=rows)
            self._iterations += 1
            self._m["iterations"].inc()
            step_ms = (time.perf_counter() - t0) * 1e3
            self._m["step_ms"].observe(step_ms)
            self._publish_gauges()
            if tel is not None:
                st = self._sched
                # one ITER_FIELDS-order tuple an iteration (a tuple of
                # scalars adds no GC work)
                tel.end_iteration(it, (
                    round(step_ms, 3),              # step_ms
                    tuple(plan.slot_ids),           # lanes
                    tuple(plan.emitting),           # emitting
                    plan.prefill_tokens,
                    st.counts["admitted"] - admitted0,
                    tuple(r.request_id for r in retired),
                    plan.queue_depth,
                    len(plan.slot_ids),             # active_slots
                    self.cache.num_free,            # blocks_free
                    self.cache.num_used,            # blocks_in_use
                    st.watermark_blocks,
                    lanes,                          # lanes_detail
                    _paged.LAUNCHES))               # kernel launches
            return True

    def _idle_iteration(self, it, admitted0):
        """An iteration the scheduler counted but in which no lane ran
        (cancels or deadlines only): a chaos poison keyed to it moves to
        the next iteration, and the flight ring and the deadline-storm
        detector still see it."""
        if self._chaos is not None:
            layer = self._chaos.serving_poison_at(it)
            if layer is not None:
                self._chaos.poison_serving_at(it + 1, layer)
        if self._tel is not None:
            self._tel.end_iteration(
                it, step_ms=0.0, lanes=[], emitting=[], prefill_tokens=0,
                admitted=self._sched.counts["admitted"] - admitted0,
                retired=[], queue_depth=self._sched.queue_depth,
                active_slots=self._sched.active_count,
                blocks_free=self.cache.num_free,
                blocks_in_use=self.cache.num_used,
                watermark_blocks=self._sched.watermark_blocks,
                lanes_detail=[], kernel=_paged.LAUNCHES)

    def _chaos_poison(self, it, lanes):
        """The chaos poisons of this iteration, before the fused step: a
        standing poison keyed to a prompt's bytes (applied at most once
        per plan entry and server: the fault closes the server) and the
        iteration's poison of the oldest lane past position 0, deferred
        to the next iteration while no lane qualifies (a position-0
        lane's block is overwritten by its own prefill write)."""
        chaos = self._chaos
        for pi, (pp, pl) in enumerate(chaos.prompt_poison_plan()):
            if pi in self._prompt_poison_fired:
                continue
            blk = self._sched.lane_block_for_prompt(pp)
            if blk is not None:
                self._nan_block(pl, blk)
                self._prompt_poison_fired.add(pi)
                chaos.prompt_poison_applied()
        layer = chaos.serving_poison_at(it)
        if layer is not None:
            if self._poison_kv(layer, lanes):
                chaos.serving_poison_applied()
            else:
                chaos.poison_serving_at(it + 1, layer)

    def _run_draft(self, plan):
        """One draft-step call: sync the draft KV with this iteration's
        feed, roll out k proposals a decode lane, and write them into
        plan.tokens columns 1..q-1 for the verify step. Returns the
        draft's proposal logps (S, k) for rejection acceptance.

        The sync pass feeds prefill chunks as planned, and for a decode
        lane fed at pos the tokens at pos - 1 and pos. The JAX package
        feeds the committed token alone; but the rollouts write the KV of
        proposals d_1..d_{k-1} only, so after a burst whose k proposals
        were all accepted, position pos - 1 (d_k) holds no draft KV, and
        the draft's next proposals attend a stale row. Re-feeding it
        rewrites what the rollouts wrote otherwise (the same token at the
        same position)."""
        tokens_d = plan.tokens.copy()
        positions_d = plan.positions.copy()
        valid_d = plan.valid.copy()
        for sid in plan.slot_ids:
            if int(plan.decode_cols[sid]) >= 1:
                pos = int(plan.positions[sid, 0])
                tokens_d[sid, :2] = (plan.prev_tokens[sid],
                                     plan.tokens[sid, 0])
                positions_d[sid, :2] = (pos - 1, pos)
                valid_d[sid, :2] = True
                valid_d[sid, 2:] = False
        l0 = _paged.LAUNCHES
        props, dlps = self._draft(
            self._draft_cache.pools, self._tensor(tokens_d),
            self._tensor(positions_d), self._tensor(valid_d),
            self._tensor(plan.tables), self._tensor(plan.decode_cols >= 1),
            self._tensor(plan.limits))
        props = props.cpu().numpy()
        self._draft_launches += _paged.LAUNCHES - l0
        for sid in plan.slot_ids:
            q = int(plan.decode_cols[sid])
            if q > 1:
                plan.tokens[sid, 1:q] = props[sid, :q - 1]
        return dlps.cpu().numpy()

    def _guided_mask(self, plan):
        """The guided-decoding additive mask of one iteration, (S, V) or
        per column (S, C, V), 0 / NEG_INF rows for constrained lanes and
        zeros elsewhere; None when no lane of the plan is constrained
        (adding zeros changes no logit). In per-column mode a guided
        lane's verify columns are masked under a scratch automaton state
        advanced through the fed drafts (the real state advances only on
        commit). A chaos mask starve narrows every guided row to its
        lowest allowed token: conformance holds, the loop must go on."""
        if not plan.guided_lanes:
            return None
        s, c = plan.tokens.shape
        per_col = self._spec is not None
        mask = np.zeros((s, c, self._vocab) if per_col
                        else (s, self._vocab), np.float32)
        starve = (self._chaos is not None
                  and self._chaos.mask_starves_at(self._sched.iteration))
        starved_any = False
        for sid, req in plan.guided_lanes:
            state = req.guided_state
            if state is None:
                continue        # dead automaton: unconstrained
            eos = req.eos_id if req.group is None else req.group.eos_id
            row = req.guided.mask_row(state, eos)
            if starve:
                row = _narrow(row)
                starved_any = True
            if not per_col:
                mask[sid] = row
                continue
            q = int(plan.decode_cols[sid])
            if q == 0:
                # prefill lane: only its last valid column is read
                mask[sid, :] = row
                continue
            mask[sid, 0] = row
            st = state
            for j in range(1, q):
                if st is not None:
                    st = req.guided.advance(st, int(plan.tokens[sid, j]))
                if st is not None:
                    row = req.guided.mask_row(st, eos)
                mask[sid, j] = row      # dead: repeat the last mask
        if starved_any:
            self._chaos.mask_starve_applied()
        return self._tensor(mask)

    def _nan_block(self, layer, block):
        """Chaos primitive: make `block`'s keys read as NaN in `layer`,
        in place. Dense pools take the NaN in the k rows; int8 pools in
        the k_scale rows (an int8 code cannot hold NaN, and NaN times
        any code dequantizes to NaN), so the poison goes through the
        same attention arithmetic on both layouts. Every held head shard
        takes it."""
        for pools in self.cache.shards:
            pool = pools[layer]
            pool["k_scale" if "k_scale" in pool else "k"][block] = \
                float("nan")

    def _poison_kv(self, layer, lanes):
        """Chaos hook: NaN the first KV block of the oldest active lane
        past position 0 (every later position attends it, so the NaN
        reaches that lane's logits this iteration). False when no lane
        qualifies; the caller defers."""
        lanes = lanes if lanes is not None else self._sched.lane_snapshot()
        # LANE_FIELDS order: (slot, rid, pos, prefilling, admit_seq,
        # generated, first_block, ...)
        victims = sorted((ln for ln in lanes if ln[2] >= 1),
                         key=lambda ln: ln[4])
        if not victims:
            return False
        self._nan_block(layer, victims[0][6])
        return True

    def _on_engine_fault(self, plan, iteration, logps, lanes):
        """A fused step gave non-finite logits on a live lane: dump the
        flight recorder (its last entry is this iteration, marked with
        the fault), fail every outstanding request, close, and raise a
        NonFiniteError carrying `bad_rids` (the requests whose lanes went
        non-finite) and `flight_dump`. A poisoned pool is unrecoverable,
        and fail-stop beats serving garbage."""
        bad = [int(s) for s in plan.slot_ids
               if not np.all(np.isfinite(logps[s]))]
        if lanes is None:       # telemetry off: the plan has no lanes
            lanes = self._sched.lane_snapshot()
        by_slot = {ln[0]: ln for ln in lanes}
        bad_rids = [by_slot[s][1] for s in bad if s in by_slot]
        dump = None
        if self._tel is not None:
            self._tel.flight.record(
                iteration, kind="iteration", aborted=True,
                lanes=list(plan.slot_ids), emitting=sorted(plan.emitting),
                prefill_tokens=plan.prefill_tokens, lanes_detail=lanes,
                blocks_free=self.cache.num_free,
                blocks_in_use=self.cache.num_used, kernel=_paged.LAUNCHES)
            dump = self._tel.fault(iteration, "non_finite_logits",
                                   {"bad_slots": bad, "bad_rids": bad_rids,
                                    "iteration": iteration})
        err = NonFiniteError(f"serving.logits[slot {bad[0]}]", iteration,
                             [f"serving.logits[slot {s}]" for s in bad])
        err.flight_dump = dump
        err.bad_rids = bad_rids
        self._fault = err
        with self._rid_lock:
            self._closed = True
        self._sched.cancel_all(err)
        raise err

    def run_until_idle(self, max_iterations=100000):
        """Pump step() until no lane has work (manual-drive mode)."""
        n = 0
        while self.step():
            n += 1
            if n >= max_iterations:
                raise RuntimeError(
                    f"serving loop did not drain in {max_iterations} "
                    f"iterations")
        return n

    def _serve(self):
        while True:
            try:
                did = self.step()
            except NonFiniteError:
                return      # every future already holds the error
            if did:
                continue
            with self._cv:
                if self._closed:
                    return
                if not self._sched.has_work():
                    # short timeout: queued deadlines under a real clock
                    # must still fire while the pool idles
                    self._cv.wait(timeout=0.05)

    def _publish_gauges(self):
        st = self._sched
        self._m["queue_depth"].set(st.queue_depth)
        self._m["active_slots"].set(st.active_count)
        self._m["blocks_in_use"].set(self.cache.num_used)
        self._publish_tier_gauges()

    def _publish_tier_gauges(self):
        if self._tier_gauges is None:
            return
        g = self._tier_gauges
        g["serving.kv.tier.spills"].set(self.cache.host_spills)
        g["serving.kv.tier.swap_ins"].set(self.cache.host_swap_ins)
        g["serving.kv.tier.preempts"].set(self._sched.preempts)
        g["serving.kv.tier.resumes"].set(self._sched.resumes)
        g["serving.kv.tier.reprefills_avoided"].set(
            self._prefix.counts["reprefills_avoided"]
            if self._prefix is not None else 0)

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain=True, timeout=60):
        """Stop accepting submits; by default finish every in-flight and
        queued request first (graceful drain), then stop the worker.
        drain=False fails outstanding requests instead. Either way, and
        also after a fault stopped the server, the endpoint closes and
        this server's ledger rows and gauge series are retired."""
        with self._rid_lock:
            already = self._closed
            if not already:
                if not drain:
                    self._sched.cancel_all(RequestCancelled(
                        "GenerationServer closed without drain"))
                self._closed = True
        if not already:
            if self._worker is not None:
                deadline = time.monotonic() + timeout
                while drain and self._sched.has_work() and \
                        time.monotonic() < deadline:
                    with self._cv:
                        self._cv.notify()
                    time.sleep(0.01)
                with self._cv:
                    self._cv.notify()
                self._worker.join(timeout=max(0.0,
                                              deadline - time.monotonic()))
            elif drain:
                self.run_until_idle()
            self._publish_gauges()
        self._retire()

    def _retire(self):
        """Close the endpoint and retire this server's SLO gauges, ledger
        rows, serving.mesh.* / serving.kv.quant.* / serving.kv.tier.*
        gauges and prefix gauge (idempotent): a closed or faulted server must not keep
        reporting live bytes or window quantiles."""
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None
        if self._tel is not None:
            self._tel.close()
        hbm_ledger().retire(self._ledger_id)
        reg = global_registry()
        for gauges in (self._mesh_gauges, self._quant_gauges,
                       self._tier_gauges):
            for name in gauges or ():
                reg.gauge(name).remove(server=self._ledger_id)
        self._mesh_gauges = self._quant_gauges = self._tier_gauges = None
        if self._prefix is not None:
            self._prefix.drop_gauges()

    def get_stats(self):
        """Scheduler + engine stats: `iterations` counts fused steps run,
        `kernel.launches` is the paged-attention wrapper's process-wide
        launch count since its last reset (one per layer per step on the
        card, 0 on the CPU). `kv_quant` (None for dense pools) gives the
        int8 pools' true bytes, scales included, beside what the same
        blocks would cost dense in the compute dtype. `prefix` (None
        without a prefix cache) holds the index's hits, misses,
        shared_blocks, evictions, cow_copies, spills and swap-ins; `spec`
        (None without speculation) k, mode, proposed, accepted,
        accept_rate and the draft's kernel launches; the "group.*",
        "beam.*" and "guided.*" keys count fork groups, beam reorders and
        masked steps. `mesh` (None single-device) the axis, tp, form,
        devices, logical and one shard's pool bytes, the reductions a
        step pays and the mesh's count so far. `kv_tier` (None without a
        host tier) the tier's
        blocks, bytes and traffic; `preempts`, `resumes` and
        `preempted_depth` the scheduler's. `memory` is this server's
        HBM-ledger rows by kind (empty once closed); `slo` and `tenants`
        the telemetry's snapshots (None with telemetry off)."""
        st = self._sched.stats()
        proposed = st.pop("spec.proposed")
        accepted = st.pop("spec.accepted")
        st["spec"] = None
        if self._spec is not None:
            st["spec"] = {
                "k": self._spec.k,
                "mode": self._spec.mode,
                "proposed": proposed,
                "accepted": accepted,
                "accept_rate": round(accepted / max(proposed, 1), 4),
                "draft_launches": self._draft_launches,
            }
        st["iterations"] = self._iterations
        st["chunk"] = self._sched.chunk
        st["block_size"] = self.block_size
        st["max_context"] = self.max_context
        st["device"] = str(self.device)
        # engaged: this server's attention is the paged kernel (the card,
        # no plain attention put in through the model's hook)
        st["kernel"] = {"launches": _paged.LAUNCHES,
                        "engaged": self.device.type == "cuda"
                        and self.model.attention is paged_attention}
        st["fused_step_signatures"] = len(self._signatures)
        st["pool_bytes"] = self.cache.pool_bytes()
        st["kv_quant"] = None
        if self.cache.quantized:
            pb, db = self.cache.pool_bytes(), self.cache.dense_pool_bytes()
            st["kv_quant"] = {
                "kv_dtype": self.cache.kv_dtype,
                "compute_dtype": str(self.cache.compute_dtype).removeprefix(
                    "torch."),
                "pool_bytes": pb,
                "scale_bytes": self.cache.scale_bytes(),
                "dense_equiv_bytes": db,
                "bytes_ratio_vs_dense": round(pb / db, 4),
                "int8_weights": self.model.int8_weights,
            }
        st["kv_tier"] = None
        if self.cache.host is not None:
            st["kv_tier"] = {
                "host_blocks": self.cache.host.num_blocks,
                "host_blocks_used": self.cache.host.num_used,
                "host_pool_bytes": self.cache.host_pool_bytes(),
                "device_pool_bytes": self.cache.pool_bytes(),
                "spills": self.cache.host_spills,
                "swap_ins": self.cache.host_swap_ins,
                "preempts": self._sched.preempts,
                "resumes": self._sched.resumes,
                "preempted_depth": st["preempted_depth"],
                "reprefills_avoided":
                    self._prefix.counts["reprefills_avoided"]
                    if self._prefix is not None else 0,
            }
        st["telemetry_enabled"] = self._tel is not None
        st["slo"] = self._tel.stats() if self._tel is not None else None
        st["tenants"] = (self._tel.tenants.snapshot()
                         if self._tel is not None else None)
        st["engine_fault"] = repr(self._fault) if self._fault else None
        st["mesh"] = None
        if self.mesh is not None:
            st["mesh"] = {
                "axis": self.mesh_axis,
                "tp": self.cache.tp,
                "form": "world" if self.mesh.world else "local",
                "devices": [str(d) for d in self.mesh.devices.flat],
                "pool_bytes": self.cache.pool_bytes(),
                "shard_pool_bytes": self.cache.shard_pool_bytes(),
                "psums_per_step": 2 * self.model.num_layers,
                "reductions": self.mesh.reductions,
            }
        st["memory"] = hbm_ledger().component_bytes(self._ledger_id)
        return st

    def check_slo(self, targets):
        """Burn-rate check over the cumulative SLO digests, e.g.
        ``check_slo({"ttft_ms": {"p99": 250.0}})`` -> {"ok": bool,
        "checks": [...]} (SLOTracker.check_slo)."""
        if self._tel is None:
            raise RuntimeError(
                "check_slo needs telemetry; this server was built with "
                "telemetry=False")
        return self._tel.check_slo(targets)

    @property
    def telemetry(self):
        """The ServingTelemetry (SLO digests + flight recorder), or None
        when disabled."""
        return self._tel

    def health(self):
        """The /healthz payload as a plain dict: status "fault" once an
        engine fault latched, "closed" after close(), "ok" otherwise."""
        status = ("fault" if self._fault
                  else "closed" if self._closed else "ok")
        return {"status": status,
                "engine_fault": repr(self._fault) if self._fault else None,
                "pending": self.pending(),
                "iteration": self._sched.iteration}

    def serve_metrics(self, port=0, host=None):
        """Mount the stdlib telemetry endpoint (/metrics Prometheus
        exposition, /healthz, /slo, /memory, /series, /tenants) for this
        server, on loopback by default; returns the running
        TelemetryServer (.port, .url, .close()), closed with the server.
        Idempotent while a mount is live, but a different explicit port
        or host than the live mount's raises."""
        from ..observability.exporter import (check_remount,
                                              serve_metrics as _serve)
        if self._exporter is not None and not self._exporter.closed:
            check_remount(self._exporter, port, host)
            return self._exporter
        tel = self._tel
        self._exporter = _serve(
            port=port, host=host or "127.0.0.1",
            slo_fn=lambda: tel.stats() if tel is not None else {},
            health_fn=self.health,
            series_fn=lambda: (tel.series.payload() if tel is not None
                               and tel.series is not None else None),
            tenants_fn=lambda: (tel.tenants.snapshot()
                                if tel is not None else {}))
        return self._exporter
