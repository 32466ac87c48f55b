"""GenerationServer: continuous-batching generation on one device.

Counterpart of ``paddle_tpu/serving/engine.py``. The whole serve loop is
ONE fused prefill/decode step

    fused(pools, tokens (S, C), positions (S, C), valid (S, C),
          tables (S, M), rng, temperature, do_sample, top_k, top_p)
        -> (next_ids (S,), next_logps (S,), logp rows (S, V))

over S decode slots x C chunk columns whose shapes are fixed for the
server's lifetime: a prefilling lane feeds up to C prompt tokens per
iteration, a decoding lane its one in-flight token, an idle lane is
masked. Requests of any length mix in one step, because length is data
(positions and tables). The step is a function of fixed-shape tensors,
so it can later be captured in one CUDA graph.

``GPTServingModel`` adapts the GPT params (models/gpt.py layout) with
the math of ``gpt.build_kv_step`` over (S, C) ragged lanes; KV goes
through ``kv_cache.write_block_kv`` (or ``write_block_kv_quant`` for int8
pools) and ``kv_cache.paged_attention``, which launches the hand-written
CUDA kernel for CUDA tensors. The q/k/v/o projections, FFN and LM head
are plain products left to ``torch.matmul``; int8 weights
(``GPTServingModel.quantize_int8``) are dequantized inline before them,
as the JAX package leaves that dequant to XLA.
"""

import math
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.gpt import _cast_params, _ln, _to_device
from ..ops.cuda import paged as _paged
from .decode_strategies import SamplingParams, gumbel_noise
from .kv_cache import (NEG_INF, NULL_BLOCK, PagedKVCache, paged_attention,
                       write_block_kv, write_block_kv_quant)
from .scheduler import ContinuousBatchingScheduler, RequestCancelled, _Request

__all__ = ["GenerationServer", "GenerationFuture", "GPTServingModel",
           "NonFiniteError"]


class NonFiniteError(FloatingPointError):
    """A fused step produced non-finite logits on a live lane; the server
    failed every outstanding request and closed."""

    def __init__(self, msg, iteration, bad_slots):
        super().__init__(msg)
        self.iteration = iteration
        self.bad_slots = bad_slots


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


def _fused_step_body(params, cfg, block_size, h_count, kv_count, d, pools,
                     tokens, positions, valid, tables, rng, temperature,
                     do_sample, top_k, top_p, attention):
    """The one fused prefill/decode step (build_kv_step's math over
    (S, C) ragged lanes with paged KV). Writes this step's K/V into the
    pools in place, then projects each lane's LAST valid column through
    the tied LM head. Greedy lanes take the argmax; lanes with
    `do_sample` take `_sample_rows`' draw. Returns (next_ids (S,) int32,
    chosen logps (S,) f32, logp rows (S, V) f32).

    A layer dict carrying "k_scale"/"v_scale" pools takes the
    quantize-at-write path and hands the scales to `attention`; a layer
    params dict carrying "<w>@q8"/"<w>@scale" entries
    (GPTServingModel.quantize_int8) gets that weight dequantized inline:
    int8 codes times the per-output-channel f32 scale, cast to the
    activation dtype."""
    s, c = tokens.shape
    wdt = params["word_emb"].dtype      # activation/compute dtype

    def w(container, name):
        # int8 weight entry -> inline dequant; plain entry -> as-is
        q8 = container.get(name + "@q8")
        if q8 is None:
            return container[name]
        return (q8.float() * container[name + "@scale"]).to(wdt)

    pos = torch.where(valid, positions, torch.zeros_like(positions))
    x = params["word_emb"][tokens.long()] + params["pos_emb"][pos.long()]
    # write targets: masked lanes route to the NULL block
    bidx = torch.gather(tables, 1, (pos // block_size).long())
    bidx = torch.where(valid, bidx, torch.full_like(bidx, NULL_BLOCK))
    off = torch.where(valid, pos % block_size, torch.zeros_like(pos))
    for i in range(cfg.num_layers):
        lp = params[f"l{i}"]
        kp, vp = pools[i]["k"], pools[i]["v"]
        ks, vs = pools[i].get("k_scale"), pools[i].get("v_scale")
        hn = _ln(x, lp["ln1_s"], lp["ln1_b"])
        q = (hn @ w(lp, "wq") + lp["bq"]).reshape(s, c, h_count, d)
        k = (hn @ w(lp, "wk") + lp["bk"]).reshape(s, c, kv_count, d)
        v = (hn @ w(lp, "wv") + lp["bv"]).reshape(s, c, kv_count, d)
        if ks is not None:
            write_block_kv_quant(kp, ks, k, bidx, off)
            write_block_kv_quant(vp, vs, v, bidx, off)
        else:
            write_block_kv(kp, k, bidx, off)
            write_block_kv(vp, v, bidx, off)
        o = attention(q.transpose(1, 2).contiguous(), kp, vp, tables, pos,
                      k_scale=ks, v_scale=vs)
        # bf16 pools under an f32 model return bf16: promote, as JAX does
        o = o.transpose(1, 2).reshape(s, c, h_count * d).to(wdt)
        x = x + (o @ w(lp, "wo") + lp["bo"]).to(x.dtype)
        hn = _ln(x, lp["ln2_s"], lp["ln2_b"])
        f = F.gelu(hn @ w(lp, "f0w") + lp["f0b"])    # exact (erf) gelu
        x = x + (f @ w(lp, "f1w") + lp["f1b"]).to(x.dtype)
    x = _ln(x, params["lnf_s"], params["lnf_b"])
    # next token comes from each lane's LAST valid column only
    last = (valid.sum(1) - 1).clamp(0, c - 1)
    xl = x[torch.arange(s, device=x.device), last]
    logp = torch.log_softmax((xl @ params["word_emb"].T).float(), dim=-1)
    nxt = torch.argmax(logp, dim=-1)
    chosen = torch.gather(logp, 1, nxt[:, None])[:, 0]
    samp, samp_lp = _sample_rows(logp, rng, temperature, top_k, top_p)
    nxt = torch.where(do_sample, samp, nxt.to(torch.int32))
    chosen = torch.where(do_sample, samp_lp, chosen)
    return nxt, chosen, logp


class GPTServingModel:
    """models/gpt.py parameters behind the engine's model interface. The
    params (the port's dict of tensors, see gpt.params_from_numpy) are
    cast to `dtype` and moved to `device`; None means the card.
    `attention` is the attention op of the fused step: None is
    kv_cache.paged_attention (the kernel on the card); a test may pass
    the plain version to hold the kernel against it end to end. Its
    signature is paged_attention's, k_scale/v_scale included."""

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

    def fused_step(self, block_size, pools, tokens, positions, valid,
                   tables, rng, temperature, do_sample, top_k, top_p):
        with torch.inference_mode():
            return _fused_step_body(
                self.params, self.cfg, block_size, self.num_heads,
                self.num_kv_heads, self.head_dim, pools, tokens, positions,
                valid, tables, rng, temperature, do_sample, top_k, top_p,
                self.attention)


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
    projection promotes back to f32, as in the JAX package."""

    def __init__(self, model, *, num_slots=4, block_size=16,
                 num_blocks=None, max_context=None, chunk=4, clock=None,
                 watermark_blocks=0, start=True, device=None,
                 kv_dtype=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, server on "
                             f"{self.device}")
        self.model = model
        self.block_size = int(block_size)
        max_context = int(max_context or model.max_position)
        if max_context > model.max_position:
            raise ValueError(
                f"max_context {max_context} exceeds the model's "
                f"max_position {model.max_position}")
        blocks_per_seq = -(-max_context // self.block_size)
        if num_blocks is None:
            num_blocks = num_slots * blocks_per_seq + 1   # +1: NULL block
        self.cache = PagedKVCache(model.num_layers, model.num_heads,
                                  model.head_dim, num_blocks,
                                  block_size=self.block_size,
                                  dtype=model.kv_dtype, device=self.device,
                                  num_kv_heads=model.num_kv_heads,
                                  kv_dtype=kv_dtype)
        self._sched = ContinuousBatchingScheduler(
            self.cache, num_slots=num_slots, chunk=chunk,
            max_context=max_context, clock=clock,
            watermark_blocks=watermark_blocks)
        self.max_context = max_context
        self._fault = None
        self._next_rid = 0
        self._rid_lock = threading.Lock()
        self._closed = False
        self._step_lock = threading.Lock()
        self._cv = threading.Condition()
        self._iterations = 0
        self._worker = None
        if start:
            self._worker = threading.Thread(target=self._serve,
                                            daemon=True)
            self._worker.start()

    # -- client surface ----------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens=32, eos_id=None,
               priority=0, deadline_ms=None, stream=None, sampling=None):
        """prompt_ids: 1-D int token ids. Returns a GenerationFuture
        resolving to a GenerationResult (or raising DeadlineExceeded /
        RequestCancelled). `stream(request_id, token)` fires on the
        serve thread for every generated token. Lower `priority` values
        run first (FIFO within a priority). `sampling=SamplingParams(...)`
        turns on stochastic decode (n=1 only in this slice)."""
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
        if sampling is not None and sampling.n != 1:
            raise NotImplementedError(
                "fork groups (n > 1) are not ported yet")
        with self._rid_lock:
            if self._closed:
                raise RuntimeError("GenerationServer is closed")
            rid = self._next_rid
            self._next_rid += 1
        fut = GenerationFuture(self, rid)
        now = self._sched.now()
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        self._sched.enqueue(_Request(rid, prompt, int(max_new_tokens),
                                     eos_id, priority, deadline, stream,
                                     fut, now, sampling=sampling))
        with self._rid_lock:
            raced_closed = self._closed
        if raced_closed:
            # lost the race with close(): its queue sweep may have run
            # before this enqueue landed
            self._sched.drop_queued_request(
                rid, self._fault or
                RequestCancelled("GenerationServer is closed"))
            raise RuntimeError("GenerationServer is closed")
        with self._cv:
            self._cv.notify()
        return fut

    def _request_cancel(self, rid):
        self._sched.request_cancel(rid)
        with self._cv:
            self._cv.notify()

    # -- serve loop --------------------------------------------------------
    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def step(self):
        """Run one scheduler iteration + fused device step. Returns True
        if any lane did work."""
        with self._step_lock:
            plan = self._sched.plan()
            if plan is None:
                return False
            it = self._sched.iteration
            do_sample, temperature, top_k, top_p, keys = plan.sample_ctl
            nxt, chosen, _ = self.model.fused_step(
                self.block_size, self.cache.pools,
                self._tensor(plan.tokens), self._tensor(plan.positions),
                self._tensor(plan.valid), self._tensor(plan.tables),
                self._tensor(keys.astype(np.int64)),
                self._tensor(temperature), self._tensor(do_sample),
                self._tensor(top_k), self._tensor(top_p))
            # commit() reads per-column arrays; a broadcast view puts the
            # last-valid-column value at every column
            s, c = plan.tokens.shape
            nxt = np.broadcast_to(nxt.cpu().numpy()[:, None], (s, c))
            logps = np.broadcast_to(chosen.cpu().numpy()[:, None], (s, c))
            # non-finite logits guard: one reduce on the hot path; the
            # per-slot triage only runs on a trip, BEFORE commit() streams
            # garbage tokens to clients
            if not math.isfinite(float(logps[:, 0].sum())):
                if not np.all(np.isfinite(logps[plan.slot_ids])):
                    self._on_engine_fault(plan, it, logps)
            self._sched.commit(plan, nxt, logps)
            self._iterations += 1
            return True

    def _on_engine_fault(self, plan, iteration, logps):
        """Fail every outstanding request, close, and raise: a poisoned
        pool is unrecoverable, and fail-stop beats serving garbage."""
        bad = [int(s) for s in plan.slot_ids
               if not np.all(np.isfinite(logps[s]))]
        err = NonFiniteError(
            f"non-finite logits on slots {bad} at iteration {iteration}",
            iteration, bad)
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

    # -- lifecycle ---------------------------------------------------------
    def close(self, drain=True, timeout=60):
        """Stop accepting submits; by default finish every in-flight and
        queued request first (graceful drain), then stop the worker.
        drain=False fails outstanding requests instead."""
        with self._rid_lock:
            if self._closed:
                return
            if not drain:
                self._sched.cancel_all(RequestCancelled(
                    "GenerationServer closed without drain"))
            self._closed = True
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

    def get_stats(self):
        """Scheduler + engine stats: `iterations` counts fused steps run,
        `kernel.launches` is the paged-attention wrapper's process-wide
        launch count since its last reset (one per layer per step on the
        card, 0 on the CPU). `kv_quant` (None for dense pools) gives the
        int8 pools' true bytes, scales included, beside what the same
        blocks would cost dense in the compute dtype."""
        st = self._sched.stats()
        st["iterations"] = self._iterations
        st["chunk"] = self._sched.chunk
        st["block_size"] = self.block_size
        st["max_context"] = self.max_context
        st["device"] = str(self.device)
        st["kernel"] = {"launches": _paged.LAUNCHES}
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
        st["engine_fault"] = repr(self._fault) if self._fault else None
        return st
