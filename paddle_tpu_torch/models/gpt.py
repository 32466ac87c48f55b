"""GPT decoder-only language model: config, parameters, and the
prompt-conditioned decoders.

Counterpart of ``paddle_tpu/models/gpt.py``. The port keeps the JAX
package's parameter layout (``load_params``): a dict with ``word_emb``
(V, hidden), ``pos_emb`` (max_position, hidden), ``lnf_s``/``lnf_b`` and
one dict per layer ``l{i}`` holding ``ln1_s ln1_b ln2_s ln2_b`` (hidden,),
``wq wk wv wo`` (hidden, hidden), ``bq bk bv bo`` (hidden,), ``f0w``
(hidden, inner), ``f0b`` (inner,), ``f1w`` (inner, hidden), ``f1b``
(hidden,). Weights multiply on the right (``x @ w``), as in the reference.

Decoding: ``build_prefill`` runs the whole prompt in one forward whose
attention is the flash kernel (``ops/flash.py``; one launch per layer on
the card), ``build_kv_step`` continues token by token over a dense KV
cache, and ``make_prompt_decoder`` / ``generate_with_prompt`` /
``make_greedy_decoder`` / ``make_sampler`` wire them to the loops of
``inference/decoding.py``. JAX's ``jit`` has no counterpart: the
factories return plain callables that run under ``torch.inference_mode``
on the device the caller names (None means the card). The training graph
and ``generate(scope, ...)`` need the framework's Program and Scope, and
wait for that slice.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

__all__ = ["GPTConfig", "gpt_tiny", "init_params", "params_from_numpy",
           "gqa_slice_kv_params", "gqa_repeat_kv_params", "build_kv_step",
           "build_prefill", "make_prompt_decoder", "generate_with_prompt",
           "make_greedy_decoder", "make_sampler"]


class GPTConfig:
    vocab_size = 32000
    hidden_size = 768
    num_layers = 12
    num_heads = 12
    # grouped-query attention: kv_heads < num_heads shares each KV head
    # across a group of query heads; None means MHA
    kv_heads = None
    inner_size = 3072
    max_position = 1024
    dropout = 0.1

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def gpt_tiny():
    """4-layer/128-wide config for tests."""
    return GPTConfig(vocab_size=256, hidden_size=128, num_layers=4,
                     num_heads=4, inner_size=512, max_position=128,
                     dropout=0.0)


_LAYER_SHAPES = (
    ("ln1_s", "h"), ("ln1_b", "h"), ("ln2_s", "h"), ("ln2_b", "h"),
    ("wq", "hq"), ("wk", "hk"), ("wv", "hk"), ("wo", "hh"),
    ("bq", "q"), ("bk", "k"), ("bv", "k"), ("bo", "h"),
    ("f0w", "hi"), ("f0b", "i"), ("f1w", "ih"), ("f1b", "h"),
)


def init_params(cfg, seed=0):
    """A numpy params tree in load_params' layout, from a seed: normal
    with std 0.02 for matrices and embeddings, ones/zeros for layer norm
    scales/biases, zeros for projection biases."""
    rng = np.random.default_rng(seed)
    hid, inner = cfg.hidden_size, cfg.inner_size
    head_dim = hid // cfg.num_heads
    kv = (getattr(cfg, "kv_heads", None) or cfg.num_heads) * head_dim
    dims = {"h": (hid,), "q": (hid,), "k": (kv,), "i": (inner,),
            "hq": (hid, hid), "hk": (hid, kv), "hh": (hid, hid),
            "hi": (hid, inner), "ih": (inner, hid)}

    def normal(shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    p = {"word_emb": normal((cfg.vocab_size, hid)),
         "pos_emb": normal((cfg.max_position, hid)),
         "lnf_s": np.ones((hid,), np.float32),
         "lnf_b": np.zeros((hid,), np.float32)}
    for i in range(cfg.num_layers):
        layer = {}
        for name, kind in _LAYER_SHAPES:
            shape = dims[kind]
            if name.endswith("_s"):
                layer[name] = np.ones(shape, np.float32)
            elif len(shape) == 1:
                layer[name] = np.zeros(shape, np.float32)
            else:
                layer[name] = normal(shape)
        p[f"l{i}"] = layer
    return p


def params_from_numpy(tree, device, dtype=None):
    """The JAX package's params pytree (load_params' layout, leaves as
    numpy arrays or anything np.asarray accepts) -> the port's dict of
    tensors on `device`. `dtype` casts the f32 leaves (_cast_params)."""
    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    out = {k: (params_from_numpy(v, device) if isinstance(v, dict)
               else leaf(v)) for k, v in tree.items()}
    return _cast_params(out, dtype)


def _gqa_group(cfg, kv_heads):
    h = cfg.num_heads
    if kv_heads < 1 or h % kv_heads:
        raise ValueError(
            f"kv_heads={kv_heads} must divide num_heads={h}")
    return h // kv_heads, cfg.hidden_size // h


def _with_kv(params, cfg, fw, fb):
    """A shallow copy of params with every layer's wk/wv mapped by fw and
    bk/bv by fb; the other leaves are shared, not copied."""
    out = dict(params)
    for i in range(cfg.num_layers):
        lp = dict(out[f"l{i}"])
        lp["wk"], lp["wv"] = fw(lp["wk"]), fw(lp["wv"])
        lp["bk"], lp["bv"] = fb(lp["bk"]), fb(lp["bv"])
        out[f"l{i}"] = lp
    return out


def gqa_slice_kv_params(params, cfg, kv_heads):
    """A grouped-query-attention params tree from an MHA one (the numpy
    tree or the dict of tensors): keep each query-head group's first
    head's wk/wv columns (and bk/bv rows), shrinking both projections to
    kv_heads * head_dim outputs. Serve it with ``GPTConfig(kv_heads=...)``.
    With `gqa_repeat_kv_params` it is an exact round trip, which makes a
    repeat-KV MHA server the reference for a GQA server."""
    g, d = _gqa_group(cfg, kv_heads)

    def slc_w(w):
        return w.reshape(-1, kv_heads, g, d)[:, :, 0, :].reshape(
            w.shape[0], kv_heads * d)

    def slc_b(bvec):
        return bvec.reshape(kv_heads, g, d)[:, 0, :].reshape(kv_heads * d)

    return _with_kv(params, cfg, slc_w, slc_b)


def _repeat(x, g, axis):
    if isinstance(x, torch.Tensor):
        return x.repeat_interleave(g, dim=axis)
    return np.repeat(x, g, axis=axis)


def gqa_repeat_kv_params(params, cfg, kv_heads):
    """Inverse of `gqa_slice_kv_params`: expand a GQA tree (wk/wv with
    kv_heads * head_dim outputs) back to full MHA width by repeating each
    KV head's columns across its query-head group, so every query head
    projects its group's shared K/V bit for bit."""
    g, d = _gqa_group(cfg, kv_heads)
    h = cfg.num_heads

    def rep_w(w):
        return _repeat(w.reshape(-1, kv_heads, d), g, 1).reshape(
            w.shape[0], h * d)

    def rep_b(bvec):
        return _repeat(bvec.reshape(kv_heads, d), g, 0).reshape(h * d)

    return _with_kv(params, cfg, rep_w, rep_b)


def _ln(x, s, b, eps=1e-5):
    """Layer norm over the last axis with the biased variance."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * s + b


def _cast_params(params, dtype):
    """Serving-dtype cast: f32 leaves -> dtype, everything else as-is."""
    if dtype is None:
        return params
    return {k: (_cast_params(v, dtype) if isinstance(v, dict)
                else v.to(dtype) if v.dtype == torch.float32 else v)
            for k, v in params.items()}


def _to_device(params, device):
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in params.items()}


# ---------------------------------------------------------------------------
# decoding: the dense KV-cache step and the parallel prompt prefill
# ---------------------------------------------------------------------------

def build_kv_step(params, cfg, max_len):
    """step_fn(ids_t (B,), cache, t) -> (logits (B, V), cache) for the
    loops of inference/decoding.py. cache: per layer {"k", "v"} of
    (B, H, max_len, D), updated in place at t.

    Scores and the softmax are f32 (JAX's numpy-scalar divide and f32
    bias promote a bf16 product to f32), the probabilities are cast back
    to the cache dtype before PV, and GELU is exact (erf)."""
    from ..inference import decoding as dec
    h_, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads

    def step(ids_t, cache, t):
        b = ids_t.shape[0]
        x = params["word_emb"][ids_t.long()] + params["pos_emb"][t]
        bias = dec.cache_attention_bias(max_len, t, x.device)[0, 0]
        for i in range(cfg.num_layers):
            lp = params[f"l{i}"]
            hn = _ln(x, lp["ln1_s"], lp["ln1_b"])
            q = (hn @ lp["wq"] + lp["bq"]).reshape(b, h_, 1, d)
            k = (hn @ lp["wk"] + lp["bk"]).reshape(b, h_, 1, d)
            v = (hn @ lp["wv"] + lp["bv"]).reshape(b, h_, 1, d)
            cache[i] = dec.update_kv_cache(cache[i], k, v, t)
            s = (torch.einsum("bhd,bhld->bhl", q[:, :, 0],
                              cache[i]["k"]).float() / math.sqrt(d)) + bias
            p = torch.softmax(s, dim=-1).to(cache[i]["v"].dtype)
            o = torch.einsum("bhl,bhld->bhd", p,
                             cache[i]["v"]).reshape(b, cfg.hidden_size)
            x = x + (o @ lp["wo"] + lp["bo"]).to(x.dtype)
            hn = _ln(x, lp["ln2_s"], lp["ln2_b"])
            f = F.gelu(hn @ lp["f0w"] + lp["f0b"])
            x = x + (f @ lp["f1w"] + lp["f1b"])
        x = _ln(x, params["lnf_s"], params["lnf_b"])
        return x @ params["word_emb"].T, cache

    return step


def _prefill_forward(lp_all, prompt_ids, cfg, max_len, h_count,
                     reduce_fn, attention=None):
    """The one prefill body (build_kv_step's math over the whole prompt):
    `h_count` is the head count this caller computes (H, or H/tp on a
    tensor-parallel shard) and `reduce_fn` finishes the row-parallel
    o-proj / ffn-down products (identity on one device). `attention` is
    the causal attention over (B, H, P, D); None is ops.flash's
    flash_attention, which launches the kernel once per layer for CUDA
    tensors. Returns (cache, logits (B, P, V)): each layer's K/V at
    positions 0..P-1 of a max_len cache, zero beyond."""
    from ..ops.flash import flash_attention

    attention = attention or flash_attention
    d = cfg.hidden_size // cfg.num_heads
    b, p = prompt_ids.shape
    ids = prompt_ids.long()
    x = lp_all["word_emb"][ids] + lp_all["pos_emb"][:p][None]
    cache = []
    for i in range(cfg.num_layers):
        lp = lp_all[f"l{i}"]
        hn = _ln(x, lp["ln1_s"], lp["ln1_b"])

        def heads(w, bias):
            # a (B, H, P, D) view of the projection: the kernel takes
            # its strides
            return (hn @ w + bias).reshape(b, p, h_count, d).transpose(1, 2)

        q = heads(lp["wq"], lp["bq"])
        k = heads(lp["wk"], lp["bk"])
        v = heads(lp["wv"], lp["bv"])
        o = attention(q, k, v, causal=True, scale=1.0 / math.sqrt(d))
        o = o.transpose(1, 2).reshape(b, p, h_count * d)
        x = x + (reduce_fn(o @ lp["wo"]) + lp["bo"]).to(x.dtype)
        hn = _ln(x, lp["ln2_s"], lp["ln2_b"])
        f = F.gelu(hn @ lp["f0w"] + lp["f0b"])
        x = x + (reduce_fn(f @ lp["f1w"]) + lp["f1b"])
        # park this layer's K/V at positions 0..P-1 of the cache
        pad = (0, 0, 0, max_len - p)
        cache.append({"k": F.pad(k, pad), "v": F.pad(v, pad)})
    x = _ln(x, lp_all["lnf_s"], lp_all["lnf_b"])
    return cache, x @ lp_all["word_emb"].T


def build_prefill(params, cfg, max_len, attention=None):
    """prefill(prompt_ids (B, P)) -> (cache, logits (B, P, V)): the whole
    prompt in one parallel forward, K/V for positions 0..P-1 written into
    a max_len cache, from which build_kv_step continues at t = P.
    `attention` replaces the flash attention (see _prefill_forward)."""

    def prefill(prompt_ids):
        return _prefill_forward(params, prompt_ids, cfg, max_len,
                                cfg.num_heads, lambda z: z, attention)

    return prefill


def _select_first(logits_last, temperature, top_k, top_p, generator):
    """First generated token from the prefill's last-position logits:
    argmax when temperature is None/<= 0, else a filtered categorical
    draw from `generator`. Returns (first, score0): ONE implementation
    for the greedy and sampled prompt paths."""
    from ..inference import decoding as dec

    logits = logits_last.float()
    if temperature is None or temperature <= 0.0:
        filtered = logits
        first = torch.argmax(filtered, dim=-1)
    else:
        filtered = dec._filter_logits(logits / temperature, top_k=top_k,
                                      top_p=top_p)
        first = dec._draw(filtered, generator)
    logp = torch.log_softmax(filtered, dim=-1)
    score0 = torch.gather(logp, 1, first[:, None])[:, 0]
    return first, score0


def _stitch_prompt_output(first, score0, ids, scores, gen, eos_id):
    """Prepend the first token and apply the first-step-EOS rule: tokens
    after a first-step EOS read as EOS, and that lane's later score is
    0."""
    out = torch.cat([first[:, None], ids], dim=1)
    if eos_id is not None:
        done0 = first == eos_id
        after = torch.arange(gen, device=out.device)[None] > 0
        out = torch.where(done0[:, None] & after,
                          torch.full_like(out, eos_id), out)
        scores = torch.where(done0, torch.zeros_like(scores), scores)
    return out, score0 + scores


def _prompt_continuation(prefill, step, p, gen, eos_id, beam_size,
                         length_penalty):
    """The continuation over any prefill(prompt) -> (cache, logits), shared
    by every prompt decoder: greedy, or beam search with `beam_size`."""
    from ..inference import decoding as dec

    if beam_size is not None:
        K = beam_size

        def decode(prompt_ids):
            cache, _logits = prefill(prompt_ids)
            cache = [{n: x.repeat_interleave(K, dim=0)
                      for n, x in layer.items()} for layer in cache]
            # feed the last prompt token at start_t = P-1: the step
            # rewrites that position's K/V (the same values) and the loop
            # emits gen tokens from position P
            return dec.beam_decode(
                step, cache, prompt_ids[:, -1], gen, K,
                eos_id if eos_id is not None else -1,
                length_penalty=length_penalty, start_t=p - 1)

        return decode

    def decode(prompt_ids):
        cache, logits = prefill(prompt_ids)
        first, score0 = _select_first(logits[:, -1], None, None, None, None)
        ids, scores = dec.greedy_decode(step, cache, first, gen - 1,
                                        eos_id=eos_id, start_t=p)
        return _stitch_prompt_output(first, score0, ids, scores, gen,
                                     eos_id)

    return decode


def _gen_len(prompt_len, max_len):
    gen = max_len - int(prompt_len)
    if gen <= 0:
        raise ValueError(f"max_len={max_len} must exceed the prompt "
                         f"length {prompt_len}")
    return gen


def _prepare(params, dtype, device):
    """Resolve the device (None: the card) and put the cast params there."""
    device = resolve_device(device)
    return _to_device(_cast_params(params, dtype), device), device


def _ids_on(ids, device, dims):
    ids = torch.as_tensor(ids).to(device=device, dtype=torch.long)
    if ids.dim() != dims:
        raise ValueError(f"token ids of shape {tuple(ids.shape)}: want "
                         f"{dims}-D")
    return ids


def make_prompt_decoder(params, cfg, prompt_len, max_len, eos_id=None,
                        dtype=None, beam_size=None, length_penalty=0.6,
                        device=None, attention=None):
    """Prompt-conditioned decoder: parallel prefill of the prompt (ONE
    flash forward), then KV-cache continuation, greedy by default and beam
    search with `beam_size`. `params` is the port's dict of tensors
    (params_from_numpy), cast to `dtype` and put on `device` (None: the
    card); `attention` replaces the prefill's flash attention.

    decode(prompt_ids (B, P)) -> greedy: (ids (B, max_len - P), scores
    (B,)), scores summing the generated tokens' log-probs; beam: (ids
    (B, K, max_len - P), scores (B, K)) best-first."""
    p = int(prompt_len)
    gen = _gen_len(p, max_len)
    params, device = _prepare(params, dtype, device)
    prefill = build_prefill(params, cfg, max_len, attention=attention)
    step = build_kv_step(params, cfg, max_len)
    run = _prompt_continuation(prefill, step, p, gen, eos_id, beam_size,
                               length_penalty)

    def decode(prompt_ids):
        ids = _ids_on(prompt_ids, device, 2)
        if ids.shape[1] != p:
            raise ValueError(f"prompt of length {ids.shape[1]}: this "
                             f"decoder takes {p}")
        with torch.inference_mode():
            return run(ids)

    return decode


def generate_with_prompt(params, cfg, prompt_ids, max_len, eos_id=None,
                         dtype=None, beam_size=None, length_penalty=0.6,
                         device=None):
    """One-shot convenience over make_prompt_decoder (a serving loop
    should keep the decoder)."""
    prompt_len = np.shape(prompt_ids)[1]
    decode = make_prompt_decoder(
        params, cfg, prompt_len, max_len, eos_id=eos_id, dtype=dtype,
        beam_size=beam_size, length_penalty=length_penalty, device=device)
    return decode(prompt_ids)


def make_greedy_decoder(params, cfg, max_len, eos_id=None, dtype=None,
                        device=None):
    """Greedy KV-cache decoder from a BOS token: decode(bos_ids (B,)) ->
    (ids (B, max_len), scores (B,)). `dtype` casts the f32 params AND the
    cache; scores and the softmax stay f32 inside (build_kv_step)."""
    from ..inference import decoding as dec

    params, device = _prepare(params, dtype, device)
    step = build_kv_step(params, cfg, max_len)
    d = cfg.hidden_size // cfg.num_heads

    def decode(bos_ids):
        bos = _ids_on(bos_ids, device, 1)
        with torch.inference_mode():
            cache = dec.init_kv_cache(bos.shape[0], cfg.num_layers,
                                      cfg.num_heads, max_len, d,
                                      dtype=dtype or torch.float32,
                                      device=device)
            return dec.greedy_decode(step, cache, bos, max_len,
                                     eos_id=eos_id)

    return decode


def make_sampler(params, cfg, max_len, temperature=1.0, top_k=None,
                 top_p=None, eos_id=None, dtype=None, prompt_len=None,
                 device=None):
    """Stochastic decoder (temperature / top-k / nucleus;
    inference/decoding.sample_decode). The draws come from the
    torch.Generator the caller passes, which must live on `device`.
    Without prompt_len: sample(bos_ids (B,), generator) -> (ids
    (B, max_len), scores). With prompt_len: the parallel prefill first,
    then the sampled continuation: sample(prompt_ids (B, P), generator)
    -> (ids (B, max_len - P), scores); the first generated token is drawn
    from the prefill's last-position logits."""
    from ..inference import decoding as dec

    params, device = _prepare(params, dtype, device)
    step = build_kv_step(params, cfg, max_len)
    d = cfg.hidden_size // cfg.num_heads

    if prompt_len is None:
        def sample(bos_ids, generator):
            bos = _ids_on(bos_ids, device, 1)
            with torch.inference_mode():
                cache = dec.init_kv_cache(bos.shape[0], cfg.num_layers,
                                          cfg.num_heads, max_len, d,
                                          dtype=dtype or torch.float32,
                                          device=device)
                return dec.sample_decode(
                    step, cache, bos, max_len, generator,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    eos_id=eos_id)

        return sample

    p = int(prompt_len)
    gen = _gen_len(p, max_len)
    prefill = build_prefill(params, cfg, max_len)

    def sample(prompt_ids, generator):
        ids = _ids_on(prompt_ids, device, 2)
        if ids.shape[1] != p:
            raise ValueError(f"prompt of length {ids.shape[1]}: this "
                             f"sampler takes {p}")
        with torch.inference_mode():
            cache, logits = prefill(ids)
            first, score0 = _select_first(logits[:, -1], temperature,
                                          top_k, top_p, generator)
            out, scores = dec.sample_decode(
                step, cache, first, gen - 1, generator,
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_id=eos_id, start_t=p)
            return _stitch_prompt_output(first, score0, out, scores, gen,
                                         eos_id)

    return sample
