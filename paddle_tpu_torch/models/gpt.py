"""GPT decoder-only language model: config, parameters, layer norm.

Counterpart of ``paddle_tpu/models/gpt.py``. The port keeps the JAX
package's parameter layout (``load_params``): a dict with ``word_emb``
(V, hidden), ``pos_emb`` (max_position, hidden), ``lnf_s``/``lnf_b`` and
one dict per layer ``l{i}`` holding ``ln1_s ln1_b ln2_s ln2_b`` (hidden,),
``wq wk wv wo`` (hidden, hidden), ``bq bk bv bo`` (hidden,), ``f0w``
(hidden, inner), ``f0b`` (inner,), ``f1w`` (inner, hidden), ``f1b``
(hidden,). Weights multiply on the right (``x @ w``), as in the reference.
"""

import numpy as np
import torch

__all__ = ["GPTConfig", "gpt_tiny", "init_params", "params_from_numpy",
           "gqa_slice_kv_params", "gqa_repeat_kv_params"]


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
