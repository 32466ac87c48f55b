"""Autoregressive decoding with a dense KV cache: greedy, sampled and
beam search.

Counterpart of ``paddle_tpu/inference/decoding.py``. The model plugs in
as ``step_fn(ids_t, cache, t) -> (logits, cache)``: ``ids_t`` (B,) or
(B*K,) current token ids, ``cache`` a list of per-layer ``{"k", "v"}``
tensors (B, H, T_max, D), ``logits`` (B, V). A tensor-parallel step's
cache is sharded on the head axis: one (B, H/tp, T_max, D) entry per
held rank and layer, rank-major; the loops treat it as any other list
of entries. JAX's ``lax.scan`` over time is a Python loop here; finished
lanes keep stepping (static shapes) but emit EOS at score 0.

Random draws come from a ``torch.Generator`` the caller passes (on the
decode's device), never from global state. They cannot match JAX's
threefry bits: what is shared with the JAX package is the filter, the
support and the scores of the chosen ids.

A layer cache with ``paged_update`` (the serving package's
``PagedDecodeLayer``, from ``build_paged_decode_cache``) takes the paged
branch of ``update_kv_cache``: the same step_fn then decodes against a
block-pooled paged cache, dense or int8, unchanged.
"""

import torch

from ..device import resolve_device

__all__ = ["init_kv_cache", "update_kv_cache", "cache_attention_bias",
           "greedy_decode", "sample_decode", "beam_decode", "NEG_INF"]

NEG_INF = -1e9


# ---------------------------------------------------------------------------
# KV cache helpers
# ---------------------------------------------------------------------------

def init_kv_cache(batch, num_layers, num_heads, max_len, head_dim,
                  dtype=torch.float32, device=None):
    """List of per-layer {'k', 'v'} zeros (B, H, T_max, D) on `device`
    (None means the card)."""
    device = resolve_device(device)
    shape = (batch, num_heads, max_len, head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(num_layers)]


def update_kv_cache(layer_cache, k_t, v_t, t):
    """Write this step's K/V (B, H, 1, D) at time t IN PLACE (the cache is
    the decode loop's own; JAX returns a new one) and return the layer
    cache, whose full (B, H, T_max, D) views the attention masks beyond t.
    The cache dtype wins: K/V computed on an f32 path are cast to a bf16
    cache.

    A layer cache exposing ``paged_update`` (serving.kv_cache's
    PagedDecodeLayer) routes through it: it writes the step's K/V into
    its block pools and presents the gathered dense view through the same
    {'k', 'v'} mapping."""
    if hasattr(layer_cache, "paged_update"):
        return layer_cache.paged_update(k_t, v_t, t)
    layer_cache["k"][:, :, t:t + 1] = k_t.to(layer_cache["k"].dtype)
    layer_cache["v"][:, :, t:t + 1] = v_t.to(layer_cache["v"].dtype)
    return layer_cache


def cache_attention_bias(max_len, t, device=None):
    """(1, 1, 1, T_max) f32 additive bias masking positions > t."""
    pos = torch.arange(max_len, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(pos <= t, zero, NEG_INF)[None, None, None, :]


def _take_chosen(logp, nxt):
    return torch.gather(logp, 1, nxt[:, None])[:, 0]


def _finish(nxt, step_lp, done, score, eos_id):
    """Apply the EOS rule: finished lanes emit eos_id at score 0."""
    if eos_id is None:
        return nxt, done, score + step_lp
    nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
    score = score + torch.where(done, torch.zeros_like(step_lp), step_lp)
    return nxt, done | (nxt == eos_id), score


def _stack_ids(ids, batch, device):
    if not ids:
        return torch.zeros((batch, 0), dtype=torch.long, device=device)
    return torch.stack(ids, dim=1)


# ---------------------------------------------------------------------------
# Greedy
# ---------------------------------------------------------------------------

def greedy_decode(step_fn, init_cache, bos_ids, max_len, eos_id=None,
                  start_t=0):
    """Returns (ids (B, max_len), scores (B,)). Lanes stop contributing
    after EOS. `start_t` begins at a later position (the continuation
    after a prompt prefill filled cache[..., :start_t]); max_len then
    counts GENERATED steps."""
    batch = bos_ids.shape[0]
    dev = bos_ids.device
    ids_t, cache = bos_ids, init_cache
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    score = torch.zeros(batch, dtype=torch.float32, device=dev)
    ids = []
    for t in range(start_t, start_t + max_len):
        logits, cache = step_fn(ids_t, cache, t)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nxt = torch.argmax(logp, dim=-1)
        ids_t, done, score = _finish(nxt, _take_chosen(logp, nxt), done,
                                     score, eos_id)
        ids.append(ids_t)
    return _stack_ids(ids, batch, dev), score


def _filter_logits(logits, top_k=None, top_p=None):
    """Sampling filters over (B, V) f32 logits: keep the top_k highest,
    then the smallest prefix of the sorted distribution whose cumulative
    probability reaches top_p (the nucleus); the rest -> NEG_INF. Entries
    strictly below a threshold go (`<`), so ties at it are kept."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep ranks whose PRECEDING mass is < top_p (always >= 1 token)
        keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                          cum[:, :-1] < top_p], dim=-1)
        inf = torch.full_like(sorted_logits, float("inf"))
        thresh = torch.where(keep, sorted_logits, inf).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, NEG_INF)
    return logits


def _draw(filtered, generator):
    """One categorical draw per row of filtered logits (entries at
    NEG_INF have probability 0)."""
    probs = torch.softmax(filtered, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_decode(step_fn, init_cache, bos_ids, max_len, generator,
                  temperature=1.0, top_k=None, top_p=None, eos_id=None,
                  start_t=0):
    """Stochastic decoding with a KV cache: temperature, then top-k and/or
    nucleus filtering, then a categorical draw from `generator`. A
    temperature <= 0 (or None) is greedy argmax. Returns (ids
    (B, max_len), scores (B,)), scores summing the chosen ids' log-probs
    under the FILTERED distribution."""
    batch = bos_ids.shape[0]
    dev = bos_ids.device
    greedy = temperature is None or temperature <= 0.0
    ids_t, cache = bos_ids, init_cache
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    score = torch.zeros(batch, dtype=torch.float32, device=dev)
    ids = []
    for t in range(start_t, start_t + max_len):
        logits, cache = step_fn(ids_t, cache, t)
        logits = logits.float()
        if greedy:
            filtered = logits
            nxt = torch.argmax(filtered, dim=-1)
        else:
            filtered = _filter_logits(logits / temperature, top_k=top_k,
                                      top_p=top_p)
            nxt = _draw(filtered, generator)
        logp = torch.log_softmax(filtered, dim=-1)
        ids_t, done, score = _finish(nxt, _take_chosen(logp, nxt), done,
                                     score, eos_id)
        ids.append(ids_t)
    return _stack_ids(ids, batch, dev), score


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _gather_beams(tree, parent, batch, beams):
    """Reorder the (B*K, ...) leading dim by parent beam indices (B, K)."""
    flat = (torch.arange(batch, device=parent.device)[:, None] * beams
            + parent).reshape(-1)
    return _tree_map(lambda x: x[flat], tree)


def _top_k_first_index(x, k):
    """Top-k along the last axis, ties broken toward the lower index (as
    jax.lax.top_k does)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_decode(step_fn, init_cache, bos_ids, max_len, beam_size, eos_id,
                length_penalty=0.6, start_t=0):
    """Standard beam search over dense lanes with the GNMT length
    penalty. init_cache leaves must already be (B*K, ...) (repeat each
    row K times). bos_ids (B,). Returns (ids (B, K, max_len), scores
    (B, K)) sorted best-first. `start_t` begins at a later position: the
    prompt path feeds the prompt's LAST token with a prefilled cache and
    start_t = P - 1 (the step rewrites that position's K/V with the same
    values and emits position P's token)."""
    batch = bos_ids.shape[0]
    K = beam_size
    dev = bos_ids.device
    ids_t = bos_ids.repeat_interleave(K)
    # lane 0 active, the others at NEG_INF so step 1 does not duplicate
    scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), dtype=torch.float32,
                          device=dev).repeat(batch)
    done = torch.zeros(batch * K, dtype=torch.bool, device=dev)
    cache = init_cache
    tokens, parents = [], []
    for t in range(start_t, start_t + max_len):
        logits, cache = step_fn(ids_t, cache, t)            # (B*K, V)
        vocab = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1)
        # finished lanes may only emit EOS at zero cost
        eos_only = torch.full((vocab,), NEG_INF, dtype=torch.float32,
                              device=dev)
        eos_only[eos_id] = 0.0
        logp = torch.where(done[:, None], eos_only[None, :], logp)
        total = (scores[:, None] + logp).reshape(batch, K * vocab)
        top_scores, top_idx = _top_k_first_index(total, K)  # (B, K)
        parent = top_idx // vocab
        token = top_idx % vocab
        cache = _gather_beams(cache, parent, batch, K)
        done = _gather_beams(done, parent, batch, K)
        done = done | (token.reshape(-1) == eos_id)
        ids_t = token.reshape(-1)
        scores = top_scores.reshape(-1)
        tokens.append(token)
        parents.append(parent)
    # backtrack the parent pointers into sequences
    beam_idx = torch.arange(K, device=dev)[None, :].repeat(batch, 1)
    seq = []
    for token_t, parent_t in zip(reversed(tokens), reversed(parents)):
        seq.append(torch.gather(token_t, 1, beam_idx))
        beam_idx = torch.gather(parent_t, 1, beam_idx)
    ids = (torch.stack(seq[::-1], dim=2) if seq else
           torch.zeros((batch, K, 0), dtype=torch.long, device=dev))
    lengths = (ids != eos_id).sum(dim=-1).float() + 1.0
    lp = ((5.0 + lengths) / 6.0) ** length_penalty
    final = scores.reshape(batch, K) / lp
    order = torch.argsort(-final, dim=1, stable=True)
    ids = torch.gather(ids, 1, order[:, :, None].expand_as(ids))
    final = torch.gather(final, 1, order)
    return ids, final
