"""Beam-search ops.

Parity: paddle/fluid/operators/beam_search_op.cc +
beam_search_decode_op.cc; the counterpart of
``paddle_tpu/ops/beam_search_ops.py``: beams as a dense (batch, beam)
lane, finished beams frozen (they propose only ``<end>``, at their score
unchanged), the static-shape form of the reference's LoD prune, and the
decode a backtrack of parent pointers.

Ties: ``lax.top_k`` puts the lower index first among equal scores;
``torch.topk`` does not (on the CPU, scores [1, 3, 3, 0, 3, 2, 3] give
indices [1, 6, 4] for k 3, where ``lax.top_k`` gives [1, 2, 4]). The
selection
here is a stable descending sort, which keeps ``lax.top_k``'s order on
every device.

Under data parallelism ``beam_search`` runs a rank's rows, each rank's
rows whole beam groups (the rows are batch x beam), and its ParentIdx,
a row index into the flattened global batch, adds the rank's row offset
(rank x its rows), so the concatenated result is the single-device one.
``beam_search_decode`` takes whole sequences: it runs once on its
inputs' ranks concatenated (the global Ids, ParentIdx and Scores) into a
replicated result.
"""

import torch

from . import Sharded, register

NEG_INF = -1e9


def _top_k(x, k):
    """(values, indices) of the k largest along the last dim, the lower
    index first among equal values (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search_step(log_probs, beam_scores, finished, beam_size, end_id,
                     length_penalty=0.0, step=None):
    """One expansion: (B, K, V) token log-probs + (B, K) running scores
    -> the top K of the K x V continuations. Finished beams propose only
    ``end_id``, at their score unchanged, so each occupies one slot.

    Returns (new_scores (B, K), parent (B, K), tokens (B, K),
    finished (B, K))."""
    b, k, v = log_probs.shape
    frozen = torch.full((v,), NEG_INF, dtype=log_probs.dtype,
                        device=log_probs.device)
    if -v <= end_id < v:        # an end_id past the vocabulary freezes
        frozen[end_id] = 0.0    # nothing (JAX drops the update)
    log_probs = torch.where(finished[..., None], frozen, log_probs)
    cand = beam_scores[..., None] + log_probs
    new_scores, flat_idx = _top_k(cand.reshape(b, k * v), k)
    parent = flat_idx // v
    tokens = flat_idx % v
    new_finished = torch.gather(finished, 1, parent) | (tokens == end_id)
    return new_scores, parent, tokens, new_finished


def _select(ctx):
    """The step on this context's rows: (SelectedIds (B K, 1) int64,
    SelectedScores (B K, 1), the parent beam (B, K) within each batch
    row)."""
    scores = ctx.in_("Scores")
    k = ctx.attr("beam_size")
    end_id = ctx.attr("end_id")
    v = scores.shape[-1]
    b = scores.shape[0] // k
    log_probs = torch.log(torch.clamp_min(scores, 1e-20)).reshape(b, k, v)
    beam_scores = ctx.in_("PreScores").reshape(b, k)
    finished = ctx.in_("PreIds").reshape(b, k) == end_id
    new_scores, parent, tokens, _ = beam_search_step(
        log_probs, beam_scores, finished, k, end_id)
    return (tokens.reshape(b * k, 1).to(torch.int64),
            new_scores.reshape(b * k, 1), parent)


def _parent_rows(parent, offset):
    """(B, K) parent beams -> ParentIdx (B K,) int32: rows of the
    flattened batch, from row `offset`."""
    b, k = parent.shape
    base = torch.arange(b, device=parent.device)[:, None] * k + offset
    return (parent + base).reshape(b * k).to(torch.int32)


def _dp_beam_search(impl, ctxs, walk):
    """A rank's rows (whole beam groups), ParentIdx from the rank's row
    offset in the global batch (the shards are equal)."""
    rows_local = ctxs[0].in_("Scores").shape[0]
    k = ctxs[0].attr("beam_size")
    if rows_local % k:
        raise NotImplementedError(
            f"op 'beam_search' under data parallelism: a rank's {rows_local} "
            f"rows do not hold whole groups of beam_size {k} (dp must "
            f"divide the batch)")
    outs = {"SelectedIds": [], "SelectedScores": [], "ParentIdx": []}
    for c in ctxs:
        ids, scores, parent = _select(c)
        outs["SelectedIds"].append(ids)
        outs["SelectedScores"].append(scores)
        outs["ParentIdx"].append(_parent_rows(parent,
                                              c.dp_rank * rows_local))
    return {slot: Sharded(parts) for slot, parts in outs.items()}


@register("beam_search", dp=_dp_beam_search)
def beam_search_op(ctx):
    """One step. Inputs: Scores (B K, V) post-softmax probabilities (the
    log taken here, of max(p, 1e-20)), PreScores (B K, 1), PreIds
    (B K, 1) (a beam whose id is end_id is finished). Outputs the
    selected ids and accumulated scores (B K, 1) and ParentIdx (B K,),
    each selection's source row in the flattened batch."""
    ids, scores, parent = _select(ctx)
    return {"SelectedIds": ids, "SelectedScores": scores,
            "ParentIdx": _parent_rows(parent, 0)}


def _decode(ids, parents, scores):
    """Backtrack (T, B, K) ids along their parent pointers (per-batch
    beam indices or flattened batch x beam rows: both reduce mod K)
    into (B, K, T) sequences."""
    t, b, k = ids.shape
    parents = parents.long() % k
    ptr = torch.arange(k, device=ids.device).repeat(b, 1)
    toks = []
    for step in range(t - 1, -1, -1):
        toks.append(torch.gather(ids[step], 1, ptr))
        ptr = torch.gather(parents[step], 1, ptr)
    seqs = torch.stack(toks[::-1], dim=-1)
    return {"SentenceIds": seqs, "SentenceScores": scores}


def _dp_decode_whole(impl, ctxs, walk):
    """The global inputs (a sharded one's ranks concatenated in rank
    order), decoded once into a replicated result."""
    c = ctxs[0]
    env = c.env.env

    def whole(slot):
        name = c.op.input(slot)[0]
        v = env[name]
        return walk.cat(v.parts) if isinstance(v, Sharded) else v

    return _decode(whole("Ids"), whole("ParentIdx"), whole("Scores"))


@register("beam_search_decode", dp=_dp_decode_whole)
def beam_search_decode_op(ctx):
    """Inputs: Ids (T, B, K), ParentIdx (T, B, K), Scores (B, K).
    Outputs: SentenceIds (B, K, T) backtracked, SentenceScores (B, K)."""
    return _decode(ctx.in_("Ids"), ctx.in_("ParentIdx"), ctx.in_("Scores"))
