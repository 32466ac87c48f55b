"""Decode strategies on the shared paged KV cache: sampling knobs, fork
groups, paged beam search, and the counter-based RNG.

Counterpart of ``paddle_tpu/serving/decode_strategies.py``. One submit
can fan out into K lanes that share the prompt's KV blocks
(``GenerationServer.submit(n=K)`` / ``SamplingParams(n=K)`` for parallel
sampling, ``BeamParams(beam_size=K)`` for beam search). The fork is a
block-table operation: each lane's table aliases the prompt blocks under
the pool's refcounts, and a write into a still-shared block goes through
the copy-on-write guard.

- `SamplingParams` / `BeamParams`: per-submit strategy knobs.
- `RequestGroup`: the group's bookkeeping (lane requests, pooled
  copy-on-write spares, beam scores and done mask), mutated only under
  the scheduler's lock.
- `GroupFuture` / `GroupResult` / `BeamHypothesis`: the client surface.
- `fold_key` / `gumbel_noise` / `host_sample`: sampling is Gumbel-argmax
  over the filtered logits with noise hashed from (seed, lane rank,
  position), a pure function of the lane's identity and progress, so a
  replayed request resamples identically.
- `beam_step` / `finalize_beam`: one beam step and the final GNMT
  ranking, with the ops and tie-breaking of ``inference.decoding.
  beam_decode`` (a stable descending sort: ties go to the lower index,
  as ``jax.lax.top_k`` breaks them), so paged beam ids are the dense
  beam's. A beam reorder is applied as a block-table remap.

PyTorch has no general uint32 arithmetic, so the 32-bit hash runs in
int64 and is masked with ``& 0xFFFFFFFF`` after every multiply and
xor-shift; the bits equal numpy's uint32 ones.
"""

from concurrent.futures import Future

import numpy as np
import torch

from ..inference.decoding import _top_k_first_index
from ..ops.cuda.paged import NEG_INF

__all__ = ["SamplingParams", "BeamParams", "RequestGroup", "GroupFuture",
           "GroupResult", "BeamHypothesis", "fold_key", "gumbel_uniform",
           "gumbel_noise", "host_sample", "beam_step", "finalize_beam"]


class SamplingParams:
    """Stochastic decode knobs for one submit. `n` > 1 forks the request
    into n lanes sharing the prompt KV. `temperature <= 0` (or None) is
    greedy argmax. `seed` roots the per-lane counter RNG."""

    __slots__ = ("n", "temperature", "top_k", "top_p", "seed")

    def __init__(self, n=1, temperature=1.0, top_k=None, top_p=None,
                 seed=0):
        if int(n) < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if top_k is not None and int(top_k) < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        self.n = int(n)
        self.temperature = None if temperature is None \
            else float(temperature)
        self.top_k = None if top_k is None else int(top_k)
        self.top_p = None if top_p is None else float(top_p)
        self.seed = int(seed)

    @property
    def do_sample(self):
        return self.temperature is not None and self.temperature > 0.0


class BeamParams:
    """Beam-search knobs: beam width and the GNMT length penalty
    (inference.decoding.beam_decode's semantics)."""

    __slots__ = ("beam_size", "length_penalty")

    def __init__(self, beam_size, length_penalty=0.6):
        if int(beam_size) < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        self.beam_size = int(beam_size)
        self.length_penalty = float(length_penalty)


class BeamHypothesis:
    """One finished beam: ids (eos-padded to max_new_tokens, like the
    dense reference's rows), cumulative logprob, and the length-penalized
    score the ranking used."""

    __slots__ = ("token_ids", "score", "norm_score")

    def __init__(self, token_ids, score, norm_score):
        self.token_ids = token_ids
        self.score = score
        self.norm_score = norm_score

    def __repr__(self):
        return (f"BeamHypothesis(n={len(self.token_ids)}, "
                f"norm_score={self.norm_score:.3f})")


class GroupResult:
    """What a GroupFuture resolves to: `lanes` (GenerationResults in lane
    order) for a sampling group, `hypotheses` (best first) for beam."""

    __slots__ = ("group_id", "kind", "lanes", "hypotheses", "prompt_len")

    def __init__(self, group_id, kind, lanes=None, hypotheses=None,
                 prompt_len=0):
        self.group_id = group_id
        self.kind = kind                    # "sample" | "beam"
        self.lanes = lanes
        self.hypotheses = hypotheses
        self.prompt_len = prompt_len

    def __repr__(self):
        n = len(self.lanes or self.hypotheses or ())
        return f"GroupResult(id={self.group_id}, kind={self.kind}, k={n})"


class GroupFuture(Future):
    """One future for a whole fork group. cancel() cancels every lane;
    `lane_rids` holds the lanes' request ids in rank order (rank r's
    stream callbacks fire with lane_rids[r])."""

    def __init__(self, group_id, lane_rids, cancel_fn):
        super().__init__()
        self.group_id = group_id
        self.lane_rids = tuple(lane_rids)
        self._cancel_fn = cancel_fn
        self.set_running_or_notify_cancel()

    def cancel(self):
        if self.done():
            return False
        self._cancel_fn()
        return True


class RequestGroup:
    """Bookkeeping of one forked submit, owned by the scheduler.

    `spares` is the group's pooled copy-on-write reserve: admission
    reserves K spare blocks (one boundary-block copy a lane, the worst
    case). A beam reorder keeps an abandoned block whose refcount would
    drop to 0 in `spares` instead of freeing it, so the group's worst
    case stays covered by its own reservation."""

    __slots__ = ("gid", "kind", "k", "eos_id", "max_new_tokens",
                 "sampling", "beam", "lanes", "future", "spares",
                 "prefilled", "done", "scores", "results", "failed",
                 "released", "lane_sids", "reorders", "cow_copies")

    def __init__(self, gid, kind, k, eos_id, max_new_tokens,
                 sampling=None, beam=None):
        self.gid = gid
        self.kind = kind                    # "sample" | "beam"
        self.k = int(k)
        self.eos_id = eos_id
        self.max_new_tokens = int(max_new_tokens)
        self.sampling = sampling            # SamplingParams or None
        self.beam = beam                    # BeamParams or None
        self.lanes = []                     # _Request per rank
        self.future = None                  # GroupFuture
        self.spares = []                    # pooled COW reserve blocks
        self.prefilled = False              # leader prompt done + forked
        self.done = np.zeros((self.k,), bool)       # beam eos mask
        self.scores = np.zeros((self.k,), np.float32)
        self.results = {}                   # rank -> GenerationResult
        self.failed = False
        self.released = 0                   # lane slots released so far
        self.lane_sids = {}                 # rank -> slot id (active)
        self.reorders = 0
        self.cow_copies = 0


_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_key(seed, lane, pos):
    """Fold (seed, lane rank, position) into a (2,) uint32 counter key."""
    z = _splitmix64(int(seed) & _M64)
    z = _splitmix64(z ^ (int(lane) + 0x100))
    z = _splitmix64(z ^ ((int(pos) + 1) << 8))
    return np.array([z & _M32, z >> 32], np.uint32)


def _mix32(h):
    """The 32-bit finalizer on int64 tensors holding uint32 values; every
    product stays below 2**63 because both factors are below 2**32."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _M32
    return h ^ (h >> 16)


def gumbel_uniform(key, vocab):
    """key (..., 2) integer tensor (uint32 values) -> (..., vocab) f32
    uniforms in [1e-7, 1 - 1e-7], bitwise the numpy hash's."""
    key = key.to(torch.int64) & _M32
    idx = torch.arange(vocab, dtype=torch.int64, device=key.device)
    h = _mix32(idx ^ key[..., 0:1])
    h = _mix32(h ^ key[..., 1:2])
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.clamp(1e-7, 1.0 - 1e-7)


def gumbel_noise(key, vocab):
    """Standard-Gumbel noise rows from the counter hash: key (..., 2) ->
    (..., vocab) f32. The hash and the uniforms are bitwise numpy's; the
    two logs are the backend's own f32 log, a few ulp from numpy's, so
    the noise agrees with numpy's to about 1e-6 absolute."""
    return -torch.log(-torch.log(gumbel_uniform(key, vocab)))


def _log_softmax_np(x):
    s = x - np.max(x)
    return s - np.log(np.sum(np.exp(s), dtype=np.float32),
                      dtype=np.float32)


def host_sample(row, key, temperature=1.0, top_k=None, top_p=None):
    """One host-side sample from a logits/logp row (V,): temperature,
    top-k, nucleus, Gumbel-argmax, in numpy f32 as the JAX package does
    (its uniforms from the same counter hash, its logs numpy's, so the
    draw is the JAX package's bit for bit). Used at a group's fork: the
    leader's last prefill row seeds every lane's first token with the
    lane's own key. Returns (token, logp under the filtered
    distribution); temperature <= 0 is the argmax with the row's own
    value."""
    row = np.asarray(row, np.float32)
    v = row.size
    if temperature is None or temperature <= 0.0:
        t = int(np.argmax(row))
        return t, float(row[t])
    scaled = row / np.float32(temperature)
    if top_k is not None and 0 < int(top_k) < v:
        kth = np.sort(scaled)[::-1][int(top_k) - 1]
        scaled = np.where(scaled < kth, np.float32(NEG_INF), scaled)
    if top_p is not None and 0.0 < float(top_p) < 1.0:
        sd = np.sort(scaled)[::-1]
        probs = np.exp(sd - sd[0])
        probs = probs / probs.sum(dtype=np.float32)
        cum = np.cumsum(probs, dtype=np.float32)
        keep = np.concatenate(([True], cum[:-1] < np.float32(top_p)))
        thresh = sd[keep][-1]
        scaled = np.where(scaled < thresh, np.float32(NEG_INF), scaled)
    u = gumbel_uniform(torch.from_numpy(np.asarray(key)), v).numpy()
    g = -np.log(-np.log(u))
    t = int(np.argmax(scaled + g))
    lp = float(_log_softmax_np(scaled)[t])
    return t, lp


def beam_step(rows, scores, done, eos_id):
    """One beam-search step over the fused step's logp rows, on the host.

    rows (K, V) f32 per-lane log-probs; scores (K,) / done (K,) the
    cumulative state. The ops of inference.decoding.beam_decode's loop
    body in order (eos-only rows for finished lanes, score broadcast, one
    top-K over the flattened K*V with ties toward the lower index).
    Returns numpy (token (K,), parent (K,), new_scores (K,),
    new_done (K,))."""
    rows = torch.as_tensor(np.asarray(rows, np.float32))
    scores = torch.as_tensor(np.asarray(scores, np.float32))
    done = torch.as_tensor(np.asarray(done, bool))
    k, vocab = rows.shape
    eos_only = torch.full((vocab,), NEG_INF, dtype=torch.float32)
    eos_only[eos_id] = 0.0
    logp = torch.where(done[:, None], eos_only[None, :], rows)
    total = (scores[:, None] + logp).reshape(1, k * vocab)
    top_scores, top_idx = _top_k_first_index(total, k)
    parent = top_idx // vocab
    token = (top_idx % vocab).to(torch.int32)
    new_done = done[parent[0]] | (token[0] == eos_id)
    return (token[0].numpy(), parent[0].numpy(), top_scores[0].numpy(),
            new_done.numpy())


def finalize_beam(histories, scores, eos_id, length_penalty=0.6):
    """Rank finished beams as the dense reference's epilogue: GNMT length
    penalty over the non-eos length, a stable sort by penalized score.
    histories (K, T) int32 eos-padded, scores (K,) f32. Returns numpy
    (ids (K, T) best first, norm_scores (K,), order (K,))."""
    ids = torch.as_tensor(np.asarray(histories, np.int32))
    scores = torch.as_tensor(np.asarray(scores, np.float32))
    lengths = (ids != eos_id).sum(dim=-1).float() + 1.0
    lp = ((5.0 + lengths) / 6.0) ** length_penalty
    final = scores / lp
    order = torch.argsort(-final, stable=True)
    return ids[order].numpy(), final[order].numpy(), order.numpy()
