"""Sampling knobs and the counter-based RNG of the serving step.

Counterpart of the sampling subset of
``paddle_tpu/serving/decode_strategies.py``: ``SamplingParams``,
``fold_key``/``_splitmix64`` and ``_mix32``/``gumbel_noise``. Sampling is
Gumbel-argmax over the filtered logits with noise hashed from (seed, lane
rank, position): a pure function of the lane's identity and progress, so
a replayed request resamples identically. Fork groups, beam search and
host-side sampling wait for a later slice.

PyTorch has no general uint32 arithmetic, so the 32-bit hash runs in
int64 and is masked with ``& 0xFFFFFFFF`` after every multiply and
xor-shift; the bits equal numpy's uint32 ones.
"""

import numpy as np
import torch

__all__ = ["SamplingParams", "fold_key", "gumbel_uniform", "gumbel_noise"]


class SamplingParams:
    """Stochastic decode knobs for one submit. `temperature <= 0` (or
    None) is greedy argmax. `seed` roots the per-lane counter RNG. Only
    n=1 is served in this slice."""

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
