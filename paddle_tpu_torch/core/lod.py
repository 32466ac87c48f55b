"""LoDTensor: host-side ragged-sequence container.

Parity: fluid.LoDTensor / fluid.create_lod_tensor
(paddle/fluid/framework/lod_tensor.cc + python/paddle/fluid/lod_tensor.py);
the port's own copy of ``paddle_tpu/core/lod.py`` (numpy only).

Device kernels never see LoD: ragged batches are padded and masked before
feeding. This class keeps the reference's host-side API (lod offsets,
recursive sequence lengths) and the one conversion that matters here:
`to_padded()` producing the (data, length) pair the sequence_* ops
consume.
"""

import numpy as np


def _lengths_to_offsets(lengths):
    off = [0]
    for n in lengths:
        off.append(off[-1] + int(n))
    return off


def _offsets_to_lengths(offsets):
    return [offsets[i + 1] - offsets[i] for i in range(len(offsets) - 1)]


class LoDTensor:
    """Level-of-detail tensor: flat data + per-level offset table."""

    def __init__(self, data=None, lod=None):
        self._array = None if data is None else np.asarray(data)
        self._lod = [list(l) for l in (lod or [])]

    # -- reference API ------------------------------------------------------
    def set(self, array, place=None):
        self._array = np.asarray(array)
        return self

    def set_lod(self, lod):
        self._lod = [list(l) for l in lod]
        return self

    def lod(self):
        return [list(l) for l in self._lod]

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = [_lengths_to_offsets(l) for l in lengths]
        return self

    def recursive_sequence_lengths(self):
        return [_offsets_to_lengths(l) for l in self._lod]

    def has_valid_recursive_sequence_lengths(self):
        if not self._lod:
            return True
        for lvl in self._lod:
            if not lvl or lvl[0] != 0 or any(
                    lvl[i] > lvl[i + 1] for i in range(len(lvl) - 1)):
                return False
        return self._array is None or self._lod[-1][-1] == len(self._array)

    def shape(self):
        return () if self._array is None else tuple(self._array.shape)

    def __array__(self, dtype=None):
        a = self._array
        return a if dtype is None else a.astype(dtype)

    def __len__(self):
        return 0 if self._array is None else len(self._array)

    def __repr__(self):
        return f"LoDTensor(shape={self.shape()}, lod={self._lod})"

    # -- padded conversion --------------------------------------------------
    def to_padded(self, max_len=None, pad_value=0):
        """(padded (B, T, ...), lengths (B,)) — the static-shape form every
        sequence_* op here consumes (LoD level 0 only)."""
        if not self._lod:
            return self._array, np.asarray([len(self._array)])
        offsets = self._lod[-1]
        lengths = np.asarray(_offsets_to_lengths(offsets), np.int64)
        t = int(max_len or (lengths.max() if len(lengths) else 0))
        feat = self._array.shape[1:]
        out = np.full((len(lengths), t) + feat, pad_value,
                      self._array.dtype)
        for i, (s, e) in enumerate(zip(offsets[:-1], offsets[1:])):
            n = min(e - s, t)
            out[i, :n] = self._array[s:s + n]
        return out, lengths


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Parity: fluid.create_lod_tensor."""
    if isinstance(data, list):
        flat = np.concatenate([np.asarray(x).reshape(len(x), -1)
                               for x in data])
        t = LoDTensor(flat)
        t.set_recursive_sequence_lengths([[len(x) for x in data]])
        return t
    t = LoDTensor(np.asarray(data))
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1):
    """Parity: fluid.create_random_int_lodtensor."""
    total = sum(recursive_seq_lens[-1])
    data = np.random.randint(low, high + 1,
                             (total,) + tuple(base_shape)).astype(np.int64)
    t = LoDTensor(data)
    t.set_recursive_sequence_lengths(recursive_seq_lens)
    return t
