"""Sequence packing for pretrain pipelines.

The counterpart of ``paddle_tpu/reader/packing.py``, host-side numpy, a
copy. Padding every sample to max_seq_len spends the products on pad
tokens; packing several short documents into one fixed-length row, with
a segment-id mask that keeps their attentions apart, spends them on real
tokens. This module is the host-side half: first-fit-decreasing bin
packing over variable-length samples, emitting per-row ``segment_ids``
(1-based; 0 = padding) and per-segment-reset ``positions``. The
device-side half is ``segment_ids=`` on the attention stack
(``ops/flash.py``), which the flash kernels compare blockwise.
"""

import numpy as np

__all__ = ["pack_sequences", "packing_efficiency"]


def pack_sequences(samples, max_len, pad_vals=None, sort=True):
    """Pack variable-length samples into fixed-length rows.

    samples: list of tuples of aligned 1-D arrays — e.g. ``(tokens,)``
        or ``(tokens, mlm_labels, mlm_weights)``; arrays within one
        tuple must share their length (the sample's length).
    max_len: row capacity. Samples longer than max_len raise.
    pad_vals: per-field pad value (default 0 for every field).
    sort: first-fit-DECREASING (better fill) when True; stable
        first-fit preserving input order when False.

    Returns a dict of stacked arrays, each (n_rows, max_len):
      field_0 .. field_{k-1}: the packed fields,
      segment_ids: 1-based segment index per token, 0 on padding,
      positions: token position WITHIN its segment (0-based), 0 on pad.
    """
    if not samples:
        raise ValueError("pack_sequences: empty sample list")
    nfields = len(samples[0])
    pad_vals = pad_vals or (0,) * nfields
    if len(pad_vals) != nfields:
        raise ValueError(f"pad_vals has {len(pad_vals)} entries for "
                         f"{nfields} fields")
    lens = []
    for i, s in enumerate(samples):
        if len(s) != nfields:
            raise ValueError(f"sample {i} has {len(s)} fields, expected "
                             f"{nfields}")
        n = len(np.asarray(s[0]))
        if any(len(np.asarray(f)) != n for f in s[1:]):
            raise ValueError(f"sample {i}: fields have unequal lengths")
        if n > max_len:
            raise ValueError(f"sample {i} length {n} > max_len {max_len}; "
                             "truncate or raise max_len")
        if n == 0:
            raise ValueError(f"sample {i} is empty")
        lens.append(n)

    order = (sorted(range(len(samples)), key=lambda i: -lens[i])
             if sort else range(len(samples)))
    rows = []          # each: list of sample indices
    space = []         # remaining capacity per row
    for i in order:
        for r, free in enumerate(space):
            if lens[i] <= free:
                rows[r].append(i)
                space[r] -= lens[i]
                break
        else:
            rows.append([i])
            space.append(max_len - lens[i])

    n_rows = len(rows)
    out = {f"field_{j}": np.full((n_rows, max_len), pad_vals[j],
                                 dtype=np.asarray(samples[0][j]).dtype)
           for j in range(nfields)}
    seg = np.zeros((n_rows, max_len), np.int64)
    pos = np.zeros((n_rows, max_len), np.int64)
    for r, members in enumerate(rows):
        cursor = 0
        for s_idx, i in enumerate(members):
            n = lens[i]
            for j in range(nfields):
                out[f"field_{j}"][r, cursor:cursor + n] = np.asarray(
                    samples[i][j])
            seg[r, cursor:cursor + n] = s_idx + 1
            pos[r, cursor:cursor + n] = np.arange(n)
            cursor += n
    out["segment_ids"] = seg
    out["positions"] = pos
    return out


def packing_efficiency(packed):
    """Fraction of token slots carrying real tokens (segment_ids > 0).
    Unpacked padded batches of the same samples would score
    mean(len)/max_len; the gap is the FLOP win."""
    seg = packed["segment_ids"]
    return float((seg > 0).mean())
