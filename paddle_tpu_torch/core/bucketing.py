"""Feed shape bucketing: pad dynamic batch/sequence dims to power-of-2
buckets so a variable-shape training loop sees O(log n) distinct feed
shapes instead of one per batch size.

The port's own copy of ``paddle_tpu/core/bucketing.py``. The JAX
Executor compiles one step a feed signature, so there the bound is one on
compiles; the port's eager Executor compiles nothing, and the bound is the
one a later CUDA graph a step needs (a fixed shape to capture), and the
one the caching allocator sees (a few block sizes, not one a batch size).
The loss mask rides in the feed dict so the padded rows are exact no-ops
for the loss and its gradients:

    bucketer = FeedBucketer(mask_name="batch_mask")
    # model side: per_row_loss * batch_mask summed / sum(batch_mask)
    out = exe.run(main, feed=bucketer.bucket(feed), fetch_list=[loss])

Padding trades FLOPs for shapes: a bucketed step burns up to 2x the
arithmetic of the real batch (power-of-2 rounding) but the shapes stay at
<= log2(max_batch)+1. The waste is observable:
`executor.bucket.pad_waste_elems` counts every padding element added, and
the `executor.bucket.shapes` gauge tracks distinct post-bucketing
signatures.
"""

import itertools

import numpy as np
import torch

from ..observability import ComponentStats

__all__ = ["FeedBucketer", "bucket_size"]

_BUCKETER_SEQ = itertools.count()


def bucket_size(n, min_size=1, max_size=None):
    """Smallest power of two >= n (floored at min_size).

    max_size caps the bucket (e.g. a captured-shape budget); a
    dimension past the cap raises instead of silently truncating data.
    """
    if n < 0:
        raise ValueError(f"negative dimension {n}")
    b = 1
    lo = max(int(min_size), 1)
    while b < lo or b < n:
        b <<= 1
    if max_size is not None and b > int(max_size):
        if n <= int(max_size):
            return int(max_size)
        raise ValueError(
            f"dimension {n} exceeds the bucket cap max_size={max_size}; "
            f"split the batch or raise the cap")
    return b


class FeedBucketer:
    """Pad a feed dict's dynamic dims to power-of-2 buckets + a loss mask.

    Parameters
    ----------
    dynamic_axes: None, or {feed_name: axis | (axes...)}. None (default)
        means "axis 0 of every array feed" — the shared batch dimension.
        Feeds named in an explicit mapping are padded on those axes;
        unnamed feeds pass through untouched. Axis 0 of every padded feed
        must agree (it is THE batch); higher axes (sequence lengths)
        bucket per-feed.
    mask_name: feed key for the generated batch mask, a float32
        (bucket_batch, 1) array with 1.0 on real rows. Present in the
        output whenever a batch (axis-0) dim was bucketed — even when no
        padding happened — so the feed signature of a bucketed loop is
        stable (sequence-only `dynamic_axes` never generate one: there
        is no batch to size it on). A mask the CALLER already put in the
        feed is preserved, not overwritten: it is padded with zeros like
        any other feed, so rows the user masked out stay out of the
        loss. None disables mask generation — only safe for inference
        paths that slice their own outputs.
    min_size / max_size: bucket floor/cap forwarded to bucket_size().
    pad_values: {feed_name: scalar} fill for padded slots (default 0 —
        safe for ids with a 0 pad token and for anything the mask zeroes
        out of the loss).
    """

    def __init__(self, dynamic_axes=None, mask_name="batch_mask",
                 min_size=1, max_size=None, pad_values=None,
                 mask_dtype=np.float32):
        if dynamic_axes is not None:
            dynamic_axes = {
                k: (v,) if isinstance(v, int) else tuple(v)
                for k, v in dynamic_axes.items()}
        self.dynamic_axes = dynamic_axes
        self.mask_name = mask_name
        self.min_size = min_size
        self.max_size = max_size
        self.pad_values = dict(pad_values or {})
        self.mask_dtype = mask_dtype
        self._shapes_seen = set()
        self._mask_cache = {}     # (batch, bucket) -> shared mask array
        self._stats = ComponentStats(
            gauge_labels={"bucketer": f"bk{next(_BUCKETER_SEQ)}"})

    # ------------------------------------------------------------------
    def _axes_for(self, feed):
        if self.dynamic_axes is not None:
            return self.dynamic_axes
        axes = {}
        for k, v in feed.items():
            if np.ndim(v) >= 1:
                axes[k] = (0,)
        return axes

    def bucket(self, feed):
        """-> new feed dict with bucketed shapes (+ the mask entry).

        Host-side only: call BEFORE device placement (device_prefetch's
        `transform=` hook does exactly this). Tensors in dynamic feeds
        are rejected: padding one on a device would pull it back to the
        host.
        """
        axes_map = self._axes_for(feed)
        out = dict(feed)
        batch = None
        pad_waste = 0
        sig = []      # (name, post-bucket shape); built in-loop — this
        #               runs per step, a second full-dict walk would
        #               double the host cost the pipeline tries to hide
        for name, axes in axes_map.items():
            if name not in feed or name == self.mask_name:
                continue      # the mask block below pads a user mask
                #               exactly once (zero-fill, never counted
                #               as data pad waste)
            v = feed[name]
            if isinstance(v, torch.Tensor):
                raise TypeError(
                    f"feed '{name}' is already a tensor — bucket feeds "
                    f"on the host, as numpy, before the upload")
            a = np.asarray(v)
            if 0 in axes:
                if batch is None:
                    batch = a.shape[0]
                elif a.shape[0] != batch:
                    raise ValueError(
                        f"feed '{name}' batch dim {a.shape[0]} disagrees "
                        f"with {batch} seen on another bucketed feed")
            target = list(a.shape)
            for ax in axes:
                if ax >= a.ndim:
                    raise ValueError(
                        f"feed '{name}' has no axis {ax} (shape {a.shape})")
                target[ax] = bucket_size(a.shape[ax], self.min_size,
                                         self.max_size)
            target = tuple(target)
            if target != a.shape:
                padded = np.full(target, self.pad_values.get(name, 0),
                                 dtype=a.dtype)
                padded[tuple(slice(0, s) for s in a.shape)] = a
                pad_waste += padded.size - a.size
                out[name] = padded
            else:
                out[name] = a
            sig.append((name, target))
        if self.mask_name is not None and batch is not None:
            bucket_batch = bucket_size(batch, self.min_size, self.max_size)
            if self.mask_name in feed:
                # the caller brought their own mask (partially-masked
                # rows): NEVER overwrite it — zero-pad it to the bucket
                # like any feed, so masked-out rows stay out of the loss
                um = np.asarray(feed[self.mask_name])
                if um.shape[0] != batch:
                    raise ValueError(
                        f"user mask '{self.mask_name}' has batch dim "
                        f"{um.shape[0]}, feeds have {batch}")
                if um.shape[0] != bucket_batch:
                    padded = np.zeros((bucket_batch,) + um.shape[1:],
                                      dtype=um.dtype)
                    padded[:batch] = um
                    um = padded
                out[self.mask_name] = um
                sig.append((self.mask_name, um.shape))
            else:
                mkey = (batch, bucket_batch)
                mask = self._mask_cache.get(mkey)
                if mask is None:
                    # shared read-only array: the executor's per-step
                    # feed identity cache then sees the SAME object
                    # every step of a given batch size
                    mask = np.zeros((bucket_batch, 1),
                                    dtype=self.mask_dtype)
                    mask[:batch] = 1
                    mask.setflags(write=False)
                    self._mask_cache[mkey] = mask
                out[self.mask_name] = mask
                sig.append((self.mask_name, mask.shape))
        for name, v in feed.items():
            if name not in axes_map:       # passthrough entries
                sig.append((name, tuple(getattr(v, "shape", ()))))
        self._shapes_seen.add(tuple(sorted(sig)))
        self._stats.count("executor.bucket.batches")
        if pad_waste:
            self._stats.count("executor.bucket.pad_waste_elems", pad_waste)
        self._stats.set_gauge("executor.bucket.shapes",
                              len(self._shapes_seen))
        return out

    __call__ = bucket

    # -- observability --------------------------------------------------
    def get_stats(self):
        local = self._stats.local

        def c(name):
            m = local.get(name)
            return int(m.value()) if m is not None else 0

        return {"batches": c("executor.bucket.batches"),
                "pad_waste_elems": c("executor.bucket.pad_waste_elems"),
                "shapes": len(self._shapes_seen)}
