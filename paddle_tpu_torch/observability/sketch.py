"""Deterministic mergeable quantile sketch (merging t-digest).

Counterpart of ``paddle_tpu/observability/sketch.py``, kept as the
port's own copy: the same centroids for the same insertion order, so
the two packages report equal quantiles.

The serving SLO surface needs p50/p90/p99 of TTFT/ITL/e2e over windows
of potentially millions of requests. A histogram with fixed buckets
(metrics.py) answers "how many landed between 25 and 50 ms", not "what
is p99 right now" — the quantile has to be interpolated across decade-
wide buckets and the error is whatever the bucket layout says it is.
This module is the streaming alternative: Dunning's *merging t-digest*
(PAPERS-adjacent standard practice; no external deps), which keeps a
bounded set of weighted centroids whose width shrinks near the tails,
so extreme quantiles — the ones SLOs are written against — are the most
accurate.

Properties the tests pin (tests/api/test_quantile_sketch.py):

- **deterministic**: no randomness anywhere; the same insertion order
  always produces the identical centroid set (and serialized form);
- **mergeable**: `merge()` combines sketches from different windows /
  slots / processes; estimates agree within the rank-error bound
  whatever the merge grouping (associativity up to the bound — exact
  bitwise associativity is impossible for any bounded-memory summary);
- **bounded rank error**: with compression δ, a quantile estimate's
  rank error is O(1/δ), concentrated toward q=0.5 and ~q(1-q)-shaped,
  so p99/p999 are sharper than the median. The tier-1 tests assert
  ≤ 1.5/δ observed rank error on adversarial streams (sorted, reversed,
  heavy duplicates, bimodal, log-tailed).

The scale function is k1: k(q) = (δ / 2π) · asin(2q − 1).
"""

import bisect
import math

__all__ = ["QuantileSketch", "DEFAULT_COMPRESSION"]

DEFAULT_COMPRESSION = 128


class QuantileSketch:
    """Streaming quantile summary over non-negative-weight float samples.

    add() buffers; the buffer is folded into the centroid list when it
    fills (amortized O(log n) per add). quantile()/rank() compress first
    so estimates always reflect every sample.
    """

    __slots__ = ("compression", "_means", "_weights", "_buf", "_count",
                 "_sum", "_min", "_max", "_buf_limit")

    def __init__(self, compression=DEFAULT_COMPRESSION):
        if compression < 8:
            raise ValueError("compression must be >= 8")
        self.compression = int(compression)
        self._means = []        # compressed centroids, ascending
        self._weights = []
        self._buf = []          # pending (value, weight)
        self._buf_limit = 4 * self.compression
        self._count = 0.0
        self._sum = 0.0
        self._min = None
        self._max = None

    # -- ingest -------------------------------------------------------------
    def add(self, value, weight=1.0):
        v = float(value)
        w = float(weight)
        if not math.isfinite(v):
            raise ValueError(f"non-finite sample {value!r}")
        if w <= 0:
            raise ValueError("weight must be > 0")
        self._buf.append((v, w))
        self._count += w
        self._sum += v * w
        self._min = v if self._min is None else min(self._min, v)
        self._max = v if self._max is None else max(self._max, v)
        if len(self._buf) >= self._buf_limit:
            self._compress()

    def add_unit(self, v):
        """add(v, 1.0) minus validation — the serving per-token hot
        path (SLOTracker.observe_token) calls this thousands of times
        per second with engine-computed finite floats; at that rate the
        float()/isfinite checks in add() are a measurable slice of the
        telemetry overhead budget. The resulting sketch state is
        identical to add(v). Callers must guarantee v is a finite
        float."""
        self._buf.append((v, 1.0))
        self._count += 1.0
        self._sum += v
        if self._min is None:
            self._min = self._max = v
        else:
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
        if len(self._buf) >= self._buf_limit:
            self._compress()

    def extend(self, values):
        for v in values:
            self.add(v)

    def merge(self, other):
        """Fold `other`'s mass into this sketch (other is unchanged).
        Centroids re-cluster under this sketch's compression."""
        if other._count == 0:
            return self
        self._buf.extend(zip(other._means, other._weights))
        self._buf.extend(other._buf)
        self._count += other._count
        self._sum += other._sum
        self._min = other._min if self._min is None \
            else min(self._min, other._min)
        self._max = other._max if self._max is None \
            else max(self._max, other._max)
        self._compress()
        return self

    # -- compression --------------------------------------------------------
    def _k(self, q):
        return self.compression / (2.0 * math.pi) * \
            math.asin(2.0 * min(max(q, 0.0), 1.0) - 1.0)

    def _compress(self):
        if not self._buf and len(self._means) <= self.compression:
            return
        pairs = sorted(self._buf + list(zip(self._means, self._weights)),
                       key=lambda p: p[0])
        self._buf = []
        if not pairs:
            return
        total = sum(w for _v, w in pairs)
        means, weights = [], []
        c_mean, c_w = pairs[0]
        done = 0.0              # weight fully emitted before the cluster
        k_lo = self._k(0.0)
        for v, w in pairs[1:]:
            q_hi = (done + c_w + w) / total
            if self._k(q_hi) - k_lo <= 1.0:
                # weighted mean update keeps the cluster centroid exact
                c_mean += (v - c_mean) * (w / (c_w + w))
                c_w += w
            else:
                means.append(c_mean)
                weights.append(c_w)
                done += c_w
                c_mean, c_w = v, w
                k_lo = self._k(done / total)
        means.append(c_mean)
        weights.append(c_w)
        self._means, self._weights = means, weights

    # -- query --------------------------------------------------------------
    @property
    def count(self):
        return self._count

    @property
    def min(self):
        return self._min

    @property
    def max(self):
        return self._max

    @property
    def mean(self):
        return self._sum / self._count if self._count else None

    def _anchors(self):
        """Piecewise-linear (cumulative_weight, value) anchors: min at 0,
        each centroid at its cumulative midpoint, max at count."""
        pts = [(0.0, self._min)]
        cum = 0.0
        for m, w in zip(self._means, self._weights):
            pts.append((cum + w / 2.0, m))
            cum += w
        pts.append((self._count, self._max))
        return pts

    def quantile(self, q):
        """Estimated value at quantile q in [0, 1]; None when empty."""
        if self._count == 0:
            return None
        self._compress()
        q = min(max(float(q), 0.0), 1.0)
        target = q * self._count
        pts = self._anchors()
        xs = [p[0] for p in pts]
        i = bisect.bisect_right(xs, target)
        if i <= 0:
            return pts[0][1]
        if i >= len(pts):
            return pts[-1][1]
        (x0, v0), (x1, v1) = pts[i - 1], pts[i]
        if x1 <= x0:
            return v1
        t = (target - x0) / (x1 - x0)
        return v0 + t * (v1 - v0)

    def rank(self, x):
        """Estimated fraction of mass <= x; None when empty."""
        if self._count == 0:
            return None
        self._compress()
        x = float(x)
        if x < self._min:
            return 0.0
        if x >= self._max:
            return 1.0
        pts = self._anchors()
        for (x0, v0), (x1, v1) in zip(pts, pts[1:]):
            if v0 <= x <= v1:
                if v1 <= v0:
                    return x1 / self._count
                t = (x - v0) / (v1 - v0)
                return (x0 + t * (x1 - x0)) / self._count
        return 1.0

    def summary(self, quantiles=(0.5, 0.9, 0.99)):
        out = {"count": round(self._count, 6), "min": self._min,
               "max": self._max,
               "avg": round(self.mean, 6) if self._count else None}
        for q in quantiles:
            v = self.quantile(q)
            tag = f"p{q * 100:g}".replace(".", "_")
            out[tag] = round(v, 6) if v is not None else None
        return out

    # -- serialization ------------------------------------------------------
    def to_dict(self):
        self._compress()
        return {"compression": self.compression,
                "count": self._count, "sum": self._sum,
                "min": self._min, "max": self._max,
                "centroids": [[m, w] for m, w in
                              zip(self._means, self._weights)]}

    @classmethod
    def from_dict(cls, d):
        s = cls(d["compression"])
        s._count = float(d["count"])
        s._sum = float(d["sum"])
        s._min = d["min"]
        s._max = d["max"]
        s._means = [float(m) for m, _w in d["centroids"]]
        s._weights = [float(w) for _m, w in d["centroids"]]
        return s

    def __repr__(self):
        return (f"QuantileSketch(compression={self.compression}, "
                f"count={self._count:g}, "
                f"centroids={len(self._means)}+{len(self._buf)}buf)")
