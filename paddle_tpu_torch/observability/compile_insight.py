"""The HBM ledger: the process-wide account of device-memory commitments.

Counterpart of the ledger half of
``paddle_tpu/observability/compile_insight.py`` (``HBMLedger``,
``hbm_ledger``, ``array_nbytes``, ``RESIDENT_KINDS``, ``LEDGER_KINDS``),
kept as the port's own copy. The JAX module's XLA cost and memory
extraction and its recompile-storm detector read the XLA compiler and
have no counterpart here. Bytes are ``numel() * element_size()`` of the
tensors a row stands for. The serving engine registers its block pools
(kind ``kv_cache``), its host KV tier (``host_ram``, never summed into
the resident total), its model's parameters (``params``) and a static
estimate of its fused step's peak (``peak_hbm``); ``/memory`` serves
the snapshot.
"""

import threading

from .metrics import global_registry

__all__ = ["array_nbytes", "HBMLedger", "hbm_ledger", "RESIDENT_KINDS",
           "LEDGER_KINDS"]


def _help(name):
    from . import _help as pkg_help
    return pkg_help(name)


def array_nbytes(t):
    """Bytes of a tensor: numel() x element_size() (bf16 counts 2)."""
    return int(t.numel()) * int(t.element_size())


# ---------------------------------------------------------------------------
# HBM ledger
# ---------------------------------------------------------------------------

RESIDENT_KINDS = ("params", "optimizer", "kv_cache", "other")
# "host_ram" rows account host-memory commitments (the serving KV
# spill tier): real bytes a fleet sizes against, but deliberately NOT
# a resident kind — memory.total_bytes stays per-device HBM truth.
LEDGER_KINDS = RESIDENT_KINDS + ("peak_hbm", "host_ram")


def _agg(kind, acc, nbytes):
    """Rollup rule per kind: resident entries are disjoint buffers and
    sum; ``peak_hbm`` entries are per-(program, shapes) estimates over
    mostly the SAME buffers — the rollup is the worst case, not a sum."""
    return max(acc, nbytes) if kind == "peak_hbm" else acc + nbytes


class HBMLedger:
    """Process-wide account of device-memory commitments.

    Entries are keyed (component, name); `register` is an upsert so a
    component refreshing a number never duplicates a row; `retire`
    drops a component's rows (and its emptied ``memory.bytes`` gauge
    series) — a closed server or a cleared jit cache must never keep
    reporting freed bytes as live. Resident kinds sum into
    ``memory.total_bytes``; ``peak_hbm`` entries are estimates over
    mostly the same buffers and never sum — per component (one entry
    per compiled (program, shapes)) they aggregate as the MAX: the
    worst-case compiled step is the component's peak.
    """

    def __init__(self, registry=None):
        self._reg = registry if registry is not None else global_registry()
        self._lock = threading.Lock()
        self._entries = {}      # (component, name) -> entry dict

    def _gauges(self):
        return (self._reg.gauge("memory.bytes", _help("memory.bytes")),
                self._reg.gauge("memory.total_bytes",
                                _help("memory.total_bytes")),
                self._reg.gauge("memory.entries", _help("memory.entries")))

    def register(self, component, name, kind, nbytes, detail=None):
        """Upsert one entry; returns it. `kind` must be a LEDGER_KINDS
        member; `detail` is a small JSON-able dict for the /memory
        endpoint (dtype, shapes, counts)."""
        if kind not in LEDGER_KINDS:
            raise ValueError(
                f"unknown ledger kind {kind!r}; expected one of "
                f"{LEDGER_KINDS}")
        entry = {"component": str(component), "name": str(name),
                 "kind": kind, "bytes": int(nbytes),
                 "detail": dict(detail or {})}
        with self._lock:
            self._entries[(entry["component"], entry["name"])] = entry
            self._publish(entry["component"])
        return entry

    def retire(self, component, name=None):
        """Drop one entry (or, with name=None, every entry) of a
        component; removes gauge series that emptied. Idempotent."""
        component = str(component)
        with self._lock:
            if name is not None:
                self._entries.pop((component, str(name)), None)
            else:
                for key in [k for k in self._entries if k[0] == component]:
                    del self._entries[key]
            self._publish(component)

    def _publish(self, component):
        """Refresh the gauges for one component + the process totals.
        Caller holds the lock."""
        by_kind_g, total_g, entries_g = self._gauges()
        live = {}
        resident_total = 0
        for e in self._entries.values():
            if e["kind"] in RESIDENT_KINDS:
                resident_total += e["bytes"]
            if e["component"] == component:
                live[e["kind"]] = _agg(e["kind"], live.get(e["kind"], 0),
                                       e["bytes"])
        for kind in LEDGER_KINDS:
            if kind in live:
                by_kind_g.labels(component=component, kind=kind).set(
                    live[kind])
            else:
                by_kind_g.remove(component=component, kind=kind)
        total_g.set(resident_total)
        entries_g.set(len(self._entries))

    def component_bytes(self, component):
        """{kind: bytes} for one component's live entries."""
        component = str(component)
        with self._lock:
            out = {}
            for e in self._entries.values():
                if e["component"] == component:
                    out[e["kind"]] = _agg(e["kind"], out.get(e["kind"], 0),
                                          e["bytes"])
            return out

    def snapshot(self):
        """JSON-able view: process totals, per-kind and per-component
        rollups, and the raw entry list (the /memory endpoint body and
        ``Executor.get_stats()["memory"]["ledger"]``)."""
        with self._lock:
            entries = [dict(e, detail=dict(e["detail"]))
                       for e in self._entries.values()]
        by_kind, by_component = {}, {}
        resident = 0
        for e in entries:
            by_kind[e["kind"]] = _agg(e["kind"], by_kind.get(e["kind"], 0),
                                      e["bytes"])
            comp = by_component.setdefault(e["component"], {})
            comp[e["kind"]] = _agg(e["kind"], comp.get(e["kind"], 0),
                                   e["bytes"])
            if e["kind"] in RESIDENT_KINDS:
                resident += e["bytes"]
        return {"total_bytes": resident,
                "by_kind": by_kind,
                "by_component": by_component,
                "entries": sorted(entries, key=lambda e: (e["component"],
                                                          e["name"]))}

    def reset(self):
        """Drop everything (tests only)."""
        with self._lock:
            components = {e["component"] for e in self._entries.values()}
            self._entries.clear()
            for c in components:
                self._publish(c)


_LEDGER = HBMLedger()


def hbm_ledger():
    return _LEDGER
