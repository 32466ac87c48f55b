"""Compile-plane observability of the port: the static cost analyzer,
``Executor.explain``'s report and the HBM ledger.

Counterpart of ``paddle_tpu/observability/compile_insight.py``, kept as
the port's own copy. The port compiles nothing, so the JAX module's XLA
extractor (``extract_xla_cost`` / ``extract_xla_memory``) and its
recompile-storm detector have no counterpart; its static half does:

- ``analyze_step`` (the counterpart of ``analyze_jaxpr``) runs a step on
  **meta** tensors, so nothing is computed, read or written: FLOPs under
  ``torch.utils.flop_counter.FlopCounterMode`` (the products: mm, bmm,
  addmm, convolution, attention), and per aten op the bytes of the fresh
  outputs it allocates (in-place results and views alias an input and
  count nothing); less the step's own outputs, those are the
  intermediates;
- ``analyze_program`` walks the Program's ops for the fluid-level
  attribution (per-op-type forward FLOPs by ``utils/model_stat``,
  parameter vs optimizer-state bytes, activation and feed bytes);
- ``explain_entry`` assembles the report ``Executor.explain`` returns,
  with the JAX report's keys: ``source`` is "static" for every field,
  ``xla`` holds ``None``s, and the walk's column is ``static["aten"]``
  (JAX's ``static["jaxpr"]``, the same keys inside; ``per_primitive``
  names aten ops).

The HBM ledger (``HBMLedger``, ``hbm_ledger``): bytes are ``numel() *
element_size()`` of the tensors a row stands for. The serving engine
registers its block pools (kind ``kv_cache``), its host KV tier
(``host_ram``, never summed into the resident total), its model's
parameters (``params``) and a static estimate of its fused step's peak
(``peak_hbm``); ``Executor.explain`` registers its estimate of a step's
peak (``peak_hbm``); ``/memory`` serves the snapshot.
"""

import threading

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from .metrics import global_registry

__all__ = ["array_nbytes", "analyze_step", "analyze_program",
           "explain_entry", "HBMLedger", "hbm_ledger", "RESIDENT_KINDS",
           "LEDGER_KINDS"]


def _help(name):
    from . import _help as pkg_help
    return pkg_help(name)


def array_nbytes(t):
    """Bytes of a tensor: numel() x element_size() (bf16 counts 2)."""
    return int(t.numel()) * int(t.element_size())


def _nbytes(t):
    return array_nbytes(t) if isinstance(t, torch.Tensor) else 0


def _var_nbytes(var, batch_size=1):
    """Static byte size of a Program variable, -1 dims resolved to
    `batch_size` (the JAX ``Variable.nbytes``)."""
    from ..ops import torch_dtype
    n = 1
    for d in var.shape:
        n *= batch_size if d in (-1, None) else int(d)
    return n * torch_dtype(var.dtype).itemsize


# ---------------------------------------------------------------------------
# static analyzer — the step on meta tensors (aten-level attribution)
# ---------------------------------------------------------------------------

class _FreshBytes(TorchDispatchMode):
    """Counts the aten calls and sums the bytes of the outputs each one
    allocates: an output that aliases an input (an in-place op's, a
    view's: its schema says so) allocates nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, o in enumerate(outs):
            alias = returns[i].alias_info if i < len(returns) else None
            if alias is None:
                self.bytes += sum(_nbytes(t) for t in tree_leaves(o))
        return out


def to_meta(value):
    """A tensor's (or a pytree of tensors') meta twin: its shape and
    dtype, no storage, nothing read."""
    if isinstance(value, torch.Tensor):
        return torch.empty_like(value, device="meta")
    if isinstance(value, dict):
        return {k: to_meta(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_meta(v) for v in value)
    return value


def analyze_step(step_fn, *args):
    """Backend-independent cost of ``step_fn(*args)``, run on meta twins
    of `args` (nothing is computed, read or written): total FLOPs and
    their attribution per aten op (FlopCounterMode: the products), the
    bytes of every fresh aten output less the step's own outputs (the
    intermediates), the outputs' bytes, and the aten calls made. The
    counterpart of JAX's ``analyze_jaxpr``, with its keys."""
    meta = to_meta(args)
    counter = FlopCounterMode(display=False)
    fresh = _FreshBytes()
    with counter, fresh:
        out = step_fn(*meta)
    out_bytes = sum(_nbytes(t) for t in tree_leaves(out))
    per = {str(k): int(v) for k, v in
           counter.get_flop_counts().get("Global", {}).items() if v}
    return {"flops": int(counter.get_total_flops()),
            "per_primitive": dict(sorted(per.items(),
                                         key=lambda kv: -kv[1])),
            "intermediate_bytes": int(max(0, fresh.bytes - out_bytes)),
            "out_bytes": int(out_bytes),
            "eqns": fresh.ops}


# ---------------------------------------------------------------------------
# static analyzer — Block/OpDesc walk (fluid-level attribution)
# ---------------------------------------------------------------------------

def analyze_program(program, feeds=None, state=None, batch_size=None):
    """Fluid-level static attribution for a Program: per-op-type forward
    FLOPs (utils/model_stat's hand-count rules), parameter vs optimizer-
    state bytes, activation and feed bytes. Byte numbers prefer the live
    values (`state` / `feeds`: their actual dtypes after a bf16 cast) and
    fall back to the declared var shapes with -1 batch dims resolved to
    `batch_size`."""
    from ..utils import model_stat

    if batch_size is None:
        batch_size = 1
        for v in (feeds or {}).values():
            shape = getattr(v, "shape", ())
            if len(shape) >= 1:
                batch_size = int(shape[0])
                break

    fwd_flops, per_op = model_stat.count_flops(program, batch_size)
    train = program.backward_marker() is not None
    param_names = {p.name for p in program.all_parameters()}

    def nbytes(v):
        return int(v.nbytes) if isinstance(v, np.ndarray) else _nbytes(v)

    if state:
        param_bytes = sum(nbytes(v) for n, v in state.items()
                          if n in param_names)
        optimizer_bytes = sum(nbytes(v) for n, v in state.items()
                              if n not in param_names)
    else:
        param_bytes = optimizer_bytes = 0
        for v in program.list_vars():
            if not v.persistable:
                continue
            b = _var_nbytes(v, batch_size)
            if v.name in param_names:
                param_bytes += b
            else:
                optimizer_bytes += b

    if feeds:
        feed_bytes = sum(nbytes(v) for v in feeds.values())
    else:
        feed_bytes = sum(_var_nbytes(v, batch_size)
                         for v in program.list_vars() if v.is_data)

    gb = program.global_block()
    activation_bytes = sum(
        _var_nbytes(v, batch_size) for v in gb.vars.values()
        if not v.persistable and not v.is_data and v.shape)

    return {
        "batch_size": batch_size,
        "train": train,
        "fwd_flops": int(fwd_flops),
        # the classic hand-count convention: train step ~ 3x forward
        "flops": int(fwd_flops) * (3 if train else 1),
        "per_op_type": dict(sorted(per_op.items(), key=lambda kv: -kv[1])),
        "param_bytes": int(param_bytes),
        "optimizer_bytes": int(optimizer_bytes),
        "feed_bytes": int(feed_bytes),
        "activation_bytes": int(activation_bytes),
        "num_ops": len(gb.ops),
    }


# ---------------------------------------------------------------------------
# report assembly (Executor.explain's engine)
# ---------------------------------------------------------------------------

def explain_entry(step_fn, args, program=None, state=None, feeds=None,
                  labels=None, backend=None, device=None):
    """The compile-plane report for one step: ``step_fn(*args)`` walked
    on meta tensors (``analyze_step``) beside the Program's attribution
    (``analyze_program``).

    The port compiles nothing and no backend reports a cost or memory
    analysis: `backend=None` (auto) and `backend=False` take the static
    path, and `backend=True`, which demands the backend's numbers,
    raises, as the JAX function does on a backend that reports none.

      flops          the meta walk's FlopCounterMode total
      bytes_accessed arg + out + 2 x intermediates
      peak_hbm_bytes arg + out + intermediates: every buffer the step
                     allocates, live at once (an upper bound: the walk
                     frees nothing), its in-place state updates aliasing
                     the state it was given
    """
    name = torch.device(device).type if device is not None else "cpu"
    if backend is True:
        raise RuntimeError(
            f"backend={name!r} reports no cost analysis for this entry "
            f"(the port compiles no step); use backend=None for the "
            f"static analysis")
    step_rep = analyze_step(step_fn, *args)
    prog_rep = analyze_program(program, feeds=feeds, state=state) \
        if program is not None else None
    arg_bytes = sum(_nbytes(t) for t in tree_leaves(args))
    out_bytes = step_rep["out_bytes"]
    inter = step_rep["intermediate_bytes"]
    static_peak = arg_bytes + out_bytes + inter
    static_bytes = arg_bytes + out_bytes + 2 * inter
    report = {
        "backend": name,
        "flops": step_rep["flops"],
        "bytes_accessed": static_bytes,
        "peak_hbm_bytes": static_peak,
        "source": {"flops": "static", "bytes": "static",
                   "peak_hbm": "static"},
        "xla": {"cost": None, "memory": None},
        "static": {"aten": step_rep, "program": prog_rep,
                   "arg_bytes": int(arg_bytes),
                   "out_bytes": int(out_bytes),
                   "donated_bytes": 0,
                   "bytes_accessed_est": int(static_bytes),
                   "peak_hbm_bytes_est": int(static_peak)},
        "memory": {
            "param_bytes": prog_rep["param_bytes"] if prog_rep else None,
            "optimizer_bytes": prog_rep["optimizer_bytes"]
            if prog_rep else None,
            "feed_bytes": prog_rep["feed_bytes"] if prog_rep else None,
            "activation_bytes": prog_rep["activation_bytes"]
            if prog_rep else None,
            "peak_hbm_bytes": static_peak,
        },
    }
    if labels:
        report.update(labels)
    return report


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
