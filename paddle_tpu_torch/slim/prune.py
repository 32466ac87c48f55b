"""Magnitude pruning with persistent masks.

Parity: the reference's slim PruneStrategy / Pruner (ratio-based
magnitude pruning of conv / fc weights, the masks re-applied so that the
pruned weights stay zero through training); the counterpart of
``paddle_tpu/slim/prune.py``. The mask is a non-trainable persistable
parameter, and the mask multiply an ``elementwise_mul`` appended after
the optimizer's ops, writing the weight's own name. The masks are
chosen on the host (``np.partition``: a tie at the threshold is pruned
with it) and live in the scope as tensors on the weight's device.
``AutoPruneStrategy`` needs the NAS controllers (``slim/nas.py``), which
are not ported (ROADMAP item 11).
"""

import numpy as np
import torch

from ..core.framework import Parameter
from .. import initializer as init_mod


def _host(value):
    """A scope entry as a numpy array (a copy of a tensor's values)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(value, copy=True)


def _like(array, value):
    """A numpy array as a tensor on the device of the scope entry
    `value`."""
    dev = value.device if isinstance(value, torch.Tensor) else "cpu"
    return torch.from_numpy(np.ascontiguousarray(array)).to(dev)


def magnitude_mask(value, ratio):
    """Zero out the `ratio` smallest-|w| entries. Returns a 0/1 mask."""
    v = _host(value)
    k = int(ratio * v.size)
    if k <= 0:
        return np.ones_like(v)
    thresh = np.partition(np.abs(v).ravel(), k - 1)[k - 1]
    return (np.abs(v) > thresh).astype(v.dtype)


def sensitivity_prune_ratios(param_names, base_ratio=0.5, decay=1.0):
    """Uniform (or geometrically decaying) ratio schedule per param —
    the reference's uniform PruneStrategy default."""
    return {n: base_ratio * (decay ** i) for i, n in enumerate(param_names)}


class Pruner:
    """prune(program, scope, ratios): compute masks from current weights,
    install them as persistable mask params, and append mask-multiply ops
    so every optimizer step re-zeros pruned weights."""

    def __init__(self, criterion="magnitude"):
        assert criterion == "magnitude"
        self.masks = {}

    def prune(self, program, scope, ratios, startup_program=None):
        block = program.global_block()
        startup_block = (startup_program.global_block()
                         if startup_program is not None else None)
        for name, ratio in ratios.items():
            var = block._find_var_recursive(name)
            if var is None or not isinstance(var, Parameter):
                raise ValueError(f"no parameter named {name}")
            value = scope.get(name)
            if value is None:
                raise RuntimeError(
                    f"{name} not materialized; run startup first")
            mask = magnitude_mask(value, ratio)
            mask_name = f"{name}.prune_mask"
            mparam = block.create_parameter(
                name=mask_name, shape=list(mask.shape), dtype=str(mask.dtype),
                trainable=False)
            init_mod.NumpyArrayInitializer(mask)(mparam, startup_block)
            # the mask lives in the scope at once too (no second startup),
            # and the weight is masked in place
            mask_t = _like(mask, value)
            scope.set(mask_name, mask_t)
            if isinstance(value, torch.Tensor):
                with torch.no_grad():
                    value.mul_(mask_t)
            else:
                scope.set(name, _like(_host(value) * mask, value))
            # re-mask after the update ops so pruned weights stay zero
            block.append_op("elementwise_mul",
                            {"X": [name], "Y": [mask_name]},
                            {"Out": [name]}, {"axis": -1})
            self.masks[name] = mask
        return program

    def sparsity(self, scope, names=None):
        names = names or list(self.masks)
        out = {}
        for n in names:
            out[n] = float((_host(scope.get(n)) == 0).mean())
        return out


class StructurePruner:
    """Whole-filter (structured) pruning decisions.

    Parity: contrib/slim/prune/pruner.py:StructurePruner — picks which
    output channels of a conv/fc weight to remove by group L1 norm.
    Here pruned channels are MASKED (zeroed via the persistent-mask
    mechanism) rather than physically resized: XLA's fused mask multiply
    is free, while shape-changing surgery would force a recompile per
    ratio and break alignment-friendly static shapes on the MXU.
    """

    def __init__(self, pruning_axis=None, criterions=None):
        self.pruning_axis = pruning_axis or {"*": 0}
        self.criterions = criterions or {"*": "l1_norm"}

    def cal_pruned_idx(self, name, param, ratio, axis=None):
        """Indexes of the `ratio` lowest-L1 slices along `axis`."""
        v = _host(param)
        if axis is None:
            axis = self.pruning_axis.get(name, self.pruning_axis.get("*", 0))
        prune_num = int(round(ratio * v.shape[axis]))
        reduce_axes = tuple(i for i in range(v.ndim) if i != axis)
        scores = np.abs(v).sum(axis=reduce_axes)
        return np.argsort(scores)[:prune_num]

    def structure_mask(self, param, pruned_idx, axis=0):
        v = _host(param)
        mask = np.ones_like(v)
        index = [slice(None)] * v.ndim
        index[axis] = np.asarray(pruned_idx, dtype=np.int64)
        mask[tuple(index)] = 0
        return mask


from .core import Strategy  # noqa: E402  (after the mask helpers above)


class PruneStrategy(Strategy):
    """Base pruning strategy (ref prune_strategy.py:PruneStrategy):
    at start_epoch, install magnitude masks for params matching
    `pruned_params` at `target_ratio`."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=0,
                 target_ratio=0.5, metric_name=None,
                 pruned_params="conv.*weights"):
        super().__init__(start_epoch, end_epoch)
        self.pruner = pruner or Pruner()
        self.target_ratio = target_ratio
        self.metric_name = metric_name
        self.pruned_params = pruned_params

    def _matched_params(self, context):
        import re
        pat = re.compile(self.pruned_params)
        return [p.name() for p in context.train_graph.all_parameters()
                if pat.match(p.name()) and not p.name().endswith(
                    ".prune_mask")]

    def _ratios(self, context):
        return {n: self.target_ratio for n in self._matched_params(context)}

    def _eval_metric(self, context):
        """Mean of the chosen eval fetch over context.eval_reader (same
        feed contract as Compressor._eval: dict batches pass through,
        sequences zip with context.eval_feed_list)."""
        from ..core.executor import Executor, scope_guard
        if context.eval_graph is None or context.eval_reader is None:
            return None
        exe = Executor(context.place)
        fetch = self.metric_name or next(
            iter(context.eval_graph.out_nodes.values()), None)
        if fetch is None:
            return None
        vals = []
        for data in context.eval_reader():
            feed = (data if isinstance(data, dict)
                    else dict(zip(context.eval_feed_list, data)))
            with scope_guard(context.scope):
                out = exe.run(context.eval_graph.program, feed=feed,
                              fetch_list=[fetch])
            vals.append(float(np.asarray(out[0]).reshape(-1)[0]))
        return float(np.mean(vals)) if vals else None

    def on_epoch_begin(self, context):
        if context.epoch_id != self.start_epoch:
            return
        ratios = self._ratios(context)
        if ratios:
            self.pruner.prune(context.train_graph.program, context.scope,
                              ratios)


class UniformPruneStrategy(PruneStrategy):
    """Same ratio everywhere (ref prune_strategy.py:UniformPruneStrategy)."""


class SensitivePruneStrategy(PruneStrategy):
    """Sensitivity-weighted ratios (ref SensitivePruneStrategy):
    params whose masking hurts the eval metric least get pruned more.
    Sensitivity of p = metric drop when p alone is pruned at
    `probe_ratio`; ratios scale inversely with normalized sensitivity
    around target_ratio (capped to [0, 0.9])."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=0,
                 target_ratio=0.5, metric_name=None,
                 pruned_params="conv.*weights", probe_ratio=0.3):
        super().__init__(pruner, start_epoch, end_epoch, target_ratio,
                         metric_name, pruned_params)
        self.probe_ratio = probe_ratio

    def _ratios(self, context):
        names = self._matched_params(context)
        base = self._eval_metric(context)
        if base is None:
            return {n: self.target_ratio for n in names}
        sens = {}
        for n in names:
            value = context.scope.get(n)
            saved = _host(value)
            masked = saved * magnitude_mask(saved, self.probe_ratio)
            context.scope.set(n, _like(masked, value))
            metric = self._eval_metric(context)
            context.scope.set(n, value)
            sens[n] = max(base - (metric if metric is not None else base),
                          0.0)
        mean_s = np.mean(list(sens.values())) or 1.0
        return {n: float(np.clip(
            self.target_ratio * (2 - sens[n] / mean_s), 0.0, 0.9))
            for n in names}


class AutoPruneStrategy(PruneStrategy):
    """The reference's simulated-annealing search over per-parameter
    ratios (auto_prune_strategy.py). Not ported: it needs
    ``slim/nas.py``'s SAController, which waits for ROADMAP item 11."""

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "AutoPruneStrategy searches its ratios with slim/nas.py's "
            "SAController, which paddle_tpu_torch does not port yet "
            "(ROADMAP item 11); use UniformPruneStrategy or "
            "SensitivePruneStrategy")
