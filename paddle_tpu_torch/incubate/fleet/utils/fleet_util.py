"""Fleet utilities.

Parity: python/paddle/fluid/incubate/fleet/utils/fleet_util.py:46
(``FleetUtil``); the counterpart of
``paddle_tpu/incubate/fleet/utils/fleet_util.py``. The portable methods
are implemented; the pslib Downpour-table methods (xbox donefiles, cache
models, table push / pull) raise with guidance: publishing pserver table
shards has no counterpart where checkpoints are whole-state or sharded
saves (``io/checkpoint.py``).
"""

import logging
import re

import numpy as np

from ....parallel.fleet import fleet

__all__ = ["FleetUtil"]

_logger = logging.getLogger("FleetUtil")


def _brace_expand(spec):
    """'{a..b}' -> list of values, zero-padded like bash brace expansion
    (the reference shells out to ``echo -n {20190720..20190729}``)."""
    spec = str(spec).strip()
    m = re.fullmatch(r"\{(\d+)\.\.(\d+)\}", spec)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo) if lo.startswith("0") else 0
        return [str(v).zfill(width) for v in range(int(lo), int(hi) + 1)]
    return spec.split()


def _host(value):
    """A scope value (a tensor or an array) as a float64 numpy array."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value, dtype=np.float64)


def _allreduce_sum(x):
    """A host numpy array summed over the fleet's processes (itself in
    one process; the reference uses an MPI Allreduce): a gloo-free
    ``all_gather_object``, whatever backend the world runs."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return x
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, np.asarray(x))
    return np.sum(every, axis=0)


class FleetUtil:
    def rank0_print(self, s):
        if fleet.worker_index() == 0:
            print(s)

    def rank0_info(self, s):
        if fleet.worker_index() == 0:
            _logger.info(s)

    def rank0_error(self, s):
        if fleet.worker_index() == 0:
            _logger.error(s)

    def set_zero(self, var_name, scope=None, place=None,
                 param_type="int64"):
        """Zero a scope variable in place (ref fleet_util.py:107)."""
        from ....core.executor import global_scope
        scope = scope or global_scope()
        cur = scope.get(var_name)
        scope.set(var_name, np.zeros(tuple(cur.shape), dtype=param_type))

    def get_global_auc(self, scope=None, stat_pos="stat_pos",
                       stat_neg="stat_neg"):
        """Exact AUC from the all-reduced auc stat buckets
        (ref fleet_util.py:172-246: reversed-bucket trapezoid walk).
        Works on the (n,) stat arrays our auc layer keeps (the reference
        stores them (1, n))."""
        from ....core.executor import global_scope
        scope = scope or global_scope()
        raw_pos, raw_neg = scope.get(stat_pos), scope.get(stat_neg)
        if raw_pos is None or raw_neg is None:
            self.rank0_print("not found auc bucket")
            return None
        pos = _host(raw_pos)
        neg = _host(raw_neg)
        fleet.barrier_worker()
        pos = _allreduce_sum(pos.reshape(-1))
        neg = _allreduce_sum(neg.reshape(-1))
        # reversed walk: high scores first, trapezoid area over the
        # (fp, tp) curve, normalized by pos*neg
        tp = np.cumsum(pos[::-1])
        fp = np.cumsum(neg[::-1])
        area = float(np.sum((fp - np.concatenate([[0.0], fp[:-1]]))
                            * (np.concatenate([[0.0], tp[:-1]]) + tp) / 2))
        total_pos, total_neg = float(tp[-1]), float(fp[-1])
        fleet.barrier_worker()
        if total_pos * total_neg == 0 or total_pos + total_neg == 0:
            return 0.5
        return area / (total_pos * total_neg)

    def print_global_auc(self, scope=None, stat_pos="stat_pos",
                         stat_neg="stat_neg", print_prefix=""):
        auc_value = self.get_global_auc(scope, stat_pos, stat_neg)
        self.rank0_print(f"{print_prefix} global auc = {auc_value}")

    def get_online_pass_interval(self, days, hours, split_interval,
                                 split_per_pass, is_data_hourly_placed):
        """Split a training day into pass buckets (ref :1073-1133);
        brace specs like '{0..23}' expand as in bash."""
        hours = _brace_expand(hours)
        split_interval = int(split_interval)
        split_per_pass = int(split_per_pass)
        splits_per_day = 24 * 60 // split_interval
        pass_per_day = splits_per_day // split_per_pass
        left, right = int(hours[0]), int(hours[-1])

        split_path = []
        start = 0
        for _ in range(splits_per_day):
            h, m = start // 60, start % 60
            start += split_interval
            if h < left or h > right:
                continue
            split_path.append(f"{h:02d}" if is_data_hourly_placed
                              else f"{h:02d}{m:02d}")

        online_pass_interval = []
        start = 0
        for _ in range(pass_per_day):
            chunk = split_path[start:start + split_per_pass]
            if not chunk:
                break
            online_pass_interval.append(chunk)
            start += split_per_pass
        return online_pass_interval

    # -- pslib Downpour-table publishing: documented non-ports ----------
    def _pslib_only(self, name):
        raise NotImplementedError(
            f"FleetUtil.{name} publishes pslib pserver table shards, which "
            "do not exist in the port: checkpoints are whole-state or "
            "sharded saves; use io/checkpoint.py or "
            "fleet.save_persistables.")

    def load_fleet_model(self, *a, **k):
        self._pslib_only("load_fleet_model")

    def load_fleet_model_one_table(self, *a, **k):
        self._pslib_only("load_fleet_model_one_table")

    def save_fleet_model(self, *a, **k):
        self._pslib_only("save_fleet_model")

    def write_model_donefile(self, *a, **k):
        self._pslib_only("write_model_donefile")

    def write_xbox_donefile(self, *a, **k):
        self._pslib_only("write_xbox_donefile")

    def write_cache_donefile(self, *a, **k):
        self._pslib_only("write_cache_donefile")

    def save_cache_model(self, *a, **k):
        self._pslib_only("save_cache_model")

    def pull_all_dense_params(self, *a, **k):
        self._pslib_only("pull_all_dense_params")
