"""DistributeTranspiler parity.

Parity: python/paddle/fluid/transpiler/distribute_transpiler.py; the
counterpart of ``paddle_tpu/parallel/transpiler.py``. The reference
rewrites a Program into trainer and pserver programs (send/recv ops,
parameter shards on servers). The port has no parameter servers: what
they delivered (parameters and optimizer state larger than one card)
maps onto the mesh, as in the JAX package:

  * sync mode   -> data parallelism (``CompiledProgram.
                   with_data_parallel``): the global batch's gradient,
                   sync SGD's numbers;
  * param shard -> ZeRO-1 (``shard_optimizer_state``: the accumulators
                   laid out over dp) and FSDP (``shard_params_fsdp``: the
                   parameters too). Both only annotate ``dist_attr``; the
                   data-parallel walk lays the state out by it
                   (``parallel/sharded.py``) and gathers a parameter where
                   an op reads it;
  * async mode  -> no counterpart on a synchronous mesh; raises with the
                   replacement.

``memory_optimize`` / ``release_memory`` warn and change nothing (torch's
caching allocator frees and reuses buffers at their last use), and
``GradAllReduce`` / ``LocalSGD`` raise with the replacement, as the JAX
package's do.
"""

import warnings

from .tensor_parallel import PartitionSpec as P

__all__ = ["DistributeTranspilerConfig", "DistributeTranspiler",
           "shard_optimizer_state", "shard_params_fsdp", "PSDispatcher",
           "HashName", "RoundRobin", "memory_optimize", "release_memory",
           "GradAllReduce", "LocalSGD"]

# the substrings that mark an optimizer accumulator by its name (the
# port names its accumulators as the JAX package does)
ACCUMULATOR_MARKS = ("moment", "velocity", "_acc", "squared", "mean_square",
                     "inf_norm", "linear")


class DistributeTranspilerConfig:
    def __init__(self):
        self.slice_var_up = True
        self.split_method = None
        self.min_block_size = 8192
        self.sync_mode = True
        self.mode = "collective"


class DistributeTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._program = None

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, startup_program=None, current_endpoint=""):
        """ZeRO-1 on `program` (the default main program): every
        parameter's optimizer accumulators laid out over dp."""
        from ..core.framework import default_main_program
        if not sync_mode:
            raise NotImplementedError(
                "async pserver training has no counterpart on a synchronous "
                "mesh; use sync data parallelism (CompiledProgram."
                "with_data_parallel) or sharded optimizer state "
                "(shard_optimizer_state, shard_params_fsdp)")
        self._program = program or default_main_program()
        self.trainer_id = trainer_id
        self.trainers = trainers
        shard_optimizer_state(self._program)
        return self

    def get_trainer_program(self, wait_port=True):
        return self._program

    def get_pserver_program(self, endpoint):
        raise NotImplementedError(
            "no parameter servers: the optimizer state is laid out over "
            "the dp axis instead (ZeRO) - see parallel/transpiler.py")

    def get_pserver_programs(self, endpoint):
        return self.get_pserver_program(endpoint)

    def get_startup_program(self, endpoint, pserver_program=None):
        from ..core.framework import default_startup_program
        return default_startup_program()


def shard_optimizer_state(program, axis="dp"):
    """ZeRO-1: annotate the optimizer accumulators (persistables that are
    not parameters, named as accumulators, with a leading dimension > 1)
    to lay out their leading dimension over `axis` (weight-update
    sharding, Xu et al. 2020)."""
    from ..core.framework import Parameter
    for v in program.list_vars():
        if not v.persistable or getattr(v, "is_data", False) or \
                isinstance(v, Parameter):
            continue
        looks_like_acc = any(t in v.name for t in ACCUMULATOR_MARKS)
        if looks_like_acc and len(v.shape) >= 1 and v.shape[0] and \
                v.shape[0] > 1:
            v.dist_attr = P(axis)
    return program


def shard_params_fsdp(program, axis="dp", min_size=1024):
    """ZeRO-3 / FSDP: annotate every parameter of at least `min_size`
    elements with a leading dimension > 1 to lay it out over `axis` along
    dim 0."""
    for p in program.all_parameters():
        if p.shape and p.shape[0] and p.shape[0] > 1 and \
                _numel(p.shape) >= min_size:
            p.dist_attr = P(axis)
    return program


def _numel(shape):
    n = 1
    for s in shape:
        n *= max(int(s), 1)
    return n


class PSDispatcher:
    """Parity: transpiler/ps_dispatcher.py PSDispatcher, the base of the
    var -> pserver placement policies. Kept with HashName / RoundRobin
    because DistributeTranspiler's config surface names them; here the
    dispatch only labels shards, the mesh places them."""

    def __init__(self, pserver_endpoints):
        self.pservers = pserver_endpoints

    def dispatch(self, varlist):
        raise NotImplementedError

    def reset(self):
        pass


class HashName(PSDispatcher):
    def dispatch(self, varlist):
        return [self.pservers[hash(v.name) % len(self.pservers)]
                for v in varlist]


class RoundRobin(PSDispatcher):
    def __init__(self, pserver_endpoints):
        super().__init__(pserver_endpoints)
        self._i = 0

    def dispatch(self, varlist):
        out = []
        for _v in varlist:
            out.append(self.pservers[self._i % len(self.pservers)])
            self._i += 1
        return out

    def reset(self):
        self._i = 0


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=True):
    """Parity no-op: fluid.transpiler.memory_optimize (the reference's
    memory_optimization_transpiler.py). The reference rewrites the
    program to reuse variables' buffers between non-overlapping live
    ranges; the port's Executor walks the Program eagerly and torch's
    caching allocator already reuses a buffer once its last reader has
    run, so a rewrite would change nothing. Kept callable so reference
    training scripts run unmodified."""
    warnings.warn(
        "memory_optimize is a no-op: torch's caching allocator already "
        "reuses buffers at their last use. Use RecomputeOptimizer for "
        "activation memory.", stacklevel=2)


def release_memory(input_program, skip_opt_set=None):
    """Parity no-op companion of memory_optimize (same rationale)."""
    warnings.warn("release_memory is a no-op: torch's caching allocator "
                  "frees buffers at their last use.", stacklevel=2)


class GradAllReduce:
    """Parity shim: transpiler/collective.py:178, the ring-allreduce
    gradient-sync transpiler. Data-parallel gradient sync needs no
    program rewrite here: the data-parallel walk sums the gradients over
    the mesh's dp axis. Construction works for config compatibility;
    transpile() raises with the replacement."""

    def __init__(self, nrings=2):
        self.nrings = nrings

    def transpile(self, startup_program=None, main_program=None,
                  rank=0, endpoints=None, current_endpoint=None,
                  wait_port=True):
        raise NotImplementedError(
            "GradAllReduce: the dp gradient all-reduce comes from the mesh "
            "- run the program through CompiledProgram.with_data_parallel "
            "(a torch.distributed world, or places) instead of "
            "transpiling. See MIGRATION.md.")


class LocalSGD:
    """Parity shim: transpiler/collective.py:269, K local steps then an
    average. Its goal (fewer syncs) maps to gradient merging
    (GradientMergeOptimizer: K steps accumulated, one sync)."""

    def __init__(self, nrings=2):
        self.nrings = nrings

    def transpile(self, *a, **k):
        raise NotImplementedError(
            "LocalSGD: use GradientMergeOptimizer (K-step gradient "
            "accumulation with one sync): the same communication saving, "
            "no staleness. See MIGRATION.md.")
