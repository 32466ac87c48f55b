"""CompiledProgram / ParallelExecutor: data parallelism.

Parity: python/paddle/fluid/compiler.py + parallel_executor.py; the
counterpart of ``paddle_tpu/core/compiler.py``. The JAX package runs the
same jitted whole-batch step under a mesh: its feeds are only laid out
over "dp", and GSPMD makes every result the single-device one (the
global batch's loss, its gradient, its fetches). The port splits the
batch and walks the Program once a rank, and keeps those global-batch
semantics (not Fluid's average of per-card gradients of per-card
losses, which differs for a weighted mean such as BERT's masked-LM loss
whenever ranks hold different numbers of masked tokens):

- feeds split along dim 0 over "dp" where dp divides it, else stay
  replicated; persistables stay replicated (the scope's tensors);
- ``Executor.run`` walks the op list once. An op whose inputs are all
  replicated runs once; an op with a dp-sharded input goes through its
  dp rule (``ops/__init__.py``): once a held rank on its rows, or a
  global reduction (``mean``, ``reduce_sum`` over dim 0, ``accuracy``)
  finished by the mesh's dp sum into a replicated value, or ``gather``
  from the whole source; an op without a rule raises;
- on a local mesh (every rank in this process, in turn) one autograd
  graph spans the ranks, so ``torch.autograd.grad`` of the replicated
  loss is the global gradient; in a ``torch.distributed`` world (one
  rank a process) each rank seeds 1/dp of the replicated loss's
  gradient, so the gradient of every replicated value is held as
  partials that sum over dp to the whole: the reductions' backward
  all-reduces them (the rows then take their whole gradient), and one
  fused all-reduce (``BuildStrategy.fuse_all_reduce_ops``) sums the
  parameters' before the ops after the backward marker run. Every path
  from a parameter to the loss counts once: through the rows, after a
  reduction (``mean(x) * w``), beside the batch (a penalty on ``w``), or
  a whole step left replicated (a batch dp does not divide);
- a sharded fetch is the rank-order concatenation along dim 0 (in a
  world all-gathered), as the JAX fetch of the global value.

``with_mesh(mesh)`` takes a mesh with "dp" and "sp" axes: under sp the
walk activates the sp axis alone, so each rank's attention takes the ring
over its own rows. Refused with ``NotImplementedError``: a mesh whose
tp, pp or ep is larger than 1, a persistable whose ``dist_attr`` shards
over an axis larger than 1 (tensor-parallel Program training, ZeRO-1 and
FSDP are ROADMAP queue A item 10d), a world mesh with any axis but dp,
and a local mesh over several devices. A ``RecomputeOptimizer`` program
runs under the walk (``Executor.run``).
"""

import os

import torch

from ..ops import Sharded
from .executor import Executor
from .framework import default_main_program

# the ROADMAP item of the sharded-state forms the walk refuses
SHARDED_STATE_ITEM = "ROADMAP queue A item 10d"


class BuildStrategy:
    """Parity: fluid.BuildStrategy. The knobs are kept for API
    compatibility; the dp walk reads ``fuse_all_reduce_ops`` (one
    all-reduce of the flattened gradients in a world, else one a
    gradient) and ``sync_batch_norm`` (the op rewrite). Nothing reads
    ``gradient_scale_strategy``, as in the JAX package: the walk always
    computes the global-batch gradient."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.memory_optimize = True
        self.enable_inplace = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        # reference compiler.py:322 swaps batch_norm -> sync_batch_norm;
        # the two share one dp rule (global-batch statistics either way)
        self.sync_batch_norm = False


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


def _cuda_places():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "data parallelism over the visible CUDA devices requested but "
            "CUDA is not available; pass places=[CPUPlace()] * n to run "
            "on the CPU")
    from .place import CUDAPlace
    return [CUDAPlace(i) for i in range(n)]


def _dp_mesh(places):
    """The 1-D dp mesh of `places`: the torch.distributed world when
    `places` is None and one is initialized, else a local mesh over the
    places' devices (every visible CUDA device when None)."""
    import torch.distributed as dist
    from ..parallel.mesh import make_mesh
    if places is None and dist.is_available() and dist.is_initialized():
        return make_mesh()
    places = _cuda_places() if places is None else list(places)
    return make_mesh(dp=len(places),
                     devices=[p.torch_device() for p in places])


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self.program = program_or_graph
        self.build_strategy = build_strategy or BuildStrategy()
        self._data_parallel = False
        self._mesh = None
        self.places = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """Run over a dp mesh of `places` (one rank a place; repeats run
        several ranks on one device, in turn): every visible CUDA device
        by default, or the torch.distributed world when one is
        initialized. Raises without CUDA unless `places` says the CPU."""
        self._data_parallel = True
        if build_strategy is not None:
            self.build_strategy = build_strategy
        self._mesh = _dp_mesh(places)
        self.places = places
        if getattr(self.build_strategy, "sync_batch_norm", False):
            for block in self.program.blocks:
                for op in block.ops:
                    if op.type == "batch_norm":
                        op.type = "sync_batch_norm"
        return self

    def with_mesh(self, mesh):
        """Run over a named mesh (``parallel.make_mesh``): feeds split
        over its 'dp' axis, attention rings over its 'sp' axis."""
        self._data_parallel = True
        self._mesh = mesh
        return self

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = _dp_mesh(None)
        return self._mesh

    def _walk(self, device):
        """The dp walk of one run on `device`, or None when this program
        is not data parallel."""
        if not self._data_parallel:
            return None
        return DataParallelWalk(self.mesh, device,
                                self.build_strategy.fuse_all_reduce_ops)


class ParallelExecutor:
    """Parity: fluid.ParallelExecutor, a facade over CompiledProgram +
    Executor with a dp mesh: ``use_cuda`` means every visible CUDA
    device (or the torch.distributed world), ``use_cuda=False`` the CPU
    with ``CPU_NUM`` ranks (Fluid's variable, 1 by default). Several
    ranks on one device go through ``with_data_parallel(places=)``."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None):
        from .place import CPUPlace
        places = None if use_cuda else \
            [CPUPlace()] * int(os.environ.get("CPU_NUM", "1"))
        self.program = main_program or default_main_program()
        self.compiled = CompiledProgram(self.program, build_strategy)
        self.compiled.with_data_parallel(
            loss_name=loss_name, exec_strategy=exec_strategy,
            share_vars_from=share_vars_from, places=places)
        self.executor = Executor(places[0] if places else None)
        self.scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self.executor.run(self.compiled, feed=feed,
                                 fetch_list=fetch_list, scope=self.scope,
                                 return_numpy=return_numpy)


def _same_device(a, b):
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    return a.type != "cuda" or (a.index or 0) == (b.index or 0)


class DataParallelWalk:
    """One run's data-parallel state: the mesh, its dp size, the dp ranks
    this process holds (every rank of a local mesh, its own in a world)
    and the collectives the ops' dp rules call (``sum``, ``cat``)."""

    def __init__(self, mesh, device, fuse=True):
        if "dp" not in mesh.shape:
            raise ValueError(f"{mesh} has no 'dp' axis")
        for axis, size in mesh.shape.items():
            if axis == "sp" and size > 1 and mesh.world:
                raise NotImplementedError(
                    "sequence parallelism under a data-parallel world mesh "
                    "is not ported: the world form takes dp-only meshes")
            if axis not in ("dp", "sp") and size > 1:
                raise NotImplementedError(
                    f"a mesh with {axis}={size} under CompiledProgram is not "
                    f"ported ({SHARDED_STATE_ITEM} for tp, item 11 for pp "
                    f"and ep); only dp and sp run")
        if not mesh.world and not all(
                _same_device(d, device) for d in mesh.devices.flat):
            raise NotImplementedError(
                f"a local mesh runs every rank on the Executor's device "
                f"{device}; got {list(mesh.devices.flat)} (start one "
                f"process a card, a torch.distributed world, for several)")
        self.mesh = mesh
        self.size = mesh.shape["dp"]
        self.ranks = mesh.held("dp")
        self.world = mesh.world
        self.fuse = fuse
        self.device = device

    # -- the ops' collectives ------------------------------------------------
    def sum(self, parts):
        return self.mesh.all_sum(parts, "dp")

    def cat(self, parts):
        return self.mesh.all_concat(parts, "dp")

    # -- the run -------------------------------------------------------------
    def check_state(self, program):
        """Refuse a persistable laid out over a mesh axis larger than 1:
        the walk keeps the state replicated and never drops a layout
        silently."""
        for v in program.list_vars():
            spec = getattr(v, "dist_attr", None) if v.persistable else None
            for entry in (spec or ()):
                for axis in (entry if isinstance(entry, tuple)
                             else (entry,)):
                    if axis is not None and self.mesh.shape.get(axis, 1) > 1:
                        raise NotImplementedError(
                            f"persistable '{v.name}' has dist_attr {spec}, "
                            f"sharded over {axis}={self.mesh.shape[axis]}: "
                            f"sharded state under CompiledProgram "
                            f"(tensor-parallel Program training, ZeRO-1, "
                            f"FSDP) is {SHARDED_STATE_ITEM}")

    def split_feeds(self, feeds):
        """Each feed's rows over dp where dp divides dim 0 (JAX's
        ``_shard_feeds_spec``'s batch rule), else replicated."""
        out = {}
        for name, t in feeds.items():
            if t.dim() == 0 or t.shape[0] % self.size:
                out[name] = t
                continue
            parts = torch.chunk(t, self.size)
            out[name] = Sharded([parts[r] for r in self.ranks])
        return out

    def active(self):
        """The context the ops run in: under sp > 1, a local mesh of the
        sp axis alone (each rank's attention rings over its own rows)."""
        import contextlib
        from ..parallel.mesh import make_named_mesh
        sp = self.mesh.shape.get("sp", 1)
        if sp <= 1:
            return contextlib.nullcontext()
        return make_named_mesh(("sp",), (sp,), [self.device] * sp)

    def loss(self, value):
        """The scalar the backward differentiates: a replicated loss's
        sum, or the dp sum of a sharded loss's row sums; in a world 1/dp
        of it, this rank's share of the seed (each replicated value's
        gradient is then this rank's partial of the whole)."""
        if isinstance(value, Sharded):
            value = self.sum([p.sum() for p in value.parts])
        total = value.sum()
        return total / self.size if self.world else total

    def reduce_grads(self, grads):
        """The global gradients: on a local mesh autograd already summed
        the ranks; a world sums the ranks' partials over dp."""
        if not self.world:
            return grads
        return self.mesh.all_reduce_grads(grads, "dp", fuse=self.fuse)

    def fetch(self, value):
        """A sharded value -> the global one (rank-order concatenation
        along dim 0; a world all-gathers); a replicated one as is."""
        if not isinstance(value, Sharded):
            return value
        if self.world:
            return self.mesh.gather_rows(value.parts[0].detach(), "dp")
        return torch.cat([p.detach() for p in value.parts])
