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

Sharded state (JAX's ``_run_data_parallel`` with ``_var_sharding``): a
persistable whose ``dist_attr`` (``apply_shard_rules``, the transpiler's
``shard_optimizer_state`` / ``shard_params_fsdp``) lays it out over the
mesh is cut at the walk's first run into a ``parallel.sharded.
ShardedTensor`` (each held position keeps only its block; the spec's
axes the mesh lacks are dropped, a dimension they do not divide stays
replicated), and stays sharded; a value laid out otherwise (left whole
by a plain ``Executor.run``, or by another mesh) is cut again. An op
reads a sharded value through its shard rule (``ops/__init__.py``: the
Megatron rules over "tp", the optimizers' blockwise update), else
through its global value (``ShardedTensor.gather``, counted in
``reductions``; in a world an all-gather whose backward is a
reduce-scatter, so a sharded gradient comes back whole for its rows and
skips the fused all-reduce). The walk's autograd leaves are the parts,
so ``name@GRAD`` comes out sharded like its parameter. The numbers are
the unsharded run's (a tp mesh's partial sums add in rank order).

``with_mesh(mesh)`` takes a mesh with "dp", "sp" and "tp" axes, in any
mix, local or over a ``torch.distributed`` world. Feeds split their rows
over dp (a tp mesh at dp 1 keeps them whole); the shard rules run once a
held dp rank on its rows, so a tp rank's heads and products sit inside
its dp rank's batch; under sp the walk activates the sp line (``active``:
on a local mesh a mesh of the sp axis alone on the Executor's device, in
a world ``Mesh.line_mesh("sp")``, this process's sp line), and each
rank's attention takes the ring over it: a world's K/V rotate between
processes. Every sp rank holds its dp rank's whole sequence; the ring
takes its own time block at the attention and gathers the outputs
(``ring_attention_sharded``), where JAX lays the feeds' dim 1 out over
sp and GSPMD keeps the same global step (ROADMAP C).

A world's gradient bookkeeping keeps one rule: a gradient is a partial
over every axis along which its value is replicated, and whole along the
axes where it is laid out. Each rank seeds 1 / (dp sp tp) of the
replicated loss's gradient; a row-parallel sum's backward all-reduces the
tp partials it is handed (as the dp sum's does over dp); then
``reduce_grads`` all-reduces each gradient over the axes its parameter is
replicated along (a replicated parameter's over dp, sp and tp, a
tp-sharded one's over dp and sp, an FSDP one's over sp and tp), one fused
all-reduce a line. A world seeds and sums over pp and ep too: a value
replicated over them is held as partials there as well.

Pipeline and expert parallelism (item 11a). A Program that
``PipelineOptimizer`` tagged runs its forward over a mesh with pp > 1
through ``parallel/pipeline.py``'s ``build_pipelined_forward`` (GPipe
over microbatches: on a local mesh every stage in this process, tick by
tick; in a world one stage a rank, the cut tensor sent down the pp line
and its cotangent back up); every parameter reaches its stages whole,
so under pp x tp the tp axis only places the state, as JAX's
``in_specs=(P(), P(), P())``. In a world each rank seeds its stage's part
of the loss and every gradient is all-reduced over pp. A Program without
the tag runs its whole step on every pp position. Under ep the expert
weights (``layers.moe``'s ``dist_attr ("ep", None, None)``) are laid out
over ep, E / ep experts a position, the ``moe`` op splits its tokens
over ep (its shard rule, ``ops/collective_ops.py``) and the other ops run
replicated. Refused with ``NotImplementedError``: a local mesh over
several devices; a pipelined Program beside dp, sp or ep, under
recompute or under amp (queued: no JAX test holds them). A
``RecomputeOptimizer`` program runs under the walk (``Executor.run``).
"""

import os

import torch

from ..ops import Sharded
from ..parallel.sharded import ShardedTensor, is_replicated, placement_spec
from .executor import Executor
from .framework import default_main_program

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
        over its 'dp' axis, attention rings over its 'sp' axis, the
        tp rules split heads and products over its 'tp' axis, and each
        persistable is laid out by its ``dist_attr``."""
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
                                self.build_strategy.fuse_all_reduce_ops,
                                self.program)


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
    """One run's state over a mesh: the mesh, its dp size, the dp ranks
    this process holds (every rank of a local mesh, its own in a world),
    the collectives the ops' dp rules call (``sum``, ``cat``), the
    placement of the sharded state and the run's gathers of it, and
    whether `program`'s forward runs pipelined (``pipelined``)."""

    def __init__(self, mesh, device, fuse=True, program=None):
        if "dp" not in mesh.shape:
            raise ValueError(f"{mesh} has no 'dp' axis")
        dp, tp, sp = (mesh.shape.get(a, 1) for a in ("dp", "tp", "sp"))
        pp, ep = mesh.shape.get("pp", 1), mesh.shape.get("ep", 1)
        if not mesh.world and not all(
                _same_device(d, device) for d in mesh.devices.flat):
            raise NotImplementedError(
                f"a local mesh runs every rank on the Executor's device "
                f"{device}; got {list(mesh.devices.flat)} (start one "
                f"process a card, a torch.distributed world, for several)")
        self.mesh = mesh
        self.size = dp
        self.tp = tp
        self.sp = sp
        self.pp = pp
        self.ep = ep
        self.pipelined = pp > 1 and \
            getattr(program, "_pipeline", None) is not None
        # the axes a replicated value is replicated along
        self.axes = tuple(a for a in ("dp", "pp", "ep", "sp", "tp")
                          if mesh.shape.get(a, 1) > 1)
        self.ranks = mesh.held("dp")
        self.world = mesh.world
        self.fuse = fuse
        self.device = device
        # id(ShardedTensor) -> (the value, its parts' versions, the
        # gathered global tensor): one gather a value and version a run
        self._gathered = {}

    # -- the ops' collectives ------------------------------------------------
    def sum(self, parts):
        return self.mesh.all_sum(parts, "dp")

    def cat(self, parts):
        return self.mesh.all_concat(parts, "dp")

    def gather(self, value):
        """A sharded value's global tensor as an op reads it
        (``ShardedTensor.gather``: differentiable, counted), gathered once
        a run while its parts are unchanged."""
        versions = tuple(p._version for p in value.parts)
        hit = self._gathered.get(id(value))
        if hit is not None and hit[0] is value and hit[1] == versions:
            return hit[2]
        full = value.gather()
        self._gathered[id(value)] = (value, versions, full)
        return full

    # -- the run -------------------------------------------------------------
    def place_state(self, program, scope):
        """Lay each persistable out as JAX's ``_run_data_parallel``
        places it: by its ``dist_attr`` through ``placement_spec``
        (``_var_sharding``), replicated without one. A value already laid
        out so stays; any other is cut again from its global value."""
        for v in program.list_vars():
            if not v.persistable:
                continue
            val = scope.get(v.name)
            if not isinstance(val, (torch.Tensor, ShardedTensor)):
                continue
            spec = placement_spec(getattr(v, "dist_attr", None),
                                  tuple(val.shape), self.mesh)
            if isinstance(val, ShardedTensor):
                if val.same_layout(spec, self.mesh):
                    continue
                val = val.full()
            if is_replicated(spec):
                scope.set(v.name, val)
            else:
                scope.set(v.name, ShardedTensor.cut(val, spec, self.mesh))

    def split_feeds(self, feeds):
        """Each feed's rows over dp where dp divides dim 0 (JAX's
        ``_shard_feeds_spec``'s batch rule), else replicated. A tp, pp
        or ep mesh at dp 1 keeps every feed whole. The time axis stays
        whole on every sp rank (the ring takes its block at the
        attention)."""
        if self.size == 1 and max(self.tp, self.pp, self.ep) > 1:
            return dict(feeds)
        out = {}
        for name, t in feeds.items():
            if t.dim() == 0 or t.shape[0] % self.size:
                out[name] = t
                continue
            parts = torch.chunk(t, self.size)
            out[name] = Sharded([parts[r] for r in self.ranks])
        return out

    def active(self):
        """The context the ops run in: under sp > 1 the sp line each
        rank's attention rings over, its own rows: on a local mesh a mesh
        of the sp axis alone on the Executor's device, in a world this
        process's sp line (``Mesh.line_mesh``), whose K/V rotate between
        processes."""
        import contextlib
        from ..parallel.mesh import make_named_mesh
        if self.sp <= 1:
            return contextlib.nullcontext()
        if self.world:
            return self.mesh.line_mesh("sp")
        return make_named_mesh(("sp",), (self.sp,), [self.device] * self.sp)

    def loss(self, value):
        """The scalar the backward differentiates: a replicated loss's
        sum, or the dp sum of a sharded loss's row sums; in a world 1 /
        the product of ``axes``' sizes of it, this rank's share of the
        seed (each replicated value's gradient is then this rank's
        partial of the whole)."""
        if isinstance(value, Sharded):
            value = self.sum([p.sum() for p in value.parts])
        total = value.sum()
        if not self.world:
            return total
        return total / self.replicas()

    def replicas(self, skip=()):
        """The product of the sizes of ``axes`` but `skip`."""
        n = 1
        for a in self.axes:
            if a not in skip:
                n *= self.mesh.shape[a]
        return n

    def reduce_grads(self, grads):
        """The global gradients: on a local mesh autograd already summed
        the ranks; a world all-reduces each gradient over the axes its
        value is replicated along (whole along those it is laid out over:
        a gather's backward or a tp rule reduced it there), one fused
        all-reduce a line and a set of such axes."""
        if not self.world:
            return grads
        by_axes = {}
        for g in grads:
            laid = set(g.axes) if isinstance(g, ShardedTensor) else set()
            axes = tuple(a for a in self.axes if a not in laid)
            if axes:
                by_axes.setdefault(axes, []).extend(
                    g.parts if isinstance(g, ShardedTensor) else [g])
        for axes, group in by_axes.items():
            self.mesh.all_reduce_grads(group, axes, fuse=self.fuse)
        return grads

    def fetch(self, value):
        """A dp-sharded value -> the global one (rank-order concatenation
        along dim 0; a world all-gathers), a sharded persistable its
        global value; a replicated one as is."""
        if isinstance(value, ShardedTensor):
            return value.full()
        if not isinstance(value, Sharded):
            return value
        parts = [p.full() if isinstance(p, ShardedTensor) else p.detach()
                 for p in value.parts]
        if self.world:
            return self.mesh.gather_rows(parts[0], "dp")
        return torch.cat(parts)
