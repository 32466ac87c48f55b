"""Fleet distributed-training facade.

Parity: python/paddle/fluid/incubate/fleet/ (base/role_maker.py,
base/fleet_base.py, collective/__init__.py); the counterpart of
``paddle_tpu/parallel/fleet.py``. fleet.init / distributed_optimizer /
worker_num keep their shapes; underneath:

* role makers resolve rank and endpoints from the PADDLE_* variables that
  PaddleCloud and the launcher (``distributed/launch.py``) set, and
  ``fleet.init`` joins the ``torch.distributed`` world from them
  (``multihost_initialize``: the first endpoint is the rendezvous);
* the backend follows the launcher's layout, never a failure: ranks that
  share a selected device (several ranks on one card, or the CPU) take
  gloo, ranks with a card each NCCL (``backend_for_layout``);
* the cluster becomes one mesh: the hybrid mesh when the job spans
  several nodes (the model axes inside each node's ranks, dp across
  nodes), a flat mesh otherwise; in one process, a local mesh over
  ``DistributedStrategy.local_devices`` (every visible card by default);
* ``distributed_optimizer`` returns a DistributedOptimizer whose minimize
  applies the DistributedStrategy as program transforms: gradient merge,
  AMP decoration, recompute, the Megatron shard rules (tp), ZeRO-1
  optimizer-state sharding and FSDP, so that
  ``exe.run(CompiledProgram(prog).with_mesh(fleet.mesh()))`` runs the
  whole strategy through the walk (``core/compiler.py``). Gradient sync
  needs no code: the walk's collectives make it.
"""

import os

import torch
import torch.distributed as dist

from .mesh import (get_mesh, make_hybrid_mesh, make_mesh,
                   multihost_initialize, set_mesh)

__all__ = ["Mode", "Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "MPISymetricRoleMaker",
           "UserDefinedCollectiveRoleMaker", "LambConfig", "DistFCConfig",
           "DistributedStrategy", "DistributedOptimizer", "Fleet",
           "Collective", "CollectiveOptimizer", "CollectiveOpBasedOptimizer",
           "fleet", "backend_for_layout"]


def _world():
    return dist.is_available() and dist.is_initialized()


def _process_count():
    return dist.get_world_size() if _world() else 1


def _process_index():
    return dist.get_rank() if _world() else 0


class Mode:
    """Parity: incubate/fleet/base/fleet_base.py:29. Every mode runs as
    COLLECTIVE (the walk over the mesh); TRANSPILER / PSLIB configs are
    accepted and re-expressed (``parallel/transpiler.py``)."""
    TRANSPILER = 1
    PSLIB = 2
    COLLECTIVE = 3


class Role:
    """Parity: incubate/fleet/base/role_maker.py:25. There are no
    parameter servers: every process is a WORKER."""
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    endpoints = None
    current_endpoint = None

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_num(self):
        return _process_count()

    def worker_index(self):
        return _process_index()


class PaddleCloudRoleMaker(RoleMakerBase):
    """Rank and endpoints from PaddleCloud's environment (reference
    role_maker.py PaddleCloudRoleMaker): PADDLE_TRAINER_ID,
    PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS,
    PADDLE_CURRENT_ENDPOINT."""

    def __init__(self, is_collective=True):
        self._is_collective = is_collective
        self._id_set = "PADDLE_TRAINER_ID" in os.environ
        self._id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._num = int(os.environ.get("PADDLE_TRAINERS_NUM", "0")) or None
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.endpoints = [e for e in eps.split(",") if e] or None
        self.current_endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT") \
            or (self.endpoints[self._id]
                if self.endpoints and self._id < len(self.endpoints)
                else None)

    def worker_num(self):
        return self._num if self._num else _process_count()

    def worker_index(self):
        return self._id if (self._id_set or self._num) \
            else _process_index()


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=None, worker_num=1,
                 server_endpoints=None, worker_endpoints=None):
        self._id = current_id
        self._num = worker_num
        # legacy pserver addresses never join the worker world: only the
        # worker endpoints make the rendezvous
        self.endpoints = worker_endpoints
        self.server_endpoints = server_endpoints
        self.current_endpoint = (self.endpoints[current_id]
                                 if self.endpoints
                                 and current_id < len(self.endpoints)
                                 else None)

    def worker_num(self):
        return self._num

    def worker_index(self):
        return self._id


class MPISymetricRoleMaker(RoleMakerBase):
    """Parity: role_maker.py MPISymetricRoleMaker. The reference needs
    mpi4py; here rank and size come from mpirun's environment
    (OMPI_COMM_WORLD_* / PMI_*), and every rank is a worker."""

    def __init__(self):
        self._id = int(os.environ.get("OMPI_COMM_WORLD_RANK",
                                      os.environ.get("PMI_RANK", "0")))
        self._num = int(os.environ.get("OMPI_COMM_WORLD_SIZE",
                                       os.environ.get("PMI_SIZE", "1")))

    def worker_num(self):
        return self._num

    def worker_index(self):
        return self._id


class UserDefinedCollectiveRoleMaker(RoleMakerBase):
    """Parity: role_maker.py UserDefinedCollectiveRoleMaker (collective
    jobs: workers only, an explicit endpoint list)."""

    def __init__(self, current_id=0, worker_endpoints=None):
        if worker_endpoints is None:
            raise ValueError("worker_endpoints is required")
        if not 0 <= current_id < len(worker_endpoints):
            raise ValueError(
                f"current_id {current_id} out of range for "
                f"{len(worker_endpoints)} worker_endpoints")
        self._id = current_id
        self.endpoints = list(worker_endpoints)
        self.current_endpoint = self.endpoints[current_id]

    def worker_num(self):
        return len(self.endpoints)

    def worker_index(self):
        return self._id


class LambConfig:
    """Parity: collective/__init__.py:31 (an empty marker config that
    selects LAMB; pass LambOptimizer directly here)."""


class DistFCConfig:
    """Parity: collective/__init__.py:36 (a marker config for the
    distributed-FC softmax; a tp-sharded fc covers it here)."""


class DistributedStrategy:
    """Parity: fleet DistributedStrategy: knobs map onto the mesh's shape
    and program transforms instead of NCCL or pserver config.

    Degrees are cluster-wide totals. `zero_stage`: 0 replicated optimizer
    state, 1 accumulators over dp (ZeRO-1), 3 parameters too (FSDP;
    `use_fsdp` is the legacy alias). `emulated_hosts` chunks a
    one-process mesh into emulated host domains. `local_devices` is a
    one-process mesh's positions, torch devices with repeats allowed
    (``["cuda:0"] * 4`` runs four positions on one card in turn,
    ``["cpu"] * 8`` eight on the CPU); None means every visible card,
    one position each."""

    def __init__(self):
        self.tp_degree = 1
        self.pp_degree = 1
        self.sp_degree = 1
        self.ep_degree = 1
        self.zero_stage = 0
        self.use_fsdp = False
        self.amp = False
        self.amp_init_loss_scaling = 2.0 ** 15
        self.recompute = False
        self.gradient_merge_steps = 1
        self.emulated_hosts = None
        self.local_devices = None


class DistributedOptimizer:
    """minimize() = the inner minimize + the strategy's program transforms
    (reference collective/__init__.py CollectiveOptimizer, done as
    annotations). Built through ``fleet.distributed_optimizer(opt)`` (the
    fleet carries the strategy) or as ``CollectiveOptimizer(opt,
    strategy)``."""

    def __init__(self, optimizer, fleet_obj=None, strategy=None):
        self._inner = optimizer
        self._fleet = fleet_obj
        self._strategy = strategy

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        import inspect
        from .tensor_parallel import apply_shard_rules
        from .transpiler import shard_optimizer_state, shard_params_fsdp
        fleet_obj = self._fleet if self._fleet is not None else fleet
        s = (self._strategy or fleet_obj._strategy
             or DistributedStrategy())
        opt = self._inner
        if s.gradient_merge_steps > 1:
            from ..optimizer.wrappers import GradientMergeOptimizer
            if s.amp:
                raise NotImplementedError(
                    "gradient_merge_steps with strategy.amp is not "
                    "supported: wrap the optimizer with amp.decorate "
                    "yourself and pass gradient merge as "
                    "GradientMergeOptimizer(decorated_opt, k)")
            opt = GradientMergeOptimizer(opt, s.gradient_merge_steps)
        if s.amp:
            from .. import amp as amp_mod
            opt = amp_mod.decorate(
                opt, init_loss_scaling=s.amp_init_loss_scaling,
                use_dynamic_loss_scaling=True)
        # the wrappers take fewer keywords than the Optimizer base:
        # forward only what the inner one accepts
        accepted = inspect.signature(opt.minimize).parameters
        kwargs = {k: v for k, v in
                  (("startup_program", startup_program),
                   ("parameter_list", parameter_list),
                   ("no_grad_set", no_grad_set))
                  if k in accepted}
        result = opt.minimize(loss, **kwargs)
        program = loss.block.program
        if s.recompute:
            program._recompute = {
                "policy": s.recompute if isinstance(s.recompute, str)
                else "dots"}
        if s.tp_degree > 1 or s.sp_degree > 1:
            apply_shard_rules(program)
        if s.use_fsdp or s.zero_stage >= 3:
            shard_params_fsdp(program)
        if s.zero_stage >= 1 or s.use_fsdp:
            shard_optimizer_state(program)
        return result


def backend_for_layout(devices=None):
    """The ``torch.distributed`` backend of a world laid out by the
    launcher: `devices` is every rank's selected device on this node
    (``PADDLE_NODE_DEVICES``, by local rank). Ranks that share a device
    (several ranks on one card) or have no card take gloo, ranks with a
    card each NCCL. Without a layout: NCCL with CUDA, gloo without."""
    if devices is None:
        listed = os.environ.get("PADDLE_NODE_DEVICES", "")
        devices = [d for d in listed.split(",") if d] or None
    if not torch.cuda.is_available():
        return "gloo"
    if devices is not None and len(set(devices)) < len(devices):
        return "gloo"
    return "nccl"


class Fleet:
    def __init__(self):
        self._role = None
        self._strategy = None
        self._inited = False
        self.backend = None

    def init(self, role_maker=None, is_collective=True, strategy=None):
        """Join the workers' world (from the role maker's endpoints, the
        backend by ``backend_for_layout``) and build fleet's mesh."""
        self._role = role_maker or PaddleCloudRoleMaker(is_collective)
        self._strategy = strategy or DistributedStrategy()
        eps = self._role.endpoints
        if is_collective and eps and len(eps) > 1:
            self.backend = backend_for_layout()
            # the rank's card is the launcher's choice under either
            # backend: gloo ranks on 0,0,1,1 train on cards 0 and 1
            selected = os.environ.get("PADDLE_SELECTED_DEVICES")
            if torch.cuda.is_available() and selected is not None:
                torch.cuda.set_device(int(selected))
            multihost_initialize(
                endpoints=eps, current_endpoint=self._role.current_endpoint,
                backend=self.backend)
        set_mesh(self._build_mesh())
        self._inited = True
        return self

    def _build_mesh(self):
        s = self._strategy
        model = s.tp_degree * s.pp_degree * s.sp_degree * s.ep_degree
        axes = dict(tp=s.tp_degree, pp=s.pp_degree, sp=s.sp_degree,
                    ep=s.ep_degree)
        if _world():
            n = dist.get_world_size()
            per_host = int(os.environ.get("PADDLE_NPROC_PER_NODE", n))
            hosts = n // per_host if per_host and n % per_host == 0 else 1
            if hosts > 1 and model <= per_host and per_host % model == 0:
                # the model axes inside each node, dp across nodes
                return make_hybrid_mesh(dp_dcn=hosts, dp=per_host // model,
                                        devices_per_host=per_host, **axes)
            return make_mesh(**axes)
        devices = s.local_devices
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "fleet's mesh over the visible CUDA devices requested "
                    "but CUDA is not available; set "
                    "DistributedStrategy.local_devices (e.g. ['cpu'] * n)")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = list(devices)
        hosts = s.emulated_hosts
        n = len(devices)
        if hosts and hosts > 1 and n % hosts == 0:
            per_host = n // hosts
            if model <= per_host and per_host % model == 0:
                return make_hybrid_mesh(dp_dcn=hosts, dp=per_host // model,
                                        devices=devices, hosts=hosts,
                                        **axes)
        return make_mesh(devices=devices, **axes)

    def mesh(self):
        return get_mesh()

    def is_first_worker(self):
        return self._role.is_first_worker() if self._role else True

    def worker_num(self):
        return self._role.worker_num() if self._role else 1

    def worker_index(self):
        return self._role.worker_index() if self._role else 0

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def barrier_worker(self):
        """Block until every worker process reaches the barrier (a
        ``dist.barrier`` over the world; nothing to wait for alone)."""
        if _process_count() > 1:
            dist.barrier()

    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is not None:
            self._strategy = strategy
        return DistributedOptimizer(optimizer, self)

    def compiled_program(self, program):
        """The program placed on fleet's mesh: run it with exe.run."""
        from ..core.compiler import CompiledProgram
        return CompiledProgram(program).with_mesh(get_mesh())

    def init_worker(self):
        pass

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        raise RuntimeError("there are no parameter servers; shard the "
                           "optimizer state (zero_stage, fsdp) instead")

    def stop_worker(self):
        pass

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None):
        from ..io.inference_io import save_inference_model
        return save_inference_model(dirname, feeded_var_names, target_vars,
                                    executor, main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from ..io.state import save_persistables
        return save_persistables(executor, dirname, main_program)


class Collective(Fleet):
    """Parity: incubate/fleet/collective/__init__.py:41: the collective
    mode is the native one; the subclass keeps ``isinstance(fleet,
    Collective)`` true."""


class CollectiveOptimizer(DistributedOptimizer):
    """Parity: collective/__init__.py:139: the reference's (optimizer,
    strategy=None); a strategy given overrides the global fleet's."""

    def __init__(self, optimizer, strategy=None):
        super().__init__(optimizer, None, strategy)


class CollectiveOpBasedOptimizer(CollectiveOptimizer):
    """Parity: collective/__init__.py:114, the variant that inserted the
    NCCL ops directly; the walk's collectives make it the same here."""


fleet = Collective()
