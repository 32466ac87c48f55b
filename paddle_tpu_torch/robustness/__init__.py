"""Robustness of the port: deterministic fault injection, the NaN/Inf
sentinel and its fail-stop error, the fault-tolerant training loop,
checkpoint retention, preemption, and the fleet's self-healing
supervision.

Counterpart of ``paddle_tpu/robustness``, kept as the port's own copy:

- chaos.py: the ``ChaosInjector`` a ``GuardedTrainer``, a
  ``GenerationServer`` and a ``FleetRouter`` consume through ``chaos=``
  (a poisoned step, a SIGTERM at a step, a failed checkpoint write
  through ``CheckpointWriteFault``; serving faults, replica
  kill/hang/slow, worker SIGKILL, dropped connections);
- guard.py: ``GuardConfig`` (what the Executor's sentinel watches) and
  ``NonFiniteError``, raised when a guarded step or a fused serving
  step's logits go non-finite;
- trainer.py: ``GuardedTrainer`` (checkpoint segments over
  ``Executor.run_async``, drain-then-commit, rollback and replay,
  retries, preemption with an emergency checkpoint, the flight dump),
  ``RecoveryPolicy``, ``TrainResult``, ``lr_backoff``. It recovers from
  NonFiniteError and checkpoint I/O errors, never from a CUDA error,
  which is sticky (see trainer.py);
- checkpoint_manager.py: last-K-good retention over io/checkpoint.py's
  atomic, CRC-checked write path, with fall-back restore;
- preemption.py: the SIGTERM/SIGINT flag the router's preempt drain
  polls;
- supervisor.py: the fleet watchdog, resurrection under a crash-loop
  breaker with prefix re-warm (``make_checkpoint_spawn``), the
  poison-request error, and the SLO-driven autoscaler.
"""

from .chaos import ChaosInjector, CheckpointWriteFault
from .checkpoint_manager import CheckpointError, CheckpointManager
from .guard import GuardConfig, NonFiniteError
from .preemption import PreemptionHandler
from .supervisor import (Autoscaler, AutoscalerConfig,
                         ChunkPopularityDigest, FleetSupervisor,
                         PoisonRequestError, SupervisorConfig,
                         make_checkpoint_spawn)
from .trainer import (GuardedTrainer, RecoveryPolicy, TrainResult,
                      lr_backoff)

__all__ = ["GuardConfig", "NonFiniteError", "ChaosInjector",
           "CheckpointWriteFault",
           "CheckpointError", "CheckpointManager",
           "PreemptionHandler",
           "FleetSupervisor", "SupervisorConfig", "PoisonRequestError",
           "ChunkPopularityDigest", "make_checkpoint_spawn",
           "Autoscaler", "AutoscalerConfig",
           "GuardedTrainer", "RecoveryPolicy", "TrainResult", "lr_backoff"]
