"""Robustness of the port: deterministic fault injection, the non-finite
fail-stop's error, checkpoint retention, preemption, and the fleet's
self-healing supervision.

Counterpart of ``paddle_tpu/robustness``, kept as the port's own copy:

- chaos.py: the ``ChaosInjector`` a ``GenerationServer`` and a
  ``FleetRouter`` consume through ``chaos=`` (serving faults, replica
  kill/hang/slow, worker SIGKILL, dropped connections);
- guard.py: ``NonFiniteError``, raised when a fused step's logits go
  non-finite on a live lane;
- checkpoint_manager.py: last-K-good retention over io/checkpoint.py's
  atomic, CRC-checked write path, with fall-back restore;
- preemption.py: the SIGTERM/SIGINT flag the router's preempt drain
  polls;
- supervisor.py: the fleet watchdog, resurrection under a crash-loop
  breaker with prefix re-warm (``make_checkpoint_spawn``), the
  poison-request error, and the SLO-driven autoscaler.

The trainer's pieces (``GuardedTrainer``, ``GuardConfig``, the chaos
training and checkpoint-write hooks) are not ported yet.
"""

from .chaos import ChaosInjector
from .checkpoint_manager import CheckpointError, CheckpointManager
from .guard import NonFiniteError
from .preemption import PreemptionHandler
from .supervisor import (Autoscaler, AutoscalerConfig,
                         ChunkPopularityDigest, FleetSupervisor,
                         PoisonRequestError, SupervisorConfig,
                         make_checkpoint_spawn)

__all__ = ["NonFiniteError", "ChaosInjector",
           "CheckpointError", "CheckpointManager",
           "PreemptionHandler",
           "FleetSupervisor", "SupervisorConfig", "PoisonRequestError",
           "ChunkPopularityDigest", "make_checkpoint_spawn",
           "Autoscaler", "AutoscalerConfig"]
