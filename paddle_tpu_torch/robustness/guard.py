"""NaN/Inf sentinels for the training step, and the fail-stop's error.

Counterpart of ``paddle_tpu/robustness/guard.py``, with the same
contract. The JAX package folds one fused ``isfinite`` reduction into
its compiled step; the port's Executor computes the same vector on the
device at the end of the eager step (one ``_foreach_norm`` pass over the
monitored tensors, ``core/executor.py`` ``_guard_vector``) and keeps it
in the step's ``FetchHandle``: the host reads it only where results are
observed, so a tripped sentinel raises a structured NonFiniteError at
run() / FetchHandle.result() / drain() identifying the FIRST bad var and
the step it went bad on, and a GuardedTrainer (robustness/trainer.py)
can roll back instead of writing a poisoned checkpoint. The serving
engine's non-finite logits guard raises the same error.

Opt-in per executor: `Executor(guard=True)` / `Executor(guard=
GuardConfig(...))`, or process-wide via `PADDLE_TPU_GUARD=1`.
"""

__all__ = ["GuardConfig", "NonFiniteError"]

_FALSY = ("", "0", "false", "no", "off")


class GuardConfig:
    """What the in-step sentinel monitors.

    check_loss    — the backward marker's loss var (training programs).
    check_grads   — every param's `var@GRAD` (the earliest place
                    divergence is visible: one bad grad poisons the
                    whole updated state on the NEXT step).
    check_fetches — floating-point fetch_list entries (inference /
                    forward-only programs have no grads to watch).
    extra_vars    — additional env var names to monitor (e.g. an AMP
                    `loss_scaling` accumulator).
    """

    __slots__ = ("check_loss", "check_grads", "check_fetches",
                 "extra_vars")

    def __init__(self, check_loss=True, check_grads=True,
                 check_fetches=True, extra_vars=()):
        self.check_loss = bool(check_loss)
        self.check_grads = bool(check_grads)
        self.check_fetches = bool(check_fetches)
        self.extra_vars = tuple(extra_vars)

    @staticmethod
    def resolve(value):
        """None/False/falsy env -> None (guard off); True/truthy env ->
        default GuardConfig; a GuardConfig passes through."""
        if value is None or value is False:
            return None
        if isinstance(value, GuardConfig):
            return value
        if isinstance(value, str):
            return None if value.strip().lower() in _FALSY \
                else GuardConfig()
        return GuardConfig() if value else None

    def candidates(self, loss_name, grad_names, fetch_names):
        """Ordered, de-duplicated monitor list (fixed per program and
        fetch list)."""
        out, seen = [], set()

        def add(n):
            if n and n not in seen:
                seen.add(n)
                out.append(n)

        if self.check_loss and loss_name:
            add(loss_name)
        if self.check_grads:
            for n in grad_names:
                add(n)
        if self.check_fetches:
            for n in fetch_names:
                add(n)
        for n in self.extra_vars:
            add(n)
        return out



class NonFiniteError(ArithmeticError):
    """A guarded step produced NaN/Inf in a monitored var.

    Attributes:
        var      -- first monitored var that went non-finite (for the
                    serving engine "serving.logits[slot <s>]");
        step     -- the step counter of the offending step (the serving
                    engine's scheduler iteration);
        bad_vars -- every monitored var that tripped this step.

    The serving engine also sets `bad_rids` (the request ids of the
    lanes that went non-finite) and `flight_dump` (the flight
    recorder's dump path, None with telemetry off) on the instance."""

    def __init__(self, var, step, bad_vars=None):
        self.var = var
        self.step = int(step)
        self.bad_vars = list(bad_vars if bad_vars is not None else [var])
        super().__init__(
            f"non-finite value detected in '{var}' at step {self.step}"
            + (f" (also bad: {self.bad_vars[1:]})"
               if len(self.bad_vars) > 1 else ""))
