"""The non-finite fail-stop's error.

Counterpart of ``NonFiniteError`` in ``paddle_tpu/robustness/guard.py``,
with the same contract: the trainer's guard and the serving engine's
non-finite logits guard raise it. The JAX package's trainer guard config
has no counterpart here yet.
"""

__all__ = ["NonFiniteError"]


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
