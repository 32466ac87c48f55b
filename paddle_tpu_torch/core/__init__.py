"""Framework core of the port: Program, Executor, Scope, backward
(the counterpart of paddle_tpu/core/)."""
