"""Parity import path: python/paddle/fluid/transpiler/. The transpiler
surface lives in ``parallel/transpiler.py`` (mesh-first re-expressions
and documented no-ops); this module keeps ``import
paddle_tpu_torch.transpiler`` working like the reference package."""

from .parallel.transpiler import (  # noqa: F401
    DistributeTranspiler, DistributeTranspilerConfig, GradAllReduce,
    HashName, LocalSGD, PSDispatcher, RoundRobin, memory_optimize,
    release_memory)

__all__ = ["DistributeTranspiler", "memory_optimize", "release_memory",
           "HashName", "RoundRobin", "DistributeTranspilerConfig",
           "GradAllReduce", "LocalSGD", "PSDispatcher"]
