"""Parity: python/paddle/fluid/incubate/fleet/collective/__init__.py: the
collective-mode fleet singleton and its optimizer wrappers
(implementation: ``parallel/fleet.py``; the walk's collectives stand for
the reference's transpiled allreduce ops)."""

from ....parallel.fleet import (  # noqa: F401
    Collective, CollectiveOpBasedOptimizer, CollectiveOptimizer,
    DistFCConfig, DistributedStrategy, LambConfig, fleet)

__all__ = ["LambConfig", "DistFCConfig", "Collective",
           "DistributedStrategy", "CollectiveOpBasedOptimizer",
           "CollectiveOptimizer", "fleet"]
