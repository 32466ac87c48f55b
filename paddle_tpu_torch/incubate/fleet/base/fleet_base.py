"""Parity: python/paddle/fluid/incubate/fleet/base/fleet_base.py: the
Fleet of ``parallel/fleet.py``."""

from ....parallel.fleet import (  # noqa: F401
    DistributedOptimizer, Fleet, Mode)

__all__ = ["Mode", "Fleet", "DistributedOptimizer"]
