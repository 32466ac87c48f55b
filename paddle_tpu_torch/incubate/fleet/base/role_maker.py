"""Parity: python/paddle/fluid/incubate/fleet/base/role_maker.py: the
environment-driven role makers of ``parallel/fleet.py``."""

from ....parallel.fleet import (  # noqa: F401
    MPISymetricRoleMaker, PaddleCloudRoleMaker, Role, RoleMakerBase,
    UserDefinedCollectiveRoleMaker, UserDefinedRoleMaker)

__all__ = ["Role", "RoleMakerBase", "MPISymetricRoleMaker",
           "UserDefinedRoleMaker", "UserDefinedCollectiveRoleMaker",
           "PaddleCloudRoleMaker"]
