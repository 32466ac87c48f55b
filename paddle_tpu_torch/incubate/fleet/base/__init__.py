from . import fleet_base  # noqa: F401
from . import role_maker  # noqa: F401
