from . import fleet_barrier_util  # noqa: F401
from . import fleet_util  # noqa: F401
from . import hdfs  # noqa: F401
from .fleet_util import FleetUtil  # noqa: F401
from .fleet_barrier_util import check_all_trainers_ready  # noqa: F401
