"""incubate.fleet: the reference's import paths onto ``parallel.fleet``.

Parity: python/paddle/fluid/incubate/fleet/; the counterpart of
``paddle_tpu/incubate/fleet/``. The implementation lives in
``paddle_tpu_torch/parallel/fleet.py`` (one Fleet; the collective mode
is native, the pserver modes are documented non-ports).
"""

from . import base  # noqa: F401
from . import collective  # noqa: F401
from . import parameter_server  # noqa: F401
from . import utils  # noqa: F401
