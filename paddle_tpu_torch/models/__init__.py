"""Models of the port (the params-dict layout of paddle_tpu/models/):
each module builds its net through the port's ``fluid.layers``, as the
JAX package's module of the same name does."""

from . import label_semantic_roles  # noqa: F401
from . import lstm_text  # noqa: F401
from . import ocr_recognition  # noqa: F401
from . import recommender  # noqa: F401
from . import fit_a_line  # noqa: F401
from . import word2vec  # noqa: F401
from . import vgg  # noqa: F401
from . import mobilenet  # noqa: F401
from . import gan  # noqa: F401
from . import simnet  # noqa: F401
from . import deeplab  # noqa: F401
from . import tsm  # noqa: F401
