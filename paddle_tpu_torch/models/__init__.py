"""Models of the port (the params-dict layout of paddle_tpu/models/):
each module builds its net through the port's ``fluid.layers``, as the
JAX package's module of the same name does."""

from . import label_semantic_roles  # noqa: F401
from . import lstm_text  # noqa: F401
from . import ocr_recognition  # noqa: F401
from . import recommender  # noqa: F401
