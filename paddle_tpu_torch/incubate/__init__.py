"""Incubating APIs of the port: the MultiSlot data-generator authoring
API (``data_generator``), the producer half of the dataset plane, and
``fleet`` (the reference's import paths onto ``parallel.fleet``)."""

from . import data_generator  # noqa: F401
from . import fleet  # noqa: F401
