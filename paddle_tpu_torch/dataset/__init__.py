"""Datasets with the paddle.dataset API (synthetic, offline).

Parity: python/paddle/dataset/__init__.py; the port's own copy of
``paddle_tpu/dataset`` (numpy, and PIL for the image codecs; no torch).
"""

from . import common
from . import mnist
from . import cifar
from . import uci_housing
from . import imdb
from . import imikolov
from . import movielens
from . import wmt14
from . import wmt16
from . import flowers
from . import conll05
from . import sentiment
from . import image
from . import mq2007
from . import voc2012
