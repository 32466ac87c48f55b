"""Linear regression on uci_housing (book ch.1 "fit a line").

Parity: python/paddle/fluid/tests/book/test_fit_a_line.py:27-38: one fc,
square error cost, SGD; a copy of ``paddle_tpu/models/fit_a_line.py`` on
the port's layers.
"""


from .. import layers
from ..layers import io as io_layers


def build_train_net(feature_dim=13):
    x = io_layers.data("x", shape=[feature_dim], dtype="float32")
    y = io_layers.data("y", shape=[1], dtype="float32")
    pred = layers.fc(x, size=1, act=None)
    loss = layers.mean(layers.square_error_cost(pred, y))
    return x, y, pred, loss
