"""MNIST digit recognition: softmax regression, an MLP and the LeNet
convnet.

Parity: reference book chapter 02 (python/paddle/fluid/tests/book/
test_recognize_digits.py); the counterpart of ``paddle_tpu/models/
mnist.py``'s static-graph builders, NCHW at the API. The dygraph
``MNISTDygraph`` class waits for the port's ``dygraph/`` (ROADMAP queue
A item 11).
"""

from .. import layers


def softmax_regression(img):
    """Single fc + softmax (book/02 `softmax_regression`)."""
    return layers.fc(img, size=10, act="softmax")


def multilayer_perceptron(img):
    """2x fc relu + softmax head (book/02 `multilayer_perceptron`)."""
    h = layers.fc(img, size=200, act="relu")
    h = layers.fc(h, size=200, act="relu")
    return layers.fc(h, size=10, act="softmax")


def convolutional_neural_network(img):
    """conv-pool x2 + fc, book/02 `convolutional_neural_network` (LeNet)."""
    conv1 = layers.conv2d(img, num_filters=20, filter_size=5, act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2, pool_type="max")
    bn1 = layers.batch_norm(pool1)
    conv2 = layers.conv2d(bn1, num_filters=50, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2, pool_type="max")
    return layers.fc(pool2, size=10, act="softmax")


def build_train_net(net="conv"):
    """Append the full training graph; returns (img, label, pred, loss, acc).

    Caller owns optimizer.minimize + Executor, mirroring the book test's
    `train()` driver.
    """
    img = layers.data("img", shape=[1, 28, 28], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    builder = {"softmax": softmax_regression,
               "mlp": multilayer_perceptron,
               "conv": convolutional_neural_network}[net]
    prediction = builder(img)
    loss = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=prediction, label=label)
    return img, label, prediction, avg_loss, acc
