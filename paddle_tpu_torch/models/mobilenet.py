"""MobileNet v1/v2 for ImageNet-style classification.

Parity: the reference era ships MobileNet in the models repo
(image_classification/mobilenet.py, and MobileNet-SSD as the detection
backbone); a copy of ``paddle_tpu/models/mobilenet.py`` on the port's
layers. The depthwise convolutions are the ``depthwise_conv2d`` op
(groups == channels: torch's grouped convolution, cuDNN on the card);
width_mult scales every stage like the reference's scale parameter.
"""


from .. import layers
from .resnet import conv_bn_layer

__all__ = ["mobilenet_v1", "mobilenet_v2", "build_train_net"]


def _conv_bn(x, filters, ksize, stride=1, groups=1, act="relu"):
    # same conv+bn idiom as the rest of the zoo (resnet.conv_bn_layer)
    return conv_bn_layer(x, filters, ksize, stride=stride, groups=groups,
                         act=act)


def _depthwise_separable(x, out_ch, stride, width_mult):
    """v1 block: depthwise 3x3 + pointwise 1x1 (both conv+bn+relu)."""
    in_ch = int(x.shape[1])
    dw = _conv_bn(x, in_ch, 3, stride=stride, groups=in_ch)
    return _conv_bn(dw, int(out_ch * width_mult), 1)


def mobilenet_v1(img, class_dim=1000, width_mult=1.0):
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
    x = _conv_bn(img, int(32 * width_mult), 3, stride=2)
    for out_ch, stride in cfg:
        x = _depthwise_separable(x, out_ch, stride, width_mult)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def _inverted_residual(x, out_ch, stride, expand, width_mult):
    """v2 block: 1x1 expand -> depthwise 3x3 -> 1x1 linear project,
    residual when shapes allow (relu6 activations, as the paper)."""
    in_ch = int(x.shape[1])
    out_ch = int(out_ch * width_mult)
    mid = in_ch * expand
    h = x
    if expand != 1:
        h = _conv_bn(h, mid, 1, act=None)
        h = layers.relu6(h)
    h = _conv_bn(h, mid, 3, stride=stride, groups=mid, act=None)
    h = layers.relu6(h)
    h = _conv_bn(h, out_ch, 1, act=None)        # linear bottleneck
    if stride == 1 and in_ch == out_ch:
        h = layers.elementwise_add(x, h)
    return h


def mobilenet_v2(img, class_dim=1000, width_mult=1.0):
    # (expand, out_ch, repeats, stride)
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    x = _conv_bn(img, int(32 * width_mult), 3, stride=2, act=None)
    x = layers.relu6(x)
    for expand, out_ch, repeats, stride in cfg:
        for i in range(repeats):
            x = _inverted_residual(x, out_ch, stride if i == 0 else 1,
                                   expand, width_mult)
    x = _conv_bn(x, int(1280 * max(1.0, width_mult)), 1, act=None)
    x = layers.relu6(x)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def build_train_net(version=1, class_dim=1000, image_shape=(3, 224, 224),
                    width_mult=1.0):
    """Returns (img, label, pred, avg_loss, acc1, acc5), the same contract
    as models/resnet.py build_train_net."""
    if version not in (1, 2):
        raise ValueError(f"mobilenet version must be 1 or 2, got {version!r}")
    img = layers.data("img", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    net = mobilenet_v1 if version == 1 else mobilenet_v2
    prediction = net(img, class_dim=class_dim, width_mult=width_mult)
    loss = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(loss)
    acc1 = layers.accuracy(input=prediction, label=label, k=1)
    acc5 = layers.accuracy(input=prediction, label=label, k=5)
    return img, label, prediction, avg_loss, acc1, acc5
