"""ResNet-{18,34,50,101,152} and SE-ResNeXt for ImageNet-style
classification.

Parity: the reference's fluid recipe (models repo
image_classification/resnet.py, se_resnext.py); the counterpart of
``paddle_tpu/models/resnet.py``, the same graph from the port's
``layers``: each conv_bn_layer is a bias-free convolution (cuDNN on the
card, f32 without TF32: ``ops/nn_ops.py``) and a batch norm whose
running statistics are persistables of the scope. ResNet-50 at 224 x
224 is BASELINE.json's images/s/chip configuration (``bench.py``'s
resnet cell).
"""

from .. import layers

_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None):
    conv = layers.conv2d(input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def basic_block(input, num_filters, stride):
    conv0 = conv_bn_layer(input, num_filters, 3, stride, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, 1)
    short = _shortcut(input, num_filters, stride)
    return layers.relu(layers.elementwise_add(short, conv1))


def bottleneck_block(input, num_filters, stride):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1)
    short = _shortcut(input, num_filters * 4, stride)
    return layers.relu(layers.elementwise_add(short, conv2))


def resnet(input, class_dim=1000, depth=50):
    block_type, stages = _DEPTH_CFG[depth]
    block = bottleneck_block if block_type == "bottleneck" else basic_block

    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu")
    conv = layers.pool2d(conv, pool_size=3, pool_stride=2, pool_padding=1,
                         pool_type="max")
    num_filters = [64, 128, 256, 512]
    for stage, n_blocks in enumerate(stages):
        for i in range(n_blocks):
            stride = 2 if i == 0 and stage != 0 else 1
            conv = block(conv, num_filters[stage], stride)
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def squeeze_excitation(input, reduction_ratio=16):
    """SE block (PaddleCV SE_ResNeXt recipe, models/PaddleCV
    image_classification/se_resnext.py): global-avg-pool -> fc/r ->
    relu -> fc -> sigmoid channel gates."""
    c = input.shape[1]
    pool = layers.pool2d(input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, size=max(c // reduction_ratio, 4), act="relu")
    excite = layers.fc(squeeze, size=c, act="sigmoid")
    excite = layers.reshape(excite, shape=[-1, c, 1, 1])
    return layers.elementwise_mul(input, excite)


def se_resnext_block(input, num_filters, stride, cardinality=8,
                     reduction_ratio=16):
    """SE-ResNeXt bottleneck: grouped 3x3 (cardinality paths) + SE gate
    on the residual branch."""
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride,
                          groups=cardinality, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1)
    scaled = squeeze_excitation(conv2, reduction_ratio)
    short = _shortcut(input, num_filters * 2, stride)
    return layers.relu(layers.elementwise_add(short, scaled))


def se_resnext(input, class_dim=1000, stages=(1, 1, 1), base_ch=32,
               cardinality=8):
    """Compact SE-ResNeXt classifier: the reference recipe's block
    structure (grouped 3x3 + SE gate on the residual branch) at a
    configurable depth. NOT the exact paper topology — the stem here
    is a single 3x3/s2 conv (paper: 7x7/s2 + max-pool) and cardinality
    defaults to 8 (paper: 32); pass stages=(3,4,6,3), base_ch=128,
    cardinality=32 to approximate SE-ResNeXt-50 minus the stem."""
    conv = conv_bn_layer(input, base_ch, 3, stride=2, act="relu")
    ch = base_ch
    for stage, n_blocks in enumerate(stages):
        for i in range(n_blocks):
            stride = 2 if i == 0 and stage != 0 else 1
            conv = se_resnext_block(conv, ch, stride,
                                    cardinality=cardinality)
        ch *= 2
    pool = layers.pool2d(conv, pool_type="avg", global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def build_se_resnext_train_net(class_dim=10, image_shape=(3, 32, 32),
                               stages=(1, 1, 1)):
    """Returns (image, label, avg_loss, prediction)."""
    image = layers.data("image", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    pred = se_resnext(image, class_dim=class_dim, stages=stages)
    loss = layers.mean(layers.cross_entropy(pred, label))
    return image, label, loss, pred


def build_train_net(depth=50, class_dim=1000, image_shape=(3, 224, 224)):
    """Returns (img, label, pred, avg_loss, acc1, acc5)."""
    img = layers.data("img", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    prediction = resnet(img, class_dim=class_dim, depth=depth)
    loss = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(loss)
    acc1 = layers.accuracy(input=prediction, label=label, k=1)
    acc5 = layers.accuracy(input=prediction, label=label, k=5)
    return img, label, prediction, avg_loss, acc1, acc5
