"""VGG-16 image classification (book chapter 03).

Parity: python/paddle/fluid/tests/book/test_image_classification.py
`vgg16_bn_drop`: conv groups with batch norm and dropout, then the fc
head; a copy of ``paddle_tpu/models/vgg.py`` on the port's layers (the
reference's `img_conv_group` written out with the same structure).
"""


from .. import layers


def conv_block(input, num_filter, groups, dropouts):
    x = input
    for i in range(groups):
        x = layers.conv2d(x, num_filters=num_filter, filter_size=3,
                          padding=1, bias_attr=False)
        x = layers.batch_norm(x, act="relu")
        if dropouts[i] > 0:
            x = layers.dropout(x, dropout_prob=dropouts[i])
    return layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")


def vgg16_bn_drop(input, class_dim=10):
    conv1 = conv_block(input, 64, 2, [0.3, 0.0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0.0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0.0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0.0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0.0])

    drop = layers.dropout(conv5, dropout_prob=0.5)
    fc1 = layers.fc(drop, size=512)
    bn = layers.batch_norm(fc1, act="relu")
    drop2 = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(drop2, size=512)
    return layers.fc(fc2, size=class_dim, act="softmax")


def build_train_net(class_dim=10, image_shape=(3, 32, 32)):
    """CIFAR-10-shaped by default, as in book/03. Returns the key vars."""
    img = layers.data("img", shape=list(image_shape), dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    prediction = vgg16_bn_drop(img, class_dim=class_dim)
    loss = layers.cross_entropy(input=prediction, label=label)
    avg_loss = layers.mean(loss)
    acc = layers.accuracy(input=prediction, label=label)
    return img, label, prediction, avg_loss, acc
