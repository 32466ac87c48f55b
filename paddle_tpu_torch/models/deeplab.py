"""Semantic segmentation: a DeepLabV3+ style encoder/decoder.

Parity: the fluid-era deeplabv3+ recipe, rebuilt from the core ops:
depthwise-separable convolutions (conv2d's groups path, conv_op.cc),
dilated convolutions for the ASPP pyramid, global pooling + broadcast,
bilinear upsampling (bilinear_interp_op, Fluid's align_corners default),
per-pixel softmax cross-entropy; a copy of ``paddle_tpu/models/deeplab.py``
on the port's layers. Every shape is static NCHW.
"""


from .. import layers


def sep_conv_bn(x, filters, stride=1, dilation=1, act="relu"):
    """Depthwise 3x3 (+ dilation) then pointwise 1x1, each with BN."""
    c_in = x.shape[1]
    pad = dilation
    x = layers.conv2d(x, num_filters=c_in, filter_size=3, stride=stride,
                      padding=pad, dilation=dilation, groups=c_in,
                      bias_attr=False)
    x = layers.batch_norm(x, act=act)
    x = layers.conv2d(x, num_filters=filters, filter_size=1,
                      bias_attr=False)
    return layers.batch_norm(x, act=act)


def aspp(x, filters=32, dilations=(1, 2, 4)):
    """Atrous spatial pyramid: parallel dilated branches + image-level
    pooling, concatenated then fused by a 1x1 conv."""
    branches = []
    for d in dilations:
        if d == 1:
            b = layers.conv2d(x, num_filters=filters, filter_size=1,
                              bias_attr=False)
        else:
            b = layers.conv2d(x, num_filters=filters, filter_size=3,
                              padding=d, dilation=d, bias_attr=False)
        branches.append(layers.batch_norm(b, act="relu"))
    # image-level features: global pool -> 1x1 -> upsample back
    h, w = x.shape[2], x.shape[3]
    img = layers.pool2d(x, pool_type="avg", global_pooling=True)
    img = layers.conv2d(img, num_filters=filters, filter_size=1,
                        bias_attr=False)
    img = layers.batch_norm(img, act="relu")
    branches.append(layers.resize_bilinear(img, out_shape=[h, w]))
    cat = layers.concat(branches, axis=1)
    fused = layers.conv2d(cat, num_filters=filters, filter_size=1,
                          bias_attr=False)
    return layers.batch_norm(fused, act="relu")


def deeplab_v3p(images, num_classes, base_filters=16):
    """(B, C, H, W) -> per-pixel logits (B, num_classes, H, W)."""
    h, w = images.shape[2], images.shape[3]
    # encoder: stride-2 entry conv, then separable blocks (os=4 backbone
    # for the compact config; dilated instead of strided past that)
    x = layers.conv2d(images, num_filters=base_filters, filter_size=3,
                      stride=2, padding=1, bias_attr=False)
    x = layers.batch_norm(x, act="relu")
    low = sep_conv_bn(x, base_filters * 2)             # 1/2: decoder skip
    x = sep_conv_bn(low, base_filters * 4, stride=2)   # 1/4
    x = sep_conv_bn(x, base_filters * 4, dilation=2)   # dilated, keeps 1/4
    x = aspp(x, filters=base_filters * 4)
    # decoder: upsample to the skip, fuse, refine, upsample to input
    x = layers.resize_bilinear(x, out_shape=[low.shape[2], low.shape[3]])
    skip = layers.conv2d(low, num_filters=base_filters, filter_size=1,
                         bias_attr=False)
    skip = layers.batch_norm(skip, act="relu")
    x = sep_conv_bn(layers.concat([x, skip], axis=1), base_filters * 4)
    logits = layers.conv2d(x, num_filters=num_classes, filter_size=1)
    return layers.resize_bilinear(logits, out_shape=[h, w])


def build_train_net(img_shape=(3, 32, 32), num_classes=8, base_filters=16):
    """Static training graph. Returns (images, label, loss, logits)."""
    images = layers.data("pixels", shape=list(img_shape), dtype="float32")
    label = layers.data("label", shape=[img_shape[1], img_shape[2]],
                        dtype="int64")
    logits = deeplab_v3p(images, num_classes, base_filters)
    # (B, C, H, W) -> (B*H*W, C) pixel softmax cross-entropy
    perm = layers.transpose(logits, [0, 2, 3, 1])
    flat = layers.reshape(perm, [-1, num_classes])
    flat_label = layers.reshape(label, [-1, 1])
    loss = layers.mean(layers.softmax_with_cross_entropy(flat, flat_label))
    return images, label, loss, logits
