"""OCR sequence recognition — CRNN-CTC (conv stack -> column sequence ->
stacked bidirectional GRU -> CTC), the classic PaddlePaddle OCR recipe.

Parity: the fluid-era ocr_recognition model family built from the core
ops: conv/bn/pool (paddle/fluid/operators/conv_op.cc), dynamic GRU
(gru_op.cc), warpctc (warpctc_op.cc), ctc_greedy_decoder +
edit_distance for eval; a copy of ``paddle_tpu/models/ocr_recognition.py``
on the port's layers. Images are static-shape (B, 1, H, W); the conv
feature map collapses its height into channel features per column, so
the RNN walks the width axis; the CTC loss and decoder operate on dense
padded logits.
"""

from .. import layers

NUM_CLASSES = 95          # printable charset; blank rides at index 0


def conv_bn_pool(x, filters, pool=True, act="relu"):
    x = layers.conv2d(x, num_filters=filters, filter_size=3, padding=1,
                      bias_attr=False)
    x = layers.batch_norm(x, act=act)
    if pool:
        x = layers.pool2d(x, pool_size=2, pool_stride=2, pool_type="max")
    return x


def encoder_features(images, base_filters=16):
    """Conv tower: (B, 1, H, W) -> column sequence (B, W/8, C*H/8)."""
    x = conv_bn_pool(images, base_filters)
    x = conv_bn_pool(x, base_filters * 2)
    x = conv_bn_pool(x, base_filters * 4)
    x = conv_bn_pool(x, base_filters * 4, pool=False)
    # (B, C, H', W') -> per-column features: transpose W' to the time
    # axis and flatten (C, H') into the feature axis (the reference's
    # im2sequence step with one static image size).
    b, c, h, w = x.shape
    x = layers.transpose(x, [0, 3, 1, 2])          # (B, W', C, H')
    return layers.reshape(x, [-1, w, c * h])


def bigru_stack(seq, hidden, num_layers=2):
    """Stacked bidirectional GRU: concat(fwd, bwd) per layer."""
    for _ in range(num_layers):
        proj = layers.fc(seq, size=hidden * 3, num_flatten_dims=2)
        fwd = layers.dynamic_gru(proj, size=hidden)
        bwd = layers.dynamic_gru(proj, size=hidden, is_reverse=True)
        seq = layers.concat([fwd, bwd], axis=-1)
    return seq


def crnn_ctc_net(images, num_classes=NUM_CLASSES, hidden=32,
                 base_filters=16):
    """Returns per-column logits (B, T, num_classes + 1); class 0 is the
    CTC blank."""
    seq = encoder_features(images, base_filters)
    seq = bigru_stack(seq, hidden)
    return layers.fc(seq, size=num_classes + 1, num_flatten_dims=2)


def build_train_net(img_shape=(1, 32, 64), label_len=8,
                    num_classes=NUM_CLASSES, hidden=32, base_filters=16):
    """Static training graph. Returns (images, label, loss, logits)."""
    images = layers.data("pixels", shape=list(img_shape), dtype="float32")
    label = layers.data("label", shape=[label_len], dtype="int64")
    logits = crnn_ctc_net(images, num_classes, hidden, base_filters)
    loss = layers.warpctc(logits, label, blank=0)
    return images, label, layers.mean(loss), logits


def greedy_transcribe(logits, blank=0):
    """Eval path: collapse repeats, strip blanks (dense padded output)."""
    return layers.ctc_greedy_decoder(logits, blank=blank)
