"""TSM (Temporal Shift Module) video classifier (PaddleVideo-era recipe
parity).

Parity target: the reference-era models/PaddleCV/video TSM recipe: a 2-D
CNN backbone where each residual block first shifts 1/8 of the channels
one frame backward and 1/8 one frame forward along the time axis (no
temporal FLOPs), then averages the per-frame logits; a copy of
``paddle_tpu/models/tsm.py`` on the port's layers. The shift is
`layers.temporal_shift` (temporal_shift_op.h:52-72: fold 0 reads frame
t - 1, fold 1 reads t + 1, the clip's edges zeroed); the frame axis
folds into the batch for every convolution ((N T, C, H, W)).
"""


from .. import layers


def _conv_bn(x, ch, ksize, stride=1, act="relu"):
    pad = (ksize - 1) // 2
    y = layers.conv2d(x, num_filters=ch, filter_size=ksize, stride=stride,
                      padding=pad, bias_attr=False)
    return layers.batch_norm(y, act=act)


def _shift_block(x, ch, seg_num, stride=1):
    """Residual-variant TSM bottleneck: the shift feeds the conv branch
    only; the skip connection carries the unshifted activations (the
    reference recipe's default)."""
    shifted = layers.temporal_shift(x, seg_num, shift_ratio=0.125)
    y = _conv_bn(shifted, ch, 1)
    y = _conv_bn(y, ch, 3, stride=stride)
    y = _conv_bn(y, ch * 2, 1, act=None)
    if x.shape[1] != ch * 2 or stride != 1:
        x = _conv_bn(x, ch * 2, 1, stride=stride, act=None)
    return layers.relu(layers.elementwise_add(x, y))


def tsm_net(video, seg_num, class_dim, base_ch=16, num_blocks=(1, 1)):
    """video (N, T, C, H, W) float32 -> logits (N, class_dim).

    A compact TSM-ResNet: stem conv + shifted residual stages; frame
    logits averaged over T (the reference's segment consensus)."""
    t = video.shape[1]
    if t != seg_num:
        raise ValueError(f"video time axis {t} != seg_num {seg_num}")
    # fold frames into batch with a single symbolic -1 (batch dim is
    # -1 at graph-build time)
    x = layers.reshape(video, shape=[-1] + list(video.shape[2:]))
    x = _conv_bn(x, base_ch, 3, stride=2)
    ch = base_ch
    for si, blocks in enumerate(num_blocks):
        for bi in range(blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            x = _shift_block(x, ch, t, stride=stride)
        ch *= 2
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    logits = layers.fc(x, size=class_dim)     # fc flattens (NT,C,1,1)
    logits = layers.reshape(logits, shape=[-1, t, class_dim])
    return layers.reduce_mean(logits, dim=1)


def build_train_net(seg_num=4, class_dim=10, image_size=32):
    """Returns (video, label, avg_loss, prediction)."""
    video = layers.data("video", shape=[seg_num, 3, image_size, image_size],
                        dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    logits = tsm_net(video, seg_num, class_dim)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return video, label, loss, layers.softmax(logits)
