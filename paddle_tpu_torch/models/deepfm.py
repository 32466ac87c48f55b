"""DeepFM CTR prediction (a factorization machine beside a DNN over
sparse features).

Parity: the reference-era PaddleRec DeepFM Fluid recipe (embedding
lookups with ``is_sparse=True``, the FM interaction, an MLP); the
counterpart of ``paddle_tpu/models/deepfm.py``, the same graph from the
port's ``layers``: (B, num_fields) int ids into one shared embedding
space, so each lookup is one batched ``F.embedding``; the first-order
weights from a (V, 1) embedding; the FM second-order term by the
sum-square trick (two reductions, not a pairwise loop); a (400, 400,
400) ReLU tower. The embeddings' gradients are dense (V, E) scatter-adds,
as in the JAX package (``is_sparse`` is accepted and moot), and under
data parallelism they are summed over the ranks like every gradient.
"""

from .. import layers


def deepfm(feat_ids, feat_vals, num_features, num_fields, embed_dim=10,
           layer_sizes=(400, 400, 400)):
    """feat_ids (B, F) int64, feat_vals (B, F) float32. Returns the logit
    (B, 1)."""
    # first order: w_i x_i
    w1 = layers.embedding(feat_ids, size=[num_features, 1])
    w1 = layers.reshape(w1, shape=[-1, num_fields])
    first = layers.reduce_sum(layers.elementwise_mul(w1, feat_vals), dim=1,
                              keep_dim=True)

    # second order: 0.5 ((sum v x)^2 - sum (v x)^2)
    emb = layers.embedding(feat_ids, size=[num_features, embed_dim])
    vals = layers.reshape(feat_vals, shape=[-1, num_fields, 1])
    vx = layers.elementwise_mul(emb, vals)
    sum_vx = layers.reduce_sum(vx, dim=1)                       # (B, E)
    sq_sum = layers.elementwise_mul(sum_vx, sum_vx)
    sum_sq = layers.reduce_sum(layers.elementwise_mul(vx, vx), dim=1)
    second = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sq_sum, sum_sq), dim=1,
                          keep_dim=True), scale=0.5)

    # the deep tower over the flattened embeddings
    deep = layers.reshape(vx, shape=[-1, num_fields * embed_dim])
    for size in layer_sizes:
        deep = layers.fc(deep, size=size, act="relu")
    deep_out = layers.fc(deep, size=1)

    return layers.sums([first, second, deep_out])


def build_train_net(num_features=100000, num_fields=39, embed_dim=10):
    """Returns (feat_ids, feat_vals, label, avg_loss, auc_prob)."""
    feat_ids = layers.data("feat_ids", shape=[num_fields], dtype="int64")
    feat_vals = layers.data("feat_vals", shape=[num_fields], dtype="float32")
    label = layers.data("label", shape=[1], dtype="float32")
    logit = deepfm(feat_ids, feat_vals, num_features, num_fields, embed_dim)
    loss = layers.sigmoid_cross_entropy_with_logits(x=logit, label=label)
    avg_loss = layers.mean(loss)
    prob = layers.sigmoid(logit)
    return feat_ids, feat_vals, label, avg_loss, prob
