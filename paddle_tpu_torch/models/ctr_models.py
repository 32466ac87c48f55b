"""Wide&Deep and DIN CTR models (the PaddleRec-era recipes).

Parity: the reference-era Fluid model zoo (models/PaddleRec); the
counterpart of ``paddle_tpu/models/ctr_models.py``, the same graphs from
the port's ``layers``:

- wide_deep: a linear "wide" half (per-feature scalar weights, a (V, 1)
  embedding, summed) beside a DNN "deep" half over shared embeddings;
  the logits are summed.
- DIN (Deep Interest Network): the user's behaviour history pooled by
  attention against the candidate's embedding; the local activation unit
  is an fc stack over [hist, cand, hist - cand, hist * cand], and padded
  history positions get -1e9 before the softmax.

Slot ids are dense (B, F) int matrices, so every lookup is one batched
``F.embedding``; all shapes are static (pad + mask).
"""

from .. import layers


def wide_deep(wide_ids, deep_ids, num_features, num_wide_fields,
              num_deep_fields, embed_dim=8, layer_sizes=(64, 32, 16)):
    """wide_ids (B, Fw) int64, deep_ids (B, Fd) int64 -> logit (B, 1)."""
    w = layers.embedding(wide_ids, size=[num_features, 1])
    w = layers.reshape(w, shape=[-1, num_wide_fields])
    wide_logit = layers.reduce_sum(w, dim=1, keep_dim=True)

    emb = layers.embedding(deep_ids, size=[num_features, embed_dim])
    deep = layers.reshape(emb, shape=[-1, num_deep_fields * embed_dim])
    for size in layer_sizes:
        deep = layers.fc(deep, size=size, act="relu")
    deep_logit = layers.fc(deep, size=1)
    return layers.sums([wide_logit, deep_logit])


def build_wide_deep_net(num_features=10000, num_wide_fields=8,
                        num_deep_fields=8, embed_dim=8):
    """Returns (wide_ids, deep_ids, label, avg_loss, prob)."""
    wide_ids = layers.data("wide_ids", shape=[num_wide_fields],
                           dtype="int64")
    deep_ids = layers.data("deep_ids", shape=[num_deep_fields],
                           dtype="int64")
    label = layers.data("label", shape=[1], dtype="float32")
    logit = wide_deep(wide_ids, deep_ids, num_features, num_wide_fields,
                      num_deep_fields, embed_dim)
    loss = layers.sigmoid_cross_entropy_with_logits(x=logit, label=label)
    avg_loss = layers.mean(loss)
    return wide_ids, deep_ids, label, avg_loss, layers.sigmoid(logit)


def _din_attention(hist_emb, cand_emb, mask, hidden=(32, 16)):
    """DIN's local activation unit. hist_emb (B, T, E), cand_emb (B, E),
    mask (B, T) float 0/1 -> pooled (B, E); padded positions score -1e9
    before the softmax, so they get no weight."""
    t = hist_emb.shape[1]
    cand = layers.expand(layers.unsqueeze(cand_emb, axes=[1]),
                         expand_times=[1, t, 1])          # (B, T, E)
    x = layers.concat([hist_emb, cand,
                       layers.elementwise_sub(hist_emb, cand),
                       layers.elementwise_mul(hist_emb, cand)], axis=2)
    for h in hidden:
        x = layers.fc(x, size=h, act="sigmoid", num_flatten_dims=2)
    score = layers.fc(x, size=1, num_flatten_dims=2)      # (B, T, 1)
    score = layers.squeeze(score, axes=[2])               # (B, T)
    neg_inf = layers.scale(layers.elementwise_sub(mask,
                                                  layers.ones_like(mask)),
                           scale=1e9)                     # 0 kept, -1e9 pad
    score = layers.softmax(layers.elementwise_add(score, neg_inf))
    score = layers.unsqueeze(score, axes=[2])             # (B, T, 1)
    return layers.reduce_sum(layers.elementwise_mul(hist_emb, score), dim=1)


def din(hist_ids, cand_id, hist_len, num_items, max_hist=16, embed_dim=16,
        fc_sizes=(32, 16)):
    """hist_ids (B, T) int64 padded, cand_id (B, 1) int64, hist_len
    (B, 1) int64 -> logit (B, 1)."""
    emb_size = [num_items, embed_dim]
    hist_emb = layers.embedding(hist_ids, size=emb_size)   # (B, T, E)
    cand_emb = layers.reshape(layers.embedding(cand_id, size=emb_size),
                              shape=[-1, embed_dim])
    mask = layers.cast(
        layers.sequence_mask(layers.reshape(hist_len, shape=[-1]),
                             maxlen=max_hist), "float32")  # (B, T)
    pooled = _din_attention(hist_emb, cand_emb, mask)      # (B, E)
    x = layers.concat([pooled, cand_emb,
                       layers.elementwise_mul(pooled, cand_emb)], axis=1)
    for h in fc_sizes:
        x = layers.fc(x, size=h, act="relu")
    return layers.fc(x, size=1)


def build_din_net(num_items=1000, max_hist=16, embed_dim=16):
    """Returns (hist_ids, cand_id, hist_len, label, avg_loss, prob)."""
    hist_ids = layers.data("hist_ids", shape=[max_hist], dtype="int64")
    cand_id = layers.data("cand_id", shape=[1], dtype="int64")
    hist_len = layers.data("hist_len", shape=[1], dtype="int64")
    label = layers.data("label", shape=[1], dtype="float32")
    logit = din(hist_ids, cand_id, hist_len, num_items, max_hist, embed_dim)
    loss = layers.sigmoid_cross_entropy_with_logits(x=logit, label=label)
    avg_loss = layers.mean(loss)
    return hist_ids, cand_id, hist_len, label, avg_loss, \
        layers.sigmoid(logit)
