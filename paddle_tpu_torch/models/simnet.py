"""SimNet-style pairwise text matching (PaddleNLP-era recipe parity).

Parity target: the reference-era models/PaddleNLP/similarity_net
recipe: a shared encoder (BOW or CNN tower) embeds query and title,
cosine similarity scores the pair, and training minimizes a pairwise
hinge over (query, positive, negative) triples; a copy of
``paddle_tpu/models/simnet.py`` on the port's layers.

The towers work on dense (B, T) int matrices through one shared
embedding gather; the CNN tower is a 1-D convolution (a (1, 3) conv2d);
pooling over the real tokens rides the mask-aware `layers.sequence_pool`
(the pad + mask replacement for LoD pooling). The pairwise net
instantiates the tower three times (query / pos / neg) over ONE shared
weight set (named param_attrs).
"""


from .. import layers


def encode(ids, lengths, vocab_size, max_len, embed_dim=64, tower="bow",
           hidden=64):
    """ids (B, T) int64 padded, lengths (B, 1) -> (B, hidden) unit-norm.

    tower: "bow" (masked mean) or "cnn" (1-D conv + masked max)."""
    emb = layers.embedding(ids, size=[vocab_size, embed_dim],
                           param_attr="simnet_emb")
    lens = layers.reshape(lengths, shape=[-1])
    if tower == "bow":
        h = layers.sequence_pool(emb, "average", length=lens)
    elif tower == "cnn":
        # zero padded positions BEFORE the conv: windows centered on
        # real tokens would otherwise read pad embeddings (the LoD
        # kernels never see padding; pad+mask must match that)
        mask = layers.cast(
            layers.sequence_mask(lens, maxlen=max_len), "float32")
        emb = layers.elementwise_mul(emb, layers.unsqueeze(mask, axes=[2]))
        x = layers.transpose(emb, perm=[0, 2, 1])       # (B, E, T)
        x = layers.unsqueeze(x, axes=[2])               # (B, E, 1, T)
        c = layers.conv2d(x, num_filters=hidden, filter_size=(1, 3),
                          padding=(0, 1), act="relu",
                          param_attr="simnet_cnn_w",
                          bias_attr="simnet_cnn_b")
        c = layers.squeeze(c, axes=[2])                 # (B, H, T)
        c = layers.transpose(c, perm=[0, 2, 1])         # (B, T, H)
        h = layers.sequence_pool(c, "max", length=lens)
    else:
        raise ValueError(f"unknown tower {tower!r} (bow | cnn)")
    h = layers.fc(h, size=hidden, act="tanh", param_attr="simnet_proj_w",
                  bias_attr="simnet_proj_b")
    return layers.l2_normalize(h, axis=-1)


def build_pairwise_net(vocab_size=1000, max_len=16, embed_dim=32,
                       tower="bow", hidden=32, margin=0.3):
    """Pairwise-hinge training graph over (query, pos, neg) triples.
    Returns (feeds, avg_loss, pos_sim) where feeds is the 6 data vars."""
    q = layers.data("q_ids", shape=[max_len], dtype="int64")
    q_len = layers.data("q_len", shape=[1], dtype="int64")
    p = layers.data("p_ids", shape=[max_len], dtype="int64")
    p_len = layers.data("p_len", shape=[1], dtype="int64")
    n = layers.data("n_ids", shape=[max_len], dtype="int64")
    n_len = layers.data("n_len", shape=[1], dtype="int64")

    # three tower instantiations over ONE shared weight set (the named
    # param_attrs make every parameter the same scope var)
    eq = encode(q, q_len, vocab_size, max_len, embed_dim, tower, hidden)
    ep = encode(p, p_len, vocab_size, max_len, embed_dim, tower, hidden)
    en = encode(n, n_len, vocab_size, max_len, embed_dim, tower, hidden)

    pos = layers.reduce_sum(layers.elementwise_mul(eq, ep), dim=1,
                            keep_dim=True)              # cosine (unit-norm)
    neg = layers.reduce_sum(layers.elementwise_mul(eq, en), dim=1,
                            keep_dim=True)
    # hinge: max(0, margin - pos + neg) (reference pairwise loss)
    gap = layers.scale(layers.elementwise_sub(neg, pos), scale=1.0,
                      bias=margin)
    loss = layers.mean(layers.relu(gap))
    return (q, q_len, p, p_len, n, n_len), loss, pos
