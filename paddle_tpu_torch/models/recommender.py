"""Personalized recommendation (book chapter 05, movielens).

Parity: python/paddle/fluid/tests/book/test_recommender_system.py — a dual
tower model: user tower (id/gender/age/job embeddings -> fc) and movie tower
(id embedding + title/category sequence-pooled embeddings -> fc), joined by
cosine similarity, regressed to the 1-5 score with square error.

LoD note: the reference feeds title/categories as LoD tensors; here they are
padded [max_len] int sequences with a companion length feed, pooled by
mask-aware sequence_pool. A copy of ``paddle_tpu/models/recommender.py``
on the port's layers.
"""

from .. import layers

USER_TOWER_DIM = 200
MOVIE_TOWER_DIM = 200
EMBED = 32

MAX_TITLE_LEN = 16
MAX_CAT_LEN = 8


def _id_embed(name, vocab, dim=EMBED):
    var = layers.data(name, shape=[1], dtype="int64")
    emb = layers.embedding(var, size=[vocab, dim])
    return var, layers.reshape(emb, shape=[-1, dim])


def user_tower(user_vocab, gender_vocab=2, age_vocab=7, job_vocab=21):
    uid, emb_uid = _id_embed("user_id", user_vocab)
    gender, emb_g = _id_embed("gender_id", gender_vocab, 16)
    age, emb_a = _id_embed("age_id", age_vocab, 16)
    job, emb_j = _id_embed("job_id", job_vocab, 16)

    fc_uid = layers.fc(emb_uid, size=32)
    fc_g = layers.fc(emb_g, size=16)
    fc_a = layers.fc(emb_a, size=16)
    fc_j = layers.fc(emb_j, size=16)
    concat = layers.concat([fc_uid, fc_g, fc_a, fc_j], axis=1)
    feat = layers.fc(concat, size=USER_TOWER_DIM, act="tanh")
    return [uid, gender, age, job], feat


def movie_tower(movie_vocab, category_vocab=19, title_vocab=5175):
    mid, emb_mid = _id_embed("movie_id", movie_vocab)
    fc_mid = layers.fc(emb_mid, size=32)

    cats = layers.data("category_ids", shape=[MAX_CAT_LEN], dtype="int64")
    cats_len = layers.data("category_len", shape=[1], dtype="int64")
    emb_cat = layers.embedding(cats, size=[category_vocab, EMBED])
    pool_cat = layers.sequence_pool(emb_cat, pool_type="sum",
                                    length=cats_len)

    title = layers.data("title_ids", shape=[MAX_TITLE_LEN], dtype="int64")
    title_len = layers.data("title_len", shape=[1], dtype="int64")
    emb_title = layers.embedding(title, size=[title_vocab, EMBED])
    conv_title = layers.sequence_conv(emb_title, num_filters=32,
                                      filter_size=3, act="tanh")
    pool_title = layers.sequence_pool(conv_title, pool_type="sum",
                                      length=title_len)

    concat = layers.concat([fc_mid, pool_cat, pool_title], axis=1)
    feat = layers.fc(concat, size=MOVIE_TOWER_DIM, act="tanh")
    return [mid, cats, cats_len, title, title_len], feat


def build_train_net(user_vocab=6041, movie_vocab=3953):
    """Returns (feed_vars, scale_infer, avg_loss)."""
    user_vars, usr = user_tower(user_vocab)
    movie_vars, mov = movie_tower(movie_vocab)
    inference = layers.cos_sim(X=usr, Y=mov)
    scale_infer = layers.scale(x=inference, scale=5.0)
    score = layers.data("score", shape=[1], dtype="float32")
    cost = layers.square_error_cost(input=scale_infer, label=score)
    avg_loss = layers.mean(cost)
    return user_vars + movie_vars + [score], scale_infer, avg_loss
