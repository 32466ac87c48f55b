"""Semantic role labeling: 8-feature embeddings -> stacked bidirectional
LSTM mix -> linear-chain CRF (book ch.7).

Parity: python/paddle/fluid/tests/book/test_label_semantic_roles.py:53-118
(db_lstm + crf); a copy of ``paddle_tpu/models/label_semantic_roles.py``
on the port's layers. The reference walks LoD sentences; here sequences
are padded (B, T) with a length tensor and the CRF / decoding ops
consume the lengths. The stacked LSTM alternates direction per depth
like the reference's bidirectional mixing. The dictionary sizes are the
module's constants (set them before a build for the conll05 sizes).
"""

from .. import layers
from ..layers import io as io_layers
from ..core.param_attr import ParamAttr

WORD_DICT_LEN = 200
LABEL_DICT_LEN = 12
PRED_DICT_LEN = 50
MARK_DICT_LEN = 2

FEATURE_NAMES = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
                 "predicate", "mark")


def db_lstm(feats, word_dim=16, mark_dim=8, hidden_dim=64, depth=4,
            length=None):
    """feats: dict of the 8 (B, T) int64 feature tensors. Returns the
    per-position emission features (B, T, hidden)."""
    embs = []
    for name in FEATURE_NAMES[:6]:
        embs.append(layers.embedding(
            feats[name], size=[WORD_DICT_LEN, word_dim],
            param_attr=ParamAttr(name="srl_emb_" + name)))
    embs.append(layers.embedding(feats["predicate"],
                                 size=[PRED_DICT_LEN, word_dim]))
    embs.append(layers.embedding(feats["mark"],
                                 size=[MARK_DICT_LEN, mark_dim]))

    hidden0 = layers.sums([
        layers.fc(e, size=hidden_dim, num_flatten_dims=2) for e in embs])
    lstm0, _ = layers.dynamic_lstm(hidden0, size=4 * hidden_dim,
                                   length=length, use_peepholes=False)
    input_tmp = [hidden0, lstm0]
    for i in range(1, depth):
        mix = layers.sums([
            layers.fc(input_tmp[0], size=hidden_dim, num_flatten_dims=2),
            layers.fc(input_tmp[1], size=hidden_dim, num_flatten_dims=2)])
        lstm, _ = layers.dynamic_lstm(
            mix, size=4 * hidden_dim, length=length,
            is_reverse=(i % 2 == 1), use_peepholes=False)
        input_tmp = [mix, lstm]
    feature_out = layers.sums([
        layers.fc(input_tmp[0], size=LABEL_DICT_LEN, num_flatten_dims=2),
        layers.fc(input_tmp[1], size=LABEL_DICT_LEN, num_flatten_dims=2)])
    return feature_out


def build_train_net(batch, seq_len, hidden_dim=64, crf_param_name="srl_crf"):
    feats = {}
    for name in FEATURE_NAMES:
        feats[name] = io_layers.data(
            name, shape=[batch, seq_len], dtype="int64",
            append_batch_size=False)
    target = io_layers.data("target", shape=[batch, seq_len], dtype="int64",
                            append_batch_size=False)
    length = io_layers.data("length", shape=[batch], dtype="int64",
                            append_batch_size=False)

    emission = db_lstm(feats, hidden_dim=hidden_dim, length=length)
    crf_cost = layers.linear_chain_crf(
        emission, target, param_attr=ParamAttr(name=crf_param_name),
        length=length)
    avg_cost = layers.mean(crf_cost)
    decode = layers.crf_decoding(
        emission, param_attr=ParamAttr(name=crf_param_name), length=length)
    return feats, target, length, avg_cost, decode
