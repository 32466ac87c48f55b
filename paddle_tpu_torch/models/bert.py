"""BERT-base / ERNIE-1.0 pretraining (MLM + NSP).

The counterpart of ``paddle_tpu/models/bert.py``, the same graph through
the port's Fluid entry points: token + position + sentence embeddings ->
N post-norm transformer encoder layers -> (a) a masked-LM head over the
gathered positions, sharing the token embedding table, and (b) the NSP
binary head on the pooled [CLS].

On the card each layer's attention runs the hand-written flash kernels
(``ops/flash.py``): non-causal, with the padding mask as a key-side
additive bias (B, 1, 1, T) that reaches the kernels as a broadcast view
(stride 0 over heads and queries), or, in the packed net, with segment
ids compared blockwise inside them. The masked-position gather keeps a
static max_predictions_per_seq, so the MLM product (P, H) x (H, V) has one
shape. The Executor walks the step eagerly (``core/executor.py``).
"""

from .. import layers
from ..core import framework
from ..core.param_attr import ParamAttr


class BertConfig:
    """BERT-base (= ERNIE-1.0 size)."""
    vocab_size = 30522
    hidden_size = 768
    num_hidden_layers = 12
    num_attention_heads = 12
    intermediate_size = 3072
    hidden_act = "gelu"
    hidden_dropout_prob = 0.1
    attention_probs_dropout_prob = 0.1
    max_position_embeddings = 512
    type_vocab_size = 2
    max_predictions_per_seq = 20

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def bert_tiny():
    """4-layer/256-wide config for tests and dryrun."""
    return BertConfig(vocab_size=1024, hidden_size=256, num_hidden_layers=4,
                      num_attention_heads=4, intermediate_size=1024,
                      max_position_embeddings=128,
                      max_predictions_per_seq=8)


def _encoder_layer(x, attn_bias, cfg, idx, segment_ids=None):
    # Post-norm (original BERT): sublayer -> add -> layer_norm.
    attn = layers.multi_head_attention(
        x, num_heads=cfg.num_attention_heads, d_model=cfg.hidden_size,
        attn_bias=attn_bias, segment_ids=segment_ids,
        dropout_rate=cfg.attention_probs_dropout_prob,
        param_attr=ParamAttr(name=f"enc{idx}_attn"),
        bias_attr=ParamAttr(name=f"enc{idx}_attn"))
    x = layers.layer_norm(layers.elementwise_add(x, attn),
                          begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"enc{idx}_ln0_w"),
                          bias_attr=ParamAttr(name=f"enc{idx}_ln0_b"))
    h = layers.fc(x, size=cfg.intermediate_size, num_flatten_dims=2,
                  act=cfg.hidden_act,
                  param_attr=ParamAttr(name=f"enc{idx}_ffn0_w"),
                  bias_attr=ParamAttr(name=f"enc{idx}_ffn0_b"))
    h = layers.fc(h, size=cfg.hidden_size, num_flatten_dims=2,
                  param_attr=ParamAttr(name=f"enc{idx}_ffn1_w"),
                  bias_attr=ParamAttr(name=f"enc{idx}_ffn1_b"))
    if cfg.hidden_dropout_prob:
        h = layers.dropout(h, cfg.hidden_dropout_prob)
    return layers.layer_norm(layers.elementwise_add(x, h), begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"enc{idx}_ln1_w"),
                             bias_attr=ParamAttr(name=f"enc{idx}_ln1_b"))


def bert_encoder(src_ids, sent_ids, input_mask, cfg, segment_ids=None,
                 positions=None):
    """Returns (sequence_output (B,T,H), pooled [CLS] output (B,H)).

    Packed mode (segment_ids + positions given): several documents share
    one row; attention is confined per segment via the flash kernel's
    segment mask (no input_mask bias — pad tokens live in segment 0 and
    are invisible to real tokens), and position embeddings are gathered
    by the per-segment-reset `positions` feed instead of the iota."""
    token_emb = layers.embedding(
        src_ids, size=[cfg.vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="word_embedding"))
    seq_len = src_ids.shape[1]
    if positions is not None:
        pos_emb = layers.embedding(
            positions, size=[cfg.max_position_embeddings, cfg.hidden_size],
            param_attr=ParamAttr(name="pos_embedding"))
    else:
        # Position ids are a static iota — computed inline, not fed.
        pos_table = layers.create_parameter(
            [cfg.max_position_embeddings, cfg.hidden_size], "float32",
            attr=ParamAttr(name="pos_embedding"))
        pos_emb = layers.slice(pos_table, axes=[0], starts=[0],
                               ends=[seq_len])
    sent_emb = layers.embedding(
        sent_ids, size=[cfg.type_vocab_size, cfg.hidden_size],
        param_attr=ParamAttr(name="sent_embedding"))

    emb = layers.elementwise_add(
        layers.elementwise_add(token_emb, sent_emb), pos_emb)
    emb = layers.layer_norm(emb, begin_norm_axis=2,
                            param_attr=ParamAttr(name="emb_ln_w"),
                            bias_attr=ParamAttr(name="emb_ln_b"))
    if cfg.hidden_dropout_prob:
        emb = layers.dropout(emb, cfg.hidden_dropout_prob)

    if segment_ids is not None:
        bias = None
    else:
        # input_mask (B, T) 1/0 -> additive bias (B, 1, 1, T)
        bias = layers.reshape(input_mask, shape=[-1, 1, 1, seq_len])
        bias = layers.scale(bias, scale=1e9, bias=-1e9)

    x = emb
    for i in range(cfg.num_hidden_layers):
        x = _encoder_layer(x, bias, cfg, i, segment_ids=segment_ids)

    cls = layers.slice(x, axes=[1], starts=[0], ends=[1])
    cls = layers.reshape(cls, shape=[-1, cfg.hidden_size])
    pooled = layers.fc(cls, size=cfg.hidden_size, act="tanh",
                       param_attr=ParamAttr(name="pooled_fc_w"),
                       bias_attr=ParamAttr(name="pooled_fc_b"))
    return x, pooled


def _mlm_head(seq_out, mask_pos, mask_label, mask_weight, cfg):
    """Masked-LM head shared by the padded and packed pretrain graphs:
    gather masked positions from the flattened token grid, transform,
    project through the TIED word-embedding table (the BERT/ERNIE
    recipe), and return the weight-normalized mean token loss."""
    flat = layers.reshape(seq_out, shape=[-1, cfg.hidden_size])
    flat_pos = layers.reshape(mask_pos, shape=[-1])
    masked_h = layers.gather(flat, flat_pos)          # (B*P, H)
    trans = layers.fc(masked_h, size=cfg.hidden_size, act=cfg.hidden_act,
                      param_attr=ParamAttr(name="mlm_trans_w"),
                      bias_attr=ParamAttr(name="mlm_trans_b"))
    trans = layers.layer_norm(trans, begin_norm_axis=1,
                              param_attr=ParamAttr(name="mlm_ln_w"),
                              bias_attr=ParamAttr(name="mlm_ln_b"))
    word_emb = framework.default_main_program().global_block().var(
        "word_embedding")
    mlm_bias = layers.create_parameter(
        [cfg.vocab_size], "float32", attr=ParamAttr(name="mlm_out_b"),
        is_bias=True)
    mlm_logits = layers.elementwise_add(
        layers.matmul(trans, word_emb, transpose_y=True), mlm_bias)
    mlm_loss_tok = layers.softmax_with_cross_entropy(
        logits=mlm_logits,
        label=layers.reshape(mask_label, shape=[-1, 1]))
    w = layers.reshape(mask_weight, shape=[-1, 1])
    return layers.elementwise_div(
        layers.reduce_sum(layers.elementwise_mul(mlm_loss_tok, w)),
        layers.elementwise_add(layers.reduce_sum(w),
                               layers.fill_constant([1], "float32", 1e-6)))


def build_pretrain_net(cfg=None, seq_len=128):
    """Full MLM+NSP pretraining graph.

    Feeds: src_ids, sent_ids, input_mask (B,T); mask_pos (B,P) flat indices
    into the (B*T) token grid; mask_label (B,P); mask_weight (B,P) 1.0 for
    real predictions 0.0 for padding; labels (B,1) NSP.
    Returns (feed dict, total_loss, mlm_loss, nsp_acc).
    """
    cfg = cfg or BertConfig()
    src_ids = layers.data("src_ids", shape=[seq_len], dtype="int64")
    sent_ids = layers.data("sent_ids", shape=[seq_len], dtype="int64")
    input_mask = layers.data("input_mask", shape=[seq_len], dtype="float32")
    P = cfg.max_predictions_per_seq
    mask_pos = layers.data("mask_pos", shape=[P], dtype="int64")
    mask_label = layers.data("mask_label", shape=[P], dtype="int64")
    mask_weight = layers.data("mask_weight", shape=[P], dtype="float32")
    nsp_label = layers.data("nsp_label", shape=[1], dtype="int64")

    seq_out, pooled = bert_encoder(src_ids, sent_ids, input_mask, cfg)

    mlm_loss = _mlm_head(seq_out, mask_pos, mask_label, mask_weight, cfg)

    # ---- NSP head.
    nsp_logits = layers.fc(pooled, size=2,
                           param_attr=ParamAttr(name="nsp_fc_w"),
                           bias_attr=ParamAttr(name="nsp_fc_b"))
    nsp_loss = layers.mean(layers.softmax_with_cross_entropy(
        logits=nsp_logits, label=nsp_label))
    nsp_acc = layers.accuracy(input=layers.softmax(nsp_logits),
                              label=nsp_label)

    total_loss = layers.elementwise_add(mlm_loss, nsp_loss)
    feeds = {"src_ids": src_ids, "sent_ids": sent_ids,
             "input_mask": input_mask, "mask_pos": mask_pos,
             "mask_label": mask_label, "mask_weight": mask_weight,
             "nsp_label": nsp_label}
    return feeds, total_loss, mlm_loss, nsp_acc


def make_pretrain_feed(cfg, seq_len, batch, seed=0, dtype=None):
    """Synthetic feed dict matching build_pretrain_net's contract — the one
    place that knows the feed schema (used by chip_smoke.py and the
    tests)."""
    import numpy as np
    dtype = dtype or np.int64
    rs = np.random.RandomState(seed)
    P_ = cfg.max_predictions_per_seq
    return {
        "src_ids": rs.randint(0, cfg.vocab_size, (batch, seq_len)).astype(dtype),
        "sent_ids": rs.randint(0, 2, (batch, seq_len)).astype(dtype),
        "input_mask": np.ones((batch, seq_len), np.float32),
        "mask_pos": np.stack([np.arange(P_) + i * seq_len
                              for i in range(batch)]).astype(dtype),
        "mask_label": rs.randint(0, cfg.vocab_size, (batch, P_)).astype(dtype),
        "mask_weight": np.ones((batch, P_), np.float32),
        "nsp_label": rs.randint(0, 2, (batch, 1)).astype(dtype),
    }


def build_packed_pretrain_net(cfg=None, seq_len=128, max_predictions=None):
    """Packed-sequence MLM pretraining graph (throughput mode).

    Several short documents share each row (reader.pack_sequences does
    the host-side packing); attention stays per-document via the
    segment mask inside the flash kernel, and positions reset per
    document. MLM-only: NSP needs one [CLS] per document, which packing
    removes — the reference recipe's NSP belongs to the unpacked net.

    Feeds: src_ids, sent_ids, segment_ids, positions (B,T);
    mask_pos (B,P) flat indices into the (B*T) grid; mask_label (B,P);
    mask_weight (B,P). Returns (feed dict, mlm_loss).

    max_predictions is the PER-ROW budget. A packed row carries several
    documents' predictions, so it must scale with the packing factor —
    cfg.max_predictions_per_seq is the per-DOCUMENT budget and would
    silently starve later-packed documents. make_packed_pretrain_feed
    sizes its arrays to fit every document and the row budget here must
    match that width (pass feed["mask_pos"].shape[1]).
    """
    cfg = cfg or BertConfig()
    src_ids = layers.data("src_ids", shape=[seq_len], dtype="int64")
    sent_ids = layers.data("sent_ids", shape=[seq_len], dtype="int64")
    segment_ids = layers.data("segment_ids", shape=[seq_len], dtype="int64")
    positions = layers.data("positions", shape=[seq_len], dtype="int64")
    P = max_predictions or cfg.max_predictions_per_seq
    mask_pos = layers.data("mask_pos", shape=[P], dtype="int64")
    mask_label = layers.data("mask_label", shape=[P], dtype="int64")
    mask_weight = layers.data("mask_weight", shape=[P], dtype="float32")

    seq_out, _pooled = bert_encoder(src_ids, sent_ids, None, cfg,
                                    segment_ids=segment_ids,
                                    positions=positions)

    mlm_loss = _mlm_head(seq_out, mask_pos, mask_label, mask_weight, cfg)
    feeds = {"src_ids": src_ids, "sent_ids": sent_ids,
             "segment_ids": segment_ids, "positions": positions,
             "mask_pos": mask_pos, "mask_label": mask_label,
             "mask_weight": mask_weight}
    return feeds, mlm_loss


def make_packed_pretrain_feed(cfg, seq_len, n_docs, seed=0,
                              min_len=None, max_len=None):
    """Synthetic packed feed: n_docs variable-length documents packed
    into as few (seq_len,) rows as first-fit-decreasing manages, with a
    random ~15% of each document's tokens selected as MLM predictions.
    Returns (feed dict, n_rows). Doc lengths default to
    [seq_len//8, seq_len//2] — the regime where packing beats padding by
    2-4x on real-token throughput."""
    import numpy as np
    from ..reader.packing import pack_sequences
    rs = np.random.RandomState(seed)
    min_len = min_len or max(4, seq_len // 8)
    max_len = max_len or max(min_len + 1, seq_len // 2)
    P_ = cfg.max_predictions_per_seq
    samples = []
    for _ in range(n_docs):
        n = int(rs.randint(min_len, max_len + 1))
        toks = rs.randint(0, cfg.vocab_size, n)
        sent = rs.randint(0, cfg.type_vocab_size, n)
        is_pred = np.zeros(n, np.int64)
        n_pred = max(1, min(int(n * 0.15), P_))
        is_pred[rs.choice(n, n_pred, replace=False)] = 1
        label = rs.randint(0, cfg.vocab_size, n)
        samples.append((toks, sent, is_pred, label))
    packed = pack_sequences(samples, seq_len)
    src = packed["field_0"]
    n_rows = src.shape[0]
    # per-ROW prediction width: every packed document keeps its full
    # per-doc budget — no silent truncation of later-packed docs
    counts = [int(packed["field_2"][r].sum()) for r in range(n_rows)]
    p_row = max(max(counts), 1)
    mask_pos = np.zeros((n_rows, p_row), np.int64)
    mask_label = np.zeros((n_rows, p_row), np.int64)
    mask_weight = np.zeros((n_rows, p_row), np.float32)
    for r in range(n_rows):
        pos = np.nonzero(packed["field_2"][r])[0]
        mask_pos[r, :len(pos)] = r * seq_len + pos
        mask_label[r, :len(pos)] = packed["field_3"][r, pos]
        mask_weight[r, :len(pos)] = 1.0
    feed = {"src_ids": src, "sent_ids": packed["field_1"],
            "segment_ids": packed["segment_ids"],
            "positions": packed["positions"],
            "mask_pos": mask_pos, "mask_label": mask_label,
            "mask_weight": mask_weight}
    return feed, n_rows


def build_classifier_net(cfg=None, seq_len=128, num_labels=2):
    """Fine-tune head (sentence classification — ERNIE downstream parity).
    Returns (feeds, loss, accuracy, probs)."""
    cfg = cfg or BertConfig()
    src_ids = layers.data("src_ids", shape=[seq_len], dtype="int64")
    sent_ids = layers.data("sent_ids", shape=[seq_len], dtype="int64")
    input_mask = layers.data("input_mask", shape=[seq_len], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    _seq, pooled = bert_encoder(src_ids, sent_ids, input_mask, cfg)
    if cfg.hidden_dropout_prob:
        pooled = layers.dropout(pooled, cfg.hidden_dropout_prob)
    logits = layers.fc(pooled, size=num_labels,
                       param_attr=ParamAttr(name="cls_out_w"))
    loss = layers.mean(layers.softmax_with_cross_entropy(
        logits=logits, label=label))
    probs = layers.softmax(logits)
    acc = layers.accuracy(input=probs, label=label)
    feeds = {"src_ids": src_ids, "sent_ids": sent_ids,
             "input_mask": input_mask, "label": label}
    return feeds, loss, acc, probs
