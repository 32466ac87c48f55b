"""Transformer-base for WMT14/16 En-De machine translation.

Parity: the reference's Fluid Transformer recipe (models
PaddleNLP/neural_machine_translation/transformer, config
``ModelHyperParams``); the counterpart of
``paddle_tpu/models/transformer.py``, the same graph from the port's
``layers``: pre-norm residual blocks (the reference's
``pre_post_process_layer`` with cmd "n da"), the decoder's causal
self-attention and its cross-attention over the encoder's output, the
padding masks as additive (B, 1, 1, T) biases built from the lengths,
and a label-smoothed soft-label cross-entropy over the non-pad target
positions, divided by their count. Every ``multi_head_attention`` is the
``multihead_attention`` op, which sends CUDA tensors to the flash
kernels (``ops/attention_ops.py``): the bias reaches them as a stride-0
view, and since it is built from integer lengths it needs no gradient
(the kernels' backward never calls ``flash_dbias``). Beam decoding
rides ``layers.beam_search``.
"""

from .. import layers


class ModelHyperParams:
    """Transformer-base (the reference config's defaults)."""
    src_vocab_size = 10000
    trg_vocab_size = 10000
    max_length = 256
    d_model = 512
    d_inner_hid = 2048
    n_head = 8
    n_layer = 6
    dropout = 0.1
    bos_idx = 0
    eos_idx = 1
    label_smooth_eps = 0.1


def _pre_norm(x):
    return layers.layer_norm(x, begin_norm_axis=len(x.shape) - 1)


def _ffn(x, d_inner, d_model, dropout):
    h = layers.fc(x, size=d_inner, num_flatten_dims=2, act="relu")
    if dropout:
        h = layers.dropout(h, dropout)
    return layers.fc(h, size=d_model, num_flatten_dims=2)


def _embed(ids, vocab, d_model, dropout, name):
    from ..core.param_attr import ParamAttr
    emb = layers.embedding(ids, size=[vocab, d_model],
                           param_attr=ParamAttr(name=name))
    emb = layers.scale(emb, scale=d_model ** 0.5)
    emb = layers.add_position_encoding(emb)
    if dropout:
        emb = layers.dropout(emb, dropout)
    return emb


def _attn_bias_from_len(seq_len, max_len):
    """(B, 1) lengths -> the additive bias (B, 1, 1, T): exactly 0 where
    kept (1 x 1e9 - 1e9), -1e9 where padded."""
    mask = layers.sequence_mask(seq_len, maxlen=max_len, dtype="float32")
    mask = layers.reshape(mask, shape=[-1, 1, 1, max_len])
    return layers.scale(mask, scale=1e9, bias=-1e9)


def encoder(src_emb, attn_bias, cfg):
    x = src_emb
    for _ in range(cfg.n_layer):
        attn = layers.multi_head_attention(
            _pre_norm(x), num_heads=cfg.n_head, d_model=cfg.d_model,
            attn_bias=attn_bias, dropout_rate=cfg.dropout)
        x = layers.elementwise_add(x, attn)
        ffn = _ffn(_pre_norm(x), cfg.d_inner_hid, cfg.d_model, cfg.dropout)
        x = layers.elementwise_add(x, ffn)
    return _pre_norm(x)


def decoder(tgt_emb, enc_out, self_bias, cross_bias, cfg):
    x = tgt_emb
    for _ in range(cfg.n_layer):
        self_attn = layers.multi_head_attention(
            _pre_norm(x), num_heads=cfg.n_head, d_model=cfg.d_model,
            attn_bias=self_bias, causal=True, dropout_rate=cfg.dropout)
        x = layers.elementwise_add(x, self_attn)
        cross = layers.multi_head_attention(
            _pre_norm(x), keys=enc_out, values=enc_out,
            num_heads=cfg.n_head, d_model=cfg.d_model,
            attn_bias=cross_bias, dropout_rate=cfg.dropout)
        x = layers.elementwise_add(x, cross)
        ffn = _ffn(_pre_norm(x), cfg.d_inner_hid, cfg.d_model, cfg.dropout)
        x = layers.elementwise_add(x, ffn)
    return _pre_norm(x)


def transformer_logits(src_ids, src_len, tgt_ids, tgt_len, cfg):
    src_emb = _embed(src_ids, cfg.src_vocab_size, cfg.d_model, cfg.dropout,
                     "src_word_emb")
    tgt_emb = _embed(tgt_ids, cfg.trg_vocab_size, cfg.d_model, cfg.dropout,
                     "trg_word_emb")
    enc_bias = _attn_bias_from_len(src_len, src_ids.shape[1])
    dec_self_bias = _attn_bias_from_len(tgt_len, tgt_ids.shape[1])
    enc_out = encoder(src_emb, enc_bias, cfg)
    dec_out = decoder(tgt_emb, enc_out, dec_self_bias, enc_bias, cfg)
    return layers.fc(dec_out, size=cfg.trg_vocab_size, num_flatten_dims=2)


def build_train_net(cfg=None, max_len=64):
    """Returns (feeds dict, avg_loss, token_num).

    Loss = the label-smoothed softmax cross-entropy over non-pad target
    positions, summed and divided by the real token count (the
    reference recipe's)."""
    cfg = cfg or ModelHyperParams
    src = layers.data("src_ids", shape=[max_len], dtype="int64")
    src_len = layers.data("src_len", shape=[1], dtype="int64")
    tgt = layers.data("tgt_ids", shape=[max_len], dtype="int64")
    tgt_len = layers.data("tgt_len", shape=[1], dtype="int64")
    labels = layers.data("lbl_ids", shape=[max_len], dtype="int64")

    logits = transformer_logits(src, src_len, tgt, tgt_len, cfg)
    one_hot = layers.one_hot(labels, depth=cfg.trg_vocab_size)
    smooth = layers.label_smooth(one_hot, epsilon=cfg.label_smooth_eps)
    cost = layers.softmax_with_cross_entropy(
        logits=logits, label=smooth, soft_label=True)
    tgt_mask = layers.sequence_mask(tgt_len, maxlen=max_len, dtype="float32")
    masked = layers.elementwise_mul(
        layers.reshape(cost, shape=[-1, max_len]), tgt_mask)
    token_num = layers.reduce_sum(tgt_mask)
    avg_loss = layers.elementwise_div(layers.reduce_sum(masked), token_num)
    feeds = {"src_ids": src, "src_len": src_len, "tgt_ids": tgt,
             "tgt_len": tgt_len, "lbl_ids": labels}
    return feeds, avg_loss, token_num
