"""ERNIE-1.0 pretraining: knowledge masking over the BERT trunk.

The counterpart of ``paddle_tpu/models/ernie.py``, host-side numpy. ERNIE-1.0
shares BERT's encoder and MLM+NSP heads (``models/bert.py`` is the shared
trunk: the same sizes, tied MLM weights); what distinguishes it is
KNOWLEDGE MASKING: whole phrases / named entities are masked as
contiguous spans, so the model must reconstruct multi-token units from
context instead of single word pieces. Masking is data preparation: the
device graph is BERT's fixed-shape MLM+NSP step, and span sampling keeps
max_predictions_per_seq static.
"""

import numpy as np

from . import bert

# re-exported: ERNIE-1.0 is BERT-base sized with its own masking pipeline
ErnieConfig = bert.BertConfig
ernie_tiny = bert.bert_tiny
build_pretrain_net = bert.build_pretrain_net
build_classifier_net = bert.build_classifier_net
build_packed_pretrain_net = bert.build_packed_pretrain_net
make_packed_pretrain_feed = bert.make_packed_pretrain_feed

MASK_TOKEN_RATE = 0.8    # of selected positions: replaced with [MASK]
RANDOM_TOKEN_RATE = 0.1  # ... replaced with a random token (rest kept)


def sample_mask_spans(seq_len, spans, max_predictions, rs,
                      basic_rate=0.15):
    """Choose positions to mask, whole spans at a time.

    spans: list of (start, end) half-open intervals marking phrases /
    entities (from any tagger; the reference ships a offline tokenizer).
    Positions outside every span are single-token units. Greedily samples
    shuffled units until ~basic_rate * seq_len positions are taken, capped
    at max_predictions (static shape contract). Returns a sorted position
    list.
    """
    units, covered = [], set()
    for s, e in spans:
        s, e = max(0, int(s)), min(seq_len, int(e))
        # taggers can emit overlapping spans (entity inside phrase) —
        # keep only the not-yet-covered positions so no unit repeats one
        u = [p for p in range(s, e) if p not in covered]
        if u:
            units.append(u)
            covered.update(u)
    units.extend([p] for p in range(seq_len) if p not in covered)
    rs.shuffle(units)
    budget = max(1, int(seq_len * basic_rate))
    picked = []
    for u in units:
        if len(picked) >= budget or len(picked) + len(u) > max_predictions:
            continue
        picked.extend(u)
    return sorted(picked[:max_predictions])


def apply_knowledge_mask(src_ids, spans_per_row, cfg, seed=0,
                         mask_token_id=None):
    """Knowledge-masking data prep for one batch.

    src_ids: (B, T) int array of un-masked token ids. spans_per_row: per-row
    list of (start, end) phrase/entity spans. Returns a feed-ready dict
    fragment: masked src_ids plus (mask_pos, mask_label, mask_weight) with
    the static (B, P) shape build_pretrain_net expects; 80/10/10
    mask/random/keep policy per the BERT/ERNIE recipe.
    """
    src = np.array(src_ids, copy=True)
    b, t = src.shape
    P = cfg.max_predictions_per_seq
    mask_id = cfg.vocab_size - 1 if mask_token_id is None else mask_token_id
    rs = np.random.RandomState(seed)
    pos = np.zeros((b, P), np.int64)
    lab = np.zeros((b, P), np.int64)
    wgt = np.zeros((b, P), np.float32)
    for i in range(b):
        picked = sample_mask_spans(t, spans_per_row[i], P, rs)
        for j, p in enumerate(picked):
            pos[i, j] = i * t + p          # flat index into the (B*T) grid
            lab[i, j] = src[i, p]
            wgt[i, j] = 1.0
            r = rs.rand()
            if r < MASK_TOKEN_RATE:
                src[i, p] = mask_id
            elif r < MASK_TOKEN_RATE + RANDOM_TOKEN_RATE:
                src[i, p] = rs.randint(0, cfg.vocab_size)
            # else: keep the original token (model must still predict it)
    return {"src_ids": src, "mask_pos": pos, "mask_label": lab,
            "mask_weight": wgt}


def make_pretrain_feed(cfg, seq_len, batch, seed=0, dtype=None,
                       span_rate=0.2, max_span=4):
    """Synthetic ERNIE feed: random tokens + random phrase spans run through
    the real knowledge-masking pipeline (the chip script and the tests)."""
    dtype = dtype or np.int64
    rs = np.random.RandomState(seed)
    src = rs.randint(0, cfg.vocab_size, (batch, seq_len))
    spans_per_row = []
    for _ in range(batch):
        spans, p = [], 0
        while p < seq_len:
            if rs.rand() < span_rate:
                ln = rs.randint(2, max_span + 1)
                spans.append((p, min(seq_len, p + ln)))
                p += ln
            else:
                p += 1
        spans_per_row.append(spans)
    masked = apply_knowledge_mask(src, spans_per_row, cfg, seed=seed)
    return {
        "src_ids": masked["src_ids"].astype(dtype),
        "sent_ids": rs.randint(0, 2, (batch, seq_len)).astype(dtype),
        "input_mask": np.ones((batch, seq_len), np.float32),
        "mask_pos": masked["mask_pos"].astype(dtype),
        "mask_label": masked["mask_label"].astype(dtype),
        "mask_weight": masked["mask_weight"],
        "nsp_label": rs.randint(0, 2, (batch, 1)).astype(dtype),
    }
