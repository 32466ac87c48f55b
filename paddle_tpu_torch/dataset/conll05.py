"""CoNLL-05 SRL (synthetic). Parity: python/paddle/dataset/conll05.py."""
import numpy as np
from .common import _rng

WORD_DICT_LEN = 44068
LABEL_DICT_LEN = 59
PRED_DICT_LEN = 3162


def get_dict():
    return ({f"w{i}": i for i in range(WORD_DICT_LEN)},
            {f"v{i}": i for i in range(PRED_DICT_LEN)},
            {f"l{i}": i for i in range(LABEL_DICT_LEN)})


def test():
    def reader():
        rng = _rng(132)
        for _ in range(512):
            n = int(rng.randint(8, 32))
            words = rng.randint(0, WORD_DICT_LEN, n).astype("int64")
            ctx = [rng.randint(0, WORD_DICT_LEN, n).astype("int64")
                   for _ in range(5)]
            pred = np.full(n, rng.randint(PRED_DICT_LEN), "int64")
            mark = rng.randint(0, 2, n).astype("int64")
            labels = ((words + pred) % LABEL_DICT_LEN).astype("int64")
            yield (words, *ctx, pred, mark, labels)
    return reader


def get_embedding():
    """Parity: dataset/conll05.py:218 — path to the pretrained word
    embedding table. Offline: a deterministic synthetic (WORD_DICT_LEN,
    32) table materializes under DATA_HOME once and its path returns —
    loaders (np.loadtxt-style text rows, like the reference file) work
    unchanged."""
    import os
    from .common import DATA_HOME, _rng
    path = os.path.join(DATA_HOME, "conll05st", "emb")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        emb = _rng(96).randn(WORD_DICT_LEN, 32).astype("float32")
        # write-then-rename: a killed or concurrent first call must not
        # leave a truncated table behind the exists() check
        tmp = f"{path}.tmp.{os.getpid()}"
        np.savetxt(tmp, emb, fmt="%.6f")
        os.replace(tmp, path)
    return path
