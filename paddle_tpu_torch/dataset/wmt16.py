"""WMT16 (synthetic). Parity: python/paddle/dataset/wmt16.py."""
from .common import synthetic_pair_reader


def train(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return synthetic_pair_reader(4096, src_dict_size, trg_dict_size, 32, 32,
                                 seed=112)


def test(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    return synthetic_pair_reader(512, src_dict_size, trg_dict_size, 32, 32,
                                 seed=113)


def validation(src_dict_size=10000, trg_dict_size=10000, src_lang="en"):
    """Parity: dataset/wmt16.py:245 — the held-out split."""
    return synthetic_pair_reader(512, src_dict_size, trg_dict_size, 32, 32,
                                 seed=114)


def get_dict(lang, dict_size, reverse=False):
    """Parity: dataset/wmt16.py:292 — the (synthetic) vocab for `lang`:
    word->id, or id->word with reverse=True. Tokens are deterministic
    `{lang}{id}` strings with the reference's reserved markers."""
    words = {0: "<s>", 1: "<e>", 2: "<unk>"}
    words.update({i: f"{lang}{i}" for i in range(3, dict_size)})
    if reverse:
        return words
    return {w: i for i, w in words.items()}


def fetch():
    """Parity: dataset/wmt16.py:322 — no-op offline (readers are
    synthetic unless real files sit under DATA_HOME; see
    common.download)."""
