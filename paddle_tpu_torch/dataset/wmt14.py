"""WMT14 En-De (synthetic). Parity: python/paddle/dataset/wmt14.py."""
from .common import synthetic_pair_reader

SRC_VOCAB = 30000
TRG_VOCAB = 30000


def train(dict_size=SRC_VOCAB):
    return synthetic_pair_reader(4096, dict_size, dict_size, 32, 32, seed=102)


def test(dict_size=SRC_VOCAB):
    return synthetic_pair_reader(512, dict_size, dict_size, 32, 32, seed=103)


def get_dict(dict_size, reverse=True):
    """Parity: dataset/wmt14.py:155 — (src_dict, trg_dict) for the
    synthetic vocab; id->word when reverse (the reference default)."""
    def one(prefix):
        words = {0: "<s>", 1: "<e>", 2: "<unk>"}
        words.update({i: f"{prefix}{i}" for i in range(3, dict_size)})
        return words if reverse else {w: i for i, w in words.items()}

    return one("src"), one("trg")
