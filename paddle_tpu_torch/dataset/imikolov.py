"""imikolov (PTB language-model n-grams).
Parity: python/paddle/dataset/imikolov.py (build_dict:64, reader_creator:99).

Real decoding when the PTB simple-examples tarball (or extracted
ptb.{train,valid}.txt) exists under DATA_HOME: word dict built by frequency
with a min-freq cutoff and '<unk>'/'<e>' entries, text turned into
(n-1)-gram -> next-word tuples bracketed by <s>/<e>, same as the reference.
Synthetic Markov-stream fallback otherwise.
"""

import os
import tarfile

import numpy as np

from .common import _rng, data_file

WORD_DICT_SIZE = 2073

_TAR = "simple-examples.tgz"
_TRAIN_MEMBER = "./simple-examples/data/ptb.train.txt"
_TEST_MEMBER = "./simple-examples/data/ptb.valid.txt"


def _real_lines(split):
    tar = data_file(_TAR, "imikolov/" + _TAR)
    member = _TRAIN_MEMBER if split == "train" else _TEST_MEMBER
    if tar:
        with tarfile.open(tar) as f:
            names = f.getnames()
            m = member if member in names else member[2:]
            if m in names:
                return [l.decode() for l in f.extractfile(m).readlines()]
    txt = data_file(os.path.basename(member),
                    "imikolov/" + os.path.basename(member))
    if txt:
        with open(txt) as f:
            return f.readlines()
    return None


def build_dict(min_word_freq=50):
    lines = _real_lines("train")
    if lines is None:
        return {f"w{i}": i for i in range(WORD_DICT_SIZE)}
    freq = {}
    for line in lines:
        for w in line.strip().split():
            freq[w] = freq.get(w, 0) + 1
    freq.pop("<unk>", None)
    kept = sorted([(w, c) for w, c in freq.items() if c >= min_word_freq],
                  key=lambda wc: (-wc[1], wc[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    word_idx["<e>"] = len(word_idx)
    return word_idx


def _real_ngram_reader(split, word_idx, n):
    def reader():
        unk = word_idx["<unk>"]
        for line in _real_lines(split):
            words = ["<s>"] * (n - 1) + line.strip().split() + ["<e>"]
            ids = [word_idx.get(w, unk) for w in words]
            for i in range(n, len(ids) + 1):
                yield tuple(np.int64(w) for w in ids[i - n:i])
    return reader


def _ngram_reader(num, n, vocab, seed):
    def reader():
        rng = _rng(seed)
        # Markov-ish stream: next word = f(prev) + noise, learnable
        for _ in range(num):
            start = int(rng.randint(vocab))
            seq = [start]
            for _ in range(n - 1):
                nxt = (seq[-1] * 31 + 7) % vocab if rng.rand() < 0.8 \
                    else int(rng.randint(vocab))
                seq.append(nxt)
            yield tuple(np.int64(w) for w in seq)
    return reader


def train(word_idx, n):
    if _real_lines("train") is not None:
        return _real_ngram_reader("train", word_idx, n)
    return _ngram_reader(8192, n, len(word_idx), seed=82)


def test(word_idx, n):
    if _real_lines("test") is not None:
        return _real_ngram_reader("test", word_idx, n)
    return _ngram_reader(1024, n, len(word_idx), seed=83)
