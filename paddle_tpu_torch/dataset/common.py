"""Synthetic dataset machinery.

Parity: python/paddle/dataset/* API (train()/test() reader creators).
The environment has zero egress, so every dataset is a *deterministic
synthetic* with the exact shapes/dtypes/vocab sizes of the original —
recipes, tests and benchmarks run unchanged; accuracy targets are checked on
learnable synthetic structure (labels correlated with inputs), not noise.
"""

import os
import tempfile

import numpy as np

DATA_HOME = os.environ.get("PADDLE_TPU_DATA_HOME",
                           os.path.join(tempfile.gettempdir(),
                                        "paddle_tpu_dataset"))


def data_file(*names):
    """First existing real dataset file under DATA_HOME (or an absolute
    candidate), else None — decoders parse the real format when the user
    has dropped the original files in, and fall back to synthetic
    otherwise (zero-egress environment)."""
    for name in names:
        path = name if os.path.isabs(name) else os.path.join(DATA_HOME, name)
        if os.path.exists(path):
            return path
    return None


def _rng(seed):
    return np.random.RandomState(seed)


def synthetic_image_reader(num, shape, num_classes, seed, flatten=False,
                           template_seed=None):
    """Images whose class signal is a per-class template + noise, so simple
    models can actually fit them (MNIST-style learnability). The templates
    are keyed by dataset (template_seed), NOT by split — train and test
    must share them or the task is unlearnable."""
    if template_seed is None:
        template_seed = 1000 + num_classes * 17 + int(np.prod(shape)) % 997
    def reader():
        rng = _rng(seed)
        templates = _rng(template_seed).randn(num_classes, *shape).astype("float32")
        for i in range(num):
            label = int(rng.randint(num_classes))
            img = templates[label] + 0.5 * rng.randn(*shape).astype("float32")
            if flatten:
                img = img.reshape(-1)
            yield img.astype("float32"), label
    return reader


def synthetic_sequence_reader(num, vocab_size, seq_len, num_classes, seed,
                              template_seed=None):
    """Token sequences where the label depends on token statistics.
    Class centers are shared across splits (see synthetic_image_reader)."""
    if template_seed is None:
        template_seed = 2000 + num_classes * 13 + vocab_size % 991
    def reader():
        rng = _rng(seed)
        class_centers = _rng(template_seed).randint(
            0, vocab_size, size=(num_classes, seq_len))
        for i in range(num):
            label = int(rng.randint(num_classes))
            base = class_centers[label]
            noise = rng.randint(0, vocab_size, size=seq_len)
            mask = rng.rand(seq_len) < 0.3
            seq = np.where(mask, noise, base)
            yield seq.astype("int64"), label
    return reader


def synthetic_regression_reader(num, dim, seed, template_seed=None):
    if template_seed is None:
        template_seed = 3000 + dim  # shared across train/test splits
    def reader():
        rng = _rng(seed)
        w = _rng(template_seed).randn(dim).astype("float32")
        for i in range(num):
            x = rng.randn(dim).astype("float32")
            y = float(x @ w + 0.1 * rng.randn())
            yield x, np.array([y], dtype="float32")
    return reader


def synthetic_pair_reader(num, src_vocab, trg_vocab, src_len, trg_len, seed):
    """Translation pairs: target is a deterministic function of source
    (reversal + offset mod vocab) — learnable by seq2seq models."""
    def reader():
        rng = _rng(seed)
        for i in range(num):
            n = int(rng.randint(max(2, src_len // 2), src_len + 1))
            src = rng.randint(2, src_vocab, size=n)
            trg = (src[::-1] + 7) % (trg_vocab - 2) + 2
            yield src.astype("int64"), trg.astype("int64"), trg.astype("int64")
    return reader


def md5file(fname):
    """Parity: dataset/common.py:57 — md5 hex digest of a file."""
    import hashlib
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Parity: dataset/common.py:66 — resolve a dataset file path.

    This environment has zero egress, so no bytes are fetched: if the
    file already sits under DATA_HOME/module_name (user-provided), its
    path returns (with an md5 warning on mismatch, like the reference's
    retry would note); otherwise a RuntimeError explains the offline
    contract and the synthetic fallback every reader has.
    """
    import warnings
    filename = os.path.join(
        DATA_HOME, module_name,
        save_name if save_name is not None else url.split("/")[-1])
    if os.path.exists(filename):
        if md5sum and md5file(filename) != md5sum:
            warnings.warn(f"{filename} md5 does not match the reference "
                          f"checksum; using the file as-is", stacklevel=2)
        return filename
    raise RuntimeError(
        f"download({url!r}): this environment has no network egress. "
        f"Drop the original file at {filename} to use real data; every "
        f"paddle_tpu_torch.dataset reader otherwise falls back to a "
        f"deterministic synthetic with the original shapes/vocabs.")


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """Parity: dataset/common.py:122 — dump a reader into line_count-
    sized pickle chunks (files open BINARY; the python-2 reference
    opened text, which py3 pickle cannot use)."""
    import pickle
    dumper = dumper or pickle.dump
    if not callable(dumper):
        raise TypeError("dumper should be callable.")
    lines = []
    indx_f = 0
    for i, d in enumerate(reader()):
        lines.append(d)
        if i >= line_count and i % line_count == 0:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
                lines = []
                indx_f += 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """Parity: dataset/common.py:160 — read back split() chunks, every
    trainer_count-th file belonging to this trainer."""
    import glob
    import pickle
    loader = loader or pickle.load

    def reader():
        if not callable(loader):
            raise TypeError("loader should be callable.")
        file_list = sorted(glob.glob(files_pattern))
        for idx, fn in enumerate(file_list):
            if idx % trainer_count == trainer_id:
                with open(fn, "rb") as f:
                    for line in loader(f):
                        yield line

    return reader
