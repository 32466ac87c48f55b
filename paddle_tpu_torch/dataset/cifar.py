"""CIFAR-10/100. Parity: python/paddle/dataset/cifar.py (reader_creator:49).

Real decoding when cifar-10-python.tar.gz / cifar-100-python.tar.gz exist
under DATA_HOME: pickled batch dicts (b'data' uint8 (N, 3072), b'labels' /
b'fine_labels'), pixels scaled to [0, 1] float32 like the reference.
Synthetic fallback otherwise.
"""

import pickle
import tarfile

from .common import data_file, synthetic_image_reader

_C10 = "cifar-10-python.tar.gz"
_C100 = "cifar-100-python.tar.gz"


def _tar_reader_creator(path, sub_name):
    def reader():
        with tarfile.open(path, mode="r") as f:
            names = [n for n in f.getnames() if sub_name in n]
            for name in sorted(names):
                batch = pickle.load(f.extractfile(name), encoding="bytes")
                data = batch[b"data"]
                labels = batch.get(b"labels", batch.get(b"fine_labels"))
                for i in range(len(labels)):
                    img = (data[i] / 255.0).astype("float32")
                    yield img.reshape(3, 32, 32), int(labels[i])
    return reader


def train10():
    path = data_file(_C10, "cifar/" + _C10)
    if path:
        return _tar_reader_creator(path, "data_batch")
    return synthetic_image_reader(8192, (3, 32, 32), 10, seed=52)


def test10():
    path = data_file(_C10, "cifar/" + _C10)
    if path:
        return _tar_reader_creator(path, "test_batch")
    return synthetic_image_reader(1024, (3, 32, 32), 10, seed=53)


def train100():
    path = data_file(_C100, "cifar/" + _C100)
    if path:
        return _tar_reader_creator(path, "train")
    return synthetic_image_reader(8192, (3, 32, 32), 100, seed=54)


def test100():
    path = data_file(_C100, "cifar/" + _C100)
    if path:
        return _tar_reader_creator(path, "test")
    return synthetic_image_reader(1024, (3, 32, 32), 100, seed=55)
