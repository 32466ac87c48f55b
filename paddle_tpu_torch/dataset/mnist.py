"""MNIST. Parity: python/paddle/dataset/mnist.py (reader_creator:41).

Real idx-gz decoding when the original files exist under DATA_HOME
(train-images-idx3-ubyte.gz etc. — big-endian magic/count header, uint8
pixels normalized to [-1, 1] exactly like the reference); deterministic
learnable synthetic otherwise (zero-egress environment).
"""

import gzip
import struct

import numpy as np

from .common import data_file, synthetic_image_reader


def _idx_reader_creator(image_path, label_path):
    def reader():
        with gzip.GzipFile(image_path, "rb") as f:
            img_buf = f.read()
        with gzip.GzipFile(label_path, "rb") as f:
            lab_buf = f.read()
        magic_img, n_img, rows, cols = struct.unpack_from(">IIII", img_buf, 0)
        magic_lab, n_lab = struct.unpack_from(">II", lab_buf, 0)
        assert magic_img == 2051 and magic_lab == 2049, "bad idx magic"
        n = min(n_img, n_lab)
        images = np.frombuffer(img_buf, np.uint8, n * rows * cols, 16)
        images = images.reshape(n, rows * cols).astype("float32")
        images = images / 255.0 * 2.0 - 1.0
        labels = np.frombuffer(lab_buf, np.uint8, n, 8)
        for i in range(n):
            yield images[i], int(labels[i])
    return reader


def train():
    img = data_file("train-images-idx3-ubyte.gz",
                    "mnist/train-images-idx3-ubyte.gz")
    lab = data_file("train-labels-idx1-ubyte.gz",
                    "mnist/train-labels-idx1-ubyte.gz")
    if img and lab:
        return _idx_reader_creator(img, lab)
    return synthetic_image_reader(8192, (784,), 10, seed=42)


def test():
    img = data_file("t10k-images-idx3-ubyte.gz",
                    "mnist/t10k-images-idx3-ubyte.gz")
    lab = data_file("t10k-labels-idx1-ubyte.gz",
                    "mnist/t10k-labels-idx1-ubyte.gz")
    if img and lab:
        return _idx_reader_creator(img, lab)
    return synthetic_image_reader(1024, (784,), 10, seed=43)
