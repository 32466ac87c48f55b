"""UCI housing. Parity: python/paddle/dataset/uci_housing.py (load_data:76).

Real decoding when housing.data exists under DATA_HOME: 506 rows of 14
whitespace-separated floats, features max-min normalized around the mean,
80/20 train/test split — same as the reference. Synthetic fallback
otherwise.
"""

import numpy as np

from .common import data_file, synthetic_regression_reader

feature_names = ['CRIM', 'ZN', 'INDUS', 'CHAS', 'NOX', 'RM', 'AGE', 'DIS',
                 'RAD', 'TAX', 'PTRATIO', 'B', 'LSTAT']

_TRAIN_RATIO = 0.8
_cache = None


def _load_real(path):
    global _cache
    if _cache is None:
        data = np.fromfile(path, sep=" ").reshape(-1, 14)
        maxs, mins, avgs = data.max(0), data.min(0), \
            data.sum(0) / data.shape[0]
        for i in range(13):
            data[:, i] = (data[:, i] - avgs[i]) / (maxs[i] - mins[i])
        offset = int(data.shape[0] * _TRAIN_RATIO)
        _cache = (data[:offset], data[offset:])
    return _cache


def _reader_creator(rows):
    def reader():
        for row in rows:
            yield row[:-1].astype("float32"), \
                row[-1:].astype("float32")
    return reader


def train():
    path = data_file("housing.data", "uci_housing/housing.data")
    if path:
        return _reader_creator(_load_real(path)[0])
    return synthetic_regression_reader(404, 13, seed=62)


def test():
    path = data_file("housing.data", "uci_housing/housing.data")
    if path:
        return _reader_creator(_load_real(path)[1])
    return synthetic_regression_reader(102, 13, seed=63)
