"""Flowers-102 (synthetic). Parity: python/paddle/dataset/flowers.py."""
from .common import synthetic_image_reader


def train(mapper=None, buffered_size=1024, use_xmap=True):
    return synthetic_image_reader(2048, (3, 224, 224), 102, seed=122)


def test(mapper=None, buffered_size=1024, use_xmap=True):
    return synthetic_image_reader(256, (3, 224, 224), 102, seed=123)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return synthetic_image_reader(256, (3, 224, 224), 102, seed=124)
