"""Sentiment (synthetic). Parity: python/paddle/dataset/sentiment.py."""
from .common import synthetic_sequence_reader

WORD_DICT_SIZE = 1024


def get_word_dict():
    return {f"w{i}": i for i in range(WORD_DICT_SIZE)}


def train():
    return synthetic_sequence_reader(2048, WORD_DICT_SIZE, 64, 2, seed=142)


def test():
    return synthetic_sequence_reader(256, WORD_DICT_SIZE, 64, 2, seed=143)
