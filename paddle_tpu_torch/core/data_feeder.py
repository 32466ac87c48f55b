"""DataFeeder: convert python/numpy minibatch rows to feed dicts.

Parity: python/paddle/fluid/data_feeder.py; the port's own copy of
``paddle_tpu/core/data_feeder.py``.
"""

import numpy as np

from .framework import convert_dtype


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None, bucketer=None):
        self.feed_vars = []
        for v in feed_list:
            if isinstance(v, str):
                from .framework import default_main_program
                v = (program or default_main_program()).global_block().var(v)
            self.feed_vars.append(v)
        self.place = place
        # optional core.bucketing.FeedBucketer: sample-list readers yield
        # ragged tail batches — padding them here keeps the step's feed
        # shapes at O(log n) distinct ones without touching the reader
        self._bucketer = bucketer

    def feed(self, iterable):
        """iterable: list of rows, each row a tuple aligned with feed_list."""
        columns = list(zip(*iterable))
        out = {}
        for var, col in zip(self.feed_vars, columns):
            arr = np.asarray(col, dtype=convert_dtype(var.dtype))
            want = [s for s in var.shape]
            # fluid appends a trailing [.,1] for int labels declared [1]
            if len(want) and want[0] == -1:
                want = want[1:]
            if want and list(arr.shape[1:]) != [s for s in want] and np.prod(
                    [s for s in want if s > 0]) == np.prod(arr.shape[1:] or [1]):
                arr = arr.reshape((arr.shape[0],) + tuple(
                    s if s > 0 else -1 for s in want))
            out[var.name] = arr
        if self._bucketer is not None:
            out = self._bucketer.bucket(out)
        return out
