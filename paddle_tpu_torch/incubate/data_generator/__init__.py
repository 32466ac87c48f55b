"""MultiSlot data-generator authoring API (the producer half of the CTR
data pipeline).

Parity: python/paddle/fluid/incubate/data_generator/__init__.py:21
(``DataGenerator``), :240 (``MultiSlotStringDataGenerator``), :282
(``MultiSlotDataGenerator``); the port's own copy of
``paddle_tpu/incubate/data_generator``. Users subclass one of these, override
``generate_sample`` (and optionally ``generate_batch``), and run the
script as a dataset ``pipe_command`` — it reads raw lines from stdin and
emits the ``ids_num id1 id2 ...`` MultiSlot text that
``csrc/dataset_feed.cc`` (our native MultiSlotDataFeed) parses.

Differences from the reference (deliberate, API-compatible):
- ``run_from_stdin``/``run_from_memory`` take optional file objects and
  also accept an iterable of lines, so generators are unit-testable
  without process plumbing; called with no args they behave exactly like
  the reference (stdin -> stdout).
- the proto-info side file the reference threatens to generate ("the
  corresponding protofile will be generated") never was in 1.5 either;
  slot typing is tracked only for validation, as there.
"""

import numbers
import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    """Base class for user ETL scripts feeding fluid-style Datasets.

    Subclasses override ``generate_sample(line)`` to turn one raw input
    line into (an iterator of) samples shaped
    ``[(slot_name, [feasign, ...]), ...]``, and may override
    ``generate_batch(samples)`` for whole-batch post-processing
    (ref :21-238).
    """

    def __init__(self):
        self._proto_info = None
        self._line_limit = None
        self.batch_size_ = 32

    def _set_line_limit(self, line_limit):
        """Cap how many input lines run_from_stdin consumes."""
        if not isinstance(line_limit, int):
            raise ValueError(f"line_limit {type(line_limit)} must be int")
        if line_limit < 1:
            raise ValueError("line_limit can not be less than 1")
        self._line_limit = line_limit

    def set_batch(self, batch_size):
        """Batch size used to group samples before ``generate_batch``."""
        self.batch_size_ = batch_size

    def run_from_memory(self, out=None):
        """Emit samples produced by ``generate_sample(None)`` (debug /
        benchmarking path, ref :67-97)."""
        out = out if out is not None else sys.stdout
        self._drain(self.generate_sample(None)(), out)

    def run_from_stdin(self, lines=None, out=None):
        """Read raw lines, parse each via ``generate_sample``, write
        MultiSlot text (ref :100-139). ``lines``/``out`` default to
        stdin/stdout so a subclass script works as a ``pipe_command``
        unchanged. Honors ``_set_line_limit``."""
        lines = lines if lines is not None else sys.stdin
        out = out if out is not None else sys.stdout

        def samples():
            for n, line in enumerate(lines):
                if self._line_limit is not None and n >= self._line_limit:
                    return
                yield from self.generate_sample(line)()

        self._drain(samples(), out)

    def _drain(self, samples, out):
        batch = []
        for sample in samples:
            if sample is None:
                continue
            batch.append(sample)
            if len(batch) == self.batch_size_:
                self._flush(batch, out)
                batch = []
        if batch:
            self._flush(batch, out)

    def _flush(self, batch, out):
        for sample in self.generate_batch(batch)():
            out.write(self._gen_str(sample))

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")

    def generate_sample(self, line):
        raise NotImplementedError(
            "override generate_sample to return an iterator factory over "
            "[(name, [feasign, ...]), ...] samples")

    def generate_batch(self, samples):
        def local_iter():
            for sample in samples:
                yield sample

        return local_iter


def _check_sample(line):
    if not isinstance(line, (list, tuple)):
        raise ValueError(
            "the output of generate_sample must be list or tuple, e.g. "
            "[('words', [1926, 8, 17]), ('label', [1])]; got "
            f"{type(line)}")


class MultiSlotStringDataGenerator(DataGenerator):
    """Slots of pre-stringified feasigns -> ``len e1 e2 ...`` text
    (ref :240-280)."""

    def _gen_str(self, line):
        _check_sample(line)
        parts = []
        for name, elements in line:
            parts.append(str(len(elements)))
            parts.extend(elements)
        return " ".join(parts) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """Typed (int/float) slots -> ``len e1 e2 ...`` text, with slot
    name/order/type consistency validated across lines the way the
    reference tracks _proto_info (ref :282-375: first sample fixes the
    slot set; floats promote a slot to float; empty slots are an error
    the user must pad away)."""

    def _gen_str(self, line):
        _check_sample(line)
        first = self._proto_info is None
        if first:
            # build into a local and commit only on success, so a bad
            # first sample doesn't leave a half-registered slot set
            proto = []
        elif len(line) != len(self._proto_info):
            raise ValueError(
                "the complete field set of two given lines are "
                "inconsistent.")
        proto = proto if first else self._proto_info
        parts = []
        for index, (name, elements) in enumerate(line):
            if not isinstance(name, str):
                raise ValueError(f"name {type(name)} must be str")
            if not isinstance(elements, list):
                raise ValueError(f"elements {type(elements)} must be list")
            if not elements:
                raise ValueError(
                    "the elements of each field can not be empty, you "
                    "need to pad it in generate_sample().")
            if first:
                proto.append((name, "uint64"))
            elif name != proto[index][0]:
                raise ValueError(
                    f"field name mismatch: require "
                    f"<{proto[index][0]}>, got <{name}>.")
            parts.append(str(len(elements)))
            for elem in elements:
                # bool is an int subclass but str(True) would corrupt the
                # MultiSlot text; numpy scalars are fine once coerced
                if isinstance(elem, bool):
                    raise ValueError(
                        "element type bool is ambiguous; cast to int")
                if isinstance(elem, numbers.Integral):
                    elem = int(elem)
                elif isinstance(elem, numbers.Real):
                    proto[index] = (name, "float")
                    elem = float(elem)
                else:
                    raise ValueError(
                        f"element type {type(elem)} must be int or float")
                parts.append(str(elem))
        if first:
            self._proto_info = proto
        return " ".join(parts) + "\n"
