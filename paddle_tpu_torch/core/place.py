"""Device places.

Parity: paddle/fluid/platform/place.h — Place/CPUPlace/CUDAPlace, Fluid
1.5's own names. A place selects the torch device an Executor runs its ops
on: ``CUDAPlace(i)`` the card ``cuda:i`` (raising without CUDA: an entry
point never drops to the CPU on its own), ``CPUPlace()`` the CPU. There is
no ``TPUPlace`` alias in the port.
"""

from ..device import resolve_device


class Place:
    _kind = "undefined"

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def torch_device(self):
        raise NotImplementedError


class CPUPlace(Place):
    _kind = "cpu"

    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "CPUPlace"

    def torch_device(self):
        return resolve_device("cpu")


class CUDAPlace(Place):
    _kind = "cuda"

    def torch_device(self):
        return resolve_device(f"cuda:{self.device_id}")
