"""Device resolution for the port's entry points."""

import torch


def resolve_device(device=None):
    """None means the card ("cuda"). A CUDA device raises when CUDA is
    unavailable: an entry point never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev
