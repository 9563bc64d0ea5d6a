"""Device selection: the port runs on the card unless told otherwise."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, defaulting to ``cuda``.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is present: the port never falls back to the CPU
    on its own; pass ``device="cpu"`` to run there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
