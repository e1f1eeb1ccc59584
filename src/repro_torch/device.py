"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card.

    Without a card, None raises instead of quietly running on the CPU:
    callers that want the CPU (the tests) say ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def on_cpu(what: str, *tensors) -> bool:
    """True when every tensor lies on the CPU (a kernel wrapper then runs
    its plain version), False when all are on one CUDA device (it launches
    the kernel); raises for a mix or another device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev.type == "cpu"
