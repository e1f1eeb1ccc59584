"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import contextlib
import functools

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
    """True when every tensor lies on the CPU or on ``meta`` (a kernel
    wrapper then runs its plain version: on ``meta``, shapes only, as the
    dry run traces), False when all are on one CUDA device (it launches
    the kernel); raises for a mix or another device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev.type != "cuda"


# observers of kernel-wrapper calls, innermost last: the dry run's counter
# (launch/analysis.py) installs itself here with ``observe_kernels``
_KERNEL_OBSERVERS: list = []


def kernel_wrapper(fn):
    """Decorates a kernel wrapper (the function that launches a kernel on
    the card or runs its plain version): with no observer installed it is
    ``fn`` itself; under ``observe_kernels(obs)`` a call goes through
    ``obs.kernel(name, fn, args, kwargs)``, which calls ``fn`` and sees
    its inputs and outputs as one kernel's."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _KERNEL_OBSERVERS:
            return fn(*args, **kwargs)
        return _KERNEL_OBSERVERS[-1].kernel(fn.__name__, fn, args, kwargs)

    return call


@contextlib.contextmanager
def observe_kernels(observer):
    """Routes every kernel-wrapper call through ``observer`` (see
    ``kernel_wrapper``) inside the block."""
    _KERNEL_OBSERVERS.append(observer)
    try:
        yield observer
    finally:
        _KERNEL_OBSERVERS.remove(observer)
