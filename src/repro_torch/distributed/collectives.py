"""The collectives of tensor-parallel serving, by mesh axis name.

The local model of ``distributed/tp.py`` names the axis its forward pass
gathers over (``cfg.tp_axis``, ``"model"``), as the JAX package's
``shard_map`` bodies do; ``ShardedServing`` binds that name to the rank's
view of the axis (``Axis``: its size, this rank's index, the process group)
around every call of the local model (``bind``), and the model code reads
it back through ``axis_index``, ``axis_size`` and ``all_gather``.  A name
that is not bound raises: a sharded local model only runs inside its
``ShardedServing`` wrappers.

Every collective is an all-gather (pure data movement), so a sharded
forward pass computes the unsharded one's values.  ``all_gather`` calls
``dist.all_gather`` with a list of outputs, which every
``torch.distributed`` version has (gloo and NCCL both gather bf16).  With
``host_staged`` (a gloo group whose ranks hold CUDA tensors: gloo gathers
host tensors only) the tensor is copied to the host, gathered there and
copied back; that is a property of the mesh, set by its caller, never
chosen by a fallback.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

_BOUND: dict = {}  # axis name -> Axis, inside ShardedServing's wrappers


@dataclasses.dataclass(frozen=True)
class Axis:
    """This rank's view of one mesh axis: ``size`` ranks, this one at
    ``index``, gathering over ``group`` (None: the default group)."""
    size: int
    index: int = 0
    group: Any = None
    host_staged: bool = False


@contextlib.contextmanager
def bind(name: str, axis: Axis):
    """Binds axis ``name`` to ``axis`` inside the block (nests)."""
    prev = _BOUND.get(name)
    _BOUND[name] = axis
    try:
        yield axis
    finally:
        if prev is None:
            del _BOUND[name]
        else:
            _BOUND[name] = prev


def bound(name: str) -> Axis:
    if name not in _BOUND:
        raise RuntimeError(
            f"mesh axis {name!r} is not bound: a tensor-parallel local "
            "model runs inside distributed.tp.ShardedServing's wrappers")
    return _BOUND[name]


def axis_index(name: str) -> int:
    return bound(name).index


def axis_size(name: str) -> int:
    return bound(name).size


def all_gather(x: torch.Tensor, name: str, dim: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` concatenated along ``dim`` in rank order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    axis = bound(name)
    if axis.size == 1:
        return x
    import torch.distributed as dist
    src = x.contiguous()
    if axis.host_staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts, dim % x.dim())
    all_gather.calls += 1
    all_gather.bytes += out.numel() * out.element_size()
    return out.to(x.device)


all_gather.calls = 0  # gathers made, for the smoke run's lines
all_gather.bytes = 0  # bytes of their outputs
