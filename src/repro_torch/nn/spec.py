"""Parameter-spec substrate: nested dicts of ``TensorSpec`` leaves.

``init_params`` materializes seeded tensors from one spec tree.  Each leaf
draws from its own ``torch.Generator`` seeded by the caller's seed and the
same sha256 path digest the JAX package folds into its key, so a leaf's
values depend only on (seed, path) and the device type.  On the CPU a
leaf is one fp32 draw, cast to the parameter type.  On a CUDA card it is
drawn there, from the card's counter-based (Philox) generator, in runs of
at most ``DEVICE_RUN`` values, each cast to the parameter type as it is
drawn: no fp32 copy of a whole leaf exists on the host or on the card
(zamba2-2.7b's stacked ``in_proj`` alone is 1.44 B values).  The CPU and
the card give different numbers for one seed; a caller that needs the
same weights on both draws on the CPU and copies.  The numbers differ
from ``jax.random``'s too; tests that compare the two packages convert
the JAX package's params with ``repro_torch.weights.from_jax_params``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

import torch

from repro_torch.device import resolve

Tree = Any


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple
    axes: tuple  # logical axis name (or None) per dim; len == len(shape)
    init: str = "normal"  # normal | zeros | ones | embed | scaled
    scale: float | None = None  # stddev override (normal/scaled)
    dtype: Any = None  # None -> use the caller's param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= int(s)
        return n


def tree_map_specs(fn: Callable[[str, TensorSpec], Any], tree: Tree,
                   path: str = "") -> Tree:
    """Map ``fn(path, spec)`` over every TensorSpec leaf, keeping structure."""
    if isinstance(tree, TensorSpec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_specs(fn, v, f"{path}/{i}")
               for i, v in enumerate(tree)]
        return type(tree)(out)
    raise TypeError(f"unexpected node in spec tree at {path!r}: {type(tree)}")


def tree_leaves(tree: Tree) -> list:
    """The leaves of a nested dict, in its insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


# values one draw on a CUDA card makes (64 MB of fp32 scratch)
DEVICE_RUN = 1 << 24


def _path_generator(seed: int, path: str, device="cpu") -> torch.Generator:
    digest = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4],
                            "little")
    # the CPU generator keeps 32 bits of its seed: fold the seed in there
    return torch.Generator(device=device).manual_seed(
        (digest ^ (int(seed) * 0x9E3779B1)) & 0xFFFFFFFF)


def _std(spec: TensorSpec) -> float:
    if spec.scale is not None:
        return spec.scale
    if spec.init == "embed":
        return 1.0
    # fan-in scaling on the first axis by convention
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1],
                                                            1)
    return fan_in ** -0.5


def _materialize(spec: TensorSpec, seed: int, path: str, dtype,
                 device: torch.device) -> torch.Tensor:
    dtype = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init not in ("normal", "embed", "scaled"):
        raise ValueError(f"unknown init {spec.init!r}")
    std = _std(spec)
    if device.type == "cpu":
        gen = _path_generator(seed, path)
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32) * std
        return x.to(dtype=dtype)
    gen = _path_generator(seed, path, device)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), DEVICE_RUN):
        run = flat[i:i + DEVICE_RUN]
        run.copy_(torch.randn(run.numel(), generator=gen, device=device,
                              dtype=torch.float32).mul_(std))
    return out


def abstract_params(spec_tree: Tree, dtype=torch.float32) -> Tree:
    """``meta`` stand-ins of the parameters (shape and dtype, no storage),
    for the dry run; JAX ``nn/spec.py:abstract_params``."""
    return tree_map_specs(
        lambda _, s: torch.empty(s.shape, dtype=s.dtype or dtype,
                                 device="meta"), spec_tree)


def init_params(spec_tree: Tree, seed: int = 0, dtype=torch.float32,
                device=None) -> Tree:
    """Materialize seeded tensors on ``device`` (the card unless the
    caller says ``"cpu"``); each leaf seeded by (seed, its path)."""
    device = resolve(device)
    return tree_map_specs(
        lambda path, s: _materialize(s, seed, path, dtype, device),
        spec_tree)
