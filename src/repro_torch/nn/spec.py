"""Parameter-spec substrate: nested dicts of ``TensorSpec`` leaves.

``init_params`` materializes seeded tensors from one spec tree.  Each leaf
draws from its own ``torch.Generator`` seeded by the caller's seed and the
same sha256 path digest the JAX package folds into its key, so a leaf's
values depend only on (seed, path).  The numbers differ from
``jax.random``'s; tests that compare the two packages convert the JAX
package's params with ``repro_torch.weights.from_jax_params`` instead.
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


def _path_generator(seed: int, path: str) -> torch.Generator:
    digest = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4],
                            "little")
    # the CPU generator keeps 32 bits of its seed: fold the seed in there
    return torch.Generator().manual_seed(
        (digest ^ (int(seed) * 0x9E3779B1)) & 0xFFFFFFFF)


def _materialize(spec: TensorSpec, gen: torch.Generator, dtype,
                 device) -> torch.Tensor:
    dtype = spec.dtype or dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("normal", "embed", "scaled"):
        if spec.scale is not None:
            std = spec.scale
        elif spec.init == "embed":
            std = 1.0
        else:  # fan-in scaling on the first axis by convention
            fan_in = (spec.shape[0] if len(spec.shape) >= 2
                      else max(spec.shape[-1], 1))
            std = fan_in ** -0.5
        # drawn on the CPU so a seed gives the same weights on every device
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32) * std
        return x.to(device=device, dtype=dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(spec_tree: Tree, seed: int = 0, dtype=torch.float32,
                device=None) -> Tree:
    """Materialize seeded tensors; each leaf seeded by (seed, its path)."""
    device = resolve(device)
    return tree_map_specs(
        lambda path, s: _materialize(s, _path_generator(seed, path), dtype,
                                     device), spec_tree)
