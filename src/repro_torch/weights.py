"""Convert the JAX package's parameter tree into the port's dict, and cut
a leaf (or draw a tree one leaf at a time) into one device's shard under
the placements of ``distributed/sharding.py``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy torch can own
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(np_tree, dtype=None, device=None):
    """Nested dict of numpy arrays (the JAX params after ``np.asarray``)
    -> the same nested dict of tensors, keys and shapes unchanged.
    ``dtype=None`` keeps each leaf's own type."""
    device = resolve(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dtype, device)

    return conv(np_tree)


def shard_leaf(leaf: torch.Tensor, placement: tuple, mesh, coords: dict
               ) -> torch.Tensor:
    """The block of ``leaf`` that the device at ``coords`` (mesh axis ->
    index) holds under ``placement`` (``distributed/sharding.py``), in
    storage of its own (the full leaf can be freed)."""
    from repro_torch.distributed.sharding import _axis_size, shard_index
    out = leaf
    for dim, axis in enumerate(placement):
        if axis is None:
            continue
        n = leaf.shape[dim] // _axis_size(mesh, axis)
        out = out.narrow(dim, shard_index(axis, coords, mesh) * n, n)
    return out if out is leaf else out.clone(
        memory_format=torch.contiguous_format)


def init_shard(spec_tree, placements, mesh, coords: dict, seed: int = 0,
               dtype=torch.bfloat16, device=None):
    """The shard of ``init_params(spec_tree, seed, dtype, device)`` that
    the device at ``coords`` holds, drawn one leaf at a time and cut
    before the next is drawn: the rank never holds the whole tree (a
    full-width model on a card shared by its ranks), and its values are
    the full draw's bits."""
    from repro_torch.nn.spec import _materialize, tree_map_specs
    device = resolve(device)

    def one(path, spec):
        return shard_leaf(_materialize(spec, seed, path, dtype, device),
                          _at(placements, path), mesh, coords)

    return tree_map_specs(one, spec_tree)


def _at(tree, path: str):
    for key in path.strip("/").split("/"):
        tree = tree[key]
    return tree
