"""Named-axis sharding rules per (arch x shape x mesh) (a port of
``repro/distributed/sharding.py``).

Logical axes (``repro_torch/nn/spec.py``) map to mesh axes per arch, with
per-leaf divisibility checks: a mesh axis is only used on a dim whose size
it divides, so no leaf is ever padded.

Baseline plan:
  * batch        -> (pod?, data)
  * heads/kv/mlp/vocab/experts -> model (tensor/expert parallelism)
  * optimizer state (fp32 m/v/master) additionally sharded over data on the
    first free divisible dim (ZeRO-1)
  * KV caches: batch -> data; kv_heads -> model when divisible, else cache
    sequence -> model (flash-decode-style KV-sequence sharding)
  * paged pools: kv heads -> model when divisible, else the in-page
    sequence axis; never the page axis

Eager torch has no GSPMD: a mesh here is a description (``Mesh``: axis
names and their sizes) and a placement is a tuple with one entry per dim,
a mesh axis name, a tuple of names (major to minor) or None, as a JAX
``PartitionSpec`` reads.  ``placement_bytes`` and ``local_shape`` say
what one device holds under a placement; ``repro_torch.weights`` cuts a
rank's shard by it, and ``distributed/tp.py`` serves over it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.spec import TensorSpec, tree_map_specs

Tree = Any


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh as its axis names and sizes (no devices, no process
    group): ``Mesh(("data", "model"), (32, 8))`` is 256 cards."""
    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} vs sizes "
                             f"{self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def __str__(self) -> str:
        return "x".join(map(str, self.sizes)) + \
            f" ({', '.join(self.axis_names)})"


def _axis_size(mesh: Mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(mesh.shape[n] for n in name)
    return mesh.shape[name]


def leaf_placement(spec: TensorSpec, rules: dict, mesh: Mesh) -> tuple:
    """Each dim's mesh axis under ``rules`` (logical axis -> mesh axis):
    None where the rule names no axis, an axis already used by an earlier
    dim, or one whose size does not divide the dim (never pad)."""
    used: set = set()
    out = []
    for dim, name in zip(spec.shape, spec.axes):
        mesh_axis = rules.get(name)
        flat = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        if (mesh_axis is None or any(a in used for a in flat)
                or dim % _axis_size(mesh, mesh_axis) != 0):
            out.append(None)
        else:
            used.update(flat)
            out.append(mesh_axis)
    return tuple(out)


def local_shape(shape, placement: tuple, mesh: Mesh) -> tuple:
    """The shape one device holds of a ``shape`` leaf under ``placement``."""
    return tuple(int(n) // _axis_size(mesh, ax)
                 for n, ax in zip(shape, placement))


def placement_bytes(shape, dtype, placement: tuple, mesh: Mesh) -> int:
    """Bytes one device holds of a ``shape`` leaf of ``dtype``."""
    return math.prod(local_shape(shape, placement, mesh)) * \
        torch.empty((), dtype=dtype).element_size()


def shard_index(axis, coords: dict, mesh: Mesh) -> int:
    """The block of a dim placed on ``axis`` that the device at ``coords``
    (mesh axis -> index) holds: row-major over a tuple of axes."""
    flat = axis if isinstance(axis, tuple) else (axis,)
    index = 0
    for name in flat:
        index = index * mesh.shape[name] + coords.get(name, 0)
    return index


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Mesh
    batch_axes: tuple  # mesh axes carrying the batch dim
    rules: dict  # logical axis -> mesh axis (params/activations)

    # ------------------------------------------------------------ params
    def params(self, spec_tree: Tree) -> Tree:
        return tree_map_specs(
            lambda _p, s: leaf_placement(s, self.rules, self.mesh),
            spec_tree)

    def opt_state(self, spec_tree: Tree):
        """ZeRO-1: m/v/master take the param placement plus the batch
        axes on the first free divisible dim; the step is replicated."""
        data_sz = _axis_size(self.mesh, self.batch_axes)

        def one(_path, s: TensorSpec):
            ps = list(leaf_placement(s, self.rules, self.mesh))
            for i, (dim, cur) in enumerate(zip(s.shape, ps)):
                if cur is None and dim % data_sz == 0 and dim > 0:
                    ps[i] = self.batch_axes
                    break
            return tuple(ps)

        from repro_torch.train.optimizer import AdamWState
        f32 = tree_map_specs(one, spec_tree)
        return AdamWState((), f32, f32, f32)

    # ------------------------------------------------------------ batches
    def batch(self, batch_tree: Tree) -> Tree:
        """Dim 0 on the batch axes where they divide it; the rest
        replicated (anything with a ``shape``)."""
        def one(leaf):
            shp = tuple(leaf.shape)
            b = shp[0] if shp else 0
            ax = self.batch_axes if b and b % _axis_size(
                self.mesh, self.batch_axes) == 0 else None
            return (ax,) + (None,) * (len(shp) - 1) if shp else ()

        return _map_leaves(one, batch_tree)

    # ------------------------------------------------------------ caches
    def cache(self, cfg: ArchConfig, cache_tree: dict) -> dict:
        mesh = self.mesh
        model_sz = _axis_size(mesh, "model")
        data_ax = self.batch_axes

        data_sz = _axis_size(mesh, data_ax)
        data_flat = data_ax if isinstance(data_ax, tuple) else (data_ax,)

        def shard_cache_leaf(name, leaf):
            shp = tuple(leaf.shape)
            ndim = len(shp)
            if name in ("k_pages", "v_pages", "k_scales", "v_scales"):
                # paged pool [L, P, bs, Hkv(, Dh)]: the page axis (1) stays
                # unsharded (host-side CoW copies, scatters and snapshot
                # export/import index it); kv heads on "model" when they
                # divide, else the in-page sequence axis (bs)
                Hkv, bs = shp[3], shp[2]
                ps = [None] * ndim
                if Hkv % model_sz == 0:
                    ps[3] = "model"
                elif bs % model_sz == 0:
                    ps[2] = "model"
                return tuple(ps)
            if name in ("k", "v", "xk", "xv"):
                # [L?, B, S, Hkv, Dh]
                Ld = ndim - 4
                B, S, Hkv = shp[Ld], shp[Ld + 1], shp[Ld + 2]
                ps = [None] * Ld
                b_ok = B % data_sz == 0
                ps.append(data_ax if b_ok else None)
                if Hkv % model_sz == 0:
                    ps += [None, "model", None]
                else:  # KV-sequence sharding (flash-decode style)
                    seq_ax = ("model",) if b_ok else data_flat + ("model",)
                    while seq_ax and S % _axis_size(mesh, seq_ax) != 0:
                        seq_ax = seq_ax[1:]
                    ps += [seq_ax or None, None, None]
                return tuple(ps)
            if name == "pos_map":
                return (data_ax if shp[0] % data_sz == 0 else None, None)
            # recurrent states (mamba/xlstm): batch -> data; the widest
            # divisible trailing dim -> model
            ps = [None] * ndim
            b_idx = {"conv": 2, "ssm": 2, "mconv": 2, "mC": 2, "mn": 2,
                     "mm": 2, "sc": 1, "sn": 1, "sm": 1, "sh": 1}.get(name, 0)
            if shp[b_idx] % data_sz == 0:
                ps[b_idx] = data_ax
            best, best_dim = None, 0
            for i in range(ndim - 1, b_idx, -1):
                if ps[i] is None and shp[i] % model_sz == 0 and \
                        shp[i] > best_dim:
                    best, best_dim = i, shp[i]
            if best is not None:
                ps[best] = "model"
            return tuple(ps)

        return {k: shard_cache_leaf(k, v) for k, v in cache_tree.items()}


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def make_plan(cfg: ArchConfig, mesh: Mesh, *,
              rules_override: dict | None = None) -> ShardingPlan:
    multi_pod = "pod" in mesh.axis_names
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    model_sz = mesh.shape["model"]
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rules = {
        "embed": None,
        "layers": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model" if cfg.n_experts and cfg.n_experts % model_sz == 0
        else None,
        "heads": "model" if (H * Dh) % model_sz == 0 and H % model_sz == 0
        else None,
        "kv_heads": "model" if (Hkv * Dh) % model_sz == 0 and
        Hkv % model_sz == 0 else None,
        "state": None,
        "conv": None,
        "batch": batch_axes,
        None: None,
    }
    if cfg.n_experts and rules["experts"] is None:
        # experts cannot split across devices: shard each expert's ff dim
        # through the "mlp" rule instead, and drop that rule too when even
        # the per-expert (or shared) ff dim does not divide, so that no
        # MoE block mixes the two layouts
        if cfg.moe_ff % model_sz != 0 or (
                cfg.shared_ff and cfg.shared_ff % model_sz != 0):
            rules["mlp"] = None
    if rules_override:
        rules.update(rules_override)
        batch_axes = rules["batch"]  # may be overridden (a pure-DP plan)
    return ShardingPlan(mesh=mesh, batch_axes=batch_axes, rules=rules)
