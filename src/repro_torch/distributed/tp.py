"""Tensor-parallel sharded serving over ``torch.distributed`` (a port of
``repro/distributed/tp.py``).

The JAX package wraps the hot entry points of ``Model`` in ``shard_map``
over a 1-D ``model`` mesh.  Here the counterpart is SPMD: one process per
rank, every rank running the same ``ServingEngine`` host logic on the same
requests, each holding its shard of the weights and a narrower paged
pool.  ``ShardedServing``'s wrappers call the rank's local model inside a
binding of the ``model`` axis to the rank's process group
(``collectives.bind``); the gathers live in the model code.

Every collective is an **all-gather, pure data movement**: no rank sums
partials, so each output element is computed whole on one rank.  The
hand-written kernels then give the unsharded call's slice bit for bit
(below), the projections included: a shard's columns run the
column-stable dense kernel (``kernels/dense_matmul.py``) under the global
width's plan, which equals those columns of the unsharded product (cuBLAS,
which picks its kernel by shape, does not at every shard shape), so a
sharded engine emits the unsharded engine's tokens exactly, bf16 too, as
the JAX package guarantees.  The layout:

  * attention: q/kv heads split over ``model`` (column-parallel qkv, exact
    local per-head attention); ``wo`` holds all H*Dh rows and 1/tp of the
    d_model output columns, gather-matmul-gather (``lm._col_gathered``).
    The paged pool's ``Hkv`` axis carries the head split, so a rank's pool
    is a narrower pool and every host-side page operation (CoW copies,
    scatters, snapshot export/import: the unsharded page axis 1) works
    unchanged;
  * dense mlp: column-parallel gate/up, output-column-parallel down;
  * MoE: the router stays replicated; expert parallelism slices the
    dispatch buffer per rank and all-gathers the expert outputs, falling
    back to sharding every expert's ff dim (and the down projection's
    output columns) when ``E % tp != 0``;
  * embedding / lm_head: replicated, so every rank holds the same logits
    and takes the same greedy token with no collective.

The kernels run at shard shapes (fewer heads, experts or columns per
call) under the launch plan of the global width (``api.py`` and
``lm.dense`` pass it), so a rank's output is the unsharded call's slice
bit for bit.

The local model is an ordinary ``Model`` whose config holds the per-rank
dimensions plus ``tp_axis``/``tp_shards`` (``dataclasses.replace``, as in
the JAX package).  When the kv heads do not divide ``tp``, attention and
its pool stay replicated while the mlp/expert dims still shard.

Snapshots gather the kv-head axis (``export_paged_kv``), so every rank
holds the same host ``KVSnapshot`` with the global geometry, and
``import_paged_kv`` re-shards into the rank's layout: a TP=4 snapshot
resumes on a TP=1 engine.

Processes: ``spawn(fn, tp, backend)`` starts ``tp`` ranks, each with its
group initialised over a file store in a temporary directory (no port to
collide on) and its ``serving_mesh(tp)``, calls ``fn(mesh, *args)`` on
every rank and returns rank 0's result.  ``fn`` must live in a module
that imports no JAX (``distributed/runs.py``): a spawned rank imports the
module of its function.  With NCCL each rank takes its own card; with
gloo ranks share a card and ``host_staged=True`` stages every gather
through host memory (gloo gathers host tensors only).
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import os
import tempfile
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (Mesh, ShardingPlan,
                                              leaf_placement, local_shape,
                                              make_plan)
from repro_torch.models.api import Model
from repro_torch.nn.spec import tree_map_specs
from repro_torch.weights import shard_leaf

Tree = Any

AXIS = "model"  # the local models' tp_axis
TIMEOUT_S = 600  # a collective's longest wait in a spawned group
HEAD_DIM = 3  # the kv-head axis of every paged pool leaf [L, P, bs, Hkv..]


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """This rank's view of a ``tp``-wide ``model`` axis (and a size-1
    ``data`` axis, so the ``make_plan`` batch rules stay well-formed):
    ``rank`` in ``group`` (None: the default group), gathers staged
    through host memory when ``host_staged``.  ``ServingMesh(tp)`` alone
    describes the layout (rank 0, no group): enough for placements, not
    for serving at ``tp`` > 1."""
    tp: int
    rank: int = 0
    group: Any = None
    host_staged: bool = False

    @property
    def mesh(self) -> Mesh:
        return Mesh(("model", "data"), (self.tp, 1))

    @property
    def axis(self) -> coll.Axis:
        return coll.Axis(self.tp, self.rank, self.group, self.host_staged)

    @property
    def coords(self) -> dict:
        return {"model": self.rank, "data": 0}


def serving_mesh(tp: int, *, group=None,
                 host_staged: bool = False) -> ServingMesh:
    """The rank's view of a ``tp``-wide ``model`` axis over ``group`` (the
    default process group when None).  ``tp`` 1 needs no group; ``tp`` > 1
    needs an initialised group of exactly ``tp`` ranks (``spawn``)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return ServingMesh(1)
    import torch.distributed as dist
    if not dist.is_initialized():
        raise ValueError(f"tp={tp} needs a process group of {tp} ranks "
                         "(distributed.tp.spawn), none is initialised")
    world = dist.get_world_size(group)
    if world != tp:
        raise ValueError(f"tp={tp} needs a group of {tp} ranks, this one "
                         f"has {world}")
    return ServingMesh(tp, dist.get_rank(group), group, host_staged)


@dataclasses.dataclass(frozen=True)
class ShardedServing:
    """Sharded view of one ``Model``'s serving surface over ``mesh``.
    Construction is cheap (layout decisions only)."""
    model: Model
    mesh: ServingMesh

    @property
    def cfg(self) -> ArchConfig:
        return self.model.cfg

    @property
    def tp(self) -> int:
        return self.mesh.tp

    # ------------------------------------------------------------- layout
    @functools.cached_property
    def tp_shards(self) -> "tuple[str, ...]":
        """Which components shard at this width, each gated on
        divisibility (``make_plan``'s never-pad rule)."""
        cfg, tp = self.cfg, self.tp
        if tp == 1:
            return ()  # the plain model, no collective at all
        shards: "list[str]" = []
        # output-column modes also split d_model (wo / down projections
        # hold 1/tp of their d_model output columns)
        d_ok = cfg.d_model % tp == 0
        if d_ok and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0:
            shards += ["heads", "kv_heads"]
        if cfg.n_experts:
            if cfg.n_experts % tp == 0:
                shards.append("experts")
            elif d_ok and cfg.moe_ff % tp == 0 and (
                    not cfg.shared_ff or cfg.shared_ff % tp == 0):
                shards.append("expert_ff")  # make_plan's expert fallback
                if cfg.shared_ff:
                    shards.append("shared_ff")
        elif d_ok and cfg.d_ff and cfg.d_ff % tp == 0:
            shards.append("mlp")
        return tuple(shards)

    @property
    def kv_sharded(self) -> bool:
        return "kv_heads" in self.tp_shards

    @functools.cached_property
    def plan(self) -> ShardingPlan:
        """The training rules with vocab/embed pinned replicated (the same
        logits on every rank) and each component rule matching
        ``tp_shards``."""
        sh = self.tp_shards
        override = {
            "vocab": None,
            "embed": None,
            "heads": "model" if "heads" in sh else None,
            "kv_heads": "model" if "kv_heads" in sh else None,
            "experts": "model" if "experts" in sh else None,
            "mlp": "model" if ("mlp" in sh or "expert_ff" in sh) else None,
            "batch": ("data",),
        }
        return make_plan(self.cfg, self.mesh.mesh, rules_override=override)

    @functools.cached_property
    def local_model(self) -> Model:
        """The per-rank model: same arch, 1/tp of every sharded dim, and
        ``tp_axis``/``tp_shards`` marking where the forward pass gathers.
        ``head_dim`` is pinned: ``d_model / n_heads`` would be wrong once
        the heads shrink."""
        cfg, tp, sh = self.cfg, self.tp, self.tp_shards
        if not sh:
            return self.model
        upd: dict = dict(tp_axis=AXIS, tp_shards=sh, head_dim=cfg.hd)
        if "heads" in sh:
            upd.update(n_heads=cfg.n_heads // tp,
                       n_kv_heads=cfg.n_kv_heads // tp)
        if "mlp" in sh:
            upd["d_ff"] = cfg.d_ff // tp
        if "expert_ff" in sh:
            upd["moe_ff"] = cfg.moe_ff // tp
            if "shared_ff" in sh:
                upd["shared_ff"] = cfg.shared_ff // tp
        # "experts": n_experts stays global; moe_apply reads the local
        # expert count off the sharded w_gate leaf and the (replicated)
        # router still sees all E logits
        return Model(dataclasses.replace(cfg, **upd))

    # ------------------------------------------------------------- params
    @functools.cached_property
    def param_pspecs(self) -> Tree:
        """Each leaf's placement.  Projections that close a sharded dim
        (wo, mlp/expert/shared down) are output-column-parallel: every
        contraction row, 1/tp of the trailing ``embed`` columns, so the
        local matmul after an input all-gather is exact.  Everything else
        follows the plan's rules."""
        rules, mesh, sh = self.plan.rules, self.mesh.mesh, self.tp_shards

        def leaf(_p, s):
            ax = s.axes
            if len(ax) >= 2 and ax[-1] == "embed" and (
                    (ax[-2] == "heads" and "heads" in sh)
                    or (ax[-2] == "mlp" and ("mlp" in sh or "expert_ff" in sh
                                             or "shared_ff" in sh))):
                return (None,) * (len(ax) - 1) + ("model",)
            return leaf_placement(s, rules, mesh)

        return tree_map_specs(leaf, self.model.spec)

    def shard_params(self, params: Tree) -> Tree:
        """This rank's tree: a leaf of the full shape is cut by its
        placement (``weights.shard_leaf``), a leaf already of the rank's
        shape (``weights.init_shard``) kept as it is."""
        def one(leaf, spec, placement):
            local = local_shape(spec.shape, placement, self.mesh.mesh)
            if tuple(leaf.shape) == local:
                return leaf
            if tuple(leaf.shape) != tuple(spec.shape):
                raise ValueError(f"param of shape {tuple(leaf.shape)}: "
                                 f"neither {tuple(spec.shape)} nor this "
                                 f"rank's {local}")
            return shard_leaf(leaf, placement, self.mesh.mesh,
                              self.mesh.coords)

        return _zip_map(one, params, self.model.spec, self.param_pspecs)

    # ------------------------------------------------------------- caches
    def cache_pspecs(self, cache_tree: dict) -> dict:
        """Placements of the paged pool leaves: ``ShardingPlan.cache``
        when the kv heads shard, else replicated (its in-page sequence
        fallback is a storage layout: the paged compute path cannot split
        offsets within a page)."""
        if not self.kv_sharded:
            return {k: (None,) * len(v.shape) for k, v in cache_tree.items()}
        return self.plan.cache(self.cfg, cache_tree)

    def abstract_paged_cache(self, num_pages: int, block_size: int,
                             kv_dtype: str = "bf16") -> dict:
        """This rank's pool leaves as ``meta`` tensors: ``Hkv / tp`` kv
        heads, or the whole pool when they do not shard."""
        return self.local_model.abstract_paged_cache(num_pages, block_size,
                                                     kv_dtype)

    # ---------------------------------------------------------- wrappers
    def _call(self, name: str, *args):
        with coll.bind(AXIS, self.mesh.axis):
            return getattr(self.local_model, name)(*args)

    def prefill(self, params, batch):
        """Monolithic/bucketed prefill (``Model.prefill``): the local
        heads' dense K/V."""
        return self._call("prefill", params, batch)

    def prefill_with_prefix(self, params, batch, prefix_k, prefix_v):
        return self._call("prefill_with_prefix", params, batch, prefix_k,
                          prefix_v)

    def serve_step_paged(self, params, cache, batch):
        return self._call("serve_step_paged", params, cache, batch)

    def verify_step_paged(self, params, cache, batch):
        return self._call("verify_step_paged", params, cache, batch)

    def prefill_chunk_paged(self, params, cache, batch):
        return self._call("prefill_chunk_paged", params, cache, batch)

    def export_paged_kv(self, cache, pages) -> dict:
        """``Model.export_paged_kv`` of the rank's pool, the kv-head axis
        gathered: every rank holds the whole snapshot."""
        leaves = self.local_model.export_paged_kv(cache, pages)
        if not self.kv_sharded:
            return leaves
        with coll.bind(AXIS, self.mesh.axis):
            return {name: coll.all_gather(leaf, AXIS, HEAD_DIM)
                    for name, leaf in leaves.items()}

    def import_paged_kv(self, cache, pages, leaves, src_dtype: str, *,
                        from_block: int = 0):
        """``Model.import_paged_kv`` of this rank's kv heads of a
        whole-geometry snapshot."""
        if self.kv_sharded:
            hk = self.local_model.cfg.n_kv_heads
            lo = self.mesh.rank * hk
            leaves = {name: leaf.narrow(HEAD_DIM, lo, hk)
                      for name, leaf in leaves.items()}
        return self.local_model.import_paged_kv(cache, pages, leaves,
                                                src_dtype,
                                                from_block=from_block)


def _zip_map(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    return fn(tree, *others)


# ---------------------------------------------------------------- processes


def _rank_main(rank: int, fn, tp: int, backend: str, host_staged: bool,
               workdir: str, args: tuple):
    import torch.distributed as dist
    torch.set_num_threads(1)  # ranks share the host's cores
    if backend == "nccl":
        torch.cuda.set_device(rank)  # one card a rank
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=tp,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = fn(serving_mesh(tp, host_staged=host_staged), *args)
        if rank == 0:
            torch.save(out, os.path.join(workdir, "result.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, tp: int, backend: str, *args, host_staged: bool = False):
    """Runs ``fn(serving_mesh(tp), *args)`` on ``tp`` new processes, one
    rank each, with their group on ``backend`` (``"gloo"`` or
    ``"nccl"``), and returns rank 0's result.  Each rank takes one CPU
    thread; a collective waits at most ``TIMEOUT_S``.  A rank
    that raises ends every rank and raises here."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_tp_") as workdir:
        mp.spawn(_rank_main, nprocs=tp, join=True,
                 args=(fn, tp, backend, host_staged, workdir, args))
        return torch.load(os.path.join(workdir, "result.pt"),
                          weights_only=False)
