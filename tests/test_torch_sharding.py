"""The port's sharding layer (``repro_torch/distributed/sharding.py``,
``tp.ShardedServing``'s layout and ``shard_params``, ``weights.init_shard``
and the dry run's mesh reckoning) against the JAX package's
``make_plan`` and ``ShardedServing`` on the 8-device host mesh
(``tests/conftest.py``): which dim of every parameter leaf, paged-pool
leaf, dense and recurrent cache leaf, ZeRO-1 moment and batch leaf holds
which mesh axis, every ``make_plan`` rule, ``tp_shards`` and the local
model's dimensions.  Placements compare with one-axis tuples written as
the axis (``("data",)`` as ``"data"``), as jax 0.9 spells them."""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.distributed import sharding as jsharding
    from repro.distributed.tp import ShardedServing as JSharded
    from repro.distributed.tp import serving_mesh as jserving_mesh
    from repro.models import build_model as jbuild
    from repro.nn.spec import TensorSpec as JTensorSpec
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import sharding
from repro_torch.distributed.tp import ServingMesh, ShardedServing
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_edge_mesh, make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.nn.spec import TensorSpec, init_params
from repro_torch.weights import init_shard

# (arch, config overrides): dense GQA, MoE with a shared expert, the
# replicated-attention and expert-ff layouts of test_tensor_parallel.py
LAYOUTS = {"dense": ("llama3.2-3b", {}),
           "moe": ("qwen2-moe-a2.7b", {}),
           "mqa": ("llama3.2-3b", {"n_kv_heads": 1}),
           "e6": ("qwen2-moe-a2.7b", {"n_experts": 6}),
           "granite": ("granite-moe-1b-a400m", {})}
# mesh shapes of 8 devices or fewer: (axis names, sizes)
MESHES = [(("model", "data"), (2, 1)), (("model", "data"), (4, 1)),
          (("data", "model"), (2, 4)), (("data", "model"), (1, 4)),
          (("pod", "data", "model"), (2, 2, 2))]


@pytest.fixture(autouse=True)
def need_jax():
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    if len(jax.devices("cpu")) < 8:
        pytest.skip("needs the 8 host devices of tests/conftest.py")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _norm(entry):
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else entry
    return entry


def _placement(p, ndim=None):
    """A JAX PartitionSpec or a port placement as a tuple of normalised
    entries, padded with None to ``ndim``."""
    out = tuple(_norm(e) for e in tuple(p))
    return out + (None,) * ((ndim or len(out)) - len(out))


def _cfgs(layout):
    arch, over = LAYOUTS[layout]
    return (dataclasses.replace(reduced(get_config(arch)), **over),
            dataclasses.replace(jreduced(jget_config(arch)), **over))


def _jmesh(names, sizes):
    n = int(np.prod(sizes))
    return JMesh(np.asarray(jax.devices("cpu")[:n]).reshape(sizes), names)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ------------------------------------------------------- ShardedServing


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_serving_layout_equals_jax(layout, width):
    """tp_shards, the local model's dimensions and every parameter leaf's
    placement equal the JAX ShardedServing's."""
    cfg, jcfg = _cfgs(layout)
    mine = ShardedServing(build_model(cfg), ServingMesh(width))
    ref = JSharded(jbuild(jcfg), jserving_mesh(width))
    assert mine.tp_shards == ref.tp_shards
    assert mine.kv_sharded == ref.kv_sharded
    for f in ("n_heads", "n_kv_heads", "d_ff", "moe_ff", "shared_ff",
              "head_dim", "n_experts", "tp_axis", "tp_shards"):
        assert getattr(mine.local_model.cfg, f) == \
            getattr(ref.local_model.cfg, f), f
    got = _flat(mine.param_pspecs)
    want = _flat(ref.param_pspecs)
    specs = _flat(mine.model.spec)
    assert got.keys() == want.keys() == specs.keys()
    for k in got:
        nd = len(specs[k].shape)
        assert _placement(got[k], nd) == _placement(want[k], nd), k
    assert {k: _norm(v) for k, v in mine.plan.rules.items()} == \
        {k: _norm(v) for k, v in ref.plan.rules.items()}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("layout", ["dense", "moe", "mqa"])
def test_pool_placement_equals_jax(layout, width, kv_dtype):
    """The paged pool's leaves: kv heads on ``model`` where they shard,
    else replicated, as the JAX engine places them; the rank's pool is the
    leaf's local shape."""
    cfg, jcfg = _cfgs(layout)
    mine = ShardedServing(build_model(cfg), ServingMesh(width))
    jm = jbuild(jcfg)
    ref = JSharded(jm, jserving_mesh(width))
    pool = build_model(cfg).abstract_paged_cache(9, 8, kv_dtype)
    jpool = jm.abstract_paged_cache(9, 8, kv_dtype=kv_dtype)
    got = mine.cache_pspecs(pool)
    want = ref.cache_shardings(jpool)
    local = mine.abstract_paged_cache(9, 8, kv_dtype)
    for k in pool:
        nd = pool[k].dim()
        assert _placement(got[k], nd) == _placement(want[k].spec, nd), k
        assert tuple(local[k].shape) == sharding.local_shape(
            pool[k].shape, got[k], mine.mesh.mesh) == \
            tuple(want[k].shard_shape(jpool[k].shape))


# ------------------------------------------------------- make_plan rules


@pytest.mark.parametrize("mesh", MESHES,
                         ids=lambda m: "x".join(map(str, m[1])))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_make_plan_equals_jax(layout, mesh):
    """Every rule, the parameter placements, the ZeRO-1 moments, a batch,
    and the dense (heads and KV-sequence fallback), paged and recurrent
    cache leaves, on meshes with and without a pod axis."""
    cfg, jcfg = _cfgs(layout)
    names, sizes = mesh
    m, jm = sharding.Mesh(names, sizes), _jmesh(names, sizes)
    plan, ref = sharding.make_plan(cfg, m), jsharding.make_plan(jcfg, jm)
    assert {k: _norm(v) for k, v in plan.rules.items()} == \
        {k: _norm(v) for k, v in ref.rules.items()}
    assert _norm(plan.batch_axes) == _norm(ref.batch_axes)
    model, jmodel = build_model(cfg), jbuild(jcfg)
    specs = _flat(model.spec)
    got = _flat(plan.params(model.spec))
    want = _flat(jax.tree.map(lambda s: s.spec, ref.params(jmodel.spec)))
    opt, jopt = plan.opt_state(model.spec), ref.opt_state(jmodel.spec)
    got_m = _flat(opt.m)
    want_m = _flat(jax.tree.map(lambda s: s.spec, jopt.m))
    for k in specs:
        nd = len(specs[k].shape)
        assert _placement(got[k], nd) == _placement(want[k], nd), k
        assert _placement(got_m[k], nd) == _placement(want_m[k], nd), k
    assert _placement(opt.step) == _placement(jopt.step.spec)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    leaves = {"k": (L, 4, 32, Hkv, D), "v": (L, 4, 32, Hkv, D),
              "xk": (L, 3, 16, 1, D), "pos_map": (4, 32),
              "k_pages": (L, 6, 8, Hkv, D), "k_scales": (L, 6, 8, Hkv),
              "v_pages": (L, 6, 8, 1, D), "conv": (L, 4, 2, 64),
              "ssm": (2, 2, 4, 8, 16, 16), "sc": (2, 4, 96), "mC": (2, 2, 4)}
    got = plan.cache(cfg, {k: torch.empty(s, device="meta")
                           for k, s in leaves.items()})
    want = ref.cache(jcfg, {k: np.zeros(s, np.int8)
                            for k, s in leaves.items()})
    for k, s in leaves.items():
        assert _placement(got[k], len(s)) == \
            _placement(want[k].spec, len(s)), k
    batch = {"tokens": torch.empty(4, 16, device="meta"),
             "odd": torch.empty(3, 5, device="meta")}
    jbatch = {k: np.zeros(tuple(v.shape), np.int32) for k, v in batch.items()}
    gb, wb = plan.batch(batch), ref.batch(jbatch)
    for k in batch:
        assert _placement(gb[k], 2) == _placement(wb[k].spec, 2), k


@pytest.mark.parametrize("size", [1, 2, 4])
def test_leaf_placement_never_pads(size):
    """A dim the axis does not divide stays unsharded, as JAX's
    ``_leaf_pspec``; an axis is used once per leaf."""
    m = sharding.Mesh(("model", "data"), (size, 1))
    jm = _jmesh(("model", "data"), (size, 1))
    rules = {"mlp": "model", "embed": "model", None: None}
    for shape, axes in [((size * 3 + 1,), ("mlp",)), ((size * 4,), ("mlp",)),
                        ((size * 2, size * 4), ("embed", "mlp")),
                        ((3, size * 4), ("embed", "mlp"))]:
        got = sharding.leaf_placement(TensorSpec(shape, axes), rules, m)
        want = jsharding._leaf_pspec(JTensorSpec(shape, axes, "zeros"),
                                     rules, jm)
        assert _placement(got, len(shape)) == _placement(want, len(shape))


# ------------------------------------------------------------- weights


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("layout", ["dense", "moe", "e6"])
def test_rank_shards_rebuild_the_tree(layout, width):
    """Concatenating the ranks' shards (``ShardedServing.shard_params``,
    as the engine cuts them) along each placed dim gives the full tree
    bit for bit, and ``init_shard`` draws each rank's shard of
    ``init_params`` without the whole tree."""
    cfg, _ = _cfgs(layout)
    model = build_model(cfg)
    sv = ShardedServing(model, ServingMesh(width))
    full = init_params(model.spec, 3, torch.bfloat16, "cpu")
    ranks = [ShardedServing(model, ServingMesh(width, rank=r))
             .shard_params(full) for r in range(width)]
    drawn = init_shard(model.spec, sv.param_pspecs, sv.mesh.mesh,
                       {"model": 1, "data": 0}, 3, torch.bfloat16, "cpu")
    flat_full, flat_pl = _flat(full), _flat(sv.param_pspecs)
    flat_ranks = [_flat(t) for t in ranks]
    for k, leaf in flat_full.items():
        pl = flat_pl[k]
        dims = [d for d, a in enumerate(pl) if a is not None]
        assert len(dims) <= 1, k
        if dims:
            rebuilt = torch.cat([fr[k] for fr in flat_ranks], dims[0])
        else:
            assert all(fr[k] is leaf for fr in flat_ranks)
            rebuilt = leaf
        assert torch.equal(rebuilt, leaf), k
        assert torch.equal(_flat(drawn)[k], flat_ranks[1][k]), k


# -------------------------------------------------------------- dry run


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "prefill_32k"])
@pytest.mark.parametrize("layout", ["dense", "moe"])
@pytest.mark.parametrize("mesh", [(("data", "model"), (2, 4)),
                                  (("data", "model"), (1, 4))],
                         ids=["2x4", "1x4"])
def test_dryrun_mesh_bytes_equal_the_plan(layout, mesh, shape):
    """A mesh cell's per-device arguments equal the JAX plan's
    reckoning: each leaf's ``NamedSharding.shard_shape`` under
    ``make_plan`` (bf16 params; fp32 m, v, master and an int32 step;
    the batch; the decode cache)."""
    cfg, jcfg = _cfgs(layout)
    names, sizes = mesh
    m, jm = sharding.Mesh(names, sizes), _jmesh(names, sizes)
    from repro_torch.configs import SHAPES
    sh = SHAPES[shape]
    got = dryrun.mesh_arguments(cfg, sh, m)
    ref = jsharding.make_plan(jcfg, jm)
    jmodel = jbuild(jcfg)

    def nbytes(sds, shardings):
        return sum(int(np.prod(s.shard_shape(a.shape))) *
                   np.dtype(a.dtype).itemsize
                   for a, s in zip(jax.tree.leaves(sds),
                                   jax.tree.leaves(shardings)))

    ab = jmodel.abstract(jnp.bfloat16)
    want = {"params": nbytes(ab, ref.params(jmodel.spec))}
    if sh.kind == "train":
        f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                          np.float32), ab)
        opt = ref.opt_state(jmodel.spec)
        want["opt_state"] = 4 + 3 * nbytes(f32, opt.m)
    batch = jmodel.input_specs(sh)
    want["batch"] = nbytes(batch, ref.batch(batch))
    if sh.kind == "decode":
        cache = jmodel.abstract_cache(sh.global_batch, sh.seq_len)
        want["cache"] = nbytes(cache, ref.cache(jcfg, cache))
    assert got == want
    rec = dryrun.mesh_cell(cfg.name, shape, m, cfg=cfg)
    assert rec["memory"]["argument_size_in_bytes"] == sum(want.values())
    assert rec["memory"]["temp_size_in_bytes"] is None
    assert rec["collective_bytes"] is None and rec["null_because"]
    assert rec["fits"] is None


def test_h100_meshes():
    """The production, multi-pod and edge meshes keep the JAX module's
    device counts, the model axis within one 8-card NVLink node."""
    prod, pods = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert prod.shape == {"data": 32, "model": 8} and prod.size == 256
    assert pods.shape == {"pod": 2, "data": 32, "model": 8}
    assert pods.size == 512
    assert make_edge_mesh(4).shape == {"data": 1, "model": 4}
