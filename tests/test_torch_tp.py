"""Tensor-parallel serving of the port (``repro_torch/distributed/tp.py``)
on the CPU: every case of ``tests/test_tensor_parallel.py:121-228`` served
by ``ServingEngine(mesh=serving_mesh(tp))`` at TP 1, 2 and 4 gives the
unsharded port engine's tokens exactly ({dense, MoE} x {bf16, int8} x
{chunked, monolithic} prefill x speculation, the replicated-attention and
expert-ff layouts), the fp32 cases also the JAX engine's, every rank the
same tokens, and a TP=4 evacuation resumes on a TP=1 engine with the
uninterrupted stream.

The ranks are processes of a gloo group over a file store
(``tp.spawn``): one spawn per width for the whole file (module fixtures
``tp2``/``tp4``), every case served inside the ranks by
``distributed/runs.py`` (a module without JAX: each rank imports the
module of its function).  The bf16 cases draw the port's seeded weights,
each rank only its shard (``weights.init_shard``); the fp32 cases take
the JAX package's weights, each rank cutting its shard from them."""
import dataclasses

import numpy as np
import pytest

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.distributed import runs, tp
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine

_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [9, 8, 7, 6, 5]]
_ARCH = {"dense": "llama3.2-3b", "moe": "qwen2-moe-a2.7b"}
# the layouts of test_tensor_parallel.py: dense GQA, MoE with a shared
# expert, replicated attention (1 kv head) and the expert-ff fallback
_LAYOUT = {"dense": ("dense", {}), "moe": ("moe", {}),
           "mqa": ("dense", {"n_kv_heads": 1}),
           "e6": ("moe", {"n_experts": 6})}
# case -> (layout, engine keywords)
_ENGINE = {
    "bf16": ("dense", {}),
    "int8": ("dense", {"kv_dtype": "int8"}),
    "moe-bf16": ("moe", {}),
    "moe-int8": ("moe", {"kv_dtype": "int8"}),
    "monolithic": ("dense", {"prefill_chunk": 0}),
    "chunk8": ("dense", {"prefill_chunk": 8}),
    "speculative": ("dense", {"draft": True, "draft_seed": 123,
                              "spec_k": 3}),
    "replicated-attention": ("mqa", {}),
    "expert-ff": ("e6", {}),
}
# the fp32 cases held to the JAX engine too
_FP32 = ("bf16", "int8", "moe-bf16", "monolithic", "speculative",
         "replicated-attention", "expert-ff")
_MIGRATE_PROMPT = np.random.default_rng(0).integers(1, 512, 23)
# the rest of the paged (attention) family, bf16 chunked: local:global
# windows and qk-norm on replicated heads (gemma3-1b), qk-norm on sharded
# heads (chameleon-34b), qkv biases (codeqwen1.5-7b), 2 kv heads
# (qwen2-0.5b: replicated at TP 4), 32 experts (granite-moe-1b-a400m)
_ZOO = ("gemma3-1b", "chameleon-34b", "codeqwen1.5-7b", "qwen2-0.5b",
        "granite-moe-1b-a400m")


def _cfg(layout, fp32=False):
    family, over = _LAYOUT[layout]
    extra = {"act_dtype": "float32"} if fp32 else {}
    cfg = reduced(get_config(_ARCH[family]), **extra)
    return dataclasses.replace(cfg, **over)


def _jparams(layout):
    family, over = _LAYOUT[layout]
    jcfg = dataclasses.replace(
        jreduced(jget_config(_ARCH[family]), act_dtype="float32"), **over)
    jm = jbuild(jcfg)
    with jax.default_device(jax.devices("cpu")[0]):
        params = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    return jm, jax.tree.map(np.asarray, params)


def _case(name, fp32=False, jp=None):
    layout, kw = _ENGINE[name]
    engine = dict(max_batch=2, max_seq=64, **kw)
    weights = jp if fp32 else {"seed": 0, "dtype": "bfloat16"}
    return dict(cfg=_cfg(layout, fp32), weights=weights, engine=engine,
                prompts=_PROMPTS, max_new_tokens=8, device="cpu")


def _migrate_case():
    return dict(cfg=_cfg("dense"), weights={"seed": 0, "dtype": "bfloat16"},
                engine=dict(max_batch=2, max_seq=64, page_size=8),
                prompts=[_MIGRATE_PROMPT], max_new_tokens=10,
                device="cpu", evacuate_after=4)


@pytest.fixture(scope="module")
def jweights():
    """The JAX package's fp32 weights of each layout (numpy), or None
    without JAX (the fp32 cases then take the port's seeded init)."""
    if jax is None:
        return None
    return {layout: _jparams(layout)[1] for layout in _LAYOUT}


@pytest.fixture(scope="module")
def cases(jweights):
    out = {name: _case(name) for name in _ENGINE}
    for arch in _ZOO:
        out["zoo/" + arch] = dict(_case("bf16"), cfg=reduced(get_config(arch)))
    for name in _FP32:
        jp = jweights[_ENGINE[name][0]] if jweights else None
        out[name + "/fp32"] = (_case(name, True, jp) if jp is not None
                               else dict(_case(name), cfg=_cfg(
                                   _ENGINE[name][0], True),
                                   weights={"seed": 0,
                                            "dtype": "float32"}))
    return out


@pytest.fixture(scope="module")
def base(cases):
    """The unsharded port engine's tokens of every case."""
    return {name: runs.serve(case)["tokens"] for name, case in cases.items()}


@pytest.fixture(scope="module")
def tp2(cases):
    return tp.spawn(runs.serve_cases, 2, "gloo", cases)


@pytest.fixture(scope="module")
def tp4(cases):
    return tp.spawn(runs.serve_cases, 4, "gloo",
                    {**cases, "migrate": _migrate_case()})


@pytest.mark.parametrize("name", sorted(_ENGINE) + [
    n + "/fp32" for n in _FP32])
def test_tp1_is_the_unsharded_engine(cases, base, name):
    """A TP=1 mesh needs no group and runs the plain model."""
    case = cases[name]
    got = runs.serve(case, tp.serving_mesh(1))
    assert got["tokens"] == base[name]
    assert got["tp_shards"] == () and not got["kv_sharded"]


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("name", sorted(_ENGINE))
def test_tp_token_identity(tp2, tp4, base, name, width):
    """test_tensor_parallel.py's token identity cases, every one at both
    widths: every rank emits the unsharded engine's tokens."""
    got = (tp2 if width == 2 else tp4)[name]
    assert got["ranks_agree"]
    assert got["tokens"] == base[name]
    layout = _ENGINE[name][0]
    if layout == "mqa":  # kv heads do not divide: attention replicated
        assert not got["kv_sharded"] and got["tp_shards"] == ("mlp",)
        assert got["pool_shape"][3] == 1
    else:
        assert got["kv_sharded"]
        assert got["pool_shape"][3] == _cfg(layout).n_kv_heads // width
    if layout == "e6" and width == 4:
        assert "expert_ff" in got["tp_shards"]
    if name == "speculative":
        assert got["stats"]["speculative"]
        assert got["stats"]["spec_tokens_drafted"] > 0


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("arch", _ZOO)
def test_tp_serves_the_attention_family(tp2, tp4, base, arch, width):
    """Every other paged config of the zoo at TP 2 and 4 emits the
    unsharded engine's tokens on every rank."""
    got = (tp2 if width == 2 else tp4)["zoo/" + arch]
    assert got["ranks_agree"] and got["tokens"] == base["zoo/" + arch]
    cfg = reduced(get_config(arch))
    assert got["kv_sharded"] == (cfg.n_kv_heads % width == 0)


@pytest.fixture(scope="module")
def jax_tokens(jweights):
    """The JAX engine's tokens of the fp32 cases, on the JAX weights."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    out = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for name in _FP32:
            layout, kw = _ENGINE[name]
            jm, _ = _jparams(layout)
            jp = jax.tree.map(jnp.asarray, jweights[layout])
            kw = dict(kw)
            if kw.pop("draft", False):
                kw["draft_config"] = jm.cfg
            eng = JEngine(jm, jp, max_batch=2, max_seq=64, **kw)
            reqs = [JRequest(i, np.asarray(p, np.int32), max_new_tokens=8)
                    for i, p in enumerate(_PROMPTS)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
            out[name] = [tuple(int(t) for t in r.output) for r in reqs]
    return out


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("name", _FP32)
def test_tp_fp32_matches_the_jax_engine(tp2, tp4, base, jax_tokens, name,
                                        width):
    """fp32 on the JAX package's weights: TP 2 and 4, the unsharded port
    engine and the JAX engine emit the same tokens."""
    got = (tp2 if width == 2 else tp4)[name + "/fp32"]
    assert got["ranks_agree"]
    assert got["tokens"] == base[name + "/fp32"] == jax_tokens[name]


def test_cross_mesh_migration_tp4_to_tp1(tp4):
    """Prefill and 4 tokens on a TP=4 mesh, evacuate, resume on an
    unsharded engine: the snapshot carries the whole kv-head axis and the
    global geometry, and the stream equals the uninterrupted one."""
    case = _migrate_case()
    got = tp4["migrate"]
    snap, req = got["snapshot"], got["request"]
    cfg = case["cfg"]
    assert snap.geometry == (cfg.n_layers, cfg.n_kv_heads, cfg.hd)
    assert snap.leaves["k_pages"].shape[3] == cfg.n_kv_heads
    eng = runs.build_engine(dict(case, evacuate_after=None))
    base_req = Request(0, _MIGRATE_PROMPT.copy(), max_new_tokens=10)
    eng.submit(base_req)
    eng.run_until_drained()
    eng.reset_prefix_cache()
    assert 4 <= len(req.output) < 10
    assert tuple(req.output) == tuple(base_req.output[:len(req.output)])
    eng.submit(req)
    eng.run_until_drained()
    assert tuple(req.output) == tuple(base_req.output)


def test_mesh_refusals():
    """A width without its group, or a group of another width, refuses."""
    with pytest.raises(ValueError, match="process group"):
        tp.serving_mesh(2)
    with pytest.raises(ValueError, match=">= 1"):
        tp.serving_mesh(0)
    model = build_model(_cfg("dense"))
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, params, paged=False, device="cpu",
                      mesh=tp.serving_mesh(1))


@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("shape", [(4, 3, 8, 10, 16, 128),
                                   (8, 3, 8, 256, 16, 128),
                                   (4, 8, 8, 10, 16, 128)])
def test_shard_plans_cut_as_the_global_width(shape, width):
    """A rank's paged decode and verify launches (its kv heads, the
    global ``plan_kv_heads``) split their keys as the unsharded call's
    plan does, with 1/tp of its CTAs: llama3.2-3b's decode tick, 8 slots
    over 4,096 keys (where the shard's own plan would cut more splits),
    chameleon-34b's tick."""
    from repro_torch.kernels import paged_decode, paged_verify
    B, G, Hkv, NB, bs, D = shape
    for T in (1, 4, 64):
        full = paged_verify.plan(B, T, G, Hkv, NB, bs, D)
        part = paged_verify.plan(B, T, G, Hkv // width, NB, bs, D,
                                 plan_kv_heads=Hkv)
        assert (part.split_keys, part.splits, part.rows) == \
            (full.split_keys, full.splits, full.rows)
        assert part.ctas * width == full.ctas
    full = paged_decode.plan(B, G, Hkv, NB, bs, D)
    part = paged_decode.plan(B, G, Hkv // width, NB, bs, D,
                             plan_kv_heads=Hkv)
    assert (part.split_keys, part.splits) == (full.split_keys, full.splits)
    assert part.ctas * width == full.ctas
    own = paged_decode.plan(B, G, Hkv // width, NB, bs, D)
    if NB * bs > 1024:  # long rows: the shard's own plan cuts more splits
        assert own.splits > full.splits
