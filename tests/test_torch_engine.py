"""Port serving engine against the JAX package's: the same fp32 weights and
the same request streams give identical ``Request.output`` and identical
page-bookkeeping stats, with bf16 and int8 pools.  int8 runs are held to
the JAX int8 engine, never to a bf16 one.  Also: unported knobs raise
``NotImplementedError`` (media requests, the dense backend, monolithic
prefill, admission batching and KV snapshot export no longer do), the
port imports neither JAX nor the JAX package, and an engine with no
device named needs a CUDA card."""
import ast
import pathlib

import numpy as np
import pytest
import torch

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
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.weights import from_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
STATS = ("prefix_hits", "prefix_tokens_reused", "prefill_tokens_computed",
         "prefill_tokens_padded", "cow_copies", "pages_in_use")


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host: JAX on a
    GPU computes fp32 products at a lower default precision than these
    tolerances allow for."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _mixed(vocab):
    """The mixed-length stream of test_kv_cache.py:188-206."""
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (6, 21, 33, 9, 16)], 5, {}


def _shared_prefix(vocab):
    """The shared-prefix stream of test_kv_cache.py:209-230."""
    rng = np.random.default_rng(4)
    shared = rng.integers(0, vocab, 24).astype(np.int32)
    return [np.concatenate([shared,
                            rng.integers(0, vocab, 4).astype(np.int32)])
            for _ in range(4)], 4, {}


def _small_chunks(vocab):
    """Several chunks per prompt under a one-chunk-per-tick budget."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (40, 7, 23, 50)], 6, dict(prefill_chunk=16,
                                               prefill_budget=16)


def _run(engine_cls, request_cls, model, params, prompts, new, **kw):
    eng = engine_cls(model, params, max_batch=2, max_seq=64, paged=True,
                     page_size=8, **kw)
    reqs = [request_cls(i, p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, [tuple(r.output) for r in reqs]


@pytest.mark.parametrize("workload", [_mixed, _shared_prefix, _small_chunks])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
def test_engine_matches_jax(need_jax, arch, kv_dtype, workload):
    cfg = jreduced(jget_config(arch), act_dtype="float32")
    jmodel = jbuild(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    model = build_model(reduced(get_config(arch), act_dtype="float32"))
    params = from_jax_params(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    prompts, new, kw = workload(cfg.vocab)
    jeng, want = _run(JEngine, JRequest, jmodel, jparams, prompts, new,
                      kv_dtype=kv_dtype, **kw)
    eng, got = _run(ServingEngine, Request, model, params, prompts, new,
                    kv_dtype=kv_dtype, device="cpu", **kw)
    assert got == want
    assert all(len(o) == new for o in got)
    js, ts = jeng.stats(), eng.stats()
    assert {k: ts[k] for k in STATS} == {k: js[k] for k in STATS}
    if workload is _shared_prefix:
        assert ts["prefix_hits"] > 0 and ts["prefix_tokens_reused"] >= 3 * 24


# moved only by KV export/import and admission batching
# (repro/serving/engine.py), which the workload below uses neither of:
# both engines leave them at 0 / empty (tests/test_torch_disagg.py moves
# them)
SNAPSHOT_STATS = ("kv_exported_pages", "kv_imported_pages",
                  "kv_export_bytes", "kv_import_bytes", "batch_admit_size")


def test_stats_have_the_jax_engines_keys(need_jax):
    """The same reduced qwen2-0.5b workload drained through both engines:
    every key of the JAX engine's ``stats()`` is in the port's, and the
    five metrics of KV export/import and admission batching agree."""
    cfg = jreduced(jget_config("qwen2-0.5b"), act_dtype="float32")
    jmodel = jbuild(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    model = build_model(reduced(get_config("qwen2-0.5b"),
                                act_dtype="float32"))
    params = from_jax_params(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    prompts, new, kw = _mixed(cfg.vocab)
    jeng, want = _run(JEngine, JRequest, jmodel, jparams, prompts, new, **kw)
    eng, got = _run(ServingEngine, Request, model, params, prompts, new,
                    device="cpu", **kw)
    assert got == want
    js, ts = jeng.stats(), eng.stats()
    assert sorted(set(js) - set(ts)) == []
    assert {k: ts[k] for k in SNAPSHOT_STATS} == \
        {k: js[k] for k in SNAPSHOT_STATS}
    assert ts["kv_exported_pages"] == 0 and ts["kv_import_bytes"] == 0


def test_padded_chunk_past_max_seq_matches_jax(need_jax):
    """A prefix hit of 56 tokens leaves 7 to prefill, padded to a 16-token
    chunk at positions 56..71, past max_seq 64: the rope positions of the
    padded columns must clamp into the table as JAX's gather does (the
    port raised IndexError here), and the tokens must match."""
    cfg = jreduced(jget_config("qwen2-0.5b"), act_dtype="float32")
    jmodel = jbuild(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    model = build_model(reduced(get_config("qwen2-0.5b"),
                                act_dtype="float32"))
    params = from_jax_params(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(0)
    first = rng.integers(0, cfg.vocab, 60).astype(np.int32)
    second = np.concatenate([first[:56], rng.integers(0, cfg.vocab, 7)
                             .astype(np.int32)])
    outs = []
    for eng_cls, req_cls, m, p, kw in (
            (JEngine, JRequest, jmodel, jparams, {}),
            (ServingEngine, Request, model, params, dict(device="cpu"))):
        eng = eng_cls(m, p, max_batch=2, max_seq=64, paged=True,
                      page_size=8, prefill_chunk=16, **kw)
        reqs = [req_cls(0, first, max_new_tokens=2),
                req_cls(1, second, max_new_tokens=1)]
        for r in reqs:  # one after the other: the second hits the first
            eng.submit(r)
            eng.run_until_drained()
        assert eng.stats()["prefix_tokens_reused"] == 56
        outs.append([tuple(r.output) for r in reqs])
    assert outs[0] == outs[1]


def _reduced_engine(arch="qwen2-0.5b", **kw):
    """An engine over reduced qwen2-0.5b's params; ``arch`` names the
    model the engine is built for (its checks run before any param is
    read)."""
    model = build_model(reduced(get_config("qwen2-0.5b"),
                                act_dtype="float32"))
    params = model.init(0, param_dtype=torch.float32, device="cpu")
    if arch != "qwen2-0.5b":
        model = build_model(reduced(get_config(arch)))
    return ServingEngine(model, params, max_batch=2, max_seq=64,
                         page_size=8, device="cpu", **kw)


@pytest.mark.parametrize("knob", [
    # a recurrent family is served on the dense backend only: the paged
    # one is refused as by the JAX engine
    dict(paged=True, arch="xlstm-1.3b"),
    dict(paged=False, kv_dtype="int8"),  # refused as by the JAX engine
    # a recurrent draft: refused as by the JAX engine
    dict(draft_config=reduced(get_config("zamba2-2.7b"))),
    # tensor-parallel serving is ported (tests/test_torch_tp.py): a mesh
    # that is not a distributed.tp.serving_mesh is refused
    dict(mesh=object()),
    # admission batching is ported: served (tests/test_torch_disagg.py
    # holds its groups to the JAX engine's)
    dict(sorted_batch_sizes=[1, 2], max_live_batches=1)])
def test_unported_knobs_raise(knob):
    """Knobs the port does not serve raise: a paged xlstm engine, an int8
    dense cache and a draft outside the attention family ``ValueError``,
    as in the JAX engine (engine.py's backend check,
    test_kv_quant.py:183-186, engine.py's draft check), a mesh that is
    not a ``serving_mesh`` ``TypeError``.  Tensor-parallel meshes are
    served (tests/test_torch_tp.py).  The dense
    backend and monolithic prefill of the attention family, MoE drafts,
    zamba2, xlstm, whisper and admission batching are ported
    (tests/test_torch_dense_engine.py, test_moe_draft_is_served,
    tests/test_torch_mamba2.py, test_torch_xlstm.py,
    test_torch_whisper.py, tests/test_torch_disagg.py); the batching
    knobs are served here."""
    if "sorted_batch_sizes" in knob:
        eng = _reduced_engine(**knob)
        reqs = [Request(i, np.arange(5 + 7 * i) % 97, max_new_tokens=3)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert all(r.done and len(r.output) == 3 for r in reqs)
        # one live group at a time, each the largest bucket the queue fills
        assert eng.metrics.histogram("batch_admit_size").values == [2, 1]
        return
    refused = {"arch": "paged serving needs", "kv_dtype": "paged",
               "draft_config": "attention-family"}
    for key, match in refused.items():
        if key in knob:
            with pytest.raises(ValueError, match=match):
                _reduced_engine(**knob)
            return
    with pytest.raises(TypeError, match="serving_mesh"):
        _reduced_engine(**knob)


def test_moe_draft_is_served():
    """An MoE draft (a 1-layer reduced granite-moe, the same vocab) for a
    dense target: served to every budget, and verification keeps the
    target's own greedy tokens.  MoE targets and drafts are held to the
    JAX engine in tests/test_torch_moe.py."""
    eng = _reduced_engine()
    draft = reduced(get_config("granite-moe-1b-a400m"), act_dtype="float32",
                    n_layers=1)
    dparams = build_model(draft).init(1, param_dtype=torch.float32,
                                      device="cpu")
    spec = ServingEngine(eng.model, eng.params, max_batch=2, max_seq=64,
                         page_size=8, device="cpu", draft_config=draft,
                         draft_params=dparams, spec_k=3)
    outs = []
    for e in (eng, spec):
        reqs = [Request(i, np.arange(5 + 7 * i) % 97, max_new_tokens=6)
                for i in range(3)]
        for r in reqs:
            e.submit(r)
        e.run_until_drained()
        outs.append([tuple(r.output) for r in reqs])
    assert outs[0] == outs[1] and all(len(o) == 6 for o in outs[1])
    assert spec.stats()["draft_steps"] > 0


def test_unported_requests_raise():
    """A media request, once unported, is accepted and served to its
    budget; KV snapshot export, once unported, refuses a request that is
    not decoding with the JAX engine's ValueError (tests/test_torch_disagg.py
    exports decoding ones)."""
    from repro_torch.serving.segments import EmbedSegment, TextSegment
    eng = _reduced_engine()
    media = Request(0, segments=[EmbedSegment(np.zeros((3, 64),
                                                       np.float32)),
                                 TextSegment(np.arange(4))],
                    max_new_tokens=3)
    assert eng.submit(media) is media
    eng.run_until_drained()
    assert media.done and len(media.output) == 3
    with pytest.raises(ValueError, match="not in decode phase"):
        eng.export_kv(0)  # finished
    with pytest.raises(ValueError, match="not in decode phase"):
        eng.evacuate(0)


def test_engine_counts_decode_steps_and_streams():
    eng = _reduced_engine()
    events = []
    reqs = [Request(i, np.arange(5 + 7 * i) % 97, max_new_tokens=4,
                    stream=events.append) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert sorted(r.uid for r in done) == [0, 1, 2]
    st = eng.stats()
    assert st["decode_tokens"] == 3 * 3 and st["decode_steps"] >= 3
    assert st["requests_finished"] == 3 and len(events) == 12
    sizes = eng.jit_cache_sizes()  # distinct shapes per step function
    assert sizes["_step"] == 1
    assert st["prefill_trace_count"] == sizes["_prefill_chunk"] >= 1
    assert eng.latency_stats()["n_requests"] == 3
    assert not eng.busy()
    eng.reset_prefix_cache()
    assert eng.pool.pages_in_use() == 0


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(reduced(get_config("qwen2-0.5b")))
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(ValueError, match="params are on"):
        ServingEngine(model, params, device="meta")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
