"""Port serving engine on the dense cache backend and with monolithic
prefill, against the JAX package's engine: the same fp32 weights and the
same request streams give identical ``Request.output`` and identical
prefill and page-bookkeeping stats, for the dense chunked engine, the
dense monolithic engine, the paged monolithic engine (bf16 and int8 pools,
with prefix hits: ``_clip_reuse`` and ``prefill_with_prefix``),
speculation with monolithic prefill and media requests on the dense
backend.  int8 runs are held to the JAX int8 engine, never to a bf16 one.
Also, in the port alone: the dense and paged engines agree (the workload
of test_kv_cache.py:188-206), chunked, whole-prompt and exact-shape
prefill agree on both backends (test_prefill_sched.py:116-120), a reused
dense slot shows none of its previous occupant's entries, and monolithic
admission honours a one-token budget."""
import functools

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
    from repro.serving.segments import EmbedSegment as JEmbed
    from repro.serving.segments import TextSegment as JText
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.segments import EmbedSegment, TextSegment
from repro_torch.weights import from_jax_params

PREFILL_STATS = ("prefill_tokens_computed", "prefill_tokens_padded",
                 "prefix_tokens_reused", "decode_tokens",
                 "requests_finished")
PAGE_STATS = ("prefix_hits", "cow_copies", "pages_in_use")
SPEC_STATS = ("spec_tokens_drafted", "spec_tokens_accepted",
              "spec_tokens_wasted")


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host: JAX on a
    GPU computes fp32 products at a lower default precision than these
    tolerances allow for."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@functools.cache
def _models(arch):
    """The JAX model and fp32 params, and the port's model on the same
    params (CPU)."""
    cfg = jreduced(jget_config(arch), act_dtype="float32")
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tm = build_model(reduced(get_config(arch), act_dtype="float32"))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _port(arch):
    """The port's reduced fp32 model with seeded params (no JAX)."""
    model = build_model(reduced(get_config(arch), act_dtype="float32"))
    return model, model.init(0, param_dtype=torch.float32, device="cpu")


def _mixed(vocab):
    """The mixed-length stream of test_kv_cache.py:188-206."""
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (6, 21, 33, 9, 16)], 5


def _shared_prefix(vocab):
    """A shared 24-token prefix (three full pages of 8) then one of 40
    (five pages, rounded down to four by the monolithic path), with
    unrelated prompts between them."""
    rng = np.random.default_rng(4)
    shared = rng.integers(0, vocab, 24).astype(np.int32)
    longer = rng.integers(0, vocab, 40).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, 4)
                               .astype(np.int32)]) for _ in range(3)]
    prompts += [rng.integers(0, vocab, 13).astype(np.int32)]
    prompts += [np.concatenate([longer, rng.integers(0, vocab, n)
                                .astype(np.int32)]) for n in (3, 9)]
    return prompts, 4


def _serve(engine_cls, request_cls, model, params, prompts, new, **kw):
    eng = engine_cls(model, params, **{**dict(max_batch=2, max_seq=64,
                                              page_size=8), **kw})
    reqs = [request_cls(i, p, max_new_tokens=new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, [tuple(r.output) for r in reqs]


def _both(arch, prompts, new, **kw):
    """The JAX and the port's engine with the same arguments over the same
    stream: (JAX stats, JAX outputs, port stats, port outputs)."""
    _, jm, jp, tm, tp = _models(arch)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if "draft" in kw:  # the self-draft: the target's own config and weights
        del jkw["draft"], tkw["draft"]
        jkw.update(draft_config=jm.cfg, draft_params=jp)
        tkw.update(draft_config=tm.cfg, draft_params=tp)
    jeng, want = _serve(JEngine, JRequest, jm, jp, prompts, new, **jkw)
    eng, got = _serve(ServingEngine, Request, tm, tp, prompts, new, **tkw)
    return jeng.stats(), want, eng.stats(), got


ENGINE_CASES = [
    # dense chunked
    ("qwen2-0.5b", dict(paged=False, prefill_chunk=16), _mixed),
    ("gemma3-1b", dict(paged=False, prefill_chunk=8), _mixed),
    # dense monolithic
    ("qwen2-0.5b", dict(paged=False, prefill_chunk=0), _shared_prefix),
    ("gemma3-1b", dict(paged=False, prefill_chunk=0), _mixed),
    ("llama3.2-3b", dict(paged=False, prefill_chunk=0), _mixed),
    # paged monolithic with prefix hits
    ("qwen2-0.5b", dict(prefill_chunk=0), _shared_prefix),
    ("gemma3-1b", dict(prefill_chunk=0), _shared_prefix),
    ("qwen2-0.5b", dict(prefill_chunk=0, kv_dtype="int8"), _shared_prefix),
    ("gemma3-1b", dict(prefill_chunk=0, kv_dtype="int8"), _shared_prefix),
]


@pytest.mark.parametrize("arch,kw,workload", ENGINE_CASES)
def test_engine_matches_jax(need_jax, arch, kw, workload):
    prompts, new = workload(_models(arch)[0].vocab)
    js, want, ts, got = _both(arch, prompts, new, **kw)
    assert got == want
    assert all(len(o) == new for o in got)
    keys = PREFILL_STATS + (PAGE_STATS if kw.get("paged", True) else ())
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["paged"] == kw.get("paged", True)
    assert ts["chunked"] == (kw["prefill_chunk"] > 0)
    if kw["prefill_chunk"] == 0:
        assert ts["prefills"] == len(prompts) and ts["prefill_chunks"] == 0
        if kw.get("paged", True):  # the prefix hits went through the suffix
            assert ts["prefix_hits"] > 0 and ts["suffix_prefills"] > 0
            assert ts["prefix_tokens_reused"] == 16 + 16 + 32  # clipped


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spec_engine_with_monolithic_prefill_matches_jax(need_jax, kv_dtype):
    """Speculation (self-draft, spec_k = 3) with ``prefill_chunk=0``: the
    target prefills each prompt whole (a suffix on a prefix hit), the
    draft's decode runs the dense flash-decode path; tokens and the
    drafted/accepted/wasted counts equal the JAX engine's."""
    prompts, _ = _shared_prefix(_models("qwen2-0.5b")[0].vocab)
    js, want, ts, got = _both("qwen2-0.5b", prompts, 8, prefill_chunk=0,
                              kv_dtype=kv_dtype, spec_k=3, draft=True)
    assert got == want
    keys = PREFILL_STATS + PAGE_STATS + SPEC_STATS
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["draft_steps"] == 3 * ts["verify_steps"] > 0
    assert ts["draft_prefills"] == len(prompts)
    assert ts["suffix_prefills"] > 0


def _media_requests(cfg, seg_types, req_type):
    """Four requests of text head + media span + text tail (random
    features; the last repeats the first's head and span)."""
    Text, Embed = seg_types
    rng = np.random.default_rng(11)
    feats = [rng.normal(size=(n, cfg.d_model)).astype(np.float32)
             for n in (8, 5, 11)]
    heads = [rng.integers(0, cfg.vocab, n).astype(np.int32)
             for n in (5, 3, 6)]
    tails = [rng.integers(0, cfg.vocab, n).astype(np.int32)
             for n in (7, 12, 4, 9)]
    reqs = []
    for i, tail in enumerate(tails):
        j = i % 3
        segs = [Text(heads[j]), Embed(feats[j].copy(), modality="image"),
                Text(tail)]
        reqs.append(req_type(i, segments=segs, max_new_tokens=6))
    return reqs


@pytest.mark.parametrize("prefill_chunk", [8, 0])
def test_media_requests_on_the_dense_backend_match_jax(need_jax,
                                                       prefill_chunk):
    """Embedding-span prompts through the dense backend, chunked (a span
    crossing chunk boundaries) and monolithic: tokens and prefill stats
    equal the JAX engine's."""
    cfg, jm, jp, tm, tp = _models("qwen2-0.5b")
    kw = dict(max_batch=2, max_seq=64, paged=False,
              prefill_chunk=prefill_chunk)
    runs = []
    for eng_cls, req_cls, segs, model, params, ekw in (
            (JEngine, JRequest, (JText, JEmbed), jm, jp, {}),
            (ServingEngine, Request, (TextSegment, EmbedSegment), tm, tp,
             dict(device="cpu"))):
        eng = eng_cls(model, params, **kw, **ekw)
        reqs = _media_requests(cfg, segs, req_cls)
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        runs.append((eng.stats(), [tuple(r.output) for r in reqs]))
    (js, want), (ts, got) = runs
    assert got == want and all(len(o) == 6 for o in got)
    assert {k: ts[k] for k in PREFILL_STATS} == \
        {k: js[k] for k in PREFILL_STATS}


# ------------------------------------------------------- the port alone


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma3-1b"])
def test_dense_matches_paged(arch):
    """Port of test_kv_cache.py::test_engine_paged_matches_dense: the
    same outputs from the dense and the paged engine, chunked and
    monolithic."""
    model, params = _port(arch)
    prompts, new = _mixed(model.cfg.vocab)
    outs = {}
    for paged in (False, True):
        for chunk in (64, 0):
            _, outs[paged, chunk] = _serve(
                ServingEngine, Request, model, params, prompts, new,
                paged=paged, prefill_chunk=chunk, device="cpu")
    assert len({tuple(o) for o in outs.values()}) == 1


@pytest.mark.parametrize("paged", [False, True])
def test_chunked_matches_whole_prompt(paged):
    """Port of test_prefill_sched.py::test_chunked_matches_whole_prompt:
    chunked, bucketed whole-prompt and exact-shape prefill give the same
    tokens on both backends."""
    model, params = _port("qwen2-0.5b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, n).astype(np.int32)
               for n in (4, 9, 17, 26, 40, 61)]
    kw = dict(paged=paged, device="cpu")
    _, chunked = _serve(ServingEngine, Request, model, params, prompts, 4,
                        prefill_chunk=8, **kw)
    eng, whole = _serve(ServingEngine, Request, model, params, prompts, 4,
                        prefill_chunk=0, **kw)
    _, legacy = _serve(ServingEngine, Request, model, params, prompts, 4,
                       prefill_chunk=0, bucket_prompts=False, **kw)
    assert chunked == whole == legacy
    # monolithic shapes are bounded by the buckets {16, 32, 64}
    assert eng.prefill_trace_count() <= 3
    assert eng.jit_cache_sizes()["_prefill"] <= 3
    assert "_prefill_chunk" not in eng.jit_cache_sizes()


@pytest.mark.parametrize("prefill_chunk", [16, 0])
def test_reused_dense_slot_shows_no_stale_keys(prefill_chunk):
    """A 50-token prompt, then a 9-token one in the same (only) slot: right
    after the second prompt's prefill and first decode tick the slot's
    pos_map holds positions 0..9 and -1 everywhere else (the chunked path
    clears it at admission, the monolithic splice pads with -1), and the
    second request generates what it generates in a fresh engine."""
    model, params = _port("gemma3-1b")
    rng = np.random.default_rng(8)
    long_p = rng.integers(0, model.cfg.vocab, 50).astype(np.int32)
    short = rng.integers(0, model.cfg.vocab, 9).astype(np.int32)
    kw = dict(max_batch=1, max_seq=64, paged=False,
              prefill_chunk=prefill_chunk, device="cpu")
    eng = ServingEngine(model, params, **kw)
    eng.submit(Request(0, long_p, max_new_tokens=4))
    eng.run_until_drained()
    assert (eng.cache["pos_map"][0, :53] >= 0).all()
    req = eng.submit(Request(1, short, max_new_tokens=4))
    while len(req.output) < 2:
        eng.step()
    want = np.full(64, -1, np.int32)
    want[:10] = np.arange(10)
    np.testing.assert_array_equal(eng.cache["pos_map"][0].numpy(), want)
    eng.run_until_drained()
    _, fresh = _serve(ServingEngine, Request, model, params, [short], 4,
                      **kw)
    assert [tuple(req.output)] == fresh


@pytest.mark.parametrize("paged", [False, True])
def test_one_token_budget_finishes_at_monolithic_admission(paged):
    """Port of test_prefill_sched.py:150-161 on the monolithic path: a
    max_new_tokens=1 request emits its prefill token only and frees its
    slot (and pages)."""
    model, params = _port("qwen2-0.5b")
    prompt = np.random.default_rng(1).integers(0, model.cfg.vocab, 9)
    eng, outs = _serve(ServingEngine, Request, model, params,
                       [prompt.astype(np.int32)], 1, paged=paged,
                       prefill_chunk=0, device="cpu")
    assert len(outs[0]) == 1 and all(s is None for s in eng.slots)
    assert eng.stats()["decode_steps"] == 0
    if paged:
        assert all(t is None for t in eng.block_tables)
