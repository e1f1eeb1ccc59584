"""KV snapshot export/import and admission batching in the port's engine,
held to the JAX engine: the workloads of test_disagg.py (bit-identical
cross-engine resume for bf16/int8 pools and chunked/monolithic prefill,
mid-stream resume, snapshots that survive source eviction, prefix
re-registration on the receiver, import validation) and the engine part of
test_streaming.py (admission batching on a virtual clock), each run on
both engines from the same fp32 weights (reduced qwen2-0.5b, the JAX
package's init converted by ``from_jax_params``).

Tokens, page bookkeeping, admission groups and virtual times are compared
exactly.  Snapshot values are compared two ways: a snapshot the port
exports from pages it computed holds the JAX engine's layout, tokens,
hashes and page ids exactly and its values within one rounding of the
storage type (the two packages' fp32 products differ in their last bits
and can round a bf16 or int8 row the other way; fp32 scales within 1e-5
relative);
a JAX snapshot imported by the port and exported again gives back the
JAX engine's bits exactly, and either package resumes the other's
snapshot at the tokens the JAX engine gives."""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.kv_cache import KVSnapshot as JSnapshot
    from repro.serving.request import ContinuumRequest as JContinuumRequest
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kv_cache import KVSnapshot, ceil_blocks
from repro_torch.serving.request import ContinuumRequest
from repro_torch.weights import from_jax_params


class Side:
    """One package's engine, request types, model and weights."""

    def __init__(self, engine, request, creq, model, params, **kw):
        self.Engine, self.Request, self.CReq = engine, request, creq
        self.model, self.params, self.kw = model, params, kw

    def engine(self, **kw):
        kw = {"max_batch": 2, "max_seq": 64, "page_size": 8, **self.kw,
              **kw}
        return self.Engine(self.model, self.params, **kw)


@pytest.fixture(scope="module")
def sides():
    """(JAX side, port side, config); the JAX reference runs on the CPU
    on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        cfg = jreduced(jget_config("qwen2-0.5b"), act_dtype="float32")
        jmodel = jbuild(cfg)
        jparams = jmodel.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
        model = build_model(reduced(get_config("qwen2-0.5b"),
                                    act_dtype="float32"))
        params = from_jax_params(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
        yield (Side(JEngine, JRequest, JContinuumRequest, jmodel, jparams),
               Side(ServingEngine, Request, ContinuumRequest, model, params,
                    device="cpu"), cfg)


def _prompt(cfg, n=23, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, n).astype(
        np.int64)


def _decode_until(eng, uid, min_tokens):
    """Step until request ``uid`` is in a decode slot with at least
    ``min_tokens`` output tokens."""
    for _ in range(10_000):
        slot = eng.slot_of_request(uid)
        if slot is not None and len(eng.slots[slot].output) >= min_tokens:
            return eng.slots[slot]
        eng.step()
    raise AssertionError(f"request {uid} never reached {min_tokens} tokens")


def _base(side, prompt, new, **kw):
    """The single-engine run's tokens, and the engine, its trie reset."""
    eng = side.engine(**kw)
    req = side.Request(0, prompt.copy(), max_new_tokens=new)
    eng.submit(req)
    eng.run_until_drained()
    eng.reset_prefix_cache()
    return tuple(req.output), eng


# ------------------------------------------------- bit-identical resume


def _migrate(side, prompt, kv_dtype, chunk, js):
    """test_disagg.py::test_migrate_bit_identity on one package: returns
    the base tokens, the migrated runs' tokens and the four counters."""
    base, B = _base(side, prompt, 12, kv_dtype=kv_dtype,
                    prefill_chunk=chunk)
    A = side.engine(kv_dtype=kv_dtype, prefill_chunk=chunk)
    outs = []
    for uid, j in enumerate(js, start=1):
        req = side.Request(uid, prompt.copy(), max_new_tokens=12)
        A.submit(req)
        _decode_until(A, uid, j)
        pc_before = B.prefill_tokens_computed
        moved, snap = A.evacuate(uid)
        assert moved is req and req.imported is snap
        assert A.slot_of_request(uid) is None
        assert snap.kv_dtype == kv_dtype
        assert snap.num_tokens == len(prompt) + len(req.output) - 1
        B.submit(req)
        B.run_until_drained()
        assert B.prefill_tokens_computed == pc_before  # no prefill pass
        outs.append(tuple(req.output))
    counters = {n: (A if "export" in n else B).metrics.counter(n).value
                for n in ("kv_exported_pages", "kv_export_bytes",
                          "kv_imported_pages", "kv_import_bytes")}
    assert counters["kv_exported_pages"] > 0
    assert counters["kv_export_bytes"] == (counters["kv_exported_pages"]
                                           * A.page_bytes())
    assert counters["kv_import_bytes"] == (counters["kv_imported_pages"]
                                           * B.page_bytes())
    return base, outs, counters


@pytest.mark.parametrize("kv_dtype,chunk", [
    ("bf16", 8), ("bf16", 0), ("int8", 8), ("int8", 0)])
def test_migrate_bit_identity(sides, kv_dtype, chunk):
    """Prefill on engine A, decode on engine B: the port's tokens equal
    its single-engine run's with no prefill pass on B (both precisions,
    chunked and monolithic prefill, a fresh import and a re-import whose
    prompt blocks already sit in B's trie), and equal the JAX engine's
    tokens and page counters for the same migrations."""
    jside, tside, cfg = sides
    prompt = _prompt(cfg)
    js = (1, 4) if (kv_dtype == "bf16" and chunk) else (1,)
    want = _migrate(jside, prompt, kv_dtype, chunk, js)
    got = _migrate(tside, prompt, kv_dtype, chunk, js)
    base, outs, _ = got
    assert len(base) == 12 and all(o == base for o in outs)
    assert got == want


@pytest.mark.parametrize("src,dst", [("bf16", "int8"), ("int8", "bf16")])
def test_cross_precision_migration(sides, src, dst):
    """A snapshot adopted by a pool of the other precision (bf16 rows
    quantized by the engine's own recipe, int8 rows dequantized): served
    to its budget, the same tokens and imported pages as the JAX
    engine's."""
    jside, tside, cfg = sides
    prompt = _prompt(cfg, seed=2)
    runs = []
    for side in (jside, tside):
        A, B = side.engine(kv_dtype=src), side.engine(kv_dtype=dst)
        req = side.Request(1, prompt.copy(), max_new_tokens=10)
        A.submit(req)
        _decode_until(A, 1, 3)
        _, snap = A.evacuate(1)
        assert snap.kv_dtype == src
        B.submit(req)
        B.run_until_drained()
        assert len(req.output) == 10
        runs.append((tuple(req.output),
                     B.metrics.counter("kv_imported_pages").value,
                     B.metrics.counter("kv_import_bytes").value))
    assert runs[1] == runs[0]


def test_midstream_resume_exact_token(sides):
    """Evacuation after j decoded tokens resumes at exactly output[-1]:
    the destination produces precisely the remaining tokens."""
    jside, tside, cfg = sides
    prompt = _prompt(cfg, seed=3)
    runs = []
    for side in (jside, tside):
        base, B = _base(side, prompt, 10)
        A = side.engine()
        req = side.Request(1, prompt.copy(), max_new_tokens=10)
        A.submit(req)
        _decode_until(A, 1, 4)
        A.evacuate(1)
        j = len(req.output)
        assert tuple(req.output) == base[:j]
        d0 = B.metrics.counter("decode_tokens").value
        B.submit(req)
        B.run_until_drained()
        assert tuple(req.output) == base
        assert B.metrics.counter("decode_tokens").value - d0 == len(base) - j
        runs.append((base, j))
    assert runs[1] == runs[0]


def test_migrate_into_speculative_engine(sides):
    """A snapshot admitted by a speculative engine rebuilds the draft's
    cache by prefilling the context (``_draft_install``) and decodes on
    through verify passes: the base run's tokens, as in the JAX engine."""
    jside, tside, cfg = sides
    prompt = _prompt(cfg, seed=4)
    runs = []
    for side in (jside, tside):
        base, _ = _base(side, prompt, 10)
        A = side.engine()
        B = side.engine(draft_config=side.model.cfg,
                        draft_params=side.params, spec_k=3)
        req = side.Request(1, prompt.copy(), max_new_tokens=10)
        A.submit(req)
        _decode_until(A, 1, 2)
        A.evacuate(1)
        B.submit(req)
        B.run_until_drained()
        assert tuple(req.output) == base
        assert B.stats()["spec_tokens_drafted"] > 0
        runs.append(tuple(req.output))
    assert runs[1] == runs[0]


# ------------------------------------------- snapshot / pool integrity


def test_snapshot_survives_source_eviction(sides):
    """An in-flight snapshot is a self-contained host copy: churning the
    source pool (eviction and page reuse) after export cannot corrupt it,
    and export itself leaks no refcounts."""
    _, side, cfg = sides
    prompt = _prompt(cfg, seed=5)
    base, B = _base(side, prompt, 8)
    # a small pool, so the churn below recycles the evacuated pages
    A = side.engine(num_pages=1 + 2 * ceil_blocks(64, 8))
    req = side.Request(1, prompt.copy(), max_new_tokens=8)
    A.submit(req)
    _decode_until(A, 1, 2)
    ref_before = list(A.pool.ref)
    snap = A.export_kv(1)
    assert list(A.pool.ref) == ref_before  # refs held then fully released
    before = {n: v.clone() for n, v in snap.leaves.items()}
    A.evacuate(1)
    for uid in range(2, 6):  # churn: unrelated prompts recycle the pages
        A.submit(side.Request(uid, _prompt(cfg, n=31, seed=100 + uid),
                              max_new_tokens=8))
    A.run_until_drained()
    assert A.pool.stats()["evictions"] > 0 or A.pool.pages_in_use() == 0
    for name, v in snap.leaves.items():
        assert torch.equal(v, before[name]), name
    B.submit(req)
    B.run_until_drained()
    assert tuple(req.output) == base


def test_prefix_reregistration_gives_receiver_hits(sides):
    """Importing a snapshot re-registers its prompt blocks in the
    receiving pool's trie: a later same-prompt request on the receiver
    reuses them, with the JAX engine's tokens and trie statistics."""
    jside, tside, cfg = sides
    prompt = _prompt(cfg, n=24, seed=7)  # 3 whole pages
    runs = []
    for side in (jside, tside):
        A, B = side.engine(), side.engine()
        req = side.Request(1, prompt.copy(), max_new_tokens=8)
        A.submit(req)
        _decode_until(A, 1, 1)
        A.evacuate(1)
        B.submit(req)
        B.run_until_drained()
        assert B.prefix_tokens_reused == 0  # cold import
        again = side.Request(2, prompt.copy(), max_new_tokens=8)
        B.submit(again)
        B.run_until_drained()
        assert tuple(again.output) == tuple(req.output)
        st = B.stats()
        assert st["prefix_tokens_reused"] > 0 and st["prefix_hits"] > 0
        runs.append((tuple(req.output), st["prefix_tokens_reused"],
                     st["prefix_hits"], st["pages_in_use"],
                     st["pages_cached"]))
    assert runs[1] == runs[0]


def test_import_validation(sides):
    """Page-size and geometry mismatches, a dense backend and requests not
    mid-decode are refused at submit, as by the JAX engine; export needs a
    decode-phase request; a snapshot's leaves must be CPU tensors of its
    storage form."""
    _, side, cfg = sides
    A = side.engine()
    req = side.Request(1, _prompt(cfg), max_new_tokens=8)
    A.submit(req)
    with pytest.raises(ValueError, match="not in decode phase"):
        A.export_kv(1)  # still queued
    _decode_until(A, 1, 1)
    _, snap = A.evacuate(1)
    with pytest.raises(ValueError, match="not in decode phase"):
        A.export_kv(1)  # evacuated
    with pytest.raises(ValueError, match="page_size"):
        side.engine(page_size=16).submit(req)
    with pytest.raises(ValueError, match="paged cache backend"):
        side.engine(paged=False).submit(req)
    deeper = build_model(reduced(get_config("qwen2-0.5b"),
                                 act_dtype="float32", n_layers=3))
    other = ServingEngine(deeper, deeper.init(0, param_dtype=torch.float32,
                                              device="cpu"),
                          max_batch=2, max_seq=64, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        other.submit(req)
    done = side.Request(2, _prompt(cfg), max_new_tokens=8, output=[1, 2])
    done.imported = snap
    done.done = True
    with pytest.raises(ValueError, match="mid-decode"):
        side.engine().submit(done)
    kw = dict(tokens=snap.tokens, n_prompt=snap.n_prompt, block_size=8,
              kv_dtype="bf16", geometry=snap.geometry,
              prefix_hashes=snap.prefix_hashes)
    with pytest.raises(ValueError, match="CPU tensors"):
        KVSnapshot(leaves={n: v.numpy() if v.dtype != torch.bfloat16
                           else v.float().numpy()
                           for n, v in snap.leaves.items()}, **kw)
    with pytest.raises(ValueError, match="CPU tensors"):
        KVSnapshot(leaves={n: v.to(torch.int8)
                           for n, v in snap.leaves.items()}, **kw)
    B = side.engine()
    B.submit(req)  # the evacuated request itself is still admissible
    B.run_until_drained()
    assert len(req.output) == 8


# ----------------------------------------- snapshot bits vs. the JAX engine


def _np_bits(a):
    """A leaf's bits as numpy: bf16 as int16, everything else as is."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _np_values(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _to_port(jsnap):
    """A JAX ``KVSnapshot`` in the port's host form (bits unchanged)."""
    leaves = {}
    for n, v in jsnap.leaves.items():
        v = np.asarray(v)
        leaves[n] = (torch.from_numpy(v.view(np.int16).copy())
                     .view(torch.bfloat16)
                     if v.dtype == ml_dtypes.bfloat16
                     else torch.from_numpy(v.copy()))
    return KVSnapshot(tokens=jsnap.tokens, n_prompt=jsnap.n_prompt,
                      block_size=jsnap.block_size, kv_dtype=jsnap.kv_dtype,
                      geometry=jsnap.geometry, leaves=leaves,
                      prefix_hashes=list(jsnap.prefix_hashes),
                      src_pages=list(jsnap.src_pages))


def _to_jax(snap):
    """A port ``KVSnapshot`` in the JAX package's host form."""
    leaves = {n: (_np_bits(v).view(ml_dtypes.bfloat16)
                  if v.dtype == torch.bfloat16 else v.numpy())
              for n, v in snap.leaves.items()}
    return JSnapshot(tokens=snap.tokens, n_prompt=snap.n_prompt,
                     block_size=snap.block_size, kv_dtype=snap.kv_dtype,
                     geometry=snap.geometry, leaves=leaves,
                     prefix_hashes=list(snap.prefix_hashes),
                     src_pages=list(snap.src_pages))


def _snapshot_at(side, prompt, kv_dtype, j):
    A = side.engine(kv_dtype=kv_dtype)
    req = side.Request(1, prompt.copy(), max_new_tokens=10)
    A.submit(req)
    _decode_until(A, 1, j)
    return A.evacuate(1)


def _resume(side, req, snap, kv_dtype):
    """Submit a copy of ``req`` carrying ``snap`` to a fresh engine of
    ``side``; returns its tokens and the engine."""
    new = side.Request(req.uid, np.asarray(req.tokens).copy(),
                       max_new_tokens=req.max_new_tokens,
                       output=list(req.output))
    new.imported = snap
    eng = side.engine(kv_dtype=kv_dtype)
    eng.submit(new)
    return new, eng


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_snapshot_bits_match_jax(sides, kv_dtype):
    """The port's snapshot at the JAX engine's step: the same tokens,
    prompt length, chain hashes, page ids, geometry, leaf names, shapes
    and dtypes exactly; its values within one rounding of the storage
    type of the JAX engine's (one bf16 ulp, one int8 step; the fp32 scales,
    each a row's absmax / 127, within 1e-5 relative: the rows' fp32 sums
    ran in another order and differ by up to ~10 fp32 ulps).  Across
    packages the bits travel unchanged: the JAX snapshot imported by the
    port and exported again after one decode step gives back the JAX bits
    of every position it covered, and each package resumes the other's
    snapshot at the JAX engine's tokens."""
    jside, tside, cfg = sides
    prompt = _prompt(cfg, seed=6)
    jreq, jsnap = _snapshot_at(jside, prompt, kv_dtype, 3)
    treq, tsnap = _snapshot_at(tside, prompt, kv_dtype, 3)
    assert list(jreq.output) == list(treq.output)
    np.testing.assert_array_equal(jsnap.tokens, tsnap.tokens)
    assert (jsnap.n_prompt, jsnap.block_size, jsnap.kv_dtype,
            jsnap.geometry, list(jsnap.prefix_hashes),
            list(jsnap.src_pages)) == \
        (tsnap.n_prompt, tsnap.block_size, tsnap.kv_dtype, tsnap.geometry,
         list(tsnap.prefix_hashes), list(tsnap.src_pages))
    assert sorted(jsnap.leaves) == sorted(tsnap.leaves)
    for n, jv in jsnap.leaves.items():
        tv = tsnap.leaves[n]
        assert tuple(np.shape(jv)) == tuple(tv.shape)
        a, b = _np_values(jv), _np_values(tv)
        if tv.dtype == torch.int8:  # one rounding step of the row
            assert np.abs(a - b).max() <= 1, n
        elif tv.dtype == torch.float32:  # scales: fp32 absmax / 127
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=0, err_msg=n)
        else:  # one bf16 ulp (2^-7 relative at most)
            assert (np.abs(a - b) <= 2 ** -7 * np.abs(a)).all(), n

    # the JAX snapshot through the port: bits of every covered position
    # come back unchanged; the tokens are the JAX engine's own resumption
    jbase, jeng = _resume(jside, jreq, jsnap, kv_dtype)
    jeng.run_until_drained()
    moved, eng = _resume(tside, jreq, _to_port(jsnap), kv_dtype)
    eng.step()  # admits the snapshot and decodes one token
    again = eng.export_kv(moved.uid)
    n_ctx = jsnap.num_tokens
    for n, jv in jsnap.leaves.items():
        L = jv.shape[0]
        want = _np_bits(jv).reshape(L, -1, *jv.shape[3:])[:, :n_ctx]
        got = _np_bits(again.leaves[n]).reshape(L, -1, *jv.shape[3:])
        np.testing.assert_array_equal(got[:, :n_ctx], want, err_msg=n)
    eng.run_until_drained()
    assert moved.output == jbase.output
    # ... and the port's snapshot through the JAX engine
    jmoved, jeng2 = _resume(jside, treq, _to_jax(tsnap), kv_dtype)
    jeng2.run_until_drained()
    assert jmoved.output == jbase.output


# -------------------------------------------- admission batching knobs


def _timeline(side, cfg, knobs, arrivals, new, dt=0.1, max_ticks=400):
    """Drive an engine with a virtual clock advanced ``dt`` a tick;
    requests arrive at the given virtual times.  Returns, per request,
    its group, admission time and token times, per tick the decode slots'
    uids, and the sizes of the admission groups."""
    vt = [0.0]
    eng = side.engine(clock=lambda: vt[0], **knobs)
    reqs = []
    ticks = []
    pending = sorted(enumerate(arrivals), key=lambda p: p[1])
    for _ in range(max_ticks):
        while pending and pending[0][1] <= vt[0] + 1e-12:
            i, _ = pending.pop(0)
            reqs.append(eng.submit(side.CReq(
                tokens=_prompt(cfg, n=9 + 5 * i, seed=20 + i),
                max_new_tokens=new[i])))
        groups = [r.group for r in reqs]
        eng.step()
        ticks.append((round(vt[0], 9), groups,
                      [None if s is None else s.uid
                       for s in eng.slots], eng._admission_held))
        vt[0] += dt
        if not pending and not eng.busy():
            break
    assert all(r.done for r in reqs)
    return ([(r.uid, r.t_admit, r.token_times, list(r.output))
             for r in reqs], ticks,
            eng.metrics.histogram("batch_admit_size").values)


@pytest.mark.parametrize("knobs,arrivals,new,held", [
    # test_streaming.py:161: a lone request held until it has waited out
    # batching_wait_secs, then a late pair filling the bucket at once
    (dict(sorted_batch_sizes=[2], batching_wait_secs=0.5),
     [0.0, 1.2, 1.2], [4, 3, 5], True),
    # test_streaming.py:182: a full bucket admitted at once
    (dict(sorted_batch_sizes=[2], batching_wait_secs=1e9),
     [0.0, 0.0], [4, 4], False),
    # test_streaming.py:200: max_live_batches=1 holds a second group until
    # the first finishes, free slots or not
    (dict(max_batch=4, sorted_batch_sizes=[1], max_live_batches=1),
     [0.0, 0.0], [6, 2], True),
    # a mix: two bucket sizes, a wait, two live groups, monolithic prefill
    (dict(max_batch=3, sorted_batch_sizes=[1, 3], batching_wait_secs=0.3,
          max_live_batches=2, prefill_chunk=0),
     [0.0, 0.05, 0.1, 0.1, 0.6, 0.65, 1.4], [5, 3, 6, 2, 4, 3, 2], True),
    (dict(max_batch=3, sorted_batch_sizes=[2, 3], batching_wait_secs=0.2,
          max_live_batches=2, prefill_chunk=8, prefill_budget=8),
     [0.0, 0.05, 0.1, 0.1, 0.6, 0.65, 1.4], [5, 3, 6, 2, 4, 3, 2], True),
])
def test_admission_batching_matches_jax(sides, knobs, arrivals, new, held):
    """The saxml-style batching knobs on a virtual clock: the port admits
    the same groups, at the same virtual times, into the same slots as the
    JAX engine, with the same tokens and group sizes."""
    jside, tside, cfg = sides
    want = _timeline(jside, cfg, knobs, arrivals, new)
    got = _timeline(tside, cfg, knobs, arrivals, new)
    assert got == want
    reqs, ticks, sizes = got
    assert [len(r[3]) for r in reqs] == new
    assert sum(sizes) == len(arrivals)
    bucket = max(knobs["sorted_batch_sizes"])
    assert max(sizes) <= bucket
    # whether the knobs (a partial group's wait, the live-group cap) ever
    # held the queue back
    assert any(h for *_, h in ticks) == held


def test_batching_knobs_refused(sides):
    """Bad batching knobs are refused at construction, as by the JAX
    engine."""
    _, side, _ = sides
    with pytest.raises(ValueError, match="sizes >= 1"):
        side.engine(sorted_batch_sizes=[0, 1])
    with pytest.raises(ValueError, match="exceeds max_batch"):
        side.engine(sorted_batch_sizes=[1, 4])


def test_held_virtual_clock_drain_raises(sides):
    """A virtual-clock engine whose queue the wait knob holds cannot drain
    on its own: ``run_until_drained`` spins a bounded number of ticks and
    says why, as the JAX engine does."""
    _, side, cfg = sides
    eng = side.engine(clock=lambda: 0.0, sorted_batch_sizes=[2],
                      batching_wait_secs=1.0)
    eng.submit(side.Request(1, _prompt(cfg), max_new_tokens=2))
    with pytest.raises(RuntimeError, match="batching knobs"):
        eng.run_until_drained(max_ticks=10)
