"""The port's continuum harness (``serving/cluster.py``: ``Cluster``,
``EngineHandle``, ``SimEngine``, ``EngineBackend``, ``build_continuum``):
the cluster cases of test_cluster.py, test_disagg.py and test_streaming.py
run against the port's live engines on the CPU, and fig10's replay held to
the JAX package's.

The fig10 case replays the same MIOBench trace under all-cloud, greedy and
fig10's QLMIO rule through both packages.  There is no EOS and the virtual
clock charges profiled tick costs, so every decision and every per-request
virtual-clock record (server, TTFT, e2e, timeout, success, tokens) is
independent of the weights and must agree exactly; each package serves
with its own seeded weights.  The copy of fig10's QLMIO rule that
``chip_smoke.py`` carries must take fig10's decisions."""
import dataclasses
import importlib.util
import math
import pathlib
import warnings

import numpy as np
import pytest
import torch

try:
    import jax

    from repro.core import baselines as jbaselines
    from repro.serving import cluster as jcluster
    from repro.sim import cemllm as jce
    from repro.sim import miobench as jmb
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.core.baselines import all_cloud_policy, greedy_policy
from repro_torch.models.api import build_model
from repro_torch.serving import cluster as cluster_mod
from repro_torch.serving import (Cluster, EngineBackend, QLMIORouter,
                                 ServerHandle, SimEngine, StreamEvent,
                                 build_continuum)
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kv_cache import ceil_blocks
from repro_torch.serving.request import ContinuumRequest
from repro_torch.serving.telemetry import Telemetry
from repro_torch.sim import cost_model as cm
from repro_torch.sim.cemllm import Episode, make_servers_from_spec, run_policy
from repro_torch.sim.miobench import generate

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = [(2, 1), (1, 1)]  # 1 cloud (llama3.2-3b) + 1 gpu edge (qwen2)
FIG10_SPEC = [(2, 1), (1, 1), (0, 1)]  # fig10's continuum


@pytest.fixture(scope="module")
def world():
    bench = generate(seed=0, n_tasks=60)
    servers = make_servers_from_spec(SPEC, bench)
    handles = build_continuum(SPEC, seed=0, max_batch=2, max_seq=96,
                              torch_device="cpu")
    return bench, servers, Cluster(handles)


def _greedy(ep):
    return int(np.argmin(ep.queue_s))


def _drained(cluster):
    cluster.drain()
    cluster.reset()
    return cluster


def _prompt(cfg, n=23, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, n).astype(
        np.int64)


# ------------------------------------------------ test_cluster.py cases


def test_handles_run_where_asked(world):
    """The handles of ``build_continuum`` are the JAX package's: reduced
    llama3.2-3b on a bf16 pool for the cloud, reduced qwen2-0.5b on an
    int8 pool for the edge, bf16 weights of the port's seeded init on the
    device asked for."""
    _, _, cluster = world
    cloud, edge = cluster.handles
    assert (cloud.cfg, edge.cfg) == (reduced(get_config("llama3.2-3b")),
                                     reduced(get_config("qwen2-0.5b")))
    assert (cloud.kv_dtype, edge.kv_dtype) == ("bf16", "int8")
    for h in cluster.handles:
        table = h.engine.params["embed"]["table"]
        assert table.device.type == "cpu" and table.dtype == torch.bfloat16
        assert h.engine.device.type == "cpu"


def test_backend_parity_decisions(world):
    """A deterministic policy takes identical decisions under the
    cost-model backend and the engine backend, while the engine backend's
    finalized records hold measured latencies from real tokens."""
    bench, servers, cluster = world
    _drained(cluster)
    tasks = np.arange(12)
    ep1 = Episode(bench, servers, tasks, np.random.default_rng(0))
    recs1 = [ep1.step(_greedy(ep1)) for _ in range(len(tasks))]
    ep1.finalize()

    be = EngineBackend(cluster, bench, servers, arrival_dt=0.02)
    ep2 = Episode(bench, servers, tasks, np.random.default_rng(0),
                  backend=be)
    recs2 = [ep2.step(_greedy(ep2)) for _ in range(len(tasks))]
    assert all(r["pending"] for r in recs2)  # unresolved until finalize
    ep2.finalize()

    assert [r["server"] for r in recs1] == [r["server"] for r in recs2]
    np.testing.assert_allclose(ep1.queue_s, ep2.queue_s)
    assert not any(r["pending"] for r in recs2)
    for r in recs2:
        assert r["latency_total"] > 0 and "ttft_s" in r
        assert r["ttft_s"] <= r["latency_total"] + 1e-9
    n_tok = sum(len(req.output) for h in cluster.handles
                for req in h.engine.finished)
    assert n_tok >= 2 * len(tasks)


def test_router_sees_real_queue_depth(world):
    """Queued work on one engine shows in its ``load`` probe and
    penalizes it in the router's ``_effective_latency``."""
    bench, servers, cluster = world
    _drained(cluster)
    h = cluster.handles[0]
    for i in range(4):
        cluster.submit(ContinuumRequest(
            tokens=np.arange(1, 9) % h.cfg.vocab, max_new_tokens=4,
            task=i, server=0))
    ld = h.load()
    assert ld["queue_depth"] == 4
    assert ld["inflight_prefill_tokens"] == 4 * 8
    assert ld["backlog_s"] > 0
    router = QLMIORouter(list(cluster.handles), lambda t, s: 1.0,
                         lambda t, s: 0.9)
    assert router.observed_load()[0] == pytest.approx(ld["backlog_s"])
    t_eff = router._effective_latency(0)
    assert t_eff[0] > t_eff[1]
    assert router.route(0) == 1
    _drained(cluster)


def test_replay_determinism(world):
    """Same trace, same policy => identical measured records across
    replays (virtual clock, no wall time anywhere)."""
    bench, servers, cluster = world
    tasks = np.arange(20, 32)
    outs = []
    for _ in range(2):
        _drained(cluster)
        be = EngineBackend(cluster, bench, servers, arrival_dt=0.01)
        res = run_policy(_greedy, bench, servers, tasks,
                         np.random.default_rng(1), backend=be)
        outs.append((res, cluster.collect()))
    assert outs[0] == outs[1]


def test_qlmio_beats_all_cloud_on_engines(world):
    """Spreading by predicted latency + queue beats sending everything to
    the single saturated cloud engine."""
    bench, servers, cluster = world
    tasks = np.arange(40, 56)

    def run(policy):
        _drained(cluster)
        be = EngineBackend(cluster, bench, servers, arrival_dt=0.005)
        return run_policy(policy, bench, servers, tasks,
                          np.random.default_rng(1), backend=be)

    cloud = int(np.argmax(servers.is_cloud))
    assert (run(_greedy)["avg_latency_s"]
            < run(lambda ep: cloud)["avg_latency_s"])


def test_failed_server_times_out_and_cluster_stays_reusable(world):
    bench, servers, cluster = world
    _drained(cluster)
    h = cluster.handles[1]
    h.fail = True
    try:
        cluster.submit(ContinuumRequest(
            tokens=np.arange(1, 9) % h.cfg.vocab, max_new_tokens=4,
            task=0, server=1))
        cluster.drain()
        rec, = cluster.collect()
        assert rec["timeout"] and not rec["success"]
        cluster.reset()
    finally:
        h.fail = False


def test_engine_virtual_clock_and_relative_drain_deadline():
    cfg = reduced(get_config("qwen2-0.5b"))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    clock = {"t": 0.0}
    eng = ServingEngine(model, params, max_batch=2, max_seq=64,
                        clock=lambda: clock["t"], device="cpu")
    rng = np.random.default_rng(0)
    req = Request(0, rng.integers(0, cfg.vocab, 8).astype(np.int32),
                  max_new_tokens=4)
    eng.submit(req)
    while not req.done:
        eng.step()
        clock["t"] += 0.5
    stats = eng.latency_stats()
    assert stats["e2e_p50_s"] == pytest.approx(req.e2e_s())
    assert req.e2e_s() >= 1.0
    assert req.itl_s()[-1] == pytest.approx(0.5)
    assert sum(req.itl_s()) == pytest.approx(req.e2e_s())
    for i in range(2):
        r = Request(1 + i, rng.integers(0, cfg.vocab, 8).astype(np.int32),
                    max_new_tokens=16)
        eng.submit(r)
        while not r.done:
            eng.step()
            clock["t"] += 0.5
    assert eng.ticks > 12
    eng.finished.clear()
    late = Request(9, rng.integers(0, cfg.vocab, 8).astype(np.int32),
                   max_new_tokens=4)
    eng.submit(late)
    assert [r.uid for r in eng.run_until_drained(max_ticks=12)] == [9]


def test_unported_handle_knobs_raise():
    """A live handle over a tensor-parallel mesh is not ported and says
    which ROADMAP item brings it; the sim backend prices ``tp`` as the
    JAX package does."""
    with pytest.raises(NotImplementedError, match="item 12"):
        build_continuum([(2, 1)], tp=2, torch_device="cpu")
    sim = build_continuum([(2, 1)], tp=2, backend="sim")[0]
    assert sim.tp == 2 and sim.decode_tick_s > 0


# ------------------------------------------- test_disagg.py cluster cases


@pytest.fixture(scope="module")
def twin_cluster():
    """Two cloud-class handles sharing arch and weights (KV-compatible),
    with tracing on."""
    tm = Telemetry(trace=True)
    handles = build_continuum([(2, 2)], arch="qwen2-0.5b", param_seed=0,
                              telemetry=tm, max_seq=64, page_size=8,
                              torch_device="cpu")
    return Cluster(handles, timeout_s=60.0), tm


def test_twin_handles_share_weights(twin_cluster):
    cl, _ = twin_cluster
    a, b = (h.engine.params["embed"]["table"] for h in cl.handles)
    assert torch.equal(a, b)
    assert cl.handles[0].kv_compatible(cl.handles[1])


def test_cluster_charged_migration(twin_cluster):
    """A planned prefill-on-0/decode-on-1 dispatch gives the pure run's
    tokens, moves the record to the decode server, emits a kv_migrate span
    with real bytes and pays the link time on the virtual clock."""
    cl, tm = twin_cluster
    cl.reset()
    h0, h1 = cl.handles
    prompt = _prompt(h0.cfg, seed=11)
    uid = cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=10,
                                     task=0, server=0))
    cl.drain()
    pure = cl.collect()[0]
    base = tuple(cl.records[uid]["req"].output)

    cl.reset()
    uid = cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=10,
                                     task=0, server=0, decode_server=1))
    cl.drain()
    rec = cl.collect()[0]
    req = cl.records[uid]["req"]
    assert tuple(req.output) == base
    assert cl.records[uid]["server"] == 1
    assert not rec["timeout"]
    assert h1.engine.stats()["prefill_tokens_computed"] == 0
    spans = [e for e in tm.tracer.events if e.get("name") == "kv_migrate"]
    assert spans
    s = spans[-1]
    assert s["args"]["bytes"] > 0 and s["args"]["pages"] > 0
    assert s["args"]["src"] == h0.name and s["args"]["dst"] == h1.name
    assert s["args"]["bytes"] == s["args"]["pages"] * h1.engine.page_bytes()
    assert (h0.engine.metrics.counter("kv_migrate_out_bytes").value
            == h1.engine.metrics.counter("kv_migrate_in_bytes").value
            == s["args"]["bytes"])
    assert rec["e2e_s"] > pure["e2e_s"]


def test_cluster_rebalance_threshold(twin_cluster):
    cl, _ = twin_cluster
    cl.reset()
    h0 = cl.handles[0]
    prompt = _prompt(h0.cfg, seed=13)
    for k in range(6):
        cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=10,
                                   task=k, server=0))
    cl.advance_to(h0.uplink_s() + 6 * h0.decode_tick_s)
    assert h0._load()["backlog_s"] > 0
    assert cl.rebalance(threshold_s=1e9) == []
    moves = cl.rebalance(threshold_s=1e-6)
    assert len(moves) == 1
    assert moves[0]["src"] == 0 and moves[0]["dst"] == 1
    assert moves[0]["bytes"] > 0
    cl.drain()
    recs = cl.collect()
    assert all(not r["timeout"] for r in recs)
    moved = next(r for r in recs if r["uid"] == moves[0]["uid"])
    assert moved["server"] == 1 and moved["n_tokens"] == 10


def test_predict_disagg_terms(twin_cluster):
    cl, _ = twin_cluster
    cl.reset()
    total, terms = cl.predict_disagg_e2e_s(0, 1, 23, 10)
    assert set(terms) == {"queue", "prefill", "migrate", "queue_decode",
                          "decode", "media", "link"}
    assert total == pytest.approx(sum(terms.values()))
    hd = cl.handles[1]
    pages = ceil_blocks(24, hd.engine.page_size)
    want = cm.migrate_link_s(pages * hd.engine.page_bytes(),
                             cl.handles[0].device, hd.device)
    assert terms["migrate"] == pytest.approx(float(want))


def test_router_plan_prefers_cheap_disagg_pair():
    servers = [ServerHandle(name=f"s{i}", model_id=0, device_id=0,
                            is_cloud=False, execute=lambda t: (10.0, True))
               for i in range(2)]
    r = QLMIORouter(servers, milp_pred=lambda t, s: 10.0,
                    mgqp_pred=lambda t, s: 0.9,
                    migrate_pred=lambda t, sp, sd: 2.0)
    p = r.plan(0)
    assert p["prefill_server"] is not None
    assert p["server"] != p["prefill_server"]


# ---------------------------------------- test_streaming.py cluster cases


def _check_stream_shape(events, uid, n_tokens):
    evs = [e for e in events if e.uid == uid]
    assert [e.index for e in evs] == list(range(n_tokens))
    assert [e.first for e in evs] == [True] + [False] * (n_tokens - 1)
    assert [e.final for e in evs] == [False] * (n_tokens - 1) + [True]
    ts = [e.t_emit for e in evs]
    assert all(a <= b + 1e-12 for a, b in zip(ts, ts[1:]))
    return evs


def _drain_run(cl, prompt, **kw):
    cl.reset()
    uid = cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=8,
                                     task=0, server=0, **kw))
    cl.drain()
    rec = cl.collect()[0]
    return uid, tuple(cl.records[uid]["req"].output), rec


def test_cluster_stream_iterator_matches_drain(twin_cluster):
    cl, _ = twin_cluster
    prompt = _prompt(cl.handles[0].cfg, seed=7)
    _, base, rec0 = _drain_run(cl, prompt)
    cl.reset()
    uid = cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=8,
                                     task=0, server=0, stream=True))
    events = list(cl.stream(until=60.0))
    rec = [r for r in cl.collect() if r["uid"] == uid][0]
    evs = _check_stream_shape(events, uid, len(base))
    assert tuple(e.token for e in evs) == base
    h = cl.handles[0]
    for e in evs:
        assert e.t_user == pytest.approx(e.t_emit + h.stream_chunk_s)
    assert rec["streamed"] and not rec0.get("streamed")
    assert h.stream_chunk_s < h.downlink_s()
    assert rec["e2e_s"] == pytest.approx(
        rec0["e2e_s"] - h.downlink_s() + h.stream_chunk_s)
    assert rec["ttft_s"] == pytest.approx(
        rec0["ttft_s"] - h.downlink_s() + h.stream_chunk_s)
    assert rec["ttft_s"] < rec0["ttft_s"]


def test_cluster_stream_callback_inline(twin_cluster):
    cl, _ = twin_cluster
    prompt = _prompt(cl.handles[0].cfg, seed=8)
    events = []
    cl.reset()
    uid = cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=6,
                                     task=0, server=0,
                                     stream=events.append))
    assert list(cl.stream(until=60.0)) == []
    evs = _check_stream_shape(events, uid, 6)
    assert all(isinstance(e, StreamEvent) and e.t_user is not None
               for e in evs)


def test_midstream_migration_streams_contiguously(twin_cluster):
    cl, _ = twin_cluster
    prompt = _prompt(cl.handles[0].cfg, seed=9)
    _, base, _ = _drain_run(cl, prompt)
    events = []
    cl.reset()
    uid = cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=8,
                                     task=0, server=0, decode_server=1,
                                     stream=events.append))
    cl.drain()
    rec = [r for r in cl.collect() if r["uid"] == uid][0]
    assert cl.records[uid]["server"] == 1
    assert not rec["timeout"]
    evs = _check_stream_shape(events, uid, len(base))
    assert tuple(e.token for e in evs) == base
    h1 = cl.handles[1]
    assert evs[-1].t_user == pytest.approx(
        evs[-1].t_emit + h1.stream_chunk_s)


def test_continuum_request_frozen_roundtrip():
    creq = ContinuumRequest(tokens=np.arange(4), max_new_tokens=5, task=3)
    with pytest.raises(dataclasses.FrozenInstanceError):
        creq.server = 1
    planned = creq.with_plan(server=2, decode_server=None,
                             predicted_s=0.25, utility=1.5)
    assert planned is not creq and creq.server is None
    assert (planned.server, planned.predicted_s, planned.utility) \
        == (2, 0.25, 1.5)


def test_legacy_submit_kwargs_warn_and_plan_required(twin_cluster):
    cl, _ = twin_cluster
    prompt = _prompt(cl.handles[0].cfg, seed=12)
    cl.reset()
    with pytest.warns(DeprecationWarning, match="ContinuumRequest"):
        cl.submit(0, task=0, tokens=prompt, max_new_tokens=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=2,
                                   task=0, server=0))
    with pytest.raises(ValueError, match="server is unset"):
        cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=2))
    cl.drain()
    assert len(cl.collect()) == 2


def test_router_plan_annotates_request(twin_cluster):
    cl, _ = twin_cluster
    router = QLMIORouter(list(cl.handles), lambda t, s: 1.0,
                         lambda t, s: 0.9)
    creq = ContinuumRequest(tokens=np.arange(1, 9), max_new_tokens=4,
                            task=0)
    planned = router.plan(creq)
    assert isinstance(planned, ContinuumRequest)
    assert creq.server is None and creq.predicted_s is None
    assert planned.server in (0, 1)
    assert math.isfinite(planned.predicted_s)
    cl.reset()
    uid = cl.submit(planned)
    cl.drain()
    rec = [r for r in cl.collect() if r["uid"] == uid][0]
    assert rec["server"] == planned.server
    assert rec["predicted_s"] == pytest.approx(planned.predicted_s)


def _replay_probe(cl, n=40):
    rng = np.random.default_rng(5)
    for k in range(n):
        cl.submit(ContinuumRequest(
            tokens=rng.integers(1, 100, 12).astype(np.int32),
            max_new_tokens=4, arrival_s=0.05 * k, task=k,
            server=int(k % 2)))
    cl.drain()
    recs = cl.collect()
    assert len(recs) == n and not any(r["timeout"] for r in recs)
    return recs, cl.handle_steps, cl.heap_pops


def test_oactive_steps_independent_of_fleet_size():
    """The event heap charges work only for engines with events: the same
    trace over the same two engines costs the same handle steps on a
    4-engine and a 64-engine fleet, with identical records."""
    def fleet(n_edge):
        return Cluster(build_continuum([(0, n_edge), (2, 2)], backend="sim",
                                       max_batch=2, max_seq=64))
    small, s_steps, s_pops = _replay_probe(fleet(2))
    large, l_steps, l_pops = _replay_probe(fleet(62))
    assert s_steps == l_steps > 0
    key = ["uid", "server", "e2e_s", "ttft_s", "n_tokens"]
    assert ([{k: r[k] for k in key} for r in small]
            == [{k: r[k] for k in key} for r in large])
    assert l_pops <= s_pops + 2 * 64


def test_sim_engine_matches_metric_names():
    eng = SimEngine(vocab=100, max_batch=2, max_seq=32)
    eng.submit(ContinuumRequest(tokens=np.arange(1, 10), max_new_tokens=4))
    eng.run_until_drained()
    st = eng.stats()
    assert st["sim"] is True
    for k in ("requests_submitted", "requests_finished", "decode_tokens",
              "prefill_tokens_computed", "prefix_tokens_reused"):
        assert k in st, k
    assert eng.latency_stats()["n_requests"] == 1


# ---------------------------------------------------- fig10 vs. the JAX


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fig10():
    """fig10's benchmark module (the JAX package's QLMIO rule and
    predictors) and ``chip_smoke.py`` (the port's copy of them)."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    return (_load("fig10_continuum_replay",
                  ROOT / "benchmarks" / "fig10_continuum_replay.py"),
            _load("chip_smoke", ROOT / "chip_smoke.py"))


def _replays(pkg, build, bench, servers, tasks, policies):
    """fig10's replay loop (benchmarks/fig10_continuum_replay.py:128-141)
    over one package's fleet: per policy, run_policy's aggregates, the
    per-server request counts, the tokens generated and every request's
    collected record."""
    handles = build()
    cluster = pkg.Cluster(handles)
    out = {}
    for name, policy in policies:
        cluster.reset()
        backend = pkg.EngineBackend(cluster, bench, servers,
                                    arrival_dt=0.01)
        res = pkg.run_policy(policy, bench, servers, tasks,
                             np.random.default_rng(1), backend=backend)
        recs = cluster.collect()
        out[name] = (res,
                     [h.engine.latency_stats()["n_requests"]
                      for h in handles],
                     [len(r.output) for h in handles
                      for r in h.engine.finished],
                     recs)
    return out


class _Pkg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("n_users", [12, 24])
def test_fig10_replay_matches_jax(fig10, n_users):
    """fig10's smoke trace (``generate(0, 200)``, users drawn with
    ``default_rng(0)``, ``arrival_dt=0.01``) cut to ``n_users``, replayed
    under all-cloud, greedy and fig10's QLMIO rule at weight 1.0: the port
    and the JAX package take the same decisions and give the same
    per-server counts, tokens and per-request virtual-clock records
    (exactly)."""
    bench_mod, _ = fig10
    jbench = jmb.generate(seed=0, n_tasks=200)
    bench = generate(seed=0, n_tasks=200)
    jservers = jce.make_servers_from_spec(FIG10_SPEC, jbench)
    servers = make_servers_from_spec(FIG10_SPEC, bench)
    tasks = np.random.default_rng(0).choice(200, n_users, replace=False)
    jt, jb = bench_mod.analytic_predictors(jbench)
    want = _replays(
        _Pkg(Cluster=jcluster.Cluster, EngineBackend=jcluster.EngineBackend,
             run_policy=jce.run_policy),
        lambda: jcluster.build_continuum(FIG10_SPEC, seed=0), jbench,
        jservers, tasks,
        [("all_cloud", jbaselines.all_cloud_policy(jservers)),
         ("greedy", jbaselines.greedy_policy()),
         ("qlmio", bench_mod.qlmio_policy(jt, jb, jservers, 1.0))])
    _, smoke = fig10
    t_hat, b_hat = smoke.analytic_predictors(bench)
    got = _replays(
        _Pkg(Cluster=Cluster, EngineBackend=EngineBackend,
             run_policy=run_policy),
        lambda: build_continuum(FIG10_SPEC, seed=0, torch_device="cpu"),
        bench, servers, tasks,
        [("all_cloud", all_cloud_policy(servers)),
         ("greedy", greedy_policy()),
         ("qlmio", smoke.qlmio_policy(t_hat, b_hat, servers, 1.0))])
    assert got == want
    # the replays did real work: every request finished on a live engine
    for res, counts, ntok, recs in got.values():
        assert sum(counts) == n_users == len(recs)
        assert all(r["n_tokens"] >= 2 for r in recs)
    assert (got["qlmio"][0]["avg_latency_s"]
            < got["all_cloud"][0]["avg_latency_s"])


def test_chip_smoke_qlmio_rule_is_fig10s(fig10):
    """``chip_smoke.py``'s numpy copy of fig10's predictors and QLMIO rule
    gives fig10's arrays and decisions on the full smoke trace, at every
    quality weight of fig10's sweeps."""
    bench_mod, smoke = fig10
    jbench = jmb.generate(seed=0, n_tasks=200)
    bench = generate(seed=0, n_tasks=200)
    want = bench_mod.analytic_predictors(jbench)
    got = smoke.analytic_predictors(bench)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    servers = make_servers_from_spec(FIG10_SPEC, bench)
    tasks = np.random.default_rng(0).choice(200, 32, replace=False)
    for w in (0.0, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0):
        decisions = []
        for mod, preds in ((bench_mod, want), (smoke, got)):
            policy = mod.qlmio_policy(*preds, servers, w)
            ep = Episode(bench, servers, tasks, np.random.default_rng(1))
            picks = []
            while not ep.done:
                picks.append(policy(ep))
                ep.step(picks[-1])
            decisions.append(picks)
        assert decisions[0] == decisions[1]
        assert len(set(decisions[1])) > 1 or w == 0.0  # the rule spreads


# ------------------------------------------- speculative handles (fig14)


def _spec_fleet(mod, cmod, **kw):
    """fig14's fleet shape (benchmarks/fig14_speculative.py:72): an edge
    tier, a plain cloud handle, colocated speculation and edge-drafts/
    cloud-verifies, over one arch."""
    edge, cloud = cmod.DEVICES["jetson_orin_nano"], cmod.DEVICES["rtx3090ti"]
    draft, prof = cmod.MODELS["qwen3vl-2b"], cmod.MODELS["qwen3vl-8b"]
    return [
        mod.EngineHandle("edge", "qwen2-0.5b", edge, draft, seed=0, **kw),
        mod.EngineHandle("cloud-plain", "qwen2-0.5b", cloud, prof,
                         is_cloud=True, seed=0, **kw),
        mod.EngineHandle("cloud-spec", "qwen2-0.5b", cloud, prof,
                         is_cloud=True, draft_profile=draft, spec_k=3,
                         seed=0, **kw),
        mod.EngineHandle("cloud-spec-edgedraft", "qwen2-0.5b", cloud, prof,
                         is_cloud=True, draft_profile=draft,
                         draft_device=edge, spec_k=3, seed=0, **kw)]


def _prices(cluster):
    """Every handle's tick and link costs and the cluster's predictions
    for the pure, disaggregated and speculative shapes, before traffic."""
    hs = cluster.handles
    out = [(h.kv_dtype, h.decode_tick_s, h.prefill_tok_s, h.spec_tick_s,
            h.up_s, h.down_s, h.stream_chunk_s, h.itl_s(),
            h.predict_e2e_s(23, 8)) for h in hs]
    out.append([cluster.predict_spec_e2e_s(a, v, 23, 8)
                for a in range(len(hs)) for v in range(len(hs))])
    out.append(cluster.predict_disagg_e2e_s(0, 1, 23, 8))
    return out


def test_speculative_handles_match_jax():
    """Speculative handles (``draft_profile``) and their pricing, the
    cluster's fourth dispatch shape: tick costs and the pure,
    disaggregated and speculative predictions equal the JAX package's
    exactly (cost-model numbers); on the port, a request drafted on its
    verify handle or priced on the edge gives plain decode's tokens (fp32
    weights), and the measured acceptance feeds the handle's ITL."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    from repro.sim import cost_model as jcm
    want = _prices(jcluster.Cluster(_spec_fleet(jcluster, jcm)))
    cfg = reduced(get_config("qwen2-0.5b"), act_dtype="float32")
    params = build_model(cfg).init(0, param_dtype=torch.float32,
                                   device="cpu")
    cl = Cluster(_spec_fleet(cluster_mod, cm, config=cfg, params=params,
                             torch_device="cpu"))
    assert _prices(cl) == want
    prompt = _prompt(cfg, seed=14)
    outs = {}
    for server, draft in ((1, None), (2, 2), (3, 0)):
        uid = cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=8,
                                         task=0, server=server,
                                         draft_server=draft))
        cl.drain()
        outs[server] = tuple(cl.records[uid]["req"].output)
    assert outs[2] == outs[3] == outs[1] and len(outs[1]) == 8
    spec = cl.handles[2]
    assert spec.engine.stats()["spec_tokens_accepted"] > 0
    assert spec.itl_s() != want[2][7]  # the live acceptance, not 0.6
    with pytest.raises(ValueError, match="not speculative"):
        cl.submit(ContinuumRequest(tokens=prompt, max_new_tokens=2, task=0,
                                   server=1, draft_server=0))
