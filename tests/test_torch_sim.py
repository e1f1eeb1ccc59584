"""The port's numpy copies of the offloading simulator (``sim/cost_model``,
``sim/miobench``, ``sim/cemllm``), the router (``serving/router``) and the
heuristic baselines (``core/baselines``) held to the JAX package's modules
on the same inputs.  All of them are numpy code run on the same numbers,
so every comparison is exact: equal arrays, equal records, equal routing
decisions (no tolerance)."""
import dataclasses

import numpy as np
import pytest

from repro.serving import router as jrouter
from repro.sim import cemllm as jce
from repro.sim import cost_model as jcm
from repro.sim import miobench as jmb
from repro_torch.core import baselines
from repro_torch.serving import router
from repro_torch.sim import cemllm as ce
from repro_torch.sim import cost_model as cm
from repro_torch.sim import miobench as mb

try:  # the JAX package's baselines module imports JAX
    from repro.core import baselines as jbaselines
except ImportError:
    jbaselines = None

SPEC = [(2, 1), (1, 1), (0, 1)]  # fig10's continuum


def _bench_pair(seed, n_tasks, prefill_chunk=None):
    return (jmb.generate(seed, n_tasks, prefill_chunk=prefill_chunk),
            mb.generate(seed, n_tasks, prefill_chunk=prefill_chunk))


def _assert_same(a, b):
    """Exact equality of nested numpy/scalar/dict/list structures."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed,n_tasks,chunk", [(0, 200, None),
                                                (3, 150, 64), (0, 3377, None)])
def test_generate_matches(seed, n_tasks, chunk):
    """``generate`` gives the JAX package's tasks, latencies, scores and
    server ids exactly (the two taskgen copies differ only in a
    docstring)."""
    jb, b = _bench_pair(seed, n_tasks, chunk)
    for f in dataclasses.fields(jb.tasks):
        _assert_same(getattr(jb.tasks, f.name), getattr(b.tasks, f.name))
    for name in ("latency_s", "score", "model_id", "device_id"):
        _assert_same(getattr(jb, name), getattr(b, name))
    assert jmb.summary(jb) == mb.summary(b)
    assert list(jb.records())[:9] == list(b.records())[:9]


def test_cost_model_matches():
    """The roofline and response model on every (device, model) pair and
    knob: latency_s / latency_terms (chunked prefill, prefix hits, split
    prefill device, TP), success_prob, decode/prefill/speculative ticks,
    KV migration, payloads and the media split point."""
    jb, b = _bench_pair(0, 120)
    tl, diff = b.tasks.text_len, b.tasks.difficulty
    aff = cm.category_affinity(12, 3)
    _assert_same(jcm.category_affinity(12, 3), aff)
    for dname in cm.DEVICE_IDS:
        jdev, dev = jcm.DEVICES[dname], cm.DEVICES[dname]
        for mname in cm.MODEL_IDS:
            jm, m = jcm.MODELS[mname], cm.MODELS[mname]
            for kw in ({}, dict(prefill_chunk=64),
                       dict(prefix_hit_rate=0.5),
                       dict(prefill_device=cm.DEVICES["rtx5090"],
                            migrate_kv_dtype="int8")):
                jkw, toks = dict(kw), tl
                if "prefill_device" in kw:  # one prompt length at a time
                    jkw["prefill_device"] = jcm.DEVICES["rtx5090"]
                    toks = 512
                _assert_same(jcm.latency_s(jdev, jm, toks, diff, **jkw),
                             cm.latency_s(dev, m, toks, diff, **kw))
                _assert_same(jcm.latency_terms(jdev, jm, 512, 0.5, **jkw),
                             cm.latency_terms(dev, m, 512, 0.5, **kw))
            _assert_same(jcm.success_prob(jm, diff, 0.3),
                         cm.success_prob(m, diff, 0.3))
            for tp in (1, 4):
                _assert_same(jcm.decode_s(jdev, jm, 10.0, context_tokens=48,
                                          kv_dtype="int8", tp=tp),
                             cm.decode_s(dev, m, 10.0, context_tokens=48,
                                         kv_dtype="int8", tp=tp))
                _assert_same(jcm.prefill_s(jdev, jm, tl, tp=tp),
                             cm.prefill_s(dev, m, tl, tp=tp))
            _assert_same(
                jcm.speculative_tick_s(jdev, jm, jcm.MODELS["qwen3vl-2b"], 3,
                                       context_tokens=48),
                cm.speculative_tick_s(dev, m, cm.MODELS["qwen3vl-2b"], 3,
                                      context_tokens=48))
            for kv in ("bf16", "int8"):
                _assert_same(jcm.kv_migrate_bytes(jm, 4096, kv),
                             cm.kv_migrate_bytes(m, 4096, kv))
                _assert_same(jcm.kv_bytes_per_token(jm, kv),
                             cm.kv_bytes_per_token(m, kv))
            _assert_same(jcm.expected_out_tokens(jm, diff),
                         cm.expected_out_tokens(m, diff))
        _assert_same((jcm.uplink_s(1e6, jdev), jcm.downlink_s(1e6, jdev),
                      jcm.stream_chunk_s(jdev)),
                     (cm.uplink_s(1e6, dev), cm.downlink_s(1e6, dev),
                      cm.stream_chunk_s(dev)))
        for mod in ("image", "audio"):
            js, s = jcm.media_spec(mod, 0.5), cm.media_spec(mod, 0.5)
            src = cm.DEVICES["jetson_orin_nano"]
            assert (jcm.best_split(js, jcm.DEVICES["jetson_orin_nano"], jdev)
                    == cm.best_split(s, src, dev))
    _assert_same(jcm.chunked_prefill_tokens(tl, 64),
                 cm.chunked_prefill_tokens(tl, 64))
    assert jcm.payload_bytes() == cm.payload_bytes()
    _assert_same(jcm.expected_accepted(3, np.linspace(0, 1, 5)),
                 cm.expected_accepted(3, np.linspace(0, 1, 5)))


@pytest.mark.parametrize("spec", [SPEC, *jce.SYSTEM_CONFIGS.values()])
def test_make_servers_from_spec(spec):
    jb, b = _bench_pair(0, 60)
    js, s = jce.make_servers_from_spec(spec, jb), ce.make_servers_from_spec(
        spec, b)
    for f in dataclasses.fields(js):
        _assert_same(getattr(js, f.name), getattr(s, f.name))
    _assert_same(jce.greedy_latencies(jb, js, np.arange(40)),
                 ce.greedy_latencies(b, s, np.arange(40)))


def _episode(mod, bench, servers, policy, tasks, failed=None):
    ep = mod.Episode(bench, servers, tasks, np.random.default_rng(1),
                     failed=failed)
    recs = []
    while not ep.done:
        recs.append(ep.step(policy(ep)))
    ep.finalize()
    return recs, ep.queue_s, ep.queue_len


@pytest.mark.parametrize("policy", ["all_cloud", "greedy", "random"])
@pytest.mark.parametrize("n_servers", [5, 15])
def test_run_policy_records(policy, n_servers):
    """Every record of an episode under the cost-model backend, and
    ``run_policy``'s aggregates, for the three heuristic baselines (a
    failed server included), equal the JAX package's."""
    if jbaselines is None:
        pytest.skip("JAX (the reference package) is not installed here")
    jb, b = _bench_pair(0, 300)
    js, s = jce.make_servers(n_servers, jb), ce.make_servers(n_servers, b)
    tasks = np.random.default_rng(0).choice(300, 64, replace=False)
    failed = np.zeros(s.n, bool)
    failed[-1] = True

    def make(mod, servers):
        if policy == "all_cloud":
            return mod.all_cloud_policy(servers)
        if policy == "greedy":
            return mod.greedy_policy()
        return mod.random_policy(np.random.default_rng(5))

    for f in (None, failed):
        want = _episode(jce, jb, js, make(jbaselines, js), tasks, f)
        got = _episode(ce, b, s, make(baselines, s), tasks, f)
        _assert_same(want, got)
        assert (jce.run_policy(make(jbaselines, js), jb, js, tasks,
                               np.random.default_rng(1), failed=f)
                == ce.run_policy(make(baselines, s), b, s, tasks,
                                 np.random.default_rng(1), failed=f))


def _router(rmod, bench, servers, **kw):
    handles = [rmod.SimulatedServer(f"s{i}", bench, int(c),
                                    np.random.default_rng(i),
                                    fail=i == servers.n - 1)
               for i, c in enumerate(servers.cls)]
    # the predictors read the router's own list, which add_server and
    # remove_server edit in place
    return rmod.QLMIORouter(
        handles,
        milp_pred=lambda t, s: 0.9 * float(
            bench.latency_s[t, handles[s].class_idx]),
        mgqp_pred=lambda t, s: float(
            bench.score[t, handles[s].class_idx] == 1), **kw)


@pytest.mark.parametrize("shapes", ["pure", "disagg", "spec"])
def test_router_route_plan_dispatch(shapes):
    """``QLMIORouter`` over ``SimulatedServer``s (the last one failing, so
    health tracking, hedging and cooldowns act): the same ``route``,
    ``plan`` (every dispatch shape) and ``dispatch`` decisions as the JAX
    router, the same queues and health state, through ``add_server`` and
    ``remove_server``."""
    jb, b = _bench_pair(0, 200)
    js, s = jce.make_servers(5, jb), ce.make_servers(5, b)
    kw = {}
    if shapes == "disagg":
        kw["migrate_pred"] = lambda t, sp, sd: (
            None if (sp + sd) % 3 == 0 else 0.1 * (t % 7) + sp + 0.5 * sd)
    elif shapes == "spec":
        kw["spec_pred"] = lambda t, sa, sv: (
            None if sa > sv else 0.2 * (t % 5) + 0.3 * sa + sv)
    jr, r = _router(jrouter, jb, js, **kw), _router(router, b, s, **kw)
    for step, task in enumerate(range(0, 120, 3)):
        assert jr.route(task) == r.route(task)
        assert jr.plan(task) == r.plan(task)
        assert jr.dispatch(task) == r.dispatch(task)
        if step == 10:
            jr.add_server(jrouter.SimulatedServer(
                "extra", jb, 1, np.random.default_rng(9)))
            r.add_server(router.SimulatedServer(
                "extra", b, 1, np.random.default_rng(9)))
        if step == 25:
            jr.remove_server(0)
            r.remove_server(0)
        _assert_same((jr.queue_s, jr.health.ewma_lat, jr.health.fails,
                      jr.health.dead_until),
                     (r.queue_s, r.health.ewma_lat, r.health.fails,
                      r.health.dead_until))
    assert jr.log == r.log
