"""The port's learning pipeline (``repro_torch/core/predictors.py``,
``d3qn.py``, ``qlmio.py``, ``baselines.py``) held to the JAX package's on
the CPU, and ``tests/test_core.py``'s behaviour tests on the port's own
init.

The JAX package's weights are carried into the port's trees in place (the
port's own draw gives other numbers); the simulator, the replay and every
exploration draw are numpy in both packages, so from the same weights the
decisions are the same.  The JAX side runs on the CPU on any host (the
``need_jax`` fixture pins it there).

Tolerances (each with its reason):
* losses and forward outputs: 1e-5 relative, 1e-6 absolute: small fp32
  layers summed in other orders (measured below 1e-6 relative);
* Adam: ``torch.optim.Adam`` against the JAX package's hand-written
  update on the same gradients: 2 ulp of the value, and 1e-5 of lr a
  step (the JAX package takes 1 - 0.999^t in fp32, 1.3e-5 off at t = 1;
  torch takes it in float64);
* parameters after Adam steps from the packages' own gradients: each
  value within 1e-6 + 2 x lr x steps x min(1, 1e-5 x s / |g|), where s
  is the largest gradient of its network and |g| its own smallest
  gradient over the steps.  The gradients agree within 1e-6 of s
  (measured 8e-7 of each leaf's largest; a gradient's rounding scales
  with the terms its sum adds, which may cancel),
  and Adam divides each by its own running RMS (plus eps 1e-8), so a
  gradient's rounding e moves its update by about lr x e / |g|, more where
  m cancels between steps (the factor 10); a gradient that is itself
  rounding noise (a sum that cancels to ~1e-8 in both packages, such as
  the policy's value head, to which the softmax is blind) moves its value
  by up to lr a step in a direction the rounding picks;
* QLMIO's later losses: 1e-4 relative, from those parameters; its
  decisions, rewards, latencies and completions are compared exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

try:
    import jax
    import jax.numpy as jnp

    from repro.core import baselines as jB
    from repro.core import d3qn as jd3qn
    from repro.core import predictors as jpred
    from repro.core import qlmio as jqlmio
    from repro.sim import cemllm as jce
    from repro.sim import miobench as jmb
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.core import baselines as B
from repro_torch.core import d3qn
from repro_torch.core import predictors as pred
from repro_torch.core import qlmio
from repro_torch.core.feature_store import compute_features
from repro_torch.data.taskgen import splits
from repro_torch.nn.spec import tree_leaves
from repro_torch.sim.cemllm import greedy_latencies, make_servers
from repro_torch.sim.miobench import SERVER_CLASSES, generate

TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 1e-6
ADAM_UPDATE_RTOL = 1e-5
GRAD_REL = 1e-5  # a gradient's rounding, of its network's largest, x 10
LATER_LOSS_RTOL = 1e-4
ABLATIONS = [dict(), dict(use_milp=False), dict(use_mgqp=False),
             dict(use_milp=False, use_mgqp=False),
             dict(use_task_features=False, use_milp=False, use_mgqp=False)]
ABLATION_IDS = ["qlmio", "no-milp", "no-mgqp", "no-both", "plain-d3qn"]


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture(scope="module")
def small_world():
    """test_core.py's world: 300 tasks, "tiny" features (the port's own
    frozen encoders on the CPU), the 8:1:1 split."""
    bench = generate(seed=0, n_tasks=300)
    f_img, f_text = compute_features(bench.tasks, profile="tiny",
                                     cache_dir=None, device="cpu")
    return bench, (f_img, f_text), splits(bench.tasks.n)


def _flat(bench, f_text, f_img, ids):
    C = len(SERVER_CLASSES)
    t = np.repeat(ids, C)
    c = np.tile(np.arange(C), len(ids))
    return {"f_text": f_text[t], "f_img": f_img[t],
            "model_id": bench.model_id[c], "device_id": bench.device_id[c],
            "label": (bench.score[t, c] == 1).astype(np.int64),
            "latency_s": bench.latency_s[t, c].astype(np.float32)}


def _np(tree):
    """A JAX tree (or a port tree) as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().numpy()
    return np.asarray(tree)


@torch.no_grad()
def _assign(dst, src):
    """Copy the numpy tree ``src`` into the port's tensor tree ``dst`` in
    place (an optimiser keeps its hold on the leaves), key by key."""
    assert sorted(dst) == sorted(src)
    for k, v in src.items():
        if isinstance(v, dict):
            _assign(dst[k], v)
        else:
            assert dst[k].shape == v.shape, k
            dst[k].copy_(torch.from_numpy(np.array(v)))


@pytest.fixture
def grad_log():
    """For every parameter any optimiser steps while the test runs: (its
    values' smallest |gradient| over the steps, the leaf's largest)."""
    log = {}

    def hook(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.abs()
                lo, hi = log.get(p, (g, g.max()))
                log[p] = (torch.minimum(lo, g), torch.maximum(hi, g.max()))

    handle = register_optimizer_step_pre_hook(hook)
    yield log
    handle.remove()


def _assert_adam(got, want, lr, steps, grad_log, stepped=None, s=None):
    """The port's tree ``got`` after ``steps`` Adam steps at ``lr`` within
    each value's bound of the JAX tree ``want`` (see the module's
    docstring); ``stepped`` is the tree whose leaves the optimiser stepped
    when ``got`` is derived from it (a target network)."""
    stepped = got if stepped is None else stepped
    if s is None:  # the network's largest gradient
        s = max(float(grad_log[p][1]) for p in tree_leaves(stepped))
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_adam(got[k], want[k], lr, steps, grad_log, stepped[k], s)
            continue
        diff = np.abs(got[k].detach().numpy() - np.asarray(want[k]))
        lo = grad_log[stepped[k]][0].numpy()
        share = np.minimum(1.0, GRAD_REL * s / np.maximum(lo, 1e-30))
        bound = PARAM_ATOL + 2 * lr * steps * share
        worst = np.argmax(diff - bound)
        assert diff.flat[worst] <= bound.flat[worst], \
            (k, diff.flat[worst], bound.flat[worst], lo.flat[worst])


def _features(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("gamma,alpha", [(2.0, 0.3), (0.0, 0.5), (1.5, 0.8)])
def test_focal_loss_matches_jax(need_jax, gamma, alpha):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 2)).astype(np.float32) * 3
    labels = rng.integers(0, 2, 64)
    want = float(jpred.focal_loss(jnp.asarray(logits), jnp.asarray(labels),
                                  alpha=alpha, gamma=gamma))
    got = float(pred.focal_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels), alpha=alpha,
                                gamma=gamma))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("delta", [1.0, 0.25])
def test_huber_loss_matches_jax(need_jax, delta):
    rng = np.random.default_rng(1)
    p, t = (rng.normal(size=100).astype(np.float32) * 2 for _ in range(2))
    want = float(jpred.huber_loss(jnp.asarray(p), jnp.asarray(t),
                                  delta=delta))
    got = float(pred.huber_loss(torch.from_numpy(p), torch.from_numpy(t),
                                delta=delta))
    np.testing.assert_allclose(got, want, **TOL)


def test_focal_loss_matches_ce_at_gamma0():
    logits = torch.tensor([[2.0, -1.0], [-0.5, 1.5]])
    labels = torch.tensor([0, 1])
    fl = pred.focal_loss(logits, labels, alpha=0.5, gamma=0.0)
    ce = -torch.log_softmax(logits, -1)[torch.arange(2), labels].mean() * 0.5
    np.testing.assert_allclose(float(fl), float(ce), rtol=1e-5)


def test_huber_quadratic_then_linear():
    assert float(pred.huber_loss(torch.tensor([0.5]), torch.tensor([0.0]))) \
        == pytest.approx(0.125)
    assert float(pred.huber_loss(torch.tensor([3.0]), torch.tensor([0.0]))) \
        == pytest.approx(2.5)


# -------------------------------------------------------------- predictors


def _predictor_pair(kind, cfg, feat_dim=64):
    jp = jpred.Predictor(kind, 8, 8, cfg, feat_dim=feat_dim)
    p = pred.Predictor(kind, 8, 8, dataclasses.replace(cfg),
                       feat_dim=feat_dim, device="cpu")
    _assign(p.params, _np(jp.params))
    return jp, p


def _records(n_tasks, feat_dim, seed):
    bench = generate(seed=seed, n_tasks=n_tasks)
    f_img, f_text = _features(n_tasks, feat_dim, seed)
    return _flat(bench, f_text, f_img, np.arange(n_tasks))


@pytest.mark.parametrize("kind", ["quality", "latency"])
def test_predictor_forward_and_predict_match_jax(need_jax, kind):
    """The deterministic forward, ``predict`` (the success probability,
    or expm1 of the log1p-latency output) and ``evaluate``."""
    jp, p = _predictor_pair(kind, pred.PredictorConfig())
    data = _records(30, 64, 2)
    want = np.asarray(jp._raw(jp.params, {k: jnp.asarray(v)
                                           for k, v in data.items()}))
    got = p._raw(p.params, p.tensors(data)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(p.predict(data), jp.predict(data), **TOL)
    if kind == "latency":
        np.testing.assert_allclose(p.predict(data), np.expm1(want[:, 0]),
                                   **TOL)
    got, want = p.evaluate(data, "x_"), jp.evaluate(data, "x_")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("kind", ["quality", "latency"])
@pytest.mark.parametrize("epochs,batch", [(1, 60), (2, 32)],
                         ids=["one-adam-step", "two-epochs"])
def test_predictor_fit_matches_jax(need_jax, grad_log, kind, epochs,
                                   batch):
    """``fit`` at dropout 0 from the JAX weights: one Adam step (one batch
    of all 60 records) against the JAX package's hand-written update, and
    two epochs of batches of 32 (the last partial batch dropped, the
    numpy permutation of each epoch), history and final parameters."""
    cfg = pred.PredictorConfig(epochs=epochs, batch=batch, dropout=0.0)
    jp, p = _predictor_pair(kind, cfg)
    data, val = _records(20, 64, 3), _records(10, 64, 4)
    want = jp.fit(data, val)
    got = p.fit(data, val)
    assert len(got) == len(want) == epochs
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
    _assert_adam(p.params, jp.params, cfg.lr, epochs * (60 // batch),
                 grad_log)
    if kind == "quality":
        assert p._alpha == jp._alpha


def _jax_adam(p, m, v, g, t, lr):
    """The JAX package's hand-written Adam (repro/core/predictors.py:125),
    one value array at a time."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    tf = jnp.float32(t)
    p = p - lr * (m / (1 - 0.9 ** tf)) / (jnp.sqrt(v / (1 - 0.999 ** tf))
                                          + 1e-8)
    return p, m, v


def test_adam_step_is_the_jax_update(need_jax):
    """``torch.optim.Adam`` as the port builds it (``d3qn.adam``) is the
    JAX package's update on the same gradients, step for step: large,
    small, eps-sized and zero gradients, over three steps."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(6, 50)).astype(np.float32)
    scales = np.array([1.0, 1e-3, 1e-6, 1e-8, 1e-9, 0.0], np.float32)
    params = {"w": torch.tensor(p0)}
    opt = d3qn.adam(params, lr=1e-3)
    jp, m, v = jnp.asarray(p0), jnp.zeros_like(p0), jnp.zeros_like(p0)
    for t in (1, 2, 3):
        g = (rng.normal(size=p0.shape) * scales[:, None]).astype(np.float32)
        params["w"].grad = torch.tensor(g)
        opt.step()
        jp, m, v = _jax_adam(jp, m, v, jnp.asarray(g), t, 1e-3)
        np.testing.assert_allclose(params["w"].detach().numpy(),
                                   np.asarray(jp), rtol=2.4e-7,
                                   atol=ADAM_UPDATE_RTOL * 1e-3 * t)


# ------------------------------------------------------------------- D3QN


def _state_batch(B, A, feat_dim, seed, prefix=""):
    rng = np.random.default_rng(seed)
    s = {"f_text": rng.normal(size=(B, feat_dim)).astype(np.float32),
         "f_img": rng.normal(size=(B, feat_dim)).astype(np.float32),
         "model_ids": rng.integers(0, 3, (B, A)),
         "device_ids": rng.integers(0, 3, (B, A)),
         "t_hat": rng.random((B, A)).astype(np.float32),
         "q_load": rng.random((B, A)).astype(np.float32),
         "b_hat": rng.random((B, A)).astype(np.float32)}
    return {prefix + k: v for k, v in s.items()}


def _replay_batch(B, A, feat_dim, seed):
    rng = np.random.default_rng(seed + 100)
    batch = {"action": rng.integers(0, A, B),
             "reward": rng.normal(size=B).astype(np.float32) * 2,
             "done": (rng.random(B) < 0.2).astype(np.float32)}
    batch.update(_state_batch(B, A, feat_dim, seed, "s_"))
    batch.update(_state_batch(B, A, feat_dim, seed + 1, "n_"))
    return batch


def _agent_pair(cfg, A=5, feat_dim=64, use_task_features=True):
    ja = jd3qn.D3QNAgent(A, 3, 3, cfg, feat_dim, use_task_features)
    a = d3qn.D3QNAgent(A, 3, 3, dataclasses.replace(cfg), feat_dim,
                       use_task_features, device="cpu")
    _assign(a.params, _np(ja.params))
    _assign(a.target, _np(ja.target))
    return ja, a


@pytest.mark.parametrize("use_task_features", [True, False])
def test_qnet_spec_and_q_values_match_jax(need_jax, use_task_features):
    """The Q-network's leaves and the dueling Q = V + A - mean(A), with
    and without the task-feature branches."""
    spec = d3qn.qnet_spec(5, 3, 3, 64, use_task_features)
    jspec = jd3qn.qnet_spec(5, 3, 3, 64, use_task_features)
    assert sorted(spec) == sorted(jspec)
    ja, a = _agent_pair(d3qn.D3QNConfig(), use_task_features=
                        use_task_features)
    state = _state_batch(7, 5, 64, 0)
    if not use_task_features:
        del state["f_text"], state["f_img"]
    want = np.asarray(jd3qn.q_values(ja.params, {k: jnp.asarray(v)
                                                 for k, v in state.items()}))
    got = d3qn.q_values(a.params, d3qn.to_tensors(state, "cpu"))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("use_task_features", [True, False])
def test_d3qn_update_matches_jax(need_jax, grad_log, use_task_features):
    """Two ``train_step``s (the double-DQN target from the parameters
    before each update, the Huber loss, Adam at steps 1 and 2) from the
    JAX weights, with a target network that differs from the online one;
    then ``soft_update``."""
    cfg = d3qn.D3QNConfig(lr=1e-3)
    ja, a = _agent_pair(cfg, use_task_features=use_task_features)
    for step, seed in enumerate((0, 1), 1):
        batch = _replay_batch(32, 5, 64, seed)
        if not use_task_features:
            batch = {k: v for k, v in batch.items() if "f_" not in k}
        np.testing.assert_allclose(a.train_step(batch),
                                   ja.train_step(batch), **TOL)
        _assert_adam(a.params, ja.params, cfg.lr, step, grad_log)
        ja.soft_update()
        a.soft_update()
        _assert_adam(a.target, ja.target, cfg.lr * cfg.tau, step, grad_log,
                     a.params)


def test_epsilon_and_act_match_jax(need_jax):
    """The epsilon schedule, and ``act`` under the same numpy seed: the
    exploration draws, and the greedy argmax on the host."""
    cfg = d3qn.D3QNConfig(eps_decay_steps=40)
    ja, a = _agent_pair(cfg)
    states = _state_batch(60, 5, 64, 3)
    picks, jpicks = [], []
    for i in range(60):
        state = {k: v[i] for k, v in states.items()}
        a.step_count = ja.step_count = i
        assert a.epsilon() == ja.epsilon()
        picks.append(a.act(state, greedy=i % 7 == 0))
        jpicks.append(ja.act(state, greedy=i % 7 == 0))
    assert picks == jpicks
    assert a.rng.random() == ja.rng.random()


# ------------------------------------------------------------------ QLMIO


def _qlmio_pair(cfg, features, milp, mgqp, n_tasks=300):
    jbench = jmb.generate(seed=0, n_tasks=n_tasks)
    bench = generate(seed=0, n_tasks=n_tasks)
    jq = jqlmio.QLMIO(jbench, jce.make_servers(5, jbench), features, milp,
                      mgqp, cfg)
    q = qlmio.QLMIO(bench, make_servers(5, bench), features, milp, mgqp,
                    dataclasses.replace(cfg), device="cpu")
    _assign(q.agent.params, _np(jq.agent.params))
    _assign(q.agent.target, _np(jq.agent.target))
    return jq, q


def _oracle(n_tasks=300):
    bench = generate(seed=0, n_tasks=n_tasks)
    return (bench.latency_s.astype(np.float32),
            (bench.score == 1).astype(np.float32))


@pytest.mark.parametrize("kw", ABLATIONS, ids=ABLATION_IDS)
def test_qlmio_state_and_replay_match_jax(need_jax, small_world, kw):
    """Eq. 18's state under each ablation (its zeroed branch) and the
    replay's keys, shapes and dtypes equal the JAX package's exactly."""
    _, features, _ = small_world
    milp, mgqp = _oracle()
    jq, q = _qlmio_pair(qlmio.QLMIOConfig(**kw), features, milp, mgqp)
    rng = np.random.default_rng(5)
    pred_sum, pred_len = rng.random(5) * 30, rng.integers(0, 3, 5) * 1.0
    for task in (0, 17, 299):
        got = q._state(task, pred_sum, pred_len)
        want = jq._state(task, pred_sum, pred_len)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert {k: (v.shape, v.dtype) for k, v in q.replay.buf.items()} == \
        {k: (v.shape, v.dtype) for k, v in jq.replay.buf.items()}


def _recorded(agent):
    """Record every ``act`` decision of ``agent`` and the number of train
    steps taken before it."""
    log = []
    act, train_step = agent.act, agent.train_step
    steps = [0]

    def rec_act(state, greedy=False):
        log.append((act(state, greedy=greedy), steps[0]))
        return log[-1][0]

    def rec_train(batch):
        steps[0] += 1
        return train_step(batch)

    agent.act, agent.train_step = rec_act, rec_train
    return log


def test_qlmio_train_and_evaluate_match_jax(need_jax, grad_log,
                                            small_world):
    """Three episodes of ``train`` from the JAX weights: the decisions are
    the JAX ones up to the first parameter update and, here, after it;
    the history's losses within 1e-4 relative, the rest exact.  Then the
    greedy ``evaluate`` gives the JAX metrics."""
    bench, features, (tr, _, te) = small_world
    milp, mgqp = _oracle()
    cfg = qlmio.QLMIOConfig(episodes=3, users=10, seed=0,
                            agent=d3qn.D3QNConfig(batch=8,
                                                  eps_decay_steps=20))
    jq, q = _qlmio_pair(cfg, features, milp, mgqp)
    jlog, log = _recorded(jq.agent), _recorded(q.agent)
    want, got = jq.train(tr), q.train(tr)
    first_update = next(i for i, (_, n) in enumerate(log) if n > 0)
    # replay.n > 8 from the 9th step on; a train step every 5th: after
    # acts 10, 15, 20, 25 and 30
    assert first_update == 10 and len(log) == 30 and log[-1][1] == 4
    assert log[:first_update] == jlog[:first_update]
    assert log == jlog
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "loss":
                np.testing.assert_allclose(g[k], w[k], rtol=LATER_LOSS_RTOL)
            else:
                assert g[k] == w[k], k
    _assert_adam(q.agent.params, jq.agent.params, cfg.agent.lr, 5, grad_log)
    assert q.evaluate(te, users=10, trials=2) == \
        jq.evaluate(te, users=10, trials=2)


def test_linreg_latency_and_heuristics_match_jax(need_jax):
    """QoS-Aware RL's regression and the three heuristic policies' metrics
    equal the JAX package's exactly (numpy on the same numbers)."""
    jbench, bench = jmb.generate(0, 400), generate(0, 400)
    tr, _, te = splits(400)
    np.testing.assert_array_equal(B.linreg_latency(bench, tr),
                                  jB.linreg_latency(jbench, tr))
    np.testing.assert_array_equal(B.A_full(np.arange(5.0)),
                                  jB.A_full(np.arange(5.0)))
    for n_servers in (5, 10):
        got = B.evaluate_heuristics(bench, make_servers(n_servers, bench),
                                    te, 12, 3)
        want = jB.evaluate_heuristics(jbench,
                                      jce.make_servers(n_servers, jbench),
                                      te, 12, 3)
        assert got == want


def test_learning_baselines_match_jax(need_jax, small_world):
    """plain D3QN and QoS-Aware RL: the degraded configurations, the
    predictions they carry and their first state equal the JAX ones."""
    bench, features, (tr, _, _) = small_world
    jbench = jmb.generate(0, 300)
    servers, jservers = make_servers(5, bench), jce.make_servers(5, jbench)
    pairs = [(B.make_plain_d3qn(bench, servers, features, device="cpu"),
              jB.make_plain_d3qn(jbench, jservers, features)),
             (B.make_qos_rl(bench, servers, features, tr, device="cpu"),
              jB.make_qos_rl(jbench, jservers, features, tr))]
    for q, jq in pairs:
        assert dataclasses.asdict(q.cfg) == dataclasses.asdict(jq.cfg)
        np.testing.assert_array_equal(q.milp, jq.milp)
        np.testing.assert_array_equal(q.mgqp, jq.mgqp)
        zeros = np.zeros(5)
        got, want = q._state(3, zeros, zeros), jq._state(3, zeros, zeros)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _sac_pair(cfg):
    jsac = jB.DiscreteSAC(5, 3, 3, cfg, feat_dim=64)
    sac = B.DiscreteSAC(5, 3, 3, dataclasses.replace(cfg), feat_dim=64,
                        device="cpu")
    for name in ("pi", "q1", "q2", "q1_t", "q2_t"):
        _assign(getattr(sac, name), _np(getattr(jsac, name)))
    return jsac, sac


def test_sac_act_and_train_step_match_jax(need_jax, grad_log):
    """DiscreteSAC from the JAX weights: greedy and sampled ``act`` under
    the same numpy seed; two ``train_step``s (critics, policy, their Adams
    and the folded soft-target update) give the JAX loss and networks."""
    jsac, sac = _sac_pair(jB.SACConfig(lr=1e-3))
    states = _state_batch(20, 5, 64, 7)
    for i in range(20):
        state = {k: v[i] for k, v in states.items() if "f_" not in k}
        for greedy in (True, False):
            assert sac.act(state, greedy) == jsac.act(state, greedy)
    lr = sac.cfg.lr
    for step, seed in enumerate((0, 1), 1):
        batch = {k: v for k, v in _replay_batch(32, 5, 64, seed).items()
                 if "f_" not in k}
        np.testing.assert_allclose(sac.train_step(batch),
                                   jsac.train_step(batch), **TOL)
        for name in ("pi", "q1", "q2"):
            _assert_adam(getattr(sac, name), getattr(jsac, name), lr, step,
                         grad_log)
            if name != "pi":
                _assert_adam(getattr(sac, name + "_t"),
                             getattr(jsac, name + "_t"),
                             lr * sac.cfg.tau, step, grad_log,
                             getattr(sac, name))


def test_sac_in_the_qlmio_harness(small_world):
    """``make_sac`` splices the SAC agent into QLMIO's harness: it trains
    (losses once the replay holds a batch) and evaluates."""
    bench, features, (tr, _, te) = small_world
    cfg = qlmio.QLMIOConfig(episodes=3, users=10, seed=0,
                            agent=d3qn.D3QNConfig(batch=8))
    q = B.make_sac(bench, make_servers(5, bench), features, cfg,
                   device="cpu")
    assert isinstance(q.agent, B._SACAdapter)
    assert q.agent.epsilon() == 0.0 and "s_f_text" not in q.replay.buf
    hist = q.train(tr)
    assert np.isfinite(hist[-1]["loss"])
    res = q.evaluate(te, users=10, trials=2)
    assert 0.0 <= res["completion_rate"] <= 1.0


# ------------------------------------------- test_core.py's behaviour tests


def test_predictors_learn(small_world):
    bench, (f_img, f_text), (tr, va, te) = small_world
    cfg = pred.PredictorConfig(epochs=6, batch=128)
    mgqp = pred.Predictor("quality", 8, 8, cfg, feat_dim=f_text.shape[1],
                          device="cpu")
    hist = mgqp.fit(_flat(bench, f_text, f_img, tr),
                    _flat(bench, f_text, f_img, va))
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert hist[-1]["train_acc"] > 0.55
    milp = pred.Predictor("latency", 8, 8, cfg, feat_dim=f_text.shape[1],
                          device="cpu")
    hist = milp.fit(_flat(bench, f_text, f_img, tr),
                    _flat(bench, f_text, f_img, va))
    # MAE must beat predicting the global mean
    lat = bench.latency_s[tr].reshape(-1)
    base_mae = np.abs(lat - lat.mean()).mean()
    assert hist[-1]["train_mae_s"] < base_mae


def test_greedy_latency_is_reasonable(small_world):
    bench, _, (tr, _, _) = small_world
    tg = greedy_latencies(bench, make_servers(5, bench), tr[:20])
    assert (tg > 0).all()


def test_qlmio_trains_and_beats_random(small_world):
    bench, features, (tr, va, te) = small_world
    servers = make_servers(5, bench)
    # oracle predictions (perfect MILP/MGQP) keep this test fast + stable
    milp_preds = bench.latency_s.astype(np.float32)
    mgqp_preds = (bench.score == 1).astype(np.float32)
    cfg = qlmio.QLMIOConfig(episodes=40, users=10, seed=0,
                            agent=d3qn.D3QNConfig(eps_decay_steps=250,
                                                  batch=64))
    q = qlmio.QLMIO(bench, servers, features, milp_preds, mgqp_preds, cfg,
                    device="cpu")
    hist = q.train(tr)
    res = q.evaluate(te, trials=3)
    heur = B.evaluate_heuristics(bench, servers, te, 10, 3)
    assert res["avg_reward"] > heur["random"]["avg_reward"]
    assert res["completion_rate"] > heur["random"]["completion_rate"]
    # learning happened
    assert np.mean([h["avg_reward"] for h in hist[-10:]]) > \
        np.mean([h["avg_reward"] for h in hist[:10]])


@pytest.mark.parametrize("kw", ABLATIONS[1:], ids=ABLATION_IDS[1:])
def test_qlmio_ablation_state_shapes(small_world, kw):
    bench, features, (tr, _, _) = small_world
    servers = make_servers(5, bench)
    zeros = np.zeros((bench.tasks.n, len(SERVER_CLASSES)), np.float32)
    cfg = qlmio.QLMIOConfig(episodes=2, users=5, seed=0, **kw)
    q = qlmio.QLMIO(bench, servers, features, zeros, zeros, cfg,
                    device="cpu")
    q.train(tr)  # must run without error


def test_learning_entry_points_need_a_device(monkeypatch):
    """Without a card, no entry point falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench = generate(seed=0, n_tasks=20)
    feats = _features(20, 16, 0)
    for make in (lambda: pred.Predictor("quality", 8, 8, feat_dim=16),
                 lambda: d3qn.D3QNAgent(5, 3, 3, feat_dim=16),
                 lambda: qlmio.QLMIO(bench, make_servers(5, bench), feats,
                                     *_oracle(20)),
                 lambda: B.DiscreteSAC(5, 3, 3, feat_dim=16)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    leaves = tree_leaves(d3qn.D3QNAgent(5, 3, 3, feat_dim=16,
                                        device="cpu").params)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in leaves)
