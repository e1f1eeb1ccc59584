"""The port's serving driver (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``): the same fleet with the JAX servers'
weights gives the same router log (server, latency, ok, hedged) for 12
tasks, healthy and with each server failed; with both fleets' engines
rebuilt in fp32 the served tokens are equal too; the drain assertion holds
and ``main`` runs on the CPU."""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.launch import serve as jserve
    from repro.models import build_model as jbuild
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.router import QLMIORouter as JRouter
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.models.api import build_model
from repro_torch.nn.spec import tree_leaves, tree_map_specs
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.router import QLMIORouter
from repro_torch.weights import from_jax_params

TASKS = 12
LOG_KEYS = ("task", "server", "latency", "ok", "hedged")


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _route(router_cls, servers) -> list:
    """The driver's router and predictors over ``servers``, 12 tasks."""
    speeds = np.array([s.speed for s in servers])
    router = router_cls(list(servers), lambda task, s: 8.0 / speeds[s],
                        lambda task, s: [0.7, 0.85, 0.95][s])
    for task in range(TASKS):
        router.dispatch(task)
    return router


def _log(router) -> list:
    return [tuple(r[k] for k in LOG_KEYS) for r in router.log]


def _params(jservers) -> list:
    """Each JAX server's engine weights as the port's tensors."""
    return [from_jax_params(jax.tree.map(np.asarray, s.engine.params),
                            device="cpu") for s in jservers]


def _check_drain(router, fail):
    counts = np.bincount([r["server"] for r in router.log], minlength=3)
    if fail is not None:
        assert counts[fail] <= router.health.fail_threshold
        assert all(not r["ok"] for r in router.log if r["server"] == fail)
    return counts


@pytest.mark.parametrize("fail", [None, 0, 1, 2])
def test_router_log_matches_jax(need_jax, fail):
    """The JAX fleet's bf16 weights in the port's fleet: the same 12
    dispatches, latencies (ticks / speed), outcomes and hedges."""
    jservers = jserve.build_cluster(fail)
    servers = serve.build_cluster(fail, params=_params(jservers),
                                  device="cpu")
    assert [(s.name, s.speed, s.model_id, s.device_id, s.is_cloud, s.fail)
            for s in servers] == \
        [(s.name, s.speed, s.model_id, s.device_id, s.is_cloud, s.fail)
         for s in jservers]
    jrouter, router = _route(JRouter, jservers), _route(QLMIORouter, servers)
    assert _log(router) == _log(jrouter)
    assert (_check_drain(router, fail) == _check_drain(jrouter, fail)).all()
    assert [s.engine.ticks for s in servers] == \
        [s.engine.ticks for s in jservers]


def _fp32_fleets(fail):
    """Both fleets with every engine rebuilt on fp32 weights and fp32
    activations (the JAX package's own classes, untouched)."""
    jservers = jserve.build_cluster(fail)
    servers = serve.build_cluster(fail, params=_params(jservers),
                                  device="cpu")
    for js, s in zip(jservers, servers):
        arch = js.name.split("/")[1].rstrip(")")
        jcfg = jreduced(jget_config(arch), act_dtype="float32")
        jmodel = jbuild(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
        js.cfg, js.engine = jcfg, JEngine(jmodel, jparams, max_batch=2,
                                          max_seq=96)
        s.cfg = reduced(get_config(arch), act_dtype="float32")
        s.engine = ServingEngine(
            build_model(s.cfg),
            from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu"),
            max_batch=2, max_seq=96, device="cpu")
    return jservers, servers


@pytest.mark.parametrize("fail", [None, 2])
def test_fp32_served_tokens_match_jax(need_jax, fail):
    """fp32 engines on the same weights: the router logs and every served
    request's tokens equal (healthy: the cloud serves; with the cloud
    failed: the edges do)."""
    jservers, servers = _fp32_fleets(fail)
    jrouter, router = _route(JRouter, jservers), _route(QLMIORouter, servers)
    assert _log(router) == _log(jrouter)
    served = 0
    for js, s in zip(jservers, servers):
        got = [list(r.output) for r in s.engine.finished]
        assert got == [list(r.output) for r in js.engine.finished], s.name
        assert all(len(o) == 8 for o in got)
        served += len(got)
    assert served >= TASKS - sum(1 for r in router.log if not r["ok"])
    _check_drain(router, fail)


def test_full_fleet_fits_one_card():
    """``--full`` builds the fleet at published width and depth with no
    cut: the three configs' parameter counts, and their bf16 weights
    (76.0 GB) within one card's memory (``mesh.HBM_BYTES``)."""
    counts = [sum(tree_leaves(tree_map_specs(
        lambda _, s: s.size, build_model(get_config(arch)).spec)))
        for _, arch, *_ in serve.FLEET]
    assert counts == [494_032_768, 3_212_749_824, 34_293_436_416]
    assert 2 * sum(counts) < HBM_BYTES


def test_main_runs_on_cpu(capsys):
    servers, router = serve.main(["--device", "cpu", "--requests", "6",
                                  "--fail-server", "2"])
    out = capsys.readouterr().out
    # the failed cloud's one attempt is hedged to edge-1, which wins
    assert "6/6 ok" in out and "fault tolerance OK" in out
    assert [r["server"] for r in router.log] == [1] * 6
    assert router.log[0]["hedged"]
    assert all(s.engine.device == torch.device("cpu") for s in servers)
    assert [len(s.engine.finished) for s in servers] == [0, 6, 0]
