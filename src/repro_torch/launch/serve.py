"""Serving driver (a port of ``repro/launch/serve.py``): a cloud-edge
continuum of real model engines behind the QLMIO router, with health
tracking, hedging and fault injection.  It runs on the CUDA card unless
``--device cpu`` (``device="cpu"``) is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --requests 24 --fail-server 1

The fleet is the JAX driver's: qwen2-0.5b, llama3.2-3b and chameleon-34b,
reduced by default.  ``--full`` builds each at its published width and
depth (about 76 GB of bf16 weights, drawn on the card from seed 0, which
fit one 80 GB card with their KV pools); each built engine prints the
device memory left.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.router import QLMIORouter, ServerHandle

# (name, arch, speed, model_id, device_id, is_cloud): the JAX driver's fleet
FLEET = [("edge-0 (jetson/qwen2-0.5b)", "qwen2-0.5b", 2.0, 0, 0, False),
         ("edge-1 (3090ti/llama3.2-3b)", "llama3.2-3b", 8.0, 1, 1, False),
         ("cloud (pod/chameleon-34b)", "chameleon-34b", 32.0, 2, 2, True)]


class EngineServer(ServerHandle):
    """A real ServingEngine wrapped as a continuum server.  'Latency' is
    the engine tick count scaled by a device-speed factor (wall clock
    would only measure this host).

    ``params`` (already on ``device``) replaces the weights drawn from
    ``seed`` (a test passes the JAX package's through
    ``repro_torch.weights.from_jax_params``); ``full`` keeps the config
    at its published size."""

    def __init__(self, name, arch, speed: float, model_id: int,
                 device_id: int, is_cloud: bool, seed: int = 0, fail=False,
                 *, params=None, full: bool = False, device=None):
        dev = resolve(device)
        cfg = get_config(arch)
        if not full:
            cfg = reduced(cfg)
        self.cfg = cfg
        model = build_model(cfg)
        if params is None:
            params = model.init(seed, device=dev)
        self.engine = ServingEngine(model, params, max_batch=2, max_seq=96,
                                    device=dev)
        self.speed = speed
        self.fail = fail
        self.uid = 0
        super().__init__(name=name, model_id=model_id, device_id=device_id,
                         is_cloud=is_cloud, execute=self._execute)

    def _execute(self, task: int):
        if self.fail:
            return 240.0, False
        rng = np.random.default_rng((task, self.model_id))
        prompt = rng.integers(0, self.cfg.vocab, 16).astype(np.int32)
        self.uid += 1
        req = Request(self.uid, prompt, max_new_tokens=8)
        self.engine.submit(req)
        t0 = self.engine.ticks
        while not req.done:
            self.engine.step()
        ticks = self.engine.ticks - t0
        return ticks / self.speed, True


def build_cluster(fail_server: int | None = None, *, params=None,
                  full: bool = False, device=None):
    """The JAX driver's three servers (names, speeds and ids), reduced or
    (``full``) at published width; ``params`` optionally gives each
    server's weights (a list of three trees, already on ``device``).  On
    the card each built engine prints the device memory left."""
    dev = resolve(device)
    servers = []
    for i, (name, arch, speed, mid, did, cloud) in enumerate(FLEET):
        t0 = time.perf_counter()
        servers.append(EngineServer(
            name, arch, speed, mid, did, cloud, fail=fail_server == i,
            params=None if params is None else params[i], full=full,
            device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            free, total = torch.cuda.mem_get_info(dev)
            print(f"[serve] built {name}: {servers[-1].cfg.n_layers} "
                  f"layers in {time.perf_counter() - t0:.1f} s; device "
                  f"memory free {free / 1e9:.2f} of {total / 1e9:.2f} GB",
                  flush=True)
    return servers


def main(argv=None):
    """Serve ``--requests`` tasks through the router and print each
    dispatch; returns (servers, router)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--fail-server", type=int, default=None)
    ap.add_argument("--full", action="store_true",
                    help="each config at its published width and depth")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    servers = build_cluster(args.fail_server, full=args.full,
                            device=args.device)
    # simple analytic predictors for the demo (speed-based)
    speeds = np.array([s.speed for s in servers])
    milp = lambda task, s: 8.0 / speeds[s]  # noqa: E731
    mgqp = lambda task, s: [0.7, 0.85, 0.95][s]  # noqa: E731
    router = QLMIORouter(list(servers), milp, mgqp)
    t0 = time.time()
    ok = 0
    for task in range(args.requests):
        rec = router.dispatch(task)
        ok += rec["ok"]
        print(f"[serve] task {task} -> {servers[rec['server']].name} "
              f"lat={rec['latency']:.2f} ok={rec['ok']} "
              f"hedged={rec['hedged']}", flush=True)
    per_server = np.bincount([r["server"] for r in router.log],
                             minlength=len(servers))
    print(f"[serve] {ok}/{args.requests} ok in {time.time()-t0:.0f}s; "
          f"dispatch counts {per_server.tolist()}")
    for s in servers:
        st = s.engine.stats()
        if st.get("paged"):
            print(f"[serve] {s.name}: paged KV "
                  f"{st['kv_cache_bytes'] / 1e6:.1f} MB, "
                  f"prefix hits {st['prefix_hits']}, "
                  f"reused {st['prefix_tokens_reused']} tok, "
                  f"computed {st['prefill_tokens_computed']} tok")
    if args.fail_server is not None:
        if per_server[args.fail_server] > router.health.fail_threshold:
            raise AssertionError(
                "router failed to drain traffic from the failed server")
        print(f"[serve] failed server {args.fail_server} drained after "
              f"{per_server[args.fail_server]} attempts (fault tolerance OK)")
    return servers, router


if __name__ == "__main__":
    main()
