"""Cluster-level QLMIO router with fault tolerance (README.md, Design notes).

The paper's offloading policy doubles as the serving fault-tolerance
mechanism: a dead or straggling server's effective latency explodes, the
health tracker folds that into the latency estimates the router sees, and
traffic drains away.  On top of that:

  * health tracking      — per-server EWMA latency + consecutive-failure
                           count; a server past the failure threshold is
                           excluded until its cooldown expires.
  * hedged requests      — if a dispatched request exceeds
                           ``hedge_factor x`` its predicted latency, a backup
                           dispatch goes to the next-best healthy server and
                           the first finisher wins (straggler mitigation).
  * elastic scaling      — servers can be added/removed between decisions;
                           the router re-reads the table every decision, and
                           the QLMIO state encodes per-server features, so a
                           trained policy generalizes across table sizes.
  * prefix-cache affinity — servers running the paged KV engine
                           (repro_torch/serving/kv_cache.py) keep prompt-prefix
                           blocks resident; an optional per-(task, server)
                           expected-hit-rate predictor shrinks the prefill
                           term of that server's latency estimate, so
                           re-routing a conversation to the server that
                           already holds its prefix scores cheaper.
  * media-aware scoring  — an optional per-(task, server) media predictor
                           (cost_model.best_split) adds each modality's
                           cheapest split-point cost — raw-media vs.
                           compressed-feature uplink bytes plus encode —
                           to that server's latency estimate.

A copy of ``repro/serving/router.py`` (numpy only), so that the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np

from repro_torch.serving.request import ContinuumRequest

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ServerHandle:
    name: str
    model_id: int
    device_id: int
    is_cloud: bool
    # returns (latency_s, success) for a task dispatched now
    execute: Callable[[int], "tuple[float, bool]"]
    # optional live-load probe.  A handle backed by a real ServingEngine
    # (repro_torch/serving/cluster.EngineHandle) returns
    #   {"queue_depth": int,              # queued + admitted + prefilling
    #    "inflight_prefill_tokens": int,  # prompt tokens not yet in cache
    #    "backlog_s": float}              # est. seconds to drain all that
    # so the router can score against the engine's *actual* congestion
    # instead of only its own dispatch bookkeeping (queue_s).
    load: "Callable[[], dict] | None" = None


class SimulatedServer(ServerHandle):
    """Trace-driven handle over MIOBench (used by tests/examples)."""

    def __init__(self, name, bench, class_idx, rng, fail: bool = False):
        self.bench = bench
        self.class_idx = class_idx
        self.rng = rng
        self.fail = fail
        super().__init__(
            name=name,
            model_id=int(bench.model_id[class_idx]),
            device_id=int(bench.device_id[class_idx]),
            is_cloud=class_idx == bench.latency_s.shape[1] - 1,
            execute=self._execute)

    def _execute(self, task: int):
        if self.fail:
            return 240.0, False
        return (float(self.bench.latency_s[task, self.class_idx]),
                bool(self.bench.score[task, self.class_idx] == 1))


class HealthTracker:
    def __init__(self, n: int, *, ewma: float = 0.3, fail_threshold: int = 3,
                 cooldown: float = 30.0):
        self.ewma_lat = np.zeros(n)
        self.fails = np.zeros(n, np.int64)
        self.dead_until = np.zeros(n)
        self.alpha = ewma
        self.fail_threshold = fail_threshold
        self.cooldown = cooldown

    def record(self, server: int, latency: float, ok: bool, now: float):
        self.ewma_lat[server] = ((1 - self.alpha) * self.ewma_lat[server]
                                 + self.alpha * latency)
        if ok:
            self.fails[server] = 0
        else:
            self.fails[server] += 1
            if self.fails[server] >= self.fail_threshold:
                self.dead_until[server] = now + self.cooldown

    def healthy(self, now: float) -> np.ndarray:
        return now >= self.dead_until

    def straggler_factor(self, server: int) -> float:
        """>1 when a server is consistently slower than the fleet median."""
        med = np.median(self.ewma_lat[self.ewma_lat > 0]) if \
            (self.ewma_lat > 0).any() else 0.0
        if med <= 0 or self.ewma_lat[server] <= 0:
            return 1.0
        return float(max(1.0, self.ewma_lat[server] / med))


class QLMIORouter:
    """Quality-latency tradeoff-aware dispatch over live server handles."""

    def __init__(self, servers: "list[ServerHandle]", milp_pred, mgqp_pred,
                 *, quality_weight: float = 1.0, hedge_factor: float = 3.0,
                 policy=None, prefix_hit_pred=None, prefill_pred=None,
                 media_pred=None, migrate_pred=None, spec_pred=None,
                 telemetry=None):
        """milp_pred(task, server) -> seconds; mgqp_pred(task, server) ->
        P(success).  ``policy`` optionally overrides the scoring rule with a
        trained QLMIO agent's argmax.

        ``prefix_hit_pred(task, server) -> [0, 1]`` optionally estimates the
        fraction of the task's prompt already resident in that server's
        paged KV prefix cache, and ``prefill_pred(task, server) -> seconds``
        the prefill share of the MILP estimate; together they discount the
        latency of servers that already hold the conversation's prefix
        (cost_model.latency_s's ``prefix_hit_rate`` term).  Build
        ``prefill_pred`` from ``cost_model.prefill_s(..., prefill_chunk=N)``
        when the target server runs the bucketed/chunked prefill engine, so
        the discount matches the step-function cost it actually pays.

        ``media_pred(task, server) -> seconds`` optionally adds the
        per-modality media cost of dispatching this task to that server —
        typically the *best split point* extra
        (``cost_model.best_split``: edge-encode + compressed-feature
        uplink vs. raw-media uplink + destination encode), so servers
        behind thin links are charged for the bytes the task's media
        actually puts on them.

        ``migrate_pred(task, prefill_server, decode_server) -> seconds``
        optionally prices the *disaggregated* dispatch shape — prefill on
        one server, KV migration over the link, decode on another
        (serving/cluster.Cluster.predict_disagg_e2e_s gives the live
        version) — returning the pair's total predicted latency, or None
        for a KV-incompatible pair.  With it, ``plan`` scores every
        (prefill, decode) pair alongside the pure single-server shapes.

        ``spec_pred(task, draft_server, verify_server) -> seconds``
        optionally prices the *speculative* dispatch shape — the verify
        server runs prefill plus acceptance-discounted multi-token
        verification while ``draft_server``'s device prices the per-tick
        draft steps (serving/cluster.Cluster.predict_spec_e2e_s gives
        the live version, fed by the verify engine's measured acceptance
        rate) — returning the pair's total predicted latency, or None
        when the pair cannot speculate (verify server not speculative,
        or speculation predicted slower than its own plain decode).
        ``draft_server == verify_server`` prices colocated speculation;
        a distinct edge draft server is the paper's edge-drafts/
        cloud-verifies offloading mode.

        ``telemetry`` (repro_torch/serving/telemetry.Telemetry) optionally
        audits every ``dispatch``: the chosen server, its predicted
        latency, every candidate's effective latency, and — this path
        executes synchronously — the measured latency, joined
        immediately.
        """
        self.servers = servers
        self.milp = milp_pred
        self.mgqp = mgqp_pred
        self.w = quality_weight
        self.hedge_factor = hedge_factor
        self.policy = policy
        self.prefix_hit_pred = prefix_hit_pred
        self.prefill_pred = prefill_pred
        self.media_pred = media_pred
        self.migrate_pred = migrate_pred
        self.spec_pred = spec_pred
        self.telemetry = telemetry
        self.health = HealthTracker(len(servers))
        self.queue_s = np.zeros(len(servers))
        self.now = 0.0
        self._last_drain = 0.0
        self.log: list[dict] = []

    # --------------------------------------------------------------- scoring
    def observed_load(self) -> np.ndarray:
        """Per-server engine-reported backlog seconds (0 for handles
        without a ``load`` probe).  Live handles report queue depth and
        in-flight prefill tokens converted to drain time; simulated ones
        report nothing and the router falls back to ``queue_s``."""
        out = np.zeros(len(self.servers))
        for s, h in enumerate(self.servers):
            probe = getattr(h, "load", None)
            if callable(probe):
                obs = probe() or {}
                out[s] = float(obs.get("backlog_s", 0.0))
        return out

    def _effective_latency(self, task: int) -> np.ndarray:
        """Per-server predicted seconds, net of expected prefix-cache hits,
        plus any engine-observed congestion beyond the router's own
        ``queue_s`` bookkeeping.

        ``queue_s`` only tracks work *this* router dispatched; a live
        engine may also be loaded by chunked prefills still in flight or
        by other traffic sources.  For servers exposing a ``load`` probe,
        the excess ``max(backlog_s - queue_s, 0)`` is folded in here, so
        ``_score``'s ``t_hat + queue_s`` totals ``t_hat + max(queue_s,
        backlog_s)`` — observed congestion wins when it is larger, and
        nothing is double-counted when the bookkeeping already covers it.
        """
        n = len(self.servers)
        t_hat = np.array([self.milp(task, s) for s in range(n)])
        if self.media_pred is not None:
            t_hat = t_hat + np.maximum(
                [self.media_pred(task, s) for s in range(n)], 0.0)
        if self.prefix_hit_pred is not None and self.prefill_pred is not None:
            hit = np.clip([self.prefix_hit_pred(task, s) for s in range(n)],
                          0.0, 1.0)
            pre = np.array([self.prefill_pred(task, s) for s in range(n)])
            t_hat = np.maximum(t_hat - hit * pre, 1e-3)
        obs = self.observed_load()
        if obs.any():
            t_hat = t_hat + np.maximum(obs - self.queue_s, 0.0)
        return t_hat

    def _score(self, task: int, t_hat: np.ndarray | None = None) -> np.ndarray:
        n = len(self.servers)
        if t_hat is None:
            t_hat = self._effective_latency(task)
        b_hat = np.array([self.mgqp(task, s) for s in range(n)])
        total = (t_hat + self.queue_s) * np.array(
            [self.health.straggler_factor(s) for s in range(n)])
        # reward-shaped utility: latency ratio + completion bonus (Eq. 21)
        utility = -total / max(total.min(), 1e-6) + self.w * (
            3.0 * b_hat - 2.0)
        utility[~self.health.healthy(self.now)] = -np.inf
        return utility

    def route(self, task: int, t_hat: np.ndarray | None = None) -> int:
        if self.policy is not None:
            a = self.policy(task, self.queue_s, self.health)
            if self.health.healthy(self.now)[a]:
                return a
        u = self._score(task, t_hat)
        best = int(np.argmax(u))
        if not np.isfinite(u[best]):
            # every server is in cooldown: argmax over all -inf would
            # silently pick server 0 — dispatch to the soonest-recovering
            # server instead (min dead_until) and say so
            best = int(np.argmin(self.health.dead_until))
            logger.warning(
                "task %s: all %d servers unhealthy; falling back to "
                "soonest-recovering server %d (%s, recovers at t=%.1fs)",
                task, len(self.servers), best, self.servers[best].name,
                float(self.health.dead_until[best]))
        return best

    def plan(self, task: "int | ContinuumRequest"):
        """Price every dispatch *shape* and return the best: pure
        prefill-and-decode-here for each healthy server, plus — when
        ``migrate_pred`` is given — disaggregated prefill-on-A/
        decode-on-B for every healthy, KV-compatible ordered pair, plus
        — when ``spec_pred`` is given — speculative draft-on-A/
        verify-on-B for every healthy pair (including A == B, colocated
        speculation; a distinct edge A is edge-drafts/cloud-verifies).

        Given a task id, returns the legacy ``{"server": decode server,
        "prefill_server": prefill server or None (pure),
        "draft_server": draft server or None (non-speculative),
        "utility", "predicted_s"}`` dict; a disaggregated winner maps
        onto ``Cluster.submit(server=prefill_server,
        decode_server=server)``.

        Given a typed ``ContinuumRequest`` (its ``task`` field names the
        MIOBench task the predictors score), returns the request
        *annotated* with the decision — ``with_plan(server=...,
        decode_server=..., predicted_s=..., utility=...)`` — ready to
        hand to ``Cluster.submit`` unchanged.

        The completion bonus is judged at the decode server — in a
        KV-compatible fleet both phases run the same model, so quality
        rides with whoever finishes the answer."""
        creq = task if isinstance(task, ContinuumRequest) else None
        if creq is not None:
            task = int(creq.task)
        n = len(self.servers)
        t_eff = self._effective_latency(task)
        healthy = self.health.healthy(self.now)
        strag = np.array([self.health.straggler_factor(s)
                          for s in range(n)])
        b_hat = np.array([self.mgqp(task, s) for s in range(n)])
        # (total_s, decode_server, prefill_server-or-None,
        #  draft_server-or-None) per shape
        shapes = [((t_eff[s] + self.queue_s[s]) * strag[s], s, None, None)
                  for s in range(n) if healthy[s]]
        if self.migrate_pred is not None:
            for sp in range(n):
                for sd in range(n):
                    if sp == sd or not (healthy[sp] and healthy[sd]):
                        continue
                    t = self.migrate_pred(task, sp, sd)
                    if t is None:  # KV-incompatible pair
                        continue
                    # both servers are busy for (parts of) the request;
                    # charge the worse backlog and the worse straggler
                    total = ((t + max(self.queue_s[sp], self.queue_s[sd]))
                             * max(strag[sp], strag[sd]))
                    shapes.append((total, sd, sp, None))
        if self.spec_pred is not None:
            for sa in range(n):  # draft server (may equal the verifier)
                for sv in range(n):  # verify/decode server
                    if not (healthy[sa] and healthy[sv]):
                        continue
                    t = self.spec_pred(task, sa, sv)
                    if t is None:  # pair cannot (profitably) speculate
                        continue
                    total = ((t + max(self.queue_s[sa], self.queue_s[sv]))
                             * max(strag[sa], strag[sv]))
                    shapes.append((total, sv, None, sa))
        if not shapes:  # every server in cooldown: mirror route()
            best = int(np.argmin(self.health.dead_until))
            logger.warning(
                "task %s: all %d servers unhealthy; plan falls back to "
                "soonest-recovering server %d (%s)", task, n, best,
                self.servers[best].name)
            if creq is not None:
                return creq.with_plan(server=best, decode_server=None,
                                      predicted_s=float("inf"),
                                      utility=float("-inf"))
            return {"server": best, "prefill_server": None,
                    "draft_server": None,
                    "utility": -np.inf, "predicted_s": float("inf")}
        norm = max(min(t for t, _, _, _ in shapes), 1e-6)
        utility = lambda e: -e[0] / norm + self.w * (3.0 * b_hat[e[1]] - 2.0)
        best = max(shapes, key=utility)
        total, decode_s, prefill_s, draft_s = best
        if creq is not None:
            # disaggregated shape: Cluster.submit prefills on ``server``
            # and decodes on ``decode_server`` — map accordingly
            if prefill_s is None:
                return creq.with_plan(server=decode_s, decode_server=None,
                                      draft_server=draft_s,
                                      predicted_s=float(total),
                                      utility=float(utility(best)))
            return creq.with_plan(server=prefill_s, decode_server=decode_s,
                                  draft_server=draft_s,
                                  predicted_s=float(total),
                                  utility=float(utility(best)))
        return {"server": decode_s, "prefill_server": prefill_s,
                "draft_server": draft_s,
                "utility": float(utility(best)),
                "predicted_s": float(total)}

    # -------------------------------------------------------------- dispatch
    def _drain_queues(self):
        """Work completes as wall-clock advances: shrink every server's
        backlog by the time elapsed since the last dispatch.  Without this,
        ``queue_s`` only ever grows and long runs mispredict every server
        as saturated."""
        elapsed = self.now - self._last_drain
        if elapsed > 0:
            self.queue_s = np.maximum(0.0, self.queue_s - elapsed)
        self._last_drain = self.now

    def dispatch(self, task: int) -> dict:
        self._drain_queues()
        t_eff = self._effective_latency(task)  # evaluated once per dispatch
        s = self.route(task, t_eff)
        lat, ok = self.servers[s].execute(task)
        predicted = t_eff[s] + self.queue_s[s]
        hedged = False
        if lat > self.hedge_factor * max(predicted, 0.25):
            # straggler: hedge to the next-best healthy server.  Both
            # servers executed the task, so the loser's work is charged to
            # its queue_s too — only the winner's latency reaches the
            # caller, but backlog accounting must cover both dispatches.
            u = self._score(task, t_eff)
            u[s] = -np.inf
            s2 = int(np.argmax(u))
            if s2 != s and np.isfinite(u[s2]):  # a healthy backup exists
                lat2, ok2 = self.servers[s2].execute(task)
                if self.queue_s[s2] + lat2 < self.queue_s[s] + lat:
                    self.health.record(s, lat, False, self.now)
                    self.queue_s[s] += lat  # losing original did the work
                    s, lat, ok, hedged = s2, lat2, ok2, True
                else:
                    self.queue_s[s2] += lat2  # losing hedge did the work
        total = lat + self.queue_s[s]
        if self.telemetry is not None:
            uid = self.telemetry.record_dispatch(
                task=task, server=s, t=self.now,
                predicted_s=t_eff[s] + self.queue_s[s],
                terms={"queue": float(self.queue_s[s]),
                       "latency": float(t_eff[s])},
                candidates=list(t_eff + self.queue_s))
            self.telemetry.join_measured(uid, total, completed=ok)
        self.queue_s[s] += lat
        self.health.record(s, lat, ok, self.now)
        self.now += 0.1
        rec = {"task": task, "server": s, "latency": total, "ok": ok,
               "hedged": hedged}
        self.log.append(rec)
        return rec

    # --------------------------------------------------------------- elastic
    def add_server(self, handle: ServerHandle):
        self.servers.append(handle)
        self.queue_s = np.append(self.queue_s, 0.0)
        h = HealthTracker(len(self.servers))
        h.ewma_lat[:-1] = self.health.ewma_lat
        h.fails[:-1] = self.health.fails
        h.dead_until[:-1] = self.health.dead_until
        self.health = h

    def remove_server(self, idx: int):
        del self.servers[idx]
        self.queue_s = np.delete(self.queue_s, idx)
        for arr_name in ("ewma_lat", "fails", "dead_until"):
            setattr(self.health, arr_name,
                    np.delete(getattr(self.health, arr_name), idx))
