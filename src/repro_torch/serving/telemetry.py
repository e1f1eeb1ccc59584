"""Continuum telemetry: request tracing, metrics registry, dispatch audit.

The paper's central difficulty is that generation quality and inference
latency are *highly difficult to predict* for MLLM offloading — but the
harness used to report only end-of-run aggregates, so there was no way to
see where a request's virtual seconds went, why the router picked a
server, or how wrong the dispatch-time latency prediction was.  This
module is the shared observability substrate for the serving stack:

  * ``Tracer``          — per-request lifecycle spans
    (uplink→queue→prefill→decode→downlink, plus per-chunk prefill spans,
    engine ticks and media-encode transfers), recorded against whatever
    clock the engine runs on — wall time for a standalone
    ``ServingEngine``, the shared **virtual clock** for the continuum
    replay harness — so live and replayed runs produce comparable traces.
    Export is Chrome trace-event JSON (``Telemetry.export``): open the
    file in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
    One *process* per engine, one *thread row* per request uid.
  * ``MetricsRegistry`` — counters / gauges / histograms replacing the
    scattered ad-hoc stats dicts: every ``ServingEngine`` owns one, and
    ``latency_stats()`` / ``stats()`` are thin views over it.  ``view``
    registers zero-cost callback metrics (KV pool occupancy, XLA trace
    counts) evaluated only at snapshot time.
  * dispatch audit      — one ``DispatchRecord`` per routed request with
    the predicted end-to-end latency and its per-term breakdown (queue,
    prefill, decode, media, link) plus every candidate server's score;
    ``join_measured`` patches in the measured e2e when the request
    finishes, making the paper's "latency is hard to predict" claim a
    measured, regression-gated number (``prediction_error``).

Zero-cost-when-off contract: components accept ``telemetry=None`` and
guard every tracing site behind a single attribute check; with tracing
disabled no span/event objects are allocated on the decode hot path.
``Telemetry(trace=False)`` keeps the metrics registry and the dispatch
audit live (both are O(1) per *request*, not per tick) while recording no
trace events at all.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

# ---------------------------------------------------------------- metrics


class Counter:
    """Monotonic int counter (``inc``); cheap enough for per-tick paths."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = v


class Histogram:
    """Value-retaining histogram: keeps raw observations so percentiles
    are exact and per-tier rollups can merge raw samples."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: list[float] = []

    def observe(self, v: float):
        self.values.append(v)

    def extend(self, vs):
        self.values.extend(vs)

    @property
    def count(self) -> int:
        return len(self.values)

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.values, q)) if self.values else 0.0

    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean(),
                "p50": self.percentile(50), "p95": self.percentile(95)}


class MetricsRegistry:
    """Named counters/gauges/histograms plus callback views.

    ``view(name, fn)`` registers a zero-storage metric evaluated only at
    ``snapshot()`` time — used for values another subsystem already
    tracks (KV pool occupancy, XLA cache sizes), so hot paths pay
    nothing.  ``reset()`` zeroes the stored metrics but keeps the view
    registrations (their backing state has its own lifecycle).
    """

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.views: dict[str, "callable"] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    def view(self, name: str, fn):
        self.views[name] = fn

    def reset(self):
        for c in self.counters.values():
            c.value = 0
        for g in self.gauges.values():
            g.value = 0.0
        for h in self.histograms.values():
            h.values.clear()

    def snapshot(self) -> dict:
        """Plain-value dict: counters/gauges as scalars, histograms as
        summary dicts, views evaluated now."""
        out: dict = {n: c.value for n, c in self.counters.items()}
        out.update((n, g.value) for n, g in self.gauges.items())
        out.update((n, h.summary()) for n, h in self.histograms.items())
        out.update((n, fn()) for n, fn in self.views.items())
        return out


def latency_summary(ttft, itl, e2e) -> dict:
    """The engine's historical ``latency_stats()`` shape, computed from
    raw samples — shared by the per-engine view and the per-tier rollups
    (``Cluster.latency_stats``)."""
    pct = lambda xs, q: float(np.percentile(xs, q)) if len(xs) else 0.0
    return {"n_requests": len(e2e),
            "ttft_p50_s": pct(ttft, 50), "ttft_p95_s": pct(ttft, 95),
            "itl_p50_s": pct(itl, 50), "itl_p95_s": pct(itl, 95),
            "e2e_p50_s": pct(e2e, 50), "e2e_p95_s": pct(e2e, 95),
            "e2e_mean_s": float(np.mean(e2e)) if len(e2e) else 0.0}


# ----------------------------------------------------------------- tracer

_US = 1e6  # chrome trace-event timestamps are microseconds


class Tracer:
    """Chrome-trace-event recorder against caller-supplied timestamps.

    Callers pass explicit ``t0``/``t1`` seconds from *their* clock (wall
    or virtual), so the tracer itself never reads time — replayed runs
    are bit-deterministic.  ``enabled=False`` turns every record call
    into an immediate return; hot paths should additionally skip the call
    entirely (bind the tracer to a local, check once per tick).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: list[dict] = []
        self._pids: dict[str, int] = {}

    def process(self, name: str) -> int:
        """Stable pid for a named event source (engine/handle/cluster);
        registering is idempotent and metadata is emitted at export."""
        pid = self._pids.get(name)
        if pid is None:
            pid = self._pids[name] = len(self._pids) + 1
        return pid

    def span(self, name: str, cat: str, t0: float, t1: float, *,
             pid: int = 0, tid: int = 0, args: dict | None = None):
        """Complete event ("X") covering ``[t0, t1]`` seconds."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X", "pid": pid, "tid": tid,
              "ts": t0 * _US, "dur": max(t1 - t0, 0.0) * _US}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, cat: str, t: float, *, pid: int = 0,
                tid: int = 0, args: dict | None = None):
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t", "pid": pid,
              "tid": tid, "ts": t * _US}
        if args is not None:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, t: float, values: dict, *, pid: int = 0):
        """Counter sample ("C"): Perfetto renders a stacked timeline —
        used for batch occupancy and KV-pool occupancy per tick."""
        if not self.enabled:
            return
        self.events.append({"name": name, "cat": "counter", "ph": "C",
                            "pid": pid, "tid": 0, "ts": t * _US,
                            "args": values})

    def clear(self):
        """Drop recorded events; process registrations survive (the
        fleet does not change between replays)."""
        self.events.clear()

    def chrome_events(self) -> list[dict]:
        """Events plus process/thread metadata, ready for Perfetto."""
        meta = []
        for name, pid in self._pids.items():
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": name}})
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": "engine"}})
        return meta + self.events


# ---------------------------------------------------------- dispatch audit


@dataclasses.dataclass
class DispatchRecord:
    """One routed request: what the router predicted vs. what happened."""

    uid: int
    task: int
    server: int
    t_dispatch_s: float
    predicted_s: float  # predicted end-to-end seconds for the chosen server
    # per-term breakdown of ``predicted_s``: queue / prefill / decode /
    # media / link (whichever the caller can decompose)
    terms: dict = dataclasses.field(default_factory=dict)
    candidates: "list[float] | None" = None  # per-server predicted totals
    policy_est_s: "float | None" = None  # the policy's own estimate, if any
    measured_e2e_s: "float | None" = None  # joined at finalize
    completed: bool = False  # False until joined; timeouts stay False


class Telemetry:
    """Facade bundling one ``Tracer``, the dispatch audit, and the
    metrics registries of every engine that attached itself.

    ``trace=False`` keeps metrics + audit live but records no trace
    events (the per-tick hot path then stays allocation-free).
    """

    def __init__(self, trace: bool = True):
        self.tracer = Tracer(enabled=trace)
        self.registries: dict[str, MetricsRegistry] = {}
        self._audit: dict[int, DispatchRecord] = {}
        self._auto_uid = 0

    # ------------------------------------------------------------ metrics
    def register_metrics(self, name: str, registry: MetricsRegistry):
        self.registries[name] = registry

    # -------------------------------------------------------------- audit
    def record_dispatch(self, *, task: int, server: int, t: float,
                        predicted_s: float, uid: "int | None" = None,
                        terms: dict | None = None, candidates=None,
                        policy_est_s: "float | None" = None) -> int:
        """Audit one dispatch decision; returns the record's uid.  Pass
        the cluster request uid when there is one (``Cluster.collect``
        joins measured latencies by it); synchronous callers (the legacy
        router path) omit it and join immediately under an auto uid."""
        if uid is None:
            self._auto_uid -= 1  # negatives: disjoint from cluster uids
            uid = self._auto_uid
        self._audit[uid] = DispatchRecord(
            uid=uid, task=int(task), server=int(server),
            t_dispatch_s=float(t), predicted_s=float(predicted_s),
            terms={k: float(v) for k, v in (terms or {}).items()},
            candidates=(None if candidates is None
                        else [float(c) for c in candidates]),
            policy_est_s=(None if policy_est_s is None
                          else float(policy_est_s)))
        return uid

    def join_measured(self, uid: int, e2e_s: float, *,
                      completed: bool = True):
        """Patch the measured end-to-end latency into a dispatch record
        (no-op for uids this telemetry never audited)."""
        rec = self._audit.get(uid)
        if rec is not None:
            rec.measured_e2e_s = float(e2e_s)
            rec.completed = bool(completed)

    def audit_records(self) -> "list[DispatchRecord]":
        return [self._audit[uid] for uid in sorted(self._audit)]

    def prediction_error(self) -> dict:
        """Cost-model calibration over completed requests: percentiles of
        the absolute per-request e2e prediction error, in percent of the
        measured latency.  Timeout/never-finished requests are excluded
        (their sentinel latency would measure the timeout horizon, not
        the model)."""
        pairs = [(r.predicted_s, r.measured_e2e_s)
                 for r in self._audit.values()
                 if r.completed and r.measured_e2e_s]
        if not pairs:
            return {"n": 0, "mean_abs_pct_err": 0.0, "p50_abs_pct_err": 0.0,
                    "p95_abs_pct_err": 0.0, "mean_signed_pct_err": 0.0}
        pred, meas = np.array(pairs).T
        pct = 100.0 * (pred - meas) / np.maximum(meas, 1e-9)
        return {"n": len(pairs),
                "mean_abs_pct_err": float(np.mean(np.abs(pct))),
                "p50_abs_pct_err": float(np.percentile(np.abs(pct), 50)),
                "p95_abs_pct_err": float(np.percentile(np.abs(pct), 95)),
                "mean_signed_pct_err": float(np.mean(pct))}

    # ---------------------------------------------------------- lifecycle
    def reset(self):
        """Per-replay reset: drop trace events and audit records.  Engine
        registries are reset by their owners (``Cluster.reset``)."""
        self.tracer.clear()
        self._audit.clear()
        self._auto_uid = 0

    def to_json(self) -> dict:
        """Chrome-trace JSON with the audit + metrics riding along as
        extra top-level keys (Perfetto ignores them)."""
        return {"traceEvents": self.tracer.chrome_events(),
                "displayTimeUnit": "ms",
                "metrics": {n: r.snapshot()
                            for n, r in self.registries.items()},
                "audit": [dataclasses.asdict(r)
                          for r in self.audit_records()],
                "prediction_error": self.prediction_error()}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path
