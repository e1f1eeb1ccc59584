"""Discrete-event cloud-edge continuum replay harness (port of
``repro/serving/cluster.py``; the live engines run on the card).

The offloading half of this repo (QLMIO router, CEMLLM-Sim episodes) used
to execute tasks against closed-form cost-model stubs; the serving half
(paged-KV + chunked-prefill ``ServingEngine``) was never in the decision
loop.  This module joins them: each ``EngineHandle`` wraps a **live**
``ServingEngine`` (small/fast reduced config for edge nodes, larger config
for the cloud tier) behind the network link of a quarantined
``DeviceProfile``, and a ``Cluster`` replays MIOBench arrival traces
against the fleet under a shared **virtual clock**:

  * the policy (QLMIO scoring, MILP/MGQP/greedy/all-cloud baselines via
    ``run_policy``) picks a server per task;
  * the harness ``submit()``s the request to that server's engine with the
    uplink delay applied, then advances every engine tick-by-tick;
  * one engine tick costs ``decode_tick_s`` virtual seconds (the roofline
    per-token decode time of the profiled hardware) plus
    ``prefill_tok_s`` per prompt token (computed + padding) the tick's
    chunked prefill actually ran — the engine generates *real* tokens
    while the clock charges the *profiled* device;
  * TTFT / ITL / e2e come from ``ServingEngine.latency_stats()`` in
    virtual-clock seconds (the engine's ``clock`` hook), and quality comes
    from the MIOBench success predictors, replacing
    ``SimulatedServer._execute``'s closed-form latency.

Multimodal requests ride the same harness: ``Cluster.submit`` accepts
typed segments (repro_torch/serving/segments.py) and a ``media_delay_s``
charge, and ``EngineHandle.split_point`` answers the per-request *split-point*
question — ship raw media and encode at this server, or encode on the
source edge device and ship keep-top-k-compressed features — from the
cost model's per-modality uplink/encode rooflines
(``cost_model.best_split``).

``EngineBackend`` plugs the harness into ``sim.cemllm.Episode`` with the
same interface as ``CostModelBackend``: dispatch-time estimates are the
cost-model numbers (so a deterministic policy takes identical decisions
under either backend), and ``drain()`` patches the episode records with
measured latencies once every engine has drained.

Observability (repro_torch/serving/telemetry.py): pass ``telemetry=`` to
``build_continuum``/``Cluster`` to record uplink/media-encode/downlink
transfer spans, per-engine tick spans with true virtual durations, and a
dispatch audit — each routed request's predicted e2e with per-term
breakdown (``EngineHandle.predict_e2e_s``), joined with the measured e2e
at ``collect()`` so ``Telemetry.prediction_error`` reports cost-model
calibration.  ``Cluster.reset`` also resets every engine's metrics
registry, so per-replay stats stay independent.

Port notes.  A live handle's weights are the port's seeded init
(``Model.init(seed, device=...)``), which draws other numbers than
``jax.random``; ``EngineHandle(params=...)`` takes given weights instead
(the parity tests pass the JAX package's, converted), ``config=`` an
``ArchConfig`` in place of ``reduced(get_config(arch))`` (full width on
the card), and ``torch_device=`` where the engine runs (None = the CUDA
card; ``device`` stays the profiled hardware the virtual clock charges).
Tensor-parallel handles (``tp > 1``) are not ported (ROADMAP queue 1
item 12).  Every latency the harness reports is virtual: the engines'
``clock`` reads the handle's ``vtime``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import warnings
from collections import deque

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.models.api import build_model
from repro_torch.serving.engine import Request, ServingEngine, _PrefillTask
from repro_torch.serving.kv_cache import ceil_blocks
from repro_torch.serving.request import ContinuumRequest, StreamEvent
from repro_torch.serving.router import ServerHandle
from repro_torch.serving.telemetry import MetricsRegistry, latency_summary
from repro_torch.sim import cost_model as cm
from repro_torch.sim.cemllm import CostModelBackend
from repro_torch.sim.miobench import SERVER_CLASSES

# live-engine arch per MIOBench server class (SERVER_CLASSES order):
# edge tiers run the small/fast config, the cloud tier a larger one.
CLASS_ARCHS = ["qwen2-0.5b", "qwen2-0.5b", "llama3.2-3b"]


class SimEngine:
    """Analytic drop-in for ``ServingEngine`` at fleet scale.

    A 100+ engine replay cannot afford 100 model builds,
    and does not need them: the continuum harness charges virtual time
    from *counters* (decode ticks, prefill tokens computed), not from
    the numerical content of the tokens.  This class implements exactly
    the surface ``EngineHandle``/``Cluster``/``QLMIORouter._load`` read —
    queue/slots/prefill_tasks/budget, ``submit``/``step``/``busy``, the
    same metrics-registry counter names, streaming emission, and a
    page-granular prefix cache — while generating deterministic
    hash-derived tokens in plain Python.  ``paged`` is False, so
    ``kv_compatible`` correctly reports sim engines as non-migratable.

    Fidelity scope: chunked prefill under a per-tick token budget, one
    decode token per slot per tick, continuous batching, prefix reuse at
    ``page_size`` granularity.  Not modeled: KV pool pressure (admission
    never blocks on pages), bucketed-shape padding, KV snapshots.
    """

    def __init__(self, vocab: int, *, max_batch: int = 4,
                 max_seq: int = 256, eos_id: "int | None" = None,
                 prefill_chunk: int = 64,
                 prefill_budget: "int | None" = None,
                 page_size: int = 16, prefix_caching: bool = True,
                 clock=None, telemetry=None, trace_name: str = "sim"):
        self.vocab = vocab
        self._now = clock if clock is not None else (lambda: float(self.ticks))
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.paged = False
        self.kv_dtype = "bf16"
        self.chunked = prefill_chunk > 0
        self.prefill_chunk = max(prefill_chunk, 1)
        self.prefill_budget = (prefill_budget if prefill_budget is not None
                               else 2 * self.prefill_chunk)
        self.bucketing = False
        self.min_bucket = 1
        self.page_size = page_size
        self.prefix_caching = prefix_caching
        self._prefixes: set = set()  # hashes of page-aligned prompt prefixes
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * max_batch
        self.prefill_tasks: list[_PrefillTask | None] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int64)
        self.budget = np.zeros(max_batch, np.int64)
        self.ticks = 0
        self.finished: list[Request] = []
        self.telemetry = telemetry
        self.metrics = m = MetricsRegistry()
        self._c_prefill_computed = m.counter("prefill_tokens_computed")
        self._c_prefill_padded = m.counter("prefill_tokens_padded")
        self._c_prefix_reused = m.counter("prefix_tokens_reused")
        self._c_submitted = m.counter("requests_submitted")
        self._c_finished = m.counter("requests_finished")
        self._c_decode_tokens = m.counter("decode_tokens")
        self._c_stream_tokens = m.counter("stream_tokens")
        self._h_ttft = m.histogram("ttft_s")
        self._h_itl = m.histogram("itl_s")
        self._h_e2e = m.histogram("e2e_s")
        self._h_queue = m.histogram("queue_s")
        self._g_queue_depth = m.gauge("queue_depth")
        m.view("ticks", lambda: self.ticks)
        tr = telemetry.tracer if telemetry is not None else None
        self._tr = tr if (tr is not None and tr.enabled) else None
        self._pid = self._tr.process(trace_name) if self._tr else 0
        if telemetry is not None:
            telemetry.register_metrics(trace_name, m)
        self._auto_uid = 1_000_000_000

    # -- back-compat attribute accessors (EngineHandle tick charging)
    @property
    def prefill_tokens_computed(self) -> int:
        return self._c_prefill_computed.value

    @property
    def prefill_tokens_padded(self) -> int:
        return self._c_prefill_padded.value

    # ------------------------------------------------------------ intake
    def make_request(self, creq: ContinuumRequest,
                     uid: "int | None" = None) -> Request:
        if uid is None:
            self._auto_uid += 1
            uid = self._auto_uid
        tokens = (None if creq.tokens is None
                  else np.asarray(creq.tokens, np.int32))
        return Request(uid, tokens, max_new_tokens=int(creq.max_new_tokens),
                       extra=creq.extra, segments=creq.segments,
                       stream=creq.stream if callable(creq.stream) else None)

    def submit(self, req: "Request | ContinuumRequest") -> Request:
        if isinstance(req, ContinuumRequest):
            req = self.make_request(req)
        if req.tokens is None or len(req.tokens) < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if len(req.tokens) > self.max_seq - 1:
            raise ValueError(
                f"request {req.uid}: prompt of {len(req.tokens)} tokens "
                f"exceeds max_seq={self.max_seq} - 1")
        if not req.token_times:
            req.t_submit = self._now()
        self._c_submitted.inc()
        if self._tr is not None:
            self._tr.instant("submit", "lifecycle", req.t_submit,
                             pid=self._pid, tid=req.uid)
        self.queue.append(req)
        return req

    def busy(self) -> bool:
        return bool(self.queue or any(s is not None for s in self.slots)
                    or any(t is not None for t in self.prefill_tasks))

    # ------------------------------------------------------------ serving
    def _token(self, req: Request) -> int:
        """Deterministic hash-derived next token (seeded by uid + index,
        independent of which engine decodes — so a replay is bit-identical
        across routing policies and fleet layouts)."""
        i = len(req.output)
        return int((req.uid * 7919 + i * 104729 + 12345) % self.vocab)

    def _prefix_reuse(self, toks: np.ndarray) -> int:
        """Longest cached page-aligned prefix (capped at T-1, like the
        paged engine: the last token is always recomputed)."""
        if not self.prefix_caching:
            return 0
        T = len(toks)
        k = ((T - 1) // self.page_size) * self.page_size
        while k > 0:
            if hash(toks[:k].tobytes()) in self._prefixes:
                return k
            k -= self.page_size
        return 0

    def _register_prefix(self, toks: np.ndarray, upto: int):
        if not self.prefix_caching:
            return
        for k in range(self.page_size, upto + 1, self.page_size):
            self._prefixes.add(hash(toks[:k].tobytes()))

    def _emit(self, req: Request, tok: int, t: float, final: bool):
        idx = len(req.output) - 1
        if idx == 0 and self._tr is not None:
            self._tr.instant("first_token", "lifecycle", t,
                             pid=self._pid, tid=req.uid)
        if req.stream is None:
            return
        self._c_stream_tokens.inc()
        req.stream(StreamEvent(uid=req.uid, index=idx, token=tok, t_emit=t,
                               first=idx == 0, final=final))

    def _finish(self, req: Request):
        req.done = True
        self.finished.append(req)
        self._c_finished.inc()
        tt = req.token_times
        ta = req.t_admit if req.t_admit >= req.t_submit else req.t_submit
        self._h_queue.observe(ta - req.t_submit)
        self._h_ttft.observe(tt[0] - req.t_submit)
        self._h_e2e.observe(tt[-1] - req.t_submit)
        if len(tt) > 1:
            self._h_itl.extend(b - a for a, b in zip(tt, tt[1:]))
        if self._tr is not None:
            pid, tid = self._pid, req.uid
            self._tr.span("queue", "lifecycle", req.t_submit, ta,
                          pid=pid, tid=tid)
            self._tr.span("prefill", "lifecycle", ta, tt[0], pid=pid,
                          tid=tid, args={"prompt_tokens": len(req.tokens)})
            self._tr.span("decode", "lifecycle", tt[0], tt[-1], pid=pid,
                          tid=tid, args={"new_tokens": len(req.output)})

    def _activate(self, slot: int, req: Request):
        tok = self._token(req)
        req.output.append(tok)
        req.token_times.append(self._now())
        ends = (req.max_new_tokens <= 1
                or (self.eos_id is not None and tok == self.eos_id))
        self._emit(req, tok, req.token_times[-1], ends)
        if ends:
            self._finish(req)
            return
        self.slots[slot] = req
        self.pos[slot] = len(req.tokens)
        self.budget[slot] = req.max_new_tokens - 1

    def step(self) -> int:
        """One engine tick, same contract as ``ServingEngine.step``: spend
        the prefill budget (admitting queued requests into free slots),
        then one decode token for every fully-prefilled slot."""
        budget = self.prefill_budget
        while budget > 0:
            progressed = False
            if self.queue:
                free = next((i for i in range(self.max_batch)
                             if self.slots[i] is None
                             and self.prefill_tasks[i] is None), None)
                if free is not None:
                    req = self.queue.popleft()
                    req.t_admit = self._now()
                    toks = np.asarray(req.tokens)
                    reuse = self._prefix_reuse(toks)
                    self._c_prefix_reused.inc(reuse)
                    self.prefill_tasks[free] = _PrefillTask(
                        req, done=reuse, reused=reuse)
                    progressed = True
            for slot in range(self.max_batch):
                if budget <= 0:
                    break
                task = self.prefill_tasks[slot]
                if task is None:
                    continue
                T = len(task.req.tokens)
                n = min(self.prefill_chunk, T - task.done, budget)
                task.done += n
                budget -= n
                self._c_prefill_computed.inc(n)
                progressed = True
                if task.done >= T:
                    toks = np.asarray(task.req.tokens)
                    self._register_prefix(
                        toks, ((T // self.page_size) * self.page_size))
                    self.prefill_tasks[slot] = None
                    self._activate(slot, task.req)
            if not progressed:
                break
        self._g_queue_depth.set(len(self.queue))
        active = [i for i, r in enumerate(self.slots) if r is not None]
        n_prefilling = sum(t is not None for t in self.prefill_tasks)
        if self._tr is not None:
            self._tr.counter("queue_depth", self._now(),
                             {"queued": len(self.queue),
                              "active": len(active) + n_prefilling},
                             pid=self._pid)
        if not active:
            if n_prefilling:
                self.ticks += 1
            return n_prefilling
        self.ticks += 1
        self._c_decode_tokens.inc(len(active))
        t_now = self._now()
        for i in active:
            req = self.slots[i]
            tok = self._token(req)
            req.output.append(tok)
            req.token_times.append(t_now)
            self.pos[i] += 1
            self.budget[i] -= 1
            ends = bool(self.budget[i] <= 0 or tok == self.eos_id
                        or self.pos[i] >= self.max_seq - 1)
            self._emit(req, tok, t_now, ends)
            if ends:
                self._finish(req)
                self.slots[i] = None
                self.pos[i] = 0
        return len(active) + n_prefilling

    def run_until_drained(self, max_ticks: int = 10_000,
                          keep_finished: bool = False):
        deadline = self.ticks + max_ticks
        while self.busy():
            self.step()
            if self.ticks > deadline:
                raise RuntimeError("engine did not drain")
        if keep_finished:
            return list(self.finished)
        out, self.finished = self.finished, []
        return out

    def reset_prefix_cache(self):
        if self.busy():
            raise RuntimeError("reset_prefix_cache needs an idle engine")
        self._prefixes.clear()

    # -------------------------------------------------------------- stats
    def latency_stats(self) -> dict:
        """Alias for ``stats()["latency"]`` (same contract as
        ``ServingEngine.latency_stats``)."""
        return latency_summary(self._h_ttft.values, self._h_itl.values,
                               self._h_e2e.values)

    def stats(self) -> dict:
        out = {"paged": False, "kv_dtype": self.kv_dtype,
               "bucketed": False, "chunked": self.chunked, "sim": True}
        out.update(self.metrics.snapshot())
        out["latency"] = self.latency_stats()
        return out


class EngineHandle(ServerHandle):
    """One continuum server: a live ``ServingEngine`` under a virtual clock.

    The engine's ``clock`` hook reads ``self.vtime``, so every request
    timestamp (``t_submit`` / ``token_times``) — and therefore
    ``latency_stats()`` — is in virtual seconds.  Doubles as a plain
    ``ServerHandle``: ``execute`` runs one task synchronously (legacy
    router path) and ``load`` reports live queue depth, in-flight prefill
    tokens and estimated drain time for the router's scoring.
    """

    def __init__(self, name: str, arch: str, device: cm.DeviceProfile,
                 profile: cm.ModelProfile, *, is_cloud: bool = False,
                 seed: int = 0, max_batch: int = 2, max_seq: int = 96,
                 time_scale: float = 1.0, payload_bytes: float | None = None,
                 kv_dtype: str | None = None, fail: bool = False,
                 draft_profile: "cm.ModelProfile | None" = None,
                 draft_device: "cm.DeviceProfile | None" = None,
                 spec_k: int = 3, tp: int = 1,
                 telemetry=None, backend: str = "live", params=None,
                 config=None, torch_device=None, **engine_kw):
        """``draft_profile`` turns on speculative decoding for this
        handle: the live engine drafts with a small same-arch model and
        verifies with the paged multi-token kernel, while the virtual
        clock charges ``cost_model.speculative_tick_s`` — ``spec_k``
        draft steps priced as ``draft_profile`` on ``draft_device``
        (None = colocated on this handle's device; an edge device here
        is the edge-drafts/cloud-verifies offloading shape, where only
        token ids ride the uplink) plus one multi-token verify pass of
        this handle's own profile.  Live backend only.

        ``tp`` is the handle's tensor-parallel mesh width, a continuum
        routing axis: the tick costs switch to the cost model's TP
        rooflines (bytes and FLOPs divided by ``tp`` plus the per-layer
        collective term on ``ici_bw``), so the router prices mesh width
        like every other knob.  A live engine over a ``tp``-wide mesh is
        not ported (ROADMAP queue 1 item 12): the sim backend prices it.

        ``torch_device`` — where the live engine runs (``device`` is the
        profiled hardware the clock charges); None means the CUDA card.
        ``params`` — the live engine's weights, on that device (default:
        the seeded init ``Model.init(seed)`` drawn there).  ``config`` —
        the ``ArchConfig`` to serve (default ``reduced(get_config(arch))``).
        """
        cfg = reduced(get_config(arch)) if config is None else config
        self.cfg = cfg
        self.backend = backend
        self.tp = tp
        self.vtime = 0.0
        self.time_scale = time_scale
        self.draft_profile = draft_profile
        self.draft_device = draft_device if draft_device is not None \
            else device
        if draft_profile is not None:
            if backend != "live":
                raise ValueError(
                    "speculative decoding (draft_profile=...) needs the "
                    "live engine backend")
            engine_kw.setdefault("draft_config", cfg)
            engine_kw.setdefault("spec_k", spec_k)
        # KV precision is itself an offloading decision: edge tiers
        # default to the int8 page pool (half the decode KV stream, ~2x
        # the page budget per HBM byte — what makes the weak tiers worth
        # routing to), the cloud tier keeps bf16.  The profiled tick cost
        # below prices the choice, so the router sees it through every
        # backlog/latency estimate.  Quantized pages need the paged
        # backend, so recurrent/hybrid archs (dense cache) stay bf16.
        if backend == "sim":
            # fleet-scale analytic engine: no weights, no model — the tick
            # *costs* below still come from the profiled roofline, so the
            # router sees the same continuum either way
            if kv_dtype is None:
                kv_dtype = "bf16" if is_cloud else "int8"
            self.kv_dtype = kv_dtype
            self.engine = SimEngine(cfg.vocab, max_batch=max_batch,
                                    max_seq=max_seq,
                                    clock=lambda: self.vtime,
                                    telemetry=telemetry, trace_name=name,
                                    **engine_kw)
            self.engine.kv_dtype = kv_dtype
        elif backend == "live":
            if tp > 1:
                raise NotImplementedError(
                    "a live engine over a tensor-parallel mesh (tp > 1) is "
                    "not ported to repro_torch yet (ROADMAP queue 1 item 12)")
            model = build_model(cfg)
            if params is None:
                params = model.init(seed, device=torch_device)
            if kv_dtype is None:
                kv_dtype = ("int8" if model.supports_paged and not is_cloud
                            else "bf16")
            self.kv_dtype = kv_dtype
            if draft_profile is not None:
                # default draft weights = the target's own (the reduced
                # live config is the "small" model already); acceptance
                # is whatever the two numerical paths agree on, and the
                # emitted stream is bit-identical regardless
                engine_kw.setdefault("draft_params", params)
            self.engine = ServingEngine(model, params, max_batch=max_batch,
                                        max_seq=max_seq, kv_dtype=kv_dtype,
                                        clock=lambda: self.vtime,
                                        telemetry=telemetry, trace_name=name,
                                        device=torch_device, **engine_kw)
        else:
            raise ValueError(f"unknown backend {backend!r} "
                             "(expected 'live' or 'sim')")
        self.telemetry = telemetry
        tr = telemetry.tracer if telemetry is not None else None
        self._tr = tr if (tr is not None and tr.enabled) else None
        self._pid = self._tr.process(name) if self._tr else 0
        self.device = device
        self.profile = profile
        eff = device.flops * cm._EFF
        bw = device.mem_bw * cm._EFF
        # per-tick decode roofline: active weights + the resident KV
        # context (nominal half-full sequences) at this tier's precision
        kv_stream = cm.kv_bytes_per_token(profile, kv_dtype) * (max_seq / 2)
        self.decode_tick_s = (time_scale * (profile.n_active
                                            * profile.bytes_per_param
                                            + kv_stream) / bw)
        self.prefill_tok_s = time_scale * 2.0 * profile.n_active / eff
        if tp > 1:
            # TP rooflines replace the single-device ticks (the tp=1
            # expressions above stay verbatim so every calibrated replay
            # is bitwise untouched when the knob is off)
            self.decode_tick_s = time_scale * float(cm.decode_s(
                device, profile, 1.0, context_tokens=max_seq / 2,
                kv_dtype=kv_dtype, tp=tp))
            self.prefill_tok_s = time_scale * float(cm.prefill_s(
                device, profile, 1.0, tp=tp))
        # speculative handles charge the spec tick (k drafts priced as
        # draft_profile on draft_device + one multi-token verify here)
        # instead of the plain decode tick; each tick then emits 1..k+1
        # tokens, which is where the effective-ITL win comes from
        self.spec_k = spec_k
        if draft_profile is not None:
            self.spec_tick_s = float(time_scale * cm.speculative_tick_s(
                device, profile, draft_profile, spec_k,
                context_tokens=max_seq / 2, kv_dtype=kv_dtype,
                draft_device=self.draft_device, tp=tp))
            self._tick_s = self.spec_tick_s
        else:
            self.spec_tick_s = None
            self._tick_s = self.decode_tick_s
        # payload (default: the cost model's text+image request) split
        # evenly between request and response; both halves priced by the
        # shared cost-model link helper
        if payload_bytes is None:
            payload_bytes = cm.payload_bytes()
        self.up_s = float(cm.uplink_s(payload_bytes / 2, device))
        self.down_s = float(cm.downlink_s(payload_bytes / 2, device))
        # one streamed token chunk's downlink time: what a streamed
        # request pays at the tail instead of the full-payload downlink
        self.stream_chunk_s = float(cm.stream_chunk_s(device))
        self.fail = fail
        self.pending: list = []  # min-heap of (t_ready, seq, Request)
        self._seq = 0
        # invoked after every charged engine tick (Cluster wires this to
        # its migration scheduler so planned evacuations fire between
        # ticks, at a consistent engine state)
        self.on_step = None
        # invoked on enqueue (Cluster wires this to its event heap so a
        # newly-arrived / migrated request wakes an otherwise-idle handle)
        self.on_enqueue = None
        # KV pages moved to / from other engines, in wire bytes (priced
        # at the *receiving* side's page precision)
        self._c_mig_in = self.engine.metrics.counter("kv_migrate_in_bytes")
        self._c_mig_out = self.engine.metrics.counter("kv_migrate_out_bytes")
        super().__init__(name=name,
                         model_id=cm.MODEL_IDS.index(profile.name),
                         device_id=cm.DEVICE_IDS.index(device.name),
                         is_cloud=is_cloud, execute=self._execute_sync,
                         load=self._load)

    # ------------------------------------------------------- network link
    def uplink_s(self) -> float:
        return self.up_s

    def downlink_s(self) -> float:
        return self.down_s

    # ------------------------------------------------------- migration
    def kv_compatible(self, other: "EngineHandle") -> bool:
        """Whether a KV snapshot exported here can be imported by
        ``other``: both paged, same vocabulary, same KV geometry
        (layers, kv heads, head dim) and page size.  Structural check
        only — bit-identical resumed tokens additionally require the two
        engines to share weights (``build_continuum(param_seed=...)``)."""
        e, o = self.engine, other.engine
        return (e.paged and o.paged
                and self.cfg.vocab == other.cfg.vocab
                and e.model.kv_geometry == o.model.kv_geometry
                and e.page_size == o.page_size)

    # ------------------------------------------------------- split point
    def split_point(self, spec: cm.MediaSpec,
                    src: cm.DeviceProfile) -> "tuple[str, float]":
        """Where to encode ``spec``'s media for a request bound to this
        server: ``("raw", s)`` — ship raw media, encode here — or
        ``("edge", s)`` — encode on the source device ``src``, ship
        compressed features.  ``s`` is the extra virtual seconds the
        chosen split adds on top of the request's base uplink; pass it to
        ``Cluster.submit(media_delay_s=...)``."""
        return cm.best_split(spec, src, self.device)

    def split_delay_s(self, spec: cm.MediaSpec, src: cm.DeviceProfile,
                      choice: str) -> float:
        """Extra virtual seconds of a *forced* split choice (the fixed
        all-raw-ship / all-edge-encode baseline policies)."""
        return cm.split_point_s(spec, src, self.device)[choice]

    # ---------------------------------------------------- virtual stepping
    def enqueue(self, req: Request, t_ready: float):
        """Queue a request to reach this server at virtual time t_ready."""
        heapq.heappush(self.pending, (t_ready, self._seq, req))
        self._seq += 1
        if self.on_enqueue is not None:
            self.on_enqueue(self)

    def busy(self) -> bool:
        return self.engine.busy()

    def _admit_ready(self):
        while self.pending and self.pending[0][0] <= self.vtime + 1e-12:
            _, _, req = heapq.heappop(self.pending)
            self.engine.submit(req)  # t_submit stamps self.vtime

    def next_wake_s(self) -> float:
        """Virtual time of this handle's next chargeable event: now if the
        engine holds admitted work, the head arrival if only pending, +inf
        if idle or failed.  The cluster's event heap keys on this, so an
        idle handle costs nothing to advance past — the O(active)
        property the 100-engine replay rests on."""
        if self.fail:
            return math.inf
        if self.busy():
            return self.vtime
        if self.pending:
            return max(self.pending[0][0], self.vtime)
        return math.inf

    def step_once(self, t: float) -> bool:
        """Run at most ONE charged engine tick without crossing ``t``.

        A tick is charged its dynamic cost (decode step + prefill tokens
        it computed), so it may overshoot ``t`` by less than one tick.
        An idle engine first fast-forwards to its next arrival; a failed
        server never steps (its requests time out at drain).  Returns
        True iff a tick was charged — the caller must then re-read
        ``next_wake_s()``."""
        if self.fail:
            return False
        self._admit_ready()
        if not self.busy():
            nxt = self.pending[0][0] if self.pending else math.inf
            if nxt >= t - 1e-12:  # nothing to do before t
                return False
            self.vtime = max(self.vtime, nxt)
            self._admit_ready()
        if not self.busy() or self.vtime >= t - 1e-12:
            return False
        e = self.engine
        p0 = e.prefill_tokens_computed + e.prefill_tokens_padded
        n_busy = e.step()
        dp = e.prefill_tokens_computed + e.prefill_tokens_padded - p0
        dt = self._tick_s + dp * self.prefill_tok_s
        if self._tr is not None:
            # engine-side spans within one tick are zero-width under
            # the virtual clock (vtime advances *after* the step);
            # this span carries the tick's true virtual duration
            self._tr.span("tick", "engine", self.vtime,
                          self.vtime + dt, pid=self._pid,
                          args={"prefill_tokens": dp, "busy": n_busy})
        self.vtime += dt
        if self.on_step is not None:
            self.on_step(self)
        return True

    def advance_to(self, t: float):
        """Run whole engine ticks until the virtual clock reaches ``t``
        (standalone-handle driver; the cluster drives ``step_once``
        through its event heap instead)."""
        while self.step_once(t):
            pass
        self.vtime = max(self.vtime, t)

    # ------------------------------------------------------------- probes
    def itl_s(self) -> float:
        """Effective virtual seconds per emitted token: the plain decode
        tick, or — for a speculative handle — the spec tick amortized
        over the expected accepted prefix at the engine's *live measured*
        acceptance rate (telemetry feeding back into prediction)."""
        if self.spec_tick_s is None:
            return self.decode_tick_s
        k = getattr(self.engine, "spec_k", self.spec_k)
        a = self.engine.acceptance_rate()
        return float(self.spec_tick_s / cm.expected_accepted(k, a))

    def _load(self) -> dict:
        """Live congestion for the router's ``_effective_latency``: queued
        + running request count, prompt tokens not yet in any KV cache,
        and the estimated virtual seconds to drain all of it."""
        e = self.engine
        waiting = list(e.queue) + [r for _, _, r in self.pending]
        active = [r for r in e.slots if r is not None]
        tasks = [t for t in e.prefill_tasks if t is not None]
        inflight = (sum(len(t.req.tokens) - t.done for t in tasks)
                    + sum(len(r.tokens) for r in waiting))
        decode_ticks = max((int(e.budget[i]) for i, r in enumerate(e.slots)
                            if r is not None), default=0)
        decode_ticks += -(-sum(r.max_new_tokens for r in waiting)
                          // max(e.max_batch, 1))
        backlog = (inflight * self.prefill_tok_s
                   + decode_ticks * self.itl_s())
        return {"queue_depth": len(waiting) + len(active) + len(tasks),
                "inflight_prefill_tokens": int(inflight),
                "backlog_s": float(backlog)}

    def predict_e2e_s(self, prompt_tokens: int, max_new_tokens: int, *,
                      media_delay_s: float = 0.0) -> "tuple[float, dict]":
        """Predicted end-to-end virtual seconds for a request dispatched
        to this server *now*, decomposed per term — the dispatch-audit
        record ``Telemetry.prediction_error`` calibrates against measured
        e2e.  Built from the same per-tick costs ``advance_to`` charges
        (harness scale), so the error measures congestion/interleaving
        mispredictions, not the replay's deliberate scale-down vs. the
        paper-scale cost model.  Call *before* ``Cluster.submit`` so the
        queue term excludes the request itself."""
        e = self.engine
        queue = self._load()["backlog_s"]
        n_pref = float(cm.chunked_prefill_tokens(
            prompt_tokens, e.prefill_chunk if e.chunked else 0,
            minimum=e.min_bucket if e.bucketing else 1))
        terms = {"queue": queue,
                 "prefill": n_pref * self.prefill_tok_s,
                 "decode": max_new_tokens * self.itl_s(),
                 "media": float(media_delay_s),
                 "link": self.up_s + self.down_s}
        return sum(terms.values()), terms

    def _execute_sync(self, task: int) -> "tuple[float, bool]":
        """Legacy ``ServerHandle.execute``: run one task to completion on
        this engine alone; returns virtual seconds including the link."""
        if self.fail:
            return 4 * cm.TIMEOUT_S, False
        rng = np.random.default_rng((task, self.model_id, 7))
        prompt = rng.integers(0, self.cfg.vocab, 16).astype(np.int32)
        req = Request(-1 - task, prompt, max_new_tokens=6)
        t0 = self.vtime
        self.enqueue(req, self.vtime + self.uplink_s())
        deadline = t0 + 4 * cm.TIMEOUT_S
        stride = self.uplink_s() + 8 * self.decode_tick_s
        while not req.done and self.vtime < deadline:
            self.advance_to(self.vtime + stride)
        return self.vtime - t0 + self.downlink_s(), req.done


class Cluster:
    """Shared-virtual-clock harness over a list of ``EngineHandle``s.

    ``submit`` routes a request (a typed ``ContinuumRequest``, or the
    deprecated positional kwargs) to a server; ``advance_to`` moves the
    fleet to a common virtual time by replaying engine ticks in global
    event order off a min-heap of per-handle wake times — O(events on
    *active* engines), so a 100-engine fleet with three busy servers
    costs the same to advance as a 3-engine one; ``stream`` does the
    same while yielding ``StreamEvent``s as tokens decode; ``drain``
    runs all engines until every submitted request finished or the
    timeout horizon passed; ``collect`` returns the measured
    per-request records.
    """

    def __init__(self, handles: "list[EngineHandle]",
                 timeout_s: float = cm.TIMEOUT_S, telemetry=None):
        self.handles = handles
        self.timeout_s = timeout_s
        self.t = 0.0
        self.records: dict[int, dict] = {}
        self._uid = 0
        # uid -> destination handle index of a planned disaggregated
        # dispatch (prefill where submitted, decode there); executed by
        # _on_engine_step as soon as the request reaches decode phase
        self._planned: dict[int, int] = {}
        # event heap of (wake_s, seq, handle_idx, entry_ver) — lazy
        # deletion: entries are cheap to push, and an entry whose version
        # no longer matches the handle's is stale and falls out on pop
        self._heap: "list[tuple[float, int, int, int]]" = []
        self._hseq = 0
        # charged engine ticks / heap pops across the fleet — the
        # O(active) scaling probe fig13 gates on
        self.handle_steps = 0
        self.heap_pops = 0
        # StreamEvents buffered for Cluster.stream() (requests submitted
        # with stream=True rather than a callback)
        self._stream_buf: "deque[StreamEvent]" = deque()
        for i, h in enumerate(handles):
            h._cluster_idx = i
            h._heap_ver = 0
            h.on_step = self._on_engine_step
            h.on_enqueue = self._wake
        # default to the handles' shared telemetry so callers building via
        # build_continuum(telemetry=...) need not pass it twice
        if telemetry is None:
            telemetry = next((h.telemetry for h in handles
                              if h.telemetry is not None), None)
        self.telemetry = telemetry
        tr = telemetry.tracer if telemetry is not None else None
        self._tr = tr if (tr is not None and tr.enabled) else None

    # ------------------------------------------------------------ intake
    def submit(self, server=None, task=None, tokens=None,
               max_new_tokens=None, t_arrival: float = 0.0,
               quality_ok: bool = True, segments=None,
               media_delay_s: float = 0.0,
               decode_server: "int | None" = None,
               stream=None) -> int:
        """Dispatch one request; returns its uid.

        The typed form — ``submit(ContinuumRequest(...))`` — is the API:
        the request carries prompt, arrival, media split, stream sink and
        the router's plan annotations (``server`` must be set; route it
        through ``QLMIORouter.plan`` or set it explicitly).  The request
        reaches the engine after the uplink delay (+ ``media_delay_s``,
        the chosen split point's edge-encode/serialization cost), so
        measured TTFT/e2e include where the media crossed the continuum.
        ``decode_server`` plans the disaggregated shape: prefill on
        ``server``, then — as soon as the request reaches decode phase —
        its KV snapshot migrates over the device link (charged on the
        virtual clock, ``kv_migrate`` span) and decode resumes there.
        ``quality_ok`` is the success-predictor verdict for (task,
        server) — generated tokens are real but random, so answer quality
        is judged by the predictor, as in the sim.

        ``stream`` (``ContinuumRequest.stream``): a callable receives a
        ``StreamEvent`` per decoded token as it decodes (``t_user``
        stamped with the streamed chunk's downlink); ``True`` buffers the
        events for ``Cluster.stream()``.  Streamed requests pay one
        chunk's downlink at the tail instead of the full payload —
        earlier chunks overlap decoding.

        The legacy positional/kwarg form (``submit(server, task, tokens,
        max_new_tokens, t_arrival, ...)``) still works through a shim
        that builds the ``ContinuumRequest`` and emits a
        ``DeprecationWarning``."""
        if isinstance(server, ContinuumRequest):
            return self._submit_typed(server)
        warnings.warn(
            "Cluster.submit(server, task, tokens, ...) kwargs are "
            "deprecated; pass a ContinuumRequest "
            "(repro_torch.serving.request)",
            DeprecationWarning, stacklevel=2)
        return self._submit_typed(ContinuumRequest(
            tokens=tokens, segments=segments,
            max_new_tokens=int(max_new_tokens), arrival_s=float(t_arrival),
            task=int(task), quality_ok=bool(quality_ok),
            media_delay_s=float(media_delay_s), stream=stream,
            server=int(server), decode_server=decode_server))

    def _submit_typed(self, creq: ContinuumRequest) -> int:
        if creq.server is None:
            raise ValueError(
                "ContinuumRequest.server is unset — annotate the request "
                "with a routing decision (QLMIORouter.plan(creq)) or set "
                "server= explicitly")
        server = int(creq.server)
        decode_server = creq.decode_server
        h = self.handles[server]
        if decode_server is not None and decode_server != server:
            if not h.kv_compatible(self.handles[decode_server]):
                raise ValueError(
                    f"cannot plan prefill on {h.name} / decode on "
                    f"{self.handles[decode_server].name}: KV-incompatible "
                    "engines (geometry, page size, or cache backend)")
        if creq.draft_server is not None:
            hv = self.handles[decode_server if decode_server is not None
                              else server]
            if hv.spec_tick_s is None:
                raise ValueError(
                    f"cannot plan drafts on "
                    f"{self.handles[creq.draft_server].name} for "
                    f"{hv.name}: the verify handle is not speculative "
                    "(build it with draft_profile=...)")
        self._uid += 1
        uid = self._uid
        req = h.engine.make_request(creq, uid=uid)
        rec = {"uid": uid, "task": creq.task, "server": server,
               "t_arrival": creq.arrival_s, "req": req,
               "quality_ok": bool(creq.quality_ok),
               "draft_server": creq.draft_server,
               "predicted_s": creq.predicted_s, "utility": creq.utility}
        streamed = creq.stream is not None and creq.stream is not False
        if streamed:
            rec["streamed"] = True
            user_cb = creq.stream if callable(creq.stream) else None

            def deliver(ev: StreamEvent, _rec=rec, _user=user_cb):
                # the *current* holder prices the chunk — a mid-stream
                # migration moves the downlink to the resumed engine
                hh = self.handles[_rec["server"]]
                ev = dataclasses.replace(
                    ev, t_user=ev.t_emit + hh.stream_chunk_s)
                if _user is not None:
                    _user(ev)
                else:
                    self._stream_buf.append(ev)

            req.stream = deliver
        self.records[uid] = rec
        t_arrival, media_delay_s = creq.arrival_s, creq.media_delay_s
        h.enqueue(req, t_arrival + h.uplink_s() + media_delay_s)
        if self._tr is not None:
            tr, pid = self._tr, h._pid
            t1 = t_arrival + h.uplink_s()
            tr.span("uplink", "transfer", t_arrival, t1, pid=pid, tid=uid,
                    args={"task": int(creq.task)})
            if media_delay_s:
                tr.span("media_encode", "transfer", t1,
                        t1 + media_delay_s, pid=pid, tid=uid)
        if decode_server is not None and decode_server != server:
            self._planned[uid] = int(decode_server)
        return uid

    # --------------------------------------------------- event-heap clock
    def busy(self) -> bool:
        return any(h.busy() or h.pending for h in self.handles)

    def _wake(self, h: EngineHandle):
        """(EngineHandle.on_enqueue) arm the handle's next wake time on
        the event heap — an arrival or migration onto an idle handle
        becomes a heap event so the event loop revisits it.  Each push
        bumps the handle's entry version: at most one entry per handle is
        *canonical*; superseded ones drop on pop without re-arming, so
        heap traffic stays linear in (ticks + arrivals)."""
        w = h.next_wake_s()
        if w == math.inf:
            return
        h._heap_ver += 1
        heapq.heappush(self._heap, (w, self._hseq, h._cluster_idx,
                                    h._heap_ver))
        self._hseq += 1

    def _step_next(self, t: float) -> bool:
        """Charge the single earliest pending engine tick strictly before
        ``t``; returns False once no handle has an event before ``t``.
        A migration fired inside the tick enqueues onto the peer handle,
        which arms a fresh heap entry — so cross-engine causality holds
        without a lockstep quantum."""
        while self._heap:
            w, _, idx, ver = self._heap[0]
            if w >= t - 1e-9:
                return False
            heapq.heappop(self._heap)
            self.heap_pops += 1
            h = self.handles[idx]
            if ver != h._heap_ver:
                continue  # superseded by a newer arm for this handle
            w2 = h.next_wake_s()
            if w2 >= t - 1e-9 or w2 > w + 1e-9:
                self._wake(h)  # re-arm at the corrected time (noop if inf)
                continue
            if h.step_once(t):
                self.handle_steps += 1
            self._wake(h)
            return True
        return False

    def advance_to(self, t: float, step_s: float | None = None):
        """Advance the whole fleet to virtual time ``t`` in global event
        order.  ``step_s`` is accepted for back-compat and ignored — the
        event heap makes a sync quantum unnecessary."""
        del step_s
        if t <= self.t:
            return
        while self._step_next(t):
            pass
        self.t = t

    def stream(self, until: float):
        """Advance the fleet to virtual time ``until``, yielding buffered
        ``StreamEvent``s (requests submitted with ``stream=True``) in
        emission order as engines decode them.  Events carry ``t_user``
        — arrival at the user after the streamed chunk's downlink.
        Requests with a ``stream`` *callback* are delivered inline
        instead and do not appear here."""
        if until > self.t:
            while True:
                progressed = self._step_next(until)
                while self._stream_buf:
                    yield self._stream_buf.popleft()
                if not progressed:
                    break
            self.t = until
        while self._stream_buf:
            yield self._stream_buf.popleft()

    # ------------------------------------------------------- migration
    def _on_engine_step(self, h: EngineHandle):
        """Per-tick hook (EngineHandle.on_step): execute planned
        prefill-here/decode-there handoffs whose request just reached
        decode phase on ``h``.  A request may decode a token or two here
        before the hook sees it — the snapshot resumes at exactly
        ``output[-1]`` either way, so no work is lost or repeated."""
        if not self._planned:
            return
        for uid in list(self._planned):
            rec = self.records.get(uid)
            if rec is None or self.handles[rec["server"]] is not h:
                continue
            req = rec["req"]
            if req.done:
                del self._planned[uid]  # finished before the handoff fired
                continue
            if req.output and h.engine.slot_of_request(uid) is not None:
                dst = self._planned.pop(uid)
                self.migrate(uid, dst)

    def migrate(self, uid: int, dst: int) -> dict:
        """Evacuate request ``uid`` from the engine currently holding it
        and resume it on handle ``dst``, charging the KV transfer on the
        virtual clock: wire bytes are the non-cached snapshot pages at the
        **destination's** page precision (int8 tiers pay ~half), link time
        is the cost model's server-to-server roofline, and the transfer is
        visible as a ``kv_migrate`` span.  Returns the move record."""
        rec = self.records[uid]
        src = rec["server"]
        src_h, dst_h = self.handles[src], self.handles[dst]
        if not src_h.kv_compatible(dst_h):
            raise ValueError(
                f"cannot migrate request {uid}: {src_h.name} and "
                f"{dst_h.name} are KV-incompatible")
        req, snap = src_h.engine.evacuate(uid)
        n_cached = (len(dst_h.engine.pool.peek_hashes(snap.prefix_hashes))
                    if dst_h.engine.prefix_caching else 0)
        n_wire = max(snap.num_pages - n_cached, 0)
        nbytes = n_wire * dst_h.engine.page_bytes()
        mig_s = float(cm.migrate_link_s(nbytes, src_h.device, dst_h.device))
        t0 = src_h.vtime
        dst_h.enqueue(req, t0 + mig_s)
        rec["server"] = dst
        src_h._c_mig_out.inc(nbytes)
        dst_h._c_mig_in.inc(nbytes)
        if self._tr is not None:
            self._tr.span("kv_migrate", "transfer", t0, t0 + mig_s,
                          pid=dst_h._pid, tid=uid,
                          args={"bytes": int(nbytes), "pages": int(n_wire),
                                "tokens": int(snap.num_tokens),
                                "src": src_h.name, "dst": dst_h.name})
        return {"uid": uid, "src": src, "dst": dst, "bytes": int(nbytes),
                "pages": int(n_wire), "migrate_s": mig_s, "t": t0}

    def rebalance(self, threshold_s: float, *,
                  min_gain_s: float = 0.0) -> "list[dict]":
        """Mid-stream evacuation policy: for every engine whose backlog
        exceeds ``threshold_s``, consider moving its decoding request with
        the most generation budget left to the KV-compatible handle where
        (migration + remaining decode + queueing) beats staying local by
        more than ``min_gain_s``.  Returns the executed move records."""
        loads = [h._load()["backlog_s"] for h in self.handles]
        moves = []
        for i, src_h in enumerate(self.handles):
            if src_h.fail or loads[i] <= threshold_s:
                continue
            e = src_h.engine
            cands = [(int(e.budget[s]), s, r.uid)
                     for s, r in enumerate(e.slots)
                     if r is not None and r.output and int(e.budget[s]) > 0]
            if not cands:
                continue
            remaining, slot, uid = max(cands)
            n_ctx = int(e.pos[slot])
            best = None
            for j, dst_h in enumerate(self.handles):
                if j == i or dst_h.fail or not src_h.kv_compatible(dst_h):
                    continue
                pages = ceil_blocks(n_ctx, dst_h.engine.page_size)
                mig = float(cm.migrate_link_s(
                    pages * dst_h.engine.page_bytes(),
                    src_h.device, dst_h.device))
                t_move = (mig + remaining * dst_h.itl_s()
                          + 0.5 * loads[j])
                if best is None or t_move < best[0]:
                    best = (t_move, j)
            if best is None:
                continue
            t_stay = remaining * src_h.itl_s() + 0.5 * loads[i]
            if t_stay - best[0] > min_gain_s:
                self._planned.pop(uid, None)  # superseded by this move
                moves.append(self.migrate(uid, best[1]))
                loads[i] = src_h._load()["backlog_s"]
        return moves

    def predict_disagg_e2e_s(self, prefill: int, decode: int,
                             prompt_tokens: int, max_new_tokens: int, *,
                             media_delay_s: float = 0.0
                             ) -> "tuple[float, dict]":
        """Predicted e2e of the disaggregated dispatch shape — prefill on
        handle ``prefill``, KV migration, decode on handle ``decode`` —
        decomposed per term; the third shape ``QLMIORouter.plan`` prices
        against pure-edge and pure-cloud.  Mirrors
        ``EngineHandle.predict_e2e_s`` (same tick-cost scale)."""
        hp, hd = self.handles[prefill], self.handles[decode]
        ep, ed = hp.engine, hd.engine
        n_pref = float(cm.chunked_prefill_tokens(
            prompt_tokens, ep.prefill_chunk if ep.chunked else 0,
            minimum=ep.min_bucket if ep.bucketing else 1))
        pages = ceil_blocks(prompt_tokens + 1, ed.page_size)
        mig = float(cm.migrate_link_s(pages * ed.page_bytes(),
                                      hp.device, hd.device))
        terms = {"queue": hp._load()["backlog_s"],
                 "prefill": n_pref * hp.prefill_tok_s,
                 "migrate": mig,
                 "queue_decode": hd._load()["backlog_s"],
                 "decode": max_new_tokens * hd.decode_tick_s,
                 "media": float(media_delay_s),
                 "link": hp.up_s + hd.down_s}
        return sum(terms.values()), terms

    def predict_spec_e2e_s(self, draft: int, verify: int,
                           prompt_tokens: int, max_new_tokens: int, *,
                           media_delay_s: float = 0.0
                           ) -> "tuple[float, dict] | None":
        """Predicted e2e of the *speculative* dispatch shape — handle
        ``draft``'s device prices the per-tick draft steps while handle
        ``verify`` runs prefill + multi-token verification — decomposed
        per term; the fourth shape ``QLMIORouter.plan`` prices (via
        ``spec_pred``) against pure and disaggregated dispatch.  None
        when ``verify`` is not a speculative handle.

        ``draft == verify`` is colocated speculation; a distinct edge
        ``draft`` is the edge-drafts/cloud-verifies mode, whose only
        cross-device traffic is ``spec_k`` token ids per tick
        (``draft_link``) — the verify tick is re-priced with the draft
        steps on the *draft handle's* device, and the expected emitted
        tokens per tick come from the verify engine's live measured
        acceptance rate (telemetry feedback)."""
        hd, hv = self.handles[draft], self.handles[verify]
        ev = hv.engine
        if hv.spec_tick_s is None or hv.draft_profile is None:
            return None
        k = getattr(ev, "spec_k", hv.spec_k)
        tick = float(hv.time_scale * cm.speculative_tick_s(
            hv.device, hv.profile, hv.draft_profile, k,
            context_tokens=ev.max_seq / 2, kv_dtype=hv.kv_dtype,
            draft_device=hd.device))
        # k drafted token ids uplink per tick (ids pipeline on the
        # persistent stream: bytes only, no per-tick RTT)
        link_bw = min(hd.device.net_bw, hv.device.net_bw)
        draft_link = 0.0 if draft == verify else k * 4.0 / link_bw
        e_acc = float(cm.expected_accepted(k, ev.acceptance_rate()))
        n_pref = float(cm.chunked_prefill_tokens(
            prompt_tokens, ev.prefill_chunk if ev.chunked else 0,
            minimum=ev.min_bucket if ev.bucketing else 1))
        terms = {"queue": hv._load()["backlog_s"],
                 "prefill": n_pref * hv.prefill_tok_s,
                 "decode": max_new_tokens * tick / e_acc,
                 "draft_link": max_new_tokens * draft_link / e_acc,
                 "media": float(media_delay_s),
                 "link": hv.up_s + hv.down_s}
        return sum(terms.values()), terms

    def drain(self, max_virtual_s: float | None = None,
              step_s: float | None = None):
        """Advance every engine until idle (or the deadline, for failed /
        wedged servers) by replaying the event heap to the deadline — one
        pass, no per-handle full-horizon sweep.  A migration fired
        mid-drain enqueues onto a peer handle *as a heap event*, so the
        peer serves it in the same pass at the right virtual time.  Work
        still queued at the deadline — a failed server's requests, or
        backlog beyond the timeout horizon — can never complete inside
        it, so it is dropped here: ``collect()`` reports those requests
        as timeouts and the cluster stays reusable (``reset()``-able).
        ``step_s`` is accepted for back-compat and ignored."""
        del step_s
        deadline = self.t + (2 * self.timeout_s if max_virtual_s is None
                             else max_virtual_s)
        self.advance_to(deadline)
        for h in self.handles:
            # timestamp the horizon on every handle (failed servers burn
            # the time without serving) and drop unservable leftovers
            h.vtime = max(h.vtime, deadline)
            h.pending.clear()
            h.engine.queue.clear()
        self.t = deadline

    def collect(self) -> "list[dict]":
        """Measured per-request records (virtual seconds, links included).
        A request that never completed (failed server, drain deadline)
        counts as a timeout, like the sim's failure injection."""
        out = []
        for uid in sorted(self.records):
            rec = self.records[uid]
            req, h = rec["req"], self.handles[rec["server"]]
            streamed = bool(rec.get("streamed"))
            if req.done and req.token_times:
                # a streamed request pays one token chunk's downlink at
                # the tail (earlier chunks overlapped decoding); a drained
                # one ships the full response payload at the end
                down = h.stream_chunk_s if streamed else h.downlink_s()
                e2e = req.token_times[-1] + down - rec["t_arrival"]
                ttft = req.token_times[0] + down - rec["t_arrival"]
                timeout = e2e > self.timeout_s
                success = rec["quality_ok"] and not timeout
                service = req.e2e_s()
                if self._tr is not None and not rec.get("spanned"):
                    rec["spanned"] = True  # collect() may run twice
                    self._tr.span("stream" if streamed else "downlink",
                                  "transfer", req.token_times[-1],
                                  req.token_times[-1] + down,
                                  pid=h._pid, tid=uid)
                if self.telemetry is not None:
                    self.telemetry.join_measured(uid, e2e)
            else:
                e2e = ttft = 4 * self.timeout_s
                timeout, success, service = True, False, 0.0
                if self.telemetry is not None:
                    self.telemetry.join_measured(uid, e2e, completed=False)
            out.append({"uid": uid, "task": rec["task"],
                        "server": rec["server"], "ttft_s": float(ttft),
                        "e2e_s": float(e2e), "service_s": float(service),
                        "timeout": bool(timeout), "success": bool(success),
                        "n_tokens": len(req.output),
                        "streamed": streamed,
                        "predicted_s": rec.get("predicted_s")})
        return out

    def reset(self):
        """Rewind the virtual clock for a fresh replay on warm engines
        (keeps the params, the expensive part).  Engine metrics registries
        (and any attached telemetry's trace + audit) reset too, so
        per-replay stats stay independent; the engines' ``_traced`` shape
        sets are not cleared, so the ``xla_trace_events`` counters restart
        at 0 against that warm state."""
        for h in self.handles:
            if h.busy() or h.pending:
                raise RuntimeError("reset() needs a drained cluster")
            h.vtime = 0.0
            h.engine.finished.clear()
            h.engine.metrics.reset()
            h.engine.reset_prefix_cache()  # replays must be independent
        if self.telemetry is not None:
            self.telemetry.reset()
        self.t = 0.0
        self.records = {}
        self._planned = {}
        self._heap.clear()  # any surviving entries are stale by now
        self._stream_buf.clear()
        self.handle_steps = 0
        self.heap_pops = 0
        self._uid = 0  # uids restart so replays compare bit-identically

    def latency_stats(self) -> dict:
        """Per-handle engine stats (virtual-clock seconds), plus per-tier
        rollups under ``"tiers"``: edge/cloud summaries over the *merged*
        raw latency samples of each tier's engines (exact percentiles, not
        averages of per-engine percentiles)."""
        out = {h.name: h.engine.latency_stats() for h in self.handles}
        tiers = {}
        for tier, cloud in (("edge", False), ("cloud", True)):
            hs = [h for h in self.handles if h.is_cloud == cloud]
            if not hs:
                continue
            tiers[tier] = latency_summary(
                [v for h in hs for v in h.engine.metrics
                 .histogram("ttft_s").values],
                [v for h in hs for v in h.engine.metrics
                 .histogram("itl_s").values],
                [v for h in hs for v in h.engine.metrics
                 .histogram("e2e_s").values])
        out["tiers"] = tiers
        return out


class EngineBackend:
    """``Episode`` execution backend over a live ``Cluster`` (same
    interface as ``sim.cemllm.CostModelBackend``).

    ``execute`` returns the cost-model estimate — backend parity: a
    deterministic policy sees exactly the observations it would under the
    default backend — while the real request is submitted to the chosen
    engine at the task's virtual arrival time; the cluster then advances
    to the next arrival, so execution pipelines across decisions.
    ``drain()`` finishes every engine and patches the registered episode
    records with measured TTFT/e2e latency, timeout, and success.
    """

    def __init__(self, cluster: Cluster, bench, servers, *,
                 failed=None, arrival_dt: float = 0.02,
                 prompt_cap: int = 48, decode_cap: int = 10,
                 out_token_scale: float = 40.0):
        self.cluster = cluster
        self.bench = bench
        self.servers = servers
        self.failed = (np.zeros(servers.n, bool) if failed is None
                       else np.asarray(failed, bool))
        self.est = CostModelBackend(bench, servers, self.failed)
        self.arrival_dt = arrival_dt
        self.prompt_cap = prompt_cap
        self.decode_cap = decode_cap
        self.out_token_scale = out_token_scale
        self.t = cluster.t
        self._last_uid: int | None = None
        self._open: "list[tuple[int, dict]]" = []

    # ------------------------------------------------------- task shaping
    def prompt_tokens(self, task: int, vocab: int) -> np.ndarray:
        """Deterministic per-task prompt, MIOBench prompt-length matched."""
        L = int(np.clip(self.bench.tasks.text_len[task], 1, self.prompt_cap))
        rng = np.random.default_rng(1_000_003 * (task + 1))
        return rng.integers(0, vocab, L).astype(np.int32)

    def gen_budget(self, task: int, server: int) -> int:
        """Scaled-down CoT inflation: weaker models / harder tasks decode
        more tokens (cost_model.expected_out_tokens / out_token_scale)."""
        prof = self.cluster.handles[server].profile
        out = cm.expected_out_tokens(
            prof, float(self.bench.tasks.difficulty[task]))
        return int(np.clip(round(out / self.out_token_scale), 2,
                           self.decode_cap))

    # --------------------------------------------------- backend interface
    def execute(self, task: int, server: int):
        lat_e, ok_e, _ = self.est.execute(task, server)
        h = self.cluster.handles[server]
        c = int(self.servers.cls[server])
        quality_ok = (not self.failed[server]
                      and int(self.bench.score[task, c]) == 1)
        prompt = self.prompt_tokens(task, h.cfg.vocab)
        budget = self.gen_budget(task, server)
        creq = ContinuumRequest(tokens=prompt, max_new_tokens=budget,
                                arrival_s=self.t, task=task,
                                quality_ok=quality_ok, server=server)
        tm = self.cluster.telemetry
        if tm is not None:
            # predict before submit: the queue term must not include the
            # request itself.  candidates = what every server would have
            # predicted, for the audit's why-this-server story.
            predicted, terms = h.predict_e2e_s(len(prompt), budget)
            cand = [self.cluster.handles[s].predict_e2e_s(
                        len(prompt), self.gen_budget(task, s))[0]
                    for s in range(len(self.cluster.handles))]
            uid = self.cluster.submit(creq.with_plan(predicted_s=predicted))
            tm.record_dispatch(task=task, server=server, t=self.t,
                               predicted_s=predicted, uid=uid, terms=terms,
                               candidates=cand, policy_est_s=float(lat_e))
            self._last_uid = uid
        else:
            self._last_uid = self.cluster.submit(creq)
        self.t += self.arrival_dt
        self.cluster.advance_to(self.t)
        return lat_e, ok_e, False

    def register(self, rec: dict):
        self._open.append((self._last_uid, rec))

    def drain(self):
        self.cluster.drain()
        measured = {r["uid"]: r for r in self.cluster.collect()}
        for uid, rec in self._open:
            m = measured[uid]
            rec.update(latency_r=m["service_s"], latency_total=m["e2e_s"],
                       ttft_s=m["ttft_s"], timeout=m["timeout"],
                       success=m["success"], pending=False)
        self._open.clear()


def build_continuum(spec, *, seed: int = 0, time_scale: float = 1.0,
                    fail=(), telemetry=None, arch: str | None = None,
                    param_seed: int | None = None, backend: str = "live",
                    tp: "int | dict | None" = None, configs=None,
                    **engine_kw) -> "list[EngineHandle]":
    """Live handles for a ``[(class_idx, count), ...]`` spec (the
    ``SYSTEM_CONFIGS`` layout) — pair with
    ``cemllm.make_servers_from_spec`` so the sim table and the engine
    fleet index the same servers.  Class 0/1 are edge tiers on the small
    config; the last class is the cloud tier on the larger config.
    ``telemetry`` (shared across the fleet) turns on lifecycle tracing +
    the dispatch audit; ``Cluster`` picks it up from the handles.

    ``arch`` forces every handle onto one live config and ``param_seed``
    onto one shared weight init — together they make the whole fleet
    KV-compatible with identical weights, the precondition for
    bit-identical cross-engine migration (disaggregated prefill/decode;
    the per-class archs and per-handle seeds stay the default because
    heterogeneous fleets exercise more of the replay harness).

    ``backend="sim"`` swaps every handle's live engine for the analytic
    ``SimEngine`` — no weights, no model, same profiled tick costs —
    which is what makes 100+ handle fleets constructible in milliseconds.

    ``tp`` makes mesh width a tier knob: an int shards only the cloud
    class (the tier with interconnect worth spending), a
    ``{class_idx: tp}`` dict shards per class.  The sim backend prices
    the width through the cost model's TP tick terms; live handles refuse
    ``tp > 1`` (ROADMAP queue 1 item 12).

    ``configs`` maps an arch id to the ``ArchConfig`` its handles serve in
    place of ``reduced(get_config(arch))`` (full width on the card);
    ``engine_kw`` reaches every ``EngineHandle`` (``torch_device``,
    ``params`` and the engine's own keywords)."""
    if isinstance(tp, int):
        tp = {len(SERVER_CLASSES) - 1: tp}
    tp = tp or {}
    handles = []
    i = 0
    for class_idx, count in spec:
        dev_name, prof_name = SERVER_CLASSES[class_idx]
        for _ in range(count):
            cloud = class_idx == len(SERVER_CLASSES) - 1
            arch_i = arch if arch is not None else CLASS_ARCHS[class_idx]
            seed_i = param_seed if param_seed is not None else seed + i
            handles.append(EngineHandle(
                f"{'cloud' if cloud else 'edge'}-{i} ({dev_name}/{arch_i})",
                arch_i, cm.DEVICES[dev_name], cm.MODELS[prof_name],
                is_cloud=cloud, seed=seed_i, fail=i in fail,
                time_scale=time_scale, telemetry=telemetry,
                backend=backend, tp=int(tp.get(class_idx, 1)),
                config=(configs or {}).get(arch_i), **engine_kw))
            i += 1
    return handles
