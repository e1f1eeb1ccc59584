"""Slot-based continuous-batching serving engine (port of
``repro/serving/engine.py``): the attention family, the zamba2 hybrid,
xlstm and whisper.

A fixed decode batch of ``max_batch`` slots steps in lockstep, one batched
decode step per tick with the argmax on the device.  Two cache backends:

* paged (the default): ``Model.serve_step_paged`` over a page pool.
  Arriving requests reserve a block table (prefix-trie hits are reused,
  copy-on-write protects shared pages); ``kv_dtype="int8"`` stores the
  pool quantized with fp32 row scales.  Finished slots return their pages
  immediately.
* dense (``paged=False``): ``Model.serve_step`` over one contiguous
  ``[L, max_batch, max_seq]`` region per slot, bf16 only, no prefix reuse;
  its decode attention runs the CUDA flash-decode kernel on the card.

``paged=None`` picks the paged backend where the model supports it
(``Model.supports_paged``) and the dense one otherwise, as the JAX engine
does: zamba2 is served on the dense backend, its recurrent conv and SSM
states in the dense cache beside the shared block's K/V, with exact-shape
monolithic prefill (neither bucketed nor chunked: a recurrent state
integrates every token, padding included); so is xlstm, whose cache holds
its mLSTM and sLSTM states only.  whisper is served on the dense backend
with bucketed monolithic prefill; a request carries its encoder frames in
``Request.extra["encoder_frames"]`` [1, Se, d], which reaches
``Model.prefill``, and its cross K/V stay in the slot's ``xk``/``xv``.

Prompts are prefilled ``prefill_chunk`` tokens at a time under a per-tick
``prefill_budget``, sharing ticks with the decode step, or, with
``prefill_chunk=0``, monolithically at admission (on a paged prefix hit
only the suffix, through ``Model.prefill_with_prefix``).  Prompts and
chunks are right-padded to power-of-two buckets.

The host-side page bookkeeping (``kv_cache.py``) is the JAX package's,
unchanged.  The engine's tensors live on ``device`` (``cuda`` unless the
caller passes ``device="cpu"``); attention runs the CUDA kernels there and
their plain versions on the CPU.

With ``draft_config`` the engine decodes speculatively (paged backend
only): each tick a draft model (dense cache; its decode runs the
flash-decode kernel, its prefill the flash-attention kernel) proposes
``spec_k`` tokens per active slot,
``Model.verify_step_paged`` scores them all in one pass through the paged
verify kernel, and each slot emits the longest agreeing prefix plus the
target's correction, the tokens plain greedy decode would give.

Multimodal prompts: a request built from ``segments`` (``TextSegment`` /
``EmbedSegment``, ``serving/segments.py``) carries one key id per position
(content digests, negative, for media rows) and the media rows' features.
Each prefill chunk that covers media positions carries the chunk's slice
of the features, which ``lm.embed_inputs`` injects in place of token
embeddings; the key ids drive the prefix trie, so two requests with the
same media share its pages.

The attention family includes its MoE members (granite-moe,
qwen2-moe), as target or as draft: the engine itself has no MoE branch,
only the model's layers differ.  Speculation and embedding spans need the
attention family, so zamba2 refuses both, as in the JAX package.

Disaggregated prefill/decode (paged backend): a decoding request can be
checkpointed as a ``KVSnapshot`` (``export_kv``; its pages copied to host
tensors) or evacuated between ticks (``evacuate``), and a request carrying
a snapshot, submitted to another engine, is admitted straight into decode
phase: its pages are adopted into the local pool (converted to the local
``kv_dtype``), its prompt blocks re-registered in the prefix trie, no
prefill pass, and decode resumes at exactly ``output[-1]``.

Admission batching (``sorted_batch_sizes``, ``max_live_batches``,
``batching_wait_secs``) admits queued requests in groups on the engine
clock, as the JAX engine does.

Tensor-parallel serving (``mesh=serving_mesh(tp)``, paged backend only):
the engine runs SPMD, one process per rank of ``distributed/tp.py``'s
group, every rank the same host logic on the same requests.  Its steps go
through ``ShardedServing``: the rank's shard of the weights, a pool of
``Hkv / tp`` kv heads (the whole pool where they do not divide), the
kernels at shard shapes and all-gathers between them, and the same logits
on every rank.  The page bookkeeping is unchanged (CoW, scatters and the
trie index the unsharded page axis), snapshots carry the whole kv-head
axis and the global geometry, and the draft model stays unsharded.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.distributed.tp import ServingMesh, ShardedServing
from repro_torch.kernels.quant import dequantize_kv, quantize_kv
from repro_torch.models.api import Model, build_model
from repro_torch.serving import segments as sg
from repro_torch.serving.kv_cache import (BlockPool, BlockTable, KVSnapshot,
                                          OutOfPagesError, ceil_blocks,
                                          full_blocks, kv_page_bytes)
from repro_torch.serving.request import ContinuumRequest, StreamEvent
from repro_torch.serving.telemetry import MetricsRegistry, latency_summary


# batch and sequence dims of the dense cache leaves (Model.abstract_cache):
# zamba2's conv windows and SSM states and xlstm's mLSTM states [G, P, B,
# ...], xlstm's sLSTM states [G, B, d] and whisper's cross K/V [L, B, Se,
# ...] have no sequence dim to grow
_BATCH_DIM = {"k": 1, "v": 1, "xk": 1, "xv": 1, "pos_map": 0,
              "conv": 2, "ssm": 2, "mconv": 2, "mC": 2, "mn": 2, "mm": 2,
              "sc": 1, "sn": 1, "sm": 1, "sh": 1}
_SEQ_DIM = {"k": 2, "v": 2, "pos_map": 1}


def bucket_length(n: int, *, minimum: int = 16, maximum: int | None = None
                  ) -> int:
    """Smallest power-of-two >= n, clamped to [minimum, maximum]."""
    if n < 1:
        raise ValueError(f"bucket_length needs n >= 1, got {n}")
    if maximum is not None and n > maximum:
        raise ValueError(f"bucket_length: n={n} exceeds maximum={maximum}")
    b = max(minimum, 1 << (n - 1).bit_length())
    return b if maximum is None else min(b, maximum)


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray | None = None  # prompt token ids
    max_new_tokens: int = 32
    extra: dict | None = None
    # ordered modality spans (text and embedding segments)
    segments: "list | None" = None
    # filled during serving:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0  # when prefill work started (ends the queue span)
    token_times: list = dataclasses.field(default_factory=list)
    features: np.ndarray | None = dataclasses.field(default=None,
                                                    repr=False)
    embed_mask: np.ndarray | None = dataclasses.field(default=None,
                                                      repr=False)
    imported: "KVSnapshot | None" = dataclasses.field(default=None,
                                                      repr=False)
    # per-token delivery callback (one StreamEvent per decoded token);
    # survives evacuate/resubmit, so a migrated request keeps streaming to
    # the same consumer with contiguous indices
    stream: "Callable[[StreamEvent], None] | None" = \
        dataclasses.field(default=None, repr=False)
    # admission-group id under the batching knobs (None = admitted on the
    # unrestricted path); engine-internal
    group: "int | None" = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.segments is None:
            return
        self.tokens = sg.key_ids(self.segments)
        media = sg.media_segments(self.segments)
        if media:
            d = np.asarray(media[0].features).shape[-1]
            self.features, self.embed_mask = sg.dense_features(
                self.segments, d)

    def ttft_s(self) -> float:
        """Time-to-first-token (prefill + queueing), on the engine clock."""
        return self.token_times[0] - self.t_submit

    def itl_s(self) -> list:
        """Inter-token latencies of the decode phase (engine clock)."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    def e2e_s(self) -> float:
        """Submit-to-last-token latency, on the engine clock."""
        return self.token_times[-1] - self.t_submit


@dataclasses.dataclass
class _PrefillTask:
    """In-flight chunked prefill of one slot (prompt partially in cache)."""
    req: Request
    done: int  # prompt tokens already in the cache (incl. prefix reuse)
    reused: int = 0  # prefix-cache tokens among ``done``
    logits: Any = None  # last chunk's next-token logits [1, V]


class ServingEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 max_seq: int = 256, eos_id: int | None = None,
                 greedy: bool = True, paged: bool | None = None,
                 page_size: int = 16, num_pages: int | None = None,
                 kv_dtype: str = "bf16", kv_budget_bytes: int | None = None,
                 prefix_caching: bool = True, prefill_chunk: int = 64,
                 prefill_budget: int | None = None,
                 bucket_prompts: bool = True, min_bucket: int = 16,
                 return_logits: bool = False,
                 draft_config=None, draft_params=None, draft_seed: int = 0,
                 spec_k: int = 3,
                 sorted_batch_sizes: "list[int] | None" = None,
                 max_live_batches: "int | None" = None,
                 batching_wait_secs: float = 0.0,
                 clock: "Callable[[], float] | None" = None,
                 telemetry=None, trace_name: str = "engine",
                 mesh=None, device=None):
        """Arguments as in the JAX engine, plus ``device``.

        ``prefill_chunk`` — prompt tokens appended per chunked prefill
        call; ``prefill_budget`` — prefill tokens spent per tick before the
        decode step (default ``2 * prefill_chunk``); ``bucket_prompts`` —
        pad chunks to power-of-two buckets >= ``min_bucket``.
        ``kv_dtype`` — ``"bf16"`` or ``"int8"`` pages; ``kv_budget_bytes``
        sizes the pool to a byte budget instead of the worst case.
        ``return_logits`` — the decode step returns [B, vocab] logits
        instead of the on-device argmax.  ``clock`` — time source for
        request timestamps (default ``time.perf_counter``).
        ``telemetry`` — optional ``telemetry.Telemetry`` recording request
        lifecycle spans and per-tick counters.  ``device`` — where the
        cache and the steps run; None means the CUDA card and raises when
        there is none.  ``params`` must already be on that device.
        ``mesh`` — ``distributed.tp.serving_mesh(tp)``, this rank's view
        of a tensor-parallel group (paged backend only): ``params`` is the
        full tree or this rank's shard (``weights.init_shard``), and the
        steps run through ``ShardedServing`` (the module's docstring).
        """
        self.paged = model.supports_paged if paged is None else bool(paged)
        if self.paged and not model.supports_paged:
            raise ValueError(
                f"{model.cfg.name}: paged serving needs an attention-family "
                "cache; use paged=False")
        if draft_config is not None:
            if not self.paged:
                raise ValueError(
                    "speculative decoding needs the paged cache backend "
                    "(the verify pass writes draft K/V through block "
                    "tables); use paged=True")
            if int(spec_k) < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if mesh is not None:
            if not isinstance(mesh, ServingMesh):
                raise TypeError(
                    f"mesh must be a distributed.tp.serving_mesh(tp), not "
                    f"{type(mesh).__name__}")
            if not self.paged:
                raise ValueError(
                    "mesh= (tensor-parallel serving) needs the paged cache "
                    "backend; use paged=True")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
        if kv_dtype != "bf16" and not self.paged:
            raise ValueError(
                "kv_dtype='int8' needs the paged cache backend (dense "
                "caches stay bf16)")
        self.device = resolve(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, the engine on "
                             f"{self.device}")
        self.model = model
        # ---- tensor-parallel serving: the steps go through the sharded
        # view of the model (the rank's shard of the weights and pool)
        self.mesh = mesh
        if mesh is not None:
            self._tp = ShardedServing(model, mesh)
            params = self._tp.shard_params(params)
        else:
            self._tp = None
        self._serving = self._tp if self._tp is not None else model
        self.params = params
        self._now = clock if clock is not None else time.perf_counter
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int64)  # next position per slot
        self.budget = np.zeros(max_batch, np.int64)
        self.kv_dtype = kv_dtype
        self.return_logits = return_logits
        self.bucketing = bucket_prompts and model.supports_bucketed_prefill
        self.chunked = prefill_chunk > 0 and model.supports_chunked_prefill
        self.prefill_chunk = prefill_chunk
        self.prefill_budget = (prefill_budget if prefill_budget is not None
                               else 2 * max(prefill_chunk, 1))
        self.min_bucket = min_bucket
        self.prefill_tasks: list[_PrefillTask | None] = [None] * max_batch
        # ---- saxml-style admission batching (None = per-request)
        if sorted_batch_sizes is not None:
            sizes = sorted(set(int(b) for b in sorted_batch_sizes))
            if not sizes or sizes[0] < 1:
                raise ValueError("sorted_batch_sizes needs sizes >= 1, got "
                                 f"{sorted_batch_sizes!r}")
            if sizes[-1] > max_batch:
                raise ValueError(
                    f"sorted_batch_sizes max {sizes[-1]} exceeds "
                    f"max_batch={max_batch}")
            sorted_batch_sizes = sizes
        self.sorted_batch_sizes = sorted_batch_sizes
        self.max_live_batches = max_live_batches
        self.batching_wait_secs = float(batching_wait_secs)
        self._group_left: dict[int, int] = {}  # group id -> unfinished
        self._next_group = 0
        self._admit_quota: "int | None" = None  # per-tick, set in step()
        self._cur_group: "int | None" = None
        self._admission_held = False  # tick ended with queue held back
        # distinct shapes handed to each step: the JAX engine's trace
        # counters, kept with their keys; eager torch compiles nothing, so
        # they count shape buckets
        self._traced: set = set()  # prefill chunk shapes
        self._step_shapes: set = set()  # decode step shapes
        self.telemetry = telemetry
        self.metrics = m = MetricsRegistry()
        self._c_prefill_computed = m.counter("prefill_tokens_computed")
        self._c_prefill_padded = m.counter("prefill_tokens_padded")
        self._c_prefix_reused = m.counter("prefix_tokens_reused")
        self._c_submitted = m.counter("requests_submitted")
        self._c_finished = m.counter("requests_finished")
        self._c_decode_tokens = m.counter("decode_tokens")
        # KV snapshot traffic (disaggregated prefill/decode): pages and
        # bytes exported to / imported from other engines, at this
        # engine's own page precision
        self._c_kv_exported_pages = m.counter("kv_exported_pages")
        self._c_kv_imported_pages = m.counter("kv_imported_pages")
        self._c_kv_export_bytes = m.counter("kv_export_bytes")
        self._c_kv_import_bytes = m.counter("kv_import_bytes")
        # admission-group sizes under the batching knobs
        self._h_admit_size = m.histogram("batch_admit_size")
        # batched decode steps run: the kernel launch count of a tick is
        # n_layers per step, which is how a run proves it used the kernel
        self._c_decode_steps = m.counter("decode_steps")
        # prefill chunks and speculative verify passes run: on the paged
        # backend each launches the paged verify kernel once per layer on
        # the card (dense chunks attend through the plain version)
        self._c_prefill_chunks = m.counter("prefill_chunks")
        self._c_verify_steps = m.counter("verify_steps")
        # monolithic prefills run (prefill_chunk=0), and those of them that
        # attended a cached prefix: each launches the flash-attention
        # kernel once per layer on the card
        self._c_prefills = m.counter("prefills")
        self._c_suffix_prefills = m.counter("suffix_prefills")
        # draft-model prefills and decode steps run (speculation): each
        # launches the flash-attention, resp. flash-decode, kernel once per
        # draft layer on the card
        self._c_draft_prefills = m.counter("draft_prefills")
        self._c_draft_steps = m.counter("draft_steps")
        # speculative decoding: drafted = spec_k per active slot per tick;
        # accepted = drafts consumed into the output stream; wasted =
        # drafted - accepted (verify compute spent on rejected tokens)
        self._c_spec_drafted = m.counter("spec_tokens_drafted")
        self._c_spec_accepted = m.counter("spec_tokens_accepted")
        self._c_spec_wasted = m.counter("spec_tokens_wasted")
        self._g_accept_rate = m.gauge("spec_acceptance_rate")
        self._c_trace_events = m.counter("xla_trace_events")
        self._h_ttft = m.histogram("ttft_s")
        self._h_itl = m.histogram("itl_s")
        self._h_e2e = m.histogram("e2e_s")
        self._h_queue = m.histogram("queue_s")
        self._h_budget_util = m.histogram("prefill_budget_util")
        self._c_stream_tokens = m.counter("stream_tokens")
        self._g_queue_depth = m.gauge("queue_depth")
        m.view("ticks", lambda: self.ticks)
        m.view("kv_cache_bytes", self.kv_cache_bytes)
        m.view("prefill_trace_count", self.prefill_trace_count)
        tr = telemetry.tracer if telemetry is not None else None
        self._tr = tr if (tr is not None and tr.enabled) else None
        self._pid = self._tr.process(trace_name) if self._tr else 0
        if telemetry is not None:
            telemetry.register_metrics(trace_name, m)
        if self.paged:
            self.page_size = page_size
            self.max_blocks = ceil_blocks(max_seq, page_size)
            if num_pages is None:
                if kv_budget_bytes is not None:
                    num_pages = max(2, 1 + kv_budget_bytes
                                    // self.page_bytes())
                else:  # worst case: admission/decode can never run out
                    num_pages = 1 + max_batch * self.max_blocks
            self.prefix_caching = prefix_caching
            self.pool = BlockPool(num_pages, page_size)
            for key in ("num_pages", "block_size", "pages_in_use",
                        "pages_cached", "prefix_hits", "prefix_misses",
                        "evictions", "cow_copies"):
                m.view(key, lambda k=key: self.pool.stats()[k])
            abstract = self._serving.abstract_paged_cache(
                num_pages, page_size, kv_dtype=kv_dtype)
            self.cache = {name: torch.zeros(s.shape, dtype=s.dtype,
                                            device=self.device)
                          for name, s in abstract.items()}
            self.tables = np.full((max_batch, self.max_blocks), -1,
                                  np.int32)
            self.block_tables: list[BlockTable | None] = [None] * max_batch
        else:
            self.cache = self._empty_cache(model, max_batch, max_seq)
        # ---- speculative decoding (draft model + multi-token verify)
        self.spec_k = int(spec_k)
        self.speculative = draft_config is not None
        if self.speculative:
            self.draft_model = build_model(draft_config)
            if not self.draft_model.supports_paged:
                raise ValueError(
                    f"{draft_config.name}: the draft model must be "
                    "attention-family (dense-cache decode)")
            if draft_config.vocab != model.cfg.vocab:
                raise ValueError(
                    f"draft vocab {draft_config.vocab} != target vocab "
                    f"{model.cfg.vocab}: token-level rejection sampling "
                    "needs a shared vocabulary")
            self.draft_params = (draft_params if draft_params is not None
                                 else self.draft_model.init(
                                     int(draft_seed), device=self.device))
            # the draft runs a plain dense cache: its KV is small, it never
            # shares pages, and stale entries past a rejection are masked
            # by position then overwritten by the next draft chain
            self._draft_cache = self._empty_cache(self.draft_model,
                                                  max_batch, max_seq)
        self.ticks = 0
        self._progress = False
        self.finished: list[Request] = []
        self._auto_uid = 1_000_000_000

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _empty_cache(self, model: Model, B: int, Sa: int) -> dict:
        """A dense cache of ``model`` on the engine's device: zero K/V and
        an all-empty (-1) pos_map."""
        return {k: torch.full(v.shape, -1, dtype=v.dtype, device=self.device)
                if k == "pos_map" else torch.zeros(v.shape, dtype=v.dtype,
                                                   device=self.device)
                for k, v in model.abstract_cache(B, Sa).items()}

    def _step(self, batch):
        """The per-tick decode step: logits, or their argmax computed on
        the device so one int32 per slot crosses to the host."""
        if self.paged:
            self._step_shapes.add(tuple(batch["block_tables"].shape))
            logits, self.cache = self._serving.serve_step_paged(
                self.params, self.cache, batch)
        else:
            self._step_shapes.add(tuple(batch["tokens"].shape))
            logits, self.cache = self.model.serve_step(
                self.params, self.cache, batch)
        if self.return_logits:
            return logits
        return torch.argmax(logits, -1).to(torch.int32)

    def page_bytes(self) -> int:
        """Bytes one page costs across all layers (K+V values plus int8
        scale rows) — the ``kv_budget_bytes`` unit."""
        cfg = self.model.cfg
        return kv_page_bytes(cfg.n_layers, cfg.n_kv_heads, cfg.hd,
                             self.page_size, self.kv_dtype)

    def _bucket(self, n: int, *, cap: int | None = None) -> int:
        if not self.bucketing:
            return n
        return bucket_length(n, minimum=self.min_bucket,
                             maximum=self.max_seq if cap is None else cap)

    def _padded_prompt(self, toks: np.ndarray, n_pad: int) -> torch.Tensor:
        out = np.zeros(n_pad, np.int64)
        out[:len(toks)] = np.maximum(toks, 0)
        return self._to_device(out)[None]

    def _padded_embeds(self, feats: np.ndarray, mask: np.ndarray,
                       n_pad: int):
        """Right-pad a request's embedding rows + mask to the shape bucket
        (zeros / False: padded positions are already masked everywhere)."""
        f = np.zeros((n_pad, feats.shape[1]), np.float32)
        f[:len(feats)] = feats
        m = np.zeros(n_pad, bool)
        m[:len(mask)] = mask
        return self._to_device(f)[None], self._to_device(m)[None]

    def _with_embeds(self, batch: dict, req: Request, start: int, stop: int,
                     n_pad: int) -> bool:
        """Attach the ``[start, stop)`` slice of a multimodal request's
        embedding rows to a prefill batch; returns whether it did (the
        flag keys the shape bucket, as the JAX engine's trace variant).  A
        slice with no embedding positions — a pure-text chunk past the
        media span, or a suffix whose prefix hit covered the media — stays
        a plain token batch."""
        if req.features is None or not req.embed_mask[start:stop].any():
            return False
        e, m = self._padded_embeds(req.features[start:stop],
                                   req.embed_mask[start:stop], n_pad)
        batch["embeds"], batch["embed_mask"] = e, m
        return True

    def _note_trace(self, key: tuple):
        """Book a prefill shape; first sightings bump
        ``xla_trace_events``."""
        if key not in self._traced:
            self._traced.add(key)
            self._c_trace_events.inc()

    def _whole_prefill(self, req: Request, Sb: int):
        """``Model.prefill`` of a whole prompt right-padded to ``Sb``:
        (logits [1, V], one-request dense cache)."""
        T = len(req.tokens)
        batch = {"tokens": self._padded_prompt(req.tokens, Sb),
                 **(req.extra or {})}
        if self.bucketing:
            batch["length"] = self._to_device(np.asarray([T], np.int32))
        mm = self._with_embeds(batch, req, 0, T, Sb)
        self._note_trace(("prefill", Sb, mm))
        return self._serving.prefill(self.params, batch)

    # ----------------------------------------------------- dense internals
    def _admit_dense(self, slot: int, req: Request) -> int:
        """Monolithic (bucketed) prefill into a dense slot; returns the
        first sampled token.  The splice pads the slot's pos_map with -1,
        so no entry of the previous occupant remains."""
        req.t_admit = self._now()
        T = len(req.tokens)
        Sb = self._bucket(T)
        logits, rc = self._whole_prefill(req, Sb)
        self._splice_cache(self.cache, slot, rc)
        self._c_prefills.inc()
        self._c_prefill_computed.inc(T)
        self._c_prefill_padded.inc(Sb - T)
        return int(torch.argmax(logits[0]))

    # ----------------------------------------------------- paged internals
    def _cow_page(self, table: BlockTable, blk: int):
        """Make ``table.pages[blk]`` privately writable, copying if shared.
        Every cache leaf is indexed by page id on axis 1 — int8 scales
        included — so the copy moves values and scales together."""
        old = table.pages[blk]
        new, copied = self.pool.ensure_writable(old)
        if copied:
            for leaf in self.cache.values():
                leaf[:, new] = leaf[:, old]
            self.pool.release(old)
            table.pages[blk] = new

    def _total_blocks(self, req: Request) -> int:
        """Worst-case pages this request can ever hold (prompt + decode;
        speculation adds ``spec_k`` scratch positions so the verify pass
        can always write its draft K/V one tick ahead of acceptance)."""
        horizon = len(req.tokens) + req.max_new_tokens
        if self.speculative:
            horizon += self.spec_k
        horizon = min(horizon, self.max_seq)
        return ceil_blocks(horizon, self.page_size)

    def _growth_outstanding(self) -> int:
        """Pages occupied slots may still allocate: decode growth of active
        requests plus the remaining horizon of mid-prefill slots."""
        out = sum(self._total_blocks(r) - len(self.block_tables[i].pages)
                  for i, r in enumerate(self.slots) if r is not None)
        out += sum(self._total_blocks(t.req)
                   - len(self.block_tables[i].pages)
                   for i, t in enumerate(self.prefill_tasks)
                   if t is not None)
        return out

    def _clip_reuse(self, n_reuse: int) -> int:
        """Bound the distinct ``prefill_with_prefix`` shapes of the
        monolithic path: the reused prefix length is a shape dim of that
        call, so round it down to a power-of-two number of pages.  The
        chunked path has no shape dependence on it and keeps every
        token."""
        if self.chunked or not self.bucketing or n_reuse <= 0:
            return n_reuse
        blocks = n_reuse // self.page_size
        if blocks == 0:
            return 0
        return (1 << (blocks.bit_length() - 1)) * self.page_size

    def _reserve_table(self, req: Request) -> "tuple[BlockTable, int] | None":
        """Admission control + page reservation: returns ``(table,
        n_reuse)`` with the prefix-hit pages retained and capacity for the
        whole prompt allocated, or None when the pool cannot cover this
        request's worst case on top of every occupied slot's growth."""
        toks = np.asarray(req.tokens, np.int64)
        T = len(toks)
        bs = self.page_size
        hit_pages = self.pool.peek_prefix(toks) if self.prefix_caching \
            else []
        est = self._clip_reuse(min(len(hit_pages) * bs, T - 1))
        used = hit_pages[:ceil_blocks(est, bs)] if est else []
        need = self._total_blocks(req) - len(used)
        need += sum(1 for p in used if self.pool.ref[p] == 0)
        if est and est % bs:
            need += 1  # fully-cached prompt: copy-on-write of the last page
        if self.pool.num_free() - self._growth_outstanding() < need:
            return None
        table = BlockTable(self.pool)
        n_reuse = 0
        if self.prefix_caching:
            table.pages, n_hit = self.pool.lookup_prefix(toks)
            # a fully-cached prompt still needs its last token recomputed
            # for the next-token logits -> copy-on-write on the final page
            n_reuse = self._clip_reuse(min(n_hit, T - 1))
            keep = ceil_blocks(n_reuse, bs)
            for p in table.pages[keep:]:  # rounded-off / unused hit pages
                self.pool.release(p)
            table.pages = table.pages[:keep]
        try:
            first_blk = n_reuse // bs
            if n_reuse and first_blk < len(table.pages):
                self._cow_page(table, first_blk)
            table.ensure_capacity(T)
        except OutOfPagesError:  # admission control should prevent this
            table.free()
            return None
        return table, n_reuse

    def _scatter_kv(self, table: BlockTable, positions: np.ndarray, sk, sv,
                    n: int):
        """Scatter ``n`` computed K/V columns ([L, 1, >=n, Hkv, Dh]) into
        the request's pages at the given logical positions.  The int8 pool
        is write-then-quantize: monolithic prefill computes the K/V in the
        activation type, rows are quantized here and their scales written
        at the same (page, offset)."""
        pages, offs = (self._to_device(a.astype(np.int64))
                       for a in table.rows_for(positions))
        if self.kv_dtype == "int8":
            for vname, sname, leaves in (("k_pages", "k_scales", sk),
                                         ("v_pages", "v_scales", sv)):
                rows, scales = quantize_kv(leaves[:, 0, :n])  # [L,n,Hkv,*]
                self.cache[vname][:, pages, offs] = rows
                self.cache[sname][:, pages, offs] = scales
            return
        for name, leaves in (("k_pages", sk), ("v_pages", sv)):
            leaf = self.cache[name]
            leaf[:, pages, offs] = leaves[:, 0, :n].to(leaf.dtype)

    def _admit_paged(self, slot: int, req: Request) -> "int | None":
        """Monolithic (bucketed) paged prefill; returns the first sampled
        token, or None when the pool cannot admit the request yet.  On a
        prefix hit only the suffix is computed, attending the cached
        prefix (int8 pools: dequantized to bf16, the values decode reads);
        the suffix's padded columns are never written."""
        reserved = self._reserve_table(req)
        if reserved is None:
            return None
        req.t_admit = self._now()
        table, n_reuse = reserved
        toks = np.asarray(req.tokens, np.int64)
        T = len(toks)
        n_sfx = T - n_reuse
        Sb = self._bucket(n_sfx)
        if n_reuse == 0:
            logits, rc = self._whole_prefill(req, Sb)
            sk, sv = rc["k"], rc["v"]  # [L, 1, Sb, Hkv, Dh]
        else:
            kp, vp = self.cache["k_pages"], self.cache["v_pages"]
            pre = self._to_device(np.asarray(table.pages, np.int64))
            L, _, _, Hkv, Dh = kp.shape
            if self.kv_dtype == "int8":
                kg = dequantize_kv(kp[:, pre], self.cache["k_scales"][:, pre],
                                   dtype=torch.bfloat16)
                vg = dequantize_kv(vp[:, pre], self.cache["v_scales"][:, pre],
                                   dtype=torch.bfloat16)
            else:
                kg, vg = kp[:, pre], vp[:, pre]
            pk = kg.reshape(L, -1, Hkv, Dh)[:, :n_reuse][:, None]
            pv = vg.reshape(L, -1, Hkv, Dh)[:, :n_reuse][:, None]
            batch = {"tokens": self._padded_prompt(toks[n_reuse:], Sb)}
            if self.bucketing:
                batch["length"] = self._to_device(
                    np.asarray([n_sfx], np.int32))
            mm = self._with_embeds(batch, req, n_reuse, T, Sb)
            self._note_trace(("prefill_sfx", n_reuse, Sb, mm))
            logits, (sk, sv) = self._serving.prefill_with_prefix(
                self.params, batch, pk, pv)
            self._c_suffix_prefills.inc()
        self._scatter_kv(table, np.arange(n_reuse, T), sk, sv, n_sfx)
        if self.prefix_caching:
            self.pool.register_prefix(
                toks, table.pages[:full_blocks(T, self.page_size)])
        self._c_prefills.inc()
        self._c_prefill_computed.inc(n_sfx)
        self._c_prefill_padded.inc(Sb - n_sfx)
        self._c_prefix_reused.inc(n_reuse)
        self.block_tables[slot] = table
        self.tables[slot] = table.as_row(self.max_blocks)
        return int(torch.argmax(logits[0]))

    def _admit(self):
        """Monolithic admission (``prefill_chunk=0``): fill free slots from
        the queue, oldest first, each prompt prefilled whole."""
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            if self._admit_quota is not None and self._admit_quota <= 0:
                break  # this tick's admission group is full
            req = self.queue.popleft()
            if req.imported is not None:
                if self._admit_imported(slot, req):
                    self._tag_group(req)
                    continue
                self.queue.appendleft(req)
                break  # out of pages: wait for running requests to finish
            admit = self._admit_paged if self.paged else self._admit_dense
            first = admit(slot, req)
            if first is None:
                self.queue.appendleft(req)
                break  # out of pages: wait for running requests to finish
            self._progress = True
            self._tag_group(req)
            self._activate(slot, req, first)

    def _free_slot(self, slot: int):
        self.slots[slot] = None
        if self.paged:
            self.block_tables[slot].free()
            self.block_tables[slot] = None
            self.tables[slot] = -1
            self.pos[slot] = 0

    # ------------------- KV snapshot export / import (disaggregation)
    def slot_of_request(self, uid: int) -> "int | None":
        """Decode slot currently holding request ``uid``, or None.  A
        request mid-chunked-prefill is not found (``slots[slot]`` stays
        None until promotion), so a hit means the request is exportable."""
        for i, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                return i
        return None

    def export_kv(self, uid: int) -> KVSnapshot:
        """Checkpoint a decoding request's KV state as a ``KVSnapshot``
        (a host copy; the request keeps running here).

        The snapshot covers every cache position written so far, the
        prompt plus the generated tokens already fed back through the
        model (positions ``[0, pos)``), and carries the prompt's
        prefix-trie chain hashes so the importer can re-register (or
        dedupe against) its own trie.  The pages are retained until the
        device->host copy is complete, so an eviction on this engine
        cannot recycle one mid-export."""
        if not self.paged:
            raise ValueError("export_kv needs the paged cache backend")
        slot = self.slot_of_request(uid)
        if slot is None:
            raise ValueError(
                f"request {uid} is not in decode phase on this engine "
                "(queued, mid-prefill, or finished)")
        req = self.slots[slot]
        bs = self.page_size
        n_ctx = int(self.pos[slot])
        pages = list(self.block_tables[slot].pages[:ceil_blocks(n_ctx, bs)])
        for p in pages:
            self.pool.retain(p)
        try:
            leaves = self._serving.export_paged_kv(self.cache, pages)
        finally:
            for p in pages:
                self.pool.release(p)
        toks = np.asarray(req.tokens, np.int64)
        n_out = n_ctx - len(toks)
        tokens = np.concatenate(
            [toks, np.asarray(req.output[:n_out], np.int64)])
        snap = KVSnapshot(tokens=tokens, n_prompt=len(toks), block_size=bs,
                          kv_dtype=self.kv_dtype,
                          geometry=self.model.kv_geometry, leaves=leaves,
                          prefix_hashes=BlockPool.chain_hashes(toks, bs),
                          src_pages=pages)
        self._c_kv_exported_pages.inc(len(pages))
        self._c_kv_export_bytes.inc(len(pages) * self.page_bytes())
        return snap

    def evacuate(self, uid: int) -> "tuple[Request, KVSnapshot]":
        """Checkpoint a decoding request and remove it from this engine,
        freeing its slot and pages.  The returned ``Request`` carries the
        snapshot in ``req.imported`` and can be submitted to another
        KV-compatible engine, which resumes decode at exactly
        ``output[-1]``.  The request is not added to ``finished``; the
        caller owns it."""
        snap = self.export_kv(uid)
        slot = self.slot_of_request(uid)
        req = self.slots[slot]
        req.imported = snap
        self._release_group(req)  # it will not finish on this engine
        self._free_slot(slot)
        return req, snap

    def _admit_imported(self, slot: int, req: Request) -> bool:
        """Admit a snapshot-carrying request straight into decode phase:
        adopt its pages into this pool (prefix-trie hits served from the
        local cache, the rest imported and converted to this engine's
        ``kv_dtype``) and install the slot at the snapshot's position, no
        prefill pass.  False => the pool cannot cover it yet (the caller
        requeues it).

        Decode writes land at logical block ``pos // page_size`` with
        ``pos >= num_tokens >= n_prompt``, past every block registered in
        the trie here, so the adopted pages need no copy-on-write."""
        snap = req.imported
        n_ctx = snap.num_tokens
        nb = snap.num_pages
        hits = (self.pool.peek_hashes(snap.prefix_hashes)
                if self.prefix_caching else [])
        need = self._total_blocks(req) - len(hits)
        need += sum(1 for p in hits if self.pool.ref[p] == 0)
        if self.pool.num_free() - self._growth_outstanding() < need:
            return False
        table = BlockTable(self.pool)
        if self.prefix_caching:
            table.pages = self.pool.lookup_hashes(snap.prefix_hashes)
        n_hit = len(table.pages)
        try:
            table.ensure_capacity(n_ctx)
        except OutOfPagesError:  # admission control should prevent this
            table.free()
            return False
        if n_hit < nb:
            self.cache = self._serving.import_paged_kv(
                self.cache, table.pages[n_hit:nb], snap.leaves,
                snap.kv_dtype, from_block=n_hit)
        if self.prefix_caching:
            self.pool.register_blocks(
                snap.prefix_hashes, table.pages[:len(snap.prefix_hashes)])
        self.block_tables[slot] = table
        self.tables[slot] = table.as_row(self.max_blocks)
        self.slots[slot] = req
        self.pos[slot] = n_ctx
        self.budget[slot] = req.max_new_tokens - len(req.output)
        req.t_admit = self._now()
        self._c_kv_imported_pages.inc(nb - n_hit)
        self._c_kv_import_bytes.inc((nb - n_hit) * self.page_bytes())
        self._c_prefix_reused.inc(n_hit * self.page_size)
        if self.speculative:
            # the snapshot carries no draft-model state: rebuild it by
            # draft-prefilling the context (prompt + emitted tokens)
            self._draft_install(slot, snap.tokens)
        self._progress = True
        return True

    # -------------------------------------------------- chunked prefill
    def _start_prefill(self, slot: int, req: Request) -> bool:
        """Begin a chunked prefill in ``slot``; False => requeued (the pool
        cannot cover the request yet)."""
        if req.imported is not None:
            if not self._admit_imported(slot, req):
                self.queue.appendleft(req)
                return False
            return True
        if self.paged:
            reserved = self._reserve_table(req)
            if reserved is None:
                self.queue.appendleft(req)
                return False
            table, n_reuse = reserved
            self.block_tables[slot] = table
            self.tables[slot] = table.as_row(self.max_blocks)
            self._c_prefix_reused.inc(n_reuse)
        else:
            n_reuse = 0
            # chunks write only the prompt's positions: clear the previous
            # occupant's pos_map entries up front, as the JAX engine does,
            # so the slot holds no entry past the prompt (reads mask by
            # position; the flash-decode kernel skips tiles with no entry)
            self.cache["pos_map"][slot] = -1
        req.t_admit = self._now()
        self.prefill_tasks[slot] = _PrefillTask(req, done=n_reuse,
                                                reused=n_reuse)
        return True

    def _advance_prefill(self, slot: int) -> int:
        """Run the next chunk of the slot's in-flight prefill; returns the
        bucketed chunk length (charged against the tick's budget)."""
        task = self.prefill_tasks[slot]
        req = task.req
        toks = np.asarray(req.tokens, np.int64)
        T = len(toks)
        n = min(self.prefill_chunk, T - task.done)
        Cb = self._bucket(n, cap=self.prefill_chunk)
        batch = {"tokens": self._padded_prompt(
                     toks[task.done:task.done + n], Cb),
                 "pos": task.done, "length": n}
        if self.paged:
            batch["block_tables"] = self._to_device(self.tables[slot][None])
            chunk_fn = self._serving.prefill_chunk_paged
        else:
            batch["slot"] = slot
            chunk_fn = self.model.prefill_chunk_dense
        mm = self._with_embeds(batch, req, task.done, task.done + n, Cb)
        self._note_trace(("prefill_chunk", Cb, mm))
        t0 = self._now() if self._tr is not None else 0.0
        task.logits, self.cache = chunk_fn(self.params, self.cache, batch)
        if self._tr is not None:
            self._tr.span("prefill_chunk", "prefill", t0, self._now(),
                          pid=self._pid, tid=req.uid,
                          args={"tokens": n, "done": task.done + n,
                                "total": T})
        task.done += n
        self._c_prefill_chunks.inc()
        self._c_prefill_computed.inc(n)
        self._c_prefill_padded.inc(Cb - n)
        if self.paged and self.prefix_caching:
            # publish fully-written prompt blocks as they complete, so a
            # request admitted later this tick already hits them
            self.pool.register_prefix(
                toks[:task.done],
                self.block_tables[slot].pages[
                    :full_blocks(task.done, self.page_size)])
        if task.done >= T:  # prompt complete: promote to decoding
            self.prefill_tasks[slot] = None
            self._activate(slot, req, int(torch.argmax(task.logits[0])))
        return Cb

    def _schedule_prefill(self):
        """Spend this tick's prefill token budget: advance in-flight chunked
        prefills and admit queued requests into free slots, oldest first."""
        budget = self.prefill_budget
        blocked = False  # admission failed this tick: stop admitting
        while budget > 0:
            progressed = False
            # admit at most one request per round, then advance every
            # in-flight prefill, so a prompt admitted behind a finished one
            # sees its freshly registered prefix blocks
            if (not blocked and self.queue
                    and (self._admit_quota is None or self._admit_quota > 0)):
                free = next((i for i in range(self.max_batch)
                             if self.slots[i] is None
                             and self.prefill_tasks[i] is None), None)
                if free is not None:
                    req = self.queue.popleft()
                    if self._start_prefill(free, req):
                        progressed = True
                        self._tag_group(req)
                    else:
                        blocked = True
            for slot in range(self.max_batch):
                if budget <= 0:
                    break
                if self.prefill_tasks[slot] is None:
                    continue
                budget -= self._advance_prefill(slot)
                progressed = True
            self._progress |= progressed
            if not progressed:
                break
        spent = self.prefill_budget - budget
        if spent and self.telemetry is not None:
            self._h_budget_util.observe(spent / self.prefill_budget)

    def _emit_stream(self, req: Request, tok: int, t: float, final: bool):
        """Deliver the token just appended to ``req.output``: a
        ``first_token`` trace instant for the TTFT token and, when the
        request streams, one ``StreamEvent`` to its callback."""
        idx = len(req.output) - 1
        if idx == 0 and self._tr is not None:
            self._tr.instant("first_token", "lifecycle", t,
                             pid=self._pid, tid=req.uid)
        if req.stream is None:
            return
        self._c_stream_tokens.inc()
        req.stream(StreamEvent(uid=req.uid, index=idx, token=tok, t_emit=t,
                               first=idx == 0, final=final))

    # ------------------------------------------------ batched admission
    def _compute_admit_quota(self) -> "int | None":
        """Queued requests that may start prefill this tick under the
        batching knobs (None = unlimited).  Sets ``_admission_held`` when
        the knobs, not resource pressure, hold the queue back."""
        self._admission_held = False
        if self.sorted_batch_sizes is None:
            return None
        if not self.queue:
            return 0
        if (self.max_live_batches is not None
                and len(self._group_left) >= self.max_live_batches):
            self._admission_held = True
            return 0
        n = len(self.queue)
        full = max((b for b in self.sorted_batch_sizes if b <= n), default=0)
        if full:
            return full  # fill the largest bucket the queue can cover
        # a partial group is released only once the oldest queued request
        # has waited out batching_wait_secs on the engine clock; its bucket
        # is the smallest allowed size >= n, so no group exceeds its bucket
        if (self._now() - self.queue[0].t_submit
                >= self.batching_wait_secs - 1e-12):
            return n
        self._admission_held = True
        return 0

    def _tag_group(self, req: Request):
        """Book a just-admitted request into this tick's admission group
        (live-group accounting for ``max_live_batches``) and spend one of
        the tick's quota."""
        if self.sorted_batch_sizes is None:
            return
        if self._cur_group is None:
            self._cur_group = self._next_group
            self._next_group += 1
            self._group_left[self._cur_group] = 0
            self._cur_size = 0
        req.group = self._cur_group
        self._group_left[self._cur_group] += 1
        self._cur_size += 1
        self._admit_quota -= 1

    def _close_admit_group(self):
        if self._cur_group is not None:
            self._h_admit_size.observe(self._cur_size)
            self._cur_group = None

    def _release_group(self, req: Request):
        """Retire a request from its admission group; a group with no
        request left frees a ``max_live_batches`` place."""
        if req.group is None:
            return
        left = self._group_left.get(req.group, 1) - 1
        if left <= 0:
            self._group_left.pop(req.group, None)
        else:
            self._group_left[req.group] = left
        req.group = None

    # ------------------------------------------------------------- public
    def busy(self) -> bool:
        """Any work left: queued, mid-chunked-prefill, or decoding."""
        return bool(self.queue or any(s is not None for s in self.slots)
                    or any(t is not None for t in self.prefill_tasks))

    def make_request(self, creq: ContinuumRequest,
                     uid: "int | None" = None) -> Request:
        """Materialize a typed ``ContinuumRequest`` as an internal
        ``Request`` (uid engine-assigned unless given)."""
        if uid is None:
            self._auto_uid += 1
            uid = self._auto_uid
        tokens = (None if creq.tokens is None
                  else np.asarray(creq.tokens, np.int32))
        return Request(uid, tokens, max_new_tokens=int(creq.max_new_tokens),
                       extra=creq.extra, segments=creq.segments,
                       stream=creq.stream if callable(creq.stream) else None)

    def submit(self, req: "Request | ContinuumRequest") -> Request:
        """Queue a request (internal ``Request`` or ``ContinuumRequest``);
        returns the queued internal request."""
        if isinstance(req, ContinuumRequest):
            req = self.make_request(req)
        if req.tokens is None:
            raise ValueError(f"request {req.uid}: no tokens or segments")
        if req.features is not None:
            if not self.model.supports_embed_spans:
                raise ValueError(
                    f"request {req.uid}: embedding-span prompts need an "
                    f"attention-family model, not {self.model.cfg.name}")
            if req.features.shape[1] != self.model.cfg.d_model:
                raise ValueError(
                    f"request {req.uid}: segment features of dim "
                    f"{req.features.shape[1]} do not match the model's "
                    f"d_model={self.model.cfg.d_model}")
        if len(req.tokens) > self.max_seq - 1:
            raise ValueError(
                f"request {req.uid}: prompt of {len(req.tokens)} tokens "
                f"exceeds the engine's capacity — max_seq={self.max_seq} "
                f"leaves room for at most {self.max_seq - 1} prompt tokens "
                "plus one generated token; raise max_seq or truncate the "
                "prompt")
        if len(req.tokens) < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        # zamba2 and xlstm: a prompt past scan_chunk must be whole chunks
        # (the JAX engine fails the same prompt at admission, with an
        # assertion)
        self.model.check_prompt_length(len(req.tokens))
        if req.imported is not None:
            self._check_import(req)
        # a migrated request keeps its original submit stamp, so queue time
        # and e2e span the source engine too (a shared clock base)
        if not req.token_times:
            req.t_submit = self._now()
        self._c_submitted.inc()
        if self._tr is not None:
            self._tr.instant("submit", "lifecycle", req.t_submit,
                             pid=self._pid, tid=req.uid)
        self.queue.append(req)
        return req

    def _check_import(self, req: Request):
        """Refuse a snapshot this engine cannot adopt: another backend,
        KV geometry, page size or capacity, or a request not mid-decode."""
        snap = req.imported
        if not self.paged:
            raise ValueError(
                f"request {req.uid}: KV snapshot import needs the paged "
                "cache backend")
        if snap.geometry != self.model.kv_geometry:
            raise ValueError(
                f"request {req.uid}: snapshot KV geometry {snap.geometry} "
                f"does not match this engine's {self.model.kv_geometry}")
        if snap.block_size != self.page_size:
            raise ValueError(
                f"request {req.uid}: snapshot block_size {snap.block_size} "
                f"!= engine page_size {self.page_size}")
        if snap.num_tokens > self.max_seq - 1:
            raise ValueError(
                f"request {req.uid}: snapshot of {snap.num_tokens} tokens "
                f"exceeds max_seq={self.max_seq} - 1")
        if not req.output or req.done:
            raise ValueError(
                f"request {req.uid}: a snapshot-carrying request must be "
                "mid-decode (non-empty output, not done)")

    def _finish(self, req: Request):
        """Request complete: move to ``finished``, fold its latencies into
        the registry histograms and emit its lifecycle spans.  A migrated
        request's queue and prefill ran on the source engine (its t_admit
        here postdates its first token), so only its decode span and its
        end-to-end latencies are recorded here."""
        req.done = True
        self.finished.append(req)
        self._c_finished.inc()
        self._release_group(req)
        tt = req.token_times
        imported = req.imported is not None
        ta = req.t_admit if req.t_admit >= req.t_submit else req.t_submit
        if not imported:
            self._h_queue.observe(ta - req.t_submit)
        self._h_ttft.observe(tt[0] - req.t_submit)
        self._h_e2e.observe(tt[-1] - req.t_submit)
        if len(tt) > 1:
            self._h_itl.extend(b - a for a, b in zip(tt, tt[1:]))
        tr = self._tr
        if tr is not None:
            pid, tid = self._pid, req.uid
            if not imported:
                tr.span("queue", "lifecycle", req.t_submit, ta, pid=pid,
                        tid=tid)
                tr.span("prefill", "lifecycle", ta, tt[0], pid=pid, tid=tid,
                        args={"prompt_tokens": len(req.tokens)})
            tr.span("decode", "lifecycle", tt[0], tt[-1], pid=pid, tid=tid,
                    args={"new_tokens": len(req.output)})

    def _activate(self, slot: int, req: Request, first_tok: int):
        """Install a prefilled request into its decode slot; a request
        whose first token already ends it finishes immediately."""
        req.output.append(first_tok)
        req.token_times.append(self._now())
        ends = (req.max_new_tokens <= 1
                or (self.eos_id is not None and first_tok == self.eos_id))
        self._emit_stream(req, first_tok, req.token_times[-1], ends)
        if ends:
            self._finish(req)
            if self.paged and self.block_tables[slot] is not None:
                self.block_tables[slot].free()
                self.block_tables[slot] = None
                self.tables[slot] = -1
            return
        self.slots[slot] = req
        self.pos[slot] = len(req.tokens)
        self.budget[slot] = req.max_new_tokens - 1
        if self.speculative:
            self._draft_install(slot, req.tokens)

    @staticmethod
    def _splice_cache(cache: dict, slot: int, req_cache: dict) -> dict:
        """Insert a one-request prefill cache into slot ``slot`` of a dense
        batch cache (in place), padding the sequence dim of the K/V and
        pos_map leaves to the cache's with zeros (pos_map: -1, empty).  A
        leaf without a sequence dim (zamba2's conv windows and SSM states)
        is copied as it is, broadcast to the slot's shape as the JAX
        splice's ``.at[].set`` broadcasts it: a 1-token prompt's one conv
        row (zamba2's ``conv``, xlstm's ``mconv``) fills all W-1 rows of
        its window, and a prompt of 2 to W-2 tokens raises ValueError
        before any leaf is written, as the JAX splice raises."""
        rcs = {}
        for name, leaf in cache.items():
            rc = req_cache[name]
            if name in _SEQ_DIM:
                sdim = _SEQ_DIM[name]
                pad = list(rc.shape)
                pad[sdim] = leaf.shape[sdim] - rc.shape[sdim]
                rc = torch.cat([rc, rc.new_full(pad, -1 if name == "pos_map"
                                                else 0)], sdim)
            want = list(leaf.shape)
            want[_BATCH_DIM[name]] = 1
            if rc.dim() != len(want) or any(
                    a not in (b, 1) for a, b in zip(rc.shape, want)):
                raise ValueError(
                    f"Incompatible shapes for broadcasting: "
                    f"{tuple(rc.shape)} and requested shape {tuple(want)} "
                    f"(cache leaf {name!r})")
            rcs[name] = rc
        for name, leaf in cache.items():
            leaf.narrow(_BATCH_DIM[name], slot, 1).copy_(rcs[name])
        return cache

    def _draft_install(self, slot: int, tokens):
        """(Re)build the draft model's dense-cache state for ``slot`` by
        prefilling ``tokens`` with the draft weights.  Media key ids are
        clamped to token 0 (``_padded_prompt``), as the JAX engine does, so
        draft quality may drop over embedding spans; verification keeps
        the emitted stream independent of draft quality."""
        toks = np.asarray(tokens, np.int64)
        T = len(toks)
        Sb = self._bucket(T)
        batch = {"tokens": self._padded_prompt(toks, Sb)}
        if self.bucketing:
            batch["length"] = self._to_device(np.asarray([T], np.int32))
        self._note_trace(("draft_prefill", Sb))
        _, rc = self.draft_model.prefill(self.draft_params, batch)
        self._c_draft_prefills.inc()
        self._draft_cache = self._splice_cache(self._draft_cache, slot, rc)

    def acceptance_rate(self, default: float = 0.6) -> float:
        """Live draft-token acceptance rate (accepted / drafted) since the
        last ``metrics.reset()``; ``default`` until any tokens have been
        drafted."""
        drafted = self._c_spec_drafted.value
        if drafted <= 0:
            return float(default)
        return self._c_spec_accepted.value / drafted

    def step(self) -> int:
        """One engine tick: spend the prefill budget, then one batched
        decode step for every fully-prefilled slot.  Returns the number of
        occupied slots; a no-op returning 0 when there is no work."""
        self._progress = False
        self._admit_quota = self._compute_admit_quota()
        if self.chunked:
            self._schedule_prefill()
        else:
            self._admit()
        self._close_admit_group()
        self._g_queue_depth.set(len(self.queue))
        active = [i for i, r in enumerate(self.slots) if r is not None]
        n_prefilling = sum(t is not None for t in self.prefill_tasks)
        if self._tr is not None and (active or n_prefilling or self.queue):
            self._sample_tick(len(active), n_prefilling)
        if not active:
            if n_prefilling:
                self.ticks += 1
            return n_prefilling
        if self.speculative:
            self._spec_tick(active)
            self.ticks += 1
            return len(active) + n_prefilling
        tokens = np.zeros(self.max_batch, np.int64)
        # slots without a decodable request (free, or still prefilling) are
        # masked out of the decode step: dense ones sit at pos = max_seq,
        # whose writes drop; paged ones get a null block table and
        # position 0, so their write lands on the null page.  Their
        # attention rows are never read
        pos = np.full(self.max_batch, self.max_seq, np.int32)
        for i in active:
            tokens[i] = self.slots[i].output[-1]
            pos[i] = self.pos[i]
        batch = {"tokens": self._to_device(tokens)}
        if self.paged:
            for i in active:  # grow block tables across page boundaries
                bt = self.block_tables[i]
                if self.pos[i] >= bt.num_tokens_capacity():
                    bt.ensure_capacity(self.pos[i] + 1)
                    self.tables[i] = bt.as_row(self.max_blocks)
            tables = np.full_like(self.tables, -1)
            for i in active:
                tables[i] = self.tables[i]
            pos[pos >= self.max_seq] = 0
            batch["block_tables"] = self._to_device(tables)
        batch["pos"] = self._to_device(pos)
        t0 = self._now() if self._tr is not None else 0.0
        out = self._step(batch)
        nxt = (torch.argmax(out, -1) if self.return_logits else out).cpu()
        nxt = nxt.numpy()
        self.ticks += 1
        self._c_decode_steps.inc()
        self._c_decode_tokens.inc(len(active))
        t_now = self._now()
        if self._tr is not None:
            self._tr.span("decode_tick", "engine", t0, t_now, pid=self._pid,
                          args={"active": len(active)})
        for i in active:
            req = self.slots[i]
            tok = int(nxt[i])
            req.output.append(tok)
            req.token_times.append(t_now)
            self.pos[i] += 1
            self.budget[i] -= 1
            ends = bool(self.budget[i] <= 0 or tok == self.eos_id
                        or self.pos[i] >= self.max_seq - 1)
            self._emit_stream(req, tok, t_now, ends)
            if ends:
                self._finish(req)
                self._free_slot(i)  # free slot/pages (continuous batching)
        return len(active) + n_prefilling

    def _spec_tick(self, active: "list[int]"):
        """One speculative decode tick: the draft model proposes ``spec_k``
        tokens per active slot (``spec_k`` dense decode steps), the target
        scores the last accepted token plus all drafts in one verify pass,
        and each slot emits the longest agreeing prefix plus the target's
        correction token: 1 to ``spec_k + 1`` tokens, the ones plain
        greedy decode would give.

        Rejected drafts leave stale K/V past the new ``pos`` in both
        caches; every read masks ``cache_pos <= query_pos`` and the next
        tick's writes overwrite them in order, so rollback costs nothing.
        Stream events are emitted per token with contiguous indices and
        timestamps spread across the tick, ``final`` only on the true last
        token."""
        k = self.spec_k
        B = self.max_batch
        t0 = self._now()
        # parked slots (free / mid-prefill) sit at pos = max_seq: their
        # dense draft writes and, with a null block table, their verify
        # writes are dropped, and their outputs are never read
        cur = np.zeros(B, np.int64)
        base = np.full(B, self.max_seq, np.int64)
        for i in active:
            cur[i] = self.slots[i].output[-1]
            base[i] = self.pos[i]
        ids = self._to_device(cur)
        proposals = []
        for t in range(k):  # drafts stay on the device until all k are in
            logits, self._draft_cache = self.draft_model.serve_step(
                self.draft_params, self._draft_cache,
                {"tokens": ids,
                 "pos": self._to_device(np.minimum(base + t, self.max_seq))})
            ids = torch.argmax(logits, -1)
            proposals.append(ids)
            self._c_draft_steps.inc()
        drafts = torch.stack(proposals, 1).cpu().numpy()  # [B, k]
        t_draft = self._now() if self._tr is not None else t0
        # grow block tables to cover the k+1 verify positions; admission
        # reserved spec_k slack in _total_blocks, so this cannot exhaust
        # the pool (positions past max_seq simply drop their writes)
        for i in active:
            bt = self.block_tables[i]
            cap = min(int(base[i]) + k + 1, self.max_seq)
            if cap > bt.num_tokens_capacity():
                bt.ensure_capacity(cap)
                self.tables[i] = bt.as_row(self.max_blocks)
        vt = np.zeros((B, k + 1), np.int64)
        tables = np.full_like(self.tables, -1)
        for i in active:
            vt[i, 0] = self.slots[i].output[-1]
            vt[i, 1:] = drafts[i]
            tables[i] = self.tables[i]
        logits, self.cache = self._serving.verify_step_paged(
            self.params, self.cache,
            {"tokens": self._to_device(vt),
             "pos": self._to_device(np.minimum(base, self.max_seq)
                                    .astype(np.int32)),
             "block_tables": self._to_device(tables)})
        # [B, k+1] target argmax per verify position, on the device
        ids = torch.argmax(logits, -1).cpu().numpy()
        self._c_verify_steps.inc()
        t_now = self._now()
        if self._tr is not None:
            self._tr.span("draft_tick", "engine", t0, t_draft,
                          pid=self._pid, args={"active": len(active),
                                               "k": k})
            self._tr.span("verify_tick", "engine", t_draft, t_now,
                          pid=self._pid, args={"active": len(active),
                                               "k": k})
        n_tok = tick_acc = 0
        for i in active:
            req = self.slots[i]
            # ids[i, j] is the target's token after consuming vt[i, :j+1];
            # draft j (= vt[i, j+1]) is accepted iff it equals ids[i, j]
            n_acc = 0
            while n_acc < k and drafts[i, n_acc] == ids[i, n_acc]:
                n_acc += 1
            emit = [int(x) for x in ids[i, :n_acc + 1]]
            emitted = 0
            for tok in emit:
                emitted += 1
                req.output.append(tok)
                ts = t0 + (t_now - t0) * emitted / len(emit)
                req.token_times.append(ts)
                self.pos[i] += 1
                self.budget[i] -= 1
                ends = bool(self.budget[i] <= 0 or tok == self.eos_id
                            or self.pos[i] >= self.max_seq - 1)
                self._emit_stream(req, tok, ts, ends)
                if ends:
                    self._finish(req)
                    self._free_slot(i)
                    break
            # drafts consumed into the stream; accepted-but-unemitted
            # drafts past an eos/budget stop count as wasted
            acc = emitted - 1
            self._c_spec_drafted.inc(k)
            self._c_spec_accepted.inc(acc)
            self._c_spec_wasted.inc(k - acc)
            n_tok += emitted
            tick_acc += acc
        self._c_decode_tokens.inc(n_tok)
        drafted = self._c_spec_drafted.value
        if drafted:
            self._g_accept_rate.set(self._c_spec_accepted.value / drafted)
        if self._tr is not None:
            self._tr.counter("spec_tokens", t_now,
                             {"drafted": k * len(active),
                              "accepted": tick_acc,
                              "emitted": n_tok}, pid=self._pid)

    def _sample_tick(self, n_active: int, n_prefilling: int):
        """Per-tick occupancy counter samples (tracing enabled only)."""
        tr, now = self._tr, self._now()
        tr.counter("batch_occupancy", now,
                   {"decoding": n_active, "prefilling": n_prefilling},
                   pid=self._pid)
        tr.counter("queue_depth", now,
                   {"queued": len(self.queue),
                    "live_batches": len(self._group_left)}, pid=self._pid)
        if self.paged:
            tr.counter("kv_pages", now,
                       {"in_use": self.pool.pages_in_use(),
                        "cached": len(self.pool.lru)}, pid=self._pid)

    def run_until_drained(self, max_ticks: int = 10_000,
                          keep_finished: bool = False):
        """Step until queue, prefill tasks and slots are all empty; returns
        the finished requests (``keep_finished=True`` also leaves them on
        ``self.finished``).  ``max_ticks`` bounds the ticks of this call."""
        drain_deadline = self.ticks + max_ticks
        spins = 0  # ticks spent holding admission (batching knobs)
        while self.busy():
            if self.step() == 0 and self.queue and not self._progress:
                if self._admission_held:
                    # the batching knobs, not resource pressure, hold the
                    # queue: a wall clock lets the wait elapse; a virtual
                    # clock needs an external driver, so the spinning is
                    # bounded instead of diagnosed as out of pages
                    spins += 1
                    if spins > max(max_ticks, 100_000):
                        raise RuntimeError(
                            "engine did not drain: admission held by the "
                            "batching knobs but the clock never advanced "
                            "(virtual-clock engines must be driven "
                            "externally when batching_wait_secs > 0)")
                    continue
                # nothing active yet admission failed: the head request can
                # never fit (its worst case exceeds the whole pool)
                head = self.queue[0]
                raise OutOfPagesError(
                    f"request {head.uid} needs {self._total_blocks(head)} "
                    f"pages but the pool only has {self.pool.num_pages - 1}")
            if self.ticks > drain_deadline:
                raise RuntimeError("engine did not drain")
        if keep_finished:
            return list(self.finished)
        out, self.finished = self.finished, []
        return out

    def reset_prefix_cache(self):
        """Drop every parked prefix block (paged backend): the next
        admission sees a cold cache.  Pages are only read through block
        tables, so the stale device tensors need no zeroing.  Requires an
        idle engine."""
        if not self.paged:
            return
        if self.busy():
            raise RuntimeError("reset_prefix_cache needs an idle engine")
        self.pool = BlockPool(self.pool.num_pages, self.page_size)

    # -------------------------------------------------------------- stats
    @property
    def prefill_tokens_computed(self) -> int:
        return self._c_prefill_computed.value

    @property
    def prefill_tokens_padded(self) -> int:
        return self._c_prefill_padded.value

    @property
    def prefix_tokens_reused(self) -> int:
        return self._c_prefix_reused.value

    def kv_cache_bytes(self) -> int:
        """Current KV-cache footprint (allocated device tensors)."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    def prefill_trace_count(self) -> int:
        """Distinct prefill shapes handed to the model so far (bounded by
        the bucket count)."""
        return len(self._traced)

    def jit_cache_sizes(self) -> dict:
        """Distinct input shapes per step function, under the JAX
        engine's keys."""
        sizes = {"_step": len(self._step_shapes)}
        for kind, *_ in self._traced:  # prefill_chunk, prefill, ...
            sizes["_" + kind] = sizes.get("_" + kind, 0) + 1
        return {name: n for name, n in sizes.items() if n}

    def latency_stats(self) -> dict:
        """TTFT / inter-token / end-to-end latency percentiles (seconds,
        on the engine clock)."""
        return latency_summary(self._h_ttft.values, self._h_itl.values,
                               self._h_e2e.values)

    def stats(self) -> dict:
        """Static configuration, a metrics-registry snapshot and the
        latency percentiles under ``"latency"``."""
        out = {"paged": self.paged, "kv_dtype": self.kv_dtype,
               "bucketed": self.bucketing, "chunked": self.chunked,
               "speculative": self.speculative,
               "spec_k": self.spec_k if self.speculative else 0,
               "acceptance_rate": (self.acceptance_rate()
                                   if self.speculative else None)}
        out.update(self.metrics.snapshot())
        out["latency"] = self.latency_stats()
        return out
