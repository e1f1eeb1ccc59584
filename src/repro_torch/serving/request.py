"""Typed submission API for the continuum serving stack.

``Cluster.submit`` accreted one positional/keyword argument per PR
(tokens, segments, media_delay_s, decode_server, ...).  This module is
the stable, typed replacement: a frozen ``ContinuumRequest`` carries
everything a request needs across the router -> cluster -> engine path,
and router decisions *annotate* the request (``with_plan``) instead of
re-threading positional args.  The legacy kwarg form still works through
a back-compat shim in ``Cluster.submit`` that builds one of these and
emits a ``DeprecationWarning``.

``StreamEvent`` is the unit of the streaming serving surface (saxml's
per-request stream-output queue, adapted to the virtual clock): the
engine emits one per decoded token, *as it decodes*, instead of holding
tokens until drain.  ``t_emit`` is on the engine's clock (virtual
seconds under the continuum harness); the cluster adds ``t_user`` — the
time the token chunk lands at the user after the streamed downlink
chunk priced by ``cost_model.stream_chunk_s``.

Deliberately light: imports nothing from the engine/cluster modules so
router-only and cost-model-only consumers can use the types without
pulling in model building.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

__all__ = ["ContinuumRequest", "StreamEvent"]


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One streamed decode token.

    ``index`` is the token's 0-based position in the request's output —
    contiguous and in-order per request, *including across a mid-stream
    migration* (the resumed engine continues the count).  ``first`` marks
    the TTFT token, ``final`` the EOS/budget end of stream (the saxml
    ``None`` end-of-stream sentinel, carried in-band)."""
    uid: int
    index: int
    token: int
    t_emit: float  # engine clock (virtual seconds under the harness)
    first: bool
    final: bool
    # set by the cluster: t_emit + the streamed downlink chunk's link time
    t_user: float | None = None


@dataclasses.dataclass(frozen=True)
class ContinuumRequest:
    """Everything one request carries through the continuum.

    Frozen: the router returns an *annotated copy* (``with_plan``) rather
    than mutating shared state, so a request can be re-planned, hedged,
    or replayed without aliasing surprises.

    Fields mirror the legacy ``Cluster.submit`` kwargs one-to-one:

    * ``tokens`` / ``segments`` — the prompt: plain token ids, or typed
      modality spans (repro_torch/serving/segments.py; ``tokens`` is then
      derived by the engine).
    * ``max_new_tokens`` — generation budget.
    * ``arrival_s`` — virtual arrival time at the user's device.
    * ``task`` / ``quality_ok`` — replay bookkeeping: MIOBench task id
      and the success-predictor verdict for the chosen server.
    * ``media`` / ``media_delay_s`` — the media spec
      (cost_model.MediaSpec) and the chosen split point's extra virtual
      seconds (edge-encode + serialization) charged before the uplink.
    * ``stream`` — per-token delivery: a callable receiving each
      ``StreamEvent``, or True to buffer events for ``Cluster.stream()``.
      None keeps the legacy drain-based collection.
    * ``extra`` — passed through to the engine (e.g. encoder_frames).

    Router/plan annotations (``with_plan`` fills these):

    * ``server`` — dispatch target (required by ``Cluster.submit``).
    * ``decode_server`` — disaggregated shape: prefill on ``server``,
      KV-migrate, decode there.
    * ``draft_server`` — speculative shape: ``server`` (or
      ``decode_server``) runs prefill + multi-token verify, while this
      server's device prices the ``spec_k`` draft steps per tick — the
      edge-drafts/cloud-verifies offloading mode (only token ids ride
      the uplink).  Equal to the decode server = colocated speculation.
    * ``predicted_s`` / ``utility`` — the router's predicted e2e seconds
      and Eq. 21 utility for the chosen shape (audit trail).
    """
    tokens: Any = None
    segments: "list | None" = None
    max_new_tokens: int = 32
    arrival_s: float = 0.0
    task: int = -1
    quality_ok: bool = True
    media: Any = None
    media_delay_s: float = 0.0
    stream: "Callable[[StreamEvent], None] | bool | None" = None
    extra: "dict | None" = None
    # --- router / plan annotations
    server: "int | None" = None
    decode_server: "int | None" = None
    draft_server: "int | None" = None
    predicted_s: "float | None" = None
    utility: "float | None" = None

    def with_plan(self, **changes) -> "ContinuumRequest":
        """Annotated copy — the router's way of recording its decision
        (``server=``, ``decode_server=``, ``predicted_s=``, ``utility=``)
        on the request itself."""
        return dataclasses.replace(self, **changes)
