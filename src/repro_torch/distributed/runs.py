"""Rank-side entry points of tensor-parallel runs (``tp.spawn``'s ``fn``):
each runs on every rank of a group and returns what rank 0 reports.  This
module imports neither JAX nor a test module, since a spawned rank
imports the module of its function.

A serving case is a dict:

  * ``cfg``: the ``ArchConfig`` served;
  * ``weights``: ``{"seed": s, "dtype": "bfloat16"}`` (the port's seeded
    init, drawn by each rank as its shard alone: ``weights.init_shard``)
    or a nested dict of numpy arrays (given weights, e.g. the JAX
    package's; each rank cuts its shard from them);
  * ``engine``: ``ServingEngine`` keywords; ``draft=True`` adds a draft of
    the target's own config (``draft_config=cfg``, its weights drawn from
    ``draft_seed``), ``draft="self"`` one with the target's own weights
    (every rank draws the whole tree for it: the draft is unsharded);
  * ``prompts`` (token arrays), ``max_new_tokens`` and ``device``;
  * ``evacuate_after`` (optional): serve request 0 alone until it has that
    many tokens, then evacuate it (the result holds the request and its
    snapshot, for another engine to resume);
  * ``warm`` (optional): serve one short request first, untimed, then
    reset the engine's metrics and prefix cache.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.tp import ShardedServing
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.nn.spec import init_params
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.weights import from_jax_params, init_shard

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the kernel wrappers a serve counts the launches of (``ops``)
KERNELS = ("paged_decode", "paged_decode_quant", "paged_verify",
           "paged_verify_quant", "flash_attention", "flash_decode",
           "flash_decode_quant", "rmsnorm", "grouped_matmul", "ssd_scan",
           "dense_matmul")


def case_params(model, case: dict, sharded=None):
    """The case's weights on its device: this rank's shard where
    ``sharded`` (a ``ShardedServing``) is given, else the whole tree."""
    w, device = case["weights"], case.get("device", "cpu")
    if "seed" not in w:
        return from_jax_params(w, device=device)
    dtype = _DTYPES[w.get("dtype", "bfloat16")]
    if sharded is None:
        return init_params(model.spec, w["seed"], dtype, device)
    return init_shard(model.spec, sharded.param_pspecs, sharded.mesh.mesh,
                      sharded.mesh.coords, w["seed"], dtype, device)


def build_engine(case: dict, mesh=None, params=None) -> ServingEngine:
    """The case's engine: unsharded, or over ``mesh`` with this rank's
    shard of the weights (``params``: given weights instead of the
    case's)."""
    model = build_model(case["cfg"])
    sharded = None if mesh is None else ShardedServing(model, mesh)
    kw = dict(case.get("engine", {}))
    draft = kw.pop("draft", False)
    if draft:
        kw["draft_config"] = case["cfg"]
    if params is None:
        params = case_params(model, case, sharded)
    if draft == "self":
        kw["draft_params"] = (params if sharded is None
                              else case_params(model, case))
    return ServingEngine(model, params, device=case.get("device", "cpu"),
                         mesh=mesh, **kw)


def requests(case: dict) -> list:
    return [Request(i, np.asarray(p, np.int64),
                    max_new_tokens=case["max_new_tokens"])
            for i, p in enumerate(case["prompts"])]


def _sync(device: str):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def serve(case: dict, mesh=None, params=None) -> dict:
    """Serve the case's requests to the end (or evacuate request 0 after
    ``evacuate_after`` tokens): ``tokens`` per request, the engine's stats,
    the kernels' launches (every count set to 0 just before the serve),
    the serve's seconds, and the engine's layout where ``mesh`` is
    given."""
    device = case.get("device", "cpu")
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    eng = build_engine(case, mesh, params)
    if case.get("warm"):
        eng.submit(Request(-1, np.arange(1, 33, dtype=np.int64),
                           max_new_tokens=4))
        eng.run_until_drained()
        eng.metrics.reset()
        eng.reset_prefix_cache()
    reqs = requests(case)
    out: dict = {}
    for name in KERNELS:  # every count 0 just before the serve
        getattr(ops, name).launches = 0
    coll.all_gather.calls = coll.all_gather.bytes = 0
    _sync(device)
    t0 = time.perf_counter()
    after = case.get("evacuate_after")
    if after is not None:
        req = reqs[0]
        eng.submit(req)
        for _ in range(10_000):
            if eng.slot_of_request(req.uid) is not None and \
                    len(req.output) >= after:
                break
            eng.step()
        req, snap = eng.evacuate(req.uid)
        out.update(request=req, snapshot=snap)
    else:
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    _sync(device)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = {name: getattr(ops, name).launches for name in KERNELS}
    out["gathers"] = coll.all_gather.calls
    out["gather_bytes"] = coll.all_gather.bytes
    out["tokens"] = [tuple(r.output) for r in reqs]
    out["new_tokens"] = sum(len(r.output) for r in reqs)
    st = eng.stats()
    out["stats"] = {k: st[k] for k in ("speculative", "spec_tokens_drafted",
                                       "decode_steps", "prefill_chunks",
                                       "prefills", "verify_steps")}
    if str(device).startswith("cuda"):
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if eng._tp is not None:
        out.update(tp_shards=eng._tp.tp_shards,
                   kv_sharded=eng._tp.kv_sharded,
                   pool_shape=tuple(eng.cache["k_pages"].shape),
                   param_bytes=_bytes(eng.params))
    return out


def _bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def serve_cases(mesh, cases: dict) -> dict:
    """``serve`` of every case over ``mesh``, in order; each result also
    says whether every rank emitted the same tokens (``ranks_agree``) and
    lists each rank's peak memory on the card (``peaks``)."""
    import torch.distributed as dist
    results = {}
    for name, case in cases.items():
        gc.collect()  # the last case's engine (its views hold cycles)
        if str(case.get("device", "cpu")).startswith("cuda"):
            torch.cuda.empty_cache()
        res = serve(case, mesh)
        seen = [None] * mesh.tp
        dist.all_gather_object(seen, (res["tokens"], res.get("peak_bytes")),
                               group=mesh.group)
        res["ranks_agree"] = all(t == seen[0][0] for t, _ in seen)
        res["peaks"] = [p for _, p in seen]
        results[name] = res
    return results


def live_tp_handle(mesh, spec: list, kw: dict) -> dict:
    """``build_continuum(spec, backend="live", tp={0: tp}, **kw)`` on every
    rank, one request served by its first handle: what rank 0's handle
    reports."""
    from repro_torch.serving.cluster import build_continuum
    h = build_continuum(spec, backend="live", tp={0: mesh.tp}, **kw)[0]
    req = Request(0, np.arange(1, 10, dtype=np.int64), max_new_tokens=4)
    h.engine.submit(req)
    h.engine.run_until_drained()
    return {"mesh_tp": h.engine.mesh.tp, "tp": h.tp,
            "engine_tp": h.engine._tp.tp, "tp_shards": h.engine._tp.tp_shards,
            "decode_tick_s": h.decode_tick_s, "tokens": tuple(req.output)}


def moe_layers(mesh, p_np: dict, x_np, kw: dict, modes: dict) -> dict:
    """``moe_apply`` of one layer's weights ``p_np`` on tokens ``x_np`` for
    each of ``modes`` (name -> ``tp_shards``), the weights cut by the
    mode's placement ("experts": dim 0 of the expert leaves; "expert_ff":
    the ff columns of gate/up and the d columns of down, dim 2;
    "shared_ff": the shared expert's likewise, dim 1)."""
    from repro_torch.models import moe
    tp, r = mesh.tp, mesh.rank
    p = from_jax_params(p_np, device="cpu")
    x = torch.from_numpy(np.asarray(x_np))
    out = {}
    for name, shards in modes.items():
        cut = {k: 0 if "experts" in shards else 2
               for k in ("w_gate", "w_up", "w_down")}
        if "shared_ff" in shards:
            cut.update(shared_gate=1, shared_up=1, shared_down=1)
        loc = dict(p)
        for k, dim in cut.items():
            n = p[k].shape[dim] // tp
            loc[k] = p[k].narrow(dim, r * n, n).contiguous()
        with coll.bind("model", mesh.axis):
            out[name] = moe.moe_apply(loc, x, tp_axis="model",
                                      tp_shards=tuple(shards), **kw)
    return out
