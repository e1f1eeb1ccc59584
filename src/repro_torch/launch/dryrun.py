"""One-card dry run (a port of ``repro/launch/dryrun.py``): trace every
(arch x shape) cell on ``meta`` tensors and reckon whether it fits one
H100 and what its roofline bound is.

For each cell the parameters (bf16, ``Model.abstract``), the AdamW state
(``adamw_init`` on them: step, fp32 m, v and master), the batch
(``Model.input_specs``) and the decode cache (``Model.abstract_cache``)
are ``meta`` tensors: nothing is allocated.  The entry point the JAX dry
run lowers (``make_train_step()``, ``prefill`` or ``serve_step``) runs on
them under ``analysis.Counter``, which records:

  * ``roofline``  -- ``analysis.Roofline.as_dict()`` of the counted FLOPs
                     and HBM bytes (collectives 0 on one card);
  * ``memory``    -- ``argument_size_in_bytes`` (the inputs),
                     ``output_size_in_bytes`` (what the call creates and
                     returns; the train step updates its inputs in place)
                     and ``temp_size_in_bytes`` (the peak of the storages
                     the call creates, outputs included);
  * ``fits``      -- arguments plus temp within ``mesh.HBM_BYTES`` (None
                     where the temp is only a lower bound and within it).

The JAX dry run lowers each cell onto the 16x16 and 2x16x16 TPU meshes.
Eager torch has no GSPMD partitioner to lower a cell per device, so a
mesh (``--mesh production``, ``multipod`` or ``edge``: the H100 meshes of
``mesh.py``) gets ``mesh_cell``'s reckoning instead of a trace: each
device's argument bytes (the bf16 parameters by ``ShardingPlan.params``,
the ZeRO-1 AdamW state by ``opt_state``, the batch by ``batch`` and the
decode cache by ``cache``), with ``fits`` False where they alone exceed
the card's memory and None where they fit, since the temp and collective
bytes stay null (the record says why).  The one-card records keep
``mesh = "1xH100"``.  The trace touches no device, so the sweep runs on
the CPU:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 6 \\
      --out build/dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --mesh production --out build/dryrun_mesh.json

(``--jobs``: worker processes; an extrapolated cell's two traces are two
jobs.)  ``--execute`` then runs each cell the sweep reckons to fit on the
card (``execute_fitting``), with seeded weights drawn there, random
caches and ragged decode positions: one warm-up call, then a few timed
ones.  It prints the measured peak (``torch.cuda.max_memory_allocated``)
beside the reckoned arguments plus temp, the step's median device time
and spread beside the roofline's ``t_total``, and the kernels' launches
beside the trace's wrapper calls.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import gc
import json
import multiprocessing
import os
import statistics
import time
import traceback

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.device import observe_kernels, resolve
from repro_torch.distributed.sharding import make_plan, placement_bytes
from repro_torch.kernels import ops
from repro_torch.launch.analysis import Counter, Roofline
from repro_torch.launch.mesh import (HBM_BYTES, MESH, make_edge_mesh,
                                     make_production_mesh)
from repro_torch.models.api import build_model
from repro_torch.nn.spec import tree_leaves as dict_leaves
from repro_torch.train.optimizer import adamw_init

MESHES = {"production": lambda: make_production_mesh(),
          "multipod": lambda: make_production_mesh(multi_pod=True),
          "edge": lambda: make_edge_mesh()}
NO_GSPMD = ("eager torch has no GSPMD partitioner to lower the cell per "
            "device: temp and collective bytes are not reckoned on a mesh")

def tree_bytes(tree) -> int:
    """Bytes of the storages of a tree's tensors (dicts, tuples and the
    AdamW state's named tuple)."""
    return sum(t.untyped_storage().nbytes() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def cell_call(model, shape, params):
    """(entry point, its arguments) of ``shape``'s kind, the JAX dry run's
    choice (``dryrun.py:67-86``): the train step with an AdamW state, the
    monolithic prefill, or one decode step over a dense cache of
    ``shape.seq_len`` positions; the batch and cache on ``params``'s
    device (``meta``: stand-ins)."""
    if shape.kind == "train":
        return model.make_train_step(), (params, adamw_init(params),
                                         model.input_specs(shape))
    if shape.kind == "prefill":
        return model.prefill, (params, model.input_specs(shape))
    cache = model.abstract_cache(shape.global_batch, shape.seq_len)
    return model.serve_step, (params, cache, model.input_specs(shape))


def _count(model, shape) -> dict:
    """The counter's totals over one trace of ``shape``'s entry point."""
    fn, args = cell_call(model, shape, model.abstract(torch.bfloat16))
    with Counter(args) as c:
        out = fn(*args)
        out_bytes = c.output_bytes(out)
        del out
    return {"flops": c.flops, "hbm_bytes": c.hbm_bytes,
            "argument_size_in_bytes": tree_bytes(args),
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": c.peak_bytes,
            "kernel_calls": c.kernel_calls}


def extrapolated(model, shape, points: tuple) -> dict:
    """``_count`` at ``shape.seq_len`` from traces at the two shorter
    lengths ``points``, on the line through them.  For xlstm's training
    and prefill cells, whose sLSTM walks its tokens in a Python loop (a
    ``meta`` trace of 32,768 steps takes tens of minutes): every count
    there is affine in S at multiples of 512 (the mLSTM's 256-token
    chunks, the loss's 512-token chunks), as
    ``tests/test_torch_dryrun.py`` checks against a whole trace.  The
    peak is not: it grows faster than the line, so the extrapolated
    ``temp_size_in_bytes`` is a lower bound (the test checks that too)."""
    a, b = (_count(model, dataclasses.replace(shape, seq_len=s))
            for s in points)
    return _on_line(a, b, points, shape.seq_len)


def _on_line(a: dict, b: dict, points: tuple, S: int) -> dict:
    f = (S - points[0]) / (points[1] - points[0])
    out = {k: round(a[k] + f * (b[k] - a[k])) for k in a
           if k != "kernel_calls"}
    out["kernel_calls"] = {k: round(a["kernel_calls"][k] + f * (
        b["kernel_calls"][k] - a["kernel_calls"][k]))
        for k in a["kernel_calls"]}
    return out


# the cells traced at two shorter lengths and extrapolated (``extrapolated``)
EXTRAPOLATED = {("xlstm", "train"): (512, 1024),
                ("xlstm", "prefill"): (512, 1024)}


def _points(cfg, shape) -> tuple | None:
    points = EXTRAPOLATED.get((cfg.block_kind, shape.kind))
    return points if points and shape.seq_len > points[1] else None


def _record(rec: dict, n: dict, points, t_trace: float) -> dict:
    """A traced cell's record from its counts ``n``."""
    roof = Roofline(float(n["flops"]), float(n["hbm_bytes"]), 0.0)
    mem = {k: n[k] for k in ("argument_size_in_bytes", "output_size_in_bytes",
                             "temp_size_in_bytes")}
    fits = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
            <= HBM_BYTES)
    if points:  # temp is a lower bound: only "does not fit" is known
        rec["extrapolated_from"] = list(points)
        fits = False if not fits else None
    return {**rec, "status": "ok", "t_trace_s": round(t_trace, 2),
            "roofline": roof.as_dict(), "t_total_s": roof.t_total,
            "memory": mem, "fits": fits, "kernel_calls": n["kernel_calls"]}


def _error(rec: dict, e: Exception) -> dict:
    return {**rec, "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc(limit=-3)}


def _head(arch: str, shape_name: str, cfg):
    """(the record's first keys, the skip reason or None)."""
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
           "kind": shape.kind}
    ok, reason = shape_applicable(cfg, shape)
    return rec, (None if ok else reason)


def trace_cell(arch: str, shape_name: str, cfg=None) -> dict:
    """Trace one cell on ``meta`` under the counter; returns its record
    (``status`` ``ok``/``skipped``/``error``, with the reason).  ``cfg``
    replaces the published config (the tests' reduced sizes)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    rec, skip = _head(arch, shape_name, cfg)
    if skip:
        return {**rec, "status": "skipped", "reason": skip}
    points = _points(cfg, shape)
    t0 = time.perf_counter()
    try:
        model = build_model(cfg)
        n = (extrapolated(model, shape, points) if points
             else _count(model, shape))
    except Exception as e:  # noqa: BLE001 -- recorded, as the JAX dry run
        return _error(rec, e)
    return _record(rec, n, points, time.perf_counter() - t0)


def count_at(arch: str, shape_name: str, seq_len: int | None):
    """One trace of a published cell (at ``seq_len`` where given): (its
    counts or the error's record keys, seconds).  A worker's job in a
    parallel sweep."""
    shape = SHAPES[shape_name]
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    t0 = time.perf_counter()
    try:
        n = _count(build_model(get_config(arch)), shape)
    except Exception as e:  # noqa: BLE001 -- recorded, as the JAX dry run
        n = _error({}, e)
    return n, time.perf_counter() - t0


def mesh_arguments(cfg, shape, mesh) -> dict:
    """Each device's argument bytes of ``shape``'s entry point on
    ``mesh`` by ``make_plan``'s placements: the bf16 parameters, and for
    a train cell the AdamW state (int32 step; fp32 m, v and master under
    ZeRO-1), the batch, and for a decode cell the dense cache."""
    model = build_model(cfg)
    plan = make_plan(cfg, mesh)
    spec = model.spec
    specs = dict_leaves(spec)

    def total(shapes_dtypes, placements) -> int:
        return sum(placement_bytes(sh, dt, pl, mesh)
                   for (sh, dt), pl in zip(shapes_dtypes, placements))

    out = {"params": total([(s.shape, torch.bfloat16) for s in specs],
                           dict_leaves(plan.params(spec)))}
    if shape.kind == "train":
        opt = plan.opt_state(spec)
        out["opt_state"] = 4 + 3 * total(
            [(s.shape, torch.float32) for s in specs], dict_leaves(opt.m))
    batch = model.input_specs(shape)
    out["batch"] = total([(t.shape, t.dtype) for t in dict_leaves(batch)],
                         dict_leaves(plan.batch(batch)))
    if shape.kind == "decode":
        cache = model.abstract_cache(shape.global_batch, shape.seq_len)
        out["cache"] = total([(t.shape, t.dtype) for t in cache.values()],
                             list(plan.cache(cfg, cache).values()))
    return out


def mesh_cell(arch: str, shape_name: str, mesh, cfg=None) -> dict:
    """One cell's record on ``mesh`` (``mesh_arguments``): per-device
    argument bytes, ``fits`` False where they exceed the card's memory
    and None where they fit (the temp is not known), temp and collective
    bytes null (``NO_GSPMD``)."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": str(mesh),
           "kind": shape.kind}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {**rec, "status": "skipped", "reason": reason}
    try:
        parts = mesh_arguments(cfg, shape, mesh)
    except Exception as e:  # noqa: BLE001 -- recorded, as the JAX dry run
        return _error(rec, e)
    args = sum(parts.values())
    return {**rec, "status": "ok", "devices": mesh.size,
            "arguments_by_part": parts,
            "memory": {"argument_size_in_bytes": args,
                       "output_size_in_bytes": None,
                       "temp_size_in_bytes": None},
            "collective_bytes": None, "null_because": NO_GSPMD,
            "fits": False if args > HBM_BYTES else None}


def _parallel(cells: list, jobs: int):
    """Yields the record of each (arch, shape) of ``cells`` as its traces
    finish, on ``jobs`` worker processes: an extrapolated cell's two
    traces are two jobs, the longest submitted first."""
    pending = {}  # cell -> [rec, points, counts by seq_len, seconds]
    work = []
    for arch, shape_name in cells:
        cfg = get_config(arch)
        rec, skip = _head(arch, shape_name, cfg)
        if skip:
            yield {**rec, "status": "skipped", "reason": skip}
            continue
        points = _points(cfg, SHAPES[shape_name])
        pending[arch, shape_name] = [rec, points, {}, 0.0]
        work += [(-(s or 0), arch, shape_name, s) for s in points or (None,)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) as pool:
        futures = {pool.submit(count_at, arch, shape_name, s):
                   (arch, shape_name, s)
                   for _, arch, shape_name, s in sorted(work)}
        for fut in concurrent.futures.as_completed(futures):
            arch, shape_name, s = futures[fut]
            cell = pending[arch, shape_name]
            rec, points, counts, _ = cell
            n, dt = fut.result()
            counts[s] = n
            cell[3] += dt
            if len(counts) < len(points or (None,)):
                continue
            errors = [c for c in counts.values() if c.get("status")]
            if errors:
                yield {**rec, **errors[0]}
            elif points:
                yield _record(rec, _on_line(counts[points[0]],
                                            counts[points[1]], points,
                                            SHAPES[shape_name].seq_len),
                              points, cell[3])
            else:
                yield _record(rec, counts[None], None, cell[3])


def sweep(archs=ARCH_IDS, shapes=tuple(SHAPES), out: str | None = None,
          verbose: bool = True, jobs: int = 1) -> list:
    """``trace_cell`` over archs x shapes (on ``jobs`` worker processes
    where ``jobs`` > 1); with ``out``, resumes from the records of an
    existing file (``ok`` and ``skipped`` cells are kept) and writes the
    file after each cell."""
    results = []
    if out and os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"]) for r in results
            if r["status"] in ("ok", "skipped")}
    cells = []
    for arch in archs:
        for shape in shapes:
            if (arch, shape) not in done:
                cells.append((arch, shape))
            elif verbose:
                print(f"[dryrun] {arch} x {shape} cached, skipping",
                      flush=True)
    records = (_parallel(cells, jobs) if jobs > 1 and cells
               else (trace_cell(arch, shape) for arch, shape in cells))
    for rec in records:
        results = [r for r in results
                   if (r["arch"], r["shape"]) != (rec["arch"], rec["shape"])]
        results.append(rec)
        if verbose:
            print(line(rec), flush=True)
        if out:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            with open(out, "w") as f:
                json.dump(results, f, indent=1)
    return results


def line(rec: dict) -> str:
    """One printed row of a record."""
    head = f"[dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']}:"
    if rec["status"] != "ok":
        return f"{head} {rec['status']} ({rec.get('reason') or rec['error']})"
    m = rec["memory"]
    if "roofline" not in rec:  # a mesh cell: arguments only
        parts = ", ".join(f"{k} {v / 1e9:.3f}"
                          for k, v in rec["arguments_by_part"].items())
        return (f"{head} ok, fits={rec['fits']} args "
                f"{m['argument_size_in_bytes'] / 1e9:.3f} GB a device "
                f"({parts} GB), temp and collectives not reckoned")
    r = rec["roofline"]
    return (f"{head} ok, fits={rec['fits']} args "
            f"{m['argument_size_in_bytes'] / 1e9:.2f} GB temp "
            f"{m['temp_size_in_bytes'] / 1e9:.2f} GB, flops "
            f"{r['flops_per_device']:.3e} bytes {r['bytes_per_device']:.3e}"
            f" -> bound {rec['t_total_s'] * 1e3:.3f} ms ({r['bottleneck']}),"
            f" traced in {rec['t_trace_s']:.1f} s"
            + (f" (extrapolated from S {rec['extrapolated_from']})"
               if "extrapolated_from" in rec else ""))


# ---------------------------------------------------------- on the card

# a measured peak above its reckoning by more than this fraction (the
# caching allocator's rounding, the libraries' workspaces) is a finding
PEAK_TOLERANCE = 0.10
# an executed cell's timed calls after its warm-up call: as many as take
# about TIMED_S seconds, at least MIN_CALLS and at most MAX_CALLS
MIN_CALLS, MAX_CALLS, TIMED_S = 2, 5, 2.0
# each kernel wrapper the trace counts calls of (``device.kernel_wrapper``
# names it by its function) -> (its kernel in ``kernels/ops.py``, the
# attribute there that counts its launches)
COUNTERS = {
    "dense_matmul_fwd": ("dense_matmul", "launches"),
    "paged_decode": ("paged_decode", "launches"),
    "paged_decode_quant": ("paged_decode_quant", "launches"),
    "paged_verify": ("paged_verify", "launches"),
    "paged_verify_quant": ("paged_verify_quant", "launches"),
    "flash_decode": ("flash_decode", "launches"),
    "flash_decode_quant": ("flash_decode_quant", "launches"),
    "flash_attention_fwd": ("flash_attention", "launches"),
    "flash_attention_bwd": ("flash_attention", "bwd_launches"),
    "rmsnorm_fwd": ("rmsnorm", "launches"),
    "rmsnorm_bwd": ("rmsnorm", "bwd_launches"),
    "grouped_matmul_fwd": ("grouped_matmul", "launches"),
    "grouped_matmul_bwd": ("grouped_matmul", "bwd_launches"),
    "ssd_scan_fwd": ("ssd_scan", "launches"),
    "ssd_scan_bwd": ("ssd_scan", "bwd_launches")}


def launch_counts() -> dict:
    """Each kernel wrapper's launches so far, by ``COUNTERS``'s names."""
    return {name: getattr(getattr(ops, kernel), attr)
            for name, (kernel, attr) in COUNTERS.items()}


class FirstCalls:
    """An observer (``device.observe_kernels``) that keeps a copy of each
    kernel wrapper's first call, as the kernel saw it:
    ``calls[name] = (args, kwargs, out)``."""

    def __init__(self):
        self.calls = {}

    def kernel(self, name, fn, args, kwargs):
        if name in self.calls:
            return fn(*args, **kwargs)
        copy = _tree_map(lambda t: t.clone(), (args, kwargs))
        out = fn(*args, **kwargs)
        self.calls[name] = (*copy, _tree_map(lambda t: t.clone(), out))
        return out


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


# recurrent states that hold sums of positive gates (the sLSTM's
# normalizer): drawn as |normal|
POSITIVE_STATES = ("sn",)


def _real(t: torch.Tensor, name: str, shape, device, gen) -> torch.Tensor:
    """A real tensor for a ``meta`` input, made from ``gen``: token ids
    below the vocab, normal frames, and the decode step of a batch whose
    slots sit at ragged positions: each slot's position drawn from
    [S/2, S - 3], its cache rows (``pos_map``) filled up to two entries
    past it (a rejected draft's stale rows, masked by position) and empty
    (-1) beyond, every float cache leaf (K/V and recurrent states) normal
    values."""
    S, vocab = shape
    if name in ("tokens", "labels"):
        return torch.randint(0, vocab, t.shape, generator=gen,
                             device=device, dtype=t.dtype)
    if name == "pos":
        return torch.randint(S // 2, S - 2, t.shape, generator=gen,
                             device=device, dtype=t.dtype)
    if t.is_floating_point():
        x = torch.empty(t.shape, dtype=t.dtype, device=device)
        x.normal_(generator=gen)
        return x.abs_() if name in POSITIVE_STATES else x
    return torch.zeros(t.shape, dtype=t.dtype, device=device)


def _pos_map(pos: torch.Tensor, S: int) -> torch.Tensor:
    """pos_map rows [B, S]: entry j holds position j up to two entries
    past the slot's position, -1 beyond."""
    pm = torch.arange(S, dtype=torch.int32, device=pos.device)
    pm = pm.expand(pos.shape[0], S).clone()
    pm[pm > pos[:, None] + 2] = -1
    return pm


def real_call(model, shape, params, seed: int = 0) -> tuple:
    """(entry point, its arguments) of ``cell_call`` with real values on
    ``params``'s device (``_real``): params as given, a fresh AdamW state
    for the train step."""
    dev = tree_leaves(params)[0].device
    fn, meta_args = cell_call(model, shape, model.abstract(torch.bfloat16))
    gen = torch.Generator(device=dev).manual_seed(seed)
    limits = (shape.seq_len, model.cfg.vocab)

    def real(tree, name=""):
        if isinstance(tree, dict):
            return {k: real(v, k) for k, v in tree.items()}
        return _real(tree, name, limits, dev, gen)

    if shape.kind == "train":
        return fn, (params, adamw_init(params), real(meta_args[2]))
    extra = [real(a) for a in meta_args[1:]]
    if shape.kind == "decode" and "pos_map" in extra[0]:
        extra[0]["pos_map"] = _pos_map(extra[1]["pos"], shape.seq_len)
    return fn, (params, *extra)


def execute_cell(arch: str, shape_name: str, rec: dict, seed: int = 0,
                 hold=None) -> dict:
    """Run one traced cell for real on the card: seeded bf16 weights drawn
    there, the batch and cache from ``real_call``.  One warm-up call, under
    ``FirstCalls``, counts the launches and gives ``hold`` (if any) each
    kernel's first call; then ``MIN_CALLS``-``MAX_CALLS`` timed calls
    (CUDA events) and their peak memory.  Returns the measured peak beside
    the reckoned one, the median, least and largest step time beside the
    roofline's bound, the launches beside the trace's wrapper calls, and
    whether the warm-up's outputs were finite."""
    dev = resolve(None)
    model = build_model(get_config(arch))
    shape = SHAPES[shape_name]
    fn, args = real_call(model, shape, model.init(seed, torch.bfloat16,
                                                  device=dev), seed)
    grad = torch.enable_grad if shape.kind == "train" else torch.no_grad
    first = FirstCalls()
    before = launch_counts()
    t0 = time.perf_counter()
    with grad(), observe_kernels(first):
        out = fn(*args)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    # the step's own result: the logits (or next tokens) of prefill and
    # decode, the train step's metrics; the caches and state it returns
    # are its inputs, updated
    head = out[2] if shape.kind == "train" else out[0]
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(head)
                 if t.is_floating_point())
    del out, head
    if hold is not None:
        hold(first.calls)
    del first
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    while len(times) < MIN_CALLS or (len(times) < MAX_CALLS
                                     and sum(times) < TIMED_S * 1e3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        with grad():
            out = fn(*args)
        end.record()
        del out
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated(dev)
    reckoned = (rec["memory"]["argument_size_in_bytes"]
                + rec["memory"]["temp_size_in_bytes"])
    del args
    return {"arch": arch, "shape": shape_name,
            "measured_peak_bytes": peak, "reckoned_bytes": reckoned,
            "within_tolerance": peak <= reckoned * (1 + PEAK_TOLERANCE),
            "warmup_s": warm_s, "step_ms": statistics.median(times),
            "step_ms_min": min(times), "step_ms_max": max(times),
            "calls": len(times), "bound_ms": rec["t_total_s"] * 1e3,
            "launches": launches, "trace_calls": rec["kernel_calls"],
            "launches_match": launches == rec["kernel_calls"],
            "finite": finite}


def execute_fitting(records: list, hold=None) -> list:
    """``execute_cell`` for each record reckoned to fit one card (``hold``
    gets each cell's kernel first calls, with the cell as ``where``)."""
    results = []
    for rec in records:
        if rec["status"] != "ok" or not rec["fits"]:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        where = f"{rec['arch']} x {rec['shape']}"
        results.append(execute_cell(
            rec["arch"], rec["shape"], rec,
            hold=None if hold is None else
            functools.partial(hold, where=where)))
    gc.collect()
    torch.cuda.empty_cache()
    return results


def executed_line(got: dict) -> str:
    """One printed row of an executed cell."""
    return (f"[dryrun] executed {got['arch']} x {got['shape']}: measured "
            f"peak {got['measured_peak_bytes'] / 1e9:.3f} GB, reckoned "
            f"(arguments + temp) {got['reckoned_bytes'] / 1e9:.3f} GB, "
            f"ratio {got['measured_peak_bytes'] / got['reckoned_bytes']:.4f}"
            f" ({'within' if got['within_tolerance'] else 'OVER, a finding:'}"
            f" tolerance +{PEAK_TOLERANCE:.0%}); step median "
            f"{got['step_ms']:.3f} ms (min {got['step_ms_min']:.3f}, max "
            f"{got['step_ms_max']:.3f}, {got['calls']} calls after a "
            f"{got['warmup_s']:.2f} s warm-up; CUDA events) against the "
            f"bound {got['bound_ms']:.3f} ms; launches {got['launches']} "
            f"(the trace's calls: "
            f"{'equal' if got['launches_match'] else got['trace_calls']}); "
            f"finite {got['finite']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append",
                    help="an arch to trace (repeatable; default: all)")
    ap.add_argument("--shape", action="append",
                    help="a shape to trace (repeatable; default: all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes tracing cells in parallel")
    ap.add_argument("--execute", action="store_true",
                    help="then run each cell that fits on the card")
    ap.add_argument("--mesh", choices=["single", *MESHES], default="single",
                    help="reckon per-device arguments on an H100 mesh "
                         "(mesh.py) instead of tracing on one card")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else args.arch
    shapes = list(SHAPES) if (args.all or not args.shape) else args.shape
    t0 = time.perf_counter()
    if args.mesh != "single":
        mesh = MESHES[args.mesh]()
        results = [mesh_cell(a, s, mesh) for a in archs for s in shapes]
        for rec in results:
            print(line(rec), flush=True)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        return int(any(r["status"] == "error" for r in results))
    results = sweep(archs, shapes, args.out, jobs=args.jobs)
    n = {s: sum(r["status"] == s for r in results)
         for s in ("ok", "skipped", "error")}
    print(f"[dryrun] done: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} errors in {time.perf_counter() - t0:.1f} s -> "
          f"{args.out}", flush=True)
    bad = n["error"]
    if args.execute:
        for got in execute_fitting(results):
            print(executed_line(got), flush=True)
            bad += not (got["launches_match"] and got["finite"])
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
