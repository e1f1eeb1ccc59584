"""The dense product of the column-cut projections
(``kernels/dense_matmul.py``) against another tree's, in turns on one card:
the same shapes, the same inputs, each tree in its own process.

    PYTHONPATH=src python scripts/dense_turns.py --parent DIR
    # DIR: another checkout (say a `git archive` of the parent commit under
    # the git-ignored build/), run in the order parent, this, this, parent
    python scripts/dense_turns.py --src DIR     # one tree's readings alone
    PYTHONPATH=src python scripts/dense_turns.py --sweep  # other plans

Shapes: ``chip_smoke.py`` phase 4's (``ROWS``): the projections [K, N] of
llama3.2-3b, qwen2-0.5b and chameleon-34b (gate/up, wq, down, and the k/v
projections) at a decode tick (M 8) and a 1024-token prompt, and
qwen2-0.5b's training batch (M 8192), bf16, each with the weights of enough
layers to pass 100 MB taken in turn (each call reads its w from HBM, as
the model does).  A reading is, per shape: the kernel's device time alone
(``torch.profiler``, the fullest of up to three sessions) and the kernels
it launches a call; CUDA events over 240 back-to-back calls (the host's
rate where it is the slower); ``torch.matmul``'s device time and events
on the same inputs; and the plan that ran.  Then, at llama3.2-3b's decode
gate/up, the host's share of a call piece by piece (``host_pieces``).

Prints the card's name and power limit, one line a reading and a table
of each tree's median beside the others.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (config, projection, M, K, N): chip_smoke.py DENSE_TIMING
ROWS = [(arch, proj, M, K, N)
        for arch, shapes in (
            ("llama3.2-3b", (("gate/up", 3072, 8192), ("wq", 3072, 3072),
                             ("down", 8192, 3072), ("wk/wv", 3072, 1024))),
            ("qwen2-0.5b", (("gate/up", 896, 4864), ("wq", 896, 896),
                            ("down", 4864, 896), ("wk/wv", 896, 128))),
            ("chameleon-34b", (("gate/up", 8192, 22016),
                               ("wq", 8192, 8192), ("down", 22016, 8192))))
        for proj, K, N in shapes for M in (8, 1024)]
ROWS += [("qwen2-0.5b", proj, 8192, K, N)
         for proj, K, N in (("gate/up", 896, 4864), ("down", 4864, 896))]


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def one_tree(src: str) -> list:
    """This process's readings of the tree whose package lies under
    ``src``."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.kernels import dense_matmul as dm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def events_ms(fn, iters=240):
        for i in range(10):
            fn(i)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for i in range(iters):
            fn(i)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def device_ms(fn, calls=20):
        """(ms a call, kernels a call) by torch.profiler, the fullest of
        up to three sessions that recorded device time."""
        fn(0)
        torch.cuda.synchronize()
        best = (0.0, 0)
        for _ in range(6):
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            with prof:
                for i in range(calls):
                    fn(i)
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages()
                   if getattr(e, "device_type", None) is not None
                   and str(e.device_type).endswith("CUDA")]
            us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                     for e in evs)
            n = sum(e.count for e in evs)
            if us > best[0]:
                best = (us, n)
            if us == 0:
                time.sleep(0.5)
        return best[0] / calls / 1e3, best[1] / calls

    def describe(p) -> str:
        """The plan; a tree before tile widths ran [128 x 256] wgmma
        tiles."""
        wgmma = p.variant == "wgmma"
        rows = 128 if wgmma else 8 * p.rows8 or 32
        width = getattr(p, "width", 256 if wgmma else 64)
        return f"{p.variant} [{rows} x {width}] {p.splits}x{p.kt_per}"

    out = []
    g = torch.Generator(device=dev).manual_seed(0)
    for arch, proj, M, K, N in ROWS:
        L = max(1, min(24, -(-100_000_000 // (2 * K * N))))
        w = (torch.randn(L, K, N, device=dev, generator=g)
             * K ** -0.5).bfloat16()
        x = torch.randn(M, K, device=dev, generator=g).bfloat16()
        layers = [w[i] for i in range(L)]
        got = dm.dense_matmul(x, layers[0])
        want = x.float() @ layers[0].float()
        err = float((got.float() - want).abs().max())
        assert err <= 1e-4 + 2 ** -7 * float(want.abs().max()), (arch, proj,
                                                                 M, err)

        def kernel(i=0):
            dm.dense_matmul(x, layers[i % L])

        def library(i=0):
            torch.matmul(x, layers[i % L])

        dms, kernels = device_ms(kernel)
        lms, _ = device_ms(library)
        out.append(dict(arch=arch, proj=proj, M=M, K=K, N=N,
                        plan=describe(dm.plan(torch.bfloat16, M, K, N)),
                        device_ms=dms, kernels=kernels,
                        ms=events_ms(kernel), lib_device_ms=lms,
                        lib_ms=events_ms(library), err=err))
        del w, x, layers
        torch.cuda.empty_cache()
    out.append(host_pieces(torch, dm, dev))
    return out


def host_pieces(torch, dm, dev) -> dict:
    """The host's share of a decode call (llama3.2-3b's gate/up, M 8), by
    CUDA events over 240 back-to-back calls of: the whole wrapper;
    ``torch.matmul``; and, where the tree has the prepared launch
    (``dm._LAUNCHES``), the bare ctypes launch on a preallocated output;
    and by the host clock over 20,000 calls of what launches nothing: the
    output's ``torch.empty`` and the cache key's lookup."""
    w = (torch.randn(3072, 8192, device=dev) * 0.02).bfloat16()
    x = torch.randn(8, 3072, device=dev).bfloat16()

    def ev(fn, iters=240):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def host(fn, iters=20000):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3

    res = {"host": True,
           "wrapper_ms": ev(lambda: dm.dense_matmul(x, w)),
           "matmul_ms": ev(lambda: torch.matmul(x, w)),
           "empty_ms": host(lambda: torch.empty((8, 8192),
                                                dtype=torch.bfloat16,
                                                device=dev))}
    torch.cuda.synchronize()
    if hasattr(dm, "_LAUNCHES"):
        dm.dense_matmul(x, w)
        (key, entry), = [(k, e) for k, e in dm._LAUNCHES.items()
                         if k[2] == x.shape and k[3] == w.shape]
        o = torch.empty((8, 8192), dtype=torch.bfloat16, device=dev)
        run = dm._RUN
        xp, wp, op = x.data_ptr(), w.data_ptr(), o.data_ptr()
        res["ctypes_launch_ms"] = ev(lambda: run(entry[0], xp, wp, op,
                                                 key[-1]))
        res["lookup_ms"] = host(lambda: dm._LAUNCHES.get(key))
    return res


# the sweep's shapes: (config, projection, M, K, N): the decode ticks, a
# prefill chunk (M 64) of qwen2-0.5b and the prompts of all but the
# largest config
SWEEP = [r for r in ROWS if r[2] == 8] + [
    (arch, proj, 64, K, N) for arch, proj, M, K, N in ROWS
    if arch == "qwen2-0.5b" and M == 8] + [
    r for r in ROWS if r[2] == 1024 and r[0] != "chameleon-34b"]


def sweep(src: str) -> list:
    """Other plans than the tree's own at the sweep's shapes (``--sweep``,
    this tree only): at M 8 and 64 the mma.sync tiles of each width, each
    at its cheapest split (``tile_plan``) and at 1, 2, 4 and 8 splits; at
    M 1024 the
    wgmma kernel's [128 x 256] unsplit and [128 x 128] at 1-4 splits.
    Each launch's output is held to ``x @ w`` in fp32 and repeated bit
    for bit; returns (shape, plan, device ms a call, kernels a call)."""
    sys.path.insert(0, str(Path(src).resolve()))
    import ctypes

    import torch
    from repro_torch.kernels import dense_matmul as dm

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(1)
    dm.dense_matmul(torch.ones(8, 64, device=dev).bfloat16(),
                    torch.ones(64, 64, device=dev).bfloat16())  # the build
    out = []
    for arch, proj, M, K, N in SWEEP:
        L = max(1, min(24, -(-100_000_000 // (2 * K * N))))
        w = (torch.randn(L, K, N, device=dev, generator=g)
             * K ** -0.5).bfloat16()
        x = torch.randn(M, K, device=dev, generator=g).bfloat16()
        want = x.float() @ w[0].float()
        if M <= dm.SMALL_ROWS:
            kt, rows8 = -(-K // 64), dm._rows8(M)
            plans = []
            for width in dm.WIDTHS["mma_sync"]:
                plans += [dm.tile_plan("mma_sync", rows8, width, M, K, N)[1]]
                plans += [dm.Plan("mma_sync", rows8, width,
                                  -(-kt // -(-kt // s)), -(-kt // s))
                          for s in (1, 2, 4, 8) if s <= kt]
        else:
            plans = [dm.tile_plan("wgmma", 0, 256, M, K, N,
                                  max_splits=1)[1]]
            plans += [dm.Plan("wgmma", 0, 128, -(-(-(-K // 64)) // per),
                              per)
                      for per in sorted({-(-(-(-K // 64)) // s)
                                         for s in (1, 2, 3, 4)},
                                        reverse=True)]
        for p in dict.fromkeys(plans):
            outs = [torch.empty(M, N, device=dev, dtype=torch.bfloat16)
                    for _ in range(L)]
            launches = [dm.launch_args(p, x, w[i], 0, stream)
                        for i in range(L)]

            def call(i=0, p=p, outs=outs, launches=launches):
                err = dm._RUN(ctypes.addressof(launches[i % L]),
                              x.data_ptr(), w[i % L].data_ptr(),
                              outs[i % L].data_ptr(), stream)
                assert err == 0, err

            call(0)
            first = outs[0].clone()
            call(0)
            torch.cuda.synchronize()
            assert torch.equal(first, outs[0]), (arch, proj, M, p)
            err = float((first.float() - want).abs().max())
            assert err <= 1e-4 + 2 ** -7 * float(want.abs().max()), (p, err)
            prof = None
            for _ in range(4):
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                with prof:
                    for i in range(20):
                        call(i)
                    torch.cuda.synchronize()
                evs = [e for e in prof.key_averages()
                       if str(getattr(e, "device_type", "")).endswith("CUDA")]
                us = sum(getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                         for e in evs)
                if us:
                    break
            out.append(dict(arch=arch, proj=proj, M=M, K=K, N=N,
                            plan=f"{p.variant} [{p.rows} x {p.width}] "
                                 f"{p.splits}x{p.kt_per}",
                            units=p.ctas(M, N), device_ms=us / 20 / 1e3,
                            kernels=sum(e.count for e in evs) / 20))
        del w, x, want
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="read one tree (its src/) and print JSON")
    ap.add_argument("--parent", help="another checkout, run in turns")
    ap.add_argument("--sweep", action="store_true",
                    help="this tree's kernel under other plans")
    args = ap.parse_args()
    if args.src:
        print("READINGS " + json.dumps(one_tree(args.src)))
        return
    if args.sweep:
        print(f"[sweep] {smi()}")
        for r in sweep(str(ROOT / "src")):
            print(f"[sweep] {r['arch']} {r['proj']} M={r['M']} [{r['K']}, "
                  f"{r['N']}] {r['plan']} ({r['units']} units): device "
                  f"{r['device_ms']:.4f} ms ({r['kernels']:.1f} kernels a "
                  "call)")
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("dense_turns.py needs a CUDA card")
    print(f"[turns] {smi()}")
    trees = {"this": ROOT / "src"}
    order = ["this"]
    if args.parent:
        trees["parent"] = Path(args.parent).resolve() / "src"
        order = ["parent", "this", "this", "parent"]
    readings = {name: [] for name in trees}
    env = dict(os.environ, PYTHONPATH="")
    for name in order:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--src",
             str(trees[name])], capture_output=True, text=True, env=env,
            cwd=str(trees[name].parent))
        if proc.returncode != 0:
            sys.exit(f"{name} failed:\n{proc.stdout[-4000:]}"
                     f"{proc.stderr[-4000:]}")
        line, = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("READINGS ")]
        rows = json.loads(line[len("READINGS "):])
        readings[name].append(rows)
        for r in rows:
            if r.get("host"):
                print(f"[turns] {name} host pieces (llama3.2-3b gate/up, M "
                      "8): " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()
                                         if k != "host"))
                continue
            print(f"[turns] {name} {r['arch']} {r['proj']} M={r['M']} "
                  f"[{r['K']}, {r['N']}] {r['plan']}: device "
                  f"{r['device_ms']:.4f} ms ({r['kernels']:.1f} kernels a "
                  f"call), events {r['ms']:.4f}; torch.matmul device "
                  f"{r['lib_device_ms']:.4f}, events {r['lib_ms']:.4f}; "
                  f"max |err| {r['err']:.3g}")
        print(f"[turns] {name}: {time.perf_counter() - t0:.1f} s")
    print("[turns] medians (device ms, x torch.matmul's in the same run; "
          "events ms):")
    for i, (arch, proj, M, K, N) in enumerate(ROWS):
        cells = []
        for name in trees:
            runs = [rows[i] for rows in readings[name]]
            d = statistics.median(r["device_ms"] for r in runs)
            ratio = statistics.median(r["device_ms"] / r["lib_device_ms"]
                                      for r in runs)
            e = statistics.median(r["ms"] for r in runs)
            le = statistics.median(r["lib_ms"] for r in runs)
            cells.append(f"{name} {d:.4f} ({ratio:.2f} x; {runs[0]['plan']};"
                         f" events {e:.4f} vs {le:.4f})")
        print(f"[turns]   {arch} {proj} M={M}: " + " | ".join(cells))


if __name__ == "__main__":
    main()
