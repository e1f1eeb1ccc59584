"""What three design choices of the backward kernels are worth on the
card: each source is built as it stands and with one choice undone (a text
substitution of the source), and the builds are timed in turn.

    PYTHONPATH=src python scripts/bwd_kernel_variants.py [source ...]
    # sources: moe_gmm_bwd, ssd_scan_bwd, rmsnorm (default: all three)

* ``csrc/moe_gmm_bwd.cu``: as built, and with the epilogue's TMA stores
  left out (the accumulators still go through shared memory), which bounds
  what the stores cost; CUDA events over 30 calls at granite-moe-1b-a400m's
  gate/up and down shapes (C 2560) and qwen2-moe-a2.7b's expert shape.
* ``csrc/ssd_scan_bwd.cu``: as built, and with the products' trip counts
  read at run time at p = n = 64 too (the instantiations for other widths);
  each kernel's device time under ``torch.profiler`` at zamba2-2.7b's B 4 x
  S 1024 (80 heads of 64, state 64, chunk 256, bf16 x).
* ``csrc/rmsnorm.cu``'s backward: dscale summed (b) by a second kernel,
  one CTA an 8-column slice, as built, and (a) in the rows kernel after a
  grid-wide barrier of a cooperative launch (one launch a call; the
  variant's text patches the source), each CTA summing the slices
  blockIdx.x, blockIdx.x + grid, ... in the same order; device time a call
  under ``torch.profiler`` (both kernels of (b)) at the training shapes of
  ``RMS_SHAPES``, bf16, each variant's dx and dscale held to the plain
  version and to the other bit for bit.

Each variant is built by ``nvcc`` with ``kernels/build.py``'s flags into
``build/bwd_variants/``, and the variants run in the order as built, the
other, the other, as built.  Prints the card's name and power limit, then
one line per reading.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd_scan as sk

OUT = Path(__file__).resolve().parents[1] / "build" / "bwd_variants"
GMM_SHAPES = [("granite-moe gate/up", 32, 2560, 1024, 512),
              ("granite-moe down", 32, 2560, 512, 1024),
              ("qwen2-moe expert shape", 60, 688, 2048, 1408)]
VARIANTS = {
    "moe_gmm_bwd": {
        "without the TMA stores": [(
            "          wg::tma_store_3d(map, out + q * kBox, tl.n0 + 64 * q,",
            "          if (q < 0) wg::tma_store_3d(map, out + q * kBox, "
            "tl.n0 + 64 * q,")]},
    "ssd_scan_bwd": {
        "trip counts read at run time": [(
            "  const bool wide = tcb::pad16(P) == 64 && tcb::pad16(N) == 64;",
            "  const bool wide = false;")]},
    "rmsnorm": {"dscale after a grid barrier": [
        ("#include <cuda_bf16.h>\n",
         "#include <cooperative_groups.h>\n#include <cuda_bf16.h>\n"),
        ("  // dscale is rmsnorm_bwd_dscale's, from every CTA's partial\n",
         "  __shared__ float seg[kSegments * (kSlice + 1)];\n"
         "  cooperative_groups::this_grid().sync();\n"
         "  for (int u = blockIdx.x; u * kSlice < d; u += gridDim.x)\n"
         "    sum_slice<ST>(partial, dscale, gridDim.x, d, u, seg);\n"),
        # the partials written by this launch, read through L2
        ("v[k] = g < grid ? partial[static_cast<size_t>(g) * d + c] : 0.f;",
         "v[k] = g < grid ? __ldcg(partial + static_cast<size_t>(g) * d + c)"
         " : 0.f;"),
        ("  kernel<<<grid, kBwdThreads, smem, stream>>>(xp, sp, gp, dxp, "
         "partial, dsp,\n",
         "  void* args[] = {&xp, &sp, &gp, &dxp, &partial, &dsp, &rows, &d,\n"
         "                  &eps, &zero_centered, &tpr};\n"
         "  return static_cast<int>(cudaLaunchCooperativeKernel(\n"
         "      reinterpret_cast<const void*>(kernel), dim3(grid),\n"
         "      dim3(kBwdThreads), args, smem, stream));\n"
         "  kernel<<<grid, kBwdThreads, smem, stream>>>(xp, sp, gp, dxp, "
         "partial, dsp,\n")]},
}
# the RMSNorm backward's shapes (label, rows, d): qwen2-0.5b,
# granite-moe-1b-a400m and gemma3-1b at B 8 x S 1024, gemma3-1b's qk-norm
# rows, zamba2-2.7b's two widths and xlstm-1.3b's at their training batches
RMS_SHAPES = [("qwen2-0.5b", 8192, 896), ("granite-moe", 8192, 1024),
              ("gemma3-1b", 8192, 1152), ("qk-norm", 32768, 256),
              ("zamba2", 4096, 2560), ("zamba2 cat", 4096, 5120),
              ("xlstm d_in", 2048, 4096), ("xlstm", 2048, 2048)]


def build_variant(name: str, label: str, subs: list) -> ctypes.CDLL:
    """csrc/<name>.cu with the substitutions (each must apply), built and
    loaded."""
    src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"{name}: the variant '{label}' no longer "
                               f"applies: {old!r} is not in the source")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    tag = "as_built" if not subs else label.replace(" ", "_")
    path = OUT / f"{name}-{tag}.cu"
    path.write_text(src)
    lib = OUT / f"{name}-{tag}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(path)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def events_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def gmm(libs: dict):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.grouped_matmul_bwd_launch.argtypes = ([i32] + [ptr] * 5
                                                  + [i32] * 8 + [ptr])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    names = list(libs)
    for label, E, C, K, N in GMM_SHAPES:
        x, w, dy = (torch.randn(s, device="cuda", dtype=torch.bfloat16)
                    for s in ((E, C, K), (E, K, N), (E, C, N)))
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        stream = torch.cuda.current_stream().cuda_stream
        readings = []
        for name in (names[0], names[1], names[1], names[0]):
            lib = libs[name]

            def call(lib=lib):
                err = lib.grouped_matmul_bwd_launch(
                    1, x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                    dx.data_ptr(), dw.data_ptr(), E, C, K, N, 1, 1, 1, sms,
                    stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            readings.append(f"{name} {events_ms(call):.4f}")
        want = mg.grouped_matmul_bwd_ref(x, w, dy)
        print(f"grouped_matmul_bwd, {label} (E {E}, C {C}, K {K}, N {N}), "
              "ms a call by CUDA events: " + "; ".join(readings)
              + f" (dx of the last call off {_rel(dx, want[0]):.2e})",
              flush=True)


def _short(kernel: str) -> str:
    """A profiler kernel name without its namespace and arguments."""
    name = kernel.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def device_ms(fn, calls: int = 10) -> tuple:
    """Device time a call of ``fn`` under ``torch.profiler`` and its split
    by kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    parts = {_short(e.key): e.self_device_time_total / calls / 1e3
             for e in prof.key_averages()
             if e.device_type == cuda and e.self_device_time_total > 0}
    return sum(parts.values()), parts


def rms(libs: dict):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.rmsnorm_bwd_launch.argtypes = ([i32, i32] + [ptr] * 6
                                           + [i32] * 2 + [ctypes.c_float]
                                           + [i32] * 5 + [ptr])
    names = list(libs)
    dt = torch.bfloat16
    for label, rows, d in RMS_SHAPES:
        x, dy = (torch.randn(rows, d, device="cuda", dtype=dt)
                 for _ in range(2))
        s = (1 + 0.5 * torch.randn(d, device="cuda")).to(dt)
        dx, ds = torch.empty_like(x), torch.empty_like(s)
        plan = rn.bwd_plan(rows, d, dt)
        partial = torch.empty(plan.grid, d, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        want = rn.rmsnorm_bwd_ref(x, s, dy)
        readings, outs = [], {}
        for name in (names[0], names[1], names[1], names[0]):
            lib = libs[name]

            def call(lib=lib):
                err = lib.rmsnorm_bwd_launch(
                    1, 1, x.data_ptr(), s.data_ptr(), dy.data_ptr(),
                    dx.data_ptr(), partial.data_ptr(), ds.data_ptr(), rows,
                    d, 1e-6, 0, *plan, stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            ms, parts = device_ms(call)
            outs[name] = (dx.clone(), ds.clone())
            readings.append(f"{name} {ms:.4f} (" + "; ".join(
                f"{k} {v:.4f}" for k, v in parts.items()) + ")")
        same = all(torch.equal(a, b) for a, b in zip(*outs.values()))
        print(f"rmsnorm_bwd, {label} [{rows}, {d}] bf16 {tuple(plan)}, ms a "
              "call of device time: " + "; ".join(readings)
              + f" (dx off {_rel(outs[names[0]][0], want[0]):.2e}, dscale "
              f"{_rel(outs[names[0]][1], want[1]):.2e}; the two "
              f"{'bit-equal' if same else 'DIFFER'})", flush=True)


def scan(libs: dict):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.ssd_scan_bwd_launch.argtypes = [i32] + [ptr] * 14 + [i32] * 6 \
            + [ptr]
    b, S, h, p, n, Q = 4, 1024, 80, 64, 64, 256
    x = torch.randn(b, S, h, p, device="cuda").bfloat16()
    dt = torch.rand(b, S, h, device="cuda") * 0.2 + 0.01
    a_neg = -torch.rand(h, device="cuda") * 2 - 0.5
    B, C = (torch.randn(b, S, n, device="cuda").bfloat16() for _ in "BC")
    dy = torch.randn(b, S, h, p, device="cuda")
    outs = [torch.empty_like(t) for t in (x, dt, a_neg, B, C)]
    scratch = torch.empty(sk.bwd_scratch_bytes(b, S, h, p, n, Q) // 4,
                          device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    names = list(libs)
    for name in (names[0], names[1], names[1], names[0]):
        lib = libs[name]

        def call(lib=lib):
            err = lib.ssd_scan_bwd_launch(
                1, x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(),
                B.data_ptr(), C.data_ptr(), None, dy.data_ptr(), None,
                *(t.data_ptr() for t in outs), scratch.data_ptr(), b, S, h,
                p, n, Q, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        ms, parts = device_ms(call)
        print(f"ssd_scan_bwd, zamba2 B {b} x S {S}, {name}: "
              f"{ms:.4f} ms a call of device time ("
              + "; ".join(f"{k} {v:.4f}" for k, v in parts.items()) + ")",
              flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    runs = {"moe_gmm_bwd": gmm, "ssd_scan_bwd": scan, "rmsnorm": rms}
    for name in sys.argv[1:] or runs:
        run = runs[name]
        libs = {"as built": build_variant(name, "as built", [])}
        for label, subs in VARIANTS[name].items():
            libs[label] = build_variant(name, label, subs)
        run(libs)


if __name__ == "__main__":
    main()
