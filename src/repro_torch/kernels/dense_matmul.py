"""Dense product of the column-cut projections: the wrapper of the
hand-written CUDA kernel ``csrc/dense_matmul.cu`` and its plain PyTorch
version.

The kernel replaces no Pallas kernel.  The JAX package computes its
projections with jnp (``repro/models/lm.py:121-137, 289-291, 303-315``;
``moe.py:160-166``) and its tensor-parallel guarantee rests on XLA's dot
being column-sliceable; cuBLAS, which ``x @ w`` reaches on the card, is
not.  The port calls ``dense_matmul`` for every projection whose weight
tensor parallelism cuts by columns (``models/lm.py`` ``dense``), in the
unsharded and the sharded engines alike.  The source note in the ``.cu``
file says what bounds it on an H100 and what its design does about that.

``plan`` chooses the variant, the tile width and the K split from
(dtype, M, K, plan_n) and the card's SM count alone; a tensor-parallel
rank holding N / tp columns passes the global N as ``plan_n``, so that its
product equals those columns of the unsharded product bit for bit.  Every
call is one kernel launch: where K is split, the tile's last CTA to arrive
sums the splits' partials.

``dense_matmul`` runs the plain version ``x @ w`` for tensors on the CPU
or on ``meta`` (so the dry run's counter sees an ``aten.mm``); for CUDA
tensors it launches the kernel or raises, never falling back.  It counts
its launches in its ``launches`` attribute (a plain integer).  The checks
and the launch's arguments are prepared once for each (dtype, shapes,
alignment, device, stream) and cached, so a decode call's host work is a
dictionary lookup, the output's allocation and one ctypes call.

Training: where grad mode is on and x or w requires grad, ``dense_matmul``
is the apply of ``DenseMatmul``, a ``torch.autograd.Function`` whose
backward is ``dx = dy w^T`` and ``dw = x^T dy`` in ``torch.matmul``: the
JAX package differentiates these products with XLA, and training under
tensor parallelism is a path of neither package.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.device import kernel_wrapper, on_cpu
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # x, w and the output
VARIANTS = {"fp32": 0, "mma_sync": 1, "wgmma": 2}  # csrc enum Variant
SMS = 132  # streaming multiprocessors of an H100 SXM
SMALL_ROWS = 64  # bf16 rows up to which the mma.sync tiles run
# (rows of x a tile or None: 8 rows8, columns a tile or None: the plan's
# width, K depth of a step) of each variant
TILES = {"fp32": (32, 64, 32), "mma_sync": (None, None, 64),
         "wgmma": (128, None, 64)}
RESIDENT = {"fp32": 2, "mma_sync": 2, "wgmma": 1}  # CTAs an SM holds
# a tile's columns by variant (the wgmma kernel's default first)
WIDTHS = {"fp32": (64,), "mma_sync": (64, 128), "wgmma": (256, 128)}
# ``split_cost``'s constants, fitted to an H100's readings of
# ``scripts/dense_turns.py --sweep``.  The bytes-bound tiles (M <= 64) in
# seconds: one CTA streams w at STREAM bytes/s by its width (x's rows
# besides), the card at CARD; the wgmma kernel in [128 x 128] K steps, a
# [128 x 256] step 1.85 of them.  A split's end each wave (the partial's
# write and the arrival) and a round of the last CTA's partial loads:
STREAM = {64: 19e9, 128: 34e9}
CARD = {64: 2.6e12, 128: 2.85e12}
WGMMA_STEP = {128: 1.0, 256: 1.85}
SPLIT = {"fp32": 2.3e-6, "mma_sync": 2.3e-6, "wgmma": 15}
ROUND = {"fp32": 0.5e-6, "mma_sync": 0.5e-6, "wgmma": 1}
# a wgmma plan other than the default [128 x 256] unsplit is taken only
# where its cost is at most this share of that plan's (the cost's error)
KEEP = 0.85


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch: ``variant`` (a key of VARIANTS), ``rows8`` (the mma.sync
    tile's rows of x, in blocks of 8: 1, 2, 4 or 8; 0 otherwise),
    ``width`` (a tile's columns: 64 or 128 for the mma.sync tiles, 128
    or 256 for the wgmma kernel, 64 for fp32),
    ``splits`` of K and ``kt_per`` K steps a split."""
    variant: str
    rows8: int
    width: int
    splits: int
    kt_per: int

    @property
    def rows(self) -> int:
        """Rows of x a tile."""
        return TILES[self.variant][0] or 8 * self.rows8

    def ctas(self, M: int, N: int) -> int:
        """The work units of a launch over [M, N] (each a CTA, but for the
        persistent wgmma kernel, which runs min(units, SMs) CTAs)."""
        return -(-M // self.rows) * -(-N // self.width) * self.splits


def dense_matmul_ref(x, w):
    """Plain version: ``x @ w`` (the JAX package's ``jnp.dot`` of the
    projection; on the CPU the same call as before the kernel)."""
    return x @ w


def _rows8(M: int) -> int:
    return next(r for r in (1, 2, 4, 8) if M <= 8 * r or r == 8)


def split_cost(tiles: int, ktiles: int, splits: int, slots: int,
               step: float, card: float, split: float,
               rounds: float) -> float:
    """The cost of ``tiles`` output tiles over ``ktiles`` K steps cut into
    ``splits`` on ``slots`` resident CTAs: waves of CTAs times the K steps
    a CTA walks (``step`` each), a wave at least its CTAs' steps at the
    card's rate (``card`` a CTA's step: a bytes-bound product); split,
    plus each wave's ``split`` and its last CTAs' ``rounds``."""
    per = -(-ktiles // splits)
    full, rest = divmod(tiles * splits, slots)
    walk = sum(count * max(per * step, n * per * card)
               for n, count in ((slots, full), (rest, rest > 0)))
    return walk + (splits > 1) * (full + (rest > 0)) * (split + rounds)


def _best_split(variant, rows8, width, tiles, ktiles, slots, most):
    """(cost, splits) of the cheapest split into at most ``most``, the
    fewer splits at a tie; only split counts that give every split a step
    are tried."""
    tm, _, bk = TILES[variant]
    tm = tm or 8 * rows8
    if variant == "wgmma":
        step, card = WGMMA_STEP[width], 0.0
    else:  # a step's w [bk][width] and x [tm][bk] through the SM
        elem = 4 if variant == "fp32" else 2
        step = (bk * width + tm * bk) * elem / STREAM[width]
        card = bk * width * elem / CARD[width]
    # csrc split_sum's rounds of 8 (fp32: 4) float4 loads a thread a split
    loads = {"fp32": 1, "mma_sync": rows8 * width / 64 / 8,
             "wgmma": 2}[variant]
    best = None
    for s in range(1, min(ktiles, most) + 1):
        if -(-ktiles // -(-ktiles // s)) != s:
            continue
        c = (split_cost(tiles, ktiles, s, slots, step, card, SPLIT[variant],
                        ROUND[variant] * math.ceil((s - 1) * loads)), s)
        best = c if best is None or c < best else best
    return best


@functools.lru_cache(maxsize=4096)
def plan(dtype, M: int, K: int, N: int, sms: int = SMS) -> Plan:
    """The launch of an [M, K] x [K, N] product of ``dtype`` on a card of
    ``sms`` SMs, from those alone (N: the global columns, ``plan_n``).
    bf16 at M > 64 with rows TMA can describe (K and N multiples of 8)
    runs the wgmma kernel, one CTA an SM, on [128 x 256] tiles unsplit or
    [128 x 128] tiles split or not; other bf16 the mma.sync tiles, 64 or
    128 columns, and fp32 the CUDA-core tiles, 64 columns, two CTAs an
    SM.  Each picks its width and K split by ``split_cost``; the wgmma
    kernel keeps [128 x 256] unsplit unless a [128 x 128] plan costs at
    most KEEP of it."""
    if dtype not in DTYPES:
        raise ValueError(f"dense_matmul: {dtype} is neither fp32 nor bf16")
    if dtype == torch.bfloat16 and M > SMALL_ROWS and K % 8 == 0 \
            and N % 8 == 0:
        first = tile_plan("wgmma", 0, 256, M, K, N, sms, 1)
        narrow = tile_plan("wgmma", 0, 128, M, K, N, sms)
        return (narrow if narrow[0] <= KEEP * first[0] else first)[1]
    variant = "fp32" if dtype == torch.float32 else "mma_sync"
    rows8 = _rows8(M) if variant == "mma_sync" else 0
    return min((tile_plan(variant, rows8, width, M, K, N, sms)
                for width in WIDTHS[variant]),
               key=lambda c: (c[0], c[1].splits, -c[1].width))[1]


def tile_plan(variant: str, rows8: int, width: int, M: int, K: int,
              N: int, sms: int = SMS, max_splits: int | None = None):
    """(cost, Plan) of the cheapest K split (at most ``max_splits``) of
    ``variant``'s tiles of 8 rows8 (or the variant's) rows and ``width``
    columns over [M, K] x [K, N] (``plan``'s pieces, also for measuring
    other plans than ``plan``'s)."""
    tm, _, bk = TILES[variant]
    tm = tm or 8 * rows8
    ktiles = max(1, -(-K // bk))
    cost, splits = _best_split(
        variant, rows8, width, -(-M // tm) * -(-N // width), ktiles,
        RESIDENT[variant] * sms, max_splits or ktiles)
    per = -(-ktiles // splits)
    return cost, Plan(variant, rows8, width, -(-ktiles // per), per)


class _Launch(ctypes.Structure):
    """The kernel's launch (csrc DenseLaunch, field for field)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "dtype", "variant", "rows8", "width", "M", "K", "N", "vec_x",
        "vec_w", "splits", "kt_per", "sms")] + [
        ("work", ctypes.c_void_p), ("arrived", ctypes.c_void_p)]


_RUN = None  # the library's dense_matmul_run, once loaded


def _load_run():
    """The built library's launch function, with its C signature declared
    (the launch, the pointers and the stream as ``c_void_p``, so ctypes
    does not cut them to 32 bits)."""
    global _RUN
    fn = build.load("dense_matmul").dense_matmul_run
    fn.argtypes = [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    _RUN = fn
    return fn


@functools.lru_cache(maxsize=16)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rows_aligned(t) -> bool:
    """Every row of ``t`` [rows, n] starts on a 16-byte boundary."""
    return (t.data_ptr() % 16 == 0
            and (t.shape[-1] * t.element_size()) % 16 == 0)


def launch_plan(x, w, plan_n: int | None = None, sms: int = SMS) -> Plan:
    """The plan a call on x [M, K] and w [K, N] launches under (``plan``
    of the global ``plan_n`` columns, default N), after the checks the
    kernel needs: raises ValueError for operands it does not take, and
    for a shard that cannot run the variant the global shape picks (the
    wgmma kernel's TMA reads 16-byte-aligned rows only) rather than
    switching quietly."""
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"dense_matmul: x {x.dtype} and w {w.dtype} must "
                         "be both fp32 or both bf16")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"dense_matmul: x {tuple(x.shape)} must be [M, K] "
                         f"and w {tuple(w.shape)} [K, N]")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dense_matmul: x and w must be contiguous")
    (M, K), N = x.shape, w.shape[1]
    if plan_n is not None and plan_n < N:
        raise ValueError(f"dense_matmul: plan_n {plan_n} is below w's {N} "
                         "columns")
    p = plan(x.dtype, M, K, plan_n or N, sms)
    if p.variant == "wgmma" and not (_rows_aligned(x) and _rows_aligned(w)):
        raise ValueError(
            f"dense_matmul: the plan of [{M}, {K}] x [{K}, {plan_n or N}] "
            f"is the wgmma kernel, whose TMA loads need 16-byte-aligned "
            f"rows; x [{M}, {K}] or this w [{K}, {N}] has others")
    return p


class _Workspace:
    """A stream's split-K scratch on one device: the fp32 partials, grown
    to the largest split plan seen, and one int32 arrival counter a tile,
    zero between calls (each call's last CTAs reset theirs), so that no
    call launches a ``zeros``."""

    def __init__(self, device):
        self.device = device
        self.partials = torch.empty(0, dtype=torch.float32, device=device)
        self.arrived = torch.zeros(0, dtype=torch.int32, device=device)

    def fit(self, floats: int, tiles: int) -> bool:
        """Grows to ``floats`` partials and ``tiles`` counters; True when
        it had to (the launches prepared before then hold old
        pointers)."""
        grown = False
        if self.partials.numel() < floats:
            self.partials = torch.empty(floats, dtype=torch.float32,
                                        device=self.device)
            grown = True
        if self.arrived.numel() < tiles:
            self.arrived = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                                       device=self.device)
            grown = True
        return grown


# (dtype, dtype, shapes, plan_n, alignment, contiguity, device, stream) ->
# (the launch's address, out shape, device, kind, the launch or None);
# workspaces by (device, stream)
_LAUNCHES: dict = {}
_WORKSPACES: dict = {}
_LAUNCH, _EMPTY, _ZERO = 0, 1, 2  # kinds of call


def _prepare(x, w, plan_n, dev: int, stream: int):
    """The checks of a call and its launch (``launch_plan``; raises for
    what the kernel does not take), with the workspace a split needs."""
    p = launch_plan(x, w, plan_n, _sms(dev))
    (M, K), N = x.shape, w.shape[1]
    if M * N == 0:  # a launch of 0 CTAs is refused
        return 0, (M, N), x.device, _EMPTY, None
    if K == 0:
        return 0, (M, N), x.device, _ZERO, None
    launch = launch_args(p, x, w, dev, stream)
    return ctypes.addressof(launch), (M, N), x.device, _LAUNCH, launch


def launch_args(p: Plan, x, w, dev: int, stream: int) -> _Launch:
    """The kernel's launch of plan ``p`` on x [M, K] and w [K, N] (M, K,
    N > 0), pointing where ``p`` splits K at the stream's workspace."""
    (M, K), N = x.shape, w.shape[1]
    launch = _Launch(DTYPES[x.dtype], VARIANTS[p.variant], p.rows8,
                     p.width, M, K, N, int(_rows_aligned(x)),
                     int(_rows_aligned(w)), p.splits, p.kt_per, _sms(dev))
    if p.splits > 1:
        ws = _WORKSPACES.get((dev, stream))
        if ws is None:
            ws = _WORKSPACES[(dev, stream)] = _Workspace(x.device)
        units = p.ctas(M, N)
        if ws.fit(units * p.rows * p.width, units // p.splits):
            _LAUNCHES.clear()
        launch.work = ws.partials.data_ptr()
        launch.arrived = ws.arrived.data_ptr()
    return launch


def dense_matmul(x, w, *, plan_n: int | None = None):
    """x [M, K] @ w [K, N], both fp32 or both bf16 -> [M, N] in x's type,
    summed in fp32.  ``plan_n`` (default N): the columns the launch is
    planned for; a rank holding N / tp columns of w passes the global N.
    Differentiable (through ``DenseMatmul``) where grad mode is on and x
    or w requires grad."""
    if (x.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        if plan_n not in (None, w.shape[-1]):
            raise ValueError("dense_matmul: a plan of another N is a "
                             "serving (forward-only) call")
        return DenseMatmul.apply(x, w)
    return dense_matmul_fwd(x, w, plan_n=plan_n)


@kernel_wrapper
def dense_matmul_fwd(x, w, *, plan_n: int | None = None):
    """The forward alone (no graph): the plain version on the CPU and on
    ``meta``, the kernel on the card."""
    dev = x.get_device()
    if dev < 0 or w.get_device() != dev:
        on_cpu("dense_matmul", x, w)  # raises for a mix of devices
        return dense_matmul_ref(x, w)
    xp, wp = x.data_ptr(), w.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    key = (x.dtype, w.dtype, x.shape, w.shape, plan_n,
           (xp & 15) | (wp & 15) << 4, x.is_contiguous(), w.is_contiguous(),
           dev, stream)
    entry = _LAUNCHES.get(key)
    if entry is None:
        entry = _LAUNCHES[key] = _prepare(x, w, plan_n, dev, stream)
    launch, shape, device, kind, _ = entry
    out = torch.empty(shape, dtype=x.dtype, device=device)
    if kind != _LAUNCH:
        return out.zero_() if kind == _ZERO else out
    run = _RUN or _load_run()
    if dev == torch._C._cuda_getDevice():
        err = run(launch, xp, wp, out.data_ptr(), stream)
    else:
        with torch.cuda.device(dev):
            err = run(launch, xp, wp, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dense_matmul kernel launch failed: error {err}")
    dense_matmul.launches += 1
    return out


class DenseMatmul(torch.autograd.Function):
    """The dense product with the plain backward (``torch.matmul``);
    saves x and w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return dense_matmul_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        return (dy @ w.T if need_x else None,
                x.T @ dy if need_w else None)


dense_matmul.launches = 0  # kernel calls (one kernel each)
