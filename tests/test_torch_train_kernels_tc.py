"""The tensor-core backwards of the grouped matmul and the SSD scan: their
arithmetic emulated on the CPU, the choice of kernel and the persistent
schedule; and - on a CUDA card only - the kernels against their plain
versions and their first versions.

Tolerances, each with its reason:
* the SSD backward's tensor-core arithmetic (``_ssd_bwd_tc``: blocks of 64
  tokens, bf16 x, B and C exact, every fp32 factor split into bf16 hi +
  lo, fp32 values wherever the kernels keep them) against
  ``ssd_scan_bwd_ref`` in float64 and ``jax.vjp`` of ``ssd_chunked`` in
  fp32 on the same bf16 values: 1e-4 of each output's largest magnitude
  (the split keeps a factor within 2^-16 of it; one bf16 rounding of the
  fp32 factors instead, 2^-8, is past that bound, and the test shows it);
* the split itself: hi + lo within 2^-16 of each fp32 value (relative),
  where hi alone is off by up to 2^-8 (bf16's unit roundoff);
* on the card: each kernel within 2^-7 of its plain version's largest
  magnitude (one bf16 rounding of dx, dw, dB, dC from fp32 sums that
  differ in their last bits), two calls bit-equal.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.models import mamba2 as jm2
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ssd_scan as sk

BF16 = torch.bfloat16


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _rel(got, want) -> float:
    """max |got - want| over want's largest magnitude."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / want.abs().max().clamp(min=1e-300))


# ----------------------------------------------- the bf16 hi + lo split


def _split(v, hi_only=False):
    """fp32 v as bf16 hi = bf16(v) and lo = bf16(v - hi) (tc_bf16.cuh
    split_bf16), both returned in float64; lo is zero with hi_only."""
    v = v.float()
    hi = v.to(BF16)
    lo = (v - hi.float()).to(BF16)
    if hi_only:
        lo = torch.zeros_like(lo)
    return hi.double(), lo.double()


def test_split_keeps_fp32_factor():
    """hi + lo is within 2^-16 of each fp32 value, where hi alone (one
    bf16 rounding) is off by up to 2^-8 of it."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(200_000).astype(np.float32)
                         * np.exp(rng.uniform(-20, 20, 200_000))
                         .astype(np.float32))
    hi, lo = _split(v)
    ref = v.double()
    both = float(((hi + lo - ref).abs() / ref.abs()).max())
    one = float(((hi - ref).abs() / ref.abs()).max())
    assert both <= 2.0 ** -16
    assert 2.0 ** -10 < one <= 2.0 ** -8


# ------------------------------------ the SSD backward's tensor-core form


def _f32(t):
    """A value the kernels keep in fp32: rounded to fp32, held in
    float64."""
    return t.float().double()


def _ssd_bwd_tc(x, dt, a_neg, B, C, dy, dfinal=None, *, chunk,
                hi_only=False):
    """The bf16 backward kernels' arithmetic (``csrc/ssd_scan_bwd.cu``
    namespace tcb) in plain torch: blocks of min(chunk, 64) tokens (a
    ragged last block padded with zero tokens, which add nothing), each
    product's exact bf16 operand kept and its fp32 factor split into hi +
    lo (two products; three where both factors are fp32), dt and the
    decays as row or column scales, values rounded to fp32 where the
    kernels store or accumulate them (sums in float64 otherwise), the
    cumulative log-decay in float64.  Returns (dx, ddt, da_neg, dB, dC) as
    fp32 values in float64, before the outputs' bf16 rounding."""
    b, S, h, p = x.shape
    n = B.shape[-1]
    T = min(chunk, 64)
    nb = -(-S // T)
    pad = nb * T - S

    def blocks(t):  # [b, S, ...] -> [b, nb, T, ...], zero tokens past S
        t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], 1)
        return t.reshape((b, nb, T) + t.shape[2:])

    sp = lambda v: _split(v, hi_only)  # noqa: E731
    xs, Bs, Cs = (blocks(t.double()) for t in (x, B, C))  # bf16 values
    dys = blocks(dy.float())  # [b, nb, T, h, p] fp32
    dts = blocks(dt.float())  # [b, nb, T, h]
    a = (dts * a_neg.float()).double()  # each product rounded to fp32
    acum = torch.cumsum(a, 2)  # float64
    ae = acum[:, :, -1:]  # the last real token's (pad tokens add 0)
    ea = torch.exp(acum.float()).double()
    ee = torch.exp((ae - acum).float()).double()
    dtd = dts.double()
    # pass 1: own = x^T W (W = B dt ee split), gown = (ea dy)^T C (split)
    wh, wl = sp(_f32(Bs[:, :, :, None, :] * (dtd * ee)[..., None]))
    own = _f32(torch.einsum("bkthp,bkthn->bkhpn", xs, wh)
               + torch.einsum("bkthp,bkthn->bkhpn", xs, wl))
    eh, el = sp(_f32(ea[..., None] * dys.double()))
    gown = _f32(torch.einsum("bkthp,bktn->bkhpn", eh + el, Cs))
    dec = _f32(ae[:, :, 0])  # [b, nb, h]
    # pass 2: the states entering each block, the gradients leaving each
    s_in, g = [], []
    s = torch.zeros((b, h, p, n), dtype=torch.float64)
    for k in range(nb):
        s_in.append(s)
        s = _f32(s * torch.exp(dec[:, k].float()).double()[..., None, None]
                 + own[:, k])
    gk = (torch.zeros((b, h, p, n), dtype=torch.float64) if dfinal is None
          else dfinal.double())
    for k in reversed(range(nb)):
        g.append(gk)
        gk = _f32(gk * torch.exp(dec[:, k].float()).double()[..., None, None]
                  + gown[:, k])
    s_in = torch.stack(s_in, 1)  # [b, nb, h, p, n]
    g = torch.stack(g[::-1], 1)
    # pass 3
    idx = torch.arange(T)
    causal = (idx[None, :] >= idx[:, None])  # [s, t]: s <= t
    ac = acum.permute(0, 1, 3, 2)  # [b, nb, h, T]
    LT = torch.exp((ac[..., None, :] - ac[..., :, None]).float()).double()
    LT = LT * causal  # [b, nb, h, s, t] = exp(acum[t] - acum[s]), s <= t
    dyh, dyl = sp(dys)
    CBT = _f32(torch.einsum("bksn,bktn->bkst", Bs, Cs))[:, :, None]
    DYX = _f32(torch.einsum("bkshp,bkthp->bkhst", xs, dyh)
               + torch.einsum("bkshp,bkthp->bkhst", xs, dyl))
    dt_s = dtd.permute(0, 1, 3, 2)[..., None]  # [b, nb, h, s, 1]
    lcb = _f32(LT * CBT)
    dxv = _f32(dt_s * DYX)
    ldx = _f32(LT * dxv)
    m = lcb * dxv
    colm, rowm = m.sum(-1), m.sum(-2)  # [b, nb, h, s], [..., t]
    gh, gl = sp(g)
    sh, sl = sp(s_in)
    ee_s = ee.permute(0, 1, 3, 2)[..., None]
    ea_t = ea.permute(0, 1, 3, 2)[..., None]
    # dxd [s, p] = ee B G^T + (L CB^T) dy, three products for the latter
    bg = _f32(torch.einsum("bksq,bkhpq->bkhsp", Bs, gh + gl))
    lh, ll = sp(lcb)
    dyh_t, dyl_t = dyh.permute(0, 1, 3, 2, 4), dyl.permute(0, 1, 3, 2, 4)
    main = (torch.einsum("bkhst,bkhtp->bkhsp", lh, dyh_t + dyl_t)
            + torch.einsum("bkhst,bkhtp->bkhsp", ll, dyh_t))
    dxd = _f32(_f32(ee_s * bg) + main)
    x_s = xs.permute(0, 1, 3, 2, 4)  # [b, nb, h, s, p]
    dx = _f32(dxd * dt_s)
    dxx = (dxd * x_s).sum(-1)
    # dB [s, q] = ee dt (x G) + (L DX^T) C; W from x G
    xg = _f32(torch.einsum("bkhsp,bkhpq->bkhsq", x_s, gh + gl))
    r = _f32(xg * _f32(ee_s * dt_s))
    wv = (r * Bs[:, :, None]).sum(-1)
    xh, xl = sp(ldx)
    dBp = _f32(r + torch.einsum("bkhst,bktq->bkhsq", xh + xl, Cs))
    # dC [t, q] = ea dy S (three products) + L DX B
    dys_t = torch.einsum("bkhtp,bkhpq->bkhtq", dyh_t, sh + sl) \
        + torch.einsum("bkhtp,bkhpq->bkhtq", dyl_t, sh)
    qv = _f32(ea_t * _f32(dys_t))
    y0 = (qv * Cs[:, :, None]).sum(-1)
    dCp = _f32(qv + torch.einsum("bkhst,bksq->bkhtq", xh + xl, Bs))
    gdot = (g * s_in).sum((-2, -1))  # [b, nb, h]
    dac = rowm - colm + y0 - wv
    dac[..., -1] += ea.permute(0, 1, 3, 2)[..., -1] * gdot + wv.sum(-1)
    da = torch.flip(torch.cumsum(torch.flip(dac, [-1]), -1), [-1])
    ddt = da * a_neg.double()[:, None] + dxx  # [b, nb, h, t]
    dan = (da * dtd.permute(0, 1, 3, 2)).sum(-1)  # [b, nb, h]

    def tokens(t):  # [b, nb, h, T, ...] -> [b, S, h, ...]
        t = t.transpose(2, 3).reshape((b, nb * T) + (h,) + t.shape[4:])
        return t[:, :S]

    return (tokens(dx), tokens(ddt[..., None])[..., 0], dan.sum((0, 1)),
            tokens(dBp).sum(2), tokens(dCp).sum(2))


def _scan_case(b, S, h, p, n, seed, final):
    """bf16 x, B, C; fp32 dt (zamba2's range), a_neg, dy, dfinal."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.normal(size=(b, S, h, p))).to(BF16)
    B_ = t(rng.normal(size=(b, S, n))).to(BF16)
    C_ = t(rng.normal(size=(b, S, n))).to(BF16)
    dt = t(0.01 + 0.2 * rng.random((b, S, h)))
    a_neg = t(-0.5 - 2 * rng.random(h))
    dy = t(rng.normal(size=(b, S, h, p)))
    dfinal = t(rng.normal(size=(b, h, p, n))) if final else None
    return x, dt, a_neg, B_, C_, dy, dfinal


# (b, S, h, p, n, chunk, final-state cotangent): a 256-token chunk in four
# blocks, a ragged last block (S 200 -> 64, 64, 64, 8), chunks below 64
# (one block each), p and n off 16
TC_CASES = [(1, 256, 2, 16, 16, 256, False),
            (2, 200, 2, 16, 8, 200, True),
            (1, 96, 3, 8, 4, 16, True),
            (1, 130, 2, 24, 40, 130, False)]


@pytest.mark.parametrize("case", TC_CASES)
def test_ssd_tc_emulation_matches_plain_backward(need_jax, case):
    """The tensor-core arithmetic within 1e-4 of each output's largest
    magnitude of ``ssd_scan_bwd_ref`` in float64 and of ``jax.vjp`` of
    ``ssd_chunked`` (fp32) on the same bf16 values; one bf16 rounding of
    the fp32 factors instead of the split is past that bound."""
    b, S, h, p, n, chunk, final = case
    x, dt, a_neg, B_, C_, dy, dfinal = _scan_case(b, S, h, p, n, S + p,
                                                  final)
    got = _ssd_bwd_tc(x, dt, a_neg, B_, C_, dy, dfinal, chunk=chunk)
    wide = [t.double() for t in (x, dt, a_neg, B_, C_, dy)]
    want = sk.ssd_scan_bwd_ref(*wide, None if dfinal is None
                               else dfinal.double(), chunk=chunk)

    def jf(*args):
        return jm2.ssd_chunked(*args, chunk=chunk)

    jargs = [jnp.asarray(t.float().numpy()) for t in (x, dt, a_neg, B_, C_)]
    _, vjp = jax.vjp(jf, *jargs)
    zero = np.zeros((b, h, p, n), np.float32)
    jgrads = vjp((jnp.asarray(dy.numpy()), jnp.asarray(
        zero if dfinal is None else dfinal.numpy())))
    rough = _ssd_bwd_tc(x, dt, a_neg, B_, C_, dy, dfinal, chunk=chunk,
                        hi_only=True)
    names = ("dx", "ddt", "da_neg", "dB", "dC")
    for name, g, w, j in zip(names, got, want, jgrads):
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))
        assert _rel(g, torch.from_numpy(np.array(j))) <= 1e-4, name
    assert max(_rel(g, w) for g, w in zip(rough, want)) > 1e-4


# ------------------------------------------- the grouped-matmul backward


@pytest.mark.parametrize("dtype,K,N,aligned,kind", [
    (BF16, 1024, 512, True, "wgmma"),        # granite-moe gate/up
    (BF16, 2048, 1408, True, "wgmma"),       # qwen2-moe's expert shape
    (BF16, 8, 8, True, "wgmma"),
    (BF16, 70, 90, True, "mma.sync"),        # rows of 140 and 180 bytes
    (BF16, 1024, 90, True, "mma.sync"),
    (BF16, 1024, 512, False, "mma.sync"),    # an unaligned base
    (torch.float32, 1024, 512, True, "fp32 CUDA cores")])
def test_gmm_bwd_variant(dtype, K, N, aligned, kind):
    """bf16 rows that TMA can describe (a multiple of 16 bytes, aligned
    bases) run the wgmma kernel; other bf16 rows the mma.sync tiles; fp32
    the CUDA cores."""
    assert mg.bwd_variant(dtype, K, N, aligned).startswith(kind)


@pytest.mark.parametrize("shape", [(32, 2560, 1024, 512),
                                   (60, 688, 2048, 1408),
                                   (16, 8, 1024, 512), (3, 100, 136, 72)])
def test_gmm_bwd_schedule(shape):
    """The persistent kernel's tiles: every dw tile ([K, N] of each expert,
    expert by expert, rows before columns, C / 64 steps) and then every dx
    tile ([C, K], N / 64 steps), each output element in exactly one tile;
    one CTA an SM at most, CTA i taking tiles i, i + grid, ..., so every
    tile has one owner."""
    E, C, K, N = shape
    tm, tn = mg.BWD_TILE
    tiles = mg.bwd_tiles(E, C, K, N)
    cd = lambda a, d: -(-a // d)  # noqa: E731
    n_dw = E * cd(K, tm) * cd(N, tn)
    assert len(tiles) == n_dw + E * cd(C, tm) * cd(K, tn)
    assert {t.out for t in tiles[:n_dw]} == {"dw"}
    assert {t.out for t in tiles[n_dw:]} == {"dx"}
    for part in (tiles[:n_dw], tiles[n_dw:]):
        keys = [(t.expert, t.row, t.col) for t in part]
        assert keys == sorted(keys) and len(set(keys)) == len(keys)
    assert all(t.steps == cd(C, mg.BWD_STEP) for t in tiles[:n_dw])
    assert all(t.steps == cd(N, mg.BWD_STEP) for t in tiles[n_dw:])
    for out, rows, cols in (("dw", K, N), ("dx", C, K)):
        cover = np.zeros((E, cd(rows, tm) * tm, cd(cols, tn) * tn), int)
        for t in tiles:
            if t.out == out:
                cover[t.expert, t.row:t.row + tm, t.col:t.col + tn] += 1
        assert (cover[:, :rows, :cols] == 1).all()
    for sms in (132, 7):
        grid = mg.bwd_grid(E, C, K, N, sms)
        assert grid == min(sms, len(tiles))
        owned = sorted(i for c in range(grid)
                       for i in range(c, len(tiles), grid))
        assert owned == list(range(len(tiles)))


@pytest.mark.parametrize("dtype,p,n,kind", [
    (BF16, 64, 64, "tensor cores"), (BF16, 16, 8, "tensor cores"),
    (BF16, 8, 4, "tensor cores"), (BF16, 80, 64, "fp32 CUDA cores"),
    (BF16, 64, 72, "fp32 CUDA cores"),
    (torch.float32, 64, 64, "fp32 CUDA cores")])
def test_ssd_bwd_variant(dtype, p, n, kind):
    """bf16 x with p and n (rounded up to 16) at most 64 runs passes 1 and
    3 on the tensor cores; wider bf16 and fp32 the CUDA-core passes."""
    assert sk.bwd_variant(dtype, p, n).startswith(kind)


# ------------------------------------------------------------- the card


def _gmm_parent(x, w, dy):
    """The first version's bf16 kernels (the mma.sync tiles)."""
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    E, C, K = x.shape
    N = w.shape[2]
    err = mg._bwd_lib().grouped_matmul_bwd_launch_mma_sync(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), E, C, K, N, mg._rows_aligned(x), mg._rows_aligned(w),
        mg._rows_aligned(dy), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return dx, dw


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 2560, 1024, 512), (16, 8, 1024, 512),
                                   (3, 100, 136, 72), (60, 688, 2048, 1408),
                                   (3, 37, 70, 90)])
def test_gmm_bwd_kernels(cuda, shape):
    """bf16: the kernel that ``bwd_variant`` names against the plain
    backward and the first version's tiles (2^-7 of the largest
    magnitude), two calls bit-equal, one count a call; an unaligned base
    runs the mma.sync tiles."""
    E, C, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x, w, dy = (torch.randn(s, device=cuda, generator=g).to(BF16)
                for s in ((E, C, K), (E, K, N), (E, C, N)))
    before = mg.grouped_matmul.bwd_launches
    got = mg.grouped_matmul_bwd(x, w, dy)
    again = mg.grouped_matmul_bwd(x, w, dy)
    assert mg.grouped_matmul.bwd_launches == before + 2
    want = mg.grouped_matmul_bwd_ref(x, w, dy)
    for a, b, ww, old in zip(got, again, want, _gmm_parent(x, w, dy)):
        assert torch.equal(a, b)
        assert _rel(a, ww) <= 2 ** -7 and _rel(old, ww) <= 2 ** -7
    # x one element into a larger buffer: its base is off 16 bytes
    xs = torch.randn(x.numel() + 1, device=cuda).to(BF16)[1:].view(E, C, K)
    xs.copy_(x)
    assert not mg._rows_aligned(xs)
    for a, ww in zip(mg.grouped_matmul_bwd(xs, w, dy), want):
        assert _rel(a, ww) <= 2 ** -7


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(4, 256, 80, 64, 64, 256, False),
                                  (2, 200, 8, 64, 64, 200, True),
                                  (1, 200, 4, 16, 8, 200, True),
                                  (2, 48, 3, 8, 4, 16, False),
                                  (1, 130, 2, 24, 40, 130, True),
                                  (1, 70, 3, 7, 5, 70, True)])
def test_ssd_bwd_tc_kernels(cuda, case):
    """bf16: the tensor-core passes against the plain backward and the
    first version's CUDA-core passes (2^-7 of each output's largest
    magnitude), two calls bit-equal; zamba2's width, ragged last blocks,
    chunks below 64, p and n off 16 and odd."""
    b, S, h, p, n, chunk, final = case
    args = [t if t is None else t.to(cuda) for t in
            _scan_case(b, S, h, p, n, S, final)]
    got = sk.ssd_scan_bwd(*args, chunk=chunk)
    again = sk.ssd_scan_bwd(*args, chunk=chunk)
    want = sk.ssd_scan_bwd_ref(*args, chunk=chunk)
    lib = sk._bwd_lib()
    x, dt, a_neg, B_, C_, dy, dfinal = args
    Q = sk.chunk_length(S, chunk)
    old = [torch.empty_like(t) for t in (x, dt, a_neg, B_, C_)]
    scratch = torch.empty(sk.bwd_scratch_bytes(b, S, h, p, n, Q) // 4,
                          device=cuda)
    err = lib.ssd_scan_bwd_launch_cuda_cores(
        x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), B_.data_ptr(),
        C_.data_ptr(), None, dy.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(),
        *(t.data_ptr() for t in old), scratch.data_ptr(), b, S, h, p, n, Q,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    for name, a, a2, w, o in zip(("dx", "ddt", "da_neg", "dB", "dC"), got,
                                 again, want, old):
        assert torch.equal(a, a2), name
        assert _rel(a, w) <= 2 ** -7 and _rel(o, w) <= 2 ** -7, name
