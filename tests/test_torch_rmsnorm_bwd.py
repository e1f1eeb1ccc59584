"""The RMSNorm backward's launch plan and the order of its sums: the plan
and the kernel choice from the shapes alone, a plain-torch emulation of the
kernel's summation order held to the plain backward and to the JAX
package; and - on a CUDA card only - the kernel against its plain version
and its first version.

The emulation (``_emulate``) follows ``csrc/rmsnorm.cu``'s backward in
fp32: each row's sum(x^2) and sum(g s x) summed by each of its ``tpr``
threads over its own vectors in order, then an xor tree over the row's
lanes of a warp and the row's warps in order; each thread's sum of g x^
over the rows of its CTA's range that its row slot walks, in row order;
the CTA's slots summed in slot order into its partial; the partials of a
column summed by 32 threads, thread q over partials q, q + 32, ... in
order, and the 32 sums combined by an xor tree.  The card's fused
multiply-adds round once where the emulation rounds twice, so it is not
bit-exact; it shows that the order keeps fp32 accuracy.

Tolerances, each with its reason:
* the emulation against ``rmsnorm_bwd_ref`` in float64: 1e-5 of each
  output's largest magnitude (fp32 sums of up to 4096 rows and 5120
  columns in a fixed order);
* against ``jax.vjp`` of ``lm._norm`` and ``_head_rms`` in fp32: 1e-5 of
  it (two fp32 summation orders);
* on the card (``BWD_TOL`` of ``chip_smoke.py``): fp32 1e-5, bf16 2^-7 of
  the plain version's largest magnitude (one bf16 rounding of dx and
  dscale from fp32 values that differ in their last bits); two calls bit
  for bit.
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.models import lm as jlm
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.kernels import rmsnorm as rn

BF16, FP32 = torch.bfloat16, torch.float32
# the trained shapes: qwen2-0.5b, granite-moe-1b-a400m and gemma3-1b at B 8
# x S 1024, gemma3-1b's qk-norm rows, zamba2-2.7b's two widths at B 4 x S
# 1024 and xlstm-1.3b's at B 4 x S 512, and one row
SHAPES = [(8192, 896), (8192, 1024), (8192, 1152), (32768, 256),
          (4096, 2560), (4096, 5120), (2048, 4096), (2048, 2048), (1, 896)]
# the plans measured fastest on the H100 (scripts/bwd_kernel_variants.py's
# shapes; PERF.md row 12): (grid, threads a row, rows a CTA, vectors)
BF16_PLANS = {(8192, 896): (264, 32, 8, 4), (8192, 1024): (264, 32, 8, 4),
              (8192, 1152): (264, 64, 4, 4), (32768, 256): (264, 16, 16, 2),
              (4096, 2560): (264, 256, 1, 2), (4096, 5120): (264, 256, 1, 4),
              (2048, 4096): (264, 256, 1, 2), (2048, 2048): (264, 128, 2, 2),
              (1, 896): (1, 256, 1, 1)}
EMU_TOL = 1e-5


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
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-300))


def _inputs(rows, d, seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    x, dy = (torch.from_numpy(rng.normal(size=(rows, d))).to(dtype)
             for _ in range(2))
    s = torch.from_numpy(1 + 0.5 * rng.normal(size=d)).to(dtype)
    return x, s, dy


# ------------------------------------------------------------- the plan


def _cta_ranges(rows, grid):
    """Each CTA's contiguous rows [lo, hi), as the kernel cuts them."""
    return [(b * rows // grid, (b + 1) * rows // grid) for b in range(grid)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,d", SHAPES)
def test_bwd_plan_covers_rows_and_vectors_once(rows, d, dtype):
    """Every row goes to exactly one CTA and one row slot; the vectors t,
    t + tpr, ... of the row's threads cover its 16-byte vectors once; the
    grid (and so the count of partials) is at most two CTAs an SM and
    comes from the shapes alone."""
    dt = getattr(torch, dtype)
    plan = rn.bwd_plan(rows, d, dt)
    assert rn.bwd_variant(rows, d, dt) == rn.BWD_REGISTERS
    assert plan == rn.bwd_plan.__wrapped__(rows, d, dt)  # not the cache's
    assert 1 <= plan.grid <= 2 * rn.SMS
    assert plan.tpr * plan.in_flight == rn.BWD_THREADS
    assert plan.tpr & (plan.tpr - 1) == 0 and plan.vectors in rn.VECTORS
    seen = np.zeros(rows, int)
    for lo, hi in _cta_ranges(rows, plan.grid):
        groups = -(-(hi - lo) // plan.in_flight)
        for slot in range(plan.in_flight):
            walked = [lo + k * plan.in_flight + slot for k in range(groups)]
            seen[[r for r in walked if r < hi]] += 1
    assert (seen == 1).all()
    nvec = d * (torch.finfo(dt).bits // 8) // 16
    held = np.zeros(nvec, int)
    for t in range(plan.tpr):
        idx = [t + j * plan.tpr for j in range(plan.vectors)]
        held[[i for i in idx if i < nvec]] += 1
    assert (held == 1).all()


def test_bwd_plan_at_the_trained_shapes():
    """bf16 plans at the trained shapes, the fastest measured on the card:
    fewer threads a row where a CTA walks enough row groups, more where it
    would walk few (zamba2's and xlstm's 2048-4096 rows)."""
    for (rows, d), want in BF16_PLANS.items():
        assert tuple(rn.bwd_plan(rows, d, BF16)) == want, (rows, d)


@pytest.mark.parametrize("rows,d,dtype,variant", [
    (4096, 16384, BF16, rn.BWD_REGISTERS),   # 2048 vectors: 8 a thread
    (4096, 16392, BF16, rn.BWD_FIRST),       # 2049 vectors
    (4096, 8192, FP32, rn.BWD_REGISTERS),
    (4096, 8196, FP32, rn.BWD_FIRST),
    (7, 16, BF16, rn.BWD_REGISTERS),          # two vectors
    (5, 24000, FP32, rn.BWD_FIRST)])
def test_bwd_variant_by_width(rows, d, dtype, variant):
    """The register design takes rows of up to 8 vectors x 256 threads;
    wider rows take the first version, whose plan is ``first_plan``
    (one warp a row)."""
    assert rn.bwd_variant(rows, d, dtype) == variant
    plan = rn.bwd_plan(rows, d, dtype)
    if variant == rn.BWD_FIRST:
        assert plan == rn.first_plan(rows, d, dtype) and plan.tpr == 32
    else:
        assert plan.vectors * plan.tpr * 16 >= d * (torch.finfo(dtype).bits
                                                    // 8)
        assert plan.vectors <= 4 or plan.grid <= rn.SMS


# ---------------------------------------------- the emulated summation


def _xor_tree(v):
    """v [..., m] summed by an xor butterfly over its last axis (offsets
    m / 2, ..., 1), as the kernel's shuffles: every lane's result."""
    m = v.shape[-1]
    lanes = torch.arange(m)
    off = m // 2
    while off:
        v = v + v[..., lanes ^ off]
        off //= 2
    return v[..., 0]


def _row_sums(a, plan, kvec):
    """sum over each row of a [rows, d] (fp32), in the kernel's order: per
    thread over its vectors t, t + tpr, ... and their kvec values in
    order, the xor tree of the row's lanes a warp, then the row's warps in
    order."""
    rows, d = a.shape
    nvec, tpr = d // kvec, plan.tpr
    v = torch.zeros(rows, plan.vectors * tpr, kvec, dtype=FP32)
    v[:, :nvec] = a.reshape(rows, nvec, kvec)
    v = v.reshape(rows, plan.vectors, tpr, kvec)
    t = torch.zeros(rows, tpr, dtype=FP32)
    for j in range(plan.vectors):
        for e in range(kvec):
            t = t + v[:, j, :, e]
    lanes = min(tpr, 32)
    warps = _xor_tree(t.reshape(rows, tpr // lanes, lanes))
    out = torch.zeros(rows, dtype=FP32)
    for w in range(tpr // lanes):
        out = out + warps[:, w]
    return out


def _emulate(x, s, dy, plan, kvec, zero_centered=False, eps=1e-6):
    """(dx, dscale) in fp32 by the kernel's summation orders (module
    docstring), from x [rows, d], scale [d] and dy, kvec values a
    16-byte vector."""
    rows, d = x.shape
    x, dy = x.float(), dy.float()
    gs = dy * (s.float() + (1.0 if zero_centered else 0.0))
    ss, gsx = _row_sums(x * x, plan, kvec), _row_sums(gs * x, plan, kvec)
    r = torch.rsqrt(ss / d + eps)[:, None]
    coef = r * r * r * gsx[:, None] / d
    dx = r * gs - x * coef
    gxr = dy * (x * r)
    partial = torch.zeros(plan.grid, d, dtype=FP32)
    for b, (lo, hi) in enumerate(_cta_ranges(rows, plan.grid)):
        slots = torch.zeros(plan.in_flight, d, dtype=FP32)
        for r0 in range(lo, hi, plan.in_flight):  # the CTA's row groups
            n = min(plan.in_flight, hi - r0)
            slots[:n] = slots[:n] + gxr[r0:r0 + n]
        for q in range(plan.in_flight):
            partial[b] = partial[b] + slots[q]
    seg = torch.zeros(32, d, dtype=FP32)
    for g in range(plan.grid):
        seg[g % 32] = seg[g % 32] + partial[g]
    return dx, _xor_tree(seg.T.contiguous())


@pytest.mark.parametrize("d", [896, 2560, 5120])
def test_emulated_order_holds_fp32_accuracy(d):
    """At 4096 rows, the kernel's order of sums (bf16 plan: its grid and
    row slots; fp32 arithmetic) stays within 1e-5 of the plain backward
    in float64, dx and dscale, plain and zero-centred."""
    x, s, dy = _inputs(4096, d, seed=d)
    plan = rn.bwd_plan(4096, d, BF16)
    for zc in (False, True):
        dx, dscale = _emulate(x, s, dy, plan, 8, zero_centered=zc)
        want = rn.rmsnorm_bwd_ref(x, s, dy, zero_centered=zc)
        assert _rel(dx, want[0]) <= EMU_TOL
        assert _rel(dscale, want[1]) <= EMU_TOL


@pytest.mark.parametrize("d", [256, 1152])
def test_emulated_row_sums_fp32_plans(d):
    """The fp32 plans' cut of a row (4 values a vector) keeps its sums
    within 1e-5 of float64 at 1024 rows."""
    x, s, dy = _inputs(1024, d, seed=3 * d)
    plan = rn.bwd_plan(1024, d, FP32)
    got = _row_sums((x * x).float(), plan, 4)
    assert _rel(got, (x * x).sum(-1)) <= EMU_TOL
    dx, dscale = _emulate(x, s, dy, plan, 4)
    want = rn.rmsnorm_bwd_ref(x, s, dy)
    assert _rel(dx, want[0]) <= EMU_TOL
    assert _rel(dscale, want[1]) <= EMU_TOL


@pytest.mark.parametrize("kind,d", [("rmsnorm", 896), ("rmsnorm", 2560),
                                    ("rmsnorm_zero", 1152),
                                    ("rmsnorm", 4096), ("head", 256)])
def test_emulation_matches_jax_vjp(need_jax, kind, d):
    """At reduced rows (300, not a multiple of the row groups) with the
    trained widths, the emulated kernel against ``jax.vjp`` of
    ``lm._norm`` (plain and zero-centred) and ``_head_rms`` in fp32."""
    rows = 300
    x, s, dy = _inputs(rows, d, seed=d + len(kind))
    jx, js, jg = (jnp.asarray(a.numpy(), jnp.float32) for a in (x, s, dy))
    if kind == "head":
        jfn = jlm._head_rms
    else:
        def jfn(x_, s_):
            return jlm._norm({"ln_s": s_}, x_, kind, "ln")
    _, vjp = jax.vjp(jfn, jx, js)
    jdx, jds = vjp(jg)
    plan = rn.bwd_plan(rows, d, BF16)
    dx, dscale = _emulate(x.float(), s.float(), dy.float(), plan, 8,
                          zero_centered=kind == "rmsnorm_zero")
    assert _rel(dx, np.array(jdx)) <= EMU_TOL
    assert _rel(dscale, np.array(jds)) <= EMU_TOL


# ------------------------------------------------------------ the card


TOL = {FP32: 1e-5, BF16: 2.0 ** -7}
GPU_WIDTHS = [896, 1024, 1152, 256, 2560, 4096, 5120, 2048]


def _card(rows, d, dt, seed, dev):
    x, s, dy = _inputs(rows, d, seed, FP32)
    return x.to(dev, dt), s.to(dev, dt), dy.to(dev, dt)


def _first(x, s, dy, zc=False):
    """The first version at any width (the parent; ``first_plan``)."""
    rows, d = x.shape
    dx, ds = torch.empty_like(x), torch.empty_like(s)
    err = rn._bwd_first(x, s, dy, dx, ds, rn.first_plan(rows, d, x.dtype),
                        1e-6, zc)
    assert err == 0
    return dx, ds


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", GPU_WIDTHS)
def test_kernel_matches_plain_and_first_version(cuda, d, dtype):
    """At each trained width (1024 rows and an odd 333), the kernel within
    TOL of the plain backward and of the first version, zero-centred or
    not, two calls bit-equal."""
    dt = getattr(torch, dtype)
    for rows, zc in ((1024, False), (333, True)):
        x, s, dy = _card(rows, d, dt, d + rows, cuda)
        got = rn.rmsnorm_bwd(x, s, dy, zero_centered=zc)
        again = rn.rmsnorm_bwd(x, s, dy, zero_centered=zc)
        want = rn.rmsnorm_bwd_ref(x, s, dy, zero_centered=zc)
        first = _first(x, s, dy, zc)
        for a, b, w, f in zip(got, again, want, first):
            assert torch.equal(a, b)
            assert _rel(a, w) <= TOL[dt]
            assert _rel(a, f) <= 2 * TOL[dt]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,dtype", [(1, 896, BF16), (7, 16, BF16),
                                          (8191, 256, BF16),
                                          (4097, 5120, FP32),
                                          (65, 16392, BF16),
                                          (5, 16384, BF16)])
def test_kernel_edges(cuda, rows, d, dtype):
    """One row, two vectors a row, rows that do not divide by the grid,
    fp32 at 8 vectors a thread, and both sides of the register design's
    widest row (the first version past it)."""
    x, s, dy = _card(rows, d, dtype, rows, cuda)
    got = rn.rmsnorm_bwd(x, s, dy)
    assert all(map(torch.equal, got, rn.rmsnorm_bwd(x, s, dy)))
    for a, w in zip(got, rn.rmsnorm_bwd_ref(x, s, dy)):
        assert _rel(a, w) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("xt,st", [(BF16, FP32), (FP32, BF16)])
def test_kernel_scale_of_another_type(cuda, xt, st):
    """x in one type and the scale in the other: dx in x's type, dscale in
    the scale's, within the looser of the two tolerances."""
    x, s, dy = _card(1000, 2560, xt, 9, cuda)
    s = s.to(st)
    got = rn.rmsnorm_bwd(x, s, dy, zero_centered=True)
    want = rn.rmsnorm_bwd_ref(x, s, dy, zero_centered=True)
    assert got[0].dtype == xt and got[1].dtype == st
    for a, w in zip(got, want):
        assert _rel(a, w) <= TOL[BF16]


@pytest.mark.gpu
def test_kernel_counts_and_no_host_sync(cuda):
    """One count a call, and no host sync under sync debug mode "error"
    (the partials come from the caching allocator)."""
    x, s, dy = _card(8192, 896, BF16, 0, cuda)
    rn.rmsnorm_bwd(x, s, dy)
    torch.cuda.synchronize()
    before = rn.rmsnorm.bwd_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        rn.rmsnorm_bwd(x, s, dy)
        rn.rmsnorm_bwd(x[:5], s, dy[:5])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert rn.rmsnorm.bwd_launches == before + 2
