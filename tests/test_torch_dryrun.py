"""The port's one-card dry run (``repro_torch.launch.dryrun``) and its
counter (``launch/analysis.py``) against the JAX package's dry run:

  (a) the argument bytes of every full-size (arch x shape) cell equal the
      bytes of the JAX package's abstract trees (``Model.abstract`` +
      ``abstract_opt_state`` + ``abstract_cache`` + ``input_specs``);
  (b) at reduced size the ``meta`` trace's products equal the dots of the
      JAX entry point compiled on the CPU (``hlo_analysis``), for train,
      prefill and decode of qwen2-0.5b, granite-moe and zamba2: prefill
      and decode exactly, the train steps up to the terms named in
      ``TRAIN_GAPS``;
  (c) the counter's FLOPs, bytes and peak on small functions whose counts
      are known;
  (d) the skipped cells are ``shape_applicable``'s;
  (e) the extrapolated xlstm cells: FLOPs and bytes on the line, the peak
      a lower bound;
  (f) the parallel sweep gives the sequential sweep's records, and the
      executed cells' inputs (random caches, ragged positions), first-call
      recorder and launch counters.
"""
import collections
import importlib

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.configs.base import ShapeConfig as JShape
    from repro.distributed.sharding import abstract_opt_state
    from repro.launch import hlo_analysis as ha
    from repro.models import build_model as jbuild
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, reduced,
                                 shape_applicable)
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import kernel_wrapper
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode as pd
from repro_torch.launch import dryrun
from repro_torch.launch.analysis import Counter, Roofline, tensor_bytes
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.models.api import build_model


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


# ------------------------------------------------------- (a) arguments


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_jax_abstract_trees(need_jax, arch):
    """Every full-size cell's arguments: bf16 parameters, plus the AdamW
    state (train), the dense cache (decode) and the batch."""
    jmodel = jbuild(jget_config(arch))
    params = jmodel.abstract(jnp.bfloat16)
    for name, shape in SHAPES.items():
        jshape = JShape(shape.name, shape.kind, shape.seq_len,
                        shape.global_batch)
        want = _jax_bytes(params) + _jax_bytes(jmodel.input_specs(jshape))
        if shape.kind == "train":
            want += _jax_bytes(abstract_opt_state(params))
        elif shape.kind == "decode":
            want += _jax_bytes(jmodel.abstract_cache(shape.global_batch,
                                                     shape.seq_len))
        model = build_model(get_config(arch))
        _, args = dryrun.cell_call(model, shape,
                                   model.abstract(torch.bfloat16))
        assert dryrun.tree_bytes(args) == want, name


# ------------------------------------------------------------- (b) FLOPs

B, S = 2, 64


def _jax_products(arch, kind) -> collections.Counter:
    """FLOPs of each dot of the JAX entry point compiled on the CPU, with
    its loop multiplicity (``hlo_analysis``); their sum is
    ``analyze_hlo_text(...)["flops"]``."""
    model = jbuild(jreduced(jget_config(arch)))
    params = model.abstract(jnp.bfloat16)
    batch = model.input_specs(JShape("t", kind, S, B))
    if kind == "train":
        low = jax.jit(model.make_train_step()).lower(
            params, abstract_opt_state(params), batch)
    elif kind == "prefill":
        low = jax.jit(model.prefill).lower(params, batch)
    else:
        low = jax.jit(model.serve_step).lower(
            params, model.abstract_cache(B, S), batch)
    text = low.compile().as_text()
    comps, entry = ha.parse_hlo(text)
    mult = ha._multiplicities(comps, entry)
    dims = {o.name: ha._result_dims(o.type_str)[1]
            for ops_ in comps.values() for o in ops_}
    out = collections.Counter()
    for name, ops_ in comps.items():
        for o in ops_:
            if o.opcode in ("dot", "dot-general"):
                out[int(ha._dot_flops(o, dims))] += int(mult.get(name, 1.0))
    assert sum(f * n for f, n in out.items()) == \
        ha.analyze_hlo_text(text)["flops"]
    return out


def _port_products(arch, kind) -> collections.Counter:
    model = build_model(reduced(get_config(arch)))
    fn, args = dryrun.cell_call(model, ShapeConfig("t", kind, S, B),
                                model.abstract(torch.bfloat16))
    with Counter(args) as c:
        fn(*args)
    assert sum(f * n for f, n in c.products.items()) == c.flops
    return c.products


# The train steps' products the port makes beyond (+) or short of (-) the
# JAX step's, {FLOPs of one product: count}, at B 2, S 64 of the reduced
# configs (d 64, 4 heads of 16, vocab 512):
#  * scores: XLA merges (CSE) the layer recompute's q k^T under remat with
#    the flash backward's recomputed q k^T; eager torch computes both:
#    one 2 B H S^2 D = 1,048,576 product per attention layer (2 layers);
#  * logits: XLA merges the loss chunk's recomputed logits with the
#    forward's; one 2 B S d V = 8,388,608 product;
#  * combine: the MoE combine's value gradient (``einsum("tkd,tk->td")``'s
#    backward) is a batched product with K 1 in torch, an elementwise
#    multiply in XLA: one 2 T k d = 65,536 product per MoE layer (2);
#  * SSD backward: the port's plain SSD-scan backward
#    (``ssd_scan_bwd_ref``, the kernel's derived backward) and XLA's
#    autodiff of ``ssd_chunked`` make different products; per Mamba2
#    layer (4; h 8 heads of p 16, state n 16, one chunk of S 64): +2 of
#    2 B S h p = 32,768, -1 of 2 B S^2 h = 131,072, +1 of 2 B S^2 n =
#    262,144 and +4 of 2 B S^2 h p / 4 = 524,288;
#  * down: the MLP's down projection (``dense_matmul``, an autograd
#    Function) is recomputed under remat where ``x @ w`` was not: a
#    Function packs its saved tensors after its forward has run, so the
#    non-reentrant checkpoint's early stop, which ends the recompute once
#    the last saved tensor is packed, comes after the layer's last
#    product and not before it; one 2 B S ff d = 2,097,152 product per
#    dense attention layer (2; an MoE layer ends in its combine).
SCORES, LOGITS, COMBINE, DOWN = 1_048_576, 8_388_608, 65_536, 2_097_152
TRAIN_GAPS = {
    "qwen2-0.5b": {SCORES: 2, LOGITS: 1, DOWN: 2},
    "granite-moe-1b-a400m": {SCORES: 2, LOGITS: 1, COMBINE: 2},
    "zamba2-2.7b": {LOGITS: 1, 32_768: 4 * 2, 131_072: -4 * 1,
                    262_144: 4 * 1, 524_288: 4 * 4},
}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(TRAIN_GAPS))
def test_flops_equal_jax_hlo_dots(need_jax, arch, kind):
    port, want = _port_products(arch, kind), _jax_products(arch, kind)
    gap = collections.Counter(port)
    gap.subtract(want)
    gap = {f: n for f, n in gap.items() if n}
    assert gap == (TRAIN_GAPS[arch] if kind == "train" else {})


# ------------------------------------------------------------ (c) counter


def test_counter_counts_known_functions():
    """mm/bmm/addmm FLOPs, bytes of inputs and outputs once (views free,
    a broadcast dimension once), the peak of live storages, a kernel
    wrapper's call as its own inputs and outputs."""
    meta = dict(device="meta")
    a, b = torch.empty(8, 16, **meta), torch.empty(16, 32, **meta)
    with Counter((a, b)) as c:
        y = a @ b  # mm: 2 * 8 * 32 * 16
        z = y.t().reshape(-1)  # a view of y's transpose: a copy
    assert c.flops == 2 * 8 * 32 * 16
    assert c.hbm_bytes == 4 * (8 * 16 + 16 * 32 + 8 * 32) + 2 * 4 * 8 * 32
    assert c.peak_bytes == 2 * 4 * 8 * 32 and c.output_bytes(z) == 4 * 256

    x, w = torch.empty(3, 4, 5, **meta), torch.empty(3, 5, 6, **meta)
    bias = torch.empty(6, **meta)
    with Counter((x, w, bias)) as c:
        torch.bmm(x, w)
        torch.addmm(bias, x[0], w[0])  # bias broadcast: 6 values read
        x.view(60)  # a view moves nothing
    assert c.flops == 2 * 3 * 4 * 6 * 5 + 2 * 4 * 6 * 5
    assert c.products == {720: 1, 240: 1}
    assert c.hbm_bytes == 4 * (60 + 90 + 72) + 4 * (6 + 20 + 30 + 24)
    assert tensor_bytes(bias.expand(4, 6)) == 24

    with Counter(()) as c:
        t1 = torch.empty(1024, **meta).fill_(1.0)  # 4 KiB live
        t2 = torch.empty(2048, **meta).fill_(1.0)  # 12 KiB live
        del t1  # 8 KiB live
        t3 = torch.empty(512, **meta).fill_(1.0)  # 10 KiB live
    assert c.peak_bytes == 4 * (1024 + 2048) and c.live_bytes == 4 * 2560
    del t2, t3

    h, scale = torch.empty(8, 896, dtype=torch.bfloat16, **meta), \
        torch.empty(896, dtype=torch.bfloat16, **meta)
    with Counter((h, scale)) as c:
        ops.rmsnorm(h, scale)
    # x, the scale and y once, whatever the plain version does
    assert c.hbm_bytes == 2 * (8 * 896 + 896 + 8 * 896)
    assert c.kernel_calls == {"rmsnorm_fwd": 1} and c.flops == 0
    assert c.peak_bytes == 2 * 8 * 896


def test_roofline_over_h100_constants():
    r = Roofline(989e12, 3.35e12, 0.0)
    assert r.t_compute == pytest.approx(1.0) and r.t_memory == \
        pytest.approx(1.0)
    assert (r.peak_flops, r.hbm_bw) == (PEAK_FLOPS_BF16, HBM_BW)
    r = Roofline(1e12, 3.35e12, 0.0)
    assert r.bottleneck == "memory" and r.t_total == r.t_memory
    assert set(r.as_dict()) == {
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "t_compute_s", "t_memory_s",
        "t_collective_s", "bottleneck"}


def test_meta_runs_plain_versions_and_mixes_raise():
    q = torch.empty(2, 8, 2, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 8, 1, 64, dtype=torch.bfloat16, device="meta")
    out = ops.flash_attention(q, k, k)
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention(q, torch.zeros(k.shape, dtype=k.dtype), k)


# ------------------------------------------------------ (d) skipped cells


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skipped_cells_are_shape_applicables(need_jax, arch):
    for name, shape in SHAPES.items():
        jok, jreason = ha_applicable(arch, shape)
        ok, reason = shape_applicable(get_config(arch), shape)
        assert (ok, reason) == (jok, jreason)
        if not ok:
            rec = dryrun.trace_cell(arch, name)
            assert rec["status"] == "skipped" and rec["reason"] == reason
            assert rec["mesh"] == "1xH100"


def ha_applicable(arch, shape):
    from repro.configs import shape_applicable as jshape_applicable
    return jshape_applicable(jget_config(arch),
                             JShape(shape.name, shape.kind, shape.seq_len,
                                    shape.global_batch))


# ------------------------------------------------- (e) extrapolated cells


def test_xlstm_extrapolation_is_on_the_line():
    """Reduced xlstm (scan_chunk 64) prefill of 320 tokens, traced whole
    and extrapolated from 128 and 192: the same FLOPs, bytes, arguments,
    outputs and kernel calls; the extrapolated peak at most the traced
    one."""
    model = build_model(reduced(get_config("xlstm-1.3b"), scan_chunk=64))
    shape = ShapeConfig("t", "prefill", 320, 2)
    whole = dryrun._count(model, shape)
    line = dryrun.extrapolated(model, shape, (128, 192))
    for key in ("flops", "hbm_bytes", "argument_size_in_bytes",
                "output_size_in_bytes", "kernel_calls"):
        assert line[key] == whole[key], key
    assert 0 < line["temp_size_in_bytes"] <= whole["temp_size_in_bytes"]


def test_sweep_resumes_and_records(tmp_path):
    """The CLI's sweep over one cheap cell writes its record, resumes
    from the file and prints the done line."""
    out = tmp_path / "dryrun.json"
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    recs = dryrun.sweep(["qwen2-0.5b"], ["decode_32k"], str(out),
                        verbose=False)
    (rec,) = recs
    assert rec["status"] == "ok" and rec["fits"] is True
    assert rec["kernel_calls"] == {"flash_decode": 24,
                                   "rmsnorm_fwd": 2 * 24 + 1,
                                   "dense_matmul_fwd": 7 * 24}
    assert rec["roofline"]["bottleneck"] == "memory"


def test_split_rule_holds_long_rows_within_the_key_cap():
    """The dry run's executed long_500k cells: rows past
    ``MAX_SPLIT_KEYS`` keys take enough splits (at most ``MAX_SPLITS``)
    that a split stages at most that many keys; shorter rows are cut as
    the SMs alone ask (the rule before the cap)."""
    for S, units, D in ((524_288, 32, 80), (524_288, 1, 256),
                        (32_768, 256, 64), (16_385, 8, 64)):
        keys, splits = pd.split_rule(S, units, D)
        assert keys <= pd.MAX_SPLIT_KEYS and splits <= pd.MAX_SPLITS
        assert keys % pd.key_tile(D) == 0 and (splits - 1) * keys < S \
            <= splits * keys
    for S in (1, 60, 448, 1000, 1500, 8192, 16_384):
        for units in (1, 8, 14, 32, 256):
            kt = pd.key_tile(64)
            want = max(1, -(-2 * pd.SMS // units))
            keys = max(-(-S // want), -(-S // pd.MAX_SPLITS))
            keys = -(-keys // kt) * kt
            assert pd.split_rule(S, units, 64) == (keys, -(-S // keys))


# ------------------------------------- (f) parallel sweep, executed cells


def test_parallel_sweep_gives_the_sequential_records(monkeypatch):
    """Two worker processes: a skipped cell, a whole trace and a cell
    extrapolated from two traces (qwen2-0.5b's decode, made one here: its
    counts are affine in the cache length) give the records of the
    sequential sweep, but for the seconds they took."""
    cfg = get_config("qwen2-0.5b")
    monkeypatch.setitem(dryrun.EXTRAPOLATED, (cfg.block_kind, "decode"),
                        (8192, 16384))
    cells = (["qwen2-0.5b", "xlstm-1.3b"], ["decode_32k", "long_500k"])
    par = dryrun.sweep(*cells, verbose=False, jobs=2)
    seq = dryrun.sweep(*cells, verbose=False)

    def key(r):
        return r["arch"], r["shape"]

    def strip(r):
        return {k: v for k, v in r.items() if k != "t_trace_s"}

    assert [strip(r) for r in sorted(par, key=key)] == \
        [strip(r) for r in sorted(seq, key=key)]
    (rec,) = [r for r in par if key(r) == ("qwen2-0.5b", "decode_32k")]
    assert rec["extrapolated_from"] == [8192, 16384]
    assert rec["kernel_calls"] == {"flash_decode": 24,
                                   "rmsnorm_fwd": 2 * 24 + 1,
                                   "dense_matmul_fwd": 7 * 24}
    assert [r["status"] for r in sorted(par, key=key)] == \
        ["ok", "skipped", "ok", "ok"]


def test_counters_cover_every_kernel_wrapper():
    """``dryrun.COUNTERS`` names every kernel wrapper the trace can count
    (``device.kernel_wrapper``), each with an integer launch counter."""
    # every decorated wrapper runs the decorator's one inner function
    code = kernel_wrapper(len).__code__
    wrapped = set()
    for mod in ("dense_matmul", "flash_attention", "flash_decode",
                "moe_gmm",
                "paged_decode", "paged_verify", "rmsnorm", "ssd_scan"):
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        wrapped |= {name for name, f in vars(m).items()
                    if getattr(f, "__code__", None) is code}
    assert wrapped == set(dryrun.COUNTERS)
    counts = dryrun.launch_counts()
    assert set(counts) == wrapped
    assert all(isinstance(n, int) for n in counts.values())


# the kernel wrappers each decode step calls
WRAPPERS_CALLED = {"qwen2-0.5b": {"rmsnorm_fwd", "flash_decode",
                                  "dense_matmul_fwd"},
                   "zamba2-2.7b": {"rmsnorm_fwd", "flash_decode",
                                   "dense_matmul_fwd"},
                   "xlstm-1.3b": {"rmsnorm_fwd"}}


@pytest.mark.parametrize("arch", sorted(WRAPPERS_CALLED))
def test_executed_decode_inputs_and_first_calls(arch):
    """The executed cells' decode inputs at reduced size: positions ragged
    in [S/2, S - 3], pos_map filled to two entries past each and empty
    beyond (no pos_map where the cache has none), every float cache leaf
    random (the sLSTM normalizer positive); ``FirstCalls`` keeps one copy
    of each wrapper's first call, equal to what the kernel was given."""
    S, B = 64, 6
    model = build_model(reduced(get_config(arch)))
    params = model.init(0, torch.float32, device="cpu")
    fn, (p, cache, batch) = dryrun.real_call(
        model, ShapeConfig("t", "decode", S, B), params)
    assert p is params and fn == model.serve_step
    pos = batch["pos"]
    assert bool(((pos >= S // 2) & (pos <= S - 3)).all())
    assert len(set(pos.tolist())) > 1
    if "pos_map" in model.abstract_cache(B, S):
        pm = cache["pos_map"]
        j = torch.arange(S)
        assert torch.equal(pm, torch.where(j <= pos[:, None] + 2, j, -1)
                           .to(pm.dtype))
    else:
        assert "pos_map" not in cache
    for name, t in cache.items():
        if t.is_floating_point():
            assert bool((t != 0).any()), name
            if name in dryrun.POSITIVE_STATES:
                assert bool((t >= 0).all()), name
    first = dryrun.FirstCalls()
    with torch.no_grad(), dryrun.observe_kernels(first):
        fn(p, cache, batch)
    assert set(first.calls) == WRAPPERS_CALLED[arch]
    for name, (args, kw, out) in first.calls.items():
        plain = getattr(ops, dryrun.COUNTERS[name][0])
        ref = plain(*args, **kw)
        assert torch.equal(ref[0] if isinstance(ref, tuple) else ref, out)
