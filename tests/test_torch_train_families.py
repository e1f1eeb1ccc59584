"""Training of the MoE, zamba2, xlstm and whisper families held to the JAX
package on the CPU: ``train_loss`` with every gradient leaf, AdamW steps,
``launch.train`` on every config of the zoo and its bitwise resume.

Weights are drawn by the JAX package from seed 0 and copied
(``from_jax_params``); batches are made with numpy from a seed; the JAX
side runs on the CPU on any host (``need_jax``).  Tolerances, each with
its reason (those of ``tests/test_torch_train.py``):
* ``train_loss`` and every gradient leaf against
  ``jax.value_and_grad(lm.train_loss)`` in fp32 at ``reduced`` size: the
  loss 1e-5 relative, each leaf within GRAD_REL of its own largest |g|
  (small fp32 layers summed in other orders);
* parameters after 2 AdamW steps from each package's own gradients: the
  Adam-aware bound (each value within 1e-6 + 2 lr steps min(1, 1e-5 s /
  |g|), s the largest gradient, |g| its own smallest over the steps).
zamba2 and xlstm run ``scan_chunk`` 16 over 32 tokens, so that the scan
crosses a chunk.  whisper's key biases (``bk``) have a gradient of
exactly zero in both packages' mathematics: without rope, ``q . bk`` is
one constant across a query's keys, which the softmax cancels.  Each
package's value is rounding noise (~1e-9), which no relative bound can
compare; they are held within GRAD_REL of the model's largest |g|
instead, i.e. to zero at the gradients' scale.  The port's remat is held
to its no-remat bit for bit, and a resumed ``launch.train`` run to the
uninterrupted one bit for bit.
"""
import os
import shutil

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
    from repro.models import lm as jlm
    from repro.train import optimizer as jopt
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.launch.train import train
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint as ck
from repro_torch.train import optimizer as opt
from repro_torch.weights import from_jax_params

FAMILIES = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b", "zamba2-2.7b",
            "xlstm-1.3b", "whisper-large-v3"]
CHUNKED = {"zamba2-2.7b", "xlstm-1.3b"}  # scan_chunk 16 over 32 tokens
GRAD_REL = 1e-5  # of each leaf's largest |g|
PARAM_ATOL, ADAM_REL = 1e-6, 1e-5  # the Adam-aware bound's terms
SEQ = 32


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(got, want, frac, what=""):
    """|got - want| within ``frac`` of want's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= frac * scale, (what, err, scale)


def _models(arch):
    over = {"scan_chunk": 16} if arch in CHUNKED else {}
    jcfg = jreduced(jget_config(arch), act_dtype="float32", **over)
    tcfg = reduced(get_config(arch), act_dtype="float32", **over)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _batch(cfg, B=2, seed=0, ignore=3):
    """The same batch for both packages: tokens, labels (the first
    ``ignore`` ignored) and, for whisper, encoder frames."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, SEQ)),
              "labels": rng.integers(0, cfg.vocab, (B, SEQ))}
    arrays["labels"][:, :ignore] = -1
    if cfg.cross_attention:
        arrays["encoder_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
          for k, v in arrays.items()}
    return jb, {k: torch.from_numpy(v) for k, v in arrays.items()}


def _leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_jax(need_jax, arch):
    """``train_loss`` and every gradient leaf against
    ``jax.value_and_grad(lm.train_loss)`` in fp32; every leaf gets a
    nonzero gradient; the port's remat gives its no-remat loss and
    gradients bit for bit."""
    jcfg, tcfg, jp, tp = _models(arch)
    jb, tb = _batch(tcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, jb)))(jp)
    out = {}
    for remat in (True, False):
        live = opt.tree_map(lambda p: p.detach().requires_grad_(), tp)
        loss = lm.train_loss(tcfg, live, tb, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, opt.leaves(live)))
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    np.testing.assert_allclose(out[True][0].item(), float(jl), rtol=1e-5)
    top = max(float(g.abs().max()) for g in out[True][1])
    for (path, _), g in zip(opt.tree_paths(tp), out[True][1]):
        w = np.asarray(_leaf(jg, path))
        if tcfg.cross_attention and path.endswith("/bk"):  # exactly zero
            assert float(np.abs(w).max()) <= GRAD_REL * top, path
            assert float(g.abs().max()) <= GRAD_REL * top, path
            continue
        assert float(np.abs(w).max()) > 0, path
        _close(_np(g), w, GRAD_REL, path)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-2.7b"])
def test_train_steps_match_jax(need_jax, arch):
    """2 ``make_train_step`` steps of both packages from the same weights
    and batches: the losses, and the parameters within the Adam-aware
    bound (|g| and s from the port's gradients at each step)."""
    jcfg, tcfg, jp, tp = _models(arch)
    ocfg = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jstep = jax.jit(jm.make_train_step(jopt.AdamWConfig(**ocfg)))
    tstep = tm.make_train_step(opt.AdamWConfig(**ocfg))
    jo, to = jm.init_opt(jp), tm.init_opt(tp)
    lo, s = None, 0.0
    for i in range(2):
        jb, tb = _batch(tcfg, seed=10 + i)
        live = opt.tree_map(lambda p: p.detach().requires_grad_(), tp)
        grads = torch.autograd.grad(tm.train_loss(live, tb),
                                    opt.leaves(live))
        ga = [g.abs() for g in grads]
        lo = ga if lo is None else [torch.minimum(a, b)
                                    for a, b in zip(lo, ga)]
        s = max(s, max(float(a.max()) for a in ga))
        jp, jo, jmet = jstep(jp, jo, jb)
        tp, to, tmet = tstep(tp, to, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    for (path, leaf), low in zip(opt.tree_paths(tp), lo):
        diff = np.abs(_np(leaf) - np.asarray(_leaf(jp, path)))
        share = np.minimum(1.0, ADAM_REL * s / np.maximum(_np(low), 1e-30))
        bound = PARAM_ATOL + 2 * ocfg["lr"] * 2 * share
        assert (diff <= bound).all(), (path, float((diff - bound).max()))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launch_train_every_arch(arch):
    """``launch.train`` trains every config of the zoo at reduced size on
    the CPU: finite losses, and parameters that moved."""
    params, losses = train(arch, steps=2, batch=2, seq=SEQ, log_every=0,
                           lr=1e-3, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    start = build_model(reduced(get_config(arch))).init(0, torch.float32,
                                                        device="cpu")
    assert any(not torch.equal(a, b) for a, b in
               zip(opt.leaves(params), opt.leaves(start)))


def test_launch_train_resume_is_bitwise_whisper(tmp_path):
    """whisper through ``launch.train`` (frames drawn from the step's
    seed): 4 steps checkpointing every 2; a second run from the step-2
    checkpoint gives the uninterrupted run's last 2 losses and final
    parameters bit for bit."""
    kw = dict(steps=4, batch=2, seq=16, ckpt_every=2, log_every=0,
              device="cpu")
    full, fresh = str(tmp_path / "full"), str(tmp_path / "resume")
    params, losses = train("whisper-large-v3", ckpt_dir=full, **kw)
    assert ck.list_checkpoints(full) == [2, 4]
    assert np.isfinite(losses).all() and len(losses) == 4
    os.makedirs(fresh)
    shutil.copytree(os.path.join(full, "ckpt_0000000002"),
                    os.path.join(fresh, "ckpt_0000000002"))
    resumed, rest = train("whisper-large-v3", ckpt_dir=fresh, **kw)
    assert rest == losses[2:]
    assert all(torch.equal(a, b) for a, b in
               zip(opt.leaves(resumed), opt.leaves(params)))
