"""The port's frozen encoders, feature store and extractor
(``repro_torch/core/encoders.py``, ``feature_store.py``, ``extractor.py``)
held to the JAX package's on the CPU.

The same seeded numpy inputs go to both packages, and the JAX package's
weights are carried across with ``repro_torch.weights.from_jax_params``
(the port's own draw gives other numbers).  The JAX side runs on the CPU
on any host (the ``need_jax`` fixture pins it there).

Tolerances (each with its reason):
* the encoder features: 2e-5 of the features' RMS, absolute: fp32
  matmuls over 2-12 layers summed in other orders (measured about 3e-6
  of the RMS at the "paper" profile, 2e-6 at "tiny");
* the extractor's fused features: 5e-6 absolute on values of order 1
  (four small fp32 layers; each LayerNorm rescales its input's rounding,
  measured 2.2e-6 at a 768-d input).
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.core import encoders as jenc
    from repro.core import extractor as jex
    from repro.core import feature_store as jfs
    from repro.data import taskgen as jtaskgen
    from repro.nn.spec import init_params as jinit
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.core import encoders as enc
from repro_torch.core import extractor as ex
from repro_torch.core import feature_store as fs
from repro_torch.data.taskgen import make_taskset
from repro_torch.weights import from_jax_params

FEAT_RTOL = 2e-5  # of the features' RMS
EXT_TOL = dict(atol=5e-6, rtol=0)


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_encoders(profile, seed=0):
    """The JAX package's frozen weights (its own draw) as numpy trees,
    drawn without its lru_cache so a large profile is freed after use."""
    p = jenc.PROFILES[profile]
    kv, kb = jax.random.split(jax.random.PRNGKey(seed))
    return (_np_tree(jinit(jenc.vit_spec(p), kv, jnp.float32)),
            _np_tree(jinit(jenc.bert_spec(p), kb, jnp.float32)))


def carried(profile, seed=0):
    """(JAX numpy weights, the same weights as the port's tensors)."""
    nv, nb = jax_encoders(profile, seed)
    return (nv, nb), (from_jax_params(nv, device="cpu"),
                      from_jax_params(nb, device="cpu"))


def media(p, B, seed, pad_rows=()):
    """Seeded images, token ids and a mask whose rows in ``pad_rows``
    (row -> kept length) are padded."""
    rng = np.random.default_rng(seed)
    imgs = rng.random((B, p.img_size, p.img_size, 3), dtype=np.float32)
    toks = rng.integers(0, p.bert_vocab, (B, p.text_len)).astype(np.int32)
    mask = np.ones((B, p.text_len), np.int32)
    for row, keep in pad_rows:
        mask[row, keep:] = 0
    return imgs, toks, mask


def assert_features(got, want):
    rms = float(np.sqrt((want ** 2).mean()))
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_RTOL * rms)


def jax_forward(nv, nb, imgs, toks, mask, profile):
    p = jenc.PROFILES[profile]
    return (np.asarray(jenc.vit_encode(nv, jnp.asarray(imgs), p)),
            np.asarray(jenc.bert_encode(nb, jnp.asarray(toks),
                                        jnp.asarray(mask), p)))


def port_forward(tv, tb, imgs, toks, mask, profile):
    p = enc.PROFILES[profile]
    return (enc.vit_encode(tv, torch.from_numpy(imgs), p).numpy(),
            enc.bert_encode(tb, torch.from_numpy(toks),
                            torch.from_numpy(mask), p).numpy())


def spec_rows(tree, spec_type):
    """{leaf path: (shape, axes, init, scale)} of a spec tree."""
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, spec_type))
    return {jax.tree_util.keystr(k): (s.shape, s.axes, s.init, s.scale)
            for k, s in flat}


def test_profiles_and_specs_match_jax(need_jax):
    """Every profile, and every leaf's shape, init and scale of both
    encoders' specs, equal the JAX package's."""
    assert {k: dataclasses.asdict(v) for k, v in enc.PROFILES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jenc.PROFILES.items()}
    for name in enc.PROFILES:
        for spec, jspec in ((enc.vit_spec, jenc.vit_spec),
                            (enc.bert_spec, jenc.bert_spec)):
            assert spec_rows(spec(enc.PROFILES[name]), enc.TensorSpec) == \
                spec_rows(jspec(jenc.PROFILES[name]), jenc.TensorSpec)


@pytest.mark.parametrize("pad_rows", [
    (), ((1, 5),), ((0, 1), (2, 9), (3, 0))],
    ids=["no-padding", "one-padded-row", "padded-and-empty-rows"])
def test_tiny_encoders_match_jax(need_jax, pad_rows):
    """ViT and BERT at the "tiny" profile, BERT with padded rows and a row
    with no token at all (its mean pool divides by max(0, 1))."""
    (nv, nb), (tv, tb) = carried("tiny")
    imgs, toks, mask = media(enc.PROFILES["tiny"], 4, 1, pad_rows)
    want = jax_forward(nv, nb, imgs, toks, mask, "tiny")
    got = port_forward(tv, tb, imgs, toks, mask, "tiny")
    for g, w in zip(got, want):
        assert_features(g, w)
    if any(keep == 0 for _, keep in pad_rows):
        assert np.all(got[1][3] == 0)


def test_paper_profile_shapes_match_jax(need_jax):
    """The "paper" profile at B 2: ViT-B/16's 14 x 14 patchify (197
    tokens, 12 layers of 768) and DistilBERT at L 256 with a padded row."""
    (nv, nb), (tv, tb) = carried("paper")
    imgs, toks, mask = media(enc.PROFILES["paper"], 2, 2, ((1, 77),))
    want = jax_forward(nv, nb, imgs, toks, mask, "paper")
    got = port_forward(tv, tb, imgs, toks, mask, "paper")
    for g, w in zip(got, want):
        assert g.shape == (2, 768)
        assert_features(g, w)


def _patched(monkeypatch, tv, tb):
    """The port's feature store drawing its encoders from ``tv``/``tb``."""
    p = enc.PROFILES["tiny"]
    monkeypatch.setattr(fs, "frozen_encoders",
                        lambda profile, seed, device: (tv, tb, p))


@pytest.mark.parametrize("batch", [16, 128])
def test_compute_features_matches_jax(need_jax, monkeypatch, batch):
    """``compute_features`` over a 40-task TaskSet (one batch, and three
    with a ragged last one) gives the JAX function's features."""
    (nv, nb), (tv, tb) = carried("tiny")
    monkeypatch.setattr(jfs, "frozen_encoders",
                        lambda profile, seed: (nv, nb, jenc.PROFILES[profile]))
    _patched(monkeypatch, tv, tb)
    want = jfs.compute_features(jtaskgen.make_taskset(40, 3), "tiny",
                                batch=batch, cache_dir=None)
    got = fs.compute_features(make_taskset(40, 3), "tiny", batch=batch,
                              cache_dir=None, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (40, 128)
        assert_features(g, w)


def test_feature_cache_is_the_ports_own(need_jax, monkeypatch, tmp_path):
    """The port's cache file has a name the JAX package never writes (and
    the device type in it); a JAX file of the same tasks in the directory
    is not read; a cached round trip returns the same arrays."""
    tasks = make_taskset(40, 3)
    jname = f"feats_tiny_{tasks.seed}_{tasks.n}_0.npz"
    name = fs.cache_name(tasks, "tiny", 0, "cpu")
    assert name == "pt_feats_tiny_3_40_0_cpu.npz" and name != jname
    np.savez_compressed(tmp_path / jname, f_img=np.zeros((40, 128)),
                        f_text=np.zeros((40, 128)))
    _, (tv, tb) = carried("tiny")
    _patched(monkeypatch, tv, tb)
    first = fs.compute_features(tasks, "tiny", cache_dir=str(tmp_path),
                                device="cpu")
    assert (tmp_path / name).exists()
    assert np.abs(first[0]).max() > 0  # not the planted JAX file
    monkeypatch.setattr(fs, "frozen_encoders", None)  # must not be called
    again = fs.compute_features(tasks, "tiny", cache_dir=str(tmp_path),
                                device="cpu")
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_frozen_encoders_cache_and_device(monkeypatch):
    """Cached by profile, seed and device; float32 leaves on the CPU; the
    vit and bert trees differ; ``encode_batch`` is the two forwards; no
    card and no device raises instead of running on the CPU."""
    a = enc.frozen_encoders("tiny", 0, "cpu")
    assert enc.frozen_encoders("tiny", 0, torch.device("cpu")) is a
    assert enc.frozen_encoders("tiny", 1, "cpu") is not a
    vit, bert, p = a
    assert p is enc.PROFILES["tiny"] and vit["cls"].dtype == torch.float32
    assert not torch.equal(vit["layers"]["wq"], bert["layers"]["wq"])
    imgs, toks, mask = media(p, 3, 4, ((2, 3),))
    fi, ft = enc.encode_batch(imgs, toks, mask, profile="tiny",
                              device="cpu")
    wi, wt = port_forward(vit, bert, imgs, toks, mask, "tiny")
    np.testing.assert_array_equal(fi.numpy(), wi)
    np.testing.assert_array_equal(ft.numpy(), wt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enc.frozen_encoders("tiny", 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fs.compute_features(make_taskset(4, 0), "tiny", cache_dir=None)


def _extractor_inputs(B, feat_dim, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, feat_dim)).astype(np.float32),
            rng.normal(size=(B, feat_dim)).astype(np.float32),
            rng.integers(0, 8, B), rng.integers(0, 8, B))


@pytest.mark.parametrize("feat_dim,B", [(128, 5), (768, 64)])
def test_extract_deterministic_matches_jax(need_jax, feat_dim, B):
    """The extractor's deterministic path from the JAX weights."""
    jp = jex.init_extractor(jax.random.PRNGKey(3), feat_dim)
    ft, fi, mid, did = _extractor_inputs(B, feat_dim, 5)
    want = np.asarray(jex.extract(jp, jnp.asarray(ft), jnp.asarray(fi),
                                  jnp.asarray(mid), jnp.asarray(did)))
    params = from_jax_params(_np_tree(jp), device="cpu")
    got = ex.extract(params, torch.from_numpy(ft), torch.from_numpy(fi),
                     torch.from_numpy(mid), torch.from_numpy(did)).numpy()
    assert got.shape == (B, ex.FUSED_DIM)
    np.testing.assert_allclose(got, want, **EXT_TOL)


def test_extract_dropout_draws_from_the_generator():
    """With dropout on, the masks come from the caller's generator: the
    same seed gives the same output, another seed another; about a tenth
    of the last layer's values are dropped, the rest scaled by 1/0.9."""
    params = ex.init_extractor(0, 128, device="cpu")
    ft, fi, mid, did = (torch.from_numpy(a) for a in
                        _extractor_inputs(256, 128, 6))

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return ex.extract(params, ft, fi, mid, did, generator=gen,
                          dropout=0.1, deterministic=False)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    share = float((a == 0).float().mean())
    assert 0.07 < share < 0.13, share
    det = ex.extract(params, ft, fi, mid, did)
    assert torch.equal(det, ex.extract(params, ft, fi, mid, did,
                                       dropout=0.5))
