"""Port model steps against the JAX package: the same fp32 parameters
(``from_jax_params``) run two paged prefill chunks (the second one padded)
and then three batched paged decode ticks in both packages, with bf16 and
int8 page pools, on the reduced qwen2-0.5b, llama3.2-3b and gemma3-1b.

Tolerances.  The activations are fp32, but both pools round to a narrow
type: bf16 pages (and the attention probabilities, cast to the page type
as the JAX package does) or int8 pages.  fp32 values that differ in their
last bits between the packages (their matmuls sum in other orders) can
round to neighbouring bf16 values or int8 steps, which moves that step's
logits by a few 1e-4 (up to 4.8e-4 seen, bf16 pool, on another x86 CPU),
so logits are held to atol/rtol 1e-3; a wrong mask, rope or scale moves
them by 1e-1 or more.  bf16 pages within one bf16 ulp, int8 pages within
one quantization step, scales rtol 4e-6 (absmax / 127 of a K/V row: a few
fp32 ulps).  Where the pages differ at all, the JAX pages are copied into
the port's pool so the next step starts from the same cache.  The null
page 0 is not compared: inactive slots all write its row 0, in an order
neither package fixes."""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
except ImportError:  # JAX (the reference) is not installed
    jax = None

from repro_torch.configs import get_config, reduced
from repro_torch.models.api import build_model
from repro_torch.weights import from_jax_params

NB, BS = 8, 8  # block table width and page size: max_seq 64
SLOT_PAGES = {0: [3, 1, 5, 7], 2: [2, 4, 6, 8, 9]}  # physical page ids


@pytest.fixture
def need_jax():
    """JAX, with the reference computed on the CPU on any host: JAX on a
    GPU computes fp32 products at a lower default precision than these
    tolerances allow for."""
    if jax is None:
        pytest.skip("JAX (the reference package) is not installed here")
    with jax.default_device(jax.devices("cpu")[0]):
        yield


def _models(arch):
    cfg = jreduced(jget_config(arch), act_dtype="float32")
    jm = jbuild(cfg)
    jp = jm.init(jax.random.PRNGKey(0), param_dtype=jnp.float32)
    tm = build_model(reduced(get_config(arch), act_dtype="float32"))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jm, jp, tm, tp


def _row(pages):
    row = np.full(NB, -1, np.int32)
    row[:len(pages)] = pages
    return row


def _check_step(jl, tl, jcache, tcache, rows=slice(None)):
    """Hold one step's logits and pages to the JAX package's."""
    differ = False
    for name, leaf in jcache.items():
        a = np.asarray(leaf.astype(jnp.float32))[:, 1:]
        b = tcache[name].float().numpy()[:, 1:]
        if name.endswith("scales"):
            np.testing.assert_allclose(b, a, rtol=4e-6, atol=0)
        elif leaf.dtype == jnp.int8:
            assert np.abs(a - b).max() <= 1, name
        else:  # one bf16 ulp: at most 2^-7 of the larger magnitude
            bound = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b))
            assert bool((np.abs(a - b) <= bound).all()), name
        differ |= bool((a != b).any())
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                               atol=1e-3, rtol=1e-3)
    if differ:  # start the next step from the same cache
        fresh = from_jax_params(dict(jcache), device="cpu")
        for name, leaf in fresh.items():
            tcache[name].copy_(leaf)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama3.2-3b", "gemma3-1b"])
def test_prefill_and_decode_steps_match_jax(need_jax, arch, kv_dtype):
    cfg, jm, jp, tm, tp = _models(arch)
    P = 12
    abstract = jm.abstract_paged_cache(P, BS, kv_dtype=kv_dtype)
    jcache = {n: jnp.zeros(s.shape, s.dtype) for n, s in abstract.items()}
    tcache = {n: torch.zeros(s.shape, dtype=s.dtype)
              for n, s in tm.abstract_paged_cache(P, BS, kv_dtype).items()}
    assert {n: tuple(t.shape) for n, t in tcache.items()} == \
        {n: tuple(s.shape) for n, s in abstract.items()}
    rng = np.random.default_rng(0)
    lengths = {0: 21, 2: 37}  # prompts: a full 16-chunk, then a padded one
    pos = np.zeros(3, np.int32)
    last = np.zeros(3, np.int64)
    for slot, T in lengths.items():
        toks = rng.integers(0, cfg.vocab, T)
        row = _row(SLOT_PAGES[slot])
        done = 0
        while done < T:
            n = min(16, T - done)
            padded = np.zeros(16, np.int32)
            padded[:n] = toks[done:done + n]
            jl, jcache = jm.prefill_chunk_paged(jp, jcache, {
                "tokens": jnp.asarray(padded)[None],
                "block_tables": jnp.asarray(row)[None],
                "pos": jnp.asarray(done, jnp.int32),
                "length": jnp.asarray(n, jnp.int32)})
            tl, tcache = tm.prefill_chunk_paged(tp, tcache, {
                "tokens": torch.from_numpy(padded.astype(np.int64))[None],
                "block_tables": torch.from_numpy(row)[None],
                "pos": done, "length": n})
            _check_step(jl, tl, jcache, tcache)
            done += n
        pos[slot] = T
        last[slot] = int(np.argmax(np.asarray(jl)[0]))
    tables = np.stack([_row(SLOT_PAGES[0]), _row([]),
                       _row(SLOT_PAGES[2])])  # slot 1 inactive
    for _ in range(3):
        jl, jcache = jm.serve_step_paged(jp, jcache, {
            "tokens": jnp.asarray(last, jnp.int32),
            "pos": jnp.asarray(pos), "block_tables": jnp.asarray(tables)})
        tl, tcache = tm.serve_step_paged(tp, tcache, {
            "tokens": torch.from_numpy(last), "pos": torch.from_numpy(pos),
            "block_tables": torch.from_numpy(tables)})
        active = [0, 2]
        _check_step(jl, tl, jcache, tcache, active)
        last = np.asarray(jnp.argmax(jl, -1)).astype(np.int64)
        pos[active] += 1


def test_init_is_seeded_per_leaf():
    m = build_model(reduced(get_config("qwen2-0.5b")))
    a = m.init(3, param_dtype=torch.float32, device="cpu")
    b = m.init(3, param_dtype=torch.float32, device="cpu")
    c = m.init(4, param_dtype=torch.float32, device="cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"],
                           c["layers"]["attn"]["wq"])
    assert a["layers"]["attn"]["wq"].shape == (2, 64, 64)
    assert bool((a["layers"]["ln1_s"] == 1).all())


def test_unported_families_raise():
    with pytest.raises(NotImplementedError):
        build_model(reduced(get_config("qwen2-moe-a2.7b"))).spec
    with pytest.raises(NotImplementedError):
        build_model(reduced(get_config("zamba2-2.7b"))).spec
