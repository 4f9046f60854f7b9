"""The port's dense LM family (attention, RoPE, the KV cache, SwiGLU / GeGLU /
GELU MLPs, Gemma2's local / global windows and softcaps) against the JAX
package's, on the CPU, on the same numpy-seeded inputs.

* **Layers**, in fp32 at atol 2e-5 (fp32 sums in another order):
  ``rope``, ``flash_attention`` (GQA ratios 1, 2 and 4, with and without a
  window and a softcap, a sequence ragged against ``kv_chunk``, a query
  offset), ``attn_decode`` (its cache written in place), ``attn_forward``
  with ``kv_override``, the three MLPs and the layernorm.
* **The four reduced dense configs** from the JAX model's weights
  (``convert.params_from_jax``): the init's shapes and scales, every leaf
  carried across, fp32 prefill logits and cache then three decode steps at
  atol 2e-4, rtol 1e-3 (as ``tests/test_models.py``), ``forward_hidden``
  against prefill plus one decode, fp32 server tokens equal to the JAX
  server's, and bf16 server tokens held by the rule of
  :func:`_lm_parity.assert_bf16_server_rule`.
* **Windows**: Gemma2 with ``local_window=4`` at prompts past the window,
  ``tests/test_models.py::test_gemma2_local_global_masking_differs`` on the
  port, and ``sliding_window=8`` on reduced granite.
* **In-place decode**: ``decode_step`` keeps the cache's storage, and its
  contents equal the reference's new cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import backbone as JB
from repro.models import layers as JL
from repro.models import prefill as JP

from _lm_parity import assert_bf16_server_rule, flat, models, servers, tokens
from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.models import Model, backbone, convert
from repro_torch.models import layers as L
from repro_torch.models import prefill as P

T = torch.from_numpy
LAYER_TOL = dict(atol=2e-5, rtol=0)
TOL = dict(atol=2e-4, rtol=1e-3)
DENSE = ("qwen1.5-4b", "phi4-mini-3.8b", "granite-3-2b", "gemma2-9b")


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 45])
@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_jax(theta, offset):
    rng = np.random.default_rng(int(theta) % 97 + offset)
    x = _normal(rng, 2, 3, 13, 32)
    pos = (offset + np.arange(13)).astype(np.int32)
    _close(L.rope(T(x), T(pos), theta), JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_rope_rotates_halves_and_keeps_bf16():
    """Halves, not interleaved pairs: position 0 is the identity and a bf16
    input comes back in bf16, within one rounding of the fp32 rotation."""
    x = torch.randn(1, 1, 3, 8, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(L.rope(x, torch.zeros(3, dtype=torch.long), 1e4), x)
    xb = x.bfloat16()
    got = L.rope(xb, torch.arange(3), 1e4)
    assert got.dtype == torch.bfloat16
    want = JL.rope(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.arange(3), 1e4)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("q_offset", [0, 5])
@pytest.mark.parametrize("softcap", [None, 2.0])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_flash_attention_matches_jax(g, window, softcap, q_offset):
    """GQA ratio ``g``, S = 37 against kv_chunk 16 (a padded tail chunk);
    ``q_offset`` puts the 32 queries at the end of the 37 keys."""
    rng = np.random.default_rng(100 * g + (window or 0) + q_offset)
    hkv, skv, sq, hd = 2, 37, 37 - q_offset, 16
    q = _normal(rng, 2, hkv * g, sq, hd, scale=2.0)
    k, v = _normal(rng, 2, hkv, skv, hd, scale=2.0), _normal(rng, 2, hkv, skv, hd)
    kw = dict(q_offset=q_offset, window=window, softcap=softcap, kv_chunk=16)
    want = JL.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    _close(L.flash_attention(T(q), T(k), T(v), **kw), want)


def test_flash_attention_non_causal_and_one_chunk():
    rng = np.random.default_rng(7)
    q, k, v = _normal(rng, 1, 4, 9, 8), _normal(rng, 1, 2, 21, 8), _normal(rng, 1, 2, 21, 8)
    for kw in (dict(causal=False), dict(causal=False, kv_chunk=8), dict(kv_chunk=1024)):
        want = JL.flash_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
        _close(L.flash_attention(T(q), T(k), T(v), **kw), want)


def _layer_cfg(arch="granite-3-2b", **kw):
    jcfg = dataclasses.replace(j_reduced_config(arch), dtype="float32", **kw)
    return jcfg, dataclasses.replace(reduced_config(arch), dtype="float32", **kw)


def _attn_params(jcfg, seed, kv_heads=None):
    jp = JL.init_attention(jax.random.key(seed), jcfg, kv_heads)
    return jp, convert.params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("arch,window", [("qwen1.5-4b", None), ("gemma2-9b", 5),
                                         ("granite-3-2b", None), ("granite-3-2b", 3)])
def test_attn_decode_matches_jax_and_writes_in_place(arch, window):
    """GQA ratios 1 (qwen), 2 (gemma2, softcap 50) and 4 (granite); the
    cache written in place at ``pos`` and the same tensors returned."""
    jcfg, cfg = _layer_cfg(arch)
    jp, p = _attn_params(jcfg, 3)
    rng = np.random.default_rng(5)
    smax, pos = 12, 7
    x = _normal(rng, 3, 1, cfg.d_model)
    ck = _normal(rng, 3, cfg.n_kv_heads, smax, cfg.head_dim)
    cv = _normal(rng, 3, cfg.n_kv_heads, smax, cfg.head_dim)
    jo, jk, jv = JL.attn_decode(jp, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.asarray(pos), jcfg, window=window)
    tk, tv = T(ck.copy()), T(cv.copy())
    o, k2, v2 = L.attn_decode(p, T(x), tk, tv, pos, cfg, window=window)
    assert k2 is tk and v2 is tv
    _close(o, jo)
    _close(tk, jk)
    _close(tv, jv)


def test_attn_forward_with_kv_override_matches_jax():
    """Cross-attention: K / V from the memory, no RoPE and no causal mask."""
    jcfg, cfg = _layer_cfg("granite-3-2b")
    jp, p = _attn_params(jcfg, 4)
    rng = np.random.default_rng(6)
    x, mem = _normal(rng, 2, 11, cfg.d_model), _normal(rng, 2, 19, cfg.d_model)
    want = JL.attn_forward(jp, jnp.asarray(x), jcfg, kv_override=jnp.asarray(mem))
    _close(L.attn_forward(p, T(x), cfg, kv_override=T(mem)), want)
    want = JL.attn_forward(jp, jnp.asarray(x), jcfg, window=4)
    _close(L.attn_forward(p, T(x), cfg, window=4), want)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_mlp_forward_matches_jax(mlp):
    jcfg, cfg = _layer_cfg(mlp=mlp)
    jp = JL.init_mlp(jax.random.key(8), jcfg)
    p = convert.params_from_jax(jp, device="cpu")
    if mlp == "gelu":  # the biases are zero at init
        assert set(p["w_up"]) == {"w", "b"}
        jp = jax.tree.map(lambda a: a + 0.1, jp)
        p = convert.params_from_jax(jp, device="cpu")
    x = _normal(np.random.default_rng(9), 2, 5, cfg.d_model, scale=2.0)
    got, want = L.mlp_forward(p, T(x), cfg), JL.mlp_forward(jp, jnp.asarray(x), jcfg)
    if mlp != "gelu":
        _close(got, want)
        return
    # The biased GELU MLP's outputs reach 27-44 here, where a flat atol of
    # 2e-5 is a few fp32 ulps and the result hangs on each host's GEMM
    # order.  Each package is held instead to a float64 evaluation of the
    # same weights and inputs, within the fp32 accumulation bound of the
    # down-projection, gamma_K * sum|terms| (K = d_ff, gamma_K = K * 2^-24),
    # and the two packages to each other within the sum of their bounds.
    y64, bound = _gelu_mlp_fp64(jp, x)
    got, want = got.detach().numpy(), np.asarray(want)
    assert np.all(np.abs(got - y64) <= bound)
    assert np.all(np.abs(want - y64) <= bound)
    assert np.all(np.abs(got - want) <= 2 * bound)


def _gelu_mlp_fp64(jp, x):
    """The biased tanh-GELU MLP in float64 from the JAX weights, and the fp32
    accumulation bound of its down-projection: ``gamma_K * (sum_j |h_j w_ji|
    + |b_i|)`` with ``gamma_K = K * 2^-24`` for ``K = d_ff``."""
    w1, b1, w2, b2 = (np.asarray(jp[lin][key], np.float64)
                      for lin in ("w_up", "w_down") for key in ("w", "b"))
    pre = x.astype(np.float64) @ w1 + b1
    h = 0.5 * pre * (1 + np.tanh(np.sqrt(2 / np.pi) * (pre + 0.044715 * pre**3)))
    k = w2.shape[0]
    return h @ w2 + b2, k * 2.0**-24 * (np.abs(h) @ np.abs(w2) + np.abs(b2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_the_tanh_form_bit_for_bit(dtype):
    """``jax.nn.gelu``'s default (tanh) on [-6, 6]: equal bits in bf16,
    within 1e-6 in fp32; the erf form would be 4e-4 away."""
    x = np.linspace(-6, 6, 4001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x, getattr(jnp, dtype))).astype(jnp.float32))
    got = L._gelu(T(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    erf = torch.nn.functional.gelu(T(x)).numpy()
    assert np.abs(erf - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() > 1e-4


def test_layernorm_matches_jax():
    jcfg, cfg = _layer_cfg(norm="layernorm")
    x = _normal(np.random.default_rng(10), 3, 7, cfg.d_model, scale=3.0) + 1.5
    jp = {"scale": jnp.asarray(_normal(np.random.default_rng(11), cfg.d_model)),
          "bias": jnp.asarray(_normal(np.random.default_rng(12), cfg.d_model))}
    p = convert.params_from_jax(jp, device="cpu")
    _close(L.apply_norm(p, T(x), cfg), JL.apply_norm(jp, jnp.asarray(x), jcfg))
    assert set(L.init_norm(cfg, device="cpu")) == {"scale", "bias"}


# --------------------------------------------------------------------------
# The reduced dense models from the JAX model's weights
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_jax_keeps_every_leaf(arch):
    _, jparams, model, params = models(arch, "bfloat16")
    jflat, pflat = flat(jparams), flat(params)
    assert jflat.keys() == pflat.keys() and len(jflat) >= 11
    for key, leaf in jflat.items():
        assert pflat[key].dtype == torch.float32 and tuple(pflat[key].shape) == leaf.shape
        np.testing.assert_array_equal(pflat[key].numpy(), np.asarray(leaf), err_msg=key)
    assert params["blocks"]["attn"]["wq"]["w"].shape[0] == model.cfg.n_layers


@pytest.mark.parametrize("arch", DENSE)
def test_init_draws_the_reference_shapes_and_scales(arch):
    _, jparams, model, _ = models(arch, "bfloat16")
    params = model.init(torch.Generator().manual_seed(0))
    jflat, pflat = flat(jparams), flat(params)
    assert jflat.keys() == pflat.keys()
    for key, j in jflat.items():
        j, p = np.asarray(j), pflat[key].numpy()
        assert p.shape == j.shape and p.dtype == j.dtype, key
        np.testing.assert_allclose(p.std(), j.std(), rtol=0.1, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(p.mean(), j.mean(), atol=0.02 + 0.1 * j.std(), err_msg=key)
    compute = model.compute_params(params)
    assert compute["blocks"]["mlp"]["w_up"]["w"].dtype == torch.bfloat16
    assert compute["embed"] is params["embed"]
    if model.cfg.qkv_bias:  # the biases stay fp32 masters, cast on each call
        assert compute["blocks"]["attn"]["wq"]["b"] is params["blocks"]["attn"]["wq"]["b"]


@pytest.mark.parametrize("arch", DENSE)
def test_fp32_prefill_cache_and_decode_match_jax(arch):
    """Prefill of 37 tokens (past reduced Gemma2's window of 32) into a
    41-position cache, then three decode steps."""
    jmodel, jparams, model, params = models(arch, "float32")
    toks = tokens(model.cfg, 2, 37, 1)
    jl, jcache = JP.prefill(jmodel.cfg, jparams, jnp.asarray(toks), max_seq=41,
                            cache_dtype=jnp.float32)
    kernels.reset_launch_counts()
    pl, cache = P.prefill(model.cfg, params, T(toks), max_seq=41, cache_dtype=torch.float32)
    _close(pl, jl, TOL)
    for name in ("k", "v"):
        assert cache[name].dtype == torch.float32 and cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name], TOL)
        assert not cache[name][:, :, :, 37:].any()
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for t in range(3):
        jd, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(37 + t))
        pd, cache = model.decode_step(params, cache, T(nxt), 37 + t)
        _close(pd, jd, TOL)
        for name in ("k", "v"):
            _close(cache[name], jcache[name], TOL)
        nxt = np.argmax(np.asarray(jd), -1).astype(np.int32)
    assert (pd[:, model.cfg.vocab_size:] == -1e30).all()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # no kernel here


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_forward(arch):
    """As ``tests/test_models.py::test_prefill_decode_matches_forward``:
    the forward pass and prefill + one decode step give the same logits for
    the last token; the forward pass is also the JAX model's."""
    jmodel, jparams, model, params = models(arch, "float32", seed=1)
    cfg = model.cfg
    toks = tokens(cfg, 2, 18, 3)
    s = 17
    hidden = backbone.forward_hidden(cfg, params, T(toks))
    want = backbone.logits_for_position(cfg, params, hidden[:, -1])
    jh = JB.forward_hidden(jmodel.cfg, jparams, jnp.asarray(toks), remat=False)
    _close(hidden, jh, TOL)
    _, cache = P.prefill(cfg, params, T(toks[:, :s]), max_seq=s + 4, cache_dtype=torch.float32)
    got, _ = model.decode_step(params, cache, T(toks[:, s]), s)
    torch.testing.assert_close(got, want, **TOL)


class _CacheWrites(torch.overrides.TorchFunctionMode):
    """Records the fp32 value of every write into a bf16 tensor (the new
    token's K / V before the cache's rounding), in the order of the writes."""

    def __init__(self):
        super().__init__()
        self.values = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__setitem__ and args[0].dtype == torch.bfloat16:
            self.values.append(args[2].detach().float().clone())
        return func(*args, **(kwargs or {}))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 (8 significant bits) at the magnitude ``|x|``."""
    return 2.0 ** (np.floor(np.log2(np.abs(x))) - 7)


def _assert_bf16_leaf_rule(got, want, unrounded, tol=TOL):
    """``got`` / ``want`` (bf16 leaves as fp32) agree within ``tol``, except
    where they are one bf16 ulp apart and ``unrounded`` (``got``'s fp32 value
    before its rounding) lies within ``tol`` of the rounding midpoint between
    them: there the two fp32 values straddle the midpoint, and the leaves can
    agree no closer than one ulp of their own dtype."""
    close = np.abs(got - want) <= tol["atol"] + tol["rtol"] * np.abs(want)
    low = np.minimum(np.abs(got), np.abs(want))
    mid = (got + want) / 2
    one_ulp = (np.sign(got) == np.sign(want)) & (low > 0) & (
        np.abs(got - want) == _bf16_ulp(np.where(low > 0, low, 1.0)))
    straddle = one_ulp & (np.abs(unrounded - mid) <= tol["atol"] + tol["rtol"] * np.abs(mid))
    bad = ~(close | straddle)
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], want[bad][:5], unrounded[bad][:5])


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-9b"])
def test_init_cache_is_the_references_and_decodes_like_it(arch):
    """``init_cache``'s keys, shapes, dtypes and zeros; three decode steps
    from it (no prefill) give the JAX model's logits and cache.

    With an fp32 cache on both sides the K / V agree within ``TOL``.  With
    the default bf16 cache they agree within ``TOL`` too, except where a
    leaf is one bf16 ulp from the reference's and the port's fp32 value
    before rounding lies within ``TOL`` of the midpoint between the two
    (:func:`_assert_bf16_leaf_rule`): fp32 sums in another order round
    such values to the other neighbour (1 to 15 of 12,288 elements of the
    reduced gemma2 over the three steps, by machine and seed)."""
    jmodel, jparams, model, params = models(arch, "float32")
    toks = tokens(model.cfg, 3, 3, 4)
    jcache = jmodel.init_cache(3, 16, dtype=jnp.float32)
    cache = model.init_cache(3, 16, dtype=torch.float32, device="cpu")
    for pos in range(3):
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, pos]),
                                        jnp.asarray(pos))
        pl, cache = model.decode_step(params, cache, T(toks[:, pos]), pos)
        _close(pl, jl, TOL)
        for name in ("k", "v"):
            assert cache[name].dtype == torch.float32
            _close(cache[name], jcache[name], TOL)

    jcache = jmodel.init_cache(3, 16)
    cache = model.init_cache(3, 16, device="cpu")
    assert sorted(cache) == sorted(jcache) == ["k", "v"]
    for name, leaf in jcache.items():
        assert tuple(cache[name].shape) == leaf.shape and cache[name].dtype == torch.bfloat16
        assert not cache[name].any()
    for pos in range(3):
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, pos]),
                                        jnp.asarray(pos))
        with _CacheWrites() as writes:
            pl, cache = model.decode_step(params, cache, T(toks[:, pos]), pos)
        assert len(writes.values) == 2 * model.cfg.n_layers  # each layer's K, then its V
        _close(pl, jl, TOL)
        for j, name in enumerate(("k", "v")):
            assert not cache[name][:, :, :, pos + 1:].any()
            got = cache[name][:, :, :, pos].float().numpy()
            want = np.asarray(jcache[name][:, :, :, pos].astype(jnp.float32))
            unrounded = torch.stack(writes.values[j::2]).numpy()
            np.testing.assert_array_equal(
                torch.from_numpy(unrounded).bfloat16().float().numpy(), got)
            _assert_bf16_leaf_rule(got, want, unrounded)


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-9b"])
def test_decode_step_writes_the_cache_in_place(arch):
    """The step returns the cache it was given, its storage unchanged, and
    its contents are the reference's new cache (the reference's server
    donates the buffer; the port writes into it)."""
    jmodel, jparams, model, params = models(arch, "float32", seed=2)
    toks = tokens(model.cfg, 2, 10, 5)
    jl, jcache = JP.prefill(jmodel.cfg, jparams, jnp.asarray(toks), max_seq=14,
                            cache_dtype=jnp.float32)
    _, cache = P.prefill(model.cfg, params, T(toks), max_seq=14, cache_dtype=torch.float32)
    ptrs = {name: t.data_ptr() for name, t in cache.items()}
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    _, jnew = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(10))
    _, new = model.decode_step(params, cache, T(nxt), 10)
    assert new is cache and {n: t.data_ptr() for n, t in new.items()} == ptrs
    for name in ("k", "v"):
        _close(cache[name], jnew[name], TOL)
        assert cache[name][:, :, :, 10].any() and not cache[name][:, :, :, 11:].any()


@pytest.mark.parametrize("arch", DENSE)
def test_fp32_server_gives_the_jax_servers_tokens(arch):
    """Both servers prefill into a bf16 cache (the reference's ``Server``
    passes no ``cache_dtype``) and decode from it upcast to fp32."""
    *_, jreqs, reqs = servers(arch, "float32", 0)
    for got, want in zip(reqs, jreqs):
        assert got.generated == want.generated


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-9b"])
def test_bf16_server_gives_the_jax_servers_tokens(arch):
    """:func:`_lm_parity.assert_bf16_server_rule`: fed the reference's
    tokens, the port's bf16 logits lie within the reference's own
    bf16-vs-fp32 distance, and greedy tokens part only at near ties."""
    assert_bf16_server_rule(arch)


# --------------------------------------------------------------------------
# Windows
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", [("gemma2-9b", dict(local_window=4)),
                                     ("granite-3-2b", dict(sliding_window=8))])
def test_windowed_models_match_jax(arch, kw):
    """Gemma2's local layers at a window of 4 and granite with a sliding
    window of 8, at prompts of 16 and 23 tokens (past the window): the
    forward pass, prefill and three decode steps, fp32."""
    jmodel, jparams, model, params = models(arch, "float32", seed=3, **kw)
    assert backbone._layer_windows(model.cfg) == (
        [4, None, 4, None] if arch == "gemma2-9b" else [8] * 4)
    for s in (16, 23):
        toks = tokens(model.cfg, 2, s, s)
        jh = JB.forward_hidden(jmodel.cfg, jparams, jnp.asarray(toks), remat=False)
        _close(backbone.forward_hidden(model.cfg, params, T(toks)), jh, TOL)
        jl, jcache = JP.prefill(jmodel.cfg, jparams, jnp.asarray(toks), max_seq=s + 3,
                                cache_dtype=jnp.float32)
        pl, cache = P.prefill(model.cfg, params, T(toks), max_seq=s + 3,
                              cache_dtype=torch.float32)
        _close(pl, jl, TOL)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
        for t in range(3):
            jd, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt),
                                            jnp.asarray(s + t))
            pd, cache = model.decode_step(params, cache, T(nxt), s + t)
            _close(pd, jd, TOL)
            nxt = np.argmax(np.asarray(jd), -1).astype(np.int32)


def test_gemma2_local_global_masking_differs():
    """``tests/test_models.py``'s test on the port: perturbing a token past
    the local window changes the last token's output through the global
    layer, and not through a stack of local layers alone."""
    cfg = dataclasses.replace(reduced_config("gemma2-9b"), n_layers=2, dtype="float32",
                              local_window=4)
    params = Model(cfg).init(torch.Generator().manual_seed(3))
    toks = T(tokens(cfg, 1, 16, 0)).long()
    toks2 = toks.clone()
    toks2[0, 0] = (toks[0, 0] + 1) % cfg.vocab_size
    h = backbone.forward_hidden(cfg, params, toks)
    h2 = backbone.forward_hidden(cfg, params, toks2)
    assert float((h[0, -1] - h2[0, -1]).abs().max()) > 0
    local = dataclasses.replace(cfg, n_layers=1)  # layer 0 alone: local
    one = dict(params, blocks=jax.tree.map(lambda a: a[:1], params["blocks"]))
    assert float((backbone.forward_hidden(local, one, toks)[0, -1]
                  - backbone.forward_hidden(local, one, toks2)[0, -1]).abs().max()) == 0


def test_moe_block_is_drawn_with_moe_not_mlp():
    """A ``moe`` config's dense block carries the MoE layer in place of the
    MLP (``tests/test_torch_moe.py`` holds it to the JAX package)."""
    cfg = reduced_config("mixtral-8x7b")
    p = backbone.init_dense_block(torch.Generator(), cfg, lead=(2,))
    assert "moe" in p and "mlp" not in p
    assert sorted(p["moe"]) == ["router", "w_down", "w_gate", "w_up"]
    assert p["moe"]["w_gate"].shape == (2, cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert Model(cfg).cfg is cfg
