"""The port's ``vlm`` LM family (Llama-3.2-Vision: units of
``cross_attn_period - 1`` dense layers then a block of tanh-gated
cross-attention over precomputed patch embeddings and an ungated MLP, with
its read-only cross K / V cache) against the JAX package's, on the CPU, on
the same numpy-seeded inputs.

At init every ``gate`` is zero, and the servers' ``extras`` are zeros, so
that K = V = 0: either alone makes the cross block add exactly nothing.
The parity tests therefore set each gate to 0.7 on both trees and feed
seeded N(0, 1) ``extras``.  The reduced config has one unit (``n_layers`` 5,
period 5); the two-unit case (``n_layers`` 10) holds the mapping of a dense
layer ``(u, j)`` to cache row ``u * (period - 1) + j`` and of cross block
``u`` to ``xk[u]``.

* **Leaves and init**: every leaf carried across by ``params_from_jax``
  (``cross_blocks`` among them), the init's shapes and scales, and
  ``compute_params`` casting every linear weight while the gates stay the
  fp32 master's.
* **fp32** at atol 2e-4, rtol 1e-3 (as ``tests/test_torch_dense.py``):
  ``forward_hidden`` (also over 1,030 patches, ragged against the 1,024-key
  chunk), prefill logits and every cache array (``k``, ``v``, ``xk``,
  ``xv``), then three teacher-forced decode steps, at one and two units;
  prefill plus one decode against the forward pass.
* The servers (fp32 tokens equal, the bf16 rule, ``serve.main``) are in
  ``tests/test_torch_vlm_serve.py``.
* **Semantics**: ``extras`` move the logits when the gate is open; under the
  servers' zero ``extras`` the cross block's attention is exactly 0, in both
  packages; a call without ``extras`` raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import backbone as JB
from repro.models import prefill as JP

from _lm_parity import flat, models, tokens
from repro_torch import kernels
from repro_torch.configs import reduced_config
from repro_torch.models import Model, backbone
from repro_torch.models import layers as L
from repro_torch.models import prefill as P

T = torch.from_numpy
TOL = dict(atol=2e-4, rtol=1e-3)
ARCH = "llama-3.2-vision-11b"
GATE = 0.7
# the JAX package's functions, jitted: compiled once a config and shape
J_FORWARD = jax.jit(JB.forward_hidden, static_argnums=0, static_argnames=("remat",))
J_PREFILL = jax.jit(JP.prefill, static_argnums=0, static_argnames=("max_seq", "cache_dtype"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)), **tol)


def _gated(seed=0, gate=GATE, dtype="float32", **kw):
    """Both packages' models on the same weights with every gate at
    ``gate``."""
    jmodel, jparams, model, params = models(ARCH, dtype, seed, **kw)
    jparams["cross_blocks"]["gate"] = jnp.full_like(jparams["cross_blocks"]["gate"], gate)
    params["cross_blocks"]["gate"].fill_(gate)
    return jmodel, jparams, model, params


def _extras(cfg, b, seed):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def test_params_from_jax_keeps_every_leaf():
    _, jparams, model, params = models(ARCH, "bfloat16", n_layers=10)
    jflat, pflat = flat(jparams), flat(params)
    assert jflat.keys() == pflat.keys()
    assert {"['cross_blocks']['gate']", "['cross_blocks']['cross']['wk']['w']",
            "['cross_blocks']['mlp']['w_down']['w']"} <= jflat.keys()
    for key, leaf in jflat.items():
        assert pflat[key].dtype == torch.float32 and tuple(pflat[key].shape) == leaf.shape
        np.testing.assert_array_equal(pflat[key].numpy(), np.asarray(leaf), err_msg=key)
    cfg = model.cfg
    assert params["blocks"]["attn"]["wq"]["w"].shape[0] == 8  # 10 - 10 // 5 dense layers
    assert params["cross_blocks"]["gate"].shape == (2, 1)
    assert cfg.n_layers // cfg.cross_attn_period == 2


def test_init_draws_the_reference_shapes_and_scales():
    _, jparams, model, _ = models(ARCH, "bfloat16")
    params = model.init(torch.Generator().manual_seed(0))
    jflat, pflat = flat(jparams), flat(params)
    assert jflat.keys() == pflat.keys()
    for key, j in jflat.items():
        j, p = np.asarray(j), pflat[key].numpy()
        assert p.shape == j.shape and p.dtype == j.dtype, key
        np.testing.assert_allclose(p.std(), j.std(), rtol=0.1, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(p.mean(), j.mean(), atol=0.02 + 0.1 * j.std(), err_msg=key)
    assert not params["cross_blocks"]["gate"].any()  # zero at init, as the reference's


def test_compute_params_casts_the_weights_and_keeps_the_gates():
    model = models(ARCH, "bfloat16")[2]
    params = model.init(torch.Generator().manual_seed(1))
    compute = model.compute_params(params)
    for key, leaf in flat(compute).items():
        if key.endswith("['w']"):
            assert leaf.dtype == torch.bfloat16, key
        else:
            assert leaf is flat(params)[key], key
    assert compute["cross_blocks"]["gate"].dtype == torch.float32


@pytest.mark.parametrize("vision_tokens", [48, 1030])
def test_forward_hidden_fp32_matches_jax(vision_tokens):
    """Gates at 0.7, seeded patch embeddings; 1,030 patches take a padded
    second chunk of 1,024 keys in the cross-attention."""
    jmodel, jparams, model, params = _gated(seed=2, vision_tokens=vision_tokens)
    cfg = model.cfg
    toks, ex = tokens(cfg, 2, 19, 3), _extras(cfg, 2, 4)
    want = J_FORWARD(jmodel.cfg, jparams, jnp.asarray(toks), extras=jnp.asarray(ex),
                     remat=False)
    _close(backbone.forward_hidden(cfg, params, T(toks), extras=T(ex)), want)


@pytest.mark.parametrize("n_layers", [5, 10], ids=["one-unit", "two-units"])
def test_fp32_prefill_cache_and_decode_match_jax(n_layers):
    """Prefill of 37 tokens into a 41-position fp32 cache, then three decode
    steps fed the reference's greedy tokens: logits and every cache array
    (``k`` / ``v`` rows ``u * 4 + j``, ``xk`` / ``xv`` one row a cross block)
    at each step; ``k`` / ``v`` written in place, ``xk`` / ``xv`` untouched."""
    jmodel, jparams, model, params = _gated(seed=5, n_layers=n_layers)
    cfg = model.cfg
    toks, ex = tokens(cfg, 2, 37, 6), _extras(cfg, 2, 7)
    jl, jcache = J_PREFILL(jmodel.cfg, jparams, jnp.asarray(toks), extras=jnp.asarray(ex),
                           max_seq=41, cache_dtype=jnp.float32)
    kernels.reset_launch_counts()
    pl, cache = P.prefill(cfg, params, T(toks), extras=T(ex), max_seq=41,
                          cache_dtype=torch.float32)
    _close(pl, jl)
    n_cross = n_layers // 5
    assert cache["k"].shape == (n_layers - n_cross, 2, cfg.n_kv_heads, 41, cfg.head_dim)
    assert cache["xk"].shape == (n_cross, 2, cfg.n_kv_heads, cfg.vision_tokens, cfg.head_dim)
    for name in ("k", "v", "xk", "xv"):
        assert cache[name].dtype == torch.float32 and cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name])
    assert not cache["k"][:, :, :, 37:].any()
    ptr, xk = cache["k"].data_ptr(), cache["xk"].clone()
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    step = jax.jit(jmodel.decode_step)
    for t in range(3):
        jd, jcache = step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(37 + t))
        pd, cache = model.decode_step(params, cache, T(nxt), 37 + t)
        _close(pd, jd)
        for name in ("k", "v", "xk", "xv"):
            _close(cache[name], jcache[name])
        nxt = np.argmax(np.asarray(jd), -1).astype(np.int32)
    assert cache["k"].data_ptr() == ptr and torch.equal(cache["xk"], xk)
    assert (pd[:, cfg.vocab_size:] == -1e30).all()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # no kernel here


def test_prefill_then_decode_matches_forward():
    """As ``tests/test_models.py::test_prefill_decode_matches_forward``, two
    units, gates open: the last logits of the forward pass over 18 tokens
    equal prefill of 17 plus one decode step (an fp32 cache)."""
    _, _, model, params = _gated(seed=8, n_layers=10)
    cfg = model.cfg
    toks, ex = T(tokens(cfg, 2, 18, 9)), T(_extras(cfg, 2, 10))
    hidden = backbone.forward_hidden(cfg, params, toks, extras=ex)
    want = backbone.logits_for_position(cfg, params, hidden[:, -1])
    _, cache = P.prefill(cfg, params, toks[:, :17], extras=ex, max_seq=21,
                         cache_dtype=torch.float32)
    got, _ = model.decode_step(params, cache, toks[:, 17], 17)
    torch.testing.assert_close(got, want, **TOL)


def test_extras_move_the_logits_when_the_gate_is_open():
    _, _, model, params = _gated(seed=11)
    cfg = model.cfg
    toks = T(tokens(cfg, 2, 12, 12))
    a = model.prefill(params, toks, extras=T(_extras(cfg, 2, 13)))[0]
    b = model.prefill(params, toks, extras=T(_extras(cfg, 2, 14)))[0]
    assert (a - b)[:, :cfg.vocab_size].abs().max() > 1e-3
    params["cross_blocks"]["gate"].zero_()  # a shut gate: the patches do not matter
    a = model.prefill(params, toks, extras=T(_extras(cfg, 2, 13)))[0]
    b = model.prefill(params, toks, extras=T(_extras(cfg, 2, 14)))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_zero_extras_add_exactly_nothing():
    """The servers' zero ``extras``: K = V = 0 (no bias), so the cross
    block's attention output is exactly 0 in both packages whatever the
    gate, and the logits equal those with the gates shut, bit for bit."""
    jmodel, jparams, model, params = _gated(seed=15)
    cfg = model.cfg
    zeros = np.zeros((2, cfg.vision_tokens, cfg.d_model), np.float32)
    x = np.random.default_rng(16).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    c = backbone.layer_params(params["cross_blocks"], 0)
    got = L.attn_forward(c["cross"], T(x), cfg, kv_override=T(zeros))
    assert not got.any()
    jc = jax.tree.map(lambda a: a[0], jparams["cross_blocks"])
    from repro.models import layers as JL

    assert not np.asarray(JL.attn_forward(jc["cross"], jnp.asarray(x), jmodel.cfg,
                                          kv_override=jnp.asarray(zeros))).any()
    toks = T(tokens(cfg, 2, 12, 17))
    open_ = model.prefill(params, toks, extras=T(zeros))[0]
    params["cross_blocks"]["gate"].zero_()
    torch.testing.assert_close(open_, model.prefill(params, toks, extras=T(zeros))[0],
                               rtol=0, atol=0)


def test_a_call_without_extras_raises():
    _, _, model, params = _gated(seed=18)
    toks = T(tokens(model.cfg, 1, 4, 19))
    with pytest.raises(ValueError, match="extras"):
        model.prefill(params, toks)
    with pytest.raises(ValueError, match="extras"):
        backbone.forward_hidden(model.cfg, params, toks)
    with pytest.raises(ValueError, match="units"):
        Model(dataclasses.replace(reduced_config(ARCH), n_layers=7))
