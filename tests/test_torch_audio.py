"""The port's ``audio`` LM family (Whisper: an encoder over precomputed
frame embeddings with learned positions, then decoder layers of causal
self-attention, cross-attention over the encoder's output and the biased
GELU MLP, with learned decoder positions and a read-only cross K / V cache)
against the JAX package's, on the CPU, on the same numpy-seeded inputs.

The frames are seeded N(0, 1) ``extras`` (the reference's audio front end
is a stub too); the servers give zeros, which the encoder's learned
positions still make into a non-trivial memory.

* **Leaves and init**: every leaf carried across by ``params_from_jax``
  (``enc_blocks``, ``enc_pos``, ``dec_pos``, ``enc_final_norm``), the init's
  shapes and scales, and ``compute_params`` casting every linear weight
  while the learned positions stay the fp32 master's.
* **fp32** at atol 2e-4, rtol 1e-3 (as ``tests/test_torch_dense.py``):
  ``forward_hidden`` (also over 1,100 frames, ragged against the
  1,024-key chunk, in the encoder and the cross-attention), prefill logits
  and every cache array (``k``, ``v``, ``xk``, ``xv``), then three
  teacher-forced decode steps; prefill plus one decode against the forward
  pass.
* The servers (fp32 tokens equal, the bf16 rule, ``serve.main``) are in
  ``tests/test_torch_audio_serve.py``.
* **Positions**: a decode step at ``pos >= max_learned_pos``, or a prompt
  longer than ``max_learned_pos``, raises ``IndexError`` (the reference's
  ``take`` clamps, or its slice comes up short).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import backbone as JB
from repro.models import prefill as JP

from _lm_parity import flat, models, tokens
from repro_torch import kernels
from repro_torch.models import backbone
from repro_torch.models import prefill as P

T = torch.from_numpy
TOL = dict(atol=2e-4, rtol=1e-3)
ARCH = "whisper-large-v3"
# the JAX package's functions, jitted: compiled once a config and shape
J_FORWARD = jax.jit(JB.forward_hidden, static_argnums=0, static_argnames=("remat",))
J_PREFILL = jax.jit(JP.prefill, static_argnums=0, static_argnames=("max_seq", "cache_dtype"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)), **tol)


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def test_params_from_jax_keeps_every_leaf():
    _, jparams, model, params = models(ARCH, "bfloat16")
    jflat, pflat = flat(jparams), flat(params)
    assert jflat.keys() == pflat.keys()
    assert {"['enc_pos']", "['dec_pos']", "['enc_final_norm']['bias']",
            "['enc_blocks']['attn']['wq']['w']", "['blocks']['cross']['wv']['w']",
            "['blocks']['ln_x']['scale']", "['blocks']['mlp']['w_up']['b']"} <= jflat.keys()
    for key, leaf in jflat.items():
        assert pflat[key].dtype == torch.float32 and tuple(pflat[key].shape) == leaf.shape
        np.testing.assert_array_equal(pflat[key].numpy(), np.asarray(leaf), err_msg=key)
    cfg = model.cfg
    assert params["enc_blocks"]["mlp"]["w_up"]["w"].shape == (
        cfg.encoder_layers, cfg.d_model, cfg.d_ff)
    assert params["dec_pos"].shape == (cfg.max_learned_pos, cfg.d_model)


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


def test_compute_params_casts_the_weights_and_keeps_the_positions():
    model = models(ARCH, "bfloat16")[2]
    params = model.init(torch.Generator().manual_seed(1))
    compute = model.compute_params(params)
    for key, leaf in flat(compute).items():
        if key.endswith("['w']"):
            assert leaf.dtype == torch.bfloat16, key
        else:
            assert leaf is flat(params)[key], key
    assert compute["enc_pos"].dtype == compute["dec_pos"].dtype == torch.float32


@pytest.mark.parametrize("encoder_seq", [64, 1100])
def test_forward_hidden_fp32_matches_jax(encoder_seq):
    jmodel, jparams, model, params = models(ARCH, "float32", 2, encoder_seq=encoder_seq)
    cfg = model.cfg
    toks, ex = tokens(cfg, 2, 19, 3), _frames(cfg, 2, 4)
    want = J_FORWARD(jmodel.cfg, jparams, jnp.asarray(toks), extras=jnp.asarray(ex),
                     remat=False)
    _close(backbone.forward_hidden(cfg, params, T(toks), extras=T(ex)), want)


def test_fp32_prefill_cache_and_decode_match_jax():
    """Prefill of 37 tokens into a 41-position fp32 cache, then three decode
    steps fed the reference's greedy tokens: logits and every cache array at
    each step; ``k`` / ``v`` written in place, ``xk`` / ``xv`` untouched."""
    jmodel, jparams, model, params = models(ARCH, "float32", 5)
    cfg = model.cfg
    toks, ex = tokens(cfg, 2, 37, 6), _frames(cfg, 2, 7)
    jl, jcache = J_PREFILL(jmodel.cfg, jparams, jnp.asarray(toks), extras=jnp.asarray(ex),
                           max_seq=41, cache_dtype=jnp.float32)
    kernels.reset_launch_counts()
    pl, cache = P.prefill(cfg, params, T(toks), extras=T(ex), max_seq=41,
                          cache_dtype=torch.float32)
    _close(pl, jl)
    assert cache["xk"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, cfg.encoder_seq,
                                 cfg.head_dim)
    for name in ("k", "v", "xk", "xv"):
        assert cache[name].dtype == torch.float32 and cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name])
    assert not cache["k"][:, :, :, 37:].any()
    ptr, xv = cache["v"].data_ptr(), cache["xv"].clone()
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    step = jax.jit(jmodel.decode_step)
    for t in range(3):
        jd, jcache = step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(37 + t))
        pd, cache = model.decode_step(params, cache, T(nxt), 37 + t)
        _close(pd, jd)
        for name in ("k", "v", "xk", "xv"):
            _close(cache[name], jcache[name])
        nxt = np.argmax(np.asarray(jd), -1).astype(np.int32)
    assert cache["v"].data_ptr() == ptr and torch.equal(cache["xv"], xv)
    assert (pd[:, cfg.vocab_size:] == -1e30).all()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # no kernel here


def test_prefill_then_decode_matches_forward():
    _, _, model, params = models(ARCH, "float32", 8)
    cfg = model.cfg
    toks, ex = T(tokens(cfg, 2, 18, 9)), T(_frames(cfg, 2, 10))
    hidden = backbone.forward_hidden(cfg, params, toks, extras=ex)
    want = backbone.logits_for_position(cfg, params, hidden[:, -1])
    _, cache = P.prefill(cfg, params, toks[:, :17], extras=ex, max_seq=21,
                         cache_dtype=torch.float32)
    got, _ = model.decode_step(params, cache, toks[:, 17], 17)
    torch.testing.assert_close(got, want, **TOL)


def test_frames_move_the_logits():
    _, _, model, params = models(ARCH, "float32", 11)
    cfg = model.cfg
    toks = T(tokens(cfg, 2, 12, 12))
    a = model.prefill(params, toks, extras=T(_frames(cfg, 2, 13)))[0]
    b = model.prefill(params, toks, extras=T(_frames(cfg, 2, 14)))[0]
    assert (a - b)[:, :cfg.vocab_size].abs().max() > 1e-3
    with pytest.raises(ValueError, match="extras"):
        model.prefill(params, toks)


def test_positions_past_the_learned_ones_raise():
    """``max_learned_pos`` 40: a 40-token prompt and decode steps at 40 and
    past it fill a 48-position cache only up to 40; a 41-token prompt and a
    step at 40 raise ``IndexError``."""
    _, _, model, params = models(ARCH, "float32", 20, max_learned_pos=40)
    cfg = model.cfg
    toks, ex = T(tokens(cfg, 1, 41, 21)), T(_frames(cfg, 1, 22))
    _, cache = model.prefill(params, toks[:, :39], extras=ex, max_seq=48)
    logits, cache = model.decode_step(params, cache, toks[:, 39], 39)  # the last position
    assert torch.isfinite(logits).all()
    for pos in (40, 47):
        with pytest.raises(IndexError, match="learned positions"):
            model.decode_step(params, cache, toks[:, 40], pos)
    assert not cache["k"][:, :, :, 40:].any()  # nothing written past the positions
    with pytest.raises(IndexError, match="learned positions"):
        model.prefill(params, toks, extras=ex, max_seq=48)
    with pytest.raises(IndexError, match="learned positions"):
        backbone.forward_hidden(cfg, params, toks, extras=ex)
