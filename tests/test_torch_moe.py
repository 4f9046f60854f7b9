"""The port's ``moe`` LM family (the top-k MoE layer with its sort-based
capacity dispatch, and OLMoE / Mixtral: the dense block with that layer in
place of its MLP) against the JAX package's, on the CPU, on the same
numpy-seeded inputs.

* **``moe_forward``** in fp32 at atol 2e-5 (fp32 sums in another order) on
  reduced olmoe (E = 8, k = 2), reduced mixtral (E = 4, k = 2) and reduced
  olmoe at E = 32, k = 4 (the only way to reach the reference's
  expert-major branch, E > 16), at S = 1, 16 and 64 and capacity factors
  1.25 and 1.0.  The dispatch's integers (each token's experts, which pairs
  keep a slot, which token each slot holds) equal ``jax.lax.top_k``'s
  choice and a numpy transcription of the reference's ``dispatch_row``;
  pairs drop wherever the capacity is short of the pairs.
* **Ties**: with the router at zero every probability ties; experts
  ``0..k-1`` are chosen, as ``jax.lax.top_k`` chooses them, and the tokens
  past the capacity drop, in the reference's order.
* **bf16**: equal bits to the reference at E = 8 and 4.  At E = 32, k = 4 a
  few outputs round apart (the two packages' ``exp`` differ in the last fp32
  bit, so a renormalised weight or a product can round to bf16 one place
  apart); there at most 1 in 1,000 outputs may differ, each by at most
  ``2**-8`` of the largest output (half a bf16 step at that size).
* **The reduced ``olmoe-1b-7b`` and ``mixtral-8x7b``** from the JAX model's
  weights (``convert.params_from_jax``): every leaf carried across, the
  init's shapes and scales, fp32 prefill logits and cache then three decode
  steps at atol 2e-4, rtol 1e-3 (as ``tests/test_torch_dense.py``),
  ``forward_hidden`` against prefill plus one decode, fp32 server tokens
  equal to the JAX server's, bf16 server tokens held by
  :func:`_lm_parity.assert_bf16_server_rule`, Mixtral's sliding window at
  prompts past it, and ``compute_params`` leaving no fp32 expert tensor.
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
from repro_torch.launch import serve
from repro_torch.models import backbone, convert
from repro_torch.models import layers as L
from repro_torch.models import prefill as P

T = torch.from_numpy
LAYER_TOL = dict(atol=2e-5, rtol=0)
TOL = dict(atol=2e-4, rtol=1e-3)
MOE = ("olmoe-1b-7b", "mixtral-8x7b")
# (arch, overrides): E = 8 and 4 take the reference's loop over experts, E = 32 its
# expert-major einsum
LAYER_CFGS = [("olmoe-1b-7b", {}), ("mixtral-8x7b", {}),
              ("olmoe-1b-7b", dict(n_experts=32, top_k_experts=4))]
LAYER_IDS = ["olmoe-E8", "mixtral-E4", "olmoe-E32"]
# the JAX package's functions, jitted: compiled once a config and shape, where
# running them eagerly compiles every op anew at each shape
J_INIT_MOE = jax.jit(JL.init_moe, static_argnums=1)
J_MOE_FORWARD = jax.jit(JL.moe_forward, static_argnums=2)


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)), **tol)


def _layer(arch, kw, dtype="float32", seed=0, capacity_factor=1.25):
    """Both packages' configs and one MoE layer's weights, the JAX draw and
    the same values in the port."""
    kw = dict(kw, dtype=dtype, capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(j_reduced_config(arch), **kw)
    cfg = dataclasses.replace(reduced_config(arch), **kw)
    jp = J_INIT_MOE(jax.random.key(seed), jcfg)
    return jcfg, cfg, jp, convert.params_from_jax(jp, device="cpu")


def _x(cfg, s, seed, b=3):
    return np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _reference_dispatch(top_e, n_experts, cap):
    """The reference's ``dispatch_row`` (``repro.models.layers.moe_forward``)
    in numpy, one row at a time: a stable argsort of the row's pairs by
    expert, the bincount's exclusive cumsum, ``keep = pos_in_e < cap``.
    Returns ``keep (B, S, k)`` and the token in each slot, ``-1`` where
    none, ``(B, E, C)``."""
    b, s, k = top_e.shape
    keep = np.zeros((b, s * k), bool)
    slots = np.full((b, n_experts, cap), -1)
    for r in range(b):
        e_flat = top_e[r].reshape(-1)
        order = np.argsort(e_flat, kind="stable")
        e_sorted = e_flat[order]
        counts = np.bincount(e_flat, minlength=n_experts)
        pos = np.arange(s * k) - (np.cumsum(counts) - counts)[e_sorted]
        kept = pos < cap
        keep[r, order] = kept
        slots[r, e_sorted[kept], pos[kept]] = order[kept] // k
    return keep.reshape(b, s, k), slots


def _dispatch(p, x, cfg):
    top_p, top_e = L.moe_route(p, x, cfg)
    cap = L.moe_capacity(cfg, x.shape[1])
    token, filled, slot = L.moe_dispatch(top_e, cfg.n_experts, cap)
    return top_p, top_e, cap, torch.where(filled, token, -1), slot < cap


# --------------------------------------------------------------------------
# The MoE layer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [1.25, 1.0])
@pytest.mark.parametrize("s", [1, 16, 64])
@pytest.mark.parametrize("arch,kw", LAYER_CFGS, ids=LAYER_IDS)
def test_moe_forward_fp32_and_its_dispatch_match_jax(arch, kw, s, capacity_factor):
    jcfg, cfg, jp, p = _layer(arch, kw, seed=s, capacity_factor=capacity_factor)
    x = _x(cfg, s, seed=s + 1)
    _close(L.moe_forward(p, T(x), cfg), J_MOE_FORWARD(jp, jnp.asarray(x), jcfg))

    probs = jax.nn.softmax(JL.linear(jp["router"], jnp.asarray(x), jnp.float32), axis=-1)
    _, j_top_e = jax.lax.top_k(probs, cfg.top_k_experts)
    top_p, top_e, cap, slots, keep = _dispatch(p, T(x), cfg)
    assert cap == -(-cfg.top_k_experts * s * capacity_factor // cfg.n_experts)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(j_top_e))
    torch.testing.assert_close(top_p.sum(-1), torch.ones(top_p.shape[:2]))
    want_keep, want_slots = _reference_dispatch(top_e.numpy(), cfg.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    if s == 1:  # a decode step: k distinct experts, one slot each, nothing drops
        assert cap == 1 and keep.all()
    elif capacity_factor == 1.0:
        assert not keep.all()  # the drop rule is exercised


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("arch,kw", LAYER_CFGS, ids=LAYER_IDS)
def test_moe_ties_go_to_the_lower_experts_and_drop_in_token_order(arch, kw, s):
    """The router at zero: every probability is 1 / E.  ``jax.lax.top_k``
    and the port choose experts ``0..k-1`` for every token; each of those
    experts receives all S tokens and keeps the first C in token order, so
    a token past C drops from every expert and its output is zero."""
    jcfg, cfg, jp, p = _layer(arch, kw, seed=7, capacity_factor=1.0)
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    p["router"]["w"].zero_()
    x = _x(cfg, s, seed=8)
    k = cfg.top_k_experts
    probs = jax.nn.softmax(JL.linear(jp["router"], jnp.asarray(x), jnp.float32), axis=-1)
    assert (np.asarray(jax.lax.top_k(probs, k)[1]) == np.arange(k)).all()
    top_p, top_e, cap, slots, keep = _dispatch(p, T(x), cfg)
    assert cap < s
    assert (top_e.numpy() == np.arange(k)).all() and (top_p == 1 / k).all()
    assert (keep.numpy() == (np.arange(s) < cap)[None, :, None]).all()
    assert (slots[:, :k].numpy() == np.arange(cap)).all() and (slots[:, k:] == -1).all()
    want = J_MOE_FORWARD(jp, jnp.asarray(x), jcfg)
    got = L.moe_forward(p, T(x), cfg)
    _close(got, want)
    assert not np.asarray(want)[:, cap:].any() and not got[:, cap:].any()
    assert np.abs(np.asarray(want)[:, :cap]).max(-1).min() > 0


@pytest.mark.parametrize("s", [16, 64])
@pytest.mark.parametrize("arch,kw", LAYER_CFGS, ids=LAYER_IDS)
def test_moe_forward_bf16_is_the_references_bits(arch, kw, s):
    """bf16 in, bf16 out, the ordered combine rounding at each add as the
    reference's does.  Equal bits at E = 8 and 4; at E = 32, k = 4, the
    tolerance of the module docstring."""
    jcfg, cfg, jp, p = _layer(arch, kw, "bfloat16", seed=s + 100, capacity_factor=1.0)
    x = _x(cfg, s, seed=s + 3)
    want = np.asarray(J_MOE_FORWARD(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
                      .astype(jnp.float32))
    got = L.moe_forward(p, T(x).bfloat16(), cfg)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if cfg.n_experts <= 16:
        np.testing.assert_array_equal(got, want)
    else:
        apart = got != want
        assert apart.mean() <= 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-8 * np.abs(want).max())


def test_moe_forward_is_batched_over_rows():
    """A batch of rows gives each row's own answer: capacity and dispatch
    are per row, not over the batch."""
    _, cfg, _, p = _layer("olmoe-1b-7b", {}, seed=11, capacity_factor=1.0)
    x = T(_x(cfg, 24, seed=12, b=4))
    whole = L.moe_forward(p, x, cfg)
    for r in range(4):
        torch.testing.assert_close(whole[r:r + 1], L.moe_forward(p, x[r:r + 1], cfg),
                                   rtol=0, atol=0)


# --------------------------------------------------------------------------
# The reduced MoE models from the JAX model's weights
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE)
def test_params_from_jax_keeps_every_leaf(arch):
    _, jparams, model, params = models(arch, "bfloat16")
    jflat, pflat = flat(jparams), flat(params)
    assert jflat.keys() == pflat.keys()
    assert {"['blocks']['moe']['w_gate']", "['blocks']['moe']['router']['w']"} <= jflat.keys()
    assert not any("['mlp']" in key for key in jflat)
    for key, leaf in jflat.items():
        assert pflat[key].dtype == torch.float32 and tuple(pflat[key].shape) == leaf.shape
        np.testing.assert_array_equal(pflat[key].numpy(), np.asarray(leaf), err_msg=key)
    cfg = model.cfg
    assert params["blocks"]["moe"]["w_down"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_ff, cfg.d_model)


@pytest.mark.parametrize("arch", MOE)
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


@pytest.mark.parametrize("arch", MOE)
def test_compute_params_leaves_no_fp32_expert_tensor(arch):
    """The expert tensors and the router are cast once to bf16; the norms
    and the embedding stay the fp32 master's tensors."""
    model = models(arch, "bfloat16")[2]
    params = model.init(torch.Generator().manual_seed(1))
    compute = model.compute_params(params)
    moe = compute["blocks"]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        assert moe[name].dtype == torch.bfloat16
        torch.testing.assert_close(moe[name], params["blocks"]["moe"][name].bfloat16(),
                                   rtol=0, atol=0)
    assert moe["router"]["w"].dtype == torch.bfloat16
    assert compute["embed"] is params["embed"]
    assert compute["blocks"]["ln2"]["scale"] is params["blocks"]["ln2"]["scale"]


@pytest.mark.parametrize("arch", MOE)
def test_fp32_prefill_cache_and_decode_match_jax(arch):
    """Prefill of 37 tokens (past reduced Mixtral's window of 32) into a
    41-position cache, then three decode steps (capacity 1: S = 1)."""
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


@pytest.mark.parametrize("arch", MOE)
def test_prefill_then_decode_matches_forward(arch):
    """As ``tests/test_models.py::test_prefill_decode_matches_forward``, at
    its ``capacity_factor=8.0``: the forward pass over 18 tokens equals the
    JAX model's, and its last logits equal prefill of 17 plus one decode
    step.  Capacity is per call, so at the default factor the last token's
    pairs may drop in the forward pass (capacity ``ceil(k * 18 / E * 1.25)``)
    and never in a decode step (capacity 1, one pair an expert); at 8.0
    nothing drops in either."""
    jmodel, jparams, model, params = models(arch, "float32", seed=1, capacity_factor=8.0)
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


@pytest.mark.parametrize("arch", MOE)
def test_fp32_server_gives_the_jax_servers_tokens(arch):
    *_, jreqs, reqs = servers(arch, "float32", 0)
    for got, want in zip(reqs, jreqs):
        assert got.generated == want.generated


@pytest.mark.parametrize("arch", MOE)
def test_bf16_server_gives_the_jax_servers_tokens(arch):
    """:func:`_lm_parity.assert_bf16_server_rule`: fed the reference's
    tokens, the port's bf16 logits lie within the reference's own
    bf16-vs-fp32 distance, and greedy tokens part only at near ties."""
    assert_bf16_server_rule(arch)


def test_mixtral_window_matches_jax_past_it():
    """Mixtral's sliding window on every layer, at 8, with prompts of 16 and
    23 tokens: the forward pass, prefill and three decode steps, fp32."""
    jmodel, jparams, model, params = models("mixtral-8x7b", "float32", seed=3,
                                            sliding_window=8)
    assert backbone._layer_windows(model.cfg) == [8] * model.cfg.n_layers
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


@pytest.mark.parametrize("arch", MOE)
def test_serve_main_serves_moe_on_the_cpu(arch, capsys):
    done = serve.main(["--device", "cpu", "--arch", arch, "--requests", "3", "--slots", "2",
                       "--prompt-len", "12", "--gen-len", "4", "--layers", "2"])
    assert len(done) == 3 and all(len(r.generated) == 4 for r in done)
    assert f"[serve] {arch} on cpu: 3 requests, 12 tokens" in capsys.readouterr().out
