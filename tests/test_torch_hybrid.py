"""The port's hybrid LM family (Mamba2 layers and Zamba2's shared dense
block) against the JAX package's, on the CPU, on the same numpy-seeded
inputs.

* **Layers**, in fp32 at atol 2e-5 (fp32 sums in another order):
  ``mamba2_forward`` at T = 17 and 70 (ragged against the kernel's chunk of
  64), ``_mamba2_with_state``'s output, conv state and SSD state, and one
  ``mamba2_decode`` step from random conv and SSD states (the conv state in
  fp32, and in bf16, which the reference's concatenation widens to fp32).
  ``a_log``, ``dt_bias``, ``d_skip`` and the norm's scale are drawn at
  random, not left at their init.
* **Reduced zamba2** (``reduced_config``: 8 layers, period 3, N = 16, so
  two units and two tail layers) from the JAX model's weights
  (``convert.params_from_jax``): the init's shapes and scales, every leaf
  carried across (the unstacked ``shared`` block included), fp32 prefill
  logits and every cache array (``conv``, ``ssm``, ``sk``, ``sv``) then
  three decode steps at atol 2e-4, rtol 1e-3 (as ``tests/test_models.py``),
  ``forward_hidden`` against prefill plus one decode, the shared KV cache
  written in place, fp32 server tokens equal to the JAX server's, and bf16
  server tokens held by the rule of
  :func:`_lm_parity.assert_bf16_server_rule`.
* **The short prompt**: a prompt of 1 or 2 tokens, shorter than the conv's
  ``K - 1 = 3``, where the reference's prefill keeps a conv state of 1 or 2
  rows and its next decode step fails; the port's prefill plus one decode
  step equals the JAX package's forward pass over the t + 1 tokens (fp32,
  the tolerance above).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import backbone as JB
from repro.models import prefill as JP
from repro.models import ssm as JS

from _lm_parity import assert_bf16_server_rule, flat, models, servers, tokens
from repro_torch import kernels
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import backbone, convert
from repro_torch.models import prefill as P
from repro_torch.models import ssm as S

T = torch.from_numpy
LAYER_TOL = dict(atol=2e-5, rtol=0)
TOL = dict(atol=2e-4, rtol=1e-3)
ARCH = "zamba2-1.2b"


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------


def _mamba(seed):
    """Reduced zamba2's fp32 config, one Mamba2 layer's parameters from the
    JAX init with ``a_log``, ``dt_bias``, ``d_skip`` and the norm's scale
    redrawn from ``seed`` (JAX tree, port tree) and the numpy generator."""
    jcfg = dataclasses.replace(j_reduced_config(ARCH), dtype="float32")
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(np.asarray, JS.init_mamba2(jax.random.key(seed), jcfg))
    h, inner = jcfg.n_heads, jcfg.ssm_expand * jcfg.d_model
    jp.update(a_log=rng.normal(0, 0.5, h).astype(np.float32),
              dt_bias=rng.normal(0, 1, h).astype(np.float32),
              d_skip=rng.normal(1, 0.3, h).astype(np.float32),
              norm=dict(scale=rng.normal(1, 0.2, inner).astype(np.float32)))
    cfg = dataclasses.replace(reduced_config(ARCH), dtype="float32")
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, convert.params_from_jax(jp, "cpu"), rng


@pytest.mark.parametrize("t", [17, 70])
def test_mamba2_forward_matches_jax(t):
    jcfg, jp, cfg, p, rng = _mamba(t)
    x = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    _close(S.mamba2_forward(p, T(x), cfg), JS.mamba2_forward(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("t", [17, 70])
def test_mamba2_with_state_matches_jax(t):
    """The output, the conv state (the last K - 1 raw inputs) and the fp32
    SSD state, through the 3-D entry of the kernel."""
    jcfg, jp, cfg, p, rng = _mamba(t + 1)
    x = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    jy, jconv, jstate = JP._mamba2_with_state(jp, jnp.asarray(x), jcfg)
    y, conv, state = P._mamba2_with_state(p, T(x), cfg)
    assert conv.shape == jconv.shape and state.shape == jstate.shape
    assert state.dtype == torch.float32
    for got, want in ((y, jy), (conv, jconv), (state, jstate)):
        _close(got, want)


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_jax(conv_dtype):
    """One step from random conv and SSD states; the new conv state comes
    back in the reference's dtype (fp32 from a bf16 state and fp32 x)."""
    jcfg, jp, cfg, p, rng = _mamba(3)
    inner, h, n = cfg.ssm_expand * cfg.d_model, cfg.n_heads, cfg.ssm_state
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, cfg.ssm_conv - 1, inner)).astype(np.float32)
    ssm = rng.normal(size=(3, h, n, inner // h)).astype(np.float32)
    jconv = jnp.asarray(conv).astype(conv_dtype)
    tconv = T(conv).to(getattr(torch, conv_dtype))
    jy, jnconv, jnst = JS.mamba2_decode(jp, jnp.asarray(x), jconv, jnp.asarray(ssm), jcfg)
    y, nconv, nst = S.mamba2_decode(p, T(x), tconv, T(ssm), cfg)
    assert str(nconv.dtype) == f"torch.{jnconv.dtype}" and nst.dtype == torch.float32
    for got, want in ((y, jy), (nconv, jnconv), (nst, jnst)):
        _close(got, want)


def test_shared_block_follows_every_period():
    """Zamba2-1.2B: six applications, after layers 5, 11, ..., 35, and two
    tail layers; reduced zamba2: after layers 2 and 5, tail 6 and 7."""
    for cfg, after in ((get_config(ARCH), [5, 11, 17, 23, 29, 35]),
                       (reduced_config(ARCH), [2, 5])):
        apps = {i: backbone.shared_application(cfg, i) for i in range(cfg.n_layers)}
        assert [i for i, j in apps.items() if j is not None] == after
        assert [apps[i] for i in after] == list(range(len(after)))


# --------------------------------------------------------------------------
# Reduced zamba2 from the JAX model's weights
# --------------------------------------------------------------------------


def test_params_from_jax_keeps_every_leaf():
    _, jparams, model, params = models(ARCH, "bfloat16")
    jflat, pflat = flat(jparams), flat(params)
    assert jflat.keys() == pflat.keys() and len(jflat) == 20
    assert sum(key.startswith("['shared']") for key in pflat) == 9
    for key, leaf in jflat.items():
        assert pflat[key].dtype == torch.float32 and tuple(pflat[key].shape) == leaf.shape
        np.testing.assert_array_equal(pflat[key].numpy(), np.asarray(leaf), err_msg=key)
    assert params["blocks"]["mamba"]["w_in"]["w"].shape[0] == model.cfg.n_layers
    assert params["shared"]["attn"]["wq"]["w"].shape == (model.cfg.d_model, model.cfg.q_dim)


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
    compute = model.compute_params(params)
    assert compute["blocks"]["mamba"]["w_in"]["w"].dtype == torch.bfloat16
    assert compute["shared"]["mlp"]["w_up"]["w"].dtype == torch.bfloat16
    assert compute["blocks"]["mamba"]["conv"] is params["blocks"]["mamba"]["conv"]


CACHE = ("conv", "ssm", "sk", "sv")


def test_fp32_prefill_cache_and_decode_match_jax():
    """Prefill of 70 tokens (past one chunk of 64) into a 74-position cache,
    then three decode steps; no kernel is launched on the CPU."""
    jmodel, jparams, model, params = models(ARCH, "float32")
    toks = tokens(model.cfg, 2, 70, 1)
    jl, jcache = JP.prefill(jmodel.cfg, jparams, jnp.asarray(toks), max_seq=74,
                            cache_dtype=jnp.float32)
    kernels.reset_launch_counts()
    pl, cache = P.prefill(model.cfg, params, T(toks), max_seq=74, cache_dtype=torch.float32)
    _close(pl, jl, TOL)
    assert sorted(cache) == sorted(jcache) == sorted(CACHE)
    for name in CACHE:
        assert cache[name].dtype == torch.float32 and cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name], TOL)
    assert not cache["sk"][..., 70:, :].any() and not cache["sv"][..., 70:, :].any()
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for t in range(3):
        jd, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(70 + t))
        pd, cache = model.decode_step(params, cache, T(nxt), 70 + t)
        _close(pd, jd, TOL)
        for name in CACHE:
            _close(cache[name], jcache[name], TOL)
        nxt = np.argmax(np.asarray(jd), -1).astype(np.int32)
    assert (pd[:, model.cfg.vocab_size:] == -1e30).all()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_prefill_then_decode_matches_forward():
    """As ``tests/test_models.py::test_prefill_decode_matches_forward``:
    the forward pass (the 4-D entry of the kernel) and prefill (the 3-D
    entry) + one decode step give the same logits for the last token; the
    forward pass is also the JAX model's."""
    jmodel, jparams, model, params = models(ARCH, "float32", seed=1)
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


def test_init_cache_is_the_references_and_decodes_like_it():
    """``init_cache``'s keys, shapes, dtypes (bf16 by default, the SSD state
    fp32) and zeros; three decode steps from an fp32 one (no prefill) give
    the JAX model's logits and cache."""
    jmodel, jparams, model, params = models(ARCH, "float32")
    jcache = jmodel.init_cache(3, 16)
    cache = model.init_cache(3, 16, device="cpu")
    assert sorted(cache) == sorted(jcache) == sorted(CACHE)
    for name, leaf in jcache.items():
        assert tuple(cache[name].shape) == leaf.shape, name
        assert str(cache[name].dtype) == f"torch.{leaf.dtype}" and not cache[name].any()
    jcache = jmodel.init_cache(3, 16, dtype=jnp.float32)
    cache = model.init_cache(3, 16, dtype=torch.float32, device="cpu")
    toks = tokens(model.cfg, 3, 3, 4)
    for pos in range(3):
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, pos]),
                                        jnp.asarray(pos))
        pl, cache = model.decode_step(params, cache, T(toks[:, pos]), pos)
        _close(pl, jl, TOL)
        for name in CACHE:
            _close(cache[name], jcache[name], TOL)


def test_decode_step_writes_the_shared_cache_in_place():
    """The step writes the shared block's K / V into the ``sk`` / ``sv`` it
    was given, storage unchanged, and returns them with new ``conv`` /
    ``ssm`` states; all four are the reference's new cache."""
    jmodel, jparams, model, params = models(ARCH, "float32", seed=2)
    toks = tokens(model.cfg, 2, 10, 5)
    jl, jcache = JP.prefill(jmodel.cfg, jparams, jnp.asarray(toks), max_seq=14,
                            cache_dtype=jnp.float32)
    _, cache = P.prefill(model.cfg, params, T(toks), max_seq=14, cache_dtype=torch.float32)
    ptrs = {name: cache[name].data_ptr() for name in ("sk", "sv")}
    old = {name: cache[name].clone() for name in ("conv", "ssm")}
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    _, jnew = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(10))
    _, new = model.decode_step(params, cache, T(nxt), 10)
    assert {name: new[name].data_ptr() for name in ptrs} == ptrs
    assert all(torch.equal(cache[name], old[name]) for name in old)  # left as they were
    for name in CACHE:
        _close(new[name], jnew[name], TOL)
    for name in ("sk", "sv"):
        assert cache[name][..., 10, :].any() and not cache[name][..., 11:, :].any()


def test_fp32_server_gives_the_jax_servers_tokens():
    """Both servers prefill into a bf16 cache (the reference's ``Server``
    passes no ``cache_dtype``); the conv state comes back fp32 from the
    first decode step in both."""
    *_, jreqs, reqs = servers(ARCH, "float32", 0)
    for got, want in zip(reqs, jreqs):
        assert got.generated == want.generated


def test_bf16_server_gives_the_jax_servers_tokens():
    """:func:`_lm_parity.assert_bf16_server_rule`: fed the reference's
    tokens, the port's bf16 logits lie within the reference's own
    bf16-vs-fp32 distance, and greedy tokens part only at near ties."""
    assert_bf16_server_rule(ARCH)


def test_serve_main_serves_zamba2_on_the_cpu(capsys):
    done = serve.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--requests", "3",
                       "--slots", "2", "--prompt-len", "9", "--gen-len", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 and r.done for r in done)
    assert f"[serve] {ARCH} on cpu: 3 requests, 12 tokens" in capsys.readouterr().out


# --------------------------------------------------------------------------
# The short prompt
# --------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 2, 3])
def test_short_prompt_then_decode_matches_forward(t):
    """A prompt of t tokens, then one decode step: the logits are the JAX
    package's forward pass over the t + 1 tokens.  Below t = K - 1 = 3 the
    reference's own prefill keeps a conv state of t rows (its decode then
    fails), where the port's holds the causal pad's zeros in front; from
    t = 3 on the two conv states are equal."""
    jmodel, jparams, model, params = models(ARCH, "float32", seed=4)
    cfg = model.cfg
    toks = tokens(cfg, 2, t + 1, 6)
    jh = JB.forward_hidden(jmodel.cfg, jparams, jnp.asarray(toks), remat=False)
    want = JB.logits_for_position(jmodel.cfg, jparams, jh[:, -1])
    _, cache = P.prefill(cfg, params, T(toks[:, :t]), max_seq=t + 1, cache_dtype=torch.float32)
    got, _ = model.decode_step(params, cache, T(toks[:, t]), t)
    _close(got, want, TOL)
    _, jcache = JP.prefill(jmodel.cfg, jparams, jnp.asarray(toks[:, :t]), max_seq=t + 1,
                           cache_dtype=jnp.float32)
    k1 = cfg.ssm_conv - 1
    rows = jcache["conv"].shape[2]  # the reference's: fewer than K - 1 below t = 3
    assert cache["conv"].shape[2] == k1 and (rows < k1) == (t < k1)
    assert not cache["conv"][:, :, :max(k1 - t, 0)].any()
    _close(cache["conv"][:, :, k1 - rows:], jcache["conv"], TOL)


def test_fp64_bound_holds_the_fp32_forward_and_fails_a_mutated_model():
    """The bound ``tests/test_torch_cuda.py::test_hybrid_model_on_the_card_equals_the_cpu``
    holds the card and the CPU to (``_hybrid_fp64.fp64_bound``: each layer's
    own fp32 rounding on the CPU, doubled, pushed through the rest of the
    model in float64, 6 standard deviations), on that test's weights and tokens: the
    CPU's fp32 ``forward_hidden`` lies within it, though not within the
    test's former ``rtol=1e-3, atol=2e-4`` of the float64 value (a
    tolerance finer than fp32 here); a model whose one layer's output
    projection is scaled by 1 + 1e-4, or whose last layer has no D skip,
    does not."""
    from _hybrid_fp64 import fp64_bound, inputs, tree

    cfg, params, toks = inputs()
    y64, bound = fp64_bound(cfg, params, toks)
    err = (backbone.forward_hidden(cfg, params, toks).double() - y64).abs()
    assert (err <= bound).all()
    assert (err > 2e-4 + 1e-3 * y64.abs()).any()
    for mutate in (lambda p: p["blocks"]["mamba"]["w_out"]["w"][3].mul_(1 + 1e-4),
                   lambda p: p["blocks"]["mamba"]["d_skip"][cfg.n_layers - 1].zero_()):
        bad = tree(params, lambda a: a.clone())
        mutate(bad)
        assert ((backbone.forward_hidden(cfg, bad, toks).double() - y64).abs() > bound).any()


@pytest.mark.parametrize("heads", ["all", "one"])
def test_device_faults_flags_a_planted_row11_fault(monkeypatch, heads):
    """``_hybrid_fp64.device_faults``, which the card test runs, on the CPU
    as the device under test: nothing on the clean model; with row 11's
    output in layer 3 scaled by 1 + 1e-4 after the reference was taken (all
    heads, or head 0), the forward lies past the bound, and for one head
    the layer's own rounding is past twice the CPU's too."""
    import itertools

    from _hybrid_fp64 import cpu_reference, device_faults, inputs, planted_fault

    cfg, params, toks = inputs()
    ref = cpu_reference(cfg, params, toks)
    assert device_faults(cfg, params, toks, "cpu", ref) == []
    monkeypatch.setattr(S, "linear_attention", planted_fault(
        S.linear_attention, cfg, heads, itertools.count()))
    faults = device_faults(cfg, params, toks, "cpu", ref)
    assert any(f.startswith("forward") for f in faults), faults
    if heads == "one":
        assert any(f.startswith("mamba3:") for f in faults), faults
