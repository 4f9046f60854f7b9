"""The port's LM stack (RWKV6) against the JAX package's, on the CPU.

* **Linear attention** (row 11 of the kernel table): the port's chunked
  plain version and its ops against the JAX Pallas kernel in interpret mode
  and against the JAX scan oracle, on the same numpy-seeded inputs, at the
  reference's own ``(t, chunk)`` cases and odd widths; tolerance atol 2e-4,
  rtol 1e-3 (the reference's own: fp32 sums in another order).
* **The reduced RWKV6 model** run from the JAX model's weights carried
  across by ``params_from_jax``: in fp32, prefill logits, the cache and one
  decode step within atol 2e-4, rtol 1e-3, and the ``Server``'s greedy
  tokens equal the JAX ``Server``'s; in bf16, the logits and greedy tokens
  agree within the tolerance stated at
  :func:`test_bf16_server_gives_the_jax_servers_tokens` (the reference's own
  bf16 error).
* ``prefill`` + ``decode_step`` equals ``forward_hidden`` ->
  ``logits_for_position``, as ``tests/test_models.py`` asserts for the
  reference; the weight carry-over, ``Model``'s refusal of the families not
  ported, the argument checks and ``serve.main`` on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.kernels.linear_attn.kernel import linear_attn_kernel
from repro.kernels.linear_attn.ops import linear_attention as j_linear_attention
from repro.kernels.linear_attn.ops import (
    linear_attention_with_state as j_linear_attention_with_state,
)
from repro.kernels.linear_attn.ref import linear_attn_ref as j_scan
from repro.launch import serve as j_serve
from repro.models import Model as JModel

from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.kernels.linear_attn import ops as la_ops
from repro_torch.kernels.linear_attn.ref import linear_attn_chunked, linear_attn_ref
from repro_torch.launch import serve
from repro_torch.models import Model, backbone, convert
from repro_torch.models import prefill as P

T = torch.from_numpy
TOL = dict(atol=2e-4, rtol=1e-3)


def _la_inputs(seed, bh, t, dk, dv, w_lo=0.5, w_hi=1.0):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(bh, t, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(bh, t, dv)).astype(np.float32)
    w = rng.uniform(w_lo, w_hi, size=(bh, t, dk)).astype(np.float32)
    u = (rng.normal(size=(bh, 1, dk)) * 0.5).astype(np.float32)
    return q, k, v, w, u


# --------------------------------------------------------------------------
# Row 11: chunked linear attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dk,dv", [(16, 24), (12, 20)])
@pytest.mark.parametrize("t,chunk", [(64, 16), (100, 32), (32, 32)])
@pytest.mark.parametrize("shift", [0, 1])
def test_chunked_matches_the_jax_kernel_and_scan(shift, t, chunk, dk, dv):
    q, k, v, w, u = _la_inputs(t + dk + shift, 3, t, dk, dv)
    o, s = la_ops.linear_attention_with_state(T(q), T(k), T(v), T(w), T(u), chunk=chunk,
                                              shift=shift)
    assert o.dtype == torch.float32 and o.shape == (3, t, dv) and s.shape == (3, dk, dv)
    jo, js = j_scan(*(jnp.asarray(a) for a in (q, k, v, w, u)), shift=shift)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    # the Pallas kernel in interpret mode, through the reference's 4-D op
    mode = "rwkv" if shift else "gla"
    b4 = [a.reshape(1, 3, t, -1) for a in (q, k, v, w)]
    want = j_linear_attention(*(jnp.asarray(a) for a in b4), jnp.asarray(u[:, 0]), chunk=chunk,
                              mode=mode, impl="pallas", interpret=True)
    got = la_ops.linear_attention(*(T(a) for a in b4), T(u[:, 0]), chunk=chunk, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if t % chunk == 0:  # the kernel itself, with its final state
        ko, ks = linear_attn_kernel(*(jnp.asarray(a) for a in (q, k, v, w, u)), chunk=chunk,
                                    shift=shift, interpret=True)
        po, ps = linear_attn_chunked(T(q), T(k), T(v), T(w), T(u), chunk=chunk, shift=shift)
        np.testing.assert_allclose(po.numpy(), np.asarray(ko), **TOL)
        np.testing.assert_allclose(ps.numpy(), np.asarray(ks), **TOL)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("chunk", [1, 8, 40, 128, 200])
def test_every_chunk_matches_the_jax_op_and_scan(chunk, shift):
    """Any chunk >= 1, as the reference's ops take it: both entries at
    chunks below, between and above the kernel's tiles, T ragged against
    each, against the reference's ops at the same chunk and its scan;
    tolerances of :func:`test_chunked_matches_the_jax_kernel_and_scan`."""
    t, dk, dv = 100, 12, 20
    q, k, v, w, u = _la_inputs(chunk + shift, 3, t, dk, dv)
    o, s = la_ops.linear_attention_with_state(T(q), T(k), T(v), T(w), T(u), chunk=chunk,
                                              shift=shift)
    assert o.shape == (3, t, dv) and s.shape == (3, dk, dv)
    jo, js = j_scan(*(jnp.asarray(a) for a in (q, k, v, w, u)), shift=shift)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    ko, ks = j_linear_attention_with_state(*(jnp.asarray(a) for a in (q, k, v, w, u)),
                                           chunk=chunk, shift=shift)
    np.testing.assert_allclose(o.numpy(), np.asarray(ko), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), **TOL)
    mode = "rwkv" if shift else "gla"
    b4 = [a.reshape(1, 3, t, -1) for a in (q, k, v, w)]
    want = j_linear_attention(*(jnp.asarray(a) for a in b4), jnp.asarray(u[:, 0]), chunk=chunk,
                              mode=mode)
    got = la_ops.linear_attention(*(T(a) for a in b4), T(u[:, 0]), chunk=chunk, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_a_dk_past_the_cards_shared_memory_is_taken_on_the_cpu():
    """Shared memory bounds the card's tiles, not the plain version: a dk
    the kernel refuses still runs on the CPU."""
    from repro_torch.kernels.linear_attn import kernel as la_kernel

    dk = 3500
    # the state's slice alone, dk rows of 16 + 8 floats, is past the limit
    assert 4 * dk * (16 + 8) > la_kernel._SMEM_LIMIT
    q, k, v, w, u = _la_inputs(11, 1, 20, dk, 4)
    o, s = la_ops.linear_attention_with_state(T(q), T(k), T(v), T(w), T(u), chunk=16)
    jo, js = j_scan(*(jnp.asarray(a) for a in (q, k, v, w, u)), shift=1)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_small_decay_stays_finite():
    """w = 0.2 over a 64-token chunk: the cumulative decay reaches 0.2**64;
    every exponent is a difference of log-decays, so nothing overflows."""
    q, k, v, _, u = _la_inputs(5, 2, 128, 16, 16)
    w = np.full_like(q, 0.2)
    o, s = la_ops.linear_attention_with_state(T(q), T(k), T(v), T(w), T(u), chunk=64)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    jo, js = j_scan(*(jnp.asarray(a) for a in (q, k, v, w, u)), shift=1)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def _subblock_model(q, k, v, w, u, *, chunk, shift, per_chunk_reference=False):
    """A plain model of the CUDA kernel's sub-block factoring (the kernel
    itself runs only on the card): per chunk, A's 16 x 16 diagonal blocks
    take the per-term exponent exp(lbq_t - lb_j); an off-diagonal block (I,
    J), J < I, is (q_I exp(lbq_I - r_I)) @ (k_J exp(r_I - lb_J))^T with r_I
    = lb at row 16 I - 1, or, with ``per_chunk_reference``, r = 0 for the
    whole chunk.  fp32 throughout; T a multiple of ``chunk``."""
    bh, t, dk = q.shape
    dv = v.shape[-1]
    lw = torch.log(torch.clamp(w, 1e-6, 1.0))
    s = torch.zeros(bh, dk, dv)
    ids = torch.arange(16)
    diag_mask = ids[None, :] <= ids[:, None] - shift
    outs = []
    for c0 in range(0, t, chunk):
        qb, kb, vb = q[:, c0:c0 + chunk], k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        lb = torch.cumsum(lw[:, c0:c0 + chunk], dim=1)
        lbq = torch.cat([torch.zeros_like(lb[:, :1]), lb[:, :-1]], dim=1) if shift else lb
        a = torch.zeros(bh, chunk, chunk)
        for bi in range(chunk // 16):
            rows = slice(16 * bi, 16 * bi + 16)
            decay = torch.exp(lbq[:, rows, None, :] - lb[:, None, rows, :])
            a[:, rows, rows] = torch.where(
                diag_mask, torch.einsum("btk,bjk,btjk->btj", qb[:, rows], kb[:, rows], decay), 0.0)
            if bi == 0:
                continue
            r = torch.zeros_like(lb[:, 0]) if per_chunk_reference else lb[:, 16 * bi - 1]
            cols = slice(0, 16 * bi)
            q_f = qb[:, rows] * torch.exp(lbq[:, rows] - r[:, None])
            k_f = kb[:, cols] * torch.exp(r[:, None] - lb[:, cols])
            a[:, rows, cols] = q_f @ k_f.transpose(1, 2)
        o = (qb * torch.exp(lbq)) @ s + a @ vb
        if shift:
            o = o + (qb * u * kb).sum(-1, keepdim=True) * vb
        s = torch.exp(lb[:, -1])[:, :, None] * s + (kb * torch.exp(lb[:, -1:] - lb)).transpose(1, 2) @ vb
        outs.append(o)
    return torch.cat(outs, dim=1), s


@pytest.mark.parametrize("shift", [0, 1])
def test_subblock_reference_point_is_safe_at_the_clip(shift):
    """w = 1e-6 everywhere, chunk 64: lb reaches -884 inside a chunk, yet
    the sub-block model's factors are all <= 1 and it equals the port's
    chunked plain version and the JAX op within ``TOL``."""
    q, k, v, _, u = _la_inputs(40 + shift, 3, 128, 16, 24)
    w = np.full_like(q, 1e-6)
    o, s = _subblock_model(*(T(a) for a in (q, k, v, w, u)), chunk=64, shift=shift)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    po, ps = linear_attn_chunked(*(T(a) for a in (q, k, v, w, u)), chunk=64, shift=shift)
    np.testing.assert_allclose(o.numpy(), po.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), ps.numpy(), **TOL)
    jo, js = j_linear_attention_with_state(*(jnp.asarray(a) for a in (q, k, v, w, u)), chunk=64,
                                           shift=shift)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("shift", [0, 1])
def test_one_reference_per_chunk_overflows_at_the_clip(shift):
    """The same model with r = 0 for the whole chunk: exp(r - lb) reaches
    e^884 and A is inf or nan -- why the kernel takes its reference per
    sub-block."""
    q, k, v, _, u = _la_inputs(40 + shift, 3, 128, 16, 24)
    w = np.full_like(q, 1e-6)
    o, _ = _subblock_model(*(T(a) for a in (q, k, v, w, u)), chunk=64, shift=shift,
                           per_chunk_reference=True)
    assert not torch.isfinite(o).all()


@pytest.mark.parametrize("shift", [0, 1])
def test_scan_oracle_matches_the_jax_scan_from_a_state(shift):
    q, k, v, w, u = _la_inputs(6, 3, 40, 8, 12)
    s0 = np.random.default_rng(7).normal(size=(3, 8, 12)).astype(np.float32)
    o, s = linear_attn_ref(T(q), T(k), T(v), T(w), T(u), shift=shift, initial_state=T(s0))
    jo, js = j_scan(*(jnp.asarray(a) for a in (q, k, v, w, u)), shift=shift,
                    initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_bf16_inputs_give_bf16_outputs_and_an_fp32_state():
    q, k, v, w, u = (T(a).bfloat16() for a in _la_inputs(8, 2, 50, 16, 16, 0.8, 1.0))
    o, s = la_ops.linear_attention_with_state(q, k, v, w, u, chunk=16)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    fo, fs = linear_attn_ref(*(a.float() for a in (q, k, v, w, u)))
    torch.testing.assert_close(o.float(), fo.bfloat16().float(), atol=0.02, rtol=0.02)
    torch.testing.assert_close(s, fs, **TOL)


def _bad_la_calls():
    q, k, v, w, u = (T(a) for a in _la_inputs(9, 2, 20, 8, 8))
    op = la_ops.linear_attention_with_state
    return [
        (TypeError, lambda: op(q.double(), k, v, w, u)),
        (TypeError, lambda: op(q, k.bfloat16(), v, w, u)),
        (ValueError, lambda: op(q, k[:, :10], v, w, u)),
        (ValueError, lambda: op(q, k, v[:1], w, u)),
        (ValueError, lambda: op(q, k, v, w, u[:, :, :4])),
        (ValueError, lambda: op(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u)),
        (ValueError, lambda: op(q, k, v, w, u, chunk=0)),
        (ValueError, lambda: op(q, k, v, w, u, shift=2)),
        (ValueError, lambda: la_ops.linear_attention(q[None], k[None], v[None], w[None],
                                                     mode="mamba")),
    ]


@pytest.mark.parametrize("case", range(9))
def test_linear_attention_checks_raise_before_dispatch(case, monkeypatch):
    def reached(*a, **kw):
        raise AssertionError("a bad argument reached the kernel or its plain version")

    monkeypatch.setattr(la_ops, "linear_attn_chunked", reached)
    calls = _bad_la_calls()
    assert len(calls) == 9
    exc, call = calls[case]
    with pytest.raises(exc):
        call()


# --------------------------------------------------------------------------
# The reduced RWKV6 model from the JAX model's weights
# --------------------------------------------------------------------------


def _models(dtype, seed=0):
    jcfg = dataclasses.replace(j_reduced_config("rwkv6-1.6b"), dtype=dtype)
    cfg = dataclasses.replace(reduced_config("rwkv6-1.6b"), dtype=dtype)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    return jmodel, jparams, Model(cfg), convert.params_from_jax(jparams, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_params_from_jax_keeps_every_leaf():
    _, jparams, model, params = _models("bfloat16")
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(params)) > 20
    for path, leaf in jleaves:
        node = params
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.float32 and tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert params["blocks"]["time_mix"]["wr"]["w"].shape[0] == model.cfg.n_layers


def test_params_from_jax_places_leaves_on_the_device_it_is_given(monkeypatch):
    """The card by default (entry points run on the card unless the caller
    asks for the CPU); the device given otherwise."""
    tree = {"a": np.ones((2, 3), np.float32), "b": {"c": np.zeros(4, np.float32)}}
    on_cpu = convert.params_from_jax(tree, device="cpu")
    assert on_cpu["a"].device.type == "cpu" and on_cpu["b"]["c"].device.type == "cpu"
    seen = []
    monkeypatch.setattr(torch.Tensor, "to", lambda self, dev: seen.append(str(dev)) or self)
    convert.params_from_jax(tree)
    convert.params_from_jax(tree, device="meta")
    assert seen == ["cuda", "cuda", "meta", "meta"]


def test_fp32_prefill_cache_and_decode_match_jax():
    jmodel, jparams, model, params = _models("float32")
    toks = _tokens(model.cfg, 2, 37, 1)
    from repro.models import prefill as JP

    jl, jcache = JP.prefill(jmodel.cfg, jparams, jnp.asarray(toks), cache_dtype=jnp.float32)
    kernels.reset_launch_counts()
    pl, cache = P.prefill(model.cfg, params, T(toks), cache_dtype=torch.float32)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)  # the CPU: no kernel
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for name in ("prev1", "prev2", "wkv"):
        assert cache[name].dtype == torch.float32
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **TOL)
    nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)
    jd, jcache2 = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt), jnp.asarray(37))
    pd, cache2 = model.decode_step(params, cache, T(nxt), 37)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(cache2["wkv"].numpy(), np.asarray(jcache2["wkv"]), **TOL)
    # the padded vocabulary never wins
    assert (pd[:, model.cfg.vocab_size:] == -1e30).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_is_the_references_and_decodes_like_it(dtype):
    """``init_cache`` has the reference's keys, shapes, dtypes and zeros, and
    three decode steps from it (no prefill) give the JAX model's logits and
    cache (fp32: atol 2e-4, rtol 1e-3; bf16: the cache dtype only, since the
    bf16 model's tolerance is the subject of the server test below)."""
    jmodel, jparams, model, params = _models(dtype)
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    jcache = jmodel.init_cache(3, 16, jdt)
    cache = model.init_cache(3, 16, dt, device="cpu")
    assert sorted(cache) == sorted(jcache)
    for name, leaf in jcache.items():
        assert tuple(cache[name].shape) == leaf.shape
        assert str(cache[name].dtype).removeprefix("torch.") == str(leaf.dtype)
        assert cache[name].device.type == "cpu" and not cache[name].any()
    if dtype == "bfloat16":
        return
    toks = _tokens(model.cfg, 3, 3, 4)
    for pos in range(3):
        jl, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, pos]),
                                        jnp.asarray(pos))
        pl, cache = model.decode_step(params, cache, T(toks[:, pos]), pos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        for name in ("prev1", "prev2", "wkv"):
            np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **TOL)


def _forced_logits(prefill, decode, prompts, tokens):
    """Logits of the prompt's last position and of each decode step fed
    ``tokens`` (B, n) in turn (teacher forcing): (n, B, V) as numpy."""
    logits, cache = prefill(prompts)
    out = [np.asarray(logits)]
    for t in range(tokens.shape[1] - 1):
        logits, cache = decode(cache, tokens[:, t], prompts.shape[1] + t)
        out.append(np.asarray(logits))
    return np.stack(out)


def _servers(dtype, seed, n_req=4, gen=16):
    jmodel, jparams, model, params = _models(dtype, seed)
    prompts = _tokens(model.cfg, n_req, 24, seed + 2)
    jreqs = [j_serve.Request(i, prompts[i]) for i in range(n_req)]
    j_serve.Server(jmodel, jparams, 2, 41).run(jreqs, gen)
    server = serve.Server(model, params, 2, 41)
    reqs = server.run([serve.Request(i, prompts[i]) for i in range(n_req)], gen)
    assert all(r.done and len(r.generated) == gen for r in reqs)
    assert [len(t["decode_s"]) for t in server.timings] == [gen] * (n_req // 2)
    return jmodel, jparams, model, server, prompts, jreqs, reqs


def test_fp32_server_gives_the_jax_servers_tokens():
    *_, jreqs, reqs = _servers("float32", 0)
    for got, want in zip(reqs, jreqs):
        assert got.generated == want.generated


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_server_gives_the_jax_servers_tokens(seed):
    """4 requests x 16 generated tokens through 2 slots, in bf16.

    bf16 keeps 8 significant bits, and the decay ``w = exp(-exp(-6 + ...))
    ~ 0.9975`` is cast to bf16, whose neighbours there are 0.99609375 and
    1.0: a last-bit difference in an fp32 reduction (a norm's mean, summed
    in another order) can move a decay and, through the state, every later
    logit.  So the tolerance is the reference's own bf16 error: ``tol``, the
    largest distance of the reference's bf16 logits from its fp32 logits on
    the same weights, measured in this run (0.24-0.82 on logits of scale
    ~4 over seeds 0-5).  Fed the reference's tokens (teacher forcing):

    * the port's logits lie within ``tol`` of the reference's bf16 logits;
    * where the port's greedy token differs from the reference's, the
      reference's top two logits lie within twice the distance of the two
      models' logits at that step: a near tie (such steps were 2-6% of the
      64 on seeds 0-5; the reference's own fp32 model differs from its bf16
      tokens on 5-11%);
    * the two servers' tokens are equal up to the first step where the
      greedy decisions differ, and there the port's server takes the port's
      greedy token.  (Logits are taken per slot batch, as the
      servers run them: a bf16 product's rounding may depend on the batch.)"""
    jmodel, jparams, model, server, prompts, jreqs, reqs = _servers("bfloat16", seed)
    want = np.array([r.generated for r in jreqs])
    jm32 = JModel(dataclasses.replace(jmodel.cfg, dtype="float32"))

    def forced(prefill, decode, prompts):
        return np.concatenate([_forced_logits(prefill, decode, prompts[i:i + 2], want[i:i + 2])
                               for i in (0, 2)], axis=1)

    jp = jnp.asarray(prompts)
    jb = forced(lambda x: jmodel.prefill(jparams, x), lambda c, t, pos: jmodel.decode_step(
        jparams, c, jnp.asarray(t), jnp.asarray(pos)), jp)
    j32 = forced(lambda x: jm32.prefill(jparams, x), lambda c, t, pos: jm32.decode_step(
        jparams, c, jnp.asarray(t), jnp.asarray(pos)), jp)
    pb = forced(lambda x: model.prefill(server.params, T(x)),
                lambda c, t, pos: model.decode_step(server.params, c, T(t), pos), prompts)
    v = model.cfg.vocab_size
    jb, j32, pb = jb[..., :v], j32[..., :v], pb[..., :v]
    assert (jb.argmax(-1) == want.T).all()  # the JAX server is its model's greedy chain
    tol = np.abs(jb - j32).max()
    dist = np.abs(pb - jb)
    assert dist.max() <= tol
    same = pb.argmax(-1) == want.T  # (steps, requests)
    top2 = np.sort(jb, axis=-1)[..., -2:]
    assert ((top2[..., 1] - top2[..., 0])[~same] <= 2 * dist.max(-1)[~same]).all()
    for i, (got, ref) in enumerate(zip(reqs, jreqs)):
        differ = np.flatnonzero(~same[:, i])
        upto = differ[0] if differ.size else len(ref.generated)
        assert got.generated[:upto] == ref.generated[:upto]
        if differ.size:  # where they part, the port took its own greedy token
            assert got.generated[upto] == pb[upto, i].argmax()


def test_prefill_then_decode_matches_forward():
    """As ``tests/test_models.py::test_prefill_decode_matches_forward`` for
    the reference: the forward pass (the 4-D entry of the kernel) and the
    prefill + one decode step (the 3-D entry, then the recurrence) give the
    same logits for the last token."""
    cfg = dataclasses.replace(reduced_config("rwkv6-1.6b"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    toks = T(_tokens(cfg, 2, 18, 3))
    s = 17
    hidden = backbone.forward_hidden(cfg, params, toks)
    want = backbone.logits_for_position(cfg, params, hidden[:, -1])
    _, cache = P.prefill(cfg, params, toks[:, :s], max_seq=s + 4, cache_dtype=torch.float32)
    got, _ = model.decode_step(params, cache, toks[:, s], s)
    torch.testing.assert_close(got, want, **TOL)


def test_init_draws_the_reference_shapes_and_scales():
    jmodel, jparams, model, _ = _models("bfloat16")
    params = model.init(torch.Generator().manual_seed(0))
    jflat = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in jax.tree_util.tree_leaves_with_path(jparams)}
    pflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_leaves_with_path(params)}
    assert jflat.keys() == pflat.keys()
    for key, j in jflat.items():
        p = pflat[key].numpy()
        assert p.shape == j.shape and p.dtype == j.dtype, key
        np.testing.assert_allclose(p.std(), j.std(), rtol=0.1, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(p.mean(), j.mean(), atol=0.02 + 0.1 * j.std(), err_msg=key)
    compute = model.compute_params(params)
    assert compute["blocks"]["time_mix"]["wr"]["w"].dtype == torch.bfloat16
    assert compute["blocks"]["time_mix"]["w_a"] is params["blocks"]["time_mix"]["w_a"]


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).family not in ("ssm", "dense", "hybrid",
                                                                  "moe")])
def test_model_refuses_the_families_not_ported(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(reduced_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_references(arch):
    from repro.configs import get_config as j_get_config

    for port, ref in ((get_config(arch), j_get_config(arch)),
                      (reduced_config(arch), j_reduced_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count() and port.padded_vocab == ref.padded_vocab
    if arch == "rwkv6-1.6b":
        cfg = get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) == (
            24, 2048, 32, 7168, 65536)


def test_serve_main_runs_on_the_cpu(capsys):
    done = serve.main(["--device", "cpu", "--reduced", "--requests", "3", "--slots", "2",
                       "--prompt-len", "9", "--gen-len", "4"])
    assert len(done) == 3 and all(len(r.generated) == 4 and r.done for r in done)
    assert "[serve] granite-3-2b on cpu: 3 requests, 12 tokens" in capsys.readouterr().out
