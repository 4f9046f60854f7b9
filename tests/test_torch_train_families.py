"""``Model.loss`` and its gradients in the port against the JAX package's
``jax.value_and_grad`` of its ``Model.loss`` on the same weights and
batch, in fp32, for each of the six families at reduced size (Zamba2 at 4
layers: a unit and a tail layer).  The VLM's gates are opened to 0.7, and
Whisper's and the VLM's ``extras`` are seeded: at init the gates are 0,
which would make the cross block add exactly nothing.  The sequence (80
tokens) is ragged against the reduced ``vocab_chunk`` (64) and row 11's
chunk (64), so the loss's padding and the kernel's are both crossed.

Tolerances: the loss to rtol 1e-6; every gradient leaf to 2e-5 of its
largest entry, or 2e-3 for the ``ssm`` and ``hybrid`` families, whose
gradients pass through row 11's log-space decays (``cumsum`` of ``log w``
and its ``exp``, rounded apart in the two packages: 3.6e-4 and 3.9e-4
measured).

Also: ``remat`` on and off give equal bits on the CPU, and row 11's
gradients (``linear_attention``, which on the CPU is autograd of its plain
version, and on the card a ``torch.autograd.Function`` whose backward is
that plain version) against ``jax.grad`` of the reference's
``linear_attention`` in both modes over a ragged ``T``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import T, flat, models, tokens
from repro.kernels.linear_attn.ops import linear_attention as j_linear_attention

from repro_torch.kernels.linear_attn.ops import linear_attention
from repro_torch.models.backbone import memory_tokens
from repro_torch.train.train_step import loss_and_grads

FAMILIES = ["granite-3-2b", "olmoe-1b-7b", "rwkv6-1.6b", "zamba2-1.2b", "llama-3.2-vision-11b",
            "whisper-large-v3"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these cases run many small tensor ops, and with
    a thread a core in each of several test workers the pool's threads
    contend (a 3 s case took 558 s in a 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=1, b=2, s=80):
    batch = dict(tokens=tokens(cfg, b, s, seed), labels=tokens(cfg, b, s, seed + 1))
    n = memory_tokens(cfg)
    if n:
        rng = np.random.default_rng(seed + 2)
        batch["extras"] = rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _models(arch):
    """Both packages' fp32 models on the same weights, built once a module
    (nothing here writes them); reduced Zamba2 at 4 layers, one unit of 3
    and a tail layer."""
    jm, jp, m, p = models(arch, "float32", 0, **({"n_layers": 4} if arch == "zamba2-1.2b"
                                                 else {}))
    if m.cfg.family == "vlm":
        jp["cross_blocks"]["gate"] = jnp.full_like(jp["cross_blocks"]["gate"], 0.7)
        p["cross_blocks"]["gate"].fill_(0.7)
    return jm, jp, m, p


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_gradient_match_jax(arch):
    jm, jp, m, p = _models(arch)
    batch = _batch(m.cfg)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(m, p, {k: T(v) for k, v in batch.items()})
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(loss) == pytest.approx(float(jl), rel=1e-6)
    tol = 2e-3 if m.cfg.family in ("ssm", "hybrid") else 2e-5
    fj, fp = flat(jg), flat(grads)
    assert fj.keys() == fp.keys()
    for k in fj:
        want = np.asarray(fj[k])
        assert fp[k].shape == want.shape and fp[k].dtype == torch.float32, k
        np.testing.assert_allclose(fp[k].numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max() + 1e-30, err_msg=k)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b", "llama-3.2-vision-11b"])
def test_remat_on_and_off_give_equal_bits(arch):
    _, _, m, p = _models(arch)
    batch = {k: T(v) for k, v in _batch(m.cfg, s=40).items()}
    l1, g1 = loss_and_grads(m, p, batch, remat=True)
    l2, g2 = loss_and_grads(m, p, batch, remat=False)
    assert torch.equal(l1, l2)
    f1, f2 = flat(g1), flat(g2)
    for k in f1:
        assert torch.equal(f1[k], f2[k]), k


@pytest.mark.parametrize("mode,t,chunk", [("rwkv", 37, 16), ("ssd", 37, 16), ("rwkv", 64, 64)])
def test_row_11_gradients_match_jax_grad(mode, t, chunk):
    rng = np.random.default_rng(7)
    b, h, dk, dv = 2, 3, 8, 6
    q, k = (rng.normal(size=(b, h, t, dk)).astype(np.float32) * 0.5 for _ in range(2))
    v = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, size=(b, h, t, dk)).astype(np.float32)
    u = rng.normal(size=(h, dk)).astype(np.float32) * 0.3
    ct = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    args = (q, k, v, w, u) if mode == "rwkv" else (q, k, v, w)

    def jloss(*a):
        return jnp.sum(j_linear_attention(*a, chunk=chunk, mode=mode) * ct)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(args)))))(*map(jnp.asarray, args))
    leaves = [T(a).requires_grad_() for a in args]
    o = linear_attention(*leaves, chunk=chunk, mode=mode)
    got = torch.autograd.grad((o * T(ct)).sum(), leaves)
    for name, g, j in zip("qkvwu", got, want):
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-5 * np.abs(j).max(),
                                   err_msg=name)
