"""Helpers shared by the LM families' CPU parity tests
(``tests/test_torch_dense.py``, ``_hybrid.py``, ``_moe.py``, ``_vlm.py``,
``_audio.py``): a reduced config's JAX model and the port's from the same
weights, seeded tokens, flattened parameter trees, teacher-forced logits,
the ``extras`` both packages' servers give prefill, both servers on the
same prompts, and the rule that holds the port's bf16 server to the JAX
package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.launch import serve as j_serve
from repro.models import Model as JModel

from repro_torch.configs import reduced_config
from repro_torch.launch import serve
from repro_torch.models import Model, backbone, convert

T = torch.from_numpy


def models(arch, dtype, seed=0, **kw):
    """``(JAX model, its params, the port's model, the same params on the
    CPU)`` for ``arch``'s reduced config in ``dtype``, with ``kw`` replaced."""
    jcfg = dataclasses.replace(j_reduced_config(arch), dtype=dtype, **kw)
    cfg = dataclasses.replace(reduced_config(arch), dtype=dtype, **kw)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    return jmodel, jparams, Model(cfg), convert.params_from_jax(jparams, device="cpu")


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def server_extras(cfg, b):
    """What both packages' servers give a prefill of ``b`` requests as
    ``extras``: zeros ``(b, encoder_seq | vision_tokens, d_model)`` for the
    ``audio`` and ``vlm`` families, else ``None``."""
    n = backbone.memory_tokens(cfg)
    return None if n is None else np.zeros((b, n, cfg.d_model), np.float32)


def forced_logits(prefill, decode, prompts, toks, extras=None):
    """Logits of the prompt's last position (``prefill(prompts, extras)``)
    and of each decode step fed ``toks`` (B, n) in turn (teacher forcing):
    (n, B, V) as numpy."""
    logits, cache = prefill(prompts, extras)
    out = [np.asarray(logits)]
    for t in range(toks.shape[1] - 1):
        logits, cache = decode(cache, toks[:, t], prompts.shape[1] + t)
        out.append(np.asarray(logits))
    return np.stack(out)


def servers(arch, dtype, seed, n_req=4, gen=12, prompt_len=24, **kw):
    """Both packages' servers, 2 slots, on the same prompts (``kw`` replaced
    in the config)."""
    jmodel, jparams, model, params = models(arch, dtype, seed, **kw)
    prompts = tokens(model.cfg, n_req, prompt_len, seed + 2)
    max_seq = prompt_len + gen + 1
    jreqs = [j_serve.Request(i, prompts[i]) for i in range(n_req)]
    j_serve.Server(jmodel, jparams, 2, max_seq).run(jreqs, gen)
    server = serve.Server(model, params, 2, max_seq)
    reqs = server.run([serve.Request(i, prompts[i]) for i in range(n_req)], gen)
    assert all(r.done and len(r.generated) == gen for r in reqs)
    assert [len(t["decode_s"]) for t in server.timings] == [gen] * (n_req // 2)
    return jmodel, jparams, model, server, prompts, jreqs, reqs


def assert_bf16_server_rule(arch, seed=0, **kw):
    """4 requests x 12 generated tokens through 2 slots, in bf16, held by
    the rule of ``tests/test_torch_lm.py``'s RWKV6 test of this name: fed
    the reference's tokens (teacher forcing), the port's logits lie within
    ``tol``, the largest distance of the reference's bf16 logits from its
    fp32 logits on the same weights (measured in this run); where the port's
    greedy token differs from the reference's, the reference's top two
    logits lie within twice the two models' distance at that step (a near
    tie); and the servers' tokens are equal up to the first such step, where
    the port's server takes the port's greedy token.  The forced chains get
    the servers' ``extras`` (:func:`server_extras`)."""
    jmodel, jparams, model, server, prompts, jreqs, reqs = servers(arch, "bfloat16", seed,
                                                                   **kw)
    want = np.array([r.generated for r in jreqs])
    jm32 = JModel(dataclasses.replace(jmodel.cfg, dtype="float32"))
    extras = server_extras(model.cfg, 2)

    def forced(prefill, decode, prompts, ex):
        return np.concatenate([forced_logits(prefill, decode, prompts[i:i + 2], want[i:i + 2],
                                             ex) for i in (0, 2)], axis=1)

    jp, smax = jnp.asarray(prompts), server.max_seq
    jex = None if extras is None else jnp.asarray(extras, jnp.bfloat16)

    def jax_forced(m):  # jitted: the same function, compiled once a model
        pf = jax.jit(lambda x, ex: m.prefill(jparams, x, extras=ex, max_seq=smax))
        step = jax.jit(m.decode_step)
        return forced(pf, lambda c, t, pos: step(jparams, c, jnp.asarray(t), jnp.asarray(pos)),
                      jp, jex)

    jb, j32 = jax_forced(jmodel), jax_forced(jm32)
    pex = None if extras is None else T(extras).bfloat16()
    pb = forced(lambda x, ex: model.prefill(server.params, T(x), extras=ex, max_seq=smax),
                lambda c, t, pos: model.decode_step(server.params, c, T(t), pos), prompts, pex)
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
        if differ.size:
            assert got.generated[upto] == pb[upto, i].argmax()
