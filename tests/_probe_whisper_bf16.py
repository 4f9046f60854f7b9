"""Probe of reduced Whisper's bf16 path, the port's against the JAX
package's, tensor by tensor (not a test: run it by hand).

    PYTHONPATH=src python tests/_probe_whisper_bf16.py [--seed 0] [--ratios 4]

On the bf16 server rule's prompts (``_lm_parity.servers``: 24-token
prompts, the servers' zero frames), the port is fed the reference's
inputs at each step, so each line shows one step's own rounding: the
frames plus ``enc_pos``, each encoder layer's two residual adds, the
encoder's output, the tokens plus ``dec_pos``, each decoder layer's three
residual adds at prefill and at the first decode step (from the
reference's cache), and ``xk`` from the reference's encoder output.  Then
the reference's encoder jitted whole against the same ops run one at a time,
and the port's encoder (which rounds as the jitted one does:
``backbone.encode``) against the jitted one.
A line gives the share of elements apart and the largest distance.

``--ratios N`` prints the rule's ratio (the port's distance from the
reference's bf16 logits over the reference's own bf16-vs-fp32 distance) at
seeds 0..N-1, under the default XLA flags and with
``--xla_allow_excess_precision=false`` (each in a process of its own: the
flag is read when JAX starts).
"""

import argparse
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _lm_parity import T, forced_logits, models, server_extras, servers, tokens  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402

from repro_torch.models import backbone as B  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import prefill as P  # noqa: E402

ARCH = "whisper-large-v3"


def _f(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


def _bf(a):
    return torch.from_numpy(_f(a)).bfloat16()


def _cmp(name, j, p):
    d = np.abs(_f(j) - _f(p))
    print(f"{name:34s} apart {(d > 0).mean():.4%}  max {d.max():.4g}")


def probe(seed: int) -> None:
    jm, jp, m, p = models(ARCH, "bfloat16", seed)
    cfg, jcfg, cp = m.cfg, jm.cfg, m.compute_params(p)
    prompts = tokens(cfg, 4, 24, seed + 2)[:2]
    ex = server_extras(cfg, 2)
    jex = jnp.asarray(ex, jnp.bfloat16)
    bf = jnp.bfloat16

    def layer(tree, i):
        return jax.tree.map(lambda a: a[i], tree)

    jh = jex.astype(bf) + jp["enc_pos"][None].astype(bf)
    _cmp("encoder input (+ enc_pos)", jh, T(ex).bfloat16() + cp["enc_pos"].bfloat16())
    for i in range(cfg.encoder_layers):
        jl, pl = layer(jp["enc_blocks"], i), B.layer_params(cp["enc_blocks"], i)
        ja = jh + JL.attn_forward(jl["attn"], JL.apply_norm(jl["ln1"], jh, jcfg), jcfg,
                                  causal=False)
        ph = _bf(jh)
        _cmp(f"encoder {i} attention add", ja, ph + L.attn_forward(
            pl["attn"], L.apply_norm(pl["ln1"], ph, cfg), cfg, causal=False))
        jh = ja + JL.mlp_forward(jl["mlp"], JL.apply_norm(jl["ln2"], ja, jcfg), jcfg)
        pa = _bf(ja)
        _cmp(f"encoder {i} MLP add", jh, pa + L.mlp_forward(pl["mlp"], L.apply_norm(
            pl["ln2"], pa, cfg), cfg))
    jenc = JL.apply_norm(jp["enc_final_norm"], jh, jcfg)
    _cmp("encoder output (op by op)", jenc, B.encode(cfg, cp, T(ex).bfloat16()))

    def dec_layers(jx, pos, step):
        for i in range(cfg.n_layers):
            jl, pl = layer(jp["blocks"], i), B.layer_params(cp["blocks"], i)
            px = _bf(jx)
            if step:
                h = JL.attn_decode(jl["attn"], JL.apply_norm(jl["ln1"], jx[:, None], jcfg),
                                   jc["k"][i], jc["v"][i], pos, jcfg)[0][:, 0]
                ph = L.attn_decode(pl["attn"], L.apply_norm(pl["ln1"], px[:, None], cfg),
                                   _bf(jc["k"][i]).clone(), _bf(jc["v"][i]).clone(), pos,
                                   cfg)[0][:, 0]
            else:
                h = JL.attn_forward(jl["attn"], JL.apply_norm(jl["ln1"], jx, jcfg), jcfg)
                ph = L.attn_forward(pl["attn"], L.apply_norm(pl["ln1"], px, cfg), cfg)
            j1 = jx + h
            _cmp(f"{step} layer {i} self-attention add", j1, px + ph)
            p1 = _bf(j1)
            if step:
                j2 = j1 + JD._cross_decode(jl["cross"], JL.apply_norm(jl["ln_x"], j1[:, None],
                                                                        jcfg),
                                           jc["xk"][i], jc["xv"][i], jcfg)[:, 0]
                p2 = p1 + D._cross_decode(pl["cross"], L.apply_norm(pl["ln_x"], p1, cfg),
                                          _bf(jc["xk"][i]), _bf(jc["xv"][i]), cfg)
            else:
                j2 = j1 + JL.attn_forward(jl["cross"], JL.apply_norm(jl["ln_x"], j1, jcfg),
                                          jcfg, kv_override=jenc)
                p2 = p1 + L.attn_forward(pl["cross"], L.apply_norm(pl["ln_x"], p1, cfg), cfg,
                                         kv_override=_bf(jenc))
            _cmp(f"{step} layer {i} cross-attention add", j2, p2)
            pj2 = _bf(j2)
            ax = (lambda a: a[:, None]) if step else (lambda a: a)
            un = (lambda a: a[:, 0]) if step else (lambda a: a)
            jx = j2 + un(JL.mlp_forward(jl["mlp"], JL.apply_norm(jl["ln2"], ax(j2), jcfg), jcfg))
            _cmp(f"{step} layer {i} MLP add", jx,
                 pj2 + L.mlp_forward(pl["mlp"], L.apply_norm(pl["ln2"], pj2, cfg), cfg))

    jx = jnp.take(jp["embed"], jnp.asarray(prompts), axis=0).astype(bf) \
        + jp["dec_pos"][:24][None].astype(bf)
    _cmp("decoder input (+ dec_pos)", jx, B.embed(cfg, cp, T(prompts)))
    jc = None
    dec_layers(jx, 0, "")
    jl_, jc = jax.jit(lambda x, e: jm.prefill(jp, x, extras=e, max_seq=40))(
        jnp.asarray(prompts), jex)
    tok = np.asarray(jl_).argmax(-1).astype(np.int32)
    jx = jnp.take(jp["embed"], jnp.asarray(tok), axis=0).astype(bf) + jp["dec_pos"][24].astype(bf)
    _cmp("decode input (+ dec_pos)", jx, B.embed(cfg, cp, T(tok)[:, None], 24)[:, 0])
    dec_layers(jx, 24, "decode")
    pcj = {n: _bf(jc[n]) for n in jc}
    l2, _ = m.decode_step(cp, pcj, T(tok), 24)
    _cmp("decode step logits (reference cache)", jax.jit(jm.decode_step)(
        jp, jc, jnp.asarray(tok), jnp.asarray(24))[0], l2)

    def enc_jit(e):
        h = e.astype(bf) + jp["enc_pos"][None].astype(bf)

        def body(h, p):
            h = h + JL.attn_forward(p["attn"], JL.apply_norm(p["ln1"], h, jcfg), jcfg, causal=False)
            return h + JL.mlp_forward(p["mlp"], JL.apply_norm(p["ln2"], h, jcfg), jcfg), None

        return JL.apply_norm(jp["enc_final_norm"], jax.lax.scan(body, h, jp["enc_blocks"])[0],
                             jcfg)

    whole = jax.jit(enc_jit)(jex)
    _cmp("reference encoder: jit whole vs op by op", whole, jenc)
    _cmp("port's encoder vs the jitted reference's", whole, B.encode(cfg, cp, T(ex).bfloat16()))
    k0 = P._kv(B.layer_params(cp["blocks"], 0)["cross"], _bf(whole), cfg)[0]
    _cmp("xk[0] from the reference's encoder", jc["xk"][0], k0)


def ratio(seed: int) -> float:
    """The bf16 server rule's measured ratio at ``seed`` (its computation,
    without its assertions)."""
    jm, jp, m, server, prompts, jreqs, _ = servers(ARCH, "bfloat16", seed)
    want = np.array([r.generated for r in jreqs])
    jm32 = JModel(dataclasses.replace(jm.cfg, dtype="float32"))
    ex, smax = server_extras(m.cfg, 2), server.max_seq

    def forced(pf, dec, e):
        return np.concatenate([forced_logits(pf, dec, prompts[i:i + 2], want[i:i + 2], e)
                               for i in (0, 2)], axis=1)

    def jforced(model):
        pf = jax.jit(lambda x, e: model.prefill(jp, jnp.asarray(x), extras=e, max_seq=smax))
        st = jax.jit(model.decode_step)
        return forced(pf, lambda c, t, pos: st(jp, c, jnp.asarray(t), jnp.asarray(pos)),
                      jnp.asarray(ex, jnp.bfloat16))

    jb, j32 = jforced(jm), jforced(jm32)
    pb = forced(lambda x, e: m.prefill(server.params, T(x), extras=e, max_seq=smax),
                lambda c, t, pos: m.decode_step(server.params, c, T(t), pos),
                T(ex).bfloat16())
    v = m.cfg.vocab_size
    return float(np.abs(pb[..., :v] - jb[..., :v]).max() / np.abs(jb[..., :v] - j32[..., :v]).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ratios", type=int, default=0)
    ap.add_argument("--ratio-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ratio_only:
        print([round(ratio(s), 3) for s in range(args.ratios)])
        return
    probe(args.seed)
    for flags in ("", "--xla_allow_excess_precision=false") if args.ratios else ():
        env = dict(os.environ, XLA_FLAGS=flags)
        out = subprocess.run([sys.executable, __file__, "--ratio-only", "--ratios",
                              str(args.ratios)], env=env, capture_output=True, text=True,
                             check=True)
        print(f"rule ratios, XLA_FLAGS={flags!r}:", out.stdout.strip().splitlines()[-1])


if __name__ == "__main__":
    main()
