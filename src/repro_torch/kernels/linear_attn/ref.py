"""Plain PyTorch versions of chunked gated linear attention (RWKV6 / GLA /
Mamba2-SSD): the token-by-token scan oracle and the chunked log-space form,
the counterparts of ``repro.kernels.linear_attn.ref``.

Recurrence per head, state ``S: (dk, dv)``:

    shift = 1 ("rwkv", bonus u):  o_t = q_t S_{t-1} + (q_t . (u * k_t)) v_t
                                  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    shift = 0 ("gla" / "ssd"):    S_t = diag(w_t) S_{t-1} + k_t v_t^T
                                  o_t = q_t S_t

:func:`linear_attn_chunked` is the CPU path of the ops and what the CUDA
kernel (``csrc/linear_attn.cu``) is held against on the card.  Both compute
in fp32 and return ``o`` in the inputs' dtype and the final state in fp32.
"""

from __future__ import annotations

import torch

from repro_torch.placements import constrain

__all__ = ["linear_attn_ref", "linear_attn_chunked"]

_EPS = 1e-6


def linear_attn_ref(
    q: torch.Tensor,  # (BH, T, dk)
    k: torch.Tensor,  # (BH, T, dk)
    v: torch.Tensor,  # (BH, T, dv)
    w: torch.Tensor,  # (BH, T, dk) decay in (0, 1]
    u: torch.Tensor,  # (BH, 1, dk) bonus
    *,
    shift: int = 1,
    initial_state: torch.Tensor | None = None,  # (BH, dk, dv)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token recurrence -> ``(o (BH, T, dv), final state (BH, dk,
    dv) f32)``; fp32 math."""
    bh, t, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf = (a.float() for a in (q, k, v))
    wf = torch.clamp(w.float(), _EPS, 1.0)
    uf = u.float().reshape(bh, dk)
    s = (torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    outs = []
    for i in range(t):
        qt, kt, vt, wt = qf[:, i], kf[:, i], vf[:, i], wf[:, i]
        kv = kt[:, :, None] * vt[:, None, :]
        if shift:
            o = torch.einsum("bk,bkv->bv", qt, s) + (qt * uf * kt).sum(1, keepdim=True) * vt
            s = wt[:, :, None] * s + kv
        else:
            s = wt[:, :, None] * s + kv
            o = torch.einsum("bk,bkv->bv", qt, s)
        outs.append(o)
    o = torch.stack(outs, dim=1) if outs else qf.new_zeros((bh, 0, dv))
    return o.to(q.dtype), s


def linear_attn_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    chunk: int = 64,
    shift: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk-parallel form of the recurrence (shapes as
    :func:`linear_attn_ref`; ``T`` a multiple of ``chunk``, which the ops
    pad).  With ``lb = cumsum(log w)`` inside a chunk and ``lbq`` it shifted
    down by ``shift`` rows:

        inter:  o_t += (q_t * exp(lbq_t)) @ S_chunk_start
        intra:  A[t, j] = sum_k q_tk k_jk exp(lbq_tk - lb_jk),  j <= t - shift
                o_t += A[t, :] @ v
        bonus:  o_t += (q_t . (u * k_t)) v_t                    (shift = 1)
        state:  S <- diag(exp(lb_C)) S + (k * exp(lb_C - lb))^T @ v

    Every exponent kept is a difference of monotone log-decays, so <= 0:
    nothing overflows however small the decay.  Only a ``(BH, C, C, dk)``
    decay tensor of one chunk is live at a time."""
    bh, t, dk = q.shape
    dv = v.shape[-1]
    if t % chunk:
        raise ValueError(f"pad T={t} to a multiple of chunk={chunk}")
    nc, c = t // chunk, chunk
    # shard the merged batch * heads dim over the whole mesh (the identity
    # outside a sharding context or on plain tensors)
    q, k, v, w = (constrain(a, "batch_heads", None, None) for a in (q, k, v, w))
    qf = q.float().reshape(bh, nc, c, dk)
    kf = k.float().reshape(bh, nc, c, dk)
    vf = v.float().reshape(bh, nc, c, dv)
    wf = torch.clamp(w.float(), _EPS, 1.0).reshape(bh, nc, c, dk)
    uf = u.float().reshape(bh, 1, -1)
    ids = torch.arange(c, device=q.device)
    mask = ids[None, :] <= ids[:, None] - shift  # (t, j)
    s = torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
    outs = []
    for i in range(nc):
        qb, kb, vb, wb = qf[:, i], kf[:, i], vf[:, i], wf[:, i]
        lb = torch.cumsum(torch.log(wb), dim=1)  # (bh, c, dk), inclusive
        lbq = torch.cat([torch.zeros_like(lb[:, :1]), lb[:, :-1]], dim=1) if shift else lb
        o = torch.einsum("bck,bkv->bcv", qb * torch.exp(lbq), s)
        decay = torch.exp(lbq[:, :, None, :] - lb[:, None, :, :])  # (bh, c, c, dk)
        # products and a sum over dk, not a 3-operand einsum: autograd of that
        # einsum runs as bmm of 1 x dk by dk x 1 on the card, 10x slower
        a = (qb[:, :, None, :] * kb[:, None, :, :] * decay).sum(-1)
        a = torch.where(mask, a, 0.0)
        o = o + torch.einsum("btj,bjv->btv", a, vb)
        if shift:
            o = o + (qb * uf * kb).sum(-1, keepdim=True) * vb
        dec_out = torch.exp(lb[:, -1:, :] - lb)  # (bh, c, dk), exponent <= 0
        s = torch.exp(lb[:, -1])[:, :, None] * s + torch.einsum("bck,bcv->bkv", kb * dec_out, vb)
        outs.append(o)
    o = torch.stack(outs, dim=1).reshape(bh, t, dv)
    return o.to(q.dtype), s
