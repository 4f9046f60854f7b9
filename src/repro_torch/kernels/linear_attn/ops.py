"""Chunked gated linear attention: the ``(B, H, T, D)`` entry of the model's
forward pass and the ``(BH, T, D)`` entry of prefill, which also returns
the final state.  Each checks its arguments, then dispatches on the device
of the tensors it was given.

Every ``chunk >= 1`` is taken, as the JAX package takes it.  A CPU tensor
takes the plain version (:func:`.ref.linear_attn_chunked`, ``T`` padded to a
chunk multiple with ``w = 1``, ``k = q = v = 0``, which neither read nor
write the state); a CUDA tensor launches the kernel (:mod:`.kernel`, which
masks the ragged chunk itself and runs a chunk above 128 as sub-chunks of
128), and a failed build or launch raises.  Only the card refuses a ``dk``
whose tiles pass its shared memory.

Where the port differs from the JAX package: there,
``linear_attention_with_state`` always runs the chunked jnp version and
``linear_attention`` takes the Pallas kernel only on a TPU; here both launch
the kernel on the card.

Gradients.  The kernel has no backward, nor has the JAX package's: there
``jax.grad`` differentiates whatever ``linear_attention`` runs.  On the
card ``linear_attention`` goes through :class:`KernelLinearAttention`, whose
forward launches the kernel and whose backward recomputes the plain version
(:func:`.ref.linear_attn_chunked` with the same chunk, shift and padding)
under autograd and returns its gradients of ``q``, ``k``, ``v``, ``w`` and
the bonus.  On the CPU autograd differentiates the plain version directly.
``linear_attention_with_state`` (prefill) has no gradient path.

Sharded.  On ``DTensor`` arguments both entries run on each rank's own
rows, through ``local_map``, forward and backward alike: each rank launches
the kernel (or runs the plain version, on the CPU) on its rows and the
outputs come back as ``DTensor``s sharded the same way; a failed launch
raises, as unsharded.  The model's entry keeps ``(B, H, T, .)`` and takes
``batch`` x ``heads`` (the batch axes, the tensor axis): as many rows a
rank as the reference's ``batch_heads`` constraint of the merged ``BH``
dim over the whole mesh, with no rows traded (the merged row-major layout
would need an all-to-all).  The ``(BH, T, .)`` entry (prefill) constrains
the merged rows to ``batch_heads``.  Nothing is gathered whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import _library
from repro_torch.kernels._checks import check_tensor, same_device
from repro_torch.kernels.linear_attn import kernel
from repro_torch.kernels.linear_attn.ref import linear_attn_chunked, linear_attn_ref
from repro_torch.placements import constrain, is_dtensor

__all__ = ["linear_attention", "linear_attention_with_state", "linear_attn_ref",
           "linear_attn_chunked", "KernelLinearAttention"]

_MODES = {"rwkv": 1, "gla": 0, "ssd": 0}


def _check(qf, kf, vf, wf, u_b, chunk: int, shift: int) -> None:
    if qf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {qf.dtype}")
    bh, t, dk = check_tensor("q", qf, qf.dtype, 3)
    check_tensor("k", kf, qf.dtype, (bh, t, dk))
    check_tensor("w", wf, qf.dtype, (bh, t, dk))
    dv = check_tensor("v", vf, qf.dtype, 3)[2]
    check_tensor("v", vf, qf.dtype, (bh, t, dv))
    check_tensor("u", u_b, qf.dtype, (bh, 1, dk))
    if min(bh, dk, dv) < 1:
        raise ValueError(f"need BH, dk and dv >= 1, got {bh}/{dk}/{dv}")
    if chunk < 1 or int(chunk) != chunk:
        raise ValueError(f"chunk must be an int >= 1, got {chunk!r}")
    if shift not in (0, 1):
        raise ValueError(f"shift must be 0 or 1, got {shift}")
    same_device(qf, kf, vf, wf, u_b)


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _chunked_padded(qf, kf, vf, wf, u_b, chunk: int, shift: int):
    t = qf.shape[1]
    pad = _round_up(t, chunk) - t
    if pad:
        qf, kf, vf = (F.pad(a, (0, 0, 0, pad)) for a in (qf, kf, vf))
        wf = F.pad(wf, (0, 0, 0, pad), value=1.0)
    o, s = linear_attn_chunked(qf, kf, vf, wf, u_b, chunk=chunk, shift=shift)
    return o[:, :t], s


def _launch_cuda(qf, kf, vf, wf, u_b, chunk: int, shift: int):
    dk = qf.shape[2]
    if kernel.smem_bytes(kernel.chunk_tile(chunk), dk, 16) > kernel._SMEM_LIMIT:
        raise ValueError(f"dk={dk} needs more shared memory than a block of the card has")
    return kernel.linear_attn(qf, kf, vf, wf, u_b, chunk, shift)


def _meta(qf, kf, vf, wf, u_b, chunk: int, shift: int):
    bh, t, dk = qf.shape
    return (qf.new_empty((bh, t, vf.shape[2])),
            qf.new_empty((bh, dk, vf.shape[2]), dtype=torch.float32))


#: the kernel as an operator (``torch.ops.repro_torch.linear_attn``): CUDA
#: launches it, CPU runs the plain version, Meta gives the shapes (a fake
#: program, such as the LM dry-run's, sees it as one operator)
_OP = _library.define(
    "linear_attn(Tensor q, Tensor k, Tensor v, Tensor w, Tensor u, int chunk, int shift) "
    "-> (Tensor, Tensor)",
    cpu=lambda *a: _chunked_padded(*a), cuda=lambda *a: _launch_cuda(*a), meta=_meta)


def _launch(qf, kf, vf, wf, u_b, chunk: int, shift: int):
    return _OP(qf, kf, vf, wf, u_b, chunk, shift)


class KernelLinearAttention(torch.autograd.Function):
    """``o`` of the ``(BH, T, D)`` entry on the card: the CUDA kernel's
    forward; a backward that recomputes the plain version under autograd
    (a backward kernel is still to come)."""

    @staticmethod
    def forward(ctx, qf, kf, vf, wf, u_b, chunk: int, shift: int):
        ctx.save_for_backward(qf, kf, vf, wf, u_b)
        ctx.chunk, ctx.shift = chunk, shift
        return _launch(qf, kf, vf, wf, u_b, chunk, shift)[0]

    @staticmethod
    def backward(ctx, do):
        need = ctx.needs_input_grad[:5]
        args = [a.detach().requires_grad_(n) for a, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            o, _ = _chunked_padded(*args, ctx.chunk, ctx.shift)
        wanted = [a for a in args if a.requires_grad]
        got = iter(torch.autograd.grad(o, wanted, do, allow_unused=True, materialize_grads=True)
                   if wanted else ())
        return (*(next(got) if a.requires_grad else None for a in args), None, None)


def linear_attention_with_state(
    qf: torch.Tensor,  # (BH, T, dk)
    kf: torch.Tensor,
    vf: torch.Tensor,  # (BH, T, dv)
    wf: torch.Tensor,  # (BH, T, dk) decay in (0, 1]
    u_b: torch.Tensor,  # (BH, 1, dk)
    *,
    chunk: int = 64,
    shift: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o (BH, T, dv) in q's dtype, final state (BH, dk, dv) f32)``; all
    five inputs contiguous, one dtype (float32 or bfloat16)."""
    if is_dtensor(qf):
        return _on_local_slices(linear_attention_with_state, (qf, kf, vf, wf, u_b), 2,
                                chunk=chunk, shift=shift)
    _check(qf, kf, vf, wf, u_b, chunk, shift)
    if qf.device.type == "cpu":
        return _chunked_padded(qf, kf, vf, wf, u_b, chunk, shift)
    if qf.device.type in ("cuda", "meta"):  # meta: the operator's shapes (a dry-run)
        return _launch(qf, kf, vf, wf, u_b, chunk, shift)
    raise ValueError(f"no linear_attention route for device {qf.device}")


def linear_attention(
    q: torch.Tensor,  # (B, H, T, dk)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, H, T, dv)
    w: torch.Tensor,  # (B, H, T, dk)
    u: torch.Tensor | None = None,  # (H, dk) bonus, rwkv mode only
    *,
    chunk: int = 64,
    mode: str = "rwkv",  # "rwkv" (exclusive + bonus) | "gla" | "ssd"
) -> torch.Tensor:
    """``(B, H, T, dv)`` outputs of the recurrence in ``mode``,
    differentiable on both devices (see the module's note on gradients)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {tuple(_MODES)}, got {mode!r}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, dk), got shape {tuple(q.shape)}")
    if is_dtensor(q):
        return _sharded_heads(q, k, v, w, u, chunk=chunk, shift=_MODES[mode])
    return _heads_attention(q, k, v, w, u, chunk=chunk, shift=_MODES[mode])


def _heads_attention(q, k, v, w, u, *, chunk: int, shift: int) -> torch.Tensor:
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    if u is None:
        u = torch.zeros((h, dk), dtype=q.dtype, device=q.device)
    u_b = u[None].expand(b, h, dk).reshape(b * h, 1, dk).contiguous()

    def flat(a):
        return a.reshape(b * h, t, a.shape[-1]).contiguous()

    o = _flat_attention(flat(q), flat(k), flat(v), flat(w), u_b, chunk=chunk, shift=shift)
    return o.reshape(b, h, t, dv)


def _sharded_heads(q, k, v, w, u, *, chunk: int, shift: int) -> torch.Tensor:
    """:func:`linear_attention` on ``DTensor``s: q / k / v / w constrained
    to ``batch`` x ``heads`` (the batch axes, the tensor axis), every other
    dim whole, and each rank's ``(B, H)`` rows run through the kernel (its
    plain version on the CPU) by ``local_map``, the bonus sliced to the
    rank's heads."""
    rows = [constrain(a, "batch", "heads", None, None) for a in (q, k, v, w)]
    mesh = rows[0].device_mesh
    keep = [p if p in (Shard(0), Shard(1)) else Replicate() for p in rows[0].placements]
    if u is None:
        u = torch.zeros((q.shape[1], q.shape[3]), dtype=q.dtype, device=q.to_local().device)
    if not is_dtensor(u):
        u = DTensor.from_local(u, mesh, [Replicate()] * mesh.ndim, run_check=False)
    u_keep = [Shard(0) if p == Shard(1) else Replicate() for p in keep]
    # the bonus's gradient on a rank sums its own batch rows: a partial sum
    # over the batch shards
    u_grad = [Partial() if p == Shard(0) else up for p, up in zip(keep, u_keep)]
    run = local_map(lambda *a: (_heads_attention(*a, chunk=chunk, shift=shift),),
                    out_placements=(tuple(keep),), in_placements=(keep,) * 4 + (u_keep,),
                    in_grad_placements=(keep,) * 4 + (u_grad,), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(*rows, u)[0]


def _flat_attention(qf, kf, vf, wf, u_b, *, chunk: int, shift: int) -> torch.Tensor:
    if qf.device.type in ("cuda", "meta"):  # meta: the operator's shapes (a dry-run)
        _check(qf, kf, vf, wf, u_b, chunk, shift)
        return KernelLinearAttention.apply(qf, kf, vf, wf, u_b, chunk, shift)
    return linear_attention_with_state(qf, kf, vf, wf, u_b, chunk=chunk, shift=shift)[0]


def _on_local_slices(fn, args, n_out: int, **kw):
    """``fn`` on each rank's share of ``DTensor`` arguments ``(BH, T, .)``:
    the merged batch * heads dim spread over the whole mesh (the reference's
    ``batch_heads`` constraint), each rank running the kernel (or its plain
    version on the CPU) on its rows, which the recurrence keeps apart; the
    outputs ``(BH, ...)`` come back sharded the same way.  Nothing is
    gathered onto one rank."""
    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    args = [a if is_dtensor(a) else  # a plain tensor the op made itself (u = 0): replicated
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            for a in args]
    args = [constrain(a.contiguous(), "batch_heads", None, None) for a in args]
    rows = tuple(args[0].placements)

    def run(*local):
        out = fn(*(a.contiguous() for a in local), **kw)
        return out if isinstance(out, tuple) else (out,)

    return local_map(run, out_placements=(rows,) * n_out, in_placements=(rows,) * len(args),
                     device_mesh=args[0].device_mesh, redistribute_inputs=True)(*args)
