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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._checks import check_tensor, same_device
from repro_torch.kernels.linear_attn import kernel
from repro_torch.kernels.linear_attn.ref import linear_attn_chunked, linear_attn_ref

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


def _launch(qf, kf, vf, wf, u_b, chunk: int, shift: int):
    dk = qf.shape[2]
    if kernel.smem_bytes(kernel.chunk_tile(chunk), dk, 16) > kernel._SMEM_LIMIT:
        raise ValueError(f"dk={dk} needs more shared memory than a block of the card has")
    return kernel.linear_attn(qf, kf, vf, wf, u_b, chunk, shift)


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
    _check(qf, kf, vf, wf, u_b, chunk, shift)
    if qf.device.type == "cpu":
        return _chunked_padded(qf, kf, vf, wf, u_b, chunk, shift)
    if qf.device.type == "cuda":
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
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    if u is None:
        u = torch.zeros((h, dk), dtype=q.dtype, device=q.device)
    u_b = u[None].expand(b, h, dk).reshape(b * h, 1, dk).contiguous()

    def flat(a):
        return a.reshape(b * h, t, a.shape[-1]).contiguous()

    args = (flat(q), flat(k), flat(v), flat(w), u_b)
    if q.device.type == "cuda":
        _check(*args, chunk, _MODES[mode])
        o = KernelLinearAttention.apply(*args, chunk, _MODES[mode])
    else:
        o, _ = linear_attention_with_state(*args, chunk=chunk, shift=_MODES[mode])
    return o.reshape(b, h, t, dv)
