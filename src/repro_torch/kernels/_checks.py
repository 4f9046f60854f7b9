"""Argument checks shared by the op wrappers: every one runs before a
wrapper dispatches, on the CPU as on the card, so a kernel never sees a
tensor it does not take."""

from __future__ import annotations

import torch


def check_tensor(
    name: str,
    t: torch.Tensor,
    dtype: torch.dtype,
    shape: int | tuple[int, ...],
    *,
    rows_only: bool = False,
) -> tuple[int, ...]:
    """Raise unless ``t`` is a tensor of ``dtype`` with ``shape`` (or, for an
    int, that many dims) laid out contiguously — or, with ``rows_only``, with
    contiguous rows (unit last stride).  Returns the shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    got = t.shape  # a torch.Size, itself a tuple
    if isinstance(shape, int):
        if len(got) != shape:
            raise ValueError(f"{name} must have {shape} dims, got shape {tuple(got)}")
    elif got != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(got)}")
    if rows_only:
        if got[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name} must have contiguous rows (unit last stride)")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return got


def same_device(*tensors: torch.Tensor | None) -> torch.device:
    """Raise unless every given tensor lies on one device; returns it."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors must share one device, got {sorted(map(str, devs))}")
    return devs.pop()
