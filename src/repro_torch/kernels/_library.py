"""The port's kernels as PyTorch operators, ``torch.ops.repro_torch.<name>``.

Each public op of ``kernels/{sc_score,gather_rerank,kmeans_assign,
pairwise_l2}/ops.py`` checks its arguments in Python and then calls one
operator defined here, with an implementation per dispatch key:

* ``CPU``: the plain version (``ref.py``);
* ``CUDA``: the kernel launch (``kernel.py``), which builds its library on
  first use and raises on any CUDA error;
* ``Meta``: the output shapes and dtypes alone.  It touches neither
  :mod:`._build` nor ``torch.cuda``, so a program runs on fake tensors
  (``FakeTensorMode``) on any host, and an op trace sees each kernel as one
  operator.

Dispatch still goes by the tensor's device, now through the dispatcher.
Every implementation is a function of its ``ops.py`` that looks up the
plain version or the launch by name when it runs, so a test that
replaces one of them sees the replacement.  ``linear_attn`` (row 11) is
an operator too, reached from ``kernels/linear_attn/ops.py``'s launch; its
CPU implementation is the padded plain version that the op's CPU route
also calls directly.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["NAMESPACE", "define", "route"]

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, *, cpu: Callable, cuda: Callable, meta: Callable):
    """Define ``repro_torch::<schema>`` with its three implementations and
    return the operator's default overload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    for fn, key in ((cpu, "CPU"), (cuda, "CUDA"), (meta, "Meta")):
        _LIB.impl(name, fn, key)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def route(device: torch.device, what: str) -> None:
    """Raise unless ``device`` is the CPU or a card: an op has no other
    route (a ``meta`` tensor handed to a public op is an error, as before
    the ops were operators; fake tensors report the device they stand for)."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} route for device {device}")
