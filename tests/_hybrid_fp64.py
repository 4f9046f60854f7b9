"""A float64 evaluation of the port's hybrid (Zamba2) forward pass, and a
bound on an fp32 evaluation's distance from it, for tests that hold fp32
forwards on two devices (no JAX: the card tests import this).

Reduced Zamba2's fp32 forward is ill-conditioned at some positions of the
card test's input: each layer rounds by a few 1e-6 (as the layer in float64
from the same input shows), and the layers after it grow that ~100x, so two
fp32 evaluations of the same weights (the CPU's and the card's, whose sums
run in other orders) lie up to ~7e-4 apart, each ~3-4e-4 from the float64
value.  :func:`fp64_bound` gives each output value a bound derived from
float64 and from the CPU alone, so that a fault on another device cannot
widen the bound it is held to:

* each layer's own rounding at each value, ``delta``: the fp32 layer on
  the CPU against the layer in float64, from the same fp32 input (the
  CPU's chain's);
* a first-order propagation: the float64 model run again with ``2 *
  |delta|`` added to every layer's output at every value, each with an
  independent random sign, ``draws`` times; the output's spread ``sigma``
  per value (its root mean square deviation);
* the bound ``lam * sigma`` (``lam = 6``).

The model is the probabilistic one of rounding-error analysis (Higham and
Mary): the fp32 chain's error is, to first order, ``sum_j J_j e_j`` over
the layers' rounding errors ``e_j``, taken as independent and of either
sign; a sum of independent terms of magnitude at most ``b_j`` passes ``lam``
times its standard deviation ``sqrt(sum J_j^2 b_j^2)`` with probability
at most ``2 exp(-lam^2 / 2)`` (Hoeffding), 3e-8 a value at ``lam = 6``.
The factor 2 on ``delta`` covers a device that rounds up to twice as much
as the CPU; :func:`device_faults` checks that a device does, layer by
layer (its largest local rounding at most ``2x`` the CPU's), besides
holding its forward to the bound.
"""

from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import torch

from repro_torch.configs import reduced_config
from repro_torch.models import Model
from repro_torch.models import backbone as B
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


def inputs():
    """The card test's config (reduced Zamba2 in fp32: 8 Mamba2 layers, the
    shared block after layers 2 and 5), weights (seed 4, on the CPU) and 2 x
    70 tokens (seed 34)."""
    cfg = dataclasses.replace(reduced_config("zamba2-1.2b"), dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(4))
    toks = torch.randint(0, cfg.vocab_size, (2, 70), generator=torch.Generator().manual_seed(34))
    return cfg, params, toks


def tree(params, fn):
    return {k: tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in params.items()}


def scan_fp64(q, k, v, w):
    """Row 11's recurrence in SSD mode (shift 0), token by token in fp64:
    ``S_t = diag(w_t) S_{t-1} + k_t v_t^T``, ``o_t = q_t S_t``."""
    q, k, v = (a.double() for a in (q, k, v))
    w = w.double().clamp(1e-6, 1.0)
    s = q.new_zeros(q.shape[0], q.shape[2], v.shape[2])
    outs = []
    for i in range(q.shape[1]):
        s = w[:, i, :, None] * s + k[:, i, :, None] * v[:, i, None, :]
        outs.append(torch.einsum("bk,bkv->bv", q[:, i], s))
    return torch.stack(outs, 1)


def ssd_fp64(q, k, v, w, u=None, *, chunk=64, mode="ssd"):
    """``linear_attention``'s ``(B, H, T, D)`` entry in SSD mode, in fp64."""
    b, h, t, _ = q.shape
    flat = [a.reshape(b * h, t, a.shape[-1]) for a in (q, k, v, w)]
    return scan_fp64(*flat).reshape(b, h, t, -1)


@contextlib.contextmanager
def fp64_mode():
    """The port's model code in float64: ``Tensor.float`` is ``double`` and
    row 11 the fp64 scan (the kernel ops take fp32 / bf16 only)."""
    with mock.patch.object(torch.Tensor, "float", torch.Tensor.double), \
            mock.patch.object(S, "linear_attention", ssd_fp64):
        yield


def layer_fns(cfg, params):
    """``[(name, fn(x))]``: each Mamba2 layer's residual step and, after
    every ``hybrid_period`` of them, the shared block, in order (what
    ``backbone.forward_hidden`` runs between the embedding and the final
    norm)."""
    out = []
    for i in range(cfg.n_layers):
        p = B.layer_params(params["blocks"], i)
        out.append((f"mamba{i}", lambda x, p=p: x + S.mamba2_forward(
            p["mamba"], L.apply_norm(p["ln1"], x, cfg), cfg)))
        if B.shared_application(cfg, i) is not None:
            out.append((f"shared{i}", lambda x: B._dense_block_fwd(params["shared"], x, cfg,
                                                                   None)))
    return out


def fp64_forward(cfg, params, toks, noise=None, generator=None):
    """``forward_hidden`` of the same weights in float64 on the CPU; with
    ``noise`` (one tensor a layer), each layer's output moved by it at
    random signs drawn from ``generator``."""
    c64 = dataclasses.replace(cfg, dtype="float64")
    p64 = tree(params, lambda a: a.cpu().double())
    with fp64_mode():
        x = B.embed(c64, p64, toks.cpu())
        for i, (_, f) in enumerate(layer_fns(c64, p64)):
            x = f(x)
            if noise is not None:
                sign = torch.randint(0, 2, x.shape, generator=generator, dtype=torch.float64)
                x = x + noise[i] * (2 * sign - 1)
        return L.apply_norm(p64["final_norm"], x, c64)


def chain_inputs(cfg, params, toks) -> list[torch.Tensor]:
    """The CPU's fp32 chain: each layer's input (of :func:`layer_fns`)."""
    x = B.embed(cfg, params, toks)
    out = []
    for _, f in layer_fns(cfg, params):
        out.append(x)
        x = f(x)
    return out


def local_errors(cfg, params, inputs, device) -> list[torch.Tensor]:
    """Each layer's own rounding on ``device``: the fp32 layer there against
    the layer in float64, both from ``inputs`` (:func:`chain_inputs`)."""
    c64 = dataclasses.replace(cfg, dtype="float64")
    p64 = tree(params, lambda a: a.double())
    on_dev = tree(params, lambda a: a.to(device))
    out = []
    with fp64_mode():
        fns64 = layer_fns(c64, p64)
    for x, (_, f_dev), (_, f64) in zip(inputs, layer_fns(cfg, on_dev), fns64):
        y = f_dev(x.to(device)).cpu().double()
        with fp64_mode():
            out.append((y - f64(x.double())).abs())
    return out


def fp64_bound(cfg, params, toks, local=None, draws: int = 64, lam: float = 6.0,
               seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(the float64 forward, the bound)`` (see the module's note) from the
    CPU's per-layer rounding ``local`` (:func:`local_errors` on the CPU
    unless given)."""
    if local is None:
        local = local_errors(cfg, params, chain_inputs(cfg, params, toks), torch.device("cpu"))
    noise = [2 * e for e in local]
    y64 = fp64_forward(cfg, params, toks)
    gen = torch.Generator().manual_seed(seed)
    spread = torch.stack([fp64_forward(cfg, params, toks, noise, gen) - y64
                          for _ in range(draws)])
    return y64, lam * spread.pow(2).mean(0).sqrt()


@dataclasses.dataclass(frozen=True)
class Reference:
    """What a device is held to, all from the CPU: its chain's layer
    inputs, each layer's own rounding there (``local``), the float64
    forward and its bound."""

    inputs: list[torch.Tensor]
    local: list[torch.Tensor]
    y64: torch.Tensor
    bound: torch.Tensor


def cpu_reference(cfg, params, toks) -> Reference:
    inputs = chain_inputs(cfg, params, toks)
    local = local_errors(cfg, params, inputs, torch.device("cpu"))
    return Reference(inputs, local, *fp64_bound(cfg, params, toks, local))


def device_faults(cfg, params, toks, device, ref: Reference, ratio: float = 2.0) -> list[str]:
    """What fails when the fp32 forward on ``device`` (the CPU's weights
    moved there) is held to ``ref``, an empty list when nothing does: a
    layer whose largest local rounding there exceeds ``ratio`` times the
    CPU's, and ``forward_hidden``'s values past the bound.  It runs the
    model on ``device`` only: each Mamba2 layer once from ``ref.inputs``,
    then the forward."""
    device = torch.device(device)
    names = [name for name, _ in layer_fns(cfg, params)]
    out = [f"{name}: local rounding {float(d.max()):.3g} > {ratio} x the CPU's "
           f"{float(c.max()):.3g}"
           for name, c, d in zip(names, ref.local,
                                 local_errors(cfg, params, ref.inputs, device))
           if d.max() > ratio * c.max()]
    on_dev = tree(params, lambda a: a.to(device))
    err = (B.forward_hidden(cfg, on_dev, toks.to(device)).cpu().double() - ref.y64).abs()
    past = err > ref.bound
    if past.any():
        out.append(f"forward: {int(past.sum())} values past the bound, largest "
                   f"{float((err / ref.bound).max()):.3g} x it")
    return out


def planted_fault(linear_attention, cfg, heads: str, calls, layer: int = 3,
                  scale: float = 1 + 1e-4):
    """``linear_attention`` with a fault planted, for the checks' own
    tests: in every ``layer``-th of each ``cfg.n_layers`` calls (layer
    ``layer`` of a pass over the Mamba2 layers, ``calls`` an
    ``itertools.count``), the output of ``heads`` ("all", or "one": head 0)
    scaled by ``scale``."""
    def faulty(*args, **kwargs):
        out = linear_attention(*args, **kwargs)
        if next(calls) % cfg.n_layers == layer:
            out = out.clone()
            out[(slice(None),) if heads == "all" else (slice(None), 0)] *= scale
        return out
    return faulty
