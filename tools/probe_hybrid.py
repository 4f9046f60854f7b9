#!/usr/bin/env python3
"""Probe of reduced Zamba2's fp32 forward pass on the card against the CPU
and against a float64 evaluation of the same weights, on the inputs of
``tests/test_torch_cuda.py::test_hybrid_model_on_the_card_equals_the_cpu``
(8 Mamba2 layers, the shared block after layers 2 and 5, weights from seed
4, 2 x 70 tokens from seed 34).

    PYTHONPATH=src python3 tools/probe_hybrid.py [--device cuda]

Prints one JSON object:

* ``forward``: ``backbone.forward_hidden`` on the device against the CPU,
  and each against the float64 evaluation: the largest distance, where, the
  value there, and how many values lie past the test's ``rtol=1e-3,
  atol=2e-4``;
* ``forward_vs_prefill``: on each device, ``forward_hidden`` against the
  prefill's own hidden states (``prefill._hybrid_prefill``, the final norm
  applied): the two launch row 11 on the same inputs;
* ``chain``: after each layer, each device's own chain against the float64
  chain (the error a layer passes on);
* ``layers``: each layer run from the CPU's fp32 input of that layer, on
  the device and on the CPU, against the layer in float64 from the same
  input (the error a layer adds alone);
* ``ssd``: row 11 in SSD mode at T = 70 (a ragged chunk of 6) on each
  layer's exact inputs (the CPU's): the device's launch and the CPU's plain
  version against an fp64 scan, the outputs' scale, and whether two
  launches give equal bits;
* ``bound``: ``tests/_hybrid_fp64.py``'s float64-derived bound (the
  CPU's per-layer rounding alone), each device's largest distance from the
  float64 value over it, and what ``device_faults`` finds on the device.

The float64 evaluation is the port's own model code with ``Tensor.float``
taken as ``Tensor.double``, the weights in float64 and row 11 as the
token-by-token scan in float64 (``tests/_hybrid_fp64.py``).  ``--device
cpu`` runs the CPU against itself (a rehearsal).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from _hybrid_fp64 import (  # noqa: E402
    cpu_reference, device_faults, fp64_forward, fp64_mode, inputs, layer_fns, ssd_fp64, tree)

from repro_torch.models import backbone as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import prefill as P  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

RTOL, ATOL = 1e-3, 2e-4


def dist(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    d = (got - want).abs()
    at = [int(i) for i in torch.unravel_index(d.argmax(), d.shape)]
    return dict(max=float(d.max()), at=at, value=float(want[tuple(at)]),
                past_test_tol=int((d > ATOL + RTOL * want.abs()).sum()), n=d.numel())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, toks = inputs()
    card = tree(params, lambda a: a.to(dev))
    c64 = dataclasses.replace(cfg, dtype="float64")
    p64 = tree(params, lambda a: a.double())
    out: dict = dict(device=str(dev))
    if dev.type == "cuda":
        import subprocess
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()

    hc = B.forward_hidden(cfg, card, toks.to(dev))
    hp = B.forward_hidden(cfg, params, toks)
    h64 = fp64_forward(cfg, params, toks)
    out["forward"] = dict(device_vs_cpu=dist(hc, hp), device_vs_fp64=dist(hc, h64),
                          cpu_vs_fp64=dist(hp, h64))

    def prefill_hidden(prm, tk):
        x, _ = P._hybrid_prefill(cfg, prm, B.embed(cfg, prm, tk), 73, torch.float32)
        return L.apply_norm(prm["final_norm"], x, cfg)

    out["forward_vs_prefill"] = dict(
        device=dist(hc, prefill_hidden(card, toks.to(dev))),
        cpu=dist(hp, prefill_hidden(params, toks)))

    # each device's own chain, and each layer alone from the CPU's input
    xc, xp = B.embed(cfg, card, toks.to(dev)), B.embed(cfg, params, toks)
    with fp64_mode():
        x64 = B.embed(c64, p64, toks)
    chain, alone = [], []
    fns_c, fns_p = layer_fns(cfg, card), layer_fns(cfg, params)
    with fp64_mode():
        fns_64 = layer_fns(c64, p64)
    for (name, fc), (_, fp), (_, f64) in zip(fns_c, fns_p, fns_64):
        yc, yp = fc(xp.to(dev)), fp(xp)
        with fp64_mode():
            y64 = f64(xp.double())
        alone.append(dict(layer=name, device=dist(yc, y64)["max"], cpu=dist(yp, y64)["max"],
                          device_vs_cpu=dist(yc, yp)["max"], scale=float(y64.abs().max())))
        xc, xp = fc(xc), fp(xp)
        with fp64_mode():
            x64 = f64(x64)
        chain.append(dict(layer=name, device=dist(xc, x64)["max"], cpu=dist(xp, x64)["max"],
                          scale=float(x64.abs().max())))
    out["chain"], out["layers"] = chain, alone

    # row 11 on each layer's exact inputs (the CPU's), SSD mode, T = 70
    from repro_torch.kernels.linear_attn import ops as la_ops

    ssd, xp = [], B.embed(cfg, params, toks)
    for name, fp in fns_p:
        if name.startswith("mamba"):
            p = B.layer_params(params["blocks"], int(name[5:]))["mamba"]
            xin, _, bmat, cmat, dt = S._in_proj(p, L.apply_norm(
                B.layer_params(params["blocks"], int(name[5:]))["ln1"], xp, cfg), cfg)
            xconv, _ = S._causal_conv(p, xin, cfg)
            q, k, v, w = S._ssd_inputs(p, xconv, bmat, cmat, dt, cfg)
            want = ssd_fp64(q, k, v, w)
            got_p = la_ops.linear_attention(q, k, v, w, mode="ssd")
            qd, kd, vd, wd = (a.to(dev) for a in (q, k, v, w))
            got_c = la_ops.linear_attention(qd, kd, vd, wd, mode="ssd")
            again = la_ops.linear_attention(qd, kd, vd, wd, mode="ssd")
            ssd.append(dict(layer=name, shape=list(q.shape), device=dist(got_c, want)["max"],
                            cpu=dist(got_p, want)["max"], scale=float(want.abs().max()),
                            equal_bits=bool(torch.equal(got_c, again))))
        xp = fp(xp)
    out["ssd"] = ssd
    ref = cpu_reference(cfg, params, toks)
    out["bound"] = dict(max=float(ref.bound.max()), min=float(ref.bound.min()),
                        device_over_bound=float(((hc.cpu().double() - h64).abs()
                                                 / ref.bound).max()),
                        cpu_over_bound=float(((hp.double() - h64).abs() / ref.bound).max()),
                        device_faults=device_faults(cfg, params, toks, dev, ref))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
