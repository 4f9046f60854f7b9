#!/usr/bin/env python3
"""Time the linear-attention op (row 11 of the kernel table) on the card at
the shapes its paths give it, and the RWKV6 prefill batch that launches it.

    python3 tools/time_linear_attn.py [--src DIR] [--label NAME] [--seed S]
                                      [--prefill] [--errors]

The options are the card timers' (``tools/_ab.py``): ``--src`` times another
checkout's ``src``, so one command can time two checkouts in turns (parent,
change, change, parent), each in its own process.  The inputs are
``chip_smoke.py``'s (``linear_attn_inputs``), drawn on the card from
``--seed``:

* ``rwkv6_prefill``: 256 heads (8 slots x 32), 2,048 tokens, 64 x 64, bf16,
  shift 1, chunk 64 (the shape ``lm_serve`` launches 24 times a batch);
* ``zamba2_ssd``: the same heads and tokens, 64 x 128, shift 0.

Per shape: every reading (the mean ms of ``REPS`` launches by CUDA events,
after warm-up) and their median, and whether two launches gave equal bits.
With ``--prefill``, also RWKV6-1.6B's ``prefill`` of 8 prompts of 2,048
tokens (weights drawn on the card from the seed), ``WALL_REPS`` readings on
the host clock ending in a synchronise.  With ``--errors``, the fp64
witness of fp32 inputs at the model's decays (16 heads, 64 x 64, shift 1):
the kernel's and the plain version's largest error in ``o`` and in the
final state against an fp64 scan of two heads, at chunks 8 to 128 over
1,000 tokens and at chunk 8 over 125 to 2,000 tokens, so that the error
can be read against the size of a chunk and the number of state updates.
Prints the tree's ``-Xptxas -v`` lines for ``csrc/linear_attn.cu`` and one
JSON line with ``nvidia-smi``'s name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys

import _ab

REPS = 20  # launches a reading
READINGS = 5  # readings a shape
WALL_REPS = 5  # prefill batches timed on the host clock
ERROR_CASES = ([(chunk, 1000) for chunk in (8, 16, 32, 64, 128)]
               + [(8, t) for t in (125, 250, 500, 2000)])  # (chunk, tokens)


def witness(chip_smoke, g, chunk: int, t: int) -> dict:
    """Both versions' largest error against an fp64 scan of two heads."""
    import torch

    from repro_torch.kernels.linear_attn import ops
    from repro_torch.kernels.linear_attn.ref import linear_attn_chunked

    args = chip_smoke.linear_attn_inputs(g, "rwkv", torch.float32, 16, t)
    o, st = ops.linear_attention_with_state(*args, chunk=chunk, shift=1)
    po, ps = linear_attn_chunked(*chip_smoke.linear_attn_padded(args, chunk), chunk=chunk, shift=1)
    o64, s64 = chip_smoke._scan_fp64(*(a[:2] for a in args), shift=1)

    def err(x, ref):
        return float((x[:2].double() - ref).abs().max())

    return dict(chunk=chunk, t=t, state_updates=-(-t // chunk),
                kernel_o=err(o, o64), plain_o=err(po[:, :t], o64),
                kernel_state=err(st, s64), plain_state=err(ps, s64),
                max_abs_state=float(s64.abs().max()))


def main() -> int:
    args, chip_smoke, out = _ab.start(__doc__, "time_linear_attn", {
        "--prefill": "also time RWKV6-1.6B's prefill of 8 x 2,048 tokens",
        "--errors": "also measure the fp64 witness against chunk and length"})
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.linear_attn import ops

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(args.seed + 20)
    shapes = {"rwkv6_prefill": ("rwkv", 1), "zamba2_ssd": ("ssd", 0)}
    out["shapes"] = {}
    for name, (kind, shift) in shapes.items():
        qkvwu = chip_smoke.linear_attn_inputs(g, kind, torch.bfloat16, 256, 2048)

        def call():
            return ops.linear_attention_with_state(*qkvwu, chunk=64, shift=shift)

        first, second = call(), call()
        out["shapes"][name] = dict(
            _ab.readings(chip_smoke, call, REPS, READINGS),
            equal_bits=all(torch.equal(a, b) for a, b in zip(first, second)))
        del qkvwu, first, second
    out["ptxas"] = _build.ptxas_report("linear_attn")
    if args.prefill:
        from repro_torch.configs import get_config
        from repro_torch.models import Model

        cfg = get_config("rwkv6-1.6b")
        model = Model(cfg)
        params = model.compute_params(model.init(torch.Generator(dev).manual_seed(args.seed)))
        toks = torch.randint(0, cfg.vocab_size, (8, 2048), device=dev,
                             generator=torch.Generator(dev).manual_seed(args.seed + 1))
        model.prefill(params, toks)  # first use: cuBLAS handles
        out["prefill_s"] = _ab.wall(lambda: model.prefill(params, toks), WALL_REPS)
    if args.errors:
        out["fp64_witness"] = [witness(chip_smoke, g, chunk, t) for chunk, t in ERROR_CASES]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
