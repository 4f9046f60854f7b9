"""Serving driver: batched prefill + greedy decode over fixed slots (the
counterpart of ``repro.launch.serve``).

On the card, Gemma2-9B (or ``--arch rwkv6-1.6b``) at full width:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --no-reduced \
      --requests 16 --slots 8 --prompt-len 2048 --gen-len 32
On the CPU, the reduced config of the default arch, granite-3-2b:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced

``--reduced`` is a ``BooleanOptionalAction`` with the reference's default
(``True``), so ``--no-reduced`` serves the full width; the reference's
``store_true`` flag with ``default=True`` cannot turn it off.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.models import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Fixed-slot batching: up to ``n_slots`` requests share one prefill and
    decode in lockstep; the next ones wait for the batch to finish.

    ``params`` may be the fp32 master tree: the server keeps
    ``model.compute_params(params)``.  ``timings`` records, per batch, the
    host seconds of the prefill and of each decode step, each ending when
    its greedy tokens reach the host (which waits for the device)."""

    def __init__(self, model: Model, params, n_slots: int, max_seq: int):
        self.model = model
        self.params = model.compute_params(params)
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.timings: list[dict] = []

    def run(self, requests: list[Request], gen_len: int) -> list[Request]:
        queue = list(requests)
        if any(len(r.prompt) != len(queue[0].prompt) for r in queue):
            raise ValueError("every prompt of a run must have the same length")
        device = self.params["embed"].device
        out: list[Request] = []
        while queue:
            active = queue[: self.n_slots]
            queue = queue[self.n_slots:]
            toks = torch.as_tensor(np.stack([r.prompt for r in active]), dtype=torch.long,
                                   device=device)
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(self.params, toks, max_seq=self.max_seq)
            nxt = torch.argmax(logits, dim=-1)
            host = nxt.tolist()
            timing = dict(batch=len(active), prefill_s=time.perf_counter() - t0, decode_s=[])
            pos = len(active[0].prompt)
            for t in range(gen_len):
                for r, tk in zip(active, host):
                    r.generated.append(tk)
                t0 = time.perf_counter()
                logits, cache = self.model.decode_step(self.params, cache, nxt, pos + t)
                nxt = torch.argmax(logits, dim=-1)
                host = nxt.tolist()
                timing["decode_s"].append(time.perf_counter() - t0)
            self.timings.append(timing)
            for r in active:
                r.done = True
                out.append(r)
        return out


def main(argv: list[str] | None = None) -> list[Request]:
    ap = argparse.ArgumentParser(description="batched prefill + greedy decode")
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg)
    device = torch.device(args.device)
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len))
            for i in range(args.requests)]
    server = Server(model, params, args.slots, args.prompt_len + args.gen_len + 1)
    t0 = time.perf_counter()
    done = server.run(reqs, args.gen_len)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.generated) for r in done)
    print(f"[serve] {cfg.name} on {device}: {len(done)} requests, {n_tok} tokens in "
          f"{dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.generated[:8]}...")
    return done


if __name__ == "__main__":
    main()
