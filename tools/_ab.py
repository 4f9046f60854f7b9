"""What the card timers under ``tools/`` share: their options, the import of
the tree being timed, the card's name and power limit, and the readings.

A timer calls :func:`start` first.  It parses ``--src DIR`` (the ``src``
directory whose ``repro_torch`` is timed, default this checkout's, so one
command can time two checkouts in turns, each in its own process),
``--label NAME`` (echoed in the output), ``--seed S`` and the timer's own
switches; imports ``chip_smoke.py`` from this checkout for its inputs, then
puts ``--src`` ahead of this checkout's ``src``; and refuses to go on
without a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]


def start(doc: str, name: str, switches: dict[str, str] | None = None
          ) -> tuple[argparse.Namespace, ModuleType, dict]:
    """``(args, chip_smoke, header)``: the parsed options (``switches`` maps
    each extra ``--flag`` to its help), ``chip_smoke.py`` imported from this
    checkout, and the output's first keys (label, src, ``nvidia-smi``'s name
    and power limit).  Matmuls run in full fp32, as ``chip_smoke.py`` runs
    them."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="a name for the tree, echoed in the output")
    ap.add_argument("--seed", type=int, default=0)
    for flag, help_ in (switches or {}).items():
        ap.add_argument(flag, action="store_true", help=help_)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # puts this checkout's src on the path ...

    sys.path.insert(0, str(Path(args.src).resolve()))  # ... behind the timed tree's

    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    return args, chip_smoke, dict(label=args.label, src=args.src, nvidia_smi=smi)


def readings(chip_smoke: ModuleType, fn, reps: int, n: int) -> dict:
    """``n`` readings of ``fn``, each the mean ms of ``reps`` runs by CUDA
    events after warm-up (``chip_smoke.time_ms``), and their median."""
    times = [chip_smoke.time_ms(fn, reps) for _ in range(n)]
    return dict(ms=statistics.median(times), readings=times)


def wall(fn, n: int) -> dict:
    """``n`` readings of ``fn`` in seconds on the host clock, each ending in
    a synchronise, and their median."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return dict(median=statistics.median(times), readings=times)


def clocks(fn, seconds: float = 2.0, samples: int = 4) -> list[str]:
    """``nvidia-smi``'s SM clock, its maximum and the power draw, sampled
    ``samples`` times while ``fn`` runs back to back for about ``seconds``:
    the clock a kernel's time was read at."""
    import threading

    import torch

    out: list[str] = []
    query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"]

    def sample():
        for _ in range(samples):
            time.sleep(seconds / (samples + 1))
            out.append(subprocess.run(query, capture_output=True, text=True, timeout=60,
                                      check=True).stdout.strip())

    th = threading.Thread(target=sample)
    th.start()
    while th.is_alive():
        fn()
        torch.cuda.synchronize()
    th.join()
    return out

