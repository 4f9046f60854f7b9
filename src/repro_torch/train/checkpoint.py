"""Fault-tolerant checkpointing: atomic, async, on the JAX package's
on-disk layout (the counterpart of ``repro.train.checkpoint``), so a
checkpoint written by either package restores in the other, leaf for leaf.

Layout:  <dir>/step_00001230/params.npz, opt_state.npz + manifest.json
         <dir>/step_00001230.tmp<pid>    (renamed last, on completion)

* Each group is an ``.npz`` keyed by the ``/``-joined dict path of every
  leaf (``blocks/ln1/scale``; the optimizer state's ``mu/...``, ``nu/...``
  and ``step``); ``manifest.json`` holds the step, the time, each group's
  sorted keys and the caller's ``extra``.
* Arrays are written from host copies, so a checkpoint restores onto any
  device: :func:`restore` puts every leaf on the device of its
  ``params_like`` counterpart, or on ``device`` where one is given (needed
  for ``meta`` trees such as ``Model.param_shapes()``).
* ``save(..., blocking=False)`` hands the write to a background thread;
  the next save, or :func:`wait_for_pending`, joins it first (at most one
  outstanding write, never torn: the rename happens last).
* ``keep`` bounds disk usage; pruning never removes the newest checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.train._tree import items

__all__ = ["save", "restore", "latest_step", "all_steps", "wait_for_pending"]

_PENDING: threading.Thread | None = None


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that no later write to ``t`` reaches."""
    a = t.detach().cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in items(tree)}


def _unflatten(tree_like: Any, flat: dict[str, np.ndarray], device, prefix: str = "") -> Any:
    if not isinstance(tree_like, dict):
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        dev = device if device is not None else tree_like.device
        return torch.from_numpy(np.array(flat[prefix])).to(dev)
    return {k: _unflatten(v, flat, device, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree_like.items()}


def _step_dir(root: Path, step: int) -> Path:
    return root / f"step_{step:08d}"


def all_steps(root: str | os.PathLike) -> list[int]:
    root = Path(root)
    if not root.exists():
        return []
    out = []
    for p in root.iterdir():
        if p.is_dir() and p.name.startswith("step_") and (p / "manifest.json").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(root: str | os.PathLike) -> int | None:
    steps = all_steps(root)
    return steps[-1] if steps else None


def _write(root: Path, step: int, flat_groups: dict[str, dict[str, np.ndarray]],
           extra: dict, keep: int) -> None:
    final = _step_dir(root, step)
    tmp = Path(str(final) + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "time": time.time(), "groups": {}, "extra": extra}
    for group, flat in flat_groups.items():
        np.savez(tmp / f"{group}.npz", **flat)
        manifest["groups"][group] = sorted(flat)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    steps = all_steps(root)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(_step_dir(root, s), ignore_errors=True)


def save(
    root: str | os.PathLike,
    step: int,
    *,
    params: Any,
    opt_state: Any | None = None,
    extra: dict | None = None,
    keep: int = 3,
    blocking: bool = True,
) -> None:
    """Write ``params`` (and ``opt_state``) as checkpoint ``step`` under
    ``root``.  The host copies are taken before this returns, so the caller
    may go on to change its tensors while a background write runs."""
    global _PENDING
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    wait_for_pending()
    groups = {"params": _flatten(params)}
    if opt_state is not None:
        groups["opt_state"] = _flatten(opt_state)
    if blocking:
        _write(root, step, groups, extra or {}, keep)
    else:
        t = threading.Thread(
            target=_write, args=(root, step, groups, extra or {}, keep), daemon=True
        )
        t.start()
        _PENDING = t


def wait_for_pending() -> None:
    global _PENDING
    if _PENDING is not None:
        _PENDING.join()
        _PENDING = None


def restore(
    root: str | os.PathLike,
    *,
    params_like: Any,
    opt_state_like: Any | None = None,
    step: int | None = None,
    device: torch.device | str | None = None,
) -> tuple[int, Any, Any | None, dict]:
    """``(step, params, opt_state, extra)`` of checkpoint ``step`` (the
    newest by default), each tree shaped as its ``*_like`` tree, on
    ``device`` or else on each like-leaf's own device."""
    root = Path(root)
    step = step if step is not None else latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    d = _step_dir(root, step)
    manifest = json.loads((d / "manifest.json").read_text())

    def load_group(name, like):
        with np.load(d / f"{name}.npz") as z:
            return _unflatten(like, dict(z), device)

    params = load_group("params", params_like)
    opt_state = None
    if opt_state_like is not None and "opt_state" in manifest["groups"]:
        opt_state = load_group("opt_state", opt_state_like)
    return step, params, opt_state, manifest.get("extra", {})

