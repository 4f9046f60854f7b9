"""Sharding rules: parameter, optimizer, batch and cache specs (the
counterpart of ``repro.launch.shardings``), and the ``DTensor`` trees they
describe.

Strategy (MaxText-style 2D "fsdp + tensor"):
  * tensor axis   = "model": heads / d_ff / vocab / experts
  * fsdp axis(es) = ("pod","data"): the d_model side of every big matrix
    (ZeRO-3: params + optimizer sharded over the batch axes too)
  * batch axes    = ("pod","data") for activations
  * long_500k     = KV-cache *sequence* axis over the batch axes
    (sequence-parallel decode)

Rules are path-based over the param tree (the ``/``-joined keys, as the
reference's ``_path_str`` joins a pytree path), so they apply uniformly to
params, grads and AdamW moments.  A spec is a :class:`Spec`, one entry per
tensor dim; :func:`to_placements` turns it into ``DTensor`` placements on
the mesh's placement mesh, and :func:`distribute_tree` / :func:`shard_tree`
make a tree of ``DTensor``s from full tensors or from this rank's shares.
"""

from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ShapeSpec
from repro_torch.placements import (
    Spec,
    axis_sizes,
    batch_axes,
    fsdp_axes,
    placement_mesh,
    to_placements,
)

__all__ = [
    "Spec",
    "param_specs",
    "opt_state_specs",
    "batch_specs",
    "cache_specs",
    "fit_spec",
    "fit_tree",
    "to_placements",
    "distribute_tree",
    "shard_tree",
    "zeros_tree",
    "local_shape",
    "local_slices",
    "spec_tree_map",
]


def _spec_for(path: str, ndim: int, cfg: ModelConfig, fsdp, tp="model") -> Spec:
    """Spec of one parameter leaf.  Leading stacked (L) axes are detected
    as (ndim - base rank) and left unsharded."""

    def lead(base: int) -> tuple:
        return (None,) * (ndim - base)

    # embeddings / heads / positions
    if path == "embed":
        return Spec(tp, fsdp)
    if path.endswith("lm_head/w"):
        return Spec(fsdp, tp)
    if path.endswith("dec_pos") or path.endswith("enc_pos"):
        return Spec(fsdp, None)

    # MoE expert tensors: expert-parallel when divisible, else tensor on d_ff
    if "moe/" in path:
        if path.endswith("router/w"):
            return Spec(*lead(2), fsdp, None)
        ep = cfg.n_experts % 16 == 0
        if path.endswith("w_gate") or path.endswith("w_up"):
            return Spec(*lead(3), tp, fsdp, None) if ep else Spec(*lead(3), None, fsdp, tp)
        if path.endswith("w_down"):
            return Spec(*lead(3), tp, None, fsdp) if ep else Spec(*lead(3), None, tp, fsdp)

    # attention / cross-attention projections
    if re.search(r"(attn|cross)/(wq|wk|wv)/w$", path):
        return Spec(*lead(2), fsdp, tp)
    if re.search(r"(attn|cross)/(wq|wk|wv)/b$", path):
        return Spec(*lead(1), tp)
    if re.search(r"(attn|cross)/wo/w$", path):
        return Spec(*lead(2), tp, fsdp)

    # dense mlp
    if re.search(r"(w_gate|w_up|wk)/w$", path):
        return Spec(*lead(2), fsdp, tp)
    if re.search(r"(w_down|wv)/w$", path):
        return Spec(*lead(2), tp, fsdp)
    if re.search(r"(w_up)/b$", path):
        return Spec(*lead(1), tp)

    # rwkv time mix / mamba projections
    if re.search(r"(wr|wg|w_in)/w$", path):
        return Spec(*lead(2), fsdp, tp)
    if re.search(r"(w_out)/w$", path):
        return Spec(*lead(2), tp, fsdp)
    if path.endswith("w_a"):
        return Spec(*lead(2), fsdp, None)
    if path.endswith("w_b"):
        return Spec(*lead(2), None, fsdp)
    if path.endswith("conv"):
        return Spec(*lead(2), None, tp)

    # everything small (norm scales, gates, decay vectors, biases)
    return Spec()


def fit_spec(spec, shape: tuple, mesh) -> Spec:
    """Drop sharded axes that don't divide the dimension exactly: odd
    vocabularies (49155, 51866) and fixed memory lengths (1500 / 1601)
    fall back to replication on that dim."""
    sizes = axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, entries):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        size = math.prod(sizes[a] for a in axes)
        out.append(ax if size and dim % size == 0 else None)
    return Spec(*out)


def spec_tree_map(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(specs, Spec):
        return fn(specs, *trees)
    return {k: spec_tree_map(fn, specs[k], *(t[k] for t in trees)) for k in specs}


def fit_tree(specs, shapes, mesh):
    return spec_tree_map(lambda s, x: fit_spec(s, tuple(x.shape), mesh), specs, shapes)


def _map_with_path(fn, tree, prefix: str = ""):
    if not isinstance(tree, dict):
        return fn(prefix, tree)
    return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in tree.items()}


def param_specs(cfg: ModelConfig, mesh, shapes) -> Any:
    fsdp = fsdp_axes(mesh)

    def leaf(path, x):
        return fit_spec(_spec_for(path, len(x.shape), cfg, fsdp), tuple(x.shape), mesh)

    return _map_with_path(leaf, shapes)


def opt_state_specs(cfg: ModelConfig, mesh, opt_shapes) -> Any:
    """AdamW moments mirror the param tree; ``step`` is replicated."""
    return {"mu": param_specs(cfg, mesh, opt_shapes["mu"]),
            "nu": param_specs(cfg, mesh, opt_shapes["nu"]), "step": Spec()}


def batch_specs(cfg: ModelConfig, mesh, shape: ShapeSpec, specs: dict) -> dict:
    """Specs matching ``input_specs(cfg, shape)``."""
    ba = batch_axes(mesh)
    out: dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = Spec(ba, None)
        if shape.kind == "train":
            out["labels"] = Spec(ba, None)
        if "extras" in specs:
            out["extras"] = Spec(ba, None, None)
        return out
    # decode
    seq_shard = shape.global_batch == 1  # long_500k: shard the KV seq axis
    out["token"] = Spec(None) if seq_shard else Spec(ba)
    out["pos"] = Spec()
    cs = cache_specs(cfg, mesh, shape)
    if "cache" in specs:
        cs = fit_tree(cs, specs["cache"], mesh)
    out["cache"] = cs
    return out


def cache_specs(cfg: ModelConfig, mesh, shape: ShapeSpec) -> dict:
    """KV / state cache specs.

    Argument shardings must divide exactly, so the head axis only takes the
    tensor axis when ``n_kv_heads % model == 0``; otherwise the tensor axis
    is folded into the *sequence* axis (sequence-sharded KV within the TP
    group, flash-decode semantics)."""
    ba = batch_axes(mesh)
    tp_size = axis_sizes(mesh)["model"]
    seq_shard = shape.global_batch == 1  # long_500k
    b_ax = None if seq_shard else ba

    heads_div = cfg.n_kv_heads % tp_size == 0
    h_ax = "model" if heads_div else None
    if heads_div:
        s_ax = ba if seq_shard else None
    else:
        s_ax = (*ba, "model") if seq_shard else "model"

    # SSM / hybrid small-state tensors: heads axis if divisible, else replicate
    st_h = "model" if cfg.n_heads % tp_size == 0 else None
    inner_ax = "model"  # inner = 2 * d_model, always divisible in practice

    out: dict[str, Any] = {}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        out["k"] = Spec(None, b_ax, h_ax, s_ax, None)
        out["v"] = Spec(None, b_ax, h_ax, s_ax, None)
    if cfg.family in ("vlm", "audio"):
        # memory K/V: fixed odd lengths (1601 / 1500) -> never shard seq
        out["xk"] = Spec(None, b_ax, h_ax, None, None)
        out["xv"] = Spec(None, b_ax, h_ax, None, None)
    if cfg.family == "ssm":
        out["prev1"] = Spec(None, b_ax, inner_ax if cfg.d_model % tp_size == 0 else None)
        out["prev2"] = out["prev1"]
        out["wkv"] = Spec(None, b_ax, st_h, None, None)
    if cfg.family == "hybrid":
        inner_ok = (cfg.ssm_expand * cfg.d_model) % tp_size == 0
        out["conv"] = Spec(None, b_ax, None, inner_ax if inner_ok else None)
        out["ssm"] = Spec(None, b_ax, st_h, None, None)
        out["sk"] = Spec(None, b_ax, h_ax, s_ax, None)
        out["sv"] = Spec(None, b_ax, h_ax, s_ax, None)
    return out


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def local_slices(mesh, spec, shape: tuple) -> tuple[slice, ...]:
    """This rank's share of a tensor of ``shape`` sharded as ``spec``: per
    dim, the block its coordinates on the dim's axes pick, row-major in the
    axes' (mesh) order, as JAX lays out a ``PartitionSpec`` (the specs here
    divide exactly)."""
    sizes = axis_sizes(mesh)
    names = tuple(mesh.mesh_dim_names)
    coords = dict(zip(names, mesh.get_coordinate()))
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        n, i = 1, 0
        for a in _axes(entry):
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        if dim % n:
            raise ValueError(f"{spec} does not divide {tuple(shape)}")
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def local_shape(mesh, spec, shape: tuple) -> tuple[int, ...]:
    """The shape of this rank's share (:func:`local_slices`)."""
    return tuple(s.stop - s.start for s in local_slices(mesh, spec, shape))


def _from_local(mesh, spec, local: torch.Tensor, shape):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, placement_mesh(mesh), to_placements(mesh, spec, len(shape)),
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def distribute_tree(mesh, specs, tree):
    """``tree``'s full tensors (the same on every rank) as ``DTensor``s
    sharded by ``specs``: each rank keeps a copy of its share, nothing is
    sent."""
    return spec_tree_map(
        lambda s, t: _from_local(mesh, s, t[local_slices(mesh, s, t.shape)].contiguous(),
                                 tuple(t.shape)), specs, tree)


def zeros_tree(mesh, specs, shapes, device):
    """``DTensor`` zeros of ``shapes``' shapes and dtypes sharded by
    ``specs``, this rank's shares on ``device``."""
    return spec_tree_map(
        lambda s, x: _from_local(mesh, s, torch.zeros(local_shape(mesh, s, tuple(x.shape)),
                                                      dtype=x.dtype, device=device),
                                 tuple(x.shape)), specs, shapes)


def shard_tree(mesh, specs, shares, shapes):
    """``DTensor``s of full shapes ``shapes`` from this rank's ``shares``
    (the dry-run's fake local tensors)."""
    return spec_tree_map(lambda s, t, x: _from_local(mesh, s, t, tuple(x.shape)),
                         specs, shares, shapes)


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, out = 1, []
    for d in reversed(tuple(shape)):
        out.append(stride)
        stride *= max(int(d), 1)
    return tuple(reversed(out))
