"""The port's sharding rules (``repro_torch.launch.shardings`` / ``mesh``,
``models.shard_ctx``, ``launch.dryrun``) against the JAX package's
(``repro.launch.shardings``, ``repro.models.shard_ctx``,
``repro.launch.dryrun``), on the CPU, with no devices.

* Specs, rule for rule: for every architecture at full width and on
  stand-in meshes (2, 16, 16), (16, 16) and (2, 2, 2) (an object with the
  reference's ``axis_names`` and ``shape``, as ``tests/test_system.py``
  uses), the port's ``param_specs``, ``opt_state_specs``, ``batch_specs``
  of every shape and ``cache_specs`` fitted to ``input_specs``' cache equal
  the reference's ``PartitionSpec``s leaf by leaf, over param trees whose
  paths are the same (``Model.param_shapes()`` on both sides).
* ``constrain``'s resolution: each call site's logical names, at the
  shapes the full configs give it, resolve to the reference's mesh axes.
  The reference's spec is captured by replacing
  ``jax.lax.with_sharding_constraint`` and ``NamedSharding`` in its module
  for the call (a stand-in mesh has no devices).
* ``should_skip`` equal for every architecture and shape.
* ``input_specs`` the reference's shapes and dtypes.
* Per-rank argument bytes: rank 0 of a fake 256- / 512-rank group holds,
  in the dry-run's arguments (``dryrun.cell_arguments``, which
  ``run_cell`` tallies), the sum over leaves of (leaf bytes / the product
  of its spec's axis sizes) under the reference's specs, for every
  architecture at ``train_4k`` and ``decode_32k`` (the port's decode takes
  ``pos`` as an int, so the reference's 4-byte ``pos`` is left out); and
  one architecture per family runs a whole step through ``run_cell`` at
  one layer (two for the units of Zamba2 and the VLM) with its record's
  argument bytes the same sum.
* ``to_placements``: the nesting order and the flattened fsdp dim.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, get_config as j_get_config
from repro.launch import dryrun as JD
from repro.launch import shardings as JSH
from repro.models import Model as JModel
from repro.models import SHAPES as J_SHAPES
from repro.models import input_specs as j_input_specs
from repro.models import shard_ctx as JCTX
from repro.train.optimizer import init_opt_state as j_init_opt_state

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import shardings as SH
from repro_torch.launch.dryrun_suco import fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import SHAPES, Model, input_specs
from repro_torch.models import shard_ctx as CTX
from repro_torch.placements import Spec, placement_mesh, to_placements
from repro_torch.train._tree import items


class StandIn:
    """A mesh with the reference's ``axis_names`` and ``shape`` only."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))

    def __repr__(self):
        return f"StandIn{tuple(self.shape.values())}"


MESHES = [StandIn((2, 16, 16), ("pod", "data", "model")), StandIn((16, 16), ("data", "model")),
          StandIn((2, 2, 2), ("pod", "data", "model"))]
FAMILY_ARCHS = ["granite-3-2b", "olmoe-1b-7b", "rwkv6-1.6b", "zamba2-1.2b", "whisper-large-v3",
                "llama-3.2-vision-11b"]


def _is_spec(x):
    return isinstance(x, P)


def _ref_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)[0]
    return {JSH._path_str(path): tuple(v) for path, v in flat}


def _port_flat(tree) -> dict:
    return {path: tuple(v) for path, v in items(tree)}


def _port_shape_flat(tree) -> dict:
    return {path: tuple(v.shape) for path, v in items(tree)}


def _ref_shape_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {JSH._path_str(path): tuple(v.shape) for path, v in flat}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_paths_and_shapes_match(arch):
    assert _port_shape_flat(Model(get_config(arch)).param_shapes()) == _ref_shape_flat(
        JModel(j_get_config(arch)).param_shapes())


@pytest.mark.parametrize("mesh", MESHES, ids=repr)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_specs_match(arch, mesh):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    j_shapes = JModel(jcfg).param_shapes()
    shapes = Model(cfg).param_shapes()
    assert _port_flat(SH.param_specs(cfg, mesh, shapes)) == _ref_flat(
        JSH.param_specs(jcfg, mesh, j_shapes))
    j_opt = jax.eval_shape(j_init_opt_state, j_shapes)
    opt = {"mu": shapes, "nu": shapes, "step": torch.empty((), dtype=torch.int32, device="meta")}
    assert _port_flat(SH.opt_state_specs(cfg, mesh, opt)) == _ref_flat(
        JSH.opt_state_specs(jcfg, mesh, j_opt))


@pytest.mark.parametrize("mesh", MESHES, ids=repr)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match(arch, mesh):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        ins, j_ins = input_specs(cfg, shape), j_input_specs(jcfg, jshape)
        assert _port_flat(SH.batch_specs(cfg, mesh, shape, ins)) == _ref_flat(
            JSH.batch_specs(jcfg, mesh, jshape, j_ins)), name
        if shape.kind == "decode":
            fitted = SH.fit_tree(SH.cache_specs(cfg, mesh, shape), ins["cache"], mesh)
            j_fitted = JSH.fit_tree(JSH.cache_specs(jcfg, mesh, jshape), j_ins["cache"], mesh)
            assert _port_flat(fitted) == _ref_flat(j_fitted), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        ins, j_ins = input_specs(cfg, shape), j_input_specs(jcfg, J_SHAPES[name])
        got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in items(ins)}
        flat = jax.tree_util.tree_flatten_with_path(j_ins)[0]
        want = {JSH._path_str(p): (tuple(x.shape), str(x.dtype)) for p, x in flat}
        assert got == want, name
        assert all(x.device.type == "meta" for _, x in items(ins))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_should_skip_matches(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in SHAPES.items():
        assert D.should_skip(cfg, shape) == JD.should_skip(jcfg, J_SHAPES[name]), name


def _call_sites(cfg):
    """Every ``constrain`` call of the LM stack with the shape the full
    config gives it at ``train_4k``'s batch and sequence."""
    b, s = 256, 4096
    hd = cfg.head_dim
    qo = ("batch", ("heads", "qseq"), ("qseq",), None)
    kv = ("batch", ("kv_heads",), None, None)
    e, d, f = max(cfg.n_experts, 1), cfg.d_model, cfg.d_ff
    cap = math.ceil(max(cfg.top_k_experts, 1) * s / e * cfg.capacity_factor)
    ex = ("expert",) if e > 16 else None
    sites = [
        ("attn q / o", (b, cfg.n_heads, s, hd), qo),
        ("attn k / v", (b, cfg.n_kv_heads, s, hd), kv),
        ("mlp ffn", (b, s, f), ("batch", None, "ffn")),
        ("residual", (b, s, d), ("batch", None, None)),
        ("logits", (b, cfg.vocab_chunk, cfg.padded_vocab), ("batch", None, "vocab")),
        ("linear attention", (b * cfg.n_heads, s, d // cfg.n_heads),
         ("batch_heads", None, None)),
        ("moe buffer", (e, b * cap, d), (ex, ("batch",), None)),
        ("moe ffn", (e, b * cap, f), (ex, ("batch",), "ffn")),
    ]
    return sites


@pytest.mark.parametrize("mesh", MESHES, ids=repr)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_constrain_resolves_as_the_reference(arch, mesh, monkeypatch):
    cfg = get_config(arch)
    seen = []
    monkeypatch.setattr(JCTX, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: seen.append(spec))
    for name, shape, logical in _call_sites(cfg):
        with JCTX.activation_sharding(mesh):
            JCTX.constrain(jax.ShapeDtypeStruct(shape, np.float32), *logical)
        want = tuple(seen.pop())
        got = CTX.resolve(mesh, CTX.DEFAULT_RULES, shape, logical)
        assert tuple(got) == want, (name, shape, got, want)


def test_constrain_is_the_identity_outside_a_context_and_on_plain_tensors():
    x = torch.randn(4, 8)
    assert CTX.constrain(x, "batch", None) is x
    with CTX.activation_sharding(MESHES[2]):
        assert CTX.constrain(x, "batch", None) is x
    assert CTX.gather_fsdp(x) is x and CTX.splittable(x, -1, 3) is x


def test_spec_normalises_as_a_partition_spec():
    for entries in ((("data",), "model"), ((), "model"), (("pod", "data"), None), ("a",)):
        assert tuple(Spec(*entries)) == tuple(P(*entries))


def _ref_bytes(jcfg, mesh, jshape) -> int:
    """Rank 0's argument bytes under the reference's specs: each leaf's
    bytes over the product of its spec's axis sizes (``pos`` left out)."""
    j_shapes = JModel(jcfg).param_shapes()
    trees = [(j_shapes, JSH.param_specs(jcfg, mesh, j_shapes))]
    ins = j_input_specs(jcfg, jshape)
    b_specs = JSH.batch_specs(jcfg, mesh, jshape, ins)
    ins.pop("pos", None)
    b_specs.pop("pos", None)
    trees.append((ins, b_specs))
    if jshape.kind == "train":
        opt = jax.eval_shape(j_init_opt_state, j_shapes)
        trees.append((opt, JSH.opt_state_specs(jcfg, mesh, opt)))
    total = 0
    for shapes, specs in trees:
        leaves = jax.tree.leaves(shapes)
        spec_leaves = jax.tree.leaves(specs, is_leaf=_is_spec)
        assert len(leaves) == len(spec_leaves)
        for x, spec in zip(leaves, spec_leaves):
            n = 1
            for ax in spec:
                for a in (() if ax is None else (ax,) if isinstance(ax, str) else ax):
                    n *= mesh.shape[a]
            total += math.prod(x.shape) * np.dtype(x.dtype).itemsize // n
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rank_argument_bytes_match_the_reference_specs(arch, multi_pod):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
        (16, 16), ("data", "model"))
    standin = StandIn(shape, names)
    for name in ("train_4k", "decode_32k"):
        with fake_group(math.prod(shape)):
            mesh = make_mesh(shape, names, "cuda")
            _, shares = D.cell_arguments(cfg, SHAPES[name], mesh)
            got = sum(t.numel() * t.element_size() for _, t in items(shares))
        assert got == _ref_bytes(jcfg, standin, J_SHAPES[name]), name


def _cut(arch):
    import dataclasses

    cfg = get_config(arch)
    layers = {"hybrid": cfg.hybrid_period, "vlm": cfg.cross_attn_period}.get(cfg.family, 1)
    return dataclasses.replace(cfg, n_layers=layers, encoder_layers=min(cfg.encoder_layers, 1))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dryrun_cell_runs_and_tallies_the_rank_arguments(arch):
    """One step of a depth-cut cell through ``run_cell`` on the fake group:
    ``status`` ok, the record's argument bytes the reference's sum at the
    same config, collectives and FLOPs counted."""
    import dataclasses

    cfg = _cut(arch)
    jcfg = dataclasses.replace(j_get_config(arch), n_layers=cfg.n_layers,
                               encoder_layers=cfg.encoder_layers)
    rec = D.run_cell(arch, "decode_32k", multi_pod=False, cfg=cfg)
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == _ref_bytes(
        jcfg, StandIn((16, 16), ("data", "model")), J_SHAPES["decode_32k"])
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0


def test_to_placements_nests_in_mesh_order():
    with fake_group(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        pm = placement_mesh(mesh)
        assert pm.mesh_dim_names == ("pod_data", "model")
        from torch.distributed.tensor import Replicate, Shard

        assert to_placements(mesh, Spec(("pod", "data"), "model"), 2) == [Shard(0), Shard(1)]
        assert to_placements(mesh, Spec(("pod", "data", "model")), 3) == [Shard(0), Shard(0)]
        assert to_placements(mesh, Spec(None, "model"), 3) == [Replicate(), Shard(1)]
        with pytest.raises(ValueError, match="order"):
            to_placements(mesh, Spec(("model", "pod")), 1)
        with pytest.raises(ValueError, match="flattened"):
            to_placements(mesh, Spec("data"), 1)
