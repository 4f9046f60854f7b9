"""The sharded engine's dry-run on fake tensors (``repro_torch.launch.
dryrun_suco``) and the op-trace cost tally under it (``launch/op_analysis``):
rank 0's shares and its query block against the JAX package's shardings on
the mesh (2, 2, 2), the dry-run at a cut n, the 1B cell's argument bytes
and the one-card share's prediction."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.distributed.compat import Mesh
from repro_torch.distributed.engine import DistSuCoConfig, index_shardings, resolved_query_block_n
from repro_torch.launch import dryrun_suco as D
from repro_torch.launch.op_analysis import OpTally, kernel_cost

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in six worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


#: (n, d, Ns): the 1B cell, and two smaller layouts
_LAYOUTS = ((1_000_000_000, 128, 16), (1 << 20, 128, 16), (200_000, 64, 8))


def _cfg(ns: int) -> dict:
    return dict(n_subspaces=ns, sqrt_k=64, kmeans_iters=10, alpha=0.03, beta=0.003, k=50,
                q_chunk=8, point_axes=("pod", "data"), tuning_backend="cpu")


_REF = """
import json, sys
from repro.distributed.engine import DistSuCoConfig, index_shardings, resolved_query_block_n
from repro.launch.mesh import compat_make_mesh

mesh = compat_make_mesh((2, 2, 2), ("pod", "data", "model"))
out = []
for n, d, ns, cfg in json.loads(sys.argv[1]):
    cfg = DistSuCoConfig(**{**cfg, "point_axes": tuple(cfg["point_axes"])})
    sh = index_shardings(mesh, cfg)
    h1 = (d // ns + 1) // 2
    shapes = dict(x=(n, d), cell_ids=(ns, n), cell_counts=(ns, 64 * 64), centroids=(ns, 64, h1),
                  queries=(256, d))
    out.append(dict(shares={k: list(sh[k].shard_shape(v)) for k, v in shapes.items()},
                    block_n=resolved_query_block_n(mesh, cfg, n, d)))
print(json.dumps(out))
"""


def test_rank_shares_and_query_block_match_the_references_on_mesh_222():
    """Every rank's share of each array and the query block on the mesh
    (2, 2, 2) are the JAX package's (8 fake XLA devices in a subprocess;
    the static CPU limits on both sides)."""
    layouts = [(n, d, ns, _cfg(ns)) for n, d, ns in _LAYOUTS]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               REPRO_MEASURED_LIMITS="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REF, json.dumps(layouts)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for rank in range(8):
        with D.fake_group(8, rank):
            mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
            for (n, d, ns, cfg), w in zip(layouts, want):
                cfg = DistSuCoConfig(**cfg)
                sh = index_shardings(mesh, cfg, n, d)
                h1 = (d // ns + 1) // 2
                full = dict(x=(n, d), cell_ids=(ns, n), cell_counts=(ns, 64 * 64),
                            centroids=(ns, 64, h1), queries=(256, d))
                got = {k: [len(range(*s.indices(dim))) for s, dim in zip(sh[k], full[k])]
                       + list(full[k][len(sh[k]):]) for k in full}
                assert got == w["shares"], (rank, n)
                assert resolved_query_block_n(mesh, cfg, n, d) == w["block_n"]


def test_pod1_argument_bytes_are_the_references():
    """Rank 0's arguments at pod1 take 2,250,026,624 bytes, the reference's
    ``argument_size_in_bytes``; its block is 65,536 under the H100's limits."""
    cfg = D.suco_config()
    with D.fake_group(256):
        mesh = Mesh((16, 16), ("data", "model"))
        with FakeTensorMode():
            args = D._shares(mesh, cfg, D.N_POINTS, D.DIM, 256)
            assert D._nbytes(*args) == 2_250_026_624
        assert resolved_query_block_n(mesh, cfg, D.N_POINTS, D.DIM) == 65_536


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fake_dryrun_at_a_cut_n(multi_pod):
    """The whole query step of rank 0 over a fake 256- (512-) rank group, at
    n cut so a shard holds 2^20 points (16 blocks of 65,536)."""
    world = 512 if multi_pod else 256
    n = (1 << 20) * world // 16
    rec = D.suco_cell(multi_pod=multi_pod, pool_ks=(10,), n=n)
    assert rec["status"] == "ok" and rec["n_chips"] == world
    assert rec["tiling"] == {"query_block_n": 65_536, "q_chunk": 8, "tuning_backend": "h100"}
    n_loc = 1 << 20
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == n_loc * 8 * 4 + n_loc * 4 + 2 * 64 * 4 * 4 \
        + 4096 * 4 + 256 * 8 * 4
    assert mem["output_size_in_bytes"] == 2 * 256 * 50 * 4
    assert 0 < mem["temp_size_in_bytes"] < mem["argument_size_in_bytes"]
    blocks, chunks = 16, 256 // 8
    coll = rec["collectives"]
    # an int8 score sum a block, an fp32 distance sum a chunk; ids and dists gathered
    assert coll["counts"]["all-reduce"] == blocks * chunks + chunks
    assert coll["counts"]["all-gather"] == 2
    assert coll["per_kind_bytes"]["all-gather"] == 1_638_400 * (2 if multi_pod else 1)
    assert rec["cost_analysis"]["kernel_calls"] == {"gather_rerank_block": chunks,
                                                    "sc_scores_cells": blocks * chunks}
    assert rec["pool"] == [{"k": 10, "mq": 256, "make_s": rec["pool"][0]["make_s"]}]


def test_share_prediction_counts_the_build():
    """The one-card program's peak: the points, their half-subspace copy,
    the paired assignments and the cell ids' two temporaries, at a cut n."""
    n = 1 << 18
    rec = D.share_prediction(n=n, batches=(8,))
    x = n * 8 * 4
    assert rec["status"] == "ok" and rec["argument_bytes"] == x
    assert rec["peak_bytes"] == rec["build_peak_bytes"]
    assert x + x + 2 * n * 4 + 2 * n * 4 <= rec["peak_bytes"] <= x + x + 2 * n * 4 + 2 * n * 4 \
        + (1 << 20)
    assert rec["query_block_n"] == 32_768  # n / 8, as the autotuner caps it
    assert rec["cost_analysis"]["kernel_calls"] == {
        "kmeans_stats": 10, "kmeans_pair_assign_hist": 1, "sc_scores_cells": n // 32_768,
        "gather_rerank_block": 1}


def test_op_tally_counts_live_bytes_and_skips_views():
    a = torch.zeros(1000)
    with OpTally((a,)) as t:
        b = a * 2  # 4,000 B
        v = b[:10]  # a view: no new storage
        c = b + 1  # 4,000 B
        del b, v
        d = c * 3  # b's storage is gone by now
        del c, d
    assert t.argument_bytes == 4000
    assert t.peak_live_bytes == 4000 + 8000
    assert t.live_bytes == 4000
    assert t.largest[0] == 4000


def test_kernel_cost_counts_the_bound_columns():
    ranks = torch.zeros((2, 8, 64), dtype=torch.int32)
    cells = torch.zeros((2, 100), dtype=torch.int32)
    out = torch.zeros((8, 100), dtype=torch.int32)
    ops, moved = kernel_cost("sc_scores_cells", (ranks, torch.zeros((2, 8), dtype=torch.int32),
                                                 cells), [out])
    assert ops == 2.0 * 2 * 8 * 100 and moved == 4 * (2 * 8 * 64 + 16 + 200 + 800)
    ids, x, q = torch.zeros((8, 5), dtype=torch.int32), torch.zeros((50, 16)), torch.zeros((8, 16))
    ops, moved = kernel_cost("gather_rerank_block", (ids, x, q), [torch.zeros((8, 5))])
    assert ops == 3.0 * 8 * 5 * 16 and moved == 4 * (40 + 800 + 128 + 40) + 4 * 8 * 5 * 16
    with pytest.raises(ValueError, match="no cost formula"):
        kernel_cost("linear_attention", (), [])


def test_cli_writes_ok_json(tmp_path):
    assert D.main(["--n", str(1 << 24), "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "suco-engine-1b__serve_q256__pod1.json").read_text())
    assert rec["status"] == "ok" and rec["config"]["n"] == 1 << 24
