"""The port's static gate (``repro_torch.analysis``): every rule passes on
every registered entry point, and every rule has a fixture that fails it,
as ``tests/test_analysis.py`` holds the JAX package's gate.  Also the
counting merge (``core/sc_linear.py``) bit for bit against the sort merge
and the JAX package's merges, and the kernels as PyTorch operators."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.analysis.registry import collect_entries as ref_collect_entries
from repro.core import sc_linear as JS
from repro_torch.analysis import lint as lint_cli
from repro_torch.analysis.ast_rules import AST_RULES, lint_source
from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.registry import (
    HOOK_MODULES,
    TileEntry,
    TraceEntry,
    ast_targets,
    collect_entries,
)
from repro_torch.analysis.trace_rules import (
    TRACE_RULES,
    TensorMeta,
    rule_bounded_intermediate,
    rule_no_scatter_in_scan,
    rule_pinned_accumulator,
    rule_tile_shape,
    run_trace_rules,
    trace,
)
from repro_torch.core import sc_linear as S
from repro_torch.core import suco
from repro_torch.core.spans import loop_span
from repro_torch.core.tuning import H100_LIMITS, TileConfig, device_limits, static_device_limits
from repro_torch.kernels.gather_rerank import ops as gather_ops
from repro_torch.kernels.kmeans_assign import ops as kmeans_ops
from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
from repro_torch.kernels.sc_score import ops as score_ops

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the repository's seeded stand-in
    from _hypothesis_fallback import given, settings, strategies as st


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in six worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fatal(findings):
    return [f for f in findings if not f.suppressed]


def _entry(fn, rules, **kw):
    return TraceEntry(name="fixture", make=lambda: trace(fn), rules=rules, **kw)


# ----------------------- every rule x every entry ---------------------------


def test_registry_covers_the_serving_surface():
    """Every entry of the JAX package's registry has a port entry of the same
    name, and the port adds the fused query under the counting merge."""
    names = {e.name for e in collect_entries()}
    ref_names = {e.name for e in ref_collect_entries()}
    assert ref_names <= names, ref_names - names
    assert names - ref_names == {"suco.query_fused_counting"}
    tnames = {t.name for t in ast_targets()}
    assert "repro_torch/serve/ann.py" in tnames
    assert any(t.startswith("repro_torch/distributed/") for t in tnames)


def test_every_entry_passes_its_rules():
    """The gate: the whole registry lints clean (``python -m
    repro_torch.analysis.lint`` exiting 0, in process); every suppression
    carries a reason."""
    for entry in collect_entries():
        findings, checked = run_trace_rules(entry)
        assert checked, f"{entry.name}: no rules ran"
        assert _fatal(findings) == [], f"{entry.name}: {_fatal(findings)}"
        assert all(f.suppress_reason for f in findings)


def test_counting_merge_entries_pass_unsuppressed():
    """Under ``merge_impl="counting"`` the fused, streaming and engine
    entries pass no-scatter-in-scan with no suppression, and each traces
    its kernel operators as leaves inside the chunk loop."""
    for entry in suco.lint_entries(merge_impl="counting"):
        assert not entry.suppress, entry.name
        tr = entry.make()
        findings = run_trace_rules(entry)[0]
        assert findings == [], f"{entry.name}: {findings}"
        if "no-scatter-in-scan" in entry.rules and entry.name != "suco.build_chunked":
            in_loop = {e.name for e in tr.kernel_ops() if e.depth > 0}
            assert "sc_scores_cells" in in_loop or "sc_scores_cells_prefilter_compact" in in_loop


def test_ast_engine_passes_on_serving_layer():
    for target in ast_targets():
        findings = lint_source(target.path.read_text(), target.name)
        assert _fatal(findings) == [], f"{target.name}: {_fatal(findings)}"


def test_sync_ok_annotations_are_audited():
    """The async server's retire point stays an annotated sync: the
    suppression shows in the report."""
    target = next(t for t in ast_targets() if t.name == "repro_torch/serve/ann.py")
    findings = lint_source(target.path.read_text(), target.name)
    assert [f for f in findings if f.rule == "host-sync" and f.suppressed]


# ------------------- failing fixtures: trace rules --------------------------


def test_no_scatter_in_scan_fails_on_scatter_fixture():
    def bad():
        carry, xs = torch.zeros(4), torch.ones(8, 16)
        for row in xs:
            with loop_span("fixture"):
                carry = carry.scatter(0, torch.tensor([0]), row.sum()[None])

    e = _entry(bad, ("no-scatter-in-scan",))
    findings = rule_no_scatter_in_scan(e, e.make())
    assert findings and "scatter" in findings[0].message


def test_no_scatter_in_scan_fails_on_sort_fixture():
    def bad():
        carry = torch.zeros(())
        for row in torch.ones(8, 16):
            with loop_span("fixture"):
                carry = carry + torch.sort(row).values[0]

    e = _entry(bad, ("no-scatter-in-scan",))
    findings = rule_no_scatter_in_scan(e, e.make())
    assert findings and "sort" in findings[0].message


def test_no_scatter_in_scan_respects_scatter_budget():
    def small():
        carry = torch.zeros(4)
        for row in torch.ones(8, 16):
            with loop_span("fixture"):
                carry = carry.scatter(0, torch.tensor([0]), row.sum()[None])

    e = _entry(small, ("no-scatter-in-scan",), scatter_budget_elems=4)
    assert rule_no_scatter_in_scan(e, e.make()) == []


def test_no_scatter_outside_scan_is_allowed():
    e = _entry(lambda: torch.ones(512).index_put_((torch.tensor([0]),), torch.tensor(1.0)),
               ("no-scatter-in-scan",))
    assert rule_no_scatter_in_scan(e, e.make()) == []


def test_bounded_intermediate_fails_on_tight_budget():
    e = _entry(lambda: torch.ones(64, 64) @ torch.ones(64, 64), ("bounded-intermediate",),
               budget_bytes=128)
    findings = rule_bounded_intermediate(e, e.make())
    assert findings and "exceeds" in findings[0].message


def test_pinned_accumulator_fails_on_bf16_matmul():
    x = torch.ones(8, 8, dtype=torch.bfloat16)
    e = _entry(lambda: x @ x, ("pinned-accumulator",))
    findings = rule_pinned_accumulator(e, e.make())
    assert findings and "bfloat16" in findings[0].message


@pytest.mark.parametrize("case", ["bf16_sum_to_f32", "f32_sum", "f32_matmul"])
def test_pinned_accumulator_passes_on_upcast_bf16_sum_and_f32_matmul(case):
    fn = {
        # a bf16 sum asked for an fp32 result accumulates in fp32: safe
        "bf16_sum_to_f32": lambda: torch.ones(8, 8, dtype=torch.bfloat16).sum(dtype=torch.float32),
        "f32_sum": lambda: torch.ones(8, 8).sum(),
        "f32_matmul": lambda: torch.ones(8, 8) @ torch.ones(8, 8),
    }[case]
    e = _entry(fn, ("pinned-accumulator",))
    assert rule_pinned_accumulator(e, e.make()) == []


def test_sorted_merge_is_the_real_world_sort_fixture():
    """The fused query under the default sort merge, its suppression taken
    away, fails the rule: proof that it bites on the real query stack (the
    port's counterpart of the reference's dense-query fixture, whose scan
    the port's dense mode does not have)."""
    entries = {e.name: e for e in suco.lint_entries()}
    fused = entries["suco.query_fused"]
    assert S._resolve_merge_impl(suco.DEFAULT_MERGE_IMPL, torch.int32, 8) != "counting"
    bare = dataclasses.replace(fused, suppress={})
    findings = rule_no_scatter_in_scan(bare, bare.make())
    assert findings and all("sort" in f.message for f in findings)
    assert all(f.suppressed for f in run_trace_rules(fused)[0])


# ------------------- failing fixtures: tile-shape ---------------------------


def test_tile_shape_fails_on_bad_tile_config():
    e = TileEntry(name="fixture.tiles", contract={"block_quantum": 512, "cap_quantum": 64},
                  tile_configs=(TileConfig(block_n=1000, survivor_cap=50),
                                TileConfig(block_n=512, survivor_cap=1024)))
    messages = [f.message for f in rule_tile_shape(e)]
    assert any("block_n=1000" in m for m in messages)
    assert any("survivor_cap=50" in m for m in messages)
    assert any("exceeds block_n=512" in m for m in messages)


def _cells_trace():
    return next(e for e in score_ops.lint_entries() if e.name == "kernels.sc_score.cells").make


def test_tile_shape_fails_on_over_limit_shared_memory():
    """A sweep block's bitmap past the shared memory a block may take."""
    e = TileEntry(name="fixture.smem", contract={"smem_bytes": 1024}, make=_cells_trace())
    findings = rule_tile_shape(e)
    assert findings and "dynamic shared memory" in findings[0].message


@pytest.mark.parametrize("contract,needle", [({"max_threads": 64}, "threads exceed"),
                                             ({"grid_yz": 4}, "grid y / z")])
def test_tile_shape_fails_on_launch_limits(contract, needle):
    make = next(e for e in kmeans_ops.lint_entries()
                if e.name == "kernels.kmeans_assign.stats").make
    findings = rule_tile_shape(TileEntry(name="fixture.launch", contract=contract, make=make))
    assert findings and any(needle in f.message for f in findings)


def test_tile_shape_fails_when_no_kernel_op_traced():
    e = TileEntry(name="fixture.nokernel", contract={}, make=lambda: trace(lambda: torch.ones(8) + 1))
    findings = rule_tile_shape(e)
    assert findings and "no kernel operator" in findings[0].message


def test_static_device_limits_is_the_h100():
    lim = static_device_limits("h100")
    assert lim is H100_LIMITS and device_limits("h100") is lim
    assert (lim.fast_bytes, lim.smem_optin_bytes, lim.n_sm, lim.regs_per_sm,
            lim.max_threads_per_block) == (52_428_800, 232_448, 132, 65_536, 1_024)
    assert (lim.smem_per_sm_bytes, lim.max_threads_per_sm) == (233_472, 2_048)
    with pytest.raises(ValueError, match="unknown device"):
        static_device_limits("tpu")


# ------------------- failing fixtures: AST rules ----------------------------


def test_host_sync_fails_on_unannotated_cpu():
    src = "def f(x):\n    return x.cpu()\n"
    assert [f.rule for f in _fatal(lint_source(src, "fixture.py"))] == ["host-sync"]


def test_host_sync_annotation_suppresses():
    src = "def f(x):\n    return x.cpu()  # host-sync: ok — a reason\n"
    findings = lint_source(src, "fixture.py")
    assert findings and all(f.suppressed for f in findings)


def test_host_sync_ignores_calls_that_do_not_sync():
    src = ("import numpy as np\n\ndef f(a, b, d):\n"
           "    return np.asarray([a, b]), a.sum(), list(d.items())\n")
    assert lint_source(src, "fixture.py") == []


def test_host_sync_flags_synchronize_and_item():
    src = "import torch\n\ndef f(x):\n    torch.cuda.synchronize()\n    return x.item()\n"
    assert [f.rule for f in _fatal(lint_source(src, "fixture.py"))] == ["host-sync", "host-sync"]


def test_tensor_branch_fails_on_if_over_a_tensor_value():
    src = ("def f(total, cap):\n"
           "    if bool((total > cap).any()):\n        return 1\n"
           "    while t.all():\n        pass\n"
           "    assert torch.equal(a, b)\n")
    findings = _fatal(lint_source(src, "fixture.py"))
    assert [f.rule for f in findings] == ["tensor-branch"] * 3
    assert "any" in findings[0].message


def test_tensor_branch_ignores_host_values():
    src = ("import numpy as np\n\ndef f(q, k, n):\n"
           "    if not np.isfinite(q).all() or len(q) > 3 or int(k) > n:\n        return 1\n")
    assert _fatal(lint_source(src, "fixture.py")) == []


def test_tensor_branch_disable_comment():
    src = "def f(t):\n    if t.any():  # lint: disable=tensor-branch\n        return 1\n"
    findings = lint_source(src, "fixture.py")
    assert findings and all(f.suppressed for f in findings)


def test_build_in_hot_path_fails_inside_loop():
    src = ("import torch\n\ndef serve(batches, g):\n"
           "    for b in batches:\n"
           "        f = _build.entry('sc_score', 'x', [])\n"
           "        h = torch.compile(g)\n")
    findings = _fatal(lint_source(src, "fixture.py"))
    assert [f.rule for f in findings] == ["build-in-hot-path"] * 2


def test_build_outside_loop_is_fine():
    src = ("import torch\n\nf = torch.compile(lambda x: x + 1)\n\n"
           "def serve(batches):\n    return [f(b) for b in batches]\n")
    assert _fatal(lint_source(src, "fixture.py")) == []


# -------------------------- suppressions & report ---------------------------


def test_entry_level_suppression_is_reported_not_fatal():
    x = torch.ones(8, 8, dtype=torch.bfloat16)
    e = _entry(lambda: x @ x, ("pinned-accumulator",),
               suppress={"pinned-accumulator": "fixture: bf16 on purpose"})
    findings, checked = run_trace_rules(e)
    assert checked == ["pinned-accumulator"]
    assert findings and all(f.suppressed for f in findings)
    assert findings[0].suppress_reason == "fixture: bf16 on purpose"


def test_report_json_shape():
    r = Report()
    r.mark_checked("host-sync", "a.py")
    r.extend([Finding(rule="host-sync", target="a.py:3", message="boom"),
              Finding(rule="host-sync", target="a.py:9", message="ok", suppressed=True,
                      suppress_reason="annotated")])
    payload = json.loads(r.to_json())
    assert list(payload) == ["ok", "n_findings", "n_suppressed", "findings", "checked", "errors"]
    assert payload["ok"] is False and payload["n_findings"] == 1 and payload["n_suppressed"] == 1
    assert payload["checked"] == {"host-sync": ["a.py"]}
    assert not r.ok and len(r.fatal) == 1


def test_unknown_rule_name_is_a_finding():
    e = _entry(lambda: torch.ones(4) + 1, ("bogus-rule",))
    findings, checked = run_trace_rules(e)
    assert checked == [] and findings and "unknown trace rule" in findings[0].message


# -------------------------------- CLI ---------------------------------------


def test_cli_json_ast_only(capsys, tmp_path):
    out_path = tmp_path / "lint.json"
    rc = lint_cli.main(["--format", "json", "--rules", ",".join(AST_RULES), "--output",
                        str(out_path)])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] is True and set(AST_RULES) <= set(payload["checked"])
    assert json.loads(out_path.read_text()) == payload


def test_cli_list_and_unknown_rule(capsys):
    assert lint_cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    for rule in [*TRACE_RULES, "tile-shape", *AST_RULES]:
        assert rule in out
    assert "suco.query_fused" in out
    assert lint_cli.main(["--rules", "nonexistent"]) == 2


def test_cli_disable_suppresses(capsys):
    src = "def f(x):\n    return x.cpu()\n"
    assert _fatal(lint_source(src, "fixture.py"))
    rc = lint_cli.main(["--format", "json", "--rules", "host-sync", "--disable", "host-sync"])
    assert rc == 0 and json.loads(capsys.readouterr().out)["ok"] is True


def test_cli_exits_zero_on_the_whole_gate(capsys):
    """``--format json`` over every entry and file: exit 0, every suppression
    in the report with its reason."""
    assert lint_cli.main(["--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] and payload["errors"] == []
    suppressed = [f for f in payload["findings"] if f["suppressed"]]
    assert suppressed and all(f["suppress_reason"] for f in suppressed)


def test_hook_modules_all_export_entries():
    import importlib

    for mod in HOOK_MODULES:
        assert hasattr(importlib.import_module(mod), "lint_entries"), mod


# ----------------------- the counting merge --------------------------------


def _pool_block(rng, m, p, b, smax, streaming):
    """A score-descending pool and a block; ``streaming``: the block's ids
    ascend and exceed every real pool id, as the query paths merge."""
    ps = -np.sort(-rng.integers(-1, smax + 1, (m, p)), axis=1).astype(np.int32)
    bs = rng.integers(-1, smax + 1, (m, b)).astype(np.int32)
    if streaming:
        pi = np.sort(rng.choice(1000, (m, p)), axis=1).astype(np.int32)
        pi = np.where(ps < 0, S.INT32_MAX, pi).astype(np.int32)
        bi = np.broadcast_to(np.arange(1000, 1000 + b, dtype=np.int32), (m, b)).copy()
        bi = np.where(bs < 0, S.INT32_MAX, bi).astype(np.int32)
        # the pool in (score desc, id asc) order, as a merge leaves it
        order = np.lexsort((pi, -ps), axis=1)
        ps, pi = np.take_along_axis(ps, order, 1), np.take_along_axis(pi, order, 1)
    else:
        pi = rng.integers(0, 1000, (m, p)).astype(np.int32)
        bi = rng.integers(0, 1000, (m, b)).astype(np.int32)
    pd = rng.random((m, p)).astype(np.float32)
    bd = rng.random((m, b)).astype(np.float32)
    return ps, pd, pi, bs, bd, bi


def _merge(impl, arrays, smax, port=True):
    if port:
        out = S.merge_topk_pool_with_dists(*(torch.from_numpy(a) for a in arrays), impl=impl,
                                           smax=smax)
        return [o.numpy() for o in out]
    out = JS.merge_topk_pool_with_dists(*(jnp.asarray(a) for a in arrays), impl=impl, smax=smax)
    return [np.asarray(o) for o in out]


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 4), st.integers(1, 24), st.integers(1, 40),
       st.integers(1, 16))
def test_counting_merge_bits_equal_the_sort_merge_on_streaming_blocks(seed, m, p, b, smax):
    """Every impl, equal bits (scores, dists, ids) on the pools the query
    paths build, and equal to the JAX package's counting merge."""
    arrays = _pool_block(np.random.default_rng(seed), m, p, b, smax, streaming=True)
    want = _merge("sort", arrays, smax)
    for impl in ("topk", "counting", "auto"):
        for got, w in zip(_merge(impl, arrays, smax), want):
            np.testing.assert_array_equal(got, w)
    for got, w in zip(_merge("counting", arrays, smax, port=False), want):
        np.testing.assert_array_equal(got, w)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 4), st.integers(1, 24), st.integers(1, 40),
       st.integers(1, 16))
def test_counting_merge_bits_equal_the_references_on_any_block(seed, m, p, b, smax):
    """On blocks in any order (ties by position, not id) the port's counting
    merge equals the JAX package's counting and top_k merges bit for bit,
    and the port's sort merge equals the JAX package's sort merge."""
    arrays = _pool_block(np.random.default_rng(seed), m, p, b, smax, streaming=False)
    got = _merge("counting", arrays, smax)
    for ref_impl in ("counting", "topk"):
        for g, w in zip(got, _merge(ref_impl, arrays, smax, port=False)):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(_merge("sort", arrays, smax), _merge("sort", arrays, smax, port=False)):
        np.testing.assert_array_equal(g, w)


def test_merge_impl_errors_are_the_references():
    s = torch.zeros((1, 2), dtype=torch.int32)
    for impl, kw, match in (("bogus", {}, "impl must be one of"),
                            ("counting", {}, "needs smax"),
                            ("counting", {"smax": 3}, "requires integer scores")):
        scores = s.float() if "integer" in match else s
        with pytest.raises(ValueError, match=match):
            S.merge_topk_pool(scores, s, scores, s, impl=impl, **kw)
        with pytest.raises(ValueError, match=match):
            JS.merge_topk_pool(jnp.asarray(scores.numpy()), jnp.asarray(s.numpy()),
                               jnp.asarray(scores.numpy()), jnp.asarray(s.numpy()),
                               impl=impl, **kw)
    assert S._resolve_merge_impl("auto", torch.int32, 8) == "counting"
    assert S._resolve_merge_impl("auto", torch.float32, 8) == "topk"


@pytest.mark.parametrize("mode", ["fused", "streaming"])
def test_query_paths_give_equal_bits_under_every_merge(mode):
    x, q, index = suco._lint_problem()
    index = dataclasses.replace(
        index, tombstone=torch.from_numpy(np.random.default_rng(3).random(x.shape[0]) < 0.05))
    kw = dict(k=10, alpha=0.05, beta=0.02, mode=mode, block_n=4096,
              tiles=TileConfig(block_n=4096, survivor_cap=64) if mode == "fused" else None)
    want = suco.suco_query(x, index, q, merge_impl="sort", **kw)
    for impl in ("topk", "counting", "auto"):
        got = suco.suco_query(x, index, q, merge_impl=impl, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), impl


# ----------------------- kernels as operators ------------------------------

_OPS = ("sc_scores_cells", "sc_scores_cells_prefilter", "sc_scores_cells_prefilter_compact",
        "sc_scores_fused", "gather_rerank_block", "pairwise_sqdist", "kmeans_stats",
        "kmeans_pair_assign_hist", "kmeans_assign_batched", "kmeans_assign")


def _op_inputs() -> dict:
    g = torch.Generator().manual_seed(0)
    ns, m, kc, bc = 2, 3, 64, 40
    x = torch.randn((4, 50, 6), generator=g)
    return dict(
        ranks=torch.randint(0, kc, (ns, m, kc), generator=g, dtype=torch.int32),
        cuts=torch.randint(0, 20, (ns, m), generator=g, dtype=torch.int32),
        cells=torch.randint(0, kc, (ns, bc), generator=g, dtype=torch.int32),
        thr=torch.zeros(m, dtype=torch.int32),
        x=x, c=torch.randn((4, 7, 6), generator=g), qs=x[:2, :3].contiguous(), xs=x[:2],
        tau=torch.full((2, 3), 5.0), ids=torch.randint(0, 50, (3, 5), generator=g),
        x0=x[0], q0=x[1, :3].contiguous(), q5=x[0, :5].contiguous(), x1=x[1], c0=x[0, :7],
    )


_OP_CALLS = {
    "sc_scores_cells": lambda t: score_ops.sc_scores_cells(t["ranks"], t["cuts"], t["cells"]),
    "sc_scores_cells_prefilter": lambda t: score_ops.sc_scores_cells_prefilter(
        t["ranks"], t["cuts"], t["cells"], t["thr"]),
    "sc_scores_cells_prefilter_compact": lambda t: score_ops.sc_scores_cells_prefilter_compact(
        t["ranks"], t["cuts"], t["cells"], t["thr"], 40, cap=8),
    "sc_scores_fused": lambda t: score_ops.sc_scores_fused(t["qs"], t["xs"], t["tau"]),
    "gather_rerank_block": lambda t: gather_ops.gather_rerank_block(t["ids"], t["x0"], t["q0"]),
    "pairwise_sqdist": lambda t: pairwise_ops.pairwise_sqdist(t["q5"], t["x1"]),
    "kmeans_stats": lambda t: kmeans_ops.kmeans_stats(t["x"], t["c"], block_n=16,
                                                      with_assign=True),
    "kmeans_pair_assign_hist": lambda t: kmeans_ops.kmeans_pair_assign_hist(t["x"], t["c"],
                                                                            block_n=16),
    "kmeans_assign_batched": lambda t: kmeans_ops.kmeans_assign_batched(t["x"], t["c"],
                                                                        block_n=16),
    "kmeans_assign": lambda t: kmeans_ops.kmeans_assign(t["x0"], t["c0"]),
}


@pytest.mark.parametrize("name", _OPS)
def test_each_kernel_op_is_one_operator_with_a_meta_impl(name):
    """The op traces as one ``repro_torch`` operator, and on fake tensors of
    the same shapes its Meta implementation gives the CPU outputs' shapes
    and dtypes, touching no library."""
    call, inputs = _OP_CALLS[name], _op_inputs()
    assert [e.name for e in trace(call, inputs).kernel_ops()] == [name]
    real = call(inputs)
    with FakeTensorMode() as mode:
        fake = call({k: mode.from_tensor(v) for k, v in inputs.items()})
    real, fake = ((o if isinstance(o, tuple) else (o,)) for o in (real, fake))
    assert [(tuple(t.shape), t.dtype) for t in real if t is not None] == \
           [(tuple(t.shape), t.dtype) for t in fake if t is not None]


def test_ops_on_a_meta_tensor_still_raise():
    x = torch.empty((4, 10, 2), device="meta")
    with pytest.raises(ValueError, match="no kmeans_stats route"):
        kmeans_ops.kmeans_stats(x, torch.empty((4, 3, 2), device="meta"), block_n=8)
    assert hasattr(torch.ops.repro_torch, "sc_scores_cells")
    assert not hasattr(torch.ops.repro_torch, "linear_attention")


class _Ops(TorchDispatchMode):
    """Every op the dispatcher runs, by name (no op recorder)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func._opname)
        return func(*args, **(kwargs or {}))


def _step():
    with loop_span("fixture"):
        torch.ones(3).sum()


def test_loop_spans_open_only_under_a_recorder_or_the_profiler():
    """Serving pays no span: outside an op recorder and the profiler a loop
    span issues no dispatcher op; an op trace sees it as the loop scope, and
    a profile names the step by it."""
    with _Ops() as plain:
        _step()
    assert "_record_function_enter_new" not in plain.names
    assert [e.depth for e in trace(_step).events if e.name == "sum"] == [1]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _step()
    assert "loop:fixture" in {e.key for e in prof.key_averages()}
    with _Ops() as after:
        _step()
    assert "_record_function_enter_new" not in after.names


@pytest.mark.parametrize("op,route", [("kmeans_stats", "_stats_wide"),
                                      ("kmeans_pair_assign_hist", "_pair_wide"),
                                      ("kmeans_assign_batched", "_batched_wide")])
def test_launch_plans_follow_the_cuda_implementations_route(monkeypatch, op, route):
    """The static gate's launch plans ask the same route function the
    ``CUDA`` implementation asks: forcing it flips the planned kernels."""
    from repro_torch.kernels import _plans

    x, c = TensorMeta((4, 1000, 8), torch.float32), TensorMeta((4, 16, 8), torch.float32)
    args = (x, c, 256, False) if op == "kmeans_stats" else (x, c, 256)
    narrow = {ln.kernel for ln in _plans.launches(op, args, H100_LIMITS)}
    assert "kmeans_assign_streamed_kernel" not in narrow
    monkeypatch.setattr(kmeans_ops, route, lambda s, smem: True)
    wide = {ln.kernel for ln in _plans.launches(op, args, H100_LIMITS)}
    assert "kmeans_assign_streamed_kernel" in wide


@pytest.mark.parametrize("threads,regs,smem,want", [
    (256, 255, 0, 1),          # registers: 8 warps x 8,192
    (256, 128, 46_384, 2),     # registers: 8 warps x 4,096
    (256, 98, 46_384, 2),      # 98 rounds up to 104 a thread
    (256, 32, 0, 8),           # threads: 2,048 an SM
    (128, 32, 0, 16),
    (256, 32, 100_000, 2),     # shared memory, with the 1 KB reserve a block
    (64, 16, 0, 32),           # the 32 blocks an SM
])
def test_blocks_per_sm_is_the_occupancy_calculators(threads, regs, smem, want):
    from repro_torch.kernels import _plans

    assert _plans.blocks_per_sm(threads, regs, smem, H100_LIMITS) == want


def test_pair_plan_sizes_its_grid_to_one_wave():
    """The paired assignment's launcher spreads the card's resident blocks
    over the subspaces, each block a run of whole tiles: at 1M points, 8
    subspaces and s = 8 (489 tiles of 2,048) two blocks an SM (128
    registers) give 33 blocks a subspace, one block an SM (255) 17."""
    from repro_torch.kernels import _plans

    x, c = TensorMeta((16, 1_000_000, 8), torch.float32), TensorMeta((16, 50, 8), torch.float32)
    kern = "kmeans_pair_assign_hist_kernel"
    two = _plans.launches("kmeans_pair_assign_hist", (x, c, 4096), H100_LIMITS, {kern: 128})
    one = _plans.launches("kmeans_pair_assign_hist", (x, c, 4096), H100_LIMITS)
    assert [ln.grid for ln in two] == [(33, 8, 1)] and [ln.grid for ln in one] == [(17, 8, 1)]
