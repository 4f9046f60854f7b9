"""The LM stack sharded over a mesh (``repro_torch.launch.mesh`` /
``shardings``, ``models.shard_ctx``) against the same port unsharded, in 8
gloo processes on the ``(2, 2, 2)`` debug mesh (pod, data, model), on the
CPU.

Each architecture's weights are the JAX package's reduced fp32 model's
(``jax.random.key(0)``), carried over with ``convert.params_from_jax``; the
batch is 8 seeded rows of 64 tokens.  Every rank draws the same tree, keeps
its share (``shardings.distribute_tree`` by ``param_specs`` /
``batch_specs``) and runs:

* ``rwkv6-1.6b`` (row 11's plain version on each rank's ``batch_heads``
  rows, through ``local_map``), ``granite-3-2b`` (dense; its one KV head
  does not divide the tensor axis, so K / V replicate there and the queries
  fall back to the sequence) and ``olmoe-1b-7b`` (MoE, 8 experts: the
  routing and the dispatch on each rank's batch rows): the loss and every
  gradient of ``loss_and_grads`` in ``shard_ctx.sharded``, and one step of
  ``make_train_step(mesh=...)`` (AdamW), against the unsharded port's;
* ``granite-3-2b``: a prefill of 24 tokens into a 32-position fp32 cache
  (sequence-sharded over the tensor axis) and one decode step: the logits
  of both and the cache's K / V entry by entry.

Tolerances.  The sharded run is the unsharded arithmetic with fp32 sums
regrouped: each weight gradient's sum over the ``N = B * S`` tokens is
split over the batch shards and added by the reduce-scatter; the
row-parallel products (``wo``, ``w_down``, the channel mix's ``wv``, the
experts' down-projection) and the vocab's logsumexp are split over the
tensor shards.  Each compared value is held to the sum of two terms, both
from the unsharded run:

* the last reduction regrouped: an fp32 sum of ``K`` terms moves by at most
  ``2 gamma_K * sum |terms|`` (``gamma_K = K u / (1 - K u)``, ``u =
  2^-24``), with ``K = N + max(d_model, d_ff, q_dim, padded vocab)`` (the
  token sum and the longest contraction feeding it); the loss is a mean
  of non-negative token NLLs (``sum |terms| = loss``), a gradient leaf's
  terms are the per-row gradients ``g_b`` (each row's share of the loss
  alone: ``max(sum_b |g_b|)``), a logit's are ``|h| @ |W|`` (``h`` the
  final hidden, rms-normalised: at most ``sqrt(D) |scale|_2 max |W|``,
  ``K = d_model + n_layers * (q_dim + d_ff) + S``), a cache entry's are
  the K / V projection's of the layer's normed input, bounded the same way
  with the layer's ``ln1`` scale (``K = d_model``; K's rotation adds its
  pair's terms, ``|cos|, |sin| <= 1``, and three roundings: ``K = d_model
  + 3``);
* what the regroupings upstream of it do, through the network: the same
  value's move when every param is moved by one rounding (``p * (1 +
  2^-24 xi)``, ``xi ~ N(0, 1)``, the probe).  A regrouped sum differs from
  the other grouping by about a rounding of its result, so the probe is
  the model's own response to perturbations of that size.  It matters for
  the reduced RWKV6 on this batch, whose gradients move by 2.1e-3 of a
  leaf's largest entry under the probe (granite: 2.5e-6).

The global norm adds the norm of the leaf bounds; the updated params
follow AdamW's first step, ``lr * g / (|g| + eps / s)`` (``s`` the clip
scale) plus the decay: where ``|g|`` is within its leaf's bound of 0 the
sign may differ (``2 lr``), elsewhere the update moves by at most ``lr
(eps b + |g| d) / ((|g| - b + eps / s) (|g| + eps / s))`` for a gradient
bound ``b`` and a move ``d`` of ``eps / s`` (the norm's bound times
``eps`` when the clip acts), plus the roundings of the update and the
probe's move of the param.

The placements are checked too: the new params and moments keep the
params', the gradients come back in them, the cache in ``cache_specs``'.
A rank's log is in ``tmp_path/rank*.log``.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as j_reduced_config
from repro.models import Model as JModel

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TIMEOUT = 600  # a hung rendezvous fails the test; a run beside other test files is slower
TRAIN_ARCHS = ("rwkv6-1.6b", "granite-3-2b", "olmoe-1b-7b")
SERVE_ARCH = "granite-3-2b"
B, S, PROMPT, MAX_SEQ = 8, 64, 24, 32
U = 2.0**-24

_WORKER = textwrap.dedent(
    """
    import dataclasses, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs import reduced_config
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model, convert
    from repro_torch.models.model import ShapeSpec
    from repro_torch.models import prefill as P, decode as D
    from repro_torch.models.shard_ctx import sharded
    from repro_torch.train._tree import items
    from repro_torch.train.optimizer import OptConfig, apply_gradients, init_opt_state
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    rank, world, init, wdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    mesh = make_debug_mesh((2, 2, 2))
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = {}

    def tree(npz, prefix):
        t = {}
        for key, val in npz.items():
            if not key.startswith(prefix):
                continue
            node, *path = key[len(prefix):].split("/")
            cur = t
            for part in [node, *path][:-1]:
                cur = cur.setdefault(part, {})
            cur[[node, *path][-1]] = val
        return t

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def bump(tree):
        # every param times (1 + 2^-24 xi), xi ~ N(0, 1) from a fixed seed
        gen = torch.Generator().manual_seed(7)
        return {k: bump(v) if isinstance(v, dict) else
                v * (1 + 2.0**-24 * torch.randn(v.shape, generator=gen)) for k, v in
                sorted(tree.items())}

    def same_places(a, b, what):
        for (p, x), (_, y) in zip(items(a), items(b)):
            assert tuple(x.placements) == tuple(y.placements), (what, p, x.placements,
                                                                 y.placements)

    data = dict(np.load(f"{wdir}/inputs.npz"))
    for arch in sys.argv[5].split(","):
        cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
        model = Model(cfg)
        params = convert.params_from_jax(tree(data, f"{arch}|"), device="cpu")
        batch = {"tokens": torch.from_numpy(data[f"{arch}:tokens"]),
                 "labels": torch.from_numpy(data[f"{arch}:labels"])}
        b, s = batch["tokens"].shape
        # unsharded: the loss, the gradients, one AdamW step, per-row gradients,
        # and the same step on params moved by one rounding (the probe)
        loss0, g0 = loss_and_grads(model, params, batch)
        new0, _, m0 = apply_gradients(params, g0, init_opt_state(params), ocfg)
        if rank == 0:
            moved = bump(params)
            loss_b, g_b = loss_and_grads(model, moved, batch)
            new_b, _, m_b = apply_gradients(moved, g_b, init_opt_state(moved), ocfg)
            out[f"{arch}:probe:loss"] = np.float64(abs(float(loss_b) - float(loss0)))
            out[f"{arch}:probe:gn"] = np.float64(abs(float(m_b["grad_norm"])
                                                     - float(m0["grad_norm"])))
            for (p, x), (_, y) in zip(items(g0), items(g_b)):
                out[f"{arch}:probe:g:{p}"] = np.float64((x - y).abs().max())
            for (p, x), (_, y) in zip(items(new0), items(new_b)):
                out[f"{arch}:probe:new:{p}"] = (x - y).abs().numpy()
            out[f"{arch}:loss0"], out[f"{arch}:gn0"] = loss0.numpy(), m0["grad_norm"].numpy()
            out[f"{arch}:scale0"] = np.float32(min(1.0, 1.0 / max(float(m0["grad_norm"]), 1e-9)))
            rows = {}
            n_all = float((batch["labels"] >= 0).sum())
            for r in range(b):
                one = {k: v[r:r + 1] for k, v in batch.items()}
                weight = float((one["labels"] >= 0).sum()) / n_all
                _, gr = loss_and_grads(model, params, one)
                for p, g in items(gr):
                    rows[p] = rows.get(p, 0) + weight * g.abs()
            for p, g in items(g0):
                out[f"{arch}:g0:{p}"] = g.numpy()
                out[f"{arch}:rows:{p}"] = rows[p].numpy()
            for p, x in items(new0):
                out[f"{arch}:new0:{p}"] = x.numpy()
            for p, x in items(params):
                out[f"{arch}:p:{p}"] = x.numpy()
        # sharded
        shape = ShapeSpec("t", "train", s, b)
        dp = SH.distribute_tree(mesh, SH.param_specs(cfg, mesh, params), params)
        db = SH.distribute_tree(mesh, SH.batch_specs(cfg, mesh, shape, batch), batch)
        with sharded(mesh):
            loss, g = loss_and_grads(model, dp, db)
        same_places(g, dp, "grads")
        step = make_train_step(model, ocfg, mesh=mesh)
        new, opt, m = step(dp, init_opt_state(dp), db)
        same_places(new, dp, "params")
        same_places(opt["mu"], dp, "mu")
        same_places(opt["nu"], dp, "nu")
        fl = {p: full(x) for p, x in items(g)}
        fn = {p: full(x) for p, x in items(new)}
        vals = full(loss), full(m["grad_norm"]), full(m["loss"])
        if rank == 0:
            out[f"{arch}:loss"], out[f"{arch}:gn"], out[f"{arch}:step_loss"] = (
                v.numpy() for v in vals)
            for p, x in fl.items():
                out[f"{arch}:g:{p}"] = x.numpy()
            for p, x in fn.items():
                out[f"{arch}:new:{p}"] = x.numpy()

    # prefill and one decode step of the dense model, fp32 cache
    arch = sys.argv[6]
    cfg = dataclasses.replace(reduced_config(arch), dtype="float32")
    model = Model(cfg)
    params = convert.params_from_jax(tree(data, f"{arch}|"), device="cpu")
    prompt = torch.from_numpy(data[f"{arch}:prompt"])
    nxt = torch.from_numpy(data[f"{arch}:next"])
    b, s = prompt.shape
    with torch.no_grad():
        lg0, c0 = P.prefill(cfg, params, prompt, max_seq=int(sys.argv[7]),
                            cache_dtype=torch.float32)
        dl0, c0 = D.decode_step(cfg, params, c0, nxt, s)
        if rank == 0:
            lgb, cb = P.prefill(cfg, bump(params), prompt, max_seq=int(sys.argv[7]),
                                cache_dtype=torch.float32)
            dlb, cb = D.decode_step(cfg, bump(params), cb, nxt, s)
            out["serve:probe:prefill"] = (lgb - lg0).abs().numpy()
            out["serve:probe:decode"] = (dlb - dl0).abs().numpy()
            for k in c0:
                out[f"serve:probe:cache:{k}"] = (cb[k] - c0[k]).abs().numpy()
    dp = SH.distribute_tree(mesh, SH.param_specs(cfg, mesh, params), params)
    shape = ShapeSpec("p", "prefill", int(sys.argv[7]), b)
    dprompt = SH.distribute_tree(mesh, SH.batch_specs(cfg, mesh, shape, {"tokens": prompt}),
                                 {"tokens": prompt})["tokens"]
    dnext = SH.distribute_tree(mesh, SH.Spec(("pod", "data")), nxt)
    with torch.no_grad(), sharded(mesh):
        lg, c = P.prefill(cfg, dp, dprompt, max_seq=int(sys.argv[7]), cache_dtype=torch.float32)
        want = SH.fit_tree(SH.cache_specs(cfg, mesh, shape), c, mesh)
        for name in c:
            assert list(c[name].placements) == SH.to_placements(mesh, want[name], 5), name
        lgf = full(lg)
        dl, c = D.decode_step(cfg, dp, c, dnext, s)
        dlf = full(dl)
        cf = {k: full(v) for k, v in c.items()}
    if rank == 0:
        out["serve:prefill0"], out["serve:prefill"] = lg0.numpy(), lgf.numpy()
        out["serve:decode0"], out["serve:decode"] = dl0.numpy(), dlf.numpy()
        for k in c0:
            out[f"serve:cache0:{k}"], out[f"serve:cache:{k}"] = c0[k].numpy(), cf[k].numpy()
        np.savez(f"{wdir}/port.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    """
)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out.update(_flat(val, path) if isinstance(val, dict) else {path: np.asarray(val)})
    return out


def _inputs(path: Path) -> None:
    """The JAX package's reduced fp32 weights of each architecture and the
    seeded batches, in one npz the ranks read."""
    out = {}
    rng = np.random.default_rng(1)
    for arch in sorted({*TRAIN_ARCHS, SERVE_ARCH}):
        cfg = dataclasses.replace(j_reduced_config(arch), dtype="float32")
        params = JModel(cfg).init(jax.random.key(0))
        out.update({f"{arch}|{k}": v for k, v in _flat(params).items()})
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out[f"{arch}:tokens"], out[f"{arch}:labels"] = toks[:, :-1], toks[:, 1:]
        out[f"{arch}:prompt"] = toks[:, :PROMPT]
        out[f"{arch}:next"] = toks[:, PROMPT]
    np.savez(path, **out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    wdir = tmp_path_factory.mktemp("mesh")
    _inputs(wdir / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    logs = [open(wdir / f"rank{r}.log", "w+") for r in range(8)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), "8", f"file://{wdir / 'rdv'}", str(wdir),
         ",".join(TRAIN_ARCHS), SERVE_ARCH, str(MAX_SEQ)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(8)]
    try:
        rcs = [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r}\n{f.read()[-3000:]}")
        f.close()
    assert rcs == [0] * 8, "\n".join(text)
    return dict(np.load(wdir / "port.npz"))


def _gamma(k: int) -> float:
    return k * U / (1 - k * U)


def _cfg(arch):
    from repro_torch.configs import reduced_config

    return dataclasses.replace(reduced_config(arch), dtype="float32")


def _k_train(cfg) -> int:
    return B * S + max(cfg.d_model, cfg.d_ff, cfg.q_dim, cfg.padded_vocab)


def _grad_bounds(port, arch):
    """Each gradient leaf's bound: the batch sum regrouped, and the probe."""
    g = _gamma(_k_train(_cfg(arch)))
    keys = [k.split(":", 2)[2] for k in port if k.startswith(f"{arch}:g0:")]
    return {p: 2 * g * float(port[f"{arch}:rows:{p}"].max())
            + float(port[f"{arch}:probe:g:{p}"]) for p in keys}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_loss_matches_unsharded(port, arch):
    loss0, loss = float(port[f"{arch}:loss0"]), float(port[f"{arch}:loss"])
    tol = 2 * _gamma(_k_train(_cfg(arch))) * loss0 + float(port[f"{arch}:probe:loss"])
    assert abs(loss - loss0) <= tol, (loss, loss0, tol)
    assert float(port[f"{arch}:step_loss"]) == loss  # the step's loss is the same program's


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_gradients_match_unsharded(port, arch):
    for p, tol in _grad_bounds(port, arch).items():
        got, want = port[f"{arch}:g:{p}"], port[f"{arch}:g0:{p}"]
        assert got.shape == want.shape, p
        assert np.abs(got - want).max() <= tol, (p, np.abs(got - want).max(), tol)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_adamw_step_matches_unsharded(port, arch):
    bounds = _grad_bounds(port, arch)
    gn0 = float(port[f"{arch}:gn0"])
    leaf_norm = np.sqrt(sum(port[f"{arch}:g0:{p}"].size * b * b for p, b in bounds.items()))
    tol_gn = leaf_norm + 2 * _gamma(_k_train(_cfg(arch))) * gn0 + float(port[f"{arch}:probe:gn"])
    assert abs(float(port[f"{arch}:gn"]) - gn0) <= tol_gn
    lr, eps, wd, s = 1e-3, 1e-8, 0.1, float(port[f"{arch}:scale0"])
    e = eps / s
    de = eps * tol_gn if gn0 > 1 else 0.0  # the clip scale's share: eps / s = eps * gn
    for p, b in bounds.items():
        g0 = np.abs(port[f"{arch}:g0:{p}"].astype(np.float64))
        p0 = np.abs(port[f"{arch}:p:{p}"].astype(np.float64))
        near = g0 <= b  # the sign of the update may differ
        moved = (e * b + g0 * de) / (np.maximum(g0 - b, 0) + e) / (g0 + e)
        rounding = 2 * U * (p0 + 3 * lr * (1 + wd * p0))
        tol = lr * np.where(near, 2.0, moved) + rounding + port[f"{arch}:probe:new:{p}"]
        diff = np.abs(port[f"{arch}:new:{p}"].astype(np.float64) - port[f"{arch}:new0:{p}"])
        assert (diff <= tol).all(), (p, diff.max(), np.argmax(diff - tol))


def test_sharded_prefill_and_decode_match_unsharded(port):
    cfg = _cfg(SERVE_ARCH)
    g = _gamma(cfg.d_model + cfg.n_layers * (cfg.q_dim + cfg.d_ff) + MAX_SEQ)
    w = (port[f"{SERVE_ARCH}:p:embed"].T if cfg.tie_embeddings
         else port[f"{SERVE_ARCH}:p:lm_head/w"])
    # the final norm's output h is rms-normalised, so by Cauchy-Schwarz
    # |h|_1 <= sqrt(D) |scale|_2, and (|h| @ |W|)_v <= |h|_1 max_d |W_dv|
    h1 = np.sqrt(cfg.d_model) * np.linalg.norm(port[f"{SERVE_ARCH}:p:final_norm/scale"])
    real = slice(0, cfg.vocab_size)
    for name in ("prefill", "decode"):
        got, want = port[f"serve:{name}"], port[f"serve:{name}0"]
        assert got.shape == want.shape == (B, cfg.padded_vocab)
        tol = 2 * g * h1 * np.abs(w).max(axis=0) + port[f"serve:probe:{name}"]
        assert (np.abs(got - want)[:, real] <= tol[:, real]).all(), name
        assert (got[:, cfg.vocab_size:] == -1e30).all()
    # each cache entry (L, B, KVH, S, hd) up to the decode's position: the
    # K / V projection of the layer's rms-normalised input (|h|_1 <= sqrt(D)
    # |ln1_l|_2), so its terms sum to at most sqrt(D) |ln1_l|_2 max_d |W_dj|
    h1 = np.sqrt(cfg.d_model) * np.linalg.norm(port[f"{SERVE_ARCH}:p:blocks/ln1/scale"], axis=-1)
    hd, written = cfg.head_dim, slice(0, PROMPT + 1)
    for key in ("k", "v"):
        got, want = port[f"serve:cache:{key}"], port[f"serve:cache0:{key}"]
        assert got.shape == want.shape == (cfg.n_layers, B, cfg.n_kv_heads, MAX_SEQ, hd)
        assert (got[:, :, :, PROMPT + 1:] == 0).all()  # nothing written past the decode
        w = np.abs(port[f"{SERVE_ARCH}:p:blocks/attn/w{key}/w"]).max(axis=1)  # (L, KVH * hd)
        terms = (h1[:, None] * w).reshape(cfg.n_layers, cfg.n_kv_heads, hd)
        k_sum = cfg.d_model
        if key == "k":  # the rotation mixes dim j with j +- hd / 2
            terms, k_sum = terms + np.roll(terms, hd // 2, axis=-1), cfg.d_model + 3
        tol = (2 * _gamma(k_sum) * terms[:, None, :, None, :]
               + port[f"serve:probe:cache:{key}"][:, :, :, written])
        diff = np.abs(got[:, :, :, written] - want[:, :, :, written])
        assert (diff <= tol).all(), (key, diff.max(), np.unravel_index(np.argmax(diff - tol),
                                                                       diff.shape))
