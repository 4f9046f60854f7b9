"""The port's training path (``repro_torch.train``, ``Model.loss``,
``data/lm_data.py``) against the JAX package's on the CPU, on the same
seeded inputs and the same weights.

* **Data**: ``SyntheticLM`` batches bit for bit.
* **Optimizer**: ``lr_at`` at the schedule's corners (rtol 1e-6: XLA's and
  PyTorch's fp32 ``cos``); ``apply_gradients`` on the same trees with the
  clip active and decay only on >= 2-D leaves (rtol 1e-6).
* **Loss and gradients** (``test_torch_train_families.py``): in fp32 for
  the six families at reduced size.
* **Train steps**: three AdamW steps and a ``micro_steps=4`` step against
  the reference's.  Losses agree to rtol 1e-5, the first step's gradient
  norm to 1e-4 and the later ones' to 1e-3.  Adam's update is about
  ``lr * sign(g)`` wherever ``|g|`` is tiny, and a gradient within its
  rounding of zero can take the other sign in the other package.  So
  parameters agree to 1e-5, except at most 0.1% of them, and those stay
  within the largest move the steps allow (``2 * lr`` a step).
* **Checkpoints**: round trip, ``keep``, async then restore, and either
  package's checkpoint restored by the other, leaf for leaf.
* **Restart**: ``train_once`` failing at step 8, restarted from its step-5
  checkpoint, ends bit for bit where the uninterrupted run does.
* **Compression**: int8 payloads and scales bit for bit against the
  reference's ``vmap(axis_name=...)`` at world size 4, over gloo in four
  processes.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import T, flat, models
from repro.data.lm_data import LMDataConfig as JLMDataConfig, SyntheticLM as JSyntheticLM
from repro.train import checkpoint as JCKPT
from repro.train import compression as JC
from repro.train.optimizer import (OptConfig as JOptConfig, apply_gradients as japply,
                                   init_opt_state as jinit, lr_at as jlr_at)
from repro.train.train_step import make_train_step as jmake_train_step

from repro_torch.configs import reduced_config
from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
from repro_torch.launch import train as launch
from repro_torch.models import Model
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.optimizer import OptConfig, apply_gradients, init_opt_state, lr_at
from repro_torch.train.resilience import FailureInjector, StepTimer, run_with_restarts
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these cases run many small tensor ops, and with
    a thread a core in each of several test workers the pool's threads
    contend (a 3 s case took 558 s in a 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# --------------------------------- data --------------------------------------


@pytest.mark.parametrize("seed,step,batch", [(0, 0, 8), (3, 17, 4), (11, 1000, 2)])
def test_synthetic_lm_batches_equal_the_jax_packages(seed, step, batch):
    ours = SyntheticLM(LMDataConfig(512, 33, batch, seed=seed))
    ref = JSyntheticLM(JLMDataConfig(512, 33, batch, seed=seed))
    got, want = ours.batch_at(step), ref.batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    half = batch // 2
    for k, v in ours.shard_rows(got, 1, 2).items():
        assert np.array_equal(v, ref.shard_rows(want, 1, 2)[k]) and len(v) == half


# ------------------------------- optimizer -----------------------------------


def test_lr_at_agrees_at_the_schedules_corners():
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=50, min_lr_ratio=0.1)
    for s in (0, 9, 10, 30, 50, 80):
        got = float(lr_at(OptConfig(**kw), torch.tensor(s, dtype=torch.int32)))
        want = float(jlr_at(JOptConfig(**kw), jnp.asarray(s, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": {"bias": rng.normal(size=(5,)).astype(np.float32),
                  "m": rng.normal(size=(2, 3, 4)).astype(np.float32)}}


def test_apply_gradients_agrees_with_clipping_and_decay_on_matrices():
    """Three steps on the same trees: the gradients' norm ~40 against a clip
    of 1, decay 0.1 on the 2-D and 3-D leaves only (the 1-D leaf's update
    is checked without decay)."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, clip_norm=1.0)
    p_np = _opt_tree(0)
    jp = jax.tree.map(jnp.asarray, p_np)
    p = jax.tree.map(T, p_np)
    js, s = jinit(jp), init_opt_state(p)
    for i in range(3):
        g_np = jax.tree.map(lambda a: 10 * a, _opt_tree(i + 1))
        jp, js, jm = japply(jp, jax.tree.map(jnp.asarray, g_np), js, JOptConfig(**cfg))
        p, s, m = apply_gradients(p, jax.tree.map(T, g_np), s, OptConfig(**cfg))
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(m["grad_norm"]) > 30
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for name, a, b in (("params", jp, p), ("mu", js["mu"], s["mu"]), ("nu", js["nu"], s["nu"])):
            fa, fb = flat(a), flat(b)
            for k in fa:
                np.testing.assert_allclose(_np(fb[k]), np.asarray(fa[k]), rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name}{k}")
    assert int(s["step"]) == int(js["step"]) == 3 and s["step"].dtype == torch.int32
    # the 1-D leaf takes no decay: with the same gradients and no decay it moves the same
    q, _, _ = apply_gradients({"bias": T(p_np["b"]["bias"])}, {"bias": T(p_np["b"]["bias"])},
                              init_opt_state({"bias": T(p_np["b"]["bias"])}),
                              OptConfig(**dict(cfg, weight_decay=0.0)))
    r, _, _ = apply_gradients({"bias": T(p_np["b"]["bias"])}, {"bias": T(p_np["b"]["bias"])},
                              init_opt_state({"bias": T(p_np["b"]["bias"])}), OptConfig(**cfg))
    assert torch.equal(q["bias"], r["bias"])


def test_adamw_state_is_fp32_zeros_like_the_master():
    p = {"w": torch.ones((2, 3)), "n": {"s": torch.ones(3)}}
    s = init_opt_state(p)
    assert s["mu"]["w"].dtype == torch.float32 and not s["nu"]["n"]["s"].any()
    assert s["step"].dtype == torch.int32 and s["step"].shape == ()


# ------------------------------- train steps ---------------------------------


def _assert_steps_agree(jp, p, lr_total):
    fa, fb = flat(jp), flat(p)
    assert fa.keys() == fb.keys()
    n_far = n = 0
    for k in fa:
        d = np.abs(_np(fb[k]) - np.asarray(fa[k]))
        assert d.max() <= lr_total + 1e-6, k
        n_far += int((d > 1e-5).sum())
        n += d.size
    assert n_far <= 1e-3 * n, (n_far, n)


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-1.6b"])
def test_three_train_steps_agree_with_the_jax_packages(arch):
    jm, jp, m, p = models(arch, "float32", 0, n_layers=2)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jmake_train_step(jm, JOptConfig(**kw)))
    step = make_train_step(m, OptConfig(**kw))
    data = SyntheticLM(LMDataConfig(m.cfg.vocab_size, 48, 4, seed=1))
    jo, o = jinit(jp), init_opt_state(p)
    for s in range(3):
        b = data.batch_at(s)
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        p, o, met = step(p, o, {k: T(v) for k, v in b.items()})
        assert met["loss"].dtype == torch.float32 and met["loss"].shape == ()
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
        # the first step's gradients are of the same weights; later ones of
        # weights that differ where a near-zero gradient took the other sign
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                        rel=1e-4 if s == 0 else 1e-3)
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    _assert_steps_agree(jp, p, 2 * 3e-3 * 3)


def test_micro_steps_agree_with_the_jax_packages_micro_steps():
    jm, jp, m, p = models("granite-3-2b", "float32", 0, n_layers=2)
    data = SyntheticLM(LMDataConfig(m.cfg.vocab_size, 32, 8, seed=1))
    b = data.batch_at(0)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jp2, _, jmet = jax.jit(jmake_train_step(jm, JOptConfig(**kw), micro_steps=4))(
        jp, jinit(jp), {k: jnp.asarray(v) for k, v in b.items()})
    p2, _, met = make_train_step(m, OptConfig(**kw), micro_steps=4)(
        p, init_opt_state(p), {k: T(v) for k, v in b.items()})
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    _assert_steps_agree(jp2, p2, 2 * 1e-3)
    # and against the port's own full batch: the mean of equal-size micro-batch means
    _, _, full = make_train_step(m, OptConfig(**kw))(p, init_opt_state(p),
                                                     {k: T(v) for k, v in b.items()})
    assert float(met["loss"]) == pytest.approx(float(full["loss"]), rel=1e-5)


def test_train_loss_decreases():
    """The reference's test of this name on the port: 60 steps of a 2-layer
    reduced granite on ``SyntheticLM``, the schedule's whole budget."""
    cfg = dataclasses.replace(reduced_config("granite-3-2b"), n_layers=2)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt_state = init_opt_state(params)
    step = make_train_step(model, OptConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    data = SyntheticLM(LMDataConfig(cfg.vocab_size, 64, 8, seed=0))
    losses = []
    for s in range(60):
        batch = {k: T(v) for k, v in data.batch_at(s).items()}
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, f"no learning: {losses[0]} -> {losses[-1]}"


# ------------------------------- checkpoints ---------------------------------


def test_checkpoint_roundtrip(tmp_path):
    params = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    opt = init_opt_state(params)
    CKPT.save(tmp_path, 7, params=params, opt_state=opt, extra={"loss": 1.5})
    assert CKPT.latest_step(tmp_path) == 7
    step, p2, o2, extra = CKPT.restore(tmp_path, params_like=params, opt_state_like=opt)
    assert step == 7 and extra["loss"] == 1.5
    assert torch.equal(p2["a"], params["a"]) and torch.equal(o2["mu"]["b"]["c"], opt["mu"]["b"]["c"])
    assert o2["step"].dtype == torch.int32
    names = sorted(np.load(tmp_path / "step_00000007" / "opt_state.npz").files)
    assert names == ["mu/a", "mu/b/c", "nu/a", "nu/b/c", "step"]
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["groups"]["params"] == ["a", "b/c"] and manifest["step"] == 7


def test_checkpoint_keep_prunes(tmp_path):
    params = {"a": torch.ones(2)}
    for s in (1, 2, 3, 4):
        CKPT.save(tmp_path, s, params=params, keep=2)
    assert CKPT.all_steps(tmp_path) == [3, 4]
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]


def test_checkpoint_async_then_restore(tmp_path):
    params = {"a": torch.full((8,), 3.0)}
    CKPT.save(tmp_path, 5, params=params, blocking=False)
    params["a"].fill_(4.0)  # the host copy was taken before save returned
    CKPT.save(tmp_path, 6, params=params, blocking=False)
    CKPT.wait_for_pending()
    step, p2, _, _ = CKPT.restore(tmp_path, params_like=params, step=5)
    assert step == 5 and torch.equal(p2["a"], torch.full((8,), 3.0))
    assert CKPT.latest_step(tmp_path) == 6


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A model and its AdamW state written by the JAX package restore in the
    port onto ``meta`` templates (``Model.param_shapes``), and the port's
    restore in the JAX package, leaf for leaf."""
    jm, jp, m, p = models("rwkv6-1.6b", "float32", 0, n_layers=2)
    jo = jinit(jp)
    jo = dict(jo, mu=jax.tree.map(lambda a: a + 0.5, jo["mu"]), step=jnp.asarray(9, jnp.int32))
    JCKPT.save(tmp_path / "jax", 9, params=jp, opt_state=jo, extra={"loss": 2.0})
    like = m.param_shapes()
    assert all(t.device.type == "meta" for t in jax.tree.leaves(like))
    step, p2, o2, extra = CKPT.restore(tmp_path / "jax", params_like=like,
                                       opt_state_like=init_opt_state(like), device="cpu")
    assert step == 9 and extra == {"loss": 2.0} and int(o2["step"]) == 9
    for a, b in ((jp, p2), (jo["mu"], o2["mu"]), (jo["nu"], o2["nu"])):
        fa, fb = flat(a), flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert np.array_equal(np.asarray(fa[k]), _np(fb[k])), k
    CKPT.save(tmp_path / "port", 3, params=p, opt_state=init_opt_state(p))
    step, jp3, jo3, _ = JCKPT.restore(tmp_path / "port", params_like=jp, opt_state_like=jinit(jp))
    assert step == 3 and int(jo3["step"]) == 0
    fa, fb = flat(jp3), flat(p)
    for k in fa:
        assert np.array_equal(np.asarray(fa[k]), _np(fb[k])), k


# --------------------------------- restart -----------------------------------


def _args(ckpt, **kw):
    return argparse.Namespace(**dict(dict(
        arch="granite-3-2b", reduced=True, steps=12, global_batch=4, seq_len=32, d_model=0,
        micro_steps=1, lr=1e-3, seed=0, no_remat=False, ckpt_dir=str(ckpt), ckpt_every=5,
        log_every=100, mesh="none", device="cpu"), **kw))


def test_restart_resumes_and_matches_uninterrupted(tmp_path):
    """A failure at step 8 (after the step-5 checkpoint) and a restart from
    it end where the uninterrupted run ends, bit for bit."""
    model = Model(reduced_config("granite-3-2b"))
    launch.train_once(_args(tmp_path / "run1"))
    s1, p1, o1, _ = CKPT.restore(tmp_path / "run1", params_like=model.param_shapes(),
                                 opt_state_like=init_opt_state(model.param_shapes()),
                                 device="cpu")
    inj = FailureInjector(fail_at=(8,))
    restarts = run_with_restarts(lambda: launch.train_once(_args(tmp_path / "run2"), inj),
                                 max_restarts=2)
    assert restarts == 1
    s2, p2, o2, _ = CKPT.restore(tmp_path / "run2", params_like=model.param_shapes(),
                                 opt_state_like=init_opt_state(model.param_shapes()),
                                 device="cpu")
    assert s1 == s2 == 12
    for a, b in ((p1, p2), (o1, o2)):
        fa, fb = flat(a), flat(b)
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k


# ------------------------------ the launcher ---------------------------------


def test_launcher_trains_on_the_cpu_and_logs_as_the_reference(capsys):
    launch.main(["--device", "cpu", "--arch", "granite-3-2b", "--steps", "3", "--seq-len", "16",
                 "--global-batch", "2", "--log-every", "1"])
    out = capsys.readouterr().out
    assert out.count("[train] step ") == 3 and "gnorm" in out
    assert "[train] done. first loss " in out


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_launcher_refuses_a_family_that_needs_extras(arch):
    with pytest.raises(ValueError, match="needs extras"):
        launch.build(_args("", arch=arch))


def test_launcher_refuses_a_tpu_mesh():
    """A mesh runs only in a world of its size: one process asking for the
    8-rank debug mesh (or the 256-rank production mesh) is refused before
    any step, told the world it needs."""
    for mesh, need in (("debug", 8), ("prod", 256), ("prod2", 512)):
        with pytest.raises(ValueError, match=f"needs a world of {need} ranks.*has 1"):
            launch.build(_args("", mesh=mesh))
        with pytest.raises(ValueError, match=f"needs a world of {need} ranks"):
            launch.train_once(_args("", mesh=mesh))


# ------------------------------- resilience ----------------------------------


def test_step_timer_flags_stragglers_on_an_injected_clock():
    ticks = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.1, 3.1, 5.0])
    t = StepTimer(alpha=0.5, threshold=1.5, clock=lambda: next(ticks))
    for _ in range(3):
        t.start()
        t.stop()
    assert t.flagged == 0 and t.ewma == pytest.approx(1.05)
    t.start()
    dt = t.stop()
    assert dt == pytest.approx(1.9) and t.flagged == 1 and t.is_straggler(dt)
    assert t.ewma == pytest.approx(1.05)  # a straggler does not move the mean


def test_failure_injector_fails_once_and_restarts_are_bounded():
    inj = FailureInjector(fail_at=(2,))
    with pytest.raises(RuntimeError):
        inj.maybe_fail(2)
    inj.maybe_fail(2)  # once only

    def down():
        raise RuntimeError("down")

    with pytest.raises(RuntimeError):
        run_with_restarts(down, max_restarts=1)


# ------------------------------ compression ----------------------------------

_WORKER = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.train import compression as C
rank, world, init, src, dst = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
z = np.load(src)
g = {"a": torch.from_numpy(z["a"][rank]), "b": {"c": torch.from_numpy(z["c"][rank])}}
r = {"a": torch.from_numpy(z["ra"][rank]), "b": {"c": torch.from_numpy(z["rc"][rank])}}
q, s = C.quantize_int8(g["a"] + r["a"])
mean = C.int8_allreduce(g["a"])
out, new_r = C.compressed_grad_allreduce(g, None, r)
np.savez(dst, q=q.numpy(), s=s.numpy(), mean=mean.numpy(), out_a=out["a"].numpy(),
         out_c=out["b"]["c"].numpy(), ra=new_r["a"].numpy(), rc=new_r["b"]["c"].numpy())
dist.barrier()
dist.destroy_process_group()
"""


def test_int8_allreduce_over_gloo_equals_the_jax_packages_vmap(tmp_path):
    world = 4
    rng = np.random.default_rng(5)
    z = dict(a=rng.normal(size=(world, 300)).astype(np.float32),
             c=(rng.normal(size=(world, 7, 5)) * 3).astype(np.float32),
             ra=(rng.normal(size=(world, 300)) * 0.01).astype(np.float32),
             rc=(rng.normal(size=(world, 7, 5)) * 0.01).astype(np.float32))
    np.savez(tmp_path / "in.npz", **z)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), f"file://{tmp_path / 'rdv'}",
         str(tmp_path / "in.npz"), str(tmp_path / f"out{r}.npz")], env=env)
        for r in range(world)]
    assert [p.wait(timeout=120) for p in procs] == [0] * world
    got = [np.load(tmp_path / f"out{r}.npz") for r in range(world)]

    def ref(ga, gc, ra, rc):
        q, s = JC.quantize_int8(ga + ra)
        out, new_r = JC.compressed_grad_allreduce({"a": ga, "b": {"c": gc}}, "dp",
                                                  {"a": ra, "b": {"c": rc}})
        return q, s, JC.int8_allreduce(ga, "dp"), out["a"], out["b"]["c"], new_r["a"], \
            new_r["b"]["c"]

    want = jax.jit(jax.vmap(ref, axis_name="dp"))(*(jnp.asarray(z[k]) for k in
                                                     ("a", "c", "ra", "rc")))
    for r in range(world):
        assert np.array_equal(got[r]["q"], np.asarray(want[0][r]))
        assert got[r]["q"].dtype == np.int8
        assert np.array_equal(got[r]["s"], np.asarray(want[1][r]))
        # the means and residuals within two fp32 ulps of the largest gradient
        # (|g| < 16, an ulp 2^-20): the packages round ``g - q * s`` and the sum
        # over the ranks apart
        for i, name in ((2, "mean"), (3, "out_a"), (4, "out_c"), (5, "ra"), (6, "rc")):
            np.testing.assert_allclose(got[r][name], np.asarray(want[i][r]), rtol=0,
                                       atol=2.0 ** -19, err_msg=name)
    true = z["a"].mean(0)
    assert np.abs(got[0]["mean"] - true).max() < 0.05  # int8 precision
