"""The port's ``train/`` (optimizer, checkpoint, fault, train loop) and
``launch/train.py`` against the JAX reference's, in-process on the CPU.

The optimizer cases of ``tests/test_optimizer.py`` (convergence on a
quadratic, the schedule's shape, the int8 round trip, error feedback),
each run on both packages from the same start, float32, with the port's
weights within 1e-6 of the reference's (the int8 path's over its first
50 steps); the bfloat16
update finding (ROADMAP Queue 3) on both; the checkpoint cases of
``tests/test_checkpoint.py`` (round trip, gc, resume) plus a nested dict
saved by each package and restored by the other; a SIGTERM during
``train``; and the launcher.
"""
import os
import re
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as RCK
from repro.train import optimizer as ROPT
from repro_torch.configs.base import get_smoke_config
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as launch
from repro_torch.models import model as PM
from repro_torch.train import checkpoint as PCK
from repro_torch.train import optimizer as POPT
from repro_torch.train.train_loop import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def quadratic_runs(oc_args, target, steps):
    """``steps`` AdamW steps on sum((w - target)^2) from w = 0 on both
    packages.  Returns (port's w, reference's w, port's state)."""
    target = np.asarray(target, np.float32)
    r_oc, p_oc = ROPT.OptConfig(**oc_args), POPT.OptConfig(**oc_args)
    params = {"w": jnp.zeros(len(target))}
    state = ROPT.init_opt_state(params, r_oc)

    @jax.jit
    def step(params, state, i):
        g = jax.grad(lambda p: jnp.sum((p["w"] - target) ** 2))(params)
        return ROPT.apply_updates(g, state, params, i, r_oc)

    w = torch.zeros(len(target))
    p_state = POPT.init_opt_state({"w": w}, p_oc)
    t = torch.from_numpy(target)
    for i in range(steps):
        params, state, _ = step(params, state, jnp.asarray(i))
        POPT.apply_updates({"w": 2 * (w - t)}, p_state, {"w": w}, i, p_oc)
    return w.numpy(), np.asarray(params["w"]), p_state


def test_adamw_converges_quadratic():
    target = [1.5, -2.0, 0.5]
    got, want, _ = quadratic_runs(dict(lr=0.05, warmup_steps=5,
                                       total_steps=300, weight_decay=0.0),
                                  target, 300)
    np.testing.assert_allclose(got, target, atol=0.05)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_grad_compress_error_feedback():
    """int8 update compression converges thanks to error feedback.  The
    two packages agree within 1e-6 over the first 50 steps; later, a
    quantization step that rounds the other way in one of them (a tie
    within float32 rounding) parts them by up to 1e-5."""
    target = [0.3, -0.7, 1.1, 0.0]
    oc = dict(lr=0.05, warmup_steps=1, total_steps=400, weight_decay=0.0,
              grad_compress=True)
    got, want, _ = quadratic_runs(oc, target, 50)
    np.testing.assert_allclose(got, want, atol=1e-6)
    got, want, state = quadratic_runs(oc, target, 400)
    assert "err" in state
    np.testing.assert_allclose(got, target, atol=0.1)
    np.testing.assert_allclose(want, target, atol=0.1)


def test_schedule_shape():
    oc = POPT.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    s0, s10, s100 = (float(POPT.schedule(oc, s)) for s in (0, 10, 100))
    assert s0 < s10
    assert s100 < s10
    assert s100 >= 0.09 * 1e-3   # cosine floor at 10%
    r_oc = ROPT.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 3, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(POPT.schedule(oc, s)),
            float(ROPT.schedule(r_oc, jnp.asarray(s))), rtol=1e-6)


def test_quantize_int8_roundtrip():
    x = [0.0, 1.0, -2.0, 0.5, 0.25, -1e-3]
    q, s = POPT._quantize_int8(torch.tensor(x))
    err = float((q.float() * s - torch.tensor(x)).abs().max())
    assert err <= float(s)   # quantization error bounded by one step
    q_r, s_r = ROPT._quantize_int8(jnp.asarray(x))
    assert q.numpy().tolist() == np.asarray(q_r).tolist()
    assert float(s) == float(s_r)


def test_zero_sharding_helpers_raise():
    """The ZeRO-1 helpers, which raised until training on a mesh was
    ported, give the reference's ``zero1_spec`` on the port's specs (a
    tuple of "model" / "data" / None where the reference has a
    ``PartitionSpec``); only the production mesh still raises."""
    from jax.sharding import PartitionSpec as P
    from repro_torch.launch import mesh as PMESH
    cases = [((None, "model"), (64, 128)), ((None, None), (64, 128)),
             ((None,), (63,)), (("data", None), (64, 128)),
             (("model", None, None), (8, 64, 32)), ((), (6, 4))]
    for spec, shape in cases:
        for dp in (2, 4):
            ref = ROPT.zero1_spec(
                P(*[("data",) if a == "data" else a for a in spec]), shape,
                ("data",), dp)
            want = tuple("data" if e == ("data",) else e for e in ref)
            assert POPT.zero1_spec(spec, shape, dp) == want, (spec, dp)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        PMESH.make_production_mesh()


def test_bfloat16_update_is_lost_below_half_an_ulp():
    """The reference's new weight is (p + delta) rounded to p's dtype
    (``src/repro/train/optimizer.py:121-123``), and its float32 master
    only feeds the weight decay.  A bfloat16 weight at std 0.02 whose
    first update is at lr 3e-6 (``OptConfig()``'s warmup) keeps its value
    in most elements while its master moves in every one, on both
    packages; the port keeps the arithmetic (ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((256, 256)) * 0.02).astype(np.float32)
    g = (rng.standard_normal((256, 256)) * 1e-3).astype(np.float32)
    oc_r, oc_p = ROPT.OptConfig(), POPT.OptConfig()
    p_r = {"w": jnp.asarray(w, jnp.bfloat16)}
    new_r, st_r, _ = ROPT.apply_updates(
        {"w": jnp.asarray(g, jnp.bfloat16)}, ROPT.init_opt_state(p_r, oc_r),
        p_r, jnp.asarray(0), oc_r)
    p_p = {"w": torch.from_numpy(w).bfloat16()}
    old = p_p["w"].clone()
    st_p = POPT.init_opt_state(p_p, oc_p)
    POPT.apply_updates({"w": torch.from_numpy(g).bfloat16()}, st_p, p_p, 0,
                       oc_p)
    changed_p = (p_p["w"] != old).float().mean().item()
    changed_r = float(jnp.mean((new_r["w"] != p_r["w"]).astype(jnp.float32)))
    moved_p = (st_p["master"]["w"] != old.float()).float().mean().item()
    moved_r = float(jnp.mean((st_r["master"]["w"] != p_r["w"].astype(
        jnp.float32)).astype(jnp.float32)))
    assert changed_p < 0.1 and changed_r < 0.1, (changed_p, changed_r)
    assert moved_p > 0.99 and moved_r > 0.99, (moved_p, moved_r)
    got = p_p["w"].float().numpy()
    want = np.asarray(new_r["w"].astype(jnp.float32))
    assert np.mean(got != want) < 1e-3


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": torch.randn(4, 2).bfloat16()}}
    mgr = PCK.CheckpointManager(str(tmp_path))
    mgr.save(7, tree, extra={"step": 7}, blocking=True)
    assert mgr.latest_step() == 7
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5, dtype=torch.int32),
                                         "d": torch.zeros(4, 2).bfloat16()}}
    restored, extra = mgr.restore(like)
    assert extra["step"] == 7
    for k, v in (("a", tree["a"]), ("c", tree["b"]["c"]),
                 ("d", tree["b"]["d"])):
        got = restored[k] if k == "a" else restored["b"][k]
        assert got.dtype == v.dtype and torch.equal(got, v)
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore({"a": torch.zeros(3, 4)})


def test_gc_keeps_latest(tmp_path):
    mgr = PCK.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(3)}, blocking=True)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_nested_dict_crosses_packages(writer, tmp_path):
    """A plain nested dict of arrays saved by one package restores in the
    other: the same file names, leaf names and order."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "opt": {"mu": rng.standard_normal(4).astype(np.float32),
                    "count": np.arange(5, dtype=np.int32)},
            "b": np.ones(2, np.float32)}
    if writer == "reference":
        RCK.CheckpointManager(str(tmp_path)).save(
            3, jax.tree.map(jnp.asarray, tree), extra={"step": 3},
            blocking=True)
        got, extra = PCK.CheckpointManager(str(tmp_path)).restore(
            jax.tree.map(torch.from_numpy, tree))
        got = jax.tree.map(lambda t: t.numpy(), got)
    else:
        PCK.CheckpointManager(str(tmp_path)).save(
            3, jax.tree.map(torch.from_numpy, tree), extra={"step": 3},
            blocking=True)
        got, extra = RCK.CheckpointManager(str(tmp_path)).restore(
            jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         tree))
        got = jax.tree.map(np.asarray, got)
    assert extra == {"step": 3}
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)


def smoke_model(seed=0):
    cfg = get_smoke_config("stablelm_12b").with_(dtype="float32")
    return PM.build(cfg, "cpu", torch.Generator().manual_seed(seed),
                    training=True)


def quiet(*args):
    pass


def test_train_resume(tmp_path):
    """6 steps checkpointed every 3, then a second ``train`` to 8 resumes
    at step 6 with the data state restored: its weights equal an
    uninterrupted 8-step run's to the bit (the CPU is deterministic)."""
    mdl = smoke_model()
    data = SyntheticTokens(mdl.cfg.vocab_size, batch=4, seq=32, seed=1)
    train(mdl, data, steps=6, ckpt_dir=str(tmp_path), ckpt_every=3,
          log_every=100, log=quiet)
    again = smoke_model(seed=5)                 # other weights, restored
    data2 = SyntheticTokens(mdl.cfg.vocab_size, batch=4, seq=32, seed=1)
    lines = []
    params, _, losses = train(again, data2, steps=8, ckpt_dir=str(tmp_path),
                              ckpt_every=3, log_every=100, log=lines.append)
    assert lines[0] == "[train] resumed from step 6"
    assert data2.step == 8 and [s for s, _ in losses] == [7]
    assert PCK.CheckpointManager(str(tmp_path)).latest_step() == 8
    whole = smoke_model()
    data3 = SyntheticTokens(mdl.cfg.vocab_size, batch=4, seq=32, seed=1)
    ref, _, _ = train(whole, data3, steps=8, log_every=100, log=quiet)
    assert all(torch.equal(params[n], ref[n]) for n in ref)


class SigtermAt:
    """A data pipeline that sends this process SIGTERM as it hands out
    batch ``at``."""

    def __init__(self, data, at):
        self.data, self.at = data, at

    def next(self):
        if self.data.step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.data.next()

    def state(self):
        return self.data.state()

    def restore(self, st):
        self.data.restore(st)


def test_sigterm_saves_and_stops_at_the_next_step(tmp_path):
    mdl = smoke_model()
    data = SigtermAt(SyntheticTokens(mdl.cfg.vocab_size, 2, 16), at=2)
    lines = []
    before = signal.getsignal(signal.SIGTERM)
    train(mdl, data, steps=10, ckpt_dir=str(tmp_path), ckpt_every=100,
          log_every=1, log=lines.append)
    assert signal.getsignal(signal.SIGTERM) == before
    assert lines[-1] == "[train] preemption at step 2: checkpointed, exiting"
    assert len(lines) == 4 and data.data.step == 3
    mgr = PCK.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    params = dict(mdl.named_parameters())
    _, extra = mgr.restore((params, POPT.init_opt_state(params,
                                                        mdl.opt_cfg)))
    assert extra == {"step": 3, "data_state": {"step": 3, "seed": 0}}


def test_launcher_prints_the_references_lines(capsys, tmp_path, monkeypatch):
    launch.main(["--arch", "stablelm_12b", "--smoke", "--device", "cpu",
                 "--steps", "3", "--batch", "2", "--seq", "32", "--ckpt",
                 str(tmp_path), "--ckpt-every", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"\[launch\] arch=stablelm-12b params=[\d.]+M "
                        r"device=cpu", lines[0]), lines
    assert all(re.fullmatch(r"\[train\] step=[02] loss=[\d.]+ gnorm=[\d.]+ "
                            r"med_step=\d+ms stragglers=0", ln)
               for ln in lines[1:]), lines
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    for flag in ("--simulate-pod", "--multi-pod", "--tpu-flags"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            launch.main(["--arch", "stablelm_12b", "--smoke", flag])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "stablelm_12b", "--smoke"])


def test_launcher_as_a_module():
    """``python -m repro_torch.launch.train --arch stablelm_12b --smoke
    --device cpu``, cut to 2 short steps."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "stablelm_12b", "--smoke", "--device", "cpu", "--steps", "2",
         "--batch", "2", "--seq", "16"], capture_output=True, text=True,
        env=env, timeout=300, check=True)
    lines = res.stdout.splitlines()
    assert lines[0].startswith("[launch] arch=stablelm-12b")
    assert len(lines) == 3 and lines[2].startswith("[train] step=1 ")


def test_train_step_needs_whole_microbatches():
    """A batch must split into ``microbatches`` equal parts, as the
    reference's reshape requires: 2 rows into 4 raise."""
    cfg = get_smoke_config("stablelm_12b").with_(dtype="float32",
                                                 microbatches=4)
    mdl = PM.build(cfg, "cpu", training=True)
    params = dict(mdl.named_parameters())
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (2, 8)),
             "labels": rng.integers(0, 256, (2, 8))}
    with pytest.raises(ValueError, match="2 rows does not split into 4"):
        mdl.train_step(POPT.init_opt_state(params, mdl.opt_cfg), batch, 0)
