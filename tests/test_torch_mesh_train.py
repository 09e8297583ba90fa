"""Training on a mesh (``Model.train_step`` on a rank's ``MeshCtx``: the
collectives' gradients, vocab-parallel ``ce_loss``, the loss over
"data", ZeRO-1, FSDP, the int8 update; ``train/train_loop.py`` and
``launch/train.py`` on a mesh) against the JAX reference, on the CPU.

The reference runs in TWO module-scoped subprocesses on 4 virtual CPU
devices each (``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
half of the cases each: for each case and each (dp, tp) mesh it builds
the model on that mesh, puts its parameters and optimizer state on the
model's shardings (``param_shardings``, ``opt_shardings``: ZeRO-1, and
FSDP where the config sets it), runs one ``jax.jit(Model.train_step)``
on a B x S batch from a numpy seed and returns the parameters before,
the metrics, and the parameters and optimizer state after, as numpy.
The port runs each mesh as thread ranks, each loading
``params_from_reference(tree, cfg, training=True, mesh=its context)``,
and gathers its weights and state (``global_weights``,
``global_state``).  Float32 throughout; held: ``loss``, ``ce`` and
``grad_norm`` within rtol ``METRIC_RTOL`` and equal on every rank,
``lr`` equal, every weight and ``master`` within ``WEIGHT_ATOL``, each
moment (``mu``, ``nu``) within ``MOMENT_RMS`` of the reference's in rms
relative to its own (``test_torch_train.py``'s ``grad_errors``: a moment
zero but for rounding is held against ``ZERO_FLOOR`` of the largest),
and ``err`` within ``WEIGHT_ATOL``.  The port measures 3e-7 in the
metrics, 2e-7 in the weights and 1e-5 in the moments; the reference
reduce-scatters each microbatch's gradients and the port the sum of
them, the same sums in another order.
"""
import functools
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import base as PB
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as PM
from repro_torch.train import optimizer as POPT
from repro_torch.train.train_loop import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
B, S = 4, 16
METRIC_RTOL = 1e-5
WEIGHT_ATOL = 1e-6
MOMENT_RMS = 1e-4
ZERO_FLOOR = 1e-6
BOTH = [(1, 2), (2, 2)]
CASES = {"dense": ("stablelm_12b", {}, BOTH),
         "moe_psum": ("qwen3_moe_30b_a3b", {"moe_dispatch": "psum"}, BOTH),
         "moe_a2a": ("qwen3_moe_30b_a3b", {"moe_dispatch": "a2a"}, BOTH),
         "mla_fsdp": ("deepseek_v3_671b", {}, BOTH),    # its own fsdp=True
         "ssm": ("falcon_mamba_7b", {}, BOTH),
         "hybrid": ("zamba2_1p2b", {}, BOTH),
         "encoder": ("hubert_xlarge", {}, [(2, 2)]),
         "dense_microbatches": ("stablelm_12b", {"microbatches": 2},
                                [(2, 2)]),
         "dense_fsdp": ("stablelm_12b", {"fsdp": True}, [(2, 2)]),
         "dense_grad_compress": ("stablelm_12b", {"grad_compress": True},
                                 BOTH)}
RUNS = [(name, dp, tp) for name, (_, _, meshes) in CASES.items()
        for dp, tp in meshes]

REFERENCE_RUN = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import pickle
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import base as RB
    from repro.launch.mesh import compat_make_mesh
    from repro.models import model as RM
    from repro.models.layers import MeshCtx
    from repro.train import optimizer as ROPT

    runs, (B, S) = pickle.loads(bytes.fromhex(sys.argv[2]))

    def run(arch, overrides, dp, tp):
        cfg = RB.get_smoke_config(arch).with_(dtype="float32", **overrides)
        mesh = compat_make_mesh((dp, tp), ("data", "model"),
                                devices=jax.devices()[:dp * tp])
        mcx = MeshCtx(mesh=mesh, dp=("data",), tp="model")
        mdl = RM.build(cfg, mcx)
        rng = np.random.default_rng(1)
        tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"labels": tok[:, 1:]}
        if cfg.input_mode == "embeddings":
            batch["embeddings"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        else:
            batch["tokens"] = tok[:, :-1]
        with mesh:
            params = jax.device_put(mdl.init_params(jax.random.PRNGKey(0)),
                                    mdl.param_shardings())
            opt = jax.device_put(ROPT.init_opt_state(params, mdl.opt_cfg),
                                 mdl.opt_shardings())
            before = jax.tree.map(np.asarray, params)
            new_p, new_opt, met = jax.jit(mdl.train_step)(
                params, opt, batch, jnp.asarray(0, jnp.int32))
            return {"params": before, "batch": batch,
                    "metrics": {k: float(v) for k, v in met.items()},
                    "new_params": jax.tree.map(np.asarray, new_p),
                    "new_opt": jax.tree.map(np.asarray, new_opt)}

    res = {(name, dp, tp): run(arch, ov, dp, tp)
           for name, arch, ov, dp, tp in runs}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
""")


def _halves():
    """The reference's runs in two lists of about equal cost (the MLA
    cases are the slowest to compile)."""
    runs = sorted(RUNS, key=lambda r: r[0] != "mla_fsdp")
    return [runs[0::2], runs[1::2]]


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocesses, started with the module's first test:
    the tests that read them come last in the file, so the port-only
    tests run meanwhile."""
    tmp = tmp_path_factory.mktemp("reference_mesh_train")
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=SRC, TF_CPP_MIN_LOG_LEVEL="3")
    procs = []
    for i, part in enumerate(_halves()):
        path = tmp / f"train{i}.pkl"
        runs = [(name, CASES[name][0], CASES[name][1], dp, tp)
                for name, dp, tp in part]
        log = open(path.with_suffix(".log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", REFERENCE_RUN, str(path),
             pickle.dumps((runs, (B, S))).hex()], env=env, stdout=log,
            stderr=subprocess.STDOUT), path, log))
    yield procs
    for proc, _, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


@pytest.fixture(scope="module")
def reference(reference_run):
    out = {}
    for proc, path, _ in reference_run:
        proc.wait(timeout=900)
        assert proc.returncode == 0, \
            path.with_suffix(".log").read_text(errors="replace")[-4000:]
        with open(path, "rb") as f:
            out.update(pickle.load(f))   # written by the subprocess above
    return out


def config(arch, **overrides):
    return PB.get_smoke_config(arch).with_(dtype="float32", **overrides)


def make_batch(cfg, seed=1, rows=B):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (rows, S + 1))
    batch = {"labels": torch.tensor(tok[:, 1:])}
    if cfg.input_mode == "embeddings":
        batch["embeddings"] = torch.tensor(rng.standard_normal(
            (rows, S, cfg.d_model)).astype(np.float32))
    else:
        batch["tokens"] = torch.tensor(tok[:, :-1])
    return batch


def one_step(mcx, cfg, batch, sd_of=None, grads=False):
    """One rank: the model (weights ``sd_of(mcx)``, or seed 0), one
    ``train_step``; returns its metrics, and its weights and optimizer
    state gathered whole (with ``grads`` its loss gradients of the step's
    weights, gathered, instead)."""
    mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0),
                   training=True, mesh=mcx)
    if sd_of is not None:
        mdl.load_state_dict(sd_of(mcx))
    if grads:
        params = dict(mdl.named_parameters())
        _, _, g = mdl._grads(params, batch)
        return {n: t if mcx is None else PM.global_leaf(
            n, t, mdl.specs[n], cfg, mcx) for n, t in g.items()}
    opt, met = mdl.train_step(mdl.init_opt_state(), batch, 0)
    return ({k: float(v) for k, v in met.items()}, mdl.global_weights(),
            mdl.global_state(opt))


def on_mesh(dp, tp, fn, *args):
    if dp * tp == 1:
        return [fn(None, *args)]
    return MESH.make_host_mesh(dp, tp).run(fn, *args)


def rms_rel(got, want) -> float:
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    ref = np.sqrt(np.mean(want ** 2))
    err = np.sqrt(np.mean((got - want) ** 2))
    return err / ref if ref > 0 else err


def rms_errors(got, want) -> dict:
    """Each leaf's rms error relative to the wanted rms, or to
    ``ZERO_FLOOR`` times the largest such rms where the wanted one is
    below that."""
    rms = {n: float(np.sqrt(np.mean(np.asarray(w, np.float64) ** 2)))
           for n, w in want.items()}
    floor = ZERO_FLOOR * max(rms.values())
    return {n: rms_rel(got[n], w) * rms[n] / max(rms[n], floor)
            for n, w in want.items()}


def worst(errs: dict):
    return sorted(errs.items(), key=lambda kv: -kv[1])[:3]


# ---------------------------------------------------------------------------
# the traps, each against one device and with its fault planted
# ---------------------------------------------------------------------------
def test_conjugate_pair_gives_one_devices_gradients(monkeypatch):
    """At (1, 2) every gathered gradient equals the one device's.  An
    all-reduce whose backward also sums over "model" (as
    ``torch.distributed.nn.functional.all_reduce``'s does) doubles the
    gradient of everything before the last row-parallel output."""
    cfg = config("stablelm_12b")
    batch = make_batch(cfg)
    want = one_step(None, cfg, batch, grads=True)
    got = on_mesh(1, 2, one_step, cfg, batch, None, True)[0]
    errs = rms_errors(got, {n: w for n, w in want.items()})
    assert max(errs.values()) <= MOMENT_RMS, worst(errs)

    def summing_backward(ctx, g):
        return ctx.mcx._collective("all_reduce", g, ctx.axis, "sum"), \
            None, None
    monkeypatch.setattr(MESH._SumReduce, "backward",
                        staticmethod(summing_backward))
    bad = on_mesh(1, 2, one_step, cfg, batch, None, True)[0]
    ratio = float(bad["emb"].norm() / want["emb"].norm())
    assert ratio > 1.9, ratio


def test_global_norm_counts_a_replicated_weight_once(monkeypatch):
    """At (2, 2) the norm equals the one device's; a rank that counts
    every shard it holds (the norms and biases held by both model ranks,
    the leaves no dim of which dp divides held by both data ranks) gives
    a larger one."""
    cfg = config("stablelm_12b")
    batch = make_batch(cfg)
    want = one_step(None, cfg, batch)[0]["grad_norm"]
    got = on_mesh(2, 2, one_step, cfg, batch)
    assert {m["grad_norm"] for m, _, _ in got} == {got[0][0]["grad_norm"]}
    np.testing.assert_allclose(got[0][0]["grad_norm"], want,
                               rtol=METRIC_RTOL)
    monkeypatch.setattr(POPT.ZeroLayout, "counted", lambda self, n: True)
    bad = on_mesh(2, 2, one_step, cfg, batch)[0][0]["grad_norm"]
    assert bad > want * (1 + 10 * METRIC_RTOL), (bad, want)


def test_int8_scale_is_the_whole_tensors(monkeypatch):
    """``grad_compress`` on ZeRO-1 shards at (2, 1): each delta is
    quantized by the max over its whole tensor (the shards' maxima
    all-reduced), so three steps give the one device's weights and
    error-feedback buffer to the bit (clipping off: the norm's sum goes in
    another order); the larger gradients sit in the second rank's rows,
    and a scale from the rank's own shard moves the first's."""
    oc = POPT.OptConfig(grad_compress=True, clip_norm=1e9)
    g0 = torch.randn((8, 6), generator=torch.Generator().manual_seed(0))
    g0[4:] *= 100.0
    w0 = torch.randn((8, 6), generator=torch.Generator().manual_seed(1))

    def steps(mcx):
        w = {"w": w0.clone()}
        lay = None if mcx is None else POPT.ZeroLayout(
            mcx, {"w": (None, None)}, {"w": ("data", None)})
        st = POPT.init_opt_state(w, oc, lay)
        for i in range(3):
            g = g0 * (i + 1)
            POPT.apply_updates({"w": g if lay is None else lay.shard(
                "w", g)}, st, w, i, oc, lay)
        return w["w"], st["err"]["w"]
    w_one, err_one = steps(None)
    for r, (w, err) in enumerate(on_mesh(2, 1, steps)):
        assert torch.equal(w, w_one)
        assert torch.equal(err, err_one[4 * r:4 * (r + 1)])
    monkeypatch.setattr(POPT, "_global_amax", lambda amax, layout: amax)
    w, _ = on_mesh(2, 1, steps)[0]
    assert not torch.equal(w[:4], w_one[:4])
    assert torch.equal(w[4:], w_one[4:])


def test_zero1_update_is_gathered_into_the_replica(monkeypatch):
    """At (2, 1) each data rank updates its ZeRO-1 shard and gathers the
    others': a rank that writes its own shard only leaves the rest of its
    replica at the old weights."""
    cfg = config("stablelm_12b")
    batch = make_batch(cfg)
    _, w_one, _ = one_step(None, cfg, batch)

    def own_shard_only(p, shard, dim, mcx):
        k = shard.shape[dim]
        p.narrow(dim, mcx.data_index * k, k).copy_(shard)
    monkeypatch.setattr(POPT, "_to_replica", own_shard_only)

    def replica(mcx):
        mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0),
                       training=True, mesh=mcx)
        mdl.train_step(mdl.init_opt_state(), batch, 0)
        return {n: p.detach().clone() for n, p in mdl.named_parameters()}
    got = on_mesh(2, 1, replica)[0]
    wrong = [n for n in w_one
             if not torch.allclose(got[n], w_one[n], atol=WEIGHT_ATOL,
                                   rtol=0)]
    assert "layers.0.mlp.w_up" in wrong and "emb" in wrong


@pytest.mark.parametrize("tp", [2, 4])
def test_in_proj_slice_is_x_and_z_channels(tp):
    """Mamba-1's ``in_proj`` (d, 2 d_inner) = [x | z]: rank r holds x's
    and z's channels r d_inner / tp .. (r + 1) d_inner / tp, not columns
    r 2 d_inner / tp .. (r + 1) 2 d_inner / tp (rank 0 would hold x
    only); and its gather is the inverse."""
    cfg = config("falcon_mamba_7b")
    whole = PM.build(cfg, "cpu", training=True).layers[0]["ssm"]["in_proj"]
    di, n = cfg.d_inner, cfg.d_inner // tp

    def part(mcx):
        mdl = PM.build(cfg, "cpu", training=True, mesh=mcx)
        w = mdl.layers[0]["ssm"]["in_proj"]
        return w.detach().clone(), PM.global_leaf(
            "layers.0.ssm.in_proj", w, mdl.specs["layers.0.ssm.in_proj"],
            cfg, mcx)
    for r, (w, gathered) in enumerate(on_mesh(1, tp, part)):
        lo = r * n
        assert torch.equal(w, torch.cat([whole[:, lo:lo + n],
                                         whole[:, di + lo:di + lo + n]], 1))
        assert torch.equal(gathered, whole)
    assert not torch.equal(on_mesh(1, tp, part)[0][0], whole[:, :2 * n])


def test_zero1_spec_takes_the_largest_free_dim():
    """The reference's rule on the port's specs."""
    assert POPT.zero1_spec((None, "model"), (64, 128), 2) == \
        ("data", "model")
    assert POPT.zero1_spec((None, None), (64, 128), 2) == (None, "data")
    assert POPT.zero1_spec((None,), (63,), 2) == (None,)
    assert POPT.zero1_spec(("data", None), (64, 128), 2) == ("data", None)
    assert POPT.zero1_spec(("model", None, None), (8, 64, 32), 4) == \
        ("model", "data", None)


def test_opt_state_shardings_and_layout():
    """Every leaf's state spec, and each rank's shard shapes at (2, 2)."""
    cfg = config("stablelm_12b", grad_compress=True)

    def layout(mcx):
        mdl = PM.build(cfg, "cpu", training=True, mesh=mcx)
        sh = POPT.opt_state_shardings(mdl.param_specs(), mdl.param_shapes(),
                                      mcx, mdl.opt_cfg)
        st = mdl.init_opt_state()
        return sh, {n: tuple(t.shape) for n, t in st["mu"].items()}, \
            mdl.param_shapes()
    (sh, shapes, whole), *_ = on_mesh(2, 2, layout)
    assert set(sh) == {"mu", "nu", "master", "err"}
    spec = sh["mu"]
    assert spec["emb"] == ("model", "data")
    assert spec["layers.0.mlp.w_down"] == ("model", "data")
    assert spec["layers.0.ln_attn.scale"] == ("data",)
    for n, s in spec.items():
        want = tuple(k // (2 if a else 1) for k, a in zip(whole[n], s))
        assert shapes[n] == want, n


def test_training_needs_rows_for_every_data_rank():
    cfg = config("stablelm_12b")

    def step(mcx):
        mdl = PM.build(cfg, "cpu", training=True, mesh=mcx)
        mdl.train_step(mdl.init_opt_state(), make_batch(cfg, rows=3), 0)
    with pytest.raises(ValueError, match="3 rows does not split over 2"):
        on_mesh(2, 1, step)


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------
def _run_steps(mcx, cfg, start, steps, init=None):
    """Steps ``start`` .. ``steps - 1`` by hand from (global weights,
    global state) ``init`` (seed 0 and a fresh state without): the
    uninterrupted run a resume is held against.  Returns the whole
    weights and state after."""
    mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0),
                   training=True, mesh=mcx)
    opt = mdl.init_opt_state()
    if init is not None:
        for n, t in mdl.local_weights(init[0]).items():
            dict(mdl.named_parameters())[n].data.copy_(t)
        opt = mdl.local_state(init[1])
    data = SyntheticTokens(cfg.vocab_size, B, S)
    data.restore({"step": start, "seed": 0})
    for step in range(start, steps):
        opt, _ = mdl.train_step(opt, data.next(), step)
    return mdl.global_weights(), mdl.global_state(opt)


def _train(mcx, cfg, steps, ckpt):
    mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0),
                   training=True, mesh=mcx)
    train(mdl, SyntheticTokens(cfg.vocab_size, B, S), steps=steps,
          ckpt_dir=ckpt, ckpt_every=2, log=lambda *a: None)
    return mdl.global_weights()


@pytest.mark.parametrize("dp,tp", [(1, 1), (1, 2)], ids=str)
def test_a_checkpoint_saved_at_2x2_resumes_on_another_mesh(tmp_path, dp,
                                                           tp):
    """``train`` to step 2 at (2, 2) with a checkpoint, then resumed on
    ``(dp, tp)`` to step 4: every weight equals to the bit the run that
    carried the (2, 2) state across in memory."""
    cfg = config("qwen3_moe_30b_a3b", moe_dispatch="a2a",
                 capacity_factor=4.0)
    ckpt = str(tmp_path / "ckpt")
    on_mesh(2, 2, _train, cfg, 2, ckpt)
    got = on_mesh(dp, tp, _train, cfg, 4, ckpt)[0]
    mid = on_mesh(2, 2, _run_steps, cfg, 0, 2)[0]
    want = on_mesh(dp, tp, _run_steps, cfg, 2, 4, mid)[0][0]
    assert got.keys() == want.keys()
    for n in want:
        assert torch.equal(got[n], want[n]), n


# ---------------------------------------------------------------------------
# processes over gloo
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_rank(rank, world, port, argv):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from repro_torch.launch import train as launch
    launch.main(argv)


def test_launcher_under_multiprocessing_equals_thread_ranks(tmp_path):
    """``launch/train.py`` in two processes started by
    ``torch.multiprocessing`` (a gloo world of 2, so a 1 x 2 mesh) logs
    the losses of the same run as thread ranks, to the bit; the
    checkpoint it writes holds the one-device layout."""
    out, ckpt = tmp_path / "losses.npy", tmp_path / "ckpt"
    argv = ["--arch", "stablelm_12b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "16", "--ckpt",
            str(ckpt), "--out", str(out)]
    torch.multiprocessing.start_processes(
        _launch_rank, args=(2, _free_port(), argv), nprocs=2, join=True,
        start_method="spawn")
    cfg = PB.get_smoke_config("stablelm_12b")

    def threads(mcx):
        mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0),
                       training=True, mesh=mcx)
        return train(mdl, SyntheticTokens(cfg.vocab_size, 2, 16), steps=3,
                     log=lambda *a: None)[2]
    want = np.asarray(on_mesh(1, 2, threads)[0])
    assert np.array_equal(np.load(out), want)
    from repro_torch.train.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(ckpt))
    plain = PM.build(cfg, "cpu", training=True)
    params = dict(plain.named_parameters())
    (saved, _), extra = mgr.restore((params, plain.init_opt_state()))
    assert extra["step"] == 3 and saved["emb"].shape == (256, 64)


def _process_step(rank, world, port, dp, tp, out):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    MESH.init_process_group(backend="gloo")
    mcx = MESH.make_mesh_ctx(MESH.make_process_mesh(dp, tp))
    cfg = config("deepseek_v3_671b", capacity_factor=4.0)
    res = one_step(mcx, cfg, make_batch(cfg))
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def test_gloo_processes_equal_thread_ranks(tmp_path):
    """One ``train_step`` of deepseek's smoke model (MLA, MoE, MTP, its
    own FSDP) at (2, 2) as four gloo processes: the metrics, weights and
    optimizer state equal the thread ranks' to the bit."""
    out = tmp_path / "step.pkl"
    torch.multiprocessing.start_processes(
        _process_step, args=(4, _free_port(), 2, 2, str(out)), nprocs=4,
        join=True, start_method="spawn")
    with open(out, "rb") as f:
        met, w, st = pickle.load(f)      # written by the processes above
    cfg = config("deepseek_v3_671b", capacity_factor=4.0)
    want_met, want_w, want_st = on_mesh(2, 2, one_step, cfg,
                                        make_batch(cfg))[0]
    assert met == want_met
    for n in want_w:
        assert torch.equal(w[n], want_w[n]), n
    for part in want_st:
        for n in want_st[part]:
            assert torch.equal(st[part][n], want_st[part][n]), (part, n)


# ---------------------------------------------------------------------------
# against the reference (last: the subprocesses run meanwhile)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,dp,tp", RUNS,
                         ids=[f"{n}-{dp}x{tp}" for n, dp, tp in RUNS])
def test_thread_ranks_equal_the_reference(reference, name, dp, tp):
    ref = reference[(name, dp, tp)]
    arch, overrides, _ = CASES[name]
    cfg = config(arch, **overrides)
    batch = {k: torch.tensor(v) for k, v in ref["batch"].items()}
    runs = on_mesh(dp, tp, one_step, cfg, batch, functools.partial(
        lambda tree, mcx: PM.params_from_reference(
            tree, cfg, training=True, mesh=mcx), ref["params"]))
    met, w, st = runs[0]
    for k in ("loss", "ce", "grad_norm"):
        assert {r[0][k] for r in runs} == {met[k]}, k
        np.testing.assert_allclose(met[k], ref["metrics"][k],
                                   rtol=METRIC_RTOL, err_msg=k)
    assert np.float32(met["lr"]) == np.float32(ref["metrics"]["lr"])
    want = PM.params_from_reference(ref["new_params"], cfg, training=True)
    assert w.keys() == want.keys()
    for n, t in want.items():
        np.testing.assert_allclose(w[n].numpy(), t.numpy(),
                                   atol=WEIGHT_ATOL, rtol=0, err_msg=n)
    assert st.keys() == ref["new_opt"].keys()
    for part in st:
        want = PM.params_from_reference(ref["new_opt"][part], cfg,
                                        training=True)
        if part in ("mu", "nu"):
            errs = rms_errors(st[part], want)
            assert max(errs.values()) <= MOMENT_RMS, (part, worst(errs))
        else:
            for n, t in want.items():
                np.testing.assert_allclose(st[part][n].numpy(), t.numpy(),
                                           atol=WEIGHT_ATOL, rtol=0,
                                           err_msg=f"{part} {n}")
