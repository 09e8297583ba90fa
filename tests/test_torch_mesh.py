"""Serving on a mesh (``repro_torch.launch.mesh``, the mesh paths of
``models/``, ``launch/serve.py`` under ``torchrun``) against the JAX
reference, on the CPU.

The reference runs in ONE module-scoped subprocess on 4 virtual CPU
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``; its
models need no shim on the installed jax): for each case and each (dp, tp)
mesh it builds the model on that mesh, prefills B x S prompts from a numpy
seed and decodes GEN steps on caches zero-padded to S + GEN, and returns
its parameters, logits and caches as numpy.  The port runs each mesh as
thread ranks (``make_host_mesh``), each rank loading
``params_from_reference(tree, cfg, mesh=its context)`` and fed the
reference's tokens (Mamba-1's and the hybrid's caches included: a
rank's states are its channels of Mamba-1's, and Mamba-2's whole).
Float32 throughout; ``TOL`` is ``test_torch_serve.py``'s: every greedy
token equal, logits and each rank's cache rows (its batch rows, its chunk
of the sequence) within atol = rtol = 1e-4.
"""
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import cost
from repro_torch.configs import base as PB
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as PM

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, GEN = 2, 24, 8
CASES = {"dense": ("stablelm_12b", {}),
         "dense_explicit_tp": ("stablelm_12b", {"explicit_tp": True}),
         "moe_psum": ("qwen3_moe_30b_a3b", {"moe_dispatch": "psum"}),
         "moe_a2a": ("qwen3_moe_30b_a3b", {"moe_dispatch": "a2a"}),
         "mla": ("deepseek_v3_671b", {}),
         "encoder": ("hubert_xlarge", {}),
         "ssm": ("falcon_mamba_7b", {}),
         "hybrid": ("zamba2_1p2b", {})}
MESHES = [(1, 2), (2, 2), (1, 4)]

REFERENCE_RUN = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import pickle
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import base as RB
    from repro.launch.mesh import compat_make_mesh
    from repro.models import layers as RL, model as RM, transformer as RT
    from repro.models.layers import MeshCtx

    cases, meshes, (B, S, GEN) = pickle.loads(bytes.fromhex(sys.argv[2]))

    def run(arch, overrides, dp, tp):
        cfg = RB.get_smoke_config(arch).with_(dtype="float32", **overrides)
        mesh = compat_make_mesh((dp, tp), ("data", "model"),
                                devices=jax.devices()[:dp * tp])
        mcx = MeshCtx(mesh=mesh, dp=("data",), tp="model")
        mdl = RM.build(cfg, mcx)
        params = mdl.init_params(jax.random.PRNGKey(0))

        def prefill(params, batch):
            x = mdl._embed_inputs(params, batch)
            positions = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
            h, caches = RT.forward_prefill(params, x, cfg, mcx, positions)
            h = RL.apply_norm(params["ln_final"], h, cfg)
            return RM.logits_fn(h[:, -1:], RM._unemb_t(params, cfg), cfg,
                                mcx), caches

        def decode(params, caches, token, pos):
            x = RM.embed(token[:, None], params["emb"], mcx)
            h, caches = RT.forward_decode(params, x, caches, pos, cfg, mcx)
            h = RL.apply_norm(params["ln_final"], h, cfg)
            return RM.logits_fn(h, RM._unemb_t(params, cfg), cfg, mcx), caches

        rng = np.random.default_rng(1)
        if cfg.input_mode == "embeddings":
            batch = {"embeddings": rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)}
        else:
            batch = {"tokens": rng.integers(
                0, cfg.vocab_size, (B, S)).astype(np.int32)}
        with mesh:
            logits, caches = jax.jit(prefill)(params, batch)
            out = {"params": jax.tree.map(np.asarray, params),
                   "batch": batch, "logits": [np.asarray(logits)],
                   "prefill_caches": jax.tree.map(np.asarray, caches)}
            if cfg.is_encoder:
                return out
            caches = {k: v if k == "ssm" else
                      jnp.pad(v, [(0, 0), (0, 0), (0, GEN)]
                              + [(0, 0)] * (v.ndim - 3))
                      for k, v in caches.items()}
            step = jax.jit(decode)
            for t in range(GEN):
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                logits, caches = step(params, caches, tok,
                                      jnp.asarray(S + t, jnp.int32))
                out["logits"].append(np.asarray(logits))
            out["caches"] = jax.tree.map(np.asarray, caches)
        return out

    res = {(name, dp, tp): run(arch, ov, dp, tp)
           for name, (arch, ov) in cases.items() for dp, tp in meshes}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
""")


@pytest.fixture(scope="module", autouse=True)
def reference_run(tmp_path_factory):
    """The reference's subprocess, started with the module's first test:
    the tests that read it come last in the file, so the port-only tests
    run meanwhile."""
    path = tmp_path_factory.mktemp("reference_mesh") / "mesh.pkl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=SRC, TF_CPP_MIN_LOG_LEVEL="3")
    log = open(path.with_suffix(".log"), "wb")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_RUN, str(path),
         pickle.dumps((CASES, MESHES, (B, S, GEN))).hex()], env=env,
        stdout=log, stderr=subprocess.STDOUT)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, path = reference_run
    proc.wait(timeout=600)
    assert proc.returncode == 0, \
        path.with_suffix(".log").read_text(errors="replace")[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)     # written by the subprocess above


def config(name, **more):
    arch, overrides = CASES[name]
    return PB.get_smoke_config(arch).with_(dtype="float32", **overrides,
                                          **more)


def rank_run(mcx, cfg, sd_of, batch, gen, feed=None):
    """One rank: the model (weights ``sd_of(mcx)``, or seed 0), prefill of
    the whole ``batch``, caches padded to S + ``gen``, ``gen`` decode steps
    fed ``feed``'s tokens (else its own).  Returns the rank's logits of
    every step, its tokens (the whole batch's), and its caches after the
    prefill and after the last step."""
    mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0), mesh=mcx)
    if sd_of is not None:
        mdl.load_state_dict(sd_of(mcx))
    logits, caches = mdl.prefill(batch)
    n = len(next(iter(batch.values())))
    out = {"logits": [logits],
           "tokens": [mdl._tokens(logits, mdl._mesh_for(n))],
           "prefill_caches": {k: v.clone() for k, v in caches.items()
                              if k != "ssm"}}
    if cfg.is_encoder:
        return out
    caches = PM.pad_caches(caches, S + gen, mcx)
    for t in range(gen):
        tok = out["tokens"][-1] if feed is None else feed[t]
        logits, caches = mdl.decode(caches, tok, S + t)
        out["logits"].append(logits)
        out["tokens"].append(mdl._tokens(logits, mdl._mesh_for(n)))
    out["caches"] = caches
    return out


def on_mesh(dp, tp, cfg, sd_of=None, batch=None, gen=GEN, feed=None):
    return MESH.make_host_mesh(dp, tp).run(rank_run, cfg, sd_of, batch, gen,
                                           feed)


def prompts(cfg, n=B, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return {"embeddings": torch.tensor(rng.standard_normal(
            (n, S, cfg.d_model)).astype(np.float32))}
    return {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (n, S)))}


def rank_rows(r, dp, tp, n=B):
    d = r // tp
    return slice(d * n // dp, (d + 1) * n // dp)


def caches_of(caches, cfg, r, dp, tp):
    """Rank r's part of whole caches: its rows; of a K/V or latent cache
    its chunk of the sequence; of Mamba-1's states its channels (of
    Mamba-2's all)."""
    rows = rank_rows(r, dp, tp)
    out = {}
    for name, c in caches.items():
        if name != "ssm":
            out[name] = chunk_of(c[:, rows], r, tp)
            continue
        conv, h = (t[:, rows] for t in c)
        if cfg.family == "ssm":
            conv, h = chunk_of(conv, r, tp, 3), chunk_of(h, r, tp, 2)
        out[name] = (conv, h)
    return out


def assert_caches(got, want, tol, msg=""):
    for name, c in got.items():
        pairs = zip(c, want[name]) if name == "ssm" else [(c, want[name])]
        for g, w in pairs:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol,
                                       err_msg=f"{msg} {name}")


def chunk_of(a, r, tp, dim=2):
    """Rank r's chunk of the sequence axis ``dim`` of a whole cache."""
    n = a.shape[dim] // tp
    idx = [slice(None)] * a.ndim
    idx[dim] = slice((r % tp) * n, (r % tp + 1) * n)
    return a[tuple(idx)]


# the same weights (seed 0) on one device and on a mesh; the MoE layers
# (qwen3's, deepseek's after its MLA) at capacity factor E / k, where no
# expert overflows, so that every layout keeps the same assignments (the
# data axis and a2a's shares change which overflow)
INSIDE = [("dense", {}), ("dense_explicit_tp", {}),
          ("dense", {"causal_tree_attn": True}),
          ("mla", {"capacity_factor": 4.0}),
          ("encoder", {}), ("moe_psum", {"capacity_factor": 4.0}),
          ("moe_a2a", {"capacity_factor": 4.0}), ("ssm", {}),
          ("hybrid", {})]


@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (2, 2), (2, 1)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("name,more", INSIDE,
                         ids=[n + "".join(f"-{k}" for k in m if k !=
                                          "capacity_factor")
                              for n, m in INSIDE])
def test_tp_k_equals_one_device(name, more, dp, tp):
    """Fed the one device's tokens; greedy tokens equal wherever the one
    device's top-2 margin exceeds the tolerance (a random smoke model has
    near-ties)."""
    cfg = config(name, **more)
    batch = prompts(cfg)
    want = rank_run(None, cfg, None, batch, GEN)
    runs = on_mesh(dp, tp, cfg, batch=batch, feed=want["tokens"][:-1])
    for r, run in enumerate(runs):
        rows = rank_rows(r, dp, tp)
        for t, got in enumerate(run["logits"]):
            torch.testing.assert_close(got, want["logits"][t][rows], **TOL)
            top2 = want["logits"][t].topk(2, -1).values
            sure = top2[:, 0] - top2[:, 1] > TOL["atol"]
            assert torch.equal(run["tokens"][t][sure],
                               want["tokens"][t][sure])
        if "caches" in run:
            assert_caches(run["caches"], caches_of(want["caches"], cfg, r,
                                                   dp, tp), TOL, f"rank {r}")


def test_psum_keeps_the_capacity_of_every_token():
    """At qwen3's smoke capacity experts overflow: tp = 2 keeps tp = 1's
    drops (capacity and ranks from the whole batch), dp = 2 does not (each
    data rank ranks its own rows at the whole batch's capacity)."""
    cfg = config("moe_psum")
    batch = prompts(cfg)
    want = rank_run(None, cfg, None, batch, 2)
    for r, run in enumerate(on_mesh(1, 2, cfg, batch=batch, gen=2)):
        torch.testing.assert_close(run["logits"][0], want["logits"][0], **TOL)
    runs = on_mesh(2, 1, cfg, batch=batch, gen=2)
    got = torch.cat([runs[0]["logits"][0], runs[1]["logits"][0]])
    assert not torch.allclose(got, want["logits"][0], **TOL)


def test_vocab_not_divisible_by_tp_takes_the_whole_table():
    """tp = 3 divides neither the padded vocabulary (256) nor the MLP
    (128): every rank holds the whole table and MLP, and the result is
    the one device's."""
    cfg = config("dense", num_heads=6, num_kv_heads=3)
    batch = prompts(cfg)
    want = rank_run(None, cfg, None, batch, 2)

    def shapes(mcx):
        mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0),
                       mesh=mcx)
        return (tuple(mdl.emb.shape), tuple(mdl.unemb.shape),
                tuple(mdl.layers[0]["mlp"]["w_down"].shape),
                tuple(mdl.layers[0]["attn"]["wq"].shape))
    assert set(MESH.make_host_mesh(1, 3).run(shapes)) == {
        ((256, 64), (64, 256), (128, 64), (64, 2, 16))}
    for run in on_mesh(1, 3, cfg, batch=batch, gen=2):
        for t, got in enumerate(run["logits"]):
            torch.testing.assert_close(got, want["logits"][t], **TOL)


def test_padded_query_heads_are_zero_rows():
    """H = 4 at tp = 3 pads to 6 heads: zero rows of ``wq`` and ``wo``."""
    cfg = config("dense", num_kv_heads=1)
    mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0))

    def part(mcx):
        m = PM.build(cfg, "cpu", torch.Generator().manual_seed(0), mesh=mcx)
        return m.layers[0]["attn"]["wq"], m.layers[0]["attn"]["wo"]
    parts = MESH.make_host_mesh(1, 3).run(part)
    wq = torch.cat([p[0] for p in parts], 1)
    wo = torch.cat([p[1] for p in parts], 0)
    assert wq.shape[1] == wo.shape[0] == 6
    assert torch.equal(wq[:, :4], mdl.layers[0]["attn"]["wq"])
    assert torch.equal(wo[:4], mdl.layers[0]["attn"]["wo"])
    assert not wq[:, 4:].any() and not wo[4:].any()


def decode_at(mcx, cfg, caches, pos, seed=5):
    """One GQA decode attention of layer 0's weights (seed 0) at ``pos``
    over the cache ``caches`` (whole), as the rank ``mcx`` (its chunk)."""
    mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0), mesh=mcx)
    x = torch.randn((B, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(seed))
    tp = L.tp_of(mcx)
    mine = {k: chunk_of(v, 0 if mcx is None else mcx.model_index, tp,
                        1).clone() for k, v in caches.items()}
    with torch.inference_mode():
        y, out = L.gqa_decode_attention(mdl.layers[0]["attn"], x, mine, pos,
                                        cfg, mcx)
    return y, out


def test_rank_whose_chunk_lies_after_pos_adds_nothing():
    """pos in the first of two chunks: the second rank's chunk, filled
    with large values, is wholly past pos, and the merge leaves it out;
    the same merge without its max correction does not."""
    cfg = config("dense")
    S_all = 16
    g = torch.Generator().manual_seed(3)
    caches = {k: torch.randn((B, S_all, 2, 16), generator=g)
              for k in ("k", "v")}
    for k in caches:
        caches[k][:, 8:] = 50.0
    want, _ = decode_at(None, cfg, caches, 5)
    got = MESH.make_host_mesh(1, 2).run(decode_at, cfg, caches, 5)
    for y, _ in got:
        torch.testing.assert_close(y, want, **TOL)
    plain = L.merge_over_ranks

    def no_correction(m, l, o, mcx):
        return mcx.all_reduce(l), mcx.all_reduce(o)
    L.merge_over_ranks = no_correction
    try:
        bad = MESH.make_host_mesh(1, 2).run(decode_at, cfg, caches, 5)
    finally:
        L.merge_over_ranks = plain
    assert not torch.allclose(bad[0][0], want, **TOL)


@pytest.mark.parametrize("pos", [3, 8, 15])
def test_new_row_is_written_in_its_owners_chunk_only(pos):
    cfg = config("dense")
    caches = {k: torch.zeros((B, 16, 2, 16)) for k in ("k", "v")}
    _, whole = decode_at(None, cfg, caches, pos)
    for r, (_, mine) in enumerate(MESH.make_host_mesh(1, 2).run(
            decode_at, cfg, caches, pos)):
        for k in ("k", "v"):
            torch.testing.assert_close(mine[k], chunk_of(whole[k], r, 2, 1),
                                       **TOL)
            written = mine[k].abs().sum((0, 2, 3)).nonzero().flatten()
            owner = pos // 8 == r
            assert written.tolist() == ([pos % 8] if owner else []), (r, k)


def test_gloo_processes_equal_thread_ranks(tmp_path):
    """``launch/serve.py`` under torchrun, two processes over gloo, gives
    the tokens of the same mesh as thread ranks."""
    cfg = PB.get_smoke_config("stablelm_12b")
    out = tmp_path / "tokens.npy"
    env = dict(os.environ, PYTHONPATH=SRC)
    subprocess.run([sys.executable, "-m", "torch.distributed.run",
                    "--standalone", "--nproc-per-node", "2", "-m",
                    "repro_torch.launch.serve", "--arch", "stablelm_12b",
                    "--smoke", "--device", "cpu", "--gen", "8",
                    "--out", str(out)], check=True, env=env, timeout=300,
                   capture_output=True)
    threads = MESH.make_host_mesh(1, 2).run(
        lambda mcx: serve.serve(cfg, 4, 32, 8, "cpu", mcx)[0])
    assert np.array_equal(threads[0], threads[1])
    assert np.array_equal(np.load(out), threads[0])


def test_training_and_the_production_mesh_raise():
    """Training on a mesh is ported (``tests/test_torch_mesh_train.py``):
    a model built for training at (1, 2) holds the tp = 1 model's weights
    split; only the 256/512-device production mesh still raises."""
    cfg = config("dense")
    whole = PM.build(cfg, "cpu", training=True)
    parts = MESH.make_host_mesh(1, 2).run(
        lambda mcx: PM.build(cfg, "cpu", training=True,
                             mesh=mcx).layers[0]["mlp"]["w_up"])
    assert torch.equal(torch.cat(parts, 1),
                       whole.layers[0]["mlp"]["w_up"])
    assert all(p.requires_grad for p in parts)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        MESH.make_production_mesh()


def test_mesh_ctx_axes():
    got = MESH.make_host_mesh(2, 2).run(lambda m: (
        m.rank, m.axis_index("model"), m.axis_index("data"),
        m.axis_index(("data", "model")), m.bspec(4), m.bspec(3),
        m.batch_rows(4), m.batch_rows(3)))
    assert got == [(r, r % 2, r // 2, r, "data", None,
                    slice(2 * (r // 2), 2 * (r // 2) + 2), slice(0, 3))
                   for r in range(4)]
    assert MESH.axis_size(MESH.make_host_mesh(2, 4), ("data", "model")) == 8
    assert MESH.make_data_mesh(3).shape == (3, 1)

    def collectives(m):
        x = torch.tensor([float(m.rank)])
        return (m.all_reduce(x).item(), m.all_reduce(x, "data", "max").item(),
                m.all_gather(x, 0, ("data", "model")).tolist(),
                m.all_to_all(torch.tensor([[10. * m.rank + j]
                                           for j in range(2)])).flatten()
                .tolist())
    assert MESH.make_host_mesh(2, 2).run(collectives) == [
        (1.0, 2.0, [0., 1., 2., 3.], [0., 10.]),
        (1.0, 3.0, [0., 1., 2., 3.], [1., 11.]),
        (5.0, 2.0, [0., 1., 2., 3.], [20., 30.]),
        (5.0, 3.0, [0., 1., 2., 3.], [21., 31.])]


def test_thread_ranks_under_stress_lose_no_update():
    """16 thread ranks (more than the cores) on a (4, 4) mesh, the
    interpreter switching threads every microsecond: 200 rounds of
    collectives on alternating axes, each checked against its closed
    form, end within the time bound."""
    import threading
    rounds = 200

    def body(m):
        for i in range(rounds):
            axis = ("model", "data", ("data", "model"))[i % 3]
            got = m.all_reduce(torch.tensor([float(m.rank + i)]), axis)
            ranks = [r for r in range(16)
                     if (axis == ("data", "model")
                         or (axis == "model" and r // 4 == m.rank // 4)
                         or (axis == "data" and r % 4 == m.rank % 4))]
            if got.item() != sum(r + i for r in ranks):
                raise AssertionError((m.rank, i, axis, got.item()))
        return m.all_gather(torch.tensor([m.rank]), 0, ("data", "model"))
    old = sys.getswitchinterval()
    out = {}
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: out.update(
            res=MESH.make_host_mesh(4, 4).run(body)))
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert all(r.tolist() == list(range(16)) for r in out["res"])


def test_a_rank_that_raises_releases_the_others(monkeypatch):
    def body(m):
        if m.rank == 1:
            raise ValueError("rank 1")
        return m.all_reduce(torch.ones(1))
    with pytest.raises(ValueError, match="rank 1"):
        MESH.make_host_mesh(1, 3).run(body)

    def early(m):               # rank 1 skips the collective the others wait at
        return m.rank if m.rank == 1 else m.all_reduce(torch.ones(1))
    monkeypatch.setattr(MESH, "WAIT_S", 0.5)
    with pytest.raises(RuntimeError, match="did not meet"):
        MESH.make_host_mesh(1, 3).run(early)


def test_cost_walk_counts_the_mesh_collectives():
    """A (1, 2) decode step of the dense smoke model, walked on rank 0
    (rank 1 runs unwalked): per layer, the query heads and the new K/V
    heads gathered, the merge's max and two sums, ``wo``'s and the MLP's
    all-reduces; the embedding's all-reduce and the logits' gather.  Bytes
    are the results', all-reduce counted twice (the reference's
    convention)."""
    cfg = config("dense")
    batch = prompts(cfg)
    H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    V = 256

    def body(mcx):
        mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0),
                       mesh=mcx)
        tok, caches = mdl.prefill_step(batch)
        caches = PM.pad_caches(caches, S + 2, mcx)
        if mcx.rank != 0:
            return mdl.decode_step(caches, tok, S)
        with cost.Recorder() as rec:
            mdl.decode_step(caches, tok, S)
        return rec.as_dict()
    rec = MESH.make_host_mesh(1, 2).run(body)[0]
    f = 4
    layer_gather = (B * H * hd + 2 * B * KV * hd) * f
    layer_reduce = (B * KV * (H // KV) * (2 + hd) + B * d + B * d) * f
    assert rec["coll"]["all-gather"] == cfg.num_layers * layer_gather \
        + B * V * f
    assert rec["coll"]["all-reduce"] == 2 * (cfg.num_layers * layer_reduce
                                             + B * d * f)
    assert rec["coll_count"] == cfg.num_layers * 8 + 2


@pytest.mark.parametrize("dp,tp", MESHES, ids=lambda v: str(v))
@pytest.mark.parametrize("name", list(CASES))
def test_thread_ranks_equal_the_reference(reference, name, dp, tp):
    ref = reference[(name, dp, tp)]
    cfg = config(name)
    batch = {k: torch.tensor(v) for k, v in ref["batch"].items()}
    feed = [torch.tensor(np.argmax(lg, -1).astype(np.int32))
            for lg in ref["logits"][:-1]]
    runs = on_mesh(dp, tp, cfg, lambda mcx: PM.params_from_reference(
        ref["params"], cfg, mesh=mcx), batch, feed=feed)
    for r, run in enumerate(runs):
        rows = rank_rows(r, dp, tp)
        for t, (got, want) in enumerate(zip(run["logits"], ref["logits"])):
            np.testing.assert_allclose(got.numpy(), want[rows], **TOL,
                                       err_msg=f"rank {r} step {t}")
            assert np.array_equal(run["tokens"][t].numpy(),
                                  np.argmax(want, -1)), (r, t)
        for key in ("prefill_caches", "caches"):
            if key in run:
                got = {k: v for k, v in run[key].items()}
                want = caches_of({k: ref[key][k] for k in got}, cfg, r, dp,
                                 tp)
                assert_caches(got, want, TOL, f"rank {r} {key}")
