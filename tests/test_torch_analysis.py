"""The port's analysis layer (``repro_torch.analysis.cost`` and
``roofline``, ``engine.fused.lower_fused_programs``,
``engine.distributed.lower_distributed_tc``, ``launch.dryrun``) against
the JAX reference's (``repro.analysis``), on the CPU.

The reference walks compiled HLO; the port counts its torch program as it
runs.  Held exactly (tolerance 0), unless a test says otherwise:

* ``model_flops_estimate`` for every architecture and shape;
* the matrix-product FLOPs of a matmul chain, and of a 2-layer dense, MoE
  and SSM smoke model's prefill and train step (the reference's walk
  restricted to ``dot`` / ``convolution``, ``ref_dot_flops``), where the
  two programs differ by pinned, named amounts (``model_gap``);
  ``tests/test_roofline.py``'s five cases;
* each hand kernel's count: its formula, and nothing of its plain version;
* argument bytes of a dry (fake-tensor) step against the real weights and
  optimizer state;
* ``sort_ops_static`` of ``lower_fused_programs`` and the all-to-all bytes
  of ``lower_distributed_tc`` against the reference's, from one
  module-scoped subprocess (the reference engine needs an
  ``enable_x64`` shim there, and its sharded round 4 virtual devices).
"""
import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hlo_analysis as HA
from repro.analysis import roofline as RRL
from repro.configs import base as RB
from repro.launch.mesh import compat_make_mesh
from repro.models import model as RM
from repro.models.layers import MeshCtx
from repro.train import optimizer as ROPT
from repro_torch.analysis import cost
from repro_torch.analysis import roofline as PRL
from repro_torch.configs import base as PB
from repro_torch.data.kb_sources import LUBM_L, lubm_facts
from repro_torch.engine import distributed as D
from repro_torch.engine import plan
from repro_torch.engine.fused import lower_fused_programs
from repro_torch.engine.materialize import EngineKB, materialize
from repro_torch.kernels import bitonic_sort as BS
from repro_torch.kernels import ops as KO
from repro_torch.launch import dryrun
from repro_torch.models import model as PM
from repro_torch.train import optimizer as POPT

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
B, S = 2, 24            # two attention and two loss chunks of 16
DIST_CFG = dict(shard_cap=1 << 10, delta_cap=1 << 8, bucket_cap=1 << 6)
DIST_NDEV = 4


# ---------------------------------------------------------------------------
# the reference's walk, restricted to matrix products
# ---------------------------------------------------------------------------
def ref_dot_flops(text: str) -> float:
    """``hlo_analysis``'s walk (while bodies times their trip counts,
    fusion and call bodies, the costliest branch) counting ``dot`` and
    ``convolution`` only, with its own FLOP formulas."""
    hc = HA.HloCost(text)
    memo = {}

    def walk(name):
        if name in memo:
            return memo[name]
        comp = hc.comps.get(name)
        total = 0.0
        for op in comp.ops if comp is not None else ():
            if op.opcode == "while":
                cond = HA._COND_RE.search(op.rest).group(1)
                body = HA._BODY_RE.search(op.rest).group(1)
                total += HA._trip_count(hc.comps[cond]) * walk(body)
            elif op.opcode == "conditional":
                m = HA._BRANCH_RE.search(op.rest)
                names = [b.strip().lstrip("%") for b in m.group(1).split(",")]
                total += max(walk(b) for b in names)
            elif op.opcode in ("call", "async-start", "fusion"):
                m = HA._TO_APPLY_RE.search(op.rest) or \
                    HA._CALLS_RE.search(op.rest)
                total += walk(m.group(1)) if m else 0.0
            elif op.opcode == "dot":
                total += HA._dot_flops(op, comp)
            elif op.opcode == "convolution":
                total += HA._conv_flops(op, comp)
        memo[name] = total
        return total

    return walk(hc.entry.name)


def _compile_text(fn, *specs) -> str:
    return jax.jit(fn).lower(*specs).compile().as_text()


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(PB.SHAPES))
@pytest.mark.parametrize("arch", PB.ARCHS)
def test_model_flops_estimate_matches_reference(arch, shape):
    want = RRL.model_flops_estimate(RB.get_config(arch), RB.SHAPES[shape])
    got = PRL.model_flops_estimate(PB.get_config(arch), PB.SHAPES[shape])
    assert got == want


def test_model_flops_count_active_parameters():
    """Active, not total: the shared block counts once per use, and an MoE
    layer its top-k experts."""
    shape = PB.SHAPES["train_4k"]
    toks = shape.global_batch * shape.seq_len
    for arch in ("zamba2_1p2b", "qwen3_moe_30b_a3b"):
        counts = PB.get_config(arch).param_counts()
        assert counts["active"] != counts["total"]
        assert PRL.model_flops_estimate(PB.get_config(arch), shape) == \
            6.0 * counts["active"] * toks


# ---------------------------------------------------------------------------
# tests/test_roofline.py's cases, and a matmul chain
# ---------------------------------------------------------------------------
def test_dot_flops_of_a_matmul_chain_equal_the_reference():
    dims = (64, 32, 48, 16, 8)
    rng = np.random.default_rng(0)
    mats = [rng.standard_normal((a, b)).astype(np.float32)
            for a, b in zip(dims, dims[1:])]

    def chain(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = out @ m
        return out

    text = _compile_text(chain, *(jax.ShapeDtypeStruct(m.shape, jnp.float32)
                                  for m in mats))
    with cost.Recorder() as r:
        chain(*(torch.from_numpy(m) for m in mats))
    want = HA.analyze_text(text)["flops"]
    assert want == ref_dot_flops(text)          # the chain holds dots only
    assert r.cost.dot_flops == r.cost.flops == want


def test_loop_of_layers_counts_each_layer():
    n, L = 128, 8
    x, w = torch.randn(n, n), torch.randn(n, n)
    with cost.Recorder() as one:
        torch.tanh(x @ w)
    with cost.Recorder() as loop:
        h = x
        for _ in range(L):
            h = torch.tanh(h @ w)
    for field in ("flops", "dot_flops", "bytes"):
        assert getattr(loop.cost, field) == L * getattr(one.cost, field)


def test_dot_flops_exact():
    m, k, n = 64, 32, 16
    a, b = torch.randn(m, k), torch.randn(k, n)
    with cost.Recorder() as r:
        a @ b
    assert r.cost.dot_flops == 2 * m * k * n


def test_nested_loops_multiply():
    """3 x 4 runs of ``g * 1.5 + 1.0`` on 64 lanes: two elementwise ops,
    one FLOP per output element each."""
    x = torch.randn(64)
    with cost.Recorder() as r:
        h = x
        for _ in range(3):
            g = h
            for _ in range(4):
                g = g * 1.5 + 1.0
            h = g
    assert r.cost.flops == 3 * 4 * 2 * 64


def test_roofline_terms_as_the_reference_computes_them():
    """One matmul through both walks and both ``analyze``: the same FLOPs
    and bytes, and each term the reference's times the ratio of the two
    packages' constants."""
    m, k, n = 128, 64, 32
    text = _compile_text(lambda a, b: a @ b,
                         jax.ShapeDtypeStruct((m, k), jnp.float32),
                         jax.ShapeDtypeStruct((k, n), jnp.float32))
    a, b = torch.randn(m, k), torch.randn(k, n)
    with cost.Recorder() as r:
        a @ b
    ref = RRL.analyze("a", "s", "16x16", 256, {"flops": 1e12}, text, 6e15)
    got = PRL.analyze("a", "s", "1", 256, r.as_dict(), 6e15)
    assert got.chips == ref.chips == 256
    assert (got.hlo_flops, got.hlo_bytes) == (ref.hlo_flops, ref.hlo_bytes)
    assert got.compute_s == ref.compute_s * RRL.PEAK_FLOPS / PRL.PEAK_FLOPS
    assert got.memory_s == ref.memory_s * RRL.HBM_BW / PRL.HBM_BW
    assert got.collective_s == ref.collective_s == 0.0
    assert got.useful_ratio == ref.useful_ratio
    assert got.bottleneck in ("compute", "memory", "collective")
    assert (PRL.PEAK_FLOPS, PRL.HBM_BW, PRL.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_collective_bytes_by_kind_all_reduce_twice():
    """The lockstep's psum of an f32[16,16] on each of 2 shards is one
    all-reduce of 16 x 16 x 4 bytes, counted 2x (ring); its bucket
    exchange one all-to-all of one shard's buckets."""
    def body(d):
        total = yield D._psum("p", torch.full((16, 16), float(d)))
        got = yield D._Collective("all_to_all", "a",
                                  torch.zeros((2, 4, 2), dtype=torch.int32))
        return total, got

    with cost.Recorder() as r:
        outs = D._lockstep([body(0), body(1)])
    assert (outs[0][0] == 1.0).all()
    rec = r.as_dict()
    assert rec["coll"]["all-reduce"] == 2 * 16 * 16 * 4
    assert rec["coll"]["all-to-all"] == 2 * 4 * 2 * 4
    assert rec["coll_count"] == 2
    assert rec["coll_bytes"] == 2 * 16 * 16 * 4 + 2 * 4 * 2 * 4


# ---------------------------------------------------------------------------
# models: dot FLOPs against the reference walk
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def mcx():
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    return MeshCtx(mesh=mesh, dp=("data",), tp="model")


def model_gap(cfg, kind: str, vocab_rows: int) -> int:
    """Port minus reference matrix-product FLOPs, by what each program
    does that the other does not:

    * causal attention: the port skips a fully masked (q-chunk, kv-chunk)
      block, the reference's ``lax.scan`` computes and masks it; 2 dots a
      block in the forward, 8 in a train step (forward, its remat, and 4
      in the backward);
    * the cross-entropy: the port checkpoints each loss chunk, so its
      logits are computed again in the backward; the reference's compiled
      step keeps them;
    * Mamba-1's depthwise conv: a dot over the K taps on the reference (in
      a train step also its remat and its backward), multiply-adds on the
      port."""
    gap = 0
    if cfg.family != "ssm":
        c = min(cfg.attn_chunk, S)
        nq = -(-S // c)
        block = 2 * B * cfg.num_heads * c * c * cfg.head_dim
        dots = 2 if kind == "prefill" else 8
        gap -= cfg.num_layers * (nq * (nq - 1) // 2) * dots * block
    if kind == "train":
        c = min(cfg.loss_chunk, S)
        gap += -(-S // c) * 2 * B * c * cfg.d_model * vocab_rows
    if cfg.ssm_version == 1:
        conv = 2 * B * S * cfg.d_inner * cfg.ssm_conv
        gap -= cfg.num_layers * conv * (1 if kind == "prefill" else 3)
    return gap


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["stablelm_12b", "qwen3_moe_30b_a3b",
                                  "falcon_mamba_7b"])
def test_model_dot_flops_against_the_reference_walk(arch, kind):
    cfg = RB.get_smoke_config(arch).with_(dtype="float32", num_layers=2)
    mdl = RM.build(cfg, mcx())
    params = mdl.init_params(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S),
                                            dtype=np.int32)
    tree = jax.tree.map(np.asarray, params)
    pcfg = PB.get_smoke_config(arch).with_(dtype="float32", num_layers=2)
    port = PM.build(pcfg, "cpu", training=kind == "train")
    port.load_state_dict(PM.params_from_reference(
        tree, pcfg, training=kind == "train"), strict=kind == "prefill")
    if kind == "prefill":
        text = _compile_text(mdl.prefill_step, params,
                             {"tokens": jnp.asarray(toks)})
        with cost.Recorder() as r:
            port.prefill_step({"tokens": toks})
    else:
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
        opt = ROPT.init_opt_state(params, mdl.opt_cfg)
        text = _compile_text(mdl.train_step, params, opt, batch,
                             jnp.int32(0))
        pp = dict(port.named_parameters())
        with cost.Recorder() as r:
            port.train_step(POPT.init_opt_state(pp, port.opt_cfg),
                            {"tokens": toks, "labels": toks}, 0)
    want = ref_dot_flops(text)
    assert r.cost.dot_flops - want == model_gap(pcfg, kind,
                                                port.emb.shape[0])


# ---------------------------------------------------------------------------
# the hand kernels count their formulas
# ---------------------------------------------------------------------------
def test_sort_counts_its_ladder_and_nothing_of_its_plain_version():
    n, tile = 1 << 12, 256
    keys = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << 20, n).astype(np.int32))
    vals = torch.arange(n, dtype=torch.int32)
    with cost.Recorder() as r:
        KO.sort_with_payload(keys, vals, tile=tile)
    per = 2 * n * (4 + 4)
    merges = int(math.log2(n // tile))
    rec = r.as_dict()
    assert rec["ops"] == 0 and rec["sorts"] == 1
    assert rec["bytes"] == (1 + merges) * per
    assert rec["kernels"] == {
        "bitonic_sort_tiles": {"calls": 1, "bytes": per, "flops": 2 * n},
        "bitonic_merge_pairs": {"calls": merges, "bytes": merges * per,
                                "flops": merges * 2 * n}}
    with cost.Recorder() as one:
        BS.bitonic_sort_tiles(keys, vals, tile)
    assert one.as_dict()["kernels"] == {
        "bitonic_sort_tiles": {"calls": 1, "bytes": per, "flops": 2 * n}}


def test_unique_mask_counts_its_formula():
    rows = torch.from_numpy(np.sort(np.random.default_rng(2).integers(
        0, 50, (1000, 3)).astype(np.int16), axis=0))
    with cost.Recorder() as r:
        KO.unique_mask(rows)
    rec = r.as_dict()
    assert rec["ops"] == 0
    assert rec["bytes"] == 1000 * 3 * 2 + 4 * 1000
    assert rec["kernels"]["unique_mask"]["calls"] == 1


def test_probe_counts_its_sectors():
    rng = np.random.default_rng(3)
    hay = np.sort(rng.integers(0, 4096, 1 << 12)).astype(np.int64)
    q = rng.integers(0, 4096, 300).astype(np.int64)
    with cost.Recorder() as r:
        KO.probe_sorted(torch.from_numpy(q), torch.from_numpy(hay))
    pos = np.minimum(np.searchsorted(hay, q), len(hay) - 1)
    sectors = len(np.unique(pos // (32 // 8)))
    rec = r.as_dict()
    assert rec["ops"] == 0
    assert rec["bytes"] == 300 * (8 + 4) + 32 * sectors


def test_a_captured_probe_counts_its_bound(monkeypatch):
    """Inside a CUDA graph capture a probe has no keys to read (reading
    them is a host sync, which a capture refuses): it counts the bound a
    fake call counts, one sector per query up to the haystack's, and
    searches nothing."""
    rng = np.random.default_rng(3)
    hay = torch.from_numpy(np.sort(rng.integers(0, 4096, 1 << 12)))
    q = torch.from_numpy(rng.integers(0, 4096, 300))
    monkeypatch.setattr(cost, "_capturing", lambda t: True)

    def no_search(*a, **k):
        raise AssertionError("a captured probe searched its haystack")

    want = 300 * (8 + 4) + 32 * min(300, 4096 // 4)
    with monkeypatch.context() as m:
        m.setattr(torch, "searchsorted", no_search)
        m.setattr(torch, "unique", no_search)
        assert cost.probe_cost(q, hay) == (want, 300)
    with cost.Recorder() as r:
        KO.probe_sorted(q, hay)
    assert r.as_dict()["bytes"] == want


def test_other_threads_neither_count_nor_stop_the_count():
    """A recorder counts its own thread: another thread's suspension (a
    kernel wrapper running there) does not stop it, and a wrapper called
    on another thread reports nothing to it."""
    import threading
    rows = torch.from_numpy(np.sort(np.random.default_rng(2).integers(
        0, 50, (1000, 3)).astype(np.int16), axis=0))
    x = torch.randn(32, 32)
    inside, done = threading.Event(), threading.Event()

    def other():
        with cost.suspended():
            inside.set()
            done.wait(60)
        KO.unique_mask(rows)

    with cost.Recorder() as r:
        t = threading.Thread(target=other)
        t.start()
        assert inside.wait(60)
        x @ x
        done.set()
        t.join()
    rec = r.as_dict()
    assert rec["dot_flops"] == 2 * 32 ** 3 and rec["kernels"] == {}


def test_replays_add_the_captured_count():
    """What a capture records is held apart (``KO.uncounted``) and added
    once per replay (``KO.add_launches``), as the launch counts are."""
    x = torch.randn(32, 32)
    with cost.Recorder() as r:
        with KO.uncounted() as made:
            x @ x
        assert r.cost.ops == 0
        KO.add_launches(made, 3)
    assert made.cost.dot_flops == 2 * 32 ** 3
    assert r.cost.dot_flops == 3 * 2 * 32 ** 3
    assert cost.ACTIVE is None
    with KO.uncounted() as idle:
        x @ x
    assert idle.cost is None


# ---------------------------------------------------------------------------
# dry mode and memory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["stablelm_12b", "qwen3_moe_30b_a3b",
                                  "falcon_mamba_7b"])
def test_dry_argument_bytes_equal_the_real_weights_and_state(arch):
    cfg = PB.get_smoke_config(arch)
    shape = PB.ShapeConfig("smoke", S, B, "train")
    rec, _ = dryrun.count_step(cfg, shape)
    mdl = PM.build(cfg, "cpu", training=True)
    params = dict(mdl.named_parameters())
    opt = POPT.init_opt_state(params, mdl.opt_cfg)
    real = (sum(p.nbytes for p in params.values())
            + sum(t.nbytes for part in opt.values() for t in part.values()))
    batch = 2 * B * S * 4                       # int32 tokens and labels
    mem = rec["memory"]
    assert mem["argument_bytes"] == real + batch
    # the weights and the optimizer state are updated in place
    assert mem["alias_bytes"] == real
    assert rec["dot_flops"] > 0 and mem["temp_bytes"] > 0


def test_dry_run_cells():
    skipped = dryrun.run_cell("hubert_xlarge", "decode_32k")
    assert skipped["status"] == "skipped"
    rec = dryrun.run_cell("internvl2_1b", "decode_32k")
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", "1", 1)
    cfg = PB.get_config("internvl2_1b")
    rl = rec["roofline"]
    assert rl["model_flops"] == PRL.model_flops_estimate(
        cfg, PB.SHAPES["decode_32k"])
    assert rl["hlo_flops"] > rl["model_flops"] > 0
    shape = PB.SHAPES["decode_32k"]
    kv = 2 * cfg.num_layers * shape.global_batch * shape.seq_len * \
        cfg.num_kv_heads * cfg.head_dim * 2          # bfloat16 K and V
    assert rec["memory"]["argument_bytes"] > kv
    with pytest.raises(NotImplementedError, match="item 12"):
        dryrun.run_cell("internvl2_1b", "decode_32k", multi_pod=True)


# ---------------------------------------------------------------------------
# engine programs against the reference's, from one subprocess
# ---------------------------------------------------------------------------
REFERENCE_RUN = textwrap.dedent("""
    import os, json, sys, functools
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["REPRO_FUSED"] = "1"
    import jax, jax.experimental
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    jax.shard_map = functools.partial(jax.shard_map, check_vma=False)
    from repro.analysis import hlo_analysis as HA
    from repro.data import kb_sources as S
    from repro.engine.distributed import DistConfig, lower_distributed_tc
    from repro.engine.fused import lower_fused_programs
    from repro.engine.materialize import EngineKB, materialize
    from repro.launch.mesh import make_data_mesh

    kb = EngineKB(S.LUBM_L, S.lubm_facts(n_univ=1))
    materialize(kb, mode="tg")
    sorts = {name: sum(1 for c in HA.parse_hlo(text).values()
                       for op in c.ops if op.opcode == "sort")
             for name, (text, _) in lower_fused_programs(kb).items()}
    cfg = DistConfig(axis=("data",), **json.loads(sys.argv[2]))
    text = lower_distributed_tc(make_data_mesh(4), cfg).compile().as_text()
    with open(sys.argv[1], "w") as f:
        json.dump({"sorts": sorts, "dist": HA.analyze_text(text)}, f)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("reference") / "analysis.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith("REPRO_")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    subprocess.run([sys.executable, "-c", REFERENCE_RUN, str(path),
                    json.dumps(DIST_CFG)], check=True, env=env, timeout=600)
    with open(path) as f:
        return json.load(f)


def test_lower_fused_programs_sort_ops_against_the_reference(
        reference, monkeypatch):
    monkeypatch.setenv("REPRO_FUSED", "1")
    monkeypatch.setattr(plan, "_CAP_MEMO", {})
    kb = EngineKB(LUBM_L, lubm_facts(n_univ=1), device="cpu")
    materialize(kb, mode="tg")
    memo = dict(plan._CAP_MEMO)
    got = lower_fused_programs(kb)
    assert plan._CAP_MEMO == memo          # counting commits nothing
    assert {k: v["sort_ops_static"] for k, v in got.items()} == \
        reference["sorts"]
    assert got["fixpoint"]["trip_count"] == 1
    roof = PRL.engine_fused_roofline(kb, kb.num_facts())
    for name, rec in got.items():
        assert roof[name]["bytes"] == rec["bytes"] > 0
        assert roof[name]["sort_ops_static"] == rec["sort_ops_static"]


def test_lower_distributed_tc_collectives_against_the_reference(reference):
    """All-to-all bytes are equal (3 exchanges of one shard's (4, 64, 2)
    int32 buckets).  The count is the reference's plus 2: XLA's all-reduce
    combiner merges the round's three psums (fresh total, triggers,
    overflow flags) into one all-reduce, and the lockstep performs each."""
    ref = reference["dist"]
    got = D.lower_distributed_tc(DIST_NDEV, D.DistConfig(**DIST_CFG),
                                 device="cpu")
    bucket = DIST_NDEV * DIST_CFG["bucket_cap"] * 2 * 4
    assert got["coll"]["all-to-all"] == ref["coll"]["all-to-all"] == \
        3 * bucket
    assert got["coll_count"] == ref["coll_count"] + 2
    assert got["coll"]["all-gather"] == ref["coll"]["all-gather"] == 0


def test_engine_op_roofline_counts_the_cores():
    out = PRL.engine_op_roofline(3000, device="cpu")
    assert (out["capacity"], out["dtype"]) == (4096, "int32")
    for op in ("sort", "probe", "absorb"):
        assert out[op]["bytes"] > 0
        assert out[op]["bytes_per_fact"] == out[op]["bytes"] / 3000
    one = PRL.engine_op_roofline(1 << 12, arity=1, device="cpu")
    assert set(one["sort"]["kernels"]) == {"bitonic_sort_tiles",
                                          "bitonic_merge_pairs"}
