"""The port's serving path (``repro_torch.models.model``,
``repro_torch.launch.serve``, ``repro_torch.data.pipeline``) against the
JAX reference, in-process on the CPU.

Each model's weights are the reference's ``init_params(PRNGKey(k))``,
carried over by ``params_from_reference``; prompts come from a numpy seed.
The reference's steps are jitted as ``repro.launch.serve`` jits them,
except in the MoE, SSM and hybrid configurations, which are compiled with
XLA's excess precision off (``rounded_jit``).
Prefill runs over two attention chunks (the smoke configs' chunk is 16, the
prompt 24 tokens; three SSM chunks of 8), then 8 decode steps on caches
zero-padded to prompt + 8 (the SSM states have no sequence axis), each
step fed the reference's token.  Tolerances: float32 atol = rtol =
1e-4 with every greedy token equal; bfloat16 atol 5e-2, with tokens equal
wherever the reference's top-2 logit margin exceeds it, and, relative to
scale, rms(port - reference) <= 2**-6 rms(reference) (four units of
bfloat16 rounding; the absolute bound is about a third of a typical logit
or cache value at smoke width).
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.data import pipeline as RP
from repro.launch.mesh import compat_make_mesh
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import ssm as RSSM
from repro.models import transformer as RT
from repro.models.layers import MeshCtx
from repro_torch.configs import base as PB
from repro_torch.data import pipeline as PP
from repro_torch.data.kb_sources import LUBM_L, lubm_facts
from repro_torch.engine.materialize import EngineKB, materialize
from repro_torch.launch import dryrun, serve, train
from repro_torch.models import model as PM
from repro_torch.models import ssm as PSSM
from repro_torch.models import transformer as PT

SERVED = ["stablelm_12b", "starcoder2_15b", "command_r_35b",
          "nemotron_4_340b", "internvl2_1b", "qwen3_moe_30b_a3b",
          "deepseek_v3_671b", "falcon_mamba_7b", "zamba2_1p2b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=0)}
BF16_RMS = 2.0 ** -6
B, S, GEN = 2, 24, 8


def rounded_jit(fn):
    """``fn`` jitted and compiled, once per input signature, with XLA's
    excess precision off: every bfloat16 value is then rounded where the
    reference's code rounds it.  With it on, XLA may keep a fused value in
    float32 (the normed hidden state the router reads, for one), so the
    compiled reference leaves its own op-by-op arithmetic, and in the MoE
    configurations a routing near-tie flips (qwen3's smoke config in
    bfloat16: one token's 2nd and 3rd expert probabilities 3.7e-4 apart,
    relative) and moves that token's later cache rows by 0.15."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = jax.tree.map(lambda a: (a.shape, a.dtype), args)
        key = (jax.tree.structure(args), tuple(jax.tree.leaves(key)))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*args)
    return call


@functools.lru_cache(maxsize=None)
def reference(arch, dtype, key, **overrides):
    """The reference model, its parameters, and its prefill / decode steps
    returning logits, jitted once per configuration (the bodies of
    ``Model.prefill_step`` / ``decode_step`` before their argmax; a MoE,
    SSM or hybrid configuration's through ``rounded_jit``); ``overrides``
    change fields of the config."""
    cfg = RB.get_smoke_config(arch).with_(dtype=dtype, **overrides)
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    mcx = MeshCtx(mesh=mesh, dp=("data",), tp="model")
    mdl = RM.build(cfg, mcx)
    params = mdl.init_params(jax.random.PRNGKey(key))

    def prefill(params, batch):
        x = mdl._embed_inputs(params, batch)
        positions = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
        h, caches = RT.forward_prefill(params, x, cfg, mcx, positions)
        h = RL.apply_norm(params["ln_final"], h, cfg)
        return RM.logits_fn(h[:, -1:], RM._unemb_t(params, cfg), cfg,
                            mcx), caches

    def decode(params, caches, token, pos):
        if cfg.input_mode == "embeddings":
            x = token.astype(jnp.dtype(cfg.dtype))
        else:
            x = RM.embed(token[:, None], params["emb"], mcx)
        h, caches = RT.forward_decode(params, x, caches, pos, cfg, mcx)
        h = RL.apply_norm(params["ln_final"], h, cfg)
        return RM.logits_fn(h, RM._unemb_t(params, cfg), cfg, mcx), caches

    jit = rounded_jit if cfg.family in ("moe", "ssm", "hybrid") else jax.jit
    return mdl, params, jit(prefill), jit(decode)


def port_of(arch, dtype, params, **overrides):
    cfg = PB.get_smoke_config(arch).with_(dtype=dtype, **overrides)
    mdl = PM.build(cfg, "cpu")
    tree = jax.tree.map(np.asarray, params)
    mdl.load_state_dict(PM.params_from_reference(tree, cfg))
    return mdl


def as_np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, dtype):
    """Within ``TOL``; in bfloat16 also within ``BF16_RMS`` of the
    reference's scale."""
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if dtype == "bfloat16":
        diff, ref = (got - want).astype(np.float64), want.astype(np.float64)
        rel = np.sqrt(np.mean(diff ** 2) / np.mean(ref ** 2))
        assert rel <= BF16_RMS, f"rms(port - ref) / rms(ref) = {rel:.3e}"


def check_logits(got, want, dtype):
    """Logits close; greedy tokens equal (in bfloat16 where the
    reference's top-2 margin exceeds the tolerance).  Returns the
    reference's tokens."""
    got, want = as_np(got), as_np(want)
    assert_close(got, want, dtype)
    top2 = np.sort(want, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > (TOL[dtype]["atol"]
                                      if dtype == "bfloat16" else -1)
    tok = want.argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(got.argmax(-1)[sure], tok[sure])
    return tok


def check_caches(got, want, dtype):
    """Every cache close, the ``"ssm"`` states (conv, h) each."""
    assert got.keys() == want.keys()
    for n in got:
        pairs = zip(got[n], want[n]) if n == "ssm" else [(got[n], want[n])]
        for g, w in pairs:
            assert_close(as_np(g), as_np(w), dtype)


def shapes(caches) -> dict:
    return {n: tuple(s.shape for s in c) if n == "ssm" else c.shape
            for n, c in caches.items()}


def ref_pad_caches(caches, length):
    """``PM.pad_caches`` on the reference's caches: K/V padded along the
    sequence to ``length``, the SSM states as they are."""
    return {n: c if n == "ssm" else jnp.pad(
        c, ((0, 0), (0, 0), (0, length - c.shape[2]))
        + ((0, 0),) * (c.ndim - 3)) for n, c in caches.items()}


def prompt(cfg, seed, n=S):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return {"embeddings": rng.normal(0, 1, (B, n, cfg.d_model))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(
        np.int32)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", SERVED)
def test_prefill_and_decode_equal_the_reference(arch, dtype):
    _, params, ref_prefill, ref_decode = reference(arch, dtype, 0)
    port = port_of(arch, dtype, params)
    cfg = port.cfg
    batch = prompt(cfg, 1)
    logits_r, caches_r = ref_prefill(params, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    logits_p, caches_p = port.prefill({k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    tok = check_logits(logits_p, logits_r, dtype)
    check_caches(caches_p, caches_r, dtype)
    assert shapes(caches_p) == PT.cache_shapes(cfg, B, S)
    caches_r = ref_pad_caches(caches_r, S + GEN)
    caches_p = PM.pad_caches(caches_p, S + GEN)
    rng = np.random.default_rng(2)
    for t in range(GEN):
        if cfg.input_mode == "embeddings":
            step = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
        else:
            step = tok
        logits_r, caches_r = ref_decode(params, caches_r, jnp.asarray(step),
                                        jnp.asarray(S + t, jnp.int32))
        logits_p, caches_p = port.decode(caches_p, torch.from_numpy(step),
                                         S + t)
        tok = check_logits(logits_p, logits_r, dtype)
    check_caches(caches_p, caches_r, dtype)
    # every step wrote its token's cache rows: no padded position is left
    # at zero
    for n, c in caches_p.items():
        if n != "ssm":
            assert bool((c[:, :, S:].abs().sum(-1) > 0).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_prefill_equals_the_reference(dtype):
    """hubert (encoder-only, embeddings in): prefill attends without a
    causal mask and without RoPE; decode is refused."""
    _, params, ref_prefill, _ = reference("hubert_xlarge", dtype, 4)
    port = port_of("hubert_xlarge", dtype, params)
    batch = prompt(port.cfg, 5)
    logits_r, caches_r = ref_prefill(params, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
    logits_p, caches_p = port.prefill({k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    check_logits(logits_p, logits_r, dtype)
    check_caches(caches_p, caches_r, dtype)
    with pytest.raises(ValueError, match="encoder-only"):
        port.decode_step(caches_p, torch.zeros(B, 1, port.cfg.d_model), S)


def test_prompt_length_cache_is_left_unchanged_at_pos_s():
    """The reference's contract, kept: with caches exactly as long as the
    prompt, ``decode_step(..., pos=S)`` writes nothing (``pos < S`` is
    false), in both packages, and both pick the same token."""
    ref, params, _, _ = reference("stablelm_12b", "float32", 0)
    port = port_of("stablelm_12b", "float32", params)
    batch = prompt(port.cfg, 6)
    t_r, c_r = jax.jit(ref.prefill_step)(params, {"tokens": jnp.asarray(
        batch["tokens"])})
    t_p, c_p = port.prefill_step({"tokens": torch.from_numpy(
        batch["tokens"])})
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_r))
    before = {n: c.clone() for n, c in c_p.items()}
    t2_r, c2_r = jax.jit(ref.decode_step)(params, c_r, t_r,
                                          jnp.asarray(S, jnp.int32))
    t2_p, c2_p = port.decode_step(c_p, t_p, S)
    np.testing.assert_array_equal(t2_p.numpy(), np.asarray(t2_r))
    for n in ("k", "v"):
        assert torch.equal(c2_p[n], before[n])
        assert np.array_equal(np.asarray(c2_r[n]), np.asarray(c_r[n]))


@pytest.mark.parametrize("cache", ["prompt_length", "padded"])
def test_decode_matches_forward_greedy(cache):
    """``tests/test_models_smoke.py``'s check on the port, with its
    weights (``PRNGKey(3)``) and prompt (``PRNGKey(4)``): the greedy token
    after one decode step equals a re-prefill over the extended sequence.
    On a prompt-length cache the step attends to the prompt only, so this
    holds for these inputs, not in general; on a padded cache it attends
    to its own K/V too, and its logits equal the re-prefill's."""
    _, params, _, _ = reference("stablelm_12b", "float32", 3)
    mdl = port_of("stablelm_12b", "float32", params)
    tokens = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(4), (2, 16), 0, mdl.cfg.vocab_size)))
    t1, caches = mdl.prefill_step({"tokens": tokens})
    if cache == "padded":
        caches = PM.pad_caches(caches, 17)
    l2, _ = mdl.decode(caches, t1, 16)
    l2_ref, _ = mdl.prefill({"tokens": torch.cat([tokens, t1[:, None]], 1)})
    np.testing.assert_array_equal(l2.argmax(-1).numpy(),
                                  l2_ref.argmax(-1).numpy())
    if cache == "padded":
        np.testing.assert_allclose(l2.numpy(), l2_ref.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_sharding_and_backward_flags_keep_the_forward():
    """``explicit_tp``, ``flash_vjp``, ``remat``, ``zero1``, ``fsdp`` and
    ``microbatches`` change sharding or the backward pass only."""
    cfg = PB.get_smoke_config("stablelm_12b").with_(dtype="float32")
    flags = dict(explicit_tp=True, flash_vjp=True, remat="none", zero1=False,
                 fsdp=True, microbatches=4)
    a = PM.build(cfg, "cpu", torch.Generator().manual_seed(5))
    b = PM.build(cfg.with_(**flags), "cpu", torch.Generator().manual_seed(5))
    batch = {"tokens": torch.from_numpy(prompt(cfg, 6)["tokens"])}
    (la, ca), (lb, cb) = a.prefill(batch), b.prefill(batch)
    assert torch.equal(la, lb) and torch.equal(ca["k"], cb["k"])


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_decode_routes_at_its_own_capacity(capacity_factor):
    """A decode step routes its B tokens at capacity ceil(B k cf / E), a
    re-prefill its B (S + 1) tokens at another, so the two drop different
    assignments and decode does not equal a re-prefill past the first MoE
    layer, on the reference as on the port.  Smallest case: qwen3's smoke
    config (E = 8, k = 2), B = 2, a 1-token prompt: at the configured 1.25
    decode routes at C = 1 and the re-prefill at C = 2, and the logits
    differ by about 5e-3; at capacity factor E / k = 4 nothing is dropped
    and they are equal."""
    arch = "qwen3_moe_30b_a3b"
    _, params, ref_prefill, ref_decode = reference(
        arch, "float32", 0, capacity_factor=capacity_factor)
    port = port_of(arch, "float32", params, capacity_factor=capacity_factor)
    tok = np.random.default_rng(0).integers(0, 256, (2, 1)).astype(np.int32)

    def ref_steps():
        logits, caches = ref_prefill(params, {"tokens": jnp.asarray(tok)})
        nxt = np.asarray(logits).argmax(-1).astype(np.int32)
        caches = jax.tree.map(lambda c: jnp.pad(
            c, ((0, 0), (0, 0), (0, 1)) + ((0, 0),) * (c.ndim - 3)), caches)
        step, _ = ref_decode(params, caches, jnp.asarray(nxt),
                             jnp.asarray(1, jnp.int32))
        again, _ = ref_prefill(params, {"tokens": jnp.asarray(
            np.concatenate([tok, nxt[:, None]], 1))})
        return as_np(step), as_np(again)

    def port_steps():
        logits, caches = port.prefill({"tokens": torch.from_numpy(tok)})
        nxt = logits.argmax(-1)
        step, _ = port.decode(PM.pad_caches(caches, 2), nxt, 1)
        again, _ = port.prefill({"tokens": torch.cat(
            [torch.from_numpy(tok), nxt[:, None].int()], 1)})
        return as_np(step), as_np(again)

    (step_r, again_r), (step_p, again_p) = ref_steps(), port_steps()
    np.testing.assert_allclose(step_p, step_r, **TOL["float32"])
    for step, again in ((step_r, again_r), (step_p, again_p)):
        gap = np.abs(step - again).max()
        assert (gap > 1e-3) if capacity_factor < 4 else (gap <= 1e-5), gap


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1p2b"])
def test_ssm_decode_matches_reprefill(arch):
    """On both packages, float32: one decode step after a prefill equals a
    re-prefill of the prompt and the token it was fed, in the greedy token
    (``tests/test_models_smoke.py``'s SSM check, its weights ``PRNGKey(5)``
    and prompt ``PRNGKey(6)``) and in the logits.  Falcon's prompt is 16
    tokens (two SSM chunks); zamba2's is 7, so that the re-prefill of 8
    fits one SSM chunk (the reference's multi-chunk SSD is not exact:
    ``test_reference_ssd_is_exact_in_one_chunk_only``), and its shared
    block's K/V caches are padded to 8 so that the step writes its row."""
    _, params, ref_prefill, ref_decode = reference(arch, "float32", 5)
    port = port_of(arch, "float32", params)
    n = 16 if arch == "falcon_mamba_7b" else port.cfg.ssm_chunk - 1
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(6), (B, n), 0,
                                          port.cfg.vocab_size), np.int32)

    def ref_steps():
        logits, caches = ref_prefill(params, {"tokens": jnp.asarray(tokens)})
        fed = np.asarray(logits).argmax(-1).astype(np.int32)
        step, _ = ref_decode(params, ref_pad_caches(caches, n + 1),
                             jnp.asarray(fed), jnp.asarray(n, jnp.int32))
        again, _ = ref_prefill(params, {"tokens": jnp.asarray(
            np.concatenate([tokens, fed[:, None]], 1))})
        return as_np(step), as_np(again)

    def port_steps():
        logits, caches = port.prefill({"tokens": torch.from_numpy(tokens)})
        fed = logits.argmax(-1).int()
        step, _ = port.decode(PM.pad_caches(caches, n + 1), fed, n)
        again, _ = port.prefill({"tokens": torch.cat(
            [torch.from_numpy(tokens), fed[:, None]], 1)})
        return as_np(step), as_np(again)

    (step_r, again_r), (step_p, again_p) = ref_steps(), port_steps()
    np.testing.assert_allclose(step_p, step_r, **TOL["float32"])
    for step, again in ((step_r, again_r), (step_p, again_p)):
        np.testing.assert_array_equal(step.argmax(-1), again.argmax(-1))
        np.testing.assert_allclose(step, again, **TOL["float32"])


def ssd_recurrence(xh, log_a, Bm, Cm):
    """SSD step by step in float64: h_t = exp(log_a_t) h_{t-1} + x_t B_t^T,
    y_t = h_t C_t (one group).  Returns (y, final h)."""
    Bsz, n, nh, hd = xh.shape
    h = np.zeros((Bsz, nh, hd, Bm.shape[-1]))
    ys = []
    for t in range(n):
        h = np.exp(log_a[:, t])[..., None, None] * h + \
            xh[:, t, :, :, None] * Bm[:, t, 0][:, None, None, :]
        ys.append(np.einsum("bhdn,bn->bhd", h, Cm[:, t, 0]))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("chunk", [32, 8])
def test_reference_ssd_is_exact_in_one_chunk_only(chunk):
    """ROADMAP Queue 3: the reference's ``ssd_chunked`` contracts its
    inter-chunk term over the diagonal of the chunk states
    (``src/repro/models/ssm.py:254``), so it equals a step-by-step
    recurrence only while the sequence fits one chunk.  B = 2, S = 32,
    nh = N = 8, hd = 16: with one chunk of 32, y equals the recurrence;
    with four chunks of 8, y is off by more than 1 (values up to about
    40); the final state is right in both.  The port keeps the
    reference's arithmetic and equals it in both cases."""
    rng = np.random.default_rng(0)
    xh = rng.normal(0, 1, (2, 32, 8, 16)).astype(np.float32)
    log_a = -rng.uniform(0.0, 0.5, (2, 32, 8)).astype(np.float32)
    Bm, Cm = (rng.normal(0, 1, (2, 32, 1, 8)).astype(np.float32)
              for _ in range(2))
    y_rec, h_rec = ssd_recurrence(xh, log_a, Bm, Cm)
    y_r, h_r = (np.asarray(a) for a in RSSM.ssd_chunked(
        *(jnp.asarray(a) for a in (xh, log_a, Bm, Cm)), chunk))
    y_p, h_p = (a.numpy() for a in PSSM.ssd_chunked(
        *(torch.from_numpy(a) for a in (xh, log_a, Bm, Cm)), chunk))
    np.testing.assert_allclose(y_p, y_r, **TOL["float32"])
    np.testing.assert_allclose(h_p, h_r, **TOL["float32"])
    for y, h in ((y_r, h_r), (y_p, h_p)):
        np.testing.assert_allclose(h, h_rec, atol=1e-4, rtol=1e-4)
        gap = np.abs(y - y_rec).max()
        assert (gap <= 1e-4 * np.abs(y_rec).max()) if chunk == 32 \
            else gap > 1.0, gap


def test_training_and_dry_run_raise():
    """Training is ported (``tests/test_torch_train*.py``): a serving
    model's ``train_step`` refuses, since it holds frozen weights and no
    MTP head.  The dry run is ported (``tests/test_torch_analysis.py``):
    a decode step of the smoke config counts under fake tensors, its K/V
    caches updated in place."""
    cfg = PB.get_smoke_config("stablelm_12b")
    mdl = PM.build(cfg, "cpu")
    with pytest.raises(ValueError, match="training=True"):
        mdl.train_step({}, {}, 0)
    assert callable(train.main)
    rec, _ = dryrun.count_step(cfg, PB.ShapeConfig("smoke", S, B, "decode"))
    kv = 2 * cfg.num_layers * B * S * cfg.num_kv_heads * cfg.head_dim * 2
    assert rec["memory"]["alias_bytes"] == kv
    assert rec["dot_flops"] > 0


def test_serve_launcher_prints_the_references_lines(capsys):
    serve.main(["--arch", "stablelm_12b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--gen", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"\[serve\] stablelm-12b: prefill\(2x20\)=\d+ms  "
                        r"decode 5 toks: [\d.]+ms/tok", lines[0]), lines
    assert re.fullmatch(r"\[serve\] sample: \[[\d ]+\]", lines[1]), lines
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])
    gen, _, _ = serve.serve(PB.get_smoke_config("internvl2_1b"), 2, 20, 5,
                            "cpu")
    assert gen.shape == (2, 5) and gen.max() < 256


@pytest.mark.parametrize("arch,name", [("qwen3_moe_30b_a3b",
                                        "qwen3-moe-30b-a3b"),
                                       ("deepseek_v3_671b",
                                        "deepseek-v3-671b")])
def test_serve_launcher_serves_the_moe_configurations(arch, name, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(rf"\[serve\] {name}: prefill\(4x32\)=\d+ms  "
                        r"decode 32 toks: [\d.]+ms/tok", lines[0]), lines
    assert re.fullmatch(r"\[serve\] sample: \[[\d ]+\]", lines[1]), lines


@pytest.mark.parametrize("arch,name", [("falcon_mamba_7b", "falcon-mamba-7b"),
                                       ("zamba2_1p2b", "zamba2-1.2b")])
def test_serve_launcher_serves_the_ssm_configurations(arch, name, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(rf"\[serve\] {name}: prefill\(4x32\)=\d+ms  "
                        r"decode 32 toks: [\d.]+ms/tok", lines[0]), lines
    assert re.fullmatch(r"\[serve\] sample: \[[\d ]+\]", lines[1]), lines


def test_synthetic_tokens_equal_the_reference():
    mine, ref = PP.SyntheticTokens(300, 3, 11, 7), RP.SyntheticTokens(300, 3,
                                                                      11, 7)
    for _ in range(2):
        a, b = mine.next(), ref.next()
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))
    st = mine.state()
    a = mine.next()
    mine.restore(st)
    assert np.array_equal(mine.next()["tokens"], a["tokens"])
    assert st == ref.state()


@pytest.mark.parametrize("materialized", [False, True])
def test_kb_linearizer_equals_the_reference(materialized):
    """The reference's linearizer is pure numpy: it runs on the port's CPU
    ``EngineKB`` (LUBM-L ``n_univ=1``) as it stands, base or after ``tg``."""
    kb = EngineKB(LUBM_L, lubm_facts(n_univ=1), device="cpu")
    if materialized:
        materialize(kb, mode="tg")
    mine, ref = PP.KBLinearizer(kb, 4, 32, seed=3), RP.KBLinearizer(
        kb, 4, 32, seed=3)
    assert mine.vocab_size == ref.vocab_size
    assert mine.stream.dtype == ref.stream.dtype
    np.testing.assert_array_equal(mine.stream, ref.stream)
    for _ in range(2):
        a, b = mine.next(), ref.next()
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))
    st, st_r = mine.state(), ref.state()
    a, b = mine.next(), ref.next()
    mine.restore(st)
    ref.restore(st_r)
    assert np.array_equal(mine.next()["tokens"], ref.next()["tokens"])
    assert np.array_equal(a["tokens"], b["tokens"])
