"""The port's SSM blocks (``repro_torch.models.ssm``: Mamba-1 and
Mamba-2 / SSD) and ``causal_tree_attention`` against the JAX reference's,
in-process on the CPU.

Parameters are made by the reference's own ``init_mamba1`` /
``init_mamba2`` from ``jax.random.PRNGKey(k)``, with ``conv_b``,
``dt_bias``, ``A_log``, ``D`` and ``norm_scale`` drawn at random (init
leaves them constant) so that every term counts; inputs come from a numpy
seed.  The reference runs compiled with XLA's excess precision off
(``rounded_jit``), so that its bfloat16 values are rounded where its code
rounds them.  Tolerances: float32 atol = rtol = 1e-4; bfloat16 atol 5e-2
and rms(port - reference) <= 2**-6 rms(reference), as in
``tests/test_torch_serve.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import ssm as RSSM
from repro_torch.configs import base as PB
from repro_torch.models import layers as PL
from repro_torch.models import ssm as PSSM
from test_torch_models import close, inputs, ref_cfg, to_torch
from test_torch_serve import rounded_jit

DTYPES = ["float32", "bfloat16"]
B, S = 2, 24


def ssm_cfg(arch, dtype="float32", **kw):
    """The smoke config (falcon: d_inner 128, N 4; zamba2: d_inner 128,
    8 heads of 16, N 8; SSM chunk 8)."""
    return PB.get_smoke_config(arch).with_(dtype=dtype, **kw)


def ssm_params(cfg, seed):
    """The reference's parameters of ``cfg``'s Mamba block, the constant
    leaves drawn at random."""
    rcfg = ref_cfg(cfg)
    init = RSSM.init_mamba1 if cfg.ssm_version == 1 else RSSM.init_mamba2
    p = dict(init(rcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def draw(name, mean, std):
        p[name] = jnp.asarray(rng.normal(mean, std, p[name].shape),
                              p[name].dtype)
    draw("conv_b", 0.0, 0.1)
    draw("dt_bias", -1.0, 0.5)
    draw("D", 1.0, 0.2)
    if "norm_scale" in p:
        draw("norm_scale", 1.0, 0.1)
    p["A_log"] = jnp.asarray(np.log(rng.uniform(0.5, 8.0, p["A_log"].shape)),
                             jnp.float32)
    return p


def state_inputs(cfg, dtype, seed):
    """A random (conv_state, h) of ``cfg``'s Mamba block for B rows."""
    K, N = cfg.ssm_conv, cfg.ssm_state
    if cfg.ssm_version == 1:
        conv_dim, h_shape = cfg.d_inner, (B, cfg.d_inner, N)
    else:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * N
        h_shape = (B, cfg.ssm_nheads, cfg.ssm_head_dim, N)
    (cj, ct), (hj, ht) = (inputs((B, K - 1, conv_dim), dtype, seed, 0.5),
                          inputs(h_shape, "float32", seed + 1, 0.5))
    return (cj, hj), (ct, ht)


def close_tree(got, want, dtype):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close_tree(g, w, dtype)
    else:
        close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d(with_state, dtype):
    K, C = 4, 40
    (xj, xt), (wj, wt), (bj, bt) = (inputs(s, dtype, i, 0.5) for i, s in
                                    enumerate([(B, S, C), (K, C), (C,)]))
    sj, st = inputs((B, K - 1, C), dtype, 3) if with_state else (None, None)
    want = rounded_jit(RSSM.causal_conv1d)(xj, wj, bj, sj) if with_state \
        else rounded_jit(lambda x, w, b: RSSM.causal_conv1d(x, w, b))(
            xj, wj, bj)
    close_tree(PSSM.causal_conv1d(xt, wt, bt, st), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1d_step(dtype):
    K, C = 4, 40
    (xj, xt), (wj, wt), (bj, bt), (sj, st) = (
        inputs(s, dtype, i, 0.5) for i, s in
        enumerate([(B, C), (K, C), (C,), (B, K - 1, C)]))
    close_tree(PSSM.conv1d_step(xt, wt, bt, st),
               rounded_jit(RSSM.conv1d_step)(xj, wj, bj, sj), dtype)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [1, 5, 8, 32])
def test_chunked_diag_scan(chunk, with_h0):
    """Chunk 8 divides S = 24, 5 pads the last chunk, 32 is one chunk."""
    rng = np.random.default_rng(chunk)
    a = rng.uniform(0.5, 1.0, (B, S, 6, 4)).astype(np.float32)
    u = rng.normal(0, 1, (B, S, 6, 4)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, 6, 4)).astype(np.float32) if with_h0 else None
    want = RSSM.chunked_diag_scan(jnp.asarray(a), jnp.asarray(u), chunk,
                                  None if h0 is None else jnp.asarray(h0))
    a_t, u_t = torch.from_numpy(a), torch.from_numpy(u)
    got = PSSM.chunked_diag_scan(a_t, u_t, chunk,
                                 None if h0 is None else torch.from_numpy(h0))
    close(got, want, "float32")
    # the inputs are left as they were
    assert np.array_equal(a_t.numpy(), a) and np.array_equal(u_t.numpy(), u)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba1_fwd(with_state, dtype):
    cfg = ssm_cfg("falcon_mamba_7b", dtype)
    rcfg, p = ref_cfg(cfg), ssm_params(cfg, 0)
    xj, xt = inputs((B, S, cfg.d_model), dtype, 1)
    if with_state:
        sj, st = state_inputs(cfg, dtype, 2)
        want = rounded_jit(lambda p, x, s: RSSM.mamba1_fwd(
            p, x, rcfg, None, state=s))(p, xj, sj)
        got = PSSM.mamba1_fwd(to_torch(p), xt, cfg, state=st)
    else:
        want = rounded_jit(lambda p, x: RSSM.mamba1_fwd(p, x, rcfg, None))(
            p, xj)
        got = PSSM.mamba1_fwd(to_torch(p), xt, cfg)
    close_tree(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba1_step(dtype):
    cfg = ssm_cfg("falcon_mamba_7b", dtype)
    rcfg, p = ref_cfg(cfg), ssm_params(cfg, 3)
    xj, xt = inputs((B, cfg.d_model), dtype, 4)
    sj, st = state_inputs(cfg, dtype, 5)
    want = rounded_jit(lambda p, x, s: RSSM.mamba1_step(p, x, rcfg, s))(
        p, xj, sj)
    close_tree(PSSM.mamba1_step(to_torch(p), xt, cfg, st), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("budget", [8 * B * S * 4, 40 * B * S * 4, 1])
def test_mamba1_sliced_scan_is_bit_equal(budget, dtype, monkeypatch):
    """``d_inner`` (128) scanned in slices of 8 channels, of 40 (the last
    one 8), or of one, gives the unsliced result to the bit."""
    cfg = ssm_cfg("falcon_mamba_7b", dtype)
    p = to_torch(ssm_params(cfg, 6))
    _, xt = inputs((B, S, cfg.d_model), dtype, 7)
    _, st = state_inputs(cfg, dtype, 8)
    assert len(PSSM._channel_slices(B, S, cfg.d_inner, cfg.ssm_state,
                                    PSSM.SCAN_SLICE_ELEMS)) == 1
    whole = PSSM.mamba1_fwd(p, xt, cfg, state=st)
    monkeypatch.setattr(PSSM, "SCAN_SLICE_ELEMS", budget)
    assert len(PSSM._channel_slices(B, S, cfg.d_inner, cfg.ssm_state,
                                    budget)) > 1
    sliced = PSSM.mamba1_fwd(p, xt, cfg, state=st)
    assert torch.equal(whole[0], sliced[0])
    assert all(torch.equal(a, b) for a, b in zip(whole[1], sliced[1]))


def test_segsum():
    la = -np.random.default_rng(9).uniform(0, 1, (2, 3, 7)).astype(np.float32)
    close(PSSM._segsum(torch.from_numpy(la)), RSSM._segsum(jnp.asarray(la)),
          "float32")


def ssd_inputs(dtype, seed, nh=8, hd=16, N=8, g=1, n=S):
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0, dt=dtype):
        x = rng.normal(0, scale, shape).astype(np.float32)
        return jnp.asarray(x, jnp.dtype(dt)), torch.from_numpy(x).to(
            PL.torch_dtype(dt))
    xh = draw((B, n, nh, hd))
    la = -rng.uniform(0.05, 1.0, (B, n, nh)).astype(np.float32)
    log_a = (jnp.asarray(la), torch.from_numpy(la))
    Bm, Cm = draw((B, n, g, N), 0.5), draw((B, n, g, N), 0.5)
    h0 = draw((B, nh, hd, N), 0.5, "float32")
    return xh, log_a, Bm, Cm, h0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [32, 8, 5])
def test_ssd_chunked(chunk, with_h0, dtype):
    """One chunk (32 >= S), three (8), five with the last padded (5): the
    port equals the reference, its diagonal inter-chunk term included."""
    xh, log_a, Bm, Cm, h0 = ssd_inputs(dtype, chunk)
    h0 = h0 if with_h0 else (None, None)
    want = rounded_jit(lambda *a: RSSM.ssd_chunked(*a[:4], chunk, *a[4:]))(
        *(t[0] for t in (xh, log_a, Bm, Cm) + ((h0,) if with_h0 else ())))
    got = PSSM.ssd_chunked(*(t[1] for t in (xh, log_a, Bm, Cm)), chunk,
                           h0[1])
    close_tree(got, want, dtype)


def test_ssd_chunked_needs_as_many_heads_as_states():
    """The reference's inter-chunk einsum needs nh == N (its repeated
    label); the port raises the same error."""
    xh, log_a, Bm, Cm, _ = ssd_inputs("float32", 0, nh=8, N=4)
    with pytest.raises(ValueError, match="Size of label 'n'"):
        RSSM.ssd_chunked(xh[0], log_a[0], Bm[0], Cm[0], 8)
    with pytest.raises(ValueError, match="Size of label 'n'"):
        PSSM.ssd_chunked(xh[1], log_a[1], Bm[1], Cm[1], 8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_fwd(with_state, dtype):
    cfg = ssm_cfg("zamba2_1p2b", dtype)
    rcfg, p = ref_cfg(cfg), ssm_params(cfg, 10)
    xj, xt = inputs((B, S, cfg.d_model), dtype, 11)
    if with_state:
        sj, st = state_inputs(cfg, dtype, 12)
        want = rounded_jit(lambda p, x, s: RSSM.mamba2_fwd(
            p, x, rcfg, None, state=s))(p, xj, sj)
        got = PSSM.mamba2_fwd(to_torch(p), xt, cfg, state=st)
    else:
        want = rounded_jit(lambda p, x: RSSM.mamba2_fwd(p, x, rcfg, None))(
            p, xj)
        got = PSSM.mamba2_fwd(to_torch(p), xt, cfg)
    close_tree(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_step(dtype):
    cfg = ssm_cfg("zamba2_1p2b", dtype)
    rcfg, p = ref_cfg(cfg), ssm_params(cfg, 13)
    xj, xt = inputs((B, cfg.d_model), dtype, 14)
    sj, st = state_inputs(cfg, dtype, 15)
    want = rounded_jit(lambda p, x, s: RSSM.mamba2_step(p, x, rcfg, s))(
        p, xj, sj)
    close_tree(PSSM.mamba2_step(to_torch(p), xt, cfg, st), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [64, 37, 16])
def test_causal_tree_attention(n, dtype):
    """Chunk 16: S = 64 halves twice into whole chunks, S = 37 splits into
    uneven halves (18 + 19, then 9 + 9 and 9 + 10), S = 16 is one leaf."""
    shape = (2, n, 4, 16)
    (qj, qt), (kj, kt), (vj, vt) = (inputs(shape, dtype, s, 2.0)
                                    for s in (16, 17, 18))
    want = rounded_jit(lambda q, k, v: RL.causal_tree_attention(
        q, k, v, chunk=16, mcx=None))(qj, kj, vj)
    got = PL.causal_tree_attention(qt, kt, vt, chunk=16)
    close(got, want, dtype)
    # and it is causal attention: the chunked flash form agrees
    flash = PL.flash_attention(qt, kt, vt, causal=True, chunk=16)
    close(got, flash.float().numpy(), dtype)
