"""The port's LM layers (``repro_torch.models.layers`` / ``model``) against
the JAX reference's, in-process on the CPU.

Parameters are made by the reference's own ``init_*`` functions from
``jax.random.PRNGKey(k)``, with their zero biases and unit norm scales
replaced by seeded random values so that every term counts; inputs come
from a numpy seed.  Tolerances: float32 atol = rtol = 1e-4; bfloat16 atol
5e-2 and, relative to scale, rms(port - reference) <= 2**-6
rms(reference) (four units of bfloat16 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.launch.mesh import compat_make_mesh
from repro.models import layers as RL
from repro.models import model as RM
from repro.models.layers import MeshCtx
from repro_torch.configs import base as PB
from repro_torch.models import layers as PL
from repro_torch.models import model as PM

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=5e-2, rtol=0)}
BF16_RMS = 2.0 ** -6


@pytest.fixture(scope="module")
def mcx():
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    return MeshCtx(mesh=mesh, dp=("data",), tp="model")


def cfg_of(dtype, **kw):
    return PB.get_smoke_config("stablelm_12b").with_(dtype=dtype, **kw)


def ref_cfg(cfg):
    """The reference's ``ModelConfig`` with the same fields."""
    return RB.ModelConfig(**{f: getattr(cfg, f)
                             for f in RB.ModelConfig.__dataclass_fields__})


def randomized(tree, seed, gain=1.0):
    """The reference's parameters with biases and norm scales drawn at
    random (init leaves them at 0 and 1) and the weights times ``gain``."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path[-1:])
        if any(k in name for k in ("'b", "scale", "norm", "bias")):
            r = rng.normal(1.0 if "scale" in name or "norm" in name else 0.0,
                           0.1, a.shape)
            return jnp.asarray(r, a.dtype)
        return (a.astype(jnp.float32) * gain).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def to_torch(tree):
    """jax arrays -> CPU tensors of the same dtype (a mapping for dicts)."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return PM._tensor(np.asarray(tree))


def inputs(shape, dtype, seed, scale=1.0):
    x = np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(x).to(PL.torch_dtype(dtype)))


def close(got, want, dtype):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if dtype == "bfloat16":
        diff, ref = (got - want).astype(np.float64), want.astype(np.float64)
        rel = np.sqrt(np.mean(diff ** 2) / np.mean(ref ** 2))
        assert rel <= BF16_RMS, f"rms(port - ref) / rms(ref) = {rel:.3e}"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm(norm, dtype):
    cfg = cfg_of(dtype, norm_type=norm)
    p = randomized(RL.init_norm(ref_cfg(cfg)), 0)
    xj, xt = inputs((3, 5, cfg.d_model), dtype, 1, scale=2.0)
    close(PL.apply_norm(to_torch(p), xt, cfg), RL.apply_norm(p, xj, cfg),
          dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(dtype):
    cfg = cfg_of(dtype)
    xj, xt = inputs((2, 40, 4, cfg.head_dim), dtype, 2)
    pos = np.random.default_rng(3).integers(0, 5000, (2, 40))
    close(PL.apply_rope(xt, torch.from_numpy(pos), 1e4),
          RL.apply_rope(xj, jnp.asarray(pos), 1e4), dtype)
    # the decode form: one position per row
    close(PL.apply_rope(xt[:, :1], torch.from_numpy(pos[:, :1]), 8e6),
          RL.apply_rope(xj[:, :1], jnp.asarray(pos[:, :1]), 8e6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mlp", ["swiglu", "squared_relu", "gelu"])
def test_apply_mlp(mlp, bias, dtype):
    """Weights at 5x their init scale put the activations' inputs at O(1),
    where gelu's tanh form and its erf form differ."""
    cfg = cfg_of(dtype, mlp_type=mlp, use_bias=bias)
    p = randomized(RL.init_mlp(ref_cfg(cfg), jax.random.PRNGKey(4)), 5, 5.0)
    xj, xt = inputs((2, 7, cfg.d_model), dtype, 6, scale=3.0)
    close(PL.apply_mlp(to_torch(p), xt, cfg), RL.apply_mlp(p, xj, cfg),
          dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [32, 37])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(causal, S, dtype, mcx):
    """Chunk 16: S=32 is two whole chunks, S=37 pads its last one."""
    shape = (2, S, 4, 16)
    (qj, qt), (kj, kt), (vj, vt) = (inputs(shape, dtype, s, 2.0)
                                    for s in (7, 8, 9))
    got = PL.flash_attention(qt, kt, vt, causal=causal, chunk=16)
    want = RL.flash_attention(qj, kj, vj, causal=causal, chunk=16, mcx=mcx)
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["plain", "bias_qknorm", "encoder"])
def test_attention_fwd_return_kv(variant, dtype, mcx):
    kw = {"plain": {}, "bias_qknorm": dict(use_bias=True, use_qk_norm=True),
          "encoder": dict(is_encoder=True)}[variant]
    cfg = cfg_of(dtype, **kw)
    p = randomized(RL.init_attention(ref_cfg(cfg), jax.random.PRNGKey(10),
                                     mcx), 11)
    xj, xt = inputs((2, 24, cfg.d_model), dtype, 12)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    causal = not cfg.is_encoder
    y, (k, v) = PL.attention_fwd(to_torch(p), xt, cfg,
                                 positions=torch.from_numpy(pos.copy()),
                                 causal=causal, return_kv=True)
    yr, (kr, vr) = RL.attention_fwd(p, xj, ref_cfg(cfg), mcx,
                                    positions=jnp.asarray(pos),
                                    causal=causal, return_kv=True)
    for got, want in ((y, yr), (k, kr), (v, vr)):
        close(got, want, dtype)
    assert PL.attention_fwd(to_torch(p), xt, cfg,
                            positions=torch.from_numpy(pos.copy()),
                            causal=causal).shape == y.shape


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["inside", "at_end"])
def test_gqa_decode_attention(where, dtype, mcx):
    """``pos < S`` writes the token's K/V into the cache; ``pos == S`` (a
    cache as long as the prompt) leaves the cache as it was."""
    cfg = cfg_of(dtype, use_bias=True)
    p = randomized(RL.init_attention(ref_cfg(cfg), jax.random.PRNGKey(13),
                                     mcx), 14)
    S = 20
    pos = 12 if where == "inside" else S
    xj, xt = inputs((2, 1, cfg.d_model), dtype, 15)
    kc = inputs((2, S, cfg.num_kv_heads, cfg.head_dim), dtype, 16)
    vc = inputs((2, S, cfg.num_kv_heads, cfg.head_dim), dtype, 17)
    cache_t = {"k": kc[1].clone(), "v": vc[1].clone()}
    y, new = PL.gqa_decode_attention(to_torch(p), xt, cache_t, pos, cfg)
    yr, new_r = RL.gqa_decode_attention(p, xj, {"k": kc[0], "v": vc[0]},
                                        jnp.asarray(pos, jnp.int32),
                                        ref_cfg(cfg), mcx)
    close(y, yr, dtype)
    for n in ("k", "v"):
        close(new[n], new_r[n], dtype)
        assert new[n] is cache_t[n]          # updated in place
    changed = not torch.equal(new["k"], kc[1])
    assert changed == (where == "inside")


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed(dtype, mcx):
    tj, tt = inputs((300, 64), dtype, 18)
    tok = np.random.default_rng(19).integers(0, 300, (3, 9))
    close(PM.embed(torch.from_numpy(tok), tt),
          RM.embed(jnp.asarray(tok), tj, mcx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tied", [False, True])
def test_logits_fn(tied, dtype, mcx):
    """Vocab 250 padded to 256: the pad rows come out at -1e30."""
    cfg = cfg_of(dtype, vocab_size=250, tie_embeddings=tied)
    ej, et = inputs((256, cfg.d_model), dtype, 20, 0.5)
    uj, ut = inputs((cfg.d_model, 256), dtype, 21, 0.5)
    hj, ht = inputs((4, 1, cfg.d_model), dtype, 22)
    pj = {"emb": ej} if tied else {"emb": ej, "unemb": uj}
    pt = {"emb": et} if tied else {"emb": et, "unemb": ut}
    got = PM.logits_fn(ht, PM._unemb_t(pt, cfg), cfg)
    want = RM.logits_fn(hj, RM._unemb_t(pj, ref_cfg(cfg)), ref_cfg(cfg), mcx)
    assert got.dtype == torch.float32
    close(got, want, dtype)
    assert (got[:, 250:] == -1e30).all()


def test_repeat_kv():
    x = torch.arange(2 * 3 * 2 * 4).reshape(2, 3, 2, 4)
    want = RL.repeat_kv(jnp.asarray(x.numpy()), 6)
    assert np.array_equal(PL.repeat_kv(x, 6).numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", RB.ARCHS)
def test_configs_equal_the_references(arch):
    """All ten configurations resolve, equal the reference's field for
    field, and count parameters and cells as it does."""
    for get in ("get_config", "get_smoke_config"):
        mine, ref = getattr(PB, get)(arch), getattr(RB, get)(arch)
        fields = RB.ModelConfig.__dataclass_fields__
        assert {f: getattr(mine, f) for f in fields} \
            == {f: getattr(ref, f) for f in fields}
        assert mine.param_counts() == ref.param_counts()
        assert PB.supported_cells(mine) == RB.supported_cells(ref)
    assert PB.SHAPES.keys() == RB.SHAPES.keys()
    assert PB.ARCHS == RB.ARCHS
