"""The port's MoE layer (``repro_torch.models.moe``) and MLA attention
(``repro_torch.models.layers``) against the JAX reference's, in-process on
the CPU on a (1, 1) mesh.

Parameters are made by the reference's own ``init_*`` functions from
``jax.random.PRNGKey(k)`` (norm scales drawn at random, see
``test_torch_models.randomized``) and carried over as they are; inputs
come from a numpy seed.  Tolerances: ``moe_fwd`` in float32 atol = rtol =
1e-5, with the routing (top experts, kept mask, slots) equal exactly and
the renormalised top-k probabilities and ``aux`` within the same
tolerance; MLA in float32 atol = rtol = 1e-4; bfloat16 atol 5e-2 and
rms(port - reference) <= 2**-6 rms(reference) on identical inputs.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.models import transformer as RT
from repro_torch.configs import base as PB
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.models import moe as PMOE
from test_torch_models import (close, inputs, mcx, randomized,  # noqa: F401
                               ref_cfg, to_torch)

# without, then with a shared expert
MOE_ARCHS = ["qwen3_moe_30b_a3b", "deepseek_v3_671b"]
DTYPES = ["float32", "bfloat16"]
F32 = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 24


def moe_cfg(arch, dtype="float32", **kw):
    return PB.get_smoke_config(arch).with_(dtype=dtype, **kw)


def ref_moe(cfg, seed):
    """The reference's MoE parameters of ``cfg``, the router 5x its init
    scale so that routing is decisive, not near uniform."""
    p = RMOE.init_moe(ref_cfg(cfg), jax.random.PRNGKey(seed))
    p["router"] = p["router"] * 5.0
    return p


def ref_routing(p, xt, cfg):
    """The reference's routing and slots at one shard
    (``src/repro/models/moe.py:83-110``, copied: ``moe_fwd`` keeps them
    inside).  Returns (top_p, top_e, kept, slot) as numpy arrays."""
    E, k = cfg.num_experts, cfg.top_k
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    T = xt.shape[0]
    C = max(1, int(math.ceil(T * k * cfg.capacity_factor / E)))
    le = top_e.reshape(-1)
    order = jnp.argsort(le, stable=True)
    le_s = le[order]
    pos_s = jnp.arange(T * k) - jnp.searchsorted(le_s, le_s, side="left")
    pos = jnp.zeros_like(pos_s).at[order].set(pos_s)
    ok = pos < C
    slot = jnp.where(ok, le * C + pos, E * C)
    return tuple(np.asarray(a) for a in (top_p, top_e, ok, slot))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_equals_the_reference(arch, capacity_factor):
    """Float32 on identical inputs: the same experts in the same order,
    the same kept assignments and slots; at capacity factor 0.5 some
    assignments overflow and are dropped."""
    cfg = moe_cfg(arch, capacity_factor=capacity_factor)
    p = ref_moe(cfg, 0)
    xj, xt = inputs((B * S, cfg.d_model), "float32", 1)
    top_p, top_e, probs, _ = PMOE.route(to_torch(p)["router"], xt, cfg)
    C = PMOE.capacity(B * S, cfg)
    kept, slot = PMOE.assign_slots(top_e, cfg.num_experts, C)
    want_p, want_e, want_ok, want_slot = ref_routing(p, xj, cfg)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(kept.numpy(), want_ok)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_allclose(top_p.numpy(), want_p, **F32)
    assert probs.shape == (B * S, cfg.num_experts)
    if capacity_factor < 1:
        assert not bool(kept.all())
    assert C == max(1, math.ceil(B * S * cfg.top_k * capacity_factor
                                 / cfg.num_experts))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_fwd_equals_the_reference(arch, capacity_factor, dtype, mcx):
    cfg = moe_cfg(arch, dtype, capacity_factor=capacity_factor)
    p = ref_moe(cfg, 2)
    assert ("ws_gate" in p) == bool(cfg.num_shared_experts)
    xj, xt = inputs((B, S, cfg.d_model), dtype, 3)
    y, aux = PMOE.moe_fwd(to_torch(p), xt, cfg)
    yr, aux_r = RMOE.moe_fwd(p, xj, ref_cfg(cfg), mcx)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), **F32)
    else:
        close(y, yr, dtype)
    np.testing.assert_allclose(float(aux), float(aux_r), **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_a2a_dispatch_equals_the_port(arch, mcx):
    """The reference's all-to-all dispatch on a (1, 1) mesh is the psum
    dispatch's computation with one shard: the port runs one body for
    both values of ``moe_dispatch``."""
    cfg = moe_cfg(arch, moe_dispatch="a2a", capacity_factor=0.5)
    p = ref_moe(cfg, 4)
    xj, xt = inputs((B, S, cfg.d_model), "float32", 5)
    y, aux = PMOE.moe_fwd(to_torch(p), xt, cfg)
    yr, aux_r = RMOE.moe_fwd(p, xj, ref_cfg(cfg), mcx)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **F32)
    np.testing.assert_allclose(float(aux), float(aux_r), **F32)
    y_psum, _ = PMOE.moe_fwd(to_torch(p), xt, cfg.with_(moe_dispatch="psum"))
    assert torch.equal(y, y_psum)


def mla_params(cfg, seed, mcx):
    return randomized(RL.init_mla(ref_cfg(cfg), jax.random.PRNGKey(seed),
                                  mcx), seed + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_fwd_return_kv(dtype, mcx):
    """Prompt of 24 over attention chunks of 16: two chunks, the second
    padded."""
    cfg = moe_cfg("deepseek_v3_671b", dtype)
    p = mla_params(cfg, 6, mcx)
    xj, xt = inputs((B, S, cfg.d_model), dtype, 8)
    pos = np.broadcast_to(np.arange(S), (B, S))
    y, (c_kv, k_rope) = PL.mla_fwd(to_torch(p), xt, cfg,
                                   positions=torch.from_numpy(pos.copy()),
                                   return_kv=True)
    yr, (c_r, kr_r) = RL.mla_fwd(p, xj, ref_cfg(cfg), mcx,
                                 positions=jnp.asarray(pos), return_kv=True)
    assert c_kv.shape == (B, S, cfg.kv_lora_rank)
    assert k_rope.shape == (B, S, cfg.qk_rope_dim)
    for got, want in ((y, yr), (c_kv, c_r), (k_rope, kr_r)):
        close(got, want, dtype)
    assert torch.equal(PL.mla_fwd(to_torch(p), xt, cfg,
                                  positions=torch.from_numpy(pos.copy())), y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["inside", "at_end"])
def test_mla_decode_attention(where, dtype, mcx):
    """``pos < S`` writes the token's latent and RoPE key into the cache
    in place; ``pos == S`` (a cache as long as the prompt) leaves it as it
    was."""
    cfg = moe_cfg("deepseek_v3_671b", dtype)
    p = mla_params(cfg, 9, mcx)
    n = 20
    pos = 12 if where == "inside" else n
    xj, xt = inputs((B, 1, cfg.d_model), dtype, 11)
    cc = inputs((B, n, cfg.kv_lora_rank), dtype, 12)
    kr = inputs((B, n, cfg.qk_rope_dim), dtype, 13)
    cache_t = {"c_kv": cc[1].clone(), "k_rope": kr[1].clone()}
    y, new = PL.mla_decode_attention(to_torch(p), xt, cache_t, pos, cfg)
    yr, new_r = RL.mla_decode_attention(p, xj, {"c_kv": cc[0],
                                                "k_rope": kr[0]},
                                        jnp.asarray(pos, jnp.int32),
                                        ref_cfg(cfg), mcx)
    close(y, yr, dtype)
    for name in ("c_kv", "k_rope"):
        close(new[name], new_r[name], dtype)
        assert new[name] is cache_t[name]        # updated in place
    changed = not torch.equal(new["c_kv"], cc[1])
    assert changed == (where == "inside")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_reference_loads_every_leaf_but_mtp(arch, mcx):
    """Every leaf of the reference's tree, each stacked layer its own
    entry, except the MTP head's; ``load_state_dict`` (strict) takes the
    result, and the model then holds the reference's arrays."""
    cfg = PB.get_smoke_config(arch)
    tree = RM.build(ref_cfg(cfg), mcx).init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, tree)
    assert ("mtp" in tree) == bool(cfg.mtp_depth)
    want = sum(a.shape[0] if path[0].key == "stacks" else 1
               for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]
               if path[0].key != "mtp")
    sd = PM.params_from_reference(tree, cfg)
    assert len(sd) == want
    mdl = PM.build(cfg, "cpu")
    mdl.load_state_dict(sd, strict=True)
    mine = mdl.state_dict()
    assert mine.keys() == sd.keys()
    assert all(torch.equal(mine[k], v) for k, v in sd.items())
    kinds = [k for k, lo, hi in RT.stack_groups(ref_cfg(cfg))
             for _ in range(lo, hi)]
    assert ["moe" in mdl.layers[i] for i in range(cfg.num_layers)] \
        == [k == "moe" for k in kinds]
