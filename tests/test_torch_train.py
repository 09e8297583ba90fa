"""The port's training step (``repro_torch.models.model.Model.loss_fn`` /
``train_step``, ``repro_torch.train.optimizer``) against the JAX
reference's ``jax.value_and_grad`` and ``apply_updates``, in-process on
the CPU on a (1, 1) mesh.

The smoke configurations of the dense, vlm, audio, SSM and hybrid
families here (the MoE ones in ``test_torch_train_moe.py``), in float32:
the reference's ``init_params(PRNGKey(0))`` carried over by
``params_from_reference`` (the MTP head included), batches of 2 x 24
drawn from a numpy seed (two attention chunks of 16, two loss chunks,
three SSM chunks of 8), two steps on each package, the reference's
jitted.  Held after each step: ``loss``, ``ce`` and ``grad_norm`` within
rtol ``METRIC_RTOL``, ``lr`` equal to float32 rounding, every parameter's
gradient within ``GRAD_RMS`` of the reference's in rms relative to the
reference's own rms (``grad_errors``), and every weight after the step
within ``WEIGHT_ATOL`` (an Adam step at lr 3e-6 moves a weight by about
3e-6).  The port measures 1e-6 in gradients and 1e-8 in weights.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as RB
from repro.launch.mesh import compat_make_mesh
from repro.models import model as RM
from repro.models.layers import MeshCtx
from repro.train import optimizer as ROPT
from repro_torch.configs import base as PB
from repro_torch.models import model as PM
from repro_torch.train import optimizer as POPT

B, S, STEPS = 2, 24, 2
METRIC_RTOL = 1e-5
GRAD_RMS = 1e-4
ZERO_FLOOR = 1e-6
WEIGHT_ATOL = 1e-6


@functools.lru_cache(maxsize=None)
def mcx():
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    return MeshCtx(mesh=mesh, dp=("data",), tp="model")


def make_batch(cfg, seed, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (batch, seq),
                                dtype=np.int32)}
    if cfg.input_mode == "embeddings":
        b["embeddings"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq),
                                   dtype=np.int32)
    return b


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference_steps(arch, overrides=(), steps=STEPS):
    """The reference's parameters (numpy tree) and, for each of ``steps``
    steps: its gradients at the step's weights (by the port's names;
    ``None`` with microbatches), its metrics and its weights after."""
    cfg = RB.get_smoke_config(arch).with_(dtype="float32", **dict(overrides))
    mdl = RM.build(cfg, mcx())
    params = mdl.init_params(jax.random.PRNGKey(0))
    opt = ROPT.init_opt_state(params, mdl.opt_cfg)
    # Model.train_step's body at one microbatch (src/repro/models/model.py
    # :196-198 and :227-231), split so that the gradients can be read
    grad = jax.jit(jax.value_and_grad(mdl.loss_fn, has_aux=True))
    update = jax.jit(functools.partial(ROPT.apply_updates, oc=mdl.opt_cfg))
    train_step = jax.jit(mdl.train_step)
    init, recs = as_np(params), []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in make_batch(cfg, i).items()}
        step = jnp.asarray(i, jnp.int32)
        g = None
        if cfg.microbatches == 1:
            (loss, met), grads = grad(params, batch)
            g = PM.params_from_reference(as_np(grads), cfg, training=True)
            params, opt, stats = update(grads, opt, params, step)
            met = {"loss": loss, **met, **stats}
        else:
            params, opt, met = train_step(params, opt, batch, step)
        recs.append({"grads": g,
                     "metrics": {k: float(v) for k, v in met.items()},
                     "params": PM.params_from_reference(as_np(params), cfg,
                                                        training=True)})
    return init, recs


def port_model(arch, init, **overrides):
    cfg = PB.get_smoke_config(arch).with_(dtype="float32", **overrides)
    mdl = PM.build(cfg, "cpu", training=True)
    mdl.load_state_dict(PM.params_from_reference(init, cfg, training=True))
    return mdl


def port_steps(mdl, steps=STEPS, with_grads=True):
    """``reference_steps``' record of the port's model ``mdl``."""
    params = dict(mdl.named_parameters())
    opt = POPT.init_opt_state(params, mdl.opt_cfg)
    recs = []
    for i in range(steps):
        batch = make_batch(mdl.cfg, i)
        g = None
        if with_grads:
            g = {n: t.detach().clone()
                 for n, t in mdl._grads(params, batch)[2].items()}
        opt, met = mdl.train_step(opt, batch, i)
        recs.append({"grads": g,
                     "metrics": {k: float(v) for k, v in met.items()},
                     "params": {n: p.detach().clone()
                                for n, p in params.items()}})
    return recs


def rms_rel(got, want) -> float:
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    ref = np.sqrt(np.mean(want ** 2))
    err = np.sqrt(np.mean((got - want) ** 2))
    return err / ref if ref > 0 else err


def grad_errors(got, want) -> dict:
    """Each gradient's rms error relative to the reference's rms, or to
    ``ZERO_FLOOR`` times the largest such rms where the reference's is
    below that: a gradient that is zero but for rounding (a key bias's,
    which the softmax cancels) is held absolutely."""
    rms = {n: float(np.sqrt(np.mean(np.asarray(w, np.float64) ** 2)))
           for n, w in want.items()}
    floor = ZERO_FLOOR * max(rms.values())
    return {n: rms_rel(got[n], w) * rms[n] / max(rms[n], floor)
            for n, w in want.items()}


def check_steps(got, want, grads=True):
    """Each step's metrics, gradients and weights after (see the module
    docstring)."""
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(g["metrics"][k], w["metrics"][k],
                                       rtol=METRIC_RTOL, err_msg=f"{i} {k}")
        assert np.float32(g["metrics"]["lr"]) == np.float32(
            w["metrics"]["lr"])
        assert g["params"].keys() == w["params"].keys()
        if grads:
            assert g["grads"].keys() == w["grads"].keys()
            bad = grad_errors(g["grads"], w["grads"])
            assert max(bad.values()) <= GRAD_RMS, \
                (i, sorted(bad.items(), key=lambda kv: -kv[1])[:5])
        for n, p in w["params"].items():
            np.testing.assert_allclose(g["params"][n].numpy(), p.numpy(),
                                       atol=WEIGHT_ATOL, rtol=0,
                                       err_msg=f"{i} {n}")


MOE = ("qwen3_moe_30b_a3b", "deepseek_v3_671b")


@pytest.mark.parametrize("arch", [a for a in RB.ARCHS if a not in MOE])
def test_two_train_steps_equal_the_reference(arch):
    init, want = reference_steps(arch)
    check_steps(port_steps(port_model(arch, init)), want)


class BmmCount(TorchDispatchMode):
    """Counts ``bmm`` calls over a batch of one (a projection, as
    ``torch.einsum`` runs it) and over a larger batch."""

    def __init__(self):
        super().__init__()
        self.n = {"one": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            self.n["one" if args[0].shape[0] == 1 else "batched"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["stablelm_12b", "zamba2_1p2b",
                                  "falcon_mamba_7b"])
def test_remat_settings_give_equal_gradients(arch):
    """``remat`` none / full / dots: gradients equal to the bit.  In the
    backward, "full" recomputes every matmul of a layer, "dots" only the
    batched ones (attention's, the SSD's): the projections' outputs are
    saved, as the reference's ``dots_with_no_batch_dims_saveable``."""
    batch = make_batch(PB.get_smoke_config(arch), 0)
    grads, counts = {}, {}
    for remat in ("none", "full", "dots"):
        cfg = PB.get_smoke_config(arch).with_(dtype="float32", remat=remat)
        mdl = PM.build(cfg, "cpu", torch.Generator().manual_seed(0),
                       training=True)
        params = dict(mdl.named_parameters())
        loss, _ = mdl.loss_fn(batch)
        with BmmCount() as c:
            grads[remat] = torch.autograd.grad(loss, list(params.values()))
        counts[remat] = c.n
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(grads["none"],
                                                     grads[remat]))
    none, full, dots = counts["none"], counts["full"], counts["dots"]
    assert full["one"] > none["one"] == dots["one"]
    assert full["batched"] == dots["batched"] >= none["batched"]
