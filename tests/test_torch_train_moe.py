"""The port's training step on the MoE smoke configurations
(``qwen3_moe_30b_a3b``; ``deepseek_v3_671b`` with MLA, a dense first
layer and the MTP head) against the JAX reference, in-process on the CPU,
with ``test_torch_train.py``'s harness and tolerances: two float32 steps
(loss, ce, grad_norm, lr, every gradient, every weight after), qwen3 also
with ``flash_vjp`` and the reference's ``a2a`` dispatch, and deepseek's
MTP term on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.models import model as RM
from repro_torch.configs import base as PB
from repro_torch.models import model as PM
from test_torch_train import (METRIC_RTOL, check_steps, make_batch, mcx,
                              port_model, port_steps, reference_steps)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v3_671b"])
def test_two_train_steps_equal_the_reference(arch):
    init, want = reference_steps(arch)
    check_steps(port_steps(port_model(arch, init)), want)


def test_flash_vjp_with_a2a_dispatch():
    """qwen3 with ``flash_vjp`` and ``moe_dispatch="a2a"``: against the
    reference's run of the same flags, and against the port's run without
    ``flash_vjp`` (the backward's recomputation moves no gradient past
    rounding)."""
    flags = (("flash_vjp", True), ("moe_dispatch", "a2a"))
    init, want = reference_steps("qwen3_moe_30b_a3b", flags)
    got = port_steps(port_model("qwen3_moe_30b_a3b", init, **dict(flags)))
    check_steps(got, want)
    plain = port_steps(port_model("qwen3_moe_30b_a3b", init,
                                  moe_dispatch="a2a"))
    check_steps(got, plain)


def test_mtp_term_equals_the_references():
    """deepseek's loss with and without its MTP head, on both packages:
    the reference's ``loss_fn`` on its parameters and on the same without
    ``mtp``; the port's on a model built for training (with the head) and
    on a serving model (without).  Both differences are the 0.3-weighted
    MTP cross-entropy, and they agree."""
    cfg_r = RB.get_smoke_config("deepseek_v3_671b").with_(dtype="float32")
    cfg_p = PB.get_smoke_config("deepseek_v3_671b").with_(dtype="float32")
    init, _ = reference_steps("deepseek_v3_671b")
    batch = make_batch(cfg_p, 0)
    ref = RM.build(cfg_r, mcx())
    loss = jax.jit(lambda p, b: ref.loss_fn(p, b)[0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = [float(loss(init, jb)),
            float(loss({k: v for k, v in init.items() if k != "mtp"}, jb))]
    trained = port_model("deepseek_v3_671b", init)
    serving = PM.build(cfg_p, "cpu")
    serving.load_state_dict(PM.params_from_reference(init, cfg_p))
    assert serving.mtp is None and trained.mtp is not None
    with torch.no_grad():
        got = [float(m.loss_fn(batch)[0]) for m in (trained, serving)]
    np.testing.assert_allclose(got, want, rtol=METRIC_RTOL)
    assert want[0] - want[1] > 0.5
    np.testing.assert_allclose(got[0] - got[1], want[0] - want[1],
                               rtol=1e-4)
