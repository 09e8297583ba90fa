"""Training variants of the port against the JAX reference, in-process on
the CPU, with ``test_torch_train.py``'s harness and tolerances: the flash
backward (``flash_vjp``) on stablelm and deepseek, two microbatches,
``grad_compress``; and the two custom backwards on their own: the flash
attention core (``layers.flash_attention_vjp``) and the Mamba-1 scan
(``ssm.chunked_diag_scan``), each against ``jax.grad`` of the
reference's function, in float32 within rms ``GRAD_RMS``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import ssm as RSSM
from repro_torch.models import layers as PL
from repro_torch.models import ssm as PSSM
from test_torch_train import (GRAD_RMS, check_steps, port_model, port_steps,
                              reference_steps, rms_rel)


@pytest.mark.parametrize("arch", ["stablelm_12b", "deepseek_v3_671b"])
def test_flash_vjp_steps(arch):
    """``flash_vjp=True`` against the reference's run with the flag, and
    against the port's run without it."""
    init, want = reference_steps(arch, (("flash_vjp", True),))
    got = port_steps(port_model(arch, init, flash_vjp=True))
    check_steps(got, want)
    check_steps(got, port_steps(port_model(arch, init)))


@pytest.mark.parametrize("arch", ["stablelm_12b", "zamba2_1p2b"])
def test_two_microbatches(arch):
    """``microbatches=2``: float32 accumulation over the two halves of the
    batch, divided by 2; loss, ce (the mean loss), grad_norm, lr and the
    weights after each step."""
    init, want = reference_steps(arch, (("microbatches", 2),))
    got = port_steps(port_model(arch, init, microbatches=2),
                     with_grads=False)
    check_steps(got, want, grads=False)


def test_grad_compress():
    """The int8 update with error feedback (``OptConfig.grad_compress``,
    set from the config) over two steps."""
    init, want = reference_steps("stablelm_12b", (("grad_compress", True),))
    mdl = port_model("stablelm_12b", init, grad_compress=True)
    assert mdl.opt_cfg.grad_compress
    check_steps(port_steps(mdl), want)


def grads_of(fn_r, fn_p, arrays, seed):
    """Gradients of sum(fn(*arrays) * w) for a random w: the reference's
    (``jax.grad``) and the port's (autograd)."""
    out = np.asarray(fn_r(*arrays))
    w = np.random.default_rng(seed).standard_normal(out.shape).astype(
        np.float32)
    want = jax.grad(lambda *a: jnp.sum(fn_r(*a) * w),
                    argnums=tuple(range(len(arrays))))(*arrays)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = torch.autograd.grad((fn_p(*ts) * torch.from_numpy(w)).sum(), ts)
    return [g.numpy() for g in got], [np.asarray(g) for g in want]


@pytest.mark.parametrize("causal,seq", [(True, 32), (True, 24), (False, 32),
                                        (False, 20)])
def test_flash_attention_vjp(causal, seq):
    """dq, dk, dv of ``flash_attention_vjp`` against the reference's
    custom VJP (chunk 16; causal sequences of 24 are padded, and a
    non-causal one of 20 takes the reference's fallback, which attends to
    its zero padding: ROADMAP Queue 3), with Dv != D as in MLA."""
    rng = np.random.default_rng(seq)
    B, H, D, Dv = 2, 4, 8, 6
    q, k = (rng.standard_normal((B, seq, H, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, seq, H, Dv)).astype(np.float32)
    got, want = grads_of(
        lambda *a: RL.flash_attention_vjp(*a, causal=causal, chunk=16,
                                          mcx=None),
        lambda *a: PL.flash_attention_vjp(*a, causal=causal, chunk=16),
        (q, k, v), seq)
    for g, w in zip(got, want):
        assert rms_rel(g, w) <= GRAD_RMS
    plain, _ = grads_of(
        lambda *a: RL.flash_attention(*a, causal=causal, chunk=16, mcx=None),
        lambda *a: PL.flash_attention(*a, causal=causal, chunk=16),
        (q, k, v), seq)
    gap = max(rms_rel(g, p) for g, p in zip(got, plain))
    assert gap <= GRAD_RMS if causal or seq % 16 == 0 else gap > 0.1


def test_flash_core_saves_only_its_inputs_output_and_row_stats():
    """The flash backward's graph node holds (q, k, v, out, m, l) and no
    block of probabilities."""
    B, S, H, D = 2, 32, 4, 8
    q, k, v = (torch.randn(B, S, H, D, requires_grad=True) for _ in range(3))
    out = PL.flash_attention_vjp(q, k, v, causal=True, chunk=16)
    node = out.grad_fn                      # past the slice to S
    while type(node).__name__ != "_FlashCoreBackward":
        node = node.next_functions[0][0]
    saved = node.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(B, S, H, D)] * 4 + \
        [(B, H, S)] * 2
    assert all(t is x for t, x in zip(saved[:3], (q, k, v)))


@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_diag_scan_backward(with_h0):
    """da, du (and dh0) of the scan's own backward (an adjoint scan in
    reverse time) against ``jax.grad`` through the reference's
    associative scan; S = 20 over chunks of 8 (one padded)."""
    rng = np.random.default_rng(int(with_h0))
    B, S, C, N = 2, 20, 3, 4
    arrays = [rng.uniform(0.5, 1.0, (B, S, C, N)).astype(np.float32),
              rng.standard_normal((B, S, C, N)).astype(np.float32)]
    if with_h0:
        arrays.append(rng.standard_normal((B, C, N)).astype(np.float32))
    got, want = grads_of(
        lambda a, u, *h: RSSM.chunked_diag_scan(a, u, 8, *h),
        lambda a, u, *h: PSSM.chunked_diag_scan(a, u, 8, *h),
        arrays, 7)
    for g, w in zip(got, want):
        assert rms_rel(g, w) <= GRAD_RMS
