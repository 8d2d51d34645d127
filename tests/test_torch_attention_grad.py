"""The plain versions of the attention backward (K3b) and of the forward's
log-sum-exp against the JAX package, on the CPU.

JAX differentiates ``fused_attention`` through the bundled Pallas flash
kernel's custom VJP, run under the TPU interpreter, and its forward gives
the row statistics l and m (lse = m + log l).  The CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
Tolerances: 2e-4 for gradients, the JAX suite's own bar for its flash VJP
(tests/test_attention_pallas.py); 1e-5 for lse, one fp32 sum of the scores.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as pallas_flash

from audiocraft_tpu.ops import attention_pallas
from audiocraft_tpu.ops.attention_pallas import fused_attention as jax_fused_attention
from audiocraft_tpu_torch.ops.attention import (attention_bwd_dkv, attention_bwd_dq,
                                                attention_di, attention_lse_reference,
                                                fused_attention, fused_attention_backward,
                                                fused_attention_backward_reference,
                                                fused_attention_with_lse, plain_attention)

B, T, H, D = 1, 130, 2, 32
SCALE = 1.0 / np.sqrt(D)


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(attention_pallas, 'INTERPRET', True)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    do = np.broadcast_to(np.arange(D, dtype=np.float32), (B, T, H, D)).copy()
    do += rng.randn(B, T, H, D).astype(np.float32)
    return q, k, v, do


def _jax_lse(q, k, v, causal):
    """m + log(l) from the bundled Pallas forward under the interpreter, with
    T and D padded to its 128 tile as the JAX wrapper pads them."""
    Tp, Dp = 256, 128

    def prep(x):
        x = jnp.swapaxes(jnp.asarray(x), 1, 2)
        return jnp.pad(x, ((0, 0), (0, 0), (0, Tp - T), (0, Dp - D)))

    seg = None
    if not causal:
        ids = jnp.broadcast_to((jnp.arange(Tp) >= T).astype(jnp.int32), (B, Tp))
        seg = pallas_flash.SegmentIds(q=ids, kv=ids)
    sizes = pallas_flash.BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1)
    with pltpu.force_tpu_interpret_mode():
        _, l, m = pallas_flash._flash_attention(prep(q), prep(k), prep(v), None, seg, True,
                                                causal, float(SCALE), sizes, False)
    return np.asarray(m + jnp.log(l))[:, :, :T]


@pytest.mark.parametrize('causal', [True, False])
def test_backward_reference_matches_pallas_vjp(interpret_kernel, causal):
    q, k, v, do = _inputs(seed=3 + causal)

    def loss(q, k, v):
        return (jax_fused_attention(q, k, v, causal=causal) * jnp.asarray(do)).sum()

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = fused_attention_with_lse(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, causal), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), attention_lse_reference(tq, tk, tv, causal=causal),
                               rtol=0, atol=0)
    ours = fused_attention_backward_reference(tq, tk, tv, o, lse, tdo, causal=causal)
    for a, b in zip(ours, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_backward_reference_matches_autograd_of_plain_attention(causal, dtype):
    """fp32: 2e-5 (only the order of fp32 sums differs); bf16: the gradients
    are rounded to bf16 on both sides, and autograd rounds dq twice (through
    the cast and the scale), 2**-7 relative."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _inputs(seed=7))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    mask = torch.where(torch.arange(T)[:, None] >= torch.arange(T)[None, :], 0.0,
                       float('-inf'))[None, None] if causal else None
    out = plain_attention(*leaves, mask, SCALE)
    ref = torch.autograd.grad(out, leaves, do)
    o, lse = fused_attention_with_lse(q, k, v, causal=causal)
    ours = fused_attention_backward_reference(q, k, v, o, lse, do, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2 ** -7
    for a, b in zip(ours, ref):
        assert a.dtype == dtype
        scale = float(b.float().abs().max())
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=tol,
                                   atol=tol * scale)


def test_cpu_wrappers_take_the_plain_versions_and_autograd():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(seed=9))
    before = (fused_attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fused_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    o, lse = fused_attention_with_lse(q, k, v, causal=True)
    torch.testing.assert_close(o, out.detach(), rtol=0, atol=0)
    split = fused_attention_backward(q, k, v, o, lse, do, causal=True)
    di = attention_di(o, do)
    assert di.shape == (B, H, T) and di.dtype == torch.float32
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di, causal=True)
    dq = attention_bwd_dq(q, k, v, do, lse, di, causal=True)
    for a, b, c in zip(grads, split, (dq, dk, dv)):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
        torch.testing.assert_close(b, c, rtol=0, atol=0)
    # a CPU tensor never launches a kernel
    assert (fused_attention.launches, attention_bwd_dkv.launches,
            attention_bwd_dq.launches) == before
