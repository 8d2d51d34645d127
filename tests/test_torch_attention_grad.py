"""The plain versions of the attention backward (K3b) and of the forward's
log-sum-exp against the JAX package, on the CPU.

JAX differentiates ``fused_attention`` through the bundled Pallas flash
kernel's custom VJP, run under the TPU interpreter, and its forward gives
the row statistics l and m (lse = m + log l).  The CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
Tolerances: 2e-4 for gradients, the JAX suite's own bar for its flash VJP
(tests/test_attention_pallas.py); 1e-5 for lse, one fp32 sum of the scores.
For bf16 inputs the plain versions round P and dS once to bf16, where the
tensor-core kernels do.
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
from audiocraft_tpu_torch.ops.attention import (_rows_on_16_bytes, attention_bwd_dkv,
                                                attention_bwd_dq, attention_di,
                                                attention_lse_reference, fused_attention,
                                                fused_attention_backward,
                                                fused_attention_backward_reference,
                                                fused_attention_with_lse, plain_attention)

B, T, H, D = 1, 130, 2, 32
SCALE = 1.0 / np.sqrt(D)


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(attention_pallas, 'INTERPRET', True)


def _inputs(seed, shape=(B, T, H, D)):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    do = np.broadcast_to(np.arange(shape[-1], dtype=np.float32), shape).copy()
    do += rng.randn(*shape).astype(np.float32)
    return q, k, v, do


def _jax_lse(q, k, v, causal):
    """m + log(l) from the bundled Pallas forward under the interpreter, with
    T and D padded to its 128 tile as the JAX wrapper pads them."""
    b, t, _, d = q.shape
    Tp, Dp = -(-t // 128) * 128, 128

    def prep(x):
        x = jnp.swapaxes(jnp.asarray(x), 1, 2)
        return jnp.pad(x, ((0, 0), (0, 0), (0, Tp - t), (0, Dp - d)))

    seg = None
    if not causal:
        ids = jnp.broadcast_to((jnp.arange(Tp) >= t).astype(jnp.int32), (b, Tp))
        seg = pallas_flash.SegmentIds(q=ids, kv=ids)
    sizes = pallas_flash.BlockSizes(block_q=128, block_k_major=128, block_k=128, block_b=1)
    # one jitted call, as in test_backward_reference_matches_pallas_vjp
    forward = jax.jit(lambda q, k, v: pallas_flash._flash_attention(
        q, k, v, None, seg, True, causal, float(1.0 / np.sqrt(d)), sizes, False))
    with pltpu.force_tpu_interpret_mode():
        _, l, m = forward(prep(q), prep(k), prep(v))
    return np.asarray(m + jnp.log(l))[:, :, :t]


# the file's shape (T = 130: two 64-row tiles and a ragged third; D = 32), and
# one tile and a row (T = 65) at the models' head width D = 64, there in bf16
# too: the bundled Pallas backward rounds P and dS (times the scale, a power
# of two at D = 64) to bf16 before its dV, dK and dQ products, where the bf16
# plain versions round them
@pytest.mark.parametrize('causal,shape,dtype', [
    pytest.param(True, (B, T, H, D), 'float32', id='True'),
    pytest.param(False, (B, T, H, D), 'float32', id='False'),
    pytest.param(True, (1, 65, 2, 64), 'float32', id='True-T65-D64'),
    pytest.param(False, (1, 65, 2, 64), 'float32', id='False-T65-D64'),
    pytest.param(True, (1, 65, 2, 64), 'bfloat16', id='True-T65-D64-bf16'),
    pytest.param(False, (1, 65, 2, 64), 'bfloat16', id='False-T65-D64-bf16')])
def test_backward_reference_matches_pallas_vjp(interpret_kernel, causal, shape, dtype):
    """The plain backward on the JAX forward's output (di = rowsum(dO * O)):
    fp32 within 2e-4; bf16 within 1/8 of one bf16 step at each gradient's
    max-abs (2**-7 of the power of two at or below it).  Both sides round the
    same values at the same points and agree all but bit for bit; a twin
    that rounds P or dS elsewhere, or not at all, is half a step or more off."""
    q, k, v, do = (jnp.asarray(x).astype(dtype) for x in _inputs(3 + causal, shape))

    # one jitted call: the TPU interpreter's callbacks run their own jax
    # operations, and an eager caller dispatching the next operation while
    # they run can deadlock (ROADMAP Queue 3)
    @jax.jit
    def forward_and_vjp(q, k, v, do):
        jo, pullback = jax.vjp(lambda q, k, v: jax_fused_attention(q, k, v, causal=causal),
                               q, k, v)
        return jo, pullback(do)

    with pltpu.force_tpu_interpret_mode():
        jo, grads = forward_and_vjp(q, k, v, do)
    tq, tk, tv, tdo, o = (torch.tensor(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
                          for x in (q, k, v, do, jo))
    lse = fused_attention_with_lse(tq, tk, tv, causal=causal)[1]
    np.testing.assert_allclose(lse.numpy(), _jax_lse(q, k, v, causal), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), attention_lse_reference(tq, tk, tv, causal=causal),
                               rtol=0, atol=0)
    ours = fused_attention_backward_reference(tq, tk, tv, o, lse, tdo, causal=causal)
    for a, b in zip(ours, grads):
        assert a.dtype == tq.dtype and b.dtype == q.dtype
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        if dtype == 'float32':
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
        else:
            step = 2.0 ** (np.floor(np.log2(np.abs(b).max())) - 7)
            np.testing.assert_allclose(a, b, rtol=0, atol=step / 8)


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


@pytest.mark.parametrize('causal', [True, False])
def test_bf16_twin_within_the_chip_gate_of_fp32(causal):
    """The bf16 plain versions (bf16 inputs, P and dS rounded once to bf16,
    bf16 gradients) against the fp32 plain versions on the same values:
    within 2e-2 of each gradient's max-abs, the gate chip_smoke.py holds the
    bf16 kernels to.  The bf16 P is bf16-exact, and P alone is not rounded in
    fp32."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(11, (1, 130, 2, 64)))
    o, lse = fused_attention_with_lse(q, k, v, causal=causal)
    ours = fused_attention_backward_reference(q, k, v, o, lse, do, causal=causal)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    ref = fused_attention_backward_reference(qf, kf, vf, o.float(), lse, dof, causal=causal)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - b).abs().max() / b.abs().max())
        assert err <= 2e-2, err
    from audiocraft_tpu_torch.ops.attention import _recompute
    scale = 1.0 / np.sqrt(64)
    di = attention_di(o, do)
    _, p, ds = _recompute(q, k, v, do, lse, di, causal, scale)
    for x in (p, ds):
        assert torch.equal(x, x.bfloat16().float())
    _, pf, dsf = _recompute(qf, kf, vf, dof, lse, di, causal, scale)
    assert not torch.equal(pf, pf.bfloat16().float())


def test_rows_on_16_bytes_copies_only_what_the_kernels_cannot_read():
    """The bf16 kernels' 16-byte copies: strided slices of a fused qkv
    projection pass untouched; a view starting off 16 bytes is copied,
    aligned and contiguous; D = 36 is zero-padded to 40."""
    B_, T_, H_, D_ = 2, 5, 3, 64
    qkv = torch.randn(B_, T_, 3 * H_ * D_).bfloat16()
    q, k, v = (x.unflatten(-1, (H_, D_)) for x in qkv.split(H_ * D_, -1))
    out = _rows_on_16_bytes(q, k, v)
    assert all(a is b for a, b in zip(out, (q, k, v)))
    flat = torch.randn(B_ * T_ * H_ * D_ + 1).bfloat16()
    odd = flat[1:].view(B_, T_, H_, D_)
    assert odd.data_ptr() % 16
    moved, = _rows_on_16_bytes(odd)
    assert moved.data_ptr() % 16 == 0 and moved.is_contiguous() and torch.equal(moved, odd)
    narrow = torch.randn(B_, T_, H_, 36).bfloat16()
    padded, = _rows_on_16_bytes(narrow)
    assert padded.shape == (B_, T_, H_, 40) and padded.is_contiguous()
    assert torch.equal(padded[..., :36], narrow) and not padded[..., 36:].any()
