"""The port's flash-attention wrapper against the JAX package's, on the CPU.

On a CPU tensor ``fused_attention`` runs its plain version, which is
compared here with the JAX Pallas flash kernel under the TPU interpreter and
with the JAX package's XLA twin ``_xla_attention``.  The CUDA kernel itself
is compared with the same plain version on the card by chip_smoke.py.
Tolerances: 2e-5 in fp32, the JAX suite's own bar for its kernel (only the
order of the fp32 sums differs); bf16 inputs at one bf16 rounding step of
the output (2**-7 relative, 1e-2 absolute at these magnitudes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from audiocraft_tpu.nn.transformer import StreamingMultiheadAttention as JaxAttention
from audiocraft_tpu.ops import attention_pallas
from audiocraft_tpu.ops.attention_pallas import _xla_attention
from audiocraft_tpu.ops.attention_pallas import fused_attention as jax_fused_attention
from audiocraft_tpu_torch.nn import transformer
from audiocraft_tpu_torch.ops.attention import (MAX_HEAD_DIM, fused_attention,
                                                fused_attention_reference, kernel_route,
                                                plain_attention)


@pytest.fixture
def interpret_kernel(monkeypatch):
    monkeypatch.setattr(attention_pallas, 'INTERPRET', True)


def _qkv(B, T, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('T', [128, 130, 250])
def test_plain_matches_pallas_interpret_and_xla(interpret_kernel, causal, T):
    q, k, v = _qkv(2, T, 2, 32, seed=T)
    pallas = np.asarray(jax_fused_attention(*map(jnp.asarray, (q, k, v)), causal=causal))
    xla = np.asarray(_xla_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                    sm_scale=1.0 / np.sqrt(32)))
    fused_attention.launches = 0
    out = fused_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert fused_attention.launches == 0  # a CPU tensor never launches the kernel
    assert out.shape == (2, T, 2, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out.numpy(), xla, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('causal', [True, False])
def test_plain_bf16_matches_xla(causal):
    q, k, v = _qkv(1, 130, 2, 32, seed=5)
    ref = _xla_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=causal,
                         sm_scale=1.0 / np.sqrt(32))
    out = fused_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=1e-2)


def test_strided_views_equal_contiguous_inputs():
    """The wrapper takes q, k, v as strided views of a fused qkv projection."""
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(2, 40, 3 * 4 * 16).astype(np.float32))
    q, k, v = (x.unflatten(-1, (4, 16)) for x in qkv.split(64, dim=-1))
    assert not q.is_contiguous()
    out = fused_attention(q, k, v, causal=False)
    ref = fused_attention_reference(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=False)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_plain_attention_takes_an_additive_mask():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 9, 2, 8, seed=1))
    band = (torch.arange(9)[:, None] - torch.arange(9)[None, :]).abs() <= 2
    mask = torch.where(band, 0.0, float('-inf'))[None, None]
    out = plain_attention(q, k, v, mask)
    for t in range(9):   # row t sees only keys within the band
        keys = band[t].nonzero()[:, 0]
        ref = plain_attention(q[:, t:t + 1], k[:, keys], v[:, keys])
        torch.testing.assert_close(out[:, t:t + 1], ref, rtol=1e-6, atol=1e-6)


def test_routing_flag():
    assert kernel_route('auto') and kernel_route('auto_local') and kernel_route(True)
    assert not kernel_route(False)


def test_route_is_decided_by_head_dim():
    assert MAX_HEAD_DIM == 128
    assert kernel_route('auto', 128) and kernel_route(True, 64)
    assert not kernel_route('auto', 256) and not kernel_route(True, 129)


@pytest.mark.parametrize('causal', [False, True])
def test_wide_heads_take_the_plain_path_and_match_jax(monkeypatch, causal):
    """Head dim 256 with attn_kernel='auto': the layer never calls the kernel
    wrapper (it would raise on the card), and its output equals the JAX
    layer's at the same weights (fp32, 2e-5 as above)."""
    E, heads, B, T = 512, 2, 2, 9
    jax_layer = JaxAttention(E, heads, causal=causal, attn_kernel='auto')
    params = jax_layer.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    params['in_proj_bias'] = jnp.asarray(rng.randn(3 * E).astype(np.float32) * 0.1)
    x = rng.randn(B, T, E).astype(np.float32)
    ref, _ = jax_layer(params, jnp.asarray(x))

    layer = transformer.StreamingMultiheadAttention(E, heads, causal=causal, attn_kernel='auto')
    layer.load_state_dict({
        'in_proj_weight': torch.from_numpy(np.array(params['in_proj_weight'])),
        'in_proj_bias': torch.from_numpy(np.array(params['in_proj_bias'])),
        'out_proj.weight': torch.from_numpy(np.array(params['out_proj']['weight'])),
        'out_proj.bias': torch.from_numpy(np.array(params['out_proj']['bias']))})

    def refuse(*args, **kwargs):
        raise AssertionError('a head of 256 reached the kernel wrapper')

    monkeypatch.setattr(transformer, 'fused_attention', refuse)
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_wrapper_refuses_other_devices():
    x = torch.empty(1, 4, 2, 8, device='meta')
    with pytest.raises(ValueError):
        fused_attention(x, x, x, causal=False)
