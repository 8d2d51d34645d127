"""The port's flash-attention wrapper against the JAX package's, on the CPU.

On a CPU tensor ``fused_attention`` runs its plain version, which is
compared here with the JAX Pallas flash kernel under the TPU interpreter and
with the JAX package's XLA twin ``_xla_attention``.  The CUDA kernel itself
is compared with the same plain version on the card by chip_smoke.py; here
a stand-in library records what the forward wrapper would launch (which
views reach the kernel uncopied, padded or copied).
Tolerances: 2e-5 in fp32, the JAX suite's own bar for its kernel (only the
order of the fp32 sums differs); bf16 inputs at one bf16 rounding step of
the output (2**-7 relative, 1e-2 absolute at these magnitudes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax
from jax.experimental.pallas import tpu as pltpu

from audiocraft_tpu.nn.transformer import StreamingMultiheadAttention as JaxAttention
from audiocraft_tpu.ops import attention_pallas
from audiocraft_tpu.ops.attention_pallas import _xla_attention
from audiocraft_tpu.ops.attention_pallas import fused_attention as jax_fused_attention
from audiocraft_tpu_torch.nn import transformer
from audiocraft_tpu_torch.ops import attention
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
    # one jitted call: the TPU interpreter's callbacks run their own jax
    # operations, and an eager caller dispatching the next operation while
    # they run can deadlock (ROADMAP Queue 3)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax.jit(lambda *a: jax_fused_attention(*a, causal=causal))(
            *map(jnp.asarray, (q, k, v))))
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


class _FakeLibrary:
    """Stands in for the built kernels on a host without a card: records the
    arguments that the forward wrapper hands to ``acx_attention_fwd``."""

    def __init__(self):
        self.calls = []

    def acx_attention_max_dim(self):
        return MAX_HEAD_DIM

    def acx_attention_fwd(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_kernel(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(attention._build, 'library', lambda: lib)
    monkeypatch.setattr(attention, '_check_cuda', lambda what, *xs: None)
    monkeypatch.setattr(attention, '_launch', lambda fn, x, *args: fn(*args, None))
    return lib


def _launched(lib):
    """(pointers of q, k, v; D; strides of q, k, v; bf16) of the last launch."""
    args = lib.calls[-1]
    return args[:3], args[8], args[9:18], args[20]


@pytest.mark.parametrize('shape,causal', [((8, 1500, 16, 64), False),   # MAGNeT-small stage 0
                                          ((4, 1501, 16, 64), True),    # MusicGen-small training
                                          ((2, 9, 4, 32), True)])       # debug widths
def test_forward_passes_the_models_fused_qkv_slices_uncopied(fake_kernel, shape, causal):
    """The transformer hands K3f strided slices of one [B, T, 3 H D]
    projection; in bf16 they reach the kernel as they are."""
    B, T, H, D = shape
    qkv = torch.empty(B, T, 3 * H * D, dtype=torch.bfloat16)
    q, k, v = (x.unflatten(-1, (H, D)) for x in qkv.split(H * D, -1))
    fused_attention.launches = 0
    out, lse = attention._forward_kernel(q, k, v, causal, D ** -0.5, with_lse=True)
    ptrs, dim, strides, bf16 = _launched(fake_kernel)
    assert ptrs == tuple(x.data_ptr() for x in (q, k, v))
    assert dim == D and strides == (T * 3 * H * D, 3 * H * D, D) * 3
    assert bf16 == 1 and fused_attention.launches == 1
    assert out.shape == shape and out.is_contiguous() and lse.shape == (B, H, T)


def test_forward_copies_a_view_off_16_bytes(fake_kernel):
    shape = (2, 5, 3, 64)
    flat = torch.randn(3, 2 * 5 * 3 * 64 + 1).bfloat16()
    q, k, v = (x[1:].view(shape) for x in flat)
    assert q.data_ptr() % 16
    attention._forward_kernel(q, k, v, False, 0.125, with_lse=False)
    ptrs, dim, strides, _ = _launched(fake_kernel)
    assert all(p % 16 == 0 and p != x.data_ptr() for p, x in zip(ptrs, (q, k, v)))
    assert dim == 64 and strides == (5 * 3 * 64, 3 * 64, 64) * 3


def test_forward_pads_a_narrow_head_and_slices_the_output_back(fake_kernel):
    """D = 36 in bf16: the kernel gets rows zero-padded to 40 features and
    writes a [B, T, H, 40] output, of which the caller sees the first 36."""
    q, k, v = (torch.randn(2, 7, 3, 36).bfloat16() for _ in range(3))
    out, lse = attention._forward_kernel(q, k, v, True, 36 ** -0.5, with_lse=True)
    _, dim, strides, _ = _launched(fake_kernel)
    assert dim == 40 and strides == (7 * 3 * 40, 3 * 40, 40) * 3
    assert out.shape == (2, 7, 3, 36) and out.stride(2) == 40 and lse.shape == (2, 3, 7)


def test_forward_passes_fp32_views_as_they_are(fake_kernel):
    """The fp32 kernel copies rows in 16-byte pieces too: fp32 views whose
    rows lie on 16 bytes (D = 36, strides of whole 4-element pieces, as the
    fused qkv slices in fp32) reach it uncopied and unpadded."""
    B, T, H, D = 2, 7, 3, 36
    qkv = torch.randn(B, T, 3 * H * D)
    q, k, v = (x.unflatten(-1, (H, D)) for x in qkv.split(H * D, -1))
    fused_attention.fp32_launches = 0
    out, _ = attention._forward_kernel(q, k, v, False, D ** -0.5, with_lse=False)
    ptrs, dim, strides, bf16 = _launched(fake_kernel)
    assert ptrs == tuple(x.data_ptr() for x in (q, k, v)) and dim == 36 and bf16 == 0
    assert strides == (T * 3 * H * D, 3 * H * D, D) * 3 and fused_attention.fp32_launches == 1
    assert out.shape == (2, 7, 3, 36) and out.is_contiguous()


@pytest.mark.parametrize('D,padded', [(36, 36), (30, 32), (1, 4)])
def test_forward_copies_an_fp32_view_off_16_bytes_and_pads_its_head(fake_kernel, D, padded):
    """A view one element past 16 bytes is copied; a head that is not a
    multiple of 4 features is zero-padded to one and sliced back."""
    flat = torch.randn(3, 2 * 7 * 3 * D + 1)
    q, k, v = (x[1:].view(2, 7, 3, D) for x in flat)
    assert q.data_ptr() % 16
    out, lse = attention._forward_kernel(q, k, v, True, D ** -0.5, with_lse=True)
    ptrs, dim, strides, bf16 = _launched(fake_kernel)
    assert all(p % 16 == 0 and p != x.data_ptr() for p, x in zip(ptrs, (q, k, v)))
    assert dim == padded and strides == (7 * 3 * padded, 3 * padded, padded) * 3 and bf16 == 0
    assert out.shape == (2, 7, 3, D) and lse.shape == (2, 3, 7)


@pytest.mark.parametrize('dim', [1, 4, 31, 32, 33, 36, 63, 64, 65, 100, 127, 128])
def test_fp32_forward_geometry_fits_every_head_up_to_the_widest(dim):
    """K3f's fp32 block (csrc/attention.cu:smem_floats_f32) at every width
    class: 64 rows of 4 warps, 32-key tiles, within a block's shared memory,
    four blocks an SM at D = 64 (JASCO's 384 blocks in one wave), two at 128;
    the unpadded K rows, swizzled, and the P^T rows spread a warp's accesses
    over the banks."""
    g = attention.fwd_f32_geometry(dim)
    assert g['width'] >= dim and g['width'] in (32, 64, 128)
    assert (g['rows'], g['keys'], g['threads']) == (64, 32, 128)
    dp = g['width']
    assert g['shared_bytes'] == 4 * (dp * 64 + 2 * 32 * 2 * dp + 4 * 32 * 16)
    per_sm = 233472 // (g['shared_bytes'] + 1024)   # an SM's 228 KiB, 1 KiB reserved a block
    assert g['shared_bytes'] <= attention.SMEM_LIMIT and per_sm >= {32: 6, 64: 4, 128: 2}[dp]
    swz = lambda r, c4: c4 ^ (r & 7)   # csrc/attention.cu:swz, in 16-byte pieces
    for j in range(4):
        # a warp's P^T stores (key kg + 8 j, rows 4 rg ..): 4 lanes a bank group
        groups = [((kg + 8 * j) * 16 // 4 + rg) % 8 for kg in range(8) for rg in range(4)]
        assert sorted(groups) == sorted(list(range(8)) * 4)
        for c4 in range(dp // 4):
            # the 8 keys of one K load (rows kg + 8 j, piece c4) on distinct bank groups
            assert len({((kg + 8 * j) * dp // 4 + swz(kg, c4)) % 8 for kg in range(8)}) == 8
            assert all(0 <= swz(r, c4) < dp // 4 for r in range(32))


def test_fp32_forward_geometry_refuses_heads_past_the_widest():
    with pytest.raises(ValueError):
        attention.fwd_f32_geometry(attention.MAX_HEAD_DIM + 1)
