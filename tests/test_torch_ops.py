"""The port's kernel modules against the JAX package's kernels, on the CPU.

On a CPU tensor each wrapper runs its kernel's plain version, which is
compared here with the Pallas kernel in interpret mode and with the JAX
package's XLA twin.  The CUDA kernels themselves are compared with the same
plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.nn.lstm import StreamableLSTM as JaxLSTM
from audiocraft_tpu.ops.lstm_pallas import lstm_layer_pallas
from audiocraft_tpu.ops.rvq_pallas import _xla_fallback, rvq_encode_fused
from audiocraft_tpu_torch.ops.lstm import lstm_layer, lstm_layer_reference
from audiocraft_tpu_torch.ops.rvq import rvq_encode, rvq_encode_reference


def _rvq_inputs(n, d, k, n_q, ties, seed):
    rng = np.random.RandomState(seed)
    embeds = rng.randn(n_q, k, d).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    if ties:
        # duplicated codebook rows tie exactly; rows of x equal to a
        # duplicated code make that tie the winner
        for q in range(n_q):
            embeds[q, 7::9] = embeds[q, 3]
            embeds[q, k - 1] = embeds[q, 0]
        x[::5] = embeds[0, 3]
        x[1::5] = embeds[0, k - 1]
    return x, embeds


@pytest.mark.parametrize("route", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("n,d,k,ties", [
    (300, 32, 400, False),    # debug bins, N not a multiple of 256
    (300, 32, 400, True),
    (517, 128, 2048, False),  # 32 kHz codebooks
    (517, 128, 2048, True),
])
def test_rvq_plain_codes_equal_jax(route, n, d, k, ties):
    x, embeds = _rvq_inputs(n, d, k, 4, ties, seed=n + k)
    if route == "xla":
        ref = _xla_fallback(jnp.asarray(x), jnp.asarray(embeds))
    else:
        ref = rvq_encode_fused(jnp.asarray(x), jnp.asarray(embeds), force_pallas=True,
                               interpret=True)
    codes = rvq_encode_reference(torch.from_numpy(x), torch.from_numpy(embeds))
    assert codes.dtype == torch.int32 and codes.shape == (4, n)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
    if ties:  # the first of two equal codes wins
        assert (codes[0, ::5] == 3).all() and (codes[0, 1::5] == 0).all()


@pytest.mark.parametrize("d", [512, 1024])
def test_rvq_plain_codes_equal_pallas_at_wide_rows(d):
    """The style conditioner's widths, above the first kernel's 128: the
    Pallas kernel pads D to a multiple of 128 and must agree code for code."""
    x, embeds = _rvq_inputs(70, d, 64, 4, True, seed=d)
    ref = rvq_encode_fused(jnp.asarray(x), jnp.asarray(embeds), force_pallas=True,
                           interpret=True)
    codes = rvq_encode_reference(torch.from_numpy(x), torch.from_numpy(embeds))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
    assert (codes[0, ::5] == 3).all() and (codes[0, 1::5] == 0).all()


def _lstm_params(H, seed):
    p = JaxLSTM(H, num_layers=1).init(jax.random.PRNGKey(seed))['l0']
    return {k: np.asarray(v) for k, v in p.items()}


def _port_lstm(x, p, dtype=torch.float32):
    args = [torch.from_numpy(np.array(a)).to(dtype)
            for a in (x, p['w_ih'], p['w_hh'], p['b_ih'], p['b_hh'])]
    return lstm_layer(*args)


@pytest.mark.parametrize("T,B,H", [(20, 8, 128), (7, 16, 256)])
def test_lstm_plain_matches_pallas_fp32(T, B, H):
    """The JAX suite's own bar for its kernel (tests/test_lstm_pallas.py)."""
    p = _lstm_params(H, seed=T)
    x = np.random.RandomState(T + B).randn(T, B, H).astype(np.float32) * 0.5
    ref = lstm_layer_pallas(jnp.asarray(x), *(jnp.asarray(p[k]) for k in
                            ('w_ih', 'w_hh', 'b_ih', 'b_hh')), interpret=True)
    out = _port_lstm(x, p)
    assert out.shape == (T, B, H) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_lstm_plain_matches_pallas_bf16():
    """bf16 weights and h, fp32 gates and c on both sides; bf16 rounding of h
    is the only gap (the JAX suite's bar, atol 0.05)."""
    T, B, H = 20, 8, 128
    p = _lstm_params(H, seed=2)
    x = np.random.RandomState(3).randn(T, B, H).astype(np.float32) * 0.5
    ref = lstm_layer_pallas(jnp.asarray(x, jnp.bfloat16), *(
        jnp.asarray(p[k], jnp.bfloat16) for k in ('w_ih', 'w_hh', 'b_ih', 'b_hh')),
        interpret=True)
    out = _port_lstm(x, p, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=0.05)


@pytest.mark.parametrize("T,B,C,H", [(20, 8, 128, 128), (9, 3, 48, 32)])
def test_lstm_plain_matches_torch_lstm(T, B, C, H):
    """A second oracle: torch.nn.LSTM on the CPU, fp32, 1e-5."""
    torch.manual_seed(T)
    ref_mod = torch.nn.LSTM(C, H, num_layers=1)
    x = torch.from_numpy(np.random.RandomState(B).randn(T, B, C).astype(np.float32))
    with torch.no_grad():
        ref, _ = ref_mod(x)
        out = lstm_layer_reference(x, ref_mod.weight_ih_l0, ref_mod.weight_hh_l0,
                                   ref_mod.bias_ih_l0, ref_mod.bias_hh_l0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    """On a CPU tensor the wrappers never launch (and never build) a kernel."""
    rvq_encode.launches = lstm_layer.launches = 0
    x, embeds = _rvq_inputs(40, 16, 64, 2, False, seed=0)
    codes = rvq_encode(torch.from_numpy(x), torch.from_numpy(embeds))
    np.testing.assert_array_equal(codes.numpy(), rvq_encode_reference(
        torch.from_numpy(x), torch.from_numpy(embeds)).numpy())
    p = _lstm_params(32, seed=1)
    _port_lstm(np.zeros((3, 2, 32), np.float32), p)
    assert rvq_encode.launches == 0 and lstm_layer.launches == 0


def test_wrappers_refuse_other_devices():
    x = torch.empty(4, 8, device='meta')
    with pytest.raises(ValueError):
        rvq_encode(x, torch.empty(1, 16, 8, device='meta'))
    w = torch.empty(32, 8, device='meta')
    with pytest.raises(ValueError):
        lstm_layer(torch.empty(2, 1, 8, device='meta'), w, w, w[:, 0], w[:, 0])
