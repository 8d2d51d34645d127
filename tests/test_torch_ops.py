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

from audiocraft_tpu.nn import lstm as jax_lstm
from audiocraft_tpu.nn.lstm import StreamableLSTM as JaxLSTM
from audiocraft_tpu.ops.lstm_pallas import lstm_layer_pallas
from audiocraft_tpu.ops.rvq_pallas import _xla_fallback, rvq_encode_fused
from audiocraft_tpu_torch.nn import lstm as port_lstm
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


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("T,B,C,H", [(9, 3, 16, 16), (1, 4, 24, 32), (12, 2, 32, 8)])
def test_lstm_plain_with_carry_matches_jax_lstm_layer_with_state(T, B, C, H):
    """A carried (h, c) in, the final (h, c) out, fp32 at 1e-6: the plain
    version against JAX's ``lstm_layer_with_state`` (a ``lax.scan``), T as
    small as one frame."""
    rng = np.random.RandomState(T * 10 + H)
    x = rng.randn(T, B, C).astype(np.float32) * 0.5
    h0, c0 = (rng.randn(B, H).astype(np.float32) * 0.3 for _ in range(2))
    b = 1.0 / np.sqrt(H)
    w = [rng.uniform(-b, b, shape).astype(np.float32)
         for shape in ((4 * H, C), (4 * H, H), (4 * H,), (4 * H,))]
    ref, (h_ref, c_ref) = jax_lstm.lstm_layer_with_state(
        jnp.asarray(x), *map(jnp.asarray, w), (jnp.asarray(h0), jnp.asarray(c0)))
    out, (h, c) = lstm_layer_reference(_t(x), *map(_t, w), state=(_t(h0), _t(c0)),
                                       return_state=True)
    assert h.dtype == torch.float32 and c.dtype == torch.float32
    for ours, theirs in ((out, ref), (h, h_ref), (c, c_ref)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)
    # no state: the zero start, one output as before
    zero = lstm_layer(_t(x), *map(_t, w))
    ref0 = jax_lstm.lstm_layer_with_state(jnp.asarray(x), *map(jnp.asarray, w))[0]
    np.testing.assert_allclose(zero.numpy(), np.asarray(ref0), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_two_chained_calls_equal_one(dtype):
    """The first half's final state carried into the second half gives the
    whole sequence's output and final state, exactly: h is carried in the
    compute dtype and c in fp32, as each step keeps them."""
    T, B, H = 14, 3, 16
    rng = np.random.RandomState(5)
    x = _t(rng.randn(T, B, H).astype(np.float32) * 0.5, dtype)
    w = [_t(a, dtype) for a in (rng.uniform(-.25, .25, (4 * H, H)),
                                rng.uniform(-.25, .25, (4 * H, H)),
                                rng.uniform(-.25, .25, 4 * H), rng.uniform(-.25, .25, 4 * H))]
    whole, (h, c) = lstm_layer(x, *w, return_state=True)
    first, state = lstm_layer(x[:5], *w, return_state=True)
    second, (h2, c2) = lstm_layer(x[5:], *w, state=state, return_state=True)
    assert state[0].dtype == dtype and state[1].dtype == torch.float32
    assert torch.equal(torch.cat([first, second]), whole)
    assert torch.equal(h2, h) and torch.equal(c2, c)
    with pytest.raises(ValueError):
        lstm_layer(x, *w, state=(h[:2], c[:2]))


def test_lstm_2layer_pipelined_matches_jax():
    """The skewed two-layer loop against JAX's, and against two plain
    layers, fp32 at 1e-6; ``StreamableLSTM(pipelined=True)`` takes it on a
    CPU tensor."""
    H, T, B = 16, 11, 3
    jmod = JaxLSTM(H, num_layers=2, pipelined=True)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(4)))
    x = np.random.RandomState(6).randn(B, H, T).astype(np.float32)
    ref = np.asarray(jmod(params, jnp.asarray(x)))
    names = ('w_ih', 'w_hh', 'b_ih', 'b_hh')
    p0, p1 = ([_t(params[f'l{k}'][n]) for n in names] for k in range(2))
    xt = _t(x).permute(2, 0, 1)
    out = port_lstm.lstm_2layer_pipelined(xt, p0, p1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_lstm.lstm_2layer_pipelined(
        jnp.asarray(x).transpose(2, 0, 1), params['l0'], params['l1'])), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), lstm_layer(lstm_layer(xt, *p0), *p1).numpy(),
                               rtol=1e-6, atol=1e-6)
    mod = port_lstm.StreamableLSTM(H, num_layers=2, pipelined=True)
    for k, theirs in enumerate((p0, p1)):
        for name, t in zip(('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh'), theirs):
            mod.lstm[f'{name}_l{k}'].data = t
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), ref, rtol=1e-6, atol=1e-6)


def test_streamable_lstm_stream_matches_jax():
    """``stream`` over three chunks, the state carried, against JAX's stream
    and against the whole-signal forward (fp32, 1e-6)."""
    H = 16
    jmod = JaxLSTM(H, num_layers=2)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(7)))
    mod = port_lstm.StreamableLSTM(H, num_layers=2)
    for k in range(2):
        for ours, theirs in (('weight_ih', 'w_ih'), ('weight_hh', 'w_hh'),
                             ('bias_ih', 'b_ih'), ('bias_hh', 'b_hh')):
            mod.lstm[f'{ours}_l{k}'].data = _t(params[f'l{k}'][theirs])
    x = np.random.RandomState(8).randn(2, H, 13).astype(np.float32)
    jstate = state = None
    outs, refs = [], []
    for a, b in ((0, 1), (1, 6), (6, 13)):
        ref, jstate = jmod.stream(params, jnp.asarray(x[..., a:b]), jstate)
        out, state = mod.stream(_t(x[..., a:b]), state)
        refs.append(np.asarray(ref))
        outs.append(out.detach().numpy())
        for (h, c), (jh, jc) in zip(state, jstate):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.concatenate(outs, -1), np.concatenate(refs, -1),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.concatenate(outs, -1), mod(_t(x)).detach().numpy(),
                               rtol=1e-6, atol=1e-6)


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
