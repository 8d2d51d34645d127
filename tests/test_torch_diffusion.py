"""The port's MultiBand-Diffusion pieces (``nn/diffusion.py``) against the
JAX package's, on the CPU.

The UNet's weights are the port's seeded init, moved by seeded noise, in
the JAX package's tree (``test_torch_codec_train.jax_tree_from_port``, which
saves JAX's init compile and checks
``ckpt/from_jax.diffusion_unet_state_from_jax`` both ways);
inputs are made from a seed with numpy, and the JAX package's normal draws
are passed to the port (``noise=``, ``noises=``, ``step=``).  The band split
compares within 1e-6 of its largest value at 32 kHz and 4 bands (5e-6 at
24 kHz and 8 bands, whose filters are twice as long), the UNet within 1e-5
(fp32, only the order of the sums differs), betas and ``alpha_bar`` within 1e-6 relative (``torch.linspace``
and ``jnp.linspace`` may round a beta one ulp apart) and the reverse
processes within 1e-4.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.nn import diffusion as jd
from audiocraft_tpu_torch.ckpt.from_jax import diffusion_unet_state_from_jax
from audiocraft_tpu_torch.nn import diffusion as td

from test_torch_codec_train import jax_tree_from_port


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _unet_pair(seed=0, **cfg):
    """A JAX UNet, its params and a port UNet holding them: the port's
    seeded init, every tensor moved by seeded noise (so that the norms'
    ones and the zero biases are not special), in JAX's tree."""
    junet = jd.DiffusionUnet(**cfg)
    tunet = td.DiffusionUnet(**cfg, generator=torch.Generator().manual_seed(seed)).eval()
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in tunet.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    params = jax_tree_from_port(junet.init, tunet.state_dict(),
                                functools.partial(diffusion_unet_state_from_jax, tunet))
    return junet, params, tunet


@pytest.mark.parametrize("sample_rate,n_bands,tol", [(32000, 4, 1e-6), (24000, 8, 5e-6),
                                                     (24000, 1, 0.0)])
def test_split_bands_matches_jax_and_sums_back(sample_rate, n_bands, tol):
    x = _randn(0, 2, 1, 4000)
    ref = np.asarray(jd.split_bands(jnp.asarray(x), sample_rate, n_bands))
    bands = td.split_bands(torch.from_numpy(x), sample_rate, n_bands)
    assert bands.shape == (n_bands, 2, 1, 4000)
    # of the largest band value: fp32 sums of 303 taps (32 kHz, 4 bands)
    # or 629 (24 kHz, 8 bands) in another order
    np.testing.assert_allclose(bands.numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())
    np.testing.assert_allclose(bands.sum(0).numpy(), x, rtol=0, atol=1e-5)


def test_lowpass_taps_at_32khz_4_bands():
    kernels, half = td._lowpass_kernels(32000, 4)
    assert half == 151 and kernels.shape == (3, 1, 303)
    ref, ref_half = jd._lowpass_kernels(32000, 4)
    assert ref_half == half
    np.testing.assert_array_equal(kernels, ref)


def test_multiband_processor_matches_jax_with_its_noise():
    kw = dict(n_bands=4, sample_rate=24000, num_samples=4)
    jproc = jd.MultiBandProcessor(**kw)
    tproc = td.MultiBandProcessor(**kw)
    state = jproc.init_state()
    for i, seed in enumerate((1, 2, 3)):   # the third batch is past num_samples: no update
        x = _randn(seed, 2, 1, 3000)
        key = jax.random.PRNGKey(i)
        noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
        ref, state = jproc.project_sample(state, jnp.asarray(x), key=key)
        out = tproc.project_sample(torch.from_numpy(x), noise=torch.from_numpy(noise.copy()))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        for name in ('counts', 'sum_x', 'sum_x2', 'sum_target_x2'):
            np.testing.assert_allclose(getattr(tproc, name).numpy(),
                                       np.asarray(getattr(state, name)), rtol=1e-5, atol=1e-7)
    assert float(tproc.counts) == 4
    y = _randn(9, 2, 1, 3000)
    np.testing.assert_allclose(tproc.return_sample(torch.from_numpy(y)).numpy(),
                               np.asarray(jproc.return_sample(state, jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)
    # without draws the statistics stay
    before = tproc.sum_x.clone()
    tproc.project_sample(torch.from_numpy(y))
    assert torch.equal(before, tproc.sum_x)
    drawn = td.MultiBandProcessor(**kw)
    drawn.project_sample(torch.from_numpy(y), generator=torch.Generator().manual_seed(0))
    assert float(drawn.counts) == 2 and bool((drawn.sum_target_x2 > 0).all())


UNETS = {
    'zeros': dict(chin=1, hidden=8, depth=2, num_steps=50, codec_dim=6),
    'bilstm': dict(chin=1, hidden=8, depth=2, num_steps=50, codec_dim=6, bilstm=True),
    'transformer': dict(chin=1, hidden=8, depth=2, num_steps=50, codec_dim=6,
                        use_transformer=True),
    'cross': dict(chin=1, hidden=8, depth=2, num_steps=50, codec_dim=6,
                  use_transformer=True, cross_attention=True),
    'stride4_all_layers': dict(chin=2, hidden=8, depth=3, num_steps=50, kernel=8, stride=4,
                               emb_all_layers=True, res_blocks=2, bilstm=True, codec_dim=6),
}


@pytest.mark.parametrize("name", list(UNETS))
def test_unet_matches_jax(name):
    cfg = UNETS[name]
    junet, params, tunet = _unet_pair(seed=1, **cfg)
    x = _randn(2, 2, cfg['chin'], 501)
    cond = _randn(3, 2, 6, 100)
    jp = jax.tree.map(jnp.asarray, params)
    jfn = jax.jit(lambda p, z, s, c: junet(p, z, s, condition=c))
    for step in (7, np.array([3, 40])):
        ref = jfn(jp, jnp.asarray(x), jnp.asarray(step, jnp.int32), jnp.asarray(cond))
        with torch.no_grad():
            out = tunet(torch.from_numpy(x), step if isinstance(step, int)
                        else torch.from_numpy(step), condition=torch.from_numpy(cond))
        assert out.shape == x.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_unet_zero_bottleneck_ignores_the_condition():
    _, _, tunet = _unet_pair(seed=2, **UNETS['zeros'])
    x = torch.from_numpy(_randn(4, 1, 1, 300))
    with torch.no_grad():
        a = tunet(x, 5, condition=torch.from_numpy(_randn(5, 1, 6, 60)))
        b = tunet(x, 5, condition=torch.zeros(1, 6, 60))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match='conditional'):
        tunet(x, 5)


def test_unet_blstm_differentiable_route():
    """With a gradient required the BLSTM's kernel route refuses; the
    differentiable route gives the kernel route's output and gradients."""
    _, _, tunet = _unet_pair(seed=3, **UNETS['bilstm'])
    tunet.requires_grad_(True)
    x = torch.from_numpy(_randn(6, 2, 1, 256))
    cond = torch.from_numpy(_randn(7, 2, 6, 40))
    with pytest.raises(RuntimeError, match='differentiable route'):
        tunet(x, 3, condition=cond)
    out = tunet(x, 3, condition=cond, lstm_kernel=False)
    out.square().sum().backward()
    assert all(p.grad is not None for p in tunet.bilstm.parameters())
    with torch.no_grad():
        torch.testing.assert_close(out, tunet(x, 3, condition=cond), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("beta_exp,num_steps", [(1.0, 1000), (2.0, 300)])
def test_betas_and_alpha_bar_match_jax(beta_exp, num_steps):
    js = jd.NoiseSchedule(num_steps=num_steps, beta_exp=beta_exp)
    ts = td.NoiseSchedule(num_steps=num_steps, beta_exp=beta_exp)
    np.testing.assert_allclose(ts.betas.numpy(), np.asarray(js.betas), rtol=1e-6)
    np.testing.assert_allclose(ts.get_alpha_bar().numpy(), np.asarray(js.get_alpha_bar()),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ts.get_alpha_bar(17)), float(js.get_alpha_bar(17)),
                               rtol=1e-6)


@pytest.mark.parametrize("tensor_step", [True, False])
def test_training_item_matches_jax_with_its_draws(tensor_step):
    js, ts = jd.NoiseSchedule(rescale=1.5, noise_scale=0.8), \
        td.NoiseSchedule(rescale=1.5, noise_scale=0.8)
    x = _randn(8, 3, 1, 200)
    key = jax.random.PRNGKey(4)
    noisy, noise, step = js.get_training_item(key, jnp.asarray(x), tensor_step=tensor_step)
    out, out_noise, out_step = ts.get_training_item(
        torch.from_numpy(x), tensor_step=tensor_step,
        step=torch.from_numpy(np.array(step, np.int64)),
        noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(out.numpy(), np.asarray(noisy), rtol=1e-5, atol=1e-6)
    drawn = ts.get_training_item(torch.from_numpy(x), generator=torch.Generator().manual_seed(1),
                                 tensor_step=tensor_step)
    assert drawn[0].shape == x.shape and drawn[2].shape == ((3,) if tensor_step else ())


def _jax_draws(key, n, shape):
    """The normal draws of the JAX reverse loops, in order: each splits the
    key and draws from the new subkey."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("subsampled,variance", [(False, 'beta'), (False, 'beta_tilde'),
                                                 (True, 'beta')])
def test_reverse_process_matches_jax_with_its_draws(subsampled, variance):
    cfg = dict(chin=1, hidden=8, depth=2, num_steps=20, bilstm=True, codec_dim=6)
    junet, params, tunet = _unet_pair(seed=5, **cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jfn = jax.jit(lambda z, s, c: junet(jp, z, s, condition=c))
    kw = dict(num_steps=20, clip=1.5, variance=variance, rescale=1.2, noise_scale=0.9)
    js, ts = jd.NoiseSchedule(**kw), td.NoiseSchedule(**kw)
    x0 = _randn(10, 2, 1, 160)
    cond = _randn(11, 2, 6, 20)
    key = jax.random.PRNGKey(6)
    step_list = [19, 13, 6, 2, 0]
    if subsampled:
        ref = js.generate_subsampled(key, lambda z, s, c: jfn(z, jnp.int32(s), c),
                                     jnp.asarray(x0), step_list=step_list,
                                     condition=jnp.asarray(cond))
        n_draws = len(step_list) - 2
    else:
        ref = js.generate(key, lambda z, s, c: jfn(z, jnp.int32(s), c), jnp.asarray(x0),
                          condition=jnp.asarray(cond))
        n_draws = 19
    noises = _jax_draws(key, n_draws, x0.shape)
    with torch.no_grad():
        fn = lambda z, s, c: tunet(z, s, condition=c)  # noqa: E731
        if subsampled:
            out = ts.generate_subsampled(fn, torch.from_numpy(x0), step_list=step_list,
                                         condition=torch.from_numpy(cond), noises=noises)
        else:
            out = ts.generate(fn, torch.from_numpy(x0), condition=torch.from_numpy(cond),
                              noises=noises)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_default_step_list_has_21_entries():
    calls = []
    ts = td.NoiseSchedule()
    out = ts.generate_subsampled(lambda z, s, c: calls.append(s) or torch.zeros_like(z),
                                 torch.zeros(1, 1, 8), generator=torch.Generator().manual_seed(0))
    assert len(calls) == 20 and calls[0] == 999 and calls[-1] == 49
    assert out.shape == (1, 1, 8)


def test_multiband_diffusion_builder_stand_in_widths():
    """The stand-in widths of the card's check (48 hidden channels, depth 4,
    kernel 8, stride 4, growth 2): the transformer bottleneck of 384
    channels at T / 256, conditioned on the codec's 128-d latent; two bands
    from one generator draw their own weights."""
    gen = torch.Generator().manual_seed(0)
    unets = [td.DiffusionUnet(chin=1, hidden=48, depth=4, kernel=8, stride=4, growth=2.0,
                              norm_groups=4, res_blocks=1, emb_all_layers=True, codec_dim=128,
                              use_transformer=True, generator=gen) for _ in range(2)]
    assert unets[0].bottleneck_dim == 384 and unets[0].transformer is not None
    assert not torch.equal(unets[0].embedding, unets[1].embedding)
    x = torch.from_numpy(_randn(12, 1, 1, 256 * 6))
    with torch.no_grad():
        out = unets[0](x, 999, condition=torch.from_numpy(_randn(13, 1, 128, 2)))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
