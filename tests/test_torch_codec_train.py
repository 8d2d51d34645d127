"""The port's codec training against the JAX package, on the CPU:
``EncodecModel.forward``, ``encodec_loss`` gradients, the reconstruction
and GAN steps, the losses, the discriminator, the balancer, the
transformer's ``checkpointing``, a ``scan_layers`` JAX LM's stacked params, the train
state, the ``train_encodec`` CLI, and the forward-only kernels' refusal of
tensors that require a gradient.

The codec is the 32 kHz topology at thin widths (``n_filters=4``,
``dimension=32``, 4 x 64 codebooks; its 2-layer LSTM of width 64 is what the
debug codec lacks), fp32, its weights the port's seeded init written into
JAX's param tree through ``ckpt/from_jax.py``'s mapping run backwards
(:func:`jax_tree_from_port`); a fresh codec's codebooks are zeros on both
sides (``kmeans_init``), so its first training forward runs k-means.  The port takes
JAX's drawn rows (``test_torch_quant_train.jax_rows``).  Inputs are made
from numpy seeds; the JAX steps run under ``jax.jit``.  Tolerances: codes
equal; EMA state within 1e-5; losses within 1e-5 relative; gradients
within 1e-4 of each tensor's largest JAX gradient (fp32, sums in another
order; the discriminator's within 1e-4 of the larger of that and its
hinge parts', :func:`hinge_part_scales`); after one SGD step parameters
within atol 2e-5 and rtol 2e-4 (the JAX suite's bar,
tests/test_mixed_precision.py); after one Adam step (a
sign step of size lr for every gradient well above Adam's eps) parameters
within 1e-3 lr plus 1e-6 where JAX's gradient exceeds 1e-6 of its tensor's
largest, and within lr everywhere.
"""

import copy
import dataclasses
import functools

import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu import adversarial as jax_adv
from audiocraft_tpu import builders as jax_builders
from audiocraft_tpu import losses as jax_losses
from audiocraft_tpu.dist import train as jax_train
from audiocraft_tpu_torch import adversarial, losses, optim
from audiocraft_tpu_torch.apps import train_encodec
from audiocraft_tpu_torch.builders import get_debug_musicgen_lm, get_encodec_32khz
from audiocraft_tpu_torch.ckpt import train_state
from audiocraft_tpu_torch.ckpt.from_jax import (balancer_state_from_jax,
                                                discriminator_state_from_jax,
                                                encodec_state_from_jax, lm_state_from_jax)
from audiocraft_tpu_torch.dist.train import (encodec_loss, lm_loss,
                                             make_encodec_gan_train_step,
                                             make_encodec_train_step)
from audiocraft_tpu_torch.nn.lstm import StreamableLSTM
from audiocraft_tpu_torch.ops.lstm import lstm_layer
from audiocraft_tpu_torch.ops.seanet import (StageSpec, banded_mono_conv, fused_stage,
                                             mono_input_conv)

from test_torch_quant_train import jax_rows

CODEC = dict(n_filters=4, dimension=32, n_q=4, bins=64)
B, SAMPLES = 2, 6400                      # 0.2 s at 32 kHz: 10 frames, 20 rows a codebook
DISC = dict(filters=4, n_ffts=(256, 128), hop_lengths=(64, 32), win_lengths=(256, 128))
LR = 3e-4


class _Sgd:
    """``optax.sgd``'s update, in place, keeping the gradients it was given
    (``grads``) for the tests to compare."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return optim.OptState(0, [], [])

    @torch.no_grad()
    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        torch._foreach_add_(list(params), list(grads), alpha=-self.lr)
        state.count += 1


def capture_sgd(lr):
    """``optax.sgd(lr)`` whose state after an update is the gradients it was
    given, so a JAX step hands them back."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(lambda t: -lr * t, g), g))


def _check_grads(got, ref, label='', scales=None):
    """Every tensor within 1e-4 of its largest JAX gradient, by name, or of
    ``scales[name]`` where that is larger (:func:`hinge_part_scales`)."""
    assert set(got) <= set(ref), label
    for n, g in got.items():
        want = torch.as_tensor(np.asarray(ref[n]))
        scale = max(float(want.abs().max()), 0.0 if scales is None else scales[n])
        err = float((g - want).abs().max())
        assert err <= 1e-4 * scale, f'{label}{n}: {err:.3g} > 1e-4 x {scale:.3g}'


def hinge_part_scales(codec, disc, x, draws):
    """Per discriminator tensor, the largest gradient of either part of its
    hinge loss (the real clips' and the reconstruction's) at the
    reconstruction a training forward of ``codec`` gives: the size of the
    two terms whose sum is the discriminator's gradient.  At init every
    logit lies inside the margin, so the two nearly cancel (the output
    conv's bias gradient is exactly 0), and the sum's own largest value is
    no measure of its fp32 rounding, which the parts' size sets."""
    codec = copy.deepcopy(codec)
    disc = copy.deepcopy(disc).requires_grad_(True)
    with torch.no_grad():
        recon = codec(x, training=True, draws=draws, expiry='effective').x
        real, fake = disc(x)[0], disc(recon)[0]
    params = list(disc.parameters())
    parts = (adversarial.hinge_d_loss(disc(x)[0], fake),
             adversarial.hinge_d_loss(real, disc(recon)[0]))
    grads = [torch.autograd.grad(loss, params) for loss in parts]
    return {n: max(float(a.abs().max()), float(b.abs().max()))
            for (n, _), a, b in zip(disc.named_parameters(), *grads)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread, as the other codec test files run it: the CPU's
    transposed convolutions are slow with several threads, and the module
    shares the host with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tree_from_port(init, state, to_port):
    """The JAX param tree of ``init``'s structure (``jax.eval_shape``, no
    compile) that ``to_port`` (a ``ckpt/from_jax`` mapping to the port's
    state dict) carries to ``state``: the mapping is read by carrying a tree
    of element indices, then run backwards.  Checked by carrying the result
    forwards again.  A JAX init's compile takes 5-10 s a model on the CPU;
    the port's seeded init takes none."""
    leaves, treedef = jax.tree.flatten(jax.eval_shape(init, jax.random.PRNGKey(0)))
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    starts = np.cumsum([0] + sizes)
    assert starts[-1] < 2 ** 24    # element indices exact in fp32
    index = to_port(treedef.unflatten([np.arange(a, a + n, dtype=np.float32).reshape(leaf.shape)
                                       for a, n, leaf in zip(starts, sizes, leaves)]))
    flat = np.full(starts[-1], np.nan, np.float32)
    for name, idx in index.items():
        flat[idx.numpy().astype(np.int64).ravel()] = state[name].numpy().ravel()
    assert not np.isnan(flat).any(), 'a JAX leaf the mapping does not fill'
    tree = treedef.unflatten([flat[a:a + n].reshape(leaf.shape).astype(leaf.dtype)
                              for a, n, leaf in zip(starts, sizes, leaves)])
    for name, t in to_port(tree).items():
        assert torch.equal(t, state[name]), name
    return tree


@pytest.fixture(scope='module')
def jax_codec():
    """The JAX codec and its params: the port's seeded init in JAX's tree."""
    model = jax_builders.get_encodec_32khz(compute_dtype=None, **CODEC)
    port = get_encodec_32khz(compute_dtype=None, device='cpu', seed=0, **CODEC)
    params = jax_tree_from_port(model.init, port.state_dict(),
                                functools.partial(encodec_state_from_jax, port))
    return model, params


@pytest.fixture(scope='module')
def jax_train_forward(jax_codec):
    """JAX's training forward (``'effective'`` expiry), jitted once."""
    model, _ = jax_codec
    return jax.jit(functools.partial(model.forward, training=True, expiry='effective'))


def _port_codec(params):
    port = get_encodec_32khz(compute_dtype=None, device='cpu', **CODEC)
    port.load_state_dict(encodec_state_from_jax(port, params))
    return port


def _wav(seed=0):
    return (np.random.RandomState(seed).randn(B, 1, SAMPLES) * 0.1).astype(np.float32)


def _draws(key, n_q=CODEC['n_q'], rows=B * 10, k=CODEC['bins']):
    return [jax_rows(kq, rows, k) for kq in jax.random.split(key, n_q)]


def _port_quant_state(port):
    layers = [layer._codebook for layer in port.quantizer.vq.layers]
    return {n: np.stack([getattr(cb, n).numpy() for cb in layers])
            for n in ('embed', 'cluster_size', 'embed_avg', 'inited')}


def _check_quant_state(port, jstate):
    got = _port_quant_state(port)
    for n in ('embed', 'cluster_size', 'embed_avg'):
        np.testing.assert_allclose(got[n], np.asarray(getattr(jstate, n)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got['inited'].reshape(-1), np.asarray(jstate.inited))


def _port_tree(port, jtree, params):
    """A JAX gradient or param tree under the port's parameter names."""
    full = dict(jtree)
    full['quantizer'] = params['quantizer']
    return encodec_state_from_jax(port, _np(full))


@pytest.mark.parametrize('fresh', [True, False], ids=['fresh-kmeans', 'warm'])
def test_encodec_forward_matches_jax(jax_codec, jax_train_forward, fresh):
    """Training forward: codes equal, reconstruction and penalty within
    1e-5 relative, the EMA state within 1e-5; a fresh codec runs k-means on
    its first batch as JAX's does."""
    _, params = jax_codec
    fwd = jax_train_forward
    key = jax.random.PRNGKey(1)
    if not fresh:   # warm: one training forward first, on another batch
        _, params = fwd(params, jnp.asarray(_wav(5)), key=jax.random.PRNGKey(7))
        params = _np(params)
    assert bool(np.all(np.asarray(params['quantizer'].inited) == (0.0 if fresh else 1.0)))
    res, new = fwd(params, jnp.asarray(_wav()), key=key)
    port = _port_codec(params)
    out = port(torch.from_numpy(_wav()), training=True, draws=_draws(key), expiry='effective')
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(res.codes))
    assert _rel(out.x.detach(), res.x) < 1e-5
    assert _rel(out.penalty.detach(), res.penalty) < 1e-5
    _check_quant_state(port, new['quantizer'])
    assert out.x.shape == (B, 1, SAMPLES)


def _grad_params(params):
    return {k: v for k, v in params.items() if k != 'quantizer'}


GRAD_KEY, GRAD_WAV = 2, 1   # the batch of the gradient and step tests


def _jax_step_params(model, step, params, opt_state, x, key):
    gp, q, opt_state, metrics = jax.jit(step)(_grad_params(params), params['quantizer'],
                                              opt_state, x, key)
    return gp, q, opt_state, metrics


@pytest.fixture(scope='module')
def jax_sgd_step(jax_codec):
    """JAX's make_encodec_train_step with SGD (1e-2) on the gradient tests'
    batch, the gradients captured: (params, EMA state, gradients under the
    port's names, metrics)."""
    model, params = jax_codec
    jopt = capture_sgd(1e-2)
    step = jax_train.make_encodec_train_step(model, jopt)
    gp, q, grads, metrics = _jax_step_params(model, step, params,
                                             jopt.init(_grad_params(params)),
                                             jnp.asarray(_wav(GRAD_WAV)),
                                             jax.random.PRNGKey(GRAD_KEY))
    return gp, q, _port_tree(_port_codec(params), grads, params), metrics


@pytest.fixture(scope='module')
def jax_loss_grads(jax_sgd_step):
    """JAX's encodec_loss and its gradients (those the step took) under the
    port's names."""
    _, _, grads, metrics = jax_sgd_step
    return float(metrics['loss']), grads


def test_encodec_loss_grads_match_jax(jax_codec, jax_loss_grads):
    """encodec_loss's gradients against jax.grad, every tensor within 1e-4 of
    its largest JAX gradient; the LSTM weights' gradients are non-zero."""
    _, params = jax_codec
    loss, ref = jax_loss_grads
    port = _port_codec(params).requires_grad_(True)
    ploss, _ = encodec_loss(port, torch.from_numpy(_wav(GRAD_WAV)),
                            draws=_draws(jax.random.PRNGKey(GRAD_KEY)))
    names = [n for n, _ in port.named_parameters()]
    got = torch.autograd.grad(ploss, [p for _, p in port.named_parameters()])
    assert _rel(ploss.detach(), loss) < 1e-5
    lstm_names = [n for n in names if '.lstm.' in n]
    assert lstm_names
    _check_grads(dict(zip(names, got)), ref)
    for n, g in zip(names, got):
        if n in lstm_names:
            assert float(ref[n].abs().max()) > 0 and float(g.abs().max()) > 0, n


@pytest.mark.parametrize('opt', ['sgd', 'adam'])
def test_encodec_train_step_matches_jax(jax_codec, jax_loss_grads, jax_sgd_step, opt):
    """One step against JAX's: with SGD, JAX's make_encodec_train_step; with
    Adam, the same step's update (optax.adam on JAX's gradients of the same
    batch), so one JAX step compiles for both."""
    model, params = jax_codec
    key = jax.random.PRNGKey(GRAD_KEY)
    x = _wav(GRAD_WAV)
    gp, q, _, metrics = jax_sgd_step
    port = _port_codec(params)
    popt = _Sgd(1e-2) if opt == 'sgd' else optim.make_optimizer('adam', LR)
    state = popt.init(list(port.parameters()))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    m = make_encodec_train_step(port, popt)(state, torch.from_numpy(x), draws=_draws(key))
    assert _rel(m['loss'], metrics['loss']) < 1e-5
    _check_quant_state(port, q)
    jgrads = jax_loss_grads[1]
    if opt == 'sgd':
        ref = _port_tree(port, gp, params)
    else:
        jopt = optax.adam(LR, b1=0.9, b2=0.95)
        jgp = {n: jnp.asarray(jgrads[n].numpy()) for n in before}
        jp = {n: jnp.asarray(p.numpy()) for n, p in before.items()}
        adam = jax.jit(lambda g, p: optax.apply_updates(p, jopt.update(g, jopt.init(p), p)[0]))
        ref = {n: torch.from_numpy(np.asarray(v)) for n, v in adam(jgp, jp).items()}
    if opt == 'sgd':
        _check_grads(dict(zip(before, popt.grads)), jgrads)
    for n, p in port.named_parameters():
        got, want = p.detach().numpy(), ref[n].numpy()
        if opt == 'sgd':
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4, err_msg=n)
            continue
        d_got, d_want = got - before[n].numpy(), want - before[n].numpy()
        assert np.abs(d_got).max() <= LR + 1e-7, n
        g = np.abs(jgrads[n].numpy())
        big = g > 1e-6 * g.max()
        np.testing.assert_allclose(d_got[big], d_want[big], atol=1e-3 * LR + 1e-6, err_msg=n)


def test_bf16_keeps_the_quantizer_fp32(jax_codec):
    """compute_dtype='bfloat16': the SEANet stacks see bf16, the quantizer fp32
    latents and fp32 codebooks; the loss within 5e-2 of fp32's."""
    _, params = jax_codec
    port = _port_codec(params)
    seen = {}

    def record(name):
        def hook(module, args):
            seen[name] = args[0].dtype
        return hook

    port.quantizer.register_forward_pre_hook(record('q'))
    port.encoder.model[0].register_forward_pre_hook(record('enc'))
    port.decoder.model[0].register_forward_pre_hook(record('dec'))
    x = torch.from_numpy(_wav(3))
    draws = _draws(jax.random.PRNGKey(4))
    state = {k: v.clone() for k, v in port.state_dict().items()}
    loss16, _ = encodec_loss(port, x, draws=draws, compute_dtype='bfloat16')
    assert seen == {'q': torch.float32, 'enc': torch.bfloat16, 'dec': torch.bfloat16}
    for layer in port.quantizer.vq.layers:
        assert all(b.dtype == torch.float32 for b in layer._codebook.buffers())
    port.load_state_dict(state)
    loss32, _ = encodec_loss(port, x, draws=draws)
    assert loss16.dtype == torch.float32 and abs(float(loss16) / float(loss32) - 1) < 5e-2


def test_stft_and_mel_match_jax():
    x = np.random.RandomState(5).randn(2, 1, 3000).astype(np.float32)
    for n_fft, hop, win in ((256, 64, 200), (128, 32, None)):
        ref = np.asarray(jax.jit(functools.partial(jax_losses.stft, n_fft=n_fft,
                                                   hop_length=hop, win_length=win))(x))
        got = losses.stft(torch.from_numpy(x), n_fft, hop, win).numpy()
        assert got.shape == ref.shape
        assert _rel(got.real, ref.real) < 1e-5 and _rel(got.imag, ref.imag) < 1e-5
    np.testing.assert_array_equal(losses.mel_filterbank(32000, 512, 40),
                                  jax_losses.mel_filterbank(32000, 512, 40))
    ref = np.asarray(jax_losses.mel_spectrogram(jnp.asarray(x), 32000, 512, 128, 40, log=True))
    got = losses.mel_spectrogram(torch.from_numpy(x), 32000, 512, 128, 40, log=True)
    assert _rel(got, ref) < 1e-5


def test_msspec_and_sisnr_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 1, 4000).astype(np.float32) * 0.1
    y = (x + 0.05 * rng.randn(*x.shape)).astype(np.float32)
    jloss = jax_losses.MultiScaleMelSpectrogramLoss(sample_rate=32000)
    ref = jax.jit(jloss)(jnp.asarray(x), jnp.asarray(y))
    got = losses.MultiScaleMelSpectrogramLoss(sample_rate=32000)(torch.from_numpy(x),
                                                                  torch.from_numpy(y))
    assert _rel(got, ref) < 1e-5
    ref = jax_losses.sisnr(jnp.asarray(y), jnp.asarray(x))
    assert _rel(losses.sisnr(torch.from_numpy(y), torch.from_numpy(x)), ref) < 1e-5


@pytest.fixture(scope='module')
def jax_disc():
    """The JAX discriminator and JAX's init of it: the balancer test's
    feature-matching near-tie (see its docstring) is this init's."""
    disc = jax_adv.MultiScaleSTFTDiscriminator(**DISC)
    return disc, _np(jax.jit(disc.init)(jax.random.PRNGKey(8)))


def _port_disc(params):
    disc = adversarial.MultiScaleSTFTDiscriminator(**DISC)
    disc.load_state_dict(discriminator_state_from_jax(disc, params))
    return disc


def test_discriminator_and_adversarial_losses_match_jax(jax_disc):
    disc, params = jax_disc
    rng = np.random.RandomState(9)
    real = (rng.randn(2, 1, 3200) * 0.1).astype(np.float32)
    fake = (rng.randn(2, 1, 3200) * 0.1).astype(np.float32)
    run = jax.jit(disc.__call__)
    (rl, rf), (fl, ff) = run(params, jnp.asarray(real)), run(params, jnp.asarray(fake))
    port = _port_disc(params)
    with torch.no_grad():
        (prl, prf), (pfl, pff) = port(torch.from_numpy(real)), port(torch.from_numpy(fake))
    for a, b in zip(prl, rl):
        assert a.shape == b.shape and _rel(a, b) < 1e-5
    for scale_a, scale_b in zip(prf, rf):
        for a, b in zip(scale_a, scale_b):
            assert a.shape == b.shape and _rel(a, b) < 1e-5
    assert _rel(adversarial.hinge_d_loss(prl, pfl), jax_adv.hinge_d_loss(rl, fl)) < 1e-5
    assert _rel(adversarial.hinge_g_loss(pfl), jax_adv.hinge_g_loss(fl)) < 1e-5
    assert _rel(adversarial.feature_matching_loss(prf, pff),
                jax_adv.feature_matching_loss(rf, ff)) < 1e-5


def test_balanced_cotangent_matches_jax(jax_disc):
    """Two balancer calls: the losses within 1e-5 relative; the cotangent,
    the gradient norms and their EMA state within 1e-4.  Feature matching's
    L1 has a kink wherever a real and a fake activation are equal, and some
    of the 2 x 10^5 activation pairs come within rounding of each other
    (1.9e-9 at the first call's seed): the two sides' signs differ there,
    which moves the feature loss's gradient by 1.6e-4 of its largest value
    and the cotangent by 7e-5 (a near-tie, as the codes' are, not a fault;
    the adversarial loss's gradient agrees within 1e-6)."""
    disc, params = jax_disc
    rng = np.random.RandomState(10)
    x = (rng.randn(2, 1, 3200) * 0.1).astype(np.float32)
    balancer = jax_losses.Balancer(weights=dict(jax_train_weights()))
    msspec = jax_losses.MultiScaleMelSpectrogramLoss(sample_rate=32000, range_start=5,
                                                    range_end=6)
    _, real_feats = disc(params, jnp.asarray(x))

    def jcall(recon, state):
        fns = {'l1': lambda r: jnp.mean(jnp.abs(r - x)), 'msspec': lambda r: msspec(r, x)}

        def group(r):
            logits, feats = disc(params, r)
            return {'adv': jax_adv.hinge_g_loss(logits),
                    'feat': jax_adv.feature_matching_loss(real_feats, feats)}
        return jax_losses.balanced_cotangent(balancer, recon, fns, state, grouped_fns=(group,))

    pdisc = _port_disc(params)
    pbal = losses.Balancer(weights=dict(jax_train_weights()))
    pmsspec = losses.MultiScaleMelSpectrogramLoss(sample_rate=32000, range_start=5, range_end=6)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        preal = pdisc(xt)[1]

    def pgroup(r):
        logits, feats = pdisc(r)
        return {'adv': adversarial.hinge_g_loss(logits),
                'feat': adversarial.feature_matching_loss(preal, feats)}

    pfns = {'l1': lambda r: (r - xt).abs().mean(), 'msspec': lambda r: pmsspec(r, xt)}
    jstate, pstate = balancer.init_state(), pbal.init_state()
    for seed in (11, 12):
        recon = (x + 0.1 * np.random.RandomState(seed).randn(*x.shape)).astype(np.float32)
        cot, jstate, metrics = jax.jit(jcall)(jnp.asarray(recon), jstate)
        pcot, pstate, pmetrics = losses.balanced_cotangent(pbal, torch.from_numpy(recon), pfns,
                                                           pstate, grouped_fns=(pgroup,))
        assert _rel(pcot, cot) < 1e-4
        for k, v in balancer_state_from_jax(_np(jstate)).items():
            assert _rel(pstate[k], v) < 1e-4, k
        assert set(pmetrics) == set(metrics)
        for k in metrics:
            assert _rel(pmetrics[k], metrics[k]) < (1e-4 if k.endswith('_norm') else 1e-5), k


def jax_train_weights():
    return {'l1': 0.1, 'msspec': 3.0, 'adv': 4.0, 'feat': 4.0}


def test_gan_step_matches_jax(jax_codec, jax_disc):
    """One GAN step from a fresh codec (k-means on the first batch) with SGD
    on both sides: the metrics within 1e-4 relative, the balancer state and
    the EMA state within 1e-5, the gradients within 1e-4 of each tensor's
    largest JAX gradient (the discriminator's: or of its hinge parts', see
    hinge_part_scales), and both networks' parameters after the step at the
    SGD bar."""
    model, params = jax_codec
    disc, dparams = jax_disc
    g_opt, d_opt = capture_sgd(1e-2), capture_sgd(1e-2)
    balancer = jax_losses.Balancer(weights={'l1': 0.1, 'l2': 1.0, 'msspec': 3.0, 'adv': 4.0,
                                            'feat': 4.0})
    jstep = jax.jit(jax_train.make_encodec_gan_train_step(model, disc, g_opt, d_opt, balancer))
    key, x = jax.random.PRNGKey(13), _wav(4)
    gp = _grad_params(params)
    gp2, q2, g_grads, dp2, d_grads, bal2, metrics = jstep(
        gp, params['quantizer'], g_opt.init(gp), dparams, d_opt.init(dparams),
        balancer.init_state(), jnp.asarray(x), key)
    port, pdisc = _port_codec(params), _port_disc(dparams)
    d_scales = hinge_part_scales(port, pdisc, torch.from_numpy(x), _draws(key))
    pbal = losses.Balancer(weights=dict(balancer.weights))
    gs, ds = _Sgd(1e-2), _Sgd(1e-2)
    step = make_encodec_gan_train_step(port, pdisc, gs, ds, pbal)
    pbal_state = pbal.init_state()
    parts = []
    m = step(gs.init(None), ds.init(None), pbal_state, torch.from_numpy(x), draws=_draws(key),
             on_part=parts.append)
    assert parts == ['generator forward', 'discriminator update', 'balancer',
                     'generator backward', 'optimizer']
    assert set(m) == set(metrics)
    for k in metrics:
        assert _rel(m[k], metrics[k]) < 1e-4, k
    for k, v in balancer_state_from_jax(_np(bal2)).items():
        assert _rel(pbal_state[k], v) < 1e-5, k
    _check_quant_state(port, q2)
    g_names = [n for n, _ in port.named_parameters()]
    d_names = [n for n, _ in pdisc.named_parameters()]
    _check_grads(dict(zip(g_names, gs.grads)), _port_tree(port, g_grads, params), 'generator ')
    _check_grads(dict(zip(d_names, ds.grads)),
                 discriminator_state_from_jax(pdisc, _np(d_grads)), 'discriminator ', d_scales)
    ref = _port_tree(port, gp2, params)
    for n, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(), atol=2e-5, rtol=2e-4,
                                   err_msg=n)
    dref = discriminator_state_from_jax(pdisc, _np(dp2))
    for n, p in pdisc.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), dref[n].numpy(), atol=2e-5, rtol=2e-4,
                                   err_msg=n)


def _lm_batch(lm, seed=14):
    rng = np.random.RandomState(seed)
    codes = torch.from_numpy(rng.randint(0, lm.card, (2, lm.n_q, 12)).astype(np.int64))
    cond = torch.from_numpy(rng.randn(2, 3, 16).astype(np.float32))
    return codes, {'description': (cond, torch.ones(2, 3, dtype=torch.long))}


@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
def test_checkpointing_gives_the_same_gradients(compute_dtype):
    """Per-layer rematerialisation, in fp32 and under the train step's bf16
    copies of the weights, gives the gradients without it."""
    lm, _ = get_debug_musicgen_lm(device='cpu', seed=1)
    lm.requires_grad_(True)
    codes, cond = _lm_batch(lm)
    grads = {}
    for flag in (False, True):
        lm.transformer.checkpointing = flag
        loss = lm_loss(lm, codes, cond, compute_dtype=compute_dtype)
        grads[flag] = torch.autograd.grad(loss, list(lm.parameters()))
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_scan_layers_lm_carried_from_jax():
    """A JAX LM with scan_layers holds stacked transformer params; the port
    reads them and gives JAX's logits within 1e-5 relative."""
    jlm, _ = jax_builders.get_debug_musicgen_lm()
    jlm = dataclasses.replace(jlm, scan_layers=True)
    params = jax.jit(jlm.init)(jax.random.PRNGKey(15))
    params = dict(params, transformer=jlm.transformer.stack_params(params['transformer']))
    assert 'layer0' not in params['transformer']
    lm, _ = get_debug_musicgen_lm(device='cpu')
    lm.load_state_dict(lm_state_from_jax(lm, _np(params)))
    codes, cond = _lm_batch(lm)
    jcond = {'description': (jnp.asarray(cond['description'][0].numpy()),
                             jnp.asarray(cond['description'][1].numpy()))}
    ref = jax.jit(jlm.compute_predictions)(params, jnp.asarray(codes.numpy()), jcond)
    with torch.no_grad():
        out = lm.compute_predictions(codes, cond)
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(out.mask.numpy(), mask)
    assert _rel(out.logits.numpy()[mask], np.asarray(ref.logits)[mask]) < 1e-5


def test_train_state_round_trip(tmp_path):
    """A whole run's tree saves and loads in place; a template of another
    structure or shape raises."""
    lm, _ = get_debug_musicgen_lm(device='cpu', seed=2)
    opt = optim.make_optimizer('adam', 1e-3)
    params = list(lm.parameters())
    state = opt.init(params)
    gen = torch.Generator().manual_seed(3)
    for m in state.mu:
        m.normal_(generator=gen)
    state.count = 5
    bal = losses.Balancer(weights={'a': 1.0}).init_state()
    bal['a'].fill_(0.25)
    run = {'model': lm.state_dict(), 'opt': state, 'bal': bal, 'gen': gen}
    train_state.save_train_state(tmp_path, run, step=7, extra={'note': 'x'})
    expected_draw = torch.rand(3, generator=torch.Generator().set_state(gen.get_state()))
    saved = {k: v.clone() for k, v in lm.state_dict().items()}
    mu0 = [m.clone() for m in state.mu]

    lm2, _ = get_debug_musicgen_lm(device='cpu', seed=9)
    state2 = opt.init(list(lm2.parameters()))
    gen2 = torch.Generator().manual_seed(100)
    bal2 = losses.Balancer(weights={'a': 1.0}).init_state()
    run2 = {'model': lm2.state_dict(), 'opt': state2, 'bal': bal2, 'gen': gen2}
    step, extra = train_state.load_train_state(tmp_path, run2)
    assert step == 7 and extra == {'note': 'x'} and state2.count == 5
    for k, v in lm2.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for a, b in zip(state2.mu, mu0):
        assert torch.equal(a, b)
    assert float(bal2['a']) == 0.25
    assert torch.equal(torch.rand(3, generator=gen2), expected_draw)
    with pytest.raises(ValueError, match='configuration drift'):
        train_state.load_train_state(tmp_path, {'model': lm2.state_dict(), 'opt': state2})
    bad = dict(run2, bal={'a': torch.zeros(2), '_count': torch.zeros(())})
    with pytest.raises(ValueError, match='shape'):
        train_state.load_train_state(tmp_path, bad)


def _cli(capsys, *args):
    train_encodec.main(['--synthetic', '--debug', '--device', 'cpu', '--log-every', '1',
                        '--batch', '2', *args])
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith('step')]


def test_train_encodec_cli(capsys, tmp_path):
    """A data directory is refused (the data modules come later); ``--ckpt``
    exports the trained codec as a checkpoint directory holding the run's
    weights and codebooks."""
    from audiocraft_tpu_torch.ckpt.io import load_checkpoint

    with pytest.raises(NotImplementedError, match='DATA_DIR'):
        train_encodec.main(['audio_dir', '--debug', '--device', 'cpu'])
    _cli(capsys, '--steps', '1', '--save-every', '1', '--run-dir', str(tmp_path / 'run'),
         '--ckpt', str(tmp_path / 'ckpt'))
    codec, meta = load_checkpoint(tmp_path / 'ckpt', device='cpu')
    assert meta['extra'] == {'steps': 1, 'weights': 'raw'}
    paths = json.loads((tmp_path / 'run' / train_state.TRAIN_META_FILE).read_text())['paths']
    with np.load(tmp_path / 'run' / train_state.TRAIN_STATE_FILE) as run:
        for key, value in codec.state_dict().items():
            np.testing.assert_array_equal(
                value.numpy(), run[f'leaf{paths.index(f"/model/{key}"):05d}'], err_msg=key)


@pytest.mark.parametrize('adversarial', [False, True], ids=['recon', 'gan'])
def test_train_encodec_resume_equals_a_whole_run(capsys, tmp_path, adversarial):
    """``--synthetic --debug --steps 2`` prints two loss lines (with
    ``d_loss`` under ``--adversarial``); one step, then a resumed second,
    leaves the same saved run as the two steps straight, leaf for leaf."""
    extra = ['--adversarial'] if adversarial else []
    lines = _cli(capsys, '--steps', '2', '--save-every', '2', '--run-dir', str(tmp_path / 'a'),
                 '--ema-decay', '0.9', *extra)
    assert len(lines) == 2 and all('loss' in line for line in lines)
    assert all(('d_loss' in line) == adversarial for line in lines)
    _cli(capsys, '--steps', '1', '--save-every', '1', '--run-dir', str(tmp_path / 'b'),
         '--ema-decay', '0.9', *extra)
    lines = _cli(capsys, '--steps', '2', '--save-every', '1', '--run-dir', str(tmp_path / 'b'),
                 '--ema-decay', '0.9', '--resume', *extra)
    assert len(lines) == 1 and lines[0].startswith('step     1')
    with np.load(tmp_path / 'a' / train_state.TRAIN_STATE_FILE) as a, \
            np.load(tmp_path / 'b' / train_state.TRAIN_STATE_FILE) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_forward_only_kernels_refuse_grad():
    """K2, K4, K5 and K6 raise on a tensor that requires a gradient while grad
    mode is on; under no_grad they run; the LSTM's differentiable route
    gives the kernel route's output and reaches every weight."""
    gen = torch.Generator().manual_seed(16)
    x = torch.randn(5, 2, 8, generator=gen)
    w = [torch.randn(32, 8, generator=gen) * 0.2, torch.randn(32, 8, generator=gen) * 0.2,
         torch.zeros(32), torch.zeros(32)]
    with pytest.raises(RuntimeError, match='no backward'):
        lstm_layer(x.requires_grad_(True), *w)
    with pytest.raises(RuntimeError, match='no backward'):
        lstm_layer(x.detach(), w[0].requires_grad_(True), *w[1:])
    with torch.no_grad():
        lstm_layer(x, *w)
    spec = StageSpec(c_in=4, c_out=8, stride=2)
    with pytest.raises(RuntimeError, match='no backward'):
        fused_stage(torch.zeros(1, 4, 8, requires_grad=True), {'w1': torch.zeros(12, 2)}, spec)
    mono = (torch.zeros(1, 1, 16), torch.zeros(4, 1, 7, requires_grad=True), torch.zeros(4))
    with pytest.raises(RuntimeError, match='no backward'):
        banded_mono_conv(*mono)
    with pytest.raises(RuntimeError, match='no backward'):
        mono_input_conv(*mono)
    with torch.no_grad():
        assert banded_mono_conv(*mono).shape == (1, 4, 10)

    lstm = StreamableLSTM(8, num_layers=2, generator=gen).requires_grad_(True)
    y = torch.randn(2, 8, 6, generator=gen)
    with pytest.raises(RuntimeError, match='no backward'):
        lstm(y)
    with torch.no_grad():
        kernel_route = lstm(y, lstm_kernel=True)
    out = lstm(y, lstm_kernel=False)
    torch.testing.assert_close(out, kernel_route, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(out.square().sum(), list(lstm.parameters()))
    assert all(float(g.abs().max()) > 0 for g in grads)
