"""The port's LM training path against the JAX package's, on the CPU:
``compute_predictions``, ``lm_loss``, ``make_lm_train_step`` (SGD, AdamW,
bf16 compute, gradient accumulation), the optimizers and schedules, a
2-layer LM at MusicGen-small's head width through the flash route, and the
training CLI.

Weights come from the JAX package's init and reach the port through
``ckpt/from_jax.py``; inputs are made from numpy seeds.  Tolerances: 1e-5 on
logits and losses (fp32 on both sides, only the order of sums differs);
after one SGD step, parameters at atol 2e-5 and rtol 2e-4, the JAX suite's
bar for the same comparison (tests/test_mixed_precision.py); flash-route
gradients at 2e-4 of each gradient's max-abs, the JAX suite's bar for its
flash VJP.
"""

import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from audiocraft_tpu import builders as jax_builders
from audiocraft_tpu import optim as jax_optim
from audiocraft_tpu.dist import train as jax_train
from audiocraft_tpu.ops import attention_pallas
from audiocraft_tpu_torch import optim
from audiocraft_tpu_torch.apps import train_lm
from audiocraft_tpu_torch.builders import get_debug_musicgen_lm
from audiocraft_tpu_torch.ckpt.from_jax import conditioners_state_from_jax, lm_state_from_jax
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.dist.train import lm_loss, lm_loss_and_grads, make_lm_train_step
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.patterns import DelayedPatternProvider

TEXTS = ["an upbeat tune", "slow sad strings", "drums", "a calm piano piece"]


class _Sgd:
    """Plain gradient descent, ``optax.sgd``'s update, for the step tests:
    its update is linear in the gradients, so parameter agreement bounds the
    gradient difference directly (Adam turns rounding of near-zero gradients
    into whole lr steps)."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return optim.OptState(0, [], [])

    @torch.no_grad()
    def update(self, grads, state, params):
        torch._foreach_add_(list(params), list(grads), alpha=-self.lr)
        state.count += 1


@pytest.fixture(scope='module')
def debug_pair():
    """The JAX debug MusicGen LM with its params and condition tensors, and
    the port's debug LM holding the same weights."""
    jlm, jprov = jax_builders.get_debug_musicgen_lm()
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(1)))
    cond_params = jax.tree.map(np.asarray, jprov.init(jax.random.PRNGKey(2)))
    cond = jprov.as_dict['description']
    c, m = cond(cond_params['description'], cond.tokenize(TEXTS))
    tlm, tprov = get_debug_musicgen_lm(device='cpu')
    tlm.load_state_dict(lm_state_from_jax(tlm, params), strict=True)
    tprov.load_state_dict(conditioners_state_from_jax(tprov, cond_params), strict=True)
    return jlm, params, tlm, tprov, (np.asarray(c), np.asarray(m))


def _codes(B, T, card, seed=3):
    return np.random.RandomState(seed).randint(0, card, size=(B, 4, T)).astype(np.int32)


def _jax_cond(cm, B):
    return {'description': (jnp.asarray(cm[0][:B]), jnp.asarray(cm[1][:B]))}


def _torch_cond(cm, B):
    return {'description': (torch.from_numpy(cm[0][:B].copy()),
                            torch.from_numpy(cm[1][:B].copy()))}


def _fresh(tlm, params):
    """The port LM reset to the JAX params."""
    tlm.load_state_dict(lm_state_from_jax(tlm, params), strict=True)
    return tlm


def test_provider_conditions_match_jax(debug_pair):
    _, _, _, tprov, (c, m) = debug_pair
    from audiocraft_tpu_torch.cond.attributes import ConditioningAttributes
    with torch.no_grad():
        out = tprov(tprov.tokenize([ConditioningAttributes(text={'description': t})
                                    for t in TEXTS]))
    np.testing.assert_allclose(out['description'][0].numpy(), c, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out['description'][1].numpy(), m)


def test_compute_predictions_and_loss_match_jax(debug_pair):
    jlm, params, tlm, _, cm = debug_pair
    codes = _codes(2, 12, jlm.card)
    jp = jax.tree.map(jnp.asarray, params)
    ref = jlm.compute_predictions(jp, jnp.asarray(codes), _jax_cond(cm, 2))
    with torch.no_grad():
        out = _fresh(tlm, params).compute_predictions(torch.from_numpy(codes), _torch_cond(cm, 2))
        loss = lm_loss(tlm, torch.from_numpy(codes), _torch_cond(cm, 2))
    assert out.logits.shape == (2, 4, 12, jlm.card) and out.mask.dtype == torch.bool
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits), rtol=1e-5,
                               atol=1e-5)   # NaN where the JAX package has NaN
    assert np.isnan(out.logits.numpy()).any()
    ref_loss, _ = jax_train.lm_loss(jlm, jp, jnp.asarray(codes), _jax_cond(cm, 2))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)


def test_sgd_step_matches_jax(debug_pair):
    jlm, params, tlm, _, cm = debug_pair
    codes = _codes(2, 12, jlm.card)
    opt = optax.sgd(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    new, _, metrics = jax.jit(jax_train.make_lm_train_step(jlm, opt))(
        jp, opt.init(jp), jnp.asarray(codes), _jax_cond(cm, 2))
    tlm = _fresh(tlm, params)
    sgd = _Sgd(1e-2)
    step = make_lm_train_step(tlm, sgd)
    out = step(sgd.init(list(tlm.parameters())), torch.from_numpy(codes), _torch_cond(cm, 2))
    np.testing.assert_allclose(float(out['loss']), float(metrics['loss']), rtol=1e-5)
    expect = lm_state_from_jax(tlm, jax.tree.map(np.asarray, new))
    for name, p in tlm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expect[name].numpy(), atol=2e-5, rtol=2e-4,
                                   err_msg=name)


def test_adamw_steps_match_jax(debug_pair):
    jlm, params, tlm, _, cm = debug_pair
    codes = _codes(2, 12, jlm.card, seed=4)
    sched = jax_optim.get_lr_schedule('cosine', 1e-3, warmup_steps=1, total_steps=3)
    jopt = jax_optim.make_optimizer('adamw', sched, weight_decay=0.1, max_grad_norm=1.0)
    jstep = jax.jit(jax_train.make_lm_train_step(jlm, jopt))
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = optim.make_optimizer('adamw', optim.get_lr_schedule('cosine', 1e-3, warmup_steps=1,
                                                               total_steps=3),
                                weight_decay=0.1, max_grad_norm=1.0)
    tlm = _fresh(tlm, params)
    tstep = make_lm_train_step(tlm, topt)
    ts = topt.init(list(tlm.parameters()))
    for _ in range(3):
        jp, js, jm = jstep(jp, js, jnp.asarray(codes), _jax_cond(cm, 2))
        tm = tstep(ts, torch.from_numpy(codes), _torch_cond(cm, 2))
        np.testing.assert_allclose(float(tm['loss']), float(jm['loss']), rtol=1e-5)
    assert ts.count == 3


def test_bf16_compute_tracks_fp32_and_keeps_fp32_masters(debug_pair):
    jlm, params, tlm, _, cm = debug_pair
    codes = torch.from_numpy(_codes(2, 12, jlm.card))
    losses = {}
    for dtype in (None, 'bfloat16'):
        tlm = _fresh(tlm, params)
        opt = optim.make_optimizer('adamw', 1e-3, betas=(0.9, 0.999), weight_decay=1e-4)
        step = make_lm_train_step(tlm, opt, compute_dtype=dtype)
        state = opt.init(list(tlm.parameters()))
        run = [float(step(state, codes, _torch_cond(cm, 2))['loss']) for _ in range(4)]
        assert all(p.dtype == torch.float32 for p in tlm.parameters())
        assert all(m.dtype == torch.float32 for m in state.mu + state.nu)
        assert np.isfinite(run).all() and run[-1] < run[0]
        losses[dtype] = run
    assert abs(losses['bfloat16'][0] - losses[None][0]) < 0.02 * abs(losses[None][0])


def test_grad_accum_matches_full_batch(debug_pair):
    jlm, params, tlm, _, cm = debug_pair
    codes = torch.from_numpy(_codes(4, 12, jlm.card))
    out = {}
    for accum in (1, 2, 4):
        tlm = _fresh(tlm, params)
        sgd = _Sgd(1e-2)
        loss = make_lm_train_step(tlm, sgd, grad_accum=accum)(
            sgd.init([]), codes, _torch_cond(cm, 4))['loss']
        out[accum] = (float(loss), {k: v.clone() for k, v in tlm.state_dict().items()})
    for accum in (2, 4):
        np.testing.assert_allclose(out[accum][0], out[1][0], rtol=1e-5)
        for name, p in out[accum][1].items():
            np.testing.assert_allclose(p.numpy(), out[1][1][name].numpy(), atol=2e-5,
                                       rtol=2e-4, err_msg=name)


@pytest.mark.parametrize('name,kw', [
    ('cosine', dict(warmup_steps=3, total_steps=10, lr_min_ratio=0.1)),
    ('inverse_sqrt', dict(warmup_steps=4)),
    ('polynomial', dict(warmup_steps=2, total_steps=9, end_lr=1e-5, power=2.0)),
    ('linear_warmup', dict(warmup_steps=5)),
    ('constant', {}),
])
def test_schedules_match_jax(name, kw):
    ours = optim.get_lr_schedule(name, 3e-4, **kw)
    ref = jax_optim.get_lr_schedule(name, 3e-4, **kw)
    for step in range(14):
        a = ours(step) if callable(ours) else ours
        b = float(ref(step)) if callable(ref) else ref
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f'{name} step {step}')
    with pytest.raises(ValueError):
        optim.get_lr_schedule('nope', 1.0)


@pytest.mark.parametrize('name,weight_decay,max_norm', [
    ('adam', 0.0, None), ('adamw', 0.1, None), ('adamw', 0.1, 0.5), ('adamw', 0.0, 1e3)])
def test_optimizer_updates_match_optax(name, weight_decay, max_norm):
    rng = np.random.RandomState(5)
    shapes = [(7, 3), (11,), (2, 2, 5)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(3)]
    lr = jax_optim.cosine_schedule(1e-2, 1, 3)
    jopt = jax_optim.make_optimizer(name, lr, betas=(0.9, 0.95), weight_decay=weight_decay,
                                    max_grad_norm=max_norm)
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init(jp)
    topt = optim.make_optimizer(name, optim.cosine_schedule(1e-2, 1, 3), betas=(0.9, 0.95),
                                weight_decay=weight_decay, max_grad_norm=max_norm)
    tp_ = [torch.from_numpy(p.copy()) for p in params]
    ts = topt.init(tp_)
    for g in grads:
        updates, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        topt.update([torch.from_numpy(x) for x in g], ts, tp_)
    for a, b in zip(tp_, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_clipping_and_ema():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]        # global norm 13
    np.testing.assert_allclose(torch.cat(optim.clip_by_global_norm(g, 1.0)).numpy(),
                               np.array([3.0, 4.0, 12.0]) / 13, rtol=1e-6)
    assert torch.equal(torch.cat(optim.clip_by_global_norm(g, 20.0)), torch.cat(g))
    ema, p = [torch.ones(3), torch.tensor([1])], [torch.zeros(3), torch.tensor([5])]
    optim.ema_update(ema, p, 0.9)
    np.testing.assert_allclose(ema[0].numpy(), 0.9, rtol=1e-6)
    assert int(ema[1]) == 5
    ref = jax_optim.ema_update({'a': jnp.ones(3)}, {'a': jnp.zeros(3)}, 0.9)
    np.testing.assert_allclose(ema[0].numpy(), np.asarray(ref['a']), rtol=1e-7)


def test_flash_route_loss_and_grads_match_jax_at_musicgen_head_width(monkeypatch):
    """MusicGen-small's flags and head width (64), cut to dim 128, 2 heads,
    2 layers, card 64: the JAX flash route (Pallas forward and VJP under the
    interpreter) against the port's kernel route, which on the CPU is the
    plain version differentiated by autograd."""
    monkeypatch.setattr(attention_pallas, 'INTERPRET', True)
    full, _ = jax_builders.get_musicgen_lm('small')
    jlm = dataclasses.replace(full, dim=128, num_heads=2, num_layers=2, card=64,
                              attn_kernel=True)
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(6)))
    fuse = {'cross': ('description',)}
    tlm = LMModel(ConditionFuser.from_dict(fuse), n_q=4, card=64, dim=128, num_heads=2,
                  num_layers=2, hidden_scale=4, norm_first=True, bias_proj=False, bias_ff=False,
                  bias_attn=False, cross_attention=True, causal=True, weight_init='gaussian',
                  attn_kernel='auto', pattern_provider=DelayedPatternProvider(4))
    tlm.load_state_dict(lm_state_from_jax(tlm, params), strict=True)
    tlm.requires_grad_(True)
    rng = np.random.RandomState(7)
    codes = rng.randint(0, 64, (2, 4, 20)).astype(np.int32)
    cond = rng.randn(2, 5, 128).astype(np.float32)
    mask = np.ones((2, 5), np.int32)
    mask[1, 3:] = 0
    cond *= mask[..., None]

    # jitted, as the training step runs it: one compiled graph instead of
    # the interpreter's eager dispatch of every operation
    loss_and_grads = jax.jit(jax.value_and_grad(functools.partial(jax_train.lm_loss, jlm),
                                                has_aux=True))
    with pltpu.force_tpu_interpret_mode():
        (ref_loss, _), ref_grads = loss_and_grads(
            jax.tree.map(jnp.asarray, params), jnp.asarray(codes),
            {'description': (jnp.asarray(cond), jnp.asarray(mask))})
    loss, grads = lm_loss_and_grads(
        tlm, torch.from_numpy(codes),
        {'description': (torch.from_numpy(cond), torch.from_numpy(mask))})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    expect = lm_state_from_jax(tlm, jax.tree.map(np.asarray, ref_grads))
    names = [n for n, _ in tlm.named_parameters()]
    assert any('self_attn.in_proj_weight' in n for n in names)
    for name, g in zip(names, grads):
        ref = expect[name].numpy()
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=2e-4 * scale, err_msg=name)


def test_cli_trains_two_steps_on_the_cpu(capsys):
    train_lm.main(['--debug', '--synthetic', '--steps', '2', '--device', 'cpu'])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ' ce ' in ln]
    assert len(lines) == 2 and lines[0].startswith('step     0')
    assert all(np.isfinite(float(ln.split(' ce ')[1].split()[0])) for ln in lines)


@pytest.mark.parametrize('flag, error', [
    (['no_such_data_dir'], ValueError), (['--codec-ckpt', 'no_such_dir'], FileNotFoundError),
    (['no_such_data_dir', '--ckpt', 'x'], ValueError), (['--resume'], SystemExit),
    (['--save-every', '2'], SystemExit)], ids=[f'flag{i}' for i in range(5)])
def test_cli_refuses_what_waits_for_later_modules(flag, error):
    """A DATA_DIR without audio (``data/audio_dataset.py`` finds no file), a
    missing codec checkpoint, and --resume or --save-every without --ckpt,
    are refused."""
    with pytest.raises(error):
        train_lm.main(['--debug', '--device', 'cpu', *flag])
