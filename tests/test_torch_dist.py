"""The port's data-parallel training over two gloo processes on the CPU,
against the JAX package's global-view steps on a 2-device mesh of the
virtual CPU devices (``tests/conftest.py`` forces 8).

Each test (the two LM tests share one run) writes its inputs, starts two
ranks of this file as a script (``python tests/test_torch_dist.py TASK DIR
RANK PORT``), each of which joins a gloo group over ``tcp://127.0.0.1``,
runs its half of the batch and writes what it holds; the test joins them
under its own timeout (the suite does not depend on ``pytest-timeout``),
kills them and fails if they do not end.  The JAX codec's and the GAN
step's discriminator's params are the port's seeded init in JAX's tree
(``test_torch_codec_train.jax_tree_from_port``).

* The codec step and the GAN step (SGD, from a fresh codec: k-means over
  the gathered rows, ``'effective'`` expiry) against JAX's step with the
  batch sharded over the mesh: the codes of both halves equal JAX's, the
  EMA state within 1e-5 (the tolerance of tests/test_distributed.py), the
  gradients the optimizers are given (the codec's, and the discriminator's
  in the GAN step) within 1e-4 of each tensor's largest JAX gradient, the
  parameters at the SGD bar of tests/test_mixed_precision.py (atol 2e-5,
  rtol 2e-4), the balancer state and the metrics within 1e-4 relative (the
  balancer's feature-matching kink, see test_torch_codec_train.py), and
  both ranks' states and gradients equal bit for bit.
* The codebooks after k-means and ``'effective'`` expiry with the ranks'
  own identically seeded generators: equal on both ranks, bit for bit, and
  to one process's on the whole batch within 1e-5.
* ``make_lm_train_step`` with the group and ``grad_accum`` 1 and 2 against
  the same step without a group on the whole batch in one process (SGD;
  params within 1e-6), as tests/test_distributed.py holds JAX's.
"""

import copy
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 2
TIMEOUT_S = 240
CODEC = dict(n_filters=4, dimension=32, n_q=4, bins=64)
B, SAMPLES = 4, 6400       # the global batch: 2 clips a rank, 10 frames each
DISC = dict(filters=4, n_ffts=(256, 128), hop_lengths=(64, 32), win_lengths=(256, 128))
WEIGHTS = {'l1': 0.1, 'l2': 1.0, 'msspec': 3.0, 'adv': 4.0, 'feat': 4.0}
LR = 1e-2


class Sgd:
    """``optax.sgd``'s update, in place, keeping the gradients it was given."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        from audiocraft_tpu_torch.optim import OptState
        return OptState(0, [], [])

    @torch.no_grad()
    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        torch._foreach_add_(list(params), list(grads), alpha=-self.lr)
        state.count += 1


def _named_grads(module, opt):
    return {n: g for (n, _), g in zip(module.named_parameters(), opt.grads)}


def _capture_sgd(lr):
    """``optax.sgd(lr)`` whose state after an update is the gradients."""
    import jax
    import jax.numpy as jnp
    import optax
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(lambda t: -lr * t, g), g))


def _port_codec():
    from audiocraft_tpu_torch.builders import get_encodec_32khz
    return get_encodec_32khz(compute_dtype=None, device='cpu', **CODEC)


def _port_disc():
    from audiocraft_tpu_torch.adversarial import MultiScaleSTFTDiscriminator
    return MultiScaleSTFTDiscriminator(**DISC, generator=torch.Generator().manual_seed(8))


def _tiny_lm():
    from audiocraft_tpu_torch.cond.fuser import ConditionFuser
    from audiocraft_tpu_torch.lm.model import LMModel
    from audiocraft_tpu_torch.patterns import DelayedPatternProvider
    return LMModel(ConditionFuser({'cross': ('description',)}), n_q=4, card=64, dim=32,
                   num_heads=4, num_layers=2, cross_attention=True, causal=True,
                   norm_first=True, pattern_provider=DelayedPatternProvider(4),
                   generator=torch.Generator().manual_seed(0))


def _quant_state(model):
    layers = [layer._codebook for layer in model.quantizer.vq.layers]
    return {n: torch.stack([getattr(cb, n) for cb in layers]).clone()
            for n in ('embed', 'cluster_size', 'embed_avg', 'inited')}


# ------------------------------------------------------------------- the ranks


def _rank_main(task: str, folder: str, rank: int, port: int) -> None:
    import copy

    import torch.distributed as dist

    from audiocraft_tpu_torch.dist import mesh
    from audiocraft_tpu_torch.dist.train import (make_encodec_gan_train_step,
                                                 make_encodec_train_step,
                                                 make_lm_train_step)
    from audiocraft_tpu_torch.losses import Balancer

    torch.set_num_threads(1)
    group = mesh.make_data_group('gloo', f'tcp://127.0.0.1:{port}', WORLD, rank)
    inputs = torch.load(Path(folder) / 'inputs.pt')
    out = {}
    if task in ('codec', 'gan', 'codebooks'):
        model = _port_codec()
        model.load_state_dict(inputs['codec'])
        x = mesh.shard_batch(inputs['x'], group)
    if task == 'codec':
        probe = copy.deepcopy(model)
        out['codes'] = probe(x, training=True, draws=inputs['draws'], group=group,
                             expiry='effective').codes
        opt = Sgd(LR)
        out['metrics'] = make_encodec_train_step(model, opt, group=group)(
            opt.init(None), x, draws=inputs['draws'])
        out['grads'] = _named_grads(model, opt)
    elif task == 'gan':
        disc = _port_disc()
        disc.load_state_dict(inputs['disc'])
        balancer = Balancer(weights=dict(WEIGHTS))
        bal = balancer.init_state()
        g_opt, d_opt = Sgd(LR), Sgd(LR)
        step = make_encodec_gan_train_step(model, disc, g_opt, d_opt, balancer, group=group)
        out['metrics'] = step(g_opt.init(None), d_opt.init(None), bal, x, draws=inputs['draws'])
        out['grads'] = _named_grads(model, g_opt)
        out['d_grads'] = _named_grads(disc, d_opt)
        out['disc'] = disc.state_dict()
        out['bal'] = bal
    elif task == 'codebooks':
        gen = torch.Generator().manual_seed(5)
        for xi in (x, x.flip(-1)):
            model(xi, training=True, generator=gen, group=group, expiry='effective')
    elif task == 'lm':
        cond = {'description': tuple(mesh.shard_batch(t, group) for t in inputs['cond'])}
        for accum in inputs['grad_accum']:     # each from the same weights
            lm = _tiny_lm()
            lm.load_state_dict(inputs['lm'])
            opt = Sgd(LR)
            step = make_lm_train_step(lm, opt, grad_accum=accum, group=group)
            out[accum] = {'metrics': step(opt.init(None), mesh.shard_batch(inputs['codes'], group),
                                          cond),
                          'lm': lm.state_dict()}
    if task in ('codec', 'gan', 'codebooks'):
        out['params'] = {n: p.detach().clone() for n, p in model.named_parameters()}
        out['quant'] = _quant_state(model)
    torch.save(out, Path(folder) / f'rank{rank}.pt')
    dist.barrier()
    dist.destroy_process_group()


# -------------------------------------------------------------------- the tests


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _run_ranks(task: str, folder: Path, inputs: dict) -> list:
    torch.save(inputs, folder / 'inputs.pt')
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, __file__, task, str(folder), str(r), str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors='replace'))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f'{task}: the ranks did not end within {TIMEOUT_S} s')
    for r, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f'{task} rank {r} failed:\n{text[-4000:]}'
    return [torch.load(folder / f'rank{r}.pt') for r in range(WORLD)]


@pytest.fixture(scope='module')
def jax_side():
    """JAX, the thin codec and its params (the port's seeded init in JAX's
    tree, ``test_torch_codec_train.jax_tree_from_port``), the mesh's
    shardings and the global batch."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from audiocraft_tpu import builders as jax_builders
    from audiocraft_tpu.dist.mesh import make_mesh
    from audiocraft_tpu_torch.ckpt.from_jax import encodec_state_from_jax
    from test_torch_codec_train import jax_tree_from_port

    model = jax_builders.get_encodec_32khz(compute_dtype=None, **CODEC)
    port = _port_codec()
    params = jax_tree_from_port(model.init, port.state_dict(),
                                functools.partial(encodec_state_from_jax, port))
    mesh = make_mesh(n_data=WORLD, n_model=1, devices=jax.devices()[:WORLD])
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P('data'))
    x = (np.random.RandomState(0).randn(B, 1, SAMPLES) * 0.1).astype(np.float32)
    return jax, jnp, model, params, repl, data, x


def _port_inputs(model, params):
    from audiocraft_tpu_torch.ckpt.from_jax import encodec_state_from_jax
    port = _port_codec()
    return port, encodec_state_from_jax(port, params)


def _draws(jax, key):
    from test_torch_quant_train import jax_rows
    return [jax_rows(k, B * 10, CODEC['bins']) for k in jax.random.split(key, CODEC['n_q'])]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _same_on_ranks(ranks, key):
    for name, t in ranks[0][key].items():
        assert torch.equal(t, ranks[1][key][name]), f'{key}/{name} differs between ranks'


def _check_quant(rank0, jstate):
    for n in ('embed', 'cluster_size', 'embed_avg'):
        np.testing.assert_allclose(rank0['quant'][n].numpy(), np.asarray(getattr(jstate, n)),
                                   rtol=1e-5, atol=1e-5, err_msg=n)
    assert bool((rank0['quant']['inited'] == 1).all())


def _port_tree(port, jtree, params):
    """A JAX param or gradient tree of the codec under the port's names."""
    from audiocraft_tpu_torch.ckpt.from_jax import encodec_state_from_jax
    full = dict(jtree)
    full['quantizer'] = params['quantizer']
    return encodec_state_from_jax(port, full)


def _check_params(port, rank0, jparams, params):
    ref = _port_tree(port, jparams, params)
    for n, p in rank0['params'].items():
        np.testing.assert_allclose(p.numpy(), ref[n].numpy(), atol=2e-5, rtol=2e-4, err_msg=n)


def _check_grads(got, ref, label, scales=None):
    """Every tensor within 1e-4 of its largest JAX gradient, or of
    ``scales[name]`` where that is larger (the discriminator's hinge parts,
    ``test_torch_codec_train.hinge_part_scales``): a gradient averaged where
    it should be summed over the ranks is off by half."""
    assert set(got) <= set(ref), label
    for n, g in got.items():
        scale = max(float(ref[n].abs().max()), 0.0 if scales is None else scales[n])
        err = float((g - ref[n]).abs().max())
        assert err <= 1e-4 * scale, f'{label} {n}: {err:.3g} > 1e-4 x {scale:.3g}'


def test_dp_codec_step_matches_jax_mesh(tmp_path, jax_side):
    from audiocraft_tpu.dist import train as jax_train

    jax, jnp, model, params, repl, data, x = jax_side
    key = jax.random.PRNGKey(1)
    xs = jax.device_put(jnp.asarray(x), data)
    res, _ = jax.jit(lambda p, xx: model.forward(p, xx, key=key, training=True,
                                                 expiry='effective'))(
        jax.device_put(params, repl), xs)
    opt = _capture_sgd(LR)
    gp = {k: v for k, v in params.items() if k != 'quantizer'}
    gp2, q2, grads, metrics = jax.jit(jax_train.make_encodec_train_step(model, opt))(
        jax.device_put(gp, repl), jax.device_put(params['quantizer'], repl),
        jax.device_put(opt.init(gp), repl), xs, key)
    port, state = _port_inputs(model, params)
    ranks = _run_ranks('codec', tmp_path, {'codec': state, 'x': torch.from_numpy(x),
                                           'draws': _draws(jax, key)})
    codes = torch.cat([r['codes'] for r in ranks]).numpy()
    np.testing.assert_array_equal(codes, np.asarray(res.codes))
    for name in ('loss', 'l1', 'l2', 'penalty'):
        assert _rel(ranks[0]['metrics'][name], metrics[name]) < 1e-5, name
    _same_on_ranks(ranks, 'quant')
    _same_on_ranks(ranks, 'params')
    _same_on_ranks(ranks, 'grads')
    _check_quant(ranks[0], q2)
    _check_grads(ranks[0]['grads'], _port_tree(port, jax.tree.map(np.asarray, grads), params),
                 'codec')
    _check_params(port, ranks[0], jax.tree.map(np.asarray, gp2), params)


def test_dp_gan_step_matches_jax_mesh(tmp_path, jax_side):
    from audiocraft_tpu import adversarial as jax_adv
    from audiocraft_tpu import losses as jax_losses
    from audiocraft_tpu.dist import train as jax_train
    from audiocraft_tpu_torch.ckpt.from_jax import (balancer_state_from_jax,
                                                    discriminator_state_from_jax)

    from test_torch_codec_train import hinge_part_scales, jax_tree_from_port

    jax, jnp, model, params, repl, data, x = jax_side
    disc = jax_adv.MultiScaleSTFTDiscriminator(**DISC)
    pdisc = _port_disc()
    dparams = jax_tree_from_port(disc.init, pdisc.state_dict(),
                                 lambda tree: discriminator_state_from_jax(pdisc, tree))
    balancer = jax_losses.Balancer(weights=dict(WEIGHTS))
    g_opt, d_opt = _capture_sgd(LR), _capture_sgd(LR)
    key = jax.random.PRNGKey(2)
    gp = {k: v for k, v in params.items() if k != 'quantizer'}
    step = jax.jit(jax_train.make_encodec_gan_train_step(model, disc, g_opt, d_opt, balancer))
    put = lambda t: jax.device_put(t, repl)
    gp2, q2, g_grads, dp2, d_grads, bal2, metrics = step(
        put(gp), put(params['quantizer']), put(g_opt.init(gp)), put(dparams),
        put(d_opt.init(dparams)), put(balancer.init_state()),
        jax.device_put(jnp.asarray(x), data), key)
    port, state = _port_inputs(model, params)
    port.load_state_dict(state)
    d_scales = hinge_part_scales(port, pdisc, torch.from_numpy(x), _draws(jax, key))
    ranks = _run_ranks('gan', tmp_path, {
        'codec': state, 'disc': pdisc.state_dict(),
        'x': torch.from_numpy(x), 'draws': _draws(jax, key)})
    for key_ in ('quant', 'params', 'disc', 'bal', 'grads', 'd_grads'):
        _same_on_ranks(ranks, key_)
    assert set(ranks[0]['metrics']) == set(metrics)
    for name in metrics:
        assert _rel(ranks[0]['metrics'][name], metrics[name]) < 1e-4, name
    for name, v in balancer_state_from_jax(jax.tree.map(np.asarray, bal2)).items():
        assert _rel(ranks[0]['bal'][name], v) < 1e-4, name
    _check_quant(ranks[0], q2)
    _check_grads(ranks[0]['grads'],
                 _port_tree(port, jax.tree.map(np.asarray, g_grads), params), 'generator')
    _check_grads(ranks[0]['d_grads'],
                 discriminator_state_from_jax(pdisc, jax.tree.map(np.asarray, d_grads)),
                 'discriminator', d_scales)
    _check_params(port, ranks[0], jax.tree.map(np.asarray, gp2), params)
    dref = discriminator_state_from_jax(pdisc, jax.tree.map(np.asarray, dp2))
    for n, p in ranks[0]['disc'].items():
        np.testing.assert_allclose(p.numpy(), dref[n].numpy(), atol=2e-5, rtol=2e-4, err_msg=n)


def test_dp_codebooks_identical_on_ranks(tmp_path):
    """k-means on the first batch and 'effective' expiry on the second, each
    rank drawing from its own generator of the same seed."""
    x = torch.from_numpy((np.random.RandomState(3).randn(B, 1, SAMPLES) * 0.1)
                         .astype(np.float32))
    model = _port_codec()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    ranks = _run_ranks('codebooks', tmp_path, {'codec': state, 'x': x})
    _same_on_ranks(ranks, 'quant')
    assert bool((ranks[0]['quant']['inited'] == 1).all())
    gen = torch.Generator().manual_seed(5)
    for xi in (x, x.flip(-1)):
        model(xi, training=True, generator=gen, expiry='effective')
    for n, t in _quant_state(model).items():
        np.testing.assert_allclose(ranks[0]['quant'][n].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)


LM_ACCUMS = (1, 2)


@pytest.fixture(scope='module')
def lm_case(tmp_path_factory):
    """The LM, its batch and what the ranks hold after the data-parallel
    step with each of LM_ACCUMS (one start of the ranks runs both)."""
    lm = _tiny_lm()
    rng = np.random.RandomState(4)
    codes = torch.from_numpy(rng.randint(0, 64, (8, 4, 6)).astype(np.int64))
    cond = (torch.from_numpy(rng.randn(8, 3, 32).astype(np.float32)),
            torch.ones(8, 3, dtype=torch.long))
    state = {k: v.clone() for k, v in lm.state_dict().items()}
    ranks = _run_ranks('lm', tmp_path_factory.mktemp('lm'),
                       {'lm': state, 'codes': codes, 'cond': cond, 'grad_accum': LM_ACCUMS})
    return lm, codes, cond, ranks


def _check_lm(lm_case, grad_accum):
    from audiocraft_tpu_torch.dist.train import make_lm_train_step

    lm, codes, cond, ranks = lm_case
    lm = copy.deepcopy(lm)
    opt = Sgd(LR)
    metrics = make_lm_train_step(lm, opt)(opt.init(None), codes, {'description': cond})
    ranks = [r[grad_accum] for r in ranks]
    _same_on_ranks(ranks, 'lm')
    assert abs(float(ranks[0]['metrics']['loss']) - float(metrics['loss'])) < 1e-6
    for n, t in lm.state_dict().items():
        np.testing.assert_allclose(ranks[0]['lm'][n].numpy(), t.numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=n)


def test_lm_dp_step_matches_one_process(lm_case):
    _check_lm(lm_case, 1)


def test_lm_dp_step_with_accumulation_matches_one_process(lm_case):
    _check_lm(lm_case, 2)


if __name__ == '__main__':
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
