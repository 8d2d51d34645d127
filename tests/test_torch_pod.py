"""The port's time-parallel pod tokenization (``dist/pod.py``) over three
gloo processes on the CPU, against the JAX package's ``pod_encode`` on the
8-device CPU mesh (``tests/conftest.py``) and the port's own whole-signal
``encode`` / ``decode``.

The codec is tests/test_pod_encode.py's (the 32 kHz topology at 8 filters,
dimension 32, 4 codebooks of 64, with its 2-layer LSTM), causal and not:
the port's seeded init with codebooks seeded from its latents
(``chip_smoke.seed_codebooks``), carried into JAX's tree
(``test_torch_codec_train.jax_tree_from_port``).  One start of the ranks
(``python tests/test_torch_pod.py TASK DIR RANK PORT``, through
``tests/torch_ranks.py``) runs every case.

* At a length of ``hop * 24 * 4`` (a multiple of ``hop * 3`` and of
  ``hop * 8``, so that neither side pads) the codes of every rank equal
  JAX's pod codes and the port's ``encode``, exactly.
* A ragged length equals the port's ``encode`` of the signal zero-padded to
  a multiple of ``hop * 3``.
* ``pod_decode`` gives every rank the whole waveform within 1e-6 of
  ``decode`` (of the codes zero-padded to a multiple of 3 frames).
* One process (``group=None``) equals ``encode`` too; a renormalizing
  codec, ``time_group_norm`` in the front and too few frames a shard are
  refused.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 3
CODEC = dict(n_filters=8, dimension=32, n_q=4, bins=64)
HOP = 640
T_EVEN = HOP * 24 * 4            # 96 frames: 32 a rank, 12 a JAX shard
T_RAGGED = HOP * 24 * 2 + 1234   # padded to 51 frames: 17 a rank
FRAMES, FRAMES_RAGGED = 3 * 16, 3 * 16 + 2


def _port_codec(causal: bool):
    from audiocraft_tpu_torch.builders import get_encodec_32khz
    return get_encodec_32khz(causal=causal, compute_dtype=None, device='cpu', **CODEC)


def _signal(seed: int, samples: int) -> torch.Tensor:
    return torch.from_numpy((np.random.RandomState(seed).randn(2, 1, samples) * 0.3)
                            .astype(np.float32))


# ------------------------------------------------------------------- the ranks

def _rank_main() -> None:
    from audiocraft_tpu_torch.dist import mesh
    from audiocraft_tpu_torch.dist.pod import pod_decode, pod_encode

    from torch_ranks import finish_rank, rank_args

    task, folder, rank, port = rank_args()
    torch.set_num_threads(1)
    group = mesh.make_data_group('gloo', f'tcp://127.0.0.1:{port}', WORLD, rank)
    inputs = torch.load(folder / 'inputs.pt')
    out = {}
    for causal in (False, True):
        model = _port_codec(causal)
        model.load_state_dict(inputs[causal]['codec'])
        out[causal] = {name: pod_encode(model, inputs[key], group)
                       for name, key in (('even', 'x_even'), ('ragged', 'x_ragged'))}
        out[causal].update({name: pod_decode(model, c, group) for name, c in (
            ('wav', inputs['codes']), ('wav_ragged', inputs['codes_ragged']))})
    finish_rank(folder, rank, out)


# -------------------------------------------------------------------- the tests

@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pod_case(tmp_path_factory):
    """Each codec with JAX's pod codes, and what the ranks hold."""
    import jax
    import jax.numpy as jnp

    from audiocraft_tpu import builders as jax_builders
    from audiocraft_tpu.dist.mesh import make_mesh
    from audiocraft_tpu.dist.pod import pod_encode as jax_pod_encode
    from audiocraft_tpu_torch.ckpt.from_jax import encodec_state_from_jax
    from chip_smoke import seed_codebooks

    from test_torch_codec_train import jax_tree_from_port
    from torch_ranks import run_ranks

    x_even, x_ragged = _signal(1, T_EVEN), _signal(2, T_RAGGED)
    rng = np.random.RandomState(3)
    codes = torch.from_numpy(rng.randint(0, 64, (2, 4, FRAMES)).astype(np.int64))
    codes_ragged = torch.from_numpy(rng.randint(0, 64, (2, 4, FRAMES_RAGGED)).astype(np.int64))
    mesh = make_mesh(n_data=8)
    models, inputs, jax_codes = {}, {}, {}
    for causal in (False, True):
        model = _port_codec(causal)
        seed_codebooks(model, x_even, seed=4)
        jmodel = jax_builders.get_encodec_32khz(causal=causal, compute_dtype=None, **CODEC)
        params = jax_tree_from_port(jmodel.init, model.state_dict(),
                                    functools.partial(encodec_state_from_jax, model))
        jax_codes[causal] = np.asarray(jax.jit(  # eager it takes 10x as long
            lambda p, a: jax_pod_encode(jmodel, p, a, mesh))(params, jnp.asarray(x_even.numpy())))
        models[causal] = model
        inputs[causal] = {'codec': {k: v.clone() for k, v in model.state_dict().items()}}
    inputs.update(x_even=x_even, x_ragged=x_ragged, codes=codes, codes_ragged=codes_ragged)
    ranks = run_ranks(__file__, 'pod', tmp_path_factory.mktemp('pod'), inputs, WORLD)
    return models, inputs, jax_codes, ranks


def _padded(x: torch.Tensor, multiple: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, -x.shape[-1] % multiple))


@pytest.mark.parametrize("causal", [False, True])
def test_pod_encode_equals_jax_pod_and_encode(pod_case, causal):
    models, inputs, jax_codes, ranks = pod_case
    ref, _ = models[causal].encode(inputs['x_even'])
    assert jax_codes[causal].shape == tuple(ref.shape) == (2, 4, T_EVEN // HOP)
    for r in ranks:
        np.testing.assert_array_equal(r[causal]['even'].numpy(), jax_codes[causal])
        assert torch.equal(r[causal]['even'], ref)


@pytest.mark.parametrize("causal", [False, True])
def test_pod_encode_pads_a_ragged_length(pod_case, causal):
    models, inputs, _, ranks = pod_case
    ref, _ = models[causal].encode(_padded(inputs['x_ragged'], HOP * WORLD))
    assert ref.shape[-1] == 51
    for r in ranks:
        assert torch.equal(r[causal]['ragged'], ref)


@pytest.mark.parametrize("causal", [False, True])
def test_pod_decode_equals_decode(pod_case, causal):
    models, inputs, _, ranks = pod_case
    for name, codes in (('wav', inputs['codes']), ('wav_ragged', inputs['codes_ragged'])):
        ref = models[causal].decode(_padded(codes, WORLD))
        for r in ranks:
            assert r[causal][name].shape == ref.shape
            np.testing.assert_allclose(r[causal][name].numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_one_process_and_refusals(pod_case):
    from audiocraft_tpu_torch.dist.pod import pod_decode, pod_encode
    from audiocraft_tpu_torch.nn.seanet import SEANetEncoder

    models, inputs, _, _ = pod_case
    model = models[False]
    x = inputs['x_ragged']
    assert torch.equal(pod_encode(model, x), model.encode(_padded(x, HOP))[0])
    np.testing.assert_allclose(pod_decode(model, inputs['codes']).numpy(),
                               model.decode(inputs['codes']).numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match='frames a shard'):
        pod_encode(model, x[..., :HOP * 3])
    renorm = _port_codec(False)
    renorm.renormalize = True
    with pytest.raises(ValueError, match='renormalize'):
        pod_encode(renorm, x)
    with pytest.raises(ValueError, match='renormalize'):
        pod_decode(renorm, inputs['codes'])
    tgn = _port_codec(False)
    tgn.encoder = SEANetEncoder(channels=1, dimension=32, n_filters=8, n_residual_layers=1,
                                ratios=(8, 5, 4, 4), norm='time_group_norm', lstm=2)
    with pytest.raises(ValueError, match='time_group_norm'):
        pod_encode(tgn, x)


if __name__ == '__main__':
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    _rank_main()
