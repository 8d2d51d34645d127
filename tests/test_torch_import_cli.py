"""The import CLI (``apps/import_checkpoint.py``), on the CPU: reference
exports (``torch.save`` of ``{'xp.cfg': dict, 'best_state': state}``) and
``.safetensors`` files into checkpoint directories that ``get_pretrained``
serves.

The codec's export keeps its conv weights factored (``weight_g`` /
``weight_v``, as the published EnCodec exports do, v scaled per row): each
imported weight is within 4 fp32 ulps of the original at the tensor's scale
(its largest value; the norms and the scaling round on both sides), and the
codes equal the original module's.  The LM's export needs no fold: its state and greedy tokens are
the original's, bit for bit.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.apps import import_checkpoint
from audiocraft_tpu_torch.ckpt import io, loaders

GOLDENS = Path(__file__).parent / "goldens"

CODEC_CFG = {
    'compression_model': 'encodec',
    'encodec': {'autoencoder': 'seanet', 'quantizer': 'rvq', 'sample_rate': 32000,
                'channels': 1, 'causal': False, 'renormalize': False},
    'seanet': {'dimension': 32, 'channels': 1, 'n_filters': 4, 'n_residual_layers': 1,
               'ratios': [10, 8, 16], 'norm': 'weight_norm', 'encoder': {}, 'decoder': {}},
    'rvq': {'n_q': 4, 'bins': 400, 'kmeans_init': True},
}
LM_CFG = {
    'lm_model': 'transformer_lm',
    'transformer_lm': {'dim': 16, 'num_heads': 4, 'num_layers': 2, 'hidden_scale': 4,
                       'n_q': 4, 'card': 400, 'causal': True, 'norm_first': False,
                       'activation': 'relu', 'cross_attention': True,
                       'positional_embedding': 'sin'},
    'codebooks_pattern': {'modeling': 'delay', 'delay': {'delays': [0, 1, 2, 3]}},
    'conditioners': {'description': {'model': 'lut', 'lut': {'n_bins': 128, 'dim': 16,
                                                             'tokenizer': 'whitespace'}}},
    'fuser': {'cross': ['description'], 'prepend': [], 'sum': [], 'input_interpolate': []},
    'classifier_free_guidance': {'training_dropout': 0.1, 'inference_coef': 3.0},
    'dataset': {'segment_duration': 30},
}


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _factored(state):
    """Conv weights as weight norm keeps them: g the norm of each output
    row, v the weight scaled per row."""
    out = {}
    gen = torch.Generator().manual_seed(0)
    for key, w in state.items():
        if key.endswith(('conv.conv.weight', 'convtr.convtr.weight')):
            base = key[:-len('weight')]
            scale = torch.rand((w.shape[0],) + (1,) * (w.dim() - 1), generator=gen) + 0.5
            out[base + 'weight_v'] = w * scale
            out[base + 'weight_g'] = torch.linalg.vector_norm(w, dim=tuple(range(1, w.dim())),
                                                              keepdim=True)
        else:
            out[key] = w
    return out


def test_reference_exports_import_and_serve(tmp_path, capsys):
    codec = builders.get_debug_compression_model(32000, device='cpu', seed=11)
    lm, provider = builders.get_debug_musicgen_lm(device='cpu', seed=12)
    torch.save({'xp.cfg': CODEC_CFG, 'best_state': _factored(codec.state_dict())},
               tmp_path / 'compression_state_dict.bin')
    lm_state = {**lm.state_dict(),
                **{f'condition_provider.{k}': v for k, v in provider.state_dict().items()}}
    torch.save({'xp.cfg': LM_CFG, 'best_state': lm_state}, tmp_path / 'state_dict.bin')
    out = tmp_path / 'model'
    # --config and --size left at their defaults: the embedded configs win
    import_checkpoint.main(['compression', str(tmp_path / 'compression_state_dict.bin'),
                            '--out', str(out / 'compression'), '--compute-dtype', 'float32',
                            '--device', 'cpu'])
    import_checkpoint.main(['lm', str(tmp_path / 'state_dict.bin'), '--out', str(out / 'lm'),
                            '--device', 'cpu'])
    printed = capsys.readouterr()
    # 22 factored convs: 60 weights from 82 tensors
    assert 'imported 82/82 tensors' in printed.out and 'imported 51/51 tensors' in printed.out
    assert 'differs from the --config fallback' in printed.err      # 32 kHz vs debug widths
    for side in ('compression', 'lm'):
        meta = json.loads((out / side / 'config.json').read_text())
        assert meta['extra']['unmapped_keys'] == []

    mg = loaders.get_pretrained(str(out), device='cpu')
    for key, value in codec.state_dict().items():
        ours = mg.compression_model.state_dict()[key]
        if key.endswith(('conv.weight', 'convtr.weight')):  # folded: within 4 ulps at the tensor's scale
            assert float((ours - value).abs().max()) <= 4 * 2 ** -23 * float(value.abs().max())
        else:
            assert torch.equal(ours, value), key
    for key, value in {**lm.state_dict(), **{f'p.{k}': v for k, v in
                                            provider.state_dict().items()}}.items():
        ours = (mg.condition_provider.state_dict()[key[2:]] if key.startswith('p.')
                else mg.lm.state_dict()[key])
        assert torch.equal(ours, value), key

    wav = torch.from_numpy(np.random.RandomState(1).randn(2, 1, 64000).astype(np.float32) * .2)
    np.testing.assert_array_equal(mg.compression_model.encode(wav)[0].numpy(),
                                  codec.encode(wav)[0].numpy())
    cond = torch.from_numpy(np.random.RandomState(2).randn(4, 5, 16).astype(np.float32))
    tensors = {'description': (cond, torch.ones(4, 5, dtype=torch.int32))}
    kw = dict(condition_tensors=tensors, num_samples=2, max_gen_len=8, use_sampling=False)
    np.testing.assert_array_equal(mg.lm.generate(**kw).numpy(), lm.generate(**kw).numpy())


def test_safetensors_and_hf_layouts(tmp_path, capsys):
    """A raw LM state dict in a ``.safetensors`` file (the --size fallback
    builds the model), and the HF EnCodec tower of a composite snapshot with
    its ``config.json`` (``--hf-config``)."""
    safetensors_numpy = pytest.importorskip("safetensors.numpy")
    lm, provider = builders.get_debug_musicgen_lm(device='cpu', seed=13)
    state = {k: v.numpy() for k, v in lm.state_dict().items()}
    state['condition_provider.conditioners.description.output_proj.weight'] = \
        provider.conditioners['description'].output_proj.weight.numpy()
    safetensors_numpy.save_file(state, str(tmp_path / 'lm.safetensors'))
    import_checkpoint.main(['lm', str(tmp_path / 'lm.safetensors'), '--out',
                            str(tmp_path / 'lm'), '--size', 'debug', '--device', 'cpu'])
    bundle, meta = io.load_checkpoint(tmp_path / 'lm', device='cpu')
    assert meta['extra']['unmapped_keys'] == []
    for key, value in lm.state_dict().items():
        assert torch.equal(bundle['lm'].state_dict()[key], value), key
    assert torch.equal(bundle['condition_provider'].conditioners['description'].output_proj.weight,
                       provider.conditioners['description'].output_proj.weight)

    with np.load(GOLDENS / 'hf_stereo_snapshot_golden.npz') as g:
        sd = {k[3:]: g[k] for k in g.files if k.startswith('sd.')}
        (tmp_path / 'config.json').write_text(str(g['config_json']))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / 'hf.bin')
    import_checkpoint.main(['compression', str(tmp_path / 'hf.bin'), '--out',
                            str(tmp_path / 'codec'), '--hf-config', str(tmp_path / 'config.json'),
                            '--compute-dtype', 'float32', '--device', 'cpu'])
    assert 'detected the HF Transformers EnCodec layout' in capsys.readouterr().err
    codec, meta = io.load_checkpoint(tmp_path / 'codec', device='cpu')
    assert type(codec).__name__ == 'HFEncodecCompressionModel'
    assert meta['extra']['unmapped_keys'] == []
    assert codec.encode(torch.zeros(1, 1, 8000))[0].shape[1] == codec.num_codebooks


def test_train_lm_resumes_bit_for_bit_and_its_ckpt_serves(tmp_path, capsys):
    """The training CLIs' checkpoint flags: a debug LM run of 4 steps saved at
    step 2 and resumed equals the run of 4 steps straight, leaf for leaf (fp32
    on the CPU); its ``--ckpt`` directory, beside the codec that
    ``train_encodec --ckpt`` exported, serves through ``get_pretrained``."""
    from audiocraft_tpu_torch.apps import train_encodec, train_lm
    from audiocraft_tpu_torch.ckpt.train_state import TRAIN_STATE_FILE

    train_encodec.main(['--synthetic', '--debug', '--device', 'cpu', '--steps', '1',
                        '--batch', '2', '--ckpt', str(tmp_path / 'compression')])
    args = ['--debug', '--synthetic', '--device', 'cpu', '--batch', '2', '--segment', '1',
            '--log-every', '1', '--save-every', '2', '--ema-decay', '0.9',
            '--codec-ckpt', str(tmp_path / 'compression')]
    train_lm.main(args + ['--steps', '4', '--ckpt', str(tmp_path / 'whole')])
    train_lm.main(args + ['--steps', '2', '--ckpt', str(tmp_path / 'lm')])
    capsys.readouterr()
    train_lm.main(args + ['--steps', '4', '--ckpt', str(tmp_path / 'lm'), '--resume'])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ' ce ' in ln]
    assert [ln.split()[1] for ln in lines] == ['2', '3']
    for name in (TRAIN_STATE_FILE, 'state.npz'):
        with np.load(tmp_path / 'whole' / name) as a, np.load(tmp_path / 'lm' / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f'{name}: {k}')
    mg = loaders.get_pretrained(str(tmp_path), device='cpu')
    with np.load(tmp_path / 'whole' / 'state.npz') as whole:
        for key, value in mg.lm.state_dict().items():
            np.testing.assert_array_equal(value.numpy(), whole[f'lm.{key}'], err_msg=key)
    assert json.loads((tmp_path / 'lm' / 'config.json').read_text())['extra'] == \
        {'steps': 4, 'weights': 'ema'}
