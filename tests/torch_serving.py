"""Checkpoint directories of the debug MusicGen facades, written by the JAX
package's ``save_checkpoint`` for the serving tests
(``test_torch_serve.py``, ``test_torch_apps_media.py``) to load in both
packages by the same name.

The weights are the port's seeded debug modules (``get_debug_musicgen`` or
``get_debug_melody_musicgen``) carried into JAX's params by JAX's own
importers, which saves JAX's eager init (about 15 s a facade here).
"""

from pathlib import Path

import numpy as np

from audiocraft_tpu import builders as jax_builders
from audiocraft_tpu.ckpt import io as jax_io
from audiocraft_tpu.ckpt import torch_import as jax_import
from audiocraft_tpu.cond.chroma_cond import ChromaConditioner as JaxChroma
from audiocraft_tpu.cond.conditioners import ConditioningProvider as JaxProvider
from audiocraft_tpu.cond.conditioners import LUTConditioner as JaxLUT
from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
from audiocraft_tpu.lm.model import LMModel as JaxLM
from audiocraft_tpu.patterns import DelayedPatternProvider as JaxDelayed
from audiocraft_tpu_torch.gen.musicgen import get_debug_melody_musicgen, get_debug_musicgen


def _np(module, prefix=''):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


def _jax_debug_melody_lm():
    provider = JaxProvider.from_dict({
        'description': JaxLUT(n_bins=128, dim=16, output_dim=16, tokenizer='whitespace'),
        'self_wav': JaxChroma(output_dim=16, sample_rate=32000, n_chroma=4, radix2_exp=12,
                              duration=5.0)})
    lm = JaxLM(pattern_provider=JaxDelayed(4), fuser=JaxFuser.from_dict(
        {'cross': ('description',), 'prepend': ('self_wav',)}), n_q=4, card=400, dim=16,
        num_heads=4, num_layers=2, cross_attention=True, causal=True, norm_first=False,
        activation='relu')
    return lm, provider


def write_debug_musicgen(root: Path, seed: int, melody: bool = False) -> str:
    """The port's debug (or debug melody) facade from ``seed``, written by
    JAX under ``root``; returns the directory's name as both packages'
    loaders take it."""
    build = get_debug_melody_musicgen if melody else get_debug_musicgen
    mg = build(device='cpu', seed=seed)
    jcodec = jax_builders.get_debug_compression_model(32000)
    jlm, jprovider = _jax_debug_melody_lm() if melody else jax_builders.get_debug_musicgen_lm()
    root.mkdir(parents=True, exist_ok=True)
    jax_io.save_checkpoint(root / 'compression', jcodec,
                           jax_import.import_encodec(jcodec, _np(mg.compression_model)))
    cond = jax_import.import_conditioners(jprovider, _np(mg.condition_provider,
                                                         'condition_provider.'))
    assert set(cond) == set(mg.condition_provider.conditioners)
    jax_io.save_checkpoint(root / 'lm', {'lm': jlm, 'condition_provider': jprovider},
                           {'lm': jax_import.import_lm(jlm, _np(mg.lm)),
                            'condition_provider': cond})
    return str(root)


def tones(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Three seeded sines and a little noise, [1, T] float32."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    x = 0.2 * np.sin(2 * np.pi * (110 + 900 * rng.rand(3, 1)) * t).sum(0)
    return (x + 0.02 * rng.randn(t.size))[None].astype(np.float32)
