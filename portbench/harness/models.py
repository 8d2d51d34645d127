"""The program's models built from a configuration file, and their seeded
weights.

Modules are built on the device without drawing weights
(``nn/init.allocate_only``, as the port's checkpoint loader builds them),
then loaded with the seeded state dict of :mod:`.weights`; the plain
reference gets the same dict.  The construction follows
``builders.get_encodec_32khz`` and ``builders.get_musicgen``, with every
width taken from the file (``tests/test_portbench_models.py`` holds the
published configurations against those builders).
"""

from __future__ import annotations

import typing as tp

import torch

from ..reference import codec as ref_codec
from . import spec
from .audio import music_batch
from .weights import seed_codebooks, seeded_state

State = tp.Dict[str, torch.Tensor]


def build_codec(cfg: dict, device: torch.device):
    from audiocraft_tpu_torch.builders import get_encodec_32khz
    from audiocraft_tpu_torch.nn import init
    s, q = cfg['seanet'], cfg['quantizer']
    if tuple(s['ratios']) != (8, 5, 4, 4) or cfg['sample_rate'] != 32000:
        raise ValueError('the 32 kHz EnCodec builder holds ratios (8, 5, 4, 4) at 32 kHz')
    with init.allocate_only(device):
        return get_encodec_32khz(n_filters=s['n_filters'], dimension=s['dimension'],
                                 n_q=q['n_q'], bins=q['bins'], causal=s['causal'],
                                 compute_dtype=cfg['compute_dtype'], device=device)


def build_musicgen(cfg: dict, device: torch.device):
    from audiocraft_tpu_torch.builders import _finish
    from audiocraft_tpu_torch.cond.conditioners import ConditioningProvider, T5Conditioner
    from audiocraft_tpu_torch.cond.fuser import ConditionFuser
    from audiocraft_tpu_torch.gen.musicgen import MusicGen
    from audiocraft_tpu_torch.lm.model import LMModel
    from audiocraft_tpu_torch.nn import init
    from audiocraft_tpu_torch.nn.t5 import T5EncoderConfig
    from audiocraft_tpu_torch.patterns import DelayedPatternProvider

    lm_cfg, t5 = dict(cfg['lm']), dict(cfg['t5'])
    if lm_cfg.pop('pattern') != 'delay':
        raise ValueError('only the delay pattern is built')
    delays = lm_cfg.pop('delays')
    codec = build_codec(codec_cfg(cfg), device)
    with init.allocate_only(device):
        name = t5.pop('name')
        provider = ConditioningProvider.from_dict({'description': T5Conditioner(
            name=name, output_dim=lm_cfg['dim'], config=T5EncoderConfig(**t5))})
        lm = LMModel(ConditionFuser.from_dict({'cross': ('description',)}),
                     pattern_provider=DelayedPatternProvider(lm_cfg['n_q'], delays), **lm_cfg)
    lm, provider = _finish(lm, device), _finish(provider, device)
    return MusicGen(cfg['name'], codec, lm, provider, max_duration=cfg['max_duration'])


def parts(model) -> tp.Dict[str, torch.nn.Module]:
    """A model's modules by the prefix their names take in the state."""
    if isinstance(model, torch.nn.Module):
        return {'': model}
    return {'codec.': model.compression_model, 'lm.': model.lm,
            'provider.': model.condition_provider}


def codec_cfg(cfg: dict) -> dict:
    """The codec's configuration: the file itself, or the one it names."""
    if cfg['kind'] != 'musicgen':
        return cfg
    return cfg['codec'] if isinstance(cfg['codec'], dict) else spec.config(cfg['codec'])


def state_shapes(model) -> tp.Dict[str, torch.Size]:
    """The floating tensors of ``model`` under their prefixed names."""
    return {prefix + name: t.shape for prefix, module in parts(model).items()
            for name, t in module.state_dict().items() if t.is_floating_point()}


def make_state(shapes: tp.Mapping[str, torch.Size], cfg: dict, seed: int,
               device: torch.device, codebooks: tp.Optional[State] = None) -> State:
    """The seeded state under the prefixed names; the codec's codebooks are
    seeded from the plain reference's latent of seeded audio unless
    ``codebooks`` gives them (a second making of the same state)."""
    state = seeded_state(shapes, cfg['assumed']['weights'], seed, device)
    if codebooks is None:
        c = codec_cfg(cfg)
        prefix = 'codec.' if cfg['kind'] == 'musicgen' else ''
        gen = torch.Generator(device=device).manual_seed(int(seed) + 7)
        clips = music_batch(gen, c['assumed']['codebook_clips'],
                            int(c['assumed']['codebook_clip_seconds'] * c['sample_rate']),
                            c['sample_rate'], CODEBOOK_AUDIO)
        latent = ref_codec.encode_latent(component(state, prefix), c, clips)
        codebooks = seed_codebooks(latent, c['quantizer']['bins'], c['quantizer']['n_q'], seed,
                                   prefix=f'{prefix}quantizer.vq.layers')
    state.update(codebooks)
    return state


def codebooks_of(state: State) -> State:
    return {k: v.detach().clone() for k, v in state.items() if '._codebook.' in k}


def load(model, state: State) -> None:
    """Copy ``state`` into the program's modules (strictly)."""
    for prefix, module in parts(model).items():
        own = module.state_dict()
        sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
        missing = [k for k, t in own.items() if t.is_floating_point() and k not in sub]
        if missing:
            raise KeyError(f'the seeded state lacks {missing[:5]}')
        with torch.no_grad():
            for k, v in sub.items():
                own[k].copy_(v)


def component(state: State, prefix: str) -> State:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


# the clips the codebooks are seeded from
CODEBOOK_AUDIO = {'notes': 6, 'harmonics': 4, 'bursts': 2, 'midi_range': [36, 84],
                  'level_dbfs': [-20, -10]}
