"""The configuration files build what the port's builders build: the same
parameters and buffers under the same names and shapes, and the same
settings, for facebook/encodec_32khz (``builders.get_encodec_32khz()``) and
facebook/musicgen-small (``builders.get_musicgen('small')``).  Both are
built on the meta device, without weights."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import models, spec

META = torch.device('meta')


def _shapes(module: torch.nn.Module):
    return {k: (tuple(v.shape), v.dtype) for k, v in module.state_dict().items()}


def _builder(name: str):
    from audiocraft_tpu_torch import builders
    from audiocraft_tpu_torch.nn import init
    with init.allocate_only(META):
        if name == 'encodec_32khz':
            return builders.get_encodec_32khz(device=META)
        return builders.get_musicgen('small', device=META)


def test_encodec_32khz_is_the_builders():
    got = models.build_codec(spec.config('encodec_32khz'), META)
    want = _builder('encodec_32khz')
    assert _shapes(got) == _shapes(want)
    for attr in ('frame_rate', 'sample_rate', 'channels', 'compute_dtype', 'causal'):
        assert getattr(got, attr) == getattr(want, attr), attr
    for attr in ('ratios', 'n_filters', 'dimension', 'lstm', 'norm', 'n_residual_layers'):
        assert getattr(got.encoder, attr) == getattr(want.encoder, attr), attr


def test_musicgen_small_is_the_builders():
    got = models.build_musicgen(spec.config('musicgen_small'), META)
    want = _builder('musicgen_small')
    for a, b in ((got.lm, want.lm), (got.compression_model, want.compression_model),
                 (got.condition_provider, want.condition_provider)):
        assert _shapes(a) == _shapes(b)
    for attr in ('dim', 'num_heads', 'num_layers', 'hidden_scale', 'n_q', 'card', 'norm_first',
                 'bias_proj', 'bias_ff', 'bias_attn', 'cross_attention', 'causal', 'activation',
                 'positional_embedding', 'weight_init', 'attn_kernel'):
        assert getattr(got.lm, attr) == getattr(want.lm, attr), attr
    assert got.lm.pattern_provider.delays == want.lm.pattern_provider.delays
    assert got.lm.fuser.fuse2cond == want.lm.fuser.fuse2cond
    assert got.max_duration == want.max_duration and got.decode_dtype == want.decode_dtype
    t5_got = got.condition_provider.conditioners['description'].t5_config
    t5_want = want.condition_provider.conditioners['description'].t5_config
    assert t5_got == t5_want


@pytest.mark.parametrize('name', ['encodec_32khz', 'musicgen_small'])
def test_every_tensor_has_a_weight_rule(name):
    from portbench.harness.weights import _rule
    cfg = spec.config(name)
    model = (models.build_codec(cfg, META) if cfg['kind'] == 'encodec'
             else models.build_musicgen(cfg, META))
    for key in models.state_shapes(model):
        _rule(key, cfg['assumed']['weights'])


def test_seeded_state_is_the_same_for_a_seed_and_differs_between_seeds():
    from portbench.harness.weights import seeded_state
    rules = spec.config('encodec_32khz')['assumed']['weights']
    shapes = {'a.conv.conv.weight': torch.Size([8, 4, 3]), 'a.conv.conv.bias': torch.Size([8])}
    big = 2 ** 31 + 12345
    one = seeded_state(shapes, rules, big, torch.device('cpu'))
    two = seeded_state(shapes, rules, big, torch.device('cpu'))
    other = seeded_state(shapes, rules, big + 1, torch.device('cpu'))
    assert all(torch.equal(one[k], two[k]) for k in shapes)
    assert not torch.equal(one['a.conv.conv.weight'], other['a.conv.conv.weight'])
    std = float(one['a.conv.conv.weight'].std())
    assert 0.5 * 0.577 / 12 ** 0.5 < std < 2 * 0.577 / 12 ** 0.5
