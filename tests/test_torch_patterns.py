"""The port's codebook patterns against the JAX package's, on the CPU:
layouts, the build and revert gathers and the logits revert with its NaN
fill, equal exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocraft_tpu import patterns as jax_patterns
from audiocraft_tpu_torch import patterns

PROVIDERS = [
    ('DelayedPatternProvider', {}),
    ('DelayedPatternProvider', {'delays': [0, 2, 4, 6]}),
    ('DelayedPatternProvider', {'flatten_first': 2, 'empty_initial': 3}),
    ('ParallelPatternProvider', {}),
    ('UnrolledPatternProvider', {}),
    ('UnrolledPatternProvider', {'flattening': [0, 1, 1, 2], 'delays': [0, 1, 1, 3]}),
    ('CoarseFirstPattern', {}),
    ('CoarseFirstPattern', {'delays': [0, 1, 2]}),
    ('MusicLMPattern', {}),
]
IDS = [f'{name}-{i}' for i, (name, _) in enumerate(PROVIDERS)]


def _pair(name, kwargs, T, n_q=4):
    return (getattr(jax_patterns, name)(n_q, **kwargs).get_pattern(T),
            getattr(patterns, name)(n_q, **kwargs).get_pattern(T))


@pytest.mark.parametrize('name,kwargs', PROVIDERS, ids=IDS)
@pytest.mark.parametrize('T', [1, 7, 16])
def test_layout_matches_jax(name, kwargs, T):
    ref, ours = _pair(name, kwargs, T)
    assert [[tuple(c) for c in step] for step in ours.layout] == \
        [[tuple(c) for c in step] for step in ref.layout]
    assert ours.max_delay == ref.max_delay
    assert ours.num_sequence_steps == ref.num_sequence_steps
    assert len(ours.valid_layout) == len(ref.valid_layout)
    assert ours.get_steps_with_timestep(T - 1) == ref.get_steps_with_timestep(T - 1)


@pytest.mark.parametrize('name,kwargs', PROVIDERS, ids=IDS)
@pytest.mark.parametrize('T', [5, 12])
@pytest.mark.parametrize('valid', [False, True])
def test_build_and_revert_match_jax(name, kwargs, T, valid):
    ref, ours = _pair(name, kwargs, T)
    rng = np.random.RandomState(T)
    z = rng.randint(0, 100, (2, 4, T)).astype(np.int64)
    v_ref, i_ref, m_ref = ref.build_pattern_sequence(jnp.asarray(z), 999, valid)
    v, i, m = ours.build_pattern_sequence(torch.from_numpy(z), 999, valid)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(m, m_ref)

    back_ref, bi_ref, bm_ref = ref.revert_pattern_sequence(v_ref, 999, valid)
    back, bi, bm = ours.revert_pattern_sequence(v, 999, valid)
    np.testing.assert_array_equal(back.numpy(), np.asarray(back_ref))
    np.testing.assert_array_equal(bi, bi_ref)
    np.testing.assert_array_equal(bm, bm_ref)

    S = v.shape[-1]
    logits = rng.randn(2, 3, 4, S).astype(np.float32)
    l_ref, li_ref, lm_ref = ref.revert_pattern_logits(jnp.asarray(logits), float('nan'), valid)
    out, li, lm = ours.revert_pattern_logits(torch.from_numpy(logits), float('nan'), valid)
    np.testing.assert_array_equal(out.numpy(), np.asarray(l_ref))   # NaN where JAX has NaN
    np.testing.assert_array_equal(li, li_ref)
    np.testing.assert_array_equal(lm, lm_ref)


def test_training_pattern_at_thirty_seconds():
    """MusicGen's delay pattern at T = 1500 frames (30 s at 50 Hz): S = 1501
    sequence steps with keep_only_valid_steps, as in the JAX package."""
    T = 1500
    ref, ours = _pair('DelayedPatternProvider', {}, T)
    z = np.random.RandomState(0).randint(0, 2048, (1, 4, T)).astype(np.int64)
    v, i, m = ours.build_pattern_sequence(torch.from_numpy(z), 2048, True)
    v_ref, _, _ = ref.build_pattern_sequence(jnp.asarray(z), 2048, True)
    assert v.shape == (1, 4, 1501)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    assert (v[0, :, 0] == 2048).all()          # the special-token step


def test_get_pattern_provider_and_errors():
    assert isinstance(patterns.get_pattern_provider('delay', 4),
                      patterns.DelayedPatternProvider)
    assert patterns.get_pattern_provider('musiclm', 4, group_by=2).group_by == 2
    with pytest.raises(ValueError):
        patterns.DelayedPatternProvider(4, delays=[2, 1, 0, 3])
    pattern = patterns.DelayedPatternProvider(4).get_pattern(6)
    with pytest.raises(ValueError):
        pattern.build_pattern_sequence(torch.zeros(1, 3, 6, dtype=torch.long), 0)
