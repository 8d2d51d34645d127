"""The plain references against the port at debug sizes on the CPU, in
float32, where both compute the same arithmetic: the codec's encoder,
quantizer and decoder, the T5 conditioning (also at t5-base's widths over a
text long enough to reach the bucket edge at distance 64), the LM's full
forward with guidance and its first layer's keys and values, and the delay
pattern."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import models, text
from portbench.harness.audio import music_batch
from portbench.reference import codec as ref_codec
from portbench.reference import lm as ref_lm
from portbench.reference import t5 as ref_t5
from portbench.reference.precision import Precision
from portbench.tests import tiny

CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def codec():
    cfg = tiny.codec_cfg()
    model = models.build_codec(cfg, CPU)
    state = models.make_state(models.state_shapes(model), cfg, 11, CPU)
    models.load(model, state)
    wav = music_batch(torch.Generator().manual_seed(2), 3, 6400, 32000, models.CODEBOOK_AUDIO)
    return cfg, model, state, wav


@pytest.fixture(scope='module')
def musicgen():
    cfg = tiny.musicgen_cfg()
    mg = models.build_musicgen(cfg, CPU)
    state = models.make_state(models.state_shapes(mg), cfg, 13, CPU)
    models.load(mg, state)
    tokenizer = text.WordHashT5(cfg['assumed']['t5_vocab'])
    mg.condition_provider.conditioners['description'].load_tokenizer = lambda: tokenizer
    return cfg, mg, state, tokenizer


def test_encoder_latent(codec):
    cfg, model, state, wav = codec
    got = model.encode_to_latent(wav)
    want = ref_codec.encode_latent(state, cfg, wav, block=2)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_quantizer_codes(codec):
    cfg, model, state, wav = codec
    latent = model.encode_to_latent(wav)
    got = model.quantizer.encode(latent)
    want = ref_codec.rvq_encode(latent, ref_codec.codebooks(state, cfg['quantizer']['n_q']))
    assert torch.equal(got.long(), want)


def test_decoder(codec):
    cfg, model, state, wav = codec
    codes = model.encode(wav)[0]
    got = model.decode(codes)
    embeds = ref_codec.codebooks(state, cfg['quantizer']['n_q'])
    want = ref_codec.decode_latent(state, cfg, ref_codec.rvq_decode(codes, embeds))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_codebooks_spread_over_the_codes(codec):
    """Seeded codebooks, not the zeros of a fresh one (on which every frame
    takes code 0): 30 frames of seeded audio take several codes of each."""
    cfg, model, state, wav = codec
    codes = model.encode(wav)[0]
    for q in range(cfg['quantizer']['n_q']):
        assert codes[:, q].unique().numel() >= 3


@pytest.mark.parametrize('counts', [(2, 5), (1,), (6, 3, 4)])
def test_t5_condition(musicgen, counts):
    cfg, mg, state, tokenizer = musicgen
    rng = np.random.default_rng(sum(counts))
    texts = [text.description(rng, n, text.words()) for n in counts]
    cond = mg.condition_provider.conditioners['description']
    ids, mask = cond.tokenize(texts + [''] * len(texts), tokenizer=tokenizer)
    got = cond((ids, mask))[0]
    want = ref_t5.condition(models.component(state, 'provider.conditioners.description.'),
                            cfg['t5'], ids, mask)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_t5_base_width_at_the_bucket_edge():
    """t5-base's widths over 80 ids (distances up to 79 reach the bucket
    edge at 64), two layers."""
    from audiocraft_tpu_torch.cond.conditioners import T5Conditioner
    from audiocraft_tpu_torch.nn.t5 import T5EncoderConfig
    from portbench.harness import spec, weights
    cfg = dict(spec.config('musicgen_small')['t5'], num_layers=2, vocab_size=4096)
    t5 = dict(cfg)
    name = t5.pop('name')
    cond = T5Conditioner(name=name, output_dim=64, config=T5EncoderConfig(**t5)).eval()
    shapes = {k: v.shape for k, v in cond.state_dict().items()}
    state = weights.seeded_state(shapes, spec.config('musicgen_small')['assumed']['weights'],
                                 5, CPU)
    cond.load_state_dict(state)
    ids = torch.randint(2, 4000, (2, 80), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, 50:] = 0
    with torch.no_grad():
        got = cond((ids, mask))[0]
    want = ref_t5.condition(state, cfg, ids, mask)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_position_buckets_match_the_port():
    from audiocraft_tpu_torch.nn.t5 import relative_position_bucket
    pos = np.arange(130)
    want = relative_position_bucket(pos[None, :] - pos[:, None], 32, 128)
    got = ref_t5.position_buckets(130, 32, 128, CPU).numpy()
    assert np.array_equal(got, want)


def test_delay_sequence_is_the_port_pattern():
    from audiocraft_tpu_torch.patterns import DelayedPatternProvider
    codes = torch.randint(0, 32, (2, 4, 9), generator=torch.Generator().manual_seed(0))
    seq, _, mask = DelayedPatternProvider(4).get_pattern(9).build_pattern_sequence(codes, 32)
    got, valid = ref_lm.delay_sequence(codes, 32)
    assert torch.equal(got, seq)
    assert np.array_equal(valid.numpy(), np.asarray(mask))


def test_lm_forward(musicgen):
    cfg, mg, state, _ = musicgen
    lm = mg.lm
    codes = torch.randint(0, cfg['lm']['card'], (2, 4, 12),
                          generator=torch.Generator().manual_seed(3))
    seq, _ = ref_lm.delay_sequence(codes, cfg['lm']['card'])
    cond = torch.randn(2, 5, cfg['lm']['dim'], generator=torch.Generator().manual_seed(4))
    mask = torch.ones(2, 5, dtype=torch.long)
    got = lm(seq, {'description': (cond, mask)})
    want = ref_lm.forward(models.component(state, 'lm.'), cfg['lm'], seq, cond)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_first_layer_kv_is_what_the_port_caches(musicgen):
    """The keys and values the port's cached forward writes in the first
    layer, position by position, whatever the condition."""
    cfg, mg, state, _ = musicgen
    lm = mg.lm
    codes = torch.randint(0, cfg['lm']['card'], (2, 4, 12),
                          generator=torch.Generator().manual_seed(5))
    seq, _ = ref_lm.delay_sequence(codes, cfg['lm']['card'])
    cond = torch.randn(2, 5, cfg['lm']['dim'], generator=torch.Generator().manual_seed(6))
    caches = lm.transformer.init_cache(2, seq.shape[-1], torch.float32, None, CPU)
    lm.forward(seq, {'description': (cond, torch.ones(2, 5, dtype=torch.long))},
               caches=caches, first_step=True)
    got = torch.stack([caches[0].k, caches[0].v]).flatten(3)
    want = ref_lm.first_layer_kv(models.component(state, 'lm.'), cfg['lm'], seq)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_greedy_generate_has_no_gap(musicgen):
    """The port's greedy tokens (fp32 on the CPU) are the reference's argmax
    at every step, under guidance over the reference's conditioning."""
    cfg, mg, state, tokenizer = musicgen
    texts = ['warm piano ballad', 'fast drums']
    mg.set_generation_params(use_sampling=False, duration=0.3, cfg_coef=3.0)
    tokens = mg.generate(texts, generator=torch.Generator().manual_seed(0),
                         return_tokens=True)[1]
    enc = tokenizer(texts + ['', ''])
    ids, mask = torch.as_tensor(enc['input_ids']), torch.as_tensor(enc['attention_mask'])
    mask[2:] = 0
    cond = ref_t5.condition(models.component(state, 'provider.conditioners.description.'),
                            cfg['t5'], ids, mask)
    seq, valid = ref_lm.delay_sequence(tokens, cfg['lm']['card'])
    logits = ref_lm.cfg_logits(models.component(state, 'lm.'), cfg['lm'], seq, cond[:2],
                               cond[2:], 3.0)
    gaps = ref_lm.logit_gaps(logits, seq, valid)
    assert gaps.numel() == 2 * 4 * tokens.shape[-1]
    assert float(gaps.max()) <= 1e-5


def test_logit_errors_align_each_step_with_the_logits_it_was_drawn_from():
    """The logits step s was drawn from are the full forward's at s - 1; a
    shift of a whole logit vector is no error (softmax does not see it)."""
    logits = torch.randn(1, 2, 6, 5, generator=torch.Generator().manual_seed(0))
    valid = torch.ones(2, 6, dtype=torch.bool)
    drawn = torch.zeros_like(logits)
    drawn[:, :, 1:] = logits[:, :, :-1] + 3.0
    err2, scale2 = ref_lm.logit_errors(logits, drawn, valid)
    assert err2 <= 1e-10 * scale2 and scale2 > 0
    drawn[0, 1, 4, 0] += 1.0
    assert ref_lm.logit_errors(logits, drawn, valid)[0] == pytest.approx(0.8, rel=1e-5)
    valid[1, 4] = False
    assert ref_lm.logit_errors(logits, drawn, valid)[0] <= 1e-10


def test_gap_of_a_token_outside_the_vocabulary_is_infinite():
    logits = torch.zeros(1, 1, 3, 4)
    logits[..., 2] = 1.0
    seq = torch.tensor([[[4, -1, 2]]])
    valid = torch.ones(1, 3, dtype=torch.bool)
    assert ref_lm.logit_gaps(logits, seq, valid).tolist() == [[float('inf'), 0.0]]


def test_fp8_rounds_and_fp32_does_not():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(Precision('fp32').operand(x), x)
    err = float(((Precision('fp8').operand(x) - x).norm() / x.norm()))
    assert 1e-3 < err < 0.1
    err16 = float(((Precision('bf16').operand(x) - x).norm() / x.norm()))
    assert err16 < err / 4
