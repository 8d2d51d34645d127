"""Model factories (counterpart of ``audiocraft_tpu/builders.py``).

Weights are random, drawn on the CPU from a ``torch.Generator`` seeded with
``seed``, so one seed gives the same weights on every device; real weights
come in through ``load_state_dict`` (see ``ckpt/from_jax.py``).

``device=None`` means the CUDA card, and raises when there is none: the
entry points never fall back to the CPU quietly.  Pass ``device='cpu'`` to run
the plain versions of the kernels on the CPU.

Models come back frozen for serving (eval mode, ``requires_grad`` off); a
trainer (``dist/train.make_lm_train_step``) turns gradients back on.

A codec's codebooks start as the JAX package's do (``kmeans_init``): zeros
with ``inited`` 0, which every row quantizes to code 0 until a training
forward runs k-means on its first batch or real weights are loaded.  The
debug codec comes warmed (:func:`get_debug_compression_model`).
"""

from __future__ import annotations

import typing as tp

import torch

from .codec.encodec import EncodecModel
from .codec.stereo import InterleaveStereoCompressionModel
from .cond.chroma_cond import ChromaConditioner
from .cond.conditioners import ConditioningProvider, LUTConditioner, T5Conditioner
from .cond.fuser import ConditionFuser
from .cond.jasco_conditioners import (ChordsEmbConditioner, DrumsConditioner,
                                      JascoConditioningProvider, MelodyConditioner)
from .cond.style_cond import StyleConditioner
from .lm.flow_matching import FlowMatchingModel
from .lm.magnet import MagnetLMModel
from .lm.model import LMModel
from .patterns import DelayedPatternProvider, ParallelPatternProvider
from .nn.demucs import HTDemucs, HTDemucsConfig
from .nn.seanet import SEANetDecoder, SEANetEncoder
from .quant.vq import ResidualVectorQuantizer


def resolve_device(device: tp.Union[str, torch.device, None]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device('cuda')
    return torch.device(device)


def _finish(model: torch.nn.Module, device: torch.device) -> tp.Any:
    return model.to(device).eval().requires_grad_(False)


def get_encodec_32khz(n_filters: int = 64, dimension: int = 128, n_q: int = 4,
                      bins: int = 2048, causal: bool = False,
                      compute_dtype: tp.Optional[str] = 'bfloat16', *,
                      device: tp.Union[str, torch.device, None] = None,
                      seed: int = 0) -> EncodecModel:
    """The MusicGen tokenizer: 32 kHz mono, hop 640, 50 Hz frames, 4 x 2048
    codebooks (facebook/encodec_32khz).  bf16 conv and LSTM stacks by default;
    ``compute_dtype=None`` gives fp32 parity."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    seanet = dict(channels=1, dimension=dimension, n_filters=n_filters,
                  n_residual_layers=1, ratios=(8, 5, 4, 4), norm='weight_norm',
                  lstm=2, causal=causal, generator=gen)
    model = EncodecModel(SEANetEncoder(**seanet), SEANetDecoder(**seanet),
                         ResidualVectorQuantizer(dimension=dimension, n_q=n_q, bins=bins,
                                                 generator=gen),
                         frame_rate=50, sample_rate=32000, channels=1, causal=causal,
                         compute_dtype=compute_dtype, lstm_kernel='auto')
    return _finish(model, device)


def get_encodec_24khz(n_filters: int = 32, dimension: int = 128, n_q: int = 8,
                      bins: int = 1024, *, device: tp.Union[str, torch.device, None] = None,
                      seed: int = 0) -> EncodecModel:
    """The causal streaming EnCodec 24 kHz config (facebook/encodec_24khz:
    hop 320, 75 Hz frames, causal convs, 8 x 1024 codebooks), fp32.  The
    fused-stage plan declines it (causal); ``conv0_kernel`` runs K5 on its
    left-padded signal."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    seanet = dict(channels=1, dimension=dimension, n_filters=n_filters,
                  n_residual_layers=1, ratios=(8, 5, 4, 2), norm='weight_norm',
                  lstm=2, causal=True, generator=gen)
    model = EncodecModel(SEANetEncoder(**seanet), SEANetDecoder(**seanet),
                         ResidualVectorQuantizer(dimension=dimension, n_q=n_q, bins=bins,
                                                 generator=gen),
                         frame_rate=75, sample_rate=24000, channels=1, causal=True)
    return _finish(model, device)


def get_debug_compression_model(sample_rate: int = 32000, *,
                                device: tp.Union[str, torch.device, None] = None,
                                seed: int = 0) -> EncodecModel:
    """Tiny codec for tests (the reference's debug compression model), its
    codebooks warmed as the JAX package's ``init_debug_compression_model``
    warms them (reference builders.py:277-278): one training forward of the
    quantizer (k-means, then an EMA step) on a seeded normal latent batch
    [8, 32, 128]."""
    if sample_rate not in (16000, 32000):
        raise ValueError(f"sample_rate must be 16000 or 32000, not {sample_rate}")
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ratios = {16000: (10, 8, 8), 32000: (10, 8, 16)}[sample_rate]
    seanet = dict(channels=1, dimension=32, n_filters=4, n_residual_layers=1,
                  ratios=ratios, generator=gen)
    model = EncodecModel(SEANetEncoder(**seanet), SEANetDecoder(**seanet),
                         ResidualVectorQuantizer(dimension=32, bins=400, n_q=4,
                                                 generator=gen),
                         frame_rate=25, sample_rate=sample_rate, channels=1)
    model.quantizer(torch.randn(8, 32, 128, generator=gen), frame_rate=1, training=True,
                    generator=gen)
    return _finish(model, device)


_MUSICGEN_SIZES = {
    # public MusicGen / MAGNeT transformer shapes (300M / 1.5B / 3.3B)
    'small': dict(dim=1024, num_layers=24, num_heads=16),
    'medium': dict(dim=1536, num_layers=48, num_heads=24),
    'large': dict(dim=2048, num_layers=48, num_heads=32),
}


def get_debug_musicgen_lm(*, device: tp.Union[str, torch.device, None] = None,
                          seed: int = 0) -> tp.Tuple[LMModel, ConditioningProvider]:
    """Debug MusicGen LM of the reference tests: dim 16, 2 layers, 4 heads,
    card 400, post-norm with ReLU, a whitespace lookup-table text
    conditioner.  Returns (lm, provider)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    provider = ConditioningProvider.from_dict({
        'description': LUTConditioner(n_bins=128, dim=16, output_dim=16, tokenizer='whitespace',
                                      generator=gen)})
    fuser = ConditionFuser.from_dict({'cross': ('description',)})
    lm = LMModel(fuser, n_q=4, card=400, dim=16, num_heads=4, num_layers=2,
                 cross_attention=True, causal=True, norm_first=False, activation='relu',
                 pattern_provider=DelayedPatternProvider(4), generator=gen)
    return _finish(lm, device), _finish(provider, device)


def get_musicgen_lm(size: str = 'small', n_q: int = 4, card: int = 2048, *,
                    melody: bool = False, style: bool = False,
                    device: tp.Union[str, torch.device, None] = None,
                    seed: int = 0) -> tp.Tuple[LMModel, ConditioningProvider]:
    """Text-to-music MusicGen LM and its T5-base text conditioning at the
    published sizes (facebook/musicgen-small, -medium, -large): causal,
    pre-norm, no biases, gaussian init, the delay pattern, cross-attention to
    the description.  ``attn_kernel='auto'`` sends every full-sequence
    self-attention (the training forward) to the flash kernels on the card.

    ``melody=True`` (musicgen-melody) adds ``self_wav``, a chroma
    conditioner (12 classes, windows of 2 ** 12, 30 s: 938 frames) fused by
    prepending; ``style=True`` (musicgen-style) makes ``self_wav`` the style
    conditioner, its own fp32 32 kHz codec as the feature extractor, also
    prepended.  The two are exclusive.  Returns (lm, provider)."""
    if melody and style:
        raise ValueError('style and melody conditioning are exclusive')
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shape = _MUSICGEN_SIZES[size]
    conditioners: tp.Dict[str, torch.nn.Module] = {
        'description': T5Conditioner(name='t5-base', output_dim=shape['dim'], generator=gen)}
    fuse: tp.Dict[str, tp.Tuple[str, ...]] = {'cross': ('description',)}
    if melody:
        conditioners['self_wav'] = ChromaConditioner(
            output_dim=shape['dim'], sample_rate=32000, n_chroma=12, radix2_exp=12,
            duration=30.0, generator=gen)
        fuse['prepend'] = ('self_wav',)
    if style:
        codec = get_encodec_32khz(compute_dtype=None, device=device, seed=seed + 1)
        conditioners['self_wav'] = StyleConditioner(
            feat_extractor=codec, output_dim=shape['dim'], sample_rate=32000, generator=gen)
        fuse['prepend'] = ('self_wav',)
    provider = ConditioningProvider.from_dict(conditioners)
    fuser = ConditionFuser.from_dict(fuse)
    lm = LMModel(
        fuser, n_q=n_q, card=card, hidden_scale=4, norm_first=True, bias_proj=False,
        bias_ff=False, bias_attn=False, cross_attention=True, causal=True, activation='gelu',
        weight_init='gaussian', depthwise_init='current', zero_bias_init=True,
        attn_kernel='auto', pattern_provider=DelayedPatternProvider(n_q), generator=gen,
        **shape)
    return _finish(lm, device), _finish(provider, device)


def get_wrapped_compression_model(compression_model: EncodecModel,
                                  interleave_stereo: bool = False, per_timestep: bool = False,
                                  n_q: tp.Optional[int] = None
                                  ) -> tp.Union[EncodecModel, InterleaveStereoCompressionModel]:
    """Optionally set the active codebook count (in place, on the codec
    given) and wrap the codec for stereo interleaving."""
    if n_q is not None:
        compression_model.set_num_codebooks(n_q)
    if interleave_stereo:
        return InterleaveStereoCompressionModel(compression_model, per_timestep=per_timestep)
    return compression_model


def get_musicgen(size: str = 'small', *, melody: bool = False, style: bool = False,
                 stereo: bool = False, device: tp.Union[str, torch.device, None] = None,
                 seed: int = 0):
    """The MusicGen facade at a published size: the 32 kHz codec (bf16) and
    :func:`get_musicgen_lm` with its T5-base conditioning, random weights
    from ``seed``; 30 s windows.  ``melody=True`` is musicgen-melody-* (the
    chroma prefix), ``style=True`` musicgen-style-* (the style prefix; its
    recipe generates with double CFG, ``cfg_coef_beta``).  ``stereo=True``
    is musicgen-stereo-*: the codec wrapped in codebook interleaving, so the
    LM models twice the codebooks (8) and the facade makes 2-channel
    audio."""
    from .gen.musicgen import MusicGen

    if melody and style:
        raise ValueError('style and melody conditioning are exclusive')
    codec: tp.Union[EncodecModel, InterleaveStereoCompressionModel] = get_encodec_32khz(
        device=device, seed=seed)
    if stereo:
        codec = get_wrapped_compression_model(codec, interleave_stereo=True)
    lm, provider = get_musicgen_lm(size, n_q=codec.num_codebooks, melody=melody, style=style,
                                   device=device, seed=seed + 1)
    variant = ('stereo-' if stereo else '') + ('melody-' if melody else '') + \
        ('style-' if style else '')
    return MusicGen(f'musicgen-{variant}{size}', codec, lm, provider, max_duration=30.0)


def get_magnet_lm(size: str = 'small', n_q: int = 4, card: int = 2048,
                  segment_duration: int = 10, *,
                  device: tp.Union[str, torch.device, None] = None,
                  seed: int = 0) -> tp.Tuple[MagnetLMModel, ConditioningProvider]:
    """MAGNeT LM and its T5-base text conditioning at the published sizes
    (facebook/magnet-small-10secs, -30secs, ...): non-causal, span 3,
    restricted subcode context 5, cross-attention to the description.
    ``attn_kernel='auto'`` sends every mask-free full-sequence self-attention
    (stage 0) to the flash kernel on the card.  Returns (lm, provider)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    shape = _MUSICGEN_SIZES[size]
    provider = ConditioningProvider.from_dict({
        'description': T5Conditioner(name='t5-base', output_dim=shape['dim'], generator=gen)})
    fuser = ConditionFuser.from_dict({'cross': ('description',)})
    lm = MagnetLMModel(
        fuser, n_q=n_q, card=card, hidden_scale=4, norm_first=True, bias_proj=False,
        bias_ff=False, bias_attn=False, cross_attention=True, causal=False,
        activation='gelu', weight_init='gaussian', depthwise_init='current',
        zero_bias_init=True, pattern_provider=ParallelPatternProvider(n_q),
        attn_kernel='auto', subcodes_context=5, span_len=3, compression_model_framerate=50,
        segment_duration=segment_duration, generator=gen, **shape)
    return _finish(lm, device), _finish(provider, device)


def get_htdemucs(cfg: tp.Optional[HTDemucsConfig] = None, *,
                 device: tp.Union[str, torch.device, None] = None, seed: int = 0) -> HTDemucs:
    """The Hybrid Transformer Demucs separator (``HTDemucsConfig()``: the
    published htdemucs, 4 stems at 44.1 kHz stereo), fp32, random weights
    from ``seed``.  A demucs state dict loads through
    ``ckpt/demucs_import.import_htdemucs``, but the decoders' transposed
    convs run its taps mirrored, as the JAX reference does, so a published
    checkpoint gives wrong stems (the importer warns).  Its ``separate`` and
    ``nn/demucs.make_stem_fn`` are the melody and drums conditioners'
    ``stem_fn``."""
    device = resolve_device(device)
    return _finish(HTDemucs(cfg or HTDemucsConfig(), torch.Generator().manual_seed(seed)),
                   device)


def get_jasco_model(compression_model: tp.Optional[EncodecModel] = None, dim: int = 512,
                    num_heads: int = 8, num_layers: int = 8, chords_dim: int = 16,
                    drums_dim: int = 16, melody_dim: int = 16, flow_dim: int = 128,
                    sequence_length: int = 500, attn_kernel: tp.Union[bool, str] = 'auto', *,
                    device: tp.Union[str, torch.device, None] = None, seed: int = 0
                    ) -> tp.Tuple[FlowMatchingModel, JascoConditioningProvider, EncodecModel]:
    """JASCO (reference builders.py:94-124, loaders.py:246-256): the flow
    model over the 32 kHz codec's latents (dim 512, 8 heads, 8 layers,
    flow_dim 128, 500 frames) with chords, drums and melody at 16 channels
    each and the T5-base description fused by cross-attention; random
    weights from ``seed``.  The drums conditioner encodes with the codec
    (``get_encodec_32khz()`` unless ``compression_model`` is given).
    ``attn_kernel='auto'`` sends the U-net's self-attention to K3f on the
    card (JAX's default, False, keeps the plain path).  Returns (model,
    provider, codec)."""
    device = resolve_device(device)
    codec = compression_model or get_encodec_32khz(device=device, seed=seed + 1)
    gen = torch.Generator().manual_seed(seed)
    provider = JascoConditioningProvider.from_dict({
        'description': T5Conditioner(name='t5-base', output_dim=dim, generator=gen),
        'chords': ChordsEmbConditioner(card=194, out_dim=chords_dim, generator=gen),
        'melody': MelodyConditioner(card=53, out_dim=melody_dim, generator=gen),
        'self_wav': DrumsConditioner(
            feat_extractor=codec, out_dim=drums_dim,
            compression_model_latent_dim=codec.quantizer.dimension, generator=gen),
    }, sequence_length=sequence_length)
    model = FlowMatchingModel(
        ConditionFuser.from_dict({'cross': ('description',)}), dim=dim, num_heads=num_heads,
        num_layers=num_layers, flow_dim=flow_dim, chords_dim=chords_dim, drums_dim=drums_dim,
        melody_dim=melody_dim, attn_kernel=attn_kernel, generator=gen)
    return _finish(model, device), _finish(provider, device), codec
