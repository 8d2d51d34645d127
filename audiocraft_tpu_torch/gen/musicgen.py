"""MusicGen generation facade: text, unconditional, melody, style,
continuation, and lengths past the model's window by stride extension
(counterpart of ``audiocraft_tpu/gen/musicgen.py``).

Descriptions become conditions with the null conditions of classifier-free
guidance (1-pass, double or two-step), an audio prompt becomes tokens
through the codec (in windows above ``decode_chunk_frames``), the LM
generates tokens (on the card its decode steps replay CUDA graphs, which
this facade keeps by signature and reuses, like the JAX facade's jit cache:
at most ``DecodeCache.max_states`` (4) signatures, each holding its KV
caches at full capacity, the least recently used dropped), and the codec
decodes them (in windows above ``decode_chunk_frames``).  Beyond ``max_duration`` the stride-extension
loop generates window after window, each prompted by the last
``max_duration - extend_stride`` seconds of the one before, and hearing
the melody from its own start on (the melody re-windowed modulo its
length).

The LM decodes in bf16 on the card (a cast copy kept beside the fp32
weights, refreshed from them at every generate, so new weights are always
read) and in fp32 on the CPU, where the JAX facade decodes in bf16 on its
accelerator and in fp32 elsewhere.  The codec may be the stereo wrapper
(``codec/stereo.py``, musicgen-stereo-*): the LM then models its interleaved
codebooks, audio comes out with 2 channels, a long prompt takes the whole
encode (windows are for a plain ``EncodecModel`` only, as in the JAX
facade) and a long decode is windowed for both.

A model with a ``self_wav`` conditioner takes a melody (musicgen-melody:
chroma, ``generate_with_chroma`` and ``generate_continuation(melody_wavs=)``)
or a style clip (musicgen-style, through the same entry points; its
bottleneck tuned by ``set_style_conditioner_params``); a ``None`` melody is
a zero wav of one sample.  A model without one refuses a melody and the
style settings with ``RuntimeError``, as the JAX facade does.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..codec.chunked import chunked_decode, chunked_encode
from ..codec.encodec import EncodecModel
from ..codec.stereo import InterleaveStereoCompressionModel
from ..cond.attributes import (ClassifierFreeGuidanceDropout, ConditioningAttributes,
                               WavCondition, drop_description_condition)
from ..cond.conditioners import ConditioningProvider
from ..cond.style_cond import StyleConditioner
from ..io.audio_utils import convert_audio
from ..lm.decode import DecodeCache
from ..lm.model import LMModel
from ..lm.quantize import quantize_lm_params

Melody = tp.Union[np.ndarray, torch.Tensor]
MelodyList = tp.List[tp.Optional[Melody]]


class MusicGen:
    """Codec, LM and conditioning with the generation settings."""

    def __init__(self, name: str,
                 compression_model: tp.Union[EncodecModel, InterleaveStereoCompressionModel],
                 lm: LMModel,
                 condition_provider: ConditioningProvider, max_duration: float = 30.0,
                 duration: float = 15.0):
        self.name = name
        self.compression_model = compression_model
        self.lm = lm
        self.condition_provider = condition_provider
        self.max_duration = max_duration
        self.set_generation_params(duration=duration)
        # the LM's compute dtype on the card; fp32 on the CPU
        self.decode_dtype: tp.Optional[str] = 'bfloat16'
        # token sequences longer than this decode (and audio prompts longer
        # than this many frames encode) in windows of half of it
        self.decode_chunk_frames = 3000
        # 'int8' stores the KV caches quantized; None in the compute dtype
        self.kv_dtype: tp.Optional[str] = None
        # 'auto', a list of capacities, or None: the caches grow in segments
        self.kv_buckets: tp.Union[None, str, tp.Sequence[int]] = None
        self._progress_callback: tp.Optional[tp.Callable[[float, str], None]] = None
        # decode states (KV caches, CUDA graphs) by signature and the LM's cast copy
        self._decode_cache = DecodeCache()

    @property
    def frame_rate(self) -> float:
        return self.compression_model.frame_rate

    @property
    def sample_rate(self) -> int:
        return self.compression_model.sample_rate

    @property
    def audio_channels(self) -> int:
        return self.compression_model.channels

    @property
    def device(self) -> torch.device:
        return self.lm.emb[0].weight.device

    def set_generation_params(self, use_sampling: bool = True, top_k: int = 250,
                              top_p: float = 0.0, temperature: float = 1.0,
                              duration: float = 30.0, cfg_coef: float = 3.0,
                              cfg_coef_beta: tp.Optional[float] = None,
                              two_step_cfg: bool = False, extend_stride: float = 10.0,
                              rep_penalty: tp.Optional[float] = None) -> None:
        """The reference's generation parameters (``rep_penalty`` is accepted
        and unused, as in the JAX package)."""
        if extend_stride >= self.max_duration:
            raise ValueError("Cannot stride by more than max generation duration.")
        self.duration, self.extend_stride = duration, extend_stride
        self.use_sampling, self.top_k, self.top_p = use_sampling, top_k, top_p
        self.temperature, self.cfg_coef = temperature, cfg_coef
        self.cfg_coef_beta, self.two_step_cfg = cfg_coef_beta, two_step_cfg

    def set_custom_progress_callback(self, cb: tp.Optional[tp.Callable[[float, str], None]]
                                     ) -> None:
        self._progress_callback = cb

    def quantize_lm_weights(self, mode: str = 'int8', group_size: int = 128) -> None:
        """Weight-only quantization of the LM ('int8' per output row, or
        'int4' per input group, packed), in place and one-way; embeddings and
        norms stay floating point, logits keep fp32 sums."""
        quantize_lm_params(self.lm, mode=mode, group_size=group_size)

    def optimize_for_serving(self, weight_mode: str = 'int8',
                             kv_dtype: tp.Optional[str] = 'int8') -> None:
        """The JAX package's serving recipe in one call: int8 weights, int8
        KV caches and growing cache segments ('auto'), on top of the bf16
        decode.  One-way for the weights."""
        self.quantize_lm_weights(mode=weight_mode)
        self.kv_dtype = kv_dtype
        self.kv_buckets = 'auto'

    def set_style_conditioner_params(self, eval_q: int = 3, excerpt_length: float = 3.0,
                                     ds_factor: tp.Optional[int] = None,
                                     encodec_n_q: tp.Optional[int] = None) -> None:
        """Tune the style conditioner's bottleneck for the next generates
        (reference ``musicgen.py``:185-209), in place."""
        styles = [c for c in self.condition_provider.conditioners.values()
                  if isinstance(c, StyleConditioner)]
        if not styles:
            raise RuntimeError('set_style_conditioner_params requires a style model')
        for cond in styles:
            cond.set_params(eval_q=eval_q, excerpt_length=excerpt_length, ds_factor=ds_factor,
                            encodec_n_q=encodec_n_q)

    # ------------------------------------------------------------- prepare
    def _prepare_tokens_and_attributes(
            self, descriptions: tp.Sequence[tp.Optional[str]],
            prompt: tp.Optional[torch.Tensor], melody_wavs: tp.Optional[MelodyList] = None,
    ) -> tp.Tuple[tp.List[ConditioningAttributes], tp.Optional[torch.Tensor]]:
        attributes = [ConditioningAttributes(text={'description': d}) for d in descriptions]
        if 'self_wav' in self.condition_provider.conditioners:
            if melody_wavs is None:
                melody_wavs = [None] * len(descriptions)
            if len(melody_wavs) != len(descriptions):
                raise ValueError("Melody wavs and nb. descriptions doesn't match")
            for attr, melody in zip(attributes, melody_wavs):
                if melody is None:
                    attr.wav['self_wav'] = WavCondition(
                        np.zeros((1, 1, 1), np.float32), np.zeros(1, np.int64),
                        sample_rate=[self.sample_rate], path=[None])
                else:
                    melody = np.asarray(torch.as_tensor(melody).detach().float().cpu())
                    attr.wav['self_wav'] = WavCondition(
                        melody[None], np.asarray([melody.shape[-1]]),
                        sample_rate=[self.sample_rate], path=[None])
        elif melody_wavs is not None and any(m is not None for m in melody_wavs):
            raise RuntimeError("This model doesn't support melody conditioning. "
                               "Use the `melody` model.")
        if prompt is None:
            return attributes, None
        if len(descriptions) != prompt.shape[0]:
            raise ValueError("Prompt and nb. descriptions doesn't match")
        hop = int(self.sample_rate / self.frame_rate)
        if (prompt.shape[-1] > self.decode_chunk_frames * hop
                and isinstance(self.compression_model, EncodecModel)):
            tokens, scale = chunked_encode(self.compression_model, prompt,
                                           chunk_frames=self.decode_chunk_frames // 2)
        else:
            tokens, scale = self.compression_model.encode(prompt)
        if scale is not None:
            raise ValueError("a codec that renormalizes cannot prompt the LM")
        return attributes, tokens

    def _cfg_condition_tensors(self, attributes: tp.List[ConditioningAttributes]):
        """CFG condition groups: 1-pass [conditions; null]; double CFG
        (``cfg_coef_beta``) [conditions; text dropped; null]; two-step the
        (conditions, null) pair."""
        provider = self.condition_provider
        null_conditions = ClassifierFreeGuidanceDropout(p=1.0)(attributes)
        if self.cfg_coef_beta is not None:
            wav_conditions = drop_description_condition([a.copy() for a in attributes])
            return provider(provider.tokenize(list(attributes) + wav_conditions
                                              + null_conditions))
        if self.two_step_cfg:
            return (provider(provider.tokenize(attributes)),
                    provider(provider.tokenize(null_conditions)))
        return provider(provider.tokenize(list(attributes) + null_conditions))

    # ------------------------------------------------------------ generate
    def generate_unconditional(self, num_samples: int,
                               generator: tp.Optional[torch.Generator] = None,
                               progress: bool = False, return_tokens: bool = False):
        attributes, _ = self._prepare_tokens_and_attributes([None] * num_samples, None)
        return self._out(self._generate_tokens(attributes, None, generator, progress),
                         return_tokens)

    def generate(self, descriptions: tp.List[str], generator: tp.Optional[torch.Generator] = None,
                 progress: bool = False, return_tokens: bool = False):
        """-> audio [B, C, T] fp32 (and tokens [B, K, T_frames] when asked).
        ``generator=None`` draws a fresh seed."""
        attributes, _ = self._prepare_tokens_and_attributes(descriptions, None)
        return self._out(self._generate_tokens(attributes, None, generator, progress),
                         return_tokens)

    def _convert_melodies(self, melody_wavs: tp.Union[MelodyList, np.ndarray, torch.Tensor],
                          melody_sample_rate: int) -> MelodyList:
        """Each melody [C, T] (or a batch [B, C, T]) to mono at the model's
        rate, on the model's device."""
        if isinstance(melody_wavs, (np.ndarray, torch.Tensor)):
            if melody_wavs.ndim == 2:
                melody_wavs = melody_wavs[None]
            melody_wavs = list(melody_wavs)
        return [None if m is None else convert_audio(
            torch.as_tensor(m, dtype=torch.float32).to(self.device), melody_sample_rate,
            self.sample_rate, 1) for m in melody_wavs]

    def generate_with_chroma(self, descriptions: tp.List[tp.Optional[str]],
                             melody_wavs: tp.Union[MelodyList, np.ndarray, torch.Tensor],
                             melody_sample_rate: int,
                             generator: tp.Optional[torch.Generator] = None,
                             progress: bool = False, return_tokens: bool = False):
        """Text and melody: one melody [C, T] per description (``None`` for
        none), at ``melody_sample_rate``, converted to mono at the model's
        rate (reference ``musicgen.py``:243-280)."""
        attributes, _ = self._prepare_tokens_and_attributes(
            descriptions, None,
            melody_wavs=self._convert_melodies(melody_wavs, melody_sample_rate))
        return self._out(self._generate_tokens(attributes, None, generator, progress),
                         return_tokens)

    def generate_continuation(self, prompt: tp.Union[torch.Tensor, np.ndarray],
                              prompt_sample_rate: int,
                              descriptions: tp.Optional[tp.List[tp.Optional[str]]] = None,
                              melody_wavs: tp.Optional[MelodyList] = None,
                              melody_sample_rate: tp.Optional[int] = None,
                              generator: tp.Optional[torch.Generator] = None,
                              progress: bool = False, return_tokens: bool = False):
        """Continue an audio prompt [B, C, T] (or [C, T]) at
        ``prompt_sample_rate``, resampled and converted to the codec's;
        ``melody_wavs`` at ``melody_sample_rate`` (the prompt's rate when
        None) condition a melody model as in :meth:`generate_with_chroma`."""
        prompt = torch.as_tensor(prompt, dtype=torch.float32).to(self.device)
        if prompt.dim() == 2:
            prompt = prompt[None]
        if prompt.dim() != 3:
            raise ValueError("prompt should be [B, C, T]")
        prompt = convert_audio(prompt, prompt_sample_rate, self.sample_rate,
                               self.audio_channels)
        if descriptions is None:
            descriptions = [None] * prompt.shape[0]
        if melody_wavs is not None:
            melody_wavs = self._convert_melodies(melody_wavs,
                                                 melody_sample_rate or prompt_sample_rate)
        attributes, prompt_tokens = self._prepare_tokens_and_attributes(
            descriptions, prompt, melody_wavs=melody_wavs)
        return self._out(self._generate_tokens(attributes, prompt_tokens, generator, progress),
                         return_tokens)

    # the fork's name: melody and prompt continuation in one call
    generate_with_all = generate_continuation

    def _out(self, tokens: torch.Tensor, return_tokens: bool):
        audio = self.generate_audio(tokens)
        return (audio, tokens) if return_tokens else audio

    def generate_audio(self, gen_tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, K, T_frames] -> audio [B, C, T], in windows above
        ``decode_chunk_frames``."""
        if gen_tokens.dim() != 3:
            raise ValueError(f"expected tokens [B, K, T], got {tuple(gen_tokens.shape)}")
        if gen_tokens.shape[-1] > self.decode_chunk_frames:
            return chunked_decode(self.compression_model, gen_tokens,
                                  chunk_frames=self.decode_chunk_frames // 2)
        return self.compression_model.decode(gen_tokens)

    # ------------------------------------------------------- token engine
    def _lm_generate(self, attributes: tp.List[ConditioningAttributes],
                     prompt_tokens: tp.Optional[torch.Tensor],
                     generator: torch.Generator, max_gen_len: int) -> torch.Tensor:
        """One LM generation, in ``decode_dtype`` on the card; its decode
        states (and CUDA graphs) are kept in the facade's cache by signature
        (batch, prompt and generation lengths, sampling and CFG settings,
        dtypes, buckets) and reused."""
        return self.lm.generate(
            generator, prompt=prompt_tokens,
            condition_tensors=self._cfg_condition_tensors(attributes),
            num_samples=len(attributes), max_gen_len=max_gen_len,
            use_sampling=self.use_sampling, temp=self.temperature, top_k=self.top_k,
            top_p=self.top_p, cfg_coef=self.cfg_coef, cfg_coef_beta=self.cfg_coef_beta,
            compute_dtype=self.decode_dtype if self.device.type == 'cuda' else None,
            kv_dtype=self.kv_dtype, kv_buckets=self.kv_buckets, graph_cache=self._decode_cache)

    def _rewindow_melodies(self, attributes: tp.List[ConditioningAttributes],
                           ref_wavs: tp.List[tp.Optional[WavCondition]],
                           time_offset: float) -> None:
        """The window at ``time_offset`` seconds hears ``max_duration``
        seconds of each melody from that point, wrapping around its length
        (reference ``musicgen.py``:487-502)."""
        for attr, ref_wav in zip(attributes, ref_wavs):
            if ref_wav is None or int(ref_wav.length[0]) == 0:
                continue
            target = int(self.max_duration * self.sample_rate)
            positions = (int(time_offset * self.sample_rate) + np.arange(target)) \
                % int(ref_wav.length[0])
            attr.wav['self_wav'] = WavCondition(
                ref_wav.wav[..., positions], np.full_like(ref_wav.length, target),
                [self.sample_rate] * ref_wav.wav.shape[0], [None], [0.])

    def _generate_tokens(self, attributes: tp.List[ConditioningAttributes],
                         prompt_tokens: tp.Optional[torch.Tensor],
                         generator: tp.Optional[torch.Generator] = None,
                         progress: bool = False) -> torch.Tensor:
        if generator is None:
            generator = torch.Generator()
            generator.seed()
        total_gen_len = int(self.duration * self.frame_rate)
        max_prompt_len = int(min(self.duration, self.max_duration) * self.frame_rate)
        if prompt_tokens is not None and prompt_tokens.shape[-1] > max_prompt_len:
            raise ValueError(
                f"Prompt is longer than audio to generate: prompt covers "
                f"{prompt_tokens.shape[-1]} frames but only {max_prompt_len} frames fit the "
                f"requested duration")

        def report(done: float) -> None:
            if progress:
                print(f'{done * self.duration: 6.2f} / {self.duration: 6.2f}', end='\r')
            if self._progress_callback is not None:
                self._progress_callback(done, f"Generated {done * self.duration: 6.2f}"
                                              f"/{self.duration: 6.2f} seconds")

        if self.duration <= self.max_duration:
            tokens = self._lm_generate(attributes, prompt_tokens, generator, total_gen_len)
            report(1.0)
            return tokens

        # stride extension: each window is prompted by the end of the last
        all_tokens = []
        ref_wavs = [attr.wav.get('self_wav') for attr in attributes]
        if prompt_tokens is None:
            prompt_length = 0
        else:
            all_tokens.append(prompt_tokens)
            prompt_length = prompt_tokens.shape[-1]
        stride_tokens = int(self.frame_rate * self.extend_stride)
        current_gen_offset = 0
        while current_gen_offset + prompt_length < total_gen_len:
            time_offset = current_gen_offset / self.frame_rate
            chunk_duration = min(self.duration - time_offset, self.max_duration)
            max_gen_len = int(chunk_duration * self.frame_rate)
            self._rewindow_melodies(attributes, ref_wavs, time_offset)
            gen_tokens = self._lm_generate(attributes, prompt_tokens, generator, max_gen_len)
            if prompt_tokens is None:
                all_tokens.append(gen_tokens)
            else:
                all_tokens.append(gen_tokens[:, :, prompt_tokens.shape[-1]:])
            prompt_tokens = gen_tokens[:, :, stride_tokens:]
            prompt_length = prompt_tokens.shape[-1]
            current_gen_offset += stride_tokens
            report(min(1.0, (current_gen_offset + prompt_length) / total_gen_len))
        return torch.cat(all_tokens, dim=-1)


def get_debug_musicgen(*, device: tp.Union[str, torch.device, None] = None,
                       seed: int = 0) -> MusicGen:
    """Debug MusicGen: the debug codec, a 2-layer LM of width 16 (card 400,
    post-norm, ReLU) and a whitespace lookup-table text conditioner, 5 s
    (the reference's debug models)."""
    from ..builders import get_debug_compression_model, get_debug_musicgen_lm

    codec = get_debug_compression_model(32000, device=device, seed=seed)
    lm, provider = get_debug_musicgen_lm(device=device, seed=seed)
    return MusicGen('debug', codec, lm, provider, max_duration=30.0, duration=5.0)


def get_debug_melody_musicgen(*, device: tp.Union[str, torch.device, None] = None,
                              seed: int = 0) -> MusicGen:
    """Debug melody MusicGen: the debug MusicGen with a chroma ``self_wav``
    (4 classes, windows of 2 ** 12, 5 s) prepended beside the text's
    cross-attention, the MusicGen-melody layout (JAX
    ``get_debug_melody_musicgen``)."""
    from ..builders import _finish, get_debug_compression_model, resolve_device
    from ..cond.chroma_cond import ChromaConditioner
    from ..cond.conditioners import LUTConditioner
    from ..cond.fuser import ConditionFuser
    from ..patterns import DelayedPatternProvider

    device = resolve_device(device)
    codec = get_debug_compression_model(32000, device=device, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    provider = ConditioningProvider.from_dict({
        'description': LUTConditioner(n_bins=128, dim=16, output_dim=16, tokenizer='whitespace',
                                      generator=gen),
        'self_wav': ChromaConditioner(output_dim=16, sample_rate=32000, n_chroma=4,
                                      radix2_exp=12, duration=5.0, generator=gen)})
    fuser = ConditionFuser.from_dict({'cross': ('description',), 'prepend': ('self_wav',)})
    lm = LMModel(fuser, n_q=4, card=400, dim=16, num_heads=4, num_layers=2,
                 cross_attention=True, causal=True, norm_first=False, activation='relu',
                 pattern_provider=DelayedPatternProvider(4), generator=gen)
    return MusicGen('debug-melody', codec, _finish(lm, device), _finish(provider, device),
                    max_duration=30.0, duration=5.0)
