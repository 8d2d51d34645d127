"""MAGNeT generation facade (counterpart of ``audiocraft_tpu/gen/magnet.py``).

Text descriptions -> conditions (plus the null conditions of CFG) -> masked
parallel decode of the LM's segment -> codec decode.  Generates one fixed
segment (``lm.segment_duration`` seconds); no extension beyond it.
"""

from __future__ import annotations

import typing as tp

import torch

from ..codec.encodec import EncodecModel
from ..cond.attributes import ClassifierFreeGuidanceDropout, ConditioningAttributes
from ..cond.conditioners import ConditioningProvider
from ..lm.magnet import MagnetLMModel


class MAGNeT:

    def __init__(self, name: str, compression_model: EncodecModel, lm: MagnetLMModel,
                 condition_provider: ConditioningProvider,
                 decoding_steps: tp.Sequence[int] = (20, 10, 10, 10)):
        self.name = name
        self.compression_model = compression_model
        self.lm = lm
        self.condition_provider = condition_provider
        self.set_generation_params(decoding_steps=decoding_steps)

    @property
    def duration(self) -> float:
        return self.lm.segment_duration

    @property
    def frame_rate(self) -> float:
        return self.compression_model.frame_rate

    @property
    def sample_rate(self) -> int:
        return self.compression_model.sample_rate

    def set_generation_params(self, use_sampling: bool = True, top_k: int = 0,
                              top_p: float = 0.9, temperature: float = 3.0,
                              max_cfg_coef: float = 10.0, min_cfg_coef: float = 1.0,
                              decoding_steps: tp.Sequence[int] = (20, 10, 10, 10),
                              span_arrangement: str = 'nonoverlap') -> None:
        self.use_sampling = use_sampling
        self.top_k = top_k
        self.top_p = top_p
        self.temperature = temperature
        self.max_cfg_coef = max_cfg_coef
        self.min_cfg_coef = min_cfg_coef
        self.decoding_steps = tuple(int(s) for s in decoding_steps)
        self.span_arrangement = span_arrangement

    @torch.no_grad()
    def generate(self, descriptions: tp.List[str],
                 generator: tp.Optional[torch.Generator] = None,
                 return_tokens: bool = False):
        """-> audio [B, C, T] fp32 (and tokens [B, K, T_frames] when asked).
        ``generator=None`` draws a fresh seed."""
        if generator is None:
            generator = torch.Generator()
            generator.seed()
        attributes = [ConditioningAttributes(text={'description': d}) for d in descriptions]
        null_conditions = ClassifierFreeGuidanceDropout(p=1.0)(attributes)
        tokenized = self.condition_provider.tokenize(list(attributes) + null_conditions)
        condition_tensors = self.condition_provider(tokenized)
        tokens = self.lm.generate_magnet(
            generator, condition_tensors=condition_tensors, num_samples=len(descriptions),
            max_gen_len=int(self.duration * self.frame_rate), use_sampling=self.use_sampling,
            temp=self.temperature, top_k=self.top_k, top_p=self.top_p,
            max_cfg_coef=self.max_cfg_coef, min_cfg_coef=self.min_cfg_coef,
            decoding_steps=self.decoding_steps, span_arrangement=self.span_arrangement)
        audio = self.compression_model.decode(tokens)
        return (audio, tokens) if return_tokens else audio


def get_debug_magnet(*, device: tp.Union[str, torch.device, None] = None,
                     seed: int = 0) -> MAGNeT:
    """Tiny MAGNeT for tests: the debug codec, a 2-layer non-causal LM of
    width 16 with restricted subcode context, and a whitespace-tokenized
    lookup-table description conditioner (no vocabulary file needed)."""
    from ..builders import _finish, get_debug_compression_model, resolve_device
    from ..cond.conditioners import LUTConditioner
    from ..cond.fuser import ConditionFuser

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    codec = get_debug_compression_model(32000, device=device, seed=seed)
    dim = 16
    provider = ConditioningProvider.from_dict({
        'description': LUTConditioner(n_bins=128, dim=dim, output_dim=dim,
                                      tokenizer='whitespace', generator=gen)})
    lm = MagnetLMModel(
        ConditionFuser.from_dict({'cross': ('description',)}), n_q=4, card=400, dim=dim,
        num_heads=4, num_layers=2, cross_attention=True, causal=False, norm_first=True,
        subcodes_context=5, compression_model_framerate=int(codec.frame_rate),
        segment_duration=2, span_len=3, generator=gen)
    return MAGNeT('debug-magnet', codec, _finish(lm, device), _finish(provider, device),
                  decoding_steps=(4, 2, 2, 2))
