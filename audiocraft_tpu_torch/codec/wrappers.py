"""Codec wrappers over the CompressionModel contract
(counterpart of ``audiocraft_tpu/codec/wrappers.py``).

* :class:`HFEncodecCompressionModel` builds the port's ``EncodecModel`` from a
  HuggingFace ``transformers`` EnCodec config (the ``config.json`` of
  facebook/encodec_24khz and facebook/encodec_32khz: the architecture is
  EnCodec's) and maps an HF state dict onto the port's reference names,
  folding weight norm (:meth:`~HFEncodecCompressionModel.import_hf_state`).
  It is the path for published EnCodec weights.  Nothing here imports
  ``transformers``: a state dict of arrays or tensors is enough.
* :class:`DACCompressionModel` keeps the reference DAC wrapper's contract
  (codebook bookkeeping, encode and decode) over a backend given by the
  caller, since the descript-audio-codec architecture is not EnCodec.

``set_num_codebooks`` works in place, as the port's ``EncodecModel``'s does
(the JAX package returns a new wrapper).
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..ckpt.torch_import import as_array, get_conv_weight, import_lstm
from ..nn.conv import StreamableConv1d, StreamableConvTranspose1d
from ..nn.lstm import StreamableLSTM
from ..nn.seanet import SEANetDecoder, SEANetEncoder, SEANetResnetBlock
from ..quant.vq import ResidualVectorQuantizer
from .encodec import EncodecModel

StateDict = tp.Mapping[str, tp.Any]


def _hf_conv(sd: StateDict, prefix: str, ours: str, norm: bool) -> tp.Dict[str, np.ndarray]:
    """An HF conv at ``prefix`` (one ``.conv`` level) at the port's ``ours``
    (``conv.conv`` or ``convtr.convtr``), with its GroupNorm when ``norm``."""
    out = {f'{ours}.weight': get_conv_weight(sd, f'{prefix}.conv')}
    if f'{prefix}.conv.bias' in sd:
        out[f'{ours}.bias'] = as_array(sd[f'{prefix}.conv.bias'])
    if norm:
        out['conv.norm.weight'] = as_array(sd[f'{prefix}.norm.weight'])
        out['conv.norm.bias'] = as_array(sd[f'{prefix}.norm.bias'])
    return out


def import_hf_seanet(stack: torch.nn.Module, sd: StateDict, prefix: str
                     ) -> tp.Dict[str, np.ndarray]:
    """An HF encoder or decoder (``{prefix}.layers.{i}``) at the port's names
    (``{prefix}.model.{i}``): HF numbers the same layer sequence, activations
    included, so the indices line up.  A transposed conv takes no GroupNorm,
    as in the JAX package."""
    out: tp.Dict[str, np.ndarray] = {}

    def put(base: str, params: tp.Dict[str, np.ndarray]) -> None:
        out.update({f'{base}.{k}': v for k, v in params.items()})

    for i, layer in enumerate(stack.model):
        key, base = f'{prefix}.layers.{i}', f'{prefix}.model.{i}'
        if isinstance(layer, StreamableConv1d):
            put(base, _hf_conv(sd, key, 'conv.conv', layer.norm == 'time_group_norm'))
        elif isinstance(layer, StreamableConvTranspose1d):
            put(base, _hf_conv(sd, key, 'convtr.convtr', False))
        elif isinstance(layer, SEANetResnetBlock):
            for j, conv in enumerate(layer.block):
                if isinstance(conv, StreamableConv1d):   # HF: convs at odd indices
                    put(f'{base}.block.{j}', _hf_conv(sd, f'{key}.block.{j}', 'conv.conv',
                                                      conv.norm == 'time_group_norm'))
            if layer.shortcut is not None:
                put(f'{base}.shortcut', _hf_conv(sd, f'{key}.shortcut', 'conv.conv',
                                                 layer.shortcut.norm == 'time_group_norm'))
        elif isinstance(layer, StreamableLSTM):
            put(base, import_lstm(sd, key, layer.num_layers))
    return out


def import_hf_rvq(sd: StateDict, n_q: int, prefix: str = 'quantizer'
                  ) -> tp.Dict[str, np.ndarray]:
    """HF quantizer buffers ``quantizer.layers.{q}.codebook.*`` at the port's
    ``quantizer.vq.layers.{q}._codebook.*``."""
    out = {}
    for q in range(n_q):
        theirs, ours = f'{prefix}.layers.{q}.codebook', f'quantizer.vq.layers.{q}._codebook'
        for name in ('embed', 'cluster_size', 'embed_avg'):
            out[f'{ours}.{name}'] = as_array(sd[f'{theirs}.{name}'])
        inited = f'{theirs}.inited'
        out[f'{ours}.inited'] = (as_array(sd[inited]).reshape(1) if inited in sd
                                 else np.ones(1, np.float32))
    return out


class HFEncodecCompressionModel(torch.nn.Module):
    """The CompressionModel contract over an EnCodec built from an HF config;
    ``model`` is the port's ``EncodecModel``."""

    def __init__(self, model: EncodecModel, target_bandwidths: tp.Sequence[float]):
        super().__init__()
        self.model = model
        self.target_bandwidths = tuple(target_bandwidths)

    @classmethod
    def from_hf_config(cls, cfg: tp.Mapping[str, tp.Any],
                       compute_dtype: tp.Optional[str] = None, *,
                       device: tp.Union[str, torch.device, None] = None,
                       seed: int = 0) -> 'HFEncodecCompressionModel':
        """Build from an HF ``EncodecConfig`` mapping, with random weights from
        ``seed`` (load real ones with :meth:`import_hf_state`).
        ``compute_dtype`` ('bfloat16') runs the conv and LSTM stacks in bf16;
        None keeps fp32.  ``device=None`` is the CUDA card."""
        from ..builders import _finish, resolve_device

        device = resolve_device(device)
        get = cfg.get
        ratios = tuple(get('upsampling_ratios', (8, 5, 4, 2)))
        common = dict(
            channels=get('audio_channels', 1), dimension=get('hidden_size', 128),
            n_filters=get('num_filters', 32), n_residual_layers=get('num_residual_layers', 1),
            ratios=ratios,
            norm='weight_norm' if get('norm_type', 'weight_norm') == 'weight_norm'
            else 'time_group_norm',
            kernel_size=get('kernel_size', 7), last_kernel_size=get('last_kernel_size', 7),
            residual_kernel_size=get('residual_kernel_size', 3),
            dilation_base=get('dilation_growth_rate', 2), causal=get('use_causal_conv', True),
            pad_mode=get('pad_mode', 'reflect'), compress=get('compress', 2),
            lstm=get('num_lstm_layers', 2),
            # HF's use_conv_shortcut is SEANet's true_skip inverted
            true_skip=not get('use_conv_shortcut', True))
        sample_rate = get('sampling_rate', 24000)
        frame_rate = sample_rate / int(np.prod(ratios))
        card = get('codebook_size', 1024)
        bandwidths = tuple(get('target_bandwidths', (6.0,)))
        max_n_q = int(round(max(bandwidths) * 1000 / (frame_rate * math.log2(card))))
        codebook_dim = get('codebook_dim', None) or common['dimension']
        if codebook_dim != common['dimension']:
            raise ValueError('codebook projections are not supported (EnCodec checkpoints '
                             'use none)')
        gen = torch.Generator().manual_seed(seed)
        model = EncodecModel(
            SEANetEncoder(**common, generator=gen),
            SEANetDecoder(**common, trim_right_ratio=get('trim_right_ratio', 1.0),
                          generator=gen),
            ResidualVectorQuantizer(dimension=codebook_dim, n_q=max_n_q, bins=card,
                                    generator=gen),
            frame_rate=frame_rate, sample_rate=sample_rate, channels=common['channels'],
            causal=common['causal'], renormalize=get('normalize', False),
            compute_dtype=compute_dtype)
        return _finish(cls(model, bandwidths), device)

    def import_hf_state(self, sd: StateDict) -> tp.Dict[str, torch.Tensor]:
        """An HF ``EncodecModel.state_dict()`` (arrays or tensors) as a state
        dict of :attr:`model`: ``wrapper.model.load_state_dict(...)``."""
        out = {**import_hf_seanet(self.model.encoder, sd, 'encoder'),
               **import_hf_seanet(self.model.decoder, sd, 'decoder'),
               **import_hf_rvq(sd, self.model.quantizer.max_n_q)}
        return {k: torch.from_numpy(v) for k, v in out.items()}

    @property
    def possible_num_codebooks(self) -> tp.List[int]:
        """Codebooks of each target bandwidth."""
        counts = [bw * 1000 / (self.frame_rate * math.log2(self.cardinality))
                  for bw in self.target_bandwidths]
        if any(abs(n - round(n)) > 1e-3 for n in counts):
            raise ValueError(f'bandwidths {self.target_bandwidths} give fractional codebook '
                             f'counts {counts}')
        return [int(round(n)) for n in counts]

    @property
    def channels(self) -> int:
        return self.model.channels

    @property
    def frame_rate(self) -> float:
        return self.model.frame_rate

    @property
    def sample_rate(self) -> int:
        return self.model.sample_rate

    @property
    def cardinality(self) -> int:
        return self.model.cardinality

    @property
    def num_codebooks(self) -> int:
        return self.model.num_codebooks

    @property
    def total_codebooks(self) -> int:
        return max(self.possible_num_codebooks)

    def set_num_codebooks(self, n: int) -> None:
        if n not in self.possible_num_codebooks:
            raise ValueError(f'allowed values for num codebooks: {self.possible_num_codebooks}')
        self.model.set_num_codebooks(n)

    def encode(self, x: torch.Tensor, **kw) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        return self.model.encode(x, **kw)

    def decode(self, codes: torch.Tensor, scale: tp.Optional[torch.Tensor] = None,
               **kw) -> torch.Tensor:
        return self.model.decode(codes, scale, **kw)

    def decode_latent(self, codes: torch.Tensor) -> torch.Tensor:
        return self.model.decode_latent(codes)


class DACBackend(tp.Protocol):
    """What a DAC implementation provides (the surface the reference wrapper
    reads from ``dac.utils.load_model``)."""
    sample_rate: int
    hop_length: int
    codebook_size: int
    n_codebooks: int

    def encode(self, x: torch.Tensor) -> torch.Tensor: ...         # [B, 1, T] -> [B, K, F]
    def decode_latent(self, codes: torch.Tensor) -> torch.Tensor: ...
    def decode(self, z_q: torch.Tensor) -> torch.Tensor: ...       # -> waveform


class DACCompressionModel:
    """The CompressionModel contract over a DAC ``backend``: the active
    codebooks (``n_quantizers``, 0 for all) clamp the codes, and decode
    chains ``decode_latent`` into the backend's ``decode``."""

    def __init__(self, backend: DACBackend, n_quantizers: int = 0):
        self.backend = backend
        self.n_quantizers = 0
        self.set_num_codebooks(n_quantizers or self.total_codebooks)

    def encode(self, x: torch.Tensor) -> tp.Tuple[torch.Tensor, None]:
        return self.backend.encode(x)[:, :self.n_quantizers], None

    def decode(self, codes: torch.Tensor, scale: None = None) -> torch.Tensor:
        if scale is not None:
            raise ValueError('DAC has no scale')
        return self.backend.decode(self.decode_latent(codes))

    def decode_latent(self, codes: torch.Tensor) -> torch.Tensor:
        return self.backend.decode_latent(codes)

    @property
    def channels(self) -> int:
        return 1

    @property
    def frame_rate(self) -> float:
        return self.backend.sample_rate / self.backend.hop_length

    @property
    def sample_rate(self) -> int:
        return self.backend.sample_rate

    @property
    def cardinality(self) -> int:
        return self.backend.codebook_size

    @property
    def num_codebooks(self) -> int:
        return self.n_quantizers

    @property
    def total_codebooks(self) -> int:
        return self.backend.n_codebooks

    def set_num_codebooks(self, n: int) -> None:
        if not 1 <= n <= self.total_codebooks:
            raise ValueError(f'n={n} is outside [1, {self.total_codebooks}]')
        self.n_quantizers = n
