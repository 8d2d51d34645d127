"""EnCodec compression model: tokenize and reconstruct
(counterpart of ``audiocraft_tpu/codec/encodec.py:EncodecModel``).

``encode(wav [B, C, T]) -> (codes [B, K, T_frames] int32, scale)`` and
``decode(codes) -> wav [B, C, T_frames * hop]``, the JAX package's layouts.

``compute_dtype`` ('bfloat16', or None for fp32) is the dtype of the conv and
LSTM stacks; the stored weights stay fp32 and are cast per call.  The RVQ
distances and the codebook lookup always stay fp32: token identity depends on
them.  ``lstm_kernel`` is kept for config compatibility with the JAX package
and selects nothing here: on a CUDA tensor every LSTM layer runs the
hand-written recurrence kernel at every batch size, and on a CPU tensor its
plain version.

``encode(x, fused=True)`` runs the input conv and the first two encoder
stages through the fused stage kernel (K4, ``ops/seanet.py``);
``encode(x, conv0_kernel=True)`` runs the mono input conv through K5.  Both
default to off, as in the JAX package.
"""

from __future__ import annotations

import typing as tp

import torch

from ..nn.seanet import SEANetDecoder, SEANetEncoder
from ..quant.vq import ResidualVectorQuantizer


class EncodecModel(torch.nn.Module):

    def __init__(self, encoder: SEANetEncoder, decoder: SEANetDecoder,
                 quantizer: ResidualVectorQuantizer, frame_rate: float = 50.0,
                 sample_rate: int = 32000, channels: int = 1, causal: bool = False,
                 renormalize: bool = False, compute_dtype: tp.Optional[str] = None,
                 lstm_kernel: tp.Union[bool, str] = False):
        super().__init__()
        if causal and renormalize:
            raise ValueError('Causal model does not support renormalize')
        self.encoder, self.decoder, self.quantizer = encoder, decoder, quantizer
        self.frame_rate, self.sample_rate, self.channels = frame_rate, sample_rate, channels
        self.causal, self.renormalize = causal, renormalize
        self.compute_dtype = compute_dtype
        self.lstm_kernel = lstm_kernel

    def set_num_codebooks(self, n: int) -> None:
        """Use the first ``n`` codebooks from now on (in place)."""
        if not 0 < n <= self.quantizer.max_n_q:
            raise ValueError(f"n={n} is outside [1, {self.quantizer.max_n_q}]")
        self.quantizer.n_q = n

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return x
        return x.to(getattr(torch, self.compute_dtype))

    def preprocess(self, x: torch.Tensor) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        if not self.renormalize:
            return x, None
        mono = x.mean(dim=1, keepdim=True)
        scale = 1e-8 + mono.square().mean(dim=2, keepdim=True).sqrt()
        return x / scale, scale.reshape(-1, 1)

    def postprocess(self, x: torch.Tensor,
                    scale: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        if scale is not None:
            x = x * scale.reshape(-1, 1, 1)
        return x

    @torch.no_grad()
    def encode(self, x: torch.Tensor, fused: tp.Optional[bool] = None,
               conv0_kernel: tp.Optional[bool] = None
               ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        """x [B, C, T] float -> (codes [B, K, T_frames] int32, scale).

        ``fused`` routes the encoder front end (input conv + 2 stages) through
        K4, ``conv0_kernel`` the input conv through K5; None means off."""
        if x.dim() != 3:
            raise ValueError(f"expected [B, C, T], got {tuple(x.shape)}")
        x, scale = self.preprocess(x)
        emb = self.encoder(self._cast(x), fused_stages=2 if fused else 0,
                           conv0_kernel=bool(conv0_kernel)).float()
        return self.quantizer.encode(emb), scale

    @torch.no_grad()
    def decode_latent(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T_frames] -> latent [B, D, T_frames] fp32."""
        return self.quantizer.decode(codes)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor,
               scale: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        """codes [B, K, T_frames] -> waveform [B, C, T] fp32."""
        emb = self.decode_latent(codes)
        out = self.decoder(self._cast(emb)).float()
        return self.postprocess(out, scale)
