"""EnCodec compression model: tokenize and reconstruct
(counterpart of ``audiocraft_tpu/codec/encodec.py:EncodecModel``).

``encode(wav [B, C, T]) -> (codes [B, K, T_frames] int32, scale)`` and
``decode(codes) -> wav [B, C, T_frames * hop]``, the JAX package's layouts;
``encode_to_latent`` stops before the quantizer.  ``total_codebooks``,
``num_codebooks`` and ``cardinality`` are the CompressionModel contract's.

``compute_dtype`` ('bfloat16', or None for fp32) is the dtype of the conv and
LSTM stacks; the stored weights stay fp32 and are cast per call, and a call
may name another (``compute_dtype=torch.float32`` for the parity dtype).  In
fp32 the conv stacks run cuDNN without TF32 whatever the caller's global flag
(``nn/conv.fp32_convs``, restored after each stack), so the fp32 codec is the
parity path on the card too.  The RVQ distances and the codebook lookup
always stay fp32: token identity depends on them.  ``lstm_kernel`` of
``encode`` / ``decode`` picks the LSTM's route: None (the default) and True
run the hand-written recurrence kernel K2 on a CUDA tensor at every batch
size, one launch a layer, and its plain version on a CPU tensor; False runs
the differentiable route (``nn/lstm.lstm_stack_differentiable``).  The
model's ``lstm_kernel`` field is kept for config compatibility with the JAX
package and selects nothing.

``forward(x, training=...)`` is the JAX package's training forward
(``codec/encodec.py``:217-263): the module stack (``fused_stages=0``, no K5)
and the differentiable LSTM route, since K2, K4 and K5 are forward only; the
SEANet stacks in ``compute_dtype`` (None: fp32) with the fp32 weights cast
per call, so gradients reach the fp32 leaves; the quantizer always in fp32,
its EMA state updated in place in the codebook buffers when training; the
output trimmed to the input length.

The encoder's route (``nn/seanet.SEANetEncoder.forward``): on a CUDA tensor
``encode(fused=None)`` takes the fused route, the input conv through K5 and
the first two stages through K4, wherever the stage plan accepts the config
and the length (``ops/seanet.fused_length_ok``).  On an H100 it is faster
than the module stack at every shape of the 32 kHz codec that
``chip_smoke.py`` times (2.1x at b128 x 10 s, 1.1-1.3x at B = 1), with a
third of its peak memory at b128, and level with it on the debug codec's
1 x 2 s in fp32 (PERF.md section 5), so no batch threshold is set.  On a
CPU tensor the default stays off, as in the JAX package, whose default rests
on a TPU measurement.  ``fused=False`` runs the module stack;
``conv0_kernel=True`` with ``fused=False`` runs the input conv alone through
K5.  In fp32 every route gives the CPU's codes; in bf16 the routes round at
other points, and about 12 % of the codes of a random-weight codec differ
between routes (near-ties that the rounding moves, not faults).
"""

from __future__ import annotations

import typing as tp

import torch

from ..dist.mesh import Group
from ..nn.seanet import SEANetDecoder, SEANetEncoder
from ..ops.seanet import fused_length_ok
from ..quant.vq import Draws, QuantizedResult, ResidualVectorQuantizer

Dtype = tp.Union[str, torch.dtype, None]


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

    @property
    def total_codebooks(self) -> int:
        return self.quantizer.max_n_q

    @property
    def num_codebooks(self) -> int:
        return self.quantizer.n_q

    @property
    def cardinality(self) -> int:
        return self.quantizer.bins

    def set_num_codebooks(self, n: int) -> None:
        """Use the first ``n`` codebooks from now on (in place; the JAX
        package returns a new model)."""
        if not 0 < n <= self.quantizer.max_n_q:
            raise ValueError(f"n={n} is outside [1, {self.quantizer.max_n_q}]")
        self.quantizer.n_q = n

    def _cast(self, x: torch.Tensor, compute_dtype: Dtype = None) -> torch.Tensor:
        """``x`` in the call's compute dtype, or else the model's (None: fp32)."""
        dtype = compute_dtype if compute_dtype is not None else self.compute_dtype
        if dtype is None:
            return x
        return x.to(getattr(torch, dtype) if isinstance(dtype, str) else dtype)

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

    def fused_default(self, x: torch.Tensor) -> bool:
        """The route ``fused=None`` takes for ``x``: fused on a CUDA tensor
        that the stage plan accepts, off on the CPU."""
        return x.is_cuda and fused_length_ok(self.encoder, x.shape[-1])

    def _latent(self, x: torch.Tensor, compute_dtype: Dtype, fused: tp.Optional[bool],
                conv0_kernel: tp.Optional[bool],
                lstm_kernel: tp.Optional[bool] = None) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"expected [B, C, T], got {tuple(x.shape)}")
        if fused is None:
            fused = self.fused_default(x)
        return self.encoder(self._cast(x, compute_dtype), fused_stages=2 if fused else 0,
                            conv0_kernel=bool(conv0_kernel),
                            lstm_kernel=lstm_kernel is not False).float()

    @torch.no_grad()
    def encode(self, x: torch.Tensor, compute_dtype: Dtype = None,
               fused: tp.Optional[bool] = None, conv0_kernel: tp.Optional[bool] = None,
               lstm_kernel: tp.Optional[bool] = None
               ) -> tp.Tuple[torch.Tensor, tp.Optional[torch.Tensor]]:
        """x [B, C, T] float -> (codes [B, K, T_frames] int32, scale).

        ``fused`` routes the encoder front end (input conv + 2 stages)
        through K4 (None: the default of :meth:`fused_default`),
        ``conv0_kernel`` the input conv through K5, ``lstm_kernel`` the LSTM
        (None or True: K2); see the module note."""
        x, scale = self.preprocess(x)
        return self.quantizer.encode(
            self._latent(x, compute_dtype, fused, conv0_kernel, lstm_kernel)), scale

    @torch.no_grad()
    def encode_to_latent(self, x: torch.Tensor, compute_dtype: Dtype = None,
                         fused: tp.Optional[bool] = None) -> torch.Tensor:
        """x [B, C, T] -> the encoder's latent [B, D, T_frames] fp32, before
        the quantizer (the codec as a feature extractor), on the route
        :meth:`encode` takes."""
        x, _ = self.preprocess(x)
        return self._latent(x, compute_dtype, fused, None)

    @torch.no_grad()
    def decode_latent(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T_frames] -> latent [B, D, T_frames] fp32."""
        return self.quantizer.decode(codes)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor, scale: tp.Optional[torch.Tensor] = None,
               compute_dtype: Dtype = None,
               lstm_kernel: tp.Optional[bool] = None) -> torch.Tensor:
        """codes [B, K, T_frames] -> waveform [B, C, T] fp32; ``lstm_kernel``
        as in :meth:`encode`."""
        emb = self.decode_latent(codes)
        out = self.decoder(self._cast(emb, compute_dtype),
                           lstm_kernel=lstm_kernel is not False).float()
        return self.postprocess(out, scale)

    def forward(self, x: torch.Tensor, training: bool = False,
                n_q_active: tp.Optional[int] = None,
                generator: tp.Optional[torch.Generator] = None,
                draws: tp.Optional[Draws] = None, group: Group = None,
                expiry: str = 'reference', compute_dtype: Dtype = None) -> QuantizedResult:
        """x [B, C, T] -> the quantizer's result with ``x`` the reconstruction
        [B, C, T] fp32, trimmed to the input length (reference
        encodec.py:206-221), differentiable in the SEANet weights.

        ``compute_dtype`` is the SEANet stacks' dtype for this call (None:
        fp32; unlike :meth:`encode`, the model's field does not apply, as in
        the JAX package, whose trainer decides the training dtype).  With
        ``training`` the quantizer runs its training forward (k-means on a
        fresh codebook, the EMA in place, the straight-through estimator;
        ``n_q_active``, ``generator``, ``draws``, ``group`` and ``expiry`` go
        to :meth:`ResidualVectorQuantizer.train_forward`; quantizer dropout
        passes ``n_q_active=quantizer.sample_n_q_active(generator)``, as the
        JAX package's caller would).  Without, it runs the eval forward."""
        if x.dim() != 3:
            raise ValueError(f"expected [B, C, T], got {tuple(x.shape)}")
        length = x.shape[-1]
        x, scale = self.preprocess(x)
        emb = self.encoder(self._cast(x, compute_dtype or torch.float32),
                           lstm_kernel=False).float()
        res = self.quantizer(emb, self.frame_rate, n_q_active=n_q_active, training=training,
                             generator=generator, draws=draws, group=group, expiry=expiry)
        out = self.decoder(self._cast(res.x, compute_dtype or torch.float32),
                           lstm_kernel=False).float()
        if out.shape[-1] < length:
            raise ValueError(f"the decoder gave {out.shape[-1]} samples for {length}")
        return res._replace(x=self.postprocess(out[..., :length], scale))
