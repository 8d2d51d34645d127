"""Quantizer contract and the pass-through ``DummyQuantizer``
(counterpart of ``audiocraft_tpu/quant/base.py``; reference
quantization/base.py:68-107).

``QuantizedResult`` lives in ``quant/vq.py`` and is re-exported here.
``DummyQuantizer`` is what a ``quantizer: no_quant`` config builds
(``config.py``): its codes are the continuous latent itself.
"""

from __future__ import annotations

import torch

from .vq import QuantizedResult

__all__ = ['BaseQuantizer', 'DummyQuantizer', 'QuantizedResult']


class BaseQuantizer(torch.nn.Module):
    """forward -> QuantizedResult (x, codes, bandwidth, penalty); encode and
    decode; codebook accounting."""

    def forward(self, x: torch.Tensor, frame_rate: float, **kwargs) -> QuantizedResult:
        raise NotImplementedError()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError()

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError()

    @property
    def total_codebooks(self) -> int:
        raise NotImplementedError()

    @property
    def num_codebooks(self) -> int:
        raise NotImplementedError()

    def set_num_codebooks(self, n: int) -> None:
        raise NotImplementedError()


class DummyQuantizer(BaseQuantizer):
    """No-op quantizer: x [B, D, T] -> codes [B, 1, D, T], the latent itself.
    ``bins`` only keeps ``EncodecModel.cardinality`` meaningful."""

    def __init__(self, n_q: int = 1, bins: int = 1, dimension: int = 0):
        super().__init__()
        self.n_q, self.bins, self.dimension = n_q, bins, dimension

    def forward(self, x: torch.Tensor, frame_rate: float, **kwargs) -> QuantizedResult:
        q = x[:, None]
        bandwidth = torch.tensor(q.numel() * 32 * frame_rate / 1000 / x.shape[0],
                                 dtype=torch.float32, device=x.device)
        return QuantizedResult(x, q, bandwidth, torch.zeros((), device=x.device))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, None]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return codes[:, 0]

    @property
    def total_codebooks(self) -> int:
        return 1

    @property
    def num_codebooks(self) -> int:
        return 1

    @property
    def max_n_q(self) -> int:
        return 1

    def set_num_codebooks(self, n: int) -> None:
        raise AttributeError("Cannot override the number of codebooks for the dummy quantizer")

