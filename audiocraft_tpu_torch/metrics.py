"""Generation-quality metrics: FAD, KLD, CLAP score, chroma cosine
(counterpart of ``audiocraft_tpu/metrics.py``).

The embedder or classifier is a pluggable function of a waveform batch; the
distance and score math runs in numpy (and ``scipy.linalg.sqrtm``) on the
host, copied from the JAX package:

* :func:`make_codec_embed_fn`: the default FAD embedding ("codec-FAD"), the
  EnCodec encoder's latents on the codec's default route (K5 and K4 fused,
  then K2, on the card), mean and population std pooled per window on the
  codec's device.
* :func:`make_codec_prob_fn`: the default KLD "classifier", each clip's
  codebook-0 histogram from ``encode``'s codes (K1 as well).
* :func:`frechet_distance` / :class:`FrechetAudioDistance`,
  :func:`kl_divergence_metric`, :func:`clap_score`.
* :func:`chroma_cosine`: frame-averaged cosine between the chroma
  (``nn/chroma.ChromaExtractor``) of two waveforms, on ``device`` (the card
  unless ``'cpu'``).

The model carries its weights, so the functions take no ``params``.  FAD
values compare only within one embedder, as for any FAD variant.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

__all__ = ['frechet_distance', 'FrechetAudioDistance', 'kl_divergence_metric', 'clap_score',
           'chroma_cosine', 'make_codec_embed_fn', 'make_codec_prob_fn']


def _codec_input(model, wav: np.ndarray, sample_rate: int) -> torch.Tensor:
    from .io.audio_utils import convert_audio
    x = torch.from_numpy(np.array(wav, np.float32))
    if x.dim() != 3:
        raise ValueError(f"expected [B, C, T], got {tuple(x.shape)}")
    device = next(model.parameters()).device
    return convert_audio(x.to(device), sample_rate, model.sample_rate, 1)


def make_codec_embed_fn(model, window_seconds: float = 1.0
                        ) -> tp.Callable[[np.ndarray, int], np.ndarray]:
    """``embed_fn(wav [B, C, T], sr) -> [B * n_windows, 2 * latent_dim]``:
    per non-overlapping window of ``window_seconds`` the codec latent's
    frames pooled by mean and population std (ddof 0, numpy's)."""

    def embed_fn(wav: np.ndarray, sample_rate: int) -> np.ndarray:
        emb = model.encode_to_latent(_codec_input(model, wav, sample_rate))   # [B, D, Tf]
        w = max(int(round(window_seconds * model.frame_rate)), 2)
        n = emb.shape[-1] // w
        if n < 1:
            raise ValueError(f"clip too short for a {window_seconds} s embedding window")
        emb = emb[..., :n * w].unflatten(-1, (n, w))
        out = torch.cat([emb.mean(dim=-1), emb.std(dim=-1, correction=0)], dim=1)  # [B, 2D, n]
        return out.transpose(1, 2).reshape(-1, out.shape[1]).cpu().numpy()

    return embed_fn


def make_codec_prob_fn(model) -> tp.Callable[[np.ndarray, int], np.ndarray]:
    """``prob_fn(wav [B, C, T], sr) -> [B, cardinality]``: each clip's
    codebook-0 token histogram, rows summing to 1; feed paired rows to
    :func:`kl_divergence_metric`."""

    def prob_fn(wav: np.ndarray, sample_rate: int) -> np.ndarray:
        codes = model.encode(_codec_input(model, wav, sample_rate))[0].cpu().numpy()
        card = model.cardinality
        return np.stack([np.bincount(c, minlength=card) / max(c.size, 1)
                         for c in codes[:, 0]]).astype(np.float64)

    return prob_fn


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians:
    ``|mu1-mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2))``."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = np.asarray(linalg.sqrtm(sigma1 @ sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = np.asarray(linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset)))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


class FrechetAudioDistance:
    """FAD over a pluggable ``embed_fn(wav [B, C, T], sample_rate) -> [N, D]``:
    accumulate reference and generated sets, then :meth:`compute`."""

    def __init__(self, embed_fn: tp.Callable[[np.ndarray, int], np.ndarray], sample_rate: int):
        self.embed_fn = embed_fn
        self.sample_rate = sample_rate
        self._ref: tp.List[np.ndarray] = []
        self._gen: tp.List[np.ndarray] = []

    def add(self, reference: tp.Optional[np.ndarray] = None,
            generated: tp.Optional[np.ndarray] = None) -> None:
        if reference is not None:
            self._ref.append(np.asarray(self.embed_fn(np.asarray(reference), self.sample_rate)))
        if generated is not None:
            self._gen.append(np.asarray(self.embed_fn(np.asarray(generated), self.sample_rate)))

    @staticmethod
    def _stats(chunks: tp.List[np.ndarray]) -> tp.Tuple[np.ndarray, np.ndarray]:
        e = np.concatenate(chunks, axis=0).astype(np.float64)
        if e.ndim != 2 or e.shape[0] < 2:
            raise ValueError(f"FAD needs at least two embeddings [N, D], got {e.shape}")
        return e.mean(axis=0), np.cov(e, rowvar=False)

    def compute(self) -> float:
        mu_r, s_r = self._stats(self._ref)
        mu_g, s_g = self._stats(self._gen)
        return frechet_distance(mu_r, s_r, mu_g, s_g)


def kl_divergence_metric(ref_probs: np.ndarray, gen_probs: np.ndarray,
                         eps: float = 1e-6) -> tp.Dict[str, float]:
    """Per-sample label-distribution KL averaged over paired rows [N,
    n_classes]: ``kld`` = KL(ref || gen), its inverse and their mean."""
    p = np.asarray(ref_probs, np.float64) + eps
    q = np.asarray(gen_probs, np.float64) + eps
    p = p / p.sum(axis=-1, keepdims=True)
    q = q / q.sum(axis=-1, keepdims=True)
    kl_pq = float(np.mean(np.sum(p * np.log(p / q), axis=-1)))
    kl_qp = float(np.mean(np.sum(q * np.log(q / p), axis=-1)))
    return {'kld': kl_pq, 'kld_inverse': kl_qp, 'kld_symmetric': 0.5 * (kl_pq + kl_qp)}


def clap_score(text_embeds: np.ndarray, audio_embeds: np.ndarray) -> float:
    """Mean cosine between matched text and audio CLAP embeddings [N, D]."""
    t = np.asarray(text_embeds, np.float64)
    a = np.asarray(audio_embeds, np.float64)
    if t.shape != a.shape or t.ndim != 2:
        raise ValueError(f"paired [N, D] embeddings expected, got {t.shape} and {a.shape}")
    t = t / (np.linalg.norm(t, axis=-1, keepdims=True) + 1e-12)
    a = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12)
    return float(np.mean(np.sum(t * a, axis=-1)))


def chroma_cosine(wav_a: np.ndarray, wav_b: np.ndarray, sample_rate: int, n_chroma: int = 12,
                  radix2_exp: int = 12,
                  device: tp.Union[str, torch.device, None] = None) -> float:
    """Frame-averaged cosine between the chroma of two waveforms (how
    closely generated audio follows a melody reference), the chroma computed
    on ``device`` (None: the card)."""
    from .builders import resolve_device
    from .nn.chroma import ChromaExtractor

    dev = resolve_device(device)
    ext = ChromaExtractor(sample_rate=sample_rate, n_chroma=n_chroma, radix2_exp=radix2_exp)
    ca, cb = (ext(torch.from_numpy(np.array(w, np.float32)).to(dev)).cpu().numpy()
              for w in (wav_a, wav_b))
    n = min(ca.shape[-2], cb.shape[-2])
    ca, cb = ca[..., :n, :], cb[..., :n, :]
    num = np.sum(ca * cb, axis=-1)
    den = np.linalg.norm(ca, axis=-1) * np.linalg.norm(cb, axis=-1) + 1e-12
    return float(np.mean(num / den))
