"""JASCO flow matching over EnCodec latents (counterpart of
``audiocraft_tpu/lm/flow_matching.py``, the reference
``models/flow_matching.py``).

* :class:`FlowMatchingModel`: the temporal conditions (``TEMPORAL_CONDS``)
  cut or zero-padded to the latent length and concatenated on the feature
  axis, a bias-free input projection (``emb``), the fuser for the text, a
  DDPM sinusoidal time embedding through a swish MLP (``temb.dense.{0,1}``,
  the reference's names) and ``temb_proj`` added to the cross-attention
  source, the U-net transformer (``nn/unet_transformer.py``; non-causal,
  its self-attention through K3f on the card where ``attn_kernel`` routes
  it), ``out_norm`` and the vector-field head ``linear``.
* :meth:`FlowMatchingModel.estimated_vector_field`: multi-source CFG, the
  condition groups stacked on the batch and their fields weighted.
* :meth:`FlowMatchingModel.generate`: ``'euler'`` and ``'heun'`` fixed steps,
  and ``'dopri5'``, JAX's adaptive Dormand-Prince RK45 (``lax.while_loop``)
  with the same tableau, FSAL reuse, controller, clip, 1e-6 floor and
  ``max_steps`` cap.  ``t``, ``dt`` and the error ratio stay fp32 tensors on
  the device, as in JAX; the loop reads ``accept`` and the end test to the
  host once per trial step, and ``ode_stats`` keeps the last solve's trial
  steps, accepted steps, vector-field evaluations and host reads.

``z0`` is drawn from an explicit ``torch.Generator``; ``_integrate`` solves
from a given ``z0``, so tests can start from JAX's draw.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from ..cond.fuser import ConditionFuser
from ..nn import init
from ..nn.transformer import LayerNorm
from ..nn.unet_transformer import UnetTransformer

ConditionType = tp.Tuple[torch.Tensor, torch.Tensor]

# temporal JASCO conditions concatenated on the feature axis, in order
TEMPORAL_CONDS = ('chords', 'self_wav', 'melody')


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """DDPM sinusoidal embedding [len(t), dim] (reference flow_matching.py:211-231)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000) / (half - 1)))
    args = t.reshape(-1).float()[:, None] * freqs[None]
    out = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    return F.pad(out, (0, dim % 2))


class FlowMatchingModel(torch.nn.Module):

    def __init__(self, fuser: ConditionFuser, dim: int = 128, num_heads: int = 8,
                 num_layers: int = 8, flow_dim: int = 128, chords_dim: int = 0,
                 drums_dim: int = 0, melody_dim: int = 0, hidden_scale: int = 4,
                 norm_first: bool = True, bias_proj: bool = True,
                 time_embedding_dim: int = 128, skip_connections: bool = True,
                 activation: str = 'gelu', attn_kernel: tp.Union[bool, str] = False,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.fuser = fuser
        self.dim, self.flow_dim = dim, flow_dim
        self.time_embedding_dim = time_embedding_dim
        self.input_dim = flow_dim + chords_dim + drums_dim + melody_dim
        d1, d2 = time_embedding_dim, 4 * time_embedding_dim

        def linear(in_d, out_d, bias=True):
            return init.linear(in_d, out_d, bias, 1.0 / math.sqrt(in_d), generator)

        self.emb = linear(self.input_dim, dim, bias=False)
        self.transformer = UnetTransformer(
            dim, num_heads, num_layers, skip_connections=skip_connections,
            dim_feedforward=int(hidden_scale * dim), norm_first=norm_first, causal=False,
            cross_attention=True, activation=activation, attn_kernel=attn_kernel,
            generator=generator)
        self.linear = linear(dim, flow_dim, bias=bias_proj)
        self.temb = torch.nn.Module()
        self.temb.dense = torch.nn.ModuleList([linear(d1, d2), linear(d2, d2)])
        self.temb_proj = linear(d2, dim)
        self.out_norm = LayerNorm(dim) if norm_first else None
        self.ode_stats: tp.Dict[str, int] = {}

    def _embed_time(self, t: torch.Tensor) -> torch.Tensor:
        h = self.temb.dense[0](timestep_embedding(t, self.time_embedding_dim))
        return self.temb.dense[1](h * torch.sigmoid(h))       # swish

    def forward(self, latents: torch.Tensor, t: torch.Tensor,
                condition_tensors: tp.Mapping[str, ConditionType]) -> torch.Tensor:
        """latents [B, T, flow_dim], t [B] or 0-d -> vector field [B, T, flow_dim]."""
        B, T, _ = latents.shape
        parts = [latents]
        for name in TEMPORAL_CONDS:
            if name in condition_tensors:
                c = condition_tensors[name][0][:, :T]
                parts.append(F.pad(c, (0, 0, 0, T - c.shape[1])).to(latents.dtype))
        x = self.emb(torch.cat(parts, dim=-1))
        x, cross = self.fuser(x, {k: v for k, v in condition_tensors.items()
                                  if k not in TEMPORAL_CONDS})
        t_proj = self.temb_proj(self._embed_time(t))[:, None, :]
        cross = t_proj * torch.ones(B, 1, self.dim, device=x.device) if cross is None \
            else cross + t_proj
        out = self.transformer(x, cross_attention_src=cross)
        if self.out_norm is not None:
            out = self.out_norm(out)
        v = self.linear(out)
        return v[:, -T:] if self.fuser.has_prepend else v

    def estimated_vector_field(self, z: torch.Tensor, t: torch.Tensor,
                               condition_tensors: tp.Mapping[str, ConditionType],
                               cfg_weights: tp.Sequence[float]) -> torch.Tensor:
        """Multi-source CFG: ``condition_tensors`` holds ``len(cfg_weights)``
        groups stacked on the batch; the groups' fields are weighted and
        summed (reference flow_matching.py:387-418)."""
        n = len(cfg_weights)
        if n > 1:
            B = z.shape[0]
            z = z.repeat(n, 1, 1)
            t = t.expand(B).repeat(n)
        v = self.forward(z, t, condition_tensors)
        if n <= 1:
            return v
        return sum(w * term for w, term in zip(cfg_weights, v.chunk(n, dim=0)))

    @torch.no_grad()
    def generate(self, condition_tensors: tp.Mapping[str, ConditionType],
                 cfg_weights: tp.Sequence[float] = (1.0,), num_samples: int = 1,
                 max_gen_len: int = 500, euler_steps: int = 100, method: str = 'euler',
                 ode_atol: float = 1e-5, ode_rtol: float = 1e-5, ode_max_steps: int = 512,
                 generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        """Integrate dz/dt = v(z, t) from z0 ~ N(0, I), drawn on the CPU from
        ``generator`` (seed 0 when None), over t in [0, 1] -> latents
        [num_samples, max_gen_len, flow_dim]."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        z0 = torch.randn(num_samples, max_gen_len, self.flow_dim, generator=gen)
        return self._integrate(z0.to(self.emb.weight.device), condition_tensors, cfg_weights,
                               euler_steps, method, ode_atol, ode_rtol, ode_max_steps)

    def _integrate(self, z0: torch.Tensor, condition_tensors: tp.Mapping[str, ConditionType],
                   cfg_weights: tp.Sequence[float] = (1.0,), euler_steps: int = 100,
                   method: str = 'euler', ode_atol: float = 1e-5, ode_rtol: float = 1e-5,
                   ode_max_steps: int = 512) -> torch.Tensor:
        if method not in ('euler', 'heun', 'dopri5'):
            raise ValueError(f"method {method!r}: 'euler', 'heun' or 'dopri5'")

        def vf(z, t):
            return self.estimated_vector_field(z, t, condition_tensors, cfg_weights)

        if method == 'dopri5':
            z, self.ode_stats = _dopri5(vf, z0, 1.0 - 1e-5, ode_atol, ode_rtol, ode_max_steps)
            return z
        dt = 1.0 / euler_steps
        z, t = z0, torch.zeros((), device=z0.device)
        for _ in range(euler_steps):
            v = vf(z, t)
            if method == 'heun':
                z = z + dt * 0.5 * (v + vf(z + dt * v, t + dt))
            else:
                z = z + dt * v
            t = t + dt
        evals = euler_steps * (2 if method == 'heun' else 1)
        self.ode_stats = dict(trials=euler_steps, accepted=euler_steps, evals=evals, host_reads=0)
        return z


# Dormand-Prince RK45 (the classic dopri5 coefficients, torchdiffeq's
# default solver that the reference calls at flow_matching.py:478-514)
_DOPRI_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DOPRI_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DOPRI_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
             187 / 2100, 1 / 40)


def _dopri5(vf, z0: torch.Tensor, t1: float, atol: float, rtol: float,
            max_steps: int) -> tp.Tuple[torch.Tensor, tp.Dict[str, int]]:
    """JAX's adaptive RK45 from t = 0 to ``t1``: 6 new evaluations a trial
    step (FSAL), a step accepted where the RMS of err / (atol + rtol *
    max(|z|, |z5|)) is at most 1, dt scaled by clip(0.9 ratio^-1/5, 0.2,
    10), cut to the end and floored at 1e-6.  Constants enter as fp32
    tensors, as JAX's weakly typed Python floats do."""
    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=z0.device)

    t_end, t1_ = f32(t1 - 1e-8), f32(t1)
    z, t, dt = z0, f32(0.0), f32(0.01)
    k1 = vf(z0, t)
    stats = dict(trials=0, accepted=0, evals=1, host_reads=0)
    while stats['trials'] < max_steps:
        ks = [k1]
        for i in range(1, 7):
            zi = z + dt * sum(a * k for a, k in zip(_DOPRI_A[i], ks))
            ks.append(vf(zi, t + _DOPRI_C[i] * dt))
        z5 = z + dt * sum(b * k for b, k in zip(_DOPRI_B5, ks))
        err = dt * sum((b5 - b4) * k for b5, b4, k in zip(_DOPRI_B5, _DOPRI_B4, ks))
        scale = atol + rtol * torch.maximum(z.abs(), z5.abs())
        ratio = (err / scale).square().mean().sqrt()
        accept = ratio <= 1.0
        factor = (0.9 * ratio.clamp_min(1e-10).pow(-0.2)).clamp(0.2, 10.0)
        t = torch.where(accept, t + dt, t)
        z = torch.where(accept, z5, z)
        k1 = torch.where(accept, ks[6], k1)
        dt = torch.minimum(dt * factor, t1_ - t).clamp_min(1e-6)
        stats['trials'] += 1
        stats['evals'] += 6
        flags = torch.stack([accept, t < t_end]).tolist()      # one host read a trial
        stats['host_reads'] += 1
        stats['accepted'] += int(flags[0])
        if not flags[1]:
            break
    return z, stats
