"""Weight-only int8 / int4 quantization for LM decode
(counterpart of ``audiocraft_tpu/lm/quantize.py``).

Decode at small batch streams every weight once a step, so storing the
transformer and head matrices in fewer bits cuts the bytes a step reads.
Two formats, both opt-in, with the JAX package's arithmetic (so the arrays
are equal):

* int8: per output row, symmetric: ``{'q': int8 [out, in], 's': fp32
  [out]}``; ``y = (x @ q.T) * s``.
* int4: per (output row, group of ``group_size`` inputs), symmetric in
  [-7, 7], two nibbles a byte (low nibble the even input):
  ``{'q4p': int8 [out, in / 2], 's': fp32 [out, in / group]}``;
  ``y[o] = sum_g s[o, g] * (x_g @ q4[o, g].T)``.

:func:`quantize_lm_params` applies either to a port ``LMModel`` in place:
each projection's weight becomes a ``nn/transformer.QuantizedWeight`` of
buffers (read by ``linear_w`` and ``LMModel.apply_heads``); embeddings,
norms, biases and layer scales stay floating point, as the JAX package
leaves them.  Plain PyTorch: the JAX package runs these as XLA ops too.
"""

from __future__ import annotations

import typing as tp

import torch

from ..nn.transformer import QuantizedLinear, QuantizedWeight

Leaf = tp.Dict[str, torch.Tensor]


def quantize_weight(w: torch.Tensor) -> Leaf:
    """[..., out, in] float -> {'q': int8, 's': fp32 [..., out]} (symmetric per row)."""
    w = w.float()
    scale = w.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(w / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return {'q': q, 's': scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 nibble values [..., n] (range [-8, 7]) -> packed [..., n / 2];
    :func:`unpack_int4` is the exact inverse."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last axis, not {tuple(q.shape)}")
    q = q.to(torch.int8)
    return ((q[..., 0::2] & 0xF) | (q[..., 1::2] << 4)).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Packed int4 pairs [..., n / 2] -> int8 values [..., n] (arithmetic
    shifts sign-extend both nibbles)."""
    lo = (p << 4) >> 4
    hi = p >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)


def quantize_weight_int4(w: torch.Tensor, group_size: int = 128) -> Leaf:
    """[..., out, in] float -> {'q4p': packed int8 [..., out, in / 2],
    's': fp32 [..., out, in / group]}: round to nearest over input groups,
    one group a row when ``in`` is not a multiple of ``group_size``."""
    w = w.float()
    n_in = w.shape[-1]
    if n_in % 2:
        raise ValueError(f"int4 needs an even input width, not {n_in}")
    if n_in % group_size:
        group_size = n_in
    g = n_in // group_size
    wg = w.reshape(*w.shape[:-1], g, group_size)
    scale = wg.abs().amax(dim=-1).clamp_min(1e-8) / 7.0
    q = torch.round(wg / scale[..., None]).clamp(-7, 7).reshape(w.shape).to(torch.int8)
    return {'q4p': pack_int4(q), 's': scale}


def dequantize_weight(leaf: tp.Union[Leaf, QuantizedWeight]) -> torch.Tensor:
    """The fp32 matrix a quantized leaf stands for (tests and non-matmul uses)."""
    if isinstance(leaf, QuantizedWeight):
        leaf = {name: buf for name, buf in leaf.named_buffers() if name != 'q4'}
    if 'q' in leaf:
        return leaf['q'].float() * leaf['s'].float()[..., None]
    q = unpack_int4(leaf['q4p']).float()
    s = leaf['s'].float()
    n_in, g = q.shape[-1], s.shape[-1]
    return (q.reshape(*q.shape[:-1], g, n_in // g) * s[..., None]).reshape(q.shape)


def prepare_for_decode(lm: torch.nn.Module) -> torch.nn.Module:
    """Unpack every int4 weight once, before a decode loop (into the same
    buffer at every call), so that no step unpacks nibbles (the JAX package converts them to native int4 once per
    traced generate, outside its scan).  No-op without int4 weights."""
    for module in lm.modules():
        if isinstance(module, QuantizedWeight):
            module.prepare()
    return lm


def _quant_fn(mode: str, group_size: int) -> tp.Callable[[torch.Tensor], Leaf]:
    if mode == 'int8':
        return quantize_weight
    if mode == 'int4':
        return lambda w: quantize_weight_int4(w, group_size)
    raise ValueError(f"unknown quantization mode: {mode!r}")


def _quantize_linear(linear: torch.nn.Module, qfn) -> QuantizedLinear:
    if isinstance(linear, QuantizedLinear):
        raise ValueError("the LM's weights are quantized already")
    bias = None if linear.bias is None else linear.bias.detach()
    return QuantizedLinear(QuantizedWeight(qfn(linear.weight.detach())), bias)


def quantize_lm_params(lm: torch.nn.Module, mode: str = 'int8',
                       group_size: int = 128) -> torch.nn.Module:
    """Quantize ``lm``'s transformer matrices and heads in place (one-way);
    returns ``lm``.  A model split over a model group (its parallel layers,
    ``dist/mesh.shard_lm``) is refused."""
    qfn = _quant_fn(mode, group_size)
    for layer in lm.transformer.layers:
        linears = [layer.linear1, layer.linear2] + [
            attn.out_proj for attn in (layer.self_attn, layer.cross_attention) if attn is not None]
        for linear in linears:
            if not isinstance(linear, (torch.nn.Linear, QuantizedLinear)):
                raise ValueError(f"quantize_lm_params takes nn.Linear layers, not "
                                 f"{type(linear).__name__}: a model split by shard_lm is not "
                                 f"quantized")
    for layer in lm.transformer.layers:
        for attn in (layer.self_attn, layer.cross_attention):
            if attn is None:
                continue
            weight = attn.in_proj_weight
            if isinstance(weight, QuantizedWeight):
                raise ValueError("the LM's weights are quantized already")
            del attn.in_proj_weight
            attn.in_proj_weight = QuantizedWeight(qfn(weight.detach()))
            attn.out_proj = _quantize_linear(attn.out_proj, qfn)
        layer.linear1 = _quantize_linear(layer.linear1, qfn)
        layer.linear2 = _quantize_linear(layer.linear2, qfn)
    lm.linears = torch.nn.ModuleList(_quantize_linear(lin, qfn) for lin in lm.linears)
    return lm
