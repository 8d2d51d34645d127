"""Reference torch state dicts into the port's state dicts
(counterpart of ``audiocraft_tpu/ckpt/torch_import.py``).

This is how published Audiocraft and EnCodec weights arrive in the port.
The input is a flat ``{name: array or tensor}`` dict, a reference
``state_dict()`` or its export; the output is a flat ``{name: np.ndarray}``
dict under the port module's own names, for ``load_state_dict`` (through
:func:`to_tensors`) or :func:`merge_params`.

The port's modules carry the reference names
(``encoder.model.0.conv.conv.weight``, ``transformer.layers.0.self_attn...``,
``condition_provider.conditioners.<name>.output_proj.weight``), so one
importer, :func:`import_state`, serves every part: it selects the keys its
module has, under the reference prefix, and folds weight norm where the
export keeps it factored:
:func:`get_conv_weight` computes ``g * v / |v|`` in fp32 numpy, the norm
over every axis but the first, for both torch layouts (``weight_g`` /
``weight_v`` and ``parametrizations.weight.original0`` / ``original1``),
with the JAX package's arithmetic, so codes that hang on a near-tie come out
the same.

Wrap the input in :class:`KeyTracker` to learn which keys no importer read
(:meth:`KeyTracker.unused`): a model that runs on half its weights generates
noise.
"""

from __future__ import annotations

import re
import typing as tp

import numpy as np
import torch

Array = np.ndarray
StateDict = tp.Mapping[str, tp.Any]


class KeyTracker:
    """A flat state dict that records which keys the importers read.

    Importers take it in place of the dict; afterwards :meth:`unused` lists
    every key no importer consumed, so the caller can warn or fail."""

    def __init__(self, sd: StateDict):
        self._sd = dict(sd)
        self.used: tp.Set[str] = set()

    def __getitem__(self, key: str) -> tp.Any:
        self.used.add(key)
        return self._sd[key]

    def __contains__(self, key: str) -> bool:
        return key in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self) -> int:
        return len(self._sd)

    def keys(self):
        return self._sd.keys()

    def items(self):
        return self._sd.items()

    def unused(self, ignore: tp.Sequence[str] = ()) -> tp.List[str]:
        """Keys never read by an importer, minus those matching a regex of
        ``ignore``."""
        return sorted(key for key in self._sd
                      if key not in self.used and not any(re.search(p, key) for p in ignore))


#: Buffers a reference LM state dict may carry that the port does not keep
#: (the chroma STFT window is recomputed, the stem indices are config).
HARMLESS_BUFFER_PATTERNS = (
    r"\.chroma\.spec\.",          # torchaudio Spectrogram window buffer
    r"\.stem_indices$",           # ChromaStemConditioner demucs stem selector
    r"num_batches_tracked$",      # BatchNorm bookkeeping
)


def as_array(v: tp.Any) -> Array:
    """``v`` as a numpy array; floating values in fp32 (numpy has no bf16)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        v = (v.float() if v.is_floating_point() else v).numpy()
    v = np.asarray(v)
    return v.astype(np.float32) if np.issubdtype(v.dtype, np.floating) else v


def to_tensors(sd: tp.Mapping[str, Array]) -> tp.Dict[str, torch.Tensor]:
    """An importer's arrays as CPU tensors for ``load_state_dict``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def merge_params(module: torch.nn.Module, partial: tp.Mapping[str, Array]) -> tp.List[str]:
    """Load a partial imported state into ``module``; the keys it does not
    cover keep the module's seeded values (e.g. the T5 encoder, which
    published LM exports leave out).  Returns those keys; a key the module
    does not have raises."""
    result = module.load_state_dict(to_tensors(partial), strict=False)
    if result.unexpected_keys:
        raise KeyError(f"keys the module does not have: {result.unexpected_keys}")
    return list(result.missing_keys)


def _norm_keepdims(v: Array) -> Array:
    return np.sqrt(np.sum(np.square(v), axis=tuple(range(1, v.ndim)), keepdims=True))


def _j(prefix: str, name: str) -> str:
    """A state-dict prefix and a relative key, tolerating an empty prefix."""
    prefix = prefix.rstrip('.')
    return f"{prefix}.{name}" if prefix else name


def _factored(sd: StateDict, prefix: str) -> bool:
    return (f"{prefix}.weight_g" in sd
            or f"{prefix}.parametrizations.weight.original0" in sd)


def get_conv_weight(sd: StateDict, prefix: str) -> Array:
    """The conv weight at ``prefix`` (e.g. ``'model.0.conv.conv'``), with
    weight norm folded: ``g * v / |v|``."""
    if f"{prefix}.weight" in sd:
        return as_array(sd[f"{prefix}.weight"])
    for g_key, v_key in ((f"{prefix}.weight_g", f"{prefix}.weight_v"),
                         (f"{prefix}.parametrizations.weight.original0",
                          f"{prefix}.parametrizations.weight.original1")):
        if g_key in sd:
            g, v = as_array(sd[g_key]), as_array(sd[v_key])
            return g * v / _norm_keepdims(v)
    raise KeyError(f"no conv weight found under {prefix}")


def import_state(module: torch.nn.Module, sd: StateDict, prefix: str = '',
                 required: bool = True) -> tp.Dict[str, Array]:
    """The importer of every part: each key of ``module``'s state dict
    found under ``prefix`` in ``sd``, a weight folded from its weight-norm
    factors where the export keeps them; a key not found raises when
    ``required``.  A value takes the module's shape where only that differs
    (the codebooks' ``inited``).  A SEANet stack is
    ``import_state(model.encoder, sd, 'encoder')``, an RVQ
    ``import_state(model.quantizer, sd, 'quantizer')``, a transformer
    ``import_state(lm.transformer, sd, 'transformer')``: the port's modules
    carry the reference names, with activations taking their Sequential
    index as in the reference."""
    out: tp.Dict[str, Array] = {}
    for key, ref in module.state_dict().items():
        src = _j(prefix, key)
        if src in sd:
            value = as_array(sd[src])
        elif key.endswith('.weight') and _factored(sd, src[:-len('.weight')]):
            value = get_conv_weight(sd, src[:-len('.weight')])
        elif required:
            raise KeyError(f"{src} is not in the state dict")
        else:
            continue
        if value.shape != tuple(ref.shape) and value.size == ref.numel():
            value = value.reshape(tuple(ref.shape))
        out[key] = value
    return out


def import_lstm(sd: StateDict, prefix: str, num_layers: int) -> tp.Dict[str, Array]:
    """The ``lstm.*_l{k}`` tensors under ``prefix``, at the same names."""
    return {f'lstm.{name}_l{k}': as_array(sd[_j(prefix, f'lstm.{name}_l{k}')])
            for k in range(num_layers)
            for name in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')}


def import_encodec(model: torch.nn.Module, sd: StateDict) -> tp.Dict[str, Array]:
    """A whole reference EncodecModel state dict: encoder, decoder and
    quantizer."""
    return import_state(model, sd)


def import_lm(lm: torch.nn.Module, sd: StateDict) -> tp.Dict[str, Array]:
    """A reference LMModel state dict (``emb.{k}``, ``transformer``,
    ``linears.{k}``, ``out_norm``) as the port ``lm``'s."""
    return import_state(lm, sd)


def import_conditioners(provider: torch.nn.Module, sd: StateDict,
                        prefix: str = 'condition_provider') -> tp.Dict[str, Array]:
    """The trained conditioner weights inside a reference LM state dict, as
    a partial state dict of the port's ``provider``
    (``conditioners.<name>...``), for :func:`merge_params`.

    The reference LM registers its ConditioningProvider as a submodule, so
    published MusicGen exports carry each conditioner's ``output_proj``, a
    lookup table's ``embed`` and the style conditioner's embeddings,
    transformer, RVQ and batch norm; the frozen T5 and the style's codec are
    not in them.  Dropping these weights would condition on noise."""
    return import_state(provider, sd, prefix, required=False)


def import_t5(sd: StateDict, num_layers: int, gated: bool = False,
              prefix: str = '') -> tp.Dict[str, Array]:
    """An HF torch T5 encoder state dict (``T5EncoderModel`` layout) as the
    port ``T5Encoder``'s (the same names; ``encoder.embed_tokens``, tied to
    ``shared``, is not read)."""
    names = ['shared.weight', 'encoder.final_layer_norm.weight',
             'encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight']
    for i in range(num_layers):
        b = f'encoder.block.{i}'
        names += [f'{b}.layer.0.SelfAttention.{n}.weight' for n in 'qkvo']
        names += [f'{b}.layer.0.layer_norm.weight', f'{b}.layer.1.layer_norm.weight',
                  f'{b}.layer.1.DenseReluDense.wo.weight']
        names += [f'{b}.layer.1.DenseReluDense.{n}.weight'
                  for n in (('wi_0', 'wi_1') if gated else ('wi',))]
    return {name: as_array(sd[_j(prefix, name)]) for name in names}
