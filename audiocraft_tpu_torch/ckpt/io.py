"""Checkpoint directories: ``config.json`` plus ``state.npz``
(counterpart of ``audiocraft_tpu/ckpt/io.py``).

``config.json`` keeps the JAX package's schema: ``{version, exported,
config, extra}``, where ``config`` names each class by ``__class__`` with its
constructor arguments under ``fields`` (the JAX package's dataclasses) or
``kwargs`` (its pattern providers), so either package reads the other's
config.  The port's modules are not dataclasses: :func:`config_to_dict`
reads each constructor argument from the attribute of the same name (a few
are kept in another form, :data:`_ENCODE`); ``generator`` and ``device``
are not configuration, and a runtime hook (an embedding function) is written
as None.

``state.npz`` comes in two layouts, told apart by ``meta['layout']``:

* ``'torch'``, what :func:`save_checkpoint` writes: the port's state dict
  under the reference names, fp32 for floating tensors (numpy has no bf16),
  a bundle's keys prefixed by its entry (``lm.``, ``condition_provider.``),
  and the codec a style or drums conditioner keeps out of its state dict
  under ``condition_provider.conditioners.<name>.feat_extractor.``.  The JAX
  package does not read it.
* no ``layout`` key: a directory the JAX package wrote, its param tree
  flattened to ``/``-joined paths; :func:`load_checkpoint` carries it across
  with ``ckpt/from_jax.py``.

:func:`load_checkpoint` builds the modules on the target device without
drawing their weights (``nn/init.allocate_only``) and loads the state into
them, strictly.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..builders import _finish, resolve_device
from ..nn import init

__version__ = '0.1.0'
LAYOUT = 'torch'

_REGISTRY: tp.Dict[str, type] = {}
#: classes the JAX package encodes under ``kwargs`` (plain classes there)
_KWARGS_CLASSES = ('DelayedPatternProvider', 'ParallelPatternProvider',
                   'UnrolledPatternProvider', 'CoarseFirstPattern', 'MusicLMPattern')
#: constructor arguments the port keeps in another form than the JAX field
_ENCODE: tp.Dict[tp.Tuple[str, str], tp.Callable[[tp.Any], tp.Any]] = {
    ('ConditionFuser', 'fuse2cond'): lambda m: tuple(m.fuse2cond.items()),
    ('ConditioningProvider', 'conditioners'): lambda m: tuple(m.conditioners.items()),
    ('StyleConditioner', 'batch_norm'): lambda m: m.batch_norm is not None,
    ('ResidualVectorQuantizer', 'n_q'): lambda m: m.max_n_q,
}
_NOT_CONFIG = ('self', 'generator', 'device')
#: runtime hooks, written as None (the JAX package's fields of the same names)
_HOOKS = ('embed_fn', 'text_embed_fn')


def _registry() -> tp.Dict[str, type]:
    if not _REGISTRY:
        from ..codec.encodec import EncodecModel
        from ..codec.stereo import InterleaveStereoCompressionModel
        from ..codec.wrappers import HFEncodecCompressionModel
        from ..cond.chroma_cond import ChromaConditioner
        from ..cond.conditioners import ConditioningProvider, LUTConditioner, T5Conditioner
        from ..cond.fuser import ConditionFuser
        from ..cond.joint_embed import JointEmbeddingConditioner
        from ..cond.style_cond import StyleConditioner
        from ..lm.magnet import MagnetLMModel
        from ..lm.model import LMModel
        from ..nn.seanet import SEANetDecoder, SEANetEncoder
        from ..nn.t5 import T5EncoderConfig
        from ..patterns.pattern import (CoarseFirstPattern, DelayedPatternProvider,
                                        MusicLMPattern, ParallelPatternProvider,
                                        UnrolledPatternProvider)
        from ..quant.base import DummyQuantizer
        from ..quant.vq import ResidualVectorQuantizer
        for cls in (EncodecModel, InterleaveStereoCompressionModel, HFEncodecCompressionModel,
                    SEANetEncoder, SEANetDecoder, ResidualVectorQuantizer, DummyQuantizer,
                    LMModel, MagnetLMModel, ConditionFuser, LUTConditioner, T5Conditioner,
                    T5EncoderConfig, ChromaConditioner, StyleConditioner,
                    JointEmbeddingConditioner, ConditioningProvider, DelayedPatternProvider,
                    ParallelPatternProvider, UnrolledPatternProvider, CoarseFirstPattern,
                    MusicLMPattern):
            _REGISTRY[cls.__name__] = cls
    return _REGISTRY


def constructor_args(cls: type) -> tp.List[str]:
    """The named constructor arguments of ``cls``, those its bases take
    through ``*args`` / ``**kwargs`` included, less :data:`_NOT_CONFIG`."""
    names: tp.List[str] = []
    for klass in cls.__mro__:
        if '__init__' not in vars(klass) or klass in (torch.nn.Module, object):
            continue
        params = inspect.signature(vars(klass)['__init__']).parameters.values()
        names += [p.name for p in params if p.name not in names and p.name not in _NOT_CONFIG
                  and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
        if not any(p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) for p in params):
            break
    return names


def config_to_dict(obj: tp.Any) -> tp.Any:
    """Encode a model, or a dict bundle of models, into JSON-able data."""
    name = type(obj).__name__
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {'__class__': name,
                'fields': {f.name: config_to_dict(getattr(obj, f.name))
                           for f in dataclasses.fields(obj) if not f.name.startswith('_')}}
    if name in _registry():
        args = {}
        for arg in constructor_args(type(obj)):
            encode = _ENCODE.get((name, arg))
            value = None if arg in _HOOKS else encode(obj) if encode else getattr(obj, arg)
            args[arg] = config_to_dict(value)
        return {'__class__': name, 'kwargs' if name in _KWARGS_CLASSES else 'fields': args}
    if isinstance(obj, (list, tuple)):
        return {'__seq__': 'tuple' if isinstance(obj, tuple) else 'list',
                'items': [config_to_dict(x) for x in obj]}
    if isinstance(obj, dict):
        return {k: config_to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    raise TypeError(f"cannot serialize config value of type {type(obj)}")


def config_from_dict(data: tp.Any, device: tp.Union[str, torch.device] = 'cpu') -> tp.Any:
    """Build what :func:`config_to_dict` (of either package) encoded; the
    modules on ``device``, their weights drawn from seed 0 (under
    ``nn/init.allocate_only``, not drawn at all)."""
    gen = torch.Generator().manual_seed(0)

    def build(node: tp.Any) -> tp.Any:
        if isinstance(node, dict) and '__class__' in node:
            cls = _registry()[node['__class__']]
            kwargs = {k: build(v) for k, v in node.get('fields', node.get('kwargs', {})).items()}
            if any('generator' in inspect.signature(vars(k)['__init__']).parameters
                   for k in cls.__mro__ if '__init__' in vars(k)):
                kwargs['generator'] = gen
            return cls(**kwargs)
        if isinstance(node, dict) and '__seq__' in node:
            seq = [build(x) for x in node['items']]
            return tuple(seq) if node['__seq__'] == 'tuple' else seq
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return node

    model = build(data)
    for _, module in _entries(model):
        _finish(module, torch.device(device))
    return model


def _entries(model: tp.Any) -> tp.List[tp.Tuple[str, torch.nn.Module]]:
    """A bundle's (key, module) pairs; ('', model) for a lone module."""
    return list(model.items()) if isinstance(model, dict) else [('', model)]


def _join(*parts: str) -> str:
    return '.'.join(p for p in parts if p)


def _feature_codecs(model: tp.Any) -> tp.Dict[str, torch.nn.Module]:
    """The codecs that style and drums conditioners hide from their state
    dict, by their key prefix in a checkpoint's state."""
    return {_join(prefix, name, 'feat_extractor'): sub.__dict__['feat_extractor']
            for prefix, module in _entries(model) for name, sub in module.named_modules()
            if isinstance(sub.__dict__.get('feat_extractor'), torch.nn.Module)}


def model_state(model: tp.Any) -> tp.Dict[str, np.ndarray]:
    """The port-layout state of a module or bundle: its state dicts under
    the bundle's prefixes, with the feature codecs; floating values fp32."""
    tensors = {_join(prefix, k): v
               for prefix, module in _entries(model) + list(_feature_codecs(model).items())
               for k, v in module.state_dict().items()}
    return {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu().numpy()
            for k, v in tensors.items()}


def save_checkpoint(path: tp.Union[str, Path], model: tp.Any,
                    extra: tp.Optional[dict] = None) -> Path:
    """Write the self-describing checkpoint directory of ``model`` (a module,
    or a dict bundle such as ``{'lm': lm, 'condition_provider': provider}``)
    with the weights it holds."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    meta = {'version': __version__, 'exported': True, 'config': config_to_dict(model),
            'extra': extra or {}, 'layout': LAYOUT}
    (path / 'config.json').write_text(json.dumps(meta, indent=2))
    np.savez(path / 'state.npz', **model_state(model))
    return path


def _unflatten(flat: tp.Mapping[str, np.ndarray]) -> dict:
    root: dict = {}
    for key, value in flat.items():
        parts = key.split('/')
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return root


def _codec_state_from_jax(codec: torch.nn.Module, params: tp.Mapping[str, tp.Any]
                          ) -> tp.Dict[str, torch.Tensor]:
    """A codec's state from the JAX tree; the stereo and HF wrappers hold
    their inner codec's tree."""
    from ..codec.encodec import EncodecModel
    from .from_jax import encodec_state_from_jax

    if isinstance(codec, EncodecModel):
        return encodec_state_from_jax(codec, params)
    return {f'model.{k}': v for k, v in _codec_state_from_jax(codec.model, params).items()}


def _state_from_jax(model: tp.Any, flat: tp.Mapping[str, np.ndarray]
                    ) -> tp.Dict[str, torch.Tensor]:
    """The port-layout state of a JAX-written directory's ``state.npz``."""
    from .from_jax import conditioners_state_from_jax, lm_state_from_jax

    params = _unflatten(flat)
    if not isinstance(model, dict):
        return _codec_state_from_jax(model, params)
    state: tp.Dict[str, torch.Tensor] = {}
    for key, module in model.items():
        if key == 'lm':
            part = lm_state_from_jax(module, params['lm'])
        elif key == 'condition_provider':
            part = conditioners_state_from_jax(module, params[key])
        else:
            raise ValueError(f"no JAX carrier for bundle entry {key!r}")
        state.update({f'{key}.{k}': v for k, v in part.items()})
    # a style or drums conditioner's codec: its params' ``codec``
    for prefix, codec in _feature_codecs(model).items():
        name = prefix.split('.')[-2]
        state.update({f'{prefix}.{k}': v for k, v in _codec_state_from_jax(
            codec, params['condition_provider'][name]['codec']).items()})
    return state


def load_state(model: tp.Any, state: tp.Mapping[str, tp.Any]) -> None:
    """Load a port-layout state into a module or bundle, strictly."""
    tensors = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
               for k, v in state.items()}
    # the feature codecs first: their keys lie under their conditioner's
    for prefix, module in list(_feature_codecs(model).items()) + _entries(model):
        module.load_state_dict({k[len(prefix) + 1:] if prefix else k: tensors.pop(k)
                                for k in list(tensors) if not prefix
                                or k.startswith(prefix + '.')})
    if tensors:
        raise KeyError(f"state keys outside the bundle: {sorted(tensors)[:8]}")


def load_checkpoint(path: tp.Union[str, Path],
                    device: tp.Union[str, torch.device, None] = None) -> tp.Tuple[tp.Any, dict]:
    """Returns ``(model, meta)``: the model (or bundle) built from the
    directory's config on ``device`` (None: the CUDA card) and holding its
    state, from either layout."""
    device = resolve_device(device)
    path = Path(path)
    meta = json.loads((path / 'config.json').read_text())
    with init.allocate_only(device):
        model = config_from_dict(meta['config'], device)
    with np.load(path / 'state.npz') as data:
        flat = {k: data[k] for k in data.files}
    state = flat if meta.get('layout') == LAYOUT else _state_from_jax(model, flat)
    load_state(model, state)
    return model, meta
