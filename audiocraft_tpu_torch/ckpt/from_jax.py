"""Carry EnCodec weights from the JAX package's param tree into the port.

:func:`encodec_state_from_jax` takes the tree that the JAX package's
``EncodecModel.init`` or ``import_encodec`` produces, as nested dicts of numpy
arrays (the quantizer state as a dict of ``embed``, ``cluster_size``,
``embed_avg`` and ``inited``), and returns a state dict for the port's
``EncodecModel.load_state_dict``.  The JAX tree names layers ``layer{i}`` at
the same indices as the port's ``model`` lists, resnet convs ``conv{j}`` and
LSTM layers ``l{k}``.  Nothing of the JAX package is imported.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..codec.encodec import EncodecModel
from ..nn.conv import StreamableConv1d, StreamableConvTranspose1d
from ..nn.lstm import StreamableLSTM
from ..nn.seanet import SEANetResnetBlock

Tree = tp.Mapping[str, tp.Any]


def _conv(sd: dict, prefix: str, params: Tree) -> None:
    for name in ('weight', 'bias'):
        if name in params:
            sd[f'{prefix}.{name}'] = params[name]


def _seanet(sd: dict, side: str, stack: torch.nn.Module, params: Tree) -> None:
    for i, layer in enumerate(stack.model):
        prefix = f'{side}.model.{i}'
        if isinstance(layer, StreamableConv1d):
            _conv(sd, f'{prefix}.conv.conv', params[f'layer{i}'])
        elif isinstance(layer, StreamableConvTranspose1d):
            _conv(sd, f'{prefix}.convtr.convtr', params[f'layer{i}'])
        elif isinstance(layer, SEANetResnetBlock):
            p = params[f'layer{i}']
            for j in range(len(layer.block) // 2):
                _conv(sd, f'{prefix}.block.{2 * j + 1}.conv.conv', p[f'conv{j}'])
            if layer.shortcut is not None:
                _conv(sd, f'{prefix}.shortcut.conv.conv', p['shortcut'])
        elif isinstance(layer, StreamableLSTM):
            for k in range(layer.num_layers):
                p = params[f'layer{i}'][f'l{k}']
                for ours, theirs in (('weight_ih', 'w_ih'), ('weight_hh', 'w_hh'),
                                     ('bias_ih', 'b_ih'), ('bias_hh', 'b_hh')):
                    sd[f'{prefix}.lstm.{ours}_l{k}'] = p[theirs]


def encodec_state_from_jax(model: EncodecModel, params: Tree) -> tp.Dict[str, torch.Tensor]:
    """The port's state dict for ``model`` holding the JAX ``params``."""
    sd: tp.Dict[str, tp.Any] = {}
    _seanet(sd, 'encoder', model.encoder, params['encoder'])
    _seanet(sd, 'decoder', model.decoder, params['decoder'])
    q = params['quantizer']
    for i in range(len(model.quantizer.vq.layers)):
        base = f'quantizer.vq.layers.{i}._codebook'
        sd[f'{base}.embed'] = q['embed'][i]
        sd[f'{base}.cluster_size'] = q['cluster_size'][i]
        sd[f'{base}.embed_avg'] = q['embed_avg'][i]
        sd[f'{base}.inited'] = np.reshape(q['inited'][i], (1,))
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
