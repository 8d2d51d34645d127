"""A ``demucs`` htdemucs state dict into the port's ``HTDemucs``
(counterpart of ``audiocraft_tpu/ckpt/demucs_import.py``).

The port's module keeps the demucs names, the attention's packed
``in_proj_weight`` included, so the import is ``load_state_dict`` with
JAX's contract around it: every key of the state dict that the model takes
is consumed, a key the model lacks is reported (:func:`import_htdemucs`
returns them, ``[]`` on a clean import), and a key the model needs but the
state dict lacks raises.

A clean import is not correct stems.  The port keeps the JAX reference's
graph, whose transposed convs run the stored kernel unflipped
(``nn/demucs.HDecLayer.forward`` flips the taps to match it), so a
published htdemucs checkpoint runs its decoders' upsampling mirrored and
gives wrong stems.  :func:`import_htdemucs` warns so on every call until
the reference is repaired.

:func:`htdemucs_state_schema` is the key set of a published htdemucs state
dict, written from the demucs v4 module layout independently of the model,
so that drift between the two fails a test.
"""

from __future__ import annotations

import typing as tp
import warnings

import numpy as np
import torch

from ..nn.demucs import HTDemucs, HTDemucsConfig


def import_htdemucs(model: HTDemucs, sd: tp.Mapping[str, tp.Any]) -> tp.List[str]:
    """Load the demucs state dict ``sd`` (tensors or arrays) into ``model``
    in place; returns the keys it did not consume, sorted.  Warns that the
    decoders' transposed convs run the loaded taps mirrored (module
    docstring)."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"the state dict lacks {len(missing)} keys of the model: {missing[:6]}")
    model.load_state_dict({k: torch.as_tensor(np.asarray(sd[k], np.float32)) for k in own},
                          strict=True)
    warnings.warn("HTDemucs runs its decoders' transposed convs with the taps mirrored, as "
                  "the JAX reference does: a published checkpoint imports cleanly but gives "
                  "wrong stems", UserWarning, stacklevel=2)
    return sorted(set(sd) - set(own))


def htdemucs_state_schema(cfg: HTDemucsConfig) -> tp.Set[str]:
    """Expected keys of a published htdemucs state dict for ``cfg``.

    From the demucs v4 modules: ``hdemucs.py`` HEncLayer (``conv``,
    ``rewrite``, ``dconv``; norm1/norm2 are Identity at the published
    ``norm_starts=4``) and HDecLayer (``conv_tr``, ``rewrite``, no dconv at
    ``dconv_mode=1``); ``demucs.py`` DConv (``layers.{j}`` Sequential [0 conv
    k3, 1 GroupNorm, 2 GELU, 3 conv 1x1, 4 GroupNorm, 5 GLU, 6 LayerScale],
    depth 2); ``transformer.py`` CrossTransformerEncoder (``norm_in``,
    ``norm_in_t``; even layers ``self_attn``, ``norm1/2``; odd layers
    ``cross_attn``, ``norm1/2/3``; each ``linear1/2``, ``gamma_1/2.scale``,
    ``norm_out``); ``htdemucs.py`` (``freq_emb.embedding.weight``, the four
    Conv1d channel resamplers when ``bottom_channels`` differs from the
    bottom width)."""
    keys: tp.Set[str] = set()

    def wb(prefix: str) -> None:
        keys.update((f'{prefix}.weight', f'{prefix}.bias'))

    for branch in ('encoder', 'tencoder'):
        for i in range(cfg.depth):
            wb(f'{branch}.{i}.conv')
            wb(f'{branch}.{i}.rewrite')
            for j in range(2):
                for part in (0, 1, 3, 4):
                    wb(f'{branch}.{i}.dconv.layers.{j}.{part}')
                keys.add(f'{branch}.{i}.dconv.layers.{j}.6.scale')
    for branch in ('decoder', 'tdecoder'):
        for i in range(cfg.depth):
            wb(f'{branch}.{i}.conv_tr')
            wb(f'{branch}.{i}.rewrite')
    wb('crosstransformer.norm_in')
    wb('crosstransformer.norm_in_t')
    for layers in ('layers', 'layers_t'):
        for i in range(cfg.t_depth):
            base = f'crosstransformer.{layers}.{i}'
            attn = 'cross_attn' if i % 2 == 1 else 'self_attn'
            keys.update((f'{base}.{attn}.in_proj_weight', f'{base}.{attn}.in_proj_bias'))
            for name in (f'{attn}.out_proj', 'linear1', 'linear2', 'norm1', 'norm2', 'norm_out'):
                wb(f'{base}.{name}')
            if i % 2 == 1:
                wb(f'{base}.norm3')
            keys.update((f'{base}.gamma_1.scale', f'{base}.gamma_2.scale'))
    keys.add('freq_emb.embedding.weight')
    if cfg.bottom_channels != cfg.bottom_dim:
        for name in ('channel_upsampler', 'channel_downsampler', 'channel_upsampler_t',
                     'channel_downsampler_t'):
            wb(name)
    return keys
