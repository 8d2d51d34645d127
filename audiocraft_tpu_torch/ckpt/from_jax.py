"""Carry weights from the JAX package's param trees into the port.

Each function takes a tree as the JAX package's ``init`` or its
``ckpt/torch_import`` importers produce it, as nested dicts of numpy arrays,
and returns a state dict for the port module's ``load_state_dict``:

* :func:`seanet_state_from_jax`: one SEANet encoder or decoder alone.
* :func:`encodec_state_from_jax`: EnCodec (the quantizer state as a dict of
  ``embed``, ``cluster_size``, ``embed_avg`` and ``inited``, a fresh
  codebook's zeros and ``inited`` 0 included), or the stereo
  wrapper, whose params are its mono codec's.  The JAX tree names layers
  ``layer{i}`` at the same indices as the port's ``model`` lists, resnet
  convs ``conv{j}`` and LSTM layers ``l{k}``; a conv's ``gn_scale`` and
  ``gn_bias`` (``time_group_norm``) go to ``conv.norm.weight`` and
  ``conv.norm.bias``.
* :func:`lm_state_from_jax`: ``LMModel`` and ``MagnetLMModel`` (stacked
  ``[K, ...]`` embeddings and heads, transformer layers ``layer{i}``, or
  the layers stacked on a leading ``[num_layers]`` axis, as the JAX
  package's ``scan_layers`` transformer's ``stack_params`` writes them).
* :func:`discriminator_state_from_jax`: ``MultiScaleSTFTDiscriminator``
  (``scale{s}/conv{i}`` to ``discriminators.{s}.convs.{i}``).
* :func:`balancer_state_from_jax`: the balancer's EMA norms and count.
* :func:`t5_state_from_jax`: the T5 encoder, under HF T5 names.
* :func:`conditioners_state_from_jax`: a ``ConditioningProvider``: the
  text conditioners, the chroma conditioner (``output_proj``) and the style
  conditioner (``embed.{i}``, ``transformer.layers.*``,
  ``rvq.vq.layers.{q}._codebook.*``, ``batch_norm.running_mean`` and
  ``running_var``, ``output_proj``: the reference names the JAX importer
  reads, ``ckpt/torch_import.py``:318-349).  The style conditioner's own
  codec is not in that state dict, as the reference hides it:
  :func:`load_musicgen_from_jax` loads it from the style params' ``codec``.
* :func:`load_musicgen_from_jax`: a whole ``MusicGen`` facade (codec, LM and
  conditioners) from the JAX facade's three trees.  Quantized weights are not
  carried: quantize the carried float weights on each side.
* :func:`htdemucs_state_from_jax`: ``HTDemucs`` under the demucs names, the
  inverse of the JAX package's ``ckpt/demucs_import.py`` (q, k and v packed
  into ``in_proj_weight``; a cross layer's ``norm_kv`` to ``norm2`` and its
  ``norm2`` to ``norm3``).
* :func:`flow_matching_state_from_jax`: JASCO's flow model (``emb``,
  ``transformer.layers``, ``transformer.skip_projections.{i}``,
  ``temb.dense.{0,1}``, ``temb_proj``, ``out_norm``, ``linear``);
  :func:`conditioners_state_from_jax` also takes JASCO's provider (chords
  ``emb``, melody and drums ``output_proj``) and the joint-embedding
  conditioner (``rvq``); :func:`load_jasco_from_jax` loads both, and the
  drums' codec from its params' ``codec``.
* :func:`diffusion_unet_state_from_jax`: MultiBand-Diffusion's
  ``DiffusionUnet`` (``encoders`` / ``decoders`` lists with their ``res``
  blocks, ``embedding`` and ``embeddings``, ``bilstm``, ``transformer``,
  ``conv_codec``), the same names on both sides.

The names produced are the reference audiocraft ones, which the JAX
package's importers read back.  Nothing of the JAX package is imported.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..adversarial import MultiScaleSTFTDiscriminator
from ..codec.encodec import EncodecModel
from ..codec.stereo import InterleaveStereoCompressionModel
from ..cond.conditioners import ConditioningProvider, LUTConditioner, T5Conditioner
from ..cond.jasco_conditioners import ChordsEmbConditioner, DrumsConditioner
from ..cond.joint_embed import JointEmbeddingConditioner
from ..cond.style_cond import StyleConditioner
from ..lm.flow_matching import FlowMatchingModel
from ..lm.model import LMModel
from ..nn.conv import StreamableConv1d, StreamableConvTranspose1d
from ..nn.lstm import StreamableLSTM
from ..nn.seanet import SEANetResnetBlock

Tree = tp.Mapping[str, tp.Any]


def _tensors(sd: tp.Mapping[str, tp.Any]) -> tp.Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _weight_bias(sd: dict, prefix: str, params: Tree) -> None:
    for name in ('weight', 'bias'):
        if name in params:
            sd[f'{prefix}.{name}'] = params[name]


def _conv(sd: dict, prefix: str, params: Tree) -> None:
    """A ``StreamableConv1d`` at ``prefix``, with its GroupNorm if it has one."""
    _weight_bias(sd, f'{prefix}.conv.conv', params)
    if 'gn_scale' in params:
        sd[f'{prefix}.conv.norm.weight'] = params['gn_scale']
        sd[f'{prefix}.conv.norm.bias'] = params['gn_bias']


def _seanet(sd: dict, side: str, stack: torch.nn.Module, params: Tree) -> None:
    for i, layer in enumerate(stack.model):
        prefix = f'{side}.model.{i}'
        if isinstance(layer, StreamableConv1d):
            _conv(sd, prefix, params[f'layer{i}'])
        elif isinstance(layer, StreamableConvTranspose1d):
            _weight_bias(sd, f'{prefix}.convtr.convtr', params[f'layer{i}'])
        elif isinstance(layer, SEANetResnetBlock):
            p = params[f'layer{i}']
            for j in range(len(layer.block) // 2):
                _conv(sd, f'{prefix}.block.{2 * j + 1}', p[f'conv{j}'])
            if layer.shortcut is not None:
                _conv(sd, f'{prefix}.shortcut', p['shortcut'])
        elif isinstance(layer, StreamableLSTM):
            for k in range(layer.num_layers):
                p = params[f'layer{i}'][f'l{k}']
                for ours, theirs in (('weight_ih', 'w_ih'), ('weight_hh', 'w_hh'),
                                     ('bias_ih', 'b_ih'), ('bias_hh', 'b_hh')):
                    sd[f'{prefix}.lstm.{ours}_l{k}'] = p[theirs]


def seanet_state_from_jax(stack: torch.nn.Module, params: Tree) -> tp.Dict[str, torch.Tensor]:
    """The state dict of a SEANet encoder or decoder on its own (keys
    ``model.{i}...``) holding the JAX stack's ``params``."""
    sd: tp.Dict[str, tp.Any] = {}
    _seanet(sd, 'stack', stack, params)
    return _tensors({k[len('stack.'):]: v for k, v in sd.items()})


def encodec_state_from_jax(model: tp.Union[EncodecModel, InterleaveStereoCompressionModel],
                           params: Tree) -> tp.Dict[str, torch.Tensor]:
    """The port's state dict for ``model`` holding the JAX ``params``; the
    stereo wrapper's is its mono codec's under ``model.``."""
    if isinstance(model, InterleaveStereoCompressionModel):
        return {f'model.{k}': v for k, v in encodec_state_from_jax(model.model, params).items()}
    sd: tp.Dict[str, tp.Any] = {}
    _seanet(sd, 'encoder', model.encoder, params['encoder'])
    _seanet(sd, 'decoder', model.decoder, params['decoder'])
    _rvq(sd, 'quantizer', params['quantizer'], len(model.quantizer.vq.layers))
    return _tensors(sd)


def _rvq_fields(state: tp.Any) -> Tree:
    """The JAX RVQ state (a dict, or the JAX package's dataclass) as a dict."""
    if isinstance(state, tp.Mapping):
        return state
    return {name: getattr(state, name) for name in ('embed', 'cluster_size', 'embed_avg',
                                                     'inited')}


def _rvq(sd: dict, prefix: str, state: tp.Any, n_q: int) -> None:
    q = _rvq_fields(state)
    for i in range(n_q):
        base = f'{prefix}.vq.layers.{i}._codebook'
        sd[f'{base}.embed'] = q['embed'][i]
        sd[f'{base}.cluster_size'] = q['cluster_size'][i]
        sd[f'{base}.embed_avg'] = q['embed_avg'][i]
        sd[f'{base}.inited'] = np.reshape(q['inited'][i], (1,))


def _attention(sd: dict, prefix: str, p: Tree) -> None:
    sd[f'{prefix}.in_proj_weight'] = p['in_proj_weight']
    if 'in_proj_bias' in p:
        sd[f'{prefix}.in_proj_bias'] = p['in_proj_bias']
    _weight_bias(sd, f'{prefix}.out_proj', p['out_proj'])
    for norm in ('q_layer_norm', 'k_layer_norm'):
        if norm in p:
            _weight_bias(sd, f'{prefix}.{norm}', p[norm])


def _layer(params: Tree, i: int) -> Tree:
    """Layer ``i`` of a transformer tree: ``layer{i}``, or slice i of the
    stacked leaves."""
    if f'layer{i}' in params:
        return params[f'layer{i}']
    return {k: _layer_slice(v, i) for k, v in params.items()}


def _layer_slice(tree: tp.Any, i: int) -> tp.Any:
    if isinstance(tree, tp.Mapping):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _transformer(sd: dict, prefix: str, params: Tree, num_layers: int) -> None:
    for i in range(num_layers):
        p, base = _layer(params, i), f'{prefix}.layers.{i}'
        _attention(sd, f'{base}.self_attn', p['self_attn'])
        for name in ('norm1', 'norm2', 'linear1', 'linear2'):
            _weight_bias(sd, f'{base}.{name}', p[name])
        if 'cross_attention' in p:
            _attention(sd, f'{base}.cross_attention', p['cross_attention'])
            _weight_bias(sd, f'{base}.norm_cross', p['norm_cross'])
        for name in ('layer_scale_1', 'layer_scale_2', 'layer_scale_cross'):
            if name in p:
                sd[f'{base}.{name}.scale'] = p[name]


def lm_state_from_jax(lm: LMModel, params: Tree) -> tp.Dict[str, torch.Tensor]:
    """The port's state dict for ``lm`` holding the JAX LM ``params``."""
    sd: tp.Dict[str, tp.Any] = {}
    for k in range(lm.n_q):
        sd[f'emb.{k}.weight'] = params['emb'][k]
        sd[f'linears.{k}.weight'] = params['linears']['weight'][k]
        if 'bias' in params['linears']:
            sd[f'linears.{k}.bias'] = params['linears']['bias'][k]
    _transformer(sd, 'transformer', params['transformer'], len(lm.transformer.layers))
    if 'out_norm' in params:
        _weight_bias(sd, 'out_norm', params['out_norm'])
    return _tensors(sd)


def discriminator_state_from_jax(disc: MultiScaleSTFTDiscriminator,
                                 params: Tree) -> tp.Dict[str, torch.Tensor]:
    """The port's state dict for ``disc`` holding the JAX MS-STFT
    discriminator's ``params`` (``scale{s}`` -> ``conv{i}`` -> weight, bias)."""
    sd: tp.Dict[str, tp.Any] = {}
    for s, sub in enumerate(disc.discriminators):
        for i in range(len(sub.convs)):
            _weight_bias(sd, f'discriminators.{s}.convs.{i}', params[f'scale{s}'][f'conv{i}'])
    return _tensors(sd)


def balancer_state_from_jax(state: Tree) -> tp.Dict[str, torch.Tensor]:
    """The JAX balancer's state (``{name: norm EMA, '_count': count}``) as
    the port's ``Balancer.init_state()`` dict."""
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in state.items()}


def t5_state_from_jax(params: Tree) -> tp.Dict[str, torch.Tensor]:
    """HF ``T5EncoderModel`` names for the JAX T5 encoder ``params``
    (``shared``, ``relative_attention_bias``, ``final_layer_norm``,
    ``block{i}``)."""
    sd: tp.Dict[str, tp.Any] = {
        'shared.weight': params['shared'],
        'encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight':
            params['relative_attention_bias'],
        'encoder.final_layer_norm.weight': params['final_layer_norm'],
    }
    i = 0
    while f'block{i}' in params:
        p, b = params[f'block{i}'], f'encoder.block.{i}'
        for name in ('q', 'k', 'v', 'o'):
            sd[f'{b}.layer.0.SelfAttention.{name}.weight'] = p[name]
        sd[f'{b}.layer.0.layer_norm.weight'] = p['ln_attn']
        sd[f'{b}.layer.1.layer_norm.weight'] = p['ln_ff']
        for name in ('wi', 'wi_0', 'wi_1', 'wo'):
            if name in p:
                sd[f'{b}.layer.1.DenseReluDense.{name}.weight'] = p[name]
        i += 1
    return _tensors(sd)


def conditioners_state_from_jax(provider: ConditioningProvider,
                                params: Tree) -> tp.Dict[str, torch.Tensor]:
    """The port's state dict for ``provider`` holding the JAX provider's
    ``params`` (``{name: conditioner params}``)."""
    out: tp.Dict[str, torch.Tensor] = {}
    for name, cond in provider.conditioners.items():
        p, base = params[name], f'conditioners.{name}'
        sd: tp.Dict[str, tp.Any] = {}
        if 'output_proj' in p:
            _weight_bias(sd, f'{base}.output_proj', p['output_proj'])
        if isinstance(cond, LUTConditioner):
            sd[f'{base}.embed.weight'] = p['embed']
        if isinstance(cond, ChordsEmbConditioner):
            sd[f'{base}.emb.weight'] = p['emb']
        if isinstance(cond, JointEmbeddingConditioner) and cond.rvq is not None:
            _rvq(sd, f'{base}.rvq', p['rvq'], cond.rvq.n_q)
        if isinstance(cond, StyleConditioner):
            for i in range(len(cond.embed)):
                sd[f'{base}.embed.{i}.weight'] = p['embed'][i]
            _transformer(sd, f'{base}.transformer', p['transformer'],
                         len(cond.transformer.layers))
            if cond.batch_norm is not None:
                sd[f'{base}.batch_norm.running_mean'] = p['bn']['mean']
                sd[f'{base}.batch_norm.running_var'] = p['bn']['var']
            _rvq(sd, f'{base}.rvq', p['rvq'], cond.rvq.n_q)
        out.update(_tensors(sd))
        if isinstance(cond, T5Conditioner):
            out.update({f'{base}.t5.{k}': v for k, v in t5_state_from_jax(p['t5']).items()})
    return out


def load_musicgen_from_jax(musicgen, codec_params: Tree, lm_params: Tree,
                           cond_params: Tree) -> None:
    """Load the JAX facade's ``codec_params``, ``lm_params`` and
    ``cond_params`` (numpy trees; quantizer states may be the JAX package's
    dataclass) into the port facade ``musicgen``, strictly; a style
    conditioner's codec from its params' ``codec``."""
    musicgen.compression_model.load_state_dict(
        encodec_state_from_jax(musicgen.compression_model, codec_params))
    musicgen.lm.load_state_dict(lm_state_from_jax(musicgen.lm, lm_params))
    provider = musicgen.condition_provider
    provider.load_state_dict(conditioners_state_from_jax(provider, cond_params))
    _load_feature_codecs(provider, cond_params)


def _load_feature_codecs(provider: ConditioningProvider, cond_params: Tree) -> None:
    """The style and drums conditioners' own codecs, from their params' ``codec``."""
    for name, cond in provider.conditioners.items():
        if isinstance(cond, (StyleConditioner, DrumsConditioner)):
            cond.feat_extractor.load_state_dict(
                encodec_state_from_jax(cond.feat_extractor, cond_params[name]['codec']))


def flow_matching_state_from_jax(model: FlowMatchingModel,
                                 params: Tree) -> tp.Dict[str, torch.Tensor]:
    """The port's state dict for JASCO's flow ``model`` holding the JAX
    ``FlowMatchingModel`` params."""
    sd: tp.Dict[str, tp.Any] = {'emb.weight': params['emb']['weight']}
    tr = params['transformer']
    _transformer(sd, 'transformer', tr, len(model.transformer.layers))
    for i, p in enumerate(tr.get('skip_projections', ())):
        _weight_bias(sd, f'transformer.skip_projections.{i}', p)
    for ours, theirs in (('temb_dense0', 'temb.dense.0'), ('temb_dense1', 'temb.dense.1'),
                         ('temb_proj', 'temb_proj'), ('linear', 'linear'),
                         ('out_norm', 'out_norm')):
        if ours in params:
            _weight_bias(sd, theirs, params[ours])
    return _tensors(sd)


def load_jasco_from_jax(model: FlowMatchingModel, provider: ConditioningProvider,
                        flow_params: Tree, cond_params: Tree) -> None:
    """Load JAX's JASCO flow ``flow_params`` and provider ``cond_params``
    into the port's model and provider, strictly, and the drums' codec
    from its params' ``codec``."""
    model.load_state_dict(flow_matching_state_from_jax(model, flow_params))
    provider.load_state_dict(conditioners_state_from_jax(provider, cond_params))
    _load_feature_codecs(provider, cond_params)


def _demucs_dconv(sd: dict, prefix: str, p: Tree) -> None:
    for j in range(len(p)):
        b, base = p[f'block{j}'], f'{prefix}.layers.{j}'
        for part, name in ((0, 'conv1'), (1, 'norm1'), (3, 'conv2'), (4, 'norm2')):
            _weight_bias(sd, f'{base}.{part}', b[name])
        sd[f'{base}.6.scale'] = b['scale']


def htdemucs_state_from_jax(model, params: Tree) -> tp.Dict[str, torch.Tensor]:
    """The port's ``HTDemucs`` state dict holding the JAX HTDemucs
    ``params`` (``model`` gives the config)."""
    cfg, sd = model.cfg, {}
    for branch in ('encoder', 'tencoder'):
        for i in range(cfg.depth):
            p, base = params[branch][f'layer{i}'], f'{branch}.{i}'
            _weight_bias(sd, f'{base}.conv', p['conv'])
            _weight_bias(sd, f'{base}.rewrite', p['rewrite'])
            _demucs_dconv(sd, f'{base}.dconv', p['dconv'])
    for branch in ('decoder', 'tdecoder'):
        for i in range(cfg.depth):
            p, base = params[branch][f'layer{i}'], f'{branch}.{i}'
            _weight_bias(sd, f'{base}.rewrite', p['rewrite'])
            _weight_bias(sd, f'{base}.conv_tr', p['convtr'])
    tf = params['crosstransformer']
    _weight_bias(sd, 'crosstransformer.norm_in', tf['norm_in_s'])
    _weight_bias(sd, 'crosstransformer.norm_in_t', tf['norm_in_t'])
    for i in range(cfg.t_depth):
        cross = i % 2 == 1
        attn = 'cross_attn' if cross else 'self_attn'
        for ours, layers in ((f'spec{i}', 'layers'), (f'time{i}', 'layers_t')):
            p, base = tf[ours], f'crosstransformer.{layers}.{i}'
            sd[f'{base}.{attn}.in_proj_weight'] = np.concatenate(
                [np.asarray(p[n]['weight']) for n in 'qkv'])
            sd[f'{base}.{attn}.in_proj_bias'] = np.concatenate(
                [np.asarray(p[n]['bias']) for n in 'qkv'])
            _weight_bias(sd, f'{base}.{attn}.out_proj', p['o'])
            norms = (('norm1', 'norm1'), ('norm_kv', 'norm2'), ('norm2', 'norm3')) if cross \
                else (('norm1', 'norm1'), ('norm2', 'norm2'))
            for name, theirs in norms + (('norm_out', 'norm_out'), ('lin1', 'linear1'),
                                         ('lin2', 'linear2')):
                _weight_bias(sd, f'{base}.{theirs}', p[name])
            sd[f'{base}.gamma_1.scale'] = p['scale1']
            sd[f'{base}.gamma_2.scale'] = p['scale2']
    sd['freq_emb.embedding.weight'] = params['freq_emb']
    for name in ('channel_upsampler', 'channel_downsampler', 'channel_upsampler_t',
                 'channel_downsampler_t'):
        if name in params:
            _weight_bias(sd, name, params[name])
    return _tensors(sd)


def diffusion_unet_state_from_jax(unet, params: Tree) -> tp.Dict[str, torch.Tensor]:
    """The port's ``DiffusionUnet`` state dict holding the JAX UNet's
    ``params`` (``unet`` gives the config)."""
    sd: tp.Dict[str, tp.Any] = {'embedding': params['embedding']}
    for i, emb in enumerate(params.get('embeddings', ())):
        sd[f'embeddings.{i}'] = emb
    for side, names in (('encoders', ('conv', 'norm')), ('decoders', ('norm', 'convtr'))):
        for d, p in enumerate(params[side]):
            for name in names:
                _weight_bias(sd, f'{side}.{d}.{name}', p[name])
            for j, res in enumerate(p['res']):
                for name in ('norm1', 'conv1', 'norm2', 'conv2'):
                    _weight_bias(sd, f'{side}.{d}.res.{j}.{name}', res[name])
    if 'bilstm' in params:
        for i, layer in enumerate(params['bilstm']['layers']):
            for name, value in layer.items():
                sd[f'bilstm.layers.{i}.{name}'] = value
        _weight_bias(sd, 'bilstm.linear', params['bilstm']['linear'])
    if 'transformer' in params:
        _transformer(sd, 'transformer', params['transformer'], len(unet.transformer.layers))
    if 'conv_codec' in params:
        _weight_bias(sd, 'conv_codec', params['conv_codec'])
    return _tensors(sd)
