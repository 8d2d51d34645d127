"""Reference-config bridge: build the port's models from the configs that
checkpoints embed (counterpart of ``audiocraft_tpu/config.py``).

Published Audiocraft checkpoints embed their training configuration as an
``xp.cfg`` Hydra/OmegaConf tree, and the reference rebuilds its models from
it (reference models/loaders.py:158-214, builders.py:70-254).  This module
maps that schema onto the port's constructors, with a disposition for every
key:

* **mapped**: carried into a constructor argument (possibly renamed, e.g.
  ``activation_params.alpha`` to ``activation_alpha``);
* **runtime**: execution settings with no numerical meaning here
  (``custom``, ``memory_efficient``, ``device``, ``dtype``, ...), recorded
  and dropped;
* **training-only**: optimiser and dropout settings the trainer owns,
  recorded and dropped;
* **unknown**: anything else, collected in the report; under
  ``strict=True`` it raises rather than build the wrong model.

:func:`diff_models` lists the fields in which two models' configs differ,
e.g. a model built from ``xp.cfg`` against the builders' fallback.  Every
builder here takes ``device=`` (None: the CUDA card) and a ``seed`` for its
random weights.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

__all__ = [
    'CfgReport', 'as_plain', 'compression_model_from_cfg', 'lm_from_cfg',
    'pattern_provider_from_cfg', 'conditioners_from_cfg', 'fuser_from_cfg',
    'diff_models',
]

Device = tp.Union[str, torch.device, None]


def as_plain(obj: tp.Any) -> tp.Any:
    """OmegaConf containers (how ``xp.cfg`` unpickles where omegaconf is
    installed) as plain dicts and lists, recursively; plain containers pass
    through."""
    try:
        import omegaconf
        kinds = (omegaconf.DictConfig, omegaconf.ListConfig)
        if all(isinstance(k, type) for k in kinds) and isinstance(obj, kinds):
            obj = omegaconf.OmegaConf.to_container(obj, resolve=True)
    except (ImportError, TypeError, AttributeError):
        # absent, or replaced by an inert stand-in
        pass
    if isinstance(obj, dict):
        return {k: as_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [as_plain(v) for v in obj]
    return obj


@dataclasses.dataclass
class CfgReport:
    """Where each config key that was not mapped went."""
    runtime: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)
    training_only: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)
    unknown: tp.Dict[str, tp.Any] = dataclasses.field(default_factory=dict)
    notes: tp.List[str] = dataclasses.field(default_factory=list)

    def raise_if_unknown(self) -> None:
        if self.unknown:
            raise ValueError('unrecognized reference-config keys (strict mode): '
                             + ', '.join(f'{k}={v!r}' for k, v in self.unknown.items()))

    def summary(self) -> str:
        lines = []
        if self.unknown:
            lines.append('UNKNOWN keys (model may be wrong!): ' + ', '.join(sorted(self.unknown)))
        if self.runtime:
            lines.append('dropped runtime keys: ' + ', '.join(sorted(self.runtime)))
        if self.training_only:
            lines.append('dropped training-only keys: ' + ', '.join(sorted(self.training_only)))
        lines.extend(self.notes)
        return '\n'.join(lines)


#: fields whose None is a value (not "unset")
_NONE_IS_VALUE = ('past_context', 'weight_init', 'depthwise_init', 'layer_scale',
                  'final_activation')


def _take(src: tp.Dict[str, tp.Any], mapping: tp.Dict[str, str],
          out: tp.Dict[str, tp.Any]) -> None:
    """Move the ``mapping`` keys (config name -> argument name) from ``src``
    to ``out``; lists become tuples."""
    for cfg_key, field in mapping.items():
        if cfg_key in src:
            val = src.pop(cfg_key)
            if val is not None or field in _NONE_IS_VALUE:
                out[field] = tuple(val) if isinstance(val, list) else val


def _classify_leftovers(src: tp.Dict[str, tp.Any], runtime: tp.Set[str],
                        training: tp.Set[str], report: CfgReport, prefix: str) -> None:
    for key, val in src.items():
        if key in runtime:
            report.runtime[prefix + key] = val
        elif key in training:
            report.training_only[prefix + key] = val
        else:
            report.unknown[prefix + key] = val


# --------------------------------------------------------------- compression

#: reference seanet schema (builders.py:56-67 feeds modules/seanet.py:63-258)
_SEANET_FIELDS = {k: k for k in (
    'channels', 'dimension', 'n_filters', 'n_residual_layers', 'ratios', 'activation', 'norm',
    'kernel_size', 'last_kernel_size', 'residual_kernel_size', 'dilation_base', 'causal',
    'pad_mode', 'true_skip', 'compress', 'lstm', 'disable_norm_outer_blocks')}
_DECODER_ONLY = {'trim_right_ratio': 'trim_right_ratio', 'final_activation': 'final_activation'}
_RVQ_FIELDS = {k: k for k in (
    'n_q', 'bins', 'decay', 'kmeans_init', 'kmeans_iters', 'threshold_ema_dead_code',
    'q_dropout', 'orthogonal_reg_weight', 'orthogonal_reg_active_codes_only')}


def _seanet_kwargs(common: tp.Dict[str, tp.Any], override: tp.Dict[str, tp.Any],
                   decoder: bool, report: CfgReport, prefix: str) -> tp.Dict[str, tp.Any]:
    src = {**common, **override}
    out: tp.Dict[str, tp.Any] = {}
    _take(src, {**_SEANET_FIELDS, **(_DECODER_ONLY if decoder else {})}, out)
    act_params = dict(src.pop('activation_params', None) or {})
    if 'alpha' in act_params:
        out['activation_alpha'] = act_params.pop('alpha')
    for k, v in act_params.items():
        report.unknown[f'{prefix}activation_params.{k}'] = v
    for group in ('norm_params', 'final_activation_params'):
        for k, v in dict(src.pop(group, None) or {}).items():
            report.unknown[f'{prefix}{group}.{k}'] = v
    if not decoder:
        # encoder configs never carry these
        src.pop('trim_right_ratio', None)
        src.pop('final_activation', None)
    _classify_leftovers(src, runtime=set(), training=set(), report=report, prefix=prefix)
    return out


def compression_model_from_cfg(cfg: tp.Dict[str, tp.Any],
                               compute_dtype: tp.Optional[str] = None, strict: bool = False,
                               *, device: Device = None, seed: int = 0):
    """Reference ``builders.get_compression_model`` (builders.py:70-91) over
    an ``xp.cfg``.  Returns ``(EncodecModel, CfgReport)``."""
    from .builders import _finish, resolve_device
    from .codec.encodec import EncodecModel
    from .nn.seanet import SEANetDecoder, SEANetEncoder
    from .quant.base import DummyQuantizer
    from .quant.vq import ResidualVectorQuantizer

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    cfg = as_plain(cfg)
    report = CfgReport()
    kind = cfg.get('compression_model', 'encodec')
    if kind != 'encodec':
        raise ValueError(f'unsupported compression_model: {kind!r}')

    enc = dict(cfg.get('encodec', {}))
    autoencoder = enc.pop('autoencoder', 'seanet')
    if autoencoder != 'seanet':
        raise ValueError(f'unsupported autoencoder: {autoencoder!r}')
    quantizer_name = enc.pop('quantizer', 'rvq')
    sample_rate = int(enc.pop('sample_rate', 32000))
    channels = int(enc.pop('channels', 1))
    causal = bool(enc.pop('causal', False))
    # 'renorm' is the deprecated spelling (reference builders.py:84-86)
    renormalize = bool(enc.pop('renormalize', enc.pop('renorm', False)))
    enc.pop('renorm', None)
    _classify_leftovers(enc, runtime={'device', 'dtype', 'autocast'}, training=set(),
                        report=report, prefix='encodec.')

    seanet = dict(cfg.get('seanet', {}))
    enc_over = dict(seanet.pop('encoder', None) or {})
    dec_over = dict(seanet.pop('decoder', None) or {})
    encoder = SEANetEncoder(**_seanet_kwargs(seanet, enc_over, False, report,
                                             'seanet.encoder.'), generator=gen)
    decoder = SEANetDecoder(**_seanet_kwargs(seanet, dec_over, True, report,
                                             'seanet.decoder.'), generator=gen)

    quantizer: torch.nn.Module
    if quantizer_name == 'rvq':
        rvq = dict(cfg.get('rvq', {}))
        qkw: tp.Dict[str, tp.Any] = {}
        _take(rvq, _RVQ_FIELDS, qkw)
        max_codes = rvq.pop('orthogonal_reg_max_codes', None)
        if max_codes is not None:
            report.unknown['rvq.orthogonal_reg_max_codes'] = max_codes
        _classify_leftovers(rvq, runtime=set(), training=set(), report=report, prefix='rvq.')
        quantizer = ResidualVectorQuantizer(dimension=encoder.dimension, generator=gen, **qkw)
    elif quantizer_name == 'no_quant':
        quantizer = DummyQuantizer(dimension=encoder.dimension)
    else:
        raise ValueError(f'unsupported quantizer: {quantizer_name!r}')

    hop = int(np.prod(encoder.ratios))
    # lstm_kernel is routing, not architecture: the production builders' value
    model = EncodecModel(encoder, decoder, quantizer, frame_rate=sample_rate // hop,
                         sample_rate=sample_rate, channels=channels, causal=causal,
                         renormalize=renormalize, compute_dtype=compute_dtype,
                         lstm_kernel='auto')
    if strict:
        report.raise_if_unknown()
    return _finish(model, device), report


# ------------------------------------------------------------------------ LM

#: reference transformer_lm schema (builders.py:136-175 feeds lm.py:145 and
#: modules/transformer.py:577) -> LMModel argument names
_TL_FIELDS = {k: k for k in (
    'dim', 'num_heads', 'num_layers', 'n_q', 'card', 'norm_first', 'bias_proj', 'bias_ff',
    'bias_attn', 'cross_attention', 'causal', 'past_context', 'positional_embedding',
    'weight_init', 'depthwise_init', 'zero_bias_init', 'qk_layer_norm', 'qk_layer_norm_cross',
    'kv_repeat', 'activation', 'two_step_cfg', 'layer_scale')}
#: execution settings with no numerical content here
_TL_RUNTIME = {'custom', 'memory_efficient', 'attention_as_float32', 'device', 'dtype',
               'autocast', 'autocast_dtype', 'safe_streaming', 'cross_attention_pos_emb'}
_TL_TRAINING = {'dropout', 'attention_dropout', 'emb_lr', 'lr', 'weight_decay', 'betas', 'eps'}
_MAGNET_FIELDS = {k: k for k in ('subcodes_context', 'compression_model_framerate',
                                 'segment_duration', 'span_len')}


def pattern_provider_from_cfg(n_q: int, pat_cfg: tp.Dict[str, tp.Any],
                              q_modeling: tp.Optional[str] = None):
    """Reference ``get_codebooks_pattern_provider`` (builders.py:240-254) and
    the ``q_modeling`` fallback (builders.py:153-160)."""
    from .patterns.pattern import (CoarseFirstPattern, DelayedPatternProvider, MusicLMPattern,
                                   ParallelPatternProvider, UnrolledPatternProvider)

    pat_cfg = dict(as_plain(pat_cfg) or {})
    modeling = pat_cfg.get('modeling')
    if modeling is None:
        if q_modeling is None:
            raise ValueError('codebooks_pattern.modeling and transformer_lm.q_modeling are '
                             'both unset')
        modeling = q_modeling
        pat_cfg = {'modeling': modeling, 'delay': {'delays': list(range(n_q))}}
    providers = {'parallel': ParallelPatternProvider, 'delay': DelayedPatternProvider,
                 'unroll': UnrolledPatternProvider, 'coarse_first': CoarseFirstPattern,
                 'musiclm': MusicLMPattern}
    return providers[modeling](n_q, **dict(pat_cfg.get(modeling, {}) or {}))


def fuser_from_cfg(fuser_cfg: tp.Dict[str, tp.Any]):
    """Reference ``get_condition_fuser`` (builders.py:230-238); empty method
    lists are dropped, as the builders never write them."""
    from .cond.fuser import ConditionFuser

    fuser_cfg = dict(as_plain(fuser_cfg) or {})
    methods = ('sum', 'cross', 'prepend', 'ignore', 'input_interpolate')
    fuse2cond = {m: list(fuser_cfg.pop(m) or []) for m in methods if m in fuser_cfg}
    return ConditionFuser.from_dict({m: v for m, v in fuse2cond.items() if v}, **fuser_cfg)


def conditioners_from_cfg(cfg: tp.Dict[str, tp.Any], output_dim: int,
                          report: tp.Optional[CfgReport] = None, *, device: Device = None,
                          seed: int = 0):
    """Reference ``get_conditioner_provider`` (builders.py:178-227) over the
    ``conditioners`` subtree.  Returns ``(ConditioningProvider, CfgReport)``.
    Options that concern the training data pipeline (evaluation wavs,
    embedding caches, spaCy text normalisation) are recorded and dropped."""
    from .builders import _finish, get_encodec_32khz, resolve_device
    from .cond.conditioners import ConditioningProvider, LUTConditioner, T5Conditioner

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    report = report if report is not None else CfgReport()
    cfg = as_plain(cfg)
    duration = float((cfg.get('dataset') or {}).get('segment_duration') or 30.0)
    cond_cfg = dict(cfg.get('conditioners') or {})
    args = dict(cond_cfg.pop('args', None) or {})
    for k in ('merge_text_conditions_p', 'drop_desc_p'):
        # training-time text augmentation (reference loaders.py:186-187)
        if k in args:
            report.training_only[f'conditioners.args.{k}'] = args.pop(k)
    for k, v in args.items():
        report.unknown[f'conditioners.args.{k}'] = v

    def pick(margs: tp.Dict[str, tp.Any], names: tp.Sequence[str]) -> tp.Dict[str, tp.Any]:
        return {k: margs.pop(k) for k in names if k in margs}

    conditioners: tp.Dict[str, torch.nn.Module] = {}
    for name, one in cond_cfg.items():
        one = dict(one)
        model_type = one.pop('model')
        margs = dict(one.pop(model_type, None) or {})
        prefix = f'conditioners.{name}.{model_type}.'
        for k, v in one.items():
            report.unknown[f'conditioners.{name}.{k}'] = v
        if model_type == 't5':
            if margs.pop('normalize_text', False):
                report.notes.append(
                    f"conditioner '{name}': normalize_text=True needs spaCy lemmatization; "
                    "the tokenizer falls back to identity (cond/tokenizers.py)")
            if margs.get('word_dropout'):
                # applied only in training (reference conditioners.py:480-487)
                report.training_only[prefix + 'word_dropout'] = margs.pop('word_dropout')
            margs.pop('word_dropout', None)
            conditioners[name] = T5Conditioner(output_dim=output_dim, generator=gen,
                                               **pick(margs, ('name', 'finetune')))
        elif model_type == 'lut':
            conditioners[name] = LUTConditioner(
                output_dim=output_dim, generator=gen,
                **pick(margs, ('n_bins', 'dim', 'tokenizer', 'pad_idx')))
        elif model_type == 'chroma_stem':
            from .cond.chroma_cond import ChromaConditioner
            for k in ('cache_path', 'eval_wavs', 'n_eval_wavs'):
                if margs.get(k):
                    report.training_only[prefix + k] = margs.pop(k)
                else:
                    margs.pop(k, None)
            kw = pick(margs, ('sample_rate', 'n_chroma', 'radix2_exp', 'duration',
                              'match_len_on_eval', 'argmax'))
            kw.setdefault('duration', duration)
            conditioners[name] = ChromaConditioner(output_dim=output_dim, generator=gen, **kw)
        elif model_type == 'style':
            from .cond.style_cond import StyleConditioner
            for k in ('model_name', 'cache_path'):
                if k in margs:
                    report.runtime[prefix + k] = margs.pop(k)
            kw = pick(margs, ('transformer_scale', 'ds_factor', 'encodec_n_q', 'n_q_out',
                              'eval_q', 'q_dropout', 'bins', 'varying_lengths', 'batch_norm',
                              'rvq_threshold_ema_dead_code', 'sample_rate',
                              'use_middle_of_segment', 'ds_rate_compression',
                              'num_codebooks_lm', 'length'))
            if 'varying_lengths' in kw:
                kw['varying_lengths'] = tuple(kw['varying_lengths'])
            conditioners[name] = StyleConditioner(
                feat_extractor=get_encodec_32khz(compute_dtype=None, device=device,
                                                 seed=seed + 1),
                output_dim=output_dim, generator=gen, **kw)
        elif model_type == 'clap':
            from .cond.joint_embed import JointEmbeddingConditioner
            for k in ('checkpoint', 'model_arch', 'enable_fusion', 'cache_path',
                      'sample_rate', 'audio_stride', 'normalize', 'batch_size'):
                if k in margs:
                    report.runtime[prefix + k] = margs.pop(k)
            conditioners[name] = JointEmbeddingConditioner(
                output_dim=output_dim, generator=gen,
                **pick(margs, ('dim', 'attribute', 'quantize', 'n_q', 'bins', 'text_p')))
            report.notes.append(f"conditioner '{name}': attach the CLAP network with "
                                "cond.clap.make_clap_embed_fns (its weights are a runtime seam)")
        else:
            report.unknown[f'conditioners.{name}.model'] = model_type
            continue
        for k, v in margs.items():
            report.unknown[prefix + k] = v
    return _finish(ConditioningProvider.from_dict(conditioners), device), report


def lm_from_cfg(cfg: tp.Dict[str, tp.Any], strict: bool = False,
                compression_model_framerate: int = 50, *, device: Device = None,
                seed: int = 0):
    """Reference ``builders.get_lm_model`` (builders.py:136-175) and the
    MAGNeT loader's settings (loaders.py:217-240) over an ``xp.cfg``.
    Returns ``(lm, provider, CfgReport)``; ``lm`` is an ``LMModel`` or a
    ``MagnetLMModel`` by ``cfg.lm_model``."""
    from .builders import _finish, resolve_device
    from .lm.model import LMModel

    device = resolve_device(device)
    cfg = as_plain(cfg)
    report = CfgReport()
    lm_kind = cfg.get('lm_model', 'transformer_lm')
    if lm_kind not in ('transformer_lm', 'transformer_lm_magnet'):
        raise ValueError(f'unsupported lm_model: {lm_kind!r}')
    magnet = lm_kind == 'transformer_lm_magnet'

    tl = dict(cfg.get('transformer_lm', {}))
    q_modeling = tl.pop('q_modeling', None)
    n_q = int(tl.get('n_q', 8))

    fuser = fuser_from_cfg(cfg.get('fuser', {}))
    provider, _ = conditioners_from_cfg(cfg, output_dim=int(tl['dim']), report=report,
                                        device=device, seed=seed + 1)
    pattern_provider = pattern_provider_from_cfg(
        n_q, cfg.get('codebooks_pattern', {'modeling': None}), q_modeling)

    kwargs: tp.Dict[str, tp.Any] = {}
    _take(tl, _TL_FIELDS, kwargs)
    if 'hidden_scale' in tl:
        kwargs['hidden_scale'] = int(tl.pop('hidden_scale'))
    ckpting = tl.pop('checkpointing', None)
    if ckpting is not None:
        kwargs['checkpointing'] = ckpting not in (False, 'none', None)
    norm = tl.pop('norm', 'layer_norm')
    if norm != 'layer_norm':
        report.unknown['transformer_lm.norm'] = norm
    if tl.pop('xpos', False):
        report.unknown['transformer_lm.xpos'] = True
    if magnet:
        _take(tl, _MAGNET_FIELDS, kwargs)
        masking = as_plain(cfg.get('masking') or {})
        if 'span_len' in masking:
            kwargs['span_len'] = int(masking['span_len'])
        dataset = as_plain(cfg.get('dataset') or {})
        if dataset.get('segment_duration'):
            kwargs['segment_duration'] = int(dataset['segment_duration'])
        kwargs.setdefault('compression_model_framerate', compression_model_framerate)
    else:
        for k in _MAGNET_FIELDS:
            if k in tl:
                report.unknown[f'transformer_lm.{k}'] = tl.pop(k)
    if (tl.get('dropout') or 0) != 0:
        report.notes.append(f"transformer_lm.dropout={tl['dropout']} is a training setting; "
                            "inference runs without dropout (as reference eval() does)")
    _classify_leftovers(tl, runtime=_TL_RUNTIME, training=_TL_TRAINING, report=report,
                        prefix='transformer_lm.')

    # CFG coefficients (builders.py:143-147); training_dropout is the trainer's
    cf = dict(as_plain(cfg.get('classifier_free_guidance') or {}))
    if 'inference_coef' in cf:
        kwargs['cfg_coef'] = float(cf.pop('inference_coef'))
    if 'training_dropout' in cf:
        report.training_only['classifier_free_guidance.training_dropout'] = \
            cf.pop('training_dropout')
    attr_drop = as_plain(cfg.get('attribute_dropout'))
    if attr_drop:
        report.training_only['attribute_dropout'] = attr_drop
    if fuser.fuse_list('cross'):
        # enforced programmatically, reference builders.py:150-151
        kwargs['cross_attention'] = True

    lm_cls: tp.Any = LMModel
    if magnet:
        from .lm.magnet import MagnetLMModel
        lm_cls = MagnetLMModel
    # attn_kernel is routing, not architecture: the builders' value
    kwargs.setdefault('attn_kernel', 'auto')
    lm = lm_cls(fuser, pattern_provider=pattern_provider,
                generator=torch.Generator().manual_seed(seed), **kwargs)
    if strict:
        report.raise_if_unknown()
    return _finish(lm, device), provider, report


# ----------------------------------------------------------- config diffing

def diff_models(ours: tp.Any, theirs: tp.Any, prefix: str = '') -> tp.List[str]:
    """The configuration fields in which two models (or bundles, or parts)
    differ, as ``field: a != b`` lines; empty when they are the same
    architecture.  Compares what ``ckpt/io.config_to_dict`` writes."""
    from .ckpt.io import config_to_dict
    return _diff(config_to_dict(ours), config_to_dict(theirs), prefix)


def _diff(a: tp.Any, b: tp.Any, prefix: str) -> tp.List[str]:
    if isinstance(a, dict) and isinstance(b, dict):
        if a.get('__class__') != b.get('__class__'):
            return [f'{prefix.rstrip(".") or "model"}: type {a.get("__class__")} != '
                    f'{b.get("__class__")}']
        if '__class__' in a:
            a, b = a.get('fields', a.get('kwargs')), b.get('fields', b.get('kwargs'))
        elif '__seq__' in a:
            a, b = a['items'], b['items']
    if isinstance(a, dict) and isinstance(b, dict):
        return [line for key in sorted(set(a) | set(b))
                for line in _diff(a.get(key), b.get(key), f'{prefix}{key}.')]
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [line for i, (x, y) in enumerate(zip(a, b))
                for line in _diff(x, y, f'{prefix}{i}.')]
    if a != b:
        return [f'{prefix.rstrip(".")}: {a!r} != {b!r}']
    return []
