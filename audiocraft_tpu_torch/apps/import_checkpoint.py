"""CLI: convert published torch Audiocraft checkpoints into the port's
checkpoint directories (counterpart of
``audiocraft_tpu/apps/import_checkpoint.py``).

    python -m audiocraft_tpu_torch.apps.import_checkpoint compression \\
        compression_state_dict.bin --out ckpt/compression [--config 32khz]
    python -m audiocraft_tpu_torch.apps.import_checkpoint lm state_dict.bin \\
        --out ckpt/lm --size small [--melody] [--t5-state t5.bin]

It reads the reference export layout (``{'xp.cfg': ..., 'best_state': ...}``,
reference utils/export.py:20-79), a raw state dict, an HF-layout state dict
or a ``.safetensors`` file; builds the model from the embedded ``xp.cfg``
through ``config.py`` when there is one (and reports how it differs from the
``--config`` / ``--size`` fallback), else from the fallback; maps the
weights through ``ckpt/torch_import`` or ``ckpt/hf_import``; and writes a
self-describing directory (``ckpt/io.save_checkpoint``) that
``ckpt/loaders.get_pretrained`` serves once ``compression/`` and ``lm/`` sit
side by side.  Every key no importer read is reported and recorded.

LM checkpoints keep the trained conditioner weights
(``condition_provider.conditioners.<name>.output_proj`` ...): dropping them
would condition on noise.  Untrusted checkpoints load with
``torch.load(weights_only=True)``; arbitrary pickle needs
``--unsafe-pickle``.  The models are built on the CUDA card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import typing as tp

import torch


def load_torch_state(path: str, allow_unsafe: bool = False) -> dict:
    """A torch checkpoint's state dict, ``{name: tensor or array}``."""
    return load_torch_package(path, allow_unsafe)[0]


def load_torch_package(path: str, allow_unsafe: bool = False
                       ) -> tp.Tuple[tp.Dict[str, tp.Any], tp.Optional[dict]]:
    """``(state dict, xp_cfg or None)`` of a torch checkpoint.

    The safe ``weights_only=True`` load comes first, with omegaconf's
    containers allowed where omegaconf is installed (exports embed ``xp.cfg``
    as one); arbitrary pickle only with ``allow_unsafe``.  ``xp_cfg`` is the
    embedded reference config as a plain dict, for ``config.py``."""
    if path.endswith('.safetensors'):
        from ..ckpt.hf_import import load_safetensors
        return load_safetensors(path), None

    def load_safe():
        try:
            return torch.load(path, map_location='cpu', weights_only=True)
        except Exception:
            safe: list = []
            try:
                import omegaconf
                safe = [omegaconf.DictConfig, omegaconf.ListConfig,
                        omegaconf.base.ContainerMetadata, omegaconf.base.Metadata,
                        omegaconf.nodes.ValueNode]
            except ImportError:
                pass
            with torch.serialization.safe_globals(safe):
                return torch.load(path, map_location='cpu', weights_only=True)

    try:
        pkg = load_safe()
    except Exception as exc:
        if not allow_unsafe:
            raise SystemExit(
                f"safe torch.load failed ({exc!r}); this checkpoint requires arbitrary pickle "
                "execution: rerun with --unsafe-pickle if you trust its source") from exc
        pkg = torch.load(path, map_location='cpu', weights_only=False)

    xp_cfg = None
    if isinstance(pkg, dict) and 'best_state' in pkg:
        from ..config import as_plain
        state, xp_cfg = pkg['best_state'], as_plain(pkg.get('xp.cfg')) or None
    elif isinstance(pkg, dict) and 'state_dict' in pkg:
        state = pkg['state_dict']
    else:
        state = pkg
    return dict(state), xp_cfg


def _config_only(build: tp.Callable[..., tp.Any]) -> tp.Any:
    """A builder's model with no weights (on the meta device), for
    comparing configs."""
    from ..nn import init
    with init.allocate_only('meta'):
        return build(device='meta')


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('kind', choices=['compression', 'lm'])
    parser.add_argument('checkpoint')
    parser.add_argument('--out', required=True)
    parser.add_argument('--config', default='32khz', choices=['32khz', '24khz', 'debug'])
    parser.add_argument('--size', default='small',
                        choices=['small', 'medium', 'large', 'debug'])
    parser.add_argument('--melody', action='store_true')
    parser.add_argument('--style', action='store_true')
    parser.add_argument('--t5-state', default=None,
                        help='a torch T5 encoder state dict to bundle (published LM exports '
                             'leave the frozen T5 out)')
    parser.add_argument('--hf-config', default=None,
                        help='the HF config.json of a compression import in the HF EnCodec '
                             "layout (a composite MusicGen config.json works: its "
                             "audio_encoder section is used)")
    parser.add_argument('--unsafe-pickle', action='store_true',
                        help='allow torch.load with weights_only=False (executes arbitrary '
                             'pickle code)')
    parser.add_argument('--compute-dtype', default='bfloat16', choices=['bfloat16', 'float32'],
                        help='the codec compute dtype when building from an embedded xp.cfg '
                             'or an HF config')
    parser.add_argument('--ignore-embedded-cfg', action='store_true',
                        help='build from the --config/--size fallback even when the '
                             'checkpoint embeds an xp.cfg')
    parser.add_argument('--device', default=None,
                        help="where the models are built (default: the CUDA card; 'cpu')")
    args = parser.parse_args(argv)

    from .. import builders
    from ..ckpt.hf_import import HF_HARMLESS_PATTERNS, import_musicgen_hf
    from ..ckpt.io import save_checkpoint
    from ..ckpt.torch_import import (HARMLESS_BUFFER_PATTERNS, KeyTracker, import_conditioners,
                                     import_encodec, import_lm, import_t5, merge_params,
                                     to_tensors)
    from ..config import compression_model_from_cfg, diff_models, lm_from_cfg

    device = builders.resolve_device(args.device)
    dtype = None if args.compute_dtype == 'float32' else args.compute_dtype
    state, xp_cfg = load_torch_package(args.checkpoint, allow_unsafe=args.unsafe_pickle)
    if args.ignore_embedded_cfg:
        xp_cfg = None

    def fallback_codec(**kw):
        return {'32khz': builders.get_encodec_32khz, '24khz': builders.get_encodec_24khz,
                'debug': builders.get_debug_compression_model}[args.config](**kw)

    def fallback_lm(**kw):
        if args.size == 'debug':
            return builders.get_debug_musicgen_lm(**kw)
        return builders.get_musicgen_lm(args.size, melody=args.melody, style=args.style, **kw)

    def report_cfg_build(report, built, fallback, label):
        if report.summary():
            print(f"[{label} <- embedded xp.cfg]\n{report.summary()}", file=sys.stderr)
        delta = diff_models(built, fallback)
        if delta:
            flag = 'config' if args.kind == 'compression' else 'size'
            print(f"[{label}] embedded xp.cfg differs from the --{flag} fallback "
                  "(xp.cfg wins):", file=sys.stderr)
            for line in delta:
                print(f"  {line}", file=sys.stderr)

    if args.kind == 'compression':
        # composite MusicGen dumps carry the codec under `audio_encoder.`
        if any(k.startswith('audio_encoder.') for k in state):
            state = {k[len('audio_encoder.'):]: v for k, v in state.items()
                     if k.startswith('audio_encoder.')}
        sd = KeyTracker(state)
        if 'quantizer.layers.0.codebook.embed' in sd:
            from ..codec.wrappers import HFEncodecCompressionModel
            hf_cfg: dict = {}
            if args.hf_config:
                with open(args.hf_config) as fh:
                    hf_cfg = json.load(fh)
                hf_cfg = hf_cfg.get('audio_encoder', hf_cfg)
            else:
                print("[codec] HF layout without --hf-config: building from the EnCodec "
                      "defaults (24 kHz); pass the checkpoint's config.json to be sure",
                      file=sys.stderr)
            print('[codec] detected the HF Transformers EnCodec layout', file=sys.stderr)
            to_save = HFEncodecCompressionModel.from_hf_config(hf_cfg, compute_dtype=dtype,
                                                               device=device)
            to_save.model.load_state_dict(to_save.import_hf_state(sd))
        else:
            if xp_cfg is not None and 'encodec' in xp_cfg:
                to_save, report = compression_model_from_cfg(xp_cfg, compute_dtype=dtype,
                                                             device=device)
                report_cfg_build(report, to_save, _config_only(fallback_codec), 'codec')
            else:
                to_save = fallback_codec(device=device)
            to_save.load_state_dict(to_tensors(import_encodec(to_save, sd)))
    else:
        sd = KeyTracker(state)
        if xp_cfg is not None and 'transformer_lm' in xp_cfg:
            lm, provider, report = lm_from_cfg(xp_cfg, device=device)
            report_cfg_build(report, lm, _config_only(fallback_lm)[0], 'lm')
        else:
            lm, provider = fallback_lm(device=device)
        if 'emb.0.weight' in sd:
            lm_state, cond = import_lm(lm, sd), import_conditioners(provider, sd)
        else:
            lm_state, cond = import_musicgen_hf(lm, sd, provider=provider)
            print("[lm] detected the HF Transformers checkpoint layout", file=sys.stderr)
        lm.load_state_dict(to_tensors(lm_state))
        merge_params(provider, cond)
        for name in provider.conditioners:
            if not any(k.startswith(f'conditioners.{name}.') for k in cond):
                print(f"WARNING: conditioner '{name}' has no trained parameters in this "
                      "checkpoint; it keeps its seeded init", file=sys.stderr)
        if args.t5_state is not None:
            t5_sd = load_torch_state(args.t5_state, allow_unsafe=args.unsafe_pickle)
            for module in provider.conditioners.values():
                if type(module).__name__ == 'T5Conditioner':
                    cfg = module.t5_config
                    module.t5.load_state_dict(to_tensors(
                        import_t5(t5_sd, cfg.num_layers, gated=cfg.gated_act)))
        to_save = {'lm': lm, 'condition_provider': provider}

    leftover = sd.unused(ignore=HARMLESS_BUFFER_PATTERNS + HF_HARMLESS_PATTERNS)
    audio_enc = [k for k in leftover if k.startswith('audio_encoder.')]
    if audio_enc:
        print(f"NOTE: {len(audio_enc)} 'audio_encoder.*' keys skipped: import the codec "
              "separately with kind=compression", file=sys.stderr)
        leftover = [k for k in leftover if not k.startswith('audio_encoder.')]
    if leftover:
        print(f"WARNING: {len(leftover)} state-dict keys were NOT imported:", file=sys.stderr)
        for key in leftover:
            print(f"  - {key}", file=sys.stderr)
    path = save_checkpoint(args.out, to_save,
                           extra={'source': args.checkpoint, 'unmapped_keys': leftover})
    print(f"imported {len(sd.used)}/{len(sd)} tensors -> {path}")


if __name__ == '__main__':
    main()
