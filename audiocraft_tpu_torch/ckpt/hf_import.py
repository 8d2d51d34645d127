"""HuggingFace-layout MusicGen checkpoints into the port
(counterpart of ``audiocraft_tpu/ckpt/hf_import.py``).

Published MusicGen weights mostly circulate in the HF Transformers layout
(``MusicgenForConditionalGeneration`` / ``MusicgenForCausalLM``), which
renames and re-splits the Audiocraft modules:

* the packed ``in_proj_weight`` as ``q_proj`` / ``k_proj`` / ``v_proj``;
* ``norm1`` / ``norm_cross`` / ``norm2`` as ``self_attn_layer_norm`` /
  ``encoder_attn_layer_norm`` / ``final_layer_norm``;
* ``linear1`` / ``linear2`` as ``fc1`` / ``fc2``;
* ``emb.{k}`` / ``linears.{k}`` as ``embed_tokens.{k}`` / ``lm_heads.{k}``,
  ``out_norm`` as ``layer_norm``;
* the T5 conditioner's trained ``output_proj`` as the top-level
  ``enc_to_dec_proj``.

The architecture is the reference's (pre-norm, no biases, sinusoidal
positions, the delay pattern), so these maps give the port's state dicts
under the reference names.  Inputs are flat ``{name: array or tensor}``
dicts; wrap them in ``torch_import.KeyTracker`` for the unmapped keys.

Snapshot weights are read without the ``safetensors`` package:
:func:`load_safetensors` parses the format itself (an 8-byte little-endian
header length, a JSON header of dtype, shape and byte offsets, then the raw
buffers).
"""

from __future__ import annotations

import json
import struct
import typing as tp
from pathlib import Path

import numpy as np
import torch

from .torch_import import Array, StateDict, as_array, import_t5

#: HF buffers with no place in the port (recomputed, or bookkeeping).
HF_HARMLESS_PATTERNS = (
    r"embed_positions\.weights$",       # sinusoidal buffer, recomputed
    r"position_bias",                    # T5 relative bias handled in-tree
    r"num_batches_tracked$",
)

_SAFETENSORS_DTYPES = {'F32': np.float32, 'F16': np.float16, 'I64': np.int64,
                       'I32': np.int32, 'BF16': np.uint16}


def load_safetensors(path: tp.Union[str, Path]) -> tp.Dict[str, Array]:
    """The tensors of a ``.safetensors`` file as numpy arrays (F32, F16,
    BF16, I64, I32; BF16 widened to fp32 exactly)."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack('<Q', raw[:8])
    header = json.loads(raw[8:8 + n])
    base = 8 + n
    out: tp.Dict[str, Array] = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        if info['dtype'] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{name}: safetensors dtype {info['dtype']} is not supported")
        start, end = info['data_offsets']
        arr = np.frombuffer(raw, dtype=_SAFETENSORS_DTYPES[info['dtype']],
                            count=(end - start) // np.dtype(
                                _SAFETENSORS_DTYPES[info['dtype']]).itemsize,
                            offset=base + start)
        if info['dtype'] == 'BF16':
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.reshape(info['shape']).copy()
    return out


def detect_lm_prefix(sd: tp.Mapping[str, tp.Any]) -> tp.Tuple[str, str]:
    """``(decoder_prefix, heads_prefix)`` of the decoder tower and the heads
    in an HF state dict: ``MusicgenForConditionalGeneration``
    (``decoder.model.decoder.*``, ``decoder.lm_heads.*``),
    ``MusicgenForCausalLM`` (``model.decoder.*``, ``lm_heads.*``) or a bare
    decoder dump."""
    for dec, heads in (("decoder.model.decoder.", "decoder."), ("model.decoder.", ""),
                       ("decoder.", ""), ("", "")):
        if f"{dec}layers.0.self_attn.q_proj.weight" in sd:
            return dec, heads
    raise KeyError("state dict does not look like an HF MusicGen checkpoint "
                   "(no '<prefix>layers.0.self_attn.q_proj.weight' key found)")


def _linear(sd: StateDict, prefix: str) -> tp.Dict[str, Array]:
    out = {'weight': as_array(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out['bias'] = as_array(sd[f"{prefix}.bias"])
    return out


def _under(prefix: str, tree: tp.Mapping[str, Array]) -> tp.Dict[str, Array]:
    return {f'{prefix}.{k}': v for k, v in tree.items()}


def _hf_attention(sd: StateDict, prefix: str) -> tp.Dict[str, Array]:
    """HF's split q/k/v projections packed into ``in_proj_weight``."""
    out = {'in_proj_weight': np.concatenate(
        [as_array(sd[f"{prefix}.{p}_proj.weight"]) for p in 'qkv'], axis=0),
        **_under('out_proj', _linear(sd, f"{prefix}.out_proj"))}
    if f"{prefix}.q_proj.bias" in sd:
        out['in_proj_bias'] = np.concatenate(
            [as_array(sd[f"{prefix}.{p}_proj.bias"]) for p in 'qkv'], axis=0)
    return out


def _hf_layer(sd: StateDict, prefix: str) -> tp.Dict[str, Array]:
    out = _under('self_attn', _hf_attention(sd, f"{prefix}.self_attn"))
    for ours, theirs in (('norm1', 'self_attn_layer_norm'), ('norm2', 'final_layer_norm'),
                         ('linear1', 'fc1'), ('linear2', 'fc2')):
        out.update(_under(ours, _linear(sd, f"{prefix}.{theirs}")))
    if f"{prefix}.encoder_attn.q_proj.weight" in sd:
        out.update(_under('cross_attention', _hf_attention(sd, f"{prefix}.encoder_attn")))
        out.update(_under('norm_cross', _linear(sd, f"{prefix}.encoder_attn_layer_norm")))
    return out


def import_lm_hf(lm: torch.nn.Module, sd: StateDict) -> tp.Dict[str, Array]:
    """An HF MusicGen decoder state dict as the port ``lm``'s state dict, at
    the prefixes :func:`detect_lm_prefix` finds."""
    dec, heads = detect_lm_prefix(sd)
    out: tp.Dict[str, Array] = {}
    for k in range(lm.n_q):
        out[f'emb.{k}.weight'] = as_array(sd[f"{dec}embed_tokens.{k}.weight"])
        out[f'linears.{k}.weight'] = as_array(sd[f"{heads}lm_heads.{k}.weight"])
    if out['emb.0.weight'].shape[0] != lm.card + 1:
        raise ValueError(f"checkpoint vocab {out['emb.0.weight'].shape[0] - 1} != model card "
                         f"{lm.card}")
    for i in range(len(lm.transformer.layers)):
        out.update(_under(f'transformer.layers.{i}', _hf_layer(sd, f"{dec}layers.{i}")))
    out.update(_under('out_norm', _linear(sd, f"{dec}layer_norm")))
    return out


def import_t5_conditioner_hf(conditioner: torch.nn.Module, sd: StateDict,
                             text_prefix: str = "text_encoder.",
                             proj_prefix: str = "enc_to_dec_proj") -> tp.Dict[str, Array]:
    """The text tower of a ``MusicgenForConditionalGeneration`` dump as a
    partial state dict of the port's T5 conditioner: the T5 encoder (when
    its width is the conditioner's) and the trained ``enc_to_dec_proj``,
    the conditioner's ``output_proj``."""
    cfg = conditioner.t5_config
    out: tp.Dict[str, Array] = {}
    probe = f"{text_prefix}shared.weight"
    if (f"{text_prefix}encoder.block.0.layer.0.SelfAttention.q.weight" in sd and probe in sd
            and as_array(sd[probe]).shape[1] == cfg.d_model):
        out.update(_under('t5', import_t5(sd, cfg.num_layers, gated=cfg.gated_act,
                                          prefix=text_prefix)))
    if f"{proj_prefix}.weight" in sd:
        out.update(_under('output_proj', _linear(sd, proj_prefix)))
    return out


def lm_from_hf_config(cfg: tp.Mapping[str, tp.Any], *,
                      device: tp.Union[str, torch.device, None] = None, seed: int = 0):
    """``(LMModel, ConditioningProvider)`` from an HF MusicGen
    ``config.json`` mapping (composite or decoder-only), random weights from
    ``seed``.

    HF MusicGen decoders are the published architecture: pre-norm, no
    biases, sinusoidal positions, the delay pattern.  Stereo snapshots
    (decoder ``audio_channels`` 2) interleave the channels' codebooks as
    (2k, 2k+1) and delay each pair by k.  The text tower is a T5 conditioner
    at the decoder width, its encoder shaped by the snapshot's own
    ``text_encoder`` config."""
    from ..builders import _finish, resolve_device
    from ..cond.conditioners import ConditioningProvider, T5Conditioner
    from ..cond.fuser import ConditionFuser
    from ..lm.model import LMModel
    from ..nn.t5 import T5EncoderConfig
    from ..patterns import DelayedPatternProvider

    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dec = cfg.get("decoder", cfg)
    dim = int(dec.get("hidden_size", 1024))
    n_q = int(dec.get("num_codebooks", 4))
    ffn = int(dec.get("ffn_dim", 4 * dim))
    if ffn % dim:
        raise ValueError(f"ffn_dim {ffn} not a multiple of hidden_size {dim}")
    delays = [k // 2 for k in range(n_q)] if int(dec.get("audio_channels", 1)) == 2 else None
    t5_name, t5_cfg = "t5-base", None
    text = cfg.get("text_encoder")
    if text:
        if text.get("_name_or_path", "") in T5Conditioner.MODELS_DIMS:
            t5_name = text["_name_or_path"]
        t5_cfg = T5EncoderConfig(
            vocab_size=int(text.get("vocab_size", 32128)), d_model=int(text.get("d_model", 512)),
            d_kv=int(text.get("d_kv", 64)), d_ff=int(text.get("d_ff", 2048)),
            num_layers=int(text.get("num_layers", 6)), num_heads=int(text.get("num_heads", 8)),
            relative_attention_num_buckets=int(text.get("relative_attention_num_buckets", 32)),
            relative_attention_max_distance=int(
                text.get("relative_attention_max_distance", 128)),
            gated_act="gated" in str(text.get("feed_forward_proj", "relu")))
    provider = ConditioningProvider.from_dict({
        "description": T5Conditioner(name=t5_name, output_dim=dim, config=t5_cfg,
                                     generator=gen)})
    lm = LMModel(
        ConditionFuser.from_dict({"cross": ("description",)}),
        pattern_provider=DelayedPatternProvider(n_q, delays=delays),
        n_q=n_q, card=int(dec.get("vocab_size", 2048)), dim=dim,
        num_heads=int(dec.get("num_attention_heads", 16)),
        num_layers=int(dec.get("num_hidden_layers", 24)), hidden_scale=ffn // dim,
        cross_attention=True, causal=True, norm_first=True, bias_proj=False, bias_ff=False,
        bias_attn=False, activation=str(dec.get("activation_function", "gelu")),
        generator=gen)
    return _finish(lm, device), _finish(provider, device)


def import_musicgen_hf(lm: torch.nn.Module, sd: StateDict, provider: torch.nn.Module
                       ) -> tp.Tuple[tp.Dict[str, Array], tp.Dict[str, Array]]:
    """A whole ``MusicgenForConditionalGeneration`` state dict: ``(lm state,
    partial provider state)``, the latter (``conditioners.<name>...``) for
    ``torch_import.merge_params``.  The ``audio_encoder.*`` codec is a
    separate checkpoint (``codec/wrappers.HFEncodecCompressionModel``)."""
    cond: tp.Dict[str, Array] = {}
    for name, module in provider.conditioners.items():
        if type(module).__name__ == "T5Conditioner":
            cond.update(_under(f'conditioners.{name}', import_t5_conditioner_hf(module, sd)))
    return import_lm_hf(lm, sd), cond


def load_snapshot_weights(src: tp.Union[str, Path]) -> tp.Dict[str, tp.Any]:
    """Flat ``{name: array or tensor}`` of an HF snapshot directory: one or
    sharded safetensors files, or a ``pytorch_model.bin`` loaded with
    ``weights_only=True``."""
    src = Path(src)
    if (src / "model.safetensors").exists():
        return load_safetensors(src / "model.safetensors")
    index = src / "model.safetensors.index.json"
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        state: tp.Dict[str, tp.Any] = {}
        for shard in sorted(set(weight_map.values())):
            state.update(load_safetensors(src / shard))
        return state
    if (src / "pytorch_model.bin").exists():
        return dict(torch.load(str(src / "pytorch_model.bin"), map_location="cpu",
                               weights_only=True))
    raise FileNotFoundError(f"no weights file found under {src}")


def import_hf_snapshot(src: tp.Union[str, Path], out: tp.Union[str, Path],
                       unmapped_hook: tp.Optional[tp.Callable[[tp.List[str]], None]] = None,
                       require_codec: bool = False) -> None:
    """Convert an HF hub snapshot directory (``config.json`` and its weights)
    into the checkpoint layout ``<out>/{lm,compression}`` that
    ``ckpt/loaders.get_pretrained`` serves.  The conversion runs on the CPU.

    Composite dumps give both sides; a decoder-only dump gives the LM only,
    or fails with ``require_codec=True``.  Each side's unmapped keys are
    recorded in its ``meta['extra']['unmapped_keys']``."""
    from ..codec.wrappers import HFEncodecCompressionModel
    from .io import save_checkpoint
    from .torch_import import HARMLESS_BUFFER_PATTERNS, KeyTracker, merge_params, to_tensors

    src, out = Path(src), Path(out)
    cfg = json.loads((src / "config.json").read_text())
    state = load_snapshot_weights(src)
    has_codec = any(k.startswith("audio_encoder.") for k in state)
    if require_codec and not has_codec:
        raise ValueError(
            f"HF snapshot {src} is decoder-only (MusicgenForCausalLM: no 'audio_encoder.*' "
            "tower): it cannot generate audio by itself.  Use a composite "
            "MusicgenForConditionalGeneration snapshot, or convert with "
            "apps.import_checkpoint and pair the LM with a separately imported EnCodec "
            "checkpoint.")
    sd = KeyTracker(state)
    lm, provider = lm_from_hf_config(cfg, device='cpu')
    lm_state, cond_partial = import_musicgen_hf(lm, sd, provider=provider)
    lm.load_state_dict(to_tensors(lm_state))
    merge_params(provider, cond_partial)

    codec_save = None
    if has_codec:
        codec_sd = KeyTracker({k[len("audio_encoder."):]: v for k, v in state.items()
                               if k.startswith("audio_encoder.")})
        wrapped: torch.nn.Module = HFEncodecCompressionModel.from_hf_config(
            cfg.get("audio_encoder", {}), device='cpu')
        wrapped.model.load_state_dict(wrapped.import_hf_state(codec_sd))
        sd.used.update(f"audio_encoder.{key}" for key in codec_sd.used)
        # stereo snapshots keep a mono codec and interleave its codebooks
        if int(cfg.get("decoder", cfg).get("audio_channels", 1)) == 2:
            from ..codec.stereo import InterleaveStereoCompressionModel
            wrapped = InterleaveStereoCompressionModel(wrapped)
        codec_save = (wrapped, codec_sd.unused(ignore=HARMLESS_BUFFER_PATTERNS))

    leftover = sd.unused(ignore=HARMLESS_BUFFER_PATTERNS + HF_HARMLESS_PATTERNS)
    save_checkpoint(out / "lm", {"lm": lm, "condition_provider": provider},
                    extra={"source": str(src), "unmapped_keys": [
                        k for k in leftover if not k.startswith("audio_encoder.")]})
    if codec_save is not None:
        save_checkpoint(out / "compression", codec_save[0],
                        extra={"source": str(src), "unmapped_keys": codec_save[1]})
    if leftover and unmapped_hook is not None:
        unmapped_hook(leftover)
