"""Pretrained-model dispatch and cache
(counterpart of ``audiocraft_tpu/ckpt/loaders.py``; reference
models/loaders.py:40-90 and app.py:300-315).

"Pretrained" means a local checkpoint directory: one that
``apps/import_checkpoint`` wrote from published torch weights, one converted
from an HF hub snapshot, or one the JAX package wrote.  The name map is the
reference's, so the same identifiers resolve.  Layout of a model
directory::

    <dir>/
        compression/   # the codec checkpoint (config.json + state.npz)
        lm/            # {'lm': LMModel, 'condition_provider': ...}

The port's cache is its own (``~/.cache/audiocraft_tpu_torch``, or
``AUDIOCRAFT_TPU_TORCH_CACHE_DIR``): the JAX package cannot read the
directories the port converts.  A directory the JAX package wrote loads by
its path.  ``get_pretrained('debug')`` builds the debug model and needs no
files.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import typing as tp
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

Device = tp.Union[str, torch.device, None]

#: reference loaders.py:40-52, verbatim
HF_MODEL_CHECKPOINTS_MAP = {
    "small": "facebook/musicgen-small",
    "medium": "facebook/musicgen-medium",
    "large": "facebook/musicgen-large",
    "melody": "facebook/musicgen-melody",
    "melody-large": "facebook/musicgen-melody-large",
    "stereo-small": "facebook/musicgen-stereo-small",
    "stereo-medium": "facebook/musicgen-stereo-medium",
    "stereo-large": "facebook/musicgen-stereo-large",
    "stereo-melody": "facebook/musicgen-stereo-melody",
    "stereo-melody-large": "facebook/musicgen-stereo-melody-large",
    "style": "facebook/musicgen-style",
}


def get_cache_dir(cache_dir: tp.Optional[str] = None) -> Path:
    return Path(cache_dir or os.environ.get(
        'AUDIOCRAFT_TPU_TORCH_CACHE_DIR', os.path.expanduser('~/.cache/audiocraft_tpu_torch')))


def resolve_checkpoint_dir(name: str, cache_dir: tp.Optional[str] = None) -> tp.Optional[Path]:
    """The checkpoint directory of a path, a short name of the map
    ('small', 'melody', ...) or a repo id ('facebook/musicgen-small'); None
    when there is none."""
    as_path = Path(name)
    if as_path.is_dir() and (as_path / 'lm').is_dir():
        return as_path
    root = get_cache_dir(cache_dir)
    candidates = [name]
    if name in HF_MODEL_CHECKPOINTS_MAP:
        candidates.append(HF_MODEL_CHECKPOINTS_MAP[name])
    reverse = {v: k for k, v in HF_MODEL_CHECKPOINTS_MAP.items()}
    if name in reverse:
        candidates.append(reverse[name])
    for cand in candidates:
        for sub in (cand, cand.replace('/', '--'), cand.split('/')[-1]):
            if (root / sub / 'lm').is_dir():
                return root / sub
    return None


def list_local_models(cache_dir: tp.Optional[str] = None) -> tp.List[str]:
    """Names servable now: 'debug' and every checkpoint directory in the
    cache."""
    root = get_cache_dir(cache_dir)
    return ['debug'] + ([child.name for child in sorted(root.iterdir())
                         if (child / 'lm').is_dir()] if root.is_dir() else [])


def _convert_snapshot(src: Path, cache_dir: tp.Optional[str]) -> Path:
    """An HF hub snapshot converted once into the cache: into a temporary
    sibling, renamed into place, so a failed conversion leaves no
    half-written directory behind."""
    from .hf_import import import_hf_snapshot

    dest = get_cache_dir(cache_dir) / (src.name + '-hf')
    if (dest / 'lm').is_dir():
        return dest
    logger.info("converting HF snapshot %s -> %s", src, dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=dest.name + '.tmp-', dir=dest.parent))
    try:
        import_hf_snapshot(src, tmp, require_codec=True,
                           unmapped_hook=lambda keys: logger.warning(
                               "%d HF keys were not imported: %s", len(keys), keys[:8]))
        if dest.exists():
            shutil.rmtree(dest)
        os.replace(tmp, dest)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return dest


def get_pretrained(name: str = 'debug', cache_dir: tp.Optional[str] = None,
                   max_duration: float = 30.0, device: Device = None):
    """A ready-to-generate MusicGen facade for ``name`` on ``device`` (None:
    the CUDA card): 'debug' is the debug model; anything else resolves to a
    checkpoint directory (see the module note), an HF snapshot directory
    being converted into the cache first."""
    from ..builders import resolve_device
    from ..gen.musicgen import MusicGen, get_debug_musicgen
    from .io import load_checkpoint

    device = resolve_device(device)
    if name == 'debug':
        return get_debug_musicgen(device=device, seed=0)
    path = resolve_checkpoint_dir(name, cache_dir)
    if path is None and (Path(name) / 'config.json').exists():
        path = _convert_snapshot(Path(name), cache_dir)
    if path is None:
        raise FileNotFoundError(
            f"no imported checkpoint for '{name}' under {get_cache_dir(cache_dir)}: run "
            f"`python -m audiocraft_tpu_torch.apps.import_checkpoint` on the published torch "
            f"weights first (map: {HF_MODEL_CHECKPOINTS_MAP.get(name, name)})")
    if not (path / 'compression').is_dir():
        raise FileNotFoundError(
            f"checkpoint dir {path} has an LM but no 'compression/' codec checkpoint (a "
            "decoder-only import?): generation needs both.  Import the matching EnCodec "
            "weights with apps.import_checkpoint --kind compression into that directory.")
    codec, _ = load_checkpoint(path / 'compression', device)
    bundle, meta = load_checkpoint(path / 'lm', device)
    unmapped = meta.get('extra', {}).get('unmapped_keys', [])
    if unmapped:
        logger.warning("checkpoint %s was imported with %d unmapped keys", path, len(unmapped))
    return MusicGen(name, codec, bundle['lm'], bundle['condition_provider'],
                    max_duration=max_duration)


_MODEL_CACHE: tp.Dict[tp.Tuple[str, str], tp.Any] = {}
_MAX_CACHED = 2  # LMs are large; keep the two most recent


def load_model(name: str = 'debug', cache_dir: tp.Optional[str] = None, device: Device = None):
    """Cached model switching for serving: the two most recently used
    models stay loaded (reference app.py:300-315 keeps one)."""
    from ..builders import resolve_device

    key = (name, str(resolve_device(device)))
    if key in _MODEL_CACHE:
        _MODEL_CACHE[key] = _MODEL_CACHE.pop(key)   # refresh recency
        return _MODEL_CACHE[key]
    model = get_pretrained(name, cache_dir, device=device)
    _MODEL_CACHE[key] = model
    while len(_MODEL_CACHE) > _MAX_CACHED:
        evicted = next(iter(_MODEL_CACHE))
        del _MODEL_CACHE[evicted]
        logger.info("evicted model '%s' from cache", evicted[0])
    return model


def clear_model_cache() -> None:
    _MODEL_CACHE.clear()
