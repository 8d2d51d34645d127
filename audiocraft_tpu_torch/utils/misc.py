"""Cross-cutting utilities (counterpart of ``audiocraft_tpu/utils/misc.py``,
the reference's ``utils/utils.py``, ``autocast.py``, ``cluster.py`` and
``environment.py``).

* :func:`model_hash`: SHA1 over a module's state dict, for regression
  tracking; :func:`length_to_mask`; :func:`warn_once`.
* :class:`DtypePolicy`, ``BF16_POLICY`` and ``FP32_POLICY``: the compute
  dtype of a mixed-precision section, its casts in functional form.
* :class:`AudioCraftEnvironment`: team and cluster settings from the same
  environment variables and yaml file as the JAX package's, with the
  cluster's regex dataset mappers for manifest paths.
* :func:`cluster_info`: this process's place in a ``torch.distributed``
  launch and its CUDA cards.
* :func:`write_and_rename`: a file written under a temporary name and
  renamed into place.
* :func:`enable_compilation_cache`: the JAX package persists its XLA
  compiles here; the port's compiled artefacts are the hand kernels, so this
  builds them (or loads the library ``ops/_build.py`` left in the
  gitignored ``_build/`` for the same sources) before the first timed launch.
  The apps call it where the JAX package's apps do.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import os
import re
import typing as tp
from pathlib import Path

import torch

from ..dist.mesh import in_torchrun

logger = logging.getLogger(__name__)

DEFAULT_CACHE_DIR = '~/.cache/audiocraft_tpu_torch'


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def model_hash(model: tp.Union[torch.nn.Module, tp.Mapping[str, torch.Tensor]]) -> str:
    """SHA1 over a module's state dict (or a name -> tensor mapping), the
    tensors' bytes taken in name order (reference ``utils/utils.py``:26-33)."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    hasher = hashlib.sha1()
    for name in sorted(state):
        hasher.update(_tensor_bytes(state[name]))
    return hasher.hexdigest()


def length_to_mask(lengths: torch.Tensor, max_len: tp.Optional[int] = None) -> torch.Tensor:
    """[B] lengths -> [B, T] boolean mask, T ``max_len`` or the longest
    length, at least 1 (reference ``utils.py``:177-190)."""
    if lengths.dim() != 1:
        raise ValueError(f"expected [B] lengths, got {tuple(lengths.shape)}")
    final_length = max_len if max_len else int(lengths.max())
    final_length = max(final_length, 1)
    return torch.arange(final_length, device=lengths.device)[None, :] < lengths[:, None]


_WARNED: tp.Set[str] = set()


def warn_once(logger_: logging.Logger, msg: str) -> None:
    if msg not in _WARNED:
        _WARNED.add(msg)
        logger_.warning(msg)


class DtypePolicy:
    """Mixed-precision policy (the reference's TorchAutocast,
    ``utils/autocast.py``:10-40, in functional form): the dtype the
    compute-heavy sections cast their floating inputs to, while the parity
    paths (RVQ distances, the attention softmax) stay fp32."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype

    @property
    def enabled(self) -> bool:
        return self.compute_dtype != torch.float32

    def cast_to_compute(self, tree: tp.Any) -> tp.Any:
        """``tree`` (tensors in dicts, lists and tuples) with every floating
        tensor cast to the compute dtype; other leaves as they are."""
        if isinstance(tree, torch.Tensor):
            return tree.to(self.compute_dtype) if tree.is_floating_point() else tree
        if isinstance(tree, dict):
            return {k: self.cast_to_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_to_compute(v) for v in tree)
        return tree


BF16_POLICY = DtypePolicy(compute_dtype=torch.bfloat16)
FP32_POLICY = DtypePolicy()


def _guess_cluster_type() -> str:
    """'slurm' under SLURM, 'torchrun' in a ``torchrun`` launch (the JAX
    package's 'tpu_pod'), else 'local' (reference ``utils/cluster.py``:21-43)."""
    if os.environ.get('SLURM_JOB_ID') or os.environ.get('SLURM_NODELIST'):
        return 'slurm'
    if in_torchrun():
        return 'torchrun'
    return 'local'


class AudioCraftEnvironment:
    """Team and cluster environment (reference ``environment.py``:25-176).

    A yaml file (``AUDIOCRAFT_CONFIG``; the reference's
    ``config/teams/<team>.yaml``) keyed by cluster name gives each cluster's
    directories and ``dataset_mappers``, regex -> replacement rules applied
    to every manifest path so that one manifest serves several clusters
    (reference ``environment.py``:166-176).  Environment variables override
    it: ``AUDIOCRAFT_TEAM``, ``AUDIOCRAFT_CLUSTER``, ``AUDIOCRAFT_DORA_DIR``,
    ``AUDIOCRAFT_REFERENCE_DIR``, ``AUDIOCRAFT_CACHE_DIR``.  The default
    cache is ``~/.cache/audiocraft_tpu_torch``, the port's own, as the
    checkpoint loaders' (``ckpt/loaders.py``).
    """

    DEFAULT_TEAM = 'default'
    _instance: tp.Optional['AudioCraftEnvironment'] = None

    def __init__(self) -> None:
        self.team: str = os.environ.get('AUDIOCRAFT_TEAM', self.DEFAULT_TEAM)
        self.cluster: str = os.environ.get('AUDIOCRAFT_CLUSTER', _guess_cluster_type())
        self._config: dict = {}
        config_path = os.environ.get('AUDIOCRAFT_CONFIG', '')
        if config_path:
            import yaml
            with open(config_path) as f:
                self._config = yaml.safe_load(f) or {}
        self._dataset_mappers: tp.List[tp.Tuple[tp.Pattern, str]] = [
            (re.compile(pattern), repl)
            for pattern, repl in (self._cluster_config().get('dataset_mappers') or {}).items()]

    def _cluster_config(self) -> dict:
        cfg = self._config.get(self.cluster)
        return cfg if isinstance(cfg, dict) else {}

    @classmethod
    def instance(cls) -> 'AudioCraftEnvironment':
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Reload on next use (reference ``environment.py``:84-87)."""
        cls._instance = None

    @classmethod
    def get_team(cls) -> str:
        return cls.instance().team

    @classmethod
    def get_cluster(cls) -> str:
        return cls.instance().cluster

    @classmethod
    def get_cache_dir(cls) -> str:
        return os.environ.get('AUDIOCRAFT_CACHE_DIR', os.path.expanduser(DEFAULT_CACHE_DIR))

    @classmethod
    def get_dora_dir(cls) -> str:
        """The experiments' output directory (reference
        ``environment.py``:103-111)."""
        return os.environ.get(
            'AUDIOCRAFT_DORA_DIR',
            str(cls.instance()._cluster_config().get('dora_dir', '')
                or os.path.join(cls.get_cache_dir(), 'xps')))

    @classmethod
    def get_reference_dir(cls) -> str:
        return os.environ.get('AUDIOCRAFT_REFERENCE_DIR',
                              str(cls.instance()._cluster_config().get('reference_dir', '')))

    @classmethod
    def resolve_reference_path(cls, path: tp.Union[str, os.PathLike]) -> str:
        path = str(path)
        if path.startswith('//reference'):
            return path.replace('//reference', cls.get_reference_dir())
        return path

    @classmethod
    def apply_dataset_mappers(cls, path: str) -> str:
        """``path`` rewritten by the cluster's regex rules in order (the
        identity when none is configured)."""
        for regex, repl in cls.instance()._dataset_mappers:
            path = regex.sub(repl, path)
        return path


def cluster_info() -> dict:
    """This process's place in a ``torch.distributed`` launch and its CUDA
    cards (the reference's SLURM detection, ``cluster.py``:27-75)."""
    import torch.distributed as dist
    joined = dist.is_available() and dist.is_initialized()
    return {
        'process_index': dist.get_rank() if joined else int(os.environ.get('RANK', 0)),
        'process_count': dist.get_world_size() if joined
        else int(os.environ.get('WORLD_SIZE', 1)),
        'local_rank': int(os.environ.get('LOCAL_RANK', 0)),
        'local_devices': torch.cuda.device_count(),
        'backend': dist.get_backend() if joined else None,
        'coordinator': (f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
                        if in_torchrun() else None),
    }


@contextlib.contextmanager
def write_and_rename(path: tp.Union[str, Path], suffix: str = '.tmp') -> tp.Iterator[tp.BinaryIO]:
    """Write a file under ``path + suffix``, renamed to ``path`` when the
    block ends without an error."""
    path = Path(path)
    tmp = path.with_name(path.name + suffix)
    with open(tmp, 'wb') as f:
        yield f
    tmp.rename(path)


def enable_compilation_cache(device: tp.Union[str, torch.device, None] = None):
    """Build the hand kernels, or load the library an earlier build left for
    the same sources, before the first timed launch.  ``device`` None means
    the CUDA card when there is one.  Returns the build's result
    (``ops/_build.BuildResult``), or None where nothing runs on a card."""
    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    if torch.device(device).type != 'cuda':
        return None
    from ..ops import _build
    result = _build.build()
    _build.library()
    return result
