"""Save and resume a whole training run (counterpart of
``audiocraft_tpu/ckpt/train_state.py``).

A run's state is a tree of dicts, lists and tuples whose leaves are
tensors (the codec's ``state_dict()`` with its codebook buffers, the weight
EMA, the discriminator's, the balancer's state), optimizer states
(``optim.OptState``: count and moments) and ``torch.Generator``s (their
states).  :func:`save_train_state` writes the leaves in the tree's order
(dict keys sorted, as JAX's tree order sorts them) to ``train_state.npz``
and the step, the leaf paths and ``extra`` to ``train_meta.json``, each
written to a temporary name and renamed.
:func:`load_train_state` pours the saved leaves back into a template of the
same tree, in place (tensors copied into, optimizer counts and generator
states set); a template whose leaf paths or shapes differ raises, naming
the first difference, instead of misassigning moments.
"""

from __future__ import annotations

import contextlib
import json
import typing as tp
from pathlib import Path

import numpy as np
import torch

from ..optim import OptState

TRAIN_STATE_FILE = 'train_state.npz'
TRAIN_META_FILE = 'train_meta.json'

Leaf = tp.Tuple[str, tp.Any]


def _leaves(tree: tp.Any, path: str = '') -> tp.Iterator[Leaf]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f'{path}/{key}')
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f'{path}/{i}')
    elif isinstance(tree, OptState):
        yield f'{path}/count', tree
        yield from _leaves(tree.mu, f'{path}/mu')
        yield from _leaves(tree.nu, f'{path}/nu')
    elif isinstance(tree, (torch.Tensor, torch.Generator)):
        yield path, tree
    else:
        raise TypeError(f"train state leaf {path or '/'} is a {type(tree).__name__}")


def _array(leaf: tp.Any) -> np.ndarray:
    if isinstance(leaf, OptState):
        return np.asarray(leaf.count, np.int64)
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    t = leaf.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@contextlib.contextmanager
def _write_and_rename(path: Path) -> tp.Iterator[tp.BinaryIO]:
    tmp = path.with_name(path.name + '.tmp')
    with open(tmp, 'wb') as f:
        yield f
    tmp.rename(path)


def save_train_state(path: tp.Union[str, Path], state_tree: tp.Any, step: int,
                     extra: tp.Optional[dict] = None) -> Path:
    """Write ``state_tree``'s leaves and ``step`` into the directory ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves = list(_leaves(state_tree))
    flat = {f'leaf{i:05d}': _array(leaf) for i, (_, leaf) in enumerate(leaves)}
    meta = {'step': int(step), 'n_leaves': len(leaves), 'paths': [p for p, _ in leaves],
            'extra': extra or {}}
    with _write_and_rename(path / TRAIN_STATE_FILE) as f:
        np.savez(f, **flat)
    with _write_and_rename(path / TRAIN_META_FILE) as f:
        f.write(json.dumps(meta, indent=2).encode())
    return path


def has_train_state(path: tp.Union[str, Path]) -> bool:
    path = Path(path)
    return (path / TRAIN_STATE_FILE).exists() and (path / TRAIN_META_FILE).exists()


@torch.no_grad()
def load_train_state(path: tp.Union[str, Path], template: tp.Any) -> tp.Tuple[int, dict]:
    """Pour the run saved at ``path`` into ``template`` in place; returns
    ``(step, extra)``.  Raises when the template's tree differs from the
    saved one (configuration drift)."""
    path = Path(path)
    meta = json.loads((path / TRAIN_META_FILE).read_text())
    leaves = list(_leaves(template))
    paths = [p for p, _ in leaves]
    if paths != meta['paths']:
        first = next((i for i, (a, b) in enumerate(zip(paths, meta['paths'])) if a != b),
                     min(len(paths), len(meta['paths'])))
        raise ValueError(f"train state at {path} has {meta['n_leaves']} leaves and the run "
                         f"expects {len(paths)}; they first differ at leaf {first} "
                         f"({meta['paths'][first] if first < len(meta['paths']) else None} != "
                         f"{paths[first] if first < len(paths) else None}): configuration "
                         f"drift?")
    with np.load(path / TRAIN_STATE_FILE) as data:
        loaded = [data[f'leaf{i:05d}'] for i in range(meta['n_leaves'])]
    for (p, leaf), value in zip(leaves, loaded):
        expected = tuple(_array(leaf).shape)
        if expected != value.shape:
            raise ValueError(f"train state leaf {p}: checkpoint shape {value.shape} != expected "
                             f"{expected}: configuration drift?")
    for (_, leaf), value in zip(leaves, loaded):
        if isinstance(leaf, OptState):
            leaf.count = int(value)
        elif isinstance(leaf, torch.Generator):
            leaf.set_state(torch.from_numpy(value.copy()))
        else:
            leaf.copy_(torch.from_numpy(value).to(leaf.dtype))
    return meta['step'], meta.get('extra', {})
