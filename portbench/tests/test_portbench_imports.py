"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the port: every ``.py`` file under
``portbench/`` is parsed with ``ast`` and each import's top-level name (the
part before the first dot) is compared whole."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent.parent
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'audiocraft_tpu'}
PORT = 'audiocraft_tpu_torch'


def imported_tops(path: Path):
    """(line, top-level name) of every absolute import in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split('.')[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == 'import_module' and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value.split('.')[0]


def sources():
    return sorted(p for p in PACKAGE.rglob('*.py') if '__pycache__' not in p.parts)


@pytest.mark.parametrize('path', sources(), ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_jax_import(path):
    bad = [(line, top) for line, top in imported_tops(path) if top in FORBIDDEN]
    assert not bad, f'{path} imports {bad}'


@pytest.mark.parametrize('path', sorted((PACKAGE / 'reference').rglob('*.py')),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    bad = [(line, top) for line, top in imported_tops(path) if top == PORT]
    assert not bad, f'{path} imports the port: {bad}'


def test_the_port_name_is_not_taken_for_the_jax_package(tmp_path):
    """The comparison is by whole names: the port's name begins with the
    JAX package's and passes; the JAX package's fails."""
    src = tmp_path / 'probe.py'
    src.write_text('import audiocraft_tpu_torch.builders\nfrom audiocraft_tpu.gen import x\n'
                   'import jax.numpy as jnp\n')
    tops = [top for _, top in imported_tops(src)]
    assert tops == ['audiocraft_tpu_torch', 'audiocraft_tpu', 'jax']
    assert [t for t in tops if t in FORBIDDEN] == ['audiocraft_tpu', 'jax']


def test_run_refuses_loaded_jax_modules(monkeypatch):
    import sys
    import types
    from portbench import run
    assert run.forbidden_modules() == [] or 'jax' in sys.modules
    monkeypatch.setitem(sys.modules, 'audiocraft_tpu_torch_probe', types.ModuleType('x'))
    assert 'audiocraft_tpu' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jaxlib.probe', types.ModuleType('y'))
    assert 'jaxlib' in run.forbidden_modules()
