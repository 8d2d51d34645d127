"""Rules of the PyTorch port's package: what it imports, where it runs,
and what it builds."""

import ast
from pathlib import Path

import pytest
import torch

from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.apps import probe_ops
from audiocraft_tpu_torch.gen.magnet import get_debug_magnet
from audiocraft_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "audiocraft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "audiocraft_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_smoke_import_nothing_of_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for module in _imported_modules(path):
            top = module.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {module}"


@pytest.mark.parametrize("build", [builders.get_encodec_32khz, builders.get_encodec_24khz,
                                   builders.get_debug_compression_model,
                                   builders.get_magnet_lm, get_debug_magnet,
                                   builders.get_musicgen_lm, builders.get_debug_musicgen_lm])
def test_entry_points_refuse_to_fall_back_to_the_cpu(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build()


def test_probe_app_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_ops.main([])


def test_build_directory_is_ignored_by_git():
    lines = (ROOT / ".gitignore").read_text().splitlines()
    assert "audiocraft_tpu_torch/_build/" in lines
    assert _build.BUILD_DIR == PORT / "_build"


def test_each_ported_kernel_has_a_cuda_source_and_entry_point():
    sources = {p.name: p.read_text() for p in (PORT / "csrc").glob("*.cu")}
    assert {"rvq.cu", "lstm.cu", "attention.cu", "attention_bwd.cu", "seanet.cu",
            "probe.cu"} <= set(sources)
    assert 'extern "C" int acx_rvq_encode(' in sources["rvq.cu"]
    assert 'extern "C" int acx_lstm_layer(' in sources["lstm.cu"]
    assert 'extern "C" int acx_attention_fwd(' in sources["attention.cu"]
    assert 'extern "C" int acx_attention_bwd_dkv(' in sources["attention_bwd.cu"]
    assert 'extern "C" int acx_attention_bwd_dq(' in sources["attention_bwd.cu"]
    assert 'extern "C" int acx_seanet_stage(' in sources["seanet.cu"]
    assert 'extern "C" int acx_mono_conv(' in sources["seanet.cu"]
    assert 'extern "C" int acx_probe_gather(' in sources["probe.cu"]
    assert 'extern "C" int acx_probe_contract(' in sources["probe.cu"]
    assert "rvq_pallas.py:_rvq_kernel" in sources["rvq.cu"]
    assert "lstm_pallas.py:_lstm_kernel" in sources["lstm.cu"]
    assert "attention_pallas.py:fused_attention" in sources["attention.cu"]
    for pallas_fn in ("_flash_attention_bwd_dkv", "_flash_attention_bwd_dq"):
        assert pallas_fn in sources["attention_bwd.cu"]
    for pallas_fn in ("seanet_pallas.py:_stage_kernel", "_banded_conv_kernel",
                      "_mono_conv_kernel"):
        assert pallas_fn in sources["seanet.cu"]
    assert "probe_mosaic_ops.py:try_kernel" in sources["probe.cu"]
    for name in ('acx_rvq_encode', 'acx_lstm_layer', 'acx_attention_fwd',
                 'acx_attention_bwd_dkv', 'acx_attention_bwd_dq', 'acx_seanet_stage',
                 'acx_mono_conv', 'acx_probe_gather', 'acx_probe_contract'):
        assert name in _build._SIGNATURES
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_musicgen_melody_and_style_are_not_ported_yet():
    for flag in ('melody', 'style'):
        with pytest.raises(NotImplementedError):
            builders.get_musicgen_lm('small', device='cpu', **{flag: True})
