"""Rules of the PyTorch port's package: what it imports, where it runs,
and what it builds."""

import ast
import functools
from pathlib import Path

import pytest
import torch

from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.apps import probe_ops
from audiocraft_tpu_torch.codec.wrappers import HFEncodecCompressionModel
from audiocraft_tpu_torch.gen.magnet import get_debug_magnet
from audiocraft_tpu_torch.cond.chroma_cond import ChromaConditioner
from audiocraft_tpu_torch.cond.style_cond import StyleConditioner
from audiocraft_tpu_torch.gen.musicgen import get_debug_melody_musicgen, get_debug_musicgen
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
                                   builders.get_musicgen_lm, builders.get_debug_musicgen_lm,
                                   builders.get_musicgen, get_debug_musicgen,
                                   functools.partial(builders.get_musicgen, stereo=True),
                                   functools.partial(builders.get_musicgen, melody=True),
                                   functools.partial(builders.get_musicgen, style=True),
                                   functools.partial(builders.get_musicgen_lm, melody=True),
                                   functools.partial(builders.get_musicgen_lm, style=True),
                                   get_debug_melody_musicgen,
                                   builders.get_htdemucs, builders.get_jasco_model,
                                   functools.partial(HFEncodecCompressionModel.from_hf_config,
                                                     {})])
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
    assert 'extern "C" int acx_rvq_encode_clocks(' in sources["rvq.cu"]
    assert 'extern "C" int acx_rvq_info(' in sources["rvq.cu"]
    assert 'extern "C" int acx_lstm_layer(' in sources["lstm.cu"]
    assert 'extern "C" int acx_attention_fwd(' in sources["attention.cu"]
    assert 'extern "C" int acx_attention_bwd_dkv(' in sources["attention_bwd.cu"]
    assert 'extern "C" int acx_attention_bwd_dq(' in sources["attention_bwd.cu"]
    assert 'extern "C" int acx_seanet_stage(' in sources["seanet.cu"]
    assert 'extern "C" int acx_seanet_stage_clocks(' in sources["seanet.cu"]
    assert 'extern "C" int acx_seanet_stage_info(' in sources["seanet.cu"]
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
    for name in ('acx_rvq_encode', 'acx_rvq_encode_clocks', 'acx_rvq_info', 'acx_lstm_layer', 'acx_attention_fwd',
                 'acx_attention_fwd_info', 'acx_attention_bwd_dkv', 'acx_attention_bwd_dq',
                 'acx_seanet_stage', 'acx_seanet_stage_clocks', 'acx_seanet_stage_info',
                 'acx_mono_conv', 'acx_probe_gather', 'acx_probe_contract'):
        assert name in _build._SIGNATURES
    assert 'extern "C" int acx_attention_fwd_info(' in sources["attention.cu"]
    # K3f's bf16 kernel streams K and V through a cp.async ring and takes its
    # operands by ldmatrix, as K3b does, from the header both include
    for name in ("attention.cu", "attention_bwd.cu"):
        assert '#include "attention_common.cuh"' in sources[name]
    for call in ("load_tile<DP, kRows, THREADS>(k_at(s)", "ldsm(qa[kk]", "ldsm(f, kt",
                 "ldsm_t(f, vt", "exp2_ftz("):
        assert call in sources["attention.cu"]
    # K4's tensor-core variant: A of conv3 and conv1 by ldmatrix, the weights
    # (B, and wd^T as the downsample's A) from shared memory by descriptor,
    # never by __ldg; the input tile and streamed wd by bulk copies on
    # mbarriers, ahead of the products that read them
    seanet = sources["seanet.cu"]
    assert '#include "attention_common.cuh"' in seanet
    for call in ("ldsm(a[k & 3], a_at(k))", "wgmma.mma_async.sync.aligned", "b_desc(",
                 "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes",
                 "mbar_wait(in_full", "mbar_wait(full"):
        assert call in seanet
    assert "__ldg" not in seanet
    # K1 streams E^T through a cp.async ring into 128-bit shared loads, in
    # fp32 FMA (no tensor cores); K5 / K6 store 16-byte vectors, streaming
    rvq_src = sources["rvq.cu"]
    assert '#include "phase_clock.cuh"' in rvq_src and '#include "phase_clock.cuh"' in seanet
    for call in ("cp_async16(dst", "cp_wait<kStages - 2>()",
                 "*reinterpret_cast<const float4*>(bs + f * TC", "fmaf(a[i], b[j], acc[i][j])"):
        assert call in rvq_src
    assert not any(op in rvq_src for op in ("mma(", "wgmma", ".tf32"))
    for call in ("__stcs(reinterpret_cast<uint4*>(dst)", "cp_async4(buf", "wr[c][d]"):
        assert call in seanet
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_build_is_named_by_the_sources_and_the_headers(tmp_path, monkeypatch):
    """An edited header builds a new library, as an edited source does."""
    assert (PORT / "csrc" / "attention_common.cuh").is_file()
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "SOURCE_DIR", tmp_path)
    tags = [_build.source_tag()]
    (tmp_path / "h.cuh").write_text("// two\n")
    tags.append(_build.source_tag())
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// changed\n')
    tags.append(_build.source_tag())
    assert len(set(tags)) == 3


def test_musicgen_melody_and_style_are_not_ported_yet(monkeypatch):
    """musicgen-melody and musicgen-style build (at a thin LM width here; the
    published widths run on the card, in chip_smoke.py), with their
    ``self_wav`` conditioner prepended; melody with style raises, as JAX
    asserts."""
    monkeypatch.setitem(builders._MUSICGEN_SIZES, 'small', dict(dim=64, num_layers=1,
                                                                num_heads=4))
    for flag, cls in (('melody', ChromaConditioner), ('style', StyleConditioner)):
        mg = builders.get_musicgen('small', device='cpu', **{flag: True})
        assert mg.name == f'musicgen-{flag}-small'
        cond = mg.condition_provider.conditioners['self_wav']
        assert isinstance(cond, cls) and cond.output_proj.out_features == 64
        assert mg.lm.fuser.fuse2cond == {'cross': ('description',), 'prepend': ('self_wav',)}
    assert cond.feat_extractor.compute_dtype is None and cond.rvq.n_q == 6
    assert builders.get_musicgen_lm('small', melody=True, device='cpu')[1].conditioners[
        'self_wav'].chroma_len == 938
    for build in (builders.get_musicgen, builders.get_musicgen_lm):
        with pytest.raises(ValueError):
            build('small', melody=True, style=True, device='cpu')
