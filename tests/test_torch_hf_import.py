"""The port's HF-layout importer (``ckpt/hf_import.py``) and its safetensors
reader, on the CPU.

``hf_lm_golden.npz`` and ``hf_stereo_snapshot_golden.npz`` hold tiny random
HF MusicGen models' state dicts and the logits HF computed with them; the
port holds them at 5e-5 absolute and 1e-4 relative, the JAX suite's bar
(``tests/test_hf_goldens.py``).  The snapshot goes through
``get_pretrained`` as a directory of ``config.json`` and
``model.safetensors``.  The reader is held against the ``safetensors``
package, which the test writes the files with.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audiocraft_tpu_torch.ckpt import hf_import, io, loaders
from audiocraft_tpu_torch.ckpt.torch_import import KeyTracker, to_tensors
from audiocraft_tpu_torch.codec.stereo import InterleaveStereoCompressionModel
from audiocraft_tpu_torch.codec.wrappers import HFEncodecCompressionModel
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.patterns import DelayedPatternProvider

GOLDENS = Path(__file__).parent / "goldens"
safetensors_numpy = pytest.importorskip("safetensors.numpy")


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    with np.load(GOLDENS / name) as data:
        sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
        return sd, {k: data[k] for k in data.files if not k.startswith("sd.")}


def _logits(lm, g):
    mask = torch.ones(g["enc"].shape[:2], dtype=torch.int32)
    with torch.no_grad():
        return lm(torch.from_numpy(g["codes"]),
                  {"description": (torch.from_numpy(g["enc"]), mask)}).numpy()


def _snapshot(path, sd, config_json):
    path.mkdir(parents=True)
    safetensors_numpy.save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
                                str(path / "model.safetensors"))
    (path / "config.json").write_text(config_json)
    return path


def test_hf_lm_logits_golden():
    sd, g = _load("hf_lm_golden.npz")
    n_q, card, dim, heads, layers, ffn = (int(v) for v in g["dims"])
    lm = LMModel(ConditionFuser.from_dict({"cross": ("description",)}), n_q=n_q, card=card,
                 dim=dim, num_heads=heads, num_layers=layers, hidden_scale=ffn // dim,
                 cross_attention=True, causal=True, norm_first=True, bias_proj=False,
                 bias_ff=False, bias_attn=False, activation="gelu",
                 pattern_provider=DelayedPatternProvider(n_q)).eval()
    tracker = KeyTracker(sd)
    assert hf_import.detect_lm_prefix(tracker) == ("model.decoder.", "")
    lm.load_state_dict(to_tensors(hf_import.import_lm_hf(lm, tracker)))
    assert tracker.unused(ignore=hf_import.HF_HARMLESS_PATTERNS) == []
    np.testing.assert_allclose(_logits(lm, g), g["logits"], atol=5e-5, rtol=1e-4)


def test_hf_stereo_snapshot_through_get_pretrained(tmp_path):
    """The stereo composite (decoder audio_channels 2) converts into the
    cache through ``get_pretrained``: pair delays, the interleaving wrapper
    over the HF codec, the LM's logits; the tied T5 embedding is the one
    unmapped key, recorded in the LM's meta; the cached directory serves
    again without converting."""
    sd, g = _load("hf_stereo_snapshot_golden.npz")
    src = _snapshot(tmp_path / "snapshot", sd, str(g["config_json"]))
    mg = loaders.get_pretrained(str(src), cache_dir=str(tmp_path / "cache"), device='cpu')
    n_q = g["codes"].shape[1]
    assert mg.lm.n_q == n_q
    assert mg.lm.pattern_provider.delays == [k // 2 for k in range(n_q)]
    assert isinstance(mg.compression_model, InterleaveStereoCompressionModel)
    assert isinstance(mg.compression_model.model, HFEncodecCompressionModel)
    np.testing.assert_allclose(_logits(mg.lm, g), g["logits"], atol=5e-5, rtol=1e-4)
    codes, scale = mg.compression_model.encode(torch.from_numpy(g["wav"]))
    assert codes.shape[1] == n_q
    assert mg.compression_model.decode(codes, scale).shape[1] == 2
    meta = json.loads((tmp_path / "cache" / "snapshot-hf" / "lm" / "config.json").read_text())
    assert meta["extra"]["unmapped_keys"] == ["text_encoder.encoder.embed_tokens.weight"]
    assert meta["layout"] == io.LAYOUT
    (src / "model.safetensors").unlink()      # served from the cache from now on
    again = loaders.get_pretrained(str(src), cache_dir=str(tmp_path / "cache"), device='cpu')
    np.testing.assert_array_equal(_logits(again.lm, g), _logits(mg.lm, g))


def test_unmapped_keys_are_recorded_and_a_decoder_only_snapshot_fails(tmp_path):
    sd, g = _load("hf_stereo_snapshot_golden.npz")
    cfg = str(g["config_json"])
    extra = dict(sd, **{"decoder.model.decoder.mystery.weight": np.ones(3, np.float32)})
    hf_import.import_hf_snapshot(_snapshot(tmp_path / "a", extra, cfg), tmp_path / "out")
    meta = json.loads((tmp_path / "out" / "lm" / "config.json").read_text())
    assert "decoder.model.decoder.mystery.weight" in meta["extra"]["unmapped_keys"]
    codec_meta = json.loads((tmp_path / "out" / "compression" / "config.json").read_text())
    assert codec_meta["extra"]["unmapped_keys"] == []
    decoder_only = {k: v for k, v in sd.items() if not k.startswith("audio_encoder.")}
    src = _snapshot(tmp_path / "b", decoder_only, cfg)
    with pytest.raises(ValueError, match="decoder-only"):
        loaders.get_pretrained(str(src), cache_dir=str(tmp_path / "cache"), device='cpu')
    assert not any((tmp_path / "cache").iterdir())   # no half-written directory left


def _tensors():
    rng = np.random.RandomState(4)
    return {"f32": rng.randn(3, 5).astype(np.float32),
            "f16": rng.randn(7).astype(np.float16),
            "i64": rng.randint(-9, 9, (2, 2, 3)).astype(np.int64),
            "i32": rng.randint(-9, 9, (4,)).astype(np.int32),
            "scalar": np.asarray(2.5, np.float32)}


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.torch import load_file as load_torch
    from safetensors.torch import save_file as save_torch

    arrays = _tensors()
    safetensors_numpy.save_file(arrays, str(tmp_path / "a.safetensors"),
                                metadata={"format": "np"})
    ours = hf_import.load_safetensors(tmp_path / "a.safetensors")
    theirs = safetensors_numpy.load_file(str(tmp_path / "a.safetensors"))
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    bf16 = torch.randn(6, 4, generator=torch.Generator().manual_seed(1)).bfloat16()
    save_torch({"bf16": bf16}, str(tmp_path / "b.safetensors"))
    got = hf_import.load_safetensors(tmp_path / "b.safetensors")["bf16"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, load_torch(str(tmp_path / "b.safetensors"))["bf16"]
                                  .float().numpy())


def test_sharded_snapshot_weights(tmp_path):
    arrays = _tensors()
    shards = {"model-00001-of-00002.safetensors": ["f32", "f16"],
              "model-00002-of-00002.safetensors": ["i64", "i32", "scalar"]}
    for name, keys in shards.items():
        safetensors_numpy.save_file({k: arrays[k] for k in keys}, str(tmp_path / name))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: name for name, keys in shards.items() for k in keys}}))
    got = hf_import.load_snapshot_weights(tmp_path)
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    torch.save({k: torch.from_numpy(v) for k, v in arrays.items()},
               tmp_path / "pytorch_model.bin")
    (tmp_path / "model.safetensors.index.json").unlink()
    got = hf_import.load_snapshot_weights(tmp_path)
    np.testing.assert_array_equal(got["i64"].numpy(), arrays["i64"])


def test_chip_smoke_snapshot_writer_round_trips(tmp_path):
    """``chip_smoke.py`` phase 17's HF snapshot, at thin widths: the inverse
    of the importers it writes the port's modules with, and its safetensors
    writer, give back those modules' state through ``import_hf_snapshot``,
    with no key unmapped."""
    import chip_smoke
    from audiocraft_tpu_torch import builders
    from audiocraft_tpu_torch.cond.conditioners import ConditioningProvider, T5Conditioner
    from audiocraft_tpu_torch.nn.t5 import T5EncoderConfig

    cfg = chip_smoke.musicgen_small_hf_config()
    cfg['decoder'].update(hidden_size=32, ffn_dim=128, num_hidden_layers=2,
                          num_attention_heads=4, vocab_size=64)
    cfg['text_encoder'].update(d_model=16, d_ff=32, num_layers=2, num_heads=2, d_kv=8,
                               vocab_size=100)
    cfg['audio_encoder'].update(num_filters=2, hidden_size=8, codebook_dim=8,
                                codebook_size=64, target_bandwidths=[1.2])
    codec = builders.get_encodec_32khz(n_filters=2, dimension=8, bins=64, device='cpu', seed=1)
    for layer in codec.quantizer.vq.layers:
        layer._codebook.embed.normal_(generator=torch.Generator().manual_seed(2))
        layer._codebook.inited.fill_(1)
    gen = torch.Generator().manual_seed(3)
    t5 = T5EncoderConfig(vocab_size=100, d_model=16, d_kv=8, d_ff=32, num_layers=2, num_heads=2)
    provider = ConditioningProvider({'description': T5Conditioner(output_dim=32, config=t5,
                                                                  generator=gen)})
    lm = LMModel(ConditionFuser.from_dict({'cross': ('description',)}), n_q=4, card=64, dim=32,
                 num_heads=4, num_layers=2, cross_attention=True, norm_first=True,
                 bias_proj=False, bias_ff=False, bias_attn=False, generator=gen)
    src = tmp_path / 'snapshot'
    src.mkdir()
    chip_smoke.write_safetensors(src / 'model.safetensors',
                                 chip_smoke.hf_snapshot_state(codec, lm, provider))
    (src / 'config.json').write_text(json.dumps(cfg))
    hf_import.import_hf_snapshot(src, tmp_path / 'out', require_codec=True)
    bundle, meta = io.load_checkpoint(tmp_path / 'out' / 'lm', device='cpu')
    wrapped, codec_meta = io.load_checkpoint(tmp_path / 'out' / 'compression', device='cpu')
    assert meta['extra']['unmapped_keys'] == codec_meta['extra']['unmapped_keys'] == []
    for ours, original in ((bundle['lm'], lm), (bundle['condition_provider'], provider),
                           (wrapped.model, codec)):
        mine = ours.state_dict()
        assert sorted(mine) == sorted(original.state_dict())
        for key, value in original.state_dict().items():
            assert torch.equal(mine[key], value), key
