"""The port's utilities (``utils/misc.py``, ``utils/cache.py``) against the
JAX package's, on the CPU: masks and the dtype policy give JAX's values,
the model hash is stable and moves with one weight, the environment reads
the same variables and yaml as JAX's, and the caches that one package
writes, the other reads (the files are byte for byte the same)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocraft_tpu.utils import cache as jax_cache
from audiocraft_tpu.utils import misc as jax_misc
from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.utils import cache, misc

ENV_VARS = ('AUDIOCRAFT_CONFIG', 'AUDIOCRAFT_CLUSTER', 'AUDIOCRAFT_TEAM', 'AUDIOCRAFT_DORA_DIR',
            'AUDIOCRAFT_REFERENCE_DIR', 'AUDIOCRAFT_CACHE_DIR', 'SLURM_JOB_ID', 'SLURM_NODELIST',
            'TPU_WORKER_HOSTNAMES', 'JAX_COORDINATOR_ADDRESS', 'RANK', 'WORLD_SIZE',
            'MASTER_ADDR', 'MASTER_PORT')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('max_len', [None, 7, 0])
def test_length_to_mask_matches_jax(max_len):
    lengths = np.array([3, 5, 0, 1])
    got = misc.length_to_mask(torch.from_numpy(lengths), max_len=max_len)
    want = np.asarray(jax_misc.length_to_mask(jnp.asarray(lengths), max_len=max_len))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        misc.length_to_mask(torch.ones(2, 2))


def test_dtype_policy_matches_jax():
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    i = np.arange(4, dtype=np.int32)
    for ours, theirs in ((misc.BF16_POLICY, jax_misc.BF16_POLICY),
                         (misc.FP32_POLICY, jax_misc.FP32_POLICY)):
        assert ours.enabled == theirs.enabled
        got = ours.cast_to_compute({'w': torch.from_numpy(x), 'i': [torch.from_numpy(i)],
                                    'n': None})
        want = theirs.cast_to_compute({'w': jnp.asarray(x), 'i': [jnp.asarray(i)], 'n': None})
        assert str(got['w'].dtype).split('.')[-1] == str(want['w'].dtype)
        np.testing.assert_array_equal(got['w'].float().numpy(),
                                      np.asarray(want['w'].astype(jnp.float32)))
        assert got['i'][0].dtype == torch.int32 and want['i'][0].dtype == jnp.int32
        assert got['n'] is None


def test_model_hash_is_stable_and_moves_with_one_weight():
    a = builders.get_debug_compression_model(32000, device='cpu', seed=0)
    b = builders.get_debug_compression_model(32000, device='cpu', seed=0)
    h = misc.model_hash(a)
    assert h == misc.model_hash(b) == misc.model_hash(dict(b.state_dict()))
    assert len(h) == 40
    with torch.no_grad():
        b.encoder.model[0].conv.conv.weight[0, 0, 0] += 1e-3
    assert misc.model_hash(b) != h
    # bf16 tensors hash too, by their bytes
    assert misc.model_hash({'x': torch.ones(3, dtype=torch.bfloat16)}) != \
        misc.model_hash({'x': torch.ones(3)})


def _both_environments(monkeypatch, **env):
    for key in ENV_VARS:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    misc.AudioCraftEnvironment.reset()
    jax_misc.AudioCraftEnvironment.reset()
    return misc.AudioCraftEnvironment, jax_misc.AudioCraftEnvironment


def test_environment_matches_jax_with_a_team_yaml(tmp_path, monkeypatch):
    cfg = tmp_path / 'team.yaml'
    cfg.write_text('mycluster:\n'
                   '  reference_dir: /mnt/shared/ref\n'
                   '  dora_dir: /mnt/shared/xps\n'
                   '  dataset_mappers:\n'
                   '    "^/old_cluster/data": "/new_cluster/data"\n'
                   '    "\\\\.flac$": ".wav"\n')
    ours, theirs = _both_environments(monkeypatch, AUDIOCRAFT_CONFIG=str(cfg),
                                      AUDIOCRAFT_CLUSTER='mycluster', AUDIOCRAFT_TEAM='lab')
    try:
        for name in ('get_team', 'get_cluster', 'get_dora_dir', 'get_reference_dir'):
            assert getattr(ours, name)() == getattr(theirs, name)(), name
        assert ours.get_dora_dir() == '/mnt/shared/xps' and ours.get_team() == 'lab'
        for path in ('/old_cluster/data/song.flac', '/elsewhere/x.mp3', '/old_cluster/data/a.wav'):
            assert ours.apply_dataset_mappers(path) == theirs.apply_dataset_mappers(path)
        assert ours.apply_dataset_mappers('/old_cluster/data/song.flac') == \
            '/new_cluster/data/song.wav'
        for path in ('//reference/manifests/train.jsonl', '/plain/x.wav'):
            assert ours.resolve_reference_path(path) == theirs.resolve_reference_path(path)
        monkeypatch.setenv('AUDIOCRAFT_REFERENCE_DIR', '/override')
        monkeypatch.setenv('AUDIOCRAFT_DORA_DIR', '/dora')
        assert ours.resolve_reference_path('//reference/x') == \
            theirs.resolve_reference_path('//reference/x') == '/override/x'
        assert ours.get_dora_dir() == theirs.get_dora_dir() == '/dora'
    finally:
        misc.AudioCraftEnvironment.reset()
        jax_misc.AudioCraftEnvironment.reset()


def test_environment_defaults_match_jax(monkeypatch):
    ours, theirs = _both_environments(monkeypatch)
    try:
        assert ours.get_cluster() == theirs.get_cluster() == 'local'
        assert ours.get_team() == theirs.get_team() == 'default'
        assert ours.get_reference_dir() == theirs.get_reference_dir() == ''
        assert ours.apply_dataset_mappers('/a/b.wav') == '/a/b.wav'
        # the port's cache is its own, as its checkpoint loaders'
        assert ours.get_cache_dir() == os.path.expanduser('~/.cache/audiocraft_tpu_torch')
        assert ours.get_dora_dir() == os.path.join(ours.get_cache_dir(), 'xps')
        monkeypatch.setenv('AUDIOCRAFT_CACHE_DIR', '/c')
        assert ours.get_cache_dir() == theirs.get_cache_dir() == '/c'
        misc.AudioCraftEnvironment.reset()
        monkeypatch.setenv('SLURM_JOB_ID', '7')
        assert ours.get_cluster() == 'slurm'
    finally:
        misc.AudioCraftEnvironment.reset()
        jax_misc.AudioCraftEnvironment.reset()


def test_cluster_info_without_a_launch(monkeypatch):
    for key in ENV_VARS:
        monkeypatch.delenv(key, raising=False)
    info = misc.cluster_info()
    assert info['process_index'] == 0 and info['process_count'] == 1
    assert info['coordinator'] is None and info['backend'] is None
    assert info['local_devices'] == torch.cuda.device_count()


def test_write_and_rename(tmp_path):
    p = tmp_path / 'f.bin'
    with misc.write_and_rename(p) as f:
        f.write(b'hello')
        assert not p.exists() and (tmp_path / 'f.bin.tmp').exists()
    assert p.read_bytes() == b'hello' and not (tmp_path / 'f.bin.tmp').exists()
    with pytest.raises(RuntimeError):
        with misc.write_and_rename(tmp_path / 'g.bin') as f:
            raise RuntimeError('interrupted')
    assert not (tmp_path / 'g.bin').exists()


def test_enable_compilation_cache_does_nothing_on_the_cpu(monkeypatch):
    from audiocraft_tpu_torch.ops import _build

    def refuse():
        raise AssertionError('built on the CPU')

    monkeypatch.setattr(_build, 'build', refuse)
    assert misc.enable_compilation_cache('cpu') is None
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert misc.enable_compilation_cache() is None


def _compute(calls, path, x, idx):
    calls.append(path)
    return np.arange(12, dtype=np.float32).reshape(4, 3) + idx + 10 * len(path)


def _extract(full, x, idx):
    return full[:2]


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_embedding_cache_across_packages(tmp_path, writer):
    paths = ['a.wav', 'bb.wav']
    calls_w, calls_r = [], []
    make_w = cache.EmbeddingCache if writer == 'port' else jax_cache.EmbeddingCache
    make_r = jax_cache.EmbeddingCache if writer == 'port' else cache.EmbeddingCache
    # the port's compute function may hand back a tensor
    compute_w = (lambda p, x, i: torch.from_numpy(_compute(calls_w, p, x, i))) \
        if writer == 'port' else (lambda p, x, i: _compute(calls_w, p, x, i))
    written = make_w(tmp_path, compute_w, _extract).get_embed_from_cache(paths, None)
    assert written.shape == (2, 2, 3) and len(calls_w) == 2
    reader = make_r(tmp_path, lambda p, x, i: _compute(calls_r, p, x, i), _extract)
    reader.populate_embed_cache(paths, None)
    np.testing.assert_array_equal(reader.get_embed_from_cache(paths, None), written)
    assert calls_r == [], 'the other package recomputed a cached embedding'
    files = sorted(f.name for f in tmp_path.glob('*.npy'))
    ours = cache.EmbeddingCache(tmp_path / 'o', lambda p, x, i: _compute([], p, x, i))
    theirs = jax_cache.EmbeddingCache(tmp_path / 't', lambda p, x, i: _compute([], p, x, i))
    assert files == sorted(ours._get_cache_path(p).name for p in paths) == \
        sorted(theirs._get_cache_path(p).name for p in paths)


def _write_batches(writer_cls, folder, process_index):
    w = writer_cls(folder, process_index=process_index)
    w.start_epoch(3)
    for step in range(3):
        w.save(np.full((2, 4), step, np.float32) + process_index, np.arange(step + 1))
    return w


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_batch_cache_across_packages(tmp_path, writer):
    for pi in (0, 1):
        _write_batches(cache.CachedBatchWriter if writer == 'port'
                       else jax_cache.CachedBatchWriter, tmp_path / 'w', pi)
        _write_batches(jax_cache.CachedBatchWriter if writer == 'port'
                       else cache.CachedBatchWriter, tmp_path / 'other', pi)
    # byte for byte the same files
    for f in sorted((tmp_path / 'w').rglob('*.zip')):
        assert f.read_bytes() == (tmp_path / 'other' / f.relative_to(tmp_path / 'w')).read_bytes()
    reader_cls = jax_cache.CachedBatchLoader if writer == 'port' else cache.CachedBatchLoader
    for pi in (0, 1):
        loader = reader_cls(tmp_path / 'w', batch_size=2, process_index=pi)
        loader.start_epoch(3)
        assert len(loader) == 3
        batches = list(loader)
        for step, (a, b) in enumerate(batches):
            np.testing.assert_array_equal(a, np.full((2, 4), step, np.float32) + pi)
            np.testing.assert_array_equal(b, np.arange(step + 1))
    w = cache.CachedBatchWriter(tmp_path / 'x')
    with pytest.raises(RuntimeError):
        w.save(np.zeros(2))
    w.start_epoch(0)
    w.save(torch.arange(3))          # a tensor is saved from the host
    loader = cache.CachedBatchLoader(tmp_path / 'x', batch_size=1)
    loader.start_epoch(0)
    np.testing.assert_array_equal(list(loader)[0][0], np.arange(3))
