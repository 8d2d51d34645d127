"""The port's quantizer training against the JAX package, on the CPU:
k-means, the EMA update in its three expiry modes, the RVQ training
forward (k-means on a fresh codebook, the EMA, the penalty, the
straight-through estimator, ``n_q_active`` masking), a fresh codebook's
init and quantizer dropout's draw.

The port draws its random rows from a ``torch.Generator``; JAX draws with
``jax.random.permutation`` / ``randint``.  Each test draws JAX's rows from
JAX's keys (:func:`jax_rows`, the draw of ``quant/codebook.sample_vectors``)
and passes them into the port's arithmetic.  Inputs are made from numpy
seeds; JAX runs under ``jax.jit``.  Tolerances: codes equal; means, EMA
state, quantized latents and penalties within 1e-5 (fp32 on both sides,
sums in another order only); gradients within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.quant import codebook as jax_cb
from audiocraft_tpu.quant.vq import ResidualVectorQuantizer as JaxRVQ
from audiocraft_tpu_torch.quant import codebook
from audiocraft_tpu_torch.quant.vq import ResidualVectorQuantizer

TOL = 1e-5


def jax_rows(key, n: int, num: int) -> torch.Tensor:
    """The rows JAX's ``sample_vectors(key, samples[n], num)`` picks."""
    if n >= num:
        idx = jax.random.permutation(key, n)[:num]
    else:
        idx = jax.random.randint(key, (num,), 0, n)
    return torch.from_numpy(np.array(idx)).long()


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


def _blobs(n, d, seed, centers=6):
    """Rows around a few centres, so that k-means has clusters to find."""
    rng = np.random.RandomState(seed)
    c = rng.randn(centers, d) * 2
    return (c[rng.randint(0, centers, n)] + 0.3 * rng.randn(n, d)).astype(np.float32)


@pytest.mark.parametrize('n,k', [(300, 16), (10, 16)], ids=['without-replacement', 'with'])
def test_kmeans_matches_jax(n, k):
    samples = _blobs(n, 8, seed=1)
    key = jax.random.PRNGKey(3)
    means, bins = jax.jit(jax_cb.kmeans, static_argnums=(2, 3))(key, jnp.asarray(samples), k, 10)
    pm, pb = codebook.kmeans(torch.from_numpy(samples), k, 10, jax_rows(key, n, k))
    _close(pm, means)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(bins))
    assert float(pb.sum()) == n


def _state(k, d, seed):
    rng = np.random.RandomState(seed)
    embed = rng.randn(k, d).astype(np.float32)
    cluster = rng.uniform(0, 6, k).astype(np.float32)   # some under the threshold of 2
    return (embed, cluster, (embed * cluster[:, None]).astype(np.float32),
            np.ones((), np.float32))


@pytest.mark.parametrize('expiry', ['reference', 'effective', 'none'])
def test_ema_update_matches_jax(expiry):
    k, d, n = 32, 8, 200
    embed, cluster, avg, inited = _state(k, d, seed=2)
    x = _blobs(n, d, seed=4)
    idx = np.random.RandomState(5).randint(0, k, n).astype(np.int32)
    key = jax.random.PRNGKey(6)
    cb = jax_cb.EuclideanCodebook(dim=d, codebook_size=k, decay=0.9)
    jstate = jax_cb.CodebookState(jnp.asarray(embed), jnp.asarray(cluster), jnp.asarray(avg),
                                  jnp.asarray(inited))
    fn = jax.jit(functools.partial(cb.ema_update, expiry=expiry))
    ref = fn(jstate, jnp.asarray(x), jnp.asarray(idx), key)
    state = codebook.CodebookState(*(torch.from_numpy(np.array(a)).reshape(s) for a, s in
                                     zip((embed, cluster, avg, inited), ((k, d), (k,), (k, d), (1,)))))
    out = codebook.ema_update(state, torch.from_numpy(x), torch.from_numpy(idx), 0.9,
                              expiry=expiry, expiry_idx=jax_rows(key, n, k))
    for name in ('embed', 'cluster_size', 'embed_avg'):
        _close(getattr(out, name), getattr(ref, name))
    expired = cluster < 2.0
    assert expired.any()
    if expiry == 'effective':   # the replaced rows really are batch rows
        rows = x[jax_rows(key, n, k).numpy()]
        _close(out.embed.numpy()[expired], rows[expired])
    with pytest.raises(ValueError, match='expiry'):
        codebook.ema_update(state, torch.from_numpy(x), torch.from_numpy(idx), 0.9,
                            expiry='sometimes')


def test_fresh_codebook_equals_jax_init():
    """kmeans_init (the default): zeros, inited 0, as JAX's init; without it,
    the uniform init's bound and inited 1."""
    jstate = JaxRVQ(dimension=8, n_q=3, bins=16).init(jax.random.PRNGKey(0))
    port = ResidualVectorQuantizer(dimension=8, n_q=3, bins=16)
    for q, layer in enumerate(port.vq.layers):
        cb = layer._codebook
        for name in ('embed', 'cluster_size', 'embed_avg'):
            np.testing.assert_array_equal(getattr(cb, name).numpy(),
                                          np.asarray(getattr(jstate, name)[q]))
        assert float(cb.inited) == float(jstate.inited[q]) == 0.0
    uni = ResidualVectorQuantizer(dimension=8, n_q=1, bins=16, kmeans_init=False,
                                  generator=torch.Generator().manual_seed(0))
    cb = uni.vq.layers[0]._codebook
    assert float(cb.inited) == 1.0
    bound = float(np.sqrt(2.0) * np.sqrt(3.0 / 8))
    assert 0 < float(cb.embed.abs().max()) <= bound and torch.equal(cb.embed, cb.embed_avg)


def _rvq_pair(n_q=3, bins=16, dim=8, seed=0):
    jrvq = JaxRVQ(dimension=dim, n_q=n_q, bins=bins, decay=0.9)
    port = ResidualVectorQuantizer(dimension=dim, n_q=n_q, bins=bins, decay=0.9)
    return jrvq, jrvq.init(jax.random.PRNGKey(seed)), port


def _jax_forward(jrvq, expiry):
    return jax.jit(functools.partial(jrvq.forward, frame_rate=50.0, training=True,
                                     expiry=expiry))


def _draws(key, n_q, n, k):
    return [jax_rows(kq, n, k) for kq in jax.random.split(key, n_q)]


def _port_state(port):
    layers = [layer._codebook for layer in port.vq.layers]
    return {name: np.stack([getattr(cb, name).numpy() for cb in layers])
            for name in ('embed', 'cluster_size', 'embed_avg', 'inited')}


def _compare_state(port, jstate):
    got = _port_state(port)
    for name in ('embed', 'cluster_size', 'embed_avg'):
        _close(got[name], getattr(jstate, name))
    np.testing.assert_array_equal(got['inited'].reshape(-1), np.asarray(jstate.inited))


@pytest.mark.parametrize('n_q_active', [None, 2], ids=['all', 'dropout-2'])
@pytest.mark.parametrize('expiry', ['reference', 'effective'])
def test_rvq_training_forward_matches_jax(expiry, n_q_active):
    """Two steps from a fresh quantizer: k-means on the first batch, then
    the EMA; codes equal, quantized, penalty, bandwidth and the whole state
    within 1e-5, and the layers past ``n_q_active`` keep their k-means state."""
    n_q, bins, dim, B, T = 3, 16, 8, 2, 40
    jrvq, jstate, port = _rvq_pair(n_q, bins, dim)
    fwd = _jax_forward(jrvq, expiry)
    nq = None if n_q_active is None else jnp.asarray(n_q_active, jnp.int32)
    for step in range(2):
        x = np.moveaxis(_blobs(B * T, dim, seed=10 + step).reshape(B, T, dim), 1, 2).copy()
        key = jax.random.PRNGKey(20 + step)
        res, jstate = fwd(jstate, jnp.asarray(x), key=key, n_q_active=nq)
        before = _port_state(port)
        out = port(torch.from_numpy(x), 50.0, n_q_active=n_q_active, training=True,
                   draws=_draws(key, n_q, B * T, bins), expiry=expiry)
        np.testing.assert_array_equal(out.codes.numpy(), np.asarray(res.codes))
        _close(out.x, res.x)
        _close(out.penalty, res.penalty)
        _close(out.bandwidth, res.bandwidth)
        _compare_state(port, jstate)
        if step == 1 and n_q_active is not None:
            after = _port_state(port)
            for name in ('embed', 'cluster_size', 'embed_avg'):
                np.testing.assert_array_equal(after[name][n_q_active:],
                                              before[name][n_q_active:])


def test_rvq_straight_through_gradient_matches_jax():
    """The gradient of <quantized, c> + penalty in the input: the RVQ-wide
    straight-through estimator passes c, and the penalty adds its own term."""
    n_q, bins, dim, B, T = 3, 16, 8, 2, 30
    jrvq, jstate, port = _rvq_pair(n_q, bins, dim)
    x = np.moveaxis(_blobs(B * T, dim, seed=30).reshape(B, T, dim), 1, 2).copy()
    c = np.random.RandomState(31).randn(B, dim, T).astype(np.float32)
    key = jax.random.PRNGKey(32)

    def f(xx):
        res, _ = jrvq.forward(jstate, xx, 50.0, key=key, training=True)
        return jnp.sum(res.x * c) + res.penalty

    ref = jax.jit(jax.grad(f))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt, 50.0, training=True, draws=_draws(key, n_q, B * T, bins))
    grad, = torch.autograd.grad((out.x * torch.from_numpy(c)).sum() + out.penalty, xt)
    _close(grad, ref)
    assert float((grad - torch.from_numpy(c)).abs().max()) > 0   # the penalty's term is there


def test_training_forward_draws_from_a_generator():
    """Without injected draws the rows come from the generator: the same seed
    gives the same codebooks; no generator and no draws raises."""
    x = torch.from_numpy(np.moveaxis(_blobs(80, 8, seed=40).reshape(2, 40, 8), 1, 2).copy())
    runs = []
    for _ in range(2):
        port = ResidualVectorQuantizer(dimension=8, n_q=2, bins=16)
        port(x, 50.0, training=True, generator=torch.Generator().manual_seed(7),
             expiry='effective')
        runs.append(_port_state(port))
    for name in runs[0]:
        np.testing.assert_array_equal(runs[0][name], runs[1][name])
    with pytest.raises(ValueError, match='generator'):
        ResidualVectorQuantizer(dimension=8, n_q=2, bins=16)(x, 50.0, training=True)


def test_sample_n_q_active_in_range():
    rvq = ResidualVectorQuantizer(dimension=4, n_q=4, bins=8)
    gen = torch.Generator().manual_seed(0)
    draws = {rvq.sample_n_q_active(gen) for _ in range(200)}
    assert draws == {1, 2, 3, 4}
