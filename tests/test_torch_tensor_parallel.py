"""The port's tensor-parallel ``'model'`` axis (``dist/mesh.make_mesh`` and
``shard_lm``) over four gloo processes on the CPU: a 2 data x 2 model mesh.

The LM is JAX's tiny LM of tests/test_distributed.py (4 codebooks of 64,
width 32, 4 heads, 2 layers, cross-attention, biases everywhere), its
weights the port's seeded init carried into JAX's tree
(``test_torch_codec_train.jax_tree_from_port``).  One start of the ranks
(``python tests/test_torch_tensor_parallel.py TASK DIR RANK PORT``, through
``tests/torch_ranks.py``) runs the default LM and one with ``kv_repeat=2``:
each rank shards the LM over its model group, runs its data group's half of
the batch, and backpropagates a fixed weighting of the logits, the
gradients summed over its data group.

* The logits of every rank equal JAX's replicated forward at the bar of
  tests/test_distributed.py (atol 2e-5, rtol 1e-4), and the two model ranks'
  bit for bit.
* Each rank's gradients equal its block of the one-process gradients of the
  whole batch within 1e-5 of each tensor's largest: the q, k and v rows of
  its heads, the input columns of ``out_proj`` and ``linear2``, the rows of
  ``linear1`` and of the heads, and the whole of every replicated tensor.
"""

import functools
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

N_DATA, N_MODEL = 2, 2
WORLD = N_DATA * N_MODEL
CFG = dict(n_q=4, card=64, dim=32, num_heads=4, num_layers=2, cross_attention=True,
           causal=True, norm_first=True)
B, S, TC = 4, 6, 3
KV_REPEATS = (1, 2)


def _port_lm(kv_repeat):
    from audiocraft_tpu_torch.cond.fuser import ConditionFuser
    from audiocraft_tpu_torch.lm.model import LMModel
    from audiocraft_tpu_torch.patterns import DelayedPatternProvider
    return LMModel(ConditionFuser.from_dict({'cross': ('description',)}),
                   pattern_provider=DelayedPatternProvider(4), kv_repeat=kv_repeat,
                   generator=torch.Generator().manual_seed(kv_repeat), **CFG)


def _loss_and_grads(lm, seq, cond, weight):
    lm.requires_grad_(True)
    logits = lm(seq, {'description': cond})
    (logits * weight).sum().backward()
    return logits.detach(), {n: p.grad.clone() for n, p in lm.named_parameters()}


# ------------------------------------------------------------------- the ranks

def _rank_main() -> None:
    from audiocraft_tpu_torch.dist import mesh

    from torch_ranks import finish_rank, rank_args

    task, folder, rank, port = rank_args()
    torch.set_num_threads(1)
    data_group, model_group = mesh.make_mesh(N_DATA, N_MODEL, 'gloo',
                                             f'tcp://127.0.0.1:{port}', WORLD, rank)
    inputs = torch.load(folder / 'inputs.pt')
    out = {}
    for kv_repeat in KV_REPEATS:
        case = inputs[kv_repeat]
        lm = _port_lm(kv_repeat)
        lm.load_state_dict(case['lm'])
        mesh.shard_lm(lm, model_group)
        part = functools.partial(mesh.shard_batch, group=data_group)
        logits, grads = _loss_and_grads(lm, part(case['seq']),
                                        tuple(part(t) for t in case['cond']),
                                        part(case['weight']))
        names = list(grads)
        summed = mesh.sum_grads([grads[n] for n in names], data_group)
        out[kv_repeat] = {'logits': logits, 'grads': dict(zip(names, summed)),
                          'data_index': mesh.rank(data_group),
                          'model_index': mesh.rank(model_group)}
    finish_rank(folder, rank, out)


# -------------------------------------------------------------------- the tests

def _block(name: str, g: torch.Tensor, lm, m: int) -> torch.Tensor:
    """Model rank m's block of the one-process gradient ``g`` of ``name``."""
    def part(t, dim):
        size = t.shape[dim] // N_MODEL
        return t.narrow(dim, m * size, size)

    if name.endswith('in_proj_weight') or name.endswith('in_proj_bias'):
        attn = lm.get_submodule(name.rsplit('.', 1)[0])
        E, kv = attn.embed_dim, attn.kv_dim
        return torch.cat([part(g[:E], 0), part(g[E:E + kv], 0), part(g[E + kv:], 0)])
    if name.endswith('out_proj.weight') or name.endswith('linear2.weight'):
        return part(g, 1)
    if '.linear1.' in name or name.startswith('linears.'):
        return part(g, 0)
    return g


@pytest.fixture(scope='module')
def tp_case(tmp_path_factory):
    """Each case's LM, inputs and JAX logits, and what the ranks hold."""
    import jax
    import jax.numpy as jnp

    from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
    from audiocraft_tpu.lm.model import LMModel as JaxLM
    from audiocraft_tpu.patterns import DelayedPatternProvider as JaxDelayed
    from audiocraft_tpu_torch.ckpt.from_jax import lm_state_from_jax

    from test_torch_codec_train import jax_tree_from_port
    from torch_ranks import run_ranks

    cases, inputs = {}, {}
    for kv_repeat in KV_REPEATS:
        rng = np.random.RandomState(kv_repeat)
        seq = torch.from_numpy(rng.randint(0, 64, (B, 4, S)).astype(np.int64))
        cond = (torch.from_numpy(rng.randn(B, TC, 32).astype(np.float32)),
                torch.ones(B, TC, dtype=torch.long))
        weight = torch.from_numpy(rng.randn(B, 4, S, 64).astype(np.float32))
        lm = _port_lm(kv_repeat)
        with torch.no_grad():   # biases and norms off their init values
            gen = torch.Generator().manual_seed(10 + kv_repeat)
            for p in lm.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        jlm = JaxLM(pattern_provider=JaxDelayed(4), fuser=JaxFuser.from_dict(
            {'cross': ('description',)}), kv_repeat=kv_repeat, **CFG)
        params = jax_tree_from_port(jlm.init, lm.state_dict(),
                                    functools.partial(lm_state_from_jax, lm))
        ref, _ = jax.jit(lambda p, s, c: jlm.forward(p, s, {'description': c}))(
            params, jnp.asarray(seq.numpy()), tuple(jnp.asarray(t.numpy()) for t in cond))
        cases[kv_repeat] = dict(lm=lm, seq=seq, cond=cond, weight=weight, jax=np.asarray(ref))
        inputs[kv_repeat] = dict(lm={k: v.clone() for k, v in lm.state_dict().items()},
                                 seq=seq, cond=cond, weight=weight)
    ranks = run_ranks(__file__, 'tp', tmp_path_factory.mktemp('tp'), inputs, WORLD)
    return cases, ranks


@pytest.mark.parametrize("kv_repeat", KV_REPEATS)
def test_sharded_logits_equal_jax(tp_case, kv_repeat):
    cases, ranks = tp_case
    case = cases[kv_repeat]
    half = B // N_DATA
    for r in ranks:
        got = r[kv_repeat]
        d = got['data_index']
        np.testing.assert_allclose(got['logits'].numpy(), case['jax'][d * half:(d + 1) * half],
                                   atol=2e-5, rtol=1e-4)
    for d in range(N_DATA):
        pair = [r[kv_repeat]['logits'] for r in ranks if r[kv_repeat]['data_index'] == d]
        assert len(pair) == N_MODEL and torch.equal(pair[0], pair[1])
    assert sorted((r[kv_repeat]['data_index'], r[kv_repeat]['model_index'])
                  for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("kv_repeat", KV_REPEATS)
def test_sharded_gradients_equal_one_process(tp_case, kv_repeat):
    cases, ranks = tp_case
    case = cases[kv_repeat]
    lm = _port_lm(kv_repeat)
    lm.load_state_dict(case['lm'].state_dict())
    _, grads = _loss_and_grads(lm, case['seq'], case['cond'], case['weight'])
    for r in ranks:
        got = r[kv_repeat]
        assert set(got['grads']) == set(grads)
        for name, g in grads.items():
            ref = _block(name, g, lm, got['model_index'])
            err = float((got['grads'][name] - ref).abs().max())
            assert got['grads'][name].shape == ref.shape, name
            assert err <= 1e-5 * max(float(ref.abs().max()), 1e-6), f'{name}: {err:.3g}'


def test_one_rank_shard_is_the_model_and_refusals():
    """Without a group ``shard_lm`` keeps every tensor and the logits; heads
    that do not split and ``qk_layer_norm`` are refused, and so are the
    split model's decode (caches, cross K/V, generate) and quantizing it."""
    from audiocraft_tpu_torch.dist import mesh
    from audiocraft_tpu_torch.lm.quantize import quantize_lm_params
    from audiocraft_tpu_torch.nn.transformer import StreamingMultiheadAttention
    lm = _port_lm(2)
    seq = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 4, S)))
    cond = {'description': (torch.randn(2, TC, 32, generator=torch.Generator().manual_seed(1)),
                            torch.ones(2, TC, dtype=torch.long))}
    with torch.no_grad():
        ref = lm(seq, cond)
        state = {k: v.clone() for k, v in lm.state_dict().items()}
        mesh.shard_lm(lm, None)
        assert all(torch.equal(v, state[k]) for k, v in lm.state_dict().items())
        assert torch.equal(lm(seq, cond), ref)
    with pytest.raises(ValueError, match='decode with a model group'):
        lm.init_cache(2, 8)
    with pytest.raises(ValueError, match='decode with a model group'):
        lm.transformer.precompute_cross_kv(cond['description'][0])
    with pytest.raises(ValueError, match='decode with a model group'):
        lm.generate(condition_tensors=cond, max_gen_len=4, use_sampling=False)
    with pytest.raises(ValueError, match='split by shard_lm'):
        quantize_lm_params(lm)
    assert all(torch.equal(v, state[k]) for k, v in lm.state_dict().items())
    assert isinstance(lm, type(_port_lm(1)))
    # nothing of the split holds the model past its last reference
    gone = weakref.ref(lm)
    del lm
    assert gone() is None
    with pytest.raises(ValueError, match='split'):
        mesh._shard_attention(StreamingMultiheadAttention(32, 4, kv_repeat=4), None, 2, 0)
    with pytest.raises(ValueError, match='qk_layer_norm'):
        mesh._shard_attention(StreamingMultiheadAttention(32, 4, qk_layer_norm=True), None, 2, 0)


if __name__ == '__main__':
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    _rank_main()
