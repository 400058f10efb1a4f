"""The port's Mixture-of-Experts block and every path through it, against
the JAX package, at test-tiny-moe size (d_model 64, 4 experts, top 2,
d_mlp 256, 2 layers).

Inputs are made with numpy from a seed; parameters come from a seeded
JAX init carried across with models/convert.params_from_jax. Pinned:
- the block (models/moe.MoEBlock) against the reference's
  MoEBlock.apply: dense and dispatch, fp32 and bf16, capacity factor
  0.25 (drops), capacity factor E (equal to dense), odd token counts, a
  routing tie; `group_size` for every g in 1..5000;
- the full-sequence logits of test-tiny-moe and of a DBRX-style tiny
  (LayerNorm without bias, qkv_clip, 4 experts top 2) against the JAX
  Transformer's, the tree carried back bit for bit and the unscanned
  layout carried to the same state;
- construction on `meta` at mixtral-8x7b's widths, the refusals (a
  parallel block, int8 weights) and the random init's fan-in.
The engine and trainer are pinned in tests/test_torch_moe_engine.py.

Tolerances: the block's fp32 output within 1e-6 (fp32 products summed in
other orders; measured <= 8e-8), bf16 within 4e-3 (a bf16 ulp at the
outputs' magnitude ~0.2 is 1e-3; measured 1e-3); the logits within
2e-5, tests/test_torch_model.py's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.moe import MoEBlock as JaxMoEBlock
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax, params_to_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.models.transformer import Transformer

_FP32 = dict(dtype='float32', param_dtype='float32', remat=False)
_BLOCK_TOL = {'float32': 1e-6, 'bfloat16': 4e-3}
_LOGIT_TOL = 2e-5
_DBRX = dict(norm_style='layernorm', norm_bias=False, qkv_clip=8.0)


def _block_params(cfg, x):
    return nn.unbox(JaxMoEBlock(cfg).init(jax.random.PRNGKey(1),
                                          jnp.asarray(x)))['params']


def _port_block(cfg, params):
    block = moe.MoEBlock(cfg, device='cpu')
    with torch.no_grad():
        for name in ('router', 'w_gate', 'w_up', 'w_down'):
            getattr(block, name).copy_(torch.from_numpy(
                np.array(params[name], np.float32)))
    return block


def _block_pair(x, params=None, **kw):
    jcfg = dataclasses.replace(jax_get_config('test-tiny-moe'), **kw)
    tcfg = get_config('test-tiny-moe', **kw)
    params = _block_params(jcfg, x) if params is None else params
    dtype = kw.get('dtype', 'float32')
    ref = JaxMoEBlock(jcfg).apply({'params': params},
                                  jnp.asarray(x, dtype))
    with torch.no_grad():
        got = _port_block(tcfg, params)(
            torch.from_numpy(x).to(getattr(torch, dtype)))
    return got.float().numpy(), np.asarray(ref.astype(jnp.float32)), params


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('impl,factor', [('dense', 1.25),
                                         ('dispatch', 1.25),
                                         ('dispatch', 0.25),
                                         ('dispatch', 4.0)],
                         ids=['dense', 'dispatch', 'drops', 'no_drops'])
@pytest.mark.parametrize('shape', [(2, 16), (3, 7)], ids=['even', 'odd'])
def test_block_matches_reference(dtype, impl, factor, shape):
    x = np.random.RandomState(0).randn(*shape, 64).astype(np.float32)
    got, ref, _ = _block_pair(x, moe_impl=impl, moe_capacity_factor=factor,
                              dtype=dtype, param_dtype='float32')
    np.testing.assert_allclose(got, ref, atol=_BLOCK_TOL[dtype], rtol=0)


def test_drops_happen_and_capacity_e_equals_dense():
    x = np.random.RandomState(3).randn(2, 16, 64).astype(np.float32)
    kw = dict(dtype='float32', param_dtype='float32')
    dense, _, params = _block_pair(x, moe_impl='dense', **kw)
    full, _, _ = _block_pair(x, params, moe_impl='dispatch',
                             moe_capacity_factor=4.0, **kw)
    dropped, _, _ = _block_pair(x, params, moe_impl='dispatch',
                                moe_capacity_factor=0.25, **kw)
    np.testing.assert_allclose(full, dense, atol=1e-6, rtol=0)
    assert np.abs(dropped).sum() < np.abs(full).sum()
    # The drop count the capacity rule gives, from route alone.
    idx, _ = moe.route(torch.from_numpy(x).reshape(1, 32, 64),
                       torch.from_numpy(np.array(params['router'])), 2)
    cap = moe.capacity(32, 2, 4, 0.25)
    assert cap == 4 and (moe.positions(idx, 4) >= cap).sum() > 0


def test_routing_tie_keeps_the_lower_expert_first():
    # A zero router column pair ties experts 1 and 3 (and 0 and 2 when x
    # is zero): jax.lax.top_k keeps the lower index first, so must the
    # port, and both blocks must agree.
    rng = np.random.RandomState(4)
    x = rng.randn(1, 8, 64).astype(np.float32)
    x[0, :3] = 0.0
    kw = dict(dtype='float32', param_dtype='float32',
              moe_capacity_factor=0.5)
    jcfg = dataclasses.replace(jax_get_config('test-tiny-moe'), **kw)
    params = dict(_block_params(jcfg, x))
    router = np.array(params['router'])
    router[:, 3] = router[:, 1]
    params['router'] = router
    got, ref, _ = _block_pair(x, params, **kw)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    idx, probs = moe.route(torch.from_numpy(x), torch.from_numpy(router), 2)
    _, want = jax.lax.top_k(jnp.asarray(x) @ jnp.asarray(router), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert idx[0, 0].tolist() == [0, 1] and probs[0, 0, 0] == 0.5


def test_group_size_and_capacity_equal_the_reference():
    for g in range(1, 5001):
        assert moe.group_size(g) == JaxMoEBlock._group_size(g), g
    cfg = jax_get_config('mixtral-8x7b')
    assert moe.capacity(8, 2, 8, cfg.moe_capacity_factor) == 2
    assert moe.capacity(256, 2, 8, 1.25) == 80
    assert moe.capacity(4, 4, 16, 1.25) == 1


def test_unknown_moe_impl_raises():
    block = moe.MoEBlock(get_config('test-tiny-moe', moe_impl='sparse',
                                    **_FP32), device='cpu')
    with pytest.raises(ValueError, match='Unknown moe_impl'):
        block(torch.zeros(1, 1, 64))


# ------------------------------------------------------------ the model

def _jax_model_params(jcfg):
    return jax.device_get(nn.unbox(jax.jit(JaxTransformer(jcfg).init)(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32)))['params'])


@pytest.mark.parametrize('family', ['mixtral', 'dbrx'])
def test_full_sequence_logits_match_reference(family):
    kw = dict(_FP32, **(_DBRX if family == 'dbrx' else {}))
    jcfg = dataclasses.replace(jax_get_config('test-tiny-moe'), **kw)
    tcfg = get_config('test-tiny-moe', **kw)
    params = _jax_model_params(jcfg)
    tokens = np.random.RandomState(5).randint(0, 512, (2, 24))
    ref = JaxTransformer(jcfg).apply({'params': params},
                                     jnp.asarray(tokens))
    model = Transformer(tcfg, device='cpu')
    state = params_from_jax(params, tcfg)
    model.load_state_dict(state, assign=True)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=_LOGIT_TOL,
                               rtol=0)
    back = params_to_jax(state, tcfg)
    for name, value in params['layers']['layer']['moe'].items():
        np.testing.assert_array_equal(
            back['layers']['layer']['moe'][name], np.asarray(value))
    # The unscanned layout (layer_{i}) carries to the same state.
    unscanned = {k: v for k, v in params.items() if k != 'layers'}
    for i in range(tcfg.num_layers):
        unscanned[f'layer_{i}'] = jax.tree.map(lambda a, i=i: a[i],
                                               params['layers']['layer'])
    for key, value in params_from_jax(unscanned, tcfg).items():
        assert torch.equal(value, state[key]), key


def test_moe_config_builds_on_meta_with_the_reference_shapes():
    cfg = dataclasses.replace(get_config('mixtral-8x7b'), num_layers=1)
    model = Transformer(cfg, device='meta')
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
              if '.moe.' in k}
    assert shapes == {'layers.0.moe.router': (4096, 8),
                      'layers.0.moe.w_gate': (8, 4096, 14336),
                      'layers.0.moe.w_up': (8, 4096, 14336),
                      'layers.0.moe.w_down': (8, 14336, 4096)}
    assert model.layers[0].mlp is None
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params()


def test_moe_refusals():
    with pytest.raises(NotImplementedError, match='parallel_block'):
        Transformer(get_config('test-tiny-moe', parallel_block=True),
                    device='meta')
    with pytest.raises(NotImplementedError, match='dense-model only'):
        Transformer(get_config('test-tiny-moe', weight_quant='int8'),
                    device='meta')
    with pytest.raises(NotImplementedError, match='dense-model only'):
        ContinuousBatchingEngine('test-tiny-moe', paged_block_size=8,
                                 quantize='int8', device='cpu')


def test_random_init_draws_the_reference_fan_in():
    cfg = get_config('test-tiny-moe', d_mlp=512, **_FP32)
    model = Transformer(cfg, device='cpu').init_random_(0)
    block = model.layers[0].moe
    # lecun_normal: std sqrt(1 / fan_in), fan_in = E x in for a stack.
    for name, fan_in in (('router', 64), ('w_gate', 4 * 64),
                         ('w_up', 4 * 64), ('w_down', 4 * 512)):
        std = float(getattr(block, name).detach().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, (name, std)
