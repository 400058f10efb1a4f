"""The port's paged Transformer against the JAX paged Transformer.

Same test-tiny fp32 weights (a seeded JAX init carried across with
models/convert.params_from_jax, scanned and unscanned layouts), same
numpy tokens, positions and block tables: a prefill chunk then several
decode steps through the paged pool. Logits must agree within 2e-5 and
the K/V pools the two write must agree within 2e-5 (measured ~1.7e-6:
fp32 matmuls and the streaming vs one-shot softmax sum in other orders;
torch's and XLA's pow/cos may differ by an ulp in the rope angles).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.models.transformer import apply_rope as jax_apply_rope
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.transformer import (RMSNorm, Transformer,
                                                   apply_rope)

_ATOL = 2e-5
_BS, _NB, _MAX_SEQ = 8, 20, 64


def _cfgs(scan_layers=True):
    kw = dict(dtype='float32', param_dtype='float32', max_seq_len=_MAX_SEQ,
              remat=False, scan_layers=scan_layers)
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **kw)
    tcfg = dataclasses.replace(get_config('test-tiny'), decode=True,
                               paged_block_size=_BS, paged_num_blocks=_NB,
                               **kw)
    return jcfg, tcfg


def _jax_params(jcfg):
    variables = jax.jit(JaxTransformer(jcfg).init)(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    return nn.unbox(variables)['params']


@pytest.mark.parametrize('scan_layers', [True, False],
                         ids=['scanned', 'unscanned'])
def test_paged_logits_match_reference(scan_layers):
    jcfg, tcfg = _cfgs(scan_layers)
    params = _jax_params(jcfg)
    dcfg = dataclasses.replace(jcfg, decode=True, paged_block_size=_BS,
                               paged_num_blocks=_NB)
    jmodel = JaxTransformer(dcfg)
    rng = np.random.RandomState(0)
    batch, width = 2, _MAX_SEQ // _BS + 1
    tables = np.zeros((batch, width), np.int32)
    perm = rng.permutation(_NB - 1) + 1
    tables[0, :3] = perm[:3]
    tables[1, :4] = perm[3:7]
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.ones((batch, 1), jnp.int32),
        jnp.zeros((batch, 1), jnp.int32),
        block_tables=jnp.asarray(tables)))['cache']
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         nn.unbox(shapes))

    model = Transformer(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(jax.device_get(params), tcfg),
                          assign=True)
    k_pool, v_pool = model.new_kv_pool(_NB)
    # A prefill chunk (row 1 starts mid-block, past unwritten zeros),
    # then decode steps crossing a block boundary.
    steps = [(rng.randint(0, 512, (batch, 8)),
              np.stack([np.arange(8), np.arange(5, 13)]))]
    steps += [(rng.randint(0, 512, (batch, 1)), np.array([[8 + s], [13 + s]]))
              for s in range(4)]
    for tokens, positions in steps:
        ref, mutated = jmodel.apply(
            {'params': params, 'cache': cache},
            jnp.asarray(tokens, jnp.int32), jnp.asarray(positions, jnp.int32),
            block_tables=jnp.asarray(tables), mutable=['cache'])
        cache = nn.unbox(mutated['cache'])
        with torch.inference_mode():
            ours = model(torch.from_numpy(tokens).int(),
                         torch.from_numpy(positions).int(),
                         torch.from_numpy(tables), k_pool, v_pool)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   atol=_ATOL, rtol=_ATOL)
    if scan_layers:
        ref_k = cache['layers']['layer']['attn']['cached_key']
        ref_v = cache['layers']['layer']['attn']['cached_value']
    else:
        ref_k = np.stack([cache[f'layer_{i}']['attn']['cached_key']
                          for i in range(tcfg.num_layers)])
        ref_v = np.stack([cache[f'layer_{i}']['attn']['cached_value']
                          for i in range(tcfg.num_layers)])
    np.testing.assert_allclose(k_pool.numpy(), np.asarray(ref_k),
                               atol=_ATOL, rtol=_ATOL)
    np.testing.assert_allclose(v_pool.numpy(), np.asarray(ref_v),
                               atol=_ATOL, rtol=_ATOL)


def test_logits_at_selects_one_position():
    _, tcfg = _cfgs()
    model = Transformer(tcfg, device='cpu').init_random_(0)
    k_pool, v_pool = model.new_kv_pool(_NB)
    tokens = torch.arange(8, dtype=torch.int32)[None]
    positions = torch.arange(8, dtype=torch.int32)[None]
    tables = torch.zeros((1, _MAX_SEQ // _BS + 1), dtype=torch.int32)
    tables[0, 0] = 3
    with torch.inference_mode():
        full = model(tokens, positions, tables, k_pool, v_pool)
        one = model(tokens, positions, tables, k_pool, v_pool, logits_at=5)
    torch.testing.assert_close(one[0], full[0, 5], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('scaling', [None, (8.0, 1.0, 4.0, 8192)],
                         ids=['plain', 'llama3'])
def test_rope_matches_reference(scaling):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [100, 2000, 7000, 30000, 131071]],
                   np.int32)
    ref = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5,
                         scaling=scaling)
    ours = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5,
                      scaling=scaling)
    # Angles reach 1.3e5 rad: an ulp of the fp32 angle is ~8e-3 rad, so
    # the pins are the tolerance of one-ulp pow/cos differences there.
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-2,
                               rtol=0)
    np.testing.assert_allclose(ours.numpy()[0], np.asarray(ref)[0],
                               atol=1e-6, rtol=0)


def test_rmsnorm_matches_reference():
    from skypilot_tpu.models.transformer import RMSNorm as JaxRMSNorm
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(2)
    x = rng.randn(3, 4, tcfg.d_model).astype(np.float32) * 3
    w = rng.randn(tcfg.d_model).astype(np.float32)
    ref = JaxRMSNorm(jcfg).apply({'params': {'scale': jnp.asarray(w)}},
                                 jnp.asarray(x))
    norm = RMSNorm(tcfg)
    norm.weight.data.copy_(torch.from_numpy(w))
    np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('name', ['gemma-2b', 'qwen2-7b', 'mixtral-8x7b',
                                  'gpt2-124m', 'falcon-7b', 'gemma2-9b'])
def test_unported_families_refused_at_construction(name):
    cfg = dataclasses.replace(get_config(name), paged_block_size=16,
                              num_layers=1)
    with pytest.raises(NotImplementedError, match='not ported'):
        Transformer(cfg, device='meta')


def test_contiguous_layout_refused():
    """Serving (decode) needs the paged layout; the full-sequence
    training path (decode=False) needs no KV layout at all."""
    with pytest.raises(NotImplementedError, match='paged'):
        Transformer(dataclasses.replace(get_config('test-tiny'), decode=True),
                    device='meta')
    Transformer(get_config('test-tiny'), device='meta')


def test_model_builds_on_the_card_by_default(monkeypatch):
    """Like the engine and the trainer, the model class defaults to the
    card and refuses to fall back to the CPU without CUDA."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(get_config('test-tiny'))
    Transformer(get_config('test-tiny'), device='cpu')


def test_params_from_jax_checks_shapes():
    jcfg, tcfg = _cfgs()
    tree = jax.device_get(_jax_params(jcfg))
    tree['lm_head']['kernel'] = tree['lm_head']['kernel'][:, :10]
    with pytest.raises(ValueError, match='lm_head'):
        params_from_jax(tree, tcfg)


def test_llama3_8b_shapes_at_full_width():
    """The served model's module tree at full width and depth, built on
    the meta device (no memory): 8.03 B parameters, as the reference
    config counts them."""
    cfg = dataclasses.replace(get_config('llama3-8b'), paged_block_size=16)
    model = Transformer(cfg, device='meta')
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params()
    assert model.layers[0].attn.qkv_proj.shape == (4096, (32 + 16) * 128)
    assert len(model.layers) == 32
