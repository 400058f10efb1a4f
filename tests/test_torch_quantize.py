"""int8 weight-only serving in the port against the JAX package.

Family configs and perturbed seeded weights as in
tests/test_torch_families.py. Pinned: `quantize_state` of the port's
float state equals `params_from_jax` of the reference's
`quantize_params` tree bit for bit (int8 payloads and fp32 scales; the
fused projections' scales are the per-projection scales concatenated);
int8-weight logits within 2e-5 of the JAX `weight_quant='int8'` model;
the engine's `quantize='int8'` greedy tokens equal to the JAX engine's;
the int8 state carried back to the reference's tree; the reference's
refusals (MoE, adapters over int8 weights).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models.quantize import quantize_params
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu_torch.models import quantize
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax, params_to_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.models.transformer import Transformer
from test_torch_families import (_generate, configs, jax_params, jax_tokens,
                                 port_engine, prompts)

_ATOL = 2e-5


def _int8(jcfg, tcfg):
    return (dataclasses.replace(jcfg, weight_quant='int8'),
            dataclasses.replace(tcfg, weight_quant='int8'))


@pytest.mark.parametrize('family', ['llama3', 'qwen2', 'gemma', 'phi',
                                    'gpt2'])
def test_quantize_state_equals_reference_bit_for_bit(family):
    jcfg, tcfg = configs(family)
    params = jax_params(jcfg)
    jq, tq = _int8(jcfg, tcfg)
    want = params_from_jax(jax.device_get(quantize_params(params, jq)), tq)
    got = quantize.quantize_state(params_from_jax(params, tcfg), tq)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
    assert got['layers.0.attn.qkv_proj'].dtype == torch.int8
    assert got['layers.0.attn.qkv_proj_scale'].dtype == torch.float32
    assert got['embed'].dtype == torch.float32          # embeddings float
    assert ('lm_head' in got) != tcfg.tie_embeddings    # tied stays float
    back = params_to_jax(got, tq)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(quantize_params(params, jq))):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize('family', ['llama3', 'qwen2', 'falcon', 'gpt2'])
def test_int8_logits_match_reference(family):
    jcfg, tcfg = configs(family)
    jq, tq = _int8(jcfg, tcfg)
    qparams = quantize_params(jax_params(jcfg), jq)
    tokens = np.random.RandomState(5).randint(0, 240, (2, 16))
    ref = np.asarray(JaxTransformer(jq).apply(
        {'params': qparams}, jnp.asarray(tokens, jnp.int32)))
    model = Transformer(tq, device='cpu')
    model.load_state_dict(params_from_jax(jax.device_get(qparams), tq),
                          assign=True)
    assert model.layers[0].mlp.down_proj.dtype == torch.int8
    with torch.no_grad():
        ours = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, ref, atol=_ATOL, rtol=_ATOL)


@pytest.mark.parametrize('family', ['llama3', 'falcon'])
def test_quantized_engine_tokens_equal_reference_engine(family):
    jcfg, tcfg = configs(family)
    params = jax_params(jcfg)
    batch = prompts(2)
    want = jax_tokens(jcfg, params, batch, quantize='int8')
    engine = port_engine(tcfg, params_from_jax(params, tcfg),
                         quantize='int8')
    try:
        got = _generate(engine, batch)
    finally:
        assert engine.drain(timeout=60)
    assert engine.cfg.weight_quant == 'int8'
    assert engine.model.layers[1].attn.qkv_proj.dtype == torch.int8
    assert got == want
    # Random weights quantize too (float draws placed, then quantized).
    engine = port_engine(tcfg, None, quantize='int8')
    try:
        assert len(engine.generate(batch[0], max_new_tokens=4)[0]) == 4
    finally:
        engine.stop()


def test_int8_refusals():
    moe = dataclasses.replace(get_config('mixtral-8x7b'), num_layers=1)
    with pytest.raises(NotImplementedError, match='MoE'):
        quantize.quantize_state({}, moe)
    _, tcfg = configs('llama3')
    with pytest.raises(NotImplementedError, match='int8 WEIGHTS'):
        ContinuousBatchingEngine(tcfg, num_slots=2, paged_block_size=8,
                                 device='cpu', quantize='int8',
                                 max_adapters=2, adapter_rank=4)
    with pytest.raises(NotImplementedError, match='int8 WEIGHTS'):
        Transformer(dataclasses.replace(
            tcfg, weight_quant='int8', serve_adapters=2, lora_rank=4,
            decode=True, paged_block_size=8), device='meta')
    with pytest.raises(ValueError, match='quantize mode'):
        ContinuousBatchingEngine(tcfg, paged_block_size=8, device='cpu',
                                 quantize='int4')
    with pytest.raises(ValueError, match='float weights'):
        Transformer(dataclasses.replace(tcfg, weight_quant='int8'),
                    device='cpu').init_random_(0)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_int8_matmul_equals_reference_quant_dense(dtype):
    """`int8_matmul` on the CPU in each compute dtype against the
    reference's QuantDenseGeneral on the same int8 payload and scales:
    fp32 within _ATOL; bf16 within one bf16 step (2^-7 relative), the
    rounding of fp32 sums taken in another order."""
    from skypilot_tpu.models.transformer import QuantDenseGeneral
    from skypilot_tpu_torch.models.transformer import int8_matmul
    jcfg, _ = configs('llama3')
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    rng = np.random.RandomState(11)
    x = rng.randn(2, 5, 64).astype(np.float32)
    q, scale = quantize.quantize_weight(
        torch.from_numpy(0.05 * rng.randn(64, 96).astype(np.float32)))
    want = QuantDenseGeneral(jcfg, features=96,
                             kernel_axes=('embed', 'mlp')).apply(
        {'params': {'kernel_q': jnp.asarray(q.numpy()),
                    'kernel_scale': jnp.asarray(scale.numpy())}},
        jnp.asarray(x, getattr(jnp, dtype)))
    tdtype = getattr(torch, dtype)
    got = int8_matmul(torch.from_numpy(x).to(tdtype), q, scale, tdtype)
    assert got.dtype == tdtype and got.shape == (2, 5, 96)
    tol = _ATOL if dtype == 'float32' else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=_ATOL, rtol=tol)


def test_quantizing_engine_takes_the_callers_float_tensors():
    """With quantize='int8' the engine empties the `params` dict it was
    given (the server's loaded weights), so no float tensor outlives its
    quantization through the caller's reference."""
    jcfg, tcfg = configs('llama3')
    state = params_from_jax(jax_params(jcfg), tcfg)
    engine = port_engine(tcfg, state, quantize='int8')
    try:
        assert state == {}
        assert engine.model.layers[0].mlp.gate_up_proj.dtype == torch.int8
    finally:
        engine.stop()
