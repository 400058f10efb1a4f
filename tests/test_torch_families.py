"""The reference's dense decoder families in the port, against the JAX
package.

Each family's knobs are copied from its registered preset onto a
test-tiny shape (d_model 64, 4 heads of 16, 2 layers, vocab 250 padded
from 240 where the preset pads, fp32): Llama-3, Mistral (a window of 8
keys, shorter than the prompts), Qwen2 (qkv bias), Gemma ((1+w) norm,
GeGLU, sqrt(d) embedding scale, tied unembedding, MQA, a head_dim
override), Gemma-2 (softcaps, served through decode_kernel='xla'),
Falcon (parallel block, MQA, LayerNorm, plain GELU MLP, tied), Phi
(biased parallel block, partial rotary, biased lm_head) and GPT-2
(LayerNorm, learned positions, biases everywhere, tied). Every float
leaf of a seeded JAX init is perturbed, so biases and norm deltas are
not zero. Pinned: the full-sequence logits within 2e-5 of the JAX
Transformer's; the port's tree carried back to the reference's bit for
bit; the paged engine's greedy tokens equal to the JAX engine's; one
int8-KV family and one multi-LoRA engine on a plain-MLP family
(per-adapter tokens equal to the JAX multi-LoRA engine's); the train
steps' losses of a gpt2-style and a gemma-style model equal to the JAX
trainer's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from skypilot_tpu.models.configs import ModelConfig as JaxModelConfig
from skypilot_tpu.models.inference import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu_torch.models.configs import ModelConfig, get_config
from skypilot_tpu_torch.models.convert import params_from_jax, params_to_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.models.transformer import Transformer

_ATOL = 2e-5          # tests/test_torch_model.py's
FAMILIES = {'llama3': 'llama3-8b', 'mistral': 'mistral-7b',
            'qwen2': 'qwen2-7b', 'gemma': 'gemma-2b', 'gemma2': 'gemma2-9b',
            'falcon': 'falcon-7b', 'phi': 'phi-2', 'gpt2': 'gpt2-124m'}
_KNOBS = ('mlp_activation', 'mlp_style', 'norm_style', 'pos_embedding',
          'norm_bias', 'rotary_pct', 'lm_head_bias', 'qkv_clip', 'qkv_bias',
          'o_bias', 'mlp_bias', 'tie_embeddings', 'scale_embed_by_dim',
          'attn_logit_softcap', 'final_logit_softcap', 'parallel_block',
          'rope_theta', 'norm_eps', 'attention_impl')
LENGTHS = (5, 12, 17, 30)
MAX_NEW = 8


def family_kwargs(family: str, **overrides) -> dict:
    """The preset's family knobs on the test-tiny shape."""
    preset = get_config(FAMILIES[family])
    kw = {k: getattr(preset, k) for k in _KNOBS}
    heads = 4
    kv = 1 if preset.num_kv_heads == 1 else (
        heads if preset.num_kv_heads == preset.num_heads else 2)
    kw.update(name=f'tiny-{family}', vocab_size=250, d_model=64,
              num_layers=2, num_heads=heads, num_kv_heads=kv, d_mlp=96,
              max_seq_len=64, dtype='float32', param_dtype='float32',
              remat=False,
              head_dim_override=16 if preset.head_dim_override else None,
              sliding_window=8 if preset.sliding_window else 0,
              unpadded_vocab_size=240 if preset.unpadded_vocab_size else 0)
    kw.update(overrides)
    return kw


def configs(family: str, **overrides):
    kw = family_kwargs(family, **overrides)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def jax_params(jcfg, seed: int = 0):
    """A seeded JAX init with every float leaf perturbed (biases, norm
    deltas and position tables away from their zero / one init)."""
    params = jax.device_get(nn.unbox(jax.jit(JaxTransformer(jcfg).init)(
        jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32)))['params'])
    rng = np.random.RandomState(seed + 1)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*np.shape(x)).astype(
            np.float32), params)


def prompts(seed: int = 0, lengths=LENGTHS):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 240, n).tolist() for n in lengths]


def decode_kernel(tcfg) -> str:
    """The route the card would take: the kernel, except for a softcap."""
    return 'xla' if tcfg.attn_logit_softcap else 'pallas'


@pytest.mark.parametrize('family', list(FAMILIES))
def test_full_sequence_logits_match_reference(family):
    jcfg, tcfg = configs(family)
    params = jax_params(jcfg)
    tokens = np.random.RandomState(3).randint(0, 250, (2, 20))
    ref = np.asarray(JaxTransformer(jcfg).apply(
        {'params': params}, jnp.asarray(tokens, jnp.int32)))
    model = Transformer(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(params, tcfg), assign=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(ours, ref, atol=_ATOL, rtol=_ATOL)
    if tcfg.unpadded_vocab_size:
        assert (ours[..., 240:] == -1e30).all()


@pytest.mark.parametrize('family', list(FAMILIES))
def test_tree_carries_back_bit_for_bit(family):
    jcfg, tcfg = configs(family)
    params = jax_params(jcfg, seed=4)
    back = params_to_jax(params_from_jax(params, tcfg), tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for want, got in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(got, want)


def _generate(engine, batch):
    futures = [engine.submit(p, max_new_tokens=MAX_NEW) for p in batch]
    return [f.result(timeout=120)[0] for f in futures]


def jax_tokens(jcfg, params, batch, **kw):
    engine = JaxEngine(jcfg, params=params, num_slots=3, paged_block_size=8,
                       prefill_chunk=16, **kw)
    try:
        return _generate(engine, batch)
    finally:
        engine.stop()


def port_engine(tcfg, params, **kw):
    kw.setdefault('decode_kernel', decode_kernel(tcfg))
    return ContinuousBatchingEngine(
        tcfg, params=params, num_slots=3, paged_block_size=8,
        prefill_chunk=16, device='cpu', **kw)


@pytest.mark.parametrize('family', list(FAMILIES))
def test_engine_tokens_equal_reference_engine(family):
    jcfg, tcfg = configs(family)
    params = jax_params(jcfg)
    batch = prompts()
    want = jax_tokens(jcfg, params, batch)
    engine = port_engine(tcfg, params_from_jax(params, tcfg))
    try:
        got = _generate(engine, batch)
    finally:
        assert engine.drain(timeout=60)
    assert got == want
    engine._pool.check()  # pylint: disable=protected-access
    assert engine._pool.used == 1  # pylint: disable=protected-access


def test_int8_kv_family_equals_reference_engine():
    jcfg, tcfg = configs('qwen2')
    params = jax_params(jcfg)
    batch = prompts(1)
    want = jax_tokens(jcfg, params, batch, kv_quant='int8')
    engine = port_engine(tcfg, params_from_jax(params, tcfg),
                         kv_quant='int8')
    try:
        assert _generate(engine, batch) == want
    finally:
        assert engine.drain(timeout=60)


def _adapter_trees(jcfg, targets, names, seed0):
    """Random adapter trees in the reference's models/lora layout for a
    multi-LoRA model of `jcfg`."""
    from skypilot_tpu.serve import tenancy as jax_tenancy
    lora_cfg = dataclasses.replace(jcfg, lora_rank=4, lora_alpha=8.0,
                                   lora_targets=targets, decode=True)
    shapes = nn.unbox(jax.eval_shape(lambda: JaxTransformer(lora_cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
        jnp.zeros((1, 8), jnp.int32))))
    template = jax_tenancy.adapter_tree_from_lora_params(shapes['params'])
    leaves, treedef = jax.tree.flatten(template)

    def rand(seed):
        rng = np.random.RandomState(seed)
        return jax.tree.unflatten(treedef, [
            rng.randn(*leaf.shape).astype(np.float32) * 0.1
            for leaf in leaves])

    return {name: rand(seed0 + i) for i, name in enumerate(names)}


def test_multi_lora_on_plain_mlp_family_equals_reference_engine():
    """GPT-2's plain MLP: the gate,up LoRA group holds up alone (gate has
    no module), and the biases land after each delta as in the
    reference."""
    targets = 'q,k,v,o,gate,up,down'
    jcfg, tcfg = configs('gpt2')
    params = jax_params(jcfg)
    trees = _adapter_trees(jcfg, targets, ['a', 'b'], 50)
    lora_kw = dict(max_adapters=2, adapter_rank=4, adapter_alpha=8.0,
                   adapter_targets=targets)
    prompt = prompts(2, (11,))[0]

    def mixed(engine):
        for name, tree in trees.items():
            engine.load_adapter(name, tree)
        futures = [engine.submit(prompt, max_new_tokens=MAX_NEW)]
        futures += [engine.submit(prompt, max_new_tokens=MAX_NEW,
                                  adapter=name) for name in trees]
        return [f.result(timeout=120)[0] for f in futures]

    jengine = JaxEngine(jcfg, params=params, num_slots=3, paged_block_size=8,
                        **lora_kw)
    try:
        want = mixed(jengine)
    finally:
        jengine.stop()
    engine = ContinuousBatchingEngine(tcfg, params=params_from_jax(
        params, tcfg), num_slots=3, paged_block_size=8, device='cpu',
        **lora_kw)
    try:
        got = mixed(engine)
    finally:
        assert engine.drain(timeout=60)
    mlp = engine.model.layers[0].mlp
    assert list(mlp.lora) == ['up_proj', 'down_proj']
    assert mlp.lora_gate_up.width == tcfg.d_mlp
    assert got == want
    assert len({tuple(t) for t in got}) == 3      # adapters matter


_TC = dict(learning_rate=1e-2, warmup_steps=1, total_steps=4)


def _jax_train_losses(jcfg, params, batch):
    """Three steps of the reference trainer's optimizer (make_optimizer:
    global-norm clip, AdamW, warmup-cosine) and loss (cross_entropy_loss)
    on one device. Its sharded-state constructor cannot place GPT-2's
    position table under this JAX (a None logical axis), so the state is
    a plain flax TrainState over the same optimizer."""
    from skypilot_tpu.train import trainer as jax_trainer
    model = JaxTransformer(jcfg)
    state = jax_trainer.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.asarray, params),
        tx=jax_trainer.make_optimizer(jax_trainer.TrainConfig(**_TC)))

    @jax.jit
    def step(state, batch):
        def loss_fn(p):
            logits = model.apply({'params': p}, batch['inputs'])
            return jax_trainer.cross_entropy_loss(logits, batch['targets'],
                                                  batch['mask'])
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    losses = []
    for _ in range(3):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize('family', ['gpt2', 'gemma'])
def test_train_step_loss_equals_reference_trainer(family):
    """The knobs sit in the decoder the trainer shares: three steps of
    the port's trainer from the same weights and batch give the JAX
    trainer's losses (the first update has lr 0, the second lr > 0)."""
    from skypilot_tpu_torch.train import trainer
    jcfg, tcfg = configs(family, attention_impl='xla')
    params = jax_params(jcfg, seed=7)
    tokens = np.random.RandomState(8).randint(0, 240, (2, 17)).astype(
        np.int32)
    batch = {'inputs': tokens[:, :-1], 'targets': tokens[:, 1:],
             'mask': np.ones((2, 16), np.int32)}
    want = _jax_train_losses(jcfg, params, batch)
    model = Transformer(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(params, tcfg, dtype='float32'))
    state = trainer.TrainState(model, trainer.TrainConfig(**_TC))
    step = trainer.make_train_step()
    got = [float(step(state, {k: torch.from_numpy(v)
                              for k, v in batch.items()})['loss'])
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert got[2] < got[0]
