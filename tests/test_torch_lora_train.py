"""LoRA training in the port against the JAX package's LoRADenseGeneral,
masked optimizer and merge_lora (skypilot_tpu/models/transformer.py,
train/trainer.py, models/lora.py).

test-tiny, fp32 params and compute, rank 4, alpha 8, targets `q,v` and
all seven. The JAX init (adapters A ~ N(0, 1/r), B = 0) is carried
across with params_from_jax, which now carries the lora_a / lora_b
leaves. Tolerances:
- forward logits: 2e-5 absolute and relative (fp32 sums in other orders;
  the fused projection's slices against the reference's separate ones);
- three train steps: test_torch_train's rtol 2e-5 on loss and grad_norm
  and atol 2e-5 on the adapter leaves; every base leaf bit-unchanged on
  both sides;
- merge_lora: 1e-6 absolute against the reference's merge (a rank-4 fp32
  product summed in another order), and the merged model's logits
  within the reference's own bound of the unmerged model's (atol 2e-4,
  rtol 1e-4, tests/test_lora.py: W + s·A·B rounded once against x·W and
  s·(x·A)·B rounded apart).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from skypilot_tpu.models import Transformer as JaxTransformer
from skypilot_tpu.models import lora as jlora
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch.models import lora
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax, params_to_jax
from skypilot_tpu_torch.models.transformer import (Transformer,
                                                   fused_projections,
                                                   projection_shapes)
from skypilot_tpu_torch.train import data
from test_torch_train import _B, _KW, _S, _TC, _batches, _jax_run, _port_run

ALL = 'q,k,v,o,gate,up,down'
_ATOL = 2e-5


def _lora(targets):
    return dict(lora_rank=4, lora_alpha=8.0, lora_targets=targets)


def _cfg(**over):
    return get_config('test-tiny', **{**_KW, 'attention_impl': 'pallas',
                                      **over})


def _jcfg(**over):
    """The JAX twin; attention through its plain XLA route (the train
    steps below take test_torch_train's Pallas-interpret config)."""
    return dataclasses.replace(jax_get_config('test-tiny'), **{
        **_KW, 'attention_impl': 'xla', **over})


def _is_adapter(path):
    return path.endswith(('/lora_a', '/lora_b'))


def _leaves(tree, path=''):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f'{path}/{key}')
    else:
        yield path, np.asarray(tree)


def _jax_params(targets, scan=True, seed=0):
    """A JAX LoRA init with every lora_b drawn nonzero (seeded)."""
    jcfg = _jcfg(scan_layers=scan, **_lora(targets))
    tokens = jnp.zeros((1, 8), jnp.int32)
    params = jax.device_get(nn.unbox(jax.jit(JaxTransformer(jcfg).init)(
        jax.random.PRNGKey(seed), tokens)['params']))
    rng = np.random.RandomState(seed + 1)

    def walk(node):
        return {k: (rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
                    if k == 'lora_b' else
                    walk(v) if isinstance(v, dict) else v)
                for k, v in node.items()}
    return jcfg, walk(params)


def _scanned(tree, num_layers):
    """An unscanned (layer_{i}) tree with its layers stacked the way the
    scanned layout holds them."""
    layers = [tree[f'layer_{i}'] for i in range(num_layers)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return np.stack(nodes)
    out = {k: v for k, v in tree.items() if not k.startswith('layer_')}
    out['layers'] = {'layer': stack(layers)}
    return out


def _tokens(seed=2):
    return np.random.RandomState(seed).randint(0, 512, (2, 24)).astype(
        np.int32)


def _port_logits(state, cfg, tokens):
    model = Transformer(cfg, device='cpu')
    model.load_state_dict(state)
    with torch.no_grad():
        return model(torch.from_numpy(tokens)).numpy()


@pytest.mark.parametrize('targets', ['q,v', ALL])
def test_lora_forward_at_init_is_the_base_bit_for_bit(targets):
    """B = 0: the adapted model's logits are the plain model's, bit for
    bit; the adapters are drawn after the base, so one seed gives both
    models the same base."""
    plain = Transformer(_cfg(), device='cpu').init_random_(3)
    adapted = Transformer(_cfg(**_lora(targets)),
                          device='cpu').init_random_(3)
    base = plain.state_dict()
    state = adapted.state_dict()
    assert set(state) - set(base) == lora.adapter_keys(adapted.cfg)
    for key, value in base.items():
        assert torch.equal(state[key], value), key
    assert not any(p.requires_grad for n, p in adapted.named_parameters()
                   if not lora.is_adapter_key(n))
    tokens = torch.from_numpy(_tokens())
    with torch.no_grad():
        assert torch.equal(adapted(tokens), plain(tokens))


@pytest.mark.parametrize('scan', [True, False], ids=['scanned', 'unscanned'])
@pytest.mark.parametrize('targets', ['q,v', ALL])
def test_lora_forward_matches_lora_dense_general(targets, scan):
    jcfg, params = _jax_params(targets, scan=scan)
    tokens = _tokens()
    want = np.asarray(jax.jit(JaxTransformer(jcfg).apply)(
        {'params': params}, jnp.asarray(tokens)))
    cfg = _cfg(**_lora(targets))
    state = params_from_jax(params, cfg, dtype='float32')
    np.testing.assert_allclose(_port_logits(state, cfg, tokens), want,
                               atol=_ATOL, rtol=_ATOL)
    # And back, to the reference's scanned tree, bit for bit.
    back = dict(_leaves(params_to_jax(state, cfg)))
    ref = dict(_leaves(params if scan else
                       _scanned(params, jcfg.num_layers)))
    assert set(back) == set(ref)
    for path, value in ref.items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)


def test_adapters_under_a_plain_config_are_refused():
    _, params = _jax_params('q,v')
    with pytest.raises(ValueError, match='lora_a/lora_b'):
        params_from_jax(params, _cfg())


def _sft_batches(tmp_path, n):
    """`n` batches of SftJsonlDataset over seeded examples: prompts of
    3-20 tokens, completions of 4-30 (some rows truncated at S + 1)."""
    rng = np.random.RandomState(7)
    path = tmp_path / 'sft.jsonl'
    with open(path, 'w', encoding='utf-8') as f:
        for _ in range(10):
            f.write(json.dumps({
                'prompt': rng.randint(1, 512, rng.randint(3, 21)).tolist(),
                'completion': rng.randint(1, 512,
                                          rng.randint(4, 31)).tolist()})
                    + '\n')
    dataset = data.SftJsonlDataset(str(path), _B, _S, seed=3)
    return [dataset.next_batch() for _ in range(n)]


@pytest.mark.parametrize('targets,grad_accum,sft', [
    ('q,v', 1, False), ('q,v', 2, True), (ALL, 2, False), (ALL, 1, True)],
    ids=['qv', 'qv-sft-grad_accum2', 'all-grad_accum2', 'all-sft'])
def test_three_lora_steps_match_jax_lora_step(tmp_path, targets, grad_accum,
                                              sft):
    batches = _sft_batches(tmp_path, 3) if sft else _batches(3)
    over = _lora(targets)
    params0, ref_metrics, ref_params = _jax_run(batches, grad_accum, **over)
    metrics, params = _port_run(params0, batches, grad_accum, **over)
    for i, ((loss, norm), (ref_loss, ref_norm)) in enumerate(
            zip(metrics, ref_metrics)):
        np.testing.assert_allclose(loss, ref_loss, rtol=2e-5,
                                   err_msg=f'loss, step {i}')
        np.testing.assert_allclose(norm, ref_norm, rtol=2e-5,
                                   err_msg=f'grad_norm, step {i}')
    assert max(norm for _, norm in metrics) > _TC['grad_clip_norm']
    got, ref, init = (dict(_leaves(t))
                      for t in (params, ref_params, params0))
    assert set(got) == set(ref) == set(init)
    for path, value in ref.items():
        if _is_adapter(path):
            np.testing.assert_allclose(got[path], value, atol=2e-5, rtol=0,
                                       err_msg=path)
        else:                     # frozen: bit-unchanged on both sides
            np.testing.assert_array_equal(value, init[path], err_msg=path)
            np.testing.assert_array_equal(got[path], init[path],
                                          err_msg=path)
    moved = max(np.abs(got[p] - init[p]).max() for p in got
                if p.endswith('/lora_b'))
    assert moved > 1e-4


def test_optimizer_holds_adapter_moments_only():
    cfg = get_config('test-tiny', param_dtype='bfloat16', **_lora('q,v'))
    from skypilot_tpu_torch.train import metrics, trainer
    state = trainer.create_train_state(cfg, device='cpu')
    assert {id(p) for p in state.params} == {
        id(p) for n, p in state.model.named_parameters()
        if lora.is_adapter_key(n)}
    batch = trainer.synthetic_batch(torch.Generator().manual_seed(0), 2, 16,
                                    cfg.vocab_size)
    trainer.make_train_step()(state, batch)
    adapters = sum(p.numel() for p in state.params)
    # q,v at rank 4: 2 layers x (64 x 4 + 4 x 64 + 64 x 4 + 4 x 32).
    assert adapters == 2 * (64 * 4 + 4 * 64 + 64 * 4 + 4 * 32)
    total, per_device = metrics.opt_state_bytes(state)
    # Two bf16 moments per adapter element, one fp32 step per tensor.
    assert total == per_device == 2 * 2 * adapters + 4 * len(state.params)


@pytest.mark.parametrize('targets', ['q,v', ALL])
def test_merge_lora_matches_reference_and_unmerged_logits(targets):
    jcfg, params = _jax_params(targets)
    cfg = _cfg(**_lora(targets))
    state = params_from_jax(params, cfg, dtype='float32')
    merged = lora.merge_lora(state, cfg)
    assert not lora.has_lora(merged) and lora.has_lora(state)
    want = params_from_jax(jlora.merge_lora(params, jcfg), _cfg(),
                           dtype='float32')
    assert set(merged) == set(want)
    for key, value in want.items():
        torch.testing.assert_close(merged[key], value, atol=1e-6, rtol=0,
                                   msg=key)
    tokens = _tokens(5)
    np.testing.assert_allclose(_port_logits(merged, _cfg(), tokens),
                               _port_logits(state, cfg, tokens),
                               atol=2e-4, rtol=1e-4)
    with pytest.raises(ValueError, match='lora_rank == 0'):
        lora.merge_lora(state, _cfg())


@pytest.mark.parametrize('mlp_style', ['glu', 'plain'])
def test_adapter_sites_tile_the_fused_projections(mlp_style):
    """Each fused projection's columns are its projections' adapter
    sites, in order and without a gap; merging at those sites gives the
    unmerged model's logits (tolerance as above), under either MLP."""
    cfg = _cfg(mlp_style=mlp_style, **_lora(ALL))
    state = Transformer(cfg, device='cpu').init_random_(0).state_dict()
    shapes = projection_shapes(cfg)
    for key, names in fused_projections(cfg).items():
        cols = 0
        for name in names:
            assert lora.adapter_site(cfg, name) == (key, cols,
                                                    shapes[name][1])
            cols += shapes[name][1]
        assert state[f'layers.0.{key}'].shape[1] == cols
    gen = torch.Generator().manual_seed(1)
    for key in lora.adapter_keys(cfg):
        if key.endswith('_lora_b'):
            state[key] = 0.1 * torch.randn(state[key].shape, generator=gen)
    tokens = _tokens(5)
    np.testing.assert_allclose(
        _port_logits(lora.merge_lora(state, cfg), _cfg(mlp_style=mlp_style),
                     tokens),
        _port_logits(state, cfg, tokens), atol=2e-4, rtol=1e-4)
