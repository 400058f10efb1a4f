"""The port's train step against the JAX package's train step.

test-tiny at fp32 params and compute on both sides, attention through the
flash path (JAX: Pallas kernels in interpret mode; port: the plain pair
its wrappers run on the CPU). The JAX state comes from
`create_sharded_state` on a one-device mesh and is carried across with
params_from_jax; both then take the same numpy batches. The schedule has
a one-step warmup, so the first update has lr 0 and the next ones lr > 0,
and grad_clip_norm is small enough that clipping is active every step.

Tolerances: loss and grad_norm within 2e-5 relative (fp32 sums in other
orders, and torch's AdamW rounds its update differently from optax;
measured <= 1.5e-7); params
after three updates within 2e-5 absolute (AdamW's normalised update
m / sqrt(v) turns the gradients' low-bit noise into noise of up to a few
thousandths of an lr-1e-3 step; measured <= 2.5e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.parallel import MeshConfig, build_mesh
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax, params_to_jax
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.train import trainer

_KW = dict(dtype='float32', param_dtype='float32', remat=False,
           attention_impl='pallas_interpret')
_TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
           grad_clip_norm=0.05)
_B, _S = 4, 32


def _batches(n, masked=False, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        tokens = rng.randint(0, 512, (_B, _S + 1)).astype(np.int32)
        mask = np.ones((_B, _S), np.int32)
        if masked:
            mask[:, :rng.randint(5, 20)] = 0
            mask[1] = 0
        out.append({'inputs': tokens[:, :-1], 'targets': tokens[:, 1:],
                    'mask': mask})
    return out


def _jax_run(batches, grad_accum=1):
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    state, shardings = jtrainer.create_sharded_state(
        jcfg, mesh, jax.random.PRNGKey(0), jtrainer.TrainConfig(**_TC))
    params0 = jax.device_get(state.params)
    step = jtrainer.make_train_step(jcfg, mesh, shardings,
                                    grad_accum=grad_accum)
    metrics = []
    with mesh:
        for batch in batches:
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            metrics.append((float(m['loss']), float(m['grad_norm'])))
    return params0, metrics, jax.device_get(state.params)


def _port_state(params0, cfg):
    model = Transformer(cfg, device='cpu')
    model.load_state_dict(params_from_jax(params0, cfg, dtype='float32'))
    return trainer.TrainState(model, trainer.TrainConfig(**_TC))


def _port_run(params0, batches, grad_accum=1):
    cfg = get_config('test-tiny', **_KW)
    state = _port_state(params0, cfg)
    step = trainer.make_train_step(grad_accum=grad_accum)
    metrics = []
    for batch in batches:
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append((float(m['loss']), float(m['grad_norm'])))
    return metrics, params_to_jax(state.model.state_dict(), cfg)


def _assert_tree_close(got, ref, path=''):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for key in ref:
            _assert_tree_close(got[key], ref[key], f'{path}/{key}')
        return
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=0,
                               err_msg=path)


@pytest.mark.parametrize('grad_accum,masked', [(1, False), (2, False),
                                               (1, True)],
                         ids=['plain', 'grad_accum2', 'masked'])
def test_three_steps_match_jax_train_step(grad_accum, masked):
    batches = _batches(3, masked=masked)
    params0, ref_metrics, ref_params = _jax_run(batches, grad_accum)
    metrics, params = _port_run(params0, batches, grad_accum)
    for i, ((loss, norm), (ref_loss, ref_norm)) in enumerate(
            zip(metrics, ref_metrics)):
        assert norm > _TC['grad_clip_norm']              # clipping active
        np.testing.assert_allclose(loss, ref_loss, rtol=2e-5,
                                   err_msg=f'loss, step {i}')
        np.testing.assert_allclose(norm, ref_norm, rtol=2e-5,
                                   err_msg=f'grad_norm, step {i}')
    _assert_tree_close(params, ref_params)
    # lr 0 on the first update, > 0 after: the params did move.
    moved = np.abs(params['lm_head']['kernel'] -
                   np.asarray(params0['lm_head']['kernel'])).max()
    assert moved > 1e-4


def test_learning_rate_schedule_matches_optax():
    import optax
    tc = trainer.TrainConfig(learning_rate=3e-4, warmup_steps=10,
                             total_steps=50)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=10, decay_steps=50,
        end_value=3e-5)
    for count in (0, 1, 5, 10, 11, 30, 50, 80):
        np.testing.assert_allclose(trainer.learning_rate_at(tc, count),
                                   float(ref(count)), rtol=1e-6)


def _grads(cfg, params0, batch):
    state = _port_state(params0, cfg)
    loss = trainer.cross_entropy_loss(
        state.model(batch['inputs']), batch['targets'], batch['mask'])
    return torch.autograd.grad(loss, state.params)


def test_remat_policies_give_identical_grads():
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    params0 = jax.device_get(jtrainer.create_sharded_state(
        jcfg, build_mesh(MeshConfig(dp=1), jax.devices()[:1]),
        jax.random.PRNGKey(1))[0].params)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    grads = {}
    for name, over in (('off', dict(remat=False)),
                       ('full', dict(remat=True, remat_policy='full')),
                       ('dots', dict(remat=True, remat_policy='dots'))):
        cfg = get_config('test-tiny', **{**_KW, 'attention_impl': 'pallas',
                                         **over})
        grads[name] = _grads(cfg, params0, batch)
    for name in ('full', 'dots'):
        for a, b in zip(grads['off'], grads[name]):
            assert torch.equal(a, b), name


@pytest.mark.parametrize('remat,forward_calls', [(False, 1), (True, 2)])
def test_flash_calls_per_layer_follow_remat(monkeypatch, remat,
                                            forward_calls):
    """Per step and layer: one forward (two under remat: the backward
    recomputes the layer), one dQ and one dK/dV — the launch counts the
    card run checks (chip_smoke.py)."""
    counts = {'fwd': 0, 'dq': 0, 'dkv': 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(fa, 'flash_forward_plain',
                        counting('fwd', fa.flash_forward_plain))
    monkeypatch.setattr(fa, 'flash_dq_plain', counting('dq',
                                                       fa.flash_dq_plain))
    monkeypatch.setattr(fa, 'flash_dkv_plain', counting('dkv',
                                                        fa.flash_dkv_plain))
    cfg = get_config('test-tiny', **{**_KW, 'attention_impl': 'auto',
                                     'remat': remat})
    state = trainer.create_train_state(cfg, trainer.TrainConfig(),
                                       device='cpu')
    batch = trainer.synthetic_batch(torch.Generator().manual_seed(0), 2, 16,
                                    cfg.vocab_size)
    trainer.make_train_step()(state, batch)
    layers = cfg.num_layers
    assert counts == {'fwd': forward_calls * layers, 'dq': layers,
                      'dkv': layers}


def test_training_params_live_in_param_dtype_with_grad():
    cfg = get_config('test-tiny', param_dtype='float32', dtype='bfloat16')
    model = Transformer(cfg, device='meta')
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    serving = Transformer(dataclasses.replace(
        cfg, decode=True, paged_block_size=16), device='meta')
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in serving.parameters())


def test_init_random_draws_the_reference_distributions():
    """Projections: lecun_normal truncated at +-2 sigma, sigma =
    sqrt(1/fan_in)/0.8796, so the draws have std sqrt(1/fan_in);
    untied embedding N(0, 1); norm scales 1. Checked on the statistics
    (within 2%: ~10^5 draws per matrix) and against the JAX init's."""
    cfg = get_config('test-tiny', param_dtype='float32', d_model=256,
                     d_mlp=512, vocab_size=1024)
    model = Transformer(cfg, device='cpu').init_random_(0)
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), d_model=256,
                               d_mlp=512, vocab_size=1024,
                               param_dtype='float32')
    ref = params_from_jax(jax.device_get(jtrainer.create_sharded_state(
        jcfg, build_mesh(MeshConfig(dp=1), jax.devices()[:1]),
        jax.random.PRNGKey(0))[0].params), get_config(
            'test-tiny', param_dtype='float32', d_model=256, d_mlp=512,
            vocab_size=1024), dtype='float32')
    for name, param in model.named_parameters():
        x = param.detach()
        if name.endswith('norm.weight'):
            assert torch.all(x == 1.0), name
            continue
        std = 1.0 if name == 'embed' else x.shape[0] ** -0.5
        assert abs(float(x.std()) / std - 1) < 0.02, name
        assert abs(float(ref[name].std()) / float(x.std()) - 1) < 0.03, name
        if name != 'embed':
            bound = 2 * std / 0.87962566103423978
            assert float(x.abs().max()) <= bound * (1 + 1e-6), name
            assert float(x.abs().max()) > 0.95 * bound, name
