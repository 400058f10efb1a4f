"""The port's paged engine and trainer on a Mixture-of-Experts model,
against the JAX package, at test-tiny-moe size (the block and model
pins are in tests/test_torch_moe.py).

Pinned: the paged engine's greedy tokens against the JAX
ContinuousBatchingEngine's with drops in decode (4 slots: a decode
step's 8 choices share 2 slots an expert, and a forward hook counts the
drops the capacity rule makes), at async depth 0 and 1 with
decode_chunk 2, under int8 KV, and with tenant q,v adapters; three train
steps (full, and LoRA with an MLP target the MoE layers do not have)
against the JAX train step, within tests/test_torch_train.py's
tolerances; and the port's own contracts (sync = async, prefix hit =
cold prefill, drafts = no drafts) under capacity factor E, where
nothing drops. Every engine's requests are queued before its thread
starts, so both engines tick the same schedule: under dispatch a row's
output depends on which rows share its step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as nn

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.inference import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.serve import tenancy as jax_tenancy
from skypilot_tpu_torch.models import moe
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from test_torch_moe import _FP32, _jax_model_params
from test_torch_train import _batches, _jax_run, _port_run

_ENGINE = dict(num_slots=4, paged_block_size=8, prefill_chunk=16)
_LENGTHS = (5, 12, 17, 30, 9, 23)
_MAX_NEW = 8


def _engine_cfgs(**kw):
    kw = dict(_FP32, max_seq_len=64, **kw)
    return (dataclasses.replace(jax_get_config('test-tiny-moe'), **kw),
            get_config('test-tiny-moe', **kw))


def _prompts(lengths=_LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 512, n).tolist() for n in lengths]


def _generate(engine, prompts, adapters=None):
    """Queue every request (its adapter from `adapters`) before the
    engine thread starts, so both engines run the same schedule of
    ticks, then wait for them all."""
    adapters = adapters or [None] * len(prompts)
    engine._ensure_thread = lambda: None   # pylint: disable=protected-access
    try:
        futures = [engine.submit(p, max_new_tokens=_MAX_NEW, adapter=a)
                   for p, a in zip(prompts, adapters)]
    finally:
        del engine._ensure_thread
    engine._ensure_thread()  # pylint: disable=protected-access
    return [f.result(timeout=120)[0] for f in futures]


def _jax_tokens(jcfg, params, prompts, **kw):
    engine = JaxEngine(jcfg, params=params, **dict(_ENGINE, **kw))
    try:
        return _generate(engine, prompts)
    finally:
        engine.stop()


def _port_engine(tcfg, params, **kw):
    return ContinuousBatchingEngine(tcfg, params=params, device='cpu',
                                    **dict(_ENGINE, **kw))


def _port_tokens(tcfg, params, prompts, **kw):
    engine = _port_engine(tcfg, params, **kw)
    try:
        return _generate(engine, prompts), engine
    finally:
        assert engine.drain(timeout=60)


class _Drops:
    """Counts, from each decode-step call of the model's MoE blocks
    (batch of num_slots rows of one token), the (token, choice)
    assignments the capacity rule drops: route and positions on the
    block's own input, outside the block."""

    def __init__(self, model, slots):
        self.decode = 0
        self.handles = [layer.moe.register_forward_hook(self._hook)
                        for layer in model.layers]
        self.slots = slots

    def _hook(self, block, args, out):
        del out
        (x,) = args
        if x.shape[:2] != (self.slots, 1):
            return
        cfg = block.cfg
        idx, _ = moe.route(x, block.router, cfg.experts_per_token)
        gs = moe.group_size(x.shape[0])
        cap = moe.capacity(gs, cfg.experts_per_token, cfg.num_experts,
                           cfg.moe_capacity_factor)
        pos = moe.positions(idx.reshape(-1, gs, cfg.experts_per_token),
                            cfg.num_experts)
        self.decode += int((pos >= cap).sum())


@pytest.fixture(scope='module')
def engine_params():
    jcfg, _ = _engine_cfgs()
    return _jax_model_params(jcfg)


@pytest.mark.parametrize('kw', [
    {}, dict(async_depth=1, decode_chunk=2), dict(kv_quant='int8')],
    ids=['sync', 'async1_chunk2', 'int8_kv'])
def test_engine_tokens_equal_reference_engine_with_drops(engine_params, kw):
    jcfg, tcfg = _engine_cfgs()
    prompts = _prompts()
    want = _jax_tokens(jcfg, engine_params, prompts, **kw)
    engine = _port_engine(tcfg, params_from_jax(engine_params, tcfg), **kw)
    drops = _Drops(engine.model, _ENGINE['num_slots'])
    try:
        got = _generate(engine, prompts)
    finally:
        assert engine.drain(timeout=60)
    assert got == want
    assert drops.decode > 0
    engine._pool.check()  # pylint: disable=protected-access
    assert engine._pool.used == 1  # pylint: disable=protected-access


def _generate_mixed(engine, trees, prompts, adapters):
    for name, tree in trees.items():
        engine.load_adapter(name, tree)
    return _generate(engine, prompts, adapters)


def test_tenant_adapters_equal_reference_engine(engine_params):
    """q,v adapters on a MoE model (its experts take none, as in the
    reference), base and two tenants batched with drops in decode."""
    jcfg, tcfg = _engine_cfgs()
    lora_cfg = dataclasses.replace(jcfg, lora_rank=4, lora_alpha=8.0,
                                   lora_targets='q,v', decode=True)
    shapes = nn.unbox(jax.eval_shape(lambda: JaxTransformer(lora_cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
        jnp.zeros((1, 8), jnp.int32))))
    leaves, treedef = jax.tree.flatten(
        jax_tenancy.adapter_tree_from_lora_params(shapes['params']))
    trees = {}
    for i, name in enumerate(('ad0', 'ad1')):
        keys = jax.random.split(jax.random.PRNGKey(70 + i), len(leaves))
        trees[name] = jax.tree.unflatten(treedef, [
            np.asarray(jax.random.normal(k, leaf.shape, jnp.float32)) * 0.2
            for k, leaf in zip(keys, leaves)])
    kw = dict(max_adapters=2, adapter_rank=4, adapter_alpha=8.0,
              adapter_targets='q,v')
    prompts = _prompts((14, 14, 14, 9), seed=6)
    prompts[1] = prompts[2] = prompts[0]
    adapters = [None, 'ad0', 'ad1', 'ad0']
    jengine = JaxEngine(jcfg, params=engine_params, **dict(_ENGINE, **kw))
    try:
        want = _generate_mixed(jengine, trees, prompts, adapters)
    finally:
        jengine.stop()
    engine = _port_engine(tcfg, params_from_jax(engine_params, tcfg), **kw)
    try:
        got = _generate_mixed(engine, trees, prompts, adapters)
    finally:
        assert engine.drain(timeout=60)
    assert got == want
    assert len({tuple(t) for t in got[:3]}) == 3      # adapters matter
    assert [name for _, name, _ in engine.model.lora_stacks()] == [
        'q_proj', 'v_proj'] * tcfg.num_layers


@pytest.mark.parametrize('contract', ['async', 'prefix_hit', 'drafts'])
def test_engine_contracts_without_drops(engine_params, contract):
    """Under capacity factor E nothing drops, so a row's tokens do not
    depend on the rows beside it: async = sync, a prefix hit = a cold
    prefill, verified drafts = plain decode."""
    _, tcfg = _engine_cfgs(moe_capacity_factor=4.0)
    params = params_from_jax(engine_params, tcfg)
    if contract == 'async':
        prompts = _prompts()
        want, _ = _port_tokens(tcfg, params, prompts)
        got, _ = _port_tokens(tcfg, params, prompts, async_depth=1,
                              decode_chunk=2)
    elif contract == 'drafts':
        prompts = _prompts((13, 16, 5, 12))
        want, _ = _port_tokens(tcfg, params, prompts)
        answers = {tuple(p): w for p, w in zip(prompts, want)}

        def draft(context, k):
            # The plain run's next k tokens, the last one wrong: every
            # verify accepts some drafts and rejects one.
            for prompt, reply in answers.items():
                if tuple(context[:len(prompt)]) == prompt:
                    done = len(context) - len(prompt)
                    return (reply[done:done + k - 1] + [0] * k)[:k]
            return None

        engine = _port_engine(tcfg, params, speculative=4)
        engine._draft_tokens = draft  # pylint: disable=protected-access
        try:
            got = _generate(engine, prompts)
        finally:
            assert engine.drain(timeout=60)
        assert engine.spec_stats['accepted'] > 0
    else:
        first = _prompts((17, 23), seed=7)

        def turns(cache):
            engine = _port_engine(tcfg, params, prefix_cache=cache)
            try:
                replies = _generate(engine, first)
                return _generate(engine, [p + r + [3, 1] for p, r in zip(
                    first, replies)]), engine.prefix_stats['hits']
            finally:
                assert engine.drain(timeout=60)

        (want, cold_hits), (got, hits) = turns(0), turns(4)
        assert (cold_hits, hits) == (0, 2)
    assert got == want


@pytest.mark.parametrize('lora', [None, 'q,v,down'], ids=['full', 'lora'])
def test_three_train_steps_match_jax_train_step(lora):
    """Full training, and LoRA with an MLP target the MoE layers do not
    have (no adapter there on either side): loss and grad_norm within
    rtol 2e-5, params within 2e-5 (tests/test_torch_train.py's)."""
    over = (dict(lora_rank=4, lora_alpha=8.0, lora_targets=lora) if lora
            else {})
    batches = _batches(3)
    params0, ref_metrics, ref_params = _jax_run(
        batches, model='test-tiny-moe', **over)
    metrics, params = _port_run(params0, batches, model='test-tiny-moe',
                                **over)
    np.testing.assert_allclose(metrics, ref_metrics, rtol=2e-5)

    def leaves(tree, path=''):
        if isinstance(tree, dict):
            for key, value in tree.items():
                yield from leaves(value, f'{path}/{key}')
        else:
            yield path, np.asarray(tree)

    got, ref = dict(leaves(params)), dict(leaves(ref_params))
    assert set(got) == set(ref)
    assert any('/moe/' in path for path in got)
    assert not any('lora' in path for path in got if '/attn/' not in path)
    for path, value in ref.items():
        np.testing.assert_allclose(got[path], value, atol=2e-5, rtol=0,
                                   err_msg=path)


def test_server_serves_moe_over_http(engine_params):
    """serve.server on a MoE config: /generate answers one request with
    the engine's tokens (the prompts of one call share its steps)."""
    import json
    import urllib.request

    from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                                 InferenceServer)
    _, tcfg = _engine_cfgs()
    server = InferenceServer(tcfg, params=params_from_jax(engine_params,
                                                          tcfg),
                             device='cpu', **_ENGINE)
    server.warmup()
    http = BackgroundServer(server)
    prompt = _prompts((11,), seed=8)[0]
    try:
        req = urllib.request.Request(
            http.url + '/generate', data=json.dumps(
                {'prompt_ids': [prompt],
                 'max_new_tokens': _MAX_NEW}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body['token_ids'] == [server.engine.generate(
            prompt, max_new_tokens=_MAX_NEW)[0]]
    finally:
        http.close()
        assert server.engine.drain(timeout=60)


def test_train_run_trains_moe_and_refuses_sp(tmp_path):
    """train.run on test-tiny-moe with a checkpoint and an HF export: the
    checkpoint served, exported by export_tool and the run's own export
    all hold the trained weights; --sp is refused at parse time."""
    import torch

    from skypilot_tpu_torch.models import convert, export_tool
    from skypilot_tpu_torch.models.inference import (
        load_params_from_checkpoint)
    from skypilot_tpu_torch.train import run
    history, result = [], {}
    ckpt, hf = str(tmp_path / 'ckpt'), str(tmp_path / 'hf')
    assert run.main(['--model', 'test-tiny-moe', '--batch', '2', '--seq',
                     '16', '--steps', '3', '--device', 'cpu',
                     '--warmup-steps', '1', '--log-every', '1',
                     '--checkpoint-dir', ckpt, '--export-hf', hf],
                    history=history, result=result) == 0
    assert len(history) == 3 and all(np.isfinite(h['loss'])
                                     for h in history)
    cfg = get_config('test-tiny-moe')
    trained = {k: v.to(torch.bfloat16)
               for k, v in result['state'].model.state_dict().items()}
    assert any('.moe.w_gate' in k for k in trained)
    assert export_tool.main(['--model', 'test-tiny-moe', '--checkpoint-dir',
                             ckpt, '--out', str(tmp_path / 'out'),
                             '--dtype', 'bfloat16']) == 0
    for state in (load_params_from_checkpoint(cfg, ckpt),
                  convert.load_hf_checkpoint(hf, cfg),
                  convert.load_hf_checkpoint(str(tmp_path / 'out'), cfg)):
        assert set(state) == set(trained)
        for key, value in trained.items():
            assert torch.equal(state[key], value), key
    with pytest.raises(SystemExit, match='--sp with a MoE model'):
        run.main(['--model', 'test-tiny-moe', '--seq', '16', '--sp', '2',
                  '--device', 'cpu'])
