"""The port's prompt-lookup speculative decoding on the CPU:
`ContinuousBatchingEngine(speculative=K)` of
skypilot_tpu_torch/models/inference.py (`_draft_tokens`, `_spec_tick`,
`_trim_blocks`, the verify step over models/step_graph.VerifyBuffers,
eager on the CPU as every step is).

Held against the JAX package on the same seeded test-tiny fp32 weights
(params_from_jax), paged blocks of 8 and prefill chunks of 16:
  - `_draft_tokens` equals the reference's over a seeded sweep of
    contexts, and the reference's own lookup cases;
  - greedy tokens with drafts equal those without and the JAX engine's
    with drafts: paged, under int8 KV, with two adapters and with the
    prefix cache on (tests/test_inference.py
    `test_greedy_exactly_matches_plain_decode`,
    tests/test_composition_matrix.py's spec cells);
  - oracle drafts: 16 tokens in ceil(16 / (K+1)) verify ticks, each a
    decode step (tests/test_inference.py `test_accepted_drafts_save_dispatches`);
  - async depth 1 and 2 flush around verify ticks and keep the tokens
    (tests/test_async_pipeline.py `test_speculative_flushes_and_matches`);
  - garbage drafts: the rejected blocks go back and the pool balances; a
    pool exhausted mid-reservation rolls the reservation back
    (tests/test_composition_matrix.py TestSpecPagedRollback);
  - sampling rows accept 0 drafts; a sampling slot beside a greedy one,
    the window edge and EOS mid-accept finish as in the reference.
"""
import dataclasses
import threading

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
from skypilot_tpu_torch.models import kv_cache as kv_cache_lib
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.serve.server import BackgroundServer, InferenceServer

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
LORA_KW = dict(adapter_rank=4, adapter_alpha=8.0, adapter_targets='q,v')
PAGED = dict(paged_block_size=8, prefill_chunk=16)
K = 4
# Prompts fit one prefill chunk: the reference's verify tick reads the
# last token of every occupied slot, which a mid-prefill slot lacks
# (skypilot_tpu/models/inference.py `_spec_tick`); the port's treats such
# a slot as an inert row.
PROMPTS = ([1, 2, 3, 4] * 3, [5, 7, 11], [9, 9, 8, 8, 7, 7, 6, 6],
           [20, 21, 22, 23, 24, 25] * 2 + [20, 21])
CELLS = {
    'paged': {},
    'int8': dict(kv_quant='int8'),
    'adapters': dict(max_adapters=2, **LORA_KW),
    'prefix': dict(prefix_cache=4),
}


def _jcfg():
    return dataclasses.replace(jax_get_config('test-tiny'), **_KW)


def _tcfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


def _random_trees(targets, names, seed0):
    """Random adapter trees in the reference's models/lora layout, as
    tests/test_torch_multitenant.py draws them."""
    lora_cfg = dataclasses.replace(_jcfg(), lora_rank=4, lora_alpha=8.0,
                                   lora_targets=targets, decode=True)
    shapes = nn.unbox(jax.eval_shape(lambda: JaxTransformer(lora_cfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32),
        jnp.zeros((1, 8), jnp.int32))))
    template = jax_tenancy.adapter_tree_from_lora_params(shapes['params'])
    leaves, treedef = jax.tree.flatten(template)

    def rand(seed):
        keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
        return jax.tree.unflatten(treedef, [
            np.asarray(jax.random.normal(k, leaf.shape, jnp.float32)) * 0.05
            for k, leaf in zip(keys, leaves)])

    return {name: rand(seed0 + i) for i, name in enumerate(names)}


@pytest.fixture(scope='module')
def base_params():
    engine = JaxEngine(_jcfg(), num_slots=2)
    params = jax.device_get(engine.params)
    engine.stop()
    return params


@pytest.fixture(scope='module')
def trees():
    return _random_trees('q,v', ['ad0', 'ad1'], 200)


def _port(base_params, **kw):
    kw.setdefault('num_slots', 2)
    for key, value in PAGED.items():
        kw.setdefault(key, value)
    return ContinuousBatchingEngine(
        _tcfg(), params=params_from_jax(base_params, _tcfg()),
        device='cpu', **kw)


def _workload(engine, cell, trees):
    """The cell's traffic: every prompt, two at a time; with adapters the
    repetitive prompt on the base model and both adapters; with the
    prefix cache a second turn that resends each conversation."""
    if cell == 'adapters':
        for name, tree in trees.items():
            engine.load_adapter(name, tree)
        futures = [engine.submit(PROMPTS[0], max_new_tokens=16,
                                 adapter=adapter)
                   for adapter in (None, 'ad0', 'ad1')]
        return [f.result(timeout=120)[0] for f in futures]
    outs = []
    for i in range(0, len(PROMPTS), 2):
        futures = [engine.submit(p, max_new_tokens=16)
                   for p in PROMPTS[i:i + 2]]
        outs += [f.result(timeout=120)[0] for f in futures]
    if cell == 'prefix':
        again = [p + out + [3, 1] for p, out in zip(PROMPTS, outs)]
        outs += [engine.generate(p, max_new_tokens=8, timeout=120)[0]
                 for p in again[:2]]
    return outs


@pytest.fixture(scope='module')
def jax_tokens(base_params, trees):
    """The JAX engine's greedy tokens with drafts, per cell."""
    made = {}

    def get(cell):
        if cell not in made:
            engine = JaxEngine(_jcfg(), params=base_params, num_slots=2,
                               speculative=K, **PAGED, **CELLS[cell])
            try:
                made[cell] = (_workload(engine, cell, trees),
                              dict(engine.spec_stats))
            finally:
                engine.stop()
        return made[cell]

    return get


# ------------------------------------------------------------- drafting

def _reference_draft(context, k):
    return JaxEngine._draft_tokens(context, k)  # pylint: disable=protected-access


@pytest.mark.parametrize('seed', range(4))
def test_draft_tokens_equal_the_reference(seed):
    """Seeded contexts over small vocabularies (so that n-grams recur),
    of lengths around the scan window, at every K from 1 to 8."""
    rng = np.random.RandomState(seed)
    for _ in range(150):
        vocab = int(rng.choice([2, 3, 5, 20, 500]))
        length = int(rng.choice([0, 1, 2, 3, 4, 7, 30, 200, 2047, 2049,
                                 2100]))
        context = rng.randint(0, vocab, length).tolist()
        k = int(rng.randint(1, 9))
        got = ContinuousBatchingEngine._draft_tokens(context, k)  # pylint: disable=protected-access
        assert got == _reference_draft(context, k), (vocab, length, k)


def test_draft_tokens_ngram_lookup():
    """tests/test_inference.py `test_draft_tokens_ngram_lookup`."""
    draft = ContinuousBatchingEngine._draft_tokens  # pylint: disable=protected-access
    assert draft([1, 2, 3, 9, 8, 7, 5, 1, 2, 3], 3) == [9, 8, 7]
    assert draft([4, 6, 4, 6], 3) == [4, 6, 0]
    assert draft([1, 2, 3, 4], 2) is None
    window = ContinuousBatchingEngine._DRAFT_SCAN_WINDOW  # pylint: disable=protected-access
    assert draft([7, 8, 9] + [0] * window + [1, 5, 7, 8, 9], 2) is None


# ---------------------------------------------------------- bit identity

@pytest.mark.parametrize('cell', sorted(CELLS))
def test_greedy_with_drafts_equals_plain_and_the_jax_engine(
        cell, base_params, trees, jax_tokens):
    want, jax_stats = jax_tokens(cell)
    plain = _port(base_params, **CELLS[cell])
    spec = _port(base_params, speculative=K, **CELLS[cell])
    try:
        assert _workload(plain, cell, trees) == want
        assert _workload(spec, cell, trees) == want
        # The repetitive prompts really went through verify ticks, as
        # the reference's did on the same traffic (how many depends on
        # which requests shared a tick).
        assert spec.spec_stats['ticks'] > 0 and jax_stats['ticks'] > 0
        assert spec.spec_stats['accepted'] > 0
        assert plain.spec_stats['ticks'] == 0
    finally:
        plain.stop()
        spec.stop()
    spec._pool.check()  # pylint: disable=protected-access


def _oracle(base_params, prompt, max_new):
    plain = _port(base_params, num_slots=1)
    try:
        return plain.generate(prompt, max_new_tokens=max_new)[0]
    finally:
        plain.stop()


def test_oracle_drafts_save_dispatches(base_params, monkeypatch):
    """Drafts of the model's own greedy continuation are all accepted:
    16 tokens land in ceil(16 / (3+1)) = 4 verify ticks, each adding one
    decode step."""
    prompt = [3, 1, 4, 1, 5]
    oracle = _oracle(base_params, prompt, 24)
    full = prompt + oracle

    def perfect_draft(context, k):
        assert context == full[:len(context)]
        follow = full[len(context):len(context) + k]
        return follow + [0] * (k - len(follow))

    spec = _port(base_params, num_slots=1, speculative=3)
    monkeypatch.setattr(spec, '_draft_tokens', perfect_draft)
    try:
        got, _ = spec.generate(prompt, max_new_tokens=16)
        assert got == oracle[:16]
        assert spec.spec_stats == {'ticks': 4, 'drafted': 12,
                                   'accepted': 12}
        assert spec.tick_stats['decode_steps'] == 4
        assert spec.tick_stats['dispatches'] == 0
    finally:
        spec.stop()


@pytest.mark.parametrize('depth', [1, 2])
def test_async_ring_flushes_around_verify_ticks(base_params, depth):
    prompt = [1, 2, 3, 4] * 3
    want = _oracle(base_params, prompt, 20)
    engine = _port(base_params, num_slots=2, async_depth=depth,
                   speculative=3)
    try:
        first = engine.submit(prompt, max_new_tokens=20)
        second = engine.submit([5, 7, 11], max_new_tokens=20)
        assert first.result(timeout=120)[0] == want
        assert second.result(timeout=120)[0] == _oracle(
            base_params, [5, 7, 11], 20)
        assert engine.spec_stats['ticks'] > 0
        assert engine.tick_stats['flushes'] > 0
        assert not engine._ring  # pylint: disable=protected-access
    finally:
        engine.stop()


# ------------------------------------------------------ blocks and pool

def test_rejected_drafts_return_blocks(base_params, monkeypatch):
    """Garbage drafts (never the model's choice) reject every draft: the
    verify span's tail blocks go back each tick and the pool balances."""
    prompt = [9, 9, 8, 8, 7, 7, 6, 6]
    ref = _oracle(base_params, prompt, 12)
    full = prompt + ref
    vocab = _tcfg().vocab_size

    def garbage_draft(context, k):
        n = len(context)
        assert context == full[:n]
        return [(full[min(n + j, len(full) - 1)] + 1) % vocab
                for j in range(k)]

    engine = _port(base_params, num_slots=1, paged_block_size=2,
                   prefill_chunk=2, speculative=3)
    monkeypatch.setattr(engine, '_draft_tokens', garbage_draft)
    try:
        assert engine.generate(prompt, max_new_tokens=12)[0] == ref
        assert engine.spec_stats['ticks'] > 0
        assert engine.spec_stats['accepted'] == 0
        assert engine.paged_stats['spec_trimmed_blocks'] > 0
        pool = engine._pool  # pylint: disable=protected-access
        pool.check()
        assert pool.used == 1
    finally:
        engine.stop()


def test_pool_exhausted_fallback_rolls_back_reservation(base_params,
                                                        monkeypatch):
    """A reservation that fails on the second slot returns the first
    slot's blocks before the plain fallback, which is counted; the
    streams stay exact and the pool balances."""
    prompt = [9, 9, 8, 8, 7, 7, 6, 6]
    ref = _oracle(base_params, prompt, 24)
    full = prompt + ref

    def perfect_draft(context, k):
        n = len(context)
        return [full[min(n + j, len(full) - 1)] for j in range(k)]

    engine = _port(base_params, num_slots=2, paged_block_size=2,
                   prefill_chunk=2, speculative=3)
    monkeypatch.setattr(engine, '_draft_tokens', perfect_draft)
    real_ensure = engine._ensure_blocks  # pylint: disable=protected-access
    state = {'armed': False, 'span_calls': 0, 'fired': False}

    def flaky_ensure(req, upto_pos):
        if (state['armed'] and not state['fired'] and
                upto_pos - req.next_pos == engine.speculative + 1):
            state['span_calls'] += 1
            if state['span_calls'] == 2:
                state['fired'] = True
                raise kv_cache_lib.PoolExhaustedError('injected')
        return real_ensure(req, upto_pos)

    monkeypatch.setattr(engine, '_ensure_blocks', flaky_ensure)
    try:
        counts = [0, 0]
        seen = [threading.Event(), threading.Event()]

        def tap(i):
            def on_token(tok):
                if tok is not None:
                    counts[i] += 1
                    if counts[i] >= 4:
                        seen[i].set()
            return on_token

        futures = [engine.submit(prompt, max_new_tokens=24, on_token=tap(i))
                   for i in (0, 1)]
        assert all(e.wait(timeout=60) for e in seen)
        state['armed'] = True
        results = [f.result(timeout=120)[0] for f in futures]
        assert state['fired']
        assert engine.spec_fallbacks['pool'] == 1
        assert engine.paged_stats['spec_trimmed_blocks'] > 0
        assert results == [ref, ref]
        pool = engine._pool  # pylint: disable=protected-access
        pool.check()
        assert pool.used == 1
    finally:
        engine.stop()


# ------------------------------------------------------------- sampling

def test_sampling_rows_accept_no_draft(base_params):
    """`_verify_impl` on self-consistent drafts: a greedy row accepts all
    K, a sampling row 0, whose later columns stay the argmax."""
    import torch
    engine = _port(base_params, num_slots=2)
    try:
        width = engine._blocks_per_seq + 1  # pylint: disable=protected-access
        tables = torch.zeros((2, width), dtype=torch.int32)
        tables[0, 0], tables[1, 0] = 1, 2
        positions = torch.arange(K + 1, dtype=torch.int32).repeat(2, 1)
        tokens = torch.tensor([[3] + [0] * K, [7] + [0] * K],
                              dtype=torch.int32)
        greedy = torch.zeros(2, dtype=torch.float32)
        with torch.inference_mode():
            for _ in range(K + 1):   # converge on the greedy rollout
                out, accepted = engine._verify_impl(  # pylint: disable=protected-access
                    tokens, positions, greedy, tables, False)
                tokens = torch.cat([tokens[:, :1], out[:, :K]], dim=1)
            assert accepted.tolist() == [K, K]
            temps = torch.tensor([0.0, 0.8])
            got, accepted = engine._verify_impl(  # pylint: disable=protected-access
                tokens, positions, temps, tables, True)
        assert accepted.tolist() == [K, 0]
        assert torch.equal(got[0], out[0])
        assert torch.equal(got[1, 1:], out[1, 1:])
    finally:
        engine.stop()


def test_sampling_slot_coexists_with_greedy(base_params):
    spec = _port(base_params, num_slots=2, speculative=3)
    try:
        greedy = spec.submit([1, 2, 3, 1, 2, 3], max_new_tokens=10)
        sampled = spec.submit([9, 8, 7], max_new_tokens=10, temperature=0.9)
        out1, st1 = greedy.result(timeout=120)
        out2, st2 = sampled.result(timeout=120)
        assert st1['new_tokens'] == 10 and st2['new_tokens'] == 10
        assert out1 == _oracle(base_params, [1, 2, 3, 1, 2, 3], 10)
        assert all(0 <= t < _tcfg().vocab_size for t in out2)
    finally:
        spec.stop()


def test_window_edge_falls_back_and_finishes(base_params):
    """A slot within K of max_seq_len (64) falls back to plain steps."""
    prompt = list(range(1, 41))
    spec = _port(base_params, num_slots=1, speculative=8)
    try:
        got, stats = spec.generate(prompt, max_new_tokens=20)
        assert stats['new_tokens'] == 20
        assert got == _oracle(base_params, prompt, 20)
        assert spec.spec_fallbacks['window'] > 0
    finally:
        spec.stop()


def test_eos_mid_accept_truncates(base_params):
    prompt = [1, 2, 3, 4, 1, 2, 3, 4]
    want = _oracle(base_params, prompt, 16)
    eos = want[5]
    plain = _port(base_params, num_slots=1)
    spec = _port(base_params, num_slots=1, speculative=4)
    try:
        want_trunc, _ = plain.generate(prompt, max_new_tokens=16,
                                       eos_id=eos)
        got, _ = spec.generate(prompt, max_new_tokens=16, eos_id=eos)
        assert got == want_trunc and got[-1] == eos
    finally:
        plain.stop()
        spec.stop()


def test_server_speculative_answers_as_plain(base_params):
    """InferenceServer(speculative=K) over /generate: the plain engine's
    tokens."""
    import json
    import urllib.request
    server = InferenceServer(_tcfg(), num_slots=2, paged_block_size=8,
                             speculative=K,
                             params=params_from_jax(base_params, _tcfg()),
                             device='cpu')
    server.warmup()
    http = BackgroundServer(server)
    try:
        req = urllib.request.Request(
            http.url + '/generate',
            data=json.dumps({'prompt_ids': [PROMPTS[0]],
                             'max_new_tokens': 16}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
        assert body['token_ids'] == [_oracle(base_params, PROMPTS[0], 16)]
        assert server.engine.spec_stats['ticks'] > 0
    finally:
        http.close()
        server.engine.drain(timeout=60)
