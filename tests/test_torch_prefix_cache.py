"""The port's paged prefix cache on the CPU: `PrefixIndex` in
skypilot_tpu_torch/models/kv_cache.py and the engine's prefix branch
(`_admit`, `_cow_copy`, `_store_prefix_paged`, `_alloc_block`) in
skypilot_tpu_torch/models/inference.py.

On test-tiny fp32 weights (a seeded JAX init carried across with
params_from_jax), paged blocks of 8:
  - the port's PrefixIndex equals the reference's on a seeded random
    sequence of put, lookup and pop_lru calls;
  - multi-turn chat traffic (each turn resends the conversation so far)
    gives the JAX engine's greedy tokens, prefix_stats and paged_stats
    (blocks_reused, cow_copies, prefix_evictions) under pool pressure;
  - a hit equals a cold prefill bit for bit (tokens, and the K/V rows of
    the published prompt) at async depth {0, 1, 3} x decode_chunk {1, 4}
    and under int8 KV;
  - the reference's tests/test_paged_cache.py contracts: two requests
    extend one prefix through copy-on-write; a copy-on-write allocation
    failure releases the shared increfs; eviction frees only at refcount
    zero; an adapter request bypasses the cache; a failed tick leaves a
    fresh index; the pool balances back to scratch-only once the index
    is released.
"""
import dataclasses
import random
import time

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models import kv_cache as jax_kv_cache
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models import inference as inference_lib
from skypilot_tpu_torch.models import kv_cache
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import adapter_layout, params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
CONFIGS = [(depth, chunk) for depth in (0, 1, 3) for chunk in (1, 4)]
# Multi-turn chat at test size: turn-1 prompts of these lengths, each
# turn's greedy reply of _REPLY tokens, then _NEW fresh tokens; 3 turns
# and an exact repeat of each turn-3 prompt. Conversation 0's turn-2 hit
# (10 tokens) is under _MIN_PREFIX; 16 is block-aligned.
_TURN1 = (10, 16, 21)
_REPLY, _NEW, _TURNS = 4, 5, 3
# Pool pressure: 2 slots, 4 entries, 17 blocks (scratch included).
_ENGINE_KW = dict(num_slots=2, paged_block_size=8, prefill_chunk=16,
                  prefix_cache=4, paged_num_blocks=17)


def _cfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


def _jax_cfg():
    return dataclasses.replace(jax_get_config('test-tiny'), **_KW)


def _conversations(generate):
    """The multi-turn traffic driven through `generate(ids) -> tokens`,
    one request at a time: every prompt in order, and every reply."""
    rng = np.random.RandomState(5)
    history = [rng.randint(1, 512, n).tolist() for n in _TURN1]
    prompts, replies = [], []
    for turn in range(_TURNS):
        for c, ids in enumerate(history):
            prompts.append(list(ids))
            replies.append(generate(ids))
            if turn < _TURNS - 1:
                history[c] = ids + replies[-1] + rng.randint(
                    1, 512, _NEW).tolist()
    for ids in history:                       # exact repeats of turn 3
        prompts.append(list(ids))
        replies.append(generate(ids))
    return prompts, replies


@pytest.fixture(scope='module')
def reference():
    """The JAX engine's multi-turn run and its weights."""
    engine = jax_inference.ContinuousBatchingEngine(
        _jax_cfg(), rng_seed=0, **_ENGINE_KW)
    try:
        prompts, replies = _conversations(
            lambda ids: engine.generate(ids, max_new_tokens=_REPLY)[0])
        stats = {'prefix': dict(engine.prefix_stats),
                 'paged': dict(engine.paged_stats)}
    finally:
        engine.drain(timeout=60)
    return {'params': jax.device_get(engine.params), 'prompts': prompts,
            'replies': replies, 'stats': stats}


def _engine(reference, **kw):
    for key, value in _ENGINE_KW.items():
        kw.setdefault(key, value)
    return ContinuousBatchingEngine(
        _cfg(), params=params_from_jax(reference['params'], _cfg()),
        device='cpu', **kw)


def _settle(engine, timeout=30.0):
    deadline = time.monotonic() + timeout
    while (engine._busy() or engine._ring) and \
            time.monotonic() < deadline:  # pylint: disable=protected-access
        time.sleep(0.005)
    assert not engine._busy()  # pylint: disable=protected-access
    engine._pool.check()  # pylint: disable=protected-access


def _release_index(engine):
    """Drop every cached prefix's references (idle engine)."""
    index = engine._prefix_entries  # pylint: disable=protected-access
    while len(index):
        _key, blocks = index.pop_lru()
        engine._pool.release(blocks)  # pylint: disable=protected-access


def _index_blocks(engine):
    return {b for _k, blocks in engine._prefix_entries.entries()  # pylint: disable=protected-access
            for b in blocks}


# ------------------------------------------------------------ PrefixIndex

@pytest.mark.parametrize('chunk', [1, 3, 8])
def test_prefix_index_equals_reference(chunk):
    """Seeded random put / lookup / pop_lru over prompts that share
    prefixes: match lengths, payloads, last_compares, displaced keys and
    LRU order equal the reference's PrefixIndex call for call."""
    rnd = random.Random(chunk)
    ours = kv_cache.PrefixIndex(capacity=5, chunk=chunk)
    theirs = jax_kv_cache.PrefixIndex(capacity=5, chunk=chunk)
    stems = [[rnd.randrange(4) for _ in range(rnd.randrange(0, 20))]
             for _ in range(6)]

    def prompt():
        stem = rnd.choice(stems)
        return stem[:rnd.randrange(len(stem) + 1)] + [
            rnd.randrange(4) for _ in range(rnd.randrange(0, 12))]

    hits = 0
    for step in range(600):
        op = rnd.random()
        if op < 0.45:
            ids = prompt()
            got = ours.put(ids, step)
            want = theirs.put(ids, step)
            assert got == want
        elif op < 0.9:
            ids = prompt()
            limit = rnd.choice([len(ids) - 1, len(ids), rnd.randrange(30)])
            got = ours.lookup(ids, limit)
            assert got == theirs.lookup(ids, limit)
            assert ours.last_compares == theirs.last_compares
            hits += got[0] > 0
        else:
            assert ours.pop_lru() == theirs.pop_lru()
        assert list(ours) == list(theirs)
        assert len(ours) == len(theirs)
    assert hits > 20


# ------------------------------------------------------------ the engine

def test_multi_turn_equals_jax_engine(reference):
    """The chat traffic one request at a time under pool pressure: greedy
    tokens, prefix_stats and paged_stats equal the JAX engine's."""
    engine = _engine(reference)
    try:
        prompts, replies = _conversations(
            lambda ids: engine.generate(ids, max_new_tokens=_REPLY)[0])
        _settle(engine)
        assert prompts == reference['prompts']
        assert replies == reference['replies']
        want = reference['stats']
        assert engine.prefix_stats == {
            k: want['prefix'][k] for k in ('hits', 'misses', 'tokens_reused')}
        for key in ('blocks_reused', 'cow_copies', 'prefix_evictions',
                    'prefill_chunks'):
            assert engine.paged_stats[key] == want['paged'][key], key
        # 3 conversations x 3 hitting turns, less turn 2's 10-token hit.
        assert engine.prefix_stats['hits'] == 8
        assert engine.paged_stats['prefix_evictions'] > 0
        assert engine.paged_stats['cow_copies'] > 0
        assert engine._pool.used == 1 + len(_index_blocks(engine))  # pylint: disable=protected-access
        _release_index(engine)
        assert engine._pool.used == 1  # pylint: disable=protected-access
    finally:
        engine.stop()


def _published_rows(engine, key):
    """K and V rows (every layer) of the prompt `key` as its index entry
    holds them."""
    blocks = engine._prefix_entries._lru[tuple(key)]  # pylint: disable=protected-access
    n = len(key)
    k = engine._k_pool[:, blocks].flatten(1, 2)[:, :n]  # pylint: disable=protected-access
    v = engine._v_pool[:, blocks].flatten(1, 2)[:, :n]  # pylint: disable=protected-access
    if engine._k_scale is None:  # pylint: disable=protected-access
        return k.clone(), v.clone()
    ks = engine._k_scale[:, blocks].flatten(1, 2)[:, :n]  # pylint: disable=protected-access
    vs = engine._v_scale[:, blocks].flatten(1, 2)[:, :n]  # pylint: disable=protected-access
    return k.clone(), v.clone(), ks.clone(), vs.clone()


_BASE = list(range(2, 22))                     # 20 tokens: 2 blocks + 4
_EXT = _BASE + [31, 7, 99, 4, 58, 3, 11]        # extends it mid-block


@pytest.mark.parametrize(
    'depth,chunk,kv_quant',
    [(d, c, None) for d, c in CONFIGS] + [(0, 1, 'int8'), (1, 4, 'int8')],
    ids=[f'depth{d}-chunk{c}' for d, c in CONFIGS] +
    ['depth0-chunk1-int8', 'depth1-chunk4-int8'])
def test_hit_equals_cold_prefill(reference, depth, chunk, kv_quant):
    """A prompt extending a cached one (copy-on-write of its partial
    boundary block, suffix prefilled from position 20) gives the tokens
    of a cold prefill, and the K/V rows it publishes equal the cold
    run's bit for bit (scale rows too under int8 KV)."""
    kw = dict(async_depth=depth, decode_chunk=chunk, kv_quant=kv_quant,
              paged_num_blocks=None)
    hot, cold = _engine(reference, **kw), _engine(reference, **kw)
    try:
        hot.generate(_BASE, max_new_tokens=6)
        got, _ = hot.generate(_EXT, max_new_tokens=12)
        want, _ = cold.generate(_EXT, max_new_tokens=12)
        _settle(hot)
        _settle(cold)
        assert got == want
        assert hot.prefix_stats == {'hits': 1, 'misses': 1,
                                    'tokens_reused': len(_BASE)}
        assert cold.prefix_stats == {'hits': 0, 'misses': 1,
                                     'tokens_reused': 0}
        assert hot.paged_stats['cow_copies'] == 1
        assert hot.paged_stats['blocks_reused'] == 2
        assert hot.paged_stats['prefill_chunks'] == 2 + 1
        assert cold.paged_stats['prefill_chunks'] == 2
        for a, b in zip(_published_rows(hot, _EXT),
                        _published_rows(cold, _EXT)):
            assert torch.equal(a, b)
        for engine in (hot, cold):
            _release_index(engine)
            assert engine._pool.used == 1  # pylint: disable=protected-access
    finally:
        hot.stop()
        cold.stop()


def test_cow_two_requests_extend_same_prefix(reference):
    """Two requests extending one cached prefix each clone the partial
    boundary block and share the full blocks read-only; both equal the
    uncached engine, so sharing never leaks one suffix into the other."""
    ext_a, ext_b = _BASE + [3, 9, 27], _BASE + [4, 8, 16]
    pfx = _engine(reference, paged_num_blocks=None)
    ref = _engine(reference, paged_num_blocks=None, prefix_cache=0)
    try:
        pfx.generate(_BASE, max_new_tokens=4)
        got = [pfx.generate(p, max_new_tokens=6)[0] for p in (ext_a, ext_b)]
        want = [ref.generate(p, max_new_tokens=6)[0] for p in (ext_a, ext_b)]
        assert got == want
        assert pfx.paged_stats['cow_copies'] == 2
        assert pfx.paged_stats['blocks_reused'] == 4      # 2 full x 2
        assert pfx.prefix_stats['hits'] == 2
        assert pfx.prefix_stats['tokens_reused'] == 2 * len(_BASE)
        assert ref.prefix_stats == {'hits': 0, 'misses': 0,
                                    'tokens_reused': 0}
        _settle(pfx)
        assert pfx.paged_occupancy()['prefix_entries'] == 3
    finally:
        pfx.stop()
        ref.stop()


def test_cow_alloc_failure_releases_shared_increfs(reference):
    """When the copy-on-write cannot allocate (pool exhausted, the
    matched entry's blocks pinned by a live owner), admission undoes its
    increfs: only the eviction's decrefs remain."""
    engine = _engine(reference, paged_num_blocks=4, prefix_cache=2)
    try:
        pool = engine._pool  # pylint: disable=protected-access
        owner = [pool.alloc() for _ in range(3)]
        for b in owner:
            pool.incref(b)                          # the entry's reference
        engine._prefix_entries.put(tuple(_BASE), list(owner))  # pylint: disable=protected-access
        assert pool.free == 0
        before = [pool.refcount(b) for b in owner]
        req = inference_lib._Request(  # pylint: disable=protected-access
            _BASE + [1, 2, 3, 4], 4, 0.0, None, None)
        with pytest.raises(kv_cache.PoolExhaustedError):
            engine._admit(0, req)  # pylint: disable=protected-access
        assert [pool.refcount(b) for b in owner] == [r - 1 for r in before]
        assert req.blocks == [] and engine._slots == [None, None]  # pylint: disable=protected-access
        assert engine.paged_stats['prefix_evictions'] == 1
        pool.check()
    finally:
        engine.stop()


def test_admission_pool_exhaustion_sheds_the_request(reference):
    """Through the tick: the request whose copy finds no block fails with
    EngineOverloadedError and the engine serves on."""
    engine = _engine(reference, paged_num_blocks=4, prefix_cache=2)
    try:
        pool = engine._pool  # pylint: disable=protected-access
        owner = [pool.alloc() for _ in range(3)]
        for b in owner:
            pool.incref(b)
        engine._prefix_entries.put(tuple(_BASE), list(owner))  # pylint: disable=protected-access
        with pytest.raises(exceptions.EngineOverloadedError,
                           match='at admission'):
            engine.generate(_BASE + [1, 2, 3, 4], max_new_tokens=2)
        pool.release(owner)
        tokens, _ = engine.generate([5, 7, 11], max_new_tokens=3)
        assert len(tokens) == 3
        _settle(engine)
    finally:
        engine.stop()


def test_eviction_only_frees_at_refcount_zero(reference):
    """Filling the LRU past capacity evicts entries; blocks return to
    the free list exactly when nothing references them."""
    engine = _engine(reference, num_slots=1, paged_num_blocks=None,
                     prefix_cache=2)
    try:
        for start in (2, 30, 60, 90, 120):
            engine.generate(list(range(start, start + 20)), max_new_tokens=2)
        occ = engine.paged_occupancy()
        assert occ['prefix_entries'] == 2
        assert occ['blocks_used'] == 1 + 2 * 3, occ   # ceil(20 / 8) each
        engine._pool.check()  # pylint: disable=protected-access
        # A shared block outlives its entry's eviction while a request
        # holds it.
        pool = engine._pool  # pylint: disable=protected-access
        (key, blocks), _ = engine._prefix_entries.entries()  # pylint: disable=protected-access
        pool.incref(blocks[0])
        _release_index(engine)
        assert pool.refcount(blocks[0]) == 1 and pool.used == 2
        pool.decref(blocks[0])
        assert pool.used == 1
        del key
    finally:
        engine.stop()


def _random_adapter(cfg, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.standard_normal(v) * 0.05).astype(np.float32))
                for k, v in sorted(node.items())}
    return walk(adapter_layout(cfg))


def test_adapter_request_bypasses_cache(reference):
    """Adapter requests neither look up nor publish: their KV depends on
    the adapter. A base request after them still hits its own entry."""
    engine = _engine(reference, paged_num_blocks=None, max_adapters=1,
                     adapter_rank=4, adapter_alpha=8.0,
                     adapter_targets='q,v')
    try:
        engine.load_adapter('a0', _random_adapter(engine.cfg, 3))
        engine.generate(_BASE, max_new_tokens=2, adapter='a0')
        assert len(engine._prefix_entries) == 0  # pylint: disable=protected-access
        engine.generate(_BASE, max_new_tokens=2)
        engine.generate(_EXT, max_new_tokens=2, adapter='a0')
        assert engine.prefix_stats == {'hits': 0, 'misses': 1,
                                       'tokens_reused': 0}
        engine.generate(_EXT, max_new_tokens=2)
        assert engine.prefix_stats['hits'] == 1
        _settle(engine)
    finally:
        engine.stop()


def test_failed_tick_leaves_fresh_index(reference):
    """A failed tick builds a fresh index with the fresh pool: no entry
    names a block of the abandoned pool, and the engine serves on."""
    engine = _engine(reference, paged_num_blocks=None)
    real = engine._steps.run  # pylint: disable=protected-access
    fired = []

    def faulty(key, body, **kw):
        if key[0] == 'prefill' and len(engine._prefix_entries) and not fired:  # pylint: disable=protected-access
            fired.append(key)
            raise RuntimeError('injected prefill fault')
        real(key, body, **kw)

    engine._steps.run = faulty  # pylint: disable=protected-access
    try:
        engine.generate(_BASE, max_new_tokens=2)
        old_index = engine._prefix_entries  # pylint: disable=protected-access
        with pytest.raises(RuntimeError, match='injected'):
            engine.generate(_EXT, max_new_tokens=2)
        _settle(engine)
        assert fired
        assert engine._prefix_entries is not old_index  # pylint: disable=protected-access
        assert len(engine._prefix_entries) == 0  # pylint: disable=protected-access
        assert engine._pool.used == 1  # pylint: disable=protected-access
        got, _ = engine.generate(_EXT, max_new_tokens=4)
        cold = _engine(reference, paged_num_blocks=None, prefix_cache=0)
        try:
            assert got == cold.generate(_EXT, max_new_tokens=4)[0]
        finally:
            cold.stop()
    finally:
        engine.stop()


def test_prefix_cache_zero_turns_the_cache_off(reference):
    """The knob is read at every admission and publish: 0 on an idle
    engine stops lookups and publishes and keeps the entries; restored,
    the entries hit again. The default pool sizes for the LRU."""
    engine = _engine(reference, paged_num_blocks=None)
    try:
        bps = engine.cfg.max_seq_len // engine.paged_block_size
        assert engine.cfg.paged_num_blocks == (2 + 4) * bps + 1
        engine.generate(_BASE, max_new_tokens=2)
        engine.prefix_cache = 0
        engine.generate(_EXT, max_new_tokens=2)
        assert engine.prefix_stats == {'hits': 0, 'misses': 1,
                                       'tokens_reused': 0}
        assert list(engine._prefix_entries) == [tuple(_BASE)]  # pylint: disable=protected-access
        engine.prefix_cache = 4
        engine.generate(_EXT, max_new_tokens=2)
        assert engine.prefix_stats['hits'] == 1
        _settle(engine)
        assert engine._pool.used == 1 + len(_index_blocks(engine))  # pylint: disable=protected-access
    finally:
        engine.stop()
