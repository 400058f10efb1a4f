"""The port's async decode pipeline on the CPU: `async_depth`,
`decode_chunk` and the device-resident feed of
skypilot_tpu_torch/models/inference.py over the static step buffers of
models/step_graph.py (on the CPU each step runs eagerly over the buffers
a CUDA graph replays on the card).

Ported from tests/test_async_pipeline.py, on test-tiny fp32 weights (a
seeded JAX init carried across with params_from_jax), paged blocks of 8
and prefill chunks of 16:
  - depth in {0, 1, 3} x decode_chunk in {1, 4} give the greedy streams
    of the port's synchronous engine under max-tokens, EOS (overshoot
    discarded), window and staggered-churn termination, and the pool
    balances back to scratch-only after every case;
  - the port at depth 1, decode_chunk 4 equals the JAX engine in the
    same configuration on the harness of tests/test_torch_engine.py;
  - a steady window uploads at most one host->device input per tick
    (a paged window of 10 ticks at most 4), counted at the one upload
    funnel, `step_graph.Staged.put`;
  - a failed tick with a full ring fails its request and emits no
    pending column, and the engine serves on;
  - a multi-LoRA engine at depth 1 equals itself at depth 0 per adapter
    in a mixed batch; InferenceServer(async_depth=1, decode_chunk=4)
    answers /generate as the synchronous engine does.
"""
import dataclasses
import json
import time
import urllib.request

import jax
import numpy as np
import pytest

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch.models import step_graph
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import adapter_layout, params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.serve.server import BackgroundServer, InferenceServer

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
CONFIGS = [(depth, chunk) for depth in (0, 1, 3) for chunk in (1, 4)]
_IDS = [f'depth{d}-chunk{c}' for d, c in CONFIGS]
# The cross-framework workload (tests/test_torch_engine.py's harness).
_LENGTHS = (3, 8, 9, 17, 30, 33)
_SECOND_WAVE = (12, 25)
_MAX_NEW = 8


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 512, n).tolist() for n in lengths]


def _run(engine, first, second):
    futures = [engine.submit(p, max_new_tokens=_MAX_NEW) for p in first]
    out = [futures[0].result(timeout=120)[0]]
    futures += [engine.submit(p, max_new_tokens=_MAX_NEW) for p in second]
    out += [f.result(timeout=120)[0] for f in futures[1:]]
    return out


@pytest.fixture(scope='module')
def reference():
    """The JAX engine at async_depth=1, decode_chunk=4 on the staggered
    workload, and its weights."""
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    engine = jax_inference.ContinuousBatchingEngine(
        jcfg, num_slots=3, paged_block_size=8, prefill_chunk=16,
        rng_seed=0, async_depth=1, decode_chunk=4)
    first, second = _prompts(_LENGTHS, 0), _prompts(_SECOND_WAVE, 1)
    try:
        outputs = _run(engine, first, second)
    finally:
        engine.drain(timeout=60)
    return {'params': jax.device_get(engine.params), 'first': first,
            'second': second, 'outputs': outputs}


def _cfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


def _engine(reference, **kw):
    kw.setdefault('num_slots', 2)
    kw.setdefault('paged_block_size', 8)
    kw.setdefault('prefill_chunk', 16)
    return ContinuousBatchingEngine(
        _cfg(), params=params_from_jax(reference['params'], _cfg()),
        device='cpu', **kw)


def _settle(engine, timeout=30.0):
    """Wait until the engine holds no request and no pending dispatch,
    then hold the pool to scratch-only."""
    deadline = time.monotonic() + timeout
    while (engine._busy() or engine._ring) and \
            time.monotonic() < deadline:  # pylint: disable=protected-access
        time.sleep(0.005)
    assert not engine._ring  # pylint: disable=protected-access
    engine._pool.check()  # pylint: disable=protected-access
    assert engine._pool.used == 1  # pylint: disable=protected-access


@pytest.fixture(scope='module')
def engines(reference):
    made = {}

    def get(depth, chunk):
        if (depth, chunk) not in made:
            made[depth, chunk] = _engine(reference, async_depth=depth,
                                         decode_chunk=chunk)
        return made[depth, chunk]

    yield get
    for engine in made.values():
        engine.stop()


@pytest.fixture(scope='module')
def ref_tokens(engines):
    """The synchronous engine's greedy stream for PROMPT: every
    comparison is cut from it (any max_new_tokens prefix)."""
    toks, _ = engines(0, 1).generate(PROMPT, max_new_tokens=24)
    return toks


def test_knobs_default_and_clamp(reference):
    engine = _engine(reference)
    assert (engine.async_depth, engine.decode_chunk) == (0, 1)
    engine = _engine(reference, async_depth=-1, decode_chunk=0)
    assert (engine.async_depth, engine.decode_chunk) == (0, 1)
    assert set(engine.tick_stats) == {'dispatches', 'decode_steps',
                                      'chained', 'flushes', 'host_gap_s',
                                      'gap_samples', 'prefills'}


@pytest.mark.parametrize('depth,chunk', CONFIGS, ids=_IDS)
def test_max_tokens_termination(engines, ref_tokens, depth, chunk):
    engine = engines(depth, chunk)
    chained0 = engine.tick_stats['chained']
    for n in (2, 9, 24):
        got, stats = engine.generate(PROMPT, max_new_tokens=n)
        assert got == ref_tokens[:n], (n, got)
        assert stats['new_tokens'] == n
    if depth:
        assert engine.tick_stats['chained'] > chained0
    # max_new_tokens=1 keeps the reference's 2 tokens (the first token
    # is counted only at the next emit): equal to the sync engine's.
    want, _ = engines(0, 1).generate(PROMPT, max_new_tokens=1)
    got, _ = engine.generate(PROMPT, max_new_tokens=1)
    assert got == want == ref_tokens[:2]
    _settle(engine)


@pytest.mark.parametrize('depth,chunk', CONFIGS, ids=_IDS)
def test_eos_termination(engines, ref_tokens, depth, chunk):
    """EOS is seen up to depth dispatches late; the overshoot is
    discarded and the stream stops at the EOS token."""
    eos = ref_tokens[5]
    got, _ = engines(depth, chunk).generate(PROMPT, max_new_tokens=24,
                                            eos_id=eos)
    assert got == ref_tokens[:ref_tokens.index(eos) + 1]
    _settle(engines(depth, chunk))


@pytest.mark.parametrize('depth,chunk', CONFIGS, ids=_IDS)
def test_window_termination(engines, depth, chunk):
    """32 prompt + 32 new tokens end exactly on max_seq_len 64: no chained
    dispatch may write past the window."""
    prompt = list(range(2, 34))
    want, _ = engines(0, 1).generate(prompt, max_new_tokens=32)
    got, stats = engines(depth, chunk).generate(prompt, max_new_tokens=32)
    assert got == want
    assert stats['new_tokens'] == len(want)
    _settle(engines(depth, chunk))


@pytest.mark.parametrize('depth,chunk', CONFIGS, ids=_IDS)
def test_mixed_churn_streams_identical(engines, ref_tokens, depth, chunk):
    """Staggered requests of different lengths churn the two slots
    mid-pipeline, some ending on EOS while others wait for their slot (the
    overshoot of a finished request must not reach the one admitted after
    it): every stream, and its on_token order, equals the synchronous
    reference."""
    engine = engines(depth, chunk)
    eos = ref_tokens[5]
    streams = {}

    def tap(key):
        streams[key] = []
        return lambda tok: tok is not None and streams[key].append(tok)

    reqs = ((4, None), (16, eos), (7, None), (12, eos), (5, None),
            (24, eos), (9, None))
    futures = []
    for i, (n, eos_id) in enumerate(reqs):
        futures.append(engine.submit(PROMPT, max_new_tokens=n,
                                     eos_id=eos_id, on_token=tap(i)))
        if i % 2:
            time.sleep(0.02)
    results = [f.result(timeout=120)[0] for f in futures]
    for i, (n, eos_id) in enumerate(reqs):
        want = ref_tokens[:n if eos_id is None else
                          min(n, ref_tokens.index(eos) + 1)]
        assert results[i] == want, (i, n, results[i])
        assert streams[i] == want, (i, n, streams[i])
    _settle(engine)


def test_greedy_equals_jax_engine_at_depth1_chunk4(reference):
    engine = _engine(reference, num_slots=3, async_depth=1, decode_chunk=4)
    try:
        outputs = _run(engine, reference['first'], reference['second'])
        _settle(engine)
    finally:
        assert engine.drain(timeout=60)
    assert outputs == reference['outputs']
    assert engine.tick_stats['chained'] > 0
    assert engine.tick_stats['decode_steps'] > engine.tick_stats['dispatches']


def _count_window(engine, monkeypatch, ticks):
    """Host->device uploads (every Staged.put) over a window of `ticks`
    decode steps of one long request in steady state."""
    fut = engine.submit(PROMPT, max_new_tokens=48)
    deadline = time.monotonic() + 60
    while engine.tick_stats['decode_steps'] < 4 and \
            time.monotonic() < deadline:
        time.sleep(0.001)
    uploads = []
    real = step_graph.Staged.put

    def counted(self, values):
        uploads.append(np.asarray(values).shape)
        real(self, values)

    monkeypatch.setattr(step_graph.Staged, 'put', counted)
    start = engine.tick_stats['decode_steps']
    while engine.tick_stats['decode_steps'] < start + ticks and \
            time.monotonic() < deadline:
        time.sleep(0.001)
    window = engine.tick_stats['decode_steps'] - start
    count = len(uploads)
    monkeypatch.setattr(step_graph.Staged, 'put', real)
    fut.result(timeout=120)
    assert window >= ticks, 'engine made no progress under the counter'
    return count, window


@pytest.mark.parametrize('depth', [0, 1])
def test_steady_window_uploads_at_most_one(reference, monkeypatch, depth):
    """Within one 32-token block a steady tick feeds the device from the
    device: at most one upload over 6 ticks (the counter's installation
    boundary)."""
    engine = _engine(reference, paged_block_size=32, async_depth=depth)
    try:
        engine.generate(PROMPT, max_new_tokens=2)
        uploads, window = _count_window(engine, monkeypatch, ticks=6)
        if depth:
            assert engine.tick_stats['chained'] > 0
    finally:
        engine.stop()
    assert uploads <= 1, f'{uploads} uploads over {window} steady ticks'


def test_paged_window_uploads_bounded_by_block_growth(reference,
                                                      monkeypatch):
    """Blocks of 8: the table re-uploads only when it grows; 10 ticks
    cross at most 2 boundaries, plus the installation allowance."""
    engine = _engine(reference, async_depth=1)
    try:
        engine.generate(PROMPT, max_new_tokens=2)
        uploads, window = _count_window(engine, monkeypatch, ticks=10)
    finally:
        engine.stop()
    assert uploads <= 4, f'{uploads} uploads over {window} paged ticks'


def test_failed_tick_with_full_ring_emits_no_pending_column(reference,
                                                            ref_tokens):
    engine = _engine(reference, async_depth=3)
    events = []
    real = engine._steps.run  # pylint: disable=protected-access
    fired = []

    def faulty(key, body, **kw):
        ring = engine._ring  # pylint: disable=protected-access
        tokens = sum(1 for e in events if e is not None)
        if key[0] == 'decode' and len(ring) == engine.async_depth and \
                tokens >= 4 and not fired:
            fired.append(len(ring))
            raise RuntimeError('injected decode fault')
        real(key, body, **kw)

    engine._steps.run = faulty  # pylint: disable=protected-access
    try:
        future = engine.submit(PROMPT, max_new_tokens=24,
                               on_token=events.append)
        with pytest.raises(RuntimeError, match='injected'):
            future.result(timeout=60)
        _settle(engine)
        streamed = [e for e in events if e is not None]
        assert fired == [3]
        assert events[-1] is None and events.count(None) == 1
        # The three pending dispatches' columns never reached the stream.
        assert streamed == ref_tokens[:len(streamed)]
        assert len(streamed) < 24
        engine._steps.run = real  # pylint: disable=protected-access
        got, _ = engine.generate(PROMPT, max_new_tokens=24)
        assert got == ref_tokens
        _settle(engine)
    finally:
        engine.stop()


def _random_adapter(cfg, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    (rng.standard_normal(v) * 0.05).astype(np.float32))
                for k, v in sorted(node.items())}
    return walk(adapter_layout(cfg))


def test_multi_lora_depth1_equals_depth0(reference):
    prompts = _prompts((5, 19, 11, 27), 3)
    adapters = [None, 'a0', 'a1', 'a0']
    outs = {}
    for depth, chunk in ((0, 1), (1, 1), (1, 4)):
        engine = _engine(reference, num_slots=4, async_depth=depth,
                         decode_chunk=chunk, max_adapters=2, adapter_rank=4,
                         adapter_alpha=8.0, adapter_targets='q,v')
        try:
            for i, name in enumerate(('a0', 'a1')):
                engine.load_adapter(name, _random_adapter(engine.cfg, 7 + i))
            futures = [engine.submit(p, max_new_tokens=10, adapter=a)
                       for p, a in zip(prompts, adapters)]
            outs[depth, chunk] = [f.result(timeout=120)[0] for f in futures]
            _settle(engine)
        finally:
            assert engine.drain(timeout=60)
    assert outs[1, 1] == outs[0, 1]
    assert outs[1, 4] == outs[0, 1]
    base = _engine(reference, num_slots=4)
    try:
        plain = [base.generate(p, max_new_tokens=10)[0] for p in prompts]
    finally:
        base.stop()
    assert plain[0] == outs[0, 1][0]
    assert any(plain[i] != outs[0, 1][i] for i in (1, 2, 3))


def test_capture_graphs_runs_on_an_idle_engine(engines, ref_tokens):
    """On the CPU capture_graphs runs the greedy steps over inert inputs
    (all-scratch tables) and captures nothing; serving is unchanged."""
    engine = engines(1, 4)
    assert engine.capture_graphs() == []
    got, _ = engine.generate(PROMPT, max_new_tokens=24)
    assert got == ref_tokens
    _settle(engine)


def test_server_async_generate_equals_sync(reference, engines):
    prompts = [PROMPT, list(range(2, 20)), [9, 9]]
    want = [engines(0, 1).generate(p, max_new_tokens=10)[0]
            for p in prompts]
    server = InferenceServer(
        _cfg(), num_slots=2, paged_block_size=8, prefill_chunk=16,
        params=params_from_jax(reference['params'], _cfg()),
        async_depth=1, decode_chunk=4, device='cpu')
    server.warmup()
    http = BackgroundServer(server)
    try:
        req = urllib.request.Request(
            http.url + '/generate',
            data=json.dumps({'prompt_ids': prompts,
                             'max_new_tokens': 10}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = json.loads(resp.read())
    finally:
        http.close()
        assert server.engine.drain(timeout=60)
    assert body['token_ids'] == want
    assert server.engine.tick_stats['chained'] > 0
