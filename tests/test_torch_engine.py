"""The port's ContinuousBatchingEngine against the JAX engine.

Both engines get the same test-tiny fp32 weights (a seeded JAX init
carried across with params_from_jax), paged blocks of 8 and prefill
chunks of 16, and the same staggered workload: more requests than slots,
prompts crossing block and chunk boundaries, a second wave admitted into
slots the first wave frees. Every greedy request's tokens must be equal.
Then the port's own contracts: the pool drains back to scratch-only, an
exhausted pool sheds with EngineOverloadedError, admission control,
deadlines, and no quiet CPU fallback.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_LENGTHS = (3, 8, 9, 17, 30, 33)
_SECOND_WAVE = (12, 25)
_MAX_NEW = 8


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 512, n).tolist() for n in lengths]


def _run(engine, first, second, sampled=None):
    """First wave at once (more requests than slots), then a second wave
    once the first request has finished."""
    futures = [engine.submit(p, max_new_tokens=_MAX_NEW) for p in first]
    extra = (engine.submit(sampled, max_new_tokens=_MAX_NEW,
                           temperature=1.0) if sampled else None)
    out = [futures[0].result(timeout=120)[0]]
    futures += [engine.submit(p, max_new_tokens=_MAX_NEW) for p in second]
    out += [f.result(timeout=120)[0] for f in futures[1:]]
    if extra is not None:
        extra.result(timeout=120)
    return out


@pytest.fixture(scope='module')
def reference():
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    engine = jax_inference.ContinuousBatchingEngine(
        jcfg, num_slots=3, paged_block_size=8, prefill_chunk=16,
        rng_seed=0)
    first, second = _prompts(_LENGTHS, 0), _prompts(_SECOND_WAVE, 1)
    try:
        outputs = _run(engine, first, second)
    finally:
        engine.drain(timeout=60)
    return {'params': jax.device_get(engine.params), 'first': first,
            'second': second, 'outputs': outputs}


def _engine(reference, **kw):
    cfg = dataclasses.replace(get_config('test-tiny'), **_KW)
    kw.setdefault('num_slots', 3)
    kw.setdefault('paged_block_size', 8)
    kw.setdefault('prefill_chunk', 16)
    return ContinuousBatchingEngine(
        cfg, params=params_from_jax(reference['params'], cfg), device='cpu',
        **kw)


def test_greedy_tokens_equal_reference_engine(reference):
    engine = _engine(reference)
    try:
        outputs = _run(engine, reference['first'], reference['second'])
    finally:
        assert engine.drain(timeout=60)
    assert outputs == reference['outputs']
    assert all(len(o) == _MAX_NEW for o in outputs)
    # Chunks: ceil(len / 16) per prompt.
    assert engine.paged_stats['prefill_chunks'] == sum(
        -(-n // 16) for n in _LENGTHS + _SECOND_WAVE)
    engine._pool.check()  # pylint: disable=protected-access
    assert engine._pool.used == 1  # pylint: disable=protected-access


def test_sampling_row_leaves_greedy_rows_unchanged(reference):
    engine = _engine(reference, num_slots=4)
    try:
        outputs = _run(engine, reference['first'], reference['second'],
                       sampled=_prompts((11,), 2)[0])
    finally:
        assert engine.drain(timeout=60)
    assert outputs == reference['outputs']


def test_exhausted_pool_sheds_with_overloaded(reference):
    # Scratch + 2 blocks = 16 tokens: a 30-token prompt cannot prefill.
    engine = _engine(reference, num_slots=2, paged_num_blocks=3)
    try:
        with pytest.raises(exceptions.EngineOverloadedError,
                           match='exhausted'):
            engine.generate(reference['first'][4], max_new_tokens=4,
                            timeout=60)
        tokens, _ = engine.generate(reference['first'][0],
                                    max_new_tokens=4, timeout=60)
        assert len(tokens) == 4             # the engine keeps serving
    finally:
        assert engine.drain(timeout=60)
    engine._pool.check()  # pylint: disable=protected-access
    assert engine._pool.used == 1  # pylint: disable=protected-access


def test_queue_cap_drain_and_deadline(reference):
    engine = _engine(reference, num_slots=1, max_queue_depth=1)
    try:
        # Idle engine: 1 free slot + cap 1 accepted, the third sheds.
        futures = [engine.submit([1, 2, 3], max_new_tokens=30)
                   for _ in range(2)]
        with pytest.raises(exceptions.EngineOverloadedError,
                           match='queue is full'):
            for _ in range(3):
                futures.append(engine.submit([1, 2, 3], max_new_tokens=30))
        for f in futures:
            f.result(timeout=60)
        late = engine.submit([4, 5], max_new_tokens=4,
                             deadline=time.time() - 1.0)
        with pytest.raises(exceptions.RequestDeadlineExceededError):
            late.result(timeout=60)
    finally:
        assert engine.drain(timeout=60)
    with pytest.raises(exceptions.EngineDrainingError):
        engine.submit([1, 2], max_new_tokens=2)


def test_submit_validation(reference):
    engine = _engine(reference)
    with pytest.raises(ValueError, match='empty'):
        engine.submit([], max_new_tokens=2)
    with pytest.raises(ValueError, match='max_seq_len'):
        engine.submit(list(range(60)), max_new_tokens=8)
    engine.stop()


def test_decode_kernel_knob_refusals():
    cfg = dataclasses.replace(get_config('test-tiny'), **_KW)
    with pytest.raises(ValueError, match='decode_kernel'):
        ContinuousBatchingEngine(cfg, paged_block_size=8, device='cpu',
                                 decode_kernel='triton')
    capped = dataclasses.replace(cfg, attn_logit_softcap=50.0)
    with pytest.raises(NotImplementedError, match='softcap'):
        ContinuousBatchingEngine(capped, paged_block_size=8, device='cpu')
    # The kernel walks block tables: the contiguous layout refuses it.
    with pytest.raises(NotImplementedError, match='paged'):
        ContinuousBatchingEngine(cfg, device='cpu', decode_kernel='pallas')


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    cfg = dataclasses.replace(get_config('test-tiny'), **_KW)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        ContinuousBatchingEngine(cfg, paged_block_size=8)
