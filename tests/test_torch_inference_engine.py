"""The port's single-request InferenceEngine and get_engine against the
reference's (skypilot_tpu/models/inference.py; its own pins are
tests/test_inference.py).

Weights are test-tiny fp32 from the JAX engine's seeded init carried
across with params_from_jax. JAX is the oracle: greedy tokens equal JAX
`InferenceEngine.generate`'s at batch 2 with decode_chunk 1 and 4 (float
and int8 KV), and so does the EOS truncation (batch 1, the EOS taken
from the stream). Within the port, the reference's contracts: the
prefill and each decode step give the full forward's logits, chunked
equals stepwise and a partial final chunk has its exact length, top_k=1
sampling is greedy and a sampled token stays in the filtered support,
`stats` has the reference's four keys, the prompt's shape and length are
asserted with the reference's messages, a config with pool geometry
raises the reference's block-tables error at its first forward, and a
serving group refuses int8 weights naming ROADMAP §1 item 5b (tp=2
itself: tests/test_torch_tp.py). get_engine is cached, refuses a tp that
does not divide the model before it starts a process, and serves a
training checkpoint directory with the tokens of its params; a missing
directory raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.inference import (
    InferenceEngine, get_engine, load_params_from_checkpoint)
from skypilot_tpu_torch.train import run as train_run

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_MAX_NEW = 10
_ATOL = 1e-4


def _prompt(batch, length, seed):
    return np.random.RandomState(seed).randint(1, 512, (batch, length))


@pytest.fixture(scope='module')
def reference():
    """The JAX engine's greedy streams: batch 2 at decode_chunk 1 and 4,
    float and int8 KV, and batch 1 with the EOS at its fourth column."""
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    engine = jax_inference.InferenceEngine(jcfg, batch_size=2)
    params = jax.device_get(engine.params)
    prompt, single = _prompt(2, 12, 0), _prompt(1, 9, 1)
    out = {'params': params, 'jcfg': jcfg, 'prompt': prompt,
           'single': single}
    for chunk in (1, 4):
        for quant in ('', 'int8'):
            eng = jax_inference.InferenceEngine(
                jcfg, params=params, batch_size=2, decode_chunk=chunk,
                kv_quant=quant or None)
            out[chunk, quant] = np.asarray(eng.generate(
                jnp.asarray(prompt, jnp.int32), max_new_tokens=_MAX_NEW)[0])
        eng = jax_inference.InferenceEngine(jcfg, params=params,
                                            batch_size=1, decode_chunk=chunk)
        full = np.asarray(eng.generate(jnp.asarray(single, jnp.int32),
                                       max_new_tokens=_MAX_NEW)[0])
        eos = int(full[0, 3])
        out[chunk, 'eos'] = (eos, np.asarray(eng.generate(
            jnp.asarray(single, jnp.int32), max_new_tokens=_MAX_NEW,
            eos_id=eos)[0]))
    return out


def _cfg(**kw):
    return dataclasses.replace(get_config('test-tiny'), **_KW, **kw)


def _engine(reference, **kw):
    cfg = _cfg()
    kw.setdefault('batch_size', 2)
    return InferenceEngine(cfg, params=params_from_jax(reference['params'],
                                                       cfg),
                           device='cpu', **kw)


@pytest.mark.parametrize('quant', ['', 'int8'], ids=['float', 'int8'])
@pytest.mark.parametrize('chunk', [1, 4])
def test_greedy_tokens_equal_reference(reference, chunk, quant):
    engine = _engine(reference, decode_chunk=chunk, kv_quant=quant or None)
    got, stats = engine.generate(reference['prompt'],
                                 max_new_tokens=_MAX_NEW)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), reference[chunk, quant])
    assert stats['new_tokens'] == _MAX_NEW
    assert set(stats) == {'ttft_s', 'total_s', 'new_tokens',
                          'decode_tokens_per_s'}
    assert stats['decode_tokens_per_s'] > 0


@pytest.mark.parametrize('chunk', [1, 4])
def test_eos_truncation_equals_reference(reference, chunk):
    """The host scans one dispatch behind and drops the overshoot: the
    output ends at the first all-EOS column, as the JAX engine's does."""
    eos, want = reference[chunk, 'eos']
    engine = _engine(reference, batch_size=1, decode_chunk=chunk)
    got, stats = engine.generate(reference['single'],
                                 max_new_tokens=_MAX_NEW, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] == 4 == stats['new_tokens']


def test_chunked_equals_stepwise_and_final_chunk_is_exact(reference):
    stepwise = _engine(reference, decode_chunk=1)
    want, _ = stepwise.generate(reference['prompt'], max_new_tokens=_MAX_NEW)
    for chunk, new in ((3, _MAX_NEW), (4, 7), (8, 5)):
        got, stats = _engine(reference, decode_chunk=chunk).generate(
            reference['prompt'], max_new_tokens=new)
        assert tuple(got.shape) == (2, new) and stats['new_tokens'] == new
        assert torch.equal(got, want[:, :new])
    # At the window's edge the final chunk shrinks to what remains.
    prompt = _prompt(2, 56, 2)
    want, _ = stepwise.generate(prompt, max_new_tokens=8)
    got, _ = _engine(reference, decode_chunk=5).generate(prompt,
                                                         max_new_tokens=8)
    assert torch.equal(got, want)


def test_prefill_and_steps_match_the_full_forward(reference):
    """The reference's KV-cache correctness pins: the prefill's logits and
    each decode step's equal the full forward's at that position."""
    engine = _engine(reference, batch_size=1)
    tokens = torch.from_numpy(_prompt(1, 10, 3))
    with torch.inference_mode():
        full = engine._forward(engine.init_cache(), tokens,  # pylint: disable=protected-access
                               torch.arange(10, dtype=torch.int32)[None])
        cache = engine.init_cache()
        logits = engine._prefill_impl(cache, tokens[:, :4], 4)  # pylint: disable=protected-access
        torch.testing.assert_close(logits, full[:, 3], atol=_ATOL,
                                   rtol=_ATOL)
        for pos in range(4, 10):
            logits = engine._decode_impl(cache, tokens[:, pos:pos + 1], pos)  # pylint: disable=protected-access
            torch.testing.assert_close(logits, full[:, pos], atol=_ATOL,
                                       rtol=_ATOL)


def test_top_k_1_sampling_is_greedy(reference):
    greedy, _ = _engine(reference).generate(reference['prompt'],
                                            max_new_tokens=8)
    for chunk in (1, 4):
        sampled, _ = _engine(reference, top_k=1, decode_chunk=chunk,
                             rng_seed=7).generate(
            reference['prompt'], max_new_tokens=8, temperature=1.0)
        assert torch.equal(sampled, greedy)


@pytest.mark.parametrize('chunk', [1, 4])
def test_sampled_tokens_stay_in_the_top_k(reference, chunk):
    """Every sampled token is among the top 3 of the logits that drew it
    (the full forward over the prompt and the stream recomputes them)."""
    k = 3
    engine = _engine(reference, top_k=k, decode_chunk=chunk, rng_seed=3)
    prompt = reference['prompt']
    got, _ = engine.generate(prompt, max_new_tokens=12, temperature=2.0)
    seq = torch.cat([torch.from_numpy(prompt), got.long()], dim=1)
    with torch.inference_mode():
        logits = engine._forward(  # pylint: disable=protected-access
            engine.init_cache(), seq[:, :-1],
            torch.arange(seq.shape[1] - 1, dtype=torch.int32)[None].expand(
                2, -1))
    start = prompt.shape[1] - 1
    for col in range(got.shape[1]):
        step = logits[:, start + col].float()
        kth = torch.topk(step, k, dim=-1).values[:, -1]
        chosen = step.gather(1, got[:, col:col + 1].long())[:, 0]
        assert bool((chosen >= kth - _ATOL).all()), col
    assert not torch.equal(got, _engine(reference).generate(
        prompt, max_new_tokens=12)[0])


def test_prompt_shape_and_length_are_asserted(reference):
    engine = _engine(reference)
    with pytest.raises(AssertionError, match=r'prompt must be \(2, L\); '
                       r'got \(12,\)'):
        engine.generate(reference['prompt'][0], max_new_tokens=4)
    with pytest.raises(AssertionError, match=r'prompt must be \(2, L\)'):
        engine.generate(reference['prompt'][:1], max_new_tokens=4)
    with pytest.raises(AssertionError,
                       match='12\\+60 exceeds max_seq_len 64'):
        engine.generate(reference['prompt'], max_new_tokens=60)


def test_pool_geometry_raises_the_block_tables_error(reference):
    """The reference serves a config with pool geometry by failing its
    first forward: the single-request engine has no block tables."""
    paged = dict(paged_block_size=8, paged_num_blocks=20)
    jcfg = dataclasses.replace(reference['jcfg'], **paged)
    with pytest.raises(ValueError, match='requires block_tables'):
        jax_inference.InferenceEngine(
            jcfg, params=reference['params']).generate(
                jnp.ones((1, 4), jnp.int32), max_new_tokens=2)
    cfg = _cfg(**paged)
    engine = InferenceEngine(cfg, params=params_from_jax(
        reference['params'], cfg), device='cpu')
    with pytest.raises(ValueError, match='paged KV cache requires '
                       'block_tables'):
        engine.generate(np.ones((1, 4), np.int64), max_new_tokens=2)


class _Group:
    """A serving group of three ranks that no process joined: tp=3 does
    not divide test-tiny, so the engine refuses before it sends
    anything."""
    tp, rank, spawned = 3, 0, True
    device = torch.device('cpu')


def test_refusals(reference):
    with pytest.raises(ValueError, match='tp=3 does not divide'):
        _engine(reference, mesh=_Group(), quantize='int8')
    with pytest.raises(NotImplementedError,
                       match="decode_kernel='pallas' requires the paged KV"):
        _engine(reference, decode_kernel='pallas')
    with pytest.raises(ValueError, match='unknown kv_quant'):
        _engine(reference, kv_quant='fp8')


def test_int8_weights_serve(reference):
    engine = _engine(reference, quantize='int8')
    assert engine.cfg.weight_quant == 'int8'
    assert engine.model.layers[0].attn.qkv_proj.dtype == torch.int8
    got, _ = engine.generate(reference['prompt'], max_new_tokens=6)
    assert tuple(got.shape) == (2, 6)
    assert int(got.max()) < engine.cfg.vocab_size


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp('ckpt'))
    assert train_run.main(['--model', 'test-tiny', '--batch', '2', '--seq',
                           '32', '--steps', '2', '--warmup-steps', '1',
                           '--device', 'cpu', '--checkpoint-dir',
                           directory]) == 0
    return directory


def test_get_engine_is_cached_and_serves_a_checkpoint(checkpoint, tmp_path):
    get_engine.cache_clear()
    try:
        engine = get_engine('test-tiny', batch_size=1, max_seq_len=64,
                            checkpoint_dir=checkpoint, device='cpu')
        assert get_engine('test-tiny', batch_size=1, max_seq_len=64,
                          checkpoint_dir=checkpoint,
                          device='cpu') is engine
        assert (engine.cfg.paged_block_size, engine.cfg.max_seq_len,
                engine.decode_kernel) == (0, 64, 'xla')
        prompt = [[5, 7, 11, 300, 2]]
        got, _ = engine.generate(prompt, max_new_tokens=6)
        params = load_params_from_checkpoint(get_config('test-tiny'),
                                             checkpoint)
        want, _ = InferenceEngine('test-tiny', params=params, max_seq_len=64,
                                  device='cpu').generate(prompt,
                                                         max_new_tokens=6)
        assert torch.equal(got, want)
        with pytest.raises(FileNotFoundError):
            get_engine('test-tiny', checkpoint_dir=str(tmp_path / 'none'),
                       device='cpu')
        with pytest.raises(ValueError, match='tp=3 does not divide'):
            get_engine('test-tiny', tp=3, device='cpu')
    finally:
        get_engine.cache_clear()
