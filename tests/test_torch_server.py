"""The port's HTTP server over live localhost HTTP: /generate returns the
same greedy tokens as the port's in-process engine and as the JAX engine
on the same test-tiny fp32 weights; /health answers; bad input is a 400;
a text prompt goes through the byte tokenizer; without device= the
server refuses to start on a machine without CUDA."""
import dataclasses
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                             InferenceServer, byte_decode,
                                             byte_encode)

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_MAX_NEW = 6


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope='module')
def live():
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 512, n).tolist() for n in (4, 13, 21)]
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    jax_engine = jax_inference.ContinuousBatchingEngine(
        jcfg, num_slots=2, paged_block_size=8, prefill_chunk=8, rng_seed=0)
    try:
        jax_out = [jax_engine.generate(p, max_new_tokens=_MAX_NEW)[0]
                   for p in prompts]
    finally:
        jax_engine.drain(timeout=60)
    cfg = dataclasses.replace(get_config('test-tiny'), **_KW)
    server = InferenceServer(
        cfg, num_slots=2, paged_block_size=8, prefill_chunk=8,
        params=params_from_jax(jax.device_get(jax_engine.params), cfg),
        device='cpu')
    server.warmup()
    http = BackgroundServer(server)
    try:
        yield {'url': http.url, 'server': server, 'prompts': prompts,
               'jax_out': jax_out}
    finally:
        http.close()
        server.engine.drain(timeout=60)


def test_health(live):
    with urllib.request.urlopen(live['url'] + '/health', timeout=30) as r:
        assert r.status == 200
        assert json.loads(r.read()) == {'status': 'ok'}


def test_generate_equals_engine_and_reference(live):
    status, body = _post(live['url'] + '/generate',
                         {'prompt_ids': live['prompts'],
                          'max_new_tokens': _MAX_NEW})
    assert status == 200
    assert body['token_ids'] == live['jax_out']
    engine_out = [live['server'].engine.generate(
        p, max_new_tokens=_MAX_NEW)[0] for p in live['prompts']]
    assert body['token_ids'] == engine_out
    assert [s['new_tokens'] for s in body['stats']] == [_MAX_NEW] * 3
    assert [s['prompt_tokens'] for s in body['stats']] == [4, 13, 21]
    assert body['text'] == [byte_decode(t) for t in body['token_ids']]


def test_text_prompt_uses_byte_tokenizer(live):
    status, body = _post(live['url'] + '/generate',
                         {'prompt': 'hi there', 'max_new_tokens': 3})
    assert status == 200
    tokens, _ = live['server'].engine.generate(byte_encode('hi there'),
                                               max_new_tokens=3)
    assert body['token_ids'] == [tokens]


@pytest.mark.parametrize('body', [{'max_new_tokens': 2},
                                  {'prompt_ids': 5},
                                  {'prompt_ids': [[1, 2]],
                                   'max_new_tokens': 'many'},
                                  {'prompt_ids': [[]]}])
def test_bad_requests_are_400(live, body):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(live['url'] + '/generate', body)
    assert err.value.code == 400


@pytest.mark.parametrize('stream', [True, False])
def test_stream_is_refused_until_ported(live, stream):
    """The reference streams SSE on stream=true; the port has no stream
    yet, so it answers 400 naming it rather than one silent JSON body.
    stream=false is the plain answer."""
    body = {'prompt_ids': [[1, 2, 3]], 'max_new_tokens': 3, 'stream': stream}
    if not stream:
        status, out = _post(live['url'] + '/generate', body)
        tokens, _ = live['server'].engine.generate([1, 2, 3],
                                                   max_new_tokens=3)
        assert status == 200 and out['token_ids'] == [tokens]
        return
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(live['url'] + '/generate', body)
    assert err.value.code == 400
    assert 'stream' in json.loads(err.value.read())['error']


def test_server_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present: the default device is usable')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        InferenceServer(dataclasses.replace(get_config('test-tiny'), **_KW),
                        paged_block_size=8)
