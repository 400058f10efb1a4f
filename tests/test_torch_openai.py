"""The port's OpenAI routes over live localhost HTTP, on test-tiny fp32
weights from a seeded JAX init: /v1/completions (plain and streamed, all
four prompt shapes) answers the JAX engine's greedy tokens as text, the
same as /generate; /v1/chat/completions applies the reference's generic
role template; stop strings truncate; the reference's 400s (n > 1, a
per-request top_p, stream with stop, stream with two prompts) come before
any stream opens; /v1/models names the model."""
import dataclasses
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.serve.server import (BackgroundServer,
                                             InferenceServer, byte_decode,
                                             byte_encode)

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_MAX_NEW = 8
_TEXTS = ('hello there', 'the port serves')
_CHAT = [{'role': 'system', 'content': 'be brief'},
         {'role': 'user', 'content': 'hi'}]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _sse(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    events = []
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers['Content-Type'].startswith('text/event-stream')
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith('data: '):
                data = line[len('data: '):]
                events.append(data if data == '[DONE]' else json.loads(data))
    return events


@pytest.fixture(scope='module')
def live():
    rng = np.random.RandomState(6)
    ids = [rng.randint(1, 256, n).tolist() for n in (5, 12)]
    chat_ids = byte_encode('system: be brief\nuser: hi\nassistant:')
    prompts = ids + [byte_encode(t) for t in _TEXTS] + [chat_ids]
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
        yield {'url': http.url, 'server': server, 'ids': ids,
               'want': dict(zip(map(tuple, prompts), jax_out)),
               'chat_ids': chat_ids}
    finally:
        http.close()
        server.engine.drain(timeout=60)


# Each OpenAI prompt shape and its prompts as token lists.
_SHAPES = {
    'text': lambda live: (_TEXTS[0], [byte_encode(_TEXTS[0])]),
    'texts': lambda live: (list(_TEXTS), [byte_encode(t) for t in _TEXTS]),
    'ids': lambda live: (live['ids'][0], [live['ids'][0]]),
    'id_lists': lambda live: (live['ids'], live['ids']),
}


@pytest.mark.parametrize('shape,stream', [
    ('text', False), ('texts', False), ('ids', False), ('id_lists', False),
    ('text', True), ('ids', True)])
def test_completions_equal_generate(live, shape, stream):
    prompt, token_lists = _SHAPES[shape](live)
    body = {'model': 'test-tiny', 'prompt': prompt, 'max_tokens': _MAX_NEW}
    plain = _post(live['url'] + '/generate',
                  {'prompt_ids': token_lists, 'max_new_tokens': _MAX_NEW})
    want = [live['want'][tuple(p)] for p in token_lists]
    assert plain['token_ids'] == want
    if not stream:
        out = _post(live['url'] + '/v1/completions', body)
        assert out['object'] == 'text_completion'
        assert [c['text'] for c in out['choices']] == plain['text']
        assert [c['index'] for c in out['choices']] == list(
            range(len(want)))
        assert {c['finish_reason'] for c in out['choices']} == {'length'}
        assert out['usage'] == {
            'prompt_tokens': sum(map(len, token_lists)),
            'completion_tokens': _MAX_NEW * len(want),
            'total_tokens': sum(map(len, token_lists)) +
            _MAX_NEW * len(want)}
        return
    events = _sse(live['url'] + '/v1/completions', dict(body, stream=True))
    assert events[-1] == '[DONE]'
    chunks = events[:-1]
    assert {c['object'] for c in chunks} == {'text_completion'}
    assert ''.join(c['choices'][0]['text'] for c in chunks) == \
        plain['text'][0] == byte_decode(want[0])
    assert chunks[-1]['choices'][0]['finish_reason'] == 'length'


@pytest.mark.parametrize('stream', [False, True])
def test_chat_uses_generic_template(live, stream):
    """Messages render as 'role: content' lines plus 'assistant:', whose
    tokens the JAX engine answers."""
    want = byte_decode(live['want'][tuple(live['chat_ids'])])
    body = {'messages': _CHAT, 'max_tokens': _MAX_NEW}
    if not stream:
        out = _post(live['url'] + '/v1/chat/completions', body)
        assert out['object'] == 'chat.completion'
        assert out['choices'][0]['message'] == {'role': 'assistant',
                                                'content': want}
        assert out['usage']['prompt_tokens'] == len(live['chat_ids'])
        return
    events = _sse(live['url'] + '/v1/chat/completions',
                  dict(body, stream=True))
    assert events[-1] == '[DONE]'
    deltas = [e['choices'][0]['delta'] for e in events[:-1]]
    assert deltas[0] == {'role': 'assistant'}
    assert ''.join(d.get('content', '') for d in deltas) == want
    assert events[-2]['choices'][0]['finish_reason'] == 'length'


def test_stop_strings_truncate(live):
    """The earliest stop sequence in the text cuts it (finish_reason
    'stop'); a stop that never occurs leaves it whole ('length')."""
    body = {'prompt': _TEXTS[1], 'max_tokens': 32}
    full = _post(live['url'] + '/v1/completions', body)['choices'][0]['text']
    assert len(full) >= 6, full
    late, early = full[-2:], full[2:4]
    cut = _post(live['url'] + '/v1/completions',
                dict(body, stop=[late, early]))['choices'][0]
    first = min(full.find(late), full.find(early))
    assert cut == {'index': 0, 'text': full[:first],
                   'logprobs': None, 'finish_reason': 'stop'}
    whole = _post(live['url'] + '/v1/completions',
                  dict(body, stop='\x00never\x00'))['choices'][0]
    assert (whole['text'], whole['finish_reason']) == (full, 'length')


@pytest.mark.parametrize('route,body', [
    ('/v1/completions', {'prompt': 'hi', 'n': 2}),
    ('/v1/completions', {'prompt': 'hi', 'top_p': 0.5, 'stream': True}),
    ('/v1/completions', {'prompt': 'hi', 'stop': 'x', 'stream': True}),
    ('/v1/completions', {'prompt': ['a', 'b'], 'stream': True}),
    ('/v1/completions', {'prompt': 'hi', 'max_tokens': 64}),
    ('/v1/completions', {'max_tokens': 4}),
    ('/v1/chat/completions', {'messages': _CHAT, 'n': 3, 'stream': True}),
    ('/v1/chat/completions', {'messages': _CHAT, 'top_p': 0.9}),
    ('/v1/chat/completions', {'messages': []})])
def test_openai_refusals_come_before_the_stream(live, route, body):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(live['url'] + route, body)
    assert err.value.code == 400
    assert err.value.headers['Content-Type'].startswith('application/json')
    error = json.loads(err.value.read())['error']
    assert error['type'] == 'invalid_request_error' and error['message']
    if body.get('top_p'):
        assert '--top-p' in error['message']


def test_top_p_one_is_the_client_default(live):
    out = _post(live['url'] + '/v1/completions',
                {'prompt': _TEXTS[0], 'max_tokens': _MAX_NEW, 'top_p': 1})
    want = byte_decode(live['want'][tuple(byte_encode(_TEXTS[0]))])
    assert out['choices'][0]['text'] == want


def test_models(live):
    with urllib.request.urlopen(live['url'] + '/v1/models', timeout=30) as r:
        body = json.loads(r.read())
    assert body['object'] == 'list'
    assert [m['id'] for m in body['data']] == ['test-tiny']
