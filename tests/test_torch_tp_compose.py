"""Tensor-parallel serving's compositions on the port, on the CPU: multi-
LoRA adapters, int8 weights, MoE and the disaggregated tiers at tp=2 over
two gloo processes, fp32 test-tiny / test-tiny-moe with 2 layers.

One driver subprocess (tests/torch_tp_compose_driver.py) runs the model
and engine checks and prints one JSON line; the tests below read it.
The oracles are the port's tp=1 on the same weights and the JAX
package's single-device engine (the reference's own tp=2 cells need
devices a CPU-only JAX lacks, ROADMAP §3). Then `--tp 2` servers, one for each composition, run
as subprocesses side by side.
"""
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import quantize
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.inference import (ContinuousBatchingEngine,
                                                 _build_model)
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.serve.tenancy import save_adapter_npz

from test_torch_tp import _alive, _children, _wait_gone
from torch_tp_compose_driver import LORA, random_adapter

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DRIVER_S = 200
# fp32 test-tiny: tp=2 sums each row-parallel product (and a MoE block's
# fp32 combine) in two halves, so its logits differ from tp=1's by
# rounding only (observed ~2e-6), as in tests/test_torch_tp.py.
LOGIT_TOL = 1e-5


@pytest.fixture(scope='module')
def driver():
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS='cpu')
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, 'tests',
                                      'torch_tp_compose_driver.py')],
        capture_output=True, text=True, timeout=_DRIVER_S, env=env,
        cwd=_REPO, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------- adapters

@pytest.mark.deadline(60)
def test_adapter_rows_equal_tp1_and_the_jax_engine(driver):
    got = driver['adapters']
    assert got['tp2'] == got['tp1'] == driver['jax']['adapters']
    # Row 0 is the base model's; the adapters change every other row.
    assert got['tp2'][0] == got['base_tp1'][0]
    assert all(a != b for a, b in zip(got['tp2'][1:], got['base_tp1'][1:]))


@pytest.mark.deadline(60)
def test_adapter_eviction_reload_and_unload_under_tp(driver):
    got = driver['adapters']
    assert got['evictions']['evictions'] == 1
    assert got['after_eviction'] == got['after_eviction_tp1']
    assert got['after_eviction'][2] != got['tp2'][2]     # ad2, not ad1
    # ad0 came back into a slot whose tree the followers already held.
    assert got['after_unload'] == got['tp2']


@pytest.mark.deadline(60)
def test_adapter_logits_at_tp2_match_tp1(driver):
    lora = driver['model']['lora']
    assert lora['tp2_vs_tp1'] <= LOGIT_TOL, lora
    assert lora['ranks_equal']


@pytest.mark.deadline(60)
def test_adapter_bytes_per_device(driver):
    """A is whole on column-parallel groups and B on o / down, so a
    rank holds more than half of the stacks; the whole engine (weights,
    pool, stacks) stays at most 0.55 of tp=1's."""
    mem = driver['adapters']['memory']
    assert mem['adapter_global'] == mem['adapter_tp1']
    assert mem['adapter_tp1'] / 2 < mem['adapter_per_device'] < \
        mem['adapter_tp1']
    assert mem['frac'] <= 0.55 and mem['global_equal']


# ------------------------------------------------------------- int8

@pytest.mark.deadline(60)
@pytest.mark.parametrize('source', ['given', 'drawn'])
def test_int8_shards_equal_tp1_slices_bit_for_bit(driver, source):
    int8 = driver['model']['int8']
    assert int8[f'{source}_shards_equal_tp1_slices']
    # Every layer's four projections and the lm_head, payload and scale.
    assert int8[f'{source}_tensors'] == 2 * (4 * 2 + 1)


@pytest.mark.deadline(60)
@pytest.mark.parametrize('proj', ['attn.o_proj', 'mlp.down_proj'])
def test_int8_row_parallel_scale_is_the_whole_input_axis(driver, proj):
    row = driver['model']['int8']['row_parallel'][proj]
    assert row['scale_is_whole_axis']
    # A row shard quantized on its own gives other bits: the check above
    # would catch it.
    assert row['differs_from_shard_alone']


@pytest.mark.deadline(60)
def test_int8_tokens_equal_tp1_and_the_jax_engine(driver):
    got = driver['int8']
    assert got['tp2'] == got['tp1'] == driver['jax']['int8']
    assert got['drawn_tp2'] == got['drawn_tp1']
    assert driver['model']['int8']['tp2_vs_tp1'] <= LOGIT_TOL


@pytest.mark.deadline(60)
def test_int8_inference_engine_at_tp2_equals_tp1(driver):
    got = driver['int8']
    assert got['inference_engine_tp2'] == got['inference_engine_tp1']
    assert len(got['inference_engine_tp2'][0]) == 12


@pytest.mark.deadline(60)
def test_int8_weight_bytes_per_device(driver):
    assert driver['int8']['frac'] <= 0.55


def test_int8_draw_equals_the_float_draw_quantized():
    """The engines' one-parameter-at-a-time draw quantizes the weights
    that `init_random_` then `quantize_state` give, bit for bit."""
    cfg = dataclasses.replace(get_config('test-tiny'), dtype='float32',
                              param_dtype='float32', decode=True)
    want = quantize.quantize_state(
        Transformer(cfg, device='cpu').init_random_(3).state_dict(), cfg)
    _, model = _build_model(cfg, None, 3, 'int8', torch.device('cpu'))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key],
                                                             value), key


# ------------------------------------------------------------- MoE

@pytest.mark.deadline(60)
def test_moe_tokens_equal_tp1_and_the_jax_engine_at_capacity_e(driver):
    got = driver['moe']
    assert got['E_tp2'] == got['E_tp1'] == driver['jax']['moe_E']


@pytest.mark.deadline(60)
def test_moe_tp2_equals_tp1_with_drops(driver):
    got = driver['moe']
    assert got['1.25_tp2'] == got['1.25_tp1']
    # The capacity rule dropped choices: the schedule shows in a row.
    assert got['1.25_tp1'] != got['E_tp1']


@pytest.mark.deadline(60)
@pytest.mark.parametrize('factor', ['1.25', '4.0'])
def test_moe_logits_at_tp2_match_tp1(driver, factor):
    got = driver['model'][f'moe_{factor}']
    assert got['tp2_vs_tp1'] <= LOGIT_TOL, got
    assert got['ranks_equal']


@pytest.mark.deadline(60)
def test_moe_routing_is_equal_on_both_ranks(driver):
    """Every dispatch of every tp=2 MoE forward (model checks, prefill
    chunks, decode steps) chose the same experts and dropped the same
    (token, choice) pairs on both ranks."""
    routing = driver['routing']
    assert routing['rank0'] == routing['rank1'] > 20
    assert routing['equal']


@pytest.mark.deadline(60)
@pytest.mark.parametrize('cell', ['adapters', 'moe_E', 'moe_1.25'])
def test_a_decode_step_makes_two_allreduces_a_layer_and_two_more(driver,
                                                                 cell):
    got = (driver['adapters']['step_collectives'] if cell == 'adapters'
           else driver['moe'][f'{cell[4:]}_step_collectives'])
    assert got == 2 * 2 + 2


# ------------------------------------------------------------- tiers

@pytest.mark.deadline(60)
@pytest.mark.parametrize('trip', ['tp2_to_tp1', 'tp1_to_tp2'])
def test_tier_handoff_across_tp_extents(driver, trip):
    tiers = driver['tiers']
    got = tiers[trip]
    assert got['final'] and got['blocks'] == 5 and got['chunks'] == 3
    assert got['prewarm_hit'] == 1
    assert got['tokens'] == tiers['mono']


@pytest.mark.deadline(60)
def test_followers_import_no_jax_and_exit_with_the_group(driver):
    assert driver['follower_reference_modules'] == 0
    assert driver['followers_exited'] == [0]
    assert driver['jax_errors'] == []


# ------------------------------------------------------------- rules

@pytest.mark.parametrize('proj', list(sharding.TP_PROJECTION_AXES))
def test_adapter_shards_cut_like_their_weight(proj):
    """A rank's adapter slice of projection p is cut where shard_tensor
    cuts p's columns (or rows) inside the fused weight."""
    cfg = get_config('test-tiny')
    d_in, d_out = {'q_proj': (64, 64), 'k_proj': (64, 32),
                   'v_proj': (64, 32), 'o_proj': (64, 64),
                   'gate_proj': (64, 256), 'up_proj': (64, 256),
                   'down_proj': (256, 64)}[proj]
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(3, d_in, 4, generator=gen)
    b = torch.randn(3, 4, d_out, generator=gen)
    fused = {'q_proj': ('attn.qkv_proj', 1, 0),
             'k_proj': ('attn.qkv_proj', 1, 64),
             'v_proj': ('attn.qkv_proj', 1, 96),
             'o_proj': ('attn.o_proj', 0, 0),
             'gate_proj': ('mlp.gate_up_proj', 1, 0),
             'up_proj': ('mlp.gate_up_proj', 1, 256),
             'down_proj': ('mlp.down_proj', 0, 0)}[proj]
    name, dim, start = fused
    width = {'attn.qkv_proj': 128, 'attn.o_proj': 64,
             'mlp.gate_up_proj': 512, 'mlp.down_proj': 64}[name]
    # Mark p's columns (or rows) of the fused weight with their index.
    shape = [64 if dim == 1 else d_in, width if dim == 1 else 64]
    weight = torch.full(shape, -1.0)
    span = torch.arange(d_out if dim == 1 else d_in, dtype=torch.float32)
    if dim == 1:
        weight[:, start:start + d_out] = span
    else:
        weight[:, :] = span[:, None]
    for rank in range(2):
        a_r, b_r = sharding.shard_adapter(proj, a, b, cfg, 2, rank)
        kept = sharding.shard_tensor(name, weight, cfg, 2, rank)
        index = kept[0] if dim == 1 else kept[:, 0]
        index = index[index >= 0].long()
        if dim == 1:
            assert torch.equal(a_r, a)
            assert torch.equal(b_r, b[..., index])
        else:
            assert torch.equal(a_r, a[:, index])
            assert torch.equal(b_r, b)
        assert a_r.is_contiguous() and b_r.is_contiguous()


def test_moe_rules_cut_the_expert_hidden_dimension():
    cfg = get_config('test-tiny-moe')
    assert sharding.param_axes('layers.0.moe.router') is None
    gate = torch.arange(4 * 64 * 256, dtype=torch.float32).reshape(4, 64,
                                                                   256)
    down = gate.reshape(4, 256, 64)
    for rank in range(2):
        got = sharding.shard_tensor('layers.1.moe.w_gate', gate, cfg, 2, rank)
        assert torch.equal(got, gate[..., rank * 128:(rank + 1) * 128])
        got = sharding.shard_tensor('layers.1.moe.w_down', down, cfg, 2, rank)
        assert torch.equal(got, down[:, rank * 128:(rank + 1) * 128])
    assert sharding.is_sharded('layers.0.moe.w_up')
    assert not sharding.is_sharded('layers.0.moe.router')


# ------------------------------------------------------------- servers

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


_PROMPT = [5, 17, 3, 99, 250, 7, 7, 31, 64, 2, 11]
_SERVE_NEW = 8
_LORA_FLAGS = ['--max-adapters', '2', '--adapter-rank',
               str(LORA['adapter_rank']), '--adapter-alpha',
               str(LORA['adapter_alpha']), '--adapter-targets',
               LORA['adapter_targets']]
SERVERS = {
    'adapters': (['--model', 'test-tiny'] + _LORA_FLAGS,
                 dict(max_adapters=2, **LORA)),
    'moe': (['--model', 'test-tiny-moe'], {}),
    'int8': (['--model', 'test-tiny', '--quantize', 'int8'],
             dict(quantize='int8')),
    'tier': (['--model', 'test-tiny', '--tier', 'prefill',
              '--prefix-cache', '4'], dict(tier='prefill', prefix_cache=4)),
}


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _serve(name, proc, url, npz):
    """Wait for `proc`'s server, ask it once, stop it: (tokens, its
    followers, whether they all left)."""
    deadline = time.monotonic() + 120
    while True:
        assert proc.poll() is None, proc.stderr.read()[-3000:]
        assert time.monotonic() < deadline, f'{name}: server did not come up'
        try:
            with urllib.request.urlopen(url + '/health', timeout=5) as r:
                if r.status == 200:
                    break
        except OSError:
            pass
        time.sleep(0.2)
    followers = _children(proc.pid)
    body = {'prompt_ids': [_PROMPT], 'max_new_tokens': _SERVE_NEW}
    if name == 'adapters':
        _post(url + '/adapters/load', {'name': 'ad0', 'path': npz})
        body['adapter'] = 'ad0'
    tokens = _post(url + '/generate', body)['token_ids'][0]
    proc.send_signal(signal.SIGTERM)
    code = proc.wait(timeout=60)
    return tokens, followers, code, _wait_gone(followers, 20)


@pytest.fixture(scope='module')
def servers(tmp_path_factory):
    """The four `--tp 2` servers, started together; each one's answer
    and the tp=1 engine's on the same seeded weights."""
    tmp = tmp_path_factory.mktemp('tp_compose_servers')
    cfg = dataclasses.replace(get_config('test-tiny'), lora_rank=4,
                              lora_alpha=8.0,
                              lora_targets=LORA['adapter_targets'])
    tree = random_adapter(cfg, 7)
    npz = str(tmp / 'ad0.npz')
    save_adapter_npz(tree, npz)
    env = dict(os.environ, PYTHONPATH=_REPO)
    procs = {}
    try:
        for name, (flags, _) in SERVERS.items():
            port = _free_port()
            procs[name] = (subprocess.Popen(
                [sys.executable, '-m', 'skypilot_tpu_torch.serve.server',
                 '--device', 'cpu', '--port', str(port), '--max-seq-len',
                 '128', '--num-slots', '2', '--tp', '2', '--drain-timeout',
                 '30'] + flags, cwd=_REPO, env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE),
                f'http://127.0.0.1:{port}')
        out = {name: _serve(name, proc, url, npz)
               for name, (proc, url) in procs.items()}
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
    for name, (flags, kw) in SERVERS.items():
        engine = ContinuousBatchingEngine(
            flags[1], max_seq_len=128, num_slots=2, paged_block_size=16,
            device='cpu', **kw)
        try:
            adapter = None
            if name == 'adapters':
                engine.load_adapter('ad0', tree)
                adapter = 'ad0'
            want, _ = engine.generate(_PROMPT, max_new_tokens=_SERVE_NEW,
                                      adapter=adapter)
        finally:
            engine.stop()
        out[name] = out[name] + (want,)
    return out


@pytest.mark.deadline(200)
@pytest.mark.parametrize('name', list(SERVERS))
def test_server_tp2_composition_answers_with_tp1_tokens(servers, name):
    tokens, followers, code, left, want = servers[name]
    assert len(followers) == 1 and code == 0
    assert left == [], [p for p in followers if _alive(p)]
    assert tokens == want
    assert len(tokens) == _SERVE_NEW
    assert np.asarray(tokens).min() >= 0
