"""Serving real weights end to end on the CPU: the port trains test-tiny
for 2 steps with `train.run --checkpoint-dir`, then serves that
directory.

Pinned: the server CLI (`python -m skypilot_tpu_torch.serve.server
--checkpoint-dir DIR --max-queue 32`, a subprocess) answers /generate
with the greedy tokens of an in-process engine on the restored weights;
in fp32 those weights give the JAX engine's tokens fed the converted
tree; the restore reads params only (the Adam moments stay in the file);
`export_tool` writes an HF directory the port's loader reads back bit for
bit; and the refusals: a lora.json sidecar over a checkpoint that holds
no such adapters (LoRA checkpoints themselves are served merged,
tests/test_torch_finetune_io.py) and --checkpoint-dir together with
--hf-model-path. The reference's
`--max-queue` flag parses (fault 5: the port named it --max-queue-depth).
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import pytest
import torch

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.inference import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.inference import (
    ContinuousBatchingEngine, load_params_from_checkpoint)
from skypilot_tpu_torch.serve import server as server_lib
from skypilot_tpu_torch.train import run as train_run

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_START_S = 60.0
PROMPTS = [[5, 17, 300, 2, 9], list(range(40, 61)), [7] * 12]
MAX_NEW = 8


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp('ckpt'))
    assert train_run.main(['--model', 'test-tiny', '--batch', '2', '--seq',
                           '32', '--steps', '2', '--warmup-steps', '1',
                           '--device', 'cpu', '--checkpoint-dir',
                           directory]) == 0
    return directory


def _engine_tokens(engine):
    try:
        futures = [engine.submit(p, max_new_tokens=MAX_NEW)
                   for p in PROMPTS]
        return [f.result(timeout=120)[0] for f in futures]
    finally:
        assert engine.drain(timeout=60)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _health(url: str) -> int:
    try:
        with urllib.request.urlopen(url + '/health', timeout=5) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_restore_is_params_only_in_the_serving_dtype(checkpoint):
    cfg = get_config('test-tiny')
    params = load_params_from_checkpoint(cfg, checkpoint)
    saved = torch.load(os.path.join(checkpoint, '2', 'state.pt'),
                       weights_only=True)
    assert set(params) == set(saved['model'])
    assert 'optimizer' in saved                       # left in the file
    assert all(v.dtype == torch.bfloat16 for v in params.values())
    assert torch.equal(params['embed'], saved['model']['embed'])


def test_cli_serves_checkpoint_like_the_in_process_engine(checkpoint):
    cfg = get_config('test-tiny')
    want = _engine_tokens(ContinuousBatchingEngine(
        cfg, params=load_params_from_checkpoint(cfg, checkpoint),
        num_slots=2, paged_block_size=16, device='cpu'))
    port = _free_port()
    url = f'http://127.0.0.1:{port}'
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.serve.server',
         '--model', 'test-tiny', '--checkpoint-dir', checkpoint,
         '--device', 'cpu', '--port', str(port), '--num-slots', '2',
         '--max-queue', '32'], cwd=_REPO,
        env=dict(os.environ, PYTHONPATH=_REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + _START_S
        while True:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.monotonic() < deadline, 'server did not come up'
            try:
                if _health(url) == 200:
                    break
            except OSError:
                pass
            time.sleep(0.1)
        req = urllib.request.Request(
            url + '/generate', data=json.dumps({
                'prompt_ids': PROMPTS, 'max_new_tokens': MAX_NEW}).encode(),
            headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())['token_ids']
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    assert got == want


def test_restored_weights_give_the_reference_engine_tokens(checkpoint):
    kw = dict(dtype='float32', param_dtype='float32', remat=False)
    cfg = get_config('test-tiny', **kw)
    params = load_params_from_checkpoint(cfg, checkpoint)
    got = _engine_tokens(ContinuousBatchingEngine(
        cfg, params=params, num_slots=2, paged_block_size=16,
        device='cpu'))
    jengine = JaxEngine(jax_get_config('test-tiny', **kw),
                        params=jax.tree.map(
                            jax.numpy.asarray,
                            convert.params_to_jax(params, cfg)),
                        num_slots=2, paged_block_size=16)
    try:
        futures = [jengine.submit(p, max_new_tokens=MAX_NEW)
                   for p in PROMPTS]
        want = [f.result(timeout=120)[0] for f in futures]
    finally:
        jengine.stop()
    assert got == want


def test_export_tool_round_trips(checkpoint, tmp_path):
    from skypilot_tpu_torch.models import export_tool
    out = str(tmp_path / 'hf')
    assert export_tool.main(['--model', 'test-tiny', '--checkpoint-dir',
                             checkpoint, '--out', out]) == 0
    cfg = get_config('test-tiny', dtype='float32')
    want = load_params_from_checkpoint(cfg, checkpoint)
    got = convert.load_hf_checkpoint(out, cfg)
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def test_lora_checkpoint_and_two_weight_sources_refused(checkpoint,
                                                        tmp_path):
    lora_dir = str(tmp_path / 'lora')
    shutil.copytree(checkpoint, lora_dir)
    with open(os.path.join(lora_dir, 'lora.json'), 'w',
              encoding='utf-8') as f:
        json.dump({'lora_rank': 4, 'lora_alpha': 8.0,
                   'lora_targets': 'q,v'}, f)
    with pytest.raises(ValueError, match='not those of its lora.json'):
        load_params_from_checkpoint(get_config('test-tiny'), lora_dir)
    with pytest.raises(ValueError, match='mutually exclusive'):
        server_lib.InferenceServer('test-tiny', checkpoint_dir=checkpoint,
                                   hf_model_path=checkpoint, device='cpu')
    with pytest.raises(FileNotFoundError):
        load_params_from_checkpoint(get_config('test-tiny'),
                                    str(tmp_path / 'missing'))


def test_reference_max_queue_flag_parses():
    """Fault 5: a reference command line's --max-queue reaches the
    engine's max_queue_depth."""
    args = server_lib.build_parser().parse_args(
        ['--model', 'test-tiny', '--max-queue', '32', '--hf-model-path',
         'd', '--quantize', 'int8', '--decode-kernel', 'xla'])
    assert (args.max_queue, args.hf_model_path, args.quantize,
            args.decode_kernel) == (32, 'd', 'int8', 'xla')
    assert server_lib.build_parser().parse_args([]).max_queue == 64
