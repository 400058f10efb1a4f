"""The fine-tune loop on the CPU through the port's entry points:
train.run with --lora-*, --sft-data, --val-dir, --init-from-hf and
--export-hf; the lora.json sidecar and its refusals; export_tool's LoRA
flags; serving the result merged (--checkpoint-dir) and its trained
adapter as a tenant (POST /adapters/load); the callbacks summary and the
byte tokenizer's shards. Held against the JAX package where it has the
same step: its eval step, its engine on the merged params and on the
same adapter tree, its callbacks and tokenize_tool.

The runs train test-tiny as train.run does (bf16 params and compute).
Within the port, checks are bit for bit (resume, overlay, merge and
export are the same tensors). Against the JAX package the weights are
cast to fp32 and both sides run in fp32: greedy tokens equal, and the
eval loss within 2e-5 relative (test_torch_train's tolerance).
"""
import dataclasses
import glob
import json
import os
import shutil
import urllib.request

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu import callbacks as jcallbacks
from skypilot_tpu.models import lora as jlora
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.inference import (
    ContinuousBatchingEngine as JaxEngine)
from skypilot_tpu.parallel import MeshConfig, build_mesh
from skypilot_tpu.serve import tenancy as jtenancy
from skypilot_tpu.train import data as jdata
from skypilot_tpu.train import tokenize_tool as jtokenize_tool
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch import callbacks
from skypilot_tpu_torch.models import convert, export_tool, lora
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.inference import (
    ContinuousBatchingEngine, load_params_from_checkpoint)
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.serve import tenancy
from skypilot_tpu_torch.serve.server import BackgroundServer, InferenceServer
from skypilot_tpu_torch.train import data, run, tokenize_tool, trainer
from skypilot_tpu_torch.train.checkpoints import CheckpointManager

LORA = {'lora_rank': 4, 'lora_alpha': 8.0, 'lora_targets': 'q,v'}
_FP32 = dict(dtype='float32', param_dtype='float32', remat=False)
PROMPTS = [[5, 17, 300, 2, 9], list(range(40, 61)), [7] * 12]
MAX_NEW = 8


def _files(root):
    """A seeded SFT JSONL (8 examples) and a validation shard."""
    rng = np.random.RandomState(0)
    sft = os.path.join(root, 'sft.jsonl')
    with open(sft, 'w', encoding='utf-8') as f:
        for _ in range(8):
            f.write(json.dumps({
                'prompt': rng.randint(0, 512, rng.randint(2, 12)).tolist(),
                'completion': rng.randint(0, 512,
                                          rng.randint(8, 40)).tolist()})
                    + '\n')
    val = os.path.join(root, 'val')
    os.makedirs(val)
    data.write_token_shard(os.path.join(val, 'v.bin'),
                           rng.randint(0, 512, 8 * 32 + 1))
    return sft, val


def _args(root, ckpt, steps=4, *extra):
    sft, val = os.path.join(root, 'sft.jsonl'), os.path.join(root, 'val')
    return ['--model', 'test-tiny', '--device', 'cpu', '--batch', '4',
            '--seq', '32', '--steps', str(steps), '--warmup-steps', '1',
            '--learning-rate', '1e-2', '--lora-rank', '4', '--lora-alpha',
            '8', '--lora-targets', 'q,v', '--sft-data', sft, '--val-dir',
            val, '--eval-every', '2', '--eval-batches', '2',
            '--checkpoint-dir', ckpt, '--checkpoint-every', '2',
            '--log-every', '1', *extra]


@pytest.fixture(scope='module')
def lora_run(tmp_path_factory):
    """One LoRA fine-tune of test-tiny: 4 steps on SFT data, validation
    every 2, checkpoints (steps 1, 2, 4), merged HF export."""
    root = str(tmp_path_factory.mktemp('lora_run'))
    _files(root)
    ckpt, export = os.path.join(root, 'ckpt'), os.path.join(root, 'hf')
    history = []
    assert run.main(_args(root, ckpt, 4, '--export-hf', export),
                    history=history) == 0
    return {'root': root, 'ckpt': ckpt, 'export': export,
            'history': history}


def _raw(ckpt, step=4):
    """A step's saved state with the full model state dict."""
    manager = CheckpointManager(ckpt)
    saved = torch.load(manager.state_path(step), weights_only=True)
    saved['model'] = manager.model_state(step)
    return saved


def test_run_writes_sidecar_checkpoints_validation(lora_run):
    with open(os.path.join(lora_run['ckpt'], 'lora.json'),
              encoding='utf-8') as f:
        assert json.load(f) == LORA
    assert CheckpointManager(lora_run['ckpt']).all_steps() == [1, 2, 4]
    history = lora_run['history']
    assert [('val_loss' in h) for h in history] == [False, True, False,
                                                     True]
    lora_cfg = get_config('test-tiny', param_dtype='bfloat16', **LORA)
    adapters = sum(v.numel() for k, v in _raw(lora_run['ckpt'])['model']
                   .items() if lora.is_adapter_key(k))
    assert history[0]['opt_state_bytes'] == 2 * 2 * adapters + 4 * len(
        lora.adapter_keys(lora_cfg))
    raw = _raw(lora_run['ckpt'])
    assert set(raw['optimizer']['state']) == set(range(len(
        lora.adapter_keys(lora_cfg))))
    # state.pt holds the adapters; the frozen base is written once and
    # every later step links it.
    step_file = torch.load(os.path.join(lora_run['ckpt'], '4', 'state.pt'),
                           weights_only=True)
    assert set(step_file['model']) == lora.adapter_keys(lora_cfg)
    inodes = {os.stat(os.path.join(lora_run['ckpt'], str(s),
                                   'frozen.pt')).st_ino for s in (1, 2, 4)}
    assert len(inodes) == 1


def test_a_frozen_tensor_changed_in_place_is_written_again(tmp_path):
    """frozen.pt is linked only while the frozen tensors' bits are those
    it holds: one element changed in place makes the next save write it,
    and a manager that restored a step links to that step's file."""
    cfg = get_config('test-tiny', param_dtype='bfloat16', **LORA)
    state = trainer.create_train_state(cfg, device='cpu', seed=0)
    directory = str(tmp_path)
    manager = CheckpointManager(directory, save_interval_steps=1)

    def inode(step):
        return os.stat(os.path.join(directory, str(step),
                                    'frozen.pt')).st_ino
    assert manager.save(1, state) and manager.save(2, state)
    key, param = next((name, p) for name, p in
                      state.model.named_parameters() if not p.requires_grad)
    with torch.no_grad():
        flat = param.view(-1)
        flat[3] = float(flat[3]) + 1.0
    assert manager.save(3, state)
    assert inode(1) == inode(2) != inode(3)
    assert torch.equal(manager.model_state(3)[key], param)
    assert not torch.equal(manager.model_state(2)[key], param)
    resumed = CheckpointManager(directory, save_interval_steps=1)
    restored, step = resumed.maybe_restore(
        trainer.create_train_state(cfg, device='cpu', seed=1))
    assert step == 3 and torch.equal(restored.model.state_dict()[key],
                                     param)
    assert resumed.save(4, restored)
    assert inode(4) == inode(3)


def test_resume_with_other_lora_flags_is_refused(lora_run):
    args = _args(lora_run['root'], lora_run['ckpt'], 6)
    args[args.index('--lora-alpha') + 1] = '16'
    with pytest.raises(SystemExit, match='do not match the existing'):
        run.main(args)
    assert CheckpointManager(lora_run['ckpt']).all_steps() == [1, 2, 4]


def test_resume_is_bit_identical(lora_run, tmp_path):
    """A run cut after step 2 and resumed ends on the uninterrupted run's
    state, bit for bit (the SFT stream skips ahead by start_batch)."""
    ckpt = str(tmp_path / 'ckpt')
    assert run.main(_args(lora_run['root'], ckpt)) == 0
    shutil.rmtree(os.path.join(ckpt, '4'))        # cut after step 2
    history = []
    assert run.main(_args(lora_run['root'], ckpt), history=history) == 0
    assert [h['step'] for h in history] == [2, 3]
    want, got = _raw(lora_run['ckpt']), _raw(ckpt)
    for key, value in want['model'].items():
        assert torch.equal(got['model'][key], value), key
    for index, moments in want['optimizer']['state'].items():
        for name, value in moments.items():
            assert torch.equal(got['optimizer']['state'][index][name],
                               value), (index, name)
    assert got['count'] == want['count'] == 4


def test_lost_or_mismatched_sidecar_is_refused(lora_run, tmp_path):
    copy = str(tmp_path / 'ckpt')
    shutil.copytree(lora_run['ckpt'], copy)
    os.remove(os.path.join(copy, 'lora.json'))
    with pytest.raises(ValueError, match='LoRA adapters'):
        load_params_from_checkpoint(get_config('test-tiny'), copy)
    with open(os.path.join(copy, 'lora.json'), 'w', encoding='utf-8') as f:
        json.dump({**LORA, 'lora_targets': 'q,k,v'}, f)
    with pytest.raises(ValueError, match='not those of its lora.json'):
        load_params_from_checkpoint(get_config('test-tiny'), copy)


def test_init_from_hf_overlays_the_base_and_keeps_adapters(lora_run,
                                                           tmp_path):
    """The HF directory supplies the frozen base, the seeded init the
    adapters; with B = 0 the step-0 model's logits are the HF model's.
    The first update has lr 0, so the step-1 checkpoint holds the
    initial state. A resume does not read the HF directory again."""
    cfg = get_config('test-tiny', param_dtype='bfloat16')
    plain = Transformer(cfg, device='cpu').init_random_(7)
    hf = str(tmp_path / 'hf')
    convert.export_hf_checkpoint(plain.state_dict(), cfg, hf)
    ckpt = str(tmp_path / 'ckpt')
    args = _args(lora_run['root'], ckpt, 1, '--init-from-hf', hf)
    assert run.main(args) == 0
    state = _raw(ckpt, 1)['model']
    lora_cfg = dataclasses.replace(cfg, **LORA)
    seeded = Transformer(lora_cfg, device='cpu').init_random_(0)
    for key, value in seeded.state_dict().items():
        want = value if lora.is_adapter_key(key) else plain.state_dict()[key]
        assert torch.equal(state[key], want), key
    seeded.load_state_dict(state)
    tokens = torch.tensor(PROMPTS[1])[None]
    with torch.no_grad():
        assert torch.equal(seeded(tokens), plain(tokens))
    shutil.rmtree(hf)
    history, result = [], {}
    resume = _args(lora_run['root'], ckpt, 2, '--init-from-hf', hf)
    assert run.main(resume, history=history, result=result) == 0
    assert [h['step'] for h in history] == [1]
    live = result['state'].model.state_dict()     # the base after training
    for key, value in plain.state_dict().items():
        assert torch.equal(live[key], value), key


def test_export_hf_is_the_merged_checkpoint(lora_run):
    cfg = get_config('test-tiny')                     # bf16 serving
    merged = load_params_from_checkpoint(cfg, lora_run['ckpt'])
    exported = convert.load_hf_checkpoint(lora_run['export'], cfg)
    assert set(exported) == set(merged)
    for key, value in merged.items():
        assert torch.equal(exported[key], value), key
    raw = _raw(lora_run['ckpt'])['model']
    assert not torch.equal(merged['layers.0.attn.qkv_proj'],
                           raw['layers.0.attn.qkv_proj'])  # tuned
    assert torch.equal(merged['layers.0.attn.o_proj'],
                       raw['layers.0.attn.o_proj'])        # not a target
    with pytest.raises(ValueError, match='lora_a/lora_b'):
        convert.to_hf(raw, cfg)


def test_val_losses_are_the_reference_eval(lora_run):
    """The run's val losses are its eval step over the reference's
    validation batches (TokenDataset, seed data_seed + 1), bit for bit;
    on the same weights in fp32 that eval equals the JAX eval step."""
    jval = jdata.TokenDataset(os.path.join(lora_run['root'], 'val'), 4, 32,
                              seed=1, prefer_native=False)
    batches = [jval.next_batch() for _ in range(2)]
    raw = _raw(lora_run['ckpt'])['model']

    def port_eval(**kw):
        cfg = get_config('test-tiny', **{'param_dtype': 'bfloat16', **LORA,
                                         **kw})
        state = trainer.create_train_state(cfg, device='cpu')
        state.model.load_state_dict(raw)
        step = trainer.make_eval_step()
        total = None
        for b in batches:
            loss = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
            total = loss if total is None else total + loss
        return float(total) / len(batches)

    assert port_eval() == lora_run['history'][3]['val_loss']
    lora_cfg = get_config('test-tiny', **_FP32, **LORA)
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_FP32, **LORA)
    mesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    state, shardings = jtrainer.create_sharded_state(
        jcfg, mesh, jax.random.PRNGKey(0))
    params = jax.tree.map(jax.numpy.asarray,
                          convert.params_to_jax(raw, lora_cfg))
    step = jtrainer.make_eval_step(jcfg, mesh, shardings)
    with mesh:
        want = sum(float(step(state.replace(params=params), b))
                   for b in batches) / len(batches)
    np.testing.assert_allclose(port_eval(**_FP32), want, rtol=2e-5)


def test_export_tool_lora_flags(lora_run, tmp_path, capsys):
    base = ['--model', 'test-tiny', '--dtype', 'bfloat16']
    ckpt = lora_run['ckpt']
    assert export_tool.main(base + ['--checkpoint-dir', ckpt, '--out',
                                    str(tmp_path / 'a'), '--lora-alpha',
                                    '32']) == 1
    assert 'disagrees' in capsys.readouterr().err
    lost = str(tmp_path / 'lost')
    shutil.copytree(ckpt, lost)
    os.remove(os.path.join(lost, 'lora.json'))
    assert export_tool.main(base + ['--checkpoint-dir', lost, '--out',
                                    str(tmp_path / 'b'), '--lora-targets',
                                    'q,v']) == 1
    assert 'need --lora-rank' in capsys.readouterr().err
    want = convert.load_hf_checkpoint(lora_run['export'],
                                      get_config('test-tiny'))
    for directory, flags in ((ckpt, []), (lost, ['--lora-rank', '4',
                                                 '--lora-alpha', '8'])):
        out = str(tmp_path / f'out{len(flags)}')
        assert export_tool.main(base + ['--checkpoint-dir', directory,
                                        '--out', out, *flags]) == 0
        got = convert.load_hf_checkpoint(out, get_config('test-tiny'))
        for key, value in want.items():
            assert torch.equal(got[key], value), (directory, key)


def _engine_tokens(engine, adapter=None):
    try:
        futures = [engine.submit(p, max_new_tokens=MAX_NEW, adapter=adapter)
                   for p in PROMPTS]
        return [f.result(timeout=120)[0] for f in futures]
    finally:
        engine.stop()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_served_checkpoint_is_the_reference_engine_on_merged_params(
        lora_run):
    """`--checkpoint-dir <lora run>` serves the merged model: over HTTP
    the in-process engine's tokens (bf16); in fp32 the JAX engine's on
    the reference's merge of the same trained tree."""
    ckpt = lora_run['ckpt']
    server = InferenceServer('test-tiny', checkpoint_dir=ckpt, num_slots=2,
                             device='cpu')
    server.warmup()
    http = BackgroundServer(server)
    try:
        got = _post(http.url + '/generate', {'prompt_ids': PROMPTS,
                                             'max_new_tokens': MAX_NEW})
    finally:
        http.close()
        server.engine.stop()
    cfg = get_config('test-tiny')
    assert got['token_ids'] == _engine_tokens(ContinuousBatchingEngine(
        cfg, params=load_params_from_checkpoint(cfg, ckpt), num_slots=2,
        paged_block_size=16, device='cpu'))
    cfg32 = get_config('test-tiny', **_FP32)
    ours = _engine_tokens(ContinuousBatchingEngine(
        cfg32, params=load_params_from_checkpoint(cfg32, ckpt), num_slots=2,
        paged_block_size=16, device='cpu'))
    jlora_cfg = dataclasses.replace(jax_get_config('test-tiny'), **_FP32,
                                    **LORA)
    tree = convert.params_to_jax(_raw(ckpt)['model'],
                                 get_config('test-tiny', **_FP32, **LORA))
    merged = jlora.merge_lora(tree, jlora_cfg)
    jengine = JaxEngine(dataclasses.replace(jlora_cfg, lora_rank=0),
                        params=jax.tree.map(jax.numpy.asarray, merged),
                        num_slots=2, paged_block_size=16)
    assert ours == _engine_tokens(jengine)


def test_trained_adapter_served_as_tenant_is_the_reference_engine(
        lora_run, tmp_path):
    """The adapter pulled out of the checkpoint (params_to_jax, then
    adapter_tree_from_lora_params) goes through save_adapter_npz and
    POST /adapters/load; fp32 greedy tokens equal the JAX engine serving
    the same tree over the same base."""
    raw = _raw(lora_run['ckpt'])['model']
    lora_cfg = get_config('test-tiny', **_FP32, **LORA)
    tree = lora.adapter_tree(raw, lora_cfg)
    ref_tree = jtenancy.adapter_tree_from_lora_params(
        convert.params_to_jax(raw, lora_cfg))
    assert jax.tree.structure(tree) == jax.tree.structure(ref_tree)
    for got, want in zip(jax.tree.leaves(tree), jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(got, want)
    npz = str(tmp_path / 'ft.npz')
    tenancy.save_adapter_npz(tree, npz)
    cfg = get_config('test-tiny', **_FP32)
    base = {k: v.float() for k, v in raw.items()
            if not lora.is_adapter_key(k)}
    kw = dict(adapter_rank=4, adapter_alpha=8.0, adapter_targets='q,v')
    server = InferenceServer(cfg, params=base, num_slots=2, max_adapters=2,
                             device='cpu', **kw)
    server.warmup()
    http = BackgroundServer(server)
    try:
        assert _post(http.url + '/adapters/load',
                     {'name': 'ft', 'path': npz})['slot'] == 1
        got = _post(http.url + '/generate', {
            'prompt_ids': PROMPTS, 'max_new_tokens': MAX_NEW,
            'adapter': 'ft'})['token_ids']
    finally:
        http.close()
        server.engine.stop()
    jengine = JaxEngine(
        dataclasses.replace(jax_get_config('test-tiny'), **_FP32),
        params=jax.tree.map(jax.numpy.asarray,
                            convert.params_to_jax(base, cfg)),
        num_slots=2, paged_block_size=16, max_adapters=2, **kw)
    jengine.load_adapter('ft', jtenancy.load_adapter_npz(npz))
    assert got == _engine_tokens(jengine, adapter='ft')
    base_tokens = _engine_tokens(ContinuousBatchingEngine(
        cfg, params=base, num_slots=2, paged_block_size=16, device='cpu'))
    assert got != base_tokens                      # the adapter matters


def test_callbacks_summary_has_the_reference_contract(tmp_path):
    summaries = []
    for impl, name in ((callbacks, 'port'), (jcallbacks, 'ref')):
        cb = impl.BaseCallback(log_dir=str(tmp_path / name), total_steps=3)
        for _ in range(3):
            with cb.step():
                pass
        cb.close()
        with open(cb.summary_path, encoding='utf-8') as f:
            summaries.append(json.load(f))
    port, ref = summaries
    assert set(port) == set(ref)
    assert (port['total_steps'], port['num_steps']) == (3, 3)
    assert port['first_step_begin'] <= port['last_step_end']
    assert port['mean_step_seconds'] >= 0


def test_byte_tokenize_shards_equal_the_reference(tmp_path, capsys):
    corpus = tmp_path / 'corpus'
    corpus.mkdir()
    rng = np.random.RandomState(0)
    for i in range(5):
        (corpus / f'doc{i}.txt').write_text(
            ''.join(chr(c) for c in rng.randint(32, 127, 50 + 30 * i))
            + ' é', encoding='utf-8')
    outs = []
    for tool, name in ((tokenize_tool, 'port'), (jtokenize_tool, 'ref')):
        out = str(tmp_path / name)
        assert tool.main(['--input', str(corpus / '*.txt'), '--out', out,
                          '--shard-tokens', '128', '--val-fraction',
                          '0.5']) == 0
        outs.append(out)
    port = sorted(os.path.relpath(p, outs[0])
                  for p in glob.glob(outs[0] + '/**/*.bin', recursive=True))
    ref = sorted(os.path.relpath(p, outs[1])
                 for p in glob.glob(outs[1] + '/**/*.bin', recursive=True))
    assert port == ref and any(p.startswith('val') for p in port)
    for rel in port:
        a, b = (os.path.join(o, rel) for o in outs)
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read(), rel
        np.testing.assert_array_equal(jdata.read_token_shard(a),
                                      data.read_token_shard(b))
    capsys.readouterr()
    with pytest.raises(SystemExit, match='not ported'):
        tokenize_tool.main(['--input', str(corpus / '*.txt'), '--out',
                            str(tmp_path / 'hf'), '--tokenizer', 'hf:x'])
