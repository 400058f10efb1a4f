"""The port's training I/O: token shards and batches against the JAX
package's, checkpoints, and the train.run entry point (on the CPU).

Batches must be identical (integers); checkpoint resume must be bit for
bit on the CPU (the same fp32 ops in the same order).
"""
import os

import numpy as np
import pytest
import torch

from skypilot_tpu.train import data as jdata
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.train import data, run, trainer
from skypilot_tpu_torch.train.checkpoints import CheckpointManager


def _shards(tmp_path, writer, sizes=(700, 333, 1200), seed=0):
    rng = np.random.RandomState(seed)
    paths = []
    for i, n in enumerate(sizes):
        path = str(tmp_path / f'shard{i}.bin')
        vocab = 70000 if i == 1 else 500           # one uint32 shard
        writer(path, rng.randint(0, vocab, n))
        paths.append(path)
    return paths


@pytest.mark.parametrize('seed,start_batch,host_rank,num_hosts', [
    (0, 0, 0, 1), (5, 3, 0, 1), (11, 7, 1, 2), (2, 40, 2, 3)])
def test_batches_match_reference_numpy_loader(tmp_path, seed, start_batch,
                                              host_rank, num_hosts):
    paths = _shards(tmp_path, data.write_token_shard)
    ref = jdata.TokenDataset(paths, 4, 16, host_rank=host_rank,
                             num_hosts=num_hosts, seed=seed,
                             start_batch=start_batch, prefer_native=False)
    ours = data.TokenDataset(paths, 4, 16, host_rank=host_rank,
                             num_hosts=num_hosts, seed=seed,
                             start_batch=start_batch)
    assert ours.num_windows == ref.num_windows
    for _ in range(12):                    # several epochs at this size
        a, b = ours.next_batch(), ref.next_batch()
        for key in ('inputs', 'targets', 'mask'):
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype


def test_shards_cross_read(tmp_path):
    for writer, reader in ((data.write_token_shard,
                            jdata.read_token_shard),
                           (jdata.write_token_shard,
                            data.read_token_shard)):
        tokens = np.random.RandomState(1).randint(0, 2**17, 1000)
        path = str(tmp_path / 'x.bin')
        writer(path, tokens)
        np.testing.assert_array_equal(reader(path), tokens)
    with open(path, 'r+b') as f:
        f.truncate(100)
    with pytest.raises(ValueError, match='truncated'):
        data.read_token_shard(path)


_KW = dict(dtype='float32', param_dtype='float32', remat=False,
           attention_impl='pallas')


def _fresh_state():
    cfg = get_config('test-tiny', **_KW)
    tc = trainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                             total_steps=4, grad_clip_norm=0.5)
    return cfg, trainer.create_train_state(cfg, tc, device='cpu', seed=3)


def _steps(cfg, state, batches):
    step = trainer.make_train_step()
    return [float(step(state, b)['loss']) for b in batches]


def test_checkpoint_resume_is_bit_identical(tmp_path):
    gen = torch.Generator().manual_seed(0)
    batches = [trainer.synthetic_batch(gen, 2, 16, 512) for _ in range(4)]
    cfg, straight = _fresh_state()
    losses = _steps(cfg, straight, batches)

    cfg, first = _fresh_state()
    resumed_losses = _steps(cfg, first, batches[:2])
    manager = CheckpointManager(str(tmp_path), save_interval_steps=1)
    assert manager.save(2, first)
    cfg, second = _fresh_state()
    second, step = CheckpointManager(str(tmp_path)).maybe_restore(second)
    assert step == 2 and second.count == 2
    resumed_losses += _steps(cfg, second, batches[2:])
    assert resumed_losses == losses
    moments = [st['optimizer']['state'] for st in (straight.state_dict(),
                                                    second.state_dict())]
    assert len(moments[0]) == len(straight.params)
    for index, slots in moments[0].items():
        for key in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(slots[key], moments[1][index][key])
    for (name, a), b in zip(straight.model.state_dict().items(),
                            second.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_eval_step_is_the_train_loss_without_an_update():
    cfg, state = _fresh_state()
    batch = trainer.synthetic_batch(torch.Generator().manual_seed(1), 2, 16,
                                    512)
    before = [p.detach().clone() for p in state.params]
    loss = trainer.make_eval_step()(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(before, state.params))
    assert float(loss) == _steps(cfg, state, [batch])[0]


def test_checkpoint_policy_keep3_and_torn_saves(tmp_path):
    _, state = _fresh_state()
    manager = CheckpointManager(str(tmp_path), save_interval_steps=2)
    assert manager.save(1, state)           # the first save always happens
    assert not manager.save(3, state)       # off the interval
    for step in (2, 4, 6, 8):
        assert manager.save(step, state)
    assert not manager.save(8, state)       # not past the latest
    assert manager.save(9, state, force=True)
    assert manager.all_steps() == [6, 8, 9]  # keep 3
    # A save torn before its rename is never seen nor restored.
    torn = tmp_path / '.tmp-12-999'
    torn.mkdir()
    (torn / 'state.pt').write_bytes(b'garbage')
    (tmp_path / '13').mkdir()               # no state file: unpublished
    fresh = CheckpointManager(str(tmp_path))
    assert fresh.latest_step() == 9
    _, other = _fresh_state()
    _, step = fresh.maybe_restore(other)
    assert step == 9 and other.count == state.count


def test_run_main_trains_test_tiny_on_cpu_and_resumes(tmp_path):
    paths = _shards(tmp_path, data.write_token_shard, sizes=(2000,))
    args = ['--model', 'test-tiny', '--batch', '2', '--seq', '16',
            '--device', 'cpu', '--data-dir', os.path.dirname(paths[0]),
            '--checkpoint-dir', str(tmp_path / 'ckpt'),
            '--checkpoint-every', '2', '--warmup-steps', '1']
    history = []
    assert run.main(args + ['--steps', '2'], history=history) == 0
    assert [h['step'] for h in history] == [0, 1]
    assert all(np.isfinite(h['loss']) and np.isfinite(h['grad_norm'])
               for h in history)
    history = []
    assert run.main(args + ['--steps', '3'], history=history) == 0
    assert [h['step'] for h in history] == [2]   # resumed at step 2
    assert CheckpointManager(str(tmp_path / 'ckpt')).latest_step() == 3


def test_run_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        run.main(['--model', 'test-tiny', '--steps', '1'])
