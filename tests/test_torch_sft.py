"""The port's SftJsonlDataset against the reference's
(skypilot_tpu/train/data.py), and train.run's refusals around it.

Batches must be identical integers (the class is the reference's code,
pinned equal in test_torch_isolation.py): prompt + completion truncated
to seq + 1 and right-padded with pad_id, the mask 1 exactly on
completion targets, examples dealt round-robin to hosts, the affine walk
per epoch, and `start_batch` skipping ahead on resume.
"""
import json

import numpy as np
import pytest

from skypilot_tpu.train import data as jdata
from skypilot_tpu_torch.train import data, run


def _write(path, rows, blank_every=0):
    with open(path, 'w', encoding='utf-8') as f:
        for i, row in enumerate(rows):
            if blank_every and i % blank_every == 0:
                f.write('\n')                     # skipped, but numbered
            f.write(json.dumps(row) + '\n')
    return str(path)


def _rows(seed, n, max_prompt=20, max_completion=12, vocab=70000):
    """Prompts of 0..max_prompt ids (some rows all prompt once cut at
    seq + 1 = 17), completions of 1..max_completion."""
    rng = np.random.RandomState(seed)
    return [{'prompt': rng.randint(0, vocab,
                                   rng.randint(0, max_prompt + 1)).tolist(),
             'completion': rng.randint(
                 0, vocab, rng.randint(1, max_completion + 1)).tolist()}
            for _ in range(n)]


@pytest.mark.parametrize('seed,start_batch,host_rank,num_hosts,pad_id', [
    (0, 0, 0, 1, 0), (5, 3, 0, 1, 7), (11, 7, 1, 2, 0), (2, 40, 2, 3, 3)])
def test_batches_match_reference(tmp_path, seed, start_batch, host_rank,
                                 num_hosts, pad_id):
    path = _write(tmp_path / 'sft.jsonl', _rows(seed, 37), blank_every=5)
    kw = dict(host_rank=host_rank, num_hosts=num_hosts, seed=seed,
              start_batch=start_batch, pad_id=pad_id)
    ours = data.SftJsonlDataset(path, 4, 16, **kw)
    ref = jdata.SftJsonlDataset(path, 4, 16, **kw)
    assert ours.num_examples == ref.num_examples
    for _ in range(12):                       # several epochs
        a, b = ours.next_batch(), ref.next_batch()
        for key in ('inputs', 'targets', 'mask'):
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].dtype == b[key].dtype


def test_rows_truncate_pad_and_mask_completion_targets(tmp_path):
    path = _write(tmp_path / 'sft.jsonl', [
        {'prompt': [1, 2, 3], 'completion': [4, 5]},
        {'prompt': [11, 12, 13, 14, 15, 16], 'completion': list(range(
            20, 30))}])
    batch = data.SftJsonlDataset(path, 2, 8, pad_id=9).next_batch()
    rows = {tuple(r[:2]): i for i, r in enumerate(batch['inputs'])}
    short, long_ = rows[(1, 2)], rows[(11, 12)]
    np.testing.assert_array_equal(batch['inputs'][short],
                                  [1, 2, 3, 4, 5, 9, 9, 9])
    np.testing.assert_array_equal(batch['targets'][short],
                                  [2, 3, 4, 5, 9, 9, 9, 9])
    # Targets 4 and 5 (positions 2 and 3) are the completion's.
    np.testing.assert_array_equal(batch['mask'][short],
                                  [0, 0, 1, 1, 0, 0, 0, 0])
    # 16 tokens cut to the 9-token window: targets 20, 21, 22 train.
    np.testing.assert_array_equal(batch['targets'][long_],
                                  [12, 13, 14, 15, 16, 20, 21, 22])
    np.testing.assert_array_equal(batch['mask'][long_],
                                  [0, 0, 0, 0, 0, 1, 1, 1])


@pytest.mark.parametrize('impl', [data, jdata], ids=['port', 'reference'])
def test_refusals(tmp_path, impl):
    path = _write(tmp_path / 'empty.jsonl', [
        {'prompt': [1], 'completion': [2]}, {'prompt': [1],
                                             'completion': []}])
    with pytest.raises(ValueError, match=r'empty.jsonl:2: empty completion'):
        impl.SftJsonlDataset(path, 1, 8)
    path = _write(tmp_path / 'few.jsonl', _rows(0, 3))
    with pytest.raises(ValueError, match='fewer examples than batch size'):
        impl.SftJsonlDataset(path, 4, 8)


def test_run_refuses_sft_data_with_data_dir_and_lora_under_sp(tmp_path):
    base = ['--model', 'test-tiny', '--device', 'cpu', '--steps', '1']
    with pytest.raises(SystemExit, match='mutually exclusive'):
        run.main(base + ['--sft-data', 'x.jsonl', '--data-dir', 'd'])
    # LoRA under --sp trains, as in the reference (ring and adapters
    # compose; tests/test_torch_sp_compose.py holds the steps).
    history = []
    assert run.main(base + ['--lora-rank', '4', '--sp', '2', '--batch', '2',
                            '--seq', '32'], history=history) == 0
    assert len(history) == 1 and np.isfinite(history[0]['loss'])


def test_run_trains_lora_on_sft_batches(tmp_path):
    """--sft-data reaches the LoRA step: finite losses over completion
    targets (a batch with none would give 0)."""
    rows = _rows(3, 8, max_prompt=8, max_completion=20, vocab=512)
    path = _write(tmp_path / 'sft.jsonl', rows)
    history = []
    assert run.main(['--model', 'test-tiny', '--device', 'cpu', '--batch',
                     '4', '--seq', '16', '--steps', '3', '--warmup-steps',
                     '1', '--lora-rank', '4', '--sft-data', path,
                     '--log-every', '1'], history=history) == 0
    assert [h['step'] for h in history] == [0, 1, 2]
    assert all(np.isfinite(h['loss']) and h['loss'] > 0 for h in history)
