"""ZeRO-1 on the port (train/trainer.TrainState(zero1=True) over a
parallel/mesh.TrainGroup) held to the reference's promises
(tests/zero1_driver.py), whose own run fails on this JAX version
(`canonicalize_partition` TypeError).

Two layers:
- in-process: the port's moment-leaf rule (parallel/sharding
  zero_update_dim) against the reference's `zero_update_shardings` on the
  same shapes, for every trainable leaf of test-tiny, test-tiny with LoRA
  and llama3-1b (built on the meta device) at dp 2, 4 and 8, on the
  conftest's fake CPU devices; scalars, odd shapes and dp = 1;
- one run of tests/torch_dp_driver.py (gloo processes on the CPU,
  test-tiny in fp32, dp 4, clipping active): parity with ZeRO-1 on and off
  at grad_accum 1 and 2, moments born as slices, bytes per rank, the first
  step's collectives, LoRA moments for the adapters only, test-tiny-moe
  through the same step (grad_accum 2), checkpoints across dp extents and
  torn files, the gauges read by a late exporter.

Bit parity is exact (==); the byte bound is the reference's (1/dp + 0.05)
of the unsharded state's.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from skypilot_tpu.parallel import train_mesh, zero_update_shardings
from skypilot_tpu_torch.models import lora
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.parallel.sharding import zero_update_dim

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = {'cfg': {'dtype': 'float32', 'param_dtype': 'float32'},
         'tc': {'warmup_steps': 1, 'total_steps': 10, 'learning_rate': 3e-2,
                'grad_clip_norm': 0.5}}
DP = 4


def _reference_dim(shape, dp):
    """The dimension the reference's zero_update_shardings puts `dp` on
    for a leaf of `shape` replicated on a pure-dp mesh (None: stays
    replicated)."""
    mesh = train_mesh(dp)
    base = NamedSharding(mesh, PartitionSpec())
    out = zero_update_shardings(
        mesh, jax.ShapeDtypeStruct(tuple(shape), jax.numpy.float32), base)
    if out is base:
        return None
    return next(i for i, entry in enumerate(out.spec) if entry == 'dp')


@pytest.mark.parametrize('model,over', [
    ('test-tiny', {}), ('test-tiny', {'lora_rank': 4}), ('llama3-1b', {})],
    ids=['test-tiny', 'test-tiny-lora', 'llama3-1b'])
@pytest.mark.parametrize('dp', [2, 4, 8])
def test_leaf_rule_matches_the_reference(model, over, dp):
    cfg = get_config(model, **over)
    shapes = {n: tuple(p.shape) for n, p in
              Transformer(cfg, device='meta').named_parameters()
              if p.requires_grad}
    assert shapes
    for name, shape in shapes.items():
        assert zero_update_dim(shape, dp) == _reference_dim(shape, dp), name


def test_scalars_odd_shapes_and_dp1_stay_whole():
    for shape in [(), (3, 7), (5,)]:
        assert zero_update_dim(shape, 2) is None
        assert _reference_dim(shape, 2) is None
    assert zero_update_dim((64, 64), 1) is None
    # The first dimension dp divides, as the reference's.
    assert zero_update_dim((3, 64, 4), 8) == _reference_dim((3, 64, 4),
                                                            8) == 1


@pytest.fixture(scope='module')
def row():
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, 'tests', 'torch_dp_driver.py'),
         'zero1', json.dumps(_SPEC)], capture_output=True, text=True,
        timeout=240, env=env, cwd=_REPO, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize('accum', [1, 2])
def test_loss_and_grad_norm_bit_parity_with_clip_active(row, accum):
    plain, zero = row[f'series/{accum}/0'], row[f'series/{accum}/1']
    assert all(norm > _SPEC['tc']['grad_clip_norm'] for _, norm in plain)
    assert len(plain) == 3 and plain == zero


def test_moments_are_born_as_slices_by_the_rule(row):
    assert row['born_sliced']
    dims = row['dims']
    assert list(dims.values()) == row['rule_dims']
    assert sum(d is not None for d in dims.values()) == len(dims)
    for name, dim in dims.items():
        assert dim == _reference_dim(row['shapes'][name], DP), name


def test_per_rank_optimizer_bytes_bound(row):
    plain_total, plain_rank = row['bytes/0']
    zero_total, zero_rank = row['bytes/1']
    assert plain_total == plain_rank == zero_total
    assert zero_rank <= (1 / DP + 0.05) * plain_total


@pytest.mark.parametrize('accum', [1, 2])
def test_step_collectives(row, accum):
    """ZeRO-1 scatters the gradients (the all-reduce of the plain step,
    read as the rank's slices) and all-gathers the params; the plain step
    does neither; accumulation does not multiply them."""
    plain, zero = row[f'probe/{accum}/0'], row[f'probe/{accum}/1']
    assert plain == {'all_reduce': 1, 'all_gather': 0, 'reduce_scatter': 0,
                     'partition_scatter': 0, 'reduce_scatter_effective': 0}
    assert zero == {'all_reduce': 0, 'all_gather': 1, 'reduce_scatter': 0,
                    'partition_scatter': 1, 'reduce_scatter_effective': 1}


def test_lora_moments_are_the_adapters_only(row):
    cfg = get_config('test-tiny', lora_rank=4)
    assert row['lora_moment_names'] == row['lora_trained'] == sorted(
        lora.adapter_keys(cfg))
    assert row['lora/0'] == row['lora/1']


def test_moe_composes_through_the_same_step(row):
    plain, zero = row['moe/0'], row['moe/1']
    assert len(plain) == 2 and plain == zero
    assert all(np.isfinite(v) for step in plain for v in step)


def test_checkpoint_same_extent_restores_the_same_bits(row):
    assert row['same_dp_ranks'] == [True] * DP
    assert row['files'] == [f'moments-{r}-of-{DP}.pt'
                            for r in range(DP)] + ['state.pt']


def test_checkpoint_restores_across_extents(row):
    assert row['cross_dp_ranks'] == [True, True]
    total, per_rank = row['cross_dp_bytes']
    assert per_rank <= (1 / 2 + 0.05) * total
    assert row['unsharded']


@pytest.mark.parametrize('damage', ['truncated', 'missing'])
def test_torn_checkpoint_never_loads(row, damage):
    assert row[f'{damage}_raises'] in ('RuntimeError', 'FileNotFoundError')
    assert row[f'{damage}_untouched']


def test_late_exporter_reads_the_gauges(row):
    assert row['gauge_per_device'] == row['bytes/1'][1]
    assert row['gauge_rs_effective'] == 1.0
