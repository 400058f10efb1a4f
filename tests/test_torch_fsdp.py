"""fsdp training on the port (the reference's default remainder axis,
ZeRO-3 style): the mesh, the rules table, the fsdp step against the JAX
package's single-device train step, its memory and collectives, its
checkpoints, and `train.run` under torchrun with no axis flag.

- parallel/mesh.py: `infer_mesh_config` against the reference's function
  (sizes and messages) over a table of cases.
- parallel/sharding.py: the fsdp rules table against the reference's
  `embed` declarations, leaf by leaf: a JAX init whose every leaf holds
  the index along its `embed` axis (-1 without one) is carried across
  with params_from_jax, and each port leaf's marked dimension must be
  `fsdp_dim`'s.
- The step: tests/torch_fsdp_driver.py trains test-tiny (fp32, clipping
  active) from the JAX init's weights on masked batches of B 8 x S 32, 3
  steps at fsdp 2 and 4, dp 2 x fsdp 2, grad_accum 2, ZeRO-1 at dp 2 x
  fsdp 2, remat, and LoRA, in gloo processes on the CPU: every step's
  loss and grad_norm within test_torch_train's 2e-5 relative of the JAX
  single-device `make_train_step`; step 0's loss bit-equal to `--dp` at
  the same extent (the forward runs on exact copies of the same weights
  over the same rows); a rank's params and AdamW state at most
  1/fsdp + 0.02 of the plain model's; the most gathered weight bytes
  alive at once at most one layer's plus the embedding's and the head's
  (less than the whole model); the collectives per step by the formula
  below. Then checkpoints: saved at fsdp 2 (and ZeRO-1 at dp 2 x fsdp 2),
  restored at fsdp 2, fsdp 4, dp 2 (ZeRO-1 or not), dp 2 x fsdp 2 and on
  one rank, each holding the saved params bit for bit and continuing
  within 2e-5 of the unbroken run (bit for bit at the saved extents); a
  torn shard file refused before the state changes.
- train.run: two processes joined by torchrun's variables with no axis
  flag train on fsdp 2 (LoRA, checkpoints, --export-hf from rank 0).

The collectives of one step at L layers, A microbatches (the forward
gathers the embedding, each layer and the head; each layer's backward
gathers it again, under remat in its recompute; each unit with trained
cut leaves reduce-scatters once a microbatch; the step sums over the dp
group (dp > 1) and over the fsdp group once):
    all_gather = A (2L + 2) (+ 1 under ZeRO-1: the updated slices)
    reduce_scatter = A (L + 2) (A L under LoRA: the adapters' units)
    all_reduce = 1 + (dp > 1) (the dp sum counts as partition_scatter
    under ZeRO-1)
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from skypilot_tpu.models import Transformer as JaxTransformer
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.parallel import mesh, sharding
from test_torch_dp import _masked_batches
from test_torch_train import _KW, _TC, _jax_run

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LORA = dict(lora_rank=4, lora_alpha=8.0, lora_targets='q,v')
_TOL = 2e-5


@pytest.mark.parametrize('n,axes', [
    (1, {}), (4, {}), (8, {'dp': 2}), (8, {'sp': 2}), (8, {'dp': 2, 'sp': 2}),
    (4, {'dp': 4}), (4, {'dp': 3}), (6, {'dp': 4}), (4, {'fsdp': 2}),
    (4, {'fsdp': 2, 'dp': 2}), (4, {'fsdp': 3}), (8, {'dp': 2, 'fsdp': 2}),
    (2, {'dp': 0}), (12, {'sp': 3, 'dp': 2}),
])
def test_infer_mesh_config_is_the_references(n, axes):
    try:
        want = jax_mesh.infer_mesh_config(n, **axes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.infer_mesh_config(n, **axes)
        assert str(got.value) == str(e)
        return
    got = mesh.infer_mesh_config(n, **axes)
    assert (got.dp, got.fsdp, got.sp) == (want.dp, want.fsdp, want.sp)
    assert (want.tp, want.pp, want.ep) == (1, 1, 1)
    assert str(got) == str(want)


def _embed_marks(jcfg):
    """The JAX init's params with every leaf holding the index along its
    logical `embed` axis (-1 where it has none)."""
    tokens = jnp.zeros((1, 8), jnp.int32)
    boxed = jax.eval_shape(lambda: JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), tokens))['params']
    specs = nn.get_partition_spec(boxed)
    shapes = nn.unbox(boxed)

    def mark(spec, shape):
        names = tuple(spec)
        if 'embed' not in names:
            return np.full(shape.shape, -1.0, np.float32)
        axis = names.index('embed')
        index = np.arange(shape.shape[axis], dtype=np.float32)
        view = [1] * len(shape.shape)
        view[axis] = -1
        return np.broadcast_to(index.reshape(view), shape.shape).copy()

    return jax.tree.map(mark, specs, shapes,
                        is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec))


@pytest.mark.parametrize('over', [
    {}, {'model': 'test-tiny-moe'}, _LORA,
    {**_LORA, 'lora_targets': 'q,k,v,o,gate,up,down'},
    {'norm_style': 'layernorm', 'norm_bias': True, 'qkv_bias': True,
     'o_bias': True, 'mlp_bias': True, 'mlp_style': 'plain',
     'mlp_activation': 'gelu', 'pos_embedding': 'learned',
     'lm_head_bias': True},
], ids=['dense', 'moe', 'lora-qv', 'lora-all', 'biases-learned-pos'])
def test_fsdp_rules_are_the_references_embed_axes(over):
    import dataclasses

    from skypilot_tpu.models.configs import get_config as jax_get_config
    over = dict(over)
    name = over.pop('model', 'test-tiny')
    kw = {**_KW, 'attention_impl': 'xla', 'scan_layers': False, **over}
    jcfg = dataclasses.replace(jax_get_config(name), **kw)
    cfg = get_config(name, **{k: v for k, v in kw.items()
                              if k != 'scan_layers'})
    port = params_from_jax(_embed_marks(jcfg), cfg, dtype='float32')
    for key, value in port.items():
        marked = [d for d in range(value.dim())
                  if value.shape[d] == cfg.d_model and torch.equal(
                      value, torch.arange(cfg.d_model, dtype=value.dtype)
                      .reshape([-1 if i == d else 1
                                for i in range(value.dim())])
                      .expand(value.shape))]
        if not marked:
            assert bool((value == -1).all()), key
        assert sharding.fsdp_dim(key) == (marked[0] if marked else None), key


def test_a_dimension_fsdp_does_not_divide_is_refused():
    with pytest.raises(ValueError, match='should be divisible by fsdp=3'):
        sharding.fsdp_shard('layers.0.attn.qkv_proj', torch.zeros(64, 8),
                            3, 0)


# ------------------------------------------------------------ the step


@pytest.fixture(scope='module')
def fsdp_row(tmp_path_factory):
    """(the JAX runs by name, the driver's row)."""
    tmp = tmp_path_factory.mktemp('fsdp')
    batches = _masked_batches()
    ref = {}
    params0, ref['plain'], _ = _jax_run(batches)
    _, ref['accum2'], _ = _jax_run(batches, 2)
    lora0, ref['lora'], _ = _jax_run(batches, **_LORA)
    cfg = get_config('test-tiny', **_KW)
    torch.save(params_from_jax(params0, cfg, dtype='float32'),
               tmp / 'params.pt')
    torch.save(params_from_jax(lora0, get_config('test-tiny', **_KW,
                                                 **_LORA), dtype='float32'),
               tmp / 'lora_params.pt')
    np.savez(tmp / 'batches.npz', **{f'{k}{i}': v for i, b in
                                     enumerate(batches) for k, v in b.items()})
    os.makedirs(tmp / 'ckpt')
    spec = {'cfg': _KW, 'tc': _TC, 'lora': _LORA,
            'params': str(tmp / 'params.pt'),
            'lora_params': str(tmp / 'lora_params.pt'),
            'batches': str(tmp / 'batches.npz'), 'ckpt': str(tmp / 'ckpt')}
    proc = subprocess.run(
        [sys.executable, os.path.join(_REPO, 'tests', 'torch_fsdp_driver.py'),
         json.dumps(spec)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=_REPO), cwd=_REPO, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ref, json.loads(proc.stdout.strip().splitlines()[-1])


_REFS = {'fsdp2': 'plain', 'fsdp4': 'plain', 'dp2xfsdp2': 'plain',
         'fsdp2/accum2': 'accum2', 'dp2xfsdp2/zero1': 'plain',
         'fsdp2/remat': 'plain', 'fsdp2/lora': 'lora'}


@pytest.mark.parametrize('case', sorted(_REFS))
def test_fsdp_steps_match_the_jax_train_step(fsdp_row, case):
    ref, row = fsdp_row
    ranks = row['steps'][case]
    series = ranks[0]['series']
    assert all(r['series'] == series for r in ranks), 'ranks disagree'
    for i, ((loss, norm), (ref_loss, ref_norm)) in enumerate(
            zip(series, ref[_REFS[case]])):
        assert norm > _TC['grad_clip_norm']              # clipping active
        np.testing.assert_allclose(loss, ref_loss, rtol=_TOL,
                                   err_msg=f'loss, step {i}')
        np.testing.assert_allclose(norm, ref_norm, rtol=_TOL,
                                   err_msg=f'grad_norm, step {i}')


@pytest.mark.parametrize('case,dp_case', [
    ('fsdp2', 'dp2'), ('fsdp4', 'dp4'), ('dp2xfsdp2', 'dp4'),
    ('fsdp2/remat', 'dp2'), ('fsdp2/lora', 'dp2/lora'),
    ('fsdp2/mixed', 'dp2/mixed')])
def test_step0_loss_is_the_dp_runs_bit_for_bit(fsdp_row, case, dp_case):
    steps = fsdp_row[1]['steps']
    assert steps[case][0]['series'][0][0] == \
        steps[dp_case][0]['series'][0][0]


def test_mixed_precision_saves_weight_casts_as_handles(fsdp_row):
    """fp32 params, bf16 compute, no remat: each layer's four products
    (qkv, o, gate_up, down) save their bf16 cast of the gathered weight,
    and every one is stored as a handle and re-made in the backward (3
    steps), so no layer's cast outlives its forward; the steps stay
    within a bf16 step of the --dp run."""
    steps = fsdp_row[1]['steps']
    for rank in steps['fsdp2/mixed']:
        assert rank['cast_handles'] == 3 * 4 * rank['layers']
        units = rank['unit_bytes']
        layer = max(v for k, v in units.items() if k.startswith('layers.'))
        assert rank['peak_gathered'] <= layer + units['embed'] + \
            units['head']
    np.testing.assert_allclose(steps['fsdp2/mixed'][0]['series'],
                               steps['dp2/mixed'][0]['series'], rtol=1e-2)


@pytest.mark.parametrize('case', ['fsdp2', 'fsdp4', 'dp2xfsdp2/zero1',
                                  'fsdp2/lora'])
def test_resident_bytes_and_gathered_bytes_a_rank(fsdp_row, case):
    fsdp = {'fsdp2': 2, 'fsdp4': 4, 'dp2xfsdp2/zero1': 2,
            'fsdp2/lora': 2}[case]
    steps = fsdp_row[1]['steps']
    plain = steps['dp2/lora' if 'lora' in case else 'dp2'][0]
    for rank in steps[case]:
        whole = rank['whole_param_bytes']
        assert whole == plain['param_bytes']
        assert rank['param_bytes'] <= (1 / fsdp + 0.02) * whole
        # The plain AdamW state (each leaf's moments whole), cut by fsdp
        # (and under ZeRO-1 by dp on top) where the rules cut the leaf;
        # a leaf with no embed axis (LoRA's B of q and v) keeps its whole
        # moments on every rank, as in the reference.
        extent = fsdp * (2 if 'zero1' in case else 1)
        cut, kept = rank['moment_split']
        assert rank['opt_bytes'][0] == plain['opt_bytes'][0]
        assert kept == 0 or 'lora' in case
        assert rank['opt_bytes'][1] <= cut / extent + kept + \
            0.02 * plain['opt_bytes'][0]
        units = rank['unit_bytes']
        layer = max(v for k, v in units.items() if k.startswith('layers.'))
        assert 0 < rank['peak_gathered'] <= layer + units['embed'] + \
            units['head'] < whole


@pytest.mark.parametrize('case,accum,dp,lora,zero1', [
    ('fsdp2', 1, 1, False, False), ('fsdp4', 1, 1, False, False),
    ('dp2xfsdp2', 1, 2, False, False), ('fsdp2/accum2', 2, 1, False, False),
    ('dp2xfsdp2/zero1', 1, 2, False, True), ('fsdp2/remat', 1, 1, False,
                                             False),
    ('fsdp2/lora', 1, 1, True, False)])
def test_collectives_follow_the_formula(fsdp_row, case, accum, dp, lora,
                                        zero1):
    for rank in fsdp_row[1]['steps'][case]:
        layers = rank['layers']
        assert rank['probe'] == {
            'all_gather': accum * (2 * layers + 2) + (1 if zero1 else 0),
            'reduce_scatter': accum * (layers + (0 if lora else 2)),
            'all_reduce': 1 + (dp > 1 and not zero1),
            'partition_scatter': 1 if zero1 else 0,
            'collective_permute': 0,
            'reduce_scatter_effective':
                accum * (layers + (0 if lora else 2)) + (1 if zero1 else 0)}


@pytest.mark.parametrize('saved,target', [
    (s, t) for s in ('fsdp2', 'zero1')
    for t in ('fsdp2', 'fsdp4', 'dp2', 'dp2/zero1', 'one',
              'dp2xfsdp2/zero1')])
def test_checkpoints_restore_across_extents(fsdp_row, saved, target):
    ckpt = fsdp_row[1]['ckpt']
    got = ckpt[f'{saved}->{target}']
    assert got['params_equal'] and got['count'] == 1
    unbroken = ckpt[f'{saved}/unbroken']
    if (saved, target) in (('fsdp2', 'fsdp2'), ('zero1', 'dp2xfsdp2/zero1')):
        assert got['series'] == unbroken            # the saved extents
    np.testing.assert_allclose(got['series'], unbroken, rtol=_TOL)


def test_checkpoint_files_and_torn_shard(fsdp_row):
    ckpt = fsdp_row[1]['ckpt']
    assert ckpt['fsdp2/files'] == ['shard-0-of-2.pt', 'shard-1-of-2.pt',
                                   'state.pt']
    assert ckpt['zero1/files'] == [
        'moments-0-of-4.pt', 'moments-1-of-4.pt', 'moments-2-of-4.pt',
        'moments-3-of-4.pt', 'shard-0-of-2.pt', 'shard-1-of-2.pt',
        'state.pt']
    assert ckpt['torn']['raises'] and ckpt['torn']['untouched']


# ------------------------------------------------------------ train.run

_RUN_WORKER = r'''
import json, sys
from skypilot_tpu_torch.train import run
history = []
assert run.main(json.loads(sys.argv[1]), history=history) == 0
with open(sys.argv[2], 'w') as f:
    json.dump(history, f)
'''


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_torchrun_without_an_axis_trains_on_fsdp(tmp_path):
    """Two processes joined by torchrun's variables, no axis flag: fsdp 2
    (the reference's remainder axis), LoRA on q,v over a base read from
    an HF directory (each rank keeps its slices; the base stays the
    file's bits), sharded checkpoints and the merged HF export written
    from rank 0."""
    from skypilot_tpu_torch.models import lora
    from skypilot_tpu_torch.models.convert import (export_hf_checkpoint,
                                                   load_hf_checkpoint)
    from skypilot_tpu_torch.models.transformer import Transformer
    from skypilot_tpu_torch.train.checkpoints import CheckpointManager
    base_cfg = get_config('test-tiny', param_dtype='bfloat16')
    export_hf_checkpoint(Transformer(base_cfg, device='cpu').init_random_(
        7).state_dict(), base_cfg, str(tmp_path / 'base'))
    argv = ['--model', 'test-tiny', '--batch', '4', '--seq', '32',
            '--steps', '2', '--device', 'cpu', '--warmup-steps', '1',
            '--learning-rate', '1e-3', '--probe-hlo', '--lora-rank', '4',
            '--init-from-hf', str(tmp_path / 'base'),
            '--checkpoint-dir', str(tmp_path / 'ckpt'), '--export-hf',
            str(tmp_path / 'hf')]
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS='1')
    port = _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, '-c', _RUN_WORKER, json.dumps(argv),
         str(tmp_path / f'rank{rank}.json')],
        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE='2',
                 MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port)), cwd=_REPO)
        for rank in range(2)]
    for proc in ranks:
        assert proc.wait(timeout=180) == 0
    runs = [json.loads((tmp_path / f'rank{r}.json').read_text())
            for r in range(2)]
    assert [h['loss'] for h in runs[0]] == [h['loss'] for h in runs[1]]
    layers = get_config('test-tiny').num_layers
    assert runs[0][0]['step_collectives'] == {
        'all_reduce': 1, 'all_gather': 2 * layers + 2,
        'reduce_scatter': layers, 'partition_scatter': 0,
        'collective_permute': 0, 'reduce_scatter_effective': layers}
    assert sorted(os.listdir(tmp_path / 'ckpt' / '2')) == [
        'frozen-0-of-2.pt', 'frozen-1-of-2.pt', 'shard-0-of-2.pt',
        'shard-1-of-2.pt', 'state.pt']
    cfg = get_config('test-tiny', param_dtype='bfloat16', lora_rank=4,
                     lora_alpha=16.0, lora_targets='q,v')
    whole = CheckpointManager(str(tmp_path / 'ckpt')).model_state(2)
    base = load_hf_checkpoint(str(tmp_path / 'base'), base_cfg,
                              dtype='bfloat16')
    for name, value in base.items():
        assert torch.equal(whole[name], value), name
    merged = lora.merge_lora(whole, cfg)
    exported = load_hf_checkpoint(str(tmp_path / 'hf'), cfg,
                                  dtype='bfloat16')
    assert set(exported) == set(merged)
    for name, value in merged.items():
        assert torch.equal(exported[name], value), name
