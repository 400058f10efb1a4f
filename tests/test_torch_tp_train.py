"""Tensor-parallel training on the port: `--tp` alone, tp beside fsdp
(the reference's `--tp N` layout), `--dp` x `--tp` with grad_accum and
ZeRO-1, and LoRA under tp, against the JAX package's single-device
train step.

- The step: tests/torch_tp_train_driver.py trains test-tiny (fp32, 4
  heads over 2 KV heads, so 2 / 1 a rank; clipping active) from the JAX
  init's weights on masked batches of B 8 x S 32, 3 steps at tp 2 (also
  under remat), fsdp 2 x tp 2, dp 2 x tp 2 (grad_accum 2, ZeRO-1), and
  LoRA on q,v and on all seven targets (also at fsdp 2 x tp 2), in gloo
  processes on the CPU: every step's loss and grad_norm, and the whole
  params after the last step, within 2e-5 of the JAX single-device
  `make_train_step`. At tp 1 no tp code runs: no tensor group, no
  tensor all-reduce, the collectives of the parent's formulas.
- The collectives over `tensor` of one step at L layers, A microbatches
  (`tensor_all_reduce`), a dense stack:
      A (4L + 5 + L remat)
  (forward: the embedding's g, o's and down's g a layer, three for the
  loss; backward: f before qkv and gate/up a layer and before lm_head;
  remat's recompute reruns o's g and stops before down's), LoRA on q,v or
  all seven targets A (4L + 4 + L remat) + 1 (layer 0's qkv input needs
  no gradient; the adapters' whole factors summed once); beside one
  all-reduce over the whole group for grad_norm and the data group's sum.
- The vocab-parallel cross-entropy against the whole-vocab one (value
  and gradient, with a mask and with a softcap), Megatron's f and g
  against autograd of the whole product, on an in-process group of
  threads.
- Checkpoints: saved at tp 2, on one rank and at dp 2 x tp 2 under
  ZeRO-1, restored at tp 1, tp 2, fsdp 2 x tp 2 and dp 2 x tp 2 under
  ZeRO-1, each holding the saved params bit for bit and continuing
  within 2e-5 of the unbroken run; a LoRA save at tp 2 restored on one
  rank.
- train.run: `--tp 2 --device cpu` spawned (its loss falls, its
  checkpoint and `--export-hf` hold the same whole params), its LoRA
  export equal to the tp 1 run's bit for bit, `--init-from-hf` placing
  each rank's shard, four processes joined by torchrun's variables with
  `--tp 2` train as fsdp 2 x tp 2, `infer_mesh_config` with tp the
  reference's, and the refusals that stay.
- Bytes: a tp 2 rank holds half the weights, an fsdp column beside tp 2
  moves half the bytes of fsdp 2 alone, and ZeRO-1 at dp 2 x tp 2 keeps
  a quarter of the optimizer state a rank.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.parallel import MeshConfig, build_mesh
from skypilot_tpu.parallel import mesh as jax_mesh
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.parallel import mesh, tensor
from skypilot_tpu_torch.train import run, trainer
from test_torch_dp import _masked_batches
from test_torch_train import _KW, _TC

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOL = 2e-5
_LORA = dict(lora_rank=4, lora_alpha=8.0, lora_targets='q,v')
_LORA_ALL = dict(_LORA, lora_targets='q,k,v,o,gate,up,down')
_WEIGHTS = {'plain': ('test-tiny', {}), 'lora': ('test-tiny', _LORA),
            'lora_all': ('test-tiny', _LORA_ALL)}
# The JAX runs by name: (weights, grad_accum).
_RUNS = {'plain': ('plain', 1), 'accum2': ('plain', 2), 'lora': ('lora', 1),
         'lora_all': ('lora_all', 1)}


def _jax_init(model, over):
    jcfg = dataclasses.replace(jax_get_config(model), **_KW, **over)
    jmesh = build_mesh(MeshConfig(dp=1), jax.devices()[:1])
    state, shardings = jtrainer.create_sharded_state(
        jcfg, jmesh, jax.random.PRNGKey(0), jtrainer.TrainConfig(**_TC))
    return jcfg, jmesh, state, shardings


def _jax_steps(init, batches, grad_accum):
    """((loss, grad_norm) of each step, the final params tree)."""
    jcfg, jmesh, state, shardings = init
    state = jax.tree.map(jnp.copy, state)
    step = jtrainer.make_train_step(jcfg, jmesh, shardings,
                                    grad_accum=grad_accum)
    metrics = []
    with jmesh:
        for batch in batches:
            state, m = step(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            metrics.append((float(m['loss']), float(m['grad_norm'])))
    return metrics, jax.device_get(state.params)


@pytest.fixture(scope='module')
def tp_row(tmp_path_factory):
    """(the JAX runs by name: series and final port-named params, the
    driver's row, the driver's directory). The driver trains from the JAX
    inits' weights while the JAX steps run here."""
    tmp = tmp_path_factory.mktemp('tp_train')
    batches = _masked_batches()
    inits, weights, configs, cfgs = {}, {}, {}, {}
    for name, (model, over) in _WEIGHTS.items():
        inits[name] = _jax_init(model, over)
        cfgs[name] = get_config(model, **_KW, **over)
        path = tmp / f'{name}.pt'
        torch.save(params_from_jax(jax.device_get(inits[name][2].params),
                                   cfgs[name], dtype='float32'), path)
        weights[name], configs[name] = str(path), (model, {**_KW, **over})
    np.savez(tmp / 'batches.npz', **{f'{k}{i}': v for i, b in
                                     enumerate(batches) for k, v in b.items()})
    os.makedirs(tmp / 'ckpt')
    spec = {'weights': weights, 'configs': configs, 'tc': _TC,
            'batches': str(tmp / 'batches.npz'), 'ckpt': str(tmp / 'ckpt')}
    proc = subprocess.Popen(
        [sys.executable, os.path.join(_REPO, 'tests',
                                      'torch_tp_train_driver.py'),
         json.dumps(spec)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=_REPO), cwd=_REPO)
    try:
        ref = {}
        for name, (weights_of, accum) in _RUNS.items():
            series, params = _jax_steps(inits[weights_of], batches, accum)
            ref[name] = (series, params_from_jax(params, cfgs[weights_of],
                                                 dtype='float32'))
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return ref, json.loads(out.strip().splitlines()[-1]), str(tmp / 'ckpt')


# Each case's JAX run.
_REFS = {'tp2': 'plain', 'tp2/remat': 'plain', 'fsdp2xtp2': 'plain',
         'dp2xtp2/accum2/zero1': 'accum2', 'tp2/lora': 'lora',
         'tp2/lora-all': 'lora_all', 'fsdp2xtp2/lora-all': 'lora_all',
         'dp2': 'plain', 'fsdp2': 'plain'}


@pytest.mark.parametrize('case', sorted(_REFS))
def test_tp_steps_match_the_jax_train_step(tp_row, case):
    ref, row, ckpt = tp_row
    ranks = row['steps'][case]
    series, params = ref[_REFS[case]]
    assert all(r['series'] == ranks[0]['series'] for r in ranks), \
        'ranks disagree'
    for i, ((loss, norm), (ref_loss, ref_norm)) in enumerate(
            zip(ranks[0]['series'], series)):
        assert norm > _TC['grad_clip_norm']              # clipping active
        np.testing.assert_allclose(loss, ref_loss, rtol=_TOL,
                                   err_msg=f'loss, step {i}')
        np.testing.assert_allclose(norm, ref_norm, rtol=_TOL,
                                   err_msg=f'grad_norm, step {i}')
    got = torch.load(os.path.join(ckpt, case.replace('/', '_') +
                                  '.params.pt'), weights_only=True)
    assert set(got) == set(params)
    for name, value in params.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   atol=_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize('case,accum,lora,zero1,fsdp,dp', [
    ('tp2', 1, False, False, 1, 1), ('tp2/remat', 1, False, False, 1, 1),
    ('fsdp2xtp2', 1, False, False, 2, 1),
    ('dp2xtp2/accum2/zero1', 2, False, True, 1, 2),
    ('tp2/lora', 1, True, False, 1, 1),
    ('tp2/lora-all', 1, True, False, 1, 1),
    ('fsdp2xtp2/lora-all', 1, True, False, 2, 1)])
def test_tensor_collectives_follow_the_formula(tp_row, case, accum, lora,
                                               zero1, fsdp, dp):
    ranks = tp_row[1]['steps'][case]
    probes = [r['probe'] for r in ranks]
    assert all(p == probes[0] for p in probes)            # every rank
    layers = ranks[0]['layers']
    remat = 1 if case.endswith('remat') else 0
    per = 4 * layers + (4 if lora else 5) + layers * remat
    want = accum * per + (1 if lora else 0)
    probe = probes[0]
    assert probe['tensor_all_reduce'] == want
    # Beside them: grad_norm's all-reduce over the whole group, and the
    # sum over the ranks that hold the same shards (dp: ZeRO-1's
    # partition scatter; fsdp: the data group's, after its gathers and
    # reduce-scatters).
    assert probe['all_reduce'] == want + 1 + (1 if fsdp > 1 else 0)
    assert probe['partition_scatter'] == (1 if zero1 else 0)
    assert probe['all_gather'] == (
        2 * layers + 2 if fsdp > 1 else 1 if zero1 else 0) * (
            accum if fsdp > 1 else 1)
    assert probe['reduce_scatter'] == (
        (layers if lora else layers + 2) if fsdp > 1 else 0)
    assert probe['collective_permute'] == 0
    assert all(r['tensor'] and r['tp_train'] for r in ranks)


def test_tp1_runs_no_tp_code(tp_row):
    """At tp 1 the step is the parent's: no tensor group, the model not in
    its tp mode, no tensor all-reduce, and the collectives of --dp's
    formula (one sum over the group)."""
    for rank in tp_row[1]['steps']['dp2']:
        assert not rank['tensor'] and not rank['tp_train']
        assert 'tensor_all_reduce' not in rank['probe']
        assert rank['probe']['all_reduce'] == 1
        assert rank['probe']['all_gather'] == 0


def test_each_tp_rank_holds_half_the_weights(tp_row):
    whole = tp_row[1]['steps']['dp2'][0]['param_bytes']
    for rank in tp_row[1]['steps']['tp2']:
        # The norms stay whole: a little over half.
        assert whole / 2 < rank['param_bytes'] <= (1 / 2 + 0.05) * whole
    for rank in tp_row[1]['steps']['fsdp2xtp2']:
        assert rank['param_bytes'] <= (1 / 4 + 0.02) * whole


def test_fsdp_moves_a_tp_shards_slices(tp_row):
    """Beside tp 2 an fsdp column gathers and reduce-scatters the slices
    of one tp shard: about half the bytes fsdp 2 alone moves (the norms,
    whole on tp, count on both)."""
    steps = tp_row[1]['steps']
    for kind in ('all_gather', 'reduce_scatter'):
        alone = steps['fsdp2'][0]['moved'][kind]
        for rank in steps['fsdp2xtp2']:
            assert 0.5 <= rank['moved'][kind] / alone <= 0.52, kind


def test_zero1_cuts_each_tp_shards_moments_over_dp(tp_row):
    """At dp 2 x tp 2 under ZeRO-1 a rank holds a quarter of the whole
    optimizer state (its dp slice of its tp shard's moments)."""
    for rank in tp_row[1]['steps']['dp2xtp2/accum2/zero1']:
        total, mine = rank['opt_bytes']
        assert total / 4 <= mine <= (1 / 4 + 0.02) * total


@pytest.mark.parametrize('saved,target', [
    (s, t) for s in ('tp2', 'one', 'dp2xtp2/zero1')
    for t in ('one', 'tp2', 'fsdp2xtp2', 'dp2xtp2/zero1')])
def test_checkpoints_restore_across_tp_extents(tp_row, saved, target):
    ckpt = tp_row[1]['ckpt']
    got = ckpt[f'{saved}->{target}']
    assert got['params_equal'] and got['count'] == 1
    unbroken = ckpt[f'{saved}/unbroken']
    if saved == target:
        assert got['series'] == unbroken                # the saved layout
    np.testing.assert_allclose(got['series'], unbroken, rtol=_TOL)


def test_a_tp_save_writes_one_directory_a_tp_index(tp_row):
    ckpt = tp_row[1]['ckpt']
    assert ckpt['tp2/files'] == ['state.pt', 'tp-0-of-2/state.pt',
                                 'tp-1-of-2/state.pt']
    assert ckpt['dp2xtp2/zero1/files'] == [
        'state.pt', 'tp-0-of-2/moments-0-of-2.pt',
        'tp-0-of-2/moments-1-of-2.pt', 'tp-0-of-2/state.pt',
        'tp-1-of-2/moments-0-of-2.pt', 'tp-1-of-2/moments-1-of-2.pt',
        'tp-1-of-2/state.pt']
    assert ckpt['one/files'] == ['state.pt']
    lora = ckpt['lora->one']
    assert lora['params_equal'] and lora['model_state_equal']
    assert lora['files'] == ['frozen.pt', 'state.pt']


# ------------------------------------------------- in-process tp regions

class _Threads:
    """An in-process stand-in for a tp group: `size` threads, each
    holding one `_Rank`, whose all_reduce meets the others' (the regions
    of parallel/tensor.py read only `rank` and `all_reduce`)."""

    def __init__(self, size):
        self.size, self.slots = size, [None] * size
        self.barrier = threading.Barrier(size)
        self.calls = 0

    def run(self, fn):
        """fn(rank) on every rank at once; their results in rank order."""
        out, errors = [None] * self.size, []

        def body(r):
            try:
                out[r] = fn(_Rank(self, r))
            except BaseException as e:  # pylint: disable=broad-except
                errors.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


class _Rank:

    def __init__(self, shared, rank):
        self.shared, self.rank, self.size = shared, rank, shared.size

    def all_reduce(self, x, kind='all_reduce', op='sum'):
        del kind
        self.shared.slots[self.rank] = x.clone()
        self.shared.barrier.wait()
        parts = torch.stack(self.shared.slots)
        total = parts.sum(0) if op == 'sum' else parts.amax(0)
        if self.rank == 0:
            self.shared.calls += 1
        self.shared.barrier.wait()
        x.copy_(total)
        return x


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('softcap', [0.0, 5.0])
@pytest.mark.parametrize('tp', [2, 4])
def test_vocab_parallel_cross_entropy_is_the_whole_vocab_one(tp, softcap,
                                                             masked):
    gen = torch.Generator().manual_seed(tp)
    vocab = 64
    logits = torch.randn(3, 5, vocab, generator=gen) * 4
    logits[..., 60:] = -1e30                    # the padded-vocab mask
    targets = torch.randint(0, 60, (3, 5), generator=gen)
    mask = (torch.rand(3, 5, generator=gen) > 0.3).float() if masked \
        else torch.ones(3, 5)
    weights = torch.randn(3, 5, generator=gen)

    def capped(x):
        return softcap * torch.tanh(x / softcap) if softcap else x

    whole = logits.clone().requires_grad_()
    losses, _ = trainer._token_losses(  # pylint: disable=protected-access
        capped(whole), targets, mask)
    (losses * mask * weights).sum().backward()
    width = vocab // tp
    group = _Threads(tp)

    def rank_fn(rank):
        part = logits[..., rank.rank * width:(rank.rank + 1) * width]
        part = part.clone().requires_grad_()
        got = tensor.vocab_parallel_cross_entropy(capped(part), targets,
                                                  rank)
        (got * mask * weights).sum().backward()
        return got.detach(), part.grad
    out = group.run(rank_fn)
    assert group.calls == 3                   # max, sum of exps, target
    for got, _ in out:
        np.testing.assert_allclose(got.numpy(), losses.detach().numpy(),
                                   atol=1e-6, rtol=1e-6)
    grad = torch.cat([g for _, g in out], dim=-1)
    np.testing.assert_allclose(grad.numpy(), whole.grad.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_f_and_g_give_the_whole_products_gradients():
    """y = g(silu(f(x) W1_r) W2_r) on every rank equals silu(x W1) W2, and
    the gradients of x, W1 and W2 are the whole product's (f sums x's
    over the ranks, g passes y's through)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, generator=gen, dtype=torch.float64)
    w1 = torch.randn(8, 12, generator=gen, dtype=torch.float64)
    w2 = torch.randn(12, 8, generator=gen, dtype=torch.float64)
    dy = torch.randn(4, 8, generator=gen, dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (x, w1, w2)]
    y = torch.nn.functional.silu(leaves[0] @ leaves[1]) @ leaves[2]
    y.backward(dy)
    group = _Threads(2)

    def rank_fn(rank):
        r = rank.rank
        mine = [x.clone().requires_grad_(),
                w1[:, 6 * r:6 * r + 6].clone().requires_grad_(),
                w2[6 * r:6 * r + 6].clone().requires_grad_()]
        out = tensor.reduce_from_tp(torch.nn.functional.silu(
            tensor.copy_to_tp(mine[0], rank) @ mine[1]) @ mine[2], rank)
        out.backward(dy)
        return out.detach(), [t.grad for t in mine]
    out = group.run(rank_fn)
    assert group.calls == 2                # g forward, f backward
    for got, grads in out:
        np.testing.assert_allclose(got.numpy(), y.detach().numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(grads[0].numpy(),
                                   leaves[0].grad.numpy(), rtol=1e-12)
    np.testing.assert_allclose(
        torch.cat([g[1][1] for g in out], dim=1).numpy(),
        leaves[1].grad.numpy(), rtol=1e-12)
    np.testing.assert_allclose(
        torch.cat([g[1][2] for g in out], dim=0).numpy(),
        leaves[2].grad.numpy(), rtol=1e-12)


def test_the_sharding_rules_name_the_whole_and_partial_leaves():
    from skypilot_tpu_torch.parallel import sharding
    whole = ['layers.0.attn_norm.weight', 'final_norm.weight', 'pos_embed',
             'layers.1.attn.o_proj_bias', 'layers.1.mlp.down_proj_bias',
             'layers.0.attn.q_proj_lora_a', 'layers.0.mlp.up_proj_lora_a',
             'layers.0.attn.o_proj_lora_b', 'layers.0.mlp.down_proj_lora_b']
    cut = ['embed', 'lm_head', 'lm_head_bias', 'layers.0.attn.qkv_proj',
           'layers.0.attn.qkv_proj_bias', 'layers.0.attn.o_proj',
           'layers.0.mlp.gate_up_proj', 'layers.0.mlp.down_proj',
           'layers.0.attn.q_proj_lora_b', 'layers.0.attn.o_proj_lora_a',
           'layers.0.mlp.down_proj_lora_a', 'layers.0.mlp.gate_proj_lora_b']
    assert all(sharding.tp_whole(n) for n in whole)
    assert not any(sharding.tp_whole(n) for n in cut)
    assert [n for n in whole + cut if sharding.tp_partial_grad(n)] == [
        n for n in whole if '_lora_' in n]
    # A shard and its inverse.
    cfg = get_config('test-tiny')
    value = torch.randn(64, 4 * 16 + 2 * 2 * 16)
    parts = [sharding.shard_tensor('layers.0.attn.qkv_proj', value, cfg, 2,
                                   r) for r in range(2)]
    assert torch.equal(sharding.unshard(parts, sharding.tp_layout(
        'layers.0.attn.qkv_proj', cfg)), value)


@pytest.mark.parametrize('n,axes', [
    (2, {'tp': 2}), (4, {'tp': 2}), (8, {'tp': 2, 'dp': 2}),
    (4, {'tp': 4}), (4, {'tp': 3}), (6, {'tp': 4}), (8, {'tp': 2, 'sp': 2}),
    (4, {'tp': 2, 'fsdp': 3}), (2, {'tp': 0}),
])
def test_infer_mesh_config_with_tp_is_the_references(n, axes):
    """tp joins the fixed axes; the remainder goes to fsdp, with the
    reference's sizes, layout string and messages."""
    try:
        want = jax_mesh.infer_mesh_config(n, **axes)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.infer_mesh_config(n, **axes)
        assert str(got.value) == str(e)
        return
    got = mesh.infer_mesh_config(n, **axes)
    assert (got.dp, got.fsdp, got.sp, got.tp) == (want.dp, want.fsdp,
                                                  want.sp, want.tp)
    assert str(got) == str(want)


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


def _one_batch(path):
    from skypilot_tpu_torch.train import data
    os.makedirs(path, exist_ok=True)
    data.write_token_shard(os.path.join(path, 'one_batch.bin'),
                           np.random.RandomState(0).randint(0, 512,
                                                            4 * 32 + 1))
    return str(path)


def _read_hf(path):
    from skypilot_tpu_torch.models import safetensors_file
    tensors = safetensors_file.CheckpointTensors(str(path))
    return {name: tensors[name].clone() for name in tensors}


def test_train_run_tp2_spawned_trains_checkpoints_and_exports(tmp_path):
    """`--tp 2 --device cpu` without torchrun: this process and one
    spawned rank; the loss falls on a repeated batch, the probe counts the
    tensor all-reduces, the checkpoint is one directory a tp index, and
    the export holds the checkpoint's whole params."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.train.checkpoints import CheckpointManager
    argv = ['--model', 'test-tiny', '--batch', '4', '--seq', '32',
            '--steps', '4', '--device', 'cpu', '--warmup-steps', '0',
            '--learning-rate', '1e-2', '--probe-hlo', '--tp', '2',
            '--data-dir', _one_batch(tmp_path / 'data'),
            '--checkpoint-dir', str(tmp_path / 'ckpt'),
            '--export-hf', str(tmp_path / 'hf')]
    history = []
    assert run.main(argv, history=history) == 0
    losses = [h['loss'] for h in history]
    assert losses[-1] < losses[0] - 0.1, losses
    layers = get_config('test-tiny').num_layers
    assert history[0]['step_collectives']['tensor_all_reduce'] == \
        4 * layers + 5
    assert sorted(os.listdir(tmp_path / 'ckpt' / '4')) == [
        'state.pt', 'tp-0-of-2', 'tp-1-of-2']
    saved = CheckpointManager(str(tmp_path / 'ckpt')).model_state(4)
    cfg = get_config('test-tiny', param_dtype='bfloat16')
    exported = convert.load_hf_checkpoint(str(tmp_path / 'hf'), cfg, 'cpu',
                                          dtype='bfloat16')
    assert set(exported) == set(saved)
    for name, value in saved.items():
        assert torch.equal(exported[name], value), name


def test_export_hf_from_tp2_is_the_tp1_export(tmp_path):
    """LoRA on all seven targets, one step (the first update has lr 0): the
    merged export of the tp 2 run equals the tp 1 run's tensor for
    tensor."""
    base = ['--model', 'test-tiny', '--batch', '4', '--seq', '32',
            '--steps', '1', '--device', 'cpu', '--lora-rank', '4',
            '--lora-targets', 'q,k,v,o,gate,up,down']
    assert run.main(base + ['--tp', '2', '--export-hf',
                            str(tmp_path / 'tp2')]) == 0
    assert run.main(base + ['--export-hf', str(tmp_path / 'tp1')]) == 0
    got, want = _read_hf(tmp_path / 'tp2'), _read_hf(tmp_path / 'tp1')
    assert set(got) == set(want) and want
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_init_from_hf_places_each_ranks_shard(tmp_path):
    """`--init-from-hf` under `--tp 2` with LoRA on all seven targets: each
    rank keeps its shard of the HF weights (the adapters their seeded
    init, B zero), so one step (lr 0 on the first update) exports the HF
    directory's tensors bit for bit."""
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models.transformer import Transformer
    cfg = get_config('test-tiny', param_dtype='bfloat16')
    model = Transformer(cfg, device='cpu').init_random_(1)
    convert.export_hf_checkpoint(model.state_dict(), cfg,
                                 str(tmp_path / 'hf'))
    assert run.main(['--model', 'test-tiny', '--batch', '4', '--seq', '32',
                     '--steps', '1', '--device', 'cpu', '--tp', '2',
                     '--lora-rank', '4', '--lora-targets',
                     'q,k,v,o,gate,up,down', '--init-from-hf',
                     str(tmp_path / 'hf'), '--export-hf',
                     str(tmp_path / 'out')]) == 0
    got, want = _read_hf(tmp_path / 'out'), _read_hf(tmp_path / 'hf')
    assert set(got) == set(want) and want
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_torchrun_tp2_on_four_processes_is_fsdp2_by_tp2(tmp_path):
    """The fine-tune recipe's fsdp x tp: four processes joined by
    torchrun's variables with --tp 2 train on fsdp 2 x tp 2, every rank
    reporting the same losses, one checkpoint directory a tp index."""
    argv = ['--model', 'test-tiny', '--batch', '4', '--seq', '32',
            '--steps', '2', '--device', 'cpu', '--warmup-steps', '1',
            '--learning-rate', '1e-3', '--probe-hlo', '--tp', '2',
            '--checkpoint-dir', str(tmp_path / 'ckpt')]
    assert run._job_mesh(run.build_parser().parse_args(argv), 4) == \
        mesh.MeshConfig(fsdp=2, tp=2)  # pylint: disable=protected-access
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS='1')
    port = _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, '-c', _RUN_WORKER, json.dumps(argv),
         str(tmp_path / f'rank{rank}.json')],
        env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE='4',
                 MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port)), cwd=_REPO)
        for rank in range(4)]
    for proc in ranks:
        assert proc.wait(timeout=180) == 0
    runs = [json.loads((tmp_path / f'rank{r}.json').read_text())
            for r in range(4)]
    assert all([h['loss'] for h in r] == [h['loss'] for h in runs[0]]
               for r in runs)
    assert all(np.isfinite(h['loss']) for h in runs[0])
    layers = get_config('test-tiny').num_layers
    probe = runs[0][0]['step_collectives']
    assert probe['all_gather'] == 2 * layers + 2
    assert probe['tensor_all_reduce'] == 4 * layers + 5
    top = tmp_path / 'ckpt' / '2'
    assert sorted(os.listdir(top)) == ['state.pt', 'tp-0-of-2', 'tp-1-of-2']
    assert sorted(os.listdir(top / 'tp-1-of-2')) == [
        'shard-0-of-2.pt', 'shard-1-of-2.pt', 'state.pt']


_BASE = ['--model', 'test-tiny', '--seq', '32', '--steps', '1', '--device',
         'cpu', '--batch', '4']


@pytest.mark.parametrize('extra,message', [
    (['--tp', '2', '--sp', '2'], 'item 6c-ii'),
    (['--tp', '2', '--model', 'test-tiny-moe'], 'item 6c-ii'),
    (['--tp', '2', '--dp', '2', '--elastic', '--checkpoint-dir', 'x'],
     '--elastic composes with dp/ZeRO-1 only'),
    (['--tp', '3'], 'tp=3 does not divide'),
    (['--tp', '0'], '--tp must be >= 1'),
], ids=['sp', 'moe', 'elastic', 'not-dividing', 'zero'])
def test_refusals_that_stay(extra, message):
    with pytest.raises(SystemExit, match=message):
        run.main(_BASE + extra)


def test_construction_refuses_moe_and_the_ring_under_tp():
    """The refusals hold at construction too, never mid-step: a MoE model
    on a training tp group, and a group whose tp runs beside an sp
    ring."""
    from skypilot_tpu_torch.models.transformer import Transformer
    with pytest.raises(NotImplementedError, match='item 6c-ii'):
        Transformer(get_config('test-tiny-moe'), device='cpu',
                    group=_Rank(_Threads(2), 0))
    group = mesh.TrainGroup(4, 0, torch.device('cpu'), sp=2, tp=2,
                            tensor=mesh.Group(2, 0, torch.device('cpu')))
    with pytest.raises(NotImplementedError, match='item 6c-ii'):
        trainer.create_train_state(get_config('test-tiny'), device='cpu',
                                   group=group)
