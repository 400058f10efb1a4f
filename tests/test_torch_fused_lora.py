"""The fused multi-LoRA delta (TPU kernel `_lora_kernel`) and the adapter
layout conversion, in the port against the JAX package.

- The plain `fused_multi_lora` (what the wrapper runs on a CPU tensor)
  against the reference's `fused_multi_lora(..., interpret=True)`, the
  TPU kernel under the Pallas interpreter, and against the reference's
  gather path (MultiLoRADenseGeneral, transformer.py:266-273: take A and
  B by id, two batched dot_generals) on seeded numpy inputs. fp32:
  within 1e-6 (the sums run in other orders); bf16: within 2e-2 absolute
  and relative (both round z to bf16 between the products, where an fp32
  sum in another order can flip one bf16 step, 2^-8 relative, and both
  round the output). Slot 0 gives an exactly zero delta.
- `LoRAGroup`, the model's call (the targets of one fused projection
  adding their scaled deltas into y's column slices): on the CPU equal
  bit for bit to the per-target composition it replaced (y[..., s] +=
  fused_multi_lora(...) * scale), for the model's groups under several
  target sets; against the reference's MultiLoRADenseGeneral output at
  the same tolerances as above (the reference's base output fed in as
  y); its refusals at construction; no kernel launch on the CPU.
- `adapter_from_jax` on scanned and unscanned reference trees, with the
  reference's error messages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu.models.transformer import (
    MultiLoRADenseGeneral as JaxMultiLoRADense)
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.ops.fused_lora import (
    fused_multi_lora as jax_fused_multi_lora)
from skypilot_tpu.serve import tenancy as jax_tenancy
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import (adapter_from_jax,
                                               adapter_layout)
from skypilot_tpu_torch.models.transformer import Transformer
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import fused_lora as fl

_TOL = {'float32': 1e-6, 'bfloat16': 2e-2}


def _case(batch, seq, d_in, d_out, rank, slots, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, seq, d_in).astype(np.float32)
    a = (rng.randn(slots, d_in, rank) / np.sqrt(d_in)).astype(np.float32)
    b = (rng.randn(slots, rank, d_out) * 0.25).astype(np.float32)
    a[0] = b[0] = 0.0
    ids = rng.randint(0, slots, batch).astype(np.int32)
    ids[0] = 0
    return x, a, b, ids


def _jax_gather_path(x, a, b, ids):
    a_sel = jnp.take(a, ids, axis=0)
    b_sel = jnp.take(b, ids, axis=0)
    z = jax.lax.dot_general(x, a_sel, (((2,), (1,)), ((0,), (0,))))
    return jax.lax.dot_general(z, b_sel, (((2,), (1,)), ((0,), (0,))))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('batch,seq,d_in,d_out,rank,slots', [
    (4, 1, 64, 48, 4, 3),       # decode rows, mixed slots
    (2, 5, 96, 130, 8, 4),
    (1, 16, 256, 64, 16, 5),    # a prefill chunk on one adapter
])
def test_plain_matches_reference_kernel_and_gather_path(
        dtype, batch, seq, d_in, d_out, rank, slots):
    x, a, b, ids = _case(batch, seq, d_in, d_out, rank, slots,
                         seed=d_in + rank)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(v, jdt) for v in (x, a, b)] + [jnp.asarray(ids)]
    kernel = np.asarray(jax_fused_multi_lora(*jargs, interpret=True),
                        np.float32)
    gather = np.asarray(_jax_gather_path(*jargs), np.float32)
    ours = fl.fused_multi_lora(*(torch.from_numpy(v).to(tdt)
                                 for v in (x, a, b)), torch.from_numpy(ids))
    assert ours.dtype == tdt and tuple(ours.shape) == kernel.shape
    ours = ours.float().numpy()
    tol = _TOL[dtype]
    np.testing.assert_allclose(ours, kernel, atol=tol, rtol=tol)
    np.testing.assert_allclose(ours, gather, atol=tol, rtol=tol)
    assert not ours[ids == 0].any()          # slot 0: exactly zero


def test_cpu_tensor_takes_plain_version_without_a_launch():
    x, a, b, ids = (torch.from_numpy(v) for v in _case(3, 2, 32, 24, 4, 3, 0))
    before = fl.fused_multi_lora.launches
    out = fl.fused_multi_lora(x, a, b, ids)
    assert fl.fused_multi_lora.launches == before
    torch.testing.assert_close(out, fl.fused_multi_lora_plain(x, a, b, ids),
                               atol=0, rtol=0)


def test_rejects_mismatched_shapes():
    x, a, b, ids = (torch.from_numpy(v) for v in _case(3, 2, 32, 24, 4, 3, 0))
    with pytest.raises(ValueError, match='do not fit'):
        fl.fused_multi_lora(x, a[:, :16], b, ids)
    with pytest.raises(ValueError, match=r'\(B,\)'):
        fl.fused_multi_lora(x, a, b, ids[:2])


# ------------------------------------------------------------- groups

# (group attribute of the layer's attn / mlp, projection names, widths).
def _model_groups(layer):
    attn, mlp = layer.attn, layer.mlp
    return ((attn.lora_qkv, attn.lora, ('q_proj', 'k_proj', 'v_proj'),
             attn.qkv_widths),
            (attn.lora_o, attn.lora, ('o_proj',), (attn.o_proj.shape[1],)),
            (mlp.lora_gate_up, mlp.lora, ('gate_proj', 'up_proj'),
             (mlp.d_mlp, mlp.d_mlp)),
            (mlp.lora_down, mlp.lora, ('down_proj',),
             (mlp.down_proj.shape[1],)))


def _per_target(y, x, stacks, names, widths, ids, scale):
    """The composition the groups replaced: each targeted projection's
    delta, scaled, added to its slice of y."""
    start = 0
    for name, width in zip(names, widths):
        if name in stacks:
            y[..., start:start + width] += \
                fl.fused_multi_lora(x, stacks[name].a, stacks[name].b,
                                    ids) * scale
        start += width
    return y


@pytest.mark.parametrize('targets', ['q,v', 'o', 'gate,up,down',
                                     'q,k,v,o,gate,up,down'])
def test_grouped_plain_equals_per_target_composition(targets):
    cfg = dataclasses.replace(
        get_config('test-tiny'), dtype='bfloat16', param_dtype='float32',
        max_seq_len=64, decode=True, paged_block_size=16, serve_adapters=3,
        lora_rank=8,
        lora_alpha=16.0, lora_targets=targets)
    layer = Transformer(cfg, device='cpu').layers[0]
    gen = torch.Generator().manual_seed(len(targets))
    for stack in [*layer.attn.lora.values(), *layer.mlp.lora.values()]:
        stack.a[1:] = torch.randn(stack.a[1:].shape, generator=gen) * 0.3
        stack.b[1:] = torch.randn(stack.b[1:].shape, generator=gen) * 0.3
    ids = torch.tensor([0, 1, 3, 2, 1], dtype=torch.int32)
    wanted = {f'{t}_proj' for t in targets.split(',')}
    seen = set()
    for group, stacks, names, widths in _model_groups(layer):
        named = wanted & set(names)
        assert (group is None) == (not named)
        if group is None:
            continue
        seen |= named
        x = torch.randn((5, 3, stacks[next(iter(named))].a.shape[1]),
                        generator=gen).bfloat16()
        y = torch.randn((5, 3, sum(widths)), generator=gen).bfloat16()
        ours = group(x, y.clone(), ids)
        theirs = _per_target(y.clone(), x, stacks, names, widths, ids,
                             cfg.lora_alpha / cfg.lora_rank)
        assert torch.equal(ours, theirs)
        assert not torch.equal(ours, y)
        assert torch.equal(ours[0], y[0])          # slot 0: y unchanged
    assert seen == wanted


def test_model_groups_follow_replaced_buffers():
    """`layer.float()` replaces every LoRAStack buffer: the model's group
    calls then read the new buffers (adapters written there count), not
    the ones the groups were built over."""
    cfg = dataclasses.replace(
        get_config('test-tiny'), dtype='bfloat16', param_dtype='float32',
        max_seq_len=64, decode=True, paged_block_size=16, serve_adapters=2,
        lora_rank=8, lora_alpha=16.0, lora_targets='q,k,v,o,gate,up,down')
    layer = Transformer(cfg, device='cpu').layers[0].float()
    gen = torch.Generator().manual_seed(7)
    for stack in [*layer.attn.lora.values(), *layer.mlp.lora.values()]:
        assert stack.a.dtype == torch.float32
        stack.a[1:] = torch.randn(stack.a[1:].shape, generator=gen) * 0.3
        stack.b[1:] = torch.randn(stack.b[1:].shape, generator=gen) * 0.3
    ids = torch.tensor([2, 0, 1], dtype=torch.int32)
    for group, stacks, names, widths in _model_groups(layer):
        x = torch.randn((3, 2, stacks[names[0]].a.shape[1]), generator=gen)
        y = torch.randn((3, 2, sum(widths)), generator=gen)
        ours = group(x, y.clone(), ids)
        theirs = _per_target(y.clone(), x, stacks, names, widths, ids,
                             cfg.lora_alpha / cfg.lora_rank)
        assert torch.equal(ours, theirs)
        assert not torch.equal(ours[0], y[0])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('targets', [
    ((64, 64), (64, 32), (64, 32)),   # q, k, v of one qkv output
    ((64, 128), (64, 128)),           # gate, up
    ((128, 64),),                     # down
])
def test_group_matches_reference_multi_lora_dense(dtype, targets):
    """Each target's slice of the group's y against the reference's
    MultiLoRADenseGeneral (gather path) on the same x, kernel, stacks and
    ids; y starts from the reference's base output (ids all 0). The
    tolerance is _TOL's on z times alpha / r, the factor that multiplies
    z and its rounding error into y."""
    rank, slots, alpha = 8, 4, 16.0
    jcfg = dataclasses.replace(
        jax_get_config('test-tiny'), dtype=dtype, param_dtype='float32',
        serve_adapters=slots - 1, lora_rank=rank, lora_alpha=alpha)
    rng = np.random.RandomState(len(targets))
    d_in = targets[0][0]
    x = rng.randn(3, 5, d_in).astype(np.float32)
    ids = np.asarray([0, 2, 3], np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    base, full, stacks = [], [], []
    for _, d_out in targets:
        w = (rng.randn(d_in, d_out) / np.sqrt(d_in)).astype(np.float32)
        a = (rng.randn(slots, d_in, rank) / np.sqrt(d_in)).astype(np.float32)
        b = (rng.randn(slots, rank, d_out) * 0.25).astype(np.float32)
        a[0] = b[0] = 0.0
        module = JaxMultiLoRADense(jcfg, features=d_out,
                                   kernel_axes=('embed', 'mlp'))
        variables = {'params': {'kernel': w},
                     'adapters': {'lora_a': a, 'lora_b': b}}
        xj = jnp.asarray(x, jdt)
        for out, aids in ((base, np.zeros(3, np.int32)), (full, ids)):
            out.append(np.asarray(module.apply(variables, xj,
                                               jnp.asarray(aids)),
                                  np.float32))
        stacks.append((torch.from_numpy(a).to(tdt),
                       torch.from_numpy(b).to(tdt)))
    offsets = [sum(d for _, d in targets[:i]) for i in range(len(targets))]
    group = fl.LoRAGroup(stacks, offsets, sum(d for _, d in targets),
                         alpha / rank)
    y = torch.from_numpy(np.concatenate(base, axis=-1)).to(tdt)
    ours = group(torch.from_numpy(x).to(tdt), y,
                 torch.from_numpy(ids)).float().numpy()
    tol = _TOL[dtype] * alpha / rank
    for off, (_, d_out), want in zip(offsets, targets, full):
        np.testing.assert_allclose(ours[..., off:off + d_out], want,
                                   atol=tol, rtol=tol)


def _stacks(slots=3, d_in=16, rank=8, outs=(24, 8), device='cpu'):
    return [(torch.zeros((slots, d_in, rank), device=device),
             torch.zeros((slots, rank, d_out), device=device))
            for d_out in outs]


@pytest.mark.parametrize('case,match', [
    ('slots', r'mismatched stacks: \(slots, IN\)'),
    ('b_rank', r'mismatched stacks \(3, 16, 8\) / \(3, 4, 8\)'),
    ('rank', r'mismatched stacks: rank 4 != target 0\'s 8'),
    ('kernel_rank', r'kernel takes rank in \(8, 16, 32, 64\), got 4'),
    ('overrun', r'target 1: columns \[24, 32\) overrun y width 30'),
    ('overlap', 'target slices overlap at column 16'),
    ('count', 'a LoRA group takes 1-3 targets'),
])
def test_group_construction_refuses(case, match):
    """Static faults fail at construction, each naming itself. The
    kernel's rank limit holds for stacks off the CPU (here 'meta': no
    data, no card); the CPU's plain version takes any rank."""
    stacks, offsets, width = _stacks(), [0, 24], 32
    if case == 'slots':
        stacks[1] = (stacks[1][0][:2], stacks[1][1][:2])
    elif case == 'b_rank':
        stacks[0] = (stacks[0][0], torch.zeros((3, 4, 8)))
    elif case == 'rank':
        stacks[1] = (stacks[1][0][..., :4].contiguous(),
                     stacks[1][1][:, :4].contiguous())
    elif case == 'kernel_rank':
        stacks = _stacks(rank=4, device='meta')
    elif case == 'overrun':
        width = 30
    elif case == 'overlap':
        offsets = [0, 16]
    elif case == 'count':
        stacks, offsets = stacks * 2, offsets * 2
    with pytest.raises(ValueError, match=match):
        fl.LoRAGroup(stacks, offsets, width, 1.0)
    if case == 'kernel_rank':      # the same stacks on the CPU are taken
        fl.LoRAGroup(_stacks(rank=4), offsets, width, 1.0)


def test_group_cpu_call_launches_nothing():
    stacks = [(torch.randn((3, 16, 8)), torch.randn((3, 8, 24)))]
    group = fl.LoRAGroup(stacks, [4], 32, 2.0)
    x, y = torch.randn((2, 3, 16)), torch.randn((2, 3, 32))
    ids = torch.tensor([2, 1], dtype=torch.int32)
    loaded = dict(_build._libs)  # pylint: disable=protected-access
    before = fl.fused_multi_lora.launches
    out = group(x, y.clone(), ids)
    assert fl.fused_multi_lora.launches == before
    assert _build._libs == loaded  # pylint: disable=protected-access
    want = y.clone()
    want[..., 4:28] += fl.fused_multi_lora_plain(x, *stacks[0], ids) * 2.0
    assert torch.equal(out, want)


# ------------------------------------------------------ adapter layout

_TARGETS = 'q,k,v,o,gate,up,down'


def _cfgs(scan_layers):
    kw = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
              remat=False, scan_layers=scan_layers, lora_rank=4,
              lora_alpha=8.0, lora_targets=_TARGETS)
    return (dataclasses.replace(jax_get_config('test-tiny'), **kw),
            dataclasses.replace(get_config('test-tiny'), **kw))


def _jax_adapter_tree(jcfg, seed=0):
    """One random adapter in the reference's layout: the lora leaves of
    a LoRA model's init, redrawn from numpy."""
    variables = nn.unbox(jax.eval_shape(lambda: JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))))
    tree = jax_tenancy.adapter_tree_from_lora_params(variables['params'])
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda leaf: rng.randn(*leaf.shape).astype(np.float32), tree)


@pytest.mark.parametrize('scan_layers', [True, False],
                         ids=['scanned', 'unscanned'])
def test_adapter_from_jax_flattens_the_reference_layout(scan_layers):
    jcfg, tcfg = _cfgs(scan_layers)
    tree = _jax_adapter_tree(jcfg)
    layers = adapter_from_jax(tree, tcfg)
    assert len(layers) == tcfg.num_layers
    d, hd, r = tcfg.d_model, tcfg.num_heads * tcfg.head_dim, tcfg.lora_rank
    kvd, f = tcfg.num_kv_heads * tcfg.head_dim, tcfg.d_mlp
    want = {'q_proj': (d, hd), 'k_proj': (d, kvd), 'v_proj': (d, kvd),
            'o_proj': (hd, d), 'gate_proj': (d, f), 'up_proj': (d, f),
            'down_proj': (f, d)}
    for i, layer in enumerate(layers):
        assert set(layer) == set(want)
        node = (tree['layers']['layer'] if scan_layers
                else tree[f'layer_{i}'])
        for name, (d_in, d_out) in want.items():
            a, b = layer[name]
            assert a.shape == (d_in, r) and b.shape == (r, d_out)
            leaf = node['attn' if name in ('q_proj', 'k_proj', 'v_proj',
                                            'o_proj') else 'mlp'][name]
            ref_a, ref_b = leaf['lora_a'], leaf['lora_b']
            if scan_layers:
                ref_a, ref_b = ref_a[i], ref_b[i]
            np.testing.assert_array_equal(a, ref_a.reshape(d_in, r))
            np.testing.assert_array_equal(b, ref_b.reshape(r, d_out))
    # The port's own layout description is the reference's structure.
    shapes = jax.tree.map(lambda leaf: tuple(leaf.shape), tree)
    assert shapes == adapter_layout(tcfg, scan_layers)


def test_adapter_from_jax_refusals_name_the_layout():
    jcfg, tcfg = _cfgs(True)
    tree = _jax_adapter_tree(jcfg)
    bad = jax.tree.map(lambda leaf: leaf, tree)
    bad['layers']['layer']['attn']['q_proj']['lora_a'] = np.zeros((2, 3))
    with pytest.raises(ValueError, match=r'adapter leaf shape \(2, 3\) != '
                                         r'expected \(2, 64, 4\)'):
        adapter_from_jax(bad, tcfg)
    del bad['layers']['layer']['mlp']
    with pytest.raises(ValueError, match="does not match the model's "
                                         "adapter layout"):
        adapter_from_jax(bad, tcfg)
    with pytest.raises(ValueError, match='adapter layout'):
        adapter_from_jax({'junk': np.zeros(3)}, tcfg)
