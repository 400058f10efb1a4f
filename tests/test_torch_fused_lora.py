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
from skypilot_tpu.models.transformer import Transformer as JaxTransformer
from skypilot_tpu.ops.fused_lora import (
    fused_multi_lora as jax_fused_multi_lora)
from skypilot_tpu.serve import tenancy as jax_tenancy
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import (adapter_from_jax,
                                               adapter_layout)
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
