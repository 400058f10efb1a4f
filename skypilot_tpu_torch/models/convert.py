"""Carry weights (or gradients) between the JAX reference and the port.

`params_from_jax(tree, cfg, device, dtype)` takes the reference's param
tree as nested dicts of numpy arrays (what `jax.device_get(params)`
gives) and returns a state dict for models/transformer.Transformer. Both
reference layouts are understood: scanned (`layers/layer/...` with a
leading layer axis, the default `scan_layers=True`) and unscanned
(`layer_{i}/...`). DenseGeneral kernels arrive as (d, H, D) for q/k/v and
(H, D, d) for o_proj; they flatten to the port's (in, out) matrices, with
q/k/v and gate/up concatenated along the output axis into the fused
projections. `params_to_jax(state, cfg)` is the inverse, into the scanned
layout. A gradient tree has the param tree's structure, so both
directions carry gradients too. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import check_supported, torch_dtype


def _layer_tree(tree: Mapping[str, Any], index: int) -> Dict[str, Any]:
    """Layer `index`'s sub-tree, sliced out of a scanned tree if needed."""
    if 'layers' in tree:
        def pick(node):
            if isinstance(node, Mapping):
                return {k: pick(v) for k, v in node.items()}
            return np.asarray(node)[index]
        return pick(tree['layers']['layer'])
    return tree[f'layer_{index}']


def _expect(arr, shape, what: str) -> np.ndarray:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f'{what}: expected shape {tuple(shape)}, got '
                         f'{tuple(arr.shape)}')
    return arr


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device='cpu', dtype: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """The reference's param tree → the port's state dict on `device`, in
    `dtype` (a torch dtype name; default cfg.dtype, what serving keeps;
    training passes cfg.param_dtype)."""
    check_supported(cfg)
    d, heads, kv_heads = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    head_dim, d_mlp, vocab = cfg.head_dim, cfg.d_mlp, cfg.vocab_size
    if 'layers' not in tree and f'layer_{cfg.num_layers - 1}' not in tree:
        raise ValueError('param tree has neither layers/layer (scanned) '
                         f'nor layer_0..layer_{cfg.num_layers - 1}')
    dtype = getattr(torch, dtype) if dtype else torch_dtype(cfg)

    def to_torch(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=dtype)

    state = {
        'embed': to_torch(_expect(tree['embed']['embedding'], (vocab, d),
                                  'embed')),
        'final_norm.weight': to_torch(_expect(tree['final_norm']['scale'],
                                              (d,), 'final_norm')),
        'lm_head': to_torch(_expect(tree['lm_head']['kernel'], (d, vocab),
                                    'lm_head')),
    }
    for i in range(cfg.num_layers):
        layer = _layer_tree(tree, i)
        attn, mlp = layer['attn'], layer['mlp']
        q = _expect(attn['q_proj']['kernel'], (d, heads, head_dim), 'q_proj')
        k = _expect(attn['k_proj']['kernel'], (d, kv_heads, head_dim),
                    'k_proj')
        v = _expect(attn['v_proj']['kernel'], (d, kv_heads, head_dim),
                    'v_proj')
        o = _expect(attn['o_proj']['kernel'], (heads, head_dim, d), 'o_proj')
        gate = _expect(mlp['gate_proj']['kernel'], (d, d_mlp), 'gate_proj')
        up = _expect(mlp['up_proj']['kernel'], (d, d_mlp), 'up_proj')
        down = _expect(mlp['down_proj']['kernel'], (d_mlp, d), 'down_proj')
        prefix = f'layers.{i}.'
        state.update({
            prefix + 'attn_norm.weight': to_torch(
                _expect(layer['attn_norm']['scale'], (d,), 'attn_norm')),
            prefix + 'attn.qkv_proj': to_torch(np.concatenate(
                [q.reshape(d, -1), k.reshape(d, -1), v.reshape(d, -1)],
                axis=1)),
            prefix + 'attn.o_proj': to_torch(o.reshape(heads * head_dim, d)),
            prefix + 'mlp_norm.weight': to_torch(
                _expect(layer['mlp_norm']['scale'], (d,), 'mlp_norm')),
            prefix + 'mlp.gate_up_proj': to_torch(
                np.concatenate([gate, up], axis=1)),
            prefix + 'mlp.down_proj': to_torch(down),
        })
    return state


def params_to_jax(state: Mapping[str, torch.Tensor],
                  cfg: ModelConfig) -> Dict[str, Any]:
    """The port's state dict (or a dict of its gradients) → the
    reference's scanned param tree, as nested dicts of float32 numpy
    arrays: the fused projections split back into q/k/v and gate/up
    kernels of the reference's shapes, layers stacked on a leading axis."""
    check_supported(cfg)
    d, heads, kv_heads = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    head_dim, d_mlp = cfg.head_dim, cfg.d_mlp

    def arr(name: str) -> np.ndarray:
        return state[name].detach().float().cpu().numpy()

    layers = []
    for i in range(cfg.num_layers):
        prefix = f'layers.{i}.'
        qkv = arr(prefix + 'attn.qkv_proj')
        q, k, v = np.split(qkv, [heads * head_dim,
                                 (heads + kv_heads) * head_dim], axis=1)
        gate, up = np.split(arr(prefix + 'mlp.gate_up_proj'), [d_mlp], axis=1)
        layers.append({
            'attn_norm': {'scale': arr(prefix + 'attn_norm.weight')},
            'attn': {
                'q_proj': {'kernel': q.reshape(d, heads, head_dim)},
                'k_proj': {'kernel': k.reshape(d, kv_heads, head_dim)},
                'v_proj': {'kernel': v.reshape(d, kv_heads, head_dim)},
                'o_proj': {'kernel': arr(prefix + 'attn.o_proj').reshape(
                    heads, head_dim, d)},
            },
            'mlp_norm': {'scale': arr(prefix + 'mlp_norm.weight')},
            'mlp': {
                'gate_proj': {'kernel': gate},
                'up_proj': {'kernel': up},
                'down_proj': {'kernel': arr(prefix + 'mlp.down_proj')},
            },
        })

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {key: stack([n[key] for n in nodes]) for key in nodes[0]}
        return np.stack(nodes)

    return {
        'embed': {'embedding': arr('embed')},
        'layers': {'layer': stack(layers)},
        'final_norm': {'scale': arr('final_norm.weight')},
        'lm_head': {'kernel': arr('lm_head')},
    }
