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
directions carry gradients too. `adapter_from_jax(tree, cfg)` takes ONE
LoRA adapter in the reference's models/lora layout (what
serve/tenancy.adapter_tree_from_lora_params yields; scanned or unscanned)
and returns the port's per-layer, per-target (A, B) matrices. Nothing
here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import (check_supported,
                                                   lora_target_names,
                                                   torch_dtype)


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


_LORA_MODULE = {'q_proj': 'attn', 'k_proj': 'attn', 'v_proj': 'attn',
                'o_proj': 'attn', 'gate_proj': 'mlp', 'up_proj': 'mlp',
                'down_proj': 'mlp'}


def _lora_shapes(cfg: ModelConfig) -> Dict[str, Tuple[tuple, tuple]]:
    """One layer's (lora_a, lora_b) shapes per projection, in the
    reference's LoRADenseGeneral layout: the input axes then r, and r
    then the output axes (q/k/v keep (heads, head_dim), o_proj takes
    (heads, head_dim) in)."""
    d, heads, kv_heads = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd, f, r = cfg.head_dim, cfg.d_mlp, cfg.lora_rank
    return {'q_proj': ((d, r), (r, heads, hd)),
            'k_proj': ((d, r), (r, kv_heads, hd)),
            'v_proj': ((d, r), (r, kv_heads, hd)),
            'o_proj': ((heads, hd, r), (r, d)),
            'gate_proj': ((d, r), (r, f)), 'up_proj': ((d, r), (r, f)),
            'down_proj': ((f, r), (r, d))}


def adapter_layout(cfg: ModelConfig, scanned: bool = True) -> Dict[str, Any]:
    """The reference's adapter tree structure for `cfg`'s targets, with
    each leaf's expected shape (a leading num_layers axis when scanned)."""
    lead = (cfg.num_layers,) if scanned else ()
    layer: Dict[str, Any] = {}
    shapes = _lora_shapes(cfg)
    for name in lora_target_names(cfg):
        a, b = shapes[name]
        layer.setdefault(_LORA_MODULE[name], {})[name] = {
            'lora_a': lead + a, 'lora_b': lead + b}
    if scanned:
        return {'layers': {'layer': layer}}
    return {f'layer_{i}': layer for i in range(cfg.num_layers)}


def _match(layout: Mapping[str, Any], tree: Any, path: str) -> Dict:
    """`tree`'s leaves as float32 arrays where its structure and shapes
    equal `layout`'s; raises a KeyError naming the first structural
    difference, or ValueError on a shape."""
    if not isinstance(tree, Mapping):
        raise KeyError(f'{path or "tree"} is a leaf, expected keys '
                       f'{sorted(layout)}')
    if set(tree) != set(layout):
        raise KeyError(f'{path or "tree"} has keys {sorted(tree)}, '
                       f'expected {sorted(layout)}')
    out = {}
    for key, want in layout.items():
        where = f'{path}/{key}' if path else key
        if isinstance(want, Mapping):
            out[key] = _match(want, tree[key], where)
            continue
        arr = np.asarray(tree[key])
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f'adapter leaf shape {tuple(arr.shape)} != '
                             f'expected {tuple(want)}')
        out[key] = arr.astype(np.float32)
    return out


def adapter_from_jax(tree: Mapping[str, Any], cfg: ModelConfig
                     ) -> List[Dict[str, Tuple[np.ndarray, np.ndarray]]]:
    """One adapter tree in the reference's models/lora layout → per layer,
    {projection name: (A (in, r), B (r, out))} float32 arrays, the input
    and output axes flattened as the reference's fused path flattens them
    (q's B (r, H, D) → (r, H·D), o_proj's A (H, D, r) → (H·D, r)).

    The tree holds exactly cfg's targets (`lora_targets`, rank
    `lora_rank`), scanned (`layers/layer/...`, leading num_layers axis)
    or unscanned (`layer_{i}/...`). Raises ValueError with the
    reference's messages: a leaf of another shape, or another structure.
    """
    scanned = isinstance(tree, Mapping) and 'layers' in tree
    try:
        leaves = _match(adapter_layout(cfg, scanned), tree, '')
    except KeyError as e:
        raise ValueError(
            f'adapter tree does not match the model\'s adapter layout '
            f'(targets {cfg.lora_targets!r}, rank {cfg.lora_rank}): '
            f'{e.args[0]}') from e
    layers = []
    for i in range(cfg.num_layers):
        layer = (leaves['layers']['layer'] if scanned
                 else leaves[f'layer_{i}'])
        out = {}
        for module in layer.values():
            for name, ab in module.items():
                a, b = ab['lora_a'], ab['lora_b']
                if scanned:
                    a, b = a[i], b[i]
                rank = cfg.lora_rank
                out[name] = (a.reshape(-1, rank), b.reshape(rank, -1))
        layers.append(out)
    return layers
