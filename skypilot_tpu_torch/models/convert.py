"""Carry weights (or gradients) between the JAX reference and the port.

`params_from_jax(tree, cfg, device, dtype)` takes the reference's param
tree as nested dicts of numpy arrays (what `jax.device_get(params)`
gives) and returns a state dict for models/transformer.Transformer. Both
reference layouts are understood: scanned (`layers/layer/...` with a
leading layer axis, the default `scan_layers=True`) and unscanned
(`layer_{i}/...`). DenseGeneral kernels arrive as (d, H, D) for q/k/v and
(H, D, d) for o_proj; they flatten to the port's (in, out) matrices, with
q/k/v and gate/up concatenated along the output axis into the fused
projections; a MoE layer's `moe/{router,w_gate,w_up,w_down}` carry as
they are (`layers.{i}.moe.*`). `params_to_jax(state, cfg)` is the
inverse, into the scanned layout. A gradient tree has the param tree's
structure, so both directions carry gradients too, and both carry the
`lora_a` / `lora_b` leaves of a LoRA training tree (cfg.lora_rank > 0
without serve adapters): the reference's (in..., r) and (r, out...)
leaves of each targeted projection become the port's `<name>_lora_a`
(in, r) and `<name>_lora_b` (r, out) beside the fused projection, and
back. `adapter_from_jax(tree, cfg)` takes ONE LoRA adapter in the
reference's models/lora layout (what
serve/tenancy.adapter_tree_from_lora_params yields; scanned or unscanned)
and returns the port's per-layer, per-target (A, B) matrices.

HF checkpoints (the reference's models/convert.py, producing the port's
state dict directly): `from_hf(tensors, cfg, device, dtype)` maps an HF
state dict of the reference's families (Llama / Mistral / Qwen2 / Gemma,
Phi, Falcon's multi_query layout, GPT-2's Conv1D layout, Mixtral's
per-expert `block_sparse_moe` matrices, DBRX's fused Wqkv and its
(E·ffn, d) `ffn.experts.mlp` blocks) onto the port's names, zero-padding
vocab rows up to cfg.vocab_size and refusing a checkpoint with tensors
the architecture does not consume;
`load_hf_checkpoint(path, cfg, device, dtype)` reads a local directory
with models/safetensors_file, one tensor at a time onto `device` in the
serving dtype. `to_hf`, `hf_config_for` and `export_hf_checkpoint` are
the inverse: HF names, config.json and safetensors shards; a LoRA state is
merged first (models/lora.merge_lora), and adapters under a config
without LoRA are refused (the reference's export guard). Nothing here
imports JAX, `transformers` or `safetensors`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import json
import logging
import os

import numpy as np
import torch

from skypilot_tpu_torch.models import lora, safetensors_file
from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import (check_supported,
                                                   lora_target_names,
                                                   lora_training,
                                                   projection_shapes,
                                                   torch_dtype)

logger = logging.getLogger(__name__)


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


def _attn_heads(cfg: ModelConfig) -> Dict[str, int]:
    """Heads of each fused attention part, by reference module name."""
    return {'q_proj': cfg.num_heads, 'k_proj': cfg.num_kv_heads,
            'v_proj': cfg.num_kv_heads}


def _mlp_ins(cfg: ModelConfig) -> Tuple[str, ...]:
    return ('gate_proj', 'up_proj') if cfg.mlp_style == 'glu' else (
        'up_proj',)


def _moe_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """A MoE layer's parameters (the reference's names) → shapes."""
    e, d, m = cfg.num_experts, cfg.d_model, cfg.d_mlp
    return {'router': (d, e), 'w_gate': (e, d, m), 'w_up': (e, d, m),
            'w_down': (e, m, d)}


def _norm_from_jax(node, d: int, what: str, cfg: ModelConfig) -> dict:
    out = {'weight': _expect(node['scale'], (d,), what)}
    if cfg.norm_style == 'layernorm' and cfg.norm_bias:
        out['bias'] = _expect(node['bias'], (d,), what + ' bias')
    return out


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device='cpu', dtype: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """The reference's param tree → the port's state dict on `device`:
    float leaves in `dtype` (a torch dtype name; default cfg.dtype, what
    serving keeps; training passes cfg.param_dtype), under
    weight_quant='int8' each projection's `kernel_q` as int8 and its
    `kernel_scale` as fp32. Every family knob's parameters carry: norm
    biases, projection biases (concatenated like their kernels), the
    learned position table; a tied model has no lm_head. A LoRA training
    config takes each targeted projection's lora_a / lora_b (in `dtype`
    too); adapters under any other config are refused."""
    check_supported(cfg)
    d, heads, head_dim = cfg.d_model, cfg.num_heads, cfg.head_dim
    d_mlp, vocab = cfg.d_mlp, cfg.vocab_size
    int8 = cfg.weight_quant == 'int8'
    if 'layers' not in tree and f'layer_{cfg.num_layers - 1}' not in tree:
        raise ValueError('param tree has neither layers/layer (scanned) '
                         f'nor layer_0..layer_{cfg.num_layers - 1}')
    dtype = getattr(torch, dtype) if dtype else torch_dtype(cfg)

    def to_torch(arr: np.ndarray) -> torch.Tensor:
        arr = np.asarray(arr)
        if arr.dtype == np.int8:
            return torch.from_numpy(np.array(arr)).to(device=device)
        return torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=dtype)

    def scale_to_torch(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(arr, np.float32)).to(device=device)

    state: Dict[str, torch.Tensor] = {}
    targets = lora_target_names(cfg) if lora_training(cfg) else ()
    rank = cfg.lora_rank

    def put_adapter(module: str, name: str, node, in_dim: int, size: int):
        """Projection `name`'s lora_a / lora_b, when it is a target."""
        if name not in targets:
            if 'lora_a' in node or 'lora_b' in node:
                raise ValueError(
                    f'{name} holds lora_a/lora_b but the config does not '
                    f'train it (lora_rank {cfg.lora_rank}, targets '
                    f'{cfg.lora_targets!r}): pass the LoRA config, or '
                    f'merge_lora first')
            return
        for leaf, shape in (('lora_a', (in_dim, rank)),
                            ('lora_b', (rank, size))):
            arr = np.asarray(node[leaf])
            if arr.size != shape[0] * shape[1]:
                raise ValueError(f'{name} {leaf}: expected {shape}, got '
                                 f'{tuple(arr.shape)}')
            state[f'{module}.{name}_{leaf}'] = to_torch(arr.reshape(shape))

    def put_projection(key: str, nodes, in_dim: int, outs, what: str):
        """Projection `key` from the reference nodes (kernels of shape
        in_shape + out_shape each, flattened to (in_dim, out) and
        concatenated along the output axis), and their adapters."""
        flat_w, flat_s, flat_b = [], [], []
        for node, out_shape, name in zip(nodes, outs, what):
            put_adapter(key.rpartition('.')[0], name, node, in_dim,
                        int(np.prod(out_shape)))
            size = int(np.prod(out_shape))
            kernel = node['kernel_q'] if int8 else node['kernel']
            kernel = np.asarray(kernel)
            if kernel.size != in_dim * size:
                raise ValueError(f'{name}: expected {in_dim} x {out_shape}, '
                                 f'got {tuple(kernel.shape)}')
            flat_w.append(kernel.reshape(in_dim, size))
            if int8:
                flat_s.append(_expect(node['kernel_scale'], out_shape,
                                      name + ' scale').reshape(size))
            if 'bias' in node:
                flat_b.append(_expect(node['bias'], out_shape,
                                      name + ' bias').reshape(size))
        state[key] = to_torch(np.concatenate(flat_w, axis=1))
        if int8:
            state[key + '_scale'] = scale_to_torch(np.concatenate(flat_s))
        if flat_b:
            if len(flat_b) != len(nodes):
                raise ValueError(f'{what}: biases on only some projections')
            state[key + '_bias'] = to_torch(np.concatenate(flat_b))

    def put_norm(key: str, node, what: str):
        for name, arr in _norm_from_jax(node, d, what, cfg).items():
            state[f'{key}.{name}'] = to_torch(arr)

    state['embed'] = to_torch(_expect(tree['embed']['embedding'], (vocab, d),
                                      'embed'))
    if cfg.pos_embedding == 'learned':
        state['pos_embed'] = to_torch(_expect(
            tree['pos_embed']['embedding'], (cfg.max_seq_len, d),
            'pos_embed'))
    for i in range(cfg.num_layers):
        layer = _layer_tree(tree, i)
        attn = layer['attn']
        prefix = f'layers.{i}.'
        put_norm(prefix + 'attn_norm', layer['attn_norm'], 'attn_norm')
        parts = _attn_heads(cfg)
        put_projection(prefix + 'attn.qkv_proj',
                       [attn[name] for name in parts], d,
                       [(n, head_dim) for n in parts.values()], list(parts))
        put_projection(prefix + 'attn.o_proj', [attn['o_proj']],
                       heads * head_dim, [(d,)], ['o_proj'])
        if not cfg.parallel_block:
            put_norm(prefix + 'mlp_norm', layer['mlp_norm'], 'mlp_norm')
        if cfg.is_moe:
            for name, shape in _moe_shapes(cfg).items():
                state[prefix + 'moe.' + name] = to_torch(_expect(
                    layer['moe'][name], shape, 'moe ' + name))
            continue
        mlp = layer['mlp']
        ins = _mlp_ins(cfg)
        put_projection(prefix + ('mlp.gate_up_proj' if len(ins) == 2
                                 else 'mlp.up_proj'),
                       [mlp[name] for name in ins], d,
                       [(d_mlp,)] * len(ins), list(ins))
        put_projection(prefix + 'mlp.down_proj', [mlp['down_proj']], d_mlp,
                       [(d,)], ['down_proj'])
    put_norm('final_norm', tree['final_norm'], 'final_norm')
    if not cfg.tie_embeddings:
        put_projection('lm_head', [tree['lm_head']], d, [(vocab,)],
                       ['lm_head'])
    return state


def params_to_jax(state: Mapping[str, torch.Tensor],
                  cfg: ModelConfig) -> Dict[str, Any]:
    """The port's state dict (or a dict of its gradients) → the
    reference's scanned param tree, as nested dicts of numpy arrays
    (float32; int8 `kernel_q` under int8 weights): the fused projections
    split back into the reference's q/k/v and gate/up kernels, biases and
    scales of the reference's shapes, a LoRA state's adapters as each
    projection's lora_a / lora_b, layers stacked on a leading axis."""
    check_supported(cfg)
    d, head_dim, d_mlp = cfg.d_model, cfg.head_dim, cfg.d_mlp
    int8 = cfg.weight_quant == 'int8'

    def arr(name: str) -> np.ndarray:
        t = state[name].detach().cpu()
        return t.numpy() if t.dtype == torch.int8 else t.float().numpy()

    def projection(key: str, in_shape, outs, names) -> list:
        """The reference nodes of fused projection `key`, whose parts
        are the projections `names`."""
        w = arr(key)
        cuts = np.cumsum([int(np.prod(o)) for o in outs])[:-1]
        ws = np.split(w, cuts, axis=1)
        ss = np.split(arr(key + '_scale'), cuts) if int8 else [None] * len(
            outs)
        bs = (np.split(arr(key + '_bias'), cuts) if key + '_bias' in state
              else [None] * len(outs))
        nodes = []
        module = key.rpartition('.')[0]
        for w_part, s_part, b_part, out, name in zip(ws, ss, bs, outs,
                                                     names):
            node = ({'kernel_q': w_part.reshape(in_shape + out),
                     'kernel_scale': s_part.reshape(out)} if int8
                    else {'kernel': w_part.reshape(in_shape + out)})
            if b_part is not None:
                node['bias'] = b_part.reshape(out)
            adapter = f'{module}.{name}_lora_'
            if adapter + 'a' in state:
                node['lora_a'] = arr(adapter + 'a').reshape(in_shape + (-1,))
                node['lora_b'] = arr(adapter + 'b').reshape((-1,) + out)
            nodes.append(node)
        return nodes

    def norm(key: str) -> dict:
        node = {'scale': arr(key + '.weight')}
        if key + '.bias' in state:
            node['bias'] = arr(key + '.bias')
        return node

    layers = []
    for i in range(cfg.num_layers):
        prefix = f'layers.{i}.'
        parts = _attn_heads(cfg)
        qkv = projection(prefix + 'attn.qkv_proj', (d,),
                         [(n, head_dim) for n in parts.values()],
                         list(parts))
        (o,) = projection(prefix + 'attn.o_proj',
                          (cfg.num_heads, head_dim), [(d,)], ['o_proj'])
        layer = {'attn_norm': norm(prefix + 'attn_norm'),
                 'attn': {**dict(zip(parts, qkv)), 'o_proj': o}}
        if cfg.is_moe:
            layer['moe'] = {name: arr(prefix + 'moe.' + name)
                            for name in _moe_shapes(cfg)}
        else:
            ins = _mlp_ins(cfg)
            ups = projection(prefix + ('mlp.gate_up_proj' if len(ins) == 2
                                       else 'mlp.up_proj'), (d,),
                             [(d_mlp,)] * len(ins), list(ins))
            (down,) = projection(prefix + 'mlp.down_proj', (d_mlp,), [(d,)],
                                 ['down_proj'])
            layer['mlp'] = {**dict(zip(ins, ups)), 'down_proj': down}
        if not cfg.parallel_block:
            layer['mlp_norm'] = norm(prefix + 'mlp_norm')
        layers.append(layer)

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {key: stack([n[key] for n in nodes]) for key in nodes[0]}
        return np.stack(nodes)

    tree = {
        'embed': {'embedding': arr('embed')},
        'layers': {'layer': stack(layers)},
        'final_norm': norm('final_norm'),
    }
    if cfg.pos_embedding == 'learned':
        tree['pos_embed'] = {'embedding': arr('pos_embed')}
    if not cfg.tie_embeddings:
        (tree['lm_head'],) = projection('lm_head', (d,), [(cfg.vocab_size,)],
                                        ['lm_head'])
    return tree


def _adapter_shapes(cfg: ModelConfig) -> Dict[str, Tuple[tuple, tuple]]:
    """One layer's (lora_a, lora_b) shapes per projection the model has
    (transformer.projection_shapes), in the reference's LoRADenseGeneral
    layout: the input axes then r, and r then the output axes (q/k/v keep
    (heads, head_dim) out, o_proj takes (heads, head_dim) in)."""
    r, hd = cfg.lora_rank, cfg.head_dim
    heads = _attn_heads(cfg)
    shapes = {}
    for name, (n_in, n_out) in projection_shapes(cfg).items():
        a_in = (cfg.num_heads, hd) if name == 'o_proj' else (n_in,)
        b_out = (heads[name], hd) if name in heads else (n_out,)
        shapes[name] = (a_in + (r,), (r,) + b_out)
    return shapes


def adapter_layout(cfg: ModelConfig, scanned: bool = True) -> Dict[str, Any]:
    """The reference's adapter tree structure for `cfg`'s targets, with
    each leaf's expected shape (a leading num_layers axis when scanned)."""
    lead = (cfg.num_layers,) if scanned else ()
    layer: Dict[str, Any] = {}
    shapes = _adapter_shapes(cfg)
    for name in lora_target_names(cfg):
        if name not in shapes:
            continue                      # gate on a plain MLP: no module
        a, b = shapes[name]
        layer.setdefault(lora.projection_module(cfg, name), {})[name] = {
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


# ------------------------------------------------------------ HF checkpoints

# Non-weight buffers HF state dicts carry that have no place in the
# port's state: rotary caches and GPT-2's causal-mask buffers.
_IGNORABLE = ('rotary_emb.inv_freq', '.attn.bias', '.attn.masked_bias')


class _Tracked:
    """Records which keys were read, so from_hf can prove it consumed
    every weight (an incompatible checkpoint fails loudly instead of
    dropping tensors)."""

    def __init__(self, tensors: Mapping[str, torch.Tensor]) -> None:
        self.tensors = tensors
        self.used = set()

    def __getitem__(self, key: str) -> torch.Tensor:
        self.used.add(key)
        return self.tensors[key]


def _pad_vocab(w: torch.Tensor, vocab: int) -> torch.Tensor:
    """Zero-pad embedding / unembedding rows (or a bias) up to vocab."""
    if w.shape[0] == vocab:
        return w
    if w.shape[0] > vocab:
        raise ValueError(f'checkpoint vocab {w.shape[0]} exceeds config '
                         f'vocab {vocab}')
    return torch.cat([w, w.new_zeros((vocab - w.shape[0],) + w.shape[1:])])


class _HFLayout(NamedTuple):
    """One family's HF layout, read forwards by from_hf and backwards by
    to_hf. `entries` are one layer's (port key, HF keys, transposed,
    widths, experts): several HF keys are the parts the port concatenates
    along its last axis, `widths` wide; transposed marks torch Linear
    weights, stored (out, in), the port's transpose (of each expert's
    matrix, for an expert stack). `experts` names how a MoE layer's
    (E, a, b) stack is stored: 'list', one HF key per expert (Mixtral),
    or 'block', one (E·rows, cols) HF tensor (DBRX); None for the rest."""
    embed: str                 # embedding key
    final: str                 # final norm module
    layer: str                 # layer prefix, '{}' the index
    entries: Tuple[Tuple[str, Tuple[str, ...], bool, Optional[tuple],
                         Optional[str]], ...]


def _hf_family(cfg: ModelConfig) -> str:
    """cfg's HF family, from the flags the forward pass branches on:
    'dbrx' (MoE with LayerNorm), 'mixtral' (MoE), 'phi' (a biased
    parallel block), 'falcon' (falcon-7b's multi_query parallel block),
    'gpt2' (learned positions, Conv1D) or 'llama' (Llama, Mistral, Qwen2,
    Gemma). Refuses the layouts no family maps."""
    if cfg.is_moe:
        return 'dbrx' if cfg.norm_style == 'layernorm' else 'mixtral'
    if cfg.parallel_block and cfg.qkv_bias:
        if (cfg.mlp_style != 'plain' or cfg.mlp_activation != 'gelu'
                or cfg.tie_embeddings):
            raise NotImplementedError(
                'a biased parallel_block maps the Phi layout only (plain '
                'GELU MLP, untied lm_head)')
        return 'phi'
    if cfg.parallel_block:
        if (cfg.num_kv_heads != 1 or cfg.mlp_style != 'plain'
                or cfg.o_bias or cfg.mlp_bias):
            raise NotImplementedError(
                'Falcon conversion supports the multi_query layout '
                '(num_kv_heads=1, falcon-7b: plain bias-free MLP); the 40B '
                'new_decoder_architecture interleaves KV per head group')
        return 'falcon'
    if cfg.pos_embedding == 'learned' and cfg.mlp_style == 'plain':
        return 'gpt2'
    return 'llama'


def _hf_layout(cfg: ModelConfig) -> _HFLayout:
    """cfg's family's HF names, one table for both directions."""
    family = _hf_family(cfg)
    attn = tuple(f'self_attn.{n}_proj' for n in 'qkv')
    experts = []
    if family == 'dbrx':
        # Wqkv rows are [q (H D), k (KV D), v (KV D)], the port's fused
        # order; each expert matrix is an (ffn, d) row block, applied as
        # x·w1ᵀ (gate), x·v1ᵀ (up) and h·w2 (down).
        top = ('transformer.wte.weight', 'transformer.norm_f',
               'transformer.blocks.{}.')
        norms = {'attn_norm': 'norm_attn_norm.norm_1',
                 'mlp_norm': 'norm_attn_norm.norm_2'}
        projs = {'attn.qkv_proj': ('norm_attn_norm.attn.Wqkv',),
                 'attn.o_proj': ('norm_attn_norm.attn.out_proj',)}
        mlp = 'ffn.experts.mlp.'
        experts = [('moe.router', ('ffn.router.layer.weight',), True, None,
                    None),
                   ('moe.w_gate', (mlp + 'w1',), True, None, 'block'),
                   ('moe.w_up', (mlp + 'v1',), True, None, 'block'),
                   ('moe.w_down', (mlp + 'w2',), False, None, 'block')]
    elif family == 'gpt2':
        # Conv1D weights are (in, out); c_attn packs q, k, v along out.
        top = ('transformer.wte.weight', 'transformer.ln_f',
               'transformer.h.{}.')
        norms = {'attn_norm': 'ln_1', 'mlp_norm': 'ln_2'}
        projs = {'attn.qkv_proj': ('attn.c_attn',),
                 'attn.o_proj': ('attn.c_proj',),
                 'mlp.up_proj': ('mlp.c_fc',),
                 'mlp.down_proj': ('mlp.c_proj',)}
    elif family == 'phi':
        top = ('model.embed_tokens.weight', 'model.final_layernorm',
               'model.layers.{}.')
        norms = {'attn_norm': 'input_layernorm'}
        projs = {'attn.qkv_proj': attn, 'attn.o_proj': ('self_attn.dense',),
                 'mlp.up_proj': ('mlp.fc1',), 'mlp.down_proj': ('mlp.fc2',)}
    elif family == 'falcon':
        # multi_query: rows [q (H D), k (D), v (D)], the port's fused order.
        top = ('transformer.word_embeddings.weight', 'transformer.ln_f',
               'transformer.h.{}.')
        norms = {'attn_norm': 'input_layernorm'}
        projs = {'attn.qkv_proj': ('self_attention.query_key_value',),
                 'attn.o_proj': ('self_attention.dense',),
                 'mlp.up_proj': ('mlp.dense_h_to_4h',),
                 'mlp.down_proj': ('mlp.dense_4h_to_h',)}
    else:
        top = ('model.embed_tokens.weight', 'model.norm', 'model.layers.{}.')
        norms = {'attn_norm': 'input_layernorm',
                 'mlp_norm': 'post_attention_layernorm'}
        projs = {'attn.qkv_proj': attn, 'attn.o_proj': ('self_attn.o_proj',)}
        if family == 'mixtral':
            moe = 'block_sparse_moe.'
            experts = [('moe.router', (moe + 'gate.weight',), True, None,
                        None)] + [
                (f'moe.{port}', tuple(f'{moe}experts.{j}.{hf}.weight'
                                      for j in range(cfg.num_experts)),
                 True, None, 'list')
                for port, hf in (('w_gate', 'w1'), ('w_up', 'w3'),
                                 ('w_down', 'w2'))]
        else:
            projs.update({'mlp.gate_up_proj': ('mlp.gate_proj',
                                               'mlp.up_proj'),
                          'mlp.down_proj': ('mlp.down_proj',)})
    kv_w = cfg.num_kv_heads * cfg.head_dim
    widths = {'attn.qkv_proj': (cfg.num_heads * cfg.head_dim, kv_w, kv_w),
              'mlp.gate_up_proj': (cfg.d_mlp, cfg.d_mlp)}
    bias = {'attn.qkv_proj': cfg.qkv_bias, 'attn.o_proj': cfg.o_bias}
    entries = []
    for port, hf in norms.items():
        entries.append((port + '.weight', (hf + '.weight',), False, None,
                        None))
        if cfg.norm_style == 'layernorm' and cfg.norm_bias:
            entries.append((port + '.bias', (hf + '.bias',), False, None,
                            None))
    for port, parts in projs.items():
        split = widths.get(port) if len(parts) > 1 else None
        entries.append((port, tuple(k + '.weight' for k in parts),
                        family != 'gpt2', split, None))
        if bias.get(port, cfg.mlp_bias):
            entries.append((port + '_bias', tuple(k + '.bias' for k in parts),
                            False, split, None))
    return _HFLayout(*top, tuple(entries + experts))


def from_hf(tensors: Mapping[str, torch.Tensor], cfg: ModelConfig,
            device='cpu', dtype: Optional[str] = None
            ) -> Dict[str, torch.Tensor]:
    """An HF state dict (name → tensor, any dtype and device) → the
    port's state dict for Transformer(cfg), each tensor on `device` in
    `dtype` (a torch dtype name; default cfg.dtype), one at a time,
    through cfg's `_hf_layout`. Refuses leftover tensors, as the
    reference does."""
    layout = _hf_layout(cfg)
    dtype = getattr(torch, dtype) if dtype else torch_dtype(cfg)
    sd = _Tracked(tensors)
    vocab = cfg.vocab_size

    def get(key: str) -> torch.Tensor:
        return sd[key].to(device=device, dtype=dtype)

    def take(keys, transposed: bool, experts: Optional[str]) -> torch.Tensor:
        if experts == 'block':
            (key,) = keys
            w = get(key)
            w = w.reshape(cfg.num_experts, -1, w.shape[-1])
            return (w.transpose(1, 2) if transposed else w).contiguous()
        parts = [get(k).t() if transposed else get(k) for k in keys]
        if experts == 'list':
            return torch.stack(parts)
        if len(parts) == 1 and not transposed:
            return parts[0]
        return torch.cat(parts, dim=-1).contiguous()

    state: Dict[str, torch.Tensor] = {
        'embed': _pad_vocab(get(layout.embed), vocab)}
    if cfg.pos_embedding == 'learned':
        wpe = get('transformer.wpe.weight')
        if wpe.shape[0] < cfg.max_seq_len:
            raise ValueError(f'checkpoint supports {wpe.shape[0]} positions '
                             f'< max_seq_len {cfg.max_seq_len}')
        state['pos_embed'] = wpe[:cfg.max_seq_len].contiguous()
    for i in range(cfg.num_layers):
        prefix = layout.layer.format(i)
        for port, keys, transposed, _, experts in layout.entries:
            state[f'layers.{i}.{port}'] = take(
                [prefix + k for k in keys], transposed, experts)
    state['final_norm.weight'] = get(layout.final + '.weight')
    if cfg.norm_style == 'layernorm' and cfg.norm_bias:
        state['final_norm.bias'] = get(layout.final + '.bias')
    if cfg.tie_embeddings:
        sd.used.add('lm_head.weight')    # the tied alias of the embedding
    else:
        state['lm_head'] = _pad_vocab(get('lm_head.weight'),
                                      vocab).t().contiguous()
        if cfg.lm_head_bias:
            state['lm_head_bias'] = _pad_vocab(get('lm_head.bias'), vocab)
    leftover = sorted(
        k for k in tensors if k not in sd.used
        and not any(k.endswith(s) or s in k for s in _IGNORABLE))
    if leftover:
        raise ValueError(
            f'checkpoint has {len(leftover)} weight tensor(s) this '
            f'architecture does not consume (incompatible checkpoint? '
            f'e.g. Gemma-2 post-norms are not modeled): '
            f'{leftover[:6]}{"..." if len(leftover) > 6 else ""}')
    return state


def load_hf_checkpoint(path: str, cfg: ModelConfig, device='cpu',
                       dtype: Optional[str] = None
                       ) -> Dict[str, torch.Tensor]:
    """A LOCAL HF checkpoint directory → the port's state dict, each
    tensor read from its file's mmap straight onto `device` in `dtype`
    (default cfg.dtype): an 8B model is never built in fp32 on the host.
    cfg must already carry any max_seq_len override (GPT-2's position
    table is sliced to it)."""
    return from_hf(safetensors_file.CheckpointTensors(path), cfg, device,
                   dtype)


def to_hf(state: Mapping[str, torch.Tensor],
          cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict → an HF state dict (from_hf's `_hf_layout`
    walked backwards, tensors in the state's dtype and device): fused
    projections split, Linear weights transposed to torch's (out, in),
    vocab padding rows stripped (cfg.unpadded_vocab_size), tied models
    emitting the embedding under lm_head.weight too, as HF ties them.
    A LoRA state is merged first (exporting the raw adapters would emit
    the untuned base); adapters under a config without LoRA training are
    refused rather than dropped."""
    if cfg.weight_quant == 'int8':
        raise ValueError('int8 weights are a serving format; export the '
                         'float weights')
    if lora_training(cfg):
        state = lora.merge_lora(state, cfg)
    elif lora.has_lora(state):
        raise ValueError(
            'state holds lora_a/lora_b adapters but cfg.lora_rank == 0: '
            'pass the LoRA config (or merge_lora first) — a silent '
            'export here would drop the fine-tune')
    layout = _hf_layout(cfg)
    n = (cfg.unpadded_vocab_size
         if 0 < cfg.unpadded_vocab_size < cfg.vocab_size else cfg.vocab_size)
    embed = state['embed'][:n]
    sd: Dict[str, torch.Tensor] = {layout.embed: embed}
    if cfg.pos_embedding == 'learned':
        sd['transformer.wpe.weight'] = state['pos_embed']
    for i in range(cfg.num_layers):
        prefix = layout.layer.format(i)
        for port, keys, transposed, widths, experts in layout.entries:
            value = state[f'layers.{i}.{port}']
            if experts == 'block':
                value = (value.transpose(1, 2) if transposed else value)
                sd[prefix + keys[0]] = value.reshape(
                    -1, value.shape[-1]).contiguous()
                continue
            parts = (torch.split(value, list(widths), dim=-1) if widths
                     else tuple(value) if experts == 'list' else (value,))
            for key, part in zip(keys, parts):
                sd[prefix + key] = (part.t() if transposed
                                    else part).contiguous()
    sd[layout.final + '.weight'] = state['final_norm.weight']
    if cfg.norm_style == 'layernorm' and cfg.norm_bias:
        sd[layout.final + '.bias'] = state['final_norm.bias']
    if cfg.tie_embeddings:
        sd['lm_head.weight'] = embed
    else:
        sd['lm_head.weight'] = state['lm_head'][:, :n].t().contiguous()
        if cfg.lm_head_bias:
            sd['lm_head.bias'] = state['lm_head_bias'][:n]
    return sd


def hf_config_for(cfg: ModelConfig, torch_dtype_name: str = 'float32'
                  ) -> Dict[str, Any]:
    """config.json for `cfg`: the keys the reference's hf_config_for sets
    on its transformers config (family chosen from the same flags the
    forward pass branches on; the UNPADDED vocab size), plus model_type,
    architectures and torch_dtype, so that `transformers` rebuilds the
    same architecture from the file."""
    hf_vocab = (cfg.unpadded_vocab_size
                if 0 < cfg.unpadded_vocab_size < cfg.vocab_size
                else cfg.vocab_size)
    if cfg.attn_logit_softcap or cfg.final_logit_softcap:
        raise NotImplementedError(
            'softcapped (Gemma-2-style) configs have no faithful HF '
            'export: this architecture omits Gemma-2 post-norms, so '
            'neither GemmaConfig nor Gemma2Config reproduces it')
    hf_family = _hf_family(cfg)

    def family(model_type: str, arch: str, **keys) -> Dict[str, Any]:
        return {'model_type': model_type, 'architectures': [arch],
                'torch_dtype': torch_dtype_name, **keys}

    if hf_family == 'dbrx':
        return family(
            'dbrx', 'DbrxForCausalLM', d_model=cfg.d_model,
            n_heads=cfg.num_heads, n_layers=cfg.num_layers,
            max_seq_len=cfg.max_seq_len, vocab_size=hf_vocab,
            attn_config={'kv_n_heads': cfg.num_kv_heads,
                         'rope_theta': cfg.rope_theta,
                         'clip_qkv': cfg.qkv_clip or None},
            ffn_config={'ffn_hidden_size': cfg.d_mlp,
                        'moe_num_experts': cfg.num_experts,
                        'moe_top_k': cfg.experts_per_token},
            tie_word_embeddings=cfg.tie_embeddings)

    if hf_family == 'phi':
        return family(
            'phi', 'PhiForCausalLM', vocab_size=hf_vocab,
            hidden_size=cfg.d_model, intermediate_size=cfg.d_mlp,
            num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_heads,
            num_key_value_heads=cfg.num_kv_heads,
            max_position_embeddings=cfg.max_seq_len,
            rope_theta=cfg.rope_theta, partial_rotary_factor=cfg.rotary_pct,
            layer_norm_eps=cfg.norm_eps,
            tie_word_embeddings=cfg.tie_embeddings)
    if hf_family == 'falcon':
        return family(
            'falcon', 'FalconForCausalLM', vocab_size=hf_vocab,
            hidden_size=cfg.d_model, num_hidden_layers=cfg.num_layers,
            num_attention_heads=cfg.num_heads, ffn_hidden_size=cfg.d_mlp,
            max_position_embeddings=cfg.max_seq_len,
            rope_theta=cfg.rope_theta, layer_norm_epsilon=cfg.norm_eps,
            multi_query=True, parallel_attn=True, bias=False, alibi=False,
            new_decoder_architecture=False,
            tie_word_embeddings=cfg.tie_embeddings)
    if hf_family == 'gpt2':
        return family(
            'gpt2', 'GPT2LMHeadModel', vocab_size=hf_vocab,
            n_embd=cfg.d_model, n_layer=cfg.num_layers, n_head=cfg.num_heads,
            n_inner=cfg.d_mlp, n_positions=cfg.max_seq_len,
            layer_norm_epsilon=cfg.norm_eps)
    common = dict(
        vocab_size=hf_vocab, hidden_size=cfg.d_model,
        intermediate_size=cfg.d_mlp, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads,
        max_position_embeddings=cfg.max_seq_len,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
        tie_word_embeddings=cfg.tie_embeddings)
    if cfg.rope_scaling is not None:
        factor, low_f, high_f, old_len = cfg.rope_scaling
        # HF `rope_type: llama3`, the Llama-3.1 long-context scaling.
        common['rope_scaling'] = {
            'rope_type': 'llama3', 'factor': factor,
            'low_freq_factor': low_f, 'high_freq_factor': high_f,
            'original_max_position_embeddings': int(old_len)}
    if hf_family == 'mixtral':
        return family('mixtral', 'MixtralForCausalLM',
                      num_local_experts=cfg.num_experts,
                      num_experts_per_tok=cfg.experts_per_token, **common)
    if cfg.norm_style == 'rms_plus1':
        return family('gemma', 'GemmaForCausalLM', head_dim=cfg.head_dim,
                      **common)
    if cfg.sliding_window:
        return family('mistral', 'MistralForCausalLM',
                      sliding_window=cfg.sliding_window, **common)
    if cfg.qkv_bias:
        return family('qwen2', 'Qwen2ForCausalLM', **common)
    return family('llama', 'LlamaForCausalLM', **common)


def export_hf_checkpoint(state: Mapping[str, torch.Tensor], cfg: ModelConfig,
                         out_dir: str, max_shard_bytes: int = 4 << 30
                         ) -> List[str]:
    """Write a loadable HF checkpoint directory from the port's state
    dict: config.json (hf_config_for) and the weights as safetensors
    (`model.safetensors`, or `model-0000N-of-0000M.safetensors` shards of
    at most `max_shard_bytes` with their index), in the state's dtype. A
    tied model's lm_head.weight is left out, as save_pretrained leaves it
    out. Returns the files written."""
    sd = to_hf(state, cfg)
    if cfg.tie_embeddings:
        del sd['lm_head.weight']
    dtype_name = str(next(iter(sd.values())).dtype).replace('torch.', '')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'config.json'), 'w',
              encoding='utf-8') as f:
        json.dump(hf_config_for(cfg, dtype_name), f, indent=2)
    files = safetensors_file.write_checkpoint(sd, out_dir, max_shard_bytes)
    logger.info('exported HF checkpoint to %s (%d files)', out_dir,
                len(files) + 1)
    return ['config.json'] + files
