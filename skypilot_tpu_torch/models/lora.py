"""LoRA utilities on the port's state dicts: merge adapters into the base
weights, overlay a base checkpoint, and pull one trained adapter out.

Port of skypilot_tpu/models/lora.py. The adapter itself lives in the
model (models/transformer: `<name>_lora_a` (in, r) and `<name>_lora_b`
(r, out) beside each targeted projection, y = W·x + (alpha/r)·B(A(x))).
Where the reference keeps one kernel per projection, the port fuses q/k/v
into `attn.qkv_proj` and gate/up into `mlp.gate_up_proj`: a target's
delta lands in its column slice of the fused kernel (`adapter_site`).

- merge_lora: fold every adapter into its base kernel
  (W += (alpha/r)·A·B, computed and summed in fp32 and cast back to the
  kernel's dtype, the reference's `_merge_one`) and drop the adapter
  entries: the result is a plain state dict, servable and exportable
  with lora_rank = 0.
- has_lora / overlay_base_params: the export guard (exporting an
  unmerged LoRA state would drop the fine-tune; models/convert.to_hf
  merges or refuses) and init-from-HF (HF supplies the frozen base, the
  seeded init keeps the adapters).
- adapter_tree: one trained adapter in the reference's models/lora
  layout, what serve/tenancy.save_adapter_npz writes and the server's
  POST /adapters/load takes.
- read_sidecar / write_sidecar: a LoRA run's adapter shape
  ({lora_rank, lora_alpha, lora_targets}) in `<checkpoint-dir>/lora.json`,
  which train.run writes and serving and models/export_tool read.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Set, Tuple

import torch

from skypilot_tpu_torch.models.configs import ModelConfig

_SUFFIXES = ('_lora_a', '_lora_b')
SIDECAR = 'lora.json'


def is_adapter_key(key: str) -> bool:
    return key.endswith(_SUFFIXES)


def has_lora(state: Mapping[str, Any]) -> bool:
    return any(is_adapter_key(key) for key in state)


def adapter_keys(cfg: ModelConfig) -> Set[str]:
    """The state-dict keys of the adapters a LoRA training model of
    `cfg` holds (a `gate` target on a plain MLP has no projection)."""
    from skypilot_tpu_torch.models.transformer import (lora_target_names,
                                                       projection_shapes)
    names = [name for name in lora_target_names(cfg)
             if name in projection_shapes(cfg)]
    return {f'layers.{i}.{projection_module(cfg, name)}.{name}{suffix}'
            for i in range(cfg.num_layers) for name in names
            for suffix in _SUFFIXES}


def adapter_site(cfg: ModelConfig, name: str) -> Tuple[str, int, int]:
    """(the fused projection's key within a layer, first column, width)
    that projection `name`'s adapter adds into
    (transformer.fused_projections, widths from projection_shapes)."""
    from skypilot_tpu_torch.models.transformer import (fused_projections,
                                                       projection_shapes)
    shapes = projection_shapes(cfg)
    for key, names in fused_projections(cfg).items():
        if name in names:
            before = names[:names.index(name)]
            return (key, sum(shapes[n][1] for n in before),
                    shapes[name][1])
    raise KeyError(f'{cfg.name} has no projection {name}')


def projection_module(cfg: ModelConfig, name: str) -> str:
    """The layer submodule ('attn' or 'mlp') holding projection `name`."""
    return adapter_site(cfg, name)[0].partition('.')[0]


def sidecar_meta(cfg: ModelConfig) -> Dict[str, Any]:
    return {'lora_rank': cfg.lora_rank, 'lora_alpha': cfg.lora_alpha,
            'lora_targets': cfg.lora_targets}


def read_sidecar(checkpoint_dir: str) -> Optional[Dict[str, Any]]:
    """The adapter shape a LoRA run recorded in `checkpoint_dir`, or None
    when it has no sidecar."""
    path = os.path.join(os.path.expanduser(checkpoint_dir), SIDECAR)
    if not os.path.exists(path):
        return None
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def write_sidecar(checkpoint_dir: str, cfg: ModelConfig) -> None:
    directory = os.path.expanduser(checkpoint_dir)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, SIDECAR), 'w', encoding='utf-8') as f:
        json.dump(sidecar_meta(cfg), f)


def merge_lora(state: Mapping[str, torch.Tensor],
               cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Fold adapters into kernels; return a LoRA-free state dict (the
    input is not modified; the kernels the adapters touch are new
    tensors, the rest shared)."""
    if cfg.lora_rank <= 0:
        raise ValueError('merge_lora called with lora_rank == 0')
    scale = cfg.lora_alpha / cfg.lora_rank
    out = {k: v for k, v in state.items() if not is_adapter_key(k)}
    copied = set()
    for key in state:
        if not key.endswith('_lora_a'):
            continue
        layer, _, leaf = key.rpartition('.')
        name = leaf[:-len('_lora_a')]
        fused, start, width = adapter_site(cfg, name)
        kernel_key = layer.rpartition('.')[0] + '.' + fused
        if kernel_key not in out:
            raise ValueError(f'{key} without a base kernel {kernel_key}')
        if kernel_key not in copied:
            out[kernel_key] = out[kernel_key].clone()
            copied.add(kernel_key)
        kernel = out[kernel_key]
        a, b = state[key], state[key[:-1] + 'b']
        # The reference's _merge_one: kernel + scale * delta in fp32,
        # cast back (its callers merge trees restored in fp32: the
        # product is fp32 here for any adapter dtype).
        delta = a.float() @ b.float()
        cols = kernel[:, start:start + width]
        cols.copy_((cols.float() + scale * delta).to(kernel.dtype))
    return out


def overlay_base_params(full: Mapping[str, Any],
                        base: Mapping[str, Any]) -> Dict[str, Any]:
    """`full`'s entries replaced by `base`'s wherever base has them,
    keeping the entries only `full` has (the adapters): the init-from-HF
    path for a LoRA config."""
    out = dict(full)
    out.update(base)
    return out


def adapter_tree(state: Mapping[str, torch.Tensor],
                 cfg: ModelConfig) -> Dict[str, Any]:
    """The trained adapter of a LoRA state dict as the reference's
    scanned adapter tree (lora_a/lora_b leaves only, float32 numpy): what
    serve/tenancy.adapter_tree_from_lora_params makes of
    models/convert.params_to_jax's tree, read from the adapter tensors
    alone (an 8B base never goes to the host)."""
    import numpy as np

    from skypilot_tpu_torch.models.convert import adapter_layout
    if not has_lora(state):
        raise ValueError('state holds no LoRA adapters')
    layout = adapter_layout(cfg)['layers']['layer']
    layer = {}
    for module, names in layout.items():
        for name, leaves in names.items():
            layer.setdefault(module, {})[name] = {
                leaf: np.stack([
                    state[f'layers.{i}.{module}.{name}_{leaf}'].detach()
                    .float().cpu().numpy() for i in range(cfg.num_layers)
                ]).reshape(shape)
                for leaf, shape in leaves.items()}
    return {'layers': {'layer': layer}}
