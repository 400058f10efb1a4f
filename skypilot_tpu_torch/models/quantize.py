"""Weight-only int8 quantization for serving (the reference's
models/quantize.py, on the port's state dict).

`quantize_state(state, cfg)` turns a float state dict into the one the
`weight_quant='int8'` model loads: each projection (the fused qkv_proj
and gate_up_proj, o_proj, up_proj, down_proj and an untied lm_head)
becomes an int8 matrix plus fp32 `<name>_scale`, one scale per output
column: absmax over the input axis / 127, floored at 1e-8, the weight
divided by it, rounded half to even and clipped to +-127, in fp32 op for
op as the reference's `quantize_kernel`. A fused projection's columns
are its parts' columns, so its per-column scales are the reference's
per-projection scales concatenated; o_proj's input axis is all of
heads x head_dim, the reference's (2, 1) entry. Embeddings, norms,
biases and a tied unembedding stay float.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, MutableMapping, Tuple

import torch

from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.transformer import (QUANT_PROJECTIONS,
                                                   check_supported)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float matrix → (int8 matrix, fp32 (out,) scales)."""
    w32 = w.float()
    # The reference's jitted `/ 127.0`: XLA compiles a division by a
    # constant into a product by its fp32 reciprocal, and so does this.
    scale = torch.clamp(w32.abs().amax(dim=0), min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_config(cfg: ModelConfig) -> ModelConfig:
    """`cfg` serving int8 weights; refuses MoE as the reference does
    (transformer.check_supported)."""
    int8 = dataclasses.replace(cfg, weight_quant='int8')
    check_supported(int8)
    return int8


def is_projection(key: str) -> bool:
    return key.rsplit('.', 1)[-1] in QUANT_PROJECTIONS


def quantize_state(state: MutableMapping[str, torch.Tensor],
                   cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Float state dict → int8-serving state dict, on the tensors' own
    device. Entries are taken out of `state` as they are quantized, so a
    caller that holds no other reference frees each float matrix before
    the next is converted."""
    int8_config(cfg)
    out: Dict[str, torch.Tensor] = {}
    for key in list(state):
        value = state.pop(key)
        if is_projection(key):
            out[key], out[key + '_scale'] = quantize_weight(value)
        else:
            out[key] = value
    return out
