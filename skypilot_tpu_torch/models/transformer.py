"""The reference's dense decoder families in PyTorch: the serving path
(paged KV) and the training path (full sequence).

Port of skypilot_tpu/models/transformer.py. Like the reference, the model
branches on `cfg.decode`:
- decode=True (the serving engines): every attention call — a prefill
  chunk, a decode step — writes its K/V into the shared paged pool through
  the block tables and attends through ops/paged_attention; or, without
  pool geometry (`paged_block_size` 0, the reference's default layout),
  writes it into its row of a contiguous (batch, max_seq_len) cache from
  the row's first position and attends over the whole row through
  ops/paged_attention.attend_window, the plain route's own math.
- decode=False (training): `forward(tokens)` runs the whole sequence and
  attends through ops/flash_attention (`impl=cfg.attention_impl`). With
  attention_impl='ring' under parallel/sharding.use_sequence_parallel,
  attention runs as a ring over sp chunks: in one process the model sees
  the whole sequence and only attention is split; per rank (group=g) the
  model gets the rank's token chunk and its positions start at
  rank x chunk.
Both reach hand-written CUDA kernels on the card and their plain versions
on the CPU.

Layout choices:
- Weights keep the reference's (in, out) orientation. Serving keeps them
  in `cfg.dtype` with no grad (an 8B model gains no fp32 copy). Training
  keeps them in `cfg.param_dtype` with requires_grad and casts each to
  `cfg.dtype` at its product: Flax's DenseGeneral(dtype, param_dtype)
  semantics. q/k/v share one fused (d, (H + 2 KV) D) projection and
  gate/up one (d, 2 F) projection: one matmul each instead of three and
  two (models/convert.py concatenates the reference's kernels).
- The KV pool is one (num_layers, num_blocks, block_size, KV, D) tensor
  each for K and V — the reference's scanned layout — and is updated IN
  PLACE, where the JAX code returns a new pool: a pool is a persistent
  buffer the engine owns, and copying 8 GB per step would be absurd. The
  contiguous cache is one (num_layers, batch, max_seq_len, KV, D) tensor
  each, updated in place the same way (`new_kv_cache`).
- Norm statistics, rope angles and attention scores are fp32, as in the
  reference. The reference's `_attend_window` math (float and int8) is
  ops/paged_attention.attend_window, the kernel's plain version.
- int8 KV (cfg.kv_cache_quant == 'int8'): the pools hold int8 payloads
  plus fp32 per-token-per-kv-head scale pools (L, NB, bs, KV, 1), the
  reference's layout; every write quantizes with `int8_quantize` (the
  reference's `_int8_quantize`, op for op) and scatters payload and scale
  rows through the step's write index.
- Multi-LoRA serving (cfg.serve_adapters = N > 0): each targeted
  projection of each layer holds a `LoRAStack`, (N + 1, in, r) A and
  (N + 1, r, out) B buffers (slot 0 the all-zero identity; not in the
  state dict, like the reference's separate 'adapters' collection). The
  per-row slot vector `adapter_ids` picks each row's adapter. The
  targets of one fused output (q/k/v of qkv, gate/up of gate_up, o,
  down) form one ops/fused_lora `LoRAGroup`, which adds each delta
  z * (alpha / r) in the compute dtype to its column slice of that
  output in place, before the split, rope and SiLU (the reference adds
  it to each target's own projection: the same numbers).
- LoRA training (cfg.lora_rank = r > 0 without serve adapters): each
  targeted projection also holds `<name>_lora_a` (in, r), drawn from
  N(0, 1/r), and `<name>_lora_b` (r, out), zeros, in the param dtype,
  trainable; every other parameter is frozen (requires_grad False, so
  autograd computes no base dW). The reference's LoRADenseGeneral
  computes y = W·x + (alpha / r)·B(A(x)) in the compute dtype: z = x·A,
  then z·B, then `* (alpha / r)`, then the add, and only then the bias.
  Here the base product of a fused projection stays one GEMM and each
  target's delta is added to its column slice (plain products under
  autograd: the reference's are XLA dots, not a Pallas kernel, and
  kernel 7 has no backward). The adapters are drawn after every base
  parameter, so a LoRA model's base equals the plain model's from the
  same seed.
- `cfg.remat` is per-layer `torch.utils.checkpoint` (non-reentrant):
  remat_policy 'dots' saves the matmul outputs (the reference's
  dots_with_no_batch_dims_saveable) through a selective-checkpoint
  policy, 'full' saves nothing. Values do not depend on the policy.

The family knobs compose as in the reference, so one module tree serves
Llama, Mistral, Qwen2, Gemma, Gemma-2, Falcon, Phi and GPT-2:
- norms in three dialects (`norm_style` 'rms', 'rms_plus1': the stored
  scale is a delta from 1, 'layernorm': mean-centred, with a bias when
  `norm_bias`), statistics in fp32;
- biases on the fused qkv, o, MLP and lm_head projections, added after
  a LoRA group's delta (the reference adds its bias after the adapter's
  delta too); `qkv_clip` clamps q, k and v before rope;
- a GLU MLP (`gate_up_proj`) or a plain one (`up_proj` alone), SiLU or
  the tanh-approximate GELU;
- rope over all of head_dim or its first `rotary_dim(cfg)` dims, or no
  rope and a learned position table (`pos_embed`, at each row's own
  positions);
- Gemma's embedding scale (sqrt(d_model) rounded to the compute dtype
  before the product), tied unembedding (no lm_head: logits = x @
  embed^T), the final logit softcap and the padded-vocab mask;
- the parallel block (one attn_norm; x + attn(h) + mlp(h));
- attention logit softcap, which only the gather-and-attend route
  (`decode_kernel='xla'`, ops/paged_attention's plain version) serves:
  the kernel refuses it, as the reference's does.
A MoE config (`num_experts` > 0: Mixtral, DBRX) puts models/moe's
MoEBlock (`moe.router`, `moe.w_gate`, `moe.w_up`, `moe.w_down`) where
the dense layer has its MLP; its experts take no LoRA adapter, so only
the attention projections of a MoE model carry them (an MLP target adds
nothing, as in the reference).
int8 weights (`weight_quant='int8'`, a serving format made by
models/quantize.py) keep each projection as int8 plus fp32 per-column
scales (`<name>_scale`): the reference's QuantDenseGeneral product.
int8 weights over MoE, and LoRA training over int8 weights (as the
reference refuses them), are refused at construction.

Tensor-parallel serving (`group`, a parallel.mesh.ServingGroup of tp > 1
ranks): each rank's model holds its shard by the reference's rules
(parallel/sharding.py): heads/tp query heads and kv_heads/tp KV heads
(the fused qkv_proj holds [q_r | k_r | v_r]), d_mlp/tp of the MLP (gate
and up each sliced), of each MoE expert's hidden dimension (every
expert on every rank, the router whole), vocab/tp embedding rows and
lm_head columns; norms, the position table and the row-parallel biases
are whole. o_proj and down_proj are row-parallel: a partial product,
one all-reduce, then the bias. The embedding looks up the rank's vocab
rows (zeros elsewhere) and sums them with one all-reduce; the
unembedding's slices meet in one more (`ServingGroup.gather_vocab`), so
every rank holds the same logits. A MoE layer routes the (replicated)
input with the whole router, so every rank picks the same experts and
drops the same choices, runs its hidden slice of every expert, and
all-reduces the fp32 combine once (it is linear in the expert outputs),
then casts. A forward makes 2 x num_layers + 2 all-reduces. int8
weights are each rank's slice of the whole matrix's quantization (a
row-parallel column's scale is its whole input axis's absmax); a
row-parallel int8 product applies its per-column scale and the cast
before the all-reduce (the scale commutes with the sum, and the partial
then moves in the compute dtype, as a float projection's does). Adapter
stacks hold the rank's slices (sharding.shard_adapter): column-parallel
groups add into the rank's output columns, and o / down add
(x_r·A_r)·B into the partial product before its all-reduce. The KV
pools and caches hold the rank's kv_heads/tp heads. Training (and LoRA
training) is refused under tp (sharding.TP_TRAINING_NEXT).

fsdp training (`fsdp`, the fsdp group of a parallel.mesh.TrainGroup):
the parameters are built on `meta` and each replaced by this rank's
slice on its `embed` dimension (parallel/sharding.fsdp_dim); the
training forward runs the embedding, each layer and the head with their
whole weights gathered just before them (parallel/fsdp.py), a layer
under remat inside its checkpoint, so its recompute gathers again.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.models.moe import MoEBlock
from skypilot_tpu_torch.ops.flash_attention import flash_attention
from skypilot_tpu_torch.ops.fused_lora import LoRAGroup
from skypilot_tpu_torch.ops.paged_attention import (
    attend_window, paged_decode_attention, paged_decode_attention_plain)
from skypilot_tpu_torch.parallel import sharding
from skypilot_tpu_torch.parallel.fsdp import FullyShard

# lecun_normal's truncation: N(0, 1) cut at +-2 has std 0.8796...
_TRUNC_STD = 0.87962566103423978


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The compute (activation) dtype."""
    return getattr(torch, cfg.dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """Where the weights live: cfg.dtype when serving (decode), else
    cfg.param_dtype (training)."""
    return getattr(torch, cfg.dtype if cfg.decode else cfg.param_dtype)


def lora_training(cfg: ModelConfig) -> bool:
    """Whether the model holds trainable LoRA adapters (lora_rank > 0
    without serve adapters): then only they train."""
    return cfg.lora_rank > 0 and not cfg.serve_adapters


def _new_param(cfg: ModelConfig, shape, device) -> nn.Parameter:
    """A base parameter: trainable only in training without LoRA."""
    return nn.Parameter(
        torch.empty(shape, device=device, dtype=param_dtype(cfg)),
        requires_grad=not cfg.decode and not lora_training(cfg))


def _unsupported_knobs(cfg: ModelConfig) -> list:
    checks = {
        'weight_quant': cfg.weight_quant not in ('none', 'int8'),
        'kv_cache_quant': cfg.kv_cache_quant not in ('', 'int8'),
        'pos_embedding': cfg.pos_embedding not in ('rope', 'learned'),
        'norm_style': cfg.norm_style not in ('rms', 'rms_plus1',
                                             'layernorm'),
        'mlp_style': cfg.mlp_style not in ('glu', 'plain'),
        'mlp_activation': cfg.mlp_activation not in ('silu', 'gelu'),
    }
    return sorted(name for name, on in checks.items() if on)


# Projections that hold int8 weights under weight_quant='int8' (the
# reference's quantize._QUANT_MODULES, fused as the port fuses them).
QUANT_PROJECTIONS = ('qkv_proj', 'o_proj', 'gate_up_proj', 'up_proj',
                     'down_proj', 'lm_head')


def check_supported(cfg: ModelConfig, tp: int = 1) -> None:
    """Refuse, at construction, what the port does not serve: unknown
    knob values, and (as the reference refuses them) int8 weights over
    MoE, and LoRA training and multi-LoRA serving over int8 weights; under
    tensor parallelism (tp > 1) a tp that does not divide the sharded
    dimensions (the reference's message), and training."""
    if tp > 1:
        cfg.assert_tp_compatible(tp)
        refused = [what for what, on in (
            ('training (decode=False)', not cfg.decode),
            ('LoRA training', lora_training(cfg))) if on]
        if refused:
            raise NotImplementedError(
                f'tensor-parallel serving (tp={tp}) does not serve '
                f'{", ".join(refused)} yet ({sharding.TP_TRAINING_NEXT})')
    bad = _unsupported_knobs(cfg)
    if bad:
        raise NotImplementedError(
            f'{cfg.name}: the PyTorch port serves the dense decoder '
            f'families; not ported yet: {", ".join(bad)}')
    if cfg.weight_quant == 'int8' and cfg.is_moe:
        raise NotImplementedError(
            'int8 serving is dense-model only for now (MoE expert '
            'kernels keep the dispatch einsum float)')
    if cfg.rotary_pct != 1.0 and not 0.0 < cfg.rotary_pct < 1.0:
        raise ValueError(f'rotary_pct must be in (0, 1], got '
                         f'{cfg.rotary_pct}')
    if cfg.weight_quant == 'int8' and cfg.serve_adapters and any(
            name in lora_target_names(cfg)
            for name in projection_shapes(cfg)):
        raise NotImplementedError(
            'multi-LoRA serving composes with int8 KV, not int8 '
            'WEIGHTS: the adapter delta applies to the float base '
            'projection (serve unquantized, or merge+quantize a '
            'single adapter)')
    if lora_training(cfg):
        targeted = [name for name in projection_shapes(cfg)
                    if name in lora_target_names(cfg)]
        if cfg.weight_quant == 'int8' and targeted:
            raise NotImplementedError(
                'LoRA trains against float base weights; serve the '
                'merged checkpoint with int8 instead '
                '(models/lora.merge_lora then quantize)')
    if cfg.serve_adapters:
        if not cfg.decode:
            raise NotImplementedError(
                'serve_adapters is a serving (decode) knob; train LoRA '
                'adapters with lora_rank alone')
        if cfg.lora_rank <= 0:
            raise ValueError('serve_adapters > 0 requires lora_rank > 0')
        lora_target_names(cfg)


_LORA_TOKENS = ('q', 'k', 'v', 'o', 'gate', 'up', 'down')


def lora_target_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """'q,v' → ('q_proj', 'v_proj'); validates the token set (the
    reference's transformer.lora_target_names)."""
    names = []
    for tok in cfg.lora_targets.split(','):
        tok = tok.strip()
        if not tok:
            continue
        if tok not in _LORA_TOKENS:
            raise ValueError(f'lora_targets token {tok!r} not in '
                             f'{_LORA_TOKENS}')
        names.append(f'{tok}_proj')
    if cfg.lora_rank > 0 and not names:
        raise ValueError('lora_rank > 0 but lora_targets is empty')
    return tuple(names)


def projection_shapes(cfg: ModelConfig, tp: int = 1) -> dict:
    """Each projection the model has, by the reference's module name →
    (in, out) widths (q/k/v and o flattened over heads; gate_proj only
    under a GLU MLP; no MLP projection under MoE, whose experts are no
    projections); a tp rank's shard widths when tp > 1."""
    q_out = cfg.num_heads * cfg.head_dim // tp
    kv_out = cfg.num_kv_heads * cfg.head_dim // tp
    shapes = {'q_proj': (cfg.d_model, q_out), 'k_proj': (cfg.d_model, kv_out),
              'v_proj': (cfg.d_model, kv_out), 'o_proj': (q_out, cfg.d_model)}
    if cfg.is_moe:
        return shapes
    d_mlp = cfg.d_mlp // tp
    if cfg.mlp_style == 'glu':
        shapes['gate_proj'] = (cfg.d_model, d_mlp)
    shapes['up_proj'] = (cfg.d_model, d_mlp)
    shapes['down_proj'] = (d_mlp, cfg.d_model)
    return shapes


def fused_projections(cfg: ModelConfig) -> dict:
    """Each projection parameter of a layer (its key within the layer) →
    the reference's projections whose outputs are its column slices, in
    order (widths from projection_shapes): q/k/v fuse into one GEMM, and
    gate/up under a GLU MLP; attention only under MoE."""
    attn = {'attn.qkv_proj': ('q_proj', 'k_proj', 'v_proj'),
            'attn.o_proj': ('o_proj',)}
    if cfg.is_moe:
        return attn
    mlp = ({'mlp.gate_up_proj': ('gate_proj', 'up_proj')}
           if cfg.mlp_style == 'glu' else {'mlp.up_proj': ('up_proj',)})
    return {**attn, **mlp, 'mlp.down_proj': ('down_proj',)}


def rotary_dim(cfg: ModelConfig) -> int:
    """Dims of each head that rope rotates: head_dim, the reference's
    partial-rotary `max(2, int(head_dim * rotary_pct) // 2 * 2)`, or 0
    with a learned position table."""
    if cfg.pos_embedding != 'rope':
        return 0
    if cfg.rotary_pct == 1.0:
        return cfg.head_dim
    return max(2, int(cfg.head_dim * cfg.rotary_pct) // 2 * 2)


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-kv-head absmax int8 quantization for KV writes, the
    reference's `_int8_quantize` op for op: amax floored at 1e-6, divided
    by 127, then round(x / scale) (half to even in both frameworks).
    x: (B, T, KV, D) → (int8 payload, fp32 scales (B, T, KV))."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    return torch.round(x32 / scale[..., None]).to(torch.int8), scale


class RMSNorm(nn.Module):
    """Pre-norm in the family's dialect: 'rms' (Llama), 'rms_plus1'
    (Gemma: the stored weight is a delta from 1), 'layernorm' (GPT-2:
    mean-centred, with a bias when cfg.norm_bias). Statistics in fp32
    regardless of dtype."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.style = cfg.norm_style
        self.dtype = torch_dtype(cfg)
        self.weight = _new_param(cfg, cfg.d_model, device)
        self.bias = (_new_param(cfg, cfg.d_model, device)
                     if self.style == 'layernorm' and cfg.norm_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.style == 'layernorm':
            x32 = x32 - x32.mean(dim=-1, keepdim=True)
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        w = self.weight.float()
        if self.style == 'rms_plus1':
            w = 1.0 + w
        out = normed * w
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(self.dtype)


def _llama3_scale_freqs(freqs: torch.Tensor, scaling) -> torch.Tensor:
    """Llama-3.1 long-context rope correction (HF rope_type 'llama3'):
    frequencies whose wavelength exceeds the ORIGINAL training window
    divide by `factor`; short wavelengths pass through; the band between
    interpolates smoothly. scaling = (factor, low_freq_factor,
    high_freq_factor, original_max_position_embeddings)."""
    factor, low_f, high_f, old_len = scaling
    wavelen = 2.0 * math.pi / freqs
    low_wl = old_len / low_f
    high_wl = old_len / high_f
    smooth = (old_len / wavelen - low_f) / (high_f - low_f)
    interpolated = (1.0 - smooth) * freqs / factor + smooth * freqs
    return torch.where(wavelen > low_wl, freqs / factor,
                       torch.where(wavelen < high_wl, freqs, interpolated))


def rope_freqs(head_dim: int, theta: float, scaling=None,
               device=None) -> torch.Tensor:
    """(head_dim // 2,) fp32 rotary frequencies, the reference formula."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32,
                             device=device) / half
    freqs = 1.0 / (theta ** exponents)
    if scaling is not None:
        freqs = _llama3_scale_freqs(freqs, scaling)
    return freqs


def rope_cos_sin(positions: torch.Tensor, freqs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, 1, half) cos/sin of the fp32 angles positions * freqs —
    computed once per forward and shared by every layer's q and k."""
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rotate(x: torch.Tensor, cos: Optional[torch.Tensor],
            sin: Optional[torch.Tensor]) -> torch.Tensor:
    """Rope over the first 2 * cos.shape[-1] dims of each head (all of
    them, or the partial-rotary share; the rest pass through); no cos:
    no rope (learned positions)."""
    if cos is None:
        return x
    rot = 2 * cos.shape[-1]
    if rot < x.shape[-1]:
        return torch.cat([_rotate(x[..., :rot], cos, sin), x[..., rot:]],
                         dim=-1)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling=None, rotary_dim: int = 0) -> torch.Tensor:
    """Rotary position embedding. x: (B, S, H, D); positions: (B, S).
    rotary_dim > 0 (partial rotary): only the first rotary_dim dims
    rotate, with frequencies over rotary_dim."""
    freqs = rope_freqs(rotary_dim or x.shape[-1], theta, scaling,
                       device=x.device)
    return _rotate(x, *rope_cos_sin(positions, freqs))


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The reference's QuantDenseGeneral product: x times the int8
    weight converted to the compute dtype, accumulated in fp32, times the
    fp32 per-column scale, cast to the compute dtype. A plain
    dequantise-then-matmul (the reference's XLA fuses the convert into
    the product; here the converted weight is a temporary)."""
    w = q.to(dtype)
    if dtype == torch.float32:
        y = x @ w
    elif x.is_cuda:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w,
                     out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        y = x.float() @ w.float()
    return (y * scale).to(dtype)


def _new_projection(module: nn.Module, cfg: ModelConfig, name: str,
                    shape: Tuple[int, int], bias: bool, device) -> None:
    """Register projection `name`, an (in, out) matrix: float, or under
    int8 weights int8 with an fp32 per-column `<name>_scale`; and its
    `<name>_bias` when `bias` (None otherwise)."""
    if cfg.weight_quant == 'int8' and name in QUANT_PROJECTIONS:
        module.register_parameter(name, nn.Parameter(
            torch.empty(shape, device=device, dtype=torch.int8),
            requires_grad=False))
        module.register_parameter(name + '_scale', nn.Parameter(
            torch.empty(shape[1], device=device, dtype=torch.float32),
            requires_grad=False))
    else:
        module.register_parameter(name, _new_param(cfg, shape, device))
    module.register_parameter(
        name + '_bias', _new_param(cfg, shape[1], device) if bias else None)


def _project(module: nn.Module, name: str, x: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """x times projection `name` of `module`, without its bias."""
    w = getattr(module, name)
    if w.dtype == torch.int8:
        return int8_matmul(x, w, getattr(module, name + '_scale'), dtype)
    return x @ w.to(dtype)


def _new_adapters(module: nn.Module, cfg: ModelConfig, shapes,
                  device) -> Tuple[str, ...]:
    """Register the LoRA training adapters of the targeted projections
    among `shapes` (name → (in, out)): `<name>_lora_a` (in, r) and
    `<name>_lora_b` (r, out) in the param dtype, trainable in training.
    Returns the targeted names (none without LoRA training)."""
    if not lora_training(cfg):
        return ()
    targets = lora_target_names(cfg)
    names = tuple(name for name in shapes if name in targets)
    r = cfg.lora_rank
    for name in names:
        d_in, d_out = shapes[name]
        for suffix, shape in (('_lora_a', (d_in, r)), ('_lora_b',
                                                       (r, d_out))):
            module.register_parameter(name + suffix, nn.Parameter(
                torch.empty(shape, device=device, dtype=param_dtype(cfg)),
                requires_grad=not cfg.decode))
    return names


def _with_adapters(module: nn.Module, y: torch.Tensor, x: torch.Tensor,
                   names, widths, dtype: torch.dtype) -> torch.Tensor:
    """y (a fused projection's output, whose column slices are the
    projections `names` of `widths`) with each targeted slice plus its
    LoRA delta ((x·A)·B) * (alpha / r), the reference's LoRADenseGeneral
    order in the compute dtype. Out of place: the saved products stay
    as autograd (and remat 'dots') saved them."""
    adapters = module.adapters
    if not any(name in adapters for name in names):
        return y

    def delta(name):
        z = x @ getattr(module, name + '_lora_a').to(dtype)
        z = z @ getattr(module, name + '_lora_b').to(dtype)
        return z * module.lora_scale

    if len(names) == 1:
        return y + delta(names[0])
    parts = list(torch.split(y, list(widths), dim=-1))
    for i, name in enumerate(names):
        if name in adapters:
            parts[i] = parts[i] + delta(name)
    return torch.cat(parts, dim=-1)


def _add_bias(module: nn.Module, name: str, y: torch.Tensor) -> torch.Tensor:
    bias = getattr(module, name + '_bias')
    return y if bias is None else y + bias.to(y.dtype)


class LoRAStack(nn.Module):
    """The resident adapters of one targeted projection: (slots, in, r)
    A and (slots, r, out) B buffers in the compute dtype, zero-filled
    (slot 0 stays the identity; the engine writes slots 1..N between
    ticks, in place). Its delta z * (alpha / r) is added by the
    `LoRAGroup` of its fused projection."""

    def __init__(self, cfg: ModelConfig, d_in: int, d_out: int,
                 device=None) -> None:
        super().__init__()
        slots, rank = cfg.serve_adapters + 1, cfg.lora_rank
        kwargs = dict(device=device, dtype=torch_dtype(cfg))
        self.register_buffer('a', torch.zeros((slots, d_in, rank), **kwargs),
                             persistent=False)
        self.register_buffer('b', torch.zeros((slots, rank, d_out), **kwargs),
                             persistent=False)


def _lora_stacks(cfg: ModelConfig, shapes, device) -> nn.ModuleDict:
    """A LoRAStack for each targeted projection among `shapes` (name →
    (in, out)); empty without serve adapters."""
    if not cfg.serve_adapters:
        return nn.ModuleDict()
    targets = lora_target_names(cfg)
    return nn.ModuleDict({
        name: LoRAStack(cfg, d_in, d_out, device)
        for name, (d_in, d_out) in shapes.items() if name in targets})


class _LoRASite:
    """The LoRAGroup of a fused projection whose output's column slices
    are the projections `names` (of `widths`): one target per targeted
    name. A call reads the LoRAStacks' buffers as they are then and
    builds the group anew when one was replaced (`model.to(...)` makes
    new buffers; the engine's slot writes keep them)."""

    def __init__(self, cfg: ModelConfig, stacks: nn.ModuleDict, names,
                 widths) -> None:
        self.stacks, self.offsets, start = [], [], 0
        for name, width in zip(names, widths):
            if name in stacks:
                self.stacks.append(stacks[name])
                self.offsets.append(start)
            start += width
        self.width, self.scale = start, cfg.lora_alpha / cfg.lora_rank
        self.group = self._build()

    def _build(self) -> LoRAGroup:
        return LoRAGroup([(s.a, s.b) for s in self.stacks], self.offsets,
                         self.width, self.scale)

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 adapter_ids: torch.Tensor) -> torch.Tensor:
        if any(s.a is not a or s.b is not b
               for s, (a, b) in zip(self.stacks, self.group.targets)):
            self.group = self._build()
        return self.group(x, y, adapter_ids)


def _lora_site(cfg: ModelConfig, stacks: nn.ModuleDict, names,
               widths) -> Optional[_LoRASite]:
    """The `_LoRASite` of a fused projection, None when none of `names`
    is targeted."""
    if not any(name in stacks for name in names):
        return None
    return _LoRASite(cfg, stacks, names, widths)


class PagedStep(NamedTuple):
    """Per-forward inputs every layer shares: positions, the rope cos/sin
    (None without rope), the tables the kernel reads through, and the
    pool scatter index."""
    positions: torch.Tensor     # (B, T) int32
    cos: Optional[torch.Tensor]  # (B, T, 1, rotary_dim / 2) fp32
    sin: Optional[torch.Tensor]
    read_tables: torch.Tensor   # (B, max_seq_len // bs) int32
    write_idx: torch.Tensor     # (B * T,) int64 flat pool rows


def paged_step(cfg: ModelConfig, positions: torch.Tensor,
               block_tables: torch.Tensor,
               freqs: Optional[torch.Tensor]) -> PagedStep:
    """Build the step once per forward (the reference recomputes it in
    every layer, where XLA deduplicates it; eager PyTorch would not).

    block_tables: (B, max_seq_len // bs + 1) int32; the extra last column
    is pinned to the scratch block and absorbs pad-token writes past
    max_seq_len via index clipping. Duplicate scatter indices (pad
    tokens, inert rows) all land on scratch block 0, whose contents are
    never visible to a live query."""
    if block_tables is None:
        raise ValueError('paged KV cache requires block_tables')
    if positions.shape[1] > cfg.max_seq_len:
        raise ValueError(
            f'prompt chunk {positions.shape[1]} exceeds max_seq_len '
            f'{cfg.max_seq_len}')
    bs = cfg.paged_block_size
    log_block = torch.clamp(positions // bs, 0,
                            block_tables.shape[1] - 1).long()
    phys = torch.gather(block_tables, 1, log_block)
    write_idx = (phys * bs + positions % bs).reshape(-1).long()
    cos, sin = (rope_cos_sin(positions, freqs) if freqs is not None
                else (None, None))
    return PagedStep(positions, cos, sin,
                     block_tables[:, :cfg.max_seq_len // bs], write_idx)


class ContiguousStep(NamedTuple):
    """Per-forward inputs every layer shares on the contiguous layout:
    positions, the rope cos/sin (None without rope), and the flat index
    of each chunk token's row in a layer's (B * max_seq_len, KV, D)
    cache view."""
    positions: torch.Tensor     # (B, T) int32
    cos: Optional[torch.Tensor]  # (B, T, 1, rotary_dim / 2) fp32
    sin: Optional[torch.Tensor]
    write_idx: torch.Tensor     # (B * T,) int64


def contiguous_step(cfg: ModelConfig, positions: torch.Tensor,
                    freqs: Optional[torch.Tensor]) -> ContiguousStep:
    """Build the step once per forward. Each row writes its T tokens
    contiguously from positions[:, 0], clamped to [0, S - T] as the
    reference's `dynamic_update_slice` clamps its start: a chunk that
    would run past the window lands at S - T. Inert rows ride decode
    dispatches with positions that advance in the graph, and a verify
    span may sit near the window; on the card an index past the cache
    would be a device-side assert, so the clamp is what keeps them in
    their own row."""
    batch, cur_len = positions.shape
    seq_len = cfg.max_seq_len
    if cur_len > seq_len:
        raise ValueError(f'prompt chunk {cur_len} exceeds max_seq_len '
                         f'{seq_len}')
    start = positions[:, :1].long().clamp(0, seq_len - cur_len)
    offsets = torch.arange(cur_len, device=positions.device)[None, :]
    rows = torch.arange(batch, device=positions.device)[:, None] * seq_len
    write_idx = (rows + start + offsets).reshape(-1)
    cos, sin = (rope_cos_sin(positions, freqs) if freqs is not None
                else (None, None))
    return ContiguousStep(positions, cos, sin, write_idx)


def _tp(group) -> int:
    return group.tp if group is not None else 1


class Attention(nn.Module):

    def __init__(self, cfg: ModelConfig, device=None, group=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg)
        tp = _tp(group)
        self.group = group if tp > 1 else None
        self.heads, self.kv_heads = cfg.num_heads // tp, cfg.num_kv_heads // tp
        shapes = projection_shapes(cfg, tp)
        q_out = self.heads * cfg.head_dim
        kv_out = self.kv_heads * cfg.head_dim
        self.qkv_names = fused_projections(cfg)['attn.qkv_proj']
        self.qkv_widths = (q_out, kv_out, kv_out)
        _new_projection(self, cfg, 'qkv_proj',
                        (cfg.d_model, q_out + 2 * kv_out), cfg.qkv_bias,
                        device)
        _new_projection(self, cfg, 'o_proj', (q_out, cfg.d_model),
                        cfg.o_bias, device)
        self.lora = _lora_stacks(cfg, {
            name: shapes[name]
            for name in ('q_proj', 'k_proj', 'v_proj', 'o_proj')}, device)
        self.lora_qkv = _lora_site(cfg, self.lora, self.qkv_names,
                                   self.qkv_widths)
        self.lora_o = _lora_site(cfg, self.lora, ('o_proj',),
                                 (cfg.d_model,))
        self.adapters = _new_adapters(self, cfg, {
            name: shapes[name]
            for name in ('q_proj', 'k_proj', 'v_proj', 'o_proj')}, device)
        self.lora_scale = cfg.lora_alpha / max(cfg.lora_rank, 1)

    def forward(self, x: torch.Tensor,
                step: 'PagedStep | ContiguousStep | FullStep',
                k_pool: Optional[torch.Tensor] = None,
                v_pool: Optional[torch.Tensor] = None,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        batch, cur_len, _ = x.shape
        heads, kv_heads, head_dim = self.heads, self.kv_heads, cfg.head_dim
        qkv = _with_adapters(self, _project(self, 'qkv_proj', x, self.dtype),
                             x, self.qkv_names, self.qkv_widths,
                             self.dtype)
        if adapter_ids is not None and self.lora_qkv is not None:
            self.lora_qkv(x, qkv, adapter_ids)
        qkv = _add_bias(self, 'qkv_proj', qkv)
        if cfg.qkv_clip:
            qkv = qkv.clamp(-cfg.qkv_clip, cfg.qkv_clip)
        q, k, v = torch.split(qkv, list(self.qkv_widths), dim=-1)
        q = _rotate(q.reshape(batch, cur_len, heads, head_dim), step.cos,
                    step.sin)
        k = _rotate(k.reshape(batch, cur_len, kv_heads, head_dim), step.cos,
                    step.sin)
        # v stays a strided view of the projection output: the flash
        # kernels read it through its strides.
        v = v.reshape(batch, cur_len, kv_heads, head_dim)
        if isinstance(step, ContiguousStep):
            out = self._contiguous_decode_attention(q, k, v, step, k_pool,
                                                    v_pool, k_scale, v_scale)
        elif cfg.decode:
            out = self._paged_decode_attention(q, k, v, step, k_pool, v_pool,
                                               k_scale, v_scale)
        else:
            out = flash_attention(q, k, v, causal=True,
                                  impl=cfg.attention_impl,
                                  logit_softcap=cfg.attn_logit_softcap,
                                  window=cfg.sliding_window)
        out = out.reshape(batch, cur_len, heads * head_dim)
        y = _with_adapters(self, _project(self, 'o_proj', out, self.dtype),
                           out, ('o_proj',), (cfg.d_model,), self.dtype)
        if adapter_ids is not None and self.lora_o is not None:
            self.lora_o(out, y, adapter_ids)
        if self.group is not None:
            y = self.group.all_reduce(y)
        return _add_bias(self, 'o_proj', y)

    def _contiguous_decode_attention(self, q, k, v, step: ContiguousStep,
                                     k_cache, v_cache, k_scale,
                                     v_scale) -> torch.Tensor:
        """The reference's contiguous `_decode_attention`: write the
        chunk's K/V into each row of this layer's cache from the row's
        clamped start (quantized, with their scales, under int8 KV: the
        same `int8_quantize` as the paged layout), then attend over the
        whole row through `attend_window`, the function the paged plain
        route calls after its gather, so contiguous equals paged on that
        route by construction. k_cache/v_cache (and k_scale/v_scale):
        this layer's (B, S, KV, D) (and (B, S, KV)) slices, written in
        place."""
        cfg = self.cfg
        kv_heads, head_dim = k.shape[2], k.shape[3]
        if k_scale is not None:
            k, k_s = int8_quantize(k)
            v, v_s = int8_quantize(v)
            k_scale.view(-1, kv_heads)[step.write_idx] = \
                k_s.reshape(-1, kv_heads)
            v_scale.view(-1, kv_heads)[step.write_idx] = \
                v_s.reshape(-1, kv_heads)
        k_cache.view(-1, kv_heads, head_dim)[step.write_idx] = \
            k.reshape(-1, kv_heads, head_dim)
        v_cache.view(-1, kv_heads, head_dim)[step.write_idx] = \
            v.reshape(-1, kv_heads, head_dim)
        return attend_window(q, k_cache, v_cache, step.positions,
                             head_dim ** -0.5, cfg.sliding_window,
                             k_scale, v_scale, cfg.attn_logit_softcap)

    def _paged_decode_attention(self, q, k, v, step: PagedStep, k_pool,
                                v_pool, k_scale, v_scale) -> torch.Tensor:
        """Write the chunk's K/V into this layer's pool at the step's
        scatter index (quantized, with their scale rows, when the pools
        are int8), then attend through the paged kernel, or under
        decode_kernel='xla' through its plain gather-and-attend version
        (the reference's XLA route, the one that serves a logit
        softcap). k_pool/v_pool (and k_scale/v_scale): this layer's
        (num_blocks, bs, KV, D) (and (num_blocks, bs, KV, 1)) slices,
        written in place."""
        cfg = self.cfg
        kv_heads, head_dim = k.shape[2], k.shape[3]
        if k_scale is not None:
            k, k_s = int8_quantize(k)
            v, v_s = int8_quantize(v)
            k_scale.view(-1, kv_heads, 1)[step.write_idx] = \
                k_s.reshape(-1, kv_heads, 1)
            v_scale.view(-1, kv_heads, 1)[step.write_idx] = \
                v_s.reshape(-1, kv_heads, 1)
        k_pool.view(-1, kv_heads, head_dim)[step.write_idx] = \
            k.reshape(-1, kv_heads, head_dim)
        v_pool.view(-1, kv_heads, head_dim)[step.write_idx] = \
            v.reshape(-1, kv_heads, head_dim)
        attend = (paged_decode_attention_plain if cfg.decode_kernel == 'xla'
                  else paged_decode_attention)
        # Without rope (learned positions) q is still a strided view of
        # the projection's output; the kernel reads contiguous queries.
        return attend(q.contiguous(), k_pool, v_pool, step.read_tables,
                      step.positions,
                      k_scale=k_scale, v_scale=v_scale,
                      window=cfg.sliding_window,
                      logit_softcap=cfg.attn_logit_softcap)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return nn.functional.gelu(x, approximate='tanh')


class SwiGLU(nn.Module):
    """Feed-forward in the family's dialect: GLU (gate * act, times up,
    then down; one fused gate_up_proj) or 'plain' (up, act, down; GPT-2,
    Falcon, Phi), act SiLU or the tanh-approximate GELU, optional biases
    (after the LoRA delta)."""

    def __init__(self, cfg: ModelConfig, device=None, group=None) -> None:
        super().__init__()
        self.dtype = torch_dtype(cfg)
        self.group = group if _tp(group) > 1 else None
        self.d_mlp = cfg.d_mlp // _tp(group)
        self.glu = cfg.mlp_style == 'glu'
        self.act = (nn.functional.silu if cfg.mlp_activation == 'silu'
                    else _gelu_tanh)
        self.up_name = 'gate_up_proj' if self.glu else 'up_proj'
        ins = fused_projections(cfg)['mlp.' + self.up_name]
        _new_projection(self, cfg, self.up_name,
                        (cfg.d_model, len(ins) * self.d_mlp), cfg.mlp_bias,
                        device)
        _new_projection(self, cfg, 'down_proj', (self.d_mlp, cfg.d_model),
                        cfg.mlp_bias, device)
        shapes = projection_shapes(cfg, _tp(group))
        self.lora = _lora_stacks(cfg, {
            name: shapes[name] for name in ins + ('down_proj',)}, device)
        self.lora_gate_up = _lora_site(cfg, self.lora, ins,
                                       (self.d_mlp,) * len(ins))
        self.lora_down = _lora_site(cfg, self.lora, ('down_proj',),
                                    (cfg.d_model,))
        self.up_names = ins
        self.adapters = _new_adapters(self, cfg, {
            name: shapes[name] for name in ins + ('down_proj',)}, device)
        self.lora_scale = cfg.lora_alpha / max(cfg.lora_rank, 1)
        self.d_model = cfg.d_model

    def forward(self, x: torch.Tensor,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        up = _with_adapters(self, _project(self, self.up_name, x, self.dtype),
                            x, self.up_names, (self.d_mlp,) * len(
                                self.up_names), self.dtype)
        if adapter_ids is not None and self.lora_gate_up is not None:
            self.lora_gate_up(x, up, adapter_ids)
        up = _add_bias(self, self.up_name, up)
        if self.glu:
            gate, up = torch.split(up, self.d_mlp, dim=-1)
            h = self.act(gate) * up
        else:
            h = self.act(up)
        y = _with_adapters(self, _project(self, 'down_proj', h, self.dtype),
                           h, ('down_proj',), (self.d_model,), self.dtype)
        if adapter_ids is not None and self.lora_down is not None:
            self.lora_down(h, y, adapter_ids)
        if self.group is not None:
            y = self.group.all_reduce(y)
        return _add_bias(self, 'down_proj', y)


class DecoderLayer(nn.Module):
    """Pre-norm block: sequential, x + attn(norm(x)) then x + mlp(norm(x))
    (x + moe(norm(x)) under MoE); or parallel (Falcon, Phi: one
    attn_norm, no mlp_norm), x + attn(h) + mlp(h) with h = attn_norm(x)."""

    def __init__(self, cfg: ModelConfig, device=None, group=None) -> None:
        super().__init__()
        self.parallel = cfg.parallel_block
        if self.parallel and cfg.is_moe:
            raise NotImplementedError(
                'parallel_block + MoE is not modeled (no family uses it); '
                'use the sequential block for MoE')
        self.attn_norm = RMSNorm(cfg, device)
        self.attn = Attention(cfg, device, group)
        self.mlp_norm = None if self.parallel else RMSNorm(cfg, device)
        self.mlp = None if cfg.is_moe else SwiGLU(cfg, device, group)
        self.moe = MoEBlock(cfg, device, group) if cfg.is_moe else None

    def forward(self, x: torch.Tensor,
                step: 'PagedStep | ContiguousStep | FullStep',
                k_pool: Optional[torch.Tensor] = None,
                v_pool: Optional[torch.Tensor] = None,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.attn_norm(x)
        x = x + self.attn(h, step, k_pool, v_pool, k_scale, v_scale,
                          adapter_ids)
        if self.parallel:
            return x + self.mlp(h, adapter_ids)
        if self.moe is not None:
            return x + self.moe(self.mlp_norm(x))
        return x + self.mlp(self.mlp_norm(x), adapter_ids)


class FullStep(NamedTuple):
    """Per-forward inputs every layer shares on the training path: the
    rope cos/sin of positions 0..S-1 (or the caller's positions); None
    without rope."""
    cos: Optional[torch.Tensor]  # (B, S, 1, rotary_dim / 2) fp32
    sin: Optional[torch.Tensor]


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """remat_policy='dots': keep the outputs of the plain (unbatched)
    matmuls — the projections — and recompute everything else, as the
    reference's dots_with_no_batch_dims_saveable does."""
    del ctx, args, kwargs
    return (checkpoint_lib.CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else checkpoint_lib.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: str):
    if policy == 'dots':
        return functools.partial(
            checkpoint_lib.create_selective_checkpoint_contexts,
            _save_matmuls)
    if policy == 'full':
        return checkpoint_lib.noop_context_fn
    raise ValueError(f"remat_policy must be 'dots' or 'full', got "
                     f"{policy!r}")


class Transformer(nn.Module):
    """Embedding (plus a learned position table with
    pos_embedding='learned'), `num_layers` decoder layers, final norm,
    lm_head (none when tied: the embedding unembeds).

    Parameters are created EMPTY on `device` (the card unless the caller
    asks for another; without CUDA the default raises) in
    `param_dtype(cfg)`, as rank `group.rank`'s shard under a serving
    group of tp > 1, or as this rank's slices under `fsdp` (the module
    docstring); fill
    them with `init_random_` (seeded, one tensor at a time — an 8B model
    is never built in fp32 on the host) or `load_state_dict` (e.g. from
    models/convert.params_from_jax)."""

    def __init__(self, cfg: ModelConfig, device='cuda', group=None,
                 fsdp=None) -> None:
        super().__init__()
        tp = _tp(group)
        check_supported(cfg, tp)
        if fsdp is not None and (cfg.decode or tp > 1):
            raise ValueError('fsdp shards a training model of one tensor-'
                             'parallel rank')
        if torch.device(device).type == 'cuda' and \
                not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the model is built on the GPU by "
                "default — pass device='cpu' explicitly to build it on the "
                "CPU")
        self.cfg = cfg
        self.dtype = torch_dtype(cfg)
        self.group = group if tp > 1 else None
        self.kv_heads = cfg.num_kv_heads // tp
        self.vocab = cfg.vocab_size // tp
        # Under fsdp the whole parameters are only shapes; each rank's
        # slices are made below.
        pdev = 'meta' if fsdp is not None else device
        self.embed = _new_param(cfg, (self.vocab, cfg.d_model), pdev)
        self.pos_embed = (_new_param(cfg, (cfg.max_seq_len, cfg.d_model),
                                     pdev)
                          if cfg.pos_embedding == 'learned' else None)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, pdev, self.group)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg, pdev)
        if not cfg.tie_embeddings:
            _new_projection(self, cfg, 'lm_head',
                            (cfg.d_model, self.vocab), cfg.lm_head_bias,
                            pdev)
        rot = rotary_dim(cfg)
        self.register_buffer(
            'rope_freqs', rope_freqs(rot, cfg.rope_theta, cfg.rope_scaling,
                                     device=device) if rot else None,
            persistent=False)
        # Gemma's sqrt(d_model), rounded to the compute dtype before the
        # product as the reference rounds it (55.43 → 55.5 in bf16).
        self.embed_scale = (float(torch.tensor(cfg.d_model ** 0.5,
                                               dtype=self.dtype))
                            if cfg.scale_embed_by_dim else None)
        self.register_buffer(
            'pad_vocab', torch.arange(cfg.vocab_size, device=device) >=
            cfg.unpadded_vocab_size
            if 0 < cfg.unpadded_vocab_size < cfg.vocab_size else None,
            persistent=False)
        self.fsdp = (FullyShard(self, fsdp, device) if fsdp is not None
                     else None)

    @torch.no_grad()
    def init_random_(self, seed: int) -> 'Transformer':
        """Seeded random weights in place, from the reference's
        distributions: the embedding N(0, 1) untied, N(0, 1 / d_model)
        tied; the learned position table N(0, 0.02^2); every projection
        Flax's lecun_normal, a normal cut at +-2 sigma with sigma =
        sqrt(1 / fan_in) / 0.8796 (fan_in = the input axes, the first
        dimension of each (in, out) matrix, E x in for a MoE block's
        (E, in, out) expert stacks); norm scales 1 (0 for
        'rms_plus1', a delta from 1); biases 0; then, after every base
        parameter, the LoRA adapters: A from N(0, 1/r), B zeros (the
        forward equals the base model's). Draws on the parameters'
        own device (torch.Generator: other numbers than jax.random from
        the same seed). Float weights only: int8 weights are made from
        float ones (models/quantize.py). A rank of a serving group draws
        each whole parameter in turn (the same numbers as one device) and
        keeps its shard, so no rank ever holds the whole model; a rank of
        an fsdp group does the same with its slices (the LoRA adapters
        too)."""
        cfg = self.cfg
        if cfg.weight_quant == 'int8':
            raise ValueError('init_random_ draws float weights; quantize '
                             'them with models/quantize.quantize_state')
        if self.fsdp is not None:
            self.fsdp.load_full(random_params(cfg, seed, self.embed.device,
                                              adapters=True))
            return self
        if self.group is not None:
            params = dict(self.named_parameters())
            for name, value in random_params(cfg, seed, self.embed.device):
                params[name].copy_(sharding.shard_tensor(
                    name, value, cfg, self.group.tp, self.group.rank))
            return self
        gen = torch.Generator(device=self.embed.device).manual_seed(seed)
        adapters = []
        for name, param in self.named_parameters():
            if name.endswith(('_lora_a', '_lora_b')):
                adapters.append((name, param))
            else:
                _init_param(cfg, name, param, gen)
        for name, param in adapters:
            if name.endswith('_lora_a'):
                param.normal_(0.0, cfg.lora_rank ** -0.5, generator=gen)
            else:
                param.zero_()
        return self

    def new_kv_pool(self, num_blocks: int) -> Tuple[torch.Tensor, ...]:
        """Zeroed (num_layers, num_blocks, block_size, KV, D) K and V
        pools on the model's device, in the model's dtype; under int8 KV
        int8 pools followed by fp32 (num_layers, num_blocks, block_size,
        KV, 1) K and V scale pools filled with ones (the reference's
        initial scale rows)."""
        cfg = self.cfg
        shape = (cfg.num_layers, num_blocks, cfg.paged_block_size,
                 self.kv_heads, cfg.head_dim)
        device = self.embed.device
        if cfg.kv_cache_quant != 'int8':
            kwargs = dict(device=device, dtype=self.embed.dtype)
            return torch.zeros(shape, **kwargs), torch.zeros(shape, **kwargs)
        scale_shape = shape[:-1] + (1,)
        return (torch.zeros(shape, device=device, dtype=torch.int8),
                torch.zeros(shape, device=device, dtype=torch.int8),
                torch.ones(scale_shape, device=device, dtype=torch.float32),
                torch.ones(scale_shape, device=device, dtype=torch.float32))

    def new_kv_cache(self, batch: int) -> Tuple[torch.Tensor, ...]:
        """Zeroed contiguous (num_layers, batch, max_seq_len, KV, D) K
        and V caches on the model's device in the model's dtype; under
        int8 KV int8 caches followed by fp32 (num_layers, batch,
        max_seq_len, KV) K and V scales, zero-filled as the reference's
        engine fills its slot cache."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cfg.max_seq_len, self.kv_heads,
                 cfg.head_dim)
        device = self.embed.device
        if cfg.kv_cache_quant != 'int8':
            kwargs = dict(device=device, dtype=self.embed.dtype)
            return torch.zeros(shape, **kwargs), torch.zeros(shape, **kwargs)
        scale_kw = dict(device=device, dtype=torch.float32)
        return (torch.zeros(shape, device=device, dtype=torch.int8),
                torch.zeros(shape, device=device, dtype=torch.int8),
                torch.zeros(shape[:-1], **scale_kw),
                torch.zeros(shape[:-1], **scale_kw))

    def lora_stacks(self):
        """(layer index, projection name, LoRAStack) of every targeted
        projection, in layer order."""
        for i, layer in enumerate(self.layers):
            for module in (layer.attn, layer.mlp):
                if module is None:
                    continue
                for name, stack in module.lora.items():
                    yield i, name, stack

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                k_pool: Optional[torch.Tensor] = None,
                v_pool: Optional[torch.Tensor] = None,
                logits_at: Optional[int | torch.Tensor] = None,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens/positions: (B, T) int. Serving (cfg.decode):
        block_tables (B, bps + 1) int32 and the (L, NB, bs, KV, D) pools
        k_pool/v_pool, written in place (int8 under int8 KV, with the
        (L, NB, bs, KV, 1) scale pools k_scale/v_scale); without pool
        geometry (cfg.paged_block_size 0) no tables and the contiguous
        (L, B, S, KV, D) caches of `new_kv_cache` in their place (scales
        (L, B, S, KV)); adapter_ids
        (B,) int32 adapter slots of a multi-LoRA model (None: no deltas).
        Positions default to 0..T-1 (training); the pools are not used
        in training.
        Returns (B, T, vocab) logits in cfg.dtype, or (B, vocab) for the
        single position `logits_at` (an int, or a 0-d int device
        tensor)."""
        cfg = self.cfg
        if positions is None:
            positions = _default_positions(tokens)
        if self.fsdp is not None:
            return self._forward_fsdp(tokens, positions)
        x = self._embed_in(tokens, positions)
        if cfg.decode:
            if (k_scale is not None) != (cfg.kv_cache_quant == 'int8'):
                raise ValueError('int8 KV takes k_scale/v_scale pools, and '
                                 'only int8 KV does')
            step = (paged_step(cfg, positions, block_tables,
                               self.rope_freqs) if cfg.paged_block_size
                    else contiguous_step(cfg, positions, self.rope_freqs))
            for i, layer in enumerate(self.layers):
                scales = ((k_scale[i], v_scale[i]) if k_scale is not None
                          else (None, None))
                x = layer(x, step, k_pool[i], v_pool[i], *scales,
                          adapter_ids)
        else:
            step = FullStep(*(rope_cos_sin(positions, self.rope_freqs)
                              if self.rope_freqs is not None
                              else (None, None)))
            remat = cfg.remat and torch.is_grad_enabled()
            context_fn = _remat_context(cfg.remat_policy) if remat else None
            for layer in self.layers:
                if remat:
                    x = checkpoint_lib.checkpoint(
                        layer, x, step, use_reentrant=False,
                        context_fn=context_fn)
                else:
                    x = layer(x, step)
        if isinstance(logits_at, torch.Tensor):
            # A 0-d device index (the prefill graph's): no host read.
            x = x.index_select(1, logits_at.reshape(1))[:, 0]
        elif logits_at is not None:
            x = x[:, logits_at]
        return self._head(self.final_norm(x))

    def _forward_fsdp(self, tokens: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        """The training forward of an fsdp rank (parallel/fsdp.py): the
        embedding, each layer and the head, each with its unit's whole
        weights gathered just before it runs; a layer under remat
        gathers them again in its recompute."""
        cfg, fsdp = self.cfg, self.fsdp
        with fsdp.running('embed', save_handles=False):
            x = self._embed_in(tokens, positions)
        step = FullStep(*(rope_cos_sin(positions, self.rope_freqs)
                          if self.rope_freqs is not None else (None, None)))
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = _remat_context(cfg.remat_policy) if remat else None
        for i, layer in enumerate(self.layers):
            run = fsdp.layer(i, layer, save_handles=not remat)
            if remat:
                x = checkpoint_lib.checkpoint(run, x, step,
                                              use_reentrant=False,
                                              context_fn=context_fn)
            else:
                x = run(x, step)
        with fsdp.running('head', save_handles=False):
            return self._head(self.final_norm(x))

    def _embed_in(self, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """The decoder's input: the token embedding (Gemma's scale) plus
        the learned position table at each row's positions."""
        x = self._embed(tokens)
        if self.embed_scale is not None:
            x = x * self.embed_scale
        if self.pos_embed is not None:
            # Pad and inert rows may sit past the table: clamp (their
            # outputs are never read).
            x = x + nn.functional.embedding(
                positions.long().clamp(0, self.cfg.max_seq_len - 1),
                self.pos_embed).to(self.dtype)
        return x

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token embedding in the compute dtype; under tp each rank
        looks up the tokens in its vocab rows, zeros the others, and one
        all-reduce sums the ranks' rows (x + 0 is exact)."""
        if self.group is None:
            return nn.functional.embedding(tokens.long(),
                                           self.embed).to(self.dtype)
        local = tokens.long() - self.group.rank * self.vocab
        inside = (local >= 0) & (local < self.vocab)
        x = nn.functional.embedding(local.clamp(0, self.vocab - 1),
                                    self.embed).to(self.dtype)
        return self.group.all_reduce(x.masked_fill(~inside[..., None], 0))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Unembed (tied: x @ embed^T), then the final logit softcap and
        the padded-vocab mask (rows past unpadded_vocab_size at -1e30);
        under tp the ranks' vocab slices are gathered first."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = x @ self.embed.to(self.dtype).t()
        else:
            logits = _add_bias(self, 'lm_head',
                               _project(self, 'lm_head', x, self.dtype))
        if self.group is not None:
            logits = self.group.gather_vocab(logits, cfg.vocab_size)
        if cfg.final_logit_softcap:
            cap = cfg.final_logit_softcap
            logits = (cap * torch.tanh(logits.float() / cap)).to(
                logits.dtype)
        if self.pad_vocab is not None:
            logits = logits.masked_fill(self.pad_vocab, -1e30)
        return logits


def _init_param(cfg: ModelConfig, name: str, param: torch.Tensor,
                gen: torch.Generator) -> None:
    """Draw base parameter `name` in place (init_random_'s rule)."""
    if name.endswith('norm.weight'):
        param.fill_(0.0 if cfg.norm_style == 'rms_plus1' else 1.0)
    elif name.endswith('bias'):
        param.zero_()
    elif name == 'embed':
        param.normal_(0.0, cfg.d_model ** -0.5
                      if cfg.tie_embeddings else 1.0, generator=gen)
    elif name == 'pos_embed':
        param.normal_(0.0, 0.02, generator=gen)
    else:
        # fan_in: every axis but the last (an (E, in, out) expert stack
        # counts E x in, as flax's lecun_normal does).
        _truncated_normal_(param, math.prod(param.shape[:-1]) ** -0.5 /
                           _TRUNC_STD, gen)


def random_params(cfg: ModelConfig, seed: int, device,
                  adapters: bool = False):
    """The float base parameters `init_random_` draws for one device from
    `seed`, whole and one at a time, in the model's parameter order:
    (name, tensor) pairs on `device`, each made when the next is asked
    for, so a caller that keeps only a shard (or a quantized copy) never
    holds the whole model. Then, with `adapters`, LoRA training's
    adapters, drawn after the base from the same generator as
    init_random_ draws them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    # The shapes of the float base (adapter stacks are no parameters).
    whole = Transformer(dataclasses.replace(
        cfg, weight_quant='none', serve_adapters=0, lora_rank=0),
        device='meta')
    for name, meta in whole.named_parameters():
        value = torch.empty(meta.shape, dtype=meta.dtype, device=device)
        _init_param(cfg, name, value, gen)
        yield name, value
    if not (adapters and lora_training(cfg)):
        return
    for name, meta in Transformer(cfg, device='meta').named_parameters():
        if name.endswith(('_lora_a', '_lora_b')):
            value = torch.empty(meta.shape, dtype=meta.dtype, device=device)
            if name.endswith('_lora_a'):
                value.normal_(0.0, cfg.lora_rank ** -0.5, generator=gen)
            else:
                value.zero_()
            yield name, value


def _default_positions(tokens: torch.Tensor) -> torch.Tensor:
    """0..T-1 per row; under a per-rank sequence-parallel context
    (parallel/sharding.py) the rank holds tokens [rank T, (rank + 1) T) of
    the sequence, so its positions start at rank T."""
    ctx = sharding.current_sequence_parallel()
    start = ctx.rank * tokens.shape[1] if ctx is not None else 0
    return torch.arange(start, start + tokens.shape[1], dtype=torch.int32,
                        device=tokens.device).expand(tokens.shape)


def _truncated_normal_(param: torch.Tensor, std: float,
                       gen: torch.Generator, chunk: int = 1 << 24) -> None:
    """param <- std * N(0, 1) truncated to [-2, 2], by the inverse CDF of
    a uniform draw (how jax.random.truncated_normal draws), in fp32 row
    chunks of at most `chunk` elements, so that a large matrix never
    needs a full fp32 copy."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    flat = param.view(-1, param.shape[-1])
    rows = max(1, chunk // flat.shape[1])
    for start in range(0, flat.shape[0], rows):
        block = flat[start:start + rows]
        u = torch.rand(block.shape, generator=gen, device=param.device,
                       dtype=torch.float32)
        x = torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2)
        block.copy_(x.clamp_(-2.0, 2.0).mul_(std))
