"""Llama-3-style decoder in PyTorch (dense MLP): the serving path (paged
KV) and the training path (full sequence).

Port of skypilot_tpu/models/transformer.py. Like the reference, the model
branches on `cfg.decode`:
- decode=True (the serving engine): every attention call — a prefill
  chunk, a decode step — writes its K/V into the shared paged pool through
  the block tables and attends through ops/paged_attention.
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
  buffer the engine owns, and copying 8 GB per step would be absurd.
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
- `cfg.remat` is per-layer `torch.utils.checkpoint` (non-reentrant):
  remat_policy 'dots' saves the matmul outputs (the reference's
  dots_with_no_batch_dims_saveable) through a selective-checkpoint
  policy, 'full' saves nothing. Values do not depend on the policy.

Family knobs beyond Llama-3 (biases, softcaps, parallel block, MoE,
int8 weights, LoRA training, learned positions, LayerNorm, tied
embeddings, padded vocab) are refused at construction; ROADMAP.md queues
them.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as checkpoint_lib

from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.ops.flash_attention import flash_attention
from skypilot_tpu_torch.ops.fused_lora import LoRAGroup
from skypilot_tpu_torch.ops.paged_attention import paged_decode_attention
from skypilot_tpu_torch.parallel import sharding

# lecun_normal's truncation: N(0, 1) cut at +-2 has std 0.8796...
_TRUNC_STD = 0.87962566103423978


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The compute (activation) dtype."""
    return getattr(torch, cfg.dtype)


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """Where the weights live: cfg.dtype when serving (decode), else
    cfg.param_dtype (training)."""
    return getattr(torch, cfg.dtype if cfg.decode else cfg.param_dtype)


def _new_param(cfg: ModelConfig, shape, device) -> nn.Parameter:
    return nn.Parameter(
        torch.empty(shape, device=device, dtype=param_dtype(cfg)),
        requires_grad=not cfg.decode)


def _unsupported_knobs(cfg: ModelConfig) -> list:
    checks = {
        'qkv_bias': cfg.qkv_bias, 'o_bias': cfg.o_bias,
        'mlp_bias': cfg.mlp_bias, 'lm_head_bias': cfg.lm_head_bias,
        'qkv_clip': cfg.qkv_clip,
        'attn_logit_softcap': cfg.attn_logit_softcap,
        'final_logit_softcap': cfg.final_logit_softcap,
        'parallel_block': cfg.parallel_block,
        'num_experts': cfg.num_experts,
        'weight_quant': cfg.weight_quant != 'none',
        'kv_cache_quant': cfg.kv_cache_quant not in ('', 'int8'),
        # LoRA training (lora_rank without serve adapters) is not ported.
        'lora_rank': cfg.lora_rank and not cfg.serve_adapters,
        'pos_embedding': cfg.pos_embedding != 'rope',
        'norm_style': cfg.norm_style != 'rms',
        'mlp_style': cfg.mlp_style != 'glu',
        'mlp_activation': cfg.mlp_activation != 'silu',
        'rotary_pct': cfg.rotary_pct != 1.0,
        'tie_embeddings': cfg.tie_embeddings,
        'scale_embed_by_dim': cfg.scale_embed_by_dim,
        'unpadded_vocab_size': cfg.unpadded_vocab_size,
    }
    return sorted(name for name, on in checks.items() if on)


def check_supported(cfg: ModelConfig) -> None:
    """Refuse, at construction, every family knob this port has not
    ported (the Llama-3 dense decoder is all-defaults)."""
    bad = _unsupported_knobs(cfg)
    if bad:
        raise NotImplementedError(
            f'{cfg.name}: the PyTorch port serves the Llama-3 dense path '
            f'only; not ported yet: {", ".join(bad)}')
    if cfg.serve_adapters:
        if not cfg.decode:
            raise NotImplementedError(
                'serve_adapters is a serving (decode) knob; LoRA training '
                'is not ported yet')
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
    """'rms' (Llama) pre-norm; statistics in fp32 regardless of dtype."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.dtype = torch_dtype(cfg)
        self.weight = _new_param(cfg, cfg.d_model, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        return (normed * self.weight.float()).to(self.dtype)


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


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling=None) -> torch.Tensor:
    """Rotary position embedding. x: (B, S, H, D); positions: (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, scaling, device=x.device)
    return _rotate(x, *rope_cos_sin(positions, freqs))


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
    """Per-forward inputs every layer shares: positions, the rope cos/sin,
    the tables the kernel reads through, and the pool scatter index."""
    positions: torch.Tensor     # (B, T) int32
    cos: torch.Tensor           # (B, T, 1, D / 2) fp32
    sin: torch.Tensor
    read_tables: torch.Tensor   # (B, max_seq_len // bs) int32
    write_idx: torch.Tensor     # (B * T,) int64 flat pool rows


def paged_step(cfg: ModelConfig, positions: torch.Tensor,
               block_tables: torch.Tensor,
               freqs: torch.Tensor) -> PagedStep:
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
    cos, sin = rope_cos_sin(positions, freqs)
    return PagedStep(positions, cos, sin,
                     block_tables[:, :cfg.max_seq_len // bs], write_idx)


class Attention(nn.Module):

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg)
        q_out = cfg.num_heads * cfg.head_dim
        kv_out = cfg.num_kv_heads * cfg.head_dim
        self.qkv_widths = (q_out, kv_out, kv_out)
        self.qkv_proj = _new_param(cfg, (cfg.d_model, q_out + 2 * kv_out),
                                   device)
        self.o_proj = _new_param(cfg, (q_out, cfg.d_model), device)
        self.lora = _lora_stacks(cfg, {
            'q_proj': (cfg.d_model, q_out), 'k_proj': (cfg.d_model, kv_out),
            'v_proj': (cfg.d_model, kv_out),
            'o_proj': (q_out, cfg.d_model)}, device)
        self.lora_qkv = _lora_site(cfg, self.lora, ('q_proj', 'k_proj',
                                                    'v_proj'),
                                   self.qkv_widths)
        self.lora_o = _lora_site(cfg, self.lora, ('o_proj',),
                                 (cfg.d_model,))

    def forward(self, x: torch.Tensor, step: 'PagedStep | FullStep',
                k_pool: Optional[torch.Tensor] = None,
                v_pool: Optional[torch.Tensor] = None,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        batch, cur_len, _ = x.shape
        heads, kv_heads, head_dim = (cfg.num_heads, cfg.num_kv_heads,
                                     cfg.head_dim)
        qkv = x @ self.qkv_proj.to(self.dtype)
        if adapter_ids is not None and self.lora_qkv is not None:
            self.lora_qkv(x, qkv, adapter_ids)
        q, k, v = torch.split(qkv, list(self.qkv_widths), dim=-1)
        q = _rotate(q.reshape(batch, cur_len, heads, head_dim), step.cos,
                    step.sin)
        k = _rotate(k.reshape(batch, cur_len, kv_heads, head_dim), step.cos,
                    step.sin)
        # v stays a strided view of the projection output: the flash
        # kernels read it through its strides.
        v = v.reshape(batch, cur_len, kv_heads, head_dim)
        if cfg.decode:
            out = self._paged_decode_attention(q, k, v, step, k_pool, v_pool,
                                               k_scale, v_scale)
        else:
            out = flash_attention(q, k, v, causal=True,
                                  impl=cfg.attention_impl,
                                  logit_softcap=cfg.attn_logit_softcap,
                                  window=cfg.sliding_window)
        out = out.reshape(batch, cur_len, heads * head_dim)
        y = out @ self.o_proj.to(self.dtype)
        if adapter_ids is not None and self.lora_o is not None:
            self.lora_o(out, y, adapter_ids)
        return y

    def _paged_decode_attention(self, q, k, v, step: PagedStep, k_pool,
                                v_pool, k_scale, v_scale) -> torch.Tensor:
        """Write the chunk's K/V into this layer's pool at the step's
        scatter index (quantized, with their scale rows, when the pools
        are int8), then attend through the paged kernel. k_pool/v_pool
        (and k_scale/v_scale): this layer's (num_blocks, bs, KV, D) (and
        (num_blocks, bs, KV, 1)) slices, written in place."""
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
        return paged_decode_attention(q, k_pool, v_pool, step.read_tables,
                                      step.positions, k_scale=k_scale,
                                      v_scale=v_scale,
                                      window=cfg.sliding_window,
                                      logit_softcap=cfg.attn_logit_softcap)


class SwiGLU(nn.Module):

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.dtype = torch_dtype(cfg)
        self.d_mlp = cfg.d_mlp
        self.gate_up_proj = _new_param(cfg, (cfg.d_model, 2 * cfg.d_mlp),
                                       device)
        self.down_proj = _new_param(cfg, (cfg.d_mlp, cfg.d_model), device)
        self.lora = _lora_stacks(cfg, {
            'gate_proj': (cfg.d_model, cfg.d_mlp),
            'up_proj': (cfg.d_model, cfg.d_mlp),
            'down_proj': (cfg.d_mlp, cfg.d_model)}, device)
        self.lora_gate_up = _lora_site(cfg, self.lora,
                                       ('gate_proj', 'up_proj'),
                                       (self.d_mlp, self.d_mlp))
        self.lora_down = _lora_site(cfg, self.lora, ('down_proj',),
                                    (cfg.d_model,))

    def forward(self, x: torch.Tensor,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        gate_up = x @ self.gate_up_proj.to(self.dtype)
        if adapter_ids is not None and self.lora_gate_up is not None:
            self.lora_gate_up(x, gate_up, adapter_ids)
        gate, up = torch.split(gate_up, self.d_mlp, dim=-1)
        h = nn.functional.silu(gate) * up
        y = h @ self.down_proj.to(self.dtype)
        if adapter_ids is not None and self.lora_down is not None:
            self.lora_down(h, y, adapter_ids)
        return y


class DecoderLayer(nn.Module):
    """Sequential pre-norm block: x + attn(norm(x)), then x + mlp(norm(x))."""

    def __init__(self, cfg: ModelConfig, device=None) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg, device)
        self.mlp = SwiGLU(cfg, device)

    def forward(self, x: torch.Tensor, step: 'PagedStep | FullStep',
                k_pool: Optional[torch.Tensor] = None,
                v_pool: Optional[torch.Tensor] = None,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), step, k_pool, v_pool, k_scale,
                          v_scale, adapter_ids)
        return x + self.mlp(self.mlp_norm(x), adapter_ids)


class FullStep(NamedTuple):
    """Per-forward inputs every layer shares on the training path: the
    rope cos/sin of positions 0..S-1 (or the caller's positions)."""
    cos: torch.Tensor           # (B, S, 1, D / 2) fp32
    sin: torch.Tensor


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
    """Embedding, `num_layers` decoder layers, final norm, untied lm_head.

    Parameters are created EMPTY on `device` (the card unless the caller
    asks for another; without CUDA the default raises) in
    `param_dtype(cfg)`; fill
    them with `init_random_` (seeded, one tensor at a time — an 8B model
    is never built in fp32 on the host) or `load_state_dict` (e.g. from
    models/convert.params_from_jax)."""

    def __init__(self, cfg: ModelConfig, device='cuda') -> None:
        super().__init__()
        check_supported(cfg)
        if torch.device(device).type == 'cuda' and \
                not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the model is built on the GPU by "
                "default — pass device='cpu' explicitly to build it on the "
                "CPU")
        if cfg.decode and not cfg.paged_block_size:
            raise NotImplementedError(
                'the PyTorch port serves the paged KV layout only '
                '(paged_block_size > 0); the contiguous layout is not '
                'ported yet')
        self.cfg = cfg
        self.dtype = torch_dtype(cfg)
        self.embed = _new_param(cfg, (cfg.vocab_size, cfg.d_model), device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg, device)
        self.lm_head = _new_param(cfg, (cfg.d_model, cfg.vocab_size), device)
        self.register_buffer(
            'rope_freqs', rope_freqs(cfg.head_dim, cfg.rope_theta,
                                     cfg.rope_scaling, device=device),
            persistent=False)

    @torch.no_grad()
    def init_random_(self, seed: int) -> 'Transformer':
        """Seeded random weights in place, from the reference's
        distributions: the untied embedding N(0, 1); every projection
        Flax's lecun_normal, a normal cut at +-2 sigma with sigma =
        sqrt(1 / fan_in) / 0.8796 (fan_in = the input axes, the first
        dimension of each (in, out) matrix); norm scales 1. Draws on the
        parameters' own device (torch.Generator: other numbers than
        jax.random from the same seed)."""
        gen = torch.Generator(device=self.embed.device).manual_seed(seed)
        for name, param in self.named_parameters():
            if name.endswith('norm.weight'):
                param.fill_(1.0)
            elif name == 'embed':
                param.normal_(0.0, 1.0, generator=gen)
            else:
                _truncated_normal_(param, param.shape[0] ** -0.5 /
                                   _TRUNC_STD, gen)
        return self

    def new_kv_pool(self, num_blocks: int) -> Tuple[torch.Tensor, ...]:
        """Zeroed (num_layers, num_blocks, block_size, KV, D) K and V
        pools on the model's device, in the model's dtype; under int8 KV
        int8 pools followed by fp32 (num_layers, num_blocks, block_size,
        KV, 1) K and V scale pools filled with ones (the reference's
        initial scale rows)."""
        cfg = self.cfg
        shape = (cfg.num_layers, num_blocks, cfg.paged_block_size,
                 cfg.num_kv_heads, cfg.head_dim)
        device = self.embed.device
        if cfg.kv_cache_quant != 'int8':
            kwargs = dict(device=device, dtype=self.embed.dtype)
            return torch.zeros(shape, **kwargs), torch.zeros(shape, **kwargs)
        scale_shape = shape[:-1] + (1,)
        return (torch.zeros(shape, device=device, dtype=torch.int8),
                torch.zeros(shape, device=device, dtype=torch.int8),
                torch.ones(scale_shape, device=device, dtype=torch.float32),
                torch.ones(scale_shape, device=device, dtype=torch.float32))

    def lora_stacks(self):
        """(layer index, projection name, LoRAStack) of every targeted
        projection, in layer order."""
        for i, layer in enumerate(self.layers):
            for module in (layer.attn, layer.mlp):
                for name, stack in module.lora.items():
                    yield i, name, stack

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                block_tables: Optional[torch.Tensor] = None,
                k_pool: Optional[torch.Tensor] = None,
                v_pool: Optional[torch.Tensor] = None,
                logits_at: Optional[int] = None,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                adapter_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens/positions: (B, T) int. Serving (cfg.decode):
        block_tables (B, bps + 1) int32 and the (L, NB, bs, KV, D) pools
        k_pool/v_pool, written in place (int8 under int8 KV, with the
        (L, NB, bs, KV, 1) scale pools k_scale/v_scale); adapter_ids
        (B,) int32 adapter slots of a multi-LoRA model (None: no deltas).
        Training: positions default to 0..T-1 and the pools are not used.
        Returns (B, T, vocab) logits in cfg.dtype, or (B, vocab) for the
        single position `logits_at`."""
        cfg = self.cfg
        x = nn.functional.embedding(tokens.long(), self.embed).to(self.dtype)
        if cfg.decode:
            if (k_scale is not None) != (cfg.kv_cache_quant == 'int8'):
                raise ValueError('int8 KV takes k_scale/v_scale pools, and '
                                 'only int8 KV does')
            step = paged_step(cfg, positions, block_tables, self.rope_freqs)
            for i, layer in enumerate(self.layers):
                scales = ((k_scale[i], v_scale[i]) if k_scale is not None
                          else (None, None))
                x = layer(x, step, k_pool[i], v_pool[i], *scales,
                          adapter_ids)
        else:
            if positions is None:
                positions = _default_positions(tokens)
            step = FullStep(*rope_cos_sin(positions, self.rope_freqs))
            remat = cfg.remat and torch.is_grad_enabled()
            context_fn = _remat_context(cfg.remat_policy) if remat else None
            for layer in self.layers:
                if remat:
                    x = checkpoint_lib.checkpoint(
                        layer, x, step, use_reentrant=False,
                        context_fn=context_fn)
                else:
                    x = layer(x, step)
        if logits_at is not None:
            x = x[:, logits_at]
        return self.final_norm(x) @ self.lm_head.to(self.dtype)


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
    flat = param.view(param.shape[0], -1)
    rows = max(1, chunk // flat.shape[1])
    for start in range(0, flat.shape[0], rows):
        block = flat[start:start + rows]
        u = torch.rand(block.shape, generator=gen, device=param.device,
                       dtype=torch.float32)
        x = torch.erfinv(lo + (hi - lo) * u) * math.sqrt(2)
        block.copy_(x.clamp_(-2.0, 2.0).mul_(std))
