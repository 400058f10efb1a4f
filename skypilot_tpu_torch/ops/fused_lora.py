"""Fused multi-LoRA delta: the hand-written CUDA kernel and its plain twin.

Replaces the TPU kernel skypilot_tpu/ops/fused_lora.py `_lora_kernel`
(entry `fused_multi_lora`). The kernel lives in ops/csrc/fused_lora.cu
(sm_90a, built at first use by ops/_build.py and called through ctypes);
its source comment says what bounds it on the H100 and what its design
does about that.

`fused_multi_lora` is the wrapper the model calls, once per targeted
projection. On a CUDA tensor it launches the kernel or raises: a build
or launch failure is an error, never a quiet switch to the plain
version. Only a tensor that lies on the CPU takes
`fused_multi_lora_plain` (the reference's gather path,
transformer.MultiLoRADenseGeneral at :266-273). `fused_multi_lora.launches`
counts kernel launches (one per call; the kernel itself is a shrink and
an expand launch), so a run can show that its main path went through it.
"""
from __future__ import annotations

import ctypes

import torch

from skypilot_tpu_torch.ops import _build

_RANKS = (8, 16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fused_multi_lora_plain(x: torch.Tensor, a_stack: torch.Tensor,
                           b_stack: torch.Tensor,
                           adapter_ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather each row's A and B by its id
    (B, IN, r) / (B, r, OUT), then two batched products in x's dtype, so
    z is rounded to it between them. Used on the CPU and as the kernel's
    yardstick of correctness on the card."""
    ids = adapter_ids.long()
    a_sel = torch.index_select(a_stack, 0, ids).to(x.dtype)
    b_sel = torch.index_select(b_stack, 0, ids).to(x.dtype)
    return torch.bmm(torch.bmm(x, a_sel), b_sel)


def _lib() -> ctypes.CDLL:
    lib = _build.load('fused_lora')
    if not getattr(lib, '_signatures_set', False):
        fwd = lib.fused_lora_forward
        fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 +
                        [ctypes.c_void_p])
        fwd.restype = ctypes.c_int
        ws = lib.fused_lora_workspace_floats
        ws.argtypes = [ctypes.c_int] * 4
        ws.restype = ctypes.c_longlong
        lib._signatures_set = True
    return lib


def _launch(x, a_stack, b_stack, adapter_ids) -> torch.Tensor:
    batch, seq, d_in = x.shape
    rank, d_out = b_stack.shape[1], b_stack.shape[2]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f'fused LoRA kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    if a_stack.dtype != x.dtype or b_stack.dtype != x.dtype:
        raise TypeError('x and the adapter stacks must share one dtype')
    if rank not in _RANKS:
        raise ValueError(f'fused LoRA kernel takes rank in {_RANKS}, got '
                         f'{rank}')
    if adapter_ids.dtype != torch.int32:
        raise TypeError('adapter_ids must be int32')
    tensors = (x, a_stack, b_stack, adapter_ids)
    if any(t.device != x.device for t in tensors):
        raise ValueError('all fused LoRA inputs must be on one device')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('x, the stacks and adapter_ids must be contiguous')
    lib = _lib()
    out = torch.empty((batch, seq, d_out), dtype=x.dtype, device=x.device)
    workspace = torch.empty(
        lib.fused_lora_workspace_floats(batch, seq, d_in, rank),
        dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_lora_forward(
            x.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
            adapter_ids.data_ptr(), out.data_ptr(), workspace.data_ptr(),
            batch, seq, d_in, d_out, rank, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f'fused LoRA kernel launch failed: CUDA error '
                           f'{err}')
    fused_multi_lora.launches += 1
    return out


def fused_multi_lora(x: torch.Tensor, a_stack: torch.Tensor,
                     b_stack: torch.Tensor,
                     adapter_ids: torch.Tensor) -> torch.Tensor:
    """Per-row low-rank delta, UNSCALED (the caller applies alpha / r,
    as the reference keeps the scale in one place).

    Args:
      x: (B, T, IN) activations (contracted dims flattened to IN).
      a_stack: (slots, IN, r) resident adapter A stack.
      b_stack: (slots, r, OUT) resident adapter B stack.
      adapter_ids: (B,) int32 per-row slots in [0, slots) (0 = identity).

    Returns (B, T, OUT) in x.dtype.
    """
    if x.dim() != 3 or a_stack.dim() != 3 or b_stack.dim() != 3:
        raise ValueError('x, a_stack and b_stack must be 3-d')
    if a_stack.shape[0] != b_stack.shape[0] or \
            a_stack.shape[1] != x.shape[2] or \
            a_stack.shape[2] != b_stack.shape[1]:
        raise ValueError(
            f'stack shapes {tuple(a_stack.shape)} / {tuple(b_stack.shape)} '
            f'do not fit x {tuple(x.shape)}')
    if tuple(adapter_ids.shape) != (x.shape[0],):
        raise ValueError('adapter_ids must be (B,)')
    if x.device.type == 'cpu':
        return fused_multi_lora_plain(x, a_stack, b_stack, adapter_ids)
    if x.device.type != 'cuda':
        raise ValueError(f'fused LoRA runs on cuda (kernel) or cpu (plain '
                         f'version), not {x.device.type}')
    return _launch(x, a_stack, b_stack, adapter_ids)


fused_multi_lora.launches = 0
