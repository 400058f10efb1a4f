"""Fused multi-LoRA: the hand-written CUDA kernel and its plain twin.

Replaces the TPU kernel skypilot_tpu/ops/fused_lora.py `_lora_kernel`
(entry `fused_multi_lora`) and the reference's scaled add after it
(transformer.MultiLoRADenseGeneral, y = y + z * (alpha / r)). The kernel
lives in ops/csrc/fused_lora.cu (sm_90a, built at first use by
ops/_build.py and called through ctypes); its source comment says what
bounds it on the H100 and what its design does about that.

`LoRAGroup` is what the model calls: the targets of one fused projection
that read one input (q, k, v; gate, up; o; down), each adding its scaled
delta into its column slice of the projection's output, in place. It
checks the static facts (stacks, ranks, dtypes, widths, offsets) once,
at construction; a call checks x, y and the ids and makes one ctypes
call (two launches). `fused_multi_lora` keeps the TPU entry's contract
(the unscaled delta z, a new tensor) through the same kernel.

On a CUDA tensor both launch the kernel or raise: a build or launch
failure is an error, never a quiet switch to the plain version. Only a
tensor that lies on the CPU takes the plain version (the reference's
gather path, transformer.MultiLoRADenseGeneral at :266-274).
`fused_multi_lora.launches` counts kernel wrapper calls (group calls and
`fused_multi_lora` calls), so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Sequence, Tuple

import torch

from skypilot_tpu_torch.ops import _build

_RANKS = (8, 16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_TARGETS = 3
_MISALIGNED = 716     # cudaErrorMisalignedAddress


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


class _Target(ctypes.Structure):
    _fields_ = [('a', ctypes.c_void_p), ('b', ctypes.c_void_p),
                ('d_out', ctypes.c_int), ('offset', ctypes.c_int)]


class _GroupDesc(ctypes.Structure):
    """ctypes twin of `GroupDesc` in ops/csrc/fused_lora.cu."""
    _fields_ = [('t', _Target * MAX_TARGETS), ('targets', ctypes.c_int),
                ('rank', ctypes.c_int), ('d_in', ctypes.c_int),
                ('width', ctypes.c_int), ('dtype', ctypes.c_int),
                ('scale', ctypes.c_float)]


def _lib() -> ctypes.CDLL:
    lib = _build.load('fused_lora')
    if not getattr(lib, '_signatures_set', False):
        desc = ctypes.POINTER(_GroupDesc)
        lib.fused_lora_group.argtypes = (
            [desc] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 +
            [ctypes.c_void_p])
        lib.fused_lora_group.restype = ctypes.c_int
        lib.fused_lora_workspace.argtypes = [
            desc, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong)]
        lib.fused_lora_workspace.restype = ctypes.c_int
        lib.fused_lora_plan.argtypes = [desc, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.fused_lora_plan.restype = ctypes.c_int
        lib._signatures_set = True
    return lib


# Per device: the scratch bytes of the fp32 partials. Calls share them in
# stream order, so groups on one device run on one stream at a time.
_workspaces: Dict[torch.device, torch.Tensor] = {}


def _workspace(device: torch.device, scratch: int) -> torch.Tensor:
    have = _workspaces.get(device)
    if have is None or have.numel() < scratch:
        have = torch.empty(scratch, dtype=torch.uint8, device=device)
        _workspaces[device] = have
    return have


class LoRAGroup:
    """The targeted projections of one fused projection output. Stacks
    that are not on the CPU must also meet the kernel's limits (rank,
    dtype), checked here; the CPU's plain version takes any.

    Args:
      targets: 1-3 (a_stack, b_stack) pairs, (slots, IN, r) and (slots, r,
        OUT_t), one dtype, device and rank among them; contiguous.
        The group holds these tensors and calls read them as they are
        then (the engine writes adapter slots in place); whoever replaces
        a stack (`model.to(...)` does) builds a new group.
      offsets: each target's first column in y; the slices
        [offset, offset + OUT_t) lie inside y and do not overlap.
      width: y's last dimension.
      scale: alpha / r, applied to each delta before the add.

    `group(x, y, adapter_ids)` adds, for every target t and row b,
    (x[b] . A_t[ids[b]]) . B_t[ids[b]] * scale into y[b, :, slice_t], in
    place, rounded as the eager `y[..., s] += z * scale` rounds. x (B, T,
    IN), y (B, T, width), adapter_ids (B,) int32 (slot 0 = identity).
    """

    def __init__(self, targets: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 offsets: Sequence[int], width: int, scale: float) -> None:
        if not 1 <= len(targets) <= MAX_TARGETS or \
                len(offsets) != len(targets):
            raise ValueError(f'a LoRA group takes 1-{MAX_TARGETS} targets '
                             f'with one offset each, got {len(targets)} '
                             f'and {len(offsets)}')
        a0, b0 = targets[0]
        slots, d_in, rank = (a0.shape if a0.dim() == 3 else (None,) * 3)
        spans = []
        for i, ((a, b), off) in enumerate(zip(targets, offsets)):
            if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or \
                    a.shape[2] != b.shape[1]:
                raise ValueError(
                    f'target {i}: mismatched stacks {tuple(a.shape)} / '
                    f'{tuple(b.shape)} (want (slots, IN, r) and (slots, '
                    f'r, OUT))')
            if (a.shape[0], a.shape[1]) != (slots, d_in):
                raise ValueError(
                    f'target {i}: mismatched stacks: (slots, IN) '
                    f'{tuple(a.shape[:2])} != target 0\'s {(slots, d_in)}')
            if a.shape[2] != rank:
                raise ValueError(f'target {i}: mismatched stacks: rank '
                                 f'{a.shape[2]} != target 0\'s {rank}')
            if b.dtype != a.dtype or a.dtype != a0.dtype:
                raise TypeError(f'target {i}: mismatched stacks: dtypes '
                                f'{a.dtype} / {b.dtype}, target 0 '
                                f'{a0.dtype}')
            if a.device != a0.device or b.device != a0.device:
                raise ValueError(f'target {i}: stacks on {a.device} / '
                                 f'{b.device}, not {a0.device}')
            if not (a.is_contiguous() and b.is_contiguous()):
                raise ValueError(f'target {i}: stacks must be contiguous')
            d_out = b.shape[2]
            if off < 0 or off + d_out > width:
                raise ValueError(f'target {i}: columns [{off}, '
                                 f'{off + d_out}) overrun y width {width}')
            spans.append((off, off + d_out))
        if a0.device.type != 'cpu':     # the kernel's limits
            if rank not in _RANKS:
                raise ValueError(f'the fused LoRA kernel takes rank in '
                                 f'{_RANKS}, got {rank}')
            if a0.dtype not in _DTYPE_CODE:
                raise TypeError(f'the fused LoRA kernel takes float32 or '
                                f'bfloat16, got {a0.dtype}')
        spans.sort()
        for (_, end), (start, _) in zip(spans, spans[1:]):
            if start < end:
                raise ValueError(f'target slices overlap at column {start}')
        self.targets = [(a, b) for a, b in targets]
        self.offsets = list(offsets)
        self.width, self.scale = width, float(scale)
        self.d_in, self.rank = d_in, rank
        self.dtype, self.device = a0.dtype, a0.device
        self._desc = None
        self._ws: Dict[Tuple[int, int, int], int] = {}

    def _plain(self, x, y, adapter_ids) -> None:
        for (a, b), off in zip(self.targets, self.offsets):
            y[..., off:off + b.shape[2]] += \
                fused_multi_lora_plain(x, a, b, adapter_ids) * self.scale

    def _descriptor(self) -> _GroupDesc:
        if self._desc is None:
            desc = _GroupDesc()
            for i, ((a, b), off) in enumerate(zip(self.targets,
                                                  self.offsets)):
                if a.data_ptr() % 16 or b.data_ptr() % 16:
                    raise ValueError('LoRA stacks must start on 16 bytes')
                desc.t[i] = _Target(a.data_ptr(), b.data_ptr(), b.shape[2],
                                    off)
            desc.targets, desc.rank, desc.d_in = (len(self.targets),
                                                  self.rank, self.d_in)
            desc.width, desc.dtype = self.width, _DTYPE_CODE[self.dtype]
            desc.scale = self.scale
            self._desc = desc
        return self._desc

    def _scratch(self, lib, batch: int, seq: int) -> int:
        key = (id(lib), batch, seq)   # a rebuilt library may plan anew
        if key not in self._ws:
            scratch = ctypes.c_longlong()
            err = lib.fused_lora_workspace(
                ctypes.byref(self._descriptor()), batch, seq,
                ctypes.byref(scratch))
            if err != 0:
                raise ValueError(f'fused LoRA kernel refused the group '
                                 f'(error {err})')
            self._ws[key] = scratch.value
        return self._ws[key]

    def plan(self, seq: int) -> Tuple[str, int]:
        """('tensor_cores' or 'cuda_cores', IN splits) of a call with T
        = seq on the card."""
        splits = ctypes.c_int()
        route = _lib().fused_lora_plan(ctypes.byref(self._descriptor()), seq,
                                       ctypes.byref(splits))
        if route < 0:
            raise ValueError('fused LoRA kernel refused the group')
        return ('tensor_cores' if route else 'cuda_cores'), splits.value

    def __call__(self, x: torch.Tensor, y: torch.Tensor,
                 adapter_ids: torch.Tensor) -> torch.Tensor:
        # A 'lora' range while a profiler runs (entering one costs ~10 us
        # of host time, so not otherwise).
        with (torch.profiler.record_function('lora')
              if torch.autograd.profiler._is_profiler_enabled  # pylint: disable=protected-access
              else contextlib.nullcontext()):
            if x.device.type == 'cpu':
                self._plain(x, y, adapter_ids)
                return y
            if x.device != self.device or y.device != self.device or \
                    adapter_ids.device != self.device:
                raise ValueError(f'x, y and adapter_ids must be on '
                                 f'{self.device}')
            if x.dtype != self.dtype or y.dtype != self.dtype:
                raise TypeError(f'x and y must be {self.dtype}, got '
                                f'{x.dtype} / {y.dtype}')
            if x.dim() != 3 or x.shape[2] != self.d_in or \
                    tuple(y.shape) != (x.shape[0], x.shape[1], self.width):
                raise ValueError(f'x {tuple(x.shape)} / y {tuple(y.shape)} '
                                 f'do not fit the group (IN {self.d_in}, '
                                 f'width {self.width})')
            if not (x.is_contiguous() and y.is_contiguous()):
                raise ValueError('x and y must be contiguous')
            if adapter_ids.dtype != torch.int32 or \
                    tuple(adapter_ids.shape) != (x.shape[0],):
                raise ValueError('adapter_ids must be (B,) int32')
            batch, seq = x.shape[0], x.shape[1]
            lib = _lib()
            scratch = _workspace(self.device,
                                 self._scratch(lib, batch, seq))
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = lib.fused_lora_group(
                ctypes.byref(self._desc), x.data_ptr(),
                adapter_ids.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                batch, seq, stream)
            if err == _MISALIGNED:
                raise ValueError('x and y must start on 16 bytes (the '
                                 "group's widths take 16-byte accesses)")
            if err != 0:
                raise RuntimeError(f'fused LoRA kernel launch failed: CUDA '
                                   f'error {err}')
            fused_multi_lora.launches += 1
            return y


def fused_multi_lora(x: torch.Tensor, a_stack: torch.Tensor,
                     b_stack: torch.Tensor,
                     adapter_ids: torch.Tensor) -> torch.Tensor:
    """Per-row low-rank delta, UNSCALED: the TPU entry's contract.

    Args:
      x: (B, T, IN) activations (contracted dims flattened to IN).
      a_stack: (slots, IN, r) resident adapter A stack.
      b_stack: (slots, r, OUT) resident adapter B stack.
      adapter_ids: (B,) int32 per-row slots in [0, slots) (0 = identity).

    Returns (B, T, OUT) in x.dtype. On the card: a one-target group with
    scale 1 adding into zeros (0 + round(z) is round(z)).
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
    if adapter_ids.dtype != torch.int32:
        raise TypeError('adapter_ids must be int32')
    if x.dtype != a_stack.dtype:
        raise TypeError(f'x and the adapter stacks must share one dtype, '
                        f'got {x.dtype} / {a_stack.dtype}')
    d_out = b_stack.shape[2]
    out = torch.zeros((x.shape[0], x.shape[1], d_out), dtype=x.dtype,
                      device=x.device)
    return LoRAGroup([(a_stack, b_stack)], [0], d_out, 1.0)(x, out,
                                                           adapter_ids)


fused_multi_lora.launches = 0
