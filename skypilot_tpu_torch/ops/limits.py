"""The shapes the port's CUDA kernels take, stated once.

The wrappers refuse anything else when a kernel launches; an engine or a
trainer on the card calls `check_kernel_shapes` at construction, so a
model the kernels cannot run fails there, before any request or step,
and never at its first tick. On the CPU the plain versions take any
shape and nothing here applies.
"""
from __future__ import annotations

from typing import Optional

# head_dim of every attention kernel (paged, flash, ring).
HEAD_DIMS = (64, 128, 256)
# Keys the paged kernel stages per loop step; a pool block must divide it.
PAGED_STEP_KEYS = 64


def check_kernel_shapes(head_dim: int,
                        paged_block_size: Optional[int] = None) -> None:
    """Raise ValueError naming the limit unless the attention kernels take
    `head_dim` and, when given, the paged kernel takes
    `paged_block_size`. Pure: reads no device."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f'the CUDA attention kernels take head_dim in '
                         f'{HEAD_DIMS}, got {head_dim}')
    if paged_block_size is not None and (
            paged_block_size <= 0 or PAGED_STEP_KEYS % paged_block_size):
        raise ValueError(f'the CUDA paged attention kernel takes a '
                         f'block_size that divides {PAGED_STEP_KEYS}, got '
                         f'{paged_block_size}')
