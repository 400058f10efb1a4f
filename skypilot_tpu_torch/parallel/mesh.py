"""The sp part of the reference's mesh inference
(skypilot_tpu/parallel/mesh.py `infer_mesh_config`): the port has one
parallel axis, `sp`, so every process (or, in one process, every ring
position) is one sp rank and no remainder may go elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; the port has the sequence axis only."""
    sp: int = 1

    def __str__(self) -> str:
        return f'MeshConfig(sp={self.sp})' if self.sp > 1 else \
            'MeshConfig(1 device)'


def infer_mesh_config(n_devices: int, *,
                      sp: Optional[int] = None) -> MeshConfig:
    """The mesh over `n_devices` with the given sp. The reference sends
    the remainder to fsdp; the port has no fsdp (or dp) axis yet, so the
    remainder must be 1. Raises with the reference's messages."""
    fixed = {'sp': sp}
    known = sp or 1
    if known < 1:
        raise ValueError(f'axis sizes must be positive, got {fixed}')
    if n_devices % known:
        raise ValueError(f'axes {fixed} do not divide {n_devices}')
    if known != n_devices:
        raise ValueError(
            f'axis product {known} != device count {n_devices} ({fixed}, '
            f'fsdp={n_devices // known}); the port has no fsdp or dp axis '
            f'yet')
    return MeshConfig(sp=known)
