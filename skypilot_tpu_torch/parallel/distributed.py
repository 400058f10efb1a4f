"""Process wiring for multi-process jobs: the counterpart of the
reference's skypilot_tpu/parallel/distributed.py (`topology_from_env`,
`initialize`, `:35-110`) over torchrun's variables (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) instead of the agent's.

`initialize` joins the default torch.distributed group: NCCL for `cuda`
(one card per process, LOCAL_RANK picks it), gloo for `cpu`. It does
nothing with one process and is idempotent.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Dict, Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    """One process's place in the job."""
    world_size: int
    rank: int
    local_rank: int
    master_addr: Optional[str]
    master_port: Optional[int]

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    @property
    def multiprocess(self) -> bool:
        return self.world_size > 1


def topology_from_env(env: Optional[Dict[str, str]] = None
                      ) -> ProcessTopology:
    e = dict(os.environ if env is None else env)
    port = e.get('MASTER_PORT')
    return ProcessTopology(
        world_size=int(e.get('WORLD_SIZE', '1')),
        rank=int(e.get('RANK', '0')),
        local_rank=int(e.get('LOCAL_RANK', '0')),
        master_addr=e.get('MASTER_ADDR'),
        master_port=int(port) if port else None,
    )


def initialize(topology: Optional[ProcessTopology] = None,
               device: str = 'cuda',
               timeout_seconds: int = 300) -> ProcessTopology:
    """Join this process to the job's default process group (no-op for
    one process, or when already joined). Returns the topology, so
    callers can branch on rank (rank 0 logs and checkpoints)."""
    import torch.distributed as dist
    if topology is None:
        topology = topology_from_env()
    if not topology.multiprocess or dist.is_initialized():
        return topology
    if topology.master_addr is None or topology.master_port is None:
        raise RuntimeError('WORLD_SIZE > 1 needs MASTER_ADDR and MASTER_PORT '
                           '(torchrun sets them)')
    backend = 'nccl' if device == 'cuda' else 'gloo'
    address = f'tcp://{topology.master_addr}:{topology.master_port}'
    logger.info('init_process_group(%s, %s, world_size=%d, rank=%d)',
                backend, address, topology.world_size, topology.rank)
    dist.init_process_group(
        backend, init_method=address, world_size=topology.world_size,
        rank=topology.rank,
        timeout=datetime.timedelta(seconds=timeout_seconds))
    return topology
