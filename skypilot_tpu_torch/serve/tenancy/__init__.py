"""Multi-tenant serving substrate, host side: named LoRA adapters
resident in a fixed-capacity device-side stack (slot assignment, LRU
eviction of idle residents, refcount pinning while any request uses a
slot, npz adapter I/O), and the SLO tiers' admission queue (TierQueue:
interactive first, FIFO within a tier, a deterministic batch starvation
floor; deadline-aware admission's projected wait). The engine glues the
device writes and the slot preemption in models/inference.py."""
from skypilot_tpu_torch.serve.tenancy.adapter_pool import (
    AdapterPool,
    adapter_tree_from_lora_params,
    load_adapter_npz,
    save_adapter_npz,
    validate_adapter_name,
)
from skypilot_tpu_torch.serve.tenancy.scheduling import (
    TIER_RANK,
    TIERS,
    TierQueue,
    parse_tier_load_header,
    projected_wait,
    render_tier_load_header,
    validate_tier,
)

__all__ = [
    'AdapterPool',
    'TIER_RANK',
    'TIERS',
    'TierQueue',
    'adapter_tree_from_lora_params',
    'load_adapter_npz',
    'parse_tier_load_header',
    'projected_wait',
    'render_tier_load_header',
    'save_adapter_npz',
    'validate_adapter_name',
    'validate_tier',
]
