"""Multi-tenant serving substrate, host side: named LoRA adapters
resident in a fixed-capacity device-side stack (slot assignment, LRU
eviction of idle residents, refcount pinning while any request uses a
slot, npz adapter I/O). The engine glues the device writes in
models/inference.py. SLO tiers (the reference's scheduling.TierQueue)
are not ported."""
from skypilot_tpu_torch.serve.tenancy.adapter_pool import (
    AdapterPool,
    adapter_tree_from_lora_params,
    load_adapter_npz,
    save_adapter_npz,
    validate_adapter_name,
)

__all__ = [
    'AdapterPool',
    'adapter_tree_from_lora_params',
    'load_adapter_npz',
    'save_adapter_npz',
    'validate_adapter_name',
]
