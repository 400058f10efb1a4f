"""In-training callback: step timestamps for the benchmark subsystem
(the port's copy of skypilot_tpu/callbacks/)."""
from skypilot_tpu_torch.callbacks.base import BaseCallback
from skypilot_tpu_torch.callbacks.base import SkyTpuCallback
from skypilot_tpu_torch.callbacks.base import init
from skypilot_tpu_torch.callbacks.base import on_step_begin
from skypilot_tpu_torch.callbacks.base import on_step_end
from skypilot_tpu_torch.callbacks.base import step

__all__ = [
    'BaseCallback', 'SkyTpuCallback', 'init', 'on_step_begin',
    'on_step_end', 'step'
]
