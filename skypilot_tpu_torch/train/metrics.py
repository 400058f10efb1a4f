"""Step time → tokens/s → MFU (skypilot_tpu/train/metrics.py).

MFU = achieved model FLOPs/s over the cards' peak, with the reference's
6 N + attention-term FLOPs/token model (the port's copy of
ModelConfig.flops_per_token). The peak is the caller's: the port knows no
device table (an H100 SXM's dense bf16 peak is 989 TFLOP/s).
"""
from __future__ import annotations

from skypilot_tpu_torch.models.configs import ModelConfig


def tokens_per_sec(batch_size: int, seq_len: int,
                   step_time_s: float) -> float:
    return batch_size * seq_len / step_time_s


def mfu(cfg: ModelConfig, batch_size: int, seq_len: int, step_time_s: float,
        num_chips: int, peak_tflops_per_chip: float) -> float:
    achieved = (cfg.flops_per_token(seq_len) * batch_size * seq_len /
                step_time_s)
    return achieved / (peak_tflops_per_chip * 1e12 * num_chips)
