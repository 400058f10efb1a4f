"""Step time → tokens/s → MFU, and the optimizer state's bytes, published
into the port's metrics registry (skypilot_tpu/train/metrics.py).

MFU = achieved model FLOPs/s over the cards' peak, with the reference's
6 N + attention-term FLOPs/token model (the port's copy of
ModelConfig.flops_per_token). The peak is the caller's: the port knows no
device table (an H100 SXM's dense bf16 peak is 989 TFLOP/s). The formula
is the reference's for every run, LoRA included: it counts the base
weights' gradient products, which a LoRA step does not compute.

The gauges carry the reference's names (skytpu_train_step_seconds,
_tokens_per_sec, _mfu, _steps_timed_total, _opt_state_bytes,
_opt_state_bytes_per_device, _step_collectives{op}). The gauges are
re-settable: an exporter enabled late reads the last published values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from skypilot_tpu_torch.models.configs import ModelConfig
from skypilot_tpu_torch.observability import metrics as obs

_STEP_SECONDS = obs.gauge(
    'skytpu_train_step_seconds', 'Last measured training step time')
_TOKENS_PER_SEC = obs.gauge(
    'skytpu_train_tokens_per_sec',
    'Training throughput over all chips (last published measurement)')
_MFU = obs.gauge(
    'skytpu_train_mfu',
    'Model FLOPs utilization in [0, 1] (last published measurement)')
_STEPS_TIMED = obs.counter(
    'skytpu_train_steps_timed_total', 'Steps timed past warmup')
_OPT_BYTES = obs.gauge(
    'skytpu_train_opt_state_bytes',
    'Global bytes of the optimizer state (fp32 Adam moments dominate)')
_OPT_BYTES_PER_DEVICE = obs.gauge(
    'skytpu_train_opt_state_bytes_per_device',
    'Optimizer-state bytes resident on ONE mesh device; ~1/dp of the '
    'global bytes under ZeRO-1 weight-update sharding (--zero1)')
_STEP_COLLECTIVES = obs.gauge(
    'skytpu_train_step_collectives',
    'Collective ops in the compiled train step, by op '
    '(compiled-HLO probe, parallel/hlo_probe.py)', labelnames=('op',))


@dataclasses.dataclass
class StepTimer:
    """Wall-clock per-step measurement with warmup discard. The caller
    synchronizes the device before `stop` (a CUDA step returns before the
    card finishes)."""
    warmup_steps: int = 2
    times: List[float] = dataclasses.field(default_factory=list)
    _t0: Optional[float] = None
    _count: int = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """End the step; returns its seconds (recorded past warmup)."""
        if self._t0 is None:
            raise RuntimeError('StepTimer.stop() without start()')
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup_steps:
            self.times.append(dt)
            _STEP_SECONDS.set(dt)
            _STEPS_TIMED.inc()
        return dt

    def mean_step_time(self) -> float:
        if not self.times:
            raise ValueError('no timed steps (all warmup?)')
        return sum(self.times) / len(self.times)


def tokens_per_sec(batch_size: int, seq_len: int,
                   step_time_s: float) -> float:
    return batch_size * seq_len / step_time_s


def mfu(cfg: ModelConfig, batch_size: int, seq_len: int, step_time_s: float,
        num_chips: int, peak_tflops_per_chip: float) -> float:
    achieved = (cfg.flops_per_token(seq_len) * batch_size * seq_len /
                step_time_s)
    return achieved / (peak_tflops_per_chip * 1e12 * num_chips)


def opt_state_bytes(state) -> Tuple[int, int]:
    """(global bytes, bytes per device) of a TrainState's optimizer
    state: every tensor AdamW keeps (the moments, in the param dtype, and
    each parameter's step counter). Per device is what this rank holds;
    global counts a ZeRO-1 slice's moments dp times (its step counter
    once), so it is what one unsharded state holds and per device reads
    ~1/dp of it."""
    total = per_device = 0
    for u, dim in zip(state.updated, state.zero_dims):
        for value in state.optimizer.state.get(u, {}).values():
            if not hasattr(value, 'element_size'):
                continue
            size = value.numel() * value.element_size()
            per_device += size
            total += size * (state.dp if dim is not None and value.dim()
                             else 1)
    return total, per_device


def publish_opt_state_bytes(state) -> Tuple[int, int]:
    """opt_state_bytes, landed in the registry (the one call train.run
    makes, so the derived and the scraped numbers agree)."""
    total, per_device = opt_state_bytes(state)
    _OPT_BYTES.set(total)
    _OPT_BYTES_PER_DEVICE.set(per_device)
    return total, per_device


def publish_step_collectives(stats: Dict[str, int]) -> None:
    """Land a trainer.step_collectives() dict in the
    skytpu_train_step_collectives{op} gauge family (how gradients land
    and how params come back)."""
    for op in ('all_reduce', 'all_gather', 'reduce_scatter',
               'partition_scatter', 'reduce_scatter_effective'):
        if op in stats:
            _STEP_COLLECTIVES.labels(op=op).set(stats[op])


def publish_throughput(cfg: ModelConfig, batch_size: int, seq_len: int,
                       step_time_s: float, num_chips: int,
                       peak_tflops_per_chip: float) -> Tuple[float, float]:
    """(tokens/s over all chips, MFU), both published into the
    registry."""
    tps = tokens_per_sec(batch_size, seq_len, step_time_s)
    utilization = mfu(cfg, batch_size, seq_len, step_time_s, num_chips,
                      peak_tflops_per_chip)
    _TOKENS_PER_SEC.set(tps)
    _MFU.set(utilization)
    return tps, utilization
