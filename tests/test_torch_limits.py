"""The kernels' shape limits (ops/limits.py), checked at construction on
the card and nowhere on the CPU: the pure rule, the wrappers sharing its
constants, the trainer and the engine calling it before any device work
when their device is CUDA, and the CPU taking any shape as before."""
import dataclasses

import pytest
import torch

from skypilot_tpu_torch.models import inference
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops import limits
from skypilot_tpu_torch.ops import paged_attention as pa
from skypilot_tpu_torch.ops import ring_attention as ra
from skypilot_tpu_torch.train import trainer


@pytest.mark.parametrize('head_dim', [64, 128, 256])
@pytest.mark.parametrize('block_size', [None, 1, 8, 16, 64])
def test_rule_takes_what_the_kernels_take(head_dim, block_size):
    limits.check_kernel_shapes(head_dim, block_size)


@pytest.mark.parametrize('head_dim,block_size,match', [
    (16, None, 'head_dim'),        # test-tiny's head_dim
    (96, 16, 'head_dim'),
    (512, 16, 'head_dim'),
    (128, 128, 'divides 64'),      # a block past the kernel's key step
    (128, 48, 'divides 64'),
    (128, 3, 'divides 64'),
    (64, 0, 'divides 64'),
])
def test_rule_refuses_with_the_limit_named(head_dim, block_size, match):
    with pytest.raises(ValueError, match=match):
        limits.check_kernel_shapes(head_dim, block_size)


def test_wrappers_share_the_rule():
    assert fa._HEAD_DIMS is limits.HEAD_DIMS  # pylint: disable=protected-access
    assert ra._HEAD_DIMS is limits.HEAD_DIMS  # pylint: disable=protected-access
    assert pa._HEAD_DIMS is limits.HEAD_DIMS  # pylint: disable=protected-access
    assert pa._STEP_KEYS == limits.PAGED_STEP_KEYS  # pylint: disable=protected-access


def _tiny(**kw):
    return dataclasses.replace(get_config('test-tiny'), dtype='float32',
                               param_dtype='float32', **kw)


@pytest.mark.parametrize('impl', ['auto', 'pallas', 'ring'])
def test_trainer_on_cuda_refuses_at_construction(impl):
    """The rule runs before the model touches the device, so this holds
    with or without a card: test-tiny's head_dim 16 through the kernels
    is refused by name."""
    with pytest.raises(ValueError, match='head_dim'):
        trainer.create_train_state(_tiny(attention_impl=impl),
                                   device='cuda')


@pytest.mark.parametrize('impl', ['auto', 'pallas', 'ring', 'xla',
                                  'pallas_interpret'])
def test_trainer_on_cpu_takes_any_head_dim(impl):
    state = trainer.create_train_state(_tiny(attention_impl=impl),
                                       device='cpu')
    assert state.model.cfg.head_dim == 16


def test_engine_on_cuda_refuses_at_construction(monkeypatch):
    """The engine's device resolves to CUDA (stubbed here, so the rule is
    seen to run before any allocation): a block of 128 is refused."""
    monkeypatch.setattr(inference, 'resolve_device',
                        lambda device: torch.device('cuda'))
    cfg = _tiny(max_seq_len=256, head_dim_override=64)
    with pytest.raises(ValueError, match='divides 64'):
        inference.ContinuousBatchingEngine(cfg, num_slots=1,
                                           paged_block_size=128)
    with pytest.raises(ValueError, match='head_dim'):
        inference.ContinuousBatchingEngine(_tiny(max_seq_len=256),
                                           num_slots=1, paged_block_size=8)


def test_engine_on_cpu_takes_any_block_size():
    engine = inference.ContinuousBatchingEngine(
        _tiny(max_seq_len=256), num_slots=1, paged_block_size=128,
        device='cpu')
    try:
        tokens, _ = engine.generate([1, 2, 3], max_new_tokens=2)
        assert len(tokens) >= 2
    finally:
        engine.drain(timeout=60)
