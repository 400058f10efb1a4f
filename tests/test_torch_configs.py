"""The port's own copies of the config registry and the block-pool
allocator agree with the JAX package's: every registered config field by
field, and the allocator's behaviour on the same operation sequence."""
import dataclasses
import random

import pytest

from skypilot_tpu.models import configs as jax_configs
from skypilot_tpu.models import kv_cache as jax_kv_cache
from skypilot_tpu_torch.models import configs as torch_configs
from skypilot_tpu_torch.models import kv_cache as torch_kv_cache


def test_same_registered_names():
    assert torch_configs.list_configs() == jax_configs.list_configs()


def test_same_fields():
    assert [f.name for f in dataclasses.fields(torch_configs.ModelConfig)] \
        == [f.name for f in dataclasses.fields(jax_configs.ModelConfig)]


@pytest.mark.parametrize('name', jax_configs.list_configs())
def test_config_equal_field_by_field(name):
    ref = jax_configs.get_config(name)
    port = torch_configs.get_config(name)
    for field in dataclasses.fields(jax_configs.ModelConfig):
        assert getattr(port, field.name) == getattr(ref, field.name), \
            (name, field.name)
    assert port.head_dim == ref.head_dim
    assert port.num_params() == ref.num_params()
    assert port.flops_per_token() == ref.flops_per_token()


def test_overrides_and_unknown_name():
    port = torch_configs.get_config('llama3-8b', max_seq_len=1024)
    ref = jax_configs.get_config('llama3-8b', max_seq_len=1024)
    assert port.max_seq_len == ref.max_seq_len == 1024
    with pytest.raises(ValueError, match='Unknown model'):
        torch_configs.get_config('no-such-model')


def test_block_pool_matches_reference_under_churn():
    """Same random alloc/incref/decref sequence on both pools: the same
    block ids come out, the same exhaustion points, the same counts."""
    ours = torch_kv_cache.BlockPool(9, block_size=4)
    ref = jax_kv_cache.BlockPool(9, block_size=4)
    rng = random.Random(0)
    held = []
    for _ in range(300):
        op = rng.random()
        if op < 0.5:
            try:
                got = ours.alloc()
            except torch_kv_cache.PoolExhaustedError:
                with pytest.raises(jax_kv_cache.PoolExhaustedError):
                    ref.alloc()
                continue
            assert got == ref.alloc()
            held.append(got)
        elif op < 0.65 and held:
            block = rng.choice(held)
            ours.incref(block)
            ref.incref(block)
            held.append(block)
        elif held:
            block = held.pop(rng.randrange(len(held)))
            ours.decref(block)
            ref.decref(block)
        assert (ours.used, ours.free, ours.peak_used) == \
            (ref.used, ref.free, ref.peak_used)
        ours.check()
    for block in range(9):
        assert ours.refcount(block) == ref.refcount(block)


def test_block_pool_refusals():
    pool = torch_kv_cache.BlockPool(3, block_size=2)
    block = pool.alloc()
    pool.decref(block)
    with pytest.raises(ValueError):
        pool.decref(block)              # double free
    with pytest.raises(ValueError):
        pool.incref(block)              # incref on a free block
    with pytest.raises(ValueError):
        pool.decref(0)                  # scratch is pinned
    with pytest.raises(ValueError):
        torch_kv_cache.BlockPool(1, block_size=2)


# ---------------------------------------------------------------------
# Command-line parity: every option of the reference's entry points
# parses on the port's, or stands in a named list of flags still to port
# (each with its ROADMAP §1 item); the port's own options stand in a
# second list, each with its reason.
# ---------------------------------------------------------------------

SERVER_TO_PORT = {}
TRAIN_TO_PORT = {
    '--ep': 'ROADMAP §1 item 6: expert parallelism',
    '--pp': 'ROADMAP §1 item 6: the pipeline',
    '--microbatches': 'ROADMAP §1 item 6: the pipeline',
    '--pipeline-repeats': 'ROADMAP §1 item 6: the pipeline',
}
PORT_ONLY = {
    'server': {'--device': 'the port runs on CUDA unless told cpu'},
    'train': {'--device': 'the port runs on CUDA unless told cpu',
              '--warmup-steps': 'the learning-rate warmup, which the '
                                "reference's train.run leaves at "
                                "TrainConfig's 100 steps (short CPU runs "
                                'set it lower)'},
}
# The server options whose default is not the reference's, each with its
# reason: {dest: (port default, reason)}.
SERVER_DEVIATIONS = {
    'paged_block_size': (
        16, 'the card path is the paged layout through the paged '
        'kernel; the contiguous layout equals paged on the plain route '
        'bit for bit and is chosen with --paged-block-size 0'),
    'decode_kernel': (
        None, "resolved by layout: 'pallas' (the paged kernel) on the "
        "paged layout, 'xla' (the reference's default) on the "
        'contiguous one'),
}


class _Captured(Exception):
    """Carries the parser a reference main() built, instead of parsing."""


def _reference_parser(main, monkeypatch):
    import argparse

    def capture(self, *args, **kwargs):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', capture)
    with pytest.raises(_Captured) as info:
        main([])
    monkeypatch.undo()
    return info.value.args[0]


def _options(parser) -> dict:
    return {opt: action for action in parser._actions  # pylint: disable=protected-access
            for opt in action.option_strings}


def _sample_argv(opt, action) -> list:
    """`opt` with a value of the reference action's kind."""
    if action.nargs == 0:
        return [opt]
    if action.choices:
        return [opt, str(list(action.choices)[0])]
    if action.default is not None and not isinstance(action.default, bool):
        return [opt, str(action.default)]
    if action.type in (int, float):
        return [opt, '1']
    return [opt, 'x']


def _parity(ref_parser, port_parser, to_port, port_only, deviations):
    """Every reference option parses on the port or is named in
    `to_port`, every port-only option is named, and every shared option
    takes the reference's default but those named in `deviations`
    ({dest: (port default, reason)}), which take the named one."""
    ref, port = _options(ref_parser), _options(port_parser)
    assert set(ref) - set(port) == set(to_port)
    assert set(port) - set(ref) == set(port_only)
    for opt, action in ref.items():
        if opt in to_port or opt in ('-h', '--help'):
            continue
        port_parser.parse_args(_sample_argv(opt, action))
    differ = {}
    for opt, action in ref.items():
        if opt in to_port or opt in ('-h', '--help'):
            continue
        mine = port[opt].default
        if mine != action.default:
            differ[action.dest] = mine
    assert differ == {dest: default
                      for dest, (default, _why) in deviations.items()}
    assert all(why for _default, why in deviations.values())


def test_server_flags_parse_or_are_named(monkeypatch):
    from skypilot_tpu.serve import server as jax_server
    from skypilot_tpu_torch.serve import server as torch_server
    _parity(_reference_parser(jax_server.main, monkeypatch),
            torch_server.build_parser(), SERVER_TO_PORT,
            PORT_ONLY['server'], SERVER_DEVIATIONS)


def test_train_flags_parse_or_are_named(monkeypatch):
    from skypilot_tpu.train import run as jax_run
    from skypilot_tpu_torch.train import run as torch_run
    _parity(_reference_parser(jax_run.main, monkeypatch),
            torch_run.build_parser(), TRAIN_TO_PORT, PORT_ONLY['train'], {})


@pytest.mark.parametrize('argv,want', [
    (['--tokenizer', 'byte', '--paged-num-blocks', '64',
      '--request-timeout', '30', '--watchdog-timeout', '120'],
     dict(tokenizer='byte', paged_num_blocks=64, request_timeout=30.0,
          watchdog_timeout=120.0)),
    ([], dict(tokenizer='byte', paged_num_blocks=None, request_timeout=0.0,
              watchdog_timeout=120.0)),
], ids=['set', 'defaults'])
def test_server_resilience_flags(argv, want):
    """Fault 7's flags and the watchdog's, with the reference's
    defaults."""
    from skypilot_tpu_torch.serve import server as torch_server
    args = torch_server.build_parser().parse_args(argv)
    assert {k: getattr(args, k) for k in want} == want


def test_hf_tokenizer_is_refused_at_parse_naming_the_package(capsys):
    from skypilot_tpu_torch.serve import server as torch_server
    with pytest.raises(SystemExit) as info:
        torch_server.build_parser().parse_args(['--tokenizer', 'hf:x'])
    assert info.value.code == 2
    err = capsys.readouterr().err
    assert 'transformers' in err and 'tokenizers' in err


@pytest.mark.parametrize('budget', [None, '45'], ids=['unset', 'set'])
def test_preempt_notice_budget_is_the_references(budget, monkeypatch):
    """Fault 8: --preempt-drain-timeout defaults to the notice budget the
    replica manager reads ($SKYTPU_SERVE_PREEMPT_NOTICE_BUDGET, 30 s),
    as the reference's does."""
    from skypilot_tpu.serve import constants as jax_constants
    from skypilot_tpu_torch.serve import constants as torch_constants
    from skypilot_tpu_torch.serve import server as torch_server
    if budget is None:
        monkeypatch.delenv('SKYTPU_SERVE_PREEMPT_NOTICE_BUDGET',
                           raising=False)
    else:
        monkeypatch.setenv('SKYTPU_SERVE_PREEMPT_NOTICE_BUDGET', budget)
    want = 30.0 if budget is None else 45.0
    assert torch_constants.preempt_notice_budget_seconds() == want
    assert jax_constants.preempt_notice_budget_seconds() == want
    args = torch_server.build_parser().parse_args([])
    assert args.preempt_drain_timeout == want


def test_server_serves_the_references_default_model():
    """Fault 9: the same command line serves the same model."""
    from skypilot_tpu_torch.serve import server as torch_server
    assert torch_server.build_parser().parse_args([]).model == 'llama3-1b'


@pytest.mark.parametrize('name', jax_configs.list_configs())
def test_infer_serving_tp_equals_the_references(name):
    from skypilot_tpu.models import inference as jax_inference
    from skypilot_tpu_torch.models import inference as torch_inference
    ref, port = jax_configs.get_config(name), torch_configs.get_config(name)
    assert [torch_inference.infer_serving_tp(port, n) for n in range(1, 9)] \
        == [jax_inference.infer_serving_tp(ref, n) for n in range(1, 9)]
