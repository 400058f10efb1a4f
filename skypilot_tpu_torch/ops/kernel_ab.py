"""Time a hand-written kernel against a textual variant of its source on
one card, in turns (base, variant, variant, base), so that a design
choice rests on a measurement taken within one call:

    python -m skypilot_tpu_torch.ops.kernel_ab flash-order paged-span
    python -m skypilot_tpu_torch.ops.kernel_ab flash-dkv-keys flash-dq-stages

Each experiment names a source under ops/csrc, the substitution that
makes the variant, and the call it times at the main path's shape
(profiler device time, mean of 20 calls after 3 of warm-up; CUDA events
beside it). The variant is built
from a copy of csrc/ into its own directory; the package's sources and
builds are left as they are. Prints one JSON object per experiment.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import tempfile

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops import paged_attention as pa


def _flash_inputs():
    """q, k, v and dO at the train path's shape: B 8, S 1024, H 16 / KV
    8, D 128, bf16, k and v column slices of one fused tensor."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    q, kv, g = (torch.randn((8, 1024, 16, 128), generator=gen,
                            device='cuda').bfloat16() for _ in range(3))
    return q, kv[:, :, :8], kv[:, :, 8:], g


def _flash_call():
    """The train path's forward."""
    q, k, v, _ = _flash_inputs()
    return lambda: fa.flash_forward(q, k, v, causal=True,
                                    sm_scale=128 ** -0.5)[0]


def _flash_backward_call(which: str):
    """The train path's dQ ('dq') or dK/dV ('dkv'), causal, with lse and
    delta from the plain forward."""
    q, k, v, g = _flash_inputs()
    opts = dict(causal=True, sm_scale=128 ** -0.5)
    out, lse = fa.flash_forward_plain(q, k, v, **opts)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, g, lse, delta)
    calls = {'dq': lambda: (fa.flash_dq(*args, **opts),),
             'dkv': lambda: fa.flash_dkv(*args, **opts)}
    return calls[which]


def _paged_decode_call(positions=(0, 7, 8190, 300, 4000, 650, 1023, 0)):
    """The serve path's decode: B 8 x T 1, llama3-8b heads, blocks of 16,
    the smoke's positions 0-8190 (or the given ones) over shuffled pool
    blocks."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    bps, num_blocks = 512, 8 * 512 + 1
    shape = (num_blocks, 16, 8, 128)
    k_pool = torch.randn(shape, generator=gen, device='cuda').bfloat16()
    v_pool = torch.randn(shape, generator=gen, device='cuda').bfloat16()
    q = torch.randn((8, 1, 32, 128), generator=gen, device='cuda').bfloat16()
    perm = torch.randperm(num_blocks - 1, generator=gen, device='cuda') + 1
    tables = perm[:8 * bps].reshape(8, bps).int()
    pos = torch.tensor(list(positions), dtype=torch.int32,
                       device='cuda')[:, None]
    return lambda: pa.paged_decode_attention(q, k_pool, v_pool, tables, pos)


# name: (source, text in the source, its replacement, call, the wrapper
# module's constants the variant changes with it)
EXPERIMENTS = {
    'flash-order': (
        'flash_attention',
        'const int qt = p.causal ? p.tiles - 1 - w / groups : w / groups;',
        'const int qt = w / groups;', _flash_call, {}),
    'flash-persistent': (
        'flash_attention', 'constexpr bool kPersistent = true;',
        'constexpr bool kPersistent = false;', _flash_call, {}),
    'flash-stages': (
        'flash_attention', 'constexpr int kFwdStages = 4;',
        'constexpr int kFwdStages = 2;', _flash_call, {}),
    # The backward pair (dQ, dK/dV).
    'flash-dq-persistent': (
        'flash_attention', 'constexpr bool kPersistent = true;',
        'constexpr bool kPersistent = false;',
        lambda: _flash_backward_call('dq'), {}),
    'flash-dkv-persistent': (
        'flash_attention', 'constexpr bool kDkvPersistent = false;',
        'constexpr bool kDkvPersistent = true;',
        lambda: _flash_backward_call('dkv'), {}),
    'flash-dq-stages-4': (
        'flash_attention', 'constexpr int kDqStages = 3;',
        'constexpr int kDqStages = 4;', lambda: _flash_backward_call('dq'),
        {}),
    'flash-dq-stages': (
        'flash_attention', 'constexpr int kDqStages = 3;',
        'constexpr int kDqStages = 2;', lambda: _flash_backward_call('dq'),
        {}),
    'flash-dkv-stages': (
        'flash_attention', 'constexpr int kDkvStages = 4;',
        'constexpr int kDkvStages = 2;', lambda: _flash_backward_call('dkv'),
        {}),
    'flash-dkv-keys': (
        'flash_attention', 'constexpr int kDkvKeys = 128;',
        'constexpr int kDkvKeys = 64;', lambda: _flash_backward_call('dkv'),
        {}),
    'paged-span': (
        'paged_attention', 'constexpr int kSplitKeys = 256;',
        'constexpr int kSplitKeys = 512;', _paged_decode_call,
        {'SPLIT_KEYS': 512}),
    'paged-span-128': (
        'paged_attention', 'constexpr int kSplitKeys = 256;',
        'constexpr int kSplitKeys = 128;', _paged_decode_call,
        {'SPLIT_KEYS': 128}),
    # The serve phase's decode tick: 8 rows near 700 tokens.
    'paged-span-tick': (
        'paged_attention', 'constexpr int kSplitKeys = 256;',
        'constexpr int kSplitKeys = 512;',
        lambda: _paged_decode_call((700,) * 8), {'SPLIT_KEYS': 512}),
    'paged-span-tick-128': (
        'paged_attention', 'constexpr int kSplitKeys = 256;',
        'constexpr int kSplitKeys = 128;',
        lambda: _paged_decode_call((700,) * 8), {'SPLIT_KEYS': 128}),
}


@contextlib.contextmanager
def _sources(csrc_dir: str, build_dir: str, constants: dict):
    """Load kernels from another csrc/ and build/, with the paged
    wrapper's `constants` set to match, for the duration."""
    saved = (_build.CSRC_DIR, _build.BUILD_DIR, dict(_build._libs),  # pylint: disable=protected-access
             {k: getattr(pa, k) for k in constants})
    _build.CSRC_DIR, _build.BUILD_DIR = csrc_dir, build_dir
    _build._libs.clear()  # pylint: disable=protected-access
    for key, value in constants.items():
        setattr(pa, key, value)
    try:
        yield
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR = saved[0], saved[1]
        _build._libs.clear()  # pylint: disable=protected-access
        _build._libs.update(saved[2])  # pylint: disable=protected-access
        for key, value in saved[3].items():
            setattr(pa, key, value)


def _events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call by CUDA events around `iters` calls: for calls
    of a tenth of a millisecond and more, where the host's launches hide
    behind the device."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call: the CUDA kernels a torch.profiler trace
    attributes to `iters` calls (a call of tens of microseconds, timed by
    CUDA events around a loop, would time the host's launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def _ptxas(log: str) -> list:
    """Registers and spills of each bf16 flash kernel in an nvcc
    -Xptxas=-v log."""
    out, name = [], None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            found = re.search(r'flash_(?:fwd|dq|dkv)_wgmma_kernelILi\d+',
                              line)
            name = found and found.group(0)
        elif name and ('spill' in line or 'registers' in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def run(name: str, workdir: str) -> dict:
    source, old, new, make_call, constants = EXPERIMENTS[name]
    csrc = os.path.join(workdir, name, 'csrc')
    variant = lambda: _sources(csrc, os.path.join(workdir, name, 'build'),
                               constants)
    shutil.copytree(_build.CSRC_DIR, csrc)
    path = os.path.join(csrc, f'{source}.cu')
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise ValueError(f'{name}: {old!r} is not in {source}.cu once')
    with open(path, 'w') as f:
        f.write(text.replace(old, new))
    call = make_call()
    base_out = call()
    with variant():
        variant_out = call()
    variant_ptxas = _ptxas(_build.build_logs.get(source, ''))
    times = {'base': [], 'variant': []}
    events = {'base': [], 'variant': []}
    for which in ('base', 'variant', 'variant', 'base'):
        with variant() if which == 'variant' else contextlib.nullcontext():
            times[which].append(_ms(call))
            events[which].append(_events_ms(call))
    return {'experiment': name, 'source': f'ops/csrc/{source}.cu',
            'variant': new, 'base_ms': times['base'],
            'variant_ms': times['variant'],
            'base_events_ms': events['base'],
            'variant_events_ms': events['variant'],
            'same_output': _same(base_out, variant_out),
            'variant_ptxas': variant_ptxas,
            'device': torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('experiments', nargs='+', choices=sorted(EXPERIMENTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('kernel_ab needs an NVIDIA GPU')
    with tempfile.TemporaryDirectory() as workdir:
        for name in args.experiments:
            print(json.dumps(run(name, workdir)), flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
