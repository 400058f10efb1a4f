"""Time a hand-written kernel against a textual variant of its source on
one card, in turns (base, variant, variant, base), so that a design
choice rests on a measurement taken within one call:

    python -m skypilot_tpu_torch.ops.kernel_ab flash-order paged-span
    python -m skypilot_tpu_torch.ops.kernel_ab flash-dkv-keys flash-dq-stages
    python -m skypilot_tpu_torch.ops.kernel_ab lora-no-hold lora-split-512

Each experiment names a source under ops/csrc, the substitutions that
make the variant, and the call it times at the main path's shape
(profiler device time, mean of 20 calls after 3 of warm-up; CUDA events
beside it; for kernel 7's calls also CUDA-graph replay). The variant is
built from a copy of csrc/ into a directory of its own (experiments with
the same substitutions share it); the package's sources and builds are
left as they are. Prints one JSON object per experiment.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import shutil
import tempfile

import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops import fused_lora as fl
from skypilot_tpu_torch.ops import paged_attention as pa
from skypilot_tpu_torch.ops import ring_attention as ra


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


# The serve_tenant phase's decode tick: its 8 prompts (20-700 tokens)
# halfway through their 32 new tokens.
_TICK_MIX = tuple(n + 16 for n in (20, 117, 214, 311, 408, 505, 602, 700))


def _paged_int8_call(shape: str):
    """The serve_tenant path's int8 paged call ('prefill': B 1 x T 256 at
    512, 'prefill_4096'; 'decode': B 8 x T 1 at 0-8190, 'tick': at 700
    each, 'tick_mix': at _TICK_MIX): llama3-8b heads, blocks of 16, bf16
    queries, pools of normal K/V quantized per token and kv head as the
    model's int8_quantize does."""
    from skypilot_tpu_torch.models.transformer import int8_quantize
    gen = torch.Generator(device='cuda').manual_seed(0)
    bps, num_blocks = 512, 8 * 512 + 1
    kv = [int8_quantize(torch.randn((num_blocks, 16, 8, 128), generator=gen,
                                    device='cuda')) for _ in range(2)]
    (k8, ks), (v8, vs) = kv
    scales = dict(k_scale=ks[..., None].contiguous(),
                  v_scale=vs[..., None].contiguous())
    batch, cur_len, start = {'prefill': (1, 256, 512),
                             'prefill_4096': (1, 256, 4096)}.get(
                                 shape, (8, 1, None))
    q = torch.randn((batch, cur_len, 32, 128), generator=gen,
                    device='cuda').bfloat16()
    perm = torch.randperm(num_blocks - 1, generator=gen, device='cuda') + 1
    tables = perm[:batch * bps].reshape(batch, bps).int()
    if start is None:
        rows = {'decode': (0, 7, 8190, 300, 4000, 650, 1023, 0),
                'tick': (700,) * 8, 'tick_mix': _TICK_MIX}[shape]
        pos = torch.tensor(rows, dtype=torch.int32, device='cuda')[:, None]
    else:
        pos = torch.arange(start, start + cur_len, dtype=torch.int32,
                           device='cuda')[None]
    return lambda: pa.paged_decode_attention(q, k8, v8, tables, pos,
                                             **scales)


def _int8_first_route(dtype, head_dim, total_rows):
    """The route rule before int8 pools took the bf16 routes, for the
    int8-pool calls the paged-int8-first experiments time: the first
    design."""
    del dtype, head_dim, total_rows
    return 'first'


# The first design for bf16 queries over int8 pools, on both sides of the
# library (route and dispatch of the int8 entry) and in the wrapper's
# workspace rule.
_INT8_FIRST = (
    ('const Route route = route_of(dtype, head_dim, p.total_rows);',
     'const Route route = quant ? kFirst : '
     'route_of(dtype, head_dim, p.total_rows);'),
    ('if constexpr (std::is_same<T, bf16>::value) {',
     'if constexpr (std::is_same<T, bf16>::value && '
     'std::is_same<P, bf16>::value) {'))


# The decode route's grid cut to the first 6 splits of each row tile: at
# the tick (rows of 700 keys: 6 int8 splits, 3 bf16 ones) the same live
# work without the blocks of the splits past the live keys.
_DECODE_GRID = ('kernel<<<dim3(batch, p.kv_heads, tiles * p.splits), '
                'kThreads, smem,\n           stream>>>(p);\n'
                '  err = cudaGetLastError();\n'
                '  if (err != cudaSuccess || p.splits == 1) return (int)err;'
                '\n  span_combine_kernel')
_GRID_6 = ((_DECODE_GRID, _DECODE_GRID.replace('tiles * p.splits',
                                               'tiles * min(p.splits, 6)')),)


# The int8 decode route's key span at bf16's 256 keys.
_INT8_SPAN_256 = (('constexpr int kInt8SplitKeys = 128;',
                   'constexpr int kInt8SplitKeys = 256;'),)


def _ring_call():
    """The train_sp path's two hops, full then diagonal: B 4, 512 queries
    x 512 keys, H 16, KV 8, D 128, bf16, k and v strided KV-head views of
    one tensor, fresh state."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    q = torch.randn((4, 512, 16, 128), generator=gen,
                    device='cuda').bfloat16()
    kv = torch.randn((4, 512, 16, 128), generator=gen,
                     device='cuda').bfloat16()
    k, v = kv[:, :, :8], kv[:, :, 8:]
    o = torch.zeros((4, 512, 16, 128), device='cuda')
    m = torch.full((4, 16, 512), -1e30, device='cuda')
    l = torch.zeros((4, 16, 512), device='cuda')
    opts = dict(sm_scale=128 ** -0.5)
    return lambda: (
        *ra.chunk_update(q, k, v, o, m, l, mask_mode=0, q_offset=512,
                         k_offset=0, **opts),
        *ra.chunk_update(q, k, v, o, m, l, mask_mode=1, q_offset=512,
                         k_offset=512, **opts))


def _lora_call(shape: str):
    """One llama3-8b layer's four LoRA group calls (qkv, o, gate_up,
    down; rank 16, 5 slots, scale 2), bf16: 'decode' B 8 x T 1 over slots
    0,1,2,3,4,1,0,2 (the serve_tenant tick), 'prefill' B 1 x T 256 on
    slot 3."""
    gen = torch.Generator(device='cuda').manual_seed(0)
    batch, seq, ids = {'decode': (8, 1, [0, 1, 2, 3, 4, 1, 0, 2]),
                       'prefill': (1, 256, [3])}[shape]
    aids = torch.tensor(ids, dtype=torch.int32, device='cuda')
    calls = []
    for d_in, outs in ((4096, (4096, 1024, 1024)), (4096, (4096,)),
                       (4096, (14336, 14336)), (14336, (4096,))):
        stacks = [(torch.randn((5, d_in, 16), generator=gen, device='cuda')
                   .mul(d_in ** -0.5).bfloat16(),
                   torch.randn((5, 16, d_out), generator=gen, device='cuda')
                   .mul(0.25).bfloat16()) for d_out in outs]
        group = fl.LoRAGroup(stacks, [sum(outs[:i]) for i in
                                      range(len(outs))], sum(outs), 2.0)
        x = torch.randn((batch, seq, d_in), generator=gen,
                        device='cuda').bfloat16()
        y = torch.zeros((batch, seq, sum(outs)), device='cuda',
                        dtype=torch.bfloat16)
        calls.append((group, x, y))

    def call():       # y accumulates: the timed call is the groups alone
        return tuple(group(x, y, aids) for group, x, y in calls)

    def check():      # outputs to compare: each y from zero
        return tuple(group(x, y.zero_(), aids).clone()
                     for group, x, y in calls)
    call.check = check
    return call


# Kernel 7's design choices: B's rows not held in registers across the
# dependency wait; the tensor-core shrink's IN split at least 512 or 1024
# instead of 256, its ring 3 stages instead of 6.
_LORA_NO_HOLD = (('constexpr int kHeld = VEC * sizeof(T) == 16 && R <= 16 '
                   '? R : 1;', 'constexpr int kHeld = 1;'),)
_LORA_STAGES_3 = (('constexpr int kTcStages = 6;',
                   'constexpr int kTcStages = 3;'),)


def _lora_split(n: int):
    return (('constexpr int kTcMinSplit = 256;',
             f'constexpr int kTcMinSplit = {n};'),)


# Sources whose calls are also timed by CUDA-graph replay (several
# launches a call, a dependent launch among them).
_GRAPH_TIMED = ('fused_lora',)


# name: (source, ((text in the source, its replacement), ...), call, the
# paged wrapper module's names the variant changes with it)
EXPERIMENTS = {
    'flash-order': (
        'flash_attention',
        (('const int qt = p.causal ? p.tiles - 1 - w / groups : w / groups;',
          'const int qt = w / groups;'),), _flash_call, {}),
    'flash-persistent': (
        'flash_attention',
        (('constexpr bool kPersistent = true;',
          'constexpr bool kPersistent = false;'),), _flash_call, {}),
    'flash-stages': (
        'flash_attention',
        (('constexpr int kFwdStages = 4;',
          'constexpr int kFwdStages = 2;'),), _flash_call, {}),
    # The backward pair (dQ, dK/dV).
    'flash-dq-persistent': (
        'flash_attention',
        (('constexpr bool kPersistent = true;',
          'constexpr bool kPersistent = false;'),),
        lambda: _flash_backward_call('dq'), {}),
    'flash-dkv-persistent': (
        'flash_attention',
        (('constexpr bool kDkvPersistent = false;',
          'constexpr bool kDkvPersistent = true;'),),
        lambda: _flash_backward_call('dkv'), {}),
    'flash-dq-stages-4': (
        'flash_attention',
        (('constexpr int kDqStages = 3;',
          'constexpr int kDqStages = 4;'),),
        lambda: _flash_backward_call('dq'),
        {}),
    'flash-dq-stages': (
        'flash_attention',
        (('constexpr int kDqStages = 3;',
          'constexpr int kDqStages = 2;'),),
        lambda: _flash_backward_call('dq'),
        {}),
    'flash-dkv-stages': (
        'flash_attention',
        (('constexpr int kDkvStages = 4;',
          'constexpr int kDkvStages = 2;'),),
        lambda: _flash_backward_call('dkv'),
        {}),
    'flash-dkv-keys': (
        'flash_attention',
        (('constexpr int kDkvKeys = 128;',
          'constexpr int kDkvKeys = 64;'),),
        lambda: _flash_backward_call('dkv'),
        {}),
    'paged-span': (
        'paged_attention',
        (('constexpr int kSplitKeys = 256;',
          'constexpr int kSplitKeys = 512;'),), _paged_decode_call,
        {'SPLIT_KEYS': 512}),
    'paged-span-128': (
        'paged_attention',
        (('constexpr int kSplitKeys = 256;',
          'constexpr int kSplitKeys = 128;'),), _paged_decode_call,
        {'SPLIT_KEYS': 128}),
    # The serve phase's decode tick: 8 rows near 700 tokens.
    'paged-span-tick': (
        'paged_attention',
        (('constexpr int kSplitKeys = 256;',
          'constexpr int kSplitKeys = 512;'),),
        lambda: _paged_decode_call((700,) * 8), {'SPLIT_KEYS': 512}),
    'paged-span-tick-128': (
        'paged_attention',
        (('constexpr int kSplitKeys = 256;',
          'constexpr int kSplitKeys = 128;'),),
        lambda: _paged_decode_call((700,) * 8), {'SPLIT_KEYS': 128}),
    # Kernel 2, bf16 queries over int8 pools: the prefill route's ring of
    # 5 stages instead of 4, the first design at the serve shapes, and
    # the decode route's span of 256 keys (bf16's) instead of 128.
    'paged-int8-stages': (
        'paged_attention',
        (('constexpr int kInt8Ring = 4;', 'constexpr int kInt8Ring = 5;'),),
        lambda: _paged_int8_call('prefill'), {}),
    'paged-int8-first-prefill': (
        'paged_attention', _INT8_FIRST, lambda: _paged_int8_call('prefill'),
        {'kernel_route': _int8_first_route}),
    'paged-int8-first-4096': (
        'paged_attention', _INT8_FIRST,
        lambda: _paged_int8_call('prefill_4096'),
        {'kernel_route': _int8_first_route}),
    'paged-int8-first-decode': (
        'paged_attention', _INT8_FIRST, lambda: _paged_int8_call('decode'),
        {'kernel_route': _int8_first_route}),
    'paged-int8-first-tick': (
        'paged_attention', _INT8_FIRST, lambda: _paged_int8_call('tick'),
        {'kernel_route': _int8_first_route}),
    'paged-int8-first-tick-mix': (
        'paged_attention', _INT8_FIRST,
        lambda: _paged_int8_call('tick_mix'),
        {'kernel_route': _int8_first_route}),
    'paged-int8-span-256-tick': (
        'paged_attention', _INT8_SPAN_256, lambda: _paged_int8_call('tick'),
        {'INT8_SPLIT_KEYS': 256}),
    'paged-int8-span-256-tick-mix': (
        'paged_attention', _INT8_SPAN_256,
        lambda: _paged_int8_call('tick_mix'), {'INT8_SPLIT_KEYS': 256}),
    'paged-int8-span-256-decode': (
        'paged_attention', _INT8_SPAN_256,
        lambda: _paged_int8_call('decode'), {'INT8_SPLIT_KEYS': 256}),
    'paged-int8-grid-tick': (
        'paged_attention', _GRID_6, lambda: _paged_int8_call('tick'), {}),
    'paged-grid-tick': (
        'paged_attention', _GRID_6, lambda: _paged_decode_call((700,) * 8),
        {}),
    # Kernel 6: 2 K/V stages instead of 4; persistent blocks.
    'ring-stages': (
        'ring_attention',
        (('constexpr int kStages = 4;', 'constexpr int kStages = 2;'),),
        _ring_call, {}),
    'ring-persistent': (
        'ring_attention',
        (('constexpr bool kPersistent = false;',
          'constexpr bool kPersistent = true;'),), _ring_call, {}),
    'lora-no-hold': (
        'fused_lora', _LORA_NO_HOLD, lambda: _lora_call('decode'), {}),
    'lora-split-512': (
        'fused_lora', _lora_split(512), lambda: _lora_call('prefill'), {}),
    'lora-split-1024': (
        'fused_lora', _lora_split(1024), lambda: _lora_call('prefill'), {}),
    'lora-stages-3': (
        'fused_lora', _LORA_STAGES_3, lambda: _lora_call('prefill'), {}),
}


@contextlib.contextmanager
def _sources(csrc_dir: str, build_dir: str, constants: dict):
    """Load kernels from another csrc/ and build/, with the paged
    wrapper's `constants` (its constants, or its route rule) set to
    match, for the duration."""
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
               if e.device_type == DeviceType.CUDA and
               e.key != 'lora') / iters / 1e3     # not the range's span


def _graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time per call of `iters` calls captured into one CUDA
    graph and replayed between CUDA events: the gaps between a call's
    launches count, the host's launch overhead does not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def _ptxas(log: str) -> list:
    """Registers and spills of each wgmma kernel in an nvcc -Xptxas=-v
    log."""
    out, name = [], None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            found = re.search(r'(?:flash_(?:fwd|dq|dkv)_wgmma|ring_chunk_wgmma'
                              r'|paged_prefill|tc_shrink|tc_expand|cc_shrink'
                              r'|cc_expand)_kernelI\w+?E', line)
            name = found and found.group(0)
        elif name and ('spill' in line or 'registers' in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def run(name: str, workdir: str) -> dict:
    source, substitutions, make_call, constants = EXPERIMENTS[name]
    # Experiments with the same substitutions share one variant build.
    key = hashlib.sha256(repr((source, substitutions)).encode()).hexdigest()
    csrc = os.path.join(workdir, key[:12], 'csrc')
    variant = lambda: _sources(csrc, os.path.join(workdir, key[:12], 'build'),
                               constants)
    if not os.path.isdir(csrc):
        shutil.copytree(_build.CSRC_DIR, csrc)
        path = os.path.join(csrc, f'{source}.cu')
        with open(path) as f:
            text = f.read()
        for old, new in substitutions:
            if text.count(old) != 1:
                raise ValueError(f'{name}: {old!r} is not in {source}.cu '
                                 f'once')
            text = text.replace(old, new)
        with open(path, 'w') as f:
            f.write(text)
    call = make_call()
    outputs = getattr(call, 'check', call)
    base_out = outputs()
    with variant():
        variant_out = outputs()
    variant_ptxas = _ptxas(_build.build_logs.get(source, ''))
    times = {'base': [], 'variant': []}
    events = {'base': [], 'variant': []}
    graphs = {'base': [], 'variant': []}
    for which in ('base', 'variant', 'variant', 'base'):
        with variant() if which == 'variant' else contextlib.nullcontext():
            times[which].append(_ms(call))
            events[which].append(_events_ms(call))
            if source in _GRAPH_TIMED:
                graphs[which].append(_graph_ms(call))
    return {'experiment': name, 'source': f'ops/csrc/{source}.cu',
            'variant': [new for _, new in substitutions],
            'base_ms': times['base'],
            'variant_ms': times['variant'],
            'base_events_ms': events['base'],
            'variant_events_ms': events['variant'],
            **({'base_graph_ms': graphs['base'],
                'variant_graph_ms': graphs['variant']}
               if graphs['base'] else {}),
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
