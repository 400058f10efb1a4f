"""Tensor-parallel serving's compositions on the port, on the CPU: tp=2
over two gloo processes against tp=1 and the JAX package's
single-device engine, fp32 test-tiny and test-tiny-moe with 2 layers:
multi-LoRA adapters (all seven targets, so column- and row-parallel
groups), int8 weights, MoE and the disaggregated tiers. Prints ONE JSON
line that tests/test_torch_tp_compose.py reads.

Run: JAX_PLATFORMS=cpu python tests/torch_tp_compose_driver.py

This module's top level imports only the port: `follower` is the
follower target, and a follower imports neither jax nor the JAX package.
The follower records every MoE dispatch's routing (expert indices and
the capacity rule's keep mask) into the file $SKYTPU_TP_ROUTING_LOG.1,
and rank 0 records the same while it drives a tp=2 MoE model, so the
test can pin that every rank routed alike.
"""
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 1, 0, 2, 5, 8, 4, 4, 1, 2],
           [11, 3, 2], [9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3, 4, 5]]
# A prompt of five 8-token blocks for the tier handoff.
LONG_PROMPT = [(7 * i + 3) % 500 + 1 for i in range(40)]
NEW = 12
_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
LORA = dict(adapter_rank=4, adapter_alpha=8.0,
            adapter_targets='q,k,v,o,gate,up,down')
ADAPTERS = ('ad0', 'ad1')
# Row r of every engine batch uses ADAPTER_ROWS[r] (None: the base).
ADAPTER_ROWS = (None, 'ad0', 'ad1', 'ad0')
MOE_E = 4.0          # test-tiny-moe's expert count: nothing drops
ROUTING_ENV = 'SKYTPU_TP_ROUTING_LOG'
_REFERENCE = ('jax', 'flax', 'skypilot_tpu')


def reference_modules() -> int:
    """Modules of jax, flax or the JAX package this process imported."""
    return sum(1 for m in sys.modules
               if m in _REFERENCE or m.startswith(tuple(
                   r + '.' for r in _REFERENCE)))


def _cfg(name='test-tiny', **kw):
    from skypilot_tpu_torch.models.configs import get_config
    return dataclasses.replace(get_config(name), **_KW, **kw)


def random_adapter(cfg, seed: int) -> dict:
    """A seeded adapter tree in the reference's scanned models/lora
    layout for cfg's targets and rank (numpy: both engines load it)."""
    from skypilot_tpu_torch.models.convert import adapter_layout
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    rng.standard_normal(v, dtype=np.float32) *
                    np.float32(0.05))
                for k, v in sorted(node.items())}
    return walk(adapter_layout(cfg))


def _lora_cfg(name='test-tiny'):
    return _cfg(name, serve_adapters=len(ADAPTERS), decode=True,
                lora_rank=LORA['adapter_rank'],
                lora_alpha=LORA['adapter_alpha'],
                lora_targets=LORA['adapter_targets'])


# ------------------------------------------------------------ routing

_RECORD = {'on': False, 'routes': [], 'path': None}


def install_routing_probe(path=None) -> None:
    """Wrap models/moe.dispatch: each call records a digest of its
    expert indices and keep mask (in memory while `_RECORD['on']`, or,
    with `path`, appended to that file on every call)."""
    from skypilot_tpu_torch.models import moe
    plain = moe.dispatch
    _RECORD['path'] = path

    def probed(x, idx, probs, w_gate, w_up, w_down, capacity_factor, dtype,
               reduce=None):
        if _RECORD['on'] or path is not None:
            e, k = w_gate.shape[0], idx.shape[-1]
            g = x.shape[0] * x.shape[1]
            gs = moe.group_size(g)
            cap = moe.capacity(gs, k, e, capacity_factor)
            keep = moe.positions(idx.reshape(g // gs, gs, k), e) < cap
            digest = hashlib.sha256(idx.numpy().tobytes() +
                                    keep.numpy().tobytes()).hexdigest()
            if path is not None:
                with open(path, 'a', encoding='utf-8') as f:
                    f.write(digest + '\n')
            else:
                _RECORD['routes'].append(digest)
        return plain(x, idx, probs, w_gate, w_up, w_down, capacity_factor,
                     dtype, reduce)

    moe.dispatch = probed


# ------------------------------------------------------------ model checks
#
# Rank 0 sends ('model', case, meta, extra) and broadcasts the case's full
# tensors; every rank runs `_model_case` on its shard; ('engines',) hands
# the follower to the engines' loop.

def _forward2(model, tokens, aids=None):
    """One 8-token prefill and one decode step of 2 rows through a paged
    pool: (prefill logits, decode logits)."""
    k_pool, v_pool = model.new_kv_pool(9)
    tables = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8, 0],
                           [5, 6, 7, 8, 1, 2, 3, 4, 0]], dtype=torch.int32)
    with torch.inference_mode():
        prefill = model(tokens, torch.arange(8, dtype=torch.int32)[None]
                        .expand(2, 8), tables, k_pool, v_pool,
                        adapter_ids=aids)
        decode = model(tokens[:, -1:], torch.full((2, 1), 8,
                                                  dtype=torch.int32),
                       tables, k_pool, v_pool, adapter_ids=aids)
    return prefill, decode


_TOKENS = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 1, 0, 2, 5, 8, 4]])


def _model_case(group, case, params, extra):
    """Run one model check on this rank (group None: tp=1). Returns a
    dict of host tensors; rank 0 compares them."""
    from skypilot_tpu_torch.models import inference
    from skypilot_tpu_torch.models.convert import adapter_from_jax
    from skypilot_tpu_torch.models.transformer import Transformer
    from skypilot_tpu_torch.parallel import sharding
    tp, rank = (group.tp, group.rank) if group is not None else (1, 0)
    if case == 'lora':
        cfg = dataclasses.replace(_lora_cfg(), paged_block_size=8,
                                  paged_num_blocks=9)
        model = Transformer(cfg, device='cpu', group=group)
        model.load_state_dict(sharding.shard_params(params, cfg, tp, rank))
        for slot, tree in enumerate(extra['trees'], start=1):
            host = adapter_from_jax(tree, cfg)
            for layer, proj, stack in model.lora_stacks():
                a, b = sharding.shard_adapter(
                    proj, *(torch.from_numpy(m) for m in host[layer][proj]),
                    cfg, tp, rank)
                stack.a[slot].copy_(a)
                stack.b[slot].copy_(b)
        prefill, decode = _forward2(model, _TOKENS,
                                    torch.tensor([1, 2], dtype=torch.int32))
        return {'prefill': prefill, 'decode': decode}
    if case == 'int8':
        cfg = dataclasses.replace(_cfg(), decode=True, paged_block_size=8,
                                  paged_num_blocks=9)
        out = {}
        for label, source in (('given', params), ('drawn', None)):
            _, model = inference._build_model(  # pylint: disable=protected-access
                cfg, source, 0, 'int8', torch.device('cpu'), group)
            state = {k: v for k, v in model.state_dict().items()
                     if v.dtype == torch.int8 or k.endswith('_scale')}
            out[label] = state
            if label == 'given':
                out['prefill'], out['decode'] = _forward2(model, _TOKENS)
        return out
    # 'moe': test-tiny-moe at the capacity factor extra['factor'].
    cfg = _cfg('test-tiny-moe', decode=True, paged_block_size=8,
               paged_num_blocks=9, moe_capacity_factor=extra['factor'])
    model = Transformer(cfg, device='cpu', group=group)
    model.load_state_dict(sharding.shard_params(params, cfg, tp, rank))
    prefill, decode = _forward2(model, _TOKENS)
    return {'prefill': prefill, 'decode': decode}


def _stream_params(group, meta):
    """A follower's side of rank 0's broadcasts, one tensor at a time."""
    return ((key, group.broadcast_tensor(None, shape, dtype))
            for key, shape, dtype in meta)


def follower(group):
    """Follower target: the model checks, then the engines' loop."""
    from skypilot_tpu_torch.models import inference
    install_routing_probe(os.environ[ROUTING_ENV] + f'.{group.rank}')
    while True:
        msg = group.recv()
        if msg[0] == 'engines':
            break
        _, case, meta, extra = msg
        params = _stream_params(group, meta)
        if case != 'int8':
            params = dict(params)
        got = _model_case(group, case, params, extra)
        for key in sorted(got):
            if isinstance(got[key], dict):
                for name in sorted(got[key]):
                    group.gather_host(got[key][name])
            else:
                group.gather_host(got[key])
    group.gather_host(torch.tensor([reference_modules()]))
    inference.serve_follower(group)


def _run_model_case(group, case, params, extra):
    """Rank 0: the case at tp=2 (the follower's shards gathered) and at
    tp=1, with the errors and bit checks the test reads."""
    ref = _model_case(None, case, dict(params), extra)
    group.send(('model', case, [(k, tuple(v.shape), v.dtype)
                                for k, v in params.items()], extra))
    for value in params.values():
        group.broadcast_tensor(value, value.shape, value.dtype)
    _RECORD['on'] = True
    try:
        got = _model_case(group, case, dict(params), extra)
    finally:
        _RECORD['on'] = False
    gathered = {}
    for key in sorted(got):
        if isinstance(got[key], dict):
            gathered[key] = {name: group.gather_host(got[key][name])
                             for name in sorted(got[key])}
        else:
            gathered[key] = group.gather_host(got[key])
    out = {'tp2_vs_tp1': max(float((got[k] - ref[k]).abs().max())
                             for k in ('prefill', 'decode')),
           'ranks_equal': all(bool(torch.equal(p[0], p[1]))
                              for k in ('prefill', 'decode')
                              for p in [gathered[k]])}
    if case == 'int8':
        from skypilot_tpu_torch.models.quantize import quantize_weight
        from skypilot_tpu_torch.parallel import sharding
        cfg = _cfg()
        for label in ('given', 'drawn'):
            equal, names = True, []
            for name, parts in gathered[label].items():
                whole = ref[label][name]
                for r, part in enumerate(parts):
                    want = sharding.shard_tensor(name, whole, cfg, 2, r)
                    equal = equal and part.dtype == want.dtype and bool(
                        torch.equal(part, want))
                names.append(name)
            out[f'{label}_shards_equal_tp1_slices'] = equal
            out[f'{label}_tensors'] = len(names)
        # The row-parallel projections (o, down): each rank's scale is
        # the WHOLE input axis's absmax, which a row shard quantized on
        # its own does not give.
        row = {}
        for proj in ('attn.o_proj', 'mlp.down_proj'):
            key = f'layers.0.{proj}'
            w = params[key]
            half = w.shape[0] // 2
            alone = [quantize_weight(w[r * half:(r + 1) * half])
                     for r in range(2)]
            got_scales = gathered['given'][key + '_scale']
            got_q = gathered['given'][key]
            row[proj] = {
                'scale_is_whole_axis': all(
                    bool(torch.equal(s, ref['given'][key + '_scale']))
                    for s in got_scales),
                'differs_from_shard_alone': any(
                    not torch.equal(got_q[r], alone[r][0]) or
                    not torch.equal(got_scales[r], alone[r][1])
                    for r in range(2))}
        out['row_parallel'] = row
    return out


# ------------------------------------------------------------ engines

def _generate(engine, prompts=PROMPTS, adapters=None, new=NEW):
    """Queue every request before the engine thread starts (one schedule
    of ticks at every tp), then wait for them all."""
    adapters = adapters or [None] * len(prompts)
    engine._ensure_thread = lambda: None   # pylint: disable=protected-access
    try:
        futures = [engine.submit(p, max_new_tokens=new, adapter=a)
                   for p, a in zip(prompts, adapters)]
    finally:
        del engine._ensure_thread
    engine._ensure_thread()  # pylint: disable=protected-access
    return [f.result(timeout=120)[0] for f in futures]


def _port_engine(cfg, params, group=None, **kw):
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    kw.setdefault('num_slots', 4)
    kw.setdefault('paged_block_size', 8)
    return ContinuousBatchingEngine(
        cfg, params=None if params is None else dict(params), device='cpu',
        mesh=group, **kw)


def _jax_engine(name='test-tiny', params=None, cfg_kw=None, **kw):
    from skypilot_tpu.models import get_config
    from skypilot_tpu.models.inference import ContinuousBatchingEngine
    cfg = dataclasses.replace(get_config(name), **_KW, **(cfg_kw or {}))
    kw.setdefault('num_slots', 4)
    kw.setdefault('paged_block_size', 8)
    return ContinuousBatchingEngine(cfg, params=params, rng_seed=0, **kw)


def _adapter_rows(engine, trees):
    for name in ADAPTERS:
        engine.load_adapter(name, trees[name])
    return _generate(engine, adapters=list(ADAPTER_ROWS))


def _engine_adapters(group, params, trees):
    """Mixed adapter rows at tp=1 and tp=2, then an eviction and a
    reload at tp=2 (a third adapter takes a slot; ad0 comes back)."""
    out = {}
    mem = {}
    for tp, mesh in ((1, None), (2, group)):
        engine = _port_engine(_cfg(), params, mesh, max_adapters=2, **LORA)
        out[f'tp{tp}'] = _adapter_rows(engine, trees)
        mem[tp] = engine.memory_footprint()
        if tp == 2:
            out['step_collectives'] = engine._tp_step[0]  # pylint: disable=protected-access
            engine.load_adapter('ad2', trees['ad2'])       # evicts ad1
            out['after_eviction'] = _generate(
                engine, adapters=[None, 'ad0', 'ad2', 'ad0'])
            out['evictions'] = engine.adapters_info()['stats']
            engine.unload_adapter('ad2')
            out['after_unload'] = _generate(engine,
                                            adapters=list(ADAPTER_ROWS))
        else:
            out['base_tp1'] = _generate(engine)
            engine.load_adapter('ad2', trees['ad2'])
            out['after_eviction_tp1'] = _generate(
                engine, adapters=[None, 'ad0', 'ad2', 'ad0'])
        assert engine.drain(timeout=60)
        engine._pool.check()  # pylint: disable=protected-access
        engine.stop()
    out['memory'] = {
        'adapter_per_device': mem[2]['adapter_bytes_per_device'],
        'adapter_tp1': mem[1]['adapter_bytes'],
        'adapter_global': mem[2]['adapter_bytes'],
        'frac': mem[2]['total_bytes_per_device'] / mem[1]['total_bytes'],
        'global_equal': mem[2]['total_bytes'] == mem[1]['total_bytes']}
    return out


def _engine_int8(group, params):
    out = {}
    for tp, mesh in ((1, None), (2, group)):
        engine = _port_engine(_cfg(), params, mesh, quantize='int8')
        out[f'tp{tp}'] = _generate(engine)
        mem = engine.memory_footprint()
        out[f'weight_tp{tp}'] = (mem['weight_bytes_per_device']
                                 if tp == 2 else mem['weight_bytes'])
        engine.stop()
    # Random weights: drawn whole one at a time, quantized, then cut.
    for tp, mesh in ((1, None), (2, group)):
        engine = _port_engine(_cfg(), None, mesh, quantize='int8')
        out[f'drawn_tp{tp}'] = _generate(engine, PROMPTS[:2])
        engine.stop()
    out['frac'] = out['weight_tp2'] / out['weight_tp1']
    # The single-request engine takes the knob too.
    from skypilot_tpu_torch.models.inference import InferenceEngine
    for tp, mesh in ((1, None), (2, group)):
        engine = InferenceEngine(_cfg(), params=dict(params), batch_size=2,
                                 quantize='int8', mesh=mesh, device='cpu')
        tokens, _ = engine.generate(np.asarray([PROMPTS[0], PROMPTS[0][::-1]]),
                                    max_new_tokens=NEW)
        out[f'inference_engine_tp{tp}'] = tokens.tolist()
    return out


def _engine_moe(group, params):
    out = {}
    for factor, label in ((MOE_E, 'E'), (1.25, '1.25')):
        cfg = _cfg('test-tiny-moe', moe_capacity_factor=factor)
        for tp, mesh in ((1, None), (2, group)):
            engine = _port_engine(cfg, params, mesh)
            _RECORD['on'] = tp == 2
            try:
                out[f'{label}_tp{tp}'] = _generate(engine)
            finally:
                _RECORD['on'] = False
            if tp == 2:
                out[f'{label}_step_collectives'] = engine._tp_step[0]  # pylint: disable=protected-access
            engine.stop()
    return out


def _handoff(pre, dec, ids, stream_id):
    pre.prefill_prefix(ids)
    chunks = pre.export_prefix_chunks(ids, stream_id, chunk_blocks=2)
    for chunk in chunks:
        result = dec.ingest_chunk(chunk)
    hits = dec.prewarm_stats['hits']
    tokens = dec.generate(ids, max_new_tokens=NEW)[0]
    return {'tokens': tokens, 'final': result['final'],
            'blocks': result['imported_blocks'], 'chunks': len(chunks),
            'prewarm_hit': dec.prewarm_stats['hits'] - hits}


def _engine_tiers(group, params):
    """A tp=2 prefill tier hands off to a tp=1 decode tier, and a tp=1
    prefill tier to a tp=2 decode tier; monolithic tp=1 is the oracle."""
    kw = dict(prefix_cache=4)
    mono = _port_engine(_cfg(), params, **kw)
    out = {'mono': mono.generate(LONG_PROMPT, max_new_tokens=NEW)[0]}
    mono.stop()
    for label, pre_mesh, dec_mesh in (('tp2_to_tp1', group, None),
                                      ('tp1_to_tp2', None, group)):
        pre = _port_engine(_cfg(), params, pre_mesh, tier='prefill', **kw)
        dec = _port_engine(_cfg(), params, dec_mesh, tier='decode', **kw)
        out[label] = _handoff(pre, dec, LONG_PROMPT, f'tp-{label}')
        dec._pool.check()  # pylint: disable=protected-access
        pre.stop()
        dec.stop()
    return out


def _jax_oracles(jax_params, moe_params, trees, out, errors):
    """The JAX package's single-device engines on the same weights."""
    try:
        eng = _jax_engine(params=jax_params, max_adapters=2, **LORA)
        out['adapters'] = _adapter_rows(eng, trees)
        eng.stop()
        eng = _jax_engine(params=jax_params, quantize='int8')
        out['int8'] = _generate(eng)
        eng.stop()
        eng = _jax_engine('test-tiny-moe', params=moe_params,
                          cfg_kw={'moe_capacity_factor': MOE_E})
        out['moe_E'] = _generate(eng)
        eng.stop()
    except Exception as e:  # pylint: disable=broad-except
        errors.append(repr(e))


def run() -> dict:
    t0 = time.monotonic()
    here = os.path.dirname(os.path.abspath(__file__))
    os.environ['PYTHONPATH'] = os.pathsep.join(
        p for p in (here, os.environ.get('PYTHONPATH')) if p)
    routing_dir = tempfile.mkdtemp(prefix='skytpu-tp-routing-')
    os.environ[ROUTING_ENV] = os.path.join(routing_dir, 'routes')
    install_routing_probe()
    import jax

    from skypilot_tpu_torch.models.convert import params_from_jax
    from skypilot_tpu_torch.parallel import distributed
    first = _jax_engine()
    jax_params = jax.device_get(first.params)
    first.stop()
    moe_first = _jax_engine('test-tiny-moe')
    moe_jax_params = jax.device_get(moe_first.params)
    moe_first.stop()
    params = params_from_jax(jax_params, _cfg())
    moe_params = params_from_jax(moe_jax_params, _cfg('test-tiny-moe'))
    trees = {name: random_adapter(_lora_cfg(), 100 + i)
             for i, name in enumerate(ADAPTERS + ('ad2',))}
    jax_out, jax_errors = {}, []
    oracle = threading.Thread(target=_jax_oracles, name='jax-oracles',
                              args=(jax_params, moe_jax_params, trees,
                                    jax_out, jax_errors))
    oracle.start()
    out = {'t_setup': time.monotonic() - t0}
    group = distributed.spawn_group(2, 'torch_tp_compose_driver:follower',
                                    ['cpu', 'cpu'], 'gloo', 120)
    try:
        out['model'] = {
            'lora': _run_model_case(group, 'lora', params,
                                    {'trees': [trees[n] for n in ADAPTERS]}),
            'int8': _run_model_case(group, 'int8', params, {})}
        for factor in (1.25, MOE_E):
            out['model'][f'moe_{factor}'] = _run_model_case(
                group, 'moe', moe_params, {'factor': factor})
        group.send(('engines',))
        out['follower_reference_modules'] = int(group.gather_host(
            torch.tensor([reference_modules()]))[1][0])
        out['t_model'] = time.monotonic() - t0
        out['adapters'] = _engine_adapters(group, params, trees)
        out['int8'] = _engine_int8(group, params)
        out['moe'] = _engine_moe(group, moe_params)
        out['tiers'] = _engine_tiers(group, params)
        out['t_engines'] = time.monotonic() - t0
    finally:
        group.close()
    out['followers_exited'] = [p.returncode for p in group.processes]
    with open(os.environ[ROUTING_ENV] + '.1', encoding='utf-8') as f:
        follower_routes = f.read().split()
    out['routing'] = {'rank0': len(_RECORD['routes']),
                      'rank1': len(follower_routes),
                      'equal': follower_routes == _RECORD['routes']}
    oracle.join()
    out['jax'] = jax_out
    out['jax_errors'] = jax_errors
    out['seconds'] = time.monotonic() - t0
    return out


if __name__ == '__main__':
    print(json.dumps(run()))
