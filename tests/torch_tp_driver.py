"""Tensor-parallel serving on the port, on the CPU: tp=2 over two gloo
processes against tp=1 and the JAX package's single-device engine, on
test-tiny (2 layers, fp32). Prints ONE JSON line that
tests/test_torch_tp.py reads (the reference's tests/sharded_driver.py
does the same for its tp=2 cells, which are red in this sandbox, so the
oracle here is the single-device JAX engine).

Run: JAX_PLATFORMS=cpu python tests/torch_tp_driver.py

This module's top level imports only the port: its `model_follower` is a
follower target, and a follower must import neither jax nor the JAX
package (each rank reports what it imported).
"""
import dataclasses
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
LONG_PROMPT = list(range(1, 33))      # >= _MIN_PREFIX: prefix-cacheable
NEW = 16
# The reference's sharded acceptance cells (tests/sharded_driver.py).
CELLS = [
    ('contig', {}),
    ('paged', dict(paged_block_size=8)),
    ('int8', dict(kv_quant='int8')),
    ('paged-int8', dict(paged_block_size=8, kv_quant='int8')),
    ('spec', dict(paged_block_size=8, speculative=3)),
    ('async3', dict(paged_block_size=8, kv_quant='int8', async_depth=3)),
    ('chunkedprefill', dict(paged_block_size=8, prefill_chunk=4)),
    ('pallas-paged', dict(paged_block_size=8, decode_kernel='pallas')),
]
_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_REFERENCE = ('jax', 'flax', 'skypilot_tpu')


def reference_modules() -> int:
    """Modules of jax, flax or the JAX package this process imported."""
    return sum(1 for m in sys.modules
               if m in _REFERENCE or m.startswith(tuple(
                   r + '.' for r in _REFERENCE)))


def _cfg(**kw):
    from skypilot_tpu_torch.models.configs import get_config
    return dataclasses.replace(get_config('test-tiny'), **_KW, **kw)


# ------------------------------------------------------------ the model

_MODEL_TOKENS = [[3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 1, 0, 2, 5, 8, 4]]


def _model_run(group, params):
    """One prefill of 8 tokens and one decode step through the paged pool
    of a (shard of the) test-tiny model: (prefill logits, decode logits,
    this rank's K pool, V pool, all-reduces made)."""
    from skypilot_tpu_torch.models.transformer import Transformer
    cfg = _cfg(decode=True, paged_block_size=8, paged_num_blocks=9)
    model = Transformer(cfg, device='cpu', group=group)
    if params is None:
        model.init_random_(0)
    else:
        from skypilot_tpu_torch.parallel import sharding
        tp, rank = (group.tp, group.rank) if group else (1, 0)
        model.load_state_dict(sharding.shard_params(params, cfg, tp, rank))
    k_pool, v_pool = model.new_kv_pool(9)
    tokens = torch.tensor(_MODEL_TOKENS)
    tables = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8, 0],
                           [5, 6, 7, 8, 1, 2, 3, 4, 0]], dtype=torch.int32)
    before = group.collectives if group else 0
    with torch.inference_mode():
        prefill = model(tokens, torch.arange(8, dtype=torch.int32)[None]
                        .expand(2, 8), tables, k_pool, v_pool)
        decode = model(tokens[:, -1:], torch.full((2, 1), 8,
                                                  dtype=torch.int32),
                       tables, k_pool, v_pool)
    made = (group.collectives - before) if group else 0
    return prefill, decode, k_pool, v_pool, made


def model_follower(group):
    """Follower target: run the model check on this rank's shard, send
    the pools and the import count to rank 0."""
    params = {}
    meta = group.recv()[0][1]
    for key, shape, dtype in meta:
        params[key] = group.broadcast_tensor(None, shape, dtype)
    _, _, k_pool, v_pool, _ = _model_run(group, params)
    group.gather_host(k_pool)
    group.gather_host(v_pool)
    group.gather_host(torch.tensor([reference_modules()]))
    group.recv()    # rank 0's close


def check_model(params_jax, jcfg):
    """tp=2 logits and pools against tp=1 and the JAX model's logits."""
    import jax.numpy as jnp

    from skypilot_tpu.models.transformer import Transformer as JaxModel
    from skypilot_tpu_torch.models.convert import params_from_jax
    from skypilot_tpu_torch.parallel import distributed
    params = params_from_jax(params_jax, _cfg())
    ref = _model_run(None, params)
    group = distributed.spawn_group(2, 'torch_tp_driver:model_follower',
                                    ['cpu', 'cpu'], 'gloo', 120)
    try:
        group.send([('params', [(k, tuple(v.shape), v.dtype)
                                for k, v in params.items()])])
        for key, value in params.items():
            group.broadcast_tensor(value, value.shape, value.dtype)
        got = _model_run(group, params)
        k_parts = group.gather_host(got[2])
        v_parts = group.gather_host(got[3])
        imported = group.gather_host(torch.tensor([reference_modules()]))
    finally:
        group.close()
    kv = ref[2].shape[3] // 2
    pool_err = max(
        float((part - full[..., r * kv:(r + 1) * kv, :]).abs().max())
        for parts, full in ((k_parts, ref[2]), (v_parts, ref[3]))
        for r, part in enumerate(parts))
    # The JAX model's full-sequence logits of the same 8 tokens (then the
    # 9th from a 9-token forward) on the same weights.
    jmodel = JaxModel(dataclasses.replace(jcfg, decode=False))
    full = np.asarray(_MODEL_TOKENS)
    full9 = np.concatenate([full, full[:, -1:]], axis=1)
    jlogits = np.asarray(jmodel.apply({'params': params_jax},
                                      jnp.asarray(full9)))
    jax_prefill, jax_decode = jlogits[:, :8], jlogits[:, 8]
    return {
        'tp2_vs_tp1': max(float((got[0] - ref[0]).abs().max()),
                          float((got[1] - ref[1]).abs().max())),
        'tp2_vs_jax': max(float(np.abs(got[0].numpy() - jax_prefill).max()),
                          float(np.abs(got[1][:, 0].numpy() -
                                       jax_decode).max())),
        'tp1_vs_jax': max(float(np.abs(ref[0].numpy() - jax_prefill).max()),
                          float(np.abs(ref[1][:, 0].numpy() -
                                       jax_decode).max())),
        'pool_vs_slice': pool_err,
        'collectives_per_two_forwards': got[4],
        'layers': jcfg.num_layers,
        'follower_reference_modules': [int(t[0]) for t in imported],
    }


# ------------------------------------------------------------ engines

def _jax_engine(**kw):
    from skypilot_tpu.models import get_config
    from skypilot_tpu.models.inference import ContinuousBatchingEngine
    cfg = dataclasses.replace(get_config('test-tiny'), **_KW)
    return ContinuousBatchingEngine(cfg, num_slots=2, rng_seed=0, **kw)


def _port_engine(params, group=None, **kw):
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    kw.setdefault('num_slots', 2)
    return ContinuousBatchingEngine(_cfg(), params=dict(params),
                                    device='cpu', mesh=group, **kw)


def _gauges(engine):
    """Enable recording only now (after construction and a request), run
    one more request, and read the tp gauges from the exposition."""
    from skypilot_tpu_torch.observability import exposition
    from skypilot_tpu_torch.observability import metrics as obs
    obs.enable()
    try:
        engine.generate(PROMPT, max_new_tokens=4)
        text = exposition.generate_latest()
    finally:
        obs.disable()
    found = {}
    for line in text.splitlines():
        if line.startswith('skytpu_engine_tp_') or line.startswith(
                'skytpu_engine_paged_blocks_used_per_device') or \
                line.startswith('skytpu_engine_paged_pool_bytes_per_device'):
            name, value = line.rsplit(' ', 1)
            found[name] = float(value)
    return found


def _preempted(engine):
    """A batch request in the one slot, preempted by an interactive
    arrival once it emits: (batch tokens, interactive tokens, slot
    preempts)."""
    started = threading.Event()
    batch = engine.submit(LONG_PROMPT, max_new_tokens=24, priority='batch',
                          on_token=lambda _t: started.set())
    assert started.wait(timeout=60)
    interactive = engine.submit(PROMPT, max_new_tokens=4,
                                priority='interactive')
    return (batch.result(timeout=120)[0], interactive.result(timeout=120)[0],
            engine.tenancy_stats['slot_preempts'])


def _compositions(group, params):
    """decode_chunk 4 on the async ring, and SLO tiers with a slot
    preemption, at tp=1 and tp=2: the same tokens."""
    out = {}
    for tp, mesh in ((1, None), (2, group)):
        chunked = _port_engine(params, mesh, paged_block_size=8,
                               decode_chunk=4, async_depth=1)
        out[f'chunk4_tp{tp}'] = chunked.generate(PROMPT,
                                                 max_new_tokens=NEW)[0]
        out[f'chunk4_steps_tp{tp}'] = chunked.tick_stats['decode_steps']
        chunked.stop()
        tiered = _port_engine(params, mesh, num_slots=1, paged_block_size=8,
                              prefill_chunk=16, async_depth=1)
        out[f'tiers_tp{tp}'] = _preempted(tiered)
        tiered.stop()
    return out


def _refusals(group, params):
    from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
    from skypilot_tpu_torch.parallel.mesh import decode_group
    from skypilot_tpu_torch.serve.server import InferenceServer
    out = {}
    cases = {
        'engine_adapters': lambda: _port_engine(
            params, group, paged_block_size=8, max_adapters=2,
            adapter_rank=4, adapter_targets='q,v'),
        'engine_int8_weights': lambda: _port_engine(
            params, group, paged_block_size=8, quantize='int8'),
        'engine_moe': lambda: ContinuousBatchingEngine(
            'test-tiny-moe', num_slots=2, device='cpu', mesh=group,
            paged_block_size=8),
        'server_adapters': lambda: InferenceServer(
            'test-tiny', tp=2, max_adapters=2, adapter_rank=4,
            device='cpu'),
        'server_moe': lambda: InferenceServer('test-tiny-moe', tp=2,
                                              device='cpu'),
        'server_int8': lambda: InferenceServer('test-tiny', tp=2,
                                               quantize='int8',
                                               device='cpu'),
        'server_tier': lambda: InferenceServer(
            'test-tiny', tp=2, tier='prefill', prefix_cache=4,
            device='cpu'),
        'tp_not_dividing': lambda: _port_engine(
            params, _FakeGroup(3), paged_block_size=8),
        'more_cards_than_present': lambda: decode_group(2, device='cuda'),
        'one_card_twice_on_nccl': lambda: decode_group(
            2, devices=['cuda:0', 'cuda:0'], backend='nccl',
            device='cuda'),
    }
    for name, make in cases.items():
        try:
            make()
            out[name] = None
        except Exception as e:  # pylint: disable=broad-except
            out[name] = f'{type(e).__name__}: {e}'
    return out


class _FakeGroup:
    """A group of `tp` ranks that no process joined: the engine must
    refuse before it sends anything."""

    def __init__(self, tp):
        self.tp, self.rank, self.spawned = tp, 0, True
        self.device = torch.device('cpu')


def run() -> dict:
    t0 = time.monotonic()
    os.environ['PYTHONPATH'] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    os.environ.get('PYTHONPATH')) if p)
    import jax

    from skypilot_tpu.models import get_config as jax_get_config
    from skypilot_tpu_torch.models.convert import params_from_jax
    from skypilot_tpu_torch.models.inference import get_engine
    from skypilot_tpu_torch.parallel.mesh import decode_group
    jcfg = dataclasses.replace(jax_get_config('test-tiny'), **_KW)
    out = {'cells': {name: {} for name, _ in CELLS}}
    # Every JAX engine draws the same weights from rng_seed 0: the first
    # one's are the port's. The JAX cells run in a thread beside the
    # port's work (both frameworks compute off the GIL).
    first = _jax_engine(**CELLS[0][1])
    jax_params = jax.device_get(first.params)
    jax_errors = []

    def jax_cells():
        try:
            for i, (name, kw) in enumerate(CELLS):
                jeng = first if i == 0 else _jax_engine(**kw)
                out['cells'][name]['jax'], _ = jeng.generate(
                    PROMPT, max_new_tokens=NEW)
                jeng.stop()
        except Exception as e:  # pylint: disable=broad-except
            jax_errors.append(repr(e))

    oracle = threading.Thread(target=jax_cells, name='jax-cells')
    oracle.start()
    out['model'] = check_model(jax_params, jcfg)
    out['t_model'] = time.monotonic() - t0
    params = params_from_jax(jax_params, _cfg())

    group = decode_group(2, device='cpu', timeout_seconds=120)
    try:
        for name, kw in CELLS:
            base = _port_engine(params, **kw)
            tp1, _ = base.generate(PROMPT, max_new_tokens=NEW)
            base.stop()
            shard = _port_engine(params, group, **kw)
            tp2, stats = shard.generate(PROMPT, max_new_tokens=NEW)
            out['cells'][name].update(
                tp1=tp1, tp2=tp2, new_tokens=stats['new_tokens'],
                chained=shard.tick_stats['chained'],
                eager=shard.tick_stats.get('eager_steps'))
            if shard.paged_block_size:
                shard._pool.check()  # pylint: disable=protected-access
            if name == 'async3':
                mem = shard.memory_footprint()
                mem1 = _port_engine(params, **kw).memory_footprint()
                out['memory'] = {
                    'per_device_bytes': mem['total_bytes_per_device'],
                    'single_device_bytes': mem1['total_bytes'],
                    'global_bytes': mem['total_bytes'],
                    'frac': (mem['total_bytes_per_device'] /
                             mem1['total_bytes'])}
                out['gauges'] = _gauges(shard)
                out['counts'] = shard.tp_counts()
            shard.stop()

        out['t_cells'] = time.monotonic() - t0
        # The prefix artifact across tp: tp=2 -> tp=2, tp=2 -> tp=1 and
        # tp=1 -> tp=2, each pre-warmed engine's tokens equal the cold
        # engine's.
        kw = dict(paged_block_size=8, prefix_cache=4)
        tmp = tempfile.mkdtemp(prefix='skytpu-tp-')
        src = _port_engine(params, group, **kw)
        ref, _ = src.generate(LONG_PROMPT, max_new_tokens=12)
        path2 = os.path.join(tmp, 'tp2.bin')
        exported = src.export_prefixes(path2)
        block_bytes = src.kv_block_bytes()
        src.stop()
        one = _port_engine(params, **kw)
        ref1, _ = one.generate(LONG_PROMPT, max_new_tokens=12)
        path1 = os.path.join(tmp, 'tp1.bin')
        one.export_prefixes(path1)
        block_bytes1 = one.kv_block_bytes()
        one.stop()
        trips = {}
        for label, path, tp in (('tp2_to_tp2', path2, 2),
                                ('tp2_to_tp1', path2, 1),
                                ('tp1_to_tp2', path1, 2)):
            dst = _port_engine(params, group if tp == 2 else None, **kw)
            imported = dst.import_prefixes(path)
            got, _ = dst.generate(LONG_PROMPT, max_new_tokens=12)
            trips[label] = {'imported': imported['imported'],
                            'blocks': imported['blocks'],
                            'prewarm_hits': dst.prewarm_stats['hits'],
                            'match': got == ref}
            dst._pool.check()  # pylint: disable=protected-access
            dst.stop()
        with open(path2, 'rb') as f2, open(path1, 'rb') as f1:
            same_size = len(f2.read()) == len(f1.read())
        out['roundtrip'] = {'exported': exported['exported'],
                            'tp1_equals_tp2_cold': ref1 == ref,
                            'block_bytes': [block_bytes, block_bytes1],
                            'artifact_sizes_equal': same_size, **trips}
        # The contiguous prefix cache under tp (followers keep each
        # entry's shard by handle) and a watchdog recovery's reset: a
        # hit, then a recovery (a fresh world; the followers drop their
        # entries with the next op), then a miss again, tokens equal.
        contig = _port_engine(params, group, prefix_cache=2)
        runs = [contig.generate(LONG_PROMPT, max_new_tokens=12)[0]
                for _ in range(2)]
        hits = contig.prefix_stats['hits']
        contig._recover_from_wedge('test')  # pylint: disable=protected-access
        runs.append(contig.generate(LONG_PROMPT, max_new_tokens=12)[0])
        out['contig_prefix'] = {'hits_before_recovery': hits,
                                'stats': dict(contig.prefix_stats),
                                'equal': runs[0] == runs[1] == runs[2] ==
                                ref}
        contig.stop()
        out['compositions'] = _compositions(group, params)
        out['refusals'] = _refusals(group, params)
        # A late engine on the same group still serves (the refusals sent
        # nothing to the followers).
        again = _port_engine(params, group, paged_block_size=8)
        out['after_refusals'] = again.generate(
            PROMPT, max_new_tokens=NEW)[0] == out['cells']['paged']['tp1']
        out['counts_after'] = again.tp_counts()
        again.stop()
    finally:
        group.close()
    out['followers_exited'] = [p.returncode for p in group.processes]
    out['t_group'] = time.monotonic() - t0

    # get_engine serves tp=2 through a group of its own.
    get_engine.cache_clear()
    auto = get_engine('test-tiny', max_seq_len=64, tp=2, device='cpu')
    toks2, _ = auto.generate(np.ones((1, 4), np.int64), max_new_tokens=4)
    one = get_engine('test-tiny', max_seq_len=64, tp=1, device='cpu')
    toks1, _ = one.generate(np.ones((1, 4), np.int64), max_new_tokens=4)
    out['get_engine'] = {'tp': auto._tp,  # pylint: disable=protected-access
                         'tokens': toks2.tolist(), 'tp1': toks1.tolist()}
    auto.mesh.close()
    get_engine.cache_clear()
    oracle.join()
    out['jax_errors'] = jax_errors
    out['seconds'] = time.monotonic() - t0
    return out


if __name__ == '__main__':
    print(json.dumps(run()))
