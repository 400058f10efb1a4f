"""KV portability on the port's engine, on the CPU: the prefix artifact
(the preemption rescue) and the KV chunk stream (the prefill-to-decode
handoff) in skypilot_tpu_torch/models/kv_cache.py and the engine's
export_prefixes / import_prefixes / prefill_prefix / export_prefix_chunks
/ ingest_chunk in skypilot_tpu_torch/models/inference.py.

  - the reference's wire contracts (tests/test_disagg.py TestChunkFraming,
    tests/test_preemption.py TestPrefixArtifact) on the port's functions,
    and the port's chunk and artifact bytes equal to the reference's for
    the same inputs;
  - the reference's engine contracts (test_disagg.py TestEngineHandoff,
    test_preemption.py TestEngineExportImport) on the port's engines over
    test-tiny fp32 weights carried across from a seeded JAX init: dedup of
    a retried seq, out-of-order refused with the expected seq, corrupt
    chunks rejected without mutation, abort and the TTL sweep back to
    refcount 0, pool-pressure and drain shedding, layout mismatch, int8
    pools, faults that leak and publish nothing;
  - across frameworks: an artifact exported by the JAX engine pre-warms
    the port's engine and a port artifact pre-warms the JAX engine, a JAX
    chunk stream ingests into the port's engine and a port stream into
    the JAX engine, each followed by the JAX engine's greedy tokens; the
    port's `_expected_leaf_meta()` equals the JAX engine's.
"""
import dataclasses
import os
import time

import jax
import numpy as np
import pytest

from skypilot_tpu.models import inference as jax_inference
from skypilot_tpu.models import kv_cache as jax_kv
from skypilot_tpu.models.configs import get_config as jax_get_config
from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch.models import kv_cache as kv
from skypilot_tpu_torch.models.configs import get_config
from skypilot_tpu_torch.models.convert import params_from_jax
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.utils import fault_injection

_KW = dict(dtype='float32', param_dtype='float32', max_seq_len=64,
           remat=False)
_ENGINE_KW = dict(num_slots=2, paged_block_size=8, prefix_cache=6)
_LEAVES = [{'shape': [8, 2, 4], 'dtype': 'float32'},
           {'shape': [8, 2, 4], 'dtype': 'float32'}]
# A 20-token prompt: ceil(20 / 8) = 3 blocks, one chunk each.
_PROMPT = list(range(1, 21))
_NEW = 4


def _payload(num_blocks: int) -> bytes:
    elems = num_blocks * 8 * 2 * 4
    return (np.arange(2 * elems, dtype=np.float32) % 251).tobytes()


def _cfg():
    return dataclasses.replace(get_config('test-tiny'), **_KW)


def _jax_cfg():
    return dataclasses.replace(jax_get_config('test-tiny'), **_KW)


# ---------------------------------------------------------------------
# the chunk stream's framing (host only)
# ---------------------------------------------------------------------


class TestChunkFraming:

    def test_round_trip(self):
        payload = _payload(2)
        data = kv.pack_kv_chunk('s1', 0, 0, 8, _LEAVES, payload, 2)
        header, got = kv.unpack_kv_chunk(data)
        assert got == payload
        assert header['stream_id'] == 's1' and header['seq'] == 0
        assert header['num_blocks'] == 2 and not header.get('final')

    def test_final_round_trip_carries_key(self):
        data = kv.pack_kv_chunk('s1', 2, 2, 8, _LEAVES, _payload(1), 1,
                                final=True, key=list(range(20)),
                                total_blocks=3)
        header, _ = kv.unpack_kv_chunk(data)
        assert header['final'] and header['total_blocks'] == 3
        assert header['key'] == list(range(20))

    def test_final_requires_key(self):
        with pytest.raises(ValueError, match='final chunk requires'):
            kv.pack_kv_chunk('s1', 0, 0, 8, _LEAVES, b'', 1, final=True)

    def test_corrupt_payload_rejected(self):
        data = bytearray(kv.pack_kv_chunk('s1', 0, 0, 8, _LEAVES,
                                          _payload(1), 1))
        data[-1] ^= 0xFF
        with pytest.raises(kv.ChunkError, match='CRC'):
            kv.unpack_kv_chunk(bytes(data))

    def test_truncated_payload_rejected(self):
        data = kv.pack_kv_chunk('s1', 0, 0, 8, _LEAVES, _payload(1), 1)
        with pytest.raises(kv.ChunkError, match='CRC'):
            kv.unpack_kv_chunk(data[:-10])

    def test_tampered_header_rejected(self):
        data = kv.pack_kv_chunk('s1', 3, 12, 8, _LEAVES, _payload(1), 1)
        tampered = data.replace(b'"seq": 3', b'"seq": 4')
        assert tampered != data
        with pytest.raises(kv.ChunkError):
            kv.unpack_kv_chunk(tampered)

    def test_bad_magic_and_version(self):
        with pytest.raises(kv.ChunkError, match='magic'):
            kv.unpack_kv_chunk(b'NOT-A-CHUNK' + b'\0' * 40)
        data = kv.pack_kv_chunk('s1', 0, 0, 8, _LEAVES, _payload(1), 1)
        with pytest.raises(kv.ChunkError, match='version'):
            kv.unpack_kv_chunk(data.replace(b'"version": 1',
                                            b'"version": 9'))

    def test_tampered_final_key_and_count_rejected(self):
        data = kv.pack_kv_chunk('s1', 0, 0, 8, _LEAVES, _payload(1), 1,
                                final=True, key=list(range(20)),
                                total_blocks=3)
        for old, new in ((b'[0, 1, 2,', b'[9, 1, 2,'),
                         (b'"num_blocks": 1', b'"num_blocks": 2')):
            bad = data.replace(old, new)
            assert bad != data
            with pytest.raises(kv.ChunkError, match='CRC'):
                kv.unpack_kv_chunk(bad)
        with pytest.raises(kv.ChunkError):
            kv.unpack_kv_chunk(data.replace(b'"total_blocks": 3',
                                            b'"total_blocks": 2'))

    def test_sequence_error_carries_expected(self):
        err = kv.ChunkSequenceError(2, 5)
        assert err.expected == 2 and err.got == 5
        assert 'expected seq 2' in str(err)

    @pytest.mark.parametrize('case', [
        dict(stream_id='s1', seq=0, start_block=0, num_blocks=2),
        dict(stream_id='h-5f', seq=3, start_block=12, num_blocks=1,
             trace='00-abc-def-01'),
        dict(stream_id='fin', seq=2, start_block=2, num_blocks=1,
             final=True, key=list(range(20)), total_blocks=3),
        dict(stream_id='i8', seq=0, start_block=0, num_blocks=1,
             leaves=[{'shape': [2, 8, 2, 16], 'dtype': 'int8'},
                     {'shape': [2, 8, 2, 1], 'dtype': 'float32'}],
             payload=bytes(range(256)) * 3),
    ], ids=['plain', 'trace', 'final', 'int8'])
    def test_chunk_bytes_equal_the_reference(self, case):
        case = dict(case)
        leaves = case.pop('leaves', _LEAVES)
        payload = case.pop('payload', _payload(case['num_blocks']))
        args = (case.pop('stream_id'), case.pop('seq'),
                case.pop('start_block'), 8, leaves, payload,
                case.pop('num_blocks'))
        port = kv.pack_kv_chunk(*args, **case)
        assert port == jax_kv.pack_kv_chunk(*args, **case)
        assert kv.unpack_kv_chunk(port) == jax_kv.unpack_kv_chunk(port)

    def test_route_hash_and_digest_equal_the_reference(self):
        rng = np.random.RandomState(3)
        port, ref = kv.PrefixIndex(4, 8), jax_kv.PrefixIndex(4, 8)
        for n in (5, 16, 23, 40, 9, 17):
            ids = rng.randint(0, 512, n).tolist()
            assert kv.prefix_route_hash(ids) == \
                jax_kv.prefix_route_hash(ids)
            port.put(ids, [1])
            ref.put(ids, [1])
            port.touch(ids[:3])
            ref.touch(ids[:3])
            assert port.digest() == ref.digest()
            assert port.digest(max_hashes=3) == ref.digest(max_hashes=3)
            assert port.epoch == ref.epoch
            assert port.get(ids) == ref.get(ids) == [1]


# ---------------------------------------------------------------------
# the prefix artifact (host only, over a numpy pool)
# ---------------------------------------------------------------------


class _FakePool:
    """An index and a block pool over a numpy leaf (4 tokens x 2 x 3
    per block), with the gather/scatter callbacks the engine supplies."""

    def __init__(self, block_size=4, num_blocks=16, module=kv):
        self.pool = module.BlockPool(num_blocks, block_size)
        self.index = module.PrefixIndex(capacity=8, chunk=block_size)
        self.leaf = np.arange(num_blocks * block_size * 6,
                              dtype=np.float32).reshape(
                                  num_blocks, block_size, 2, 3)
        self.meta = [{'shape': list(self.leaf.shape[1:]),
                      'dtype': 'float32'}]

    def add_prefix(self, ids):
        ids = list(ids)
        blocks = [self.pool.alloc()
                  for _ in range(-(-len(ids) // self.pool.block_size))]
        self.index.put(ids, blocks)
        return blocks

    def gather(self, blocks):
        return [self.leaf[np.asarray(list(blocks))]]

    def scatter(self, blocks, blob):
        self.leaf[np.asarray(list(blocks))] = np.frombuffer(
            blob, dtype=np.float32).reshape(
                (len(blocks),) + self.leaf.shape[1:])


def _export(src, tmp_path, name='a.pfx', **kw):
    path = str(tmp_path / name)
    return path, kv.export_prefixes(src.index, src.pool, src.gather, path,
                                    **kw)


class TestPrefixArtifact:

    def test_round_trip_restores_bytes_and_trie(self, tmp_path):
        src = _FakePool()
        b1 = src.add_prefix(range(100, 108))
        src.add_prefix(range(200, 205))
        path, stats = _export(src, tmp_path)
        assert stats['exported'] == 2 and not stats['truncated']
        dst = _FakePool()
        dst.leaf[:] = 0
        got = kv.import_prefixes(path, dst.index, dst.pool, dst.scatter,
                                 expect_leaves=dst.meta)
        assert got['imported'] == 2 and got['blocks'] == stats['blocks']
        dst.pool.check()
        plen, payload = dst.index.lookup(list(range(100, 108)) + [1], 8)
        assert plen == 8
        assert np.array_equal(dst.leaf[np.asarray(payload)],
                              src.leaf[np.asarray(b1)])

    def test_block_size_mismatch_rejects_cleanly(self, tmp_path):
        src = _FakePool(block_size=4)
        src.add_prefix(range(8))
        path, _ = _export(src, tmp_path)
        dst = _FakePool(block_size=8)
        with pytest.raises(kv.ArtifactError, match='block_size'):
            kv.import_prefixes(path, dst.index, dst.pool, dst.scatter)
        assert len(dst.index) == 0 and dst.pool.used == 1
        dst.pool.check()

    def test_layout_mismatch_rejects_cleanly(self, tmp_path):
        src = _FakePool()
        src.add_prefix(range(8))
        path, _ = _export(src, tmp_path)
        dst = _FakePool()
        with pytest.raises(kv.ArtifactError, match='layout'):
            kv.import_prefixes(path, dst.index, dst.pool, dst.scatter,
                               expect_leaves=[{'shape': [4, 2, 3],
                                               'dtype': 'bfloat16'}])
        assert len(dst.index) == 0

    def test_corrupt_prefix_skipped_never_trusted(self, tmp_path):
        src = _FakePool()
        src.add_prefix(range(100, 108))
        src.add_prefix(range(200, 205))
        path, _ = _export(src, tmp_path)
        raw = bytearray(open(path, 'rb').read())
        raw[-3] ^= 0xFF
        open(path, 'wb').write(bytes(raw))
        dst = _FakePool()
        got = kv.import_prefixes(path, dst.index, dst.pool, dst.scatter,
                                 expect_leaves=dst.meta)
        assert got['skipped_corrupt'] == 1 and got['imported'] == 1
        dst.pool.check()

    def test_truncated_payload_skipped(self, tmp_path):
        src = _FakePool()
        src.add_prefix(range(100, 108))
        path, _ = _export(src, tmp_path)
        raw = open(path, 'rb').read()
        open(path, 'wb').write(raw[:-10])
        dst = _FakePool()
        got = kv.import_prefixes(path, dst.index, dst.pool, dst.scatter)
        assert got['imported'] == 0 and got['skipped_corrupt'] == 1
        dst.pool.check()

    def test_garbage_file_raises_artifact_error(self, tmp_path):
        path = str(tmp_path / 'junk.pfx')
        open(path, 'wb').write(b'not an artifact at all')
        dst = _FakePool()
        with pytest.raises(kv.ArtifactError):
            kv.import_prefixes(path, dst.index, dst.pool, dst.scatter)

    def test_double_import_is_idempotent(self, tmp_path):
        src = _FakePool()
        src.add_prefix(range(100, 108))
        src.add_prefix(range(200, 205))
        path, _ = _export(src, tmp_path)
        dst = _FakePool()
        kv.import_prefixes(path, dst.index, dst.pool, dst.scatter)
        used = dst.pool.used
        again = kv.import_prefixes(path, dst.index, dst.pool, dst.scatter)
        assert again['imported'] == 0 and again['skipped_existing'] == 2
        assert dst.pool.used == used
        dst.pool.check()

    def test_nearly_full_pool_partial_prewarm_invariants_hold(
            self, tmp_path):
        src = _FakePool()
        src.add_prefix(range(100, 108))
        src.add_prefix(range(200, 212))
        path, _ = _export(src, tmp_path)
        dst = _FakePool(num_blocks=5)
        got = kv.import_prefixes(path, dst.index, dst.pool, dst.scatter,
                                 expect_leaves=dst.meta)
        assert got['stopped_pool_full']
        assert got['imported'] == 1 and got['blocks'] == 3
        assert len(dst.index) == 1
        dst.pool.check()

    def test_export_newest_first_under_deadline(self, tmp_path):
        src = _FakePool()
        src.add_prefix(range(100, 108))
        src.add_prefix(range(200, 205))
        calls = {'n': 0}

        def stop_after_one():
            calls['n'] += 1
            return calls['n'] > 1

        path, stats = _export(src, tmp_path, should_stop=stop_after_one)
        assert stats['exported'] == 1 and stats['truncated']
        dst = _FakePool()
        got = kv.import_prefixes(path, dst.index, dst.pool, dst.scatter)
        assert got['keys'] == [tuple(range(200, 205))]

    def test_artifact_bytes_equal_the_reference(self, tmp_path):
        """The same index, pool and gather give the same file from both
        packages' export_prefixes (the writer's pid only names its
        temporary file)."""
        pools = {}
        for name, module in (('port', kv), ('ref', jax_kv)):
            src = _FakePool(module=module)
            src.add_prefix(range(100, 108))
            src.add_prefix(range(200, 211))
            src.add_prefix(range(300, 302))
            path = str(tmp_path / f'{name}.pfx')
            module.export_prefixes(src.index, src.pool, src.gather, path)
            pools[name] = open(path, 'rb').read()
        assert pools['port'] == pools['ref']
        assert kv.read_artifact_header(str(tmp_path / 'port.pfx')) == \
            jax_kv.read_artifact_header(str(tmp_path / 'ref.pfx'))


# ---------------------------------------------------------------------
# engines: the JAX engine and the port's on the same weights
# ---------------------------------------------------------------------


@pytest.fixture(scope='module')
def reference():
    """The JAX engine (tokens and leaf meta) and its weights; the engine
    stays up for the cross-framework cases."""
    engine = jax_inference.ContinuousBatchingEngine(
        _jax_cfg(), rng_seed=0, **_ENGINE_KW)
    want, _ = engine.generate(_PROMPT, max_new_tokens=_NEW)
    yield {'engine': engine, 'want': want,
           'params': jax.device_get(engine.params)}
    fault_injection.disarm_all()
    engine.stop()


def _engine(reference, **kw):
    for key, value in _ENGINE_KW.items():
        kw.setdefault(key, value)
    return ContinuousBatchingEngine(
        _cfg(), params=params_from_jax(reference['params'], _cfg()),
        device='cpu', **kw)


@pytest.fixture(scope='module')
def handoff_engines(reference):
    """A prefill-tier and a decode-tier port engine, each warmed."""
    pre = _engine(reference, tier='prefill')
    dec = _engine(reference, tier='decode')
    for engine in (pre, dec):
        engine.generate([1, 2, 3], max_new_tokens=2)
    yield pre, dec
    fault_injection.disarm_all()
    for engine in (pre, dec):
        engine.stop()


def _stream(pre, ids, stream_id):
    pre.prefill_prefix(ids)
    return pre.export_prefix_chunks(ids, stream_id, chunk_blocks=1)


class TestEngineHandoff:

    def test_tier_validation(self, reference):
        with pytest.raises(ValueError, match='unknown engine tier'):
            _engine(reference, tier='gpu')
        with pytest.raises(ValueError, match='requires paged_block_size'):
            _engine(reference, tier='prefill', paged_block_size=0)
        with pytest.raises(ValueError, match='requires paged_block_size'):
            _engine(reference, tier='decode', prefix_cache=0)

    def test_stream_round_trip_equals_the_reference(self, reference,
                                                    handoff_engines):
        """prefill_prefix -> export_prefix_chunks -> ingest_chunk: the
        handed-off prompt admits as a full-prefix hit, credited as a
        pre-warm hit, and decodes the JAX engine's greedy tokens."""
        pre, dec = handoff_engines
        stats = pre.prefill_prefix(_PROMPT)
        assert stats['cached'] and stats['prompt_tokens'] == 20
        chunks = pre.export_prefix_chunks(_PROMPT, 'rt-1', chunk_blocks=1)
        assert len(chunks) == 3
        hits = dec.prewarm_stats['hits']
        for chunk in chunks:
            result = dec.ingest_chunk(chunk)
        assert result['final'] and result['imported_blocks'] == 3
        out, _ = dec.generate(_PROMPT, max_new_tokens=_NEW)
        assert out == reference['want']
        assert dec.prewarm_stats['hits'] == hits + 1
        dec._pool.check()  # pylint: disable=protected-access

    def test_export_uncached_prefix_raises_retryably(self, handoff_engines):
        pre, _dec = handoff_engines
        with pytest.raises(ValueError, match='not cached'):
            pre.export_prefix_chunks([9, 9, 9, 9], 'nope-1')

    def test_duplicate_chunks_dedup_without_double_allocation(
            self, handoff_engines):
        pre, dec = handoff_engines
        chunks = _stream(pre, list(range(30, 50)), 'dup-1')
        dec.ingest_chunk(chunks[0])
        used = dec._pool.used  # pylint: disable=protected-access
        assert dec.ingest_chunk(chunks[0])['duplicate']
        assert dec._pool.used == used  # pylint: disable=protected-access
        for chunk in chunks[1:]:
            dec.ingest_chunk(chunk)
        used = dec._pool.used  # pylint: disable=protected-access
        assert dec.ingest_chunk(chunks[-1])['duplicate']
        assert dec._pool.used == used  # pylint: disable=protected-access
        dec._pool.check()  # pylint: disable=protected-access

    def test_out_of_order_refused_with_expected_seq(self, handoff_engines):
        pre, dec = handoff_engines
        ids = list(range(60, 80))
        chunks = _stream(pre, ids, 'ooo-1')
        dec.ingest_chunk(chunks[0])
        with pytest.raises(kv.ChunkSequenceError) as exc:
            dec.ingest_chunk(chunks[2])
        assert exc.value.expected == 1
        fresh = pre.export_prefix_chunks(ids, 'ooo-2', chunk_blocks=1)
        with pytest.raises(kv.ChunkSequenceError) as exc:
            dec.ingest_chunk(fresh[1])
        assert exc.value.expected == 0
        assert dec.abort_ingest('ooo-1')
        dec._pool.check()  # pylint: disable=protected-access

    def test_corrupt_chunk_rejected_without_mutation(self, handoff_engines):
        pre, dec = handoff_engines
        chunks = _stream(pre, list(range(100, 120)), 'cor-1')
        used = dec._pool.used  # pylint: disable=protected-access
        bad = bytearray(chunks[0])
        bad[-1] ^= 0xFF
        with pytest.raises(kv.ChunkError, match='CRC'):
            dec.ingest_chunk(bytes(bad))
        assert dec._pool.used == used  # pylint: disable=protected-access
        assert 'cor-1' not in dec._ingest_sessions  # pylint: disable=protected-access

    def test_abort_rolls_back_to_refcount_zero(self, handoff_engines):
        pre, dec = handoff_engines
        chunks = _stream(pre, list(range(130, 150)), 'abr-1')
        used = dec._pool.used  # pylint: disable=protected-access
        dec.ingest_chunk(chunks[0])
        dec.ingest_chunk(chunks[1])
        assert dec._pool.used == used + 2  # pylint: disable=protected-access
        assert dec.abort_ingest('abr-1') is True
        assert dec.abort_ingest('abr-1') is False
        assert dec._pool.used == used  # pylint: disable=protected-access
        dec._pool.check()  # pylint: disable=protected-access
        assert dec.ingest_stats['streams_aborted'] >= 1

    def test_tick_sweep_reclaims_without_new_ingest(self, handoff_engines):
        """The TTL sweep runs every engine tick: a quiet decode replica
        reclaims an orphaned stream without further ingest traffic."""
        pre, dec = handoff_engines
        chunks = _stream(pre, list(range(200, 220)), 'tick-1')
        used = dec._pool.used  # pylint: disable=protected-access
        dec.ingest_chunk(chunks[0])
        with dec._ingest_lock:  # pylint: disable=protected-access
            dec._ingest_sessions['tick-1'].touched -= 10_000  # pylint: disable=protected-access
        deadline = time.time() + 30
        while time.time() < deadline and \
                'tick-1' in dec._ingest_sessions:  # pylint: disable=protected-access
            time.sleep(0.02)
        assert 'tick-1' not in dec._ingest_sessions  # pylint: disable=protected-access
        assert dec._pool.used == used  # pylint: disable=protected-access
        dec._pool.check()  # pylint: disable=protected-access

    def test_ttl_sweep_reclaims_orphaned_stream(self, handoff_engines):
        pre, dec = handoff_engines
        ids = list(range(160, 180))
        chunks = _stream(pre, ids, 'ttl-1')
        fresh = pre.export_prefix_chunks(ids, 'ttl-2', chunk_blocks=1)
        used = dec._pool.used  # pylint: disable=protected-access
        dec.ingest_chunk(chunks[0])
        expired = dec.ingest_stats['streams_expired']
        with dec._ingest_lock:  # pylint: disable=protected-access
            dec._ingest_sessions['ttl-1'].touched -= 10_000  # pylint: disable=protected-access
        # The next chunk's sweep (or the engine tick's, whichever runs
        # first) rolls the orphan back.
        dec.ingest_chunk(fresh[0])
        assert 'ttl-1' not in dec._ingest_sessions  # pylint: disable=protected-access
        assert dec.ingest_stats['streams_expired'] == expired + 1
        dec.abort_ingest('ttl-2')
        assert dec._pool.used == used  # pylint: disable=protected-access
        dec._pool.check()  # pylint: disable=protected-access

    def test_pool_pressure_sheds_new_streams(self, reference):
        """A new stream must leave one full-depth request of headroom:
        pressure sheds with EngineOverloadedError, never corrupts."""
        tiny = _engine(reference, num_slots=1, paged_num_blocks=4,
                       prefix_cache=1, tier='decode')
        try:
            meta = tiny._expected_leaf_meta()  # pylint: disable=protected-access
            payload = b''.join(np.zeros((1,) + tuple(m['shape']),
                                        np.dtype(m['dtype'])).tobytes()
                               for m in meta)
            chunk = kv.pack_kv_chunk('shed-1', 0, 0, 8, meta, payload, 1)
            with pytest.raises(exceptions.EngineOverloadedError,
                               match='pool pressure'):
                tiny.ingest_chunk(chunk)
            assert tiny.ingest_stats['chunks_shed'] == 1
            tiny._pool.check()  # pylint: disable=protected-access
        finally:
            tiny.stop()

    def test_layout_mismatch_rejected(self, handoff_engines):
        _pre, dec = handoff_engines
        with pytest.raises(kv.ChunkError, match='layout'):
            dec.ingest_chunk(kv.pack_kv_chunk('lay-1', 0, 0, 8, _LEAVES,
                                              _payload(1), 1))
        meta = dec._expected_leaf_meta()  # pylint: disable=protected-access
        with pytest.raises(kv.ChunkError, match='layout'):
            dec.ingest_chunk(kv.pack_kv_chunk('lay-2', 0, 0, 16, meta,
                                              b'', 1))

    def test_engine_ingest_fault_point(self, handoff_engines):
        pre, dec = handoff_engines
        chunks = _stream(pre, list(range(190, 210)), 'flt-1')
        used = dec._pool.used  # pylint: disable=protected-access
        fault_injection.arm('engine.ingest', 'fail:1')
        try:
            with pytest.raises(fault_injection.InjectedFault):
                dec.ingest_chunk(chunks[0])
        finally:
            fault_injection.disarm_all()
        assert dec._pool.used == used  # pylint: disable=protected-access
        dec.ingest_chunk(chunks[0])
        dec.abort_ingest('flt-1')
        dec._pool.check()  # pylint: disable=protected-access

    def test_draining_engine_sheds_ingest(self, handoff_engines):
        pre, dec = handoff_engines
        chunks = _stream(pre, list(range(220, 240)), 'drn-1')
        dec._draining = True  # pylint: disable=protected-access
        try:
            with pytest.raises(exceptions.EngineDrainingError):
                dec.ingest_chunk(chunks[0])
        finally:
            dec._draining = False  # pylint: disable=protected-access

    def test_prefix_digest_names_the_cached_prefixes(self, handoff_engines):
        pre, _dec = handoff_engines
        ids = list(range(250, 270))
        pre.prefill_prefix(ids)
        digest = pre.prefix_digest()
        version, chunk, epoch, hashes = digest.split(':')
        assert (version, chunk) == ('v1', '8')
        assert int(epoch) == pre._prefix_entries.epoch  # pylint: disable=protected-access
        # Newest entry first, its longest chunk-aligned prefix first.
        assert hashes.split(',')[:2] == [kv.prefix_route_hash(ids[:16]),
                                         kv.prefix_route_hash(ids[:8])]
        assert pre.prefix_digest() is digest


def _export_engine(engine, ids, path):
    engine.generate(ids, max_new_tokens=2)
    assert engine.drain(timeout=60)
    return engine.export_prefixes(path)


class TestEngineExportImport:

    def test_prewarmed_replacement_equals_the_reference(self, reference,
                                                        tmp_path):
        path = str(tmp_path / 'victim.skypfx')
        stats = _export_engine(_engine(reference), _PROMPT, path)
        assert stats['exported'] == 1 and stats['blocks'] == 3
        rep = _engine(reference)
        got = rep.import_prefixes(path)
        assert got['imported'] == 1 and got['skipped_corrupt'] == 0
        out, _ = rep.generate(_PROMPT, max_new_tokens=_NEW)
        assert out == reference['want']
        assert rep.prewarm_stats == {'hits': 1, 'export_blocks': 0,
                                     'prewarm_blocks': 3}
        assert rep.prefix_stats['tokens_reused'] == len(_PROMPT) - 1
        rep._pool.check()  # pylint: disable=protected-access
        rep.stop()

    def test_int8_pool_round_trip_equals_cold(self, reference, tmp_path):
        cold = _engine(reference, kv_quant='int8')
        want, _ = cold.generate(_PROMPT, max_new_tokens=_NEW)
        cold.stop()
        path = str(tmp_path / 'int8.skypfx')
        _export_engine(_engine(reference, kv_quant='int8'), _PROMPT, path)
        header, _ = kv.read_artifact_header(path)
        assert [leaf['dtype'] for leaf in header['leaves']] == \
            ['int8', 'float32', 'int8', 'float32']
        rep = _engine(reference, kv_quant='int8')
        rep.import_prefixes(path)
        got, _ = rep.generate(_PROMPT, max_new_tokens=_NEW)
        assert got == want
        assert rep.prewarm_stats['hits'] == 1
        rep.stop()

    def test_fp32_artifact_rejected_by_int8_engine(self, reference,
                                                   tmp_path):
        path = str(tmp_path / 'fp32.skypfx')
        _export_engine(_engine(reference), _PROMPT, path)
        rep = _engine(reference, kv_quant='int8')
        with pytest.raises(kv.ArtifactError, match='layout'):
            rep.import_prefixes(path)
        assert len(rep._prefix_entries) == 0  # pylint: disable=protected-access
        rep._pool.check()  # pylint: disable=protected-access
        toks, _ = rep.generate([1, 2, 3], max_new_tokens=3)
        assert len(toks) == 3
        rep.stop()

    def test_storage_import_fault_leaks_nothing(self, reference, tmp_path):
        path = str(tmp_path / 'a.skypfx')
        _export_engine(_engine(reference), _PROMPT, path)
        rep = _engine(reference)
        fault_injection.arm('storage.import', 'fail:1')
        try:
            with pytest.raises(fault_injection.InjectedFault):
                rep.import_prefixes(path)
            rep._pool.check()  # pylint: disable=protected-access
            assert len(rep._prefix_entries) == 0  # pylint: disable=protected-access
        finally:
            fault_injection.disarm_all()
        assert rep.import_prefixes(path)['imported'] == 1
        rep._pool.check()  # pylint: disable=protected-access
        rep.stop()

    def test_export_fault_publishes_nothing(self, reference, tmp_path):
        vic = _engine(reference)
        vic.generate(_PROMPT, max_new_tokens=2)
        assert vic.drain(timeout=60)
        path = str(tmp_path / 'never.skypfx')
        fault_injection.arm('storage.export', 'fail')
        try:
            with pytest.raises(fault_injection.InjectedFault):
                vic.export_prefixes(path)
        finally:
            fault_injection.disarm_all()
        assert not os.path.exists(path)
        assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------
# across frameworks
# ---------------------------------------------------------------------


@pytest.mark.parametrize('kv_quant', [None, 'int8'])
def test_expected_leaf_meta_equals_the_jax_engine(reference, kv_quant):
    port = _engine(reference, kv_quant=kv_quant)
    ref = jax_inference.ContinuousBatchingEngine(
        _jax_cfg(), kv_quant=kv_quant, **_ENGINE_KW)
    try:
        assert port._expected_leaf_meta() == ref._expected_leaf_meta()  # pylint: disable=protected-access
    finally:
        port.stop()
        ref.stop()


def test_jax_artifact_prewarms_the_port(reference, tmp_path):
    path = str(tmp_path / 'jax.skypfx')
    jax_engine = reference['engine']
    jax_engine.generate(_PROMPT, max_new_tokens=2)
    assert jax_engine.export_prefixes(path)['exported'] >= 1
    port = _engine(reference)
    got = port.import_prefixes(path)
    assert got['imported'] >= 1 and got['skipped_corrupt'] == 0
    out, _ = port.generate(_PROMPT, max_new_tokens=_NEW)
    assert out == reference['want']
    assert port.prewarm_stats['hits'] == 1
    port._pool.check()  # pylint: disable=protected-access
    port.stop()


def test_port_artifact_prewarms_the_jax_engine(reference, tmp_path):
    path = str(tmp_path / 'port.skypfx')
    _export_engine(_engine(reference), _PROMPT, path)
    jax_engine = jax_inference.ContinuousBatchingEngine(
        _jax_cfg(), rng_seed=0, **_ENGINE_KW)
    try:
        got = jax_engine.import_prefixes(path)
        assert got['imported'] == 1 and got['skipped_corrupt'] == 0
        out, _ = jax_engine.generate(_PROMPT, max_new_tokens=_NEW)
        assert out == reference['want']
        assert jax_engine.prefix_stats['prewarm_hits'] == 1
    finally:
        jax_engine.stop()


def test_jax_chunk_stream_ingests_into_the_port(reference):
    jax_engine = reference['engine']
    ids = list(range(300, 319))
    want, _ = jax_engine.generate(ids, max_new_tokens=_NEW)
    jax_engine.prefill_prefix(ids)
    chunks = jax_engine.export_prefix_chunks(ids, 'jx-1', chunk_blocks=2)
    assert len(chunks) == 2
    port = _engine(reference, tier='decode')
    try:
        for chunk in chunks:
            result = port.ingest_chunk(chunk)
        assert result['final'] and result['imported_blocks'] == 3
        out, _ = port.generate(ids, max_new_tokens=_NEW)
        assert out == want
        assert port.prewarm_stats['hits'] == 1
        port._pool.check()  # pylint: disable=protected-access
    finally:
        port.stop()


def test_port_chunk_stream_ingests_into_the_jax_engine(reference):
    ids = list(range(400, 421))
    port = _engine(reference, tier='prefill')
    try:
        port.prefill_prefix(ids)
        chunks = port.export_prefix_chunks(ids, 'pt-1', chunk_blocks=2)
    finally:
        port.stop()
    jax_engine = jax_inference.ContinuousBatchingEngine(
        _jax_cfg(), rng_seed=0, tier='decode', **_ENGINE_KW)
    try:
        want, _ = reference['engine'].generate(ids, max_new_tokens=_NEW)
        for chunk in chunks:
            result = jax_engine.ingest_chunk(chunk)
        assert result['final'] and result['imported_blocks'] == 3
        out, _ = jax_engine.generate(ids, max_new_tokens=_NEW)
        assert out == want
        assert jax_engine.prefix_stats['prewarm_hits'] == 1
    finally:
        jax_engine.stop()
