"""The PyTorch port stands alone: no module of skypilot_tpu_torch, and not
chip_smoke.py, imports jax, flax or anything of the JAX package — not
even its jax-free modules — nor `transformers` or `safetensors`. Two pins: a subprocess that imports every port
module (and chip_smoke.py's module body) with jax and skypilot_tpu
blocked, and an AST scan of every import statement in those files. The
port's own copy of a jax-free reference module keeps the reference's
code: serve/tenancy/scheduling.py is pinned equal to the reference's,
its module docstring aside, and so are callbacks/base.py and
train/data.py's SftJsonlDataset (with the walk it draws from). The KV
portability copies are pinned definition by definition: kv_cache's
artifact and chunk-stream functions and PrefixIndex's touch/get/digest,
every function and class of utils/fault_injection.py (its points the
reference's less the named control-plane list), the prefix
store's classes and methods in data/storage.py, the URL helpers of
data/data_utils.py, the handoff and preemption-notice settings of
serve/constants.py and the engine's `infer_serving_tp`. So
are the observability copies, docstrings aside: every definition of
observability/tracing.py (its spans the reference's less the load
balancer's), the histograms' exemplars and `collect_exemplars`. Each
declared point and span has a literal call site in the port, and every
call site names a declared one (the reference's drift checks, run over
the port's tree).
"""
import ast
import copy
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_REPO, 'skypilot_tpu_torch')


def _port_files():
    files = [os.path.join(_REPO, 'chip_smoke.py')]
    for root, _dirs, names in os.walk(_PKG):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return sorted(files)


def _module_names():
    names = []
    for path in _port_files():
        rel = os.path.relpath(path, _REPO)
        if rel == 'chip_smoke.py':
            continue
        mod = rel[:-3].replace(os.sep, '.')
        names.append(mod[:-len('.__init__')] if mod.endswith('__init__')
                     else mod)
    return names


_BLOCKER = '''
import importlib, importlib.abc, runpy, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ('jax', 'flax', 'skypilot_tpu') or name.startswith(
                ('jax.', 'flax.', 'skypilot_tpu.')):
            raise ImportError(f'port imported {name}')
        return None

sys.modules['jax'] = None
sys.modules['flax'] = None
sys.meta_path.insert(0, _Block())
for mod in sys.argv[2:]:
    importlib.import_module(mod)
runpy.run_path(sys.argv[1], run_name='chip_smoke_module')
leaked = sorted(m for m in sys.modules if m == 'skypilot_tpu' or
                m.startswith(('skypilot_tpu.', 'jax.', 'flax.')))
assert not leaked, leaked
print('ISOLATED', len(sys.argv) - 2)
'''


def test_port_imports_without_jax_or_the_jax_package():
    mods = _module_names()
    for mod in ('skypilot_tpu_torch.models.step_graph',
                'skypilot_tpu_torch.ops.paged_attention',
                'skypilot_tpu_torch.ops.fused_lora',
                'skypilot_tpu_torch.serve.tenancy',
                'skypilot_tpu_torch.serve.tenancy.adapter_pool',
                'skypilot_tpu_torch.serve.tenancy.scheduling',
                'skypilot_tpu_torch.observability',
                'skypilot_tpu_torch.observability.metrics',
                'skypilot_tpu_torch.observability.exposition',
                'skypilot_tpu_torch.observability.tracing',
                'skypilot_tpu_torch.models.quantize',
                'skypilot_tpu_torch.models.safetensors_file',
                'skypilot_tpu_torch.models.export_tool',
                'skypilot_tpu_torch.models.lora',
                'skypilot_tpu_torch.callbacks',
                'skypilot_tpu_torch.callbacks.base',
                'skypilot_tpu_torch.train.tokenize_tool',
                'skypilot_tpu_torch.utils.fault_injection',
                'skypilot_tpu_torch.data.storage',
                'skypilot_tpu_torch.data.data_utils',
                'skypilot_tpu_torch.serve.constants',
                'skypilot_tpu_torch.parallel.mesh',
                'skypilot_tpu_torch.parallel.distributed',
                'skypilot_tpu_torch.parallel.sharding',
                'skypilot_tpu_torch.parallel.tensor',
                'skypilot_tpu_torch.train.elastic',
                'skypilot_tpu_torch.train.checkpoints',
                'skypilot_tpu_torch.train.metrics'):
        assert mod in mods
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run(
        [sys.executable, '-c', _BLOCKER,
         os.path.join(_REPO, 'chip_smoke.py'), *mods],
        capture_output=True, text=True, timeout=120, env=env, cwd=_REPO,
        check=False)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f'ISOLATED {len(mods)}' in proc.stdout


# Every process of a tensor-parallel group blocks jax, flax and the JAX
# package at start (a sitecustomize on PYTHONPATH, which the followers
# inherit): rank 0 serves a request at tp=2 through a follower, and a
# follower that imported any of them would fail its import and the run.
_SITE_BLOCKER = """
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ('jax', 'flax', 'skypilot_tpu') or name.startswith(
                ('jax.', 'flax.', 'skypilot_tpu.')):
            raise ImportError(f'port imported {name}')
        return None

sys.modules['jax'] = None
sys.modules['flax'] = None
sys.meta_path.insert(0, _Block())
"""
_TP_GROUP = """
import sys
from skypilot_tpu_torch.models.inference import ContinuousBatchingEngine
from skypilot_tpu_torch.parallel.mesh import decode_group
group = decode_group(2, device='cpu', timeout_seconds=60)
engine = ContinuousBatchingEngine('test-tiny', max_seq_len=64, num_slots=2,
                                  paged_block_size=8, device='cpu',
                                  mesh=group)
tokens, _ = engine.generate([1, 2, 3, 4], max_new_tokens=4)
engine.stop()
group.close()
leaked = sorted(m for m in sys.modules if m == 'skypilot_tpu' or
                m.startswith(('skypilot_tpu.', 'jax.', 'flax.')))
assert not leaked, leaked
print('FOLLOWERS', [p.returncode for p in group.processes], len(tokens))
"""


def test_tp_followers_import_no_jax_or_the_jax_package(tmp_path):
    (tmp_path / 'sitecustomize.py').write_text(_SITE_BLOCKER)
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), _REPO]))
    proc = subprocess.run([sys.executable, '-c', _TP_GROUP],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=_REPO, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'FOLLOWERS [0] 4' in proc.stdout


def _imported_names(path):
    tree = ast.parse(open(path, encoding='utf-8').read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_no_port_file_names_jax_in_an_import(path):
    for name in _imported_names(path):
        root = name.split('.')[0]
        assert root not in ('jax', 'flax', 'skypilot_tpu'), (
            f'{os.path.relpath(path, _REPO)} imports {name}')


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_no_port_file_imports_transformers_or_safetensors(path):
    """The port reads and writes HF checkpoints itself
    (models/safetensors_file.py): the machine with the card has neither
    package."""
    for name in _imported_names(path):
        assert name.split('.')[0] not in ('transformers', 'safetensors'), (
            f'{os.path.relpath(path, _REPO)} imports {name}')


def _code_without_docstring(path):
    tree = ast.parse(open(path, encoding='utf-8').read(), filename=path)
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            getattr(body[0], 'value', None), ast.Constant):
        body = body[1:]
    return [ast.dump(node) for node in body]


def test_scheduling_copy_equals_the_reference():
    rel = os.path.join('serve', 'tenancy', 'scheduling.py')
    port = _code_without_docstring(os.path.join(_PKG, rel))
    reference = _code_without_docstring(
        os.path.join(_REPO, 'skypilot_tpu', rel))
    assert port == reference


def test_callbacks_copy_equals_the_reference():
    rel = os.path.join('callbacks', 'base.py')
    port = _code_without_docstring(os.path.join(_PKG, rel))
    reference = _code_without_docstring(
        os.path.join(_REPO, 'skypilot_tpu', rel))
    assert port == reference


@pytest.mark.parametrize('name', ['SftJsonlDataset', '_gcd_walk_params'])
def test_sft_dataset_copy_equals_the_reference(name):
    def definition(path):
        tree = ast.parse(open(path, encoding='utf-8').read(), filename=path)
        (node,) = [n for n in tree.body if getattr(n, 'name', None) == name]
        return ast.dump(node)
    rel = os.path.join('train', 'data.py')
    assert definition(os.path.join(_PKG, rel)) == definition(
        os.path.join(_REPO, 'skypilot_tpu', rel))


def _top_level(path):
    """{name: ast dump} of a module's top-level functions, classes and
    single-name assignments."""
    tree = ast.parse(open(path, encoding='utf-8').read(), filename=path)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node
    return out


def _members(node):
    """{name: ast dump} of a class's methods and attribute assignments."""
    out = {}
    for item in node.body:
        if isinstance(item, ast.FunctionDef):
            out[item.name] = ast.dump(item)
        elif isinstance(item, (ast.Assign, ast.AnnAssign)):
            target = (item.targets[0] if isinstance(item, ast.Assign)
                      else item.target)
            out[target.id] = ast.dump(item)
    return out


def _pair(rel, ref_rel=None):
    return (_top_level(os.path.join(_PKG, rel)),
            _top_level(os.path.join(_REPO, 'skypilot_tpu', ref_rel or rel)))


_KV_COPIES = ('prefix_route_hash', 'PREFIX_ARTIFACT_MAGIC',
              'PREFIX_ARTIFACT_VERSION', 'ArtifactError', 'KV_CHUNK_MAGIC',
              'KV_CHUNK_VERSION', 'ChunkError', 'ChunkSequenceError',
              'leaf_sig', '_chunk_crc', 'pack_kv_chunk', 'unpack_kv_chunk',
              '_leaf_sig', '_prefix_crc', 'export_prefixes',
              'read_artifact_header', 'import_prefixes')


@pytest.mark.parametrize('name', _KV_COPIES)
def test_kv_portability_copy_equals_the_reference(name):
    port, ref = _pair(os.path.join('models', 'kv_cache.py'))
    assert ast.dump(port[name]) == ast.dump(ref[name])


@pytest.mark.parametrize('name', ['touch', 'get', 'put', 'pop_lru',
                                  'digest'])
def test_prefix_index_methods_equal_the_reference(name):
    port, ref = _pair(os.path.join('models', 'kv_cache.py'))
    assert _members(port['PrefixIndex'])[name] == \
        _members(ref['PrefixIndex'])[name]


def test_fault_injection_copy_equals_the_reference():
    port, ref = _pair(os.path.join('utils', 'fault_injection.py'))
    points = ast.literal_eval(port.pop('KNOWN_POINTS').value)
    ref_points = ast.literal_eval(ref.pop('KNOWN_POINTS').value)
    left_out = ast.literal_eval(port.pop('CONTROL_PLANE_POINTS').value)
    assert left_out == ('rpc.send', 'replica.probe',
                        'replica.preempt_notice', 'storage.chunk',
                        'lb.digest', 'lb.handoff')
    assert [p for p in ref_points if p not in left_out] == list(points)
    assert set(left_out) <= set(ref_points)
    assert {k: ast.dump(v) for k, v in port.items()} == \
        {k: ast.dump(v) for k, v in ref.items()}


def _without_docstrings(node):
    """ast dump of a definition with every docstring dropped (the copies
    reword some to speak of the port)."""
    node = copy.deepcopy(node)
    for sub in ast.walk(node):
        body = getattr(sub, 'body', None)
        if isinstance(sub, (ast.FunctionDef, ast.ClassDef, ast.Module)) \
                and body and isinstance(body[0], ast.Expr) and \
                isinstance(body[0].value, ast.Constant) and \
                isinstance(body[0].value.value, str):
            sub.body = body[1:] or [ast.Pass()]
    return ast.dump(node)


def test_tracing_copy_equals_the_reference():
    port, ref = _pair(os.path.join('observability', 'tracing.py'))
    spans = ast.literal_eval(port.pop('KNOWN_SPANS').value)
    ref_spans = ast.literal_eval(ref.pop('KNOWN_SPANS').value)
    control_plane = ast.literal_eval(port.pop('CONTROL_PLANE_SPANS').value)
    assert control_plane == ('lb.request', 'lb.route', 'lb.proxy',
                             'lb.handoff', 'lb.handoff_attempt')
    assert [n for n in ref_spans if n not in control_plane] == list(spans)
    assert set(control_plane) <= set(ref_spans)
    assert sorted(port) == sorted(ref)
    for name in port:
        assert _without_docstrings(port[name]) == \
            _without_docstrings(ref[name]), name


@pytest.mark.parametrize('name', ['EXEMPLAR_WINDOW_S', '_HistogramChild',
                                  'Histogram'])
def test_metrics_exemplars_equal_the_reference(name):
    port, ref = _pair(os.path.join('observability', 'metrics.py'))
    assert _without_docstrings(port[name]) == \
        _without_docstrings(ref[name])


def test_collect_exemplars_equals_the_reference():
    port, ref = _pair(os.path.join('observability', 'exposition.py'))
    assert _without_docstrings(port['collect_exemplars']) == \
        _without_docstrings(ref['collect_exemplars'])


def _port_tree():
    from skypilot_tpu.analysis.core import ProjectTree
    return ProjectTree(_PKG)


def test_every_fault_point_has_a_literal_call_site():
    """The reference's injection-drift rule over the port's tree: every
    KNOWN_POINTS entry is fired by a literal fault_injection.point()
    call, and every call names a declared point."""
    from skypilot_tpu.analysis import drift
    tree = _port_tree()
    known, _path, _line = drift.known_points(tree)
    sites = {name for name, _p, _l in drift.collect_points(tree)}
    assert sites == set(known)


def test_every_span_has_a_literal_call_site():
    """The reference's trace-discipline rule over the port's tree: every
    span(...)/start_span(...)/record_span(...) call names a KNOWN_SPANS
    entry by a literal, and every entry has a call site."""
    from skypilot_tpu.analysis import drift
    tree = _port_tree()
    known, _path, _line = drift.known_spans(tree)
    sites = [name for name, _p, _l in drift.collect_span_sites(tree)]
    assert None not in sites
    assert set(sites) == set(known)


@pytest.mark.parametrize('name', ['PlainDirStore', '_KeyPrefixStore',
                                  'artifact_store_from_url'])
def test_prefix_store_copy_equals_the_reference(name):
    port, ref = _pair(os.path.join('data', 'storage.py'))
    assert ast.dump(port[name]) == ast.dump(ref[name])


@pytest.mark.parametrize('cls', ['AbstractStore', 'GcsStore',
                                 'LocalStore'])
def test_store_methods_equal_the_reference(cls):
    """The port keeps the object calls of each store class, and each is
    the reference's."""
    port, ref = _pair(os.path.join('data', 'storage.py'))
    ours, theirs = _members(port[cls]), _members(ref[cls])
    assert ours
    for name, dump in ours.items():
        assert dump == theirs[name], name


@pytest.mark.parametrize('name', ['GCS_PREFIX', 'LOCAL_PREFIX',
                                  '_BUCKET_NAME_RE', 'split_gcs_path',
                                  'split_local_bucket_path',
                                  'validate_bucket_name',
                                  'fake_bucket_dir'])
def test_data_utils_copy_equals_the_reference(name):
    port, ref = _pair(os.path.join('data', 'data_utils.py'))
    assert ast.dump(port[name]) == ast.dump(ref[name])


@pytest.mark.parametrize('name', ['_env_float', 'handoff_chunk_blocks',
                                  'handoff_timeout_seconds',
                                  'ingest_session_ttl_seconds',
                                  'preempt_notice_budget_seconds'])
def test_serve_constants_copy_equals_the_reference(name):
    port, ref = _pair(os.path.join('serve', 'constants.py'))
    assert ast.dump(port[name]) == ast.dump(ref[name])


def test_infer_serving_tp_copy_equals_the_reference():
    port, ref = _pair(os.path.join('models', 'inference.py'))
    assert ast.dump(port['infer_serving_tp']) == \
        ast.dump(ref['infer_serving_tp'])


@pytest.mark.parametrize('name', ['_PREEMPTIONS', '_RESIZES',
                                  'record_preemption',
                                  'notice_budget_seconds',
                                  'PreemptionNotice', 'surviving_extent',
                                  'ElasticMeta', 'IncarnationResult'])
def test_elastic_copy_equals_the_reference(name):
    """train/elastic.py keeps the reference's jax-free definitions, docstrings
    aside (revalidate_extent and ElasticTrainLoop are the port's own: ranks
    are processes)."""
    port, ref = _pair(os.path.join('train', 'elastic.py'))
    assert _without_docstrings(port[name]) == _without_docstrings(ref[name])


@pytest.mark.parametrize('name', ['_SAVE_SECONDS', '_RESTORE_FALLBACKS'])
def test_checkpoint_metrics_equal_the_reference(name):
    port, ref = _pair(os.path.join('train', 'checkpoints.py'))
    assert ast.dump(port[name]) == ast.dump(ref[name])


def test_step_collectives_gauge_equals_the_reference():
    port, ref = _pair(os.path.join('train', 'metrics.py'))
    assert ast.dump(port['_STEP_COLLECTIVES']) == \
        ast.dump(ref['_STEP_COLLECTIVES'])
    assert _without_docstrings(port['publish_step_collectives'].body[-1]) \
        == _without_docstrings(ref['publish_step_collectives'].body[-1])
