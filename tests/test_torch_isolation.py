"""The PyTorch port stands alone: no module of skypilot_tpu_torch, and not
chip_smoke.py, imports jax, flax or anything of the JAX package — not
even its jax-free modules — nor `transformers` or `safetensors`. Two pins: a subprocess that imports every port
module (and chip_smoke.py's module body) with jax and skypilot_tpu
blocked, and an AST scan of every import statement in those files. The
port's own copy of a jax-free reference module keeps the reference's
code: serve/tenancy/scheduling.py is pinned equal to the reference's,
its module docstring aside, and so are callbacks/base.py and
train/data.py's SftJsonlDataset (with the walk it draws from).
"""
import ast
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
                'skypilot_tpu_torch.models.quantize',
                'skypilot_tpu_torch.models.safetensors_file',
                'skypilot_tpu_torch.models.export_tool',
                'skypilot_tpu_torch.models.lora',
                'skypilot_tpu_torch.callbacks',
                'skypilot_tpu_torch.callbacks.base',
                'skypilot_tpu_torch.train.tokenize_tool'):
        assert mod in mods
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run(
        [sys.executable, '-c', _BLOCKER,
         os.path.join(_REPO, 'chip_smoke.py'), *mods],
        capture_output=True, text=True, timeout=120, env=env, cwd=_REPO,
        check=False)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f'ISOLATED {len(mods)}' in proc.stdout


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
