"""Build the port's CUDA kernels at first use and load them with ctypes.

Every kernel source under ops/csrc/ has a plain C interface (no PyTorch
headers), so `nvcc` builds each one into its own shared library in
seconds. Libraries go to ops/build/ (listed in .gitignore) under a name
that carries a hash of the source, every shared header (csrc/*.cuh) and
the flags: an edited source or header never loads a stale build. Nothing here runs at import; `load(name)` builds on
first call and `build_all()` starts one nvcc per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, 'csrc')
BUILD_DIR = os.path.join(_HERE, 'build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) per built source.
build_logs: Dict[str, str] = {}


def sources() -> List[str]:
    """Kernel names: one per ops/csrc/<name>.cu."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith('.cu'))


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (set CUDA_HOME or put nvcc on PATH); the '
            "port's CUDA kernels are built from source at first use")
    return found


def _target(name: str) -> Tuple[str, str]:
    src = os.path.join(CSRC_DIR, f'{name}.cu')
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        digest.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            digest.update(f.read())
    lib = os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:12]}.so')
    return src, lib


def _start(name: str):
    """Start nvcc for `name` unless its library exists; returns
    (lib_path, tmp_path, Popen or None)."""
    src, lib = _target(name)
    if os.path.exists(lib):
        return lib, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{lib}.{os.getpid()}.tmp'
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def _finish(name: str, lib: str, tmp, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu '
                           f'(rc {proc.returncode}):\n{log}')
    os.replace(tmp, lib)     # atomic publish: a half-written .so never loads


def build_all() -> None:
    """Build every kernel source, one nvcc process each, all at once."""
    with _lock:
        started = [(name, *_start(name)) for name in sources()]
        for name, lib, tmp, proc in started:
            _finish(name, lib, tmp, proc)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ops/csrc/<name>.cu, built if needed."""
    with _lock:
        if name not in _libs:
            lib, tmp, proc = _start(name)
            _finish(name, lib, tmp, proc)
            _libs[name] = ctypes.CDLL(lib)
        return _libs[name]
