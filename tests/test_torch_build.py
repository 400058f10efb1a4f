"""ops/_build.py names each kernel library by a digest of its source, the
shared headers (csrc/*.cuh) and the nvcc flags, so an edited source or
header never loads a stale build. Runs on the CPU: nothing is compiled."""
import os

import pytest

from skypilot_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / 'csrc'
    src.mkdir()
    (src / 'kern.cu').write_text('#include "shared.cuh"\nint k;\n')
    (src / 'other.cu').write_text('int o;\n')
    (src / 'shared.cuh').write_text('#pragma once\nint h;\n')
    monkeypatch.setattr(_build, 'CSRC_DIR', str(src))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    return src


def test_sources_are_the_cu_files_only(csrc):
    assert _build.sources() == ['kern', 'other']


@pytest.mark.parametrize('edit', ['shared.cuh', 'kern.cu', 'new.cuh'])
def test_an_edited_source_or_header_names_a_new_library(csrc, edit):
    src, before = _build._target('kern')  # pylint: disable=protected-access
    assert src == os.path.join(str(csrc), 'kern.cu')
    with open(csrc / edit, 'a') as f:
        f.write('int edited;\n')
    _, after = _build._target('kern')  # pylint: disable=protected-access
    assert after != before
    assert os.path.dirname(after) == _build.BUILD_DIR


def test_an_unchanged_tree_names_the_same_library(csrc):
    first = _build._target('kern')  # pylint: disable=protected-access
    assert _build._target('kern') == first  # pylint: disable=protected-access
    assert _build._target('other') != first  # pylint: disable=protected-access
