"""Names of the port's kernel libraries (ops/_build.py): a hash of the
source, of every header under csrc/ and of the nvcc flags, so that an edited
source or header is rebuilt and a stale library is never loaded.  Only the
names are computed here; nothing is compiled (there is no nvcc on the CPU)."""
import shutil

import pytest

from ecg_representation_learning_tpu_torch.ops import _build

LIBS = ('flash_fwd', 'flash_bwd', 'adamw', 'nlm')


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that library_path reads instead of the package's."""
    copy = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, 'CSRC', copy)
    return copy


def _paths():
    return {name: _build.library_path(name) for name in LIBS}


def test_same_sources_same_names(csrc, monkeypatch):
    copied = _paths()
    monkeypatch.undo()
    assert copied == _paths()
    assert all(p.parent == _build.BUILD_DIR for p in copied.values())


@pytest.mark.parametrize('edit,changed', [
    ('hopper.cuh', set(LIBS)),          # a header rebuilds every library
    ('flash_bwd.cu', {'flash_bwd'}),    # a source only its own
])
def test_an_edit_renames_what_it_may_change(csrc, edit, changed):
    before = _paths()
    (csrc / edit).write_text((csrc / edit).read_text() + '\n// edited\n')
    after = _paths()
    assert {name for name in LIBS if before[name] != after[name]} == changed


def test_a_new_header_renames_every_library(csrc):
    before = _paths()
    (csrc / 'extra.cuh').write_text('#pragma once\n')
    after = _paths()
    assert all(before[name] != after[name] for name in LIBS)
