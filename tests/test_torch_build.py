"""The nvcc build of the port's kernels (styletts2_tpu_torch/ops/_build.py):
the library path is a hash of everything the build reads, so an edited
source or header never loads a stale library. Runs without nvcc."""

import shutil

import pytest

from styletts2_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


def test_every_source_includes_only_headers_in_csrc():
    for src in _build.SOURCES.values():
        text = (_build.CSRC / src).read_text()
        for line in text.splitlines():
            if line.startswith('#include "'):
                name = line.split('"')[1]
                assert (_build.CSRC / name).is_file(), (src, name)


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_library_path_changes_with_a_header(csrc_copy, name):
    before = _build.library_path(name)
    assert before == _build.library_path(name)  # stable
    hdr = csrc_copy / "ptx.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_library_path_changes_with_the_source_and_flags(csrc_copy, name,
                                                         monkeypatch):
    before = _build.library_path(name)
    src = csrc_copy / _build.SOURCES[name]
    src.write_text(src.read_text() + "\n// edited\n")
    edited = _build.library_path(name)
    assert edited != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path(name) != edited


def test_a_new_header_changes_the_library_path(csrc_copy):
    before = _build.library_path("vocoder")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("vocoder") != before
