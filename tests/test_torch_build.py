"""``repro_torch.kernels.build``: a kernel library's path carries a digest
of everything its build reads — its source, the shared headers
(``csrc/*.cuh``) and nvcc's flags — so an edited file never loads a stale
library. Needs no nvcc and no card: only paths are computed."""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that ``build`` reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_an_edited_header_changes_the_library_path(csrc, name):
    """Every library's digest covers ``hopper.cuh``, the header that the
    tensor-core sources share: an edit to it gives a new path."""
    before = build.library_path(name)
    assert build.library_path(name) == before          # stable while nothing changes
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    assert build.library_path(name) != before


def test_a_new_header_changes_the_path_and_other_files_do_not(csrc):
    before = build.library_path("flash_attention_bwd")
    (csrc / "notes.txt").write_text("not read by nvcc")
    assert build.library_path("flash_attention_bwd") == before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("flash_attention_bwd") != before


def test_the_source_and_the_flags_change_the_path(csrc, monkeypatch):
    paths = {n: build.library_path(n) for n in build.SOURCES}
    src = csrc / build.SOURCES["flash_attention_bwd"]
    src.write_text(src.read_text() + "\n// an edit\n")
    assert build.library_path("flash_attention_bwd") != paths["flash_attention_bwd"]
    assert build.library_path("agg_reduce") == paths["agg_reduce"]   # its source is untouched
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("agg_reduce") != paths["agg_reduce"]
