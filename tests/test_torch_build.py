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


# Shared-memory budgets of the hand-written kernels, reckoned from their tile
# layouts as the sources state them (``Wg<HD>`` in flash_attention_bwd.cu,
# ``GradsSmem<T>`` in rwkv6_scan_bwd.cu, each with its static_assert). The
# H100 gives a block at most 227 KB of dynamic shared memory and an SM
# 228 KB, 1 KB of it reserved for each resident block.
BLOCK_SMEM, SM_SMEM, RESERVED = 232448, 233472, 1024


def _flash_bwd_smem(hd: int, rows: int):
    """(dK/dV, dQ) bytes of a tensor-core backward block owning ``rows``
    rows: its own tiles of two operands and a 2-stage ring of two 64-row
    tiles (lse and D rows beside it in dK/dV), barriers, 1 KB to align."""
    tile = 64 * hd * 2
    own, ring = 2 * (rows // 64) * tile, 2 * 2 * tile
    return own + ring + 2 * 2 * 64 * 4 + 1024 + 128, own + ring + 1024 + 128


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_flash_backward_blocks_fit_shared_memory(hd):
    """Every head size's wgmma backward fits one block; at hd 256 only
    because a block owns 64 rows (128, as at hd <= 128, would need 256 KB),
    and the source states the layout and its assert."""
    rows = 64 if hd > 128 else 128
    assert max(_flash_bwd_smem(hd, rows)) <= BLOCK_SMEM
    if hd == 256:
        assert min(_flash_bwd_smem(hd, 128)) > BLOCK_SMEM
        assert max(_flash_bwd_smem(hd, rows)) < 200 * 1024
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "static constexpr int ROWS = kSplit ? hopper::kRows : 2 * hopper::kRows;" in src
    assert "static_assert(SMEM_DKDV <= kMaxSmem && SMEM_DQ <= kMaxSmem" in src


@pytest.mark.parametrize("itemsize,blocks", [(2, 2), (4, 1)])
def test_rwkv6_backward_gradient_pass_fits(itemsize, blocks):
    """Pass C of the RWKV6 backward: r, k, v in their own type (row stride
    72 bf16 or 68 f32), three 64 × 68 f32 tiles, the 64 × 65 decays, u, X
    and half the u-bonus. Two blocks share an SM where r, k, v are bf16
    (the train path), one where they are f32; the first form's ten f32
    tiles allowed one."""
    ld = 72 if itemsize == 2 else 68
    nbytes = 3 * itemsize * 64 * ld + 4 * (3 * 64 * 68 + 64 * 65 + 3 * 64)
    assert nbytes <= BLOCK_SMEM
    assert blocks * (nbytes + RESERVED) <= SM_SMEM < (blocks + 1) * (nbytes + RESERVED)
    first_form = 4 * (10 * 64 * 68 + 64 * 65 + 2 * 64)
    assert 2 * (first_form + RESERVED) > SM_SMEM
    src = (build.CSRC / "rwkv6_scan_bwd.cu").read_text()
    assert "static_assert(2 * (GradsSmem<__nv_bfloat16>::BYTES + 1024) <= 233472" in src
