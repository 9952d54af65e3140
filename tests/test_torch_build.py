"""The port's kernel builder names each library by what it is built from.

``_build.library_path`` hashes a kernel's source, every header of
``csrc/`` and the nvcc flags, so that an edited source or header gives a new
library (built anew) and an unchanged tree loads the one it built before.
Nothing here runs nvcc.
"""

import pytest

from graphem_rapids_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A csrc/ of two kernels that include one shared header."""
    (tmp_path / "plan.cuh").write_text("// shared plan\n")
    (tmp_path / "a.cu").write_text('#include "plan.cuh"\n// a\n')
    (tmp_path / "b.cu").write_text('#include "plan.cuh"\n// b\n')
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    return tmp_path


@pytest.mark.fast
def test_header_edit_changes_every_library_path(csrc):
    before = {n: _build.library_path(n) for n in ("a", "b")}
    assert before == {n: _build.library_path(n) for n in ("a", "b")}
    (csrc / "plan.cuh").write_text("// shared plan, edited\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert all(after[n] != before[n] for n in ("a", "b"))
    assert after["a"].parent == _build.BUILD_DIR
    assert after["a"].name.startswith("liba-")


@pytest.mark.fast
def test_source_edit_changes_only_its_library_path(csrc):
    before = {n: _build.library_path(n) for n in ("a", "b")}
    (csrc / "a.cu").write_text('#include "plan.cuh"\n// a, edited\n')
    assert _build.library_path("a") != before["a"]
    assert _build.library_path("b") == before["b"]


@pytest.mark.fast
def test_new_header_changes_library_path(csrc):
    before = _build.library_path("a")
    (csrc / "other.cuh").write_text("// another header\n")
    assert _build.library_path("a") != before


@pytest.mark.fast
def test_repo_kernels_hash_the_shared_fold_plan():
    """binfold.cu and ring_binfold.cu include the shared fold plan, which
    the library names hash."""
    headers = sorted(p.name for p in _build.CSRC_DIR.glob("*.cuh"))
    assert "fold_plan.cuh" in headers
    for name in ("binfold", "ring_binfold"):
        assert '#include "fold_plan.cuh"' in _build.source_path(
            name).read_text()
