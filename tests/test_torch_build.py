"""The port's kernel builder names each library by what it is built from.

``_build.library_path`` hashes a kernel's source, every header of
``csrc/`` and the nvcc flags, so that an edited source or header gives a new
library (built anew) and an unchanged tree loads the one it built before;
a host C source hashes its compiler in place of the headers. Nothing here
runs a compiler.
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


@pytest.fixture
def host_csrc(csrc):
    """csrc/ with a host C source beside the kernels."""
    (csrc / "h.c").write_text("// host helpers\n")
    return csrc


@pytest.mark.fast
def test_host_source_hashes_its_compiler_not_the_headers(host_csrc,
                                                         monkeypatch):
    assert _build.source_path("h").suffix == ".c"
    assert _build.source_path("a").suffix == ".cu"
    before = _build.library_path("h")
    assert before.name.startswith("libh-")
    (host_csrc / "plan.cuh").write_text("// shared plan, edited\n")
    assert _build.library_path("h") == before
    monkeypatch.setenv("CC", "some-other-cc")
    assert _build.host_compiler() == ["some-other-cc"]
    assert _build.library_path("h") != before
    (host_csrc / "h.c").write_text("// host helpers, edited\n")
    assert _build.library_path("h") != before


@pytest.mark.fast
def test_build_without_names_compiles_only_kernels(host_csrc, tmp_path,
                                                   monkeypatch):
    """build() runs nvcc over csrc/*.cu only; the host library is built by
    name, with the host compiler."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setenv("CC", "cc")
    commands = {}

    def start(name):
        commands[name] = _build._command(name, tmp_path / "out.so")
        return None, None, None

    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build, "_finish", lambda *args: "")
    assert set(_build.build()) == {"a", "b"}
    assert all(cmd[0] == "nvcc" for cmd in commands.values())
    commands.clear()
    assert set(_build.build(["h"])) == {"h"}
    assert commands["h"][0] == "cc"
    assert "-pthread" in commands["h"]


@pytest.mark.fast
def test_repo_host_library_is_fastgraph():
    assert _build.source_path("fastgraph").name == "fastgraph.c"
    assert "fastgraph" not in {p.stem for p in _build.CSRC_DIR.glob("*.cu")}
