"""The port's native host helpers (graphem_rapids_torch/native,
csrc/fastgraph.c) against the JAX package's own C code and their plain
versions.

The JAX package's ``native/fastgraph.c`` is compiled here into a temporary
directory and patched in as ``graphem_rapids_tpu.native._fastgraph`` for the
tests that need it, so nothing is written into the JAX package. Every
helper's output must equal the JAX C code's and its plain version's in
value and dtype, on seeded inputs with ties and on empty ones; the
builders' tables and the edge extraction must be equal array for array
(dtypes included) between the port's C and plain paths, and equal to the
JAX package's with its C helpers patched in. Both packages' 'perm' and
'edge_user' are int32 there: the port chose int32 on both of its paths.
"""

import importlib.util
import subprocess
import sys
import sysconfig
import types
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import graphem_rapids_tpu as gr
import graphem_rapids_tpu.native as jn
from graphem_rapids_tpu.models.embedder import GraphEmbedderTPU
from graphem_rapids_tpu.ops import forces as jf
from graphem_rapids_torch import _build
from graphem_rapids_torch import datasets as tds
from graphem_rapids_torch import native as fg
from graphem_rapids_torch.models.embedder import csr_upper_edges
from graphem_rapids_torch.ops import forces as tf

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_c(tmp_path_factory):
    """The JAX package's fastgraph.c, compiled into a temporary directory
    and loaded as graphem_rapids_tpu.native._fastgraph."""
    out_dir = tmp_path_factory.mktemp("jax_fastgraph")
    src = REPO / "graphem_rapids_tpu" / "native" / "fastgraph.c"
    lib = out_dir / ("_fastgraph" + sysconfig.get_config_var("EXT_SUFFIX"))
    subprocess.run(
        [*_build.host_compiler(), "-O3", "-shared", "-fPIC", "-pthread",
         "-I" + sysconfig.get_paths()["include"], "-o", str(lib), str(src)],
        check=True, capture_output=True, timeout=120)
    spec = importlib.util.spec_from_file_location(
        "graphem_rapids_tpu.native._fastgraph", lib)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_native(monkeypatch, jax_c):
    """The JAX package with its C helpers in place."""
    monkeypatch.setattr(jn, "_fastgraph", jax_c)
    monkeypatch.setattr(jn, "FASTGRAPH_AVAILABLE", True)
    return jn


def _same(a, b, path="out"):
    """Equal in value, shape and dtype, through dicts, lists and tuples."""
    if a is None or b is None:
        assert a is None and b is None, path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _same(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------- #
# parse_edges
# ---------------------------------------------------------------------- #

PARSE_CASES = {
    # tests/test_native.py's cases
    "basic": (b"# comment\n0 1\n1 2\n\n2 3 99\n", {}),
    "mtx": (b"%%MatrixMarket\n% note\n4 4 3\n1 2\n2 3\n3 4\n",
            {"one_based": True, "skip_header": True}),
    "garbage": (b"hello world\n0 1\nnot numbers\n5\n2 3\n", {}),
    "empty": (b"", {}),
    "only_comments": (b"# only comments\n% more\n", {}),
    "crlf_tabs": (b"0\t1\r\n1\t2\r\n", {}),
    "large_ids": (b"4000000000 4000000001\n", {}),
    # the scanner's corners
    "signs_and_glued": (b"+3 -4\n12-5\n7+8\n- 1 2\n+-1 2\n", {}),
    "saturation": (b"99999999999999999999 1\n-99999999999999999999 2\n"
                   b"9223372036854775807 -9223372036854775808\n", {}),
    "second_field_next_line": (b"5\n6 7\n8\n", {}),
    "leading_blanks": (b"   \t 1 2\n\t# c\n  % c\n\v3 4\n\f5 6\n", {}),
    "no_final_newline": (b"1 2\n3 4", {}),
    "trailing_text": (b"1 2#c\n3 4x y\n5 6.5\n7\v8\n", {}),
    "header_after_garbage": (b"junk\n% c\n10 10 3\n1 2\n", {
        "one_based": True, "skip_header": True}),
    "lone_cr": (b"1 2\r3 4\n", {}),
    "vt_newline": (b"\v\n1 2\n\v\n# c 5 6\n", {}),
    "nul_bytes": (b"1\x002\n3 4\x00\n\x005 6\n", {}),
}


@pytest.mark.fast
@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_edges_equals_jax_c_and_plain(jax_native, case):
    data, kw = PARSE_CASES[case]
    got = fg.parse_edges_native(data, **kw)
    _same(got, jax_native.parse_edges_native(data, **kw))
    _same(got, fg.parse_edges_plain(data, **kw))


@pytest.mark.fast
def test_parse_edges_cases_of_jax_tests():
    """tests/test_native.py's expectations, on the port's scanner."""
    assert fg.parse_edges_native(PARSE_CASES["basic"][0]).tolist() == \
        [[0, 1], [1, 2], [2, 3]]
    data, kw = PARSE_CASES["mtx"]
    assert fg.parse_edges_native(data, **kw).tolist() == \
        [[0, 1], [1, 2], [2, 3]]
    assert fg.parse_edges_native(PARSE_CASES["garbage"][0]).tolist() == \
        [[0, 1], [2, 3]]
    assert fg.parse_edges_native(b"").shape == (0, 2)
    assert fg.parse_edges_native(PARSE_CASES["only_comments"][0]).shape == \
        (0, 2)
    assert fg.parse_edges_native(PARSE_CASES["crlf_tabs"][0]).tolist() == \
        [[0, 1], [1, 2]]
    assert fg.parse_edges_native(PARSE_CASES["large_ids"][0]).tolist() == \
        [[4000000000, 4000000001]]


@pytest.mark.fast
@pytest.mark.parametrize("seed", range(4))
def test_parse_edges_fuzz(jax_native, seed):
    """Random bytes over the scanner's alphabet: all three agree."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"0123456789  \t\n\n\r#%+-x.", np.uint8)
    for _ in range(20):
        data = alphabet[rng.integers(0, len(alphabet), 400)].tobytes()
        kw = {"one_based": bool(rng.integers(2)),
              "skip_header": bool(rng.integers(2))}
        got = fg.parse_edges_native(data, **kw)
        _same(got, jax_native.parse_edges_native(data, **kw))
        _same(got, fg.parse_edges_plain(data, **kw))


@pytest.mark.fast
def test_parse_edges_large_random(jax_native):
    rng = np.random.default_rng(0)
    e = rng.integers(0, 10_000, size=(5000, 2))
    data = ("# header\n" + "\n".join(f"{a} {b}" for a, b in e)).encode()
    got = fg.parse_edges_native(data)
    np.testing.assert_array_equal(got, e)
    _same(got, jax_native.parse_edges_native(data))
    _same(got, fg.parse_edges_plain(data))


@pytest.mark.fast
def test_parse_edge_text_routes(tmp_path, monkeypatch):
    """'#' comments go to the C scanner; any other comment to the plain
    parser, which skips its lines as well."""
    f = tmp_path / "edges.txt"
    f.write_bytes(b"! skip me 1 2\n# c\n0 1\n% c\n1 2\n")
    monkeypatch.setattr(fg.parse_edges_native, "calls", 0)
    assert tds._parse_edge_text(f).tolist() == [[0, 1], [1, 2]]
    assert fg.parse_edges_native.calls == 1
    got = tds._parse_edge_text(f, comment="!")
    assert fg.parse_edges_native.calls == 1
    assert got.tolist() == [[0, 1], [1, 2]]
    f.write_bytes(b"// 5 6\n0 1\n")
    assert tds._parse_edge_text(f, comment="//").tolist() == [[0, 1]]
    f.write_bytes(b"7 8\n0 1\n")
    assert tds._parse_edge_text(f, comment="7").tolist() == [[0, 1]]


# ---------------------------------------------------------------------- #
# csr_lt_edges and the edge extraction
# ---------------------------------------------------------------------- #

def _sym_csr(n, ne, seed):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, (ne, 2))
    e = e[e[:, 0] != e[:, 1]]
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(n, n)).tocsr()
    return ((a + a.T) > 0).astype(np.float32).tocsr()


def _with_index_dtype(a, dtype):
    return sp.csr_matrix((a.data, a.indices.astype(dtype),
                          a.indptr.astype(dtype)), shape=a.shape)


CSR_CASES = [(50, 100), (1000, 5000), (7, 0), (3, 2), (200, 40)]


@pytest.mark.fast
@pytest.mark.parametrize("n,ne", CSR_CASES)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_csr_lt_edges_equals_jax_c_and_plain(jax_native, n, ne, dtype):
    a = _with_index_dtype(_sym_csr(n, ne, seed=n), dtype)
    got = fg.csr_lt_edges_native(a.indptr, a.indices, n)
    assert got.dtype == np.int32
    _same(got, jax_native.csr_lt_edges_native(a.indptr, a.indices, n))
    _same(got, fg.csr_lt_edges_plain(a.indptr, a.indices, n))
    for threads in (1, 3, 16):
        _same(got, fg.csr_lt_edges_native(a.indptr, a.indices, n, threads))


@pytest.mark.fast
def test_csr_lt_edges_declines_and_checks(jax_native):
    a = _sym_csr(30, 60, seed=1)
    f = a.indices.astype(np.float64)
    assert fg.csr_lt_edges_native(a.indptr, f, 30) is None
    assert jax_native.csr_lt_edges_native(a.indptr, f, 30) is None
    with pytest.raises(ValueError, match="indptr"):
        fg.csr_lt_edges_native(a.indptr[:10], a.indices, 30)
    with pytest.raises(ValueError, match="indices"):
        fg.csr_lt_edges_native(a.indptr, a.indices[:-1], 30)
    bad = a.indices.copy()
    bad[-1] = 30
    with pytest.raises(ValueError, match="out of range"):
        fg.csr_lt_edges_native(a.indptr, bad, 30)


def _jax_extract(adj):
    """GraphEmbedderTPU's extraction, without building the engine."""
    return GraphEmbedderTPU._extract_edges_from_adjacency(
        types.SimpleNamespace(verbose=False), adj)


@pytest.mark.fast
@pytest.mark.parametrize("kind", ["er", "int64", "explicit_zero", "coo",
                                  "empty"])
def test_extraction_equals_jax(jax_native, monkeypatch, kind):
    adj = gr.erdos_renyi_graph(n=300, p=0.03, seed=0).tocsr()
    adj = adj.astype(np.float32)
    if kind == "int64":
        adj = _with_index_dtype(adj, np.int64)
    elif kind == "explicit_zero":
        rows = np.repeat(np.arange(adj.shape[0]), np.diff(adj.indptr))
        adj.data[np.flatnonzero(rows < adj.indices)[:3]] = 0.0
    elif kind == "coo":
        adj = adj.tocoo()
    elif kind == "empty":
        adj = sp.csr_matrix((40, 40), dtype=np.float32)
    monkeypatch.setattr(fg.csr_lt_edges_native, "calls", 0)
    got = csr_upper_edges(adj)
    assert fg.csr_lt_edges_native.calls == int(kind != "explicit_zero")
    _same(got, csr_upper_edges(adj, native=False))
    _same(got, _jax_extract(adj))
    if kind == "explicit_zero":
        assert len(got) == len(csr_upper_edges(
            gr.erdos_renyi_graph(n=300, p=0.03, seed=0))) - 3


# ---------------------------------------------------------------------- #
# radix_argsort and the element-wise passes
# ---------------------------------------------------------------------- #

def _radix_cases():
    rng = np.random.default_rng(3)
    return {
        "empty": np.zeros(0, np.uint64),
        "one": np.array([5], np.uint64),
        "dups_1_pass": rng.integers(0, 7, 1000).astype(np.uint64),
        "2_passes": rng.integers(0, 2**30, 10_000).astype(np.uint64),
        "3_passes": rng.integers(0, 2**45, 50_000).astype(np.uint64),
        "4_passes": rng.integers(0, 2**60, 20_000).astype(np.uint64),
        "int32_keys": rng.integers(0, 100, 5000).astype(np.int32),
        "int64_keys": np.minimum(rng.integers(0, 40, 3000), 11),
        "few": np.array([3, 1, 3, 0, 1], np.int16),
    }


RADIX = _radix_cases()


@pytest.mark.fast
@pytest.mark.parametrize("case", sorted(RADIX))
def test_radix_argsort_equals_jax_c_and_plain(jax_native, case):
    k = RADIX[case]
    got = fg.radix_argsort_native(k)
    assert got.dtype == np.int32
    _same(got, jax_native.radix_argsort_native(k))
    _same(got, fg.radix_argsort_plain(k))
    for threads in (1, 2, 16):
        _same(got, fg.radix_argsort_native(k, nthreads=threads))


@pytest.mark.fast
def test_radix_argsort_declines_as_jax(jax_native):
    for keys in (np.array([-1, 3], np.int64), np.array([0.5, 1.0]),
                 np.array([True, False])):
        assert fg.radix_argsort_native(keys) is None
        assert jax_native.radix_argsort_native(keys) is None
    # the dispatcher then runs the plain version
    _same(fg.radix_argsort(np.array([-1, 3, -1])),
          np.array([0, 2, 1], np.int32))


@pytest.mark.fast
@pytest.mark.parametrize("E", [0, 3, 4000])
def test_table_passes_equal_jax_c_and_plain(jax_native, E):
    rng = np.random.default_rng(4 + E)
    n = 500
    edges = rng.integers(0, n, (E, 2)).astype(np.int32)
    inv = rng.permutation(n).astype(np.int32)

    lohi = fg.apply_perm_minmax_native(edges, inv)
    _same(lohi, jax_native.apply_perm_minmax_native(edges, inv))
    _same(lohi, fg.apply_perm_minmax_plain(edges, inv))

    lo, hi = lohi
    order = rng.permutation(E).astype(np.int32)
    pp = fg.permute_pairs_native(lo, hi, order)
    _same(pp, jax_native.permute_pairs_native(lo, hi, order))
    _same(pp, fg.permute_pairs_plain(lo, hi, order))

    keys = rng.integers(0, n, E).astype(np.int32)
    perm = np.argsort(keys, kind="stable").astype(np.int32)
    starts = np.concatenate(
        [[0], np.cumsum(np.bincount(keys, minlength=n))[:-1]]).astype(np.int32)
    sr = fg.scatter_ranks_native(perm, keys, starts)
    _same(sr, jax_native.scatter_ranks_native(perm, keys, starts))
    _same(sr, fg.scatter_ranks_plain(perm, keys, starts))
    for threads in (1, 5, 16):
        _same(lohi, fg.apply_perm_minmax_native(edges, inv, threads))
        _same(pp, fg.permute_pairs_native(lo, hi, order, threads))
        _same(sr, fg.scatter_ranks_native(perm, keys, starts, threads))


@pytest.mark.fast
def test_table_passes_decline_as_jax(jax_native):
    e64 = np.array([[0, 1], [1, 2]], np.int64)
    inv = np.arange(3, dtype=np.int32)
    i32 = np.array([0, 1], np.int32)
    i64 = i32.astype(np.int64)
    assert fg.apply_perm_minmax_native(e64, inv) is None
    assert jax_native.apply_perm_minmax_native(e64, inv) is None
    assert fg.permute_pairs_native(i32, i32, i64) is None
    assert jax_native.permute_pairs_native(i32, i32, i64) is None
    assert fg.scatter_ranks_native(i64, i32, i32) is None
    assert jax_native.scatter_ranks_native(i64, i32, i32) is None
    # the dispatchers run the plain versions on what the wrappers decline
    _same(fg.apply_perm_minmax(e64, inv),
          fg.apply_perm_minmax_plain(e64, inv))


@pytest.mark.fast
def test_table_passes_reject_ids_out_of_range():
    i32 = np.array([0, 1], np.int32)
    with pytest.raises(ValueError, match="out of range"):
        fg.apply_perm_minmax_native(np.array([[0, 3]], np.int32),
                                    np.arange(3, dtype=np.int32))
    with pytest.raises(ValueError, match="out of range"):
        fg.permute_pairs_native(i32, i32, np.array([0, 2], np.int32))
    with pytest.raises(ValueError, match="out of range"):
        fg.scatter_ranks_native(i32, np.array([0, 5], np.int32), i32)


# ---------------------------------------------------------------------- #
# the builders
# ---------------------------------------------------------------------- #

def _skewed(n=400, seed=2):
    rng = np.random.default_rng(seed)
    e = [(0, j) for j in range(1, 300)] + [(1, j) for j in range(2, 200)]
    e += [(min(a, b), max(a, b))
          for a, b in rng.integers(0, n, (700, 2)) if a != b]
    return np.unique(np.array(sorted(set(e)), np.int64), axis=0), n


def _ring_chords(n=3000, chords=9000, seed=0):
    rng = np.random.default_rng(seed)
    ring = np.column_stack([np.arange(n), (np.arange(n) + 1) % n])
    ch = rng.integers(0, n, (chords, 2))
    e = np.concatenate([ring, ch[ch[:, 0] != ch[:, 1]]])
    return np.unique(np.sort(e, axis=1), axis=0).astype(np.int64), n


def _extracted(adj):
    return csr_upper_edges(sp.csr_matrix(adj)), adj.shape[0]


GRAPHS = {
    "skewed": _skewed(),
    "ring_chords": _ring_chords(),
    "ba": _extracted(gr.generate_ba(n=600, m=3, seed=0)),
    "regular": _extracted(gr.generate_random_regular(n=200, d=6, seed=0)),
}


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("ref_order", ["row", "slot"])
def test_flat_table_c_equals_plain_and_jax_c(jax_native, name, ref_order):
    edges, n = GRAPHS[name]
    got = tf.build_neighbor_table(edges, n, ref_order=ref_order)
    _same(got, tf.build_neighbor_table(edges, n, ref_order=ref_order,
                                       native=False))
    _same(got, jf.build_neighbor_table(edges, n, ref_order=ref_order,
                                       to_device=False))


@pytest.mark.fast
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("ref_order", ["row", "slot"])
def test_binned_table_c_equals_plain_and_jax_c(jax_native, name, ref_order):
    edges, n = GRAPHS[name]
    got = tf.build_neighbor_table_binned(edges, n, overhead_rows=0,
                                         ref_order=ref_order)
    _same(got, tf.build_neighbor_table_binned(
        edges, n, overhead_rows=0, ref_order=ref_order, native=False))
    _same(got, jf.build_neighbor_table_binned(
        edges, n, overhead_rows=0, ref_order=ref_order, to_device=False))
    if name != "regular":
        assert got["perm"].dtype == np.int32
        assert got["edge_user"].dtype == np.int32


@pytest.mark.fast
def test_builders_count_helper_calls(monkeypatch):
    edges, n = GRAPHS["skewed"]
    for fn in fg.NATIVE:
        monkeypatch.setattr(fn, "calls", 0)
    tf.build_neighbor_table_binned(edges, n, overhead_rows=0, native=False)
    tf.build_neighbor_table(edges, n, native=False)
    assert all(fn.calls == 0 for fn in fg.NATIVE)
    tf.build_neighbor_table_binned(edges, n, overhead_rows=0)
    # clipped, pack keys, e1, overflow; apply_perm_minmax; permute_pairs;
    # the reverse ranks
    assert fg.radix_argsort_native.calls == 4
    assert fg.apply_perm_minmax_native.calls == 1
    assert fg.permute_pairs_native.calls == 1
    assert fg.scatter_ranks_native.calls == 1
    tf.build_neighbor_table(edges, n)
    assert fg.radix_argsort_native.calls == 7
    assert fg.scatter_ranks_native.calls == 3


# ---------------------------------------------------------------------- #
# building the library
# ---------------------------------------------------------------------- #

@pytest.mark.fast
@pytest.mark.parametrize("compiler", ["graphem-no-such-cc", "false"])
def test_compiler_failure_raises_and_names_it(tmp_path, monkeypatch,
                                              compiler):
    """A compiler that is missing or fails raises RuntimeError naming it;
    no set-up call returns the numpy result in its place."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setenv("CC", compiler)
    with pytest.raises(RuntimeError, match=compiler):
        fg.library()
    edges, n = GRAPHS["skewed"]
    with pytest.raises(RuntimeError, match=compiler):
        tf.build_neighbor_table(edges, n)
    with pytest.raises(RuntimeError, match=compiler):
        csr_upper_edges(sp.csr_matrix(np.ones((3, 3))))
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.fast
def test_concurrent_builds_share_one_library(tmp_path, monkeypatch):
    """Processes that build the library at once leave one good file."""
    build_dir = tmp_path / "build"
    code = (
        "import sys\n"
        "from graphem_rapids_torch import _build, native\n"
        "from pathlib import Path\n"
        "_build.BUILD_DIR = Path(sys.argv[1])\n"
        "print(native.parse_edges_native(b'1 2').tolist())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert all(o.strip() == "[[1, 2]]" for o in outs)
    assert len(list(build_dir.glob("libfastgraph-*.so"))) == 1
    assert not list(build_dir.glob("*.tmp"))
