"""Threaded host helpers of the set-up path, and their plain versions.

Counterpart of ``graphem_rapids_tpu/native/``, under its names. The C
source is ``csrc/fastgraph.c`` (a plain C interface, loaded with ctypes);
``_build`` compiles it with the host compiler at its first use, on the CPU
as on a card's host. If it cannot be built or loaded, the call raises and
names the compiler: no call quietly runs the numpy line instead.

Each ``*_native`` wrapper returns None exactly where the JAX package's
does on domain grounds (a dtype it does not take, negative keys, 2^31 keys
or more), and the caller then runs the plain version. Beside each wrapper
stands that plain version (``*_plain``): the numpy line the builders ran
before, which the tests and ``native=False`` use as the reference. The
dispatchers without a suffix take the wrapper, or the plain version where
the wrapper declines or ``native`` is False.

Each wrapper adds one to its ``calls`` where it calls into the library, so
that a run can show which helpers its set-up went through.
"""

import ctypes
import os
import re

import numpy as np

from .. import _build

_c_i64 = ctypes.c_int64
_c_ptr = ctypes.c_void_p
_SIGNATURES = {
    "fg_parse_edges": (_c_i64, [ctypes.c_char_p, _c_i64, ctypes.c_int,
                                ctypes.c_int,
                                ctypes.POINTER(ctypes.c_void_p)]),
    "fg_free": (None, [_c_ptr]),
    "fg_csr_lt_count": (ctypes.c_int, [_c_ptr, _c_ptr, ctypes.c_int,
                                       ctypes.c_int, _c_i64, _c_i64, _c_i64,
                                       _c_ptr]),
    "fg_csr_lt_fill": (None, [_c_ptr, _c_ptr, ctypes.c_int, ctypes.c_int,
                              _c_i64, _c_i64, _c_i64, _c_ptr, _c_ptr]),
    "fg_radix_argsort_u64": (ctypes.c_int, [_c_ptr, _c_i64, _c_i64, _c_ptr]),
    "fg_apply_perm_minmax": (_c_i64, [_c_ptr, _c_i64, _c_ptr, _c_i64, _c_i64,
                                      _c_ptr, _c_ptr]),
    "fg_permute_pairs": (_c_i64, [_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64,
                                  _c_ptr, _c_ptr]),
    "fg_scatter_ranks": (_c_i64, [_c_ptr, _c_ptr, _c_i64, _c_ptr, _c_i64,
                                  _c_i64, _c_ptr]),
}
MAX_THREADS = 16


def library():
    """The loaded ``csrc/fastgraph.c`` library, built at first use."""
    lib = _build.load("fastgraph")
    if not getattr(lib, "_fg_declared", False):
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        lib._fg_declared = True
    return lib


def _nthreads(nthreads):
    return (min(os.cpu_count() or 1, MAX_THREADS)
            if nthreads is None else int(nthreads))


def _ptr(a):
    return a.ctypes.data


def _raise_bad(bad, what):
    if bad:
        raise ValueError(f"{bad} {what} out of range")


def _contiguous(*arrays):
    return [np.ascontiguousarray(a) for a in arrays]


# ---------------------------------------------------------------------- #
# edge-list parsing
# ---------------------------------------------------------------------- #

# a data line as the C scanner reads it: two integers on one line, the
# first after leading blanks; possessive, since the scanner never
# backtracks into a number
_EDGE_LINE = re.compile(rb"([+-]?[0-9]++)[ \t\r]*+([+-]?[0-9]++)")
_I64_MIN, _I64_MAX = -2**63, 2**63 - 1


def parse_edges_native(data, one_based=False, skip_header=False):
    """Parse raw edge-list bytes into an (E, 2) int64 array in one pass of
    the C scanner.

    Comment lines ('#' or '%' after leading blanks) and unparsable lines
    are skipped, the second field must be on the same line (CRLF and tabs
    are blanks), trailing columns are ignored; ``skip_header`` drops the
    first data row (a Matrix Market size line) and ``one_based`` subtracts
    one from every id.
    """
    lib = library()
    data = bytes(data)
    out = ctypes.c_void_p()
    parse_edges_native.calls += 1
    count = lib.fg_parse_edges(data, len(data), int(bool(one_based)),
                               int(bool(skip_header)), ctypes.byref(out))
    if count < 0:
        raise MemoryError("parse_edges: out of memory")
    try:
        edges = np.empty((count, 2), np.int64)
        ctypes.memmove(_ptr(edges), out.value, edges.nbytes)
    finally:
        lib.fg_free(out)
    return edges


def parse_edges_plain(data, one_based=False, skip_header=False,
                      comment="#"):
    """The parser in Python, with the C scanner's semantics; lines that
    start with ``comment`` are skipped as well."""
    skip = (b"#", b"%", comment.encode())
    rows = []
    for line in bytes(data).split(b"\n"):
        s = line.lstrip(b" \t\r\v\f")
        if not s or s.startswith(skip):
            continue
        m = _EDGE_LINE.match(s)
        if m:
            rows.append([min(max(int(m[1]), _I64_MIN), _I64_MAX),
                         min(max(int(m[2]), _I64_MIN), _I64_MAX)])
    if skip_header:
        rows = rows[1:]
    edges = np.array(rows, np.int64).reshape(-1, 2)
    return edges - 1 if one_based else edges


# ---------------------------------------------------------------------- #
# the sorts and passes of the table builders
# ---------------------------------------------------------------------- #

def radix_argsort_native(keys, nthreads=None):
    """Stable ascending argsort of non-negative integer keys as an int32
    permutation, by the threaded LSD radix sort.

    None (the caller runs radix_argsort_plain) where keys are not an
    integer dtype, any is negative, or there are 2^31 or more.
    """
    keys = np.asarray(keys)
    if keys.dtype.kind not in "ui" or len(keys) >= 2**31:
        return None
    if keys.dtype.kind == "i" and len(keys) and int(keys.min()) < 0:
        return None
    lib = library()
    k = np.ascontiguousarray(keys.reshape(-1).astype(np.uint64, copy=False))
    out = np.empty(len(k), np.int32)
    radix_argsort_native.calls += 1
    if lib.fg_radix_argsort_u64(_ptr(k), len(k), _nthreads(nthreads),
                                _ptr(out)) != 0:
        raise MemoryError("radix_argsort: out of memory")
    return out


def radix_argsort_plain(keys):
    """np.argsort(kind='stable'), int32 below 2^31 keys."""
    order = np.argsort(keys, kind="stable")
    return order.astype(np.int32) if len(order) < 2**31 else order


def apply_perm_minmax_native(edges, inv, nthreads=None):
    """(e_lo, e_hi) int32: the min and max of each edge's ``inv``-relabelled
    ends; None where ``edges`` or ``inv`` is not int32."""
    if edges.dtype != np.int32 or inv.dtype != np.int32:
        return None
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be (E, 2), got {edges.shape}")
    lib = library()
    edges, inv = _contiguous(edges, inv)
    E = len(edges)
    e_lo = np.empty(E, np.int32)
    e_hi = np.empty(E, np.int32)
    apply_perm_minmax_native.calls += 1
    _raise_bad(lib.fg_apply_perm_minmax(_ptr(edges), E, _ptr(inv), len(inv),
                                        _nthreads(nthreads), _ptr(e_lo),
                                        _ptr(e_hi)),
               "vertex ids")
    return e_lo, e_hi


def apply_perm_minmax_plain(edges, inv):
    a = inv[edges]
    return np.minimum(a[:, 0], a[:, 1]), np.maximum(a[:, 0], a[:, 1])


def permute_pairs_native(e_lo, e_hi, order, nthreads=None):
    """(pairs (E, 2) int32, the inverse of ``order`` (E,) int32), pairs[i]
    = (e_lo[order[i]], e_hi[order[i]]); None unless all three are int32.
    ``order`` must be a permutation of range(E)."""
    if any(a.dtype != np.int32 for a in (e_lo, e_hi, order)):
        return None
    E = len(order)
    if len(e_lo) != E or len(e_hi) != E:
        raise ValueError("e_lo, e_hi and order must have one length")
    lib = library()
    e_lo, e_hi, order = _contiguous(e_lo, e_hi, order)
    pairs = np.empty((E, 2), np.int32)
    invp = np.empty(E, np.int32)
    permute_pairs_native.calls += 1
    _raise_bad(lib.fg_permute_pairs(_ptr(e_lo), _ptr(e_hi), _ptr(order), E,
                                    _nthreads(nthreads), _ptr(pairs),
                                    _ptr(invp)),
               "order entries")
    return pairs, invp


def permute_pairs_plain(e_lo, e_hi, order):
    pairs = np.column_stack([e_lo[order], e_hi[order]])
    invp = np.empty(len(order), np.int32)
    invp[order] = np.arange(len(order), dtype=np.int32)
    return pairs, invp


def scatter_ranks_native(perm, keys, starts, nthreads=None):
    """out[perm[i]] = i - starts[keys[perm[i]]] as int32: each element's
    rank within its key's run; None unless all three are int32."""
    if any(a.dtype != np.int32 for a in (perm, keys, starts)):
        return None
    E = len(perm)
    if len(keys) != E:
        raise ValueError("perm and keys must have one length")
    lib = library()
    perm, keys, starts = _contiguous(perm, keys, starts)
    out = np.empty(E, np.int32)
    scatter_ranks_native.calls += 1
    _raise_bad(lib.fg_scatter_ranks(_ptr(perm), _ptr(keys), E, _ptr(starts),
                                    len(starts), _nthreads(nthreads),
                                    _ptr(out)),
               "perm entries or keys")
    return out


def scatter_ranks_plain(perm, keys, starts):
    out = np.empty(len(perm), np.int32)
    out[perm] = np.arange(len(perm), dtype=np.int32) - starts[keys[perm]]
    return out


# ---------------------------------------------------------------------- #
# CSR edge extraction
# ---------------------------------------------------------------------- #

_INDEX_DTYPES = {np.dtype(np.int32): 0, np.dtype(np.int64): 1}


def csr_lt_edges_native(indptr, indices, n, nthreads=None):
    """(E, 2) int32 upper-triangle (i < j) edges of a CSR structure in
    row-major order, by a threaded count pass and fill pass.

    None where an index dtype is not int32 or int64. The caller must have
    excluded explicit zeros, and ``n`` must be below 2^31.
    """
    if indptr.dtype not in _INDEX_DTYPES or indices.dtype not in _INDEX_DTYPES:
        return None
    n = int(n)
    if len(indptr) < n + 1:
        raise ValueError("indptr buffer too small for n")
    if n and int(indptr[n]) > len(indices):
        raise ValueError("indices buffer too small")
    lib = library()
    indptr, indices = _contiguous(indptr, indices)
    if n == 0:
        return np.zeros((0, 2), np.int32)
    args = (_ptr(indptr), _ptr(indices), _INDEX_DTYPES[indptr.dtype],
            _INDEX_DTYPES[indices.dtype], n, len(indices),
            _nthreads(nthreads))
    counts = np.zeros(MAX_THREADS, np.int64)
    csr_lt_edges_native.calls += 1
    T = lib.fg_csr_lt_count(*args, _ptr(counts))
    if T < 0:
        raise ValueError("CSR structure: indptr or column ids out of range")
    out = np.empty((int(counts[:T].sum()), 2), np.int32)
    lib.fg_csr_lt_fill(*args, _ptr(counts), _ptr(out))
    return out


def csr_lt_edges_plain(indptr, indices, n, keep=None):
    """The numpy line; ``keep`` (nnz,) bool also drops entries (the
    caller's explicit zeros)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr[:n + 1]))
    cols = indices[:len(rows)]
    mask = rows < cols
    if keep is not None:
        mask &= keep[:len(rows)]
    return np.column_stack([rows[mask], cols[mask]]).astype(np.int32)


NATIVE = (parse_edges_native, radix_argsort_native, apply_perm_minmax_native,
          permute_pairs_native, scatter_ranks_native, csr_lt_edges_native)
for _fn in NATIVE:
    _fn.calls = 0


# ---------------------------------------------------------------------- #
# dispatch: the wrapper, or the plain version where it declines
# ---------------------------------------------------------------------- #

def radix_argsort(keys, native=True):
    out = radix_argsort_native(keys) if native else None
    return radix_argsort_plain(keys) if out is None else out


def apply_perm_minmax(edges, inv, native=True):
    out = apply_perm_minmax_native(edges, inv) if native else None
    return apply_perm_minmax_plain(edges, inv) if out is None else out


def permute_pairs(e_lo, e_hi, order, native=True):
    out = permute_pairs_native(e_lo, e_hi, order) if native else None
    return permute_pairs_plain(e_lo, e_hi, order) if out is None else out


def scatter_ranks(perm, keys, starts, native=True):
    out = scatter_ranks_native(perm, keys, starts) if native else None
    return scatter_ranks_plain(perm, keys, starts) if out is None else out
