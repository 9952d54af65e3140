"""Build and load the native libraries of ``csrc/``.

Each ``csrc/<name>.cu`` is a hand-written CUDA kernel with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``); each
``csrc/<name>.c`` is host C (the threaded set-up helpers of
``native/``), compiled by the host compiler (``$CC``, else ``cc``, else
the one Python was built with). Both go into ``build/graphem_rapids_torch/``
beside the package, at first use. The library file name carries a hash of
the source, of every header ``csrc/*.cuh`` that a CUDA source may include,
of the flags and, for host C, of the compiler, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. A library is
written under a temporary name and moved into place, so processes that
build the same one at once do no harm. Libraries are loaded with
``ctypes``; the caller declares the argument types of the entry points it
calls.

Nothing here runs when the package is imported. The CPU paths never run
``nvcc``; they build only the host library, at its first use.
"""

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import sysconfig
import time
from pathlib import Path

from .utils import tracing

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "graphem_rapids_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    # no fused multiply-add: the kernels must round exactly as their
    # plain PyTorch versions do (bit-equal distances, equal indices)
    "--fmad=false",
    "-Xptxas", "-v",
)

HOST_CFLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_loaded = {}


def nvcc_path():
    """The ``nvcc`` on PATH, else the one under CUDA_HOME (/usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "of graphem_rapids_torch are built from source at first use"
        )
    return path


def host_compiler():
    """The host C compiler's command: ``$CC``, else ``cc`` where it is on
    PATH, else the compiler Python was built with."""
    cc = os.environ.get("CC")
    if not cc:
        cc = ("cc" if shutil.which("cc")
              else sysconfig.get_config_var("CC") or "cc")
    return shlex.split(cc)


def source_path(name):
    """``csrc/<name>.cu`` (CUDA), else ``csrc/<name>.c`` (host C)."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.c"


def _command(name, out):
    """The compile command of ``name``'s source into ``out``."""
    src = source_path(name)
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [*host_compiler(), *HOST_CFLAGS, "-o", str(out), str(src)]


def library_path(name):
    """Where the library built from ``name``'s source lives: its name
    hashes the source, the headers of ``csrc/`` (CUDA) or the compiler
    (host C), and the flags."""
    src = source_path(name)
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.name.encode())
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        h.update(" ".join(host_compiler() + list(HOST_CFLAGS)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = _command(name, tmp)
    try:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
    except OSError as exc:
        raise RuntimeError(
            f"cannot run the compiler {cmd[0]!r} for "
            f"csrc/{source_path(name).name}: {exc}"
        ) from exc
    return proc, tmp, out


def _finish(name, proc, tmp, out):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"{proc.args[0]} failed for csrc/{source_path(name).name} "
            f"(exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build(names=None, force=False):
    """Compile the given libraries (default: every CUDA kernel,
    ``csrc/*.cu``) at once.

    One compiler process per source, all started together. Sources whose
    library is already built are skipped unless ``force``. Returns
    ``{name: {"seconds", "log"}}`` for the sources that were compiled;
    for a kernel ``log`` holds the ``-Xptxas -v`` report (registers,
    spills). The wait for the compilers is the span ``kernel.compile``;
    each library built adds one to the counter ``kernels.compiled``.
    """
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    started = {
        name: _start(name) for name in names
        if force or not library_path(name).exists()
    }
    report = {}
    if not started:
        return report
    with tracing.span("kernel.compile"):
        for name, (proc, tmp, out) in started.items():
            log = _finish(name, proc, tmp, out)
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
            tracing.count("kernels.compiled")
    return report


def load(name):
    """ctypes handle of the library ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
