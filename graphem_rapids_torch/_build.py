"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/graphem_rapids_torch/`` beside the
package, at first use. The library file name carries a hash of the source,
of every header ``csrc/*.cuh`` (which the sources include) and of the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. Libraries are loaded with ``ctypes``; the caller declares the
argument types of the entry points it calls.

Nothing here runs when the package is imported: the CPU-only test
environment has no ``nvcc``, and the CPU paths never build anything.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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


def source_path(name):
    return CSRC_DIR / f"{name}.cu"


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives: its name
    hashes the source, the headers of ``csrc/`` and the flags."""
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name, proc, tmp, out):
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build(names=None, force=False):
    """Compile the given kernels (default: every ``csrc/*.cu``) at once.

    One ``nvcc`` process per source, all started together. Sources whose
    library is already built are skipped unless ``force``. Returns
    ``{name: {"seconds", "log"}}`` for the sources that were compiled;
    ``log`` holds the ``-Xptxas -v`` report (registers, spills).
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
    for name, (proc, tmp, out) in started.items():
        log = _finish(name, proc, tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name):
    """ctypes handle of the kernel library ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
