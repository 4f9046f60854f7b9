"""Build and load the port's CUDA kernels: ``nvcc`` by hand into one shared
library per ``csrc/*.cu`` source, loaded with ``ctypes``.

Each library is compiled for Hopper (``-gencode arch=compute_90a,
code=sm_90a``) into ``build/repro_torch/`` at the root of the checkout,
under a name that carries a hash of its source and flags, so an edited
source builds anew and an unchanged one is reused.  Nothing is built when a
module is imported: :func:`load` builds on first use, and
:func:`build_all` starts one ``nvcc`` per source at once and waits for all
of them.  ``nvcc -Xptxas -v`` reports each kernel's registers, shared
memory and spills; :func:`ptxas_report` returns those lines.

Each library exports plain C entry points that return ``cudaGetLastError()``
after their launches, and ``repro_cuda_error_string`` to name a code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "entry", "library_path", "ptxas_report", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-lineinfo",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: the name
    carries a hash of the source and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=f, stderr=subprocess.STDOUT,
        )
    return proc, tmp, out


def _finish(name: str, started: tuple[subprocess.Popen, Path, Path] | None) -> None:
    if started is None:
        return
    proc, tmp, out = started
    rc = proc.wait()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        log = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (rc={rc}):\n{log}")
    os.replace(tmp, out)


def build_all() -> list[str]:
    """Build every missing library, one ``nvcc`` per source, all at once.
    Returns the names that were built (empty when all were up to date)."""
    started = {name: _start(name) for name in SOURCES}
    try:
        for name, st in started.items():
            _finish(name, st)
    finally:
        for st in started.values():  # never leave a compiler running
            if st is not None and st[0].poll() is None:
                st[0].kill()
                st[0].wait()
    return [name for name, st in started.items() if st is not None]


def ptxas_report(name: str) -> list[str]:
    """The ``-Xptxas -v`` lines of the last build of ``csrc/<name>.cu``:
    registers, shared memory and spills per kernel."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    keys = ("Compiling entry", "registers", "spill", "smem")
    return [ln.strip() for ln in log.read_text().splitlines() if any(k in ln for k in keys)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def entry(name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``fn_name`` of ``csrc/<name>.cu`` with its
    ``argtypes`` set (``c_void_p`` for every pointer and the stream, so
    ctypes never cuts a pointer to 32 bits) and an ``int`` result."""
    fn = getattr(load(name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise if a C entry point of ``csrc/<name>.cu`` returned a CUDA error."""
    if rc != 0:
        msg = load(name).repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
