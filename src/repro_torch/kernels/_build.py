"""Build and load the port's CUDA kernels: ``nvcc`` straight into one
shared library, bound with ``ctypes``.

Each ``csrc/*.cu`` exports plain C launch functions, so no PyTorch header
is compiled (seconds per source, against minutes through
``torch.utils.cpp_extension``).  The library is built at first use from
the checkout's own sources into ``src/repro_torch/_build/`` (listed in
``.gitignore``): one ``nvcc -c`` per source, all started together, then
one link.  Its name carries a digest of the sources, the shared headers
and the flags, so an edited file is never served from a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("fused_gate.cu", "rate_gate.cu", "int8_gemm.cu",
           "decode_attention.cu", "telemetry.cu", "threefry_draw.cu")
HEADERS = ("gate_common.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: List[ctypes.CDLL] = []
_fns: Dict[str, object] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this host")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"libfenix_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: Sequence[Sequence[str]]) -> str:
    """Run commands concurrently; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0].strip() for p in procs]
    log = "\n".join(o for o in outs if o)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    return log


def build(ptxas_verbose: bool = False) -> Tuple[Path, str]:
    """Compile the library unless it is built: returns (path, compiler
    output); raises with the compiler's output when a step fails."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    verbose = ("-Xptxas", "-v") if ptxas_verbose else ()
    log = _run_all([[nvcc, *CFLAGS, *verbose, "-c", "-o", str(o),
                     str(CSRC / s)] for s, o in zip(SOURCES, objs)])
    tmp = path.with_suffix(f".{tag}")
    log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    os.replace(tmp, path)
    for o in objs:
        o.unlink()
    return path, log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    with _lock:
        if not _lib:
            path, _ = build()
            _lib.append(ctypes.CDLL(str(path)))
        return _lib[0]


def function(symbol: str, argtypes: Sequence):
    """The C launch function ``symbol``, with its ctypes signature set
    (int return: the launch's cudaError), looked up once per process."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def build_all(ptxas_verbose: bool = False) -> Tuple[float, str]:
    """Build and load the library; returns (seconds, compiler output)."""
    t0 = time.perf_counter()
    _, log = build(ptxas_verbose=ptxas_verbose)
    load()
    return time.perf_counter() - t0, log


def check(status: int, name: str) -> None:
    """Raise when a C launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with "
                           f"cudaError {status}")
