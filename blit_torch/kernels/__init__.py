"""Build and load the hand-written CUDA kernels of ``blit_torch/csrc``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``.  Libraries land in ``blit_torch/kernels/build/`` under a name
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source builds anew and an unchanged one is
reused.  Nothing is built at import time:
:func:`load` builds on first use, :func:`build_all` builds every source
in parallel (one ``nvcc`` process each).  A failed build raises.
Builds hold an exclusive lock on ``build/.lock``, so processes that
share the directory (the agents of a remote worker pool on one host)
build each library once, one at a time, and the others load it.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
KERNEL_SOURCES = ("pfb_dft1", "tail2_detect", "pfb_dequant", "dft", "dft_tail2",
                  "taylor_tree", "beamform_detect", "xengine", "detect_untwist")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches`` under a lock: the reducers of a
    thread pool launch the same kernels at once, and an unlocked ``+=``
    can lose a count."""
    with _COUNT_LOCK:
        wrapper.launches += n


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of blit_torch are "
                       "built on the machine that has the GPU")


def _lib_path(name: str) -> str:
    # The headers of csrc/ count too: a source may include any of them.
    parts = [name + ".cu"] + sorted(f for f in os.listdir(CSRC)
                                    if f.endswith(".cuh"))
    src = b""
    for f in parts:
        with open(os.path.join(CSRC, f), "rb") as fh:
            src += fh.read()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{h}.so")


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, final) or
    None when the library is already built."""
    final = _lib_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


@contextlib.contextmanager
def _build_lock():
    """An exclusive lock across processes on the build directory."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Build every named source at once (one ``nvcc`` each, started
    together).  Returns ``{name: compiler output}`` (register and shared
    memory use from ``-Xptxas -v``); raises on the first failed build."""
    with _build_lock():
        started = {n: _start_build(n) for n in names}
        logs: Dict[str, str] = {}
        errors: List[str] = []
        for name, job in started.items():
            if job is None:
                logs[name] = "(cached)"
                continue
            proc, tmp, final = job
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{out}")
                if os.path.exists(tmp):
                    os.unlink(tmp)
            else:
                os.replace(tmp, final)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_lib_path(name))
            lib.blit_cuda_error_string.argtypes = [ctypes.c_int]
            lib.blit_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


# The current stream's raw handle without building a torch.cuda.Stream (a
# tenth of the cost of a launch), where this torch has the call.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch_stream(dev: torch.device):
    """(a context that makes ``dev`` current, the raw handle of its current
    stream) for a launch: the context is a no-op when ``dev`` already is
    current."""
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    ctx = contextlib.nullcontext() if idx == cur else torch.cuda.device(idx)
    if _raw_stream is not None:
        return ctx, _raw_stream(idx)
    return ctx, torch.cuda.current_stream(idx).cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.blit_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")
