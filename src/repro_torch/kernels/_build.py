"""Build and load the port's CUDA kernels (``csrc/*.cu``) for Hopper.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library lives
under ``build/kernels/<hash of the sources and flags>/`` at the repository
root (listed in ``.gitignore``), so an edited source rebuilds and an
unchanged one is reused.  ``ptxas -v`` output (registers, shared memory and
spills per kernel) is kept beside it as ``ptxas.log``, each source's part
headed by its name and the seconds its ``nvcc`` took.

A missing ``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# every pointer and the stream as c_void_p, or ctypes passes them as 32-bit
# ints and cuts the pointer
_SIGNATURES = {
    "gram_launch": [_VP, _VP, _VP, _LL, _VP, _VP, _I, _LL, _I, _I, _I, _LL,
                    _VP],
    "gram_launch_config": [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "gram_mma_launch": [_VP, _VP, _VP, _LL, _VP, _VP, _I, _LL, _I, _LL, _VP],
    "gram_mma_launch_config": [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "combine_launch": [_VP, _VP, _VP, _VP, _I, _LL, _I, _I, _I, _VP],
    "combine_vec_launch_config": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "combine_vec_launch": [_VP, _VP, _VP, _VP, _I, _LL, _I, _I, _I, _I, _VP],
    "topk_launch": [_VP, _LL, _I, _VP, _LL, _VP, _VP, _I, _LL, _VP],
    "topk_small_launch": [_VP, _I, _I, _VP, _VP, _VP],
    "sign_sketch_launch": [_VP, _I, _LL, _I, ctypes.c_uint, _I, _VP, _LL, _VP,
                           _I, _LL, _VP],
    "sign_sketch_adjoint_launch": [_VP, _I, ctypes.c_uint, _LL, _VP, _VP],
    "sign_sketch_col_launch": [_VP, _I, _LL, _I, ctypes.c_uint, _I, _I, _I,
                               _LL, _VP, _VP],
    "sign_sketch_adjoint_col_launch": [_VP, _I, ctypes.c_uint, _LL, _I, _I,
                                       _VP, _VP],
    "stream_stats_launch_config": [_I, _I, ctypes.POINTER(_I),
                                   ctypes.POINTER(_LL)],
    "stream_stats_launch": [_VP, _LL, _I, _VP, _LL, _I, _I, _LL, _VP, _LL,
                            _I, _LL, _VP, _VP, _I, _VP],
    "stream_stats_mma_launch": [_VP, _LL, _VP, _LL, _I, _LL, _VP, _LL, _I,
                                _LL, _VP, _VP, _I, _VP],
    "gram_block_launch_config": [_I, _I, ctypes.POINTER(_I),
                                 ctypes.POINTER(_LL)],
    "gram_block_launch": [_VP, _LL, _I, _I, _VP, _LL, _I, _I, _VP, _I, _LL,
                          _VP, _LL, _I, _LL, _VP, _VP, _VP],
    "gram_block_mma_launch_config": [_I, _I, ctypes.POINTER(_I),
                                     ctypes.POINTER(_I)],
    "gram_block_mma_launch": [_VP, _LL, _I, _VP, _LL, _I, _VP, _LL, _VP, _LL,
                              _I, _LL, _VP, _VP, _VP],
    "sketch_apply_launch_config": [_I, _I, ctypes.POINTER(_I),
                                   ctypes.POINTER(_LL)],
    "sketch_apply_launch": [_VP, _LL, _I, _I, _VP, _LL, _I, _I, _LL, _VP, _LL,
                            _I, _LL, _VP, _VP],
    "sketch_mma_launch_config": [_I, _I, ctypes.POINTER(_I),
                                 ctypes.POINTER(_LL)],
    "sketch_mma_launch": [_VP, _LL, _I, _VP, _LL, _I, _LL, _VP, _LL, _I, _LL,
                          _VP, _VP],
    "flash_decode_launch_config": [_I, _I, _I, ctypes.POINTER(_I)],
    "flash_decode_launch": [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _VP, _VP,
                            _I, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL,
                            _I, _I, ctypes.c_float, _I, _I, _I,
                            ctypes.c_float, _VP],
    "flash_decode_mma_launch_config": [_I, ctypes.POINTER(_I)],
    "flash_decode_mma_launch": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I,
                                _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL,
                                _I, _I, ctypes.c_float, _I, _I, _I,
                                ctypes.c_float, _VP],
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``.  Raises when there is none."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels of repro_torch "
                       "need the CUDA toolkit to build")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build(force: bool = False) -> Path:
    """Compile the sources into the shared library (unless it exists) and
    return its path."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file() and not force:
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp, \
            contextlib.ExitStack() as outs:
        objs, procs = [], []
        t0 = time.perf_counter()
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            out = outs.enter_context(open(Path(tmp) / (src.stem + ".log"),
                                          "w+"))
            procs.append((src, out, subprocess.Popen(
                [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=out, stderr=subprocess.STDOUT)))
        seconds = {}                      # each source's time to its object
        while len(seconds) < len(procs):
            for src, _, proc in procs:
                if src.name not in seconds and proc.poll() is not None:
                    seconds[src.name] = time.perf_counter() - t0
            time.sleep(0.05)
        logs, failed = [], []
        for src, out, proc in procs:
            out.seek(0)
            logs.append(f"== {src.name} ({seconds[src.name]:.2f} s)\n"
                        f"{out.read()}")
            if proc.returncode != 0:
                failed.append(src.name)
        (out_dir / "ptxas.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)   # atomic: a racing build sees all or nothing
    return lib_path


def ptxas_log() -> str:
    """The ``-Xptxas -v`` report of the last build of these sources."""
    path = build_dir() / "ptxas.log"
    return path.read_text() if path.is_file() else ""


def load_library() -> ctypes.CDLL:
    """The built library with its C signatures set (builds at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (the grids scale with it)."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
