"""Build of the port's CUDA kernels: nvcc into a shared library, loaded with ctypes.

The pattern of tpu_knn/native/build.py: the sources are compiled on first
use, into ``tpu_knn_torch/_build/`` under a name that hashes their content
and the flags, through a temporary directory and an atomic rename, so
concurrent first users are safe and a changed source rebuilds. Each *.cu
file (one family of kernels; knn_common.cuh, tiled.cuh and kselect.cuh hold
what they share) is compiled by its own nvcc, all started together, and
the objects are linked into one library. The library has a plain C
interface (no PyTorch headers), which keeps a build to seconds. Nothing is
fetched: the build uses the sources in this directory and the local CUDA
toolkit. Importing this module runs nothing.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")

#: -Xptxas -v reports each kernel's registers, shared memory and spills;
#: build() keeps that report beside the library (log_path()).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the tpu_knn_torch kernels are "
        "compiled from csrc/ on the machine with the card")


def lib_path() -> str:
    h = hashlib.sha256()
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtpuknn_torch_{h.hexdigest()[:16]}.so")


def log_path() -> str:
    return lib_path()[:-3] + ".log"


def build() -> str:
    """Compile (if needed) and return the shared library's path. A failed
    build raises with nvcc's output."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (s for s in sources() if s.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc(), *NVCC_FLAGS, "-c", src, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
        lib = os.path.join(tmp, "lib.so")
        if all(rc == 0 for _, _, rc in report):
            cmd = [nvcc(), "-shared", *[obj for _, obj, _ in jobs], "-o", lib]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            report.append((cmd, proc.stdout, proc.returncode))
        for cmd, output, rc in report:
            if rc != 0:
                raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{output}")
        with open(log_path(), "w") as f:
            f.write("".join(output for _, output, _ in report))
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types
    (c_void_p for pointers and the stream: ctypes would cut a pointer
    passed as a default int to 32 bits)."""
    lib = ctypes.CDLL(build())
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tk_fused_candidates.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i64,
                                        i32, i32, i32, ptr]
    lib.tk_fused_candidates.restype = i32
    lib.tk_smallm_candidates.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i64,
                                         i32, i32, ptr]
    lib.tk_smallm_candidates.restype = i32
    lib.tk_smallm_candidates_bf16.argtypes = lib.tk_smallm_candidates.argtypes
    lib.tk_smallm_candidates_bf16.restype = i32
    lib.tk_tensor_candidates.argtypes = [ptr] * 6 + [i32, i32, i64] + [i32] * 6 + [ptr]
    lib.tk_tensor_candidates.restype = i32
    # The top-K kernels' tier instances (tensor_*_kernels.cu).
    lib.tk_tensor_banded.argtypes = [ptr] * 7 + [i32, i32, i64] + [i32] * 6 + [ptr]
    lib.tk_tensor_minima.argtypes = [ptr] * 6 + [i32, i32, i64] + [i32] * 7 + [ptr]
    lib.tk_tensor_sweep.argtypes = [ptr] * 6 + [i32, i32, i64] + [i32] * 7 + [ptr]
    lib.tk_tensor_moments.argtypes = [ptr] * 9 + [i32, i32, i64] + [i32] * 9 + [ptr]
    for name in ("banded", "minima", "sweep", "moments"):
        getattr(lib, f"tk_tensor_{name}").restype = i32
    # The 1-NN ladder's tier instances (tensor_ladder_kernels.cu): v3, v6, B10.
    lib.tk_tensor_resident_candidates.argtypes = [ptr] * 5 + [i32, i32, i64] + [i32] * 6 + [ptr]
    lib.tk_tensor_aos_candidates.argtypes = [ptr] * 4 + [i32, i32, i64] + [i32] * 5 + [ptr]
    lib.tk_tensor_dma_candidates.argtypes = [ptr] * 3 + [i32, i32, i64] + [i32] * 5 + [ptr]
    for name in ("aos", "resident", "dma"):
        getattr(lib, f"tk_tensor_{name}_candidates").restype = i32
    lib.tk_banded_candidates.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                         i64, i32, i32, i32, ptr]
    lib.tk_banded_candidates.restype = i32
    lib.tk_sweep_candidates.argtypes = [ptr] * 4 + [i32, i32, i32, i64] + [i32] * 4 + [ptr]
    lib.tk_sweep_candidates.restype = i32
    lib.tk_smallm_topk_candidates.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                              i64, i32, i32, i32, ptr]
    lib.tk_smallm_topk_candidates.restype = i32
    lib.tk_minima_candidates.argtypes = [ptr] * 5 + [i32, i32, i32, i64] + [i32] * 4 + [ptr]
    lib.tk_minima_candidates.restype = i32
    lib.tk_extract_moments.argtypes = [ptr] * 8 + [i32, i32, i32, i64] + [i32] * 6 + [ptr]
    lib.tk_extract_moments.restype = i32
    lib.tk_compact_cells.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
    lib.tk_compact_cells.restype = i32
    lib.tk_aos_candidates.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.tk_aos_candidates.restype = i32
    lib.tk_const_query_candidates.argtypes = lib.tk_fused_candidates.argtypes
    lib.tk_const_query_candidates.restype = i32
    lib.tk_dma_candidates.argtypes = [ptr] * 3 + [i32, i32, i32, i64] + [i32] * 3 + [ptr]
    lib.tk_dma_candidates.restype = i32
    lib.tk_window_candidates.argtypes = [ptr] * 4 + [i32, i32, i64, i32, i32, ptr]
    lib.tk_window_candidates.restype = i32
    lib.tk_kdtree_traverse.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.tk_kdtree_traverse.restype = i32
    # The bf16 instances take their f32 instance's arguments, r a bf16 operand.
    for name in ("fused_candidates", "banded_candidates", "sweep_candidates",
                 "smallm_topk_candidates", "minima_candidates", "extract_moments"):
        f32, bf16 = getattr(lib, f"tk_{name}"), getattr(lib, f"tk_{name}_bf16")
        bf16.argtypes, bf16.restype = f32.argtypes, i32
    lib.tk_error_string.argtypes = [i32]
    lib.tk_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: cudaError {err} "
            f"({lib.tk_error_string(err).decode()})")
