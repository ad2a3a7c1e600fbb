"""Build of the port's host KD-tree library: g++ into a shared library, loaded with ctypes.

tpu_knn/native/build.py's recipe for the port's own copy of the KD-tree
source (src/kdtree_native.cc): one g++ invocation with tpu_knn's flags, on
first use, into ``tpu_knn_torch/_build/`` under a name that hashes the
source, the flags and the toolchain (a -march=native binary must never be
reused on another host), through a temporary file and an atomic rename, so
concurrent first users are safe and a changed source rebuilds. Importing
this module runs nothing; a failed build raises with the compiler's output.

The compiler is ``g++`` on the PATH, or ``$TPU_KNN_TORCH_CXX`` where set.
It does not read ``$CXX``: an environment may point that at a compiler
without an OpenMP runtime, and -fopenmp is one of the fixed flags, so such a
compiler fails the build (it raises) rather than building a serial library.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "kdtree_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")

CXX = os.environ.get("TPU_KNN_TORCH_CXX", "g++")
#: tpu_knn's flags. -ffp-contract=off: no FMA contraction, so a squared
#: distance is the f32 multiply-then-add chain of the plain versions and of
#: the v10 kernel, bit for bit.
CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp", "-shared", "-fPIC",
            "-std=c++17"]


def _toolchain_id() -> bytes:
    try:
        ver = subprocess.run([CXX, "-dumpfullversion"], capture_output=True,
                             text=True).stdout.strip()
    except OSError:
        ver = "unknown"
    return f"{platform.machine()}|{platform.node()}|{CXX}|{ver}".encode()


def lib_path() -> str:
    with open(SRC, "rb") as f:
        payload = f.read() + " ".join(CXXFLAGS).encode() + _toolchain_id()
    digest = hashlib.sha256(payload).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libkdtree_native_{digest}.so")


def build() -> str:
    """Compile (if needed) and return the shared library's path."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXXFLAGS, SRC, "-o", tmp], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native KD-tree build failed ({CXX} exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
