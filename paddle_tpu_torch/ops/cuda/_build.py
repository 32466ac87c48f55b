"""Build a CUDA source of ``paddle_tpu_torch/csrc/`` at first use.

Each kernel module compiles its own source with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under
``paddle_tpu_torch/csrc/build/`` (named by the hash of the source and the
headers beside it, so an edited source or header rebuilds and an unchanged
one loads as it is) and loads it with ctypes. ``ptxas``'s report of each kernel (registers, shared
memory, spills) is kept beside the library as ``<library>.log``. Builds
of different sources may run at the same time: each writes a temporary
file of its own and renames it into place.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")


def _nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built from source at first use")
    return found


def library_path(source):
    """Where ``csrc/<source>``'s library lives, by its content and that of
    every header (``*.cuh``) beside it, so that an edited header rebuilds
    the sources that include it."""
    path = os.path.join(CSRC, source)
    h = hashlib.sha256()
    for name in [source] + sorted(f for f in os.listdir(CSRC)
                                  if f.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return path, os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build_library(source):
    """Compile ``csrc/<source>`` for sm_90a (once per source content) and
    return the loaded ctypes library. Raises with nvcc's output when the
    build fails."""
    path, so = library_path(source)
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, path]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} ({res.returncode}):\n{res.stderr}")
        with open(f"{tmp}.log", "w") as f:
            f.write(res.stderr)
        os.replace(f"{tmp}.log", f"{so}.log")
        os.replace(tmp, so)
    return ctypes.CDLL(so)
