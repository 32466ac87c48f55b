"""Build the repo's host C++ libraries (``csrc/*.cc``) at first use.

The port's own build step for the sources the JAX package also builds: the
prefetch ring (``prefetch.cc``), the loader pool (``loader_pool.cc``) and
the dataset parser (``dataset_feed.cc``). Each source is compiled with
``g++`` into ``paddle_tpu_torch/csrc/build/`` under a name that carries
the hash of its content, so an edited source rebuilds and an unchanged one
loads as it is. Builds of one source in several processes at once (test
workers) each write a temporary file of their own and rename it into
place. A failed build raises with the compiler's output: callers decide
whether to fall back, and say which path ran.
"""

import ctypes
import hashlib
import os
import subprocess

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "build")
CXXFLAGS = ("-O2", "-fPIC", "-shared", "-pthread", "-std=c++17")


def library_path(src_name):
    """(source path, library path) of ``csrc/<src_name>``."""
    src = os.path.join(CSRC_DIR, src_name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    stem = os.path.splitext(src_name)[0]
    return src, os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build_and_load(src_name):
    """Compile ``csrc/<src_name>`` (once per content) and dlopen it."""
    src, so = library_path(src_name)
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        res = subprocess.run(["g++", *CXXFLAGS, src, "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {src_name} ({res.returncode}):\n"
                f"{res.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)
