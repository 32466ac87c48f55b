"""Time edited copies of the port's f32 flash forward kernel on one GPU.

    python3 tools/flash_fwd_variants.py [variant ...]

Each variant is ``paddle_tpu_torch/csrc/flash_attention.cu`` and the
header beside it with a few lines edited (``VARIANTS`` below; ``base`` is
the source as it is). The card's machine has no profiler that reads stall
reasons, so the variants ask the questions by edits: a block of 8 warps
(128 query rows), a third ring stage, and three diagnostics that are wrong
on purpose (no split of the streamed operands, one TF32 pass instead of
three, a split by truncation). Every variant is built with nvcc into
``paddle_tpu_torch/csrc/build/variants/<name>/``, its f32 kernels' ptxas
registers and spills are printed, its error against the plain version is
measured on f32 cases (|out - ref| / max(1, |ref|), out and lse; printed,
not gated), and all are timed in turns (every variant, then every variant
in reverse, L2 flushed as chip_smoke.py's phase 8 does) at the training
shape (B 8, H 12, T 512, D 64, causal, the training step's views) and at
T 16384 (B 1, H 12), beside scaled_dot_product_attention. The last two
lines are the card's name and power limit and one JSON object of the
times and errors. Exits non-zero without CUDA.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs                                   # noqa: E402
from paddle_tpu_torch.ops.cuda import _build, flash       # noqa: E402

SOURCE = "flash_attention.cu"
HEADER = "flash_common.cuh"

# name -> [(file, text, replacement)]
VARIANTS = {
    "base": [],
    "rows128": [(SOURCE, "constexpr int kFwdWarps = 4;",
                 "constexpr int kFwdWarps = 8;")],
    "stages3": [(SOURCE, "constexpr int kFwdStages = 2;",
                 "constexpr int kFwdStages = 3;")],
    # the streamed operand of every product taken as it is (no split)
    "no_b_split": [(HEADER, "  split(b0, bb0, bs0);\n  split(b1, bb1, bs1);\n",
                    "  bb0 = bs0 = __float_as_uint(b0);\n"
                    "  bb1 = bs1 = __float_as_uint(b1);\n")],
    # big.big' alone
    "one_pass": [(HEADER, "  mma_tf32(c, as, bb0, bb1);\n"
                  "  mma_tf32(c, ab, bs0, bs1);\n", "")],
    # big by truncation, small as the exact remainder, untouched: the
    # tensor cores read the top 19 bits of each
    "trunc_split": [(HEADER, "  big = tf32_bits(x);\n"
                     "  small = tf32_bits(x - __uint_as_float(big));\n",
                     "  big = __float_as_uint(x) & 0xffffe000u;\n"
                     "  small = __float_as_uint(x - __uint_as_float(big));\n")],
}


def build(name):
    """Start nvcc on the variant's copy; returns (process, library path)."""
    out = os.path.join(_build.BUILD_DIR, "variants", name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    for f in (SOURCE, HEADER):
        shutil.copy(os.path.join(_build.CSRC, f), out)
    for f, old, new in VARIANTS[name]:
        path = os.path.join(out, f)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            cs._fail(f"variant {name}: the edit of {f} does not apply")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    so = os.path.join(out, "lib.so")
    cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
           "-v", "-o", so, os.path.join(out, SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), so


def load(so):
    lib = ctypes.CDLL(so)
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def ptxas_lines(log):
    keep, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            on = "flash_fwd_kernel" in line
        if on and ("Used" in line or "spill" in line):
            keep.append(line.replace("ptxas info    : ", "").strip())
    return keep


def max_err(gen):
    """The worst |x - ref| / max(1, |ref|) of out and lse over f32 cases at
    D 32/64/128 and T 16384."""
    worst = 0.0
    cases = [cs.flash_case(name, torch.float32, d, gen)
             for d in flash.HEAD_DIMS
             for name in ("causal", "bias_full", "long_key",
                          "segment_causal")]
    cases.append(tuple(cs._rand(cs.LONG_SHAPE, gen) for _ in range(3))
                 + (None, None, None, True))
    for q, k, v, bias, segq, segk, causal in cases:
        out, lse = flash.flash_attention_cuda(q, k, v, bias, segq, segk,
                                              None, causal)
        if q.shape[2] == cs.LONG_SHAPE[2]:
            ref, rlse = cs._flash_plain_by_head(flash, q, k, v, causal)
        else:
            ref, rlse = flash.flash_attention_reference(
                q, k, v, bias, segq, segk, None, causal)
        worst = max(worst, cs._flash_err(out, ref), cs._flash_err(lse, rlse))
    return worst


def main():
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available")
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        cs._fail(f"unknown variants {unknown}: want some of {list(VARIANTS)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {n: build(n) for n in names}
    libs = {}
    for n, (proc, so) in builds.items():
        _, log = proc.communicate()
        if proc.returncode != 0:
            cs._fail(f"nvcc failed on variant {n}:\n{log[-3000:]}")
        for line in ptxas_lines(log):
            print(f"ptxas {n}: {line}")
        libs[n] = load(so)
    errs = {}
    for n, lib in libs.items():
        flash._libs[SOURCE] = lib
        errs[n] = max_err(torch.Generator(device="cuda").manual_seed(cs.SEED))
        print(f"{n}: max err {errs[n]:.3e}")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    shapes = {"train_f32": cs.prefill_views(torch.float32, gen,
                                            cs.TRAIN_SHAPE),
              "long_f32": tuple(cs._rand(cs.LONG_SHAPE, gen)
                                for _ in range(3))}
    reps = {"train_f32": 50, "long_f32": 5}
    times = {n: {s: [] for s in shapes} for n in libs}
    for n in list(libs) + list(libs)[::-1]:
        flash._libs[SOURCE] = libs[n]
        for s, (q, k, v) in shapes.items():
            times[n][s].append(cs._time_ms(
                lambda: flash.flash_attention_cuda(q, k, v, None, None, None,
                                                   None, True),
                reps=reps[s], warmup=2))
    sdpa = {s: cs._time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=reps[s], warmup=2)
        for s, (q, k, v) in shapes.items()}
    print(cs._card_line())
    print(json.dumps({"times": times, "sdpa": sdpa, "max_err": errs}))


if __name__ == "__main__":
    main()
