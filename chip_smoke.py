"""Chip smoke for the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (the three kernel sources, paged
attention, the flash-attention forward and its backward, are built from
paddle_tpu_torch/csrc/ first, one nvcc each, side by side; ptxas's
registers, shared memory and spills of the f32 forward kernel and of the
backward kernels are printed):

1. kernel vs plain: the hand-written paged-attention kernel against its
   plain PyTorch version on the card, dense pools (q in the pool dtype, and
   f32 q over bf16 pools) and int8 pools (codes with f32 row scales, q f32
   or bf16), at a small shape (GQA, idle lane, NaN-poisoned NULL block; for
   int8 its codes 127 and its scales NaN) and at the serving shapes (decode
   C=1, prefill C=chunk, and the fused step's steady decode: C=chunk with
   one valid column per lane; H 12 for dense, H 12 over H_kv 4 for int8),
   the same at head_dim 128 (H 8, over H_kv 4 for int8), and the table
   walk's and the split-K merge's edges (one live block a lane, fewer
   live blocks than splits, a full context, NULL entries inside the live
   range (held to the plain function with those keys masked, as the
   kernel and v2 skip them), bs 32 and 24, a two-entry table (one split),
   256 rows (two row groups)), a bf16 output also held row by row against
   the plain version with q and dense pools in f32;
1n. the paged kernel on NaN keys: one NaN key block a poisoned lane (NaN
   k rows, for int8 pools NaN k_scale rows, as serving's chaos poison
   writes them) at its first, its second (key group 1's first tile), a
   middle and its last live table entry, through decode C 1 over M 64
   (8 splits, 4 key groups), the 16-lane fused step (split-K) and a
   two-entry table (one split), dense bf16, f32, f32 q over bf16 pools
   and int8 under bf16 and f32 q: the kernel's non-finite output rows
   must be exactly the plain version's, its finite rows within TOLERANCE;
1f. flash kernels vs plain: the flash-attention forward against its plain
   version, out and lse, f32 (flash_fwd_kernel, mma.sync) and bf16
   (flash_fwd_tc_kernel, wgmma: every bf16 case must add one to its
   count), D 32/64/128, on
   every feature of the TPU kernels it replaces (causal and not, Tq != Tk,
   lengths off the tile grid, key-only / per-query / per-head bias, bias
   under causal, segment ids self and cross and with a bias, tiles skipped
   whole, causal rows with no visible key exactly 0) and three more (a
   long key run off the 128-key grid over two q tiles, Tk one past a key
   tile, views at an odd offset that the wrapper must copy for TMA, a
   bias strided along keys that it must copy for the kernel), then
   at the prefill shape (B 8, H 12, T 512, D 64, causal, bf16, q/k/v as
   the prefill's transposed views, which meet TMA's rule and are not
   copied) and the long shape (B 1, H 12, T 16384, causal, bf16 and f32;
   the plain version head by head), and the f32 training shape (the
   training step's views, which meet the 16-byte rule and are not
   copied); bf16 also row by row against the plain version in f32;
2. serve at full width: GPTConfig() (12 x 768, vocab 32000, bf16, random
   weights from a seed) through GenerationServer with continuous batching,
   greedy and sampled requests and one mid-stream cancel; the kernel's
   launch count over the run must equal iterations x layers;
2b. serve the int8 path at full width: GPTConfig(kv_heads=4) (12 query
   heads over 4 KV heads), bf16 activations, int8 weights and int8 KV
   pools, the same request mix; launches = iterations x layers, 72 int8
   weights, pool bytes <= 0.56x the same blocks dense in bf16, printed
   beside bf16 MHA pools of the same block count;
3. end-to-end agreement: the greedy requests in f32, once through the
   kernel and once with the plain attention put in through the model's
   ``attention`` hook, must give identical first 16 ids;
3b. the same for phase 2b's configuration in f32 (int8 KV, int8 weights);
2c. head_dim 128: GPTConfig(hidden_size=1024, num_heads=8) at 12 layers
   in bf16 serves 6 greedy requests of 64 new tokens (launches =
   iterations x layers), then in f32 kernel and plain attention give
   identical first 16 ids;
4. times of the kernel (and its wrapper's host microseconds a call),
   its plain version and a library yardstick
   (scaled_dot_product_attention over K/V gathered, for int8 also
   dequantized, dense beforehand) at the three serving shapes and the
   fused step at head_dim 128, cold L2 before every launch, beside the
   bound: the bytes the function must move over the card's memory rate,
   or its operations over the bf16/f32 peak, whichever is larger;
5. where a full-width step's time goes: torch.profiler over 20 steady
   steps of phase 2's and of phase 2b's server, the device's busy share
   and the kernel's part of it;
6. prompt-conditioned decoding at full width: GPTConfig() in bf16 through
   make_prompt_decoder on 8 seeded 512-token prompts, 64 new tokens each
   (greedy), beam K 4 on 2 of them, and make_sampler(prompt_len=512,
   top_k=50); every call's prefill must launch the flash forward's
   tensor-core kernel exactly 12 times (once per layer); prints the
   prefill ms (the median of 5 timed prefills, each one listed), prompt
   tokens/s and decode tokens/s;
6b. where the greedy prompt decode's time goes: torch.profiler over one
   call, the device's busy share, the flash kernel's part and the device
   operations per decode step;
7. end-to-end agreement of the prefill: the greedy prompt decoder in f32,
   once through the flash kernel and once with its plain version put in
   through ``attention``, must give identical first 16 ids;
8. flash times: kernel, plain and scaled_dot_product_attention (the
   yardstick, never on the path) at the prefill and the long shape (bf16,
   flash_fwd_tc_kernel) and at the training shape and the long shape
   (f32, flash_fwd_kernel, which phase 9 launches), cold L2, beside the
   bound;
1g. flash backward kernels vs plain: dq, dk and dv of the dQ and dK/dV
   kernels against their plain version on phase 1f's feature cases and
   the backward's own (Tq and Tk one past and one under its tiles, a
   per-query bias under causal over several tiles, views that break its
   copies' 16-byte rule), f32 and bf16, D 32/64/128, with and without an
   lse cotangent, dbias through the torch op where the case has a bias,
   bf16 also row by row against the plain version in float64, rows with
   no visible key exactly 0; then the training shape (B 8, H 12,
   T 512, D 64, causal, f32 and bf16, q/k/v/do as transposed views; the
   pair run twice must give bitwise-equal dq, dk, dv) and T 16384 (B 1,
   H 12, f32; the plain version head by head);
9. full-width training through the Fluid entry points:
   ``gpt.build_lm_net(GPTConfig(max_position=1024, dropout=0.0),
   seq_len=512)`` + ``AdamOptimizer(1e-4).minimize(loss)``, the startup on
   the card, 3 warm-up and 20 timed steps on one seeded batch of 8; the
   loss must be finite and fall, and every step must launch the flash
   forward and each backward kernel 12 times; prints step ms p50/p99,
   tokens/s, the peak memory and the first and last loss;
9b. f32 agreement: one full-width step through the kernels and one with
   the plain dense attention put in at ``attention_ops`` (a seam of this
   script only), from the same scope: the loss and every @GRAD agree;
9c. where the training step's time goes: torch.profiler over 3 steps, the
   device's busy share, device operations per step, top kernels and the
   flash kernels' share;
10. flash backward times: kernels, plain and the backward of
   scaled_dot_product_attention(is_causal=True) on the same views (the
   yardstick, never on the path) at the training shape (f32 and bf16) and
   at T 16384 (f32), cold L2, beside the bound;
11. the prefix cache at full width (GPTConfig(), 16 slots, block 16,
   chunk 16, context 1024): bench.py's prefix traffic (48 requests, 80 %
   one of three tenant system prompts of 384, 256 and 512 tokens plus a
   1-64 token suffix, the rest random prompts of 64-512 tokens, 32 new
   tokens each) through a no-share server and a prefix server's cold and
   warm passes; in f32 the prefix passes give the no-share ids, allocate
   fewer blocks a request (the ratio is printed), hit the index and copy
   at least one block on write; tokens/s of both servers in bf16;
12. speculative decoding on GPTConfig(), k 3: the target as its own
   draft (f32: the plain server's ids, accept rate 1.0, fewer
   iterations) and a small draft at head dim 32 (hidden 256, 8 heads, 2
   layers; f32: the plain server's ids; rejection mode: the same ids on
   two runs with one seed); bf16 tokens/s of the plain server and of the
   small draft's; the draft's launches = iterations x k x its layers;
13. decode strategies at full width: four n = 4 sampled fork groups
   (one prefill a group, a peak block footprint below the same 16 lanes
   as separate requests), beam K 4 with an eos id in f32, plain and
   under greedy speculation (every hypothesis's ids equal the dense
   inference.decoding beam's over the same prompts), a regex and a JSON constraint over a seeded
   32000-entry string vocabulary (every output conforms, one of them an
   n = 2 group), and a cancelled group and a group past its deadline
   (every block comes back); wall and device ms a step of the group and
   beam runs;
14. the host KV tier at full width: GPTConfig(), 16 slots over 257
   device blocks (a quarter of phase 2's) and 640 host blocks, phase 2's
   prompts greedy with 128 new tokens. f32 on the first 16 requests: the
   tiered server's ids equal the untiered server's at 257 blocks and
   phase 2's full pool's, it preempts at least once and resumes every
   preempted request, every device and host block comes back; a chaos
   preemption of a named decode lane gives the same ids; a prefix
   server whose chains chaos spilled serves the next hit from the host
   tier (swap-ins) with the same ids; the kernel agrees with its plain
   version on a step whose tables hold a resumed lane's swapped-in
   blocks. bf16: the 32 requests with and without the tier (peak and
   mean lanes, steps, tokens/s, preemptions, spills, swap-ins), and the
   µs and GB/s of a block spilled and swapped in beside the host link's
   64 GB/s;
15. telemetry, chaos and the HBM ledger: a chaos NaN poison through
   phase 2's bf16 server and phase 2b's int8/GQA server must raise
   NonFiniteError through the kernel at the iteration and for the
   request ids of the same server on the plain attention, with the
   flight dump's aborted entry last; telemetry on and off give the same
   f32 ids (the host ms a bf16 step it adds is printed); the kv_pool and
   model_params ledger rows beside torch.cuda.memory_allocated()'s growth
   over a build and the model build's requested bytes (without the
   allocator's block rounding), the kv_pool_host row equal to the pinned
   host pools; serve_metrics on 127.0.0.1 serves the serving.* and
   serving.kv.tier.* series;
16. BERT-base pretraining through the Fluid entry points:
   ``bert.build_pretrain_net(BertConfig(max_position_embeddings=512),
   seq_len=512)`` (vocab 30522, hidden 768, 12 layers, 12 heads, FFN
   3072, dropout 0.1) + ``AdamOptimizer(1e-4)``, f32 with TF32 off, on
   ``ernie.make_pretrain_feed(cfg, 512, 8, dtype=np.int32)`` (bench.py's
   ERNIE cell, synthetic): 30 steps on one batch; every step must launch
   the f32 flash forward, dQ and dK/dV kernels 12 times each, the first
   step's padding bias must reach the kernels as a (B, H, T, T) view with
   stride 0 over heads and queries, and the last loss must be below
   BERT_LOSS_MARGIN x the first; prints step ms p50/p99, tokens/s, the
   peak memory, then a profile of 3 more steps (device ms a step, busy
   share, the flash kernels' share of device time);
16b. f32 agreement at full width and 2 layers, dropout 0, the same feed
   with two rows padded at the tail (a non-zero key-side bias): 3 Adam
   steps through the kernels and with the plain dense attention put in
   at ``attention_ops``, from one startup scope: every loss and the first
   step's @GRADs within 9b's tolerances;
16c. packed pretraining: ``build_packed_pretrain_net`` at full width, seq
   512, over 16 documents of 64-512 tokens packed by ``pack_sequences``
   (segment ids through the kernels): 10 steps (the loss falls, 12 + 12 +
   12 launches a step), packing efficiency and real (non-pad) tokens/s;
   then one step kernel vs plain at 2 layers, as 16b;
17. ring attention on a local sp 4 mesh on the card (``make_mesh(sp=4)``:
   the four ranks in this process), q/k/v (1, 12, 8192, 64) f32, causal
   and non-causal with a key-side bias over the last 1000 keys:
   ``ring_attention_sharded``'s output and d q/k/v of a seeded cotangent
   against the plain full attention at the JAX tests' tolerances (3e-5,
   2e-4), flash launches a call 10 + 10 + 10 causal, 16 + 16 + 16 not;
   the ring call's ms beside one flash call over the whole T (for
   information).

Phases 11-13 serve through the paged kernel (launches = iterations x
layers in every run, and a draft's iterations x k x its layers) and hold
it against its plain version on one attention call each path made, its
inputs copied as the kernel read them: lanes that share prefix blocks, a
verify step with several decode columns a lane, a draft rollout at C 1
and D 32, beam lanes over shared prompt blocks, and a beam verify step
whose columns land in the tail block the lanes' first decode write
copied.

    python3 chip_smoke.py --bwd-times-of <checkout>

runs phase 10 alone on the backward kernels of the package in another
checkout (such as the parent commit unpacked by ``git archive`` into a
directory that .gitignore lists), so that two versions are timed in one
call, on one card.

    python3 chip_smoke.py --fwd-times-of <checkout>

does the same with phase 8 and the forward kernels, and

    python3 chip_smoke.py --paged-of <checkout>

with phase 1n's NaN cases (reported, not failed) and phase 4 on the
paged kernel.

Each phase prints its seconds. The line before the last is a JSON object
with the kernel table (the paged kernel's dense and int8 variants, the
flash-attention forward's bf16 (wgmma) and f32 (mma.sync) kernels and
the flash-attention backward; the paged entry also counts the launches
of phases 11-15 in ``launches_by_path``, the flash entries those of
phases 16-17, with 16b/16c/17's errors in ``path_errs``); the line before
it the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``. Exits non-zero, printing no result, when CUDA is
unavailable or any phase fails.
"""

import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
# the least time for a dtype's operations: bf16 at the tensor cores'
# dense rate; f32 at the dense TF32 rate over three passes, since an
# f32-accurate product runs on the tensor cores as three TF32 products
# (big.big' + big.small' + small.big', as the flash backward does), which
# beats the 67 TFLOP/s of the CUDA cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 494.7e12 / 3}
SEED = 0
CHUNK = 16
N_REQUESTS = 32
NEW_TOKENS = 64
AGREE_TOKENS = 16
SHAPES = ("decode", "prefill", "step")
KV_HEADS = 4                        # phase 2b's GQA: 12 query heads over 4
D128_CFG = dict(hidden_size=1024, num_heads=8)  # phase 2c: head_dim 128
D128_REQUESTS = 6
PREFIX_REQUESTS = 48                # phase 11: bench.py's prefix traffic
PREFIX_NEW = 32
TENANT_LENS = (384, 256, 512)       # its three tenant system prompts
SPEC_K = 3                          # phase 12
SPEC_REQUESTS = 16
SPEC_NEW = 32
# phase 12's small draft: head dim 256 / 8 = 32, a head dim the paged
# kernel takes
SPEC_DRAFT_CFG = dict(hidden_size=256, num_heads=8, num_layers=2,
                      inner_size=1024)
GROUPS = 4                          # phase 13: n = 4 fork groups
GROUP_NEW = 48
BEAM_PROMPT = 72                    # ends inside a block of 16
BEAM_NEW = 16
GUIDED_REGEX = r"[a-z]+@[a-z]+\.(com|org)"
GUIDED_NEW = 24
TIER_BLOCKS = 257                   # phase 14: a quarter of phase 2's pool
TIER_HOST_BLOCKS = 640              # ~16 lanes' worst case of 40 blocks
TIER_NEW = 128
TIER_GATE = 16                      # phase 14's f32 gate: the first 16
POISON_AT = 6                       # phase 15: the chaos poison's iteration
TELEMETRY_PAIRS = 3                 # phase 15: off/on server pairs timed
TIER_TURNS = 2                      # phase 14: bf16 no-tier/tier pairs
# the host link of an H100 SXM: PCIe Gen5 x16, 64 GB/s a direction
# (nominal), the yardstick of the tier's spill and swap-in rates
HOST_LINK_BYTES_PER_S = 64e9
PROMPTS = 8                         # phase 6: prompts of PROMPT_LEN tokens
PROMPT_LEN = 512
PREFILL_RUNS = 5                    # phase 6: timed prefills, median kept
BEAM = 4
PREFILL_SHAPE = (8, 12, 512, 64)    # the prefill's attention at full width
LONG_SHAPE = (1, 12, 16384, 64)
TRAIN_SEQ = 512                     # phase 9: bench.py's GPT training cell
TRAIN_BATCH = 8
TRAIN_WARM = 3
TRAIN_STEPS = 20
TRAIN_SHAPE = (TRAIN_BATCH, 12, TRAIN_SEQ, 64)  # its attention
# phase 9b: |kernel - plain| of the loss over |plain|, and of each @GRAD
# over (its max |plain| + 1e-3 of the largest gradient's): the same f32
# step summed in other orders (the flash kernels' tiles against dense
# matmuls), carried through 12 layers; the floor covers gradients that are
# 0 in exact arithmetic (the key projection's bias), where both sides hold
# rounding noise
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
# phases 16-16c: bench.py's ERNIE cell (BERT-base, seq 512, batch 8, Adam
# 1e-4, int32 feeds) with synthetic feeds
BERT_CFG = dict(max_position_embeddings=512)
BERT_SEQ = 512
BERT_BATCH = 8
BERT_WARM = 3
BERT_STEPS = 27
BERT_PROFILE_STEPS = 3
# phase 16's gate: the last of the 30 steps' losses below this share of
# the first (one fixed batch, dropout 0.1)
BERT_LOSS_MARGIN = 0.95
BERT_AGREE_LAYERS = 2               # phases 16b, 16c: kernel vs plain
BERT_AGREE_STEPS = 3
BERT_PAD = 100                      # 16b: padded keys at one row's tail
PACKED_DOCS = 16                    # phase 16c: documents of 64-512
PACKED_DOC_LENS = (64, 512)         # tokens packed into rows of 512
PACKED_WARM = 2
PACKED_STEPS = 8
RING_SP = 4                         # phase 17: a local sp mesh on the card
RING_SHAPE = (1, 12, 8192, 64)
RING_MASKED = 1000                  # padded keys at the row's tail
# the JAX tests' tolerances at depth (np.allclose, rtol = atol): the
# output's of test_ring_sp8_8k_tokens, the gradients' of
# test_ring_sp8_long_sequence_grads
RING_OUT_TOL = 3e-5
RING_GRAD_TOL = 2e-4
# the profile phases trace the device only: every number they print is a
# device time or count, or a host wall around the traced loop, and the
# host-side op events made the profiler's own processing the largest part
# of the script's time
PROFILE_ACTIVITIES = [torch.profiler.ProfilerActivity.CUDA]


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        _fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: kernel vs plain
# ---------------------------------------------------------------------------

def make_case(dtype, b, h, hp, c, d, bs, m, seed, poison=False,
              idle_lane=False, max_len=None, step=False, int8=False,
              device="cuda", pool_dtype=None, lengths=None, holes=False):
    """Random paged-attention operands ((q, k_pool, v_pool, table,
    positions), scales): pools (1 + b*m, hp, bs, d), each lane's live
    blocks drawn from a shuffled free list, the NULL block NaN-poisoned on
    request, lane 0 idle on request. `step` lays the positions out as the
    fused step feeds a decoding lane: the position in column 0 and 0 in
    the masked columns. `pool_dtype` gives dense pools another dtype
    than q's (bf16 under f32 q). `int8` quantizes the pools with the port's
    quantize_kv_rows (scales {"k_scale", "v_scale"}, else {}); q stays in
    `dtype`, and a poisoned NULL block holds codes 127 and NaN scales.
    `lengths` gives each lane's length (None: idle) instead of drawing
    it; `holes` sets every third table entry inside a lane's live range
    (never its last) to the NULL block."""
    rng = np.random.default_rng(seed)
    n = 1 + b * m
    k_pool = rng.standard_normal((n, hp, bs, d)).astype(np.float32)
    v_pool = rng.standard_normal((n, hp, bs, d)).astype(np.float32)
    k_pool[0] = np.nan if poison else 0.0
    v_pool[0] = np.nan if poison else 0.0
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    tables = np.zeros((b, m), np.int32)
    q_pos = np.zeros((b, c), np.int32)
    free = list(range(1, n))
    rng.shuffle(free)
    hi = max_len or m * bs - c
    for i in range(b):
        if (idle_lane and i == 0) or (lengths and lengths[i] is None):
            continue
        length = lengths[i] if lengths else int(rng.integers(1, hi))
        n_blocks = -(-(length + c) // bs)
        for j in range(n_blocks):
            if not (holes and j % 3 == 1 and j < n_blocks - 1):
                tables[i, j] = free.pop()
        if step:
            q_pos[i, 0] = length
        else:
            q_pos[i] = np.arange(length, length + c)

    def t(x):
        return torch.from_numpy(x).to(device)

    q, tables, q_pos = t(q).to(dtype), t(tables), t(q_pos)
    if not int8:
        pdt = pool_dtype or dtype
        return (q, t(k_pool).to(pdt), t(v_pool).to(pdt), tables,
                q_pos), {}
    from paddle_tpu_torch.serving.kv_cache import quantize_kv_rows
    kq, ks = quantize_kv_rows(t(k_pool))
    vq, vs = quantize_kv_rows(t(v_pool))
    if poison:
        kq[0] = vq[0] = 127
        ks[0] = vs[0] = float("nan")
    return (q, kq, vq, tables, q_pos), {"k_scale": ks, "v_scale": vs}


def _clean_null(case):
    """A copy of the pools whose NULL block holds what a fresh cache
    does (zeros; for int8, zero codes and scale 1.0): the plain version
    gathers the NULL block, and 0 * NaN = NaN."""
    (q, k_pool, v_pool, tables, pos), scales = case
    k_pool, v_pool = k_pool.clone(), v_pool.clone()
    k_pool[0] = 0
    v_pool[0] = 0
    scales = {k: v.clone() for k, v in scales.items()}
    for v in scales.values():
        v[0] = 1.0
    return (q, k_pool, v_pool, tables, pos), scales


def serving_case(dtype, name, int8=False, pool_dtype=None, d=64):
    """The serving shapes: 16 lanes, H=12 (over H_kv=4 for int8), D=64,
    bs=16, M=64 (context 1024), lane 0 idle, NULL block NaN-poisoned. At
    D 128 the heads are GPTConfig(hidden_size=1024, num_heads=8)'s: H 8
    (over H_kv 4 for int8)."""
    c = 1 if name == "decode" else CHUNK
    h = 12 if d == 64 else 1024 // d
    return make_case(dtype, b=16, h=h, hp=KV_HEADS if int8 else h, c=c,
                     d=d, bs=16, m=64, seed=2, poison=True, idle_lane=True,
                     max_len=1024 - c, step=name == "step", int8=int8,
                     pool_dtype=pool_dtype)


# phase 1's edge cases of the table walk and the split-K merge (H 12 over
# H_kv 4, D 64, bs 16, M 64 unless named; NULL block NaN-poisoned): each
# lane's length, None for an idle lane
EDGE_CASES = {
    # every lane in its first block: one live block, the other splits idle
    "one_live_block": dict(c=1, lengths=[None, 0, 5, 15]),
    # 2-3 live blocks a lane, fewer than the split count
    "fewer_than_splits": dict(c=1, lengths=[None, 20, 40, 47]),
    # positions up to M * bs - 1: every table entry live
    "full_context": dict(c=CHUNK, lengths=[None, 1024 - CHUNK, 700, 1]),
    # NULL entries inside the live range (skipped by the kernel, as v2)
    "null_holes": dict(c=CHUNK, lengths=[None, 1000, 600, 97], holes=True),
    # 2 key tiles a block, and a block of 24 keys (one tile half padded)
    "bs32": dict(c=CHUNK, bs=32, m=32, lengths=[None, 1000, 31, 500]),
    "bs24": dict(c=4, bs=24, m=16, lengths=[None, 370, 23, 200]),
    # a table of two entries: one split, the output written directly
    "m2": dict(c=CHUNK, m=2, lengths=[None, 16, 3, 0]),
    # 256 rows (16 heads over 1 x 16 columns): two row groups
    "rows256": dict(c=CHUNK, h=16, hp=1, m=16, lengths=[None, 240, 99, 7]),
}


def edge_case(dtype, name, int8=False):
    kw = dict(b=4, h=12, hp=KV_HEADS, d=64, bs=16, m=64)
    kw.update(EDGE_CASES[name])
    return make_case(dtype, seed=3, poison=True, int8=int8, **kw)


def kernel_cases():
    """(name, case) at the small shape and the serving shapes, dense and
    int8 pools, f32 and bf16 q, and f32 q over bf16 pools (an f32 model
    serving bf16 KV)."""
    small = dict(b=3, h=4, hp=2, d=32, bs=8, m=6, poison=True,
                 idle_lane=True)
    cases = []
    for int8 in (False, True):
        pre = "int8_" if int8 else ""
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            for c in (4, 1):
                cases.append((f"{pre}small_c{c}_{tag}",
                              make_case(dt, c=c, seed=1, int8=int8,
                                        **small)))
            for name in SHAPES:
                cases.append((f"{pre}{name}_{tag}",
                              serving_case(dt, name, int8)))
    mixed = dict(pool_dtype=torch.bfloat16)
    cases.append(("small_c4_f32q_bf16pool",
                  make_case(torch.float32, c=4, seed=1, **small, **mixed)))
    cases.append(("step_f32q_bf16pool",
                  serving_case(torch.float32, "step", **mixed)))
    # head dim 128: the small case and the serving shapes (H 8)
    for int8 in (False, True):
        pre = "int8_" if int8 else ""
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            cases.append((f"{pre}small_c4_d128_{tag}",
                          make_case(dt, c=4, seed=1, int8=int8,
                                    **dict(small, d=128))))
            for name in SHAPES:
                cases.append((f"{pre}{name}_d128_{tag}",
                              serving_case(dt, name, int8, d=128)))
    cases.append(("step_d128_f32q_bf16pool",
                  serving_case(torch.float32, "step", d=128, **mixed)))
    for name in EDGE_CASES:
        for int8 in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                tag = "f32" if dt == torch.float32 else "bf16"
                cases.append((f"{'int8_' if int8 else ''}{name}_{tag}",
                              edge_case(dt, name, int8)))
    return cases


def plain_skip_null(q, k_pool, v_pool, tables, pos, k_scale=None,
                    v_scale=None):
    """The plain function with the keys of NULL table entries masked, in
    f32, cast to the kernel's output dtype: the v2 semantics, which the
    kernel implements. paged_attention_reference gathers a NULL entry
    below the early stop as keys (v1's semantics); the two agree on every
    table without NULL entries inside the live range."""
    from paddle_tpu_torch.ops.cuda.paged import (NEG_INF, NULL_BLOCK,
                                                 gather_block_kv_pair,
                                                 gather_block_scales)
    gk, gv = gather_block_kv_pair(k_pool, v_pool, tables)
    gk, gv = gk.float(), gv.float()
    if k_scale is not None:
        gk = gk * gather_block_scales(k_scale, tables)[..., None]
        gv = gv * gather_block_scales(v_scale, tables)[..., None]
    rep = q.shape[1] // k_pool.shape[1]
    gk = gk.repeat_interleave(rep, dim=1)
    gv = gv.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhcd,bhtd->bhct", q.float(), gk) / q.shape[-1] ** 0.5
    live = (tables != NULL_BLOCK).repeat_interleave(k_pool.shape[2], dim=1)
    key_pos = torch.arange(gk.shape[2], device=q.device)
    mask = ((key_pos[None, None, None, :] <= pos[:, None, :, None])
            & live[:, None, None, :])
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhct,bhtd->bhcd", p, gv) / torch.where(l > 0, l, 1.0)
    return out.to(q.dtype if k_pool.dtype == torch.int8 else k_pool.dtype)


def _row_rel_err(out, ref):
    """Max over output rows (lane, head, column) of the row's max-abs
    error over the row's max |ref|."""
    err = (out.float() - ref).abs().amax(dim=-1)
    scale = ref.abs().amax(dim=-1).clamp_min(1e-30)
    return (err / scale).max().item()


def check_kernel(paged):
    """Every case: kernel (poisoned NULL block) vs plain version (clean
    copy: it gathers the NULL block, and 0 * NaN = NaN), finite output,
    idle lane exactly 0, tolerance keyed by the output dtype. A bf16 output
    is also held row by row against the plain version computed with q in
    f32 (and, for dense pools, the pools in f32) from the same inputs.
    Returns {case: max_abs_err}."""
    errs = {}
    for name, case in kernel_cases():
        args, scales = case
        out = paged.paged_attention_cuda(*args, **scales)
        torch.cuda.synchronize()
        clean, cscales = _clean_null(case)
        plain = (plain_skip_null if "null_holes" in name
                 else paged.paged_attention_reference)
        ref = plain(*clean, **cscales)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            _fail(f"kernel output non-finite at {name}")
        if out[0].abs().max().item() != 0.0:
            _fail(f"idle lane not exactly 0 at {name}")
        if out.dtype != ref.dtype:
            _fail(f"kernel output {out.dtype}, plain {ref.dtype} at {name}")
        err = (out.float() - ref.float()).abs().max().item()
        tol = paged.TOLERANCE[out.dtype]
        line = f"kernel {name}: max_abs_err {err:.3e} (tolerance {tol})"
        rel = None
        if out.dtype == torch.bfloat16:
            q, k_pool, v_pool, tables, pos = clean
            if not cscales:
                k_pool, v_pool = k_pool.float(), v_pool.float()
            ref32 = plain(q.float(), k_pool, v_pool, tables, pos,
                          **cscales)
            torch.cuda.synchronize()
            rel = _row_rel_err(out, ref32)
            line += (f", vs f32 plain: row max_rel_err {rel:.3e} "
                     f"(tolerance {paged.BF16_ROW_REL_TOLERANCE})")
        print(line)
        if not err <= tol:
            _fail(f"kernel disagrees with its plain version at {name}: "
                  f"{err} > {tol}")
        if rel is not None and not rel <= paged.BF16_ROW_REL_TOLERANCE:
            _fail(f"bf16 kernel disagrees with the f32 plain version at "
                  f"{name}: row error {rel} > "
                  f"{paged.BF16_ROW_REL_TOLERANCE} of the row's scale")
        errs[name] = err
    return errs


# phase 1's NaN cases: one NaN key block a poisoned lane (NaN k rows for
# dense pools, NaN k_scale rows for int8 pools, as serving's chaos poison
# writes it), at the lane's first live table entry, at entry 1 (key
# group 1's first tile when a split has several key groups), at a middle
# entry and at its last live entry; the NULL block clean. Shapes: decode
# C 1 over M 64 with 4 lanes (split-K: 8 splits of 8 entries, 4 key
# groups), the 16-lane fused step (C 16, one valid column: 3 splits for
# dense pools, 5 for int8 under GQA) and a two-entry table (C 16: one
# split, the output written directly)
NAN_SHAPES = {
    "decode_splitk": dict(b=4, c=1, lengths=[1000, 700, 333, 90]),
    "step16": dict(b=16, c=CHUNK, step=True,
                   lengths=[None] + [int(x) for x in
                                     np.linspace(60, 1000, 15)]),
    "one_split": dict(b=4, c=CHUNK, m=2, lengths=[16, 10, 12, 14]),
}
NAN_AT = ("first", "entry1", "middle", "last")
# (q dtype, pool dtype or "int8")
NAN_VARIANTS = {"bf16": (torch.bfloat16, None),
                "f32": (torch.float32, None),
                "f32q_bf16pool": (torch.float32, torch.bfloat16),
                "int8_bf16q": (torch.bfloat16, "int8"),
                "int8_f32q": (torch.float32, "int8")}


def nan_case(shape, variant):
    """(case, {lane: (where, table entry)}): NAN_SHAPES[shape] at H 12
    (over H_kv 4 for int8), D 64, bs 16, M 64 unless named, each of the
    first four live lanes poisoned at one NAN_AT entry."""
    qdt, pool = NAN_VARIANTS[variant]
    int8 = pool == "int8"
    kw = {"m": 64, **NAN_SHAPES[shape]}
    case = make_case(qdt, h=12, hp=KV_HEADS if int8 else 12, d=64, bs=16,
                     seed=5, int8=int8, pool_dtype=None if int8 else pool,
                     **kw)
    (q, k_pool, v_pool, tables, pos), scales = case
    c = kw["c"]
    live = [i for i, n in enumerate(kw["lengths"]) if n is not None][:4]
    where = {}
    for i, at in zip(live, NAN_AT):
        n_live = (kw["lengths"][i] + (0 if kw.get("step") else c - 1)) \
            // 16 + 1
        j = {"first": 0, "entry1": 1, "middle": n_live // 2,
             "last": n_live - 1}[at]
        blk = int(tables[i, j])
        if int8:
            scales["k_scale"][blk] = float("nan")
        else:
            k_pool[blk] = float("nan")
        where[i] = (at, j)
    return case, where


def check_kernel_nan(paged, report_only=False):
    """Phase 1's NaN cases: the kernel's non-finite output rows (lane,
    head, column) must be exactly the plain version's, and its finite
    rows agree within TOLERANCE. `report_only` prints what the kernel
    gave (the rows it lost) without failing: the record of a kernel that
    drops NaN partials. Returns {case: max_abs_err over finite rows}."""
    errs, report = {}, {}
    for shape in NAN_SHAPES:
        for variant in NAN_VARIANTS:
            name = f"nan_{shape}_{variant}"
            case, where = nan_case(shape, variant)
            args, scales = case
            q, k_pool = args[0], args[1]
            splits = paged._plan(paged.build(), (
                q.device.index, *q.shape[:2], k_pool.shape[1], q.shape[2],
                q.shape[3], k_pool.shape[2], args[3].shape[1],
                paged._DTYPE_CODE[q.dtype],
                paged._DTYPE_CODE[k_pool.dtype]))[0]
            out = paged.paged_attention_cuda(*args, **scales)
            ref = paged.paged_attention_reference(*args, **scales)
            torch.cuda.synchronize()
            bad_k = ~torch.isfinite(out.float()).all(dim=-1)
            bad_p = ~torch.isfinite(ref.float()).all(dim=-1)
            lost = (bad_p & ~bad_k).sum().item()
            extra = (bad_k & ~bad_p).sum().item()
            fin = ~(bad_k | bad_p)
            err = ((out.float() - ref.float()).abs().amax(dim=-1)[fin]
                   .max().item() if fin.any() else 0.0)
            tol = paged.TOLERANCE[out.dtype]
            per_lane = {}
            for lane, (at, j) in where.items():
                per_lane[f"lane{lane}_{at}_entry{j}"] = {
                    "plain_nan_rows": int(bad_p[lane].sum().item()),
                    "kernel_nan_rows": int(bad_k[lane].sum().item())}
            report[name] = {"splits": int(splits), "lost_nan_rows": lost,
                            "extra_nan_rows": extra,
                            "finite_max_abs_err": err, "lanes": per_lane}
            print(f"kernel {name}: " + json.dumps(report[name]))
            if report_only:
                continue
            if not all(v["plain_nan_rows"] for v in per_lane.values()):
                _fail(f"{name}: a poisoned lane has no NaN row in the "
                      f"plain version")
            if lost or extra:
                _fail(f"{name}: the kernel's non-finite rows differ from "
                      f"the plain version's ({lost} lost, {extra} extra)")
            if not err <= tol:
                _fail(f"{name}: finite rows disagree, {err} > {tol}")
            errs[name] = err
    return report if report_only else errs


# ---------------------------------------------------------------------------
# phases 2 and 3: serving
# ---------------------------------------------------------------------------

def make_requests(vocab):
    """N_REQUESTS seeded prompts of 16..512 tokens; every third request
    samples (alternating top-k and nucleus filters)."""
    from paddle_tpu_torch.serving import SamplingParams
    rng = np.random.default_rng(SEED + 1)
    reqs = []
    for i in range(N_REQUESTS):
        prompt = rng.integers(0, vocab, int(rng.integers(16, 513)))
        sampling = None
        if i % 3 == 2:
            sampling = (SamplingParams(temperature=0.8, top_k=50, seed=i)
                        if i % 2 else
                        SamplingParams(temperature=1.0, top_p=0.9, seed=i))
        reqs.append((prompt.astype(np.int32), sampling))
    return reqs


def make_server(model, kv_dtype=None):
    from paddle_tpu_torch.serving import GenerationServer
    return GenerationServer(model, num_slots=16, block_size=16,
                            max_context=1024, chunk=CHUNK, start=False,
                            kv_dtype=kv_dtype)


def make_model(cfg, tree, dtype=None, int8=False, attention=None):
    """The serving model on the card; `int8` quantizes its weights."""
    from paddle_tpu_torch.models.gpt import params_from_numpy
    from paddle_tpu_torch.serving import GPTServingModel
    model = GPTServingModel(params_from_numpy(tree, "cuda"), cfg,
                            dtype=dtype, attention=attention)
    return model.quantize_int8() if int8 else model


def serve(model, requests, new_tokens, cancel=None, kv_dtype=None):
    """Submit every request to a fresh GenerationServer and pump steps
    until idle; `cancel` = (request index, after how many steps). Returns
    (server, futures, wall seconds, per-step host ms)."""
    srv = make_server(model, kv_dtype)
    futs = [srv.submit(p, max_new_tokens=new_tokens, sampling=s)
            for p, s in requests]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_ms = []
    while True:
        # a step ends in the device-to-host copy of the chosen ids
        ts = time.perf_counter()
        if not srv.step():
            break
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if cancel is not None and len(step_ms) == cancel[1]:
            if not futs[cancel[0]].cancel():
                _fail("mid-stream cancel refused")
    torch.cuda.synchronize()
    return srv, futs, time.perf_counter() - t0, step_ms


def phase_serve(paged, cfg, tree, int8=False):
    """Serve the request mix at full width in bf16: dense (phase 2) or
    int8 weights and int8 KV pools (phase 2b). Returns (launches,
    requests, numbers)."""
    kv_dtype = "int8" if int8 else None
    model = make_model(cfg, tree, torch.bfloat16, int8)
    requests = make_requests(cfg.vocab_size)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paged.LAUNCHES = 0
    srv, futs, wall, step_ms = serve(model, requests, NEW_TOKENS,
                                     cancel=(5, 40), kv_dtype=kv_dtype)
    launches = paged.LAUNCHES
    st = srv.get_stats()
    if not futs[5].cancelled():
        _fail("the cancelled request was not cancelled")
    generated = 0
    for i, f in enumerate(futs):
        if i == 5:
            continue
        res = f.result(timeout=0)
        ids = np.asarray(res.token_ids)
        if len(ids) != NEW_TOKENS or ids.min() < 0 \
                or ids.max() >= cfg.vocab_size \
                or not np.isfinite(res.score):
            _fail(f"request {i}: {len(ids)} ids, score {res.score}")
        generated += len(ids)
    if st["cancelled"] != 1 or st["retired"] != N_REQUESTS - 1 \
            or st["blocks_free"] != st["blocks_total"]:
        _fail(f"scheduler end state: {st}")
    if launches <= 0 or launches != st["iterations"] * cfg.num_layers:
        _fail(f"kernel launches {launches} != iterations "
              f"{st['iterations']} x {cfg.num_layers} layers")
    out = {"iterations": st["iterations"], "launches": launches,
           "generated_tokens": generated,
           "prefill_tokens": st["prefill_tokens"],
           "wall_s": wall, "tokens_per_s": generated / wall,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if int8:
        out.update(int8_pools(cfg, srv, st))
    print(("serve int8 " if int8 else "serve ") + json.dumps(out))
    return launches, requests, out


def int8_pools(cfg, srv, st):
    """Phase 2b's pool checks: 6 int8 weights a layer, pool bytes (codes
    and scales) <= 0.56x the same blocks dense in bf16, and beside them
    bf16 MHA pools of the same block count (68/128 x 4/12 = 0.18 at
    D 64), counted on the meta device."""
    from paddle_tpu_torch.serving import PagedKVCache
    kq = st["kv_quant"]
    if kq is None or kq["int8_weights"] != 6 * cfg.num_layers:
        _fail(f"int8 serve: kv_quant {kq}")
    if not kq["bytes_ratio_vs_dense"] <= 0.56:
        _fail(f"int8 pools at {kq['bytes_ratio_vs_dense']} of dense bf16 "
              f"(want <= 0.56)")
    c = srv.cache
    mha = PagedKVCache(c.num_layers, c.num_heads, c.head_dim, c.num_blocks,
                       block_size=c.block_size, dtype=torch.bfloat16,
                       device="meta").pool_bytes()
    return {"kv_quant": kq, "num_blocks": c.num_blocks,
            "bf16_mha_pool_bytes": mha,
            "ratio_vs_bf16_mha": kq["pool_bytes"] / mha}


def phase_agree(paged, cfg, tree, requests, int8=False):
    """The greedy requests in f32 through the kernel and through the
    plain attention: identical first AGREE_TOKENS ids. `int8` serves
    int8 weights from int8 KV pools (phase 3b)."""
    greedy = [(p, None) for p, s in requests if s is None]
    ids = []
    for attention in (None, paged.paged_attention_reference):
        model = make_model(cfg, tree, int8=int8, attention=attention)
        futs = serve(model, greedy, AGREE_TOKENS,
                     kv_dtype="int8" if int8 else None)[1]
        ids.append([list(f.result(timeout=0).token_ids) for f in futs])
    same = sum(a == b for a, b in zip(*ids))
    tag = "int8 " if int8 else ""
    print(f"agree {tag}f32: {same}/{len(greedy)} greedy requests identical "
          f"in their first {AGREE_TOKENS} ids (kernel vs plain attention)")
    if same != len(greedy):
        _fail(f"{tag}f32 kernel and plain attention served different ids")


def phase_serve_d128(paged, cfg, tree):
    """Phase 2c: head_dim 128 (GPTConfig(hidden_size=1024, num_heads=8))
    served at full width and depth in bf16, D128_REQUESTS greedy requests
    of NEW_TOKENS new tokens; launches = iterations x layers. Then the same
    requests in f32 through the kernel and through the plain attention:
    identical first AGREE_TOKENS ids."""
    rng = np.random.default_rng(SEED + 2)
    requests = [(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                 None) for n in rng.integers(16, 257, D128_REQUESTS)]
    model = make_model(cfg, tree, torch.bfloat16)
    paged.LAUNCHES = 0
    srv, futs, wall, step_ms = serve(model, requests, NEW_TOKENS)
    launches = paged.LAUNCHES
    st = srv.get_stats()
    generated = 0
    for i, f in enumerate(futs):
        res = f.result(timeout=0)
        ids = np.asarray(res.token_ids)
        if len(ids) != NEW_TOKENS or ids.min() < 0 \
                or ids.max() >= cfg.vocab_size \
                or not np.isfinite(res.score):
            _fail(f"d128 request {i}: {len(ids)} ids, score {res.score}")
        generated += len(ids)
    if launches <= 0 or launches != st["iterations"] * cfg.num_layers:
        _fail(f"d128 kernel launches {launches} != iterations "
              f"{st['iterations']} x {cfg.num_layers} layers")
    out = {"head_dim": cfg.hidden_size // cfg.num_heads,
           "iterations": st["iterations"], "launches": launches,
           "generated_tokens": generated, "wall_s": wall,
           "tokens_per_s": generated / wall,
           "step_ms_p50": float(np.percentile(step_ms, 50))}
    print("serve d128 " + json.dumps(out))
    ids = []
    for attention in (None, paged.paged_attention_reference):
        model = make_model(cfg, tree, attention=attention)
        futs = serve(model, requests, AGREE_TOKENS)[1]
        ids.append([list(f.result(timeout=0).token_ids) for f in futs])
        del model
    same = sum(a == b for a, b in zip(*ids))
    print(f"agree d128 f32: {same}/{len(requests)} greedy requests "
          f"identical in their first {AGREE_TOKENS} ids (kernel vs plain "
          f"attention)")
    if same != len(requests):
        _fail("d128 f32 kernel and plain attention served different ids")
    return launches


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def _time_ms(fn, reps=50, warmup=5):
    """Mean device ms of fn(), with the 50 MB L2 flushed before each
    launch (the fused step reads each layer's pools cold). A sleep kernel
    holds the device first, so the host queues every launch ahead and the
    events time the device work only, not the host's Python between
    them."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)      # ~50 ms at H100 clocks
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / reps


def _host_us(fn, reps=200):
    """Mean host microseconds of one call of fn(), which only enqueues
    device work: what the host-bound serving step pays for it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return host


def bound_ms(case):
    """The larger of (bytes the function must move / memory rate) and
    (its operations / peak rate): q, table and positions read once, the
    output (q's dtype) written once, and the live K/V blocks (non-NULL,
    below each lane's early stop) read once at the pool's element size,
    with their f32 row scales for int8 pools; QK^T and PV over the live
    keys, at q's dtype's peak."""
    (q, k_pool, _, tables, pos), scales = case
    b, h, c, d = q.shape
    _, hp, bs, _ = k_pool.shape
    tb = tables.cpu().numpy()
    n_live = np.minimum(pos.cpu().numpy().max(axis=1) // bs + 1,
                        tb.shape[1])
    live_blocks = np.array([np.count_nonzero(tb[i, :n_live[i]])
                            for i in range(b)])
    kv = 2 * int(live_blocks.sum()) * hp * bs * d * k_pool.element_size()
    if scales:
        kv += 2 * int(live_blocks.sum()) * hp * bs * 4
    moved = (kv + 2 * q.numel() * q.element_size()
             + tables.numel() * 4 + pos.numel() * 4)
    flops = 4 * int(live_blocks.sum()) * bs * (h // hp) * hp * c * d
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def library_call(case):
    """scaled_dot_product_attention over K/V gathered dense beforehand
    (int8 pools: gathered and dequantized into q's dtype beforehand, so
    it reads bf16, not int8), with the position mask and the GQA group
    mapping: the yardstick, timed only."""
    from paddle_tpu_torch.ops.cuda.paged import (gather_block_kv_pair,
                                                 gather_block_scales)
    import torch.nn.functional as F
    (q, k_pool, v_pool, tables, pos), scales = _clean_null(case)
    gk, gv = gather_block_kv_pair(k_pool, v_pool, tables)
    if scales:
        gk = (gk.float() * gather_block_scales(scales["k_scale"], tables)
              [..., None]).to(q.dtype)
        gv = (gv.float() * gather_block_scales(scales["v_scale"], tables)
              [..., None]).to(q.dtype)
    key_pos = torch.arange(gk.shape[2], device=q.device)
    mask = key_pos[None, None, None, :] <= pos[:, None, :, None]
    gqa = gk.shape[1] != q.shape[1]
    return lambda: F.scaled_dot_product_attention(q, gk, gv,
                                                  attn_mask=mask,
                                                  enable_gqa=gqa)


def phase_times(paged, int8=False):
    """Kernel, plain and library ms and the bound at the three serving
    shapes with bf16 q (dense pools, or int8 pools over H_kv 4), and at
    the fused step with head_dim 128 (H 8, phase 2c's model)."""
    rows = {}
    for name in SHAPES + ("step_d128",):
        d128 = name == "step_d128"
        case = serving_case(torch.bfloat16, "step" if d128 else name, int8,
                            d=128 if d128 else 64)
        args, scales = case
        clean, cscales = _clean_null(case)
        b_ms, b_by = bound_ms(case)
        rows[name] = {
            "shape": list(args[0].shape), "kv_heads": args[1].shape[1],
            "ms": _time_ms(lambda: paged.paged_attention_cuda(*args,
                                                              **scales)),
            "host_us": _host_us(lambda: paged.paged_attention_cuda(
                *args, **scales)),
            "plain_ms": _time_ms(
                lambda: paged.paged_attention_reference(*clean, **cscales)),
            "library_ms": _time_ms(library_call(case)),
            "bound_ms": b_ms, "bound_by": b_by}
        tag = "int8 pools, bf16 q" if int8 else "bf16"
        print(f"times {name} {tag} " + json.dumps(rows[name]))
    return rows


def phase_profile(cfg, tree, int8=False, warm_steps=60, steps=20):
    """Where a full-width step's time goes: serve the request mix (phase
    2's server, or with `int8` phase 2b's), skip `warm_steps`, then trace
    `steps` steps with torch.profiler. Prints the host wall per step, the
    device's kernel time per step (its busy share; one stream, so kernels
    do not overlap), the device operations (kernels, copies) per step, the
    paged-attention kernel's share, and the top kernels by device time."""
    from torch.profiler import profile as tprofile
    model = make_model(cfg, tree, torch.bfloat16, int8)
    srv = make_server(model, "int8" if int8 else None)
    for p, s in make_requests(cfg.vocab_size):
        srv.submit(p, max_new_tokens=NEW_TOKENS, sampling=s)
    for _ in range(warm_steps):
        srv.step()
    torch.cuda.synchronize()
    with tprofile(activities=PROFILE_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            if not srv.step():
                _fail("the request mix drained before the profile")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    launches = sum(e.count for e in kernels) / steps
    busy = sum(dev_us.values()) / steps / 1e3
    attn = sum(v for k, v in dev_us.items()
               if "paged_attention" in k) / steps / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    out = {"steps": steps, "after_steps": warm_steps,
           "wall_ms_per_step": wall / steps * 1e3,
           "device_ms_per_step": busy,
           "device_busy_share": busy / (wall / steps * 1e3),
           "device_launches_per_step": launches,
           "paged_attention_ms_per_step": attn,
           "top_kernels_ms_per_step": [[k[:80], v / steps / 1e3]
                                       for k, v in top]}
    if busy <= 0:
        _fail("the profiler saw no device time")
    print(("profile int8 " if int8 else "profile ") + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 1f: flash kernel vs plain
# ---------------------------------------------------------------------------

def _rand(shape, gen, dtype=torch.float32):
    return torch.randn(*shape, device="cuda", generator=gen).to(dtype)


def flash_case(name, dtype, d, gen):
    """(q, k, v, bias, segq, segk, causal) of one feature case at a small
    shape: the features of the TPU kernels the flash kernel replaces."""
    b, h, tq, tk, causal = 2, 3, 64, 64, False
    if name in ("causal", "segment_causal", "bias_causal"):
        causal = True
    if name == "cross_len":
        tq, tk, causal = 48, 80, True
    if name == "ragged":                  # off every tile grid
        tq, tk, causal = 100, 53, False
    if name == "ragged_causal":
        tq, tk, causal = 37, 133, True
    if name == "no_visible_keys":         # rows i < Tq - Tk see nothing
        tq, tk, causal = 80, 16, True
    if name == "long_key":                # many key tiles
        b, h, tq, tk = 1, 2, 70, 700
    if name == "long_ragged":             # two q tiles, Tk off the grid
        b, h, tq, tk = 1, 2, 130, 1037
    if name == "key_tile_plus_one":       # Tk one past a 128-key tile
        tq, tk, causal = 100, 129, True
    if name == "tile_plus_one":           # one past a 64-row tile
        tq, tk, causal = 65, 65, True
    if name == "tile_minus_one":          # one under
        tq, tk, causal = 63, 63, True
    if name == "tiles_cross":             # one past three 32-row streamed
        tq, tk, causal = 97, 159, True    # tiles, one under 2.5 64-key ones
    if name == "bias_causal_long":        # a per-query bias under causal
        tq, tk, causal = 200, 200, True   # over several tiles
    q = _rand((b, h, tq, d), gen, dtype)
    k = _rand((b, h, tk, d), gen, dtype)
    v = _rand((b, h, tk, d), gen, dtype)
    bias = segq = segk = None
    if name == "bias_key":                # a padding mask, batch row 0
        bias = torch.zeros(b, 1, 1, tk, device="cuda")
        bias[0, ..., tk // 2:] = -1e9
        bias = bias.expand(b, h, tq, tk)
    if name in ("bias_query", "bias_causal", "bias_causal_long"):
        bias = _rand((b, 1, tq, tk), gen).expand(b, h, tq, tk)
    if name == "bias_full":
        bias = _rand((b, h, tq, tk), gen) * 2
    if name.startswith("segment"):
        segq = torch.sort(torch.randint(0, 3, (b, tq), device="cuda",
                                        generator=gen), dim=1).values
        segk = segq
        if name == "segment_bias":
            bias = _rand((1, h, tq, tk), gen).expand(b, h, tq, tk)
    if name == "segment_cross":
        tq, tk = 32, 48
        q = q[:, :, :tq]
        k, v = _rand((b, h, tk, d), gen, dtype), _rand((b, h, tk, d), gen,
                                                       dtype)
        segq = torch.tensor([[1] * 16 + [2] * 16] * b, device="cuda")
        segk = torch.tensor([[1] * 16 + [2] * 32] * b, device="cuda")
    if name == "segment_skip":            # tile-aligned disjoint segments
        tq = tk = 128
        q = _rand((b, h, tq, d), gen, dtype)
        k, v = _rand((b, h, tk, d), gen, dtype), _rand((b, h, tk, d), gen,
                                                       dtype)
        segq = segk = torch.tensor([[1] * 64 + [2] * 64] * b, device="cuda")
    if name == "misaligned":              # views at an odd offset
        q, k, v = (_offset_view(t) for t in (q, k, v))
    if name == "bias_strided":            # a bias strided along keys
        bias = _rand((b, h, tk, tq), gen).transpose(-1, -2)
    if segq is not None:
        segq = segq.to(torch.int32).contiguous()
        segk = segk.to(torch.int32).contiguous()
    return q, k, v, bias, segq, segk, causal


def _offset_view(t):
    """t's values in a view one element into a fresh buffer: a base that
    is not 16-byte aligned, which the TMA rule refuses."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


FLASH_FEATURES = ("plain", "causal", "cross_len", "ragged", "ragged_causal",
                  "no_visible_keys", "long_key", "bias_key", "bias_query",
                  "bias_full", "bias_causal", "segment", "segment_causal",
                  "segment_bias", "segment_cross", "segment_skip")
# phase 1f only: the tensor-core kernel's tile edges and its TMA copy
FLASH_FWD_EXTRA = ("long_ragged", "key_tile_plus_one", "misaligned",
                   "bias_strided")
# phase 1g only: the backward's tile edges (64 own rows, 64 streamed, 32
# at D 128), a per-query bias under causal over several tiles, and views
# that break its copies' 16-byte rule (copied by the wrapper)
FLASH_BWD_EXTRA = ("tile_plus_one", "tile_minus_one", "tiles_cross",
                   "bias_causal_long", "misaligned")


def prefill_views(dtype, gen, shape=PREFILL_SHAPE):
    """q, k, v as the prefill passes them: each (B, T, H, D) projection
    viewed as (B, H, T, D)."""
    b, h, t, d = shape
    return tuple(_rand((b, t, h, d), gen, dtype).transpose(1, 2)
                 for _ in range(3))


def _flash_err(out, ref):
    """max over elements of |out - ref| / max(1, |ref|)."""
    return ((out.float() - ref.float()).abs()
            / ref.float().abs().clamp_min(1.0)).max().item()


def _flash_plain_by_head(flash, q, k, v, causal):
    """The plain version one head at a time (the long shape's score matrix
    of all heads at once would not fit)."""
    outs, lses = [], []
    for i in range(q.shape[1]):
        o, l = flash.flash_attention_reference(
            q[:, i:i + 1], k[:, i:i + 1], v[:, i:i + 1], None, None, None,
            None, causal)
        outs.append(o)
        lses.append(l)
    return torch.cat(outs, 1), torch.cat(lses, 1)


def check_one_flash(flash, name, case, by_head=False):
    """One case through the kernel its dtype takes (bf16:
    flash_fwd_tc_kernel, whose count must go up by one; f32:
    flash_fwd_kernel) against the plain version. Returns the max-abs error
    of out."""
    q, k, v, bias, segq, segk, causal = case
    tc = flash.TC_LAUNCHES
    out, lse = flash.flash_attention_cuda(q, k, v, bias, segq, segk, None,
                                          causal)
    torch.cuda.synchronize()
    want_tc = tc + (q.dtype == torch.bfloat16)
    if flash.TC_LAUNCHES != want_tc:
        _fail(f"flash {name}: tensor-core launches {flash.TC_LAUNCHES - tc}"
              f", want {want_tc - tc}")
    if by_head:
        ref, rlse = _flash_plain_by_head(flash, q, k, v, causal)
    else:
        ref, rlse = flash.flash_attention_reference(q, k, v, bias, segq,
                                                    segk, None, causal)
    torch.cuda.synchronize()
    if out.dtype != q.dtype or tuple(lse.shape) != tuple(q.shape[:3]):
        _fail(f"flash {name}: out {out.dtype}, lse {tuple(lse.shape)}")
    if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
        _fail(f"flash kernel output non-finite at {name}")
    err, lerr = _flash_err(out, ref), _flash_err(lse, rlse)
    abs_err = (out.float() - ref.float()).abs().max().item()
    tol, ltol = flash.TOLERANCE[q.dtype], flash.TOLERANCE[torch.float32]
    line = (f"flash {name}: err {err:.3e} (tolerance {tol}), lse err "
            f"{lerr:.3e} (tolerance {ltol}), max_abs_err {abs_err:.3e}")
    rel = None
    if q.dtype == torch.bfloat16:
        if by_head:
            ref32, _ = _flash_plain_by_head(flash, q.float(), k.float(),
                                            v.float(), causal)
        else:
            ref32, _ = flash.flash_attention_reference(
                q.float(), k.float(), v.float(), bias, segq, segk, None,
                causal)
        rel = _row_rel_err(out, ref32)
        line += (f", vs f32 plain: row max_rel_err {rel:.3e} (tolerance "
                 f"{flash.BF16_FWD_ROW_REL_TOLERANCE})")
    if name.startswith("no_visible_keys"):
        dead = q.shape[2] - k.shape[2]
        if out[:, :, :dead].abs().max().item() != 0.0 or not bool(
                (lse[:, :, :dead] == flash.NEG_INF).all()):
            _fail(f"flash {name}: rows with no visible key not exactly 0")
        line += f", {dead} rows with no visible key exactly 0"
    print(line)
    if not (err <= tol and lerr <= ltol):
        _fail(f"flash kernel disagrees with its plain version at {name}: "
              f"{err} / lse {lerr}")
    if rel is not None and not rel <= flash.BF16_FWD_ROW_REL_TOLERANCE:
        _fail(f"bf16 flash kernel disagrees with the f32 plain version at "
              f"{name}: row error {rel}")
    return abs_err


def check_flash(flash):
    """Every feature case, f32 and bf16, D 32/64/128, then the prefill
    (whose views the wrapper must take as they are), the long shape in
    bf16 and f32, and the f32 training shape (its views taken as they
    are too). Returns {case: max_abs_err}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    errs = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for d in flash.HEAD_DIMS:
            for name in FLASH_FEATURES + FLASH_FWD_EXTRA:
                key = f"{name}_d{d}_{tag}"
                case = flash_case(name, dtype, d, gen)
                if name == "misaligned" and any(
                        flash.tma_aligned(t) for t in case[:3]):
                    _fail(f"flash {key}: the views meet TMA's rule")
                errs[key] = check_one_flash(flash, key, case)
    q, k, v = prefill_views(torch.bfloat16, gen)
    if not all(flash.tma_aligned(t) for t in (q, k, v)):
        _fail("the prefill's views do not meet TMA's rule: the wrapper "
              "would copy them")
    errs["prefill_bf16"] = check_one_flash(
        flash, "prefill_bf16", (q, k, v, None, None, None, True))
    q, k, v = (_rand(LONG_SHAPE, gen, torch.bfloat16) for _ in range(3))
    errs["long_bf16"] = check_one_flash(
        flash, "long_bf16", (q, k, v, None, None, None, True), by_head=True)
    q, k, v = (_rand(LONG_SHAPE, gen) for _ in range(3))
    errs["long_f32"] = check_one_flash(
        flash, "long_f32", (q, k, v, None, None, None, True), by_head=True)
    q, k, v = prefill_views(torch.float32, gen, TRAIN_SHAPE)
    if not all(flash.tma_aligned(t) for t in (q, k, v)):
        _fail("the training step's views do not meet the 16-byte rule: the "
              "wrapper would copy them")
    errs["train_f32"] = check_one_flash(
        flash, "train_f32", (q, k, v, None, None, None, True))
    return errs


# ---------------------------------------------------------------------------
# phases 6 and 7: prompt-conditioned decoding
# ---------------------------------------------------------------------------

def make_prompts(vocab, n=PROMPTS):
    rng = np.random.default_rng(SEED + 2)
    return rng.integers(0, vocab, (n, PROMPT_LEN)).astype(np.int32)


def _launched_once(flash, cfg, what, fn, *args):
    """fn(*args) with the flash counts set to 0 just before; its bf16
    prefill must launch the tensor-core kernel once per layer, and nothing
    else. Returns (result, seconds, launches)."""
    torch.cuda.synchronize()
    flash.LAUNCHES = flash.TC_LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches, tc = flash.LAUNCHES, flash.TC_LAUNCHES
    if launches != cfg.num_layers or tc != cfg.num_layers:
        _fail(f"{what}: flash launches {launches}, tensor-core {tc}; want "
              f"{cfg.num_layers} layers each")
    return out, sec, tc


def phase_prompt_decode(flash, cfg, tree):
    """Greedy, beam and sampled prompt decoding in bf16 at full width.
    Returns the flash launches of the three calls."""
    from paddle_tpu_torch.models import gpt
    params = gpt.params_from_numpy(tree, "cuda")
    prompts = make_prompts(cfg.vocab_size)
    max_len = PROMPT_LEN + NEW_TOKENS
    bf16 = torch.bfloat16
    # the prefill alone, timed PREFILL_RUNS times (its wall is mostly the
    # host's launches, which vary from call to call): the median counts
    prefill = gpt.build_prefill(gpt._cast_params(params, bf16), cfg, max_len)
    ids = torch.from_numpy(prompts).to("cuda")
    pre_runs = []
    with torch.inference_mode():
        prefill(ids)                      # warm
        for _ in range(PREFILL_RUNS):
            (cache, logits), sec, _ = _launched_once(
                flash, cfg, "prefill", prefill, ids)
            pre_runs.append(sec)
    pre_s = float(np.median(pre_runs))
    if logits.shape != (PROMPTS, PROMPT_LEN, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        _fail(f"prefill logits {tuple(logits.shape)} non-finite or "
              f"misshapen")
    del cache, logits
    decode = gpt.make_prompt_decoder(params, cfg, PROMPT_LEN, max_len,
                                     dtype=bf16)
    (gids, gscores), dec_s, n_greedy = _launched_once(
        flash, cfg, "greedy", decode, prompts)
    beam = gpt.make_prompt_decoder(params, cfg, PROMPT_LEN, max_len,
                                   dtype=bf16, beam_size=BEAM)
    (bids, bscores), beam_s, n_beam = _launched_once(
        flash, cfg, "beam", beam, prompts[:2])
    sample = gpt.make_sampler(params, cfg, max_len, top_k=50,
                              prompt_len=PROMPT_LEN, dtype=bf16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    (sids, sscores), samp_s, n_samp = _launched_once(
        flash, cfg, "sampler", sample, prompts, gen)
    for name, x, shape in (("greedy", gids, (PROMPTS, NEW_TOKENS)),
                           ("beam", bids, (2, BEAM, NEW_TOKENS)),
                           ("sampled", sids, (PROMPTS, NEW_TOKENS))):
        if tuple(x.shape) != shape or x.min() < 0 \
                or x.max() >= cfg.vocab_size:
            _fail(f"{name} ids {tuple(x.shape)} out of shape or range")
    for name, x in (("greedy", gscores), ("beam", bscores),
                    ("sampled", sscores)):
        if not torch.isfinite(x).all():
            _fail(f"{name} scores non-finite")
    if not bool((bscores[:, :-1] >= bscores[:, 1:]).all()):
        _fail("beams are not sorted best-first")
    gen_tokens = PROMPTS * NEW_TOKENS
    out = {"prefill_ms": pre_s * 1e3,
           "prefill_ms_runs": [t * 1e3 for t in pre_runs],
           "prompt_tokens_per_s": PROMPTS * PROMPT_LEN / pre_s,
           "greedy_s": dec_s,
           "decode_tokens_per_s": gen_tokens / (dec_s - pre_s),
           "beam_s": beam_s, "sampled_s": samp_s,
           "sampled_tokens_per_s": gen_tokens / samp_s,
           "flash_launches": [n_greedy, n_beam, n_samp],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    print("prompt decode " + json.dumps(out))
    return n_greedy + n_beam + n_samp


def phase_profile_prompt(cfg, tree):
    """Where a full-width greedy prompt decode's time goes: one warm call
    of phase 6's decoder under torch.profiler. Prints the host wall, the
    device's kernel time and busy share, the flash kernel's part, and the
    device operations per decode step (after the prefill's)."""
    from torch.profiler import profile as tprofile
    from paddle_tpu_torch.models import gpt
    decode = gpt.make_prompt_decoder(gpt.params_from_numpy(tree, "cuda"),
                                     cfg, PROMPT_LEN,
                                     PROMPT_LEN + NEW_TOKENS,
                                     dtype=torch.bfloat16)
    prompts = make_prompts(cfg.vocab_size)
    decode(prompts)                       # warm
    torch.cuda.synchronize()
    with tprofile(activities=PROFILE_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        decode(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    fl = sum(e.self_device_time_total for e in kernels
             if "flash_fwd" in e.key) / 1e3
    ops = sum(e.count for e in kernels)
    top = sorted(((e.key[:80], e.self_device_time_total / 1e3)
                  for e in kernels), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall * 1e3, "device_ms": busy,
           "device_busy_share": busy / (wall * 1e3),
           "flash_ms": fl, "device_ops": ops,
           "device_ops_per_decode_step": ops / NEW_TOKENS,
           "top_kernels_ms": top}
    if busy <= 0 or fl <= 0:
        _fail("the profiler saw no device time or no flash kernel")
    print("profile prompt decode " + json.dumps(out))


def phase_agree_prefill(flash, cfg, tree):
    """The greedy prompt decoder in f32 through the flash kernel and
    through its plain version: identical first AGREE_TOKENS ids."""
    from paddle_tpu_torch.models import gpt
    params = gpt.params_from_numpy(tree, "cuda")
    prompts = make_prompts(cfg.vocab_size)
    max_len = PROMPT_LEN + AGREE_TOKENS

    def plain(q, k, v, causal, scale):
        return flash.flash_attention_reference(q, k, v, None, None, None,
                                               scale, causal)[0]

    ids = []
    for attention in (None, plain):
        decode = gpt.make_prompt_decoder(params, cfg, PROMPT_LEN, max_len,
                                         attention=attention)
        flash.LAUNCHES = flash.TC_LAUNCHES = 0
        ids.append(decode(prompts)[0].cpu().numpy())
        want = cfg.num_layers if attention is None else 0
        if flash.LAUNCHES != want or flash.TC_LAUNCHES != 0:
            _fail(f"agree prefill: {flash.LAUNCHES} flash launches "
                  f"({flash.TC_LAUNCHES} tensor-core), want {want} (0) "
                  f"in f32")
    same = int((ids[0] == ids[1]).all(axis=1).sum())
    print(f"agree prefill f32: {same}/{PROMPTS} prompts identical in their "
          f"first {AGREE_TOKENS} ids (flash kernel vs plain attention)")
    if same != PROMPTS:
        _fail("f32 flash kernel and plain attention gave different ids")


# ---------------------------------------------------------------------------
# phase 8: flash times
# ---------------------------------------------------------------------------

def flash_bound_ms(q, k, causal):
    """The larger of (bytes / memory rate) and (operations / peak): q, k,
    v read once, out and lse written once; QK^T and PV over the visible
    (query, key) pairs only (causal halves them), at q's dtype's peak."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    el = q.element_size()
    moved = (2 * b * h * tq * d + 2 * b * h * tk * d) * el + b * h * tq * 4
    rows = np.arange(tq)
    pairs = (np.clip(rows + (tk - tq) + 1, 0, tk).sum() if causal
             else tq * tk)
    flops = 4 * int(pairs) * d * b * h
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


FWD_TIME_POINTS = (("prefill", 50), ("long", 5), ("train_f32", 20),
                   ("long_f32", 3))


def phase_flash_times(flash):
    """Kernel, plain (head by head at the long shape) and SDPA ms, causal,
    beside the bound: flash_fwd_tc_kernel at the prefill shape (the
    prefill's views) and the long shape in bf16, flash_fwd_kernel at the
    training shape (the training step's views) and the long shape in
    f32."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = {}
    for name, reps in FWD_TIME_POINTS:
        by_head = name.startswith("long")
        dtype = torch.float32 if name.endswith("_f32") else torch.bfloat16
        if name == "prefill":
            q, k, v = prefill_views(dtype, gen)
        elif name == "train_f32":
            q, k, v = prefill_views(dtype, gen, TRAIN_SHAPE)
        else:
            q, k, v = (_rand(LONG_SHAPE, gen, dtype) for _ in range(3))

        def plain():
            if by_head:
                return _flash_plain_by_head(flash, q, k, v, True)
            return flash.flash_attention_reference(q, k, v, None, None,
                                                   None, None, True)

        b_ms, b_by = flash_bound_ms(q, k, True)
        rows[name] = {
            "shape": list(q.shape),
            "dtype": "f32" if dtype == torch.float32 else "bf16",
            "causal": True,
            "ms": _time_ms(lambda: flash.flash_attention_cuda(
                q, k, v, None, None, None, None, True), reps=reps),
            "plain_ms": _time_ms(plain, reps=max(2, reps // 10),
                                 warmup=1),
            "library_ms": _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), reps=reps),
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"times flash {name} " + json.dumps(rows[name]))
    return rows


# ---------------------------------------------------------------------------
# phase 1g: flash backward kernels vs plain
# ---------------------------------------------------------------------------

def _bwd_operands(flash, case, gen, with_dlse):
    """The forward kernel's out and lse on a case, a cotangent do in q's
    dtype laid out as (B, T, H, D) viewed as (B, H, T, D) (as the training
    step's autograd hands it over), and an f32 lse cotangent or None."""
    q, k, v, bias, segq, segk, causal = case
    out, lse = flash.flash_attention_cuda(q, k, v, bias, segq, segk, None,
                                          causal)
    b, h, tq, d = q.shape
    do = _rand((b, tq, h, d), gen, q.dtype).transpose(1, 2)
    dlse = _rand((b, h, tq), gen) if with_dlse else None
    return out, lse, do, dlse


def _flash_bwd_plain_by_head(flash, q, k, v, out, lse, do, dlse, causal):
    """The plain backward one head at a time (the long shape's score
    matrices of all heads at once would not fit)."""
    parts = []
    for i in range(q.shape[1]):
        hs = slice(i, i + 1)
        parts.append(flash.flash_attention_bwd_reference(
            q[:, hs], k[:, hs], v[:, hs], None, None, None, out[:, hs],
            lse[:, hs], do[:, hs], None if dlse is None else dlse[:, hs],
            None, causal))
    return tuple(torch.cat([p[j] for p in parts], 1) for j in range(4))


def check_one_flash_bwd(flash, name, case, gen, with_dlse, by_head=False):
    """dq, dk, dv of the backward kernels against the plain version on the
    same operands (element error |x - ref| / max(1, |ref|) within
    BWD_TOLERANCE; bf16 also row by row against the plain version in f64);
    dbias through the torch op with each side's delta; rows with no
    visible key exactly 0. Returns the max-abs error over dq, dk, dv."""
    q, k, v, bias, segq, segk, causal = case
    out, lse, do, dlse = _bwd_operands(flash, case, gen, with_dlse)
    got = flash.flash_attention_bwd_cuda(q, k, v, bias, segq, segk, out,
                                         lse, do, dlse, None, causal)
    torch.cuda.synchronize()
    if by_head:
        ref = _flash_bwd_plain_by_head(flash, q, k, v, out, lse, do, dlse,
                                       causal)
    else:
        ref = flash.flash_attention_bwd_reference(
            q, k, v, bias, segq, segk, out, lse, do, dlse, None, causal)
    torch.cuda.synchronize()
    tol = flash.BWD_TOLERANCE[q.dtype]
    line = [f"flash bwd {name}:"]
    errs, abs_errs, rels = [], [], []
    for tag, x, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        if x.dtype != q.dtype or x.shape != r.shape:
            _fail(f"flash bwd {name}: {tag} {x.dtype} {tuple(x.shape)}")
        if not torch.isfinite(x).all():
            _fail(f"flash bwd kernel output non-finite at {name} ({tag})")
        errs.append(_flash_err(x, r))
        abs_errs.append((x.float() - r.float()).abs().max().item())
    line.append(f"err dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} "
                f"(tolerance {tol}), max_abs_err {max(abs_errs):.3e}")
    if q.dtype == torch.bfloat16:
        # the row oracle in f64: where a row's exact gradient is 0 (a query
        # whose only visible key is the one its output copied) the plain
        # version in f32 holds the rounding difference of two summation
        # orders (dO.v by matmul, delta by sum), which no other summation
        # reproduces; in f64 both sums are exact and the row is 0
        f64 = [t.double() for t in (q, k, v, out, do)]
        if by_head:
            ref64 = _flash_bwd_plain_by_head(flash, *f64[:3], f64[3], lse,
                                             f64[4], dlse, causal)
        else:
            ref64 = flash.flash_attention_bwd_reference(
                *f64[:3], bias, segq, segk, f64[3], lse, f64[4], dlse, None,
                causal)
        rels = [_row_rel_err(x, r) for x, r in zip(got[:3], ref64[:3])]
        line.append(f"vs f64 plain: row max_rel_err {max(rels):.3e} "
                    f"(tolerance {flash.BF16_ROW_REL_TOLERANCE})")
    if bias is not None:
        dbs = [flash.flash_dbias(q, k, v, bias, lse, do, delta, None,
                                 causal, segq, segk)
               for delta in (got[3], ref[3])]
        db_err = _flash_err(dbs[0], dbs[1])
        line.append(f"dbias err {db_err:.3e}")
        errs.append(db_err)
    if name.startswith("no_visible_keys"):
        dead = q.shape[2] - k.shape[2]
        if got[0][:, :, :dead].abs().max().item() != 0.0:
            _fail(f"flash bwd {name}: dq of rows with no visible key not "
                  f"exactly 0")
        line.append(f"{dead} rows with no visible key: dq exactly 0")
    print(", ".join(line))
    if not max(errs) <= tol:
        _fail(f"flash backward kernels disagree with their plain version at "
              f"{name}: {errs}")
    if rels and not max(rels) <= flash.BF16_ROW_REL_TOLERANCE:
        _fail(f"bf16 flash backward disagrees with the f64 plain version at "
              f"{name}: row error {max(rels)}")
    return max(abs_errs)


def check_bwd_deterministic(flash, tag, qkv, gen):
    """The kernel pair run twice on the same operands gives bitwise-equal
    dq, dk and dv (each output tile is written by one block, no atomics)."""
    q, k, v = qkv
    out, lse, do, _ = _bwd_operands(flash, (q, k, v, None, None, None, True),
                                    gen, False)
    runs = [flash.flash_attention_bwd_cuda(q, k, v, None, None, None, out,
                                           lse, do, None, None, True)[:3]
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        _fail(f"flash bwd train_{tag}: two runs of the kernels differ")
    print(f"flash bwd train_{tag}: two runs bitwise equal (dq, dk, dv)")


def check_flash_bwd(flash):
    """Every feature case and the backward's own edge cases, f32 and
    bf16, D 32/64/128, with an lse cotangent on every other case, then the
    training shape (f32, bf16; each also run twice for bitwise equality)
    and T 16384 (f32). Returns {case: max_abs_err}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    errs = {}
    i = 0
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for d in flash.HEAD_DIMS:
            for name in FLASH_FEATURES + FLASH_BWD_EXTRA:
                with_dlse = i % 2 == 1
                i += 1
                key = f"{name}_d{d}_{tag}" + ("_dlse" if with_dlse else "")
                errs[key] = check_one_flash_bwd(
                    flash, key, flash_case(name, dtype, d, gen), gen,
                    with_dlse)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v = prefill_views(dtype, gen, TRAIN_SHAPE)
        errs[f"train_{tag}"] = check_one_flash_bwd(
            flash, f"train_{tag}", (q, k, v, None, None, None, True), gen,
            False)
        check_bwd_deterministic(flash, tag, (q, k, v), gen)
    q, k, v = (_rand(LONG_SHAPE, gen) for _ in range(3))
    errs["long_f32"] = check_one_flash_bwd(
        flash, "long_f32", (q, k, v, None, None, None, True), gen, True,
        by_head=True)
    return errs


# ---------------------------------------------------------------------------
# phases 9, 9b, 9c: full-width training through the Fluid entry points
# ---------------------------------------------------------------------------

def build_train():
    """bench.py's GPT training cell on the port: (cfg, main, startup,
    loss, the seeded batch of token ids)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(max_position=max(TRAIN_SEQ, 1024), dropout=0.0)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _tokens, loss, _logits = gpt.build_lm_net(cfg, seq_len=TRAIN_SEQ)
        fluid.optimizer.AdamOptimizer(1e-4).minimize(loss)
    rng = np.random.default_rng(SEED + 8)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    return cfg, main, startup, loss, toks.astype(np.int64)


def _bwd_counts(flash):
    return flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES


def _zero_counts(flash):
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKV_LAUNCHES = 0
    flash.TC_LAUNCHES = 0


def _train_run(flash, exe, main, feed, loss, steps, warm):
    """`steps` steps of main on one feed: (losses, timed step ms after
    `warm`, the set of per-step (fwd, dQ, dK/dV) launch deltas, tensor-
    core forward launches)."""
    losses, step_ms, per_step = [], [], set()
    tc0 = flash.TC_LAUNCHES
    for i in range(steps):
        before = _bwd_counts(flash)
        ts = time.perf_counter()
        # the fetch's copy to the host ends the step
        out, = exe.run(main, feed=feed, fetch_list=[loss])
        if i >= warm:
            step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
        per_step.add(tuple(a - b for a, b in zip(_bwd_counts(flash),
                                                 before)))
    return losses, step_ms, per_step, flash.TC_LAUNCHES - tc0


def phase_train(flash):
    """Train the full-width GPT for TRAIN_WARM + TRAIN_STEPS steps on one
    batch. Returns the launches of the run: the backward's (dQ + dK/dV)
    and the forward's (flash_fwd_kernel, f32)."""
    import paddle_tpu_torch as fluid
    cfg, main, startup, loss, toks = build_train()
    scope = fluid.Scope()
    exe = fluid.Executor()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        n_params = len(main.all_parameters())
        _zero_counts(flash)
        losses, step_ms, per_step, tc = _train_run(
            flash, exe, main, {"tokens": toks}, loss,
            TRAIN_WARM + TRAIN_STEPS, TRAIN_WARM)
        counts = _bwd_counts(flash)
    n = cfg.num_layers
    if per_step != {(n, n, n)} or tc != 0:
        _fail(f"train: flash launches fwd/dq/dkv per step {per_step}, want "
              f"{n} each; {tc} tensor-core, want 0 in f32")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        _fail(f"train: loss not finite and falling: {losses}")
    mean_ms = float(np.mean(step_ms))
    out = {"config": "GPTConfig(max_position=1024, dropout=0.0)",
           "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH, "params": n_params,
           "startup_s": startup_s, "steps_timed": TRAIN_STEPS,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "step_ms_mean": mean_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (mean_ms / 1e3),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "loss_first": losses[0], "loss_last": losses[-1],
           "flash_launches_fwd_dq_dkv": list(counts)}
    print("train " + json.dumps(out))
    return counts[1] + counts[2], counts[0]


def _plain_attention(q, k, v, bias=None, scale=None, causal=False,
                     segment_ids=None):
    """The dense attention of attention_ops with the segment ids as an
    additive mask bias (its CPU path), put in for the agreement runs."""
    from paddle_tpu_torch.ops import attention_ops
    from paddle_tpu_torch.ops.flash import segment_mask_bias
    if segment_ids is not None:
        seg_b = segment_mask_bias(segment_ids)
        bias = seg_b if bias is None else bias + seg_b
    return attention_ops._xla_attention(q, k, v, bias=bias, scale=scale,
                                        causal=causal)


def train_agree(flash, tag, program, feed, layers, steps):
    """`steps` f32 Adam steps of `program` (main, startup, loss) through
    the flash kernels and with the plain dense attention put in at
    attention_ops (a seam of this script only, restored after), from
    copies of one startup scope: each step's loss within TRAIN_LOSS_TOL
    and the first step's @GRADs within TRAIN_GRAD_TOL (see their
    comment). Returns ((fwd, dQ, dK/dV, bf16 fwd) launches of the kernel
    run, the errors)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_ops
    main, startup, loss = program
    exe = fluid.Executor()
    base = fluid.Scope()
    with fluid.scope_guard(base):
        exe.run(startup)
    names = [p.name for p in main.all_parameters()]

    def run():
        scope = fluid.Scope()
        for nm in base.names():
            scope.set(nm, base.get(nm).clone())
        losses = []
        with fluid.scope_guard(scope):
            for i in range(steps):
                out = exe.run(main, feed=feed, fetch_list=[loss] + (
                    [nm + "@GRAD" for nm in names] if i == 0 else []),
                    return_numpy=False)
                losses.append(out[0].double().item())
                if i == 0:
                    grads = out[1:]
        return losses, grads

    _zero_counts(flash)
    kl, kg = run()
    kernel_counts = _bwd_counts(flash)
    tc = flash.TC_LAUNCHES
    real = attention_ops.dot_product_attention
    attention_ops.dot_product_attention = _plain_attention
    try:
        _zero_counts(flash)
        pl, pg = run()
        plain_counts = _bwd_counts(flash)
    finally:
        attention_ops.dot_product_attention = real
    n = layers * steps
    if kernel_counts != (n, n, n) or plain_counts != (0, 0, 0) or tc:
        _fail(f"{tag}: launches {kernel_counts} ({tc} tensor-core) "
              f"through the kernels, {plain_counts} through the plain "
              f"attention")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
    floor = 1e-3 * max(g.abs().max().item() for g in pg)
    worst = max(((a - b).abs().max().item() / (b.abs().max().item() + floor),
                 nm) for nm, a, b in zip(names, kg, pg))
    print(f"{tag} f32: losses {kl} vs {pl} (worst rel err {loss_err:.3e}, "
          f"tolerance {TRAIN_LOSS_TOL}); {len(names)} @GRADs, worst "
          f"{worst[0]:.3e} at {worst[1]} (tolerance {TRAIN_GRAD_TOL}); "
          f"launches {kernel_counts}")
    if not (loss_err <= TRAIN_LOSS_TOL and worst[0] <= TRAIN_GRAD_TOL):
        _fail(f"{tag}: f32 steps through the kernels disagree with the "
              f"plain attention")
    return kernel_counts + (tc,), {"loss_rel_err": loss_err,
                                   "grad_rel_err": worst[0]}


def phase_train_agree(flash):
    """Phase 9b: one f32 step of the full-width GPT through the flash
    kernels and through the plain dense attention (train_agree)."""
    cfg, main, startup, loss, toks = build_train()
    train_agree(flash, "train agree", (main, startup, loss),
                {"tokens": toks}, cfg.num_layers, 1)


def _profile_train(step, steps):
    """Where a training step's time goes: torch.profiler (the device
    only) over `steps` calls of step(). The host wall and device time a
    step, the busy share, device operations a step, the flash forward's
    and backward's device time (the backward's also by kernel), their
    shares and the top kernels."""
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=PROFILE_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    dev = {e.key: e.self_device_time_total / steps / 1e3 for e in kernels}
    busy = sum(dev.values())
    fwd = sum(v for k, v in dev.items() if "flash_fwd" in k)
    dq = sum(v for k, v in dev.items() if "flash_bwd_dq" in k)
    dkv = sum(v for k, v in dev.items() if "flash_bwd_dkv" in k)
    bwd = dq + dkv
    if busy <= 0 or fwd <= 0 or bwd <= 0:
        _fail("the profiler saw no device time or no flash kernel")
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "wall_ms_per_step": wall,
            "device_ms_per_step": busy, "device_busy_share": busy / wall,
            "device_ops_per_step": sum(e.count for e in kernels) / steps,
            "flash_fwd_ms_per_step": fwd, "flash_bwd_ms_per_step": bwd,
            "flash_bwd_dq_dkv_ms_per_step": [dq, dkv],
            "flash_bwd_share_of_device": bwd / busy,
            "flash_share_of_device": (fwd + bwd) / busy,
            "top_kernels_ms_per_step": [[k[:80], v] for k, v in top]}


def phase_profile_train(flash):
    """Phase 9c: 3 warm training steps under the profiler
    (_profile_train)."""
    import paddle_tpu_torch as fluid
    _cfg, main, startup, loss, toks = build_train()
    exe = fluid.Executor()

    def step():
        exe.run(main, feed={"tokens": toks}, fetch_list=[loss])

    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        step()                                              # warm
        out = _profile_train(step, 3)
    print("profile train " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 10: flash backward times
# ---------------------------------------------------------------------------

def flash_bwd_bound_ms(q, k, causal):
    """The larger of (bytes / memory rate) and (operations / peak): q, k,
    v, out, do read once, lse read once, dq, dk, dv written once; five
    products of 2 D flops over each visible (query, key) pair (S and dP
    recomputed once, dQ, dK, dV), at q's dtype's peak."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    el = q.element_size()
    moved = (4 * b * h * tq * d + 4 * b * h * tk * d) * el + b * h * tq * 4
    rows = np.arange(tq)
    pairs = (np.clip(rows + (tk - tq) + 1, 0, tk).sum() if causal
             else tq * tk)
    flops = 5 * 2 * d * int(pairs) * b * h
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


BWD_TIME_POINTS = (("train", torch.float32, 20), ("long", torch.float32, 3),
                   ("train_bf16", torch.bfloat16, 20))


def phase_flash_bwd_times(flash):
    """Kernels (dQ, which also computes delta, + dK/dV), plain (head by
    head at the long shape) and the backward of SDPA(is_causal=True) on
    the same views, causal, at the training shape (f32 and bf16) and at
    T 16384 (f32), beside the bound (bf16's at the bf16 peak)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = {}
    for name, dtype, reps in BWD_TIME_POINTS:
        if name == "long":
            q, k, v = (_rand(LONG_SHAPE, gen) for _ in range(3))
        else:
            q, k, v = prefill_views(dtype, gen, TRAIN_SHAPE)
        case = (q, k, v, None, None, None, True)
        out, lse, do, _ = _bwd_operands(flash, case, gen, False)

        def kernel():
            return flash.flash_attention_bwd_cuda(
                q, k, v, None, None, None, out, lse, do, None, None, True)

        def plain():
            if name == "long":
                return _flash_bwd_plain_by_head(flash, q, k, v, out, lse, do,
                                                None, True)
            return flash.flash_attention_bwd_reference(
                q, k, v, None, None, None, out, lse, do, None, None, True)

        lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)

        def library():
            return torch.autograd.grad(lo, (lq, lk, lv), do,
                                       retain_graph=True)

        b_ms, b_by = flash_bwd_bound_ms(q, k, True)
        rows[name] = {
            "shape": list(q.shape),
            "dtype": "f32" if dtype == torch.float32 else "bf16",
            "causal": True,
            "ms": _time_ms(kernel, reps=reps, warmup=2),
            "plain_ms": _time_ms(plain, reps=2, warmup=1),
            "library_ms": _time_ms(library, reps=reps, warmup=2),
            "bound_ms": b_ms, "bound_by": b_by}
        del lo
        print(f"times flash bwd {name} " + json.dumps(rows[name]))
    return rows


# ---------------------------------------------------------------------------
# phases 11-13: the prefix cache, speculative decoding, decode strategies
# ---------------------------------------------------------------------------

class CaptureAttention:
    """A model's attention hook for phases 11-13: the dispatcher itself
    (so every launch counts as on the plain path), plus, once `armed`,
    a copy of one call's inputs (after `skip` more calls), taken after
    the step's KV write: what the kernel read at a shape and over tables
    that the path gave it."""

    def __init__(self):
        self.armed = False
        self.skip = 0
        self.args = None

    def arm(self, skip=0):
        self.armed, self.skip = True, skip

    def __call__(self, q, k_pool, v_pool, tables, pos, k_scale=None,
                 v_scale=None):
        from paddle_tpu_torch.serving import paged_attention
        if self.armed:
            if self.skip:
                self.skip -= 1
            else:
                self.armed = False
                scales = {} if k_scale is None else {
                    "k_scale": k_scale.clone(), "v_scale": v_scale.clone()}
                self.args = ([t.clone() for t in (q, k_pool, v_pool,
                                                  tables, pos)], scales)
        return paged_attention(q, k_pool, v_pool, tables, pos,
                               k_scale=k_scale, v_scale=v_scale)


def check_captured(paged, name, cap):
    """The kernel against its plain version on a captured call, over the
    lanes with work (an idle lane's table is all NULL: the plain version
    gathers the NULL block there, the kernel reads nothing). Returns the
    max abs error."""
    if cap.args is None:
        _fail(f"{name}: no attention call was captured")
    args, scales = cap.args
    out = paged.paged_attention_cuda(*args, **scales)
    ref = paged.paged_attention_reference(*args, **scales)
    torch.cuda.synchronize()
    live = args[3][:, 0] != paged.NULL_BLOCK
    err = (out[live].float() - ref[live].float()).abs().max().item()
    tol = paged.TOLERANCE[out.dtype]
    q, tables = args[0], args[3]
    shared = int((torch.bincount(tables[live].flatten().long())[1:] > 1)
                 .sum().item())
    print(f"kernel {name}: q {tuple(q.shape)} {str(q.dtype)[6:]}, D "
          f"{q.shape[-1]}, {int(live.sum())} lanes, {shared} blocks in "
          f"two or more lanes' tables: max_abs_err {err:.3e} (tolerance "
          f"{tol})")
    if not torch.isfinite(out[live]).all() or not err <= tol:
        _fail(f"kernel disagrees with its plain version at {name}: {err}")
    cap.args = None
    return err


def _serving_model(cfg, tree, dtype=None):
    """A serving model on the card whose attention is a CaptureAttention
    (returned beside it)."""
    cap = CaptureAttention()
    return make_model(cfg, tree, dtype, attention=cap), cap


def _pump(paged, srv, arm=None, cap=None, skip=0):
    """Step `srv` until idle with the paged launch count set to 0 just
    before; arm `cap` before the first step at which arm(srv) holds.
    Returns (wall s, iterations, launches, per-step host ms)."""
    it0 = srv.get_stats()["iterations"]
    torch.cuda.synchronize()
    paged.LAUNCHES = 0
    t0 = time.perf_counter()
    step_ms = []
    while True:
        if cap is not None and arm is not None and cap.args is None \
                and not cap.armed and arm(srv):
            cap.arm(skip)
        ts = time.perf_counter()
        if not srv.step():
            break
        step_ms.append((time.perf_counter() - ts) * 1e3)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, srv.get_stats()["iterations"] - it0,
            paged.LAUNCHES, step_ms)


def _count_allocations(srv):
    """Wrap the server's block allocator to count the blocks it hands
    out (bench.py's blocks-per-request measure)."""
    counter = {"blocks": 0}
    real = srv.cache.allocate

    def counting_allocate(n):
        got = real(n)
        if got is not None:
            counter["blocks"] += len(got)
        return got

    srv.cache.allocate = counting_allocate
    return counter


def _lanes_sharing(srv):
    """True when two of the server's active lanes hold one block."""
    seen = set()
    for slot in srv._sched._slots:
        if slot is None or slot.hold:
            continue
        mine = {int(b) for b in slot.table if b}
        if seen & mine:
            return True
        seen |= mine
    return False


def prefix_requests(vocab):
    """bench.py's prefix-cache traffic at this width: PREFIX_REQUESTS
    requests, 80 % a tenant system prompt (384, 256 or 512 tokens) plus a
    random 1-64 token suffix, the rest random prompts of 64-512 tokens."""
    rng = np.random.default_rng(SEED + 11)
    tenants = [rng.integers(3, vocab, n).astype(np.int32)
               for n in TENANT_LENS]
    reqs = []
    for _ in range(PREFIX_REQUESTS):
        if rng.random() < 0.8:
            t = tenants[int(rng.integers(len(tenants)))]
            sfx = rng.integers(3, vocab, int(rng.integers(1, 65)))
            reqs.append(np.concatenate([t, sfx]).astype(np.int32))
        else:
            reqs.append(rng.integers(3, vocab, int(rng.integers(64, 513)))
                        .astype(np.int32))
    return reqs


def _serve_pass(paged, srv, prompts, new_tokens, counter=None, arm=None,
                cap=None, **submit):
    """Submit every prompt and pump until idle; the launch gate: one
    launch a layer a step. Returns (ids, wall s, iterations, blocks)."""
    if counter is not None:
        counter["blocks"] = 0
    futs = [srv.submit(p, max_new_tokens=new_tokens, **submit)
            for p in prompts]
    wall, iters, launches, _ = _pump(paged, srv, arm, cap)
    want = iters * srv.model.num_layers
    if launches != want:
        _fail(f"paged launches {launches} != iterations {iters} x "
              f"{srv.model.num_layers} layers")
    ids = [list(f.result(timeout=0).token_ids) for f in futs]
    return ids, wall, iters, counter["blocks"] if counter else None


def phase_prefix(paged, cfg, tree):
    """Phase 11: bench.py's prefix traffic through a prefix-cache server
    and a no-share server at full width. f32: the prefix server's cold
    and warm passes give the no-share ids; fewer blocks allocated per
    request; hit rate > 0; at least one copy-on-write; launches =
    iterations x layers; the kernel against its plain version on a step
    whose lanes share blocks. bf16: tokens/s of the warm prefix pass and
    the no-share pass. Returns the launches of the f32 warm pass."""
    from paddle_tpu_torch.serving import GenerationServer
    prompts = prefix_requests(cfg.vocab_size)
    out, errs = {}, {}

    def server(model, prefix):
        return GenerationServer(model, num_slots=16, block_size=16,
                                max_context=1024, chunk=CHUNK, start=False,
                                prefix_cache=prefix)

    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model, cap = _serving_model(cfg, tree, dtype)
        plain = server(model, False)
        plain_ctr = _count_allocations(plain)
        ids0, wall0, it0, blocks0 = _serve_pass(paged, plain, prompts,
                                                PREFIX_NEW, plain_ctr)
        del plain
        share = server(model, True)
        ctr = _count_allocations(share)
        ids1, wall1, it1, blocks1 = _serve_pass(paged, share, prompts,
                                                PREFIX_NEW, ctr)
        ids2, wall2, it2, blocks2 = _serve_pass(
            paged, share, prompts, PREFIX_NEW, ctr, _lanes_sharing, cap)
        errs[f"prefix_warm_{tag}"] = check_captured(
            paged, f"prefix warm pass {tag}", cap)
        st = share.get_stats()
        pf = st["prefix"]
        gen = PREFIX_REQUESTS * PREFIX_NEW
        row = {"noshare_tokens_per_s": gen / wall0,
               "prefix_cold_tokens_per_s": gen / wall1,
               "prefix_warm_tokens_per_s": gen / wall2,
               "iterations": {"noshare": it0, "prefix_cold": it1,
                              "prefix_warm": it2},
               "launches_warm": it2 * cfg.num_layers,
               "blocks_per_request": {"noshare": blocks0 / PREFIX_REQUESTS,
                                      "prefix_cold":
                                      blocks1 / PREFIX_REQUESTS,
                                      "prefix_warm":
                                      blocks2 / PREFIX_REQUESTS},
               "blocks_per_request_ratio_noshare_over_warm":
                   blocks0 / max(blocks2, 1),
               "hit_rate": pf["hits"] / max(pf["hits"] + pf["misses"], 1),
               "prefix": pf, "cow_copies": share.cache.cow_copies,
               "ids_equal_noshare": ids1 == ids0 and ids2 == ids0}
        out[tag] = row
        print(f"prefix {tag} " + json.dumps(row))
        if st["blocks_free"] + pf["entries"] != st["blocks_total"]:
            _fail(f"prefix {tag}: blocks not reclaimed: {st}")
        if tag == "f32":
            if not row["ids_equal_noshare"]:
                same = sum(a == b for a, b in zip(ids0, ids2))
                _fail(f"prefix f32: ids differ from the no-share server "
                      f"({same}/{PREFIX_REQUESTS} warm requests equal)")
            if not blocks2 < blocks0:
                _fail(f"prefix f32: {blocks2} blocks allocated warm, "
                      f"{blocks0} without sharing")
            if not pf["hits"] > 0 or not share.cache.cow_copies >= 1:
                _fail(f"prefix f32: hits {pf['hits']}, copies "
                      f"{share.cache.cow_copies}")
        del share, model
        torch.cuda.empty_cache()
    return out, errs


def spec_requests(vocab):
    rng = np.random.default_rng(SEED + 12)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in rng.integers(16, 257, SPEC_REQUESTS)]


def phase_spec(paged, cfg, tree):
    """Phase 12: speculative decoding on GPTConfig(), k = SPEC_K, chunk
    16, in f32: (a) the target as its own draft: ids of the plain
    server, accept rate 1.0, fewer iterations; (b) a small draft at head
    dim 32 (SPEC_DRAFT_CFG): ids of the plain server; rejection mode
    gives the same ids on two runs with one seed. Launches: the target
    iterations x its layers, the draft iterations x k x its layers. The
    kernel against its plain version on a verify step (decode lanes with
    several columns) and on a draft rollout (C = 1, D 32). Then bf16
    tokens/s of the plain server and of (b). Returns the launches of the
    target and of the draft in (b)'s f32 run."""
    from paddle_tpu_torch.models.gpt import GPTConfig, init_params
    from paddle_tpu_torch.serving import GenerationServer, SpecDecodeConfig
    dcfg = GPTConfig(vocab_size=cfg.vocab_size,
                     max_position=cfg.max_position, **SPEC_DRAFT_CFG)
    dtree = init_params(dcfg, seed=SEED + 1)
    prompts = spec_requests(cfg.vocab_size)
    errs, out = {}, {}

    def verifying(srv):
        return any(s is not None and not s.prefilling
                   and s.req.max_new_tokens - len(s.req.generated) > SPEC_K
                   for s in srv._sched._slots)

    def run(dtype, draft, mode="greedy", arm=False):
        model, cap = _serving_model(cfg, tree, dtype)
        spec = None
        dcap = None
        if draft is not None:
            dm_cfg, dm_tree = draft
            dmodel, dcap = _serving_model(dm_cfg, dm_tree, dtype)
            spec = SpecDecodeConfig(dmodel, k=SPEC_K, mode=mode,
                                    seed=SEED)
        srv = GenerationServer(model, num_slots=16, block_size=16,
                               max_context=1024, chunk=CHUNK, start=False,
                               spec=spec)
        futs = [srv.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
        caps = [c for c in (cap, dcap) if c is not None]

        def arm_all(s):
            if arm and verifying(s):
                if dcap is not None:
                    # the draft's sync pass calls each layer once, then
                    # the first rollout (C = 1) calls layer 0
                    dcap.arm(skip=dm_cfg.num_layers)
                return True
            return False

        wall, iters, launches, _ = _pump(paged, srv, arm_all, cap)
        st = srv.get_stats()
        ids = [list(f.result(timeout=0).token_ids) for f in futs]
        draft_launches = st["spec"]["draft_launches"] if spec else 0
        target = launches - draft_launches
        if target != iters * cfg.num_layers:
            _fail(f"spec: target launches {target} != iterations {iters} "
                  f"x {cfg.num_layers}")
        if spec and draft_launches != iters * SPEC_K * dm_cfg.num_layers:
            _fail(f"spec: draft launches {draft_launches} != iterations "
                  f"{iters} x k {SPEC_K} x {dm_cfg.num_layers} layers")
        if st["blocks_free"] != st["blocks_total"]:
            _fail(f"spec: blocks not reclaimed: {st}")
        row = {"iterations": iters, "wall_s": wall,
               "tokens_per_s": SPEC_REQUESTS * SPEC_NEW / wall,
               "target_launches": target, "draft_launches": draft_launches,
               "spec": st["spec"]}
        return ids, row, caps

    plain_ids, row, _ = run(None, None)
    out["plain_f32"] = row
    self_ids, row, caps = run(None, (cfg, tree), arm=True)
    out["self_draft_f32"] = row
    errs["spec_verify_f32"] = check_captured(paged, "spec verify step f32",
                                             caps[0])
    if row["spec"]["accept_rate"] != 1.0 or self_ids != plain_ids \
            or not row["iterations"] < out["plain_f32"]["iterations"]:
        _fail(f"spec (a): accept rate {row['spec']['accept_rate']}, ids "
              f"equal {self_ids == plain_ids}, iterations "
              f"{row['iterations']} vs {out['plain_f32']['iterations']}")
    small_ids, row, caps = run(None, (dcfg, dtree), arm=True)
    out["small_draft_f32"] = row
    errs["spec_verify_small_f32"] = check_captured(
        paged, "spec verify step, small draft, f32", caps[0])
    errs["spec_draft_d32_f32"] = check_captured(
        paged, "spec draft rollout D 32 f32", caps[1])
    if small_ids != plain_ids:
        same = sum(a == b for a, b in zip(small_ids, plain_ids))
        _fail(f"spec (b): {same}/{SPEC_REQUESTS} requests equal the plain "
              f"server's ids")
    rej = [run(None, (dcfg, dtree), mode="rejection")[0:2]
           for _ in range(2)]
    out["rejection_f32"] = rej[0][1]
    if rej[0][0] != rej[1][0]:
        _fail("spec rejection mode: two runs with one seed differ")
    _, out["plain_bf16"], _ = run(torch.bfloat16, None)
    _, out["small_draft_bf16"], _ = run(torch.bfloat16, (dcfg, dtree))
    for k, v in out.items():
        print(f"spec {k} " + json.dumps(v))
    return out, errs


def synthetic_vocab(n):
    """A seeded n-entry string vocabulary of 1-3 characters over digits,
    letters and JSON punctuation; id 1 is the eos id."""
    rng = np.random.default_rng(SEED + 13)
    alphabet = np.array(list('0123456789abcdefghijklmnopqrstuvwxyz'
                             '{}[]":,.-@ '))
    return ["".join(rng.choice(alphabet, int(rng.integers(1, 4))))
            for _ in range(n)]


def _conforms(constraint, ids, eos):
    state = constraint.initial_state()
    for t in ids:
        if int(t) == eos:
            return (constraint.accepting(state)
                    or not constraint.allowed_tokens(state).any())
        state = constraint.advance(state, int(t))
        if state is None:
            return False
    return True


def _dense_beam(cfg, tree, prompt, n_new, eos):
    """The dense reference beam (inference.decoding.beam_decode over
    build_kv_step, prompt teacher-forced into a K-tiled cache) in f32 on
    the card."""
    from paddle_tpu_torch.inference import decoding as dec
    from paddle_tpu_torch.models import gpt
    params = gpt.params_from_numpy(tree, "cuda")
    max_len = len(prompt) + n_new
    d = cfg.hidden_size // cfg.num_heads
    step = gpt.build_kv_step(params, cfg, max_len)
    cache = dec.init_kv_cache(BEAM, cfg.num_layers, cfg.num_heads, max_len,
                              d, device="cuda")
    with torch.inference_mode():
        for t, tok in enumerate(prompt[:-1]):
            _, cache = step(torch.full((BEAM,), int(tok), device="cuda"),
                            cache, t)
        ids, norm = dec.beam_decode(
            step, cache, torch.tensor([int(prompt[-1])], device="cuda"),
            n_new, BEAM, eos, start_t=len(prompt) - 1)
    return ids[0].cpu().numpy(), norm[0].cpu().numpy()


def _profile_steps(srv, steps):
    """torch.profiler over `steps` steps of srv: host wall and device
    kernel time per step."""
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=PROFILE_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        n = 0
        while n < steps and srv.step():
            n += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type.name == "CUDA") / 1e3
    if n == 0 or dev <= 0:
        _fail("the profiler saw no steps or no device time")
    return {"steps": n, "wall_ms_per_step": wall / n * 1e3,
            "device_ms_per_step": dev / n,
            "device_busy_share": dev / (wall * 1e3)}


def phase_strategies(paged, cfg, tree):
    """Phase 13 at full width: n = 4 sampled fork groups (bf16): one
    prefill a group and a peak block footprint below the same lanes as
    separate requests; beam K 4 with an eos id (f32): ids of the dense
    beam; regex and JSON constraints over a seeded 32000-entry string
    vocabulary (bf16), one of them an n = 2 group: every output
    conforms; cancel and deadline on groups: every block comes back. The
    beam again under greedy speculation (the target as its own draft, k
    SPEC_K): the same ids. Launches = iterations x layers in each run
    (and the draft's iterations x k x layers); the kernel against its
    plain version on the first step after the forks of each beam run
    (lanes sharing the prompt's blocks; under speculation, verify columns
    written into the block the first decode write copied);
    wall and device ms a step of the group and beam runs (the (S, V)
    logp rows cross to the host at a group's fork and at every beam
    step). Returns {run: launches}."""
    from paddle_tpu_torch.serving import (BeamParams, DeadlineExceeded,
                                          GenerationServer, JsonConstraint,
                                          RegexConstraint, RequestCancelled,
                                          SamplingParams, SpecDecodeConfig)
    rng = np.random.default_rng(SEED + 14)
    out, errs, launches = {}, {}, {}

    def server(model, **kw):
        kw.setdefault("max_context", 1024)
        return GenerationServer(model, num_slots=16, block_size=16,
                                chunk=CHUNK, start=False, **kw)

    # -- fork groups --------------------------------------------------------
    model, cap = _serving_model(cfg, tree, torch.bfloat16)
    prompts = [rng.integers(3, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(256, 513, GROUPS)]
    peaks = {}
    for tag in ("group", "separate"):
        srv = server(model)
        if tag == "group":
            futs = [srv.submit(p, max_new_tokens=GROUP_NEW, n=4,
                               sampling=SamplingParams(
                                   n=4, temperature=0.8, top_k=50,
                                   seed=SEED + i))
                    for i, p in enumerate(prompts)]
        else:
            futs = [srv.submit(p, max_new_tokens=GROUP_NEW,
                               sampling=SamplingParams(
                                   temperature=0.8, top_k=50, seed=SEED + i))
                    for i, p in enumerate(prompts) for _ in range(4)]
        paged.LAUNCHES = 0
        it0 = srv.get_stats()["iterations"]
        peak = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while srv.step():
            peak = max(peak, srv.cache.num_used)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.get_stats()
        iters = st["iterations"] - it0
        if paged.LAUNCHES != iters * cfg.num_layers:
            _fail(f"groups {tag}: launches {paged.LAUNCHES} != "
                  f"{iters} x {cfg.num_layers}")
        launches[f"13 fork groups {tag}"] = paged.LAUNCHES
        if st["blocks_free"] != st["blocks_total"]:
            _fail(f"groups {tag}: blocks not reclaimed")
        peaks[tag] = peak
        res = [f.result(timeout=0) for f in futs]
        if tag == "group":
            lanes = [len(r.lanes) for r in res]
            if lanes != [4] * GROUPS or st["group.forks"] != 3 * GROUPS \
                    or st["prefill_tokens"] != sum(map(len, prompts)):
                _fail(f"groups: lanes {lanes}, stats {st}")
            out["groups"] = {"groups": GROUPS, "lanes": 4 * GROUPS,
                             "iterations": iters, "wall_s": wall,
                             "tokens_per_s": 4 * GROUPS * GROUP_NEW / wall,
                             "prefill_tokens": st["prefill_tokens"],
                             "cow_copies": st["group.cow_copies"]}
        else:
            out["separate"] = {"requests": 4 * GROUPS, "iterations": iters,
                               "wall_s": wall,
                               "tokens_per_s": 4 * GROUPS * GROUP_NEW / wall,
                               "prefill_tokens": st["prefill_tokens"]}
    out["peak_blocks"] = peaks
    if not peaks["group"] < peaks["separate"]:
        _fail(f"fork groups peak at {peaks['group']} blocks, separate "
              f"requests at {peaks['separate']}")
    # the groups again, traced over 8 steps once every lane decodes
    srv = server(model)
    for i, p in enumerate(prompts):
        srv.submit(p, max_new_tokens=GROUP_NEW, n=4,
                   sampling=SamplingParams(n=4, temperature=0.8, top_k=50,
                                           seed=SEED + i))
    while True:
        busy = [s for s in srv._sched._slots if s is not None]
        if busy and all(not s.prefilling and not s.hold for s in busy):
            break
        srv.step()
    out["groups"]["decode_steps"] = _profile_steps(srv, 8)
    srv.close(drain=False)
    del model

    # -- beam, plain and under greedy speculation ----------------------------
    # the prompts end inside a block, which the K lanes share after the
    # fork: the first decode write copies it (and a verify step then
    # writes several columns into the copy)
    bprompts = [rng.integers(3, cfg.vocab_size, BEAM_PROMPT)
                .astype(np.int32) for _ in range(2)]
    eos = []
    dense = []
    for p in bprompts:
        probe, _ = _dense_beam(cfg, tree, p, BEAM_NEW, eos=0)
        e = int(probe[0, 2])
        eos.append(e)
        dense.append(_dense_beam(cfg, tree, p, BEAM_NEW, e))
    for tag in ("beam", "beam_spec"):
        model, cap = _serving_model(cfg, tree)
        spec = None
        if tag == "beam_spec":
            spec = SpecDecodeConfig(make_model(cfg, tree), k=SPEC_K)
        srv = server(model, max_context=BEAM_PROMPT + BEAM_NEW, spec=spec)
        futs = [srv.submit(p, max_new_tokens=BEAM_NEW, eos_id=e,
                           beam=BeamParams(BEAM))
                for p, e in zip(bprompts, eos)]
        paged.LAUNCHES = 0
        it0 = srv.get_stats()["iterations"]
        prof = None
        while True:
            if cap.args is None and not cap.armed and _lanes_sharing(srv) \
                    and all(s is None or not s.prefilling
                            for s in srv._sched._slots):
                # the first step after the forks
                cap.arm()
                if not srv.step():
                    break
                if spec is None:
                    prof = _profile_steps(srv, 4)
                continue
            if not srv.step():
                break
        st = srv.get_stats()
        iters = st["iterations"] - it0
        draft = st["spec"]["draft_launches"] if spec else 0
        if paged.LAUNCHES - draft != iters * cfg.num_layers or \
                draft != iters * (SPEC_K if spec else 0) * cfg.num_layers:
            _fail(f"{tag}: launches {paged.LAUNCHES} ({draft} draft) for "
                  f"{iters} iterations x {cfg.num_layers} layers")
        launches[f"13 {tag}"] = paged.LAUNCHES
        errs[f"{tag}_f32"] = check_captured(paged, f"{tag} step f32", cap)
        score_err = 0.0
        for f, (ids, norm) in zip(futs, dense):
            hyps = f.result(timeout=0).hypotheses
            got = np.stack([np.asarray(h.token_ids, np.int64)
                            for h in hyps])
            if not np.array_equal(got, ids):
                _fail(f"{tag} ids {got.tolist()} != dense {ids.tolist()}")
            score_err = max(score_err, float(np.abs(
                np.array([h.norm_score for h in hyps]) - norm).max()))
        if st["blocks_free"] != st["blocks_total"]:
            _fail(f"{tag}: blocks not reclaimed")
        out[tag] = {"groups": 2, "beam": BEAM, "new_tokens": BEAM_NEW,
                    "prompt": BEAM_PROMPT, "eos": eos, "iterations": iters,
                    "reorders": st["beam.reorders"],
                    "group_cow_copies": st["group.cow_copies"],
                    "norm_score_max_abs_diff_vs_dense": score_err,
                    "spec": st["spec"], "steps": prof}
        del model, srv

    # -- guided -------------------------------------------------------------
    vocab = synthetic_vocab(cfg.vocab_size)
    geos = 1
    model, cap = _serving_model(cfg, tree, torch.bfloat16)
    srv = server(model)
    t0 = time.perf_counter()
    regex = RegexConstraint(GUIDED_REGEX, vocab)
    json_c = JsonConstraint(vocab)
    gp = [rng.integers(3, cfg.vocab_size, 64).astype(np.int32)
          for _ in range(3)]
    fr = srv.submit(gp[0], max_new_tokens=GUIDED_NEW, eos_id=geos,
                    guided=regex)
    fj = srv.submit(gp[1], max_new_tokens=GUIDED_NEW, eos_id=geos,
                    guided=json_c)
    fg = srv.submit(gp[2], max_new_tokens=GUIDED_NEW, eos_id=geos, n=2,
                    sampling=SamplingParams(n=2, temperature=1.0,
                                            seed=SEED),
                    guided=json_c)
    wall, iters, n_launch, _ = _pump(paged, srv)
    if n_launch != iters * cfg.num_layers:
        _fail(f"guided: launches {n_launch} != {iters} x {cfg.num_layers}")
    launches["13 guided"] = n_launch
    outs = {"regex": [list(fr.result(timeout=0).token_ids)],
            "json": [list(fj.result(timeout=0).token_ids)],
            "json_n2": [list(r.token_ids)
                        for r in fg.result(timeout=0).lanes]}
    for name, ids_list in outs.items():
        c = regex if name == "regex" else json_c
        for ids in ids_list:
            if not ids or not _conforms(c, ids, geos):
                _fail(f"guided {name}: {ids} does not conform")
    st = srv.get_stats()
    if st["guided.violations"] != 0 or \
            st["blocks_free"] != st["blocks_total"]:
        _fail(f"guided: {st}")
    out["guided"] = {"regex": GUIDED_REGEX,
                     "texts": {k: ["".join(vocab[t] for t in ids
                                           if t != geos) for ids in v]
                               for k, v in outs.items()},
                     "masked_steps": st["guided.masked_steps"],
                     "iterations": iters, "wall_s": time.perf_counter() - t0}

    # -- cancel and deadline ------------------------------------------------
    now = [0.0]
    srv = server(model, clock=lambda: now[0])
    fc = srv.submit(prompts[0], max_new_tokens=GROUP_NEW, n=4)
    fd = srv.submit(prompts[1], max_new_tokens=GROUP_NEW, eos_id=geos,
                    beam=BeamParams(BEAM), deadline_ms=2000)
    for i in range(200):
        now[0] += 0.1
        if i == 3 and not fc.cancel():
            _fail("group cancel refused")
        if not srv.step():
            break
    st = srv.get_stats()
    if not isinstance(fc.exception(timeout=0), RequestCancelled) \
            or not isinstance(fd.exception(timeout=0), DeadlineExceeded):
        _fail(f"cancel/deadline: {fc}, {fd}")
    if st["blocks_free"] != st["blocks_total"] or st["active_slots"]:
        _fail(f"cancel/deadline: blocks not reclaimed: {st}")
    out["cancel_deadline"] = {"cancelled": st["cancelled"],
                              "deadline_cancels": st["deadline_cancels"],
                              "blocks_free": st["blocks_free"]}
    for k, v in out.items():
        print(f"strategies {k} " + json.dumps(v))
    return out, errs, launches


# ---------------------------------------------------------------------------
# phases 14-15: the host KV tier; telemetry, chaos and the HBM ledger
# ---------------------------------------------------------------------------

def tier_server(model, num_blocks, host_blocks=0, **kw):
    """Phase 14's server: phase 2's geometry (16 slots, block 16, chunk
    16, context 1024) over `num_blocks` device blocks, with a host tier
    of `host_blocks` when given."""
    from paddle_tpu_torch.serving import GenerationServer
    return GenerationServer(model, num_slots=16, block_size=16,
                            max_context=1024, chunk=CHUNK, start=False,
                            num_blocks=num_blocks,
                            host_kv_blocks=host_blocks, **kw)


def _tier_pass(paged, srv, prompts, new_tokens, cap=None, on_step=None):
    """Submit `prompts` greedy and pump until idle with the paged launch
    count set to 0 just before (the gate: launches = iterations x
    layers); arm `cap` at the first step with a resumed (swapped-in)
    lane. Returns the ids and the run's numbers."""
    futs = [srv.submit(p, max_new_tokens=new_tokens) for p in prompts]
    it0 = srv.get_stats()["iterations"]
    torch.cuda.synchronize()
    paged.LAUNCHES = 0
    active, step_ms = [], []
    t0 = time.perf_counter()
    while True:
        sched = srv._sched
        if cap is not None and cap.args is None and not cap.armed and any(
                s is not None and s.tier == "host" and not s.prefilling
                for s in sched._slots):
            cap.arm()
        if on_step is not None:
            on_step(srv)
        ts = time.perf_counter()
        if not srv.step():
            break
        step_ms.append((time.perf_counter() - ts) * 1e3)
        active.append(sched.active_count)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = srv.get_stats()
    iters = st["iterations"] - it0
    if paged.LAUNCHES != iters * srv.model.num_layers:
        _fail(f"tier pass: paged launches {paged.LAUNCHES} != iterations "
              f"{iters} x {srv.model.num_layers}")
    ids = [list(f.result(timeout=0).token_ids) for f in futs]
    if any(len(i) != new_tokens for i in ids):
        _fail("tier pass: a request ended early")
    cached = st["prefix"]["evictable"] if st["prefix"] else 0
    if st["blocks_free"] + cached != st["blocks_total"]:
        _fail(f"tier pass: blocks not returned: {st['blocks_free']} free "
              f"+ {cached} idle cached of {st['blocks_total']}")
    kt = st["kv_tier"]
    out = {"iterations": iters, "launches": paged.LAUNCHES,
           "wall_s": wall, "tokens_per_s": len(prompts) * new_tokens / wall,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "peak_lanes": max(active), "mean_lanes": float(np.mean(active)),
           "preempts": st["preempts"], "resumes": st["resumes"],
           "spills": kt["spills"] if kt else 0,
           "swap_ins": kt["swap_ins"] if kt else 0,
           "host_blocks_used": kt["host_blocks_used"] if kt else None}
    return ids, out


def _check_round_trips(srv):
    """Wrap the server's spill and swap-in so that every block spilled
    is copied on the device first and held, after its swap-in, against
    the rows that arrived (torch.equal: bitwise). Returns a dict the
    wrappers fill: blocks checked, mismatches."""
    cache = srv.cache
    spill, swap = cache.spill_block, cache.swap_in_block
    out = {"checked": 0, "mismatched": 0}
    kept = {}

    def rows(block):
        return [t[block] for h in cache._holders() for layer in h.pools
                for t in layer.values()]

    def checking_spill(block):
        before = [r.clone() for r in rows(block)]
        hb = spill(block)
        if hb is not None:
            kept[hb] = before
        return hb

    def checking_swap(hb, dst):
        swap(hb, dst)
        torch.cuda.synchronize()
        want = kept.pop(int(hb))
        out["checked"] += 1
        if not all(torch.equal(a, b) for a, b in zip(rows(dst), want)):
            out["mismatched"] += 1

    cache.spill_block, cache.swap_in_block = checking_spill, checking_swap
    return out


def _tier_copy_times(srv, n=64):
    """µs per block spilled (device to pinned host, the call returns
    with the rows landed) and per block swapped in (host to device on
    the stream; timed to the device's completion), over `n` blocks of
    the server's cache, each call bracketed by synchronizes. A block is
    every layer's k and v rows: 2 x layers small copies."""
    cache = srv.cache
    blocks = cache.allocate(min(n, cache.num_free, cache.host.num_free))
    torch.cuda.synchronize()
    spill_s, hbs = [], []
    for b in blocks:
        t0 = time.perf_counter()
        hbs.append(cache.spill_block(b))
        spill_s.append(time.perf_counter() - t0)
    swap_s = []
    for hb, b in zip(hbs, blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache.swap_in_block(hb, b)
        torch.cuda.synchronize()
        swap_s.append(time.perf_counter() - t0)
    cache.host.free(hbs)
    cache.free(blocks)
    nbytes = cache.pool_bytes() // cache.num_blocks
    spill_us = float(np.median(spill_s)) * 1e6
    swap_us = float(np.median(swap_s)) * 1e6
    return {"block_bytes": nbytes, "copies_per_block":
            sum(len(layer) for layer in cache.pools),
            "spill_us_per_block": spill_us,
            "swap_in_us_per_block": swap_us,
            "spill_gb_per_s": nbytes / spill_us / 1e3,
            "swap_in_gb_per_s": nbytes / swap_us / 1e3,
            "host_link_gb_per_s": HOST_LINK_BYTES_PER_S / 1e9}


def phase_tier(paged, cfg, tree):
    """Phase 14: the host KV tier at full width, GPTConfig() with 16
    slots over TIER_BLOCKS device blocks (a quarter of phase 2's 1025)
    and TIER_HOST_BLOCKS host blocks; phase 2's prompts, greedy,
    TIER_NEW new tokens. f32 gate on the first TIER_GATE requests: the
    tiered server gives the ids of the same server without a tier and of
    phase 2's full pool, preempts at least once and resumes every
    preempted request, returns every device and host block; a chaos
    preemption of a named request gives the same ids; a prefix server
    whose chain chaos spilled serves the next hit from the host tier
    (swap-ins) with the same ids; the kernel agrees with its plain
    version on a step whose tables hold swapped-in blocks. bf16: the 32
    requests with and without the tier at TIER_BLOCKS (lanes, steps,
    tokens/s, tier traffic) and the copy times of spill and swap-in.
    Returns (numbers, {path: launches}, {path: max_abs_err})."""
    from paddle_tpu_torch.robustness import ChaosInjector
    prompts = [p for p, _s in make_requests(cfg.vocab_size)]
    gate = prompts[:TIER_GATE]
    out, launches, errs = {}, {}, {}
    model32, cap = _serving_model(cfg, tree)
    full_ids, out["f32_full_pool"] = _tier_pass(
        paged, tier_server(model32, 1025), gate, TIER_NEW)
    plain_ids, out["f32_no_tier"] = _tier_pass(
        paged, tier_server(model32, TIER_BLOCKS), gate, TIER_NEW)
    tiered = tier_server(model32, TIER_BLOCKS, TIER_HOST_BLOCKS)
    trips = _check_round_trips(tiered)
    tier_ids, out["f32_tier"] = _tier_pass(paged, tiered, gate, TIER_NEW,
                                           cap=cap)
    launches["14 tier f32"] = out["f32_tier"]["launches"]
    t = out["f32_tier"]
    t["round_trips"] = trips
    if trips["mismatched"] or trips["checked"] != t["swap_ins"]:
        _fail(f"phase 14: spill/swap-in round trips {trips} over "
              f"{t['swap_ins']} swap-ins")
    if tier_ids != plain_ids or tier_ids != full_ids:
        _fail("phase 14: the tiered server's f32 ids differ from the "
              "untiered and the full-pool server's")
    if t["preempts"] < 1 or t["resumes"] != t["preempts"] \
            or t["host_blocks_used"] != 0:
        _fail(f"phase 14: tier traffic {t}")
    errs["tier_swapped_in_f32"] = check_captured(
        paged, "tier f32, a resumed lane's swapped-in blocks", cap)
    # a chaos preemption of a named decode lane
    chaos = ChaosInjector()
    srv = tier_server(model32, TIER_BLOCKS, TIER_HOST_BLOCKS, chaos=chaos)
    planned = []

    def plan_preempt(srv):
        if planned:
            return
        for slot in srv._sched._slots:
            if slot is not None and not slot.prefilling \
                    and len(slot.req.generated) >= 8:
                chaos.preempt_request_at(srv._sched.iteration + 1,
                                         slot.req.rid)
                planned.append(slot.req.rid)
                return

    chaos_ids, out["f32_chaos_preempt"] = _tier_pass(
        paged, srv, gate, TIER_NEW, on_step=plan_preempt)
    if chaos.fired["preempt"] != 1 or chaos_ids != full_ids:
        _fail(f"phase 14: chaos preemption of request {planned}: fired "
              f"{chaos.fired['preempt']}, ids equal "
              f"{chaos_ids == full_ids}")
    out["f32_chaos_preempt"]["request"] = planned[0]
    # a prefix chain spilled by chaos, then hit from the host tier
    chaos = ChaosInjector()
    srv = tier_server(model32, TIER_BLOCKS, TIER_HOST_BLOCKS, chaos=chaos,
                      prefix_cache=True)
    hot = gate[:4]
    first, _ = _tier_pass(paged, srv, hot, 16)
    entries = srv.get_stats()["prefix"]["entries"]
    chaos.spill_chain_at(srv._sched.iteration + 1, entries)
    second, o = _tier_pass(paged, srv, hot, 16)
    pst = srv.get_stats()
    if first != second or chaos.fired["spill"] < 1 \
            or pst["kv_tier"]["swap_ins"] < 1 \
            or pst["prefix"]["reprefills_avoided"] < 1:
        _fail(f"phase 14: spilled prefix hit: ids equal {first == second},"
              f" fired {chaos.fired['spill']}, tier {pst['kv_tier']}")
    out["f32_prefix_spill"] = {
        "entries": entries, "spills_fired": chaos.fired["spill"],
        "swap_ins": pst["kv_tier"]["swap_ins"],
        "reprefills_avoided": pst["prefix"]["reprefills_avoided"]}
    del model32, srv, tiered
    # bf16: the 32 requests without and with the tier, in turns (the
    # host-bound step's wall moves between runs)
    model16 = make_model(cfg, tree, torch.bfloat16)
    for turn in range(TIER_TURNS):
        _, out[f"bf16_no_tier_{turn}"] = _tier_pass(
            paged, tier_server(model16, TIER_BLOCKS), prompts, TIER_NEW)
        srv16 = tier_server(model16, TIER_BLOCKS, TIER_HOST_BLOCKS)
        _, out[f"bf16_tier_{turn}"] = _tier_pass(paged, srv16, prompts,
                                                 TIER_NEW)
        if out[f"bf16_tier_{turn}"]["preempts"] < 1:
            _fail(f"phase 14: bf16 tier run never preempted: "
                  f"{out[f'bf16_tier_{turn}']}")
    launches["14 tier bf16"] = out["bf16_tier_0"]["launches"]
    out["bf16_tokens_per_s_ratio"] = [
        out[f"bf16_tier_{t}"]["tokens_per_s"]
        / out[f"bf16_no_tier_{t}"]["tokens_per_s"]
        for t in range(TIER_TURNS)]
    out["bf16_copy_times"] = _tier_copy_times(srv16)
    out["host_pool_bytes"] = srv16.cache.host_pool_bytes()
    for k, v in out.items():
        print(f"tier {k} " + json.dumps(v))
    return out, launches, errs, srv16


def _time_hooks(tel):
    """Time every call the engine and scheduler make into the telemetry
    `tel` (its instance methods rebound to timing wrappers). Returns a
    list [seconds, calls] the wrappers fill."""
    acc = [0.0, 0]
    for name in ("on_submit", "on_admit", "on_prefill_chunk",
                 "on_first_token", "on_token", "on_deadline_cancel",
                 "on_finish", "begin_iteration", "end_iteration"):
        real = getattr(tel, name)

        def timed(*a, _real=real, **k):
            t0 = time.perf_counter()
            try:
                return _real(*a, **k)
            finally:
                acc[0] += time.perf_counter() - t0
                acc[1] += 1

        setattr(tel, name, timed)
    return acc


def _poison_run(cfg, tree, int8, attention, flight_dir):
    """Phase 15's poison: the first TIER_GATE greedy requests through
    phase 2's bf16 server (or phase 2b's int8/GQA one) with a chaos NaN
    in the oldest lane's first KV block at iteration POISON_AT. Returns
    (the NonFiniteError, the flight dump, the launches)."""
    from paddle_tpu_torch.robustness import ChaosInjector, NonFiniteError
    from paddle_tpu_torch.serving import GenerationServer
    model = make_model(cfg, tree, torch.bfloat16, int8, attention)
    chaos = ChaosInjector().poison_serving_at(POISON_AT)
    srv = GenerationServer(model, num_slots=16, block_size=16,
                           max_context=1024, chunk=CHUNK, start=False,
                           kv_dtype="int8" if int8 else None, chaos=chaos,
                           flight_dir=flight_dir)
    prompts = [p for p, _s in make_requests(cfg.vocab_size)][:TIER_GATE]
    futs = [srv.submit(p, max_new_tokens=32) for p in prompts]
    from paddle_tpu_torch.ops.cuda import paged
    paged.LAUNCHES = 0
    try:
        srv.run_until_idle()
    except NonFiniteError as e:
        err = e
    else:
        _fail(f"phase 15: the poison at iteration {POISON_AT} did not trip "
              f"the guard ({'plain' if attention else 'kernel'} attention,"
              f" {'int8' if int8 else 'bf16'})")
    if chaos.fired["serving_poison"] != 1:
        _fail("phase 15: the poison did not fire")
    if not all(isinstance(f.exception(timeout=0), NonFiniteError)
               for f in futs):
        _fail("phase 15: a request did not fail with the fault")
    dump = json.load(open(err.flight_dump))
    last = dump["entries"][-1]
    if not (last.get("aborted") and last["step"] == err.step
            and last["fault"]["kind"] == "non_finite_logits"):
        _fail(f"phase 15: the flight dump's last entry is not the aborted "
              f"iteration: {last.get('step')}")
    srv.close()
    return err, dump, paged.LAUNCHES


def phase_telemetry(paged, cfg, tree, gcfg, gtree, tier_srv):
    """Phase 15: telemetry, chaos and the HBM ledger at full width.
    Poison: phase 2's bf16 server and phase 2b's int8/GQA server, through
    the kernel and through the plain attention, raise NonFiniteError at
    the same iteration for the same request ids, each with its flight
    dump's aborted entry last. Telemetry on and off: the same f32 ids,
    and the host ms a bf16 step that telemetry adds. Ledger: the kv_pool
    and model_params rows against torch.cuda.memory_allocated() growth
    across a server's build; the kv_pool_host row against the pinned
    host pools. Endpoint: serve_metrics on 127.0.0.1 serves the
    serving.* and serving.kv.tier.* series. Returns (numbers, {path:
    launches})."""
    import tempfile
    import urllib.request
    from paddle_tpu_torch.observability.compile_insight import hbm_ledger
    from paddle_tpu_torch.serving import GenerationServer
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, c, t, int8 in (("bf16", cfg, tree, False),
                                ("int8", gcfg, gtree, True)):
            runs = []
            for attention in (None, paged.paged_attention_reference):
                runs.append(_poison_run(c, t, int8, attention, tmp))
            (ek, dk, lk), (ep, _dp, _lp) = runs
            if (ek.step, ek.bad_rids) != (ep.step, ep.bad_rids) \
                    or not ek.bad_rids:
                _fail(f"phase 15 {tag}: kernel tripped at {ek.step} on "
                      f"{ek.bad_rids}, plain at {ep.step} on "
                      f"{ep.bad_rids}")
            launches[f"15 poison {tag}"] = lk
            out[f"poison_{tag}"] = {
                "step": ek.step, "bad_rids": ek.bad_rids,
                "plain_step": ep.step, "plain_bad_rids": ep.bad_rids,
                "dump_entries": len(dk["entries"]), "launches": lk}
    # telemetry on and off
    greedy = [p for p, _s in make_requests(cfg.vocab_size)][:8]
    model32 = make_model(cfg, tree)
    ids = {}
    for on in (True, False):
        srv = GenerationServer(model32, num_slots=16, block_size=16,
                               max_context=1024, chunk=CHUNK, start=False,
                               telemetry=on)
        futs = [srv.submit(p, max_new_tokens=AGREE_TOKENS) for p in greedy]
        srv.run_until_idle()
        ids[on] = [list(f.result(timeout=0).token_ids) for f in futs]
    if ids[True] != ids[False]:
        _fail("phase 15: f32 ids differ with telemetry on and off")
    del model32
    model16 = make_model(cfg, tree, torch.bfloat16)
    step_ms = {True: [], False: []}
    hook_s = []
    for on in (False, True) * TELEMETRY_PAIRS:
        srv = GenerationServer(model16, num_slots=16, block_size=16,
                               max_context=1024, chunk=CHUNK, start=False,
                               telemetry=on)
        if on:
            hook_s.append(_time_hooks(srv.telemetry))
        for p in greedy * 2:
            srv.submit(p, max_new_tokens=NEW_TOKENS)
        while True:
            ts = time.perf_counter()
            if not srv.step():
                break
            step_ms[on].append((time.perf_counter() - ts) * 1e3)
        srv.close()
        del srv
    steps_on = len(step_ms[True])
    out["telemetry"] = {
        "f32_ids_equal": True, "requests": len(greedy),
        "pairs": TELEMETRY_PAIRS,
        "bf16_step_ms_mean_on": float(np.mean(step_ms[True])),
        "bf16_step_ms_mean_off": float(np.mean(step_ms[False])),
        "bf16_step_ms_p50_on": float(np.median(step_ms[True])),
        "bf16_step_ms_p50_off": float(np.median(step_ms[False])),
        "host_ms_added_per_step": float(np.mean(step_ms[True])
                                        - np.mean(step_ms[False])),
        "hook_ms_per_step": sum(h[0] for h in hook_s) * 1e3 / steps_on,
        "hook_calls_per_step": sum(h[1] for h in hook_s) / steps_on}
    # the ledger against the allocator: nothing else is freed or made
    # while the server is built
    del model16
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    requested = torch.cuda.memory_stats()["requested_bytes.all.current"]
    model = make_model(cfg, tree, torch.bfloat16)
    torch.cuda.synchronize()
    params_grown = torch.cuda.memory_allocated() - before
    # the bytes the build asked for, without the allocator's block
    # rounding: against the model_params row (ROADMAP C5)
    params_requested = torch.cuda.memory_stats()[
        "requested_bytes.all.current"] - requested
    srv = tier_server(model, TIER_BLOCKS, 64)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    rows = {e["name"]: e for e in hbm_ledger().snapshot()["entries"]
            if e["component"] == srv._ledger_id}
    ledger = rows["kv_pool"]["bytes"] + rows["model_params"]["bytes"]
    pinned = sum(t.numel() * t.element_size()
                 for layer in srv.cache.host.pools for t in layer.values())
    if not all(t.is_pinned() for layer in srv.cache.host.pools
               for t in layer.values()):
        _fail("phase 15: the host tier's pools are not pinned")
    if rows["kv_pool_host"]["bytes"] != pinned \
            or rows["kv_pool_host"]["kind"] != "host_ram":
        _fail(f"phase 15: kv_pool_host row {rows['kv_pool_host']} != "
              f"{pinned} pinned bytes")
    out["ledger"] = {"kv_pool": rows["kv_pool"]["bytes"],
                     "model_params": rows["model_params"]["bytes"],
                     "rows_sum": ledger, "allocated_growth": grown,
                     "difference": grown - ledger,
                     "params_growth": params_grown,
                     "params_requested_growth": params_requested,
                     "params_requested_minus_row":
                         params_requested - rows["model_params"]["bytes"],
                     "server_growth": grown - params_grown,
                     "kv_pool_host": rows["kv_pool_host"]["bytes"],
                     "pinned_bytes": pinned}
    srv.close()
    del srv, model
    # the endpoint, on phase 14's tier server
    exp = tier_srv.serve_metrics(port=0)
    try:
        with urllib.request.urlopen(f"{exp.url}/metrics", timeout=30) as r:
            body = r.read().decode()
    finally:
        exp.close()
    series = sorted({line.split("{")[0].split(" ")[0]
                     for line in body.splitlines()
                     if line.startswith("serving_")})
    tier_series = [n for n in series if n.startswith("serving_kv_tier_")]
    if not tier_series or "serving_requests" not in series:
        _fail(f"phase 15: /metrics lacks the serving series: {series}")
    out["endpoint"] = {"url_host": exp.host, "serving_series": len(series),
                       "tier_series": tier_series}
    for k, v in out.items():
        print(f"telemetry {k} " + json.dumps(v))
    return out, launches


# ---------------------------------------------------------------------------
# phases 16, 16b, 16c: BERT-base / ERNIE-1.0 pretraining through the Fluid
# entry points; phase 17: ring attention over a local sp mesh
# ---------------------------------------------------------------------------

def bert_config(**kw):
    """BERT-base (= ERNIE-1.0): vocab 30522, hidden 768, 12 layers, 12
    heads, FFN 3072, 512 positions, dropout 0.1 unless `kw` says
    otherwise."""
    from paddle_tpu_torch.models import bert
    return bert.BertConfig(**{**BERT_CFG, **kw})


def build_bert(cfg, packed_width=None):
    """(main, startup, loss): the MLM+NSP pretraining net at seq BERT_SEQ,
    or the packed MLM net with `packed_width` predictions a row, with
    AdamOptimizer(1e-4)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 16
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if packed_width is None:
            _f, loss, _mlm, _acc = bert.build_pretrain_net(cfg,
                                                           seq_len=BERT_SEQ)
        else:
            _f, loss = bert.build_packed_pretrain_net(
                cfg, seq_len=BERT_SEQ, max_predictions=packed_width)
        fluid.optimizer.AdamOptimizer(1e-4).minimize(loss)
    return main, startup, loss


def bert_feed():
    """bench.py's ERNIE cell feed (int32, synthetic, from the seed)."""
    from paddle_tpu_torch.models import ernie
    return ernie.make_pretrain_feed(bert_config(), BERT_SEQ, BERT_BATCH,
                                    seed=SEED, dtype=np.int32)


def packed_feed(cfg):
    """Documents of PACKED_DOC_LENS tokens packed by pack_sequences into
    rows of BERT_SEQ: (feed, rows, packing efficiency)."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.reader import packing_efficiency
    lo, hi = PACKED_DOC_LENS
    feed, rows = bert.make_packed_pretrain_feed(cfg, BERT_SEQ, PACKED_DOCS,
                                                seed=SEED, min_len=lo,
                                                max_len=hi)
    return feed, rows, packing_efficiency(feed)


def _bias_views(flash, run):
    """The (shape, strides) of every bias the flash kernels' checks hand
    the kernels during run()."""
    seen = []
    real = flash._check

    def spy(*args):
        bias = real(*args)
        seen.append(None if bias is None else
                    (tuple(bias.shape), tuple(bias.stride())))
        return bias

    flash._check = spy
    try:
        run()
    finally:
        flash._check = real
    return seen


def phase_bert(flash):
    """BERT-base pretraining at seq BERT_SEQ x batch BERT_BATCH, Adam
    1e-4, f32, dropout 0.1, on bench.py's ERNIE feed: BERT_WARM +
    BERT_STEPS steps on one batch (12 + 12 + 12 flash launches a step,
    the loss below BERT_LOSS_MARGIN x the first), then a profile of
    BERT_PROFILE_STEPS more. The first step also records the padding
    bias the kernels get: a (B, H, T, T) view with stride 0 over heads and
    queries, never a copy. Returns the run's (fwd, dQ, dK/dV) launches."""
    import paddle_tpu_torch as fluid
    cfg = bert_config()
    main, startup, loss = build_bert(cfg)
    feed = bert_feed()
    exe = fluid.Executor()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = cfg.num_hidden_layers
    with fluid.scope_guard(fluid.Scope()):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        _zero_counts(flash)
        first = []
        views = _bias_views(flash, lambda: first.append(_train_run(
            flash, exe, main, feed, loss, 1, 1)))
        losses, step_ms, per_step, tc = _train_run(
            flash, exe, main, feed, loss, BERT_WARM + BERT_STEPS - 1,
            BERT_WARM - 1)
        counts = _bwd_counts(flash)
        losses = first[0][0] + losses
        per_step |= first[0][2]
        tc += first[0][3]
        peak = torch.cuda.max_memory_allocated()
        prof = _profile_train(lambda: exe.run(main, feed=feed,
                                              fetch_list=[loss]),
                              BERT_PROFILE_STEPS)
    b, h, t = BERT_BATCH, cfg.num_attention_heads, BERT_SEQ
    want_view = ((b, h, t, t), (t, 0, 0, 1))
    if len(views) != 2 * n or set(views) != {want_view}:
        _fail(f"bert: the kernels got padding biases {set(views)} in "
              f"{len(views)} calls, want {2 * n} x {want_view}")
    if per_step != {(n, n, n)} or tc != 0 or counts != (
            (BERT_WARM + BERT_STEPS) * n,) * 3:
        _fail(f"bert: flash launches fwd/dq/dkv per step {per_step} "
              f"(run {counts}), want {n} each; {tc} tensor-core, want 0")
    first, last = losses[0], losses[-1]
    if not np.isfinite(losses).all() or not last < BERT_LOSS_MARGIN * first:
        _fail(f"bert: loss not finite or not below {BERT_LOSS_MARGIN} x "
              f"the first: {losses}")
    mean_ms = float(np.mean(step_ms))
    out = {"config": "BertConfig(max_position_embeddings=512)",
           "seq_len": t, "batch": b, "params": len(main.all_parameters()),
           "feed": "ernie.make_pretrain_feed(cfg, 512, 8, int32)",
           "startup_s": startup_s, "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "step_ms_mean": mean_ms,
           "tokens_per_s": b * t / (mean_ms / 1e3),
           "max_memory_allocated": peak,
           "loss_first": first, "loss_last": last,
           "loss_ratio": last / first, "loss_margin": BERT_LOSS_MARGIN,
           "bias_view": [list(want_view[0]), list(want_view[1])],
           "flash_launches_fwd_dq_dkv": list(counts)}
    print("bert " + json.dumps(out))
    print("profile bert " + json.dumps(prof))
    return counts + (tc,)


def phase_bert_agree(flash):
    """Phase 16b: train_agree at full width, BERT_AGREE_LAYERS layers,
    dropout 0, BERT_AGREE_STEPS Adam steps on the ERNIE feed with padding
    (input_mask 0 on two rows' tails, so the kernels get a non-zero
    key-side bias)."""
    cfg = bert_config(num_hidden_layers=BERT_AGREE_LAYERS,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    feed = bert_feed()
    feed["input_mask"][1, BERT_SEQ - BERT_PAD:] = 0.0
    feed["input_mask"][5, BERT_SEQ // 2:] = 0.0
    return train_agree(flash, "bert agree", build_bert(cfg), feed,
                       BERT_AGREE_LAYERS, BERT_AGREE_STEPS)


def phase_packed(flash):
    """Phase 16c: the packed MLM net at full width, seq BERT_SEQ, over
    PACKED_DOCS documents packed by pack_sequences (segment ids through
    the flash kernels): PACKED_WARM + PACKED_STEPS steps (the loss falls;
    12 + 12 + 12 launches a step), real (non-pad) tokens/s and the
    packing efficiency; then kernel vs plain at BERT_AGREE_LAYERS layers.
    Returns (the training run's launches, the agreement's launches, its
    errors)."""
    import paddle_tpu_torch as fluid
    cfg = bert_config()
    feed, rows, eff = packed_feed(cfg)
    width = feed["mask_pos"].shape[1]
    main, startup, loss = build_bert(cfg, width)
    exe = fluid.Executor()
    n = cfg.num_hidden_layers
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        _zero_counts(flash)
        losses, step_ms, per_step, tc = _train_run(
            flash, exe, main, feed, loss, PACKED_WARM + PACKED_STEPS,
            PACKED_WARM)
        counts = _bwd_counts(flash)
    if per_step != {(n, n, n)} or tc != 0:
        _fail(f"packed: flash launches per step {per_step}, want {n} "
              f"each; {tc} tensor-core, want 0")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        _fail(f"packed: loss not finite and falling: {losses}")
    real = int((feed["segment_ids"] > 0).sum())
    mean_ms = float(np.mean(step_ms))
    out = {"docs": PACKED_DOCS, "doc_lens": list(PACKED_DOC_LENS),
           "rows": rows, "seq_len": BERT_SEQ, "predictions_a_row": width,
           "packing_efficiency": eff, "real_tokens": real,
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_mean": mean_ms,
           "real_tokens_per_s": real / (mean_ms / 1e3),
           "slot_tokens_per_s": rows * BERT_SEQ / (mean_ms / 1e3),
           "loss_first": losses[0], "loss_last": losses[-1],
           "flash_launches_fwd_dq_dkv": list(counts)}
    print("packed " + json.dumps(out))
    acfg = bert_config(num_hidden_layers=BERT_AGREE_LAYERS,
                       hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    agree_counts, errs = train_agree(flash, "packed agree",
                                     build_bert(acfg, width), feed,
                                     BERT_AGREE_LAYERS, 1)
    return counts + (tc,), agree_counts, errs


def _allclose_ratio(got, want, tol):
    """max |got - want| / (tol + tol |want|): at most 1 where the two are
    close as np.allclose(rtol=tol, atol=tol) holds them; and the max
    absolute error."""
    diff = (got.double() - want.double()).abs()
    return ((diff / (tol + tol * want.double().abs())).max().item(),
            diff.max().item())


def phase_ring(flash):
    """Phase 17: ring attention on a local sp RING_SP mesh on the card,
    q/k/v RING_SHAPE f32: causal, and non-causal with a key-side padding
    bias over the last RING_MASKED keys. ring_attention_sharded's output
    and the gradients of <out, do> (d q/k/v, a seeded cotangent) against
    the plain full attention (attention_ops._xla_attention) at the JAX
    tests' tolerances (RING_OUT_TOL, RING_GRAD_TOL, as np.allclose);
    flash launches a call: sp(sp+1)/2 forward, dQ and dK/dV causal, sp**2
    each non-causal. Prints the ring call's ms beside one flash call over
    the whole T (information only). Returns ({case: launches}, errors)."""
    import importlib
    from paddle_tpu_torch.ops import attention_ops
    from paddle_tpu_torch.parallel import make_mesh
    ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")
    from paddle_tpu_torch.ops.flash import flash_attention
    mesh = make_mesh(sp=RING_SP)
    if mesh.world or mesh.shape["sp"] != RING_SP:
        _fail(f"ring: {mesh} is not a local sp {RING_SP} mesh")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    q, k, v, do = (_rand(RING_SHAPE, gen) for _ in range(4))
    t = RING_SHAPE[2]
    bias = torch.zeros((RING_SHAPE[0], 1, 1, t), device="cuda")
    bias[..., t - RING_MASKED:] = -1e9
    sp = RING_SP
    launches, errs, out = {}, {}, {}
    for case, causal, b in (("causal", True, None),
                            ("padding_bias", False, bias)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        _zero_counts(flash)
        ring_out = ra.ring_attention_sharded(*leaves, mesh, causal=causal,
                                             bias=b)
        ring_grads = torch.autograd.grad(ring_out, leaves, do)
        torch.cuda.synchronize()
        counts = _bwd_counts(flash) + (flash.TC_LAUNCHES,)
        want = sp * (sp + 1) // 2 if causal else sp * sp
        if counts != (want,) * 3 + (0,):
            _fail(f"ring {case}: flash launches fwd/dq/dkv/tensor-core "
                  f"{counts}, want {want} each and 0 tensor-core")
        plain_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ref = attention_ops._xla_attention(*plain_leaves, bias=b,
                                           causal=causal)
        ref_grads = torch.autograd.grad(ref, plain_leaves, do)
        ratio, err = _allclose_ratio(ring_out.detach(), ref.detach(),
                                     RING_OUT_TOL)
        g = [_allclose_ratio(a, r, RING_GRAD_TOL)
             for a, r in zip(ring_grads, ref_grads)]
        del ref, ref_grads, plain_leaves
        torch.cuda.empty_cache()
        row = {"launches_fwd_dq_dkv_tc": list(counts),
               "out_max_abs_err": err, "out_ratio": ratio,
               "grad_max_abs_err": {n: e for n, (_, e) in zip("qkv", g)},
               "grad_ratio": {n: r for n, (r, _) in zip("qkv", g)},
               "tolerances": [RING_OUT_TOL, RING_GRAD_TOL]}
        with torch.no_grad():
            row["ring_fwd_ms"] = _time_ms(lambda: ra.ring_attention_sharded(
                q, k, v, mesh, causal=causal, bias=b), reps=5, warmup=1)
            row["flash_fwd_ms_whole_t"] = _time_ms(lambda: flash_attention(
                q, k, v, bias=b, causal=causal), reps=5, warmup=1)
        out[case] = row
        print(f"ring {case} " + json.dumps(row))
        if ratio > 1 or max(r for r, _ in g) > 1:
            _fail(f"ring {case}: the ring disagrees with full attention")
        launches[case] = counts
        errs[case] = (err, max(e for _, e in g))
    print("ring " + json.dumps({"mesh": repr(mesh), "shape": list(RING_SHAPE),
                                "masked_keys": RING_MASKED}))
    return launches, errs


def times_of(flag, root):
    """Phase 10 (`--bwd-times-of`) or phase 8 (`--fwd-times-of`) alone on
    the flash kernels of the package under `root` (a checkout of another
    commit, for a comparison inside one call): builds its flash libraries
    and prints the phase's rows, then the card line."""
    import os
    sys.path.insert(0, os.path.abspath(root))
    from paddle_tpu_torch.ops.cuda import flash
    if not flash.__file__.startswith(os.path.abspath(root)):
        _fail(f"{flash.__file__} is not under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _phase("build", lambda: (flash.build(), flash.build_bwd()))
    if flag == "--bwd-times-of":
        rows = _phase("10 flash backward times", phase_flash_bwd_times, flash)
    else:
        rows = _phase("8 flash times", phase_flash_times, flash)
    print(_card_line())
    print(json.dumps({flag[2:].replace("-", "_"): root, "rows": rows}))


def paged_of(root):
    """`--paged-of <checkout>`: phase 1's NaN cases (reported, not
    failed) and phase 4's times on the paged kernel of the package under
    `root` (a checkout of another commit, for a comparison inside one
    call), then the card line."""
    import os
    sys.path.insert(0, os.path.abspath(root))
    from paddle_tpu_torch.ops.cuda import paged
    if not paged.__file__.startswith(os.path.abspath(root)):
        _fail(f"{paged.__file__} is not under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _phase("build", paged.build)
    nan = _phase("1 NaN cases (report)", check_kernel_nan, paged, True)
    times = _phase("4 times", phase_times, paged)
    times8 = _phase("4 times int8", phase_times, paged, int8=True)
    print(_card_line())
    print(json.dumps({"paged_of": root, "nan": nan, "times": times,
                      "times_int8": times8}))


def _phase(name, fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def kernel_entry(name, replaces, launches, errs, times, at, main="step",
                 source="paddle_tpu_torch/csrc/paged_attention.cu"):
    row = times[main]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(errs),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "at": at, "shapes": times}


FLASH_FWD_REPLACES = (
    "paddle_tpu/ops/pallas/flash.py:168 (_fwd_kernel, launch :294), "
    "paddle_tpu/ops/pallas/flash.py:318 (_fwd_kernel_kgrid, launch :423)")


def build_all():
    """The kernels' libraries, one nvcc for each source, side by side."""
    from paddle_tpu_torch.ops.cuda import flash, paged
    builds = (paged.build, flash.build, flash.build_bwd)
    with ThreadPoolExecutor(len(builds)) as pool:
        for lib in [pool.submit(b) for b in builds]:
            lib.result()


def ptxas_report(source, match):
    """ptxas's lines (entry, registers, shared memory, spills) for the
    kernels of csrc/<source> whose names hold `match`."""
    from paddle_tpu_torch.ops.cuda._build import library_path
    try:
        with open(library_path(source)[1] + ".log") as f:
            lines = f.read().splitlines()
    except FileNotFoundError:
        return ["no ptxas report beside the library (built elsewhere)"]
    keep, on = [], False
    for line in lines:
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            on = match in line
        if on:
            keep.append(line.replace("ptxas info    : ", "").strip())
    return keep


def main():
    if not torch.cuda.is_available():
        _fail("CUDA is not available")
    if len(sys.argv) == 3 and sys.argv[1] in ("--bwd-times-of",
                                               "--fwd-times-of"):
        times_of(sys.argv[1], sys.argv[2])
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--paged-of":
        paged_of(sys.argv[2])
        return
    if len(sys.argv) > 1:
        _fail(f"arguments {sys.argv[1:]}: want none, or --bwd-times-of, "
              f"--fwd-times-of or --paged-of <checkout>")
    from paddle_tpu_torch.models.gpt import GPTConfig, init_params
    from paddle_tpu_torch.ops.cuda import flash, paged
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    _phase("build", build_all)
    for source, match in (("flash_attention.cu", "flash_fwd_kernel"),
                          ("flash_attention_bwd.cu", "flash_bwd")):
        for line in ptxas_report(source, match):
            print(f"ptxas {source}: {line}")
    cfg = GPTConfig()
    tree = init_params(cfg, seed=SEED)
    gcfg = GPTConfig(kv_heads=KV_HEADS)
    gtree = init_params(gcfg, seed=SEED)
    errs = _phase("1 kernel vs plain", check_kernel, paged)
    nan_errs = _phase("1n kernel NaN cases", check_kernel_nan, paged)
    ferrs = _phase("1f flash kernel vs plain", check_flash, flash)
    berrs = _phase("1g flash backward kernels vs plain", check_flash_bwd,
                   flash)
    launches, requests, _ = _phase("2 serve", phase_serve, paged, cfg, tree)
    launches8, requests8, _ = _phase("2b serve int8", phase_serve, paged,
                                     gcfg, gtree, int8=True)
    _phase("3 agree", phase_agree, paged, cfg, tree, requests)
    _phase("3b agree int8", phase_agree, paged, gcfg, gtree, requests8,
           int8=True)
    dcfg = GPTConfig(**D128_CFG)
    _phase("2c serve head_dim 128", phase_serve_d128, paged, dcfg,
           init_params(dcfg, seed=SEED))
    times = _phase("4 times", phase_times, paged)
    times8 = _phase("4 times int8", phase_times, paged, int8=True)
    _phase("5 profile", phase_profile, cfg, tree)
    _phase("5 profile int8", phase_profile, gcfg, gtree, int8=True)
    flaunches = _phase("6 prompt decode", phase_prompt_decode, flash, cfg,
                       tree)
    _phase("6b profile prompt decode", phase_profile_prompt, cfg, tree)
    _phase("7 agree prefill", phase_agree_prefill, flash, cfg, tree)
    ftimes = _phase("8 flash times", phase_flash_times, flash)
    blaunches, f32_launches = _phase("9 train", phase_train, flash)
    _phase("9b train agree", phase_train_agree, flash)
    _phase("9c profile train", phase_profile_train, flash)
    btimes = _phase("10 flash backward times", phase_flash_bwd_times, flash)
    btimes["train_bf16"]["max_abs_err"] = berrs["train_bf16"]
    prefix, perrs = _phase("11 prefix cache", phase_prefix, paged, cfg, tree)
    spec, serrs = _phase("12 speculative decoding", phase_spec, paged, cfg,
                         tree)
    _, derrs, dlaunches = _phase("13 decode strategies", phase_strategies,
                                 paged, cfg, tree)
    _, tlaunches, terrs, tier_srv = _phase("14 host KV tier", phase_tier,
                                           paged, cfg, tree)
    _, plaunches = _phase("15 telemetry, chaos, ledger", phase_telemetry,
                          paged, cfg, tree, gcfg, gtree, tier_srv)
    del tier_srv
    bert_launches = _phase("16 BERT-base pretrain", phase_bert, flash)
    bagree_launches, bagree_errs = _phase("16b BERT agree",
                                          phase_bert_agree, flash)
    packed_launches, pagree_launches, pagree_errs = _phase(
        "16c packed pretrain", phase_packed, flash)
    ring_launches, ring_errs = _phase("17 ring attention", phase_ring,
                                      flash)
    path_errs = {**perrs, **serrs, **derrs, **terrs}
    by_path = {
        "2 serve": launches,
        "11 prefix f32 warm pass": prefix["f32"]["launches_warm"],
        "12 spec verify (target, small draft, f32)":
            spec["small_draft_f32"]["target_launches"],
        "12 spec draft D 32 (f32)":
            spec["small_draft_f32"]["draft_launches"],
        **dlaunches, **tlaunches, **plaunches}
    print(f"all phases: {time.perf_counter() - t_all:.1f} s")
    card = _card_line()
    kernels = [
        kernel_entry(
            "paged_attention",
            "paddle_tpu/ops/pallas/paged.py:134 (_paged_kernel), "
            "paddle_tpu/ops/pallas/paged.py:333 (_paged_kernel_v2)",
            launches, [errs[f"{n}{d}_bf16"] for n in SHAPES
                       for d in ("", "_d128")]
            + [nan_errs[f"nan_{n}_bf16"] for n in NAN_SHAPES]
            + list(path_errs.values()), times,
            "fused-step decode: 16 lanes x H 12 x C 16 (one valid column) "
            "x D 64, bs 16, M 64, bf16; launches_by_path counts phases 2 "
            "and 11-15, max_abs_err includes their captured calls "
            "(path_errs)"),
        kernel_entry(
            "paged_attention_int8",
            "paddle_tpu/ops/pallas/paged.py:151-219 (_paged_kernel int8 "
            "branch, launch :282), paddle_tpu/ops/pallas/paged.py:435-437 "
            "(_paged_kernel_v2 int8 dequant, launch :505)",
            launches8, [errs[f"int8_{n}{d}_bf16"] for n in SHAPES
                        for d in ("", "_d128")]
            + [nan_errs[f"nan_{n}_int8_bf16q"] for n in NAN_SHAPES], times8,
            "fused-step decode: 16 lanes x H 12 over H_kv 4 x C 16 (one "
            "valid column) x D 64, bs 16, M 64, int8 pools, bf16 q"),
        kernel_entry(
            "flash_attention_fwd: flash_fwd_tc_kernel (bf16, wgmma + TMA)",
            FLASH_FWD_REPLACES, flaunches,
            [ferrs["prefill_bf16"], ferrs["long_bf16"]],
            {k: ftimes[k] for k in ("prefill", "long")},
            "prefill attention: B 8 x H 12 x T 512 x D 64, causal, bf16, "
            "q/k/v as the prefill's transposed views; launches over phase "
            "6's three calls",
            main="prefill",
            source="paddle_tpu_torch/csrc/flash_attention.cu"),
        kernel_entry(
            "flash_attention_fwd: flash_fwd_kernel (f32, mma.sync 3xTF32 "
            "+ cp.async ring)",
            FLASH_FWD_REPLACES, f32_launches,
            [ferrs["train_f32"], ferrs["long_f32"]],
            {k: ftimes[k] for k in ("train_f32", "long_f32")},
            "training attention: B 8 x H 12 x T 512 x D 64, causal, f32, "
            "q/k/v as the training step's transposed views; launches over "
            "phase 9; shapes also T 16384 (B 1, H 12, f32)",
            main="train_f32",
            source="paddle_tpu_torch/csrc/flash_attention.cu"),
        kernel_entry(
            "flash_attention_bwd",
            "paddle_tpu/ops/pallas/flash.py:465 (_dq_kernel), :519 "
            "(_dkv_kernel), launches :854/:895 (_flash_bwd); "
            "paddle_tpu/ops/pallas/flash.py:579 (_dq_kernel_kgrid), :629 "
            "(_dkv_kernel_kgrid), launches :741/:783 (_flash_bwd_kgrid)",
            blaunches, [berrs["train_f32"], berrs["long_f32"]], btimes,
            "training attention backward (dQ + dK/dV kernels, delta "
            "included): B 8 x H 12 x T 512 x D 64, causal, f32, q/k/v/do "
            "as transposed views; launches = dQ + dK/dV over phase 9; "
            "shapes also T 16384 (f32) and the training shape in bf16",
            main="train",
            source="paddle_tpu_torch/csrc/flash_attention_bwd.cu"),
    ]
    kernels[0]["launches_by_path"] = by_path
    kernels[0]["path_errs"] = path_errs
    # the flash kernels' paths: (fwd, dQ, dK/dV, bf16 fwd) launches of
    # each run, counted from 0 just before it
    flash_paths = {
        "16 BERT-base pretrain (30 steps)": bert_launches,
        "16b BERT agree (kernel run, 2 layers x 3 steps)": bagree_launches,
        "16c packed pretrain (10 steps)": packed_launches,
        "16c packed agree (kernel run, 2 layers x 1 step)": pagree_launches,
        **{f"17 ring sp {RING_SP} {case} (one call)": c
           for case, c in ring_launches.items()}}
    kernels[2]["launches_by_path"] = {
        "6 prompt decode": flaunches,
        **{name: c[3] for name, c in flash_paths.items()}}
    kernels[3]["launches_by_path"] = {"9 train": f32_launches, **{
        name: c[0] for name, c in flash_paths.items()}}
    kernels[4]["launches_by_path"] = {"9 train": blaunches, **{
        name: c[1] + c[2] for name, c in flash_paths.items()}}
    kernels[3]["max_abs_err"] = max(
        [kernels[3]["max_abs_err"]] + [e[0] for e in ring_errs.values()])
    kernels[4]["max_abs_err"] = max(
        [kernels[4]["max_abs_err"]] + [e[1] for e in ring_errs.values()])
    agree = {"16b BERT agree": bagree_errs,
             "16c packed agree": pagree_errs,
             **{f"17 ring {case} (out, grads: max abs)": list(e)
                for case, e in ring_errs.items()}}
    kernels[3]["path_errs"] = kernels[4]["path_errs"] = agree
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
