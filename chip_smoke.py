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
1fn. the flash kernels' NaN semantics (ROADMAP C11): the f32 and bf16
   forward, causal and not, D 64 and 128, (2, 3, 128, 128), with one
   visible key's bias NaN, one NaN element of q, one of k (in f32 the
   card's own NaN, 0x7fffffff), a NaN bias at a causally hidden key and
   at a key of another segment: every non-finite out row, out element
   and lse entry exactly the plain version's, the finite rows within
   1f's tolerances, a hidden NaN changing nothing (bitwise the output
   with that element 0); then the dQ / dK / dV kernels on those inputs
   against the plain backward the same way (under causal the dK of a
   NaN in q and the dQ of a NaN in k lie between the rows a visible pair
   reaches and the plain version's, whose products give 0 x NaN where
   the kernels prune the pair);
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
   blocks. bf16: the first 16 requests with and without the tier, in
   two pairs (peak and mean lanes, steps, tokens/s, preemptions, spills,
   swap-ins), and the
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
   ERNIE cell, synthetic): 23 steps on one batch; every step must launch
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
18. the in-process fleet: bench.py's fleet traffic at full-width lengths
   (18 tenant system prompts of 128 tokens, 85 % of its first 48
   requests (of 96) one of
   them plus a 1-64 token suffix, the rest private prompts of 32-256
   tokens, one arriving a router step, 32 new tokens, greedy) through 3
   GenerationServer replicas behind a FleetRouter (affinity routing),
   bf16: tokens/s against one server on the same arrivals, in turns,
   and the fleet's prefix hit rate and blocks a request against a seeded
   random scatter over the same replicas, with the engine's default
   pools (every replica can cache every tenant) and with pools of 113
   blocks (16 lanes of a mean lane's own blocks and two tenants' chains,
   as bench.py sizes its replicas; the scatter must evict); f32: chaos
   kills replica 0
   mid-stream (kill_replica_at) and every request's ids equal one
   server's;
18b. disaggregated prefill/decode: one prefill and two decode replicas,
   dense bf16 and the int8/GQA geometry (int8 weights and KV, blocks
   moved with their scale rows): blocks handed off and µs a block of the
   in-process transfer; in f32 the disaggregated fleet's ids equal the
   colocated fleet's, dense and int8;
18c. self-healing: a supervised f32 fleet spawned by make_checkpoint_spawn
   from a full-width checkpoint the port's CheckpointManager wrote (the
   startup of gpt.build_lm_net(GPTConfig()) on the card); chaos kills
   one replica, hangs another (the watchdog must declare it hung) and
   sends a poison prompt (PoisonRequestError through the kernel);
   every dead slot is resurrected with its prefix re-warmed, the other
   requests' ids equal one server's, and the time to resurrection is
   printed;
18d. the out-of-process fleet: worker processes spawned by
   make_subprocess_spawn from that checkpoint, each on the card. f32: a
   SIGKILL of worker 0 mid-stream (kill_process_at) fails over with
   ids equal to one in-process server's and the slot comes back as a
   new process; bf16: the fleet traffic's first 48 requests through two
   workers against one in-process server, in turns (the four workers
   boot, and the bf16 ones serve a first request, beside 18c), and a
   512-token prompt's chain handed
   over the RPC from one worker to the other (µs a block each way; the
   receiver's blocks are bitwise the donor's bf16 bytes); each worker's
   paged-kernel launches are read over the RPC just before and just
   after every run it serves, and each run's must be > 0 and equal its
   iterations x layers;
19. tensor-parallel serving on a local tp 2 mesh on the card
   (``make_named_mesh(("tp",), (2,), ["cuda"] * 2)``: both ranks in this
   process, run in turn): GPTConfig() over phase 2's prompts, every one
   greedy (a mesh server refuses sampling), 16 slots, block 16, chunk 16,
   context 1024. f32: 16 prompts' ids at tp 2 equal tp 1's; bf16: tokens/s
   and step p50/p99 in turns tp 1, tp 2, tp 2, tp 1. Every run's launches
   = iterations x 12 x tp and its reductions 2 x 12 a step; each rank's
   pool is a contiguous (N, 6, 16, 64) shard, shard bytes x 2 = pool
   bytes, the ledger's kv_pool/shard rows sum to it; the kernel against
   its plain version on a call captured at H 6;
19b. GPTConfig(kv_heads=4), dense f32 weights over int8 KV pools, at tp
   1, 2 and 4 (H 6 over 2 and H 3 over 1 KV heads a rank): ids equal tp
   1's, launches = iterations x 12 x tp, the kernel against its plain
   version on a call captured at each tp;
19c. make_tp_prompt_decoder at tp 2 over phase 6's prompts, 64 new,
   greedy: f32 ids equal make_prompt_decoder's and 24 flash launches (12
   layers x 2 ranks) a prefill; bf16 24 tensor-core launches, its wall
   beside tp 1's; the flash kernel against its plain version on each
   dtype's first prefill call (B 8 x H 6 x T 512 x D 64);
19d. the world form: two processes on cuda:0 joined by gloo (this script
   with ``--tp-world-rank``), one rank's params and pool shard each, serve
   tests/parallel/test_serving_tp.py's f32 staggered stream: both ranks'
   ids equal a tp 1 server's, 2 x 12 reductions a step, launches =
   iterations x 12 a rank, equal block tables every step; a rank's
   failure fails the phase;
20. the training recipe on phase 16's configuration (BertConfig(), seq
   512 x batch 8, dropout 0.1, the ERNIE feed), in the shape of
   PaddlePaddle's LARK BERT recipe: ``amp.decorate(AdamOptimizer(
   learning_rate=linear_lr_warmup(polynomial_decay(1e-4, 1000, 0.0), 4,
   0.0, 1e-4), regularization=L2Decay(1e-2)), init_loss_scaling=2**15,
   use_dynamic_loss_scaling=True)`` under ``set_gradient_clip(
   GradientClipByGlobalNorm(1.0))``: the products in bf16 (cuBLAS; in
   phases 20-20d split-K partials are summed in f32, as XLA accumulates
   a bf16 dot), the attention in f32 through the flash kernels. 23 steps
   on one batch: every loss finite, the last below 0.95 x the first, the
   first within 1e-2 of phase 16's f32 first loss (the same weights, feed
   and dropout masks), 12 + 12 + 12 flash launches a step and none of the
   tensor-core kernel, the rate fetched each step the schedule's closed
   form; prints step ms p50/p99, tokens/s, the peak memory, the loss
   scale and good-step count at the end, and a profile of 3 more steps
   beside phase 16's (wall and device ms, busy share, device operations
   a step);
20b. the recipe under ``RecomputeOptimizer(policy="dots")``,
   ``"nothing"`` and ``"offload"`` (the saved products in pinned host
   memory, their bytes a step printed) beside two runs without
   recompute, from copies of one startup scope, 3 steps each: the first loss equal, the first step's
   @GRADs within a few f32 roundings (what the two runs without
   recompute differ by), the later losses within bf16's 1e-3, 24 + 12 +
   12 flash launches a step under recompute (the checkpoint re-runs the
   forward kernel), a lower peak memory, and, as the first step's
   backward starts, "dots" holding at least half its forward's 2-D
   products' bytes more than "nothing" (the products it saved) and less
   than the run without recompute; prints each run's peak bytes, bytes
   held at the backward, step ms and errors against the first run
   without recompute;
20c. 3 steps of the recipe, then the loss-scaling var set to 3e38 for one
   step (the scaled loss overflows): every parameter finite after it, the
   scale 0.8 x 3e38, the good-step count 0, the next 3 losses finite;
20d. kernel vs plain attention under the recipe: train_agree at full
   width, 2 layers, dropout 0, 16b's padded feed, 3 steps, at bf16's
   tolerances (the same bf16 products on both sides);
21. data parallelism on phase 16's cell: ``CompiledProgram(main).
   with_data_parallel(places=[CUDAPlace(0)] * 2)``, a local dp 2 mesh
   whose two ranks run in turn on the card, 23 steps on phase 16's feed
   (BertConfig(), seq 512 x batch 8, 4 rows a rank, dropout 0.1, Adam
   1e-4, f32): every feed split into (4, ...) shards (printed), the loss
   below 0.95 x the first, 2 x 12 flash forward, dQ and dK/dV launches a
   step (12 a rank) and none of the tensor-core kernel, 5 dp reductions
   a step (the NSP mean, accuracy, the MLM gather and its two sums);
   prints step ms p50/p99, tokens/s, the peak memory and a profile of 3
   more steps beside phase 16's;
21b. dp 2 (``with_data_parallel(places=[CUDAPlace(0)] * 2)``) against
   dp 1 (``with_data_parallel(places=[CUDAPlace(0)])``) at full width and 2
   layers, dropout 0, 16b's padded feed with unequal masked-LM weights
   per rank (rank 0's rows keep one prediction, rank 1's all): 3 Adam
   steps from one startup scope, the first loss within 1e-6, the first
   step's @GRADs within 1e-5 of their scale, the later losses within
   1e-3 (phase 20b's staged tolerances: the sentence embedding's
   backward is not bitwise on the card); then dp 2 with the plain dense attention
   put in at ``attention_ops``: the kernels' losses and @GRADs within
   9b's tolerances;
21c. GPT at phase 9's width (GPTConfig(max_position=1024, dropout=0),
   seq 512 x batch 8, Adam 1e-4) on a local dp 2 x sp 2 mesh (``with_
   mesh(make_mesh(dp=2, sp=2, devices=["cuda:0"] * 4))``: each dp rank's
   attention rings over sp 2), 3 steps against dp 1: the first loss
   within 1e-5, the first step's @GRADs within 1e-4 of their scale, the
   later losses within 1e-3; 12 layers x 2 ranks x 3 causal ring steps =
   72 flash forward, dQ and dK/dV launches a step;
21d. the world form: two processes on cuda:0 joined by gloo (this script
   with ``--dp-world-rank``), one dp rank each, run 21b's program (depth
   cut to 2 layers, as 21b) for 3 steps through ``with_data_parallel()``
   over the world: both ranks' losses equal 21b's dp 2 run's (1e-6 the
   first, 1e-3 the later) and their first step's @GRADs 21b's (1e-5 of
   their scale: a gradient counted dp times, or of part of the batch,
   shows there, where Adam's first update would hide its scale from the
   losses), 5 op reductions and one fused gradient
   all-reduce a step, 2 + 2 + 2 flash launches a step a rank; two more
   steps time the all-reduces (ms a step);
22. the recipe under data parallelism: phase 20's cell (nothing cut)
   through ``with_data_parallel(places=[CUDAPlace(0)] * 2)``, 23 steps:
   the loss below 0.95 x the first and finite, 24 + 24 + 24 flash
   launches a step, 5 dp reductions a step; a profile of 3 more steps;
   then 3 steps under ``RecomputeOptimizer("dots")`` at dp 2 from the
   same weights: 48 + 24 + 24 launches a step (the checkpoint re-runs
   each rank's forward), the first loss within 1e-6 of the run
   without, a lower peak memory; prints step ms p50/p99, tokens/s,
   device ms, operations and busy share a step and peak memory beside
   phases 20's and 21's;
23. ResNet-50 training (``bench.py:285-313``'s cell at full width and
   depth: ``resnet.build_train_net(depth=50, class_dim=1000,
   image_shape=(3, 224, 224))``, f32, ``MomentumOptimizer(0.1, 0.9)``),
   batch 32 of synthetic images and labels made on the card from the
   seed, one batch for 23 steps, under torch's default cuDNN setting
   (TF32 allowed: the port's convolution sets f32 itself): every loss
   finite and the last below the first; the first batch norm's running
   mean and variance after step 1 against a plain f64 convolution of the
   step's images by its filter (1e-5), the op's convolution at that
   layer against f64 (1e-5; torch's own call under the process flag
   printed beside it); prints images/s, step ms p50/p99, the
   convolutions' operations and TFLOP/s, peak memory and a profile of
   3 more steps (device ms, operations, busy share, top kernels);
23b. phase 23's net at dp 2 against dp 1 and the plain Executor, 3
   steps from one startup: the first loss, the running statistics after
   step 1 and the first step's @GRADs (as one vector) of dp 2 within 4x
   the plain run's distance from dp 1 or a floor (1e-5, 1e-5, 1e-3);
23c. LeNet (``mnist.build_train_net("conv")``, Adam 1e-3, batch 64) 3
   steps on the card against the port on the CPU: losses within 1e-5,
   @GRADs within 1e-4 of their scale. Phases 23-23c launch none of the
   attention kernels (their counts stay 0);
24. Transformer-base training (``bench.py:315-355``'s cell at full width
   and depth: ``transformer.build_train_net(ModelHyperParams with
   dropout 0, max_len=256)``, vocab 10000 + 10000, d_model 512, FFN
   2048, 8 heads, 6 + 6 layers, label smoothing 0.1, f32,
   ``AdamOptimizer(1e-4)``), batch 16 (4096 target tokens a card), the
   source and target lengths drawn from the seed in 128-256 (the cell
   feeds full lengths): 23 steps on one batch; every step launches the
   f32 flash forward, dQ and dK/dV kernels 18 times each (6 encoder
   self-attentions, 6 causal decoder self-attentions and 6
   cross-attentions, each under a (B, 1, 1, T) padding bias that
   reaches the kernels as a view with stride 0 over heads and queries)
   and never calls ``flash_dbias``; every loss finite and the last below
   0.95 x the first; prints padded and real (token_num) tokens/s, step
   ms p50/p99, the peak memory and a profile of 3 more steps; then the
   first decoder layer's causal self-attention and its cross-attention,
   their operands as the first step called them, against the plain
   version (out and lse, dq/dk/dv of a seeded cotangent);
24b. the tiny Transformer of ``test_model_zoo.py:147`` with one head
   (head_dim 32), a padded batch, 3 Adam steps on the card and in the
   port on the CPU: losses within 1e-5, @GRADs within 1e-4 of their
   scale, 6 + 6 + 6 flash launches a step;
25. DeepFM training (``bench.py:388-416``'s cell: ``deepfm.
   build_train_net(num_features=1000000, num_fields=39, embed_dim=10)``,
   ``AdamOptimizer(1e-3)``, f32), batch 2048 synthetic examples made on
   the card from the seed, 23 steps on one batch: every loss finite and
   the last below the first; prints examples/s, step ms p50/p99, the
   peak memory and a profile of 3 more steps by op (device ms, busy
   share, operations, the embedding backward's and Adam's share);
25b. phase 25's net at dp 2 (``with_data_parallel(places=[CUDAPlace(0)]
   * 2)``) against dp 1 and the plain Executor, 3 steps from one
   startup: the first loss and the first step's @GRADs (each
   embedding's, the ranks' dense scatter-adds summed over dp, and all
   as one vector) within 4x the plain run's distance from dp 1 or a
   floor (1e-6, 1e-5);
25c. Wide&Deep and DIN at ``test_ctr_models.py``'s sizes, 3 steps on
   the card and in the port on the CPU: losses within 1e-5, @GRADs
   within 1e-4 of their scale. Phases 25-25c launch none of the
   attention kernels;
26. ERNIE (phase 16's program and cell at 4 layers, Adam 1e-4, dropout
   0.1) under guarded asynchronous training, 25 distinct ERNIE feeds: two
   clean runs from one startup on ``Executor(guard=True,
   async_window=2)``, one through ``run()``, one through ``run_async()``
   (their distance is the card's own); the host syncs inside 5 warm
   dispatches (torch's sync debug mode: 0); an upload probe (step k ends
   with 50 ms of device sleep: step k+1's pinned feed upload must leave
   it on the card, a pageable copy must wait for it); run against
   run_async in alternating blocks; the guard's cost (an unguarded run:
   p50, device ms and operations); then ``GuardedTrainer``
   (checkpoint_every 10) with a NaN poisoned into step 12's MLM weights,
   the 3rd physical checkpoint write failing and a SIGTERM before step
   20, and a fresh Executor, scope and ``GuardedTrainer.resume()`` to
   step 25: one rollback, the write retried, every step's loss within
   4x the clean runs' distance (or 1e-5) of the clean run's; 4 + 4 + 4
   flash launches a step in every run, flash_dbias 0, the first
   layer's attention against the plain version; checkpoint bytes, sync
   and async save and restore ms, peak memory; then one NaN in a fresh
   step's ``input_mask`` (the attention's padding bias) must raise
   ``NonFiniteError`` when the step's handle resolves;
26b. save_params / save_persistables / save_inference_model and the
   Fluid 1.5 formats (save_fluid_inference_model) from 26's trained
   scope, each reloaded in a fresh Scope and Executor: the pooled output
   and the MLM logits bitwise the trained program's clone(for_test=True),
   4 forward launches a reloaded forward, the persistables bitwise;
26c. ``run_pipelined`` over 20 batches of 26's ERNIE (the last 5 rows,
   padded to 8 by a FeedBucketer) against run() over the same feeds
   from the same startup: losses in feed order within 26's tolerance;
   the prefetch depth and each copy's share hidden under earlier steps;
26d. phase 25's DeepFM through ``train_from_dataset`` over 4 generated
   MultiSlot files (16,384 examples, 4 native parse threads, 8 batches
   of 2048): the native parser ran, the losses match run() over the same
   batches; examples/s of both. No attention kernel.
27. ERNIE-base (phase 16's cell, dropout 0) under
   ``GradientMergeOptimizer(AdamOptimizer(1e-4), k_steps=4, avg=True)``
   over 8 sub-batches of 8, against plain Adam on the same sub-batches
   concatenated to batch 32, run twice: the merged gradient and the
   parameters after each apply step within 4x the two big-batch runs'
   distance (or a floor), off-steps bitwise, the off-step's and apply
   step's device ms;
27b. LARK's shape: ``contrib.extend_with_decoupled_weight_decay(
   AdamOptimizer)(1e-6, learning_rate=1e-4)`` inside
   ``LookaheadOptimizer(alpha=0.5, k=5)`` with an EMA (0.999,
   thres_steps) and a ModelAverage, 10 steps: fast == slow bitwise and
   slow as the formula at steps 5 and 10, EMA and ModelAverage apply()
   against numpy on the word embedding, layer 0's Q projection and the
   MLM bias, restore() bitwise, a nested apply unwinding one level, 12
   forward launches under apply();
27c. ``DGCMomentumOptimizer(1e-3, 0.9, rampup_begin_step=2,
   sparsity=(0.999,))`` at dp 2 on this card, 6 steps: the dense steps
   equal Momentum's, each sparse step changes at most 0.1 % (+1) of a
   tensor's entries and leaves the masked-out velocity in V exactly, dp 2
   within 4x two dp 1 runs' distance;
27d. "offload" (in 20b), ``Optimizer.set_lr`` (the next step's update
   scales with it, the step before does not, the LR var filled in
   place), ``train_from_dataset`` under ``with_data_parallel()`` at dp 2
   against run() at dp 2, and ``parallel.data_parallel_step`` over a
   two-process gloo world (2 layers) against the local mesh. Every 27
   run launches 12 + 12 + 12 flash kernels a step (24 each at dp 2) and
   prints step p50, device ms and operations a step and peak memory.
28. semantic role labeling at the book's widths: ``label_semantic_roles.
   db_lstm(word_dim=32, mark_dim=5, hidden_dim=512, depth=8)`` over the
   conll05 dictionaries (44068 words, 3162 predicates, 59 labels) with
   ``linear_chain_crf`` and ``crf_decoding``, 32 conll05 sentences
   padded to 32, Adam(1e-3), 30 steps: the loss finite and falling (the
   last 5 steps' mean below the first 5's), every row's NLL >= -1e-4 x
   its gold score's magnitude, the Viterbi path's score (recomputed in
   float64 on the host) >= the gold path's and within 1e-4 of the
   float64 maximum; ``chunk_eval`` (IOB, 29 types) printed; the forward
   recurrence's share of a step's device ms and operations;
28b. phase 28's net at depth 2, T 16, batch 4, one startup on the card
   and on the CPU (TF32 off): each row's NLL within 1e-5, each @GRAD
   within 1e-4 of its largest entry, the Viterbi paths equal apart from
   rows with a float64 near tie;
28c. phase 28's cell at dp 2 (``with_data_parallel(places=[CUDAPlace(0)]
   * 2)``) against dp 1, 3 steps: losses and first-step @GRADs within
   4x two plain runs' distance or 1e-5 of their scale; ``chunk_eval``'s
   counts equal dp 1's; a ragged ``sequence_expand`` refuses;
28d. CRNN-CTC OCR: ``ocr_recognition.crnn_ctc_net`` on (1, 48, 384)
   images (48 columns of 384 features), 95 classes, a bidirectional GRU
   stack of hidden 200, ``warpctc`` over labels of 4-16 ids, batch 32,
   Adam(1e-3), 40 steps on one batch: the last loss below 0.5x the
   first; the greedy transcription (-1-padded, counts equal to the non
   -1 entries) and its ``edit_distance``; the port's CTC recursion
   against ``F.ctc_loss`` within 1e-4 (both timed); the port's GRU
   against a cuDNN ``torch.nn.GRU`` (timed only);
28e. stacked-LSTM sentiment (``lstm_text.stacked_lstm_net(emb_dim=128,
   hid_dim=512, stacked_num=3)``, imdb's 5147-word dictionary, T 128,
   batch 128, 20 steps: every loss finite; one lstm op against a cuDNN
   ``torch.nn.LSTM``, timed only) and the recommender
   (``recommender.build_train_net()``, 6041 users, 3953 movies, batch
   256, 20 steps: the loss falls). Every 28 phase prints step p50, device
   ms and operations a step, the busy share and peak memory beside the
   card's name and power limit, and launches no attention kernel (the
   flash and paged counts gated at 0);
29. contrib.decoder's seq2seq at WMT14's widths, built from public
   layers here: a source embedding (30000 x 512), an ``fc`` to 3 x 512,
   a ``dynamic_gru`` of 512 over the padded source with lengths,
   ``sequence_last_step`` and an ``fc`` with tanh to the decoder's
   ``InitState``; a ``StateCell`` whose updater is ``fc(concat([x, h]),
   512, tanh)``, a ``TrainingDecoder`` over the time-major teacher-forced
   ids with a target embedding (30000 x 512), a softmax ``fc`` of 30000,
   ``cross_entropy`` and ``mean``, Adam(1e-3); 64 ``wmt14.train()``
   pairs padded to 32, 30 steps on the fixed batch: every loss finite,
   the last 5 steps' mean below the first 5's; the host syncs of a
   training dispatch printed, and the recurrences' share of a step's
   operations;
29b. ``BeamSearchDecoder(beam_size=4, max_len=32, end_id=1,
   length_penalty=0)`` on phase 29's trained parameters (by name) for
   the 64 sources: the ids (64, 4, 32) in [0, 30000), the scores sorted
   best first, and each row's top beam (and its other three beams)
   replayed teacher-forced through phase 29's Program
   (``clone(for_test=True)``), whose float64 sum of
   ``log_softmax(log(p + 1e-9))`` of its ids up to and including the
   first end id equals the beam's score within 1e-4 relative; the
   decode's ms and its dispatch's host syncs printed;
29c. phase 29's Program and 29b's decoder at batch 4, T 8 and the same
   widths, one startup on the card and on the CPU (TF32 off): the loss
   within 1e-5, each @GRAD within 1e-4 of its largest entry, the beam
   ids equal apart from listed near ties (the differing beams' scores
   within 1e-5); then each construct of the JAX package's control-flow
   tests on the card against its closed-form answer (While's 45 / 10,
   cond both ways, switch_case 20, StaticRNN's cumsum, a Switch
   schedule on ``autoincreased_step_counter`` over 12 steps, IfElse's
   row merge, DynamicRNN's frozen accumulator, the arrays through
   ``tensor_array_to_tensor``, while_loop's 5 / 10, py_func's sort,
   Print's text), the host syncs of one dispatch of each (StaticRNN,
   DynamicRNN, Switch and IfElse gated at 0; While, cond, switch_case,
   while_loop and py_func printed beside their iteration counts) and the
   host µs a While iteration costs. Every 29 phase prints step p50,
   device ms and operations, the busy share and peak memory beside the
   card's name and power limit, and launches no attention kernel (the
   flash and paged counts gated at 0).
30. detection through the Fluid entry points: SSD training at SSD300's
   width (``detection_demo.build_ssd_net(num_classes=21, image_size=300,
   max_boxes=16)``: 38^2 and 19^2 maps, 7,942 priors), batch 32 of seeded
   images and 16 gt boxes each, Adam, 10 steps on the batch: the loss
   finite and falling, 0 host syncs in a training dispatch;
30b. SSD inference through ``detection_output`` (``build_infer_net`` at
   the same width on phase 30's weights, ``clone(for_test=True)``;
   nms_top_k 400, keep_top_k 200): 0 host syncs in a dispatch; the card's
   decoded boxes and class scores within 1e-5 of the CPU's on the same
   feed and weights; the multiclass_nms op on the CPU on the card's boxes
   and scores gives the card's (32, 200, 6) rows (classes and survivor
   sets equal, rows within 1e-5); ``inference.postprocess.
   multiclass_nms_host`` over ``csrc/nms.cc`` (built there) keeps each
   image's survivor set; the NMS sweep's device operations and host ms;
30c. Faster R-CNN training at PaddleCV's Fluid 1.5 COCO width
   (``build_faster_rcnn_train(batch=2, num_classes=81, image_size=800,
   max_gt=32, rpn_samples=256, rcnn_samples=512, post_nms=64)``: 30,000
   anchors an image), 10 Adam steps on a seeded batch, the loss finite and
   falling (the syncs of a dispatch printed); then the deterministic
   configuration of tests/test_torch_detection_models.py (image 64, every
   anchor and roi sampled) from one CPU startup on the card and on the
   CPU: the first step's loss within 1e-5 relative, each @GRAD within 1e-4
   of its largest entry, the inputs' IoUs 1e-4 or more from the
   thresholds. Every 30 phase prints step p50, device ms and operations,
   the busy share and peak memory, and launches no attention kernel.
31. the vision nets and the activation family (31-31g: MobileNet v2 and
   v1 at ImageNet width, DeepLabv3+ at VOC's crop, TSM, DCGAN, the book
   nets, and the slice's ops on the card against the CPU; the constants'
   comments say what each gates).
32. DeepFM at phase 25's width with the streaming ``layers.auc(prob,
   label, 4095)`` in the training Program, 10 Adam steps over a new
   batch each: after every step the persistable statistics equal numpy's
   histograms of the card's own fetched probabilities and labels with
   the op's buckets, exactly, and the AUC is within 1e-5 of numpy's
   float64 AUC over them; the loss falls; 0 host syncs in a dispatch;
   step p50 with and without the metric, the auc op's device ms and
   operations;
32b. the same Program at dp 2 on one card against dp 1 over 4 batches:
   the statistics count the global batch once, the AUCs within 1e-5;
32c. DeepLabv3+ at VOC's 513² crop (phase 31c's) with ``layers.argmax``
   of the transposed logits and ``layers.mean_iou`` in the Program, 5
   steps: OutCorrect and OutWrong equal numpy's confusion matrix of the
   fetched argmax, the mIoU within 1e-6, 0 host syncs in a dispatch; then
   a mean_iou call on the card with 5 % of its labels 255 (VOC's ignore
   label): no device assert, those pixels left out, the CPU's outputs;
32d. every one of the slice's 71 tensor, math, loss and metric ops on
   the card against the CPU (forward and gradient; integers equal), the
   host syncs of each op's call (``where``, ``unique``,
   ``unique_with_counts``, ``has_inf``, ``has_nan`` gated at 0); the four
   distributions on the card against the CPU and their draws' moments;
   the MSRA, TruncatedNormal, Bilinear and NumpyArray initializers at a
   ResNet-50 conv weight's shape (Bilinear and NumpyArray exact). Phases
   31-32d launch no attention kernel (gated at 0).
33. QAT MobileNet-v1 at phase 31b's ImageNet recipe (224², 1000 classes,
   batch 64, Momentum(0.1, 0.9), L2 4e-5): ``quant.QuantizationTransform``
   before minimize, 8 steps: the loss falls, 0 host syncs in a dispatch,
   the image's moving-average scale numpy's recurrence after each step;
   then ``QuantizationFreezePass`` and ``ConvertToInt8Pass``: the frozen
   output bitwise the test-mode QAT clone's, every int8 weight numpy's;
   step p50, device ms, operations and the fake-quant share beside 31b's
   float v1;
33b. one QAT step at MN_AGREE on the card and on the CPU from one
   startup: each rounding flip between the devices shown to be one and
   the CPU step rerun on the card's codes there, then held to 31b's
   tolerances;
33c. PTQ ResNet-50 at 224²: ``calibrate_program`` over 4 batches of 16
   (each scale numpy's max|act|, exactly; the card's scales the CPU's
   within 1e-4), ``apply_ptq`` at both weight granularities, the card's
   logits within 4 units of the last layer's quantization step of the
   CPU's; float and PTQ forward ms, the PTQ logits' error and top-1
   agreement against float;
33d. the word2vec N-gram trunk at the One Billion Word Benchmark's
   793,471 words under four heads (the model's full softmax, ``layers.
   nce`` with 64 log-uniform negatives, ``layers.hsigmoid``'s depth-20
   tree, ``layers.sampled_softmax_with_cross_entropy`` with 8192
   samples), batch 512, Adam, 6 steps each: the loss falls (NCE's cost
   on the first step's draws), 0 syncs, the first step's cost within 1e-5
   of float64 numpy's on the op's own draws; 2^20 log-uniform draws on
   the card within a KS distance of 4e-3 of the Zipf CDF;
33e. every op of the slice (the 11 quant ops, the samplers through their
   score halves on given draws, hsigmoid, the 5 match ops at
   MatchPyramid's and TBCNN's sizes) on the card against the CPU, 0 host
   syncs each; ``slim.Pruner`` at 50 % on MobileNet-v1 (pruned entries
   exactly 0 through 3 Momentum steps), and a ResNet-50 teacher merged
   into a MobileNet-v1 student by ``slim.merge_programs`` (3 steps of
   soft-label distillation at T 4: the teacher's persistables bitwise
   unchanged). Phases 33-33e launch no attention kernel (gated at 0).
35. fleet collective training through the port's launcher: two ranks
   of this script (``--fleet-world-rank``) started by ``python -m
   paddle_tpu_torch.distributed.launch --selected_gpus=0,0``, gloo chosen
   by that layout; phase 16/34's BERT-base under
   ``DistributedStrategy(tp_degree=2)`` through
   ``fleet.distributed_optimizer(Adam).minimize`` and
   ``CompiledProgram(main).with_mesh(fleet.mesh())``, FLEET_STEPS steps:
   the first loss phase 34's within 1e-6, the first step's @GRADs a
   local tp 2 step's within FLEET_GRAD_TOL of their scale (the 12-layer
   reordering), 12 + 12 + 12 flash launches a step a rank (the rank's
   own counts, none of the bf16 kernel),
   each scope holding the tp shares; reductions and gloo ms a step. In
   the same processes: the 2-layer net at sp 2 over the world (the
   ring's K/V rotating between them) against a local sp 2 run, the
   collective ops on CUDA tensors against numpy, barrier_worker and
   ``global_shuffle(fleet=)`` (the union the whole set);
35b. fleet in this process, ``DistributedStrategy(tp_degree=2,
   zero_stage=1, local_devices=["cuda:0"] * 4)``: dp 2 x tp 2, BERT-base
   for BERT_WARM + FLEET_B_STEPS steps, the first loss phase 21's and
   the first @GRADs a dp 2 step's, 48 + 48 + 48 launches a step (four
   positions), step p50, device ms and peak memory;
35c. four ranks through the launcher: 35b's form at 2 layers over a
   world of four (dp 2 x tp 2), against its local form; each scope's
   elements the dist_attrs' shares;
36. pipeline parallelism: phase 9's GPT-base (12 layers, seq 512, batch
   8, its startup weights) through ``PipelineOptimizer(Adam,
   cut_list=`` the last residual add of blocks 2, 5, 8 ``,
   num_microbatches=4)`` on four positions of cuda:0
   (``make_mesh(pp=4)``), 4 steps against the plain step: first loss
   within 1e-6, later 1e-5, @GRADs (the tied word embedding's too)
   within FLEET_GRAD_TOL, 48 + 48 + 48 f32 flash launches a step, a
   falling loss, one profiled step; then ``pipeline_1f1b`` with one
   pre-norm GPT-2 block a stage at width 768 (mb 2 x 512) at M 8 and 16
   against a sequential autograd run: 2M + M + M launches a stage, the
   in-flight peak at M 16 within 5 % of M 8's, ``schedule_stats`` =
   ``bubble_fraction``;
36b. four ranks through the launcher (gloo on cuda:0), booted beside 36
   and 36c: ``DistributedStrategy(pp_degree=4)`` on the GPT at 4 layers,
   one block a rank, against 36's local form at 4 layers (first loss
   1e-6, @GRADs 1e-5 of scale, 4 + 4 + 4 launches a step a rank, the
   step and its gloo ms); then ``DistributedStrategy(ep_degree=4)`` on
   36c's Program against 36c's local ep 4;
36c. ``layers.moe`` at Switch-Base-8's FFN width (768, 3072, 8 experts,
   top-1, capacity factor 1.25) over 8 x 512 tokens, SGD: dense on the
   card, ep 4 on four positions of cuda:0, ep 4 on the CPU from the
   card's weights: experts equal card vs CPU (near-ties counted),
   outputs within 1e-5 of their scale, ep 4 = dense within 1e-5 at
   capacity factor 8, the dropped share at 1.25 printed, no flash
   launch;
37. inference through Fluid's entry point: BERT-base (16's config) as a
   3-label classifier at seq 128, random weights, save_inference_model on
   the card, create_predictor with buckets (1, 8, 32): predict_batch of
   3, 8 and 40 rows (40 as 32 + 8) within 1e-6 of Executor.run of the
   for_test clone on each run's rows, 12 flash launches a bucket run;
   the forward kernel against its plain version at the path's shapes (B
   1, 3, 8, 32 f32 and B 8 bf16 x H 12 x T 128 x D 64 under the key
   padding bias), and the bucket runs 8 and 32 + 8 within 1e-5 of the
   clone run with the plain dense attention put in (0 flash launches;
   the clone without key padding must lie farther);
   enable_bf16 within 3e-2 of f32 and of its own scope run with the
   plain attention (which forward kernel ran printed);
   enable_int8 over 4 calibration batches within 0.1 of the scale, both
   int8 counters moved; the reference __model__ export served within
   1e-6; tp 2 on two positions of cuda:0 within 2e-5, >= 4 tp-sharded
   persistables, the mesh's reductions moving each run;
37b. generation_server at GPTConfig() width: the LM net exported from
   its startup, enable_generation with 16 slots and block 16 serving
   phase 2's first 16 prompts, ids bitwise a direct GenerationServer's
   over the same parameters; enable_int8: 72 int8 weights, an int8 pool,
   ids bitwise a direct server's over quantize_int8() with
   kv_dtype="int8"; one fused step signature, the kernel engaged,
   launches = iterations x layers;
37d. BatchingServer (the native queue) over 37's Predictor: 8 threads x
   16 single-row requests, each within 1e-5 of its row alone through
   Predictor.run, the mean batch above 1; requests/s, p50 / p99;
37e. the paged decode adapter at GPT width: 64 greedy steps through
   gpt.build_kv_step over build_paged_decode_cache (16 rows x 128
   positions) against over init_kv_cache, ids bitwise in f32 and bf16,
   int8 pools' agreement printed, the pool's blocks back;
37f. Executor.explain on 37's classifier and on 16's training Program:
   no step runs (step counter, every scope tensor's _version), flops > 0,
   the attribution model_stat's, peak >= parameter + optimizer bytes;
   the estimate beside max_memory_allocated over one real step;
37c. save_aot_model of 37's Predictor at batches 1 and 8 (torch.export):
   the graphs call aten ops and paddle_tpu_torch.flash_attention_fwd
   only (and the getitem unpacking its outputs), loaded once the
   Predictor is dropped, within 1e-5 of Predictor.run, 12 flash launches
   a run through the op, batch 5 refused; export seconds and bytes.

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
paged kernel;

    python3 chip_smoke.py --host-cost-of <checkout>

the host microseconds of one flash forward call and phase 16's step p50
with that checkout's package (the parent's direct ctypes launch against
the registered op; with the op, its kernel called without the
dispatcher in turns beside it), and

    python3 chip_smoke.py --inference-phases

the build and phases 37-37f alone.

Each phase prints its seconds. The line before the last is a JSON object
with the kernel table (the paged kernel's dense and int8 variants, the
flash-attention forward's bf16 (wgmma) and f32 (mma.sync) kernels and
the flash-attention backward; the paged entry also counts the launches
of phases 11-15, 18-18d (the workers' own counts among them) and 19-19d
(19d's ranks' own) in ``launches_by_path``, the int8 entry those of
phases 2b, 18b and 19b, the flash entries those of phases 16-17, 19c,
20-20d, 21-21d, 22, 24-24b, 26-26c, 27-27d, 34-34d, 35-35c, 36-36b
(the world ranks' own counts), 37, 37c and 37d, the paged entries also
37b's, and 28-28e's, 29-29c's, 30-30c's,
31-31g's, 32-32d's, 33-33e's and 36c's gated 0s,
with 16b/16c/17/19b/19c/20d/21b/21c/24/24b/26's errors and 37's path
shapes in ``path_errs``); the line before
it the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``. Exits non-zero, printing no result, when CUDA is
unavailable or any phase fails.
"""

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
TIER_TURN_REQUESTS = 16             # phase 14: each bf16 turn's requests
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
BERT_STEPS = 20
BERT_PROFILE_STEPS = 3
# phase 16's gate: the last of the 23 steps' losses below this share of
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
# phases 18-18d: bench.py's fleet traffic (its tenant long tail) at
# full-width lengths, 16 slots, block 16, chunk 16, context 1024
FLEET_TENANTS = 18
FLEET_TENANT_LEN = 128
FLEET_SHARED = 0.85                 # share of requests behind a tenant
FLEET_REQUESTS = 96
FLEET_PHASE_REQUESTS = 48           # 18: the fleet traffic's first requests
FLEET_NEW = 32
FLEET_REPLICAS = 3
FLEET_GATE = 24                     # the f32 gates' first requests
FLEET_GATE_NEW = 16
FLEET_KILL_AT = 6                   # router iteration of 18's and 18d's kill
SELF_HEAL_REQUESTS = 12             # 18c's requests beside the poison
FLEET_CKPT_SEQ = 64                 # the checkpointed Program's seq_len
FLEET_PROGRAM_SEED = 13
WIRE_PROMPT = 512                   # 18d: the chain handed over the RPC
# 18's pressured pools: 16 lanes of a mean lane's own blocks (6: a
# tenant request's 1-64 token suffix and 32 new tokens, a private
# prompt's whole chain, 85:15) beside two tenants' 8-block chains and
# the NULL block, as bench.py sizes its replicas (num_blocks=25) so that
# one replica cannot cache every tenant
FLEET_PRESSURE_BLOCKS = 1 + 16 * 6 + 2 * 8
WORKER_SPAWN_S = 180.0
WORKER_TURN_REQUESTS = 48           # 18d: each bf16 turn's requests
TP = 2                              # phases 19, 19c, 19d: tp 2
TP_GQA = (2, 4)                     # 19b: H 6 over 2, H 3 over 1 KV heads
TP_AGREE = 16                       # 19, 19b: the f32 gates' prompts
# 19b: int8 KV's near-tie bound on a logp, set after the exact ids gate
# failed on the card (one request of 16 at tp 2), from the int8 code
# step: a flipped code moves one K/V element by a 127th of its row's
# absmax, a few 1e-4 of a logit at these widths
TP_INT8_TIE = 1e-3
TP_WORLD_TIMEOUT_S = 300.0          # 19d: both ranks, boot included
# the JAX tests' tolerances at depth (np.allclose, rtol = atol): the
# output's of test_ring_sp8_8k_tokens, the gradients' of
# test_ring_sp8_long_sequence_grads
RING_OUT_TOL = 3e-5
RING_GRAD_TOL = 2e-4
# phases 20-20d: the training recipe on phase 16's configuration, in the
# shape of PaddlePaddle's LARK BERT recipe: bf16 products under dynamic
# loss scaling, linear warmup then linear decay, the global-norm clip,
# weight decay
RECIPE_PEAK_LR = 1e-4
RECIPE_WARMUP = 4
RECIPE_DECAY_STEPS = 1000
RECIPE_L2 = 1e-2
RECIPE_CLIP = 1.0
RECIPE_SCALE = 2.0 ** 15
# 20: the rate fetched each step against the schedule's closed form in
# f64: a handful of f32 scalar ops, each rounding once (2**-24)
RECIPE_LR_RTOL = 1e-6
# 20: the first loss (bf16 products, f32 accumulation) against phase
# 16's (f32 products) on the same weights, feed and dropout masks: every
# product's inputs rounded to bf16 (2**-9 relative each), the errors of
# both signs averaged over the hidden width, carried through 12 layers
# into a mean over 8 x 20 masked tokens and 8 NSP rows
AMP_FIRST_LOSS_RTOL = 1e-2
RECOMPUTE_POLICIES = ("dots", "nothing", "offload")
RECOMPUTE_STEPS = 3
# 20b: recompute re-runs the same kernels on the same inputs, so the
# first step's loss is expected equal. Its @GRADs are not bitwise even
# between two identical runs without recompute (on an H100 they differ
# by ~5e-7 of their scale: some accumulation in the step's backward has
# no fixed order), so they are held to a few f32 roundings, relative to
# each gradient's max (the floor as 9b's). Later steps' weights come
# from updates of those gradients, and a last-bit difference in a
# weight can flip its bf16 rounding at the next product: their losses
# are held to 20d's bf16 tolerance
RECOMPUTE_LOSS_TOL = 1e-6
RECOMPUTE_GRAD_TOL = 1e-5
# 20b: "dots" must-saves the outputs of the forward's 2-D products
# (aten.mm / aten.addmm), "nothing" saves a segment's inputs alone, so as
# the backward starts "dots" holds about those products' bytes more. A
# policy whose saving never fired would hold the same; an output that is
# also a segment's boundary is held under both, hence the half
RECOMPUTE_DOTS_HELD_SHARE = 0.5
OVERFLOW_SCALE = 3e38               # 20c: the loss-scaling var, one step
OVERFLOW_STEPS = 3                  # 20c: steps before and after it
# 20d: kernel vs plain attention under the recipe, measured as 9b's. The
# attention is f32 on both sides (1e-5 apart, 9b), but its output is
# rounded to bf16 at the next product's input, where a difference of an
# ulp of f32 flips a bf16 rounding (2**-8 relative) now and then: the
# agreement is bf16's, as tests/test_torch_amp.py's against JAX (loss a
# quarter of a bf16 step, gradients eight)
AMP_AGREE_LOSS_TOL = 1e-3
AMP_AGREE_GRAD_TOL = 2.0 ** -5
DP = 2                              # phases 21-21d: a dp 2 mesh on one card
# 21b and 21d (dp 2 against dp 1, the world against the local form):
# phase 20b's staged tolerances; the sentence embedding's backward sums its
# lookups in no fixed order on the card, which later steps amplify
DP_FIRST_LOSS_TOL = 1e-6
DP_GRAD_TOL = 1e-5
DP_LATER_LOSS_TOL = 1e-3
# 21c (dp 2 x sp 2 against dp 1): the ring merges two chunks' outputs by
# their lse, another rounding than one flash call over T
DP_SP_FIRST_LOSS_TOL = 1e-5
DP_SP_GRAD_TOL = 1e-4
DP_REDUCTIONS = 5                   # BERT's dp reductions a step
DP_WORLD_TIMEOUT_S = 300.0          # 21d: both ranks, boot included
DP_WORLD_TIMED = 2                  # 21d: steps timing the all-reduces
# phases 34-34d: sharded state under CompiledProgram. 34: tp 2 on one card
# (both ranks on cuda:0); its 2-layer agreement with tp 1 and the world's
# with the local runs use 21's staged tolerances (the tp partial sums add
# in rank order: another f32 summation order than tp 1's one product)
TP_TRAIN_STEPS = 10                 # 34: timed steps after BERT_WARM
SHARD_STEPS = 10                    # 34b: timed FSDP + ZeRO-1 steps
FSDP_MIN_SIZE = 1024                # shard_params_fsdp's default
CKPT_DIVERGE = 2                    # 34d: steps between save and restore
CKPT_CONTINUE = 3                   # 34d: steps after each restore
CKPT_ELASTIC_DP = 4                 # 34d: the mesh it reshards onto
SHARD_FORMS = ("plain", "zero1", "fsdp", "both")
SHARD_WORLD_TIMED = 1               # 34c: steps timing the gathers
# phases 35-35c: fleet collective training through the port's launcher;
# every world's ranks share cuda:0 (gloo by the layout), and each form is
# held to its local form with 21's staged tolerances
FLEET_STEPS = 2                     # 35: BERT-base steps, tp 2 world
FLEET_B_STEPS = 5                   # 35b: timed steps after BERT_WARM
FLEET_WORLD_TIMEOUT_S = 300.0       # 35, 35c: the launcher, boot included
# the 12-layer forms' @GRAD gate (35's tp 2 world against a local tp 2
# step, 35b's dp 2 x tp 2 against a dp 2 step), of each tensor's scale.
# Each form sums the same f32 terms in another order than its reference
# (a world rank runs a replicated layer's backward on its partial and the
# partials are summed after it; 35b adds the tp partials of each dp
# rank), and the reordering grows with depth: on an H100 a query weight's
# @GRAD moves 1.77e-5 (35) and a key bias's 2.22e-5 (35b), the same
# digits in every call and 6.4e-7 between two runs, where the local tp 2
# step itself lies 3.25e-5 from the plain one at 12 layers and 5.5e-6
# from tp 1 at 2 (phase 34's agreement). The 2-layer forms (35's sp 2,
# 35c) keep DP_GRAD_TOL
FLEET_GRAD_TOL = 3e-5
# phases 23-23c: bench.py's ResNet cell (bench.py:285-313), on the port
RESNET_DEPTH = 50
RESNET_CLASSES = 1000
RESNET_IMAGE = (3, 224, 224)
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_BATCH = 32                   # a card (PaddleCV: 256 over 8 cards)
RESNET_WARM = 3
RESNET_STEPS = 20
RESNET_PROFILE_STEPS = 3
RESNET_DP_STEPS = 3                 # 23b
# 23: the first batch norm's running statistics against momentum x
# their start + (1 - momentum) x the statistics of an f64 convolution:
# the f32 convolution (147 products a cell) and the f32 batch sums over
# 32 x 112 x 112 cells each round a few times 2**-24
RESNET_BN_TOL = 1e-5
# 23: the op's convolution against f64 at that layer, over the output's
# largest magnitude: f32 products (TF32's 10-bit mantissa would give
# about 1e-3)
CONV_F32_TOL = 1e-5
# 23b: dp 2 against dp 1 on the same weights: each rank's batch
# statistics sum in another order, and cuDNN's algorithms at batch 16
# and 32 do not sum in one fixed order. Each distance is held to
# RESNET_DP_SPREAD x the plain run's from dp 1 (the same numbers in a
# third order) or its floor: the first loss 1e-5, the statistics after
# the first step 1e-5 of their scale, the first step's @GRADs 1e-3 of
# their norm. The f32 backward through 53 batch norms is ill conditioned
# at random weights: on the CPU (64 x 64 and 128 x 128, batch 8) the
# @GRADs of each f32 run lie 1.5-1.7 % (in norm) from an f64 run's, and
# 0.8-1.7 % from each other
RESNET_DP_LOSS_TOL = 1e-5
RESNET_DP_STAT_TOL = 1e-5
RESNET_DP_GRAD_TOL = 1e-3
RESNET_DP_SPREAD = 4.0
# 23c: LeNet on the card against the port on the CPU: f32 on both sides
# (cuDNN without TF32 against the CPU's convolution), Adam(1e-3), 3 steps
LENET_BATCH = 64
LENET_STEPS = 3
LENET_LOSS_TOL = 1e-5
LENET_GRAD_TOL = 1e-4
# 24: bench.py:315-355's Transformer-base cell at full width and depth
# (ModelHyperParams: vocab 10000 + 10000, d_model 512, FFN 2048, 8 heads,
# 6 + 6 layers, label smoothing 0.1; dropout 0, as the cell sets it),
# max_len 256, f32, Adam(1e-4), batch 16 a card (16 x 256 = 4096 target
# tokens, PaddleNLP's per-card token batch); src/tgt lengths drawn from
# the seed in TF_LENS (the cell feeds full lengths) so that the padding
# biases and the masked loss do real work
TF_MAX_LEN = 256
TF_BATCH = 16
TF_LENS = (128, 256)
TF_LR = 1e-4
TF_WARM = 3
TF_STEPS = 20
TF_PROFILE_STEPS = 3
TF_LOSS_MARGIN = 0.95
# 24b: test_model_zoo.py:147's tiny Transformer (vocab 64, d_model 32,
# FFN 64, 2 + 2 layers) with one head (head_dim 32, the kernels'
# smallest) on the card and in the port on the CPU, 3 Adam(1e-3) steps
# on a padded batch: f32 on both sides, the flash kernels (three TF32
# passes a product) against the CPU's plain attention
TF_AGREE_CFG = dict(src_vocab_size=64, trg_vocab_size=64, d_model=32,
                    d_inner_hid=64, n_head=1, n_layer=2)
TF_AGREE_LEN = 12
TF_AGREE_LENS = ((12, 10), (7, 12), (9, 5), (3, 8))   # (src, tgt) a row
TF_AGREE_STEPS = 3
TF_AGREE_LOSS_TOL = 1e-5
TF_AGREE_GRAD_TOL = 1e-4
# 25: bench.py:388-416's DeepFM cell (1,000,000 features, 39 fields,
# embed 10, the (400, 400, 400) tower, Adam(1e-3)), batch 2048 a card
# (the port's choice: bench.py's 8/16 sweep is a TPU-window size), one
# synthetic batch from the seed, made on the card
DEEPFM_FEATURES = 1_000_000
DEEPFM_FIELDS = 39
DEEPFM_EMBED = 10
DEEPFM_LR = 1e-3
DEEPFM_BATCH = 2048
DEEPFM_WARM = 3
DEEPFM_STEPS = 20
DEEPFM_PROFILE_STEPS = 3
# 25b: dp 2 against dp 1 on the same weights. torch's CUDA embedding
# backward sums each row's contributions in no fixed order (ROADMAP C),
# so each distance is held to DEEPFM_DP_SPREAD x the plain run's from
# dp 1 or its floor: the first loss 1e-6, the first step's @GRADs
# (each embedding's, and all as one vector) 1e-5 of their norm
DEEPFM_DP_STEPS = 3
DEEPFM_DP_LOSS_TOL = 1e-6
DEEPFM_DP_GRAD_TOL = 1e-5
DEEPFM_DP_SPREAD = 4.0
# 25c: Wide&Deep and DIN at test_ctr_models.py's sizes (batch 32,
# Adam(1e-2)), 3 steps on the card against the port on the CPU: f32
# products on both sides
CTR_AGREE_STEPS = 3
CTR_LOSS_TOL = 1e-5
CTR_GRAD_TOL = 1e-4
# phases 28-28e: the sequence, recurrent, CRF and CTC family at the
# book's widths. 28: SRL (db_lstm over conll05's dictionaries, one batch
# of conll05 sentences, Adam)
SRL_WORD_DIM, SRL_MARK_DIM = 32, 5
SRL_HIDDEN, SRL_DEPTH = 512, 8
SRL_BATCH, SRL_LEN = 32, 32         # sentences, their padded length
SRL_LR = 1e-3
SRL_STEPS = 15
SRL_PROFILE_STEPS = 1                # a profiled step holds ~15,000 ops
SRL_CHUNK_TYPES = 29                # IOB over conll05's 59 labels
SRL_NLL_FLOOR = 1e-4                # a row's NLL >= -this x |gold score|
SRL_VITERBI_RTOL = 1e-4             # the path's score vs the float64 max
# 28b: the card against the CPU at a cut depth, TF32 off
SRL_AGREE = {"depth": 2, "hidden": 512, "length": 16, "batch": 4}
SRL_AGREE_NLL_TOL = 1e-5            # each row's NLL, relative
SRL_AGREE_GRAD_TOL = 1e-4           # of each @GRAD's largest entry
SRL_TIE_TOL = 1e-5                  # a near tie: two scores this close
# 28c: phase 28's cell at dp 2 against dp 1 (phase 26's rule)
SRL_DP_STEPS = 3
SRL_DP_SPREAD = 4.0                 # x the distance of two plain runs
SRL_DP_FLOOR = 1e-5                 # or this share of the value's scale
# 28d: CRNN-CTC OCR
OCR_IMG = (1, 48, 384)
OCR_LABEL_LEN = 16
OCR_CLASSES = 95
OCR_HIDDEN = 200
OCR_FILTERS = 16
OCR_BATCH = 32
OCR_LR = 1e-3
OCR_STEPS = 20
OCR_PROFILE_STEPS = 1
OCR_MARGIN = 0.5                    # the last loss below this x the first
OCR_CTC_RTOL = 1e-4                 # warpctc against F.ctc_loss
# 28e: stacked-LSTM sentiment and the recommender
SENT_EMB, SENT_HID, SENT_STACK = 128, 512, 3
SENT_LEN, SENT_BATCH = 128, 128
SENT_LR = 1e-3
SENT_STEPS = 8
SENT_PROFILE_STEPS = 1
REC_BATCH = 256
REC_LR = 1e-3
REC_STEPS = 20
REC_PROFILE_STEPS = 3
SEQ_TIME_REPS = 10                  # 28d/28e's op timings: calls a median
# phases 29-29c: control flow through the Fluid entry points, and
# contrib.decoder's seq2seq at WMT14's widths (the readers' 30000-word
# dictionaries, 512-wide embeddings and state, beam 4)
S2S_VOCAB, S2S_WIDTH = 30000, 512
S2S_BATCH, S2S_LEN = 64, 32         # wmt14.train() pairs, the longest
S2S_BOS, S2S_END = 0, 1             # the dictionaries' <s> and <e>
S2S_LR = 1e-3
S2S_STEPS = 30
S2S_PROFILE_STEPS = 1
S2S_BEAM = 4
S2S_DECODES = 3                     # 29b: timed decodes (after one warm)
S2S_REPLAY_RTOL = 1e-4              # a beam's score vs its replay
# 29c: phase 29's Program cut to batch 4 and T 8 at the same widths, one
# startup on the card and on the CPU, TF32 off
S2S_AGREE = {"batch": 4, "length": 8}
S2S_AGREE_LOSS_TOL = 1e-5           # relative
S2S_AGREE_GRAD_TOL = 1e-4           # of each @GRAD's largest entry
S2S_TIE_TOL = 1e-5                  # differing beams' scores this close
CF_SWITCH_STEPS = 12                # the Switch schedule's steps
CF_WHILE_LONG = 1000                # iterations of the host-µs While
# phases 30-30c: detection. 30: SSD300's width (Liu et al., "SSD", 2016;
# PaddleCV's Fluid 1.5 SSD recipe: 21 VOC classes, 300 x 300 images) on
# detection_demo's backbone, 16 gt boxes an image, batch 32, Adam, f32
SSD_CLASSES, SSD_IMAGE, SSD_BOXES = 21, 300, 16
SSD_BATCH, SSD_LR, SSD_STEPS = 32, 1e-3, 10
SSD_PROFILE_STEPS = 3
SSD_INFER_RUNS = 5                  # 30b: timed inference batches
# 30b: the card's decoded boxes and class scores against the CPU's on
# the same feed and weights (f32 convolutions on both, TF32 off, summed
# in other orders), over each tensor's largest magnitude; the NMS rows
# on the same inputs
SSD_AGREE_TOL = 1e-5
# 30c: PaddleCV's Fluid 1.5 R-CNN config at COCO width (81 classes, scale
# 800, rpn_batch_size_per_im 256, batch_size_per_im 512); the demo fixes
# pre_nms_top_n at 64, so post_nms is 64
FRCNN = {"batch": 2, "num_classes": 81, "image_size": 800, "max_gt": 32,
         "rpn_samples": 256, "rcnn_samples": 512, "post_nms": 64}
FRCNN_LR, FRCNN_STEPS, FRCNN_PROFILE_STEPS = 1e-3, 10, 3
# 30c's card vs CPU: the test twin's deterministic configuration (every
# anchor and roi sampled), one step; the loss relative, each @GRAD over
# its largest entry (the sampled rows sum in another order); the inputs'
# IoUs at least FRCNN_MARGIN from the thresholds
FRCNN_AGREE = {"rpn_samples": 384, "rcnn_samples": 112}
FRCNN_LOSS_TOL, FRCNN_GRAD_TOL, FRCNN_MARGIN = 1e-5, 1e-4, 1e-4
# phases 31-31g: the vision nets and the activation family. 31:
# MobileNet-v2 at ImageNet width (Sandler et al., "MobileNetV2", 2018;
# PaddleCV's Fluid 1.5 image_classification recipe: 3 x 224², 1000
# classes, width 1.0, Momentum 0.9, lr 0.1, L2 4e-5), batch 64 a card,
# f32, on one seeded batch
MNV2_IMAGE, MNV2_CLASSES, MNV2_BATCH = (3, 224, 224), 1000, 64
MN_LR, MN_MOMENTUM, MN_DECAY = 0.1, 0.9, 4e-5
MNV2_WARM, MNV2_STEPS, MN_PROFILE_STEPS = 2, 20, 2
MNV1_STEPS = 8                      # 31b: v1 at the same width
# 31b's card vs CPU: v2 at width 0.25, 64², batch 8, one step from one
# CPU startup
MN_AGREE = {"width_mult": 0.25, "image": (3, 64, 64), "batch": 8}
# 31c: DeepLabv3+ at PASCAL VOC's crop (Chen et al., "DeepLabv3+", 2018:
# 513², 21 classes; the model's base_filters 64), batch 8, Adam 1e-3;
# its card vs CPU at 65², base 8, batch 2
DL_IMAGE, DL_CLASSES, DL_FILTERS, DL_BATCH = 513, 21, 64, 8
DL_LR, DL_STEPS = 1e-3, 8
DL_AGREE = {"image": 65, "filters": 8, "batch": 2}
# 31d: TSM at Kinetics width (Lin et al., "TSM", 2019; PaddleVideo's TSM:
# 8 segments of 224², 400 classes, ResNet-50's (3, 4, 6, 3) blocks at
# base 64, Momentum(0.01, 0.9)), 4 videos; its card vs CPU at 4
# segments of 32², base 16, blocks (1, 1), 2 videos
TSM_SEG, TSM_IMAGE, TSM_CLASSES, TSM_BASE = 8, 224, 400, 64
TSM_BLOCKS, TSM_BATCH, TSM_LR, TSM_STEPS = (3, 4, 6, 3), 4, 0.01, 10
TSM_AGREE = {"seg": 4, "image": 32, "base": 16, "blocks": (1, 1),
             "batch": 2}
# 31e: DCGAN at its width (MNIST's 1 x 28², NOISE_DIM 100, ngf / ndf
# 64), batch 32, Adam 2e-4, alternating D and G steps
GAN_BATCH, GAN_LR, GAN_STEPS = 32, 2e-4, 10
# 31f: the book nets at the JAX tests' sizes, each this many steps on
# one batch; VGG-16's dropout (0.3-0.5 after most layers) holds its loss
# flat for ~18 Adam steps before it falls (a CPU rehearsal: 2.52 -> 2.51
# at step 17, 1.72 at 30, 1.21 at 80)
BOOK_STEPS, VGG_STEPS = 15, 40
# 31b-31e card vs CPU from one CPU startup: the loss relative, each
# @GRAD's largest difference over the step's largest @GRAD (f32
# convolutions and batch norms over a few samples on both, summed in
# other orders)
VISION_LOSS_TOL, VISION_GRAD_TOL = 1e-5, 1e-4
# 31g: each op of the slice on the card against the same op on the CPU
# from one seeded input: the largest difference over the output's (the
# gradient's) largest magnitude; integer outputs equal
OPS_FWD_TOL, OPS_GRAD_TOL = 1e-5, 1e-4
# phases 32-32d: the tensor, math, loss and metric ops. 32: phase 25's
# DeepFM with layers.auc(prob, label, num_thresholds=AUC_THRESHOLDS) in
# the training Program (Fluid 1.5's CTR recipe), METRIC_STEPS Adam steps
# over a new seeded batch each, a METRIC_POS_RATE share of them positive
# (the base rate is what the net can learn from ids it has not seen, so
# the loss falls); then METRIC_TIMED steps with and without the metric.
# 32b: the same at dp DP on one card over AUC_DP_STEPS batches
AUC_THRESHOLDS = 4095
METRIC_STEPS, METRIC_TIMED, AUC_DP_STEPS = 10, 10, 4
METRIC_POS_RATE = 0.1
AUC_TOL = 1e-5                      # the AUC against numpy's float64
# 32c: phase 31c's DeepLabv3+ with layers.argmax of the transposed logits
# and layers.mean_iou in the Program, MIOU_STEPS steps; mIoU within
# MIOU_TOL of numpy's; one more mean_iou call with a MIOU_IGNORE share of
# its labels set to VOC's ignore label 255
MIOU_STEPS, MIOU_TIMED, MIOU_TOL = 5, 3, 1e-6
MIOU_IGNORE = 0.05
# 32d: the distributions' draws and the initializers at a ResNet-50 conv
# weight's shape; a draw's mean within MEAN_SE standard errors and its
# standard deviation within DRAW_STD_RTOL
INIT_SHAPE = (512, 512, 3, 3)
MEAN_SE, DRAW_STD_RTOL = 5.0, 1e-2
# phases 33-33e: the quant, sampling and match ops with quant/ and slim/.
# 33: QAT MobileNet-v1 at phase 31b's recipe (ImageNet width: 224², 1000
# classes, batch 64, Momentum(0.1, 0.9), L2 4e-5, f32; PaddleSlim's
# ImageNet quantization demos train it), QAT_STEPS steps on one seeded
# batch: quant.QuantizationTransform() before minimize (channel-wise
# abs-max on the conv and depthwise filters, per tensor on the fc,
# moving-average abs-max at rate 0.9 on the activations, 8/8 bits)
QAT_STEPS, QAT_PROFILE_STEPS = 8, 2
# the image's moving-average scale against numpy's f32 recurrence
# s <- 0.9 s + 0.1 max|img| (the op's three f32 operations, unfused)
QAT_SCALE_RTOL = 1e-6
# the frozen program's output against the test-mode QAT clone's on one
# batch: bitwise (0). The freeze hands each activation's quantize-
# dequantize the moving average's own f32 value as its static scale (a
# Python float holds it exactly) and re-installs the same weight ops
# (channel-wise on the filters, per tensor on the fc) at the same attrs,
# so every op of the frozen program computes the same f32 function of
# the same inputs as the clone's; cuDNN's and cuBLAS's forward kernels
# give the same bits for the same shapes and inputs
QAT_FREEZE_TOL = 0.0
# 33b: where the two devices' codes differ, each differing value's
# distance from its code's half-way point: the inputs agree within
# OPS_FWD_TOL of their largest (at most the scale), so a value v = 127
# |x| / s moves by at most 127 x 2 x OPS_FWD_TOL between them
QAT_FLIP_EPS = 127 * 2 * OPS_FWD_TOL
# 33c: PTQ ResNet-50 inference at 224², 1000 classes: calibration over
# PTQ_CALIB seeded batches of PTQ_CALIB_BATCH, the card's PTQ logits at
# batch PTQ_BATCH against the CPU's in units of the last layer's
# quantization step. A logit j moves by (s / 127) sum_i W_ij k_i where
# the two devices' quantized fc inputs differ by k_i steps (s the fc
# input's static scale, rounding flips cascading from earlier layers);
# with every input one step off at random sign its standard deviation is
# u_j = (s / 127) ||W_:j||_2, so |delta logit_j| within PTQ_UNITS u_j
# (a wrong scale or rewrite moves the logits by their own size, ~100
# units; a CPU rehearsal with 1e-6 relative noise on the image moved
# them 1.47 units)
PTQ_CALIB, PTQ_CALIB_BATCH, PTQ_BATCH = 4, 16, 4
PTQ_UNITS = 4.0
# 33c: the scales calibrate_program takes on the card against those it
# takes on the CPU over the same batch of PTQ_BATCH, relative. The two
# float forwards differ by summation order only: on the CPU, ResNet-50
# (at 64², batch 2) calibrated at 1 thread against 4 moved its 50 scales
# by 7.3e-7 at most, with 1e-6 relative noise on the image by 1.7e-6;
# cuDNN's f32 algorithms (Winograd, FFT) may round up to ten times worse
# a layer. A wrong calibration (a missed batch, a mean for a max, the
# wrong activation) moves a scale by percents
PTQ_SCALE_RTOL = 1e-4
PTQ_TIMED = 10
# 33d: the large-vocabulary heads at the One Billion Word Benchmark's
# vocabulary (Chelba et al., 2013: 793,471 words) on models/word2vec.py's
# N-gram trunk at its widths (4 context words, a shared embedding of 32,
# hidden 256, sigmoid), batch 512, Adam 1e-3, f32, HEAD_STEPS steps a
# head on one seeded batch of log-uniform (Zipfian) ids: the model's
# full softmax, NCE with 64 log-uniform negatives, hsigmoid's default
# tree (depth 20), the sampled softmax with 8192 samples (Jozefowicz et
# al., 2016)
LM_VOCAB, LM_BATCH, LM_LR = 793_471, 512, 1e-3
HEAD_STEPS = 6
NCE_NEG, SSM_SAMPLES = 64, 8192
HEAD_COST_RTOL = 1e-5               # the first step's cost vs float64
# the log-uniform sampler's draws on the card: a KS distance of about 4
# / sqrt(n) at n = 2^20, which a correct sampler passes with near
# certainty
KS_DRAWS, KS_TOL = 1 << 20, 4e-3
# 33e: MatchPyramid's pair (query 32 x title 128 tokens, embed 128,
# channel_num 4; var_conv_2d 4 -> 8 at 3 x 3, stride 1 and 2; topks (1,
# 3, 5, 10)), TBCNN (4 trees of 256 nodes, feature 64, output 64,
# max_depth 2 and 3); slim.Pruner at 50 % on MobileNet-v1's conv filters
# over 3 Momentum steps; a ResNet-50 teacher distilled into a
# MobileNet-v1 student at 224², batch 32, soft_label_loss at T 4, 3 steps
MP_QUERY, MP_TITLE, MP_EMBED, MP_CHANNELS = 32, 128, 128, 4
TB_TREES, TB_NODES, TB_FEATURE, TB_OUT = 4, 256, 64, 64
PRUNE_RATIO, PRUNE_STEPS = 0.5, 3
DISTILL_BATCH, DISTILL_STEPS, DISTILL_T = 32, 3, 4.0
# phases 26-26c: ERNIE-base (phase 16's program) under guarded
# asynchronous training: GUARD_STEPS steps of distinct ERNIE feeds, the
# async window GUARD_WINDOW, a checkpoint every GUARD_CKPT_EVERY steps, a
# NaN poisoned into step GUARD_POISON_AT, the GUARD_WRITE_FAULT-th
# physical checkpoint write failing, a SIGTERM before step
# GUARD_PREEMPT_AT
GUARD_STEPS = 25
# 26-26c run ERNIE at this depth (phase 16's widths): the checkpoints,
# mostly the Adam state, shrink with the layers (1.32 GB at 12)
GUARD_LAYERS = 4
GUARD_WINDOW = 2
GUARD_CKPT_EVERY = 10
GUARD_POISON_AT = 12
GUARD_WRITE_FAULT = 3
GUARD_PREEMPT_AT = 20
GUARD_COST_STEPS = 6                # the unguarded run's timed steps
# 26's upload probe: step k ends with this much device sleep, so it is
# still on the card when step k+1's feeds are uploaded; GUARD_PROBES times
GUARD_PROBE_SLEEP_MS = 50.0
GUARD_PROBES = 3
GUARD_SYNC_STEPS = 5                # warm dispatches with syncs counted
GUARD_TIMING_BLOCKS = 4             # run / run_async blocks, alternating
GUARD_TIMING_STEPS = 5
# 26: a replayed or resumed run on the card matches the clean run within
# GUARD_SPREAD x the distance between two clean runs (torch's CUDA
# embedding backward sums in no fixed order, as 21b's and 25b's) or the
# floor: an f32 loss (a mean over 8 x 20 masked tokens plus NSP's) a few
# roundings apart, relative
GUARD_SPREAD = 4.0
GUARD_LOSS_FLOOR = 1e-5
PIPE_BATCHES = 20                   # 26c: run_pipelined's ERNIE batches
PIPE_TAIL = 5                       # 26c: the last batch's rows
# 26d: phase 25's DeepFM through train_from_dataset over generated
# MultiSlot files: DATASET_BATCHES batches of DEEPFM_BATCH, split over
# DATASET_FILES files, parsed by DATASET_THREADS native threads; the
# losses against run() over the same batches within DEEPFM_DP_SPREAD x
# two such runs' distance, or this f32 floor (relative)
DATASET_BATCHES = 8
DATASET_FILES = 4
DATASET_THREADS = 4
DATASET_LOSS_FLOOR = 1e-6
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
# phase 1fn: the flash kernels' NaN semantics (ROADMAP C11)
# ---------------------------------------------------------------------------

NAN_FLASH_SHAPE = (2, 3, 128, 128)     # B, H, Tq = Tk: several tiles
NAN_FLASH_CASES = ("bias_visible", "q", "k", "bias_hidden", "bias_segment")
NAN_FLASH_AT = {"bias_visible": (0, 1, 70, 20),
                "bias_hidden": (0, 1, 20, 70),
                "bias_segment": (0, 1, 90, 20), "q": (1, 2, 70, 5),
                "k": (0, 1, 50, 7)}
DEVICE_NAN = 0x7fffffff                # what the card's arithmetic gives


def nan_flash_case(name, dtype, d, causal, gen):
    """(q, k, v, bias, segq, segk, causal, clean bias) of one NaN case: a
    NaN bias at a key the row sees, in q, in k (f32: the card's own NaN,
    0x7fffffff, whose TF32 rounding carries into the sign), at a key
    hidden by the causal mask, or at a key of another segment. The clean
    bias is the same bias with that element 0 (None where the NaN is not
    in the bias)."""
    b, h, t, _ = NAN_FLASH_SHAPE
    q, k, v = (_rand((b, h, t, d), gen, dtype) for _ in range(3))
    bias = segq = segk = clean = None
    at = NAN_FLASH_AT[name]
    if name.startswith("bias"):
        bias = 0.5 * _rand((b, h, t, t), gen)
        bias[at] = 0.0
        clean = bias.clone()
        bias[at] = float("nan")
    if name == "bias_segment":
        segq = torch.ones((b, t), dtype=torch.int32, device=q.device)
        segq[:, 60:] = 2
        segk = segq
    if name in ("q", "k"):
        x = q if name == "q" else k
        if dtype == torch.float32:
            x.view(torch.int32)[at] = DEVICE_NAN
        else:
            x[at] = float("nan")
    return q, k, v, bias, segq, segk, causal, clean


def _bad_rows(x):
    """(B, H, T) bool: rows (the last dimension) with a non-finite entry;
    an lse (B, H, T) as it is."""
    return ~torch.isfinite(x) if x.dim() == 3 else \
        ~torch.isfinite(x).all(dim=-1)


def _rows_seen_by(bad_q, causal, segq, segk, tk):
    """(B, H, Tk) bool: keys that some row of `bad_q` (B, H, Tq) sees
    (the plain version's visibility mask)."""
    from paddle_tpu_torch.ops.cuda.flash import _visible_mask
    vis = _visible_mask(bad_q.shape[2], tk, causal, segq, segk,
                        device=bad_q.device)
    return (bad_q[..., None] & vis).any(dim=2)


def _nan_compare(key, tag, got, ref, tol, exact=True, floor=None):
    """Hold got's non-finite rows to ref's: equal, or (exact False)
    floor <= got <= ref as sets; the rows finite in both within tol.
    Returns (bad rows of got, err)."""
    g, r = _bad_rows(got), _bad_rows(ref)
    if exact:
        if not torch.equal(g, r) or not torch.equal(
                torch.isnan(got), torch.isnan(ref)):
            _fail(f"flash NaN {key}: {tag} non-finite rows "
                  f"{int(g.sum())} / elements {int(torch.isnan(got).sum())}"
                  f", plain {int(r.sum())} / {int(torch.isnan(ref).sum())}")
    elif bool((g & ~r).any()) or bool((floor & ~g).any()):
        _fail(f"flash NaN {key}: {tag} non-finite rows {int(g.sum())} not "
              f"between the rows a visible pair reaches ({int(floor.sum())})"
              f" and the plain version's ({int(r.sum())})")
    fine = ~(g | r)
    err = _flash_err(got[fine], ref[fine]) if bool(fine.any()) else 0.0
    if not err <= tol:
        _fail(f"flash NaN {key}: {tag} finite rows err {err} > {tol}")
    return g, err


def check_flash_nan(flash):
    """Phase 1fn: the f32 and bf16 forward kernels, causal and not, D 64
    and 128, on NAN_FLASH_CASES, against the plain version: every
    non-finite out row, out element and lse entry exactly the plain
    version's, the finite rows within TOLERANCE; a NaN bias at a hidden
    key changes nothing (bitwise the output with that element 0). Then
    the dQ / dK / dV kernels on the forward kernel's out and lse:
    non-finite rows exactly the plain backward's, finite rows within
    BWD_TOLERANCE. The one exception is the plain version's 0 x NaN: its
    products give dK (a NaN in q) or dQ (a NaN in k) a NaN row also where
    the NaN operand meets only hidden pairs, which the kernels' causal
    pruning never visits; under causal those rows lie between the rows a
    visible pair reaches and the plain version's. Returns {case: rows}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    out_rows = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tol, btol = flash.TOLERANCE[dtype], flash.BWD_TOLERANCE[dtype]
        for d in (64, 128):
            for causal in (False, True):
                for name in NAN_FLASH_CASES:
                    if name == "bias_hidden" and not causal:
                        continue
                    key = (f"{name}_d{d}_{'causal' if causal else 'full'}"
                           f"_{tag}")
                    q, k, v, bias, segq, segk, _, clean = nan_flash_case(
                        name, dtype, d, causal, gen)
                    out, lse = flash.flash_attention_cuda(
                        q, k, v, bias, segq, segk, None, causal)
                    ref, rlse = flash.flash_attention_reference(
                        q, k, v, bias, segq, segk, None, causal)
                    rows, ferr = _nan_compare(key, "out", out, ref, tol)
                    _nan_compare(key, "lse", lse, rlse, tol)
                    hidden = name in ("bias_hidden", "bias_segment")
                    if hidden:
                        if bool(rows.any()):
                            _fail(f"flash NaN {key}: a NaN bias at a hidden "
                                  f"key made {int(rows.sum())} rows NaN")
                        c_out, c_lse = flash.flash_attention_cuda(
                            q, k, v, clean, segq, segk, None, causal)
                        if not (torch.equal(c_out, out)
                                and torch.equal(c_lse, lse)):
                            _fail(f"flash NaN {key}: the hidden NaN changed "
                                  f"the output")
                    elif not bool(rows.any()):
                        _fail(f"flash NaN {key}: no row came out NaN")
                    do = _rand(q.shape, gen, dtype)
                    got = flash.flash_attention_bwd_cuda(
                        q, k, v, bias, segq, segk, out, lse, do, None, None,
                        causal)
                    bref = flash.flash_attention_bwd_reference(
                        q, k, v, bias, segq, segk, out, lse, do, None, None,
                        causal)
                    torch.cuda.synchronize()
                    bad_lse = _bad_rows(lse)
                    seen = _rows_seen_by(bad_lse, causal, segq, segk,
                                         k.shape[2])
                    counts, berr = [], 0.0
                    for tag2, x, r, floor in (("dq", got[0], bref[0],
                                               bad_lse),
                                              ("dk", got[1], bref[1], seen),
                                              ("dv", got[2], bref[2], seen)):
                        exact = not (causal and (tag2, name) in (
                            ("dk", "q"), ("dq", "k")))
                        g, e = _nan_compare(key, tag2, x, r, btol, exact,
                                            floor)
                        counts.append(int(g.sum()))
                        berr = max(berr, e)
                    out_rows[key] = {"out_rows": int(rows.sum()),
                                     "dq_dk_dv_rows": counts,
                                     "err": ferr, "bwd_err": berr}
                    print(f"flash NaN {key}: out rows {int(rows.sum())}, "
                          f"dq/dk/dv rows {counts}, finite rows err "
                          f"{ferr:.3e} / bwd {berr:.3e}")
    return out_rows


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


def _train_run(flash, exe, main, feed, loss, steps, warm, extra=(),
               extra_out=None):
    """`steps` steps of main on one feed: (losses, timed step ms after
    `warm`, the set of per-step (fwd, dQ, dK/dV) launch deltas, tensor-
    core forward launches). With `extra`, each step's fetches of those
    vars go to the list `extra_out`."""
    losses, step_ms, per_step = [], [], set()
    tc0 = flash.TC_LAUNCHES
    for i in range(steps):
        before = _bwd_counts(flash)
        ts = time.perf_counter()
        # the fetch's copy to the host ends the step
        out, *more = exe.run(main, feed=feed,
                             fetch_list=[loss] + list(extra))
        if i >= warm:
            step_ms.append((time.perf_counter() - ts) * 1e3)
        if extra:
            extra_out.append(more)
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


def train_agree(flash, tag, program, feed, layers, steps,
                loss_tol=TRAIN_LOSS_TOL, grad_tol=TRAIN_GRAD_TOL):
    """`steps` Adam steps of `program` (main, startup, loss) through
    the flash kernels and with the plain dense attention put in at
    attention_ops (a seam of this script only, restored after), from
    copies of one startup scope: each step's loss within `loss_tol`
    and the first step's @GRADs within `grad_tol` (by default the f32
    TRAIN_LOSS_TOL and TRAIN_GRAD_TOL, see their comment). Returns
    ((fwd, dQ, dK/dV, bf16 fwd) launches of the kernel run, the
    errors)."""
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
    print(f"{tag}: losses {kl} vs {pl} (worst rel err {loss_err:.3e}, "
          f"tolerance {loss_tol}); {len(names)} @GRADs, worst "
          f"{worst[0]:.3e} at {worst[1]} (tolerance {grad_tol}); "
          f"launches {kernel_counts}")
    if not (loss_err <= loss_tol and worst[0] <= grad_tol):
        _fail(f"{tag}: steps through the kernels disagree with the "
              f"plain attention")
    return kernel_counts + (tc,), {"loss_rel_err": loss_err,
                                   "grad_rel_err": worst[0]}


def phase_train_agree(flash):
    """Phase 9b: one f32 step of the full-width GPT through the flash
    kernels and through the plain dense attention (train_agree)."""
    cfg, main, startup, loss, toks = build_train()
    train_agree(flash, "train agree", (main, startup, loss),
                {"tokens": toks}, cfg.num_layers, 1)


def _profile_train(step, steps, flash=True):
    """Where a training step's time goes: torch.profiler (the device
    only) over `steps` calls of step(). The host wall and device time a
    step, the busy share, device operations a step, the flash forward's
    and backward's device time (the backward's also by kernel), their
    shares and the top kernels. A step without attention (`flash`
    False) must show device time, not flash kernels."""
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
    if busy <= 0 or (flash and (fwd <= 0 or bwd <= 0)):
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
    version on a step whose tables hold swapped-in blocks. bf16: the
    first TIER_TURN_REQUESTS requests with and without the tier at
    TIER_BLOCKS, in TIER_TURNS pairs (lanes, steps, tokens/s, tier
    traffic) and the copy times of spill and swap-in.
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
    # bf16: the turns' requests without and with the tier, in pairs (the
    # host-bound step's wall moves between runs)
    model16 = make_model(cfg, tree, torch.bfloat16)
    turn_prompts = prompts[:TIER_TURN_REQUESTS]
    for turn in range(TIER_TURNS):
        _, out[f"bf16_no_tier_{turn}"] = _tier_pass(
            paged, tier_server(model16, TIER_BLOCKS), turn_prompts,
            TIER_NEW)
        srv16 = tier_server(model16, TIER_BLOCKS, TIER_HOST_BLOCKS)
        _, out[f"bf16_tier_{turn}"] = _tier_pass(paged, srv16,
                                                 turn_prompts, TIER_NEW)
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
           "ops": len(main.global_block().ops),
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
    return counts + (tc,), out, prof


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


# ---------------------------------------------------------------------------
# phases 18-18d: the serving fleet
# ---------------------------------------------------------------------------

def fleet_requests(vocab, n=None):
    """bench.py's fleet traffic at full-width lengths: FLEET_TENANTS
    tenant system prompts of FLEET_TENANT_LEN tokens; 85 % of requests
    are one of them plus a 1-64 token suffix, the rest private prompts
    of 32-256 tokens."""
    rng = np.random.default_rng(SEED + 18)
    tenants = [rng.integers(3, vocab, FLEET_TENANT_LEN).astype(np.int32)
               for _ in range(FLEET_TENANTS)]
    reqs = []
    for _ in range(FLEET_REQUESTS if n is None else n):
        if rng.random() < FLEET_SHARED:
            t = tenants[int(rng.integers(len(tenants)))]
            sfx = rng.integers(3, vocab, int(rng.integers(1, 65)))
            reqs.append(np.concatenate([t, sfx]).astype(np.int32))
        else:
            reqs.append(rng.integers(3, vocab, int(rng.integers(32, 257)))
                        .astype(np.int32))
    return reqs


def fleet_server(model, **kw):
    """A fleet replica: phase 2's geometry with the prefix cache."""
    from paddle_tpu_torch.serving import GenerationServer
    return GenerationServer(model, num_slots=16, block_size=16,
                            max_context=1024, chunk=CHUNK, start=False,
                            prefix_cache=True, **kw)


def _arrivals(submit, pump, prompts, new_tokens):
    """The fleet's arrival process (bench.py's): one request submitted,
    one step of everything; then pump until idle. Returns (futures,
    wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = []
    for p in prompts:
        futs.append(submit(p, new_tokens))
        pump()
    while pump():
        pass
    torch.cuda.synchronize()
    return futs, time.perf_counter() - t0


def _ids(futs):
    return [list(f.result(timeout=0).token_ids) for f in futs]


def _single_pass(paged, model, prompts, new_tokens):
    """One server over the fleet traffic: (ids, wall s, launches)."""
    srv = fleet_server(model)
    paged.LAUNCHES = 0
    futs, wall = _arrivals(
        lambda p, n: srv.submit(p, max_new_tokens=n), srv.step, prompts,
        new_tokens)
    launches = paged.LAUNCHES
    srv.close()
    return _ids(futs), wall, launches


def _fleet_prefix(servers, ctrs, n):
    """A fleet's prefix hit rate, blocks a request (bench.py's measure)
    and prefix-cache evictions, over n requests."""
    h = m = ev = 0
    for s in servers:
        if s._prefix is not None:
            st = s._prefix.stats()
            h, m, ev = h + st["hits"], m + st["misses"], ev + st["evictions"]
    return {"hit_rate": h / max(h + m, 1),
            "blocks_per_request": sum(c["blocks"] for c in ctrs) / n,
            "evictions": ev}


def _router_pass(paged, router, prompts, new_tokens, gate_launches=True):
    """The router over the fleet traffic: (ids, wall s, launches). Every
    live replica's step launches the kernel once a layer."""
    paged.LAUNCHES = 0
    futs, wall = _arrivals(
        lambda p, n: router.submit(p, max_new_tokens=n), router.step,
        prompts, new_tokens)
    launches = paged.LAUNCHES
    if gate_launches and not launches > 0:
        _fail("fleet pass launched no paged kernel")
    return _ids(futs), wall, launches


def _kill_when_busy(router, plan):
    """A pump for _arrivals that plans replica 0's kill (`plan(at)` arms
    the chaos hook for router iteration `at`) for the step after the
    first one, from FLEET_KILL_AT on, at which replica 0 has lanes in
    flight: the kill must catch requests mid-stream."""
    state = {"at": None}

    def pump():
        if state["at"] is None and router.iteration >= FLEET_KILL_AT \
                and router.replicas()[0].server._sched \
                .load_snapshot()[1] > 0:
            state["at"] = router.iteration + 1
            plan(state["at"])
        return router.step()

    return pump, state


def _counted_fleet(model, n, **kw):
    servers = [fleet_server(model, **kw) for _ in range(n)]
    return servers, [_count_allocations(s) for s in servers]


def _affinity_pass(paged, model, prompts, **kw):
    """FLEET_REPLICAS replicas behind a FleetRouter (affinity routing)
    over the fleet traffic: (prefix measures, wall s, launches)."""
    from paddle_tpu_torch.serving import FleetRouter
    servers, ctrs = _counted_fleet(model, FLEET_REPLICAS, **kw)
    router = FleetRouter(servers, start=False)
    _ids2, wall, launches = _router_pass(paged, router, prompts, FLEET_NEW)
    res = _fleet_prefix(servers, ctrs, len(prompts))
    res.update(admitted=[s._sched.counts["admitted"] for s in servers],
               iterations=router.iteration)
    router.close()
    return res, wall, launches


def _random_pass(paged, model, prompts, **kw):
    """bench.py's baseline, no router: the same replicas, each request
    sent to one of them by a seeded scatter, every replica stepped once
    an arrival: (prefix measures and tokens/s, launches)."""
    servers, ctrs = _counted_fleet(model, FLEET_REPLICAS, **kw)
    rng = np.random.default_rng(SEED + 180)

    def scatter(p, n):
        return servers[int(rng.integers(len(servers)))].submit(
            p, max_new_tokens=n)

    def pump_all():
        return any([s.step() for s in servers])

    paged.LAUNCHES = 0
    futs, wall = _arrivals(scatter, pump_all, prompts, FLEET_NEW)
    launches = paged.LAUNCHES
    _ids(futs)
    res = _fleet_prefix(servers, ctrs, len(prompts))
    res["tokens_per_s"] = len(prompts) * FLEET_NEW / wall
    for s in servers:
        s.close()
    if not launches > 0:
        _fail("random scatter launched no paged kernel")
    return res, launches


def phase_fleet(paged, cfg, tree):
    """Phase 18: FLEET_REPLICAS in-process replicas under affinity
    routing over the fleet traffic (its first FLEET_PHASE_REQUESTS
    requests, one arriving a router step, FLEET_NEW greedy tokens),
    bf16: tokens/s
    against one server on the same arrivals, in turns (server, fleet,
    fleet, server), and the fleet's prefix hit rate and blocks a request
    against a seeded random scatter over the same replicas (bench.py's
    baseline: no router), with the engine's default pools (every
    replica can cache every tenant) and again with FLEET_PRESSURE_BLOCKS
    blocks a replica (it cannot: the scatter must evict). f32 gate: the first FLEET_GATE requests
    through a fleet whose replica 0 chaos kills mid-stream (at the first
    router iteration from FLEET_KILL_AT on at which it has lanes in
    flight) give one f32 server's ids, with a failover."""
    from paddle_tpu_torch.robustness import ChaosInjector
    from paddle_tpu_torch.serving import FleetRouter
    prompts = fleet_requests(cfg.vocab_size, FLEET_PHASE_REQUESTS)
    gen = len(prompts) * FLEET_NEW
    out = {"launches": {}}
    model = make_model(cfg, tree, torch.bfloat16)
    turns = {"single": [], "fleet": []}
    for turn in ("single", "fleet", "fleet", "single"):
        if turn == "single":
            _ids1, wall, launches = _single_pass(paged, model, prompts,
                                                 FLEET_NEW)
            turns["single"].append(gen / wall)
            continue
        out["affinity"], wall, launches = _affinity_pass(paged, model,
                                                         prompts)
        turns["fleet"].append(gen / wall)
        out["launches"]["18 fleet bf16 affinity (3 replicas)"] = launches
    out["random"], launches = _random_pass(paged, model, prompts)
    out["launches"]["18 random scatter bf16 (3 replicas)"] = launches
    # the same two under pools that cannot cache every tenant
    press = {"num_blocks": FLEET_PRESSURE_BLOCKS}
    aff, _wall, launches = _affinity_pass(paged, model, prompts, **press)
    out["launches"]["18 fleet bf16 affinity, pressured pools"] = launches
    rnd, launches = _random_pass(paged, model, prompts, **press)
    out["launches"]["18 random scatter bf16, pressured pools"] = launches
    out["pressured"] = {"num_blocks": FLEET_PRESSURE_BLOCKS,
                        "affinity": aff, "random": rnd}
    if not rnd["evictions"] > 0:
        _fail(f"18: the pressured pools evicted nothing: {rnd}")
    out["tokens_per_s"] = turns
    out["fleet_over_single"] = (sum(turns["fleet"])
                                / sum(turns["single"]))
    del model
    # f32: a replica killed mid-flight
    model = make_model(cfg, tree)
    gate = prompts[:FLEET_GATE]
    want, _w, _l = _single_pass(paged, model, gate, FLEET_GATE_NEW)
    chaos = ChaosInjector()
    router = FleetRouter([fleet_server(model) for _ in
                          range(FLEET_REPLICAS)], start=False, chaos=chaos)
    pump, when = _kill_when_busy(
        router, lambda at: chaos.kill_replica_at(at, 0))
    paged.LAUNCHES = 0
    futs, _w = _arrivals(
        lambda p, n: router.submit(p, max_new_tokens=n), pump, gate,
        FLEET_GATE_NEW)
    got, launches = _ids(futs), paged.LAUNCHES
    out["launches"]["18 fleet f32 replica kill"] = launches
    out["kill"] = {"at_iteration": when["at"],
                   "fired": chaos.fired["replica_kill"],
                   "failovers": router.counts["failovers"],
                   "ids_equal_single": got == want}
    router.close()
    print("fleet " + json.dumps(out))
    if chaos.fired["replica_kill"] != 1 or \
            not router.counts["failovers"] >= 1:
        _fail(f"fleet kill: {out['kill']}")
    if got != want:
        same = sum(a == b for a, b in zip(got, want))
        _fail(f"fleet f32 ids after the kill differ from one server's "
              f"({same}/{len(want)} equal)")
    del model
    torch.cuda.empty_cache()
    return out


def _timed_local_handoffs(router):
    """Wrap the router's in-process chain transfer to time each call
    (synchronized): -> the list of (seconds, blocks moved) it fills."""
    rec = []
    real = router._transfer_chain_local

    def timed(src, dst, rr):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = real(src, dst, rr)
        torch.cuda.synchronize()
        rec.append((time.perf_counter() - t0, moved))
        return moved

    router._transfer_chain_local = timed
    return rec


def phase_disaggregated(paged, cfg, tree, gcfg, gtree):
    """Phase 18b: one prefill replica and two decode replicas,
    RouterPolicy("disaggregated"), dense bf16 and int8/GQA (int8 weights
    and KV: blocks carry their scale rows). The first FLEET_GATE requests
    of the fleet traffic, FLEET_GATE_NEW new tokens: every request with
    a full chunk hands its chain off (blocks handed off, µs a block of
    the in-process transfer); in f32, dense and int8, the disaggregated
    fleet's ids equal the colocated fleet's."""
    from paddle_tpu_torch.serving import FleetRouter, RouterPolicy
    prompts = fleet_requests(cfg.vocab_size)[:FLEET_GATE]
    policy = RouterPolicy("disaggregated", prefill=(0,), decode=(1, 2))
    out = {"launches": {}, "launches_int8": {}}
    for tag, c, t, int8 in (("dense", cfg, tree, False),
                            ("int8_gqa", gcfg, gtree, True)):
        kw = {"kv_dtype": "int8"} if int8 else {}
        row = {}
        for dtype in (torch.bfloat16, None):
            model = make_model(c, t, dtype, int8=int8)
            router = FleetRouter([fleet_server(model, **kw)
                                  for _ in range(3)], start=False,
                                 policy=policy)
            rec = _timed_local_handoffs(router)
            ids, wall, launches = _router_pass(paged, router, prompts,
                                               FLEET_GATE_NEW)
            blocks = sum(m for _s, m in rec)
            secs = sum(s for s, _m in rec)
            name = "bf16" if dtype is not None else "f32"
            row[name] = {"handoffs": router.counts["handoffs"],
                         "handoff_blocks": router.counts["handoff_blocks"],
                         "us_per_block": secs / max(blocks, 1) * 1e6,
                         "tokens_per_s": len(prompts) * FLEET_GATE_NEW
                         / wall}
            key = "launches_int8" if int8 else "launches"
            out[key][f"18b disaggregated {tag} {name}"] = launches
            router.close()
            if not router.counts["handoff_blocks"] > 0 or blocks != \
                    router.counts["handoff_blocks"]:
                _fail(f"18b {tag} {name}: {row[name]}, timed {blocks}")
            if dtype is None:
                colo = FleetRouter([fleet_server(model, **kw)
                                    for _ in range(3)], start=False)
                want, _w, _l = _router_pass(paged, colo, prompts,
                                            FLEET_GATE_NEW)
                colo.close()
                row["f32_ids_equal_colocated"] = ids == want
                if ids != want:
                    same = sum(a == b for a, b in zip(ids, want))
                    _fail(f"18b {tag}: f32 disaggregated ids differ from "
                          f"the colocated fleet's ({same}/{len(want)})")
            del model
            torch.cuda.empty_cache()
        out[tag] = row
        print(f"disaggregated {tag} " + json.dumps(row))
    return out


def fleet_checkpoint(root):
    """GPTConfig()'s Program (gpt.build_lm_net at FLEET_CKPT_SEQ), its
    startup run on the card, committed by the port's CheckpointManager
    under `root`: the artifact phases 18c and 18d spawn replicas from.
    Returns (cfg, seconds to save)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import framework
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.robustness import CheckpointManager
    cfg = gpt.GPTConfig(dropout=0.0)
    main, startup = framework.Program(), framework.Program()
    main.random_seed = startup.random_seed = FLEET_PROGRAM_SEED
    with framework.program_guard(main, startup):
        gpt.build_lm_net(cfg, seq_len=FLEET_CKPT_SEQ)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    t0 = time.perf_counter()
    CheckpointManager(root, program=main).save(exe, 0, scope=scope)
    return cfg, main, time.perf_counter() - t0


def phase_self_healing(paged, root, flight, cfg, main):
    """Phase 18c: a supervised f32 fleet of FLEET_REPLICAS replicas built
    by make_checkpoint_spawn from the port's full-width checkpoint; chaos kills
    replica 0 at router iteration 3, hangs replica 1 at 7, and a poison
    prompt arrives mid-stream. The watchdog declares the hang, the
    supervisor resurrects every dead slot from the checkpoint with its
    prefix re-warmed, the poison ends in PoisonRequestError (its NaN
    through the kernel), the fleet ends at full strength, and every
    other request's ids equal one server's from the same checkpoint.
    Prints the time to resurrection: each spawn's restore and build,
    and the wall from the kill to replica 0 serving again. Flight dumps
    go under `flight`."""
    from paddle_tpu_torch.robustness import (ChaosInjector,
                                             CheckpointManager,
                                             PoisonRequestError,
                                             SupervisorConfig,
                                             make_checkpoint_spawn)
    from paddle_tpu_torch.serving import FleetRouter
    kw = dict(num_slots=16, block_size=16, max_context=1024, chunk=CHUNK,
              start=False, prefix_cache=True)
    manager = CheckpointManager(root, program=main)
    prompts = fleet_requests(cfg.vocab_size)[:SELF_HEAL_REQUESTS]
    rng = np.random.default_rng(SEED + 183)
    poison = rng.integers(3, cfg.vocab_size, 40).astype(np.int32)
    ref = make_checkpoint_spawn(manager, cfg, **kw)(0)
    futs = [ref.submit(p, max_new_tokens=FLEET_GATE_NEW) for p in prompts]
    ref.run_until_idle()
    want = _ids(futs)
    ref.close()
    del ref
    chaos = (ChaosInjector().kill_replica_at(3, 0).hang_replica_at(7, 1)
             .poison_prompt(poison))
    build = make_checkpoint_spawn(manager, cfg, chaos=chaos,
                                  flight_dir=flight, **kw)
    spawns = []

    def spawn(index):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv = build(index)
        torch.cuda.synchronize()
        spawns.append(time.perf_counter() - t0)
        return srv

    router = FleetRouter([spawn(i) for i in range(FLEET_REPLICAS)],
                         start=False, chaos=chaos, spawn_fn=spawn,
                         flight_dir=flight,
                         supervisor=SupervisorConfig(
                             hang_heartbeats=3, backoff_heartbeats=2,
                             warm_chains=3))
    boot = list(spawns)
    spawns.clear()
    paged.LAUNCHES = 0
    futs, t_kill, t_back = [], None, None
    for i, p in enumerate(prompts):
        futs.append(router.submit(p, max_new_tokens=FLEET_GATE_NEW))
        if i == 4:
            pfut = router.submit(poison, max_new_tokens=FLEET_GATE_NEW)
        router.step()
        if t_kill is None and chaos.fired["replica_kill"]:
            t_kill = time.perf_counter()
        r0 = router.replicas()[0]
        if t_kill is not None and t_back is None and r0.generation >= 1 \
                and r0.accepting():
            t_back = time.perf_counter()
    while router.step():
        r0 = router.replicas()[0]
        if t_kill is not None and t_back is None and r0.generation >= 1 \
                and r0.accepting():
            t_back = time.perf_counter()
    launches = paged.LAUNCHES
    st = router.get_stats()
    got = _ids(futs)
    try:
        pfut.result(timeout=0)
        poisoned = None
    except PoisonRequestError as e:
        poisoned = e
    out = {"boot_spawn_s": boot, "resurrection_spawn_s": list(spawns),
           "kill_to_serving_s": (None if t_back is None
                                 else t_back - t_kill),
           "fired": {k: chaos.fired[k] for k in
                     ("replica_kill", "replica_hang", "prompt_poison")},
           "hangs": st["hangs"], "resurrections": st["resurrections"],
           "quarantines": st["quarantines"],
           "live_replicas": st["live_replicas"],
           "warm_prompts": st["supervisor"]["warm_prompts"],
           "poison_deaths": None if poisoned is None else poisoned.deaths,
           "launches": launches, "ids_equal_single": got == want}
    router.close()
    print("self-healing " + json.dumps(out))
    if poisoned is None:
        _fail("18c: the poison prompt was not quarantined")
    if not (out["fired"]["replica_kill"] == 1 and st["hangs"] == 1
            and st["quarantines"] == 1
            and st["live_replicas"] == FLEET_REPLICAS
            and st["resurrections"] >= 2 and out["warm_prompts"] >= 1
            and t_back is not None and launches > 0):
        _fail(f"18c: {out}")
    if got != want:
        same = sum(a == b for a, b in zip(got, want))
        _fail(f"18c f32 ids differ from one server's ({same}/{len(want)})")
    torch.cuda.empty_cache()
    return out


def _spawn_workers(spawn, n):
    """n workers booted side by side: -> (proxies, seconds)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(n) as pool:
        ws = list(pool.map(spawn, range(n)))
    return ws, time.perf_counter() - t0


def _worker_counts(w):
    """A worker's paged-kernel launches and engine iterations so far:
    process totals read over the RPC, so a run's own are the difference
    of two reads around it."""
    st = w.get_stats()
    return st["kernel"]["launches"], st["iterations"]


def _worker_run(before, after, layers):
    """One worker's own run between two _worker_counts reads: its
    launches and iterations, and whether every iteration launched the
    kernel once a layer."""
    launches, iters = after[0] - before[0], after[1] - before[1]
    return {"launches": launches, "iterations": iters,
            "ok": launches > 0 and launches == iters * layers}


def _worker_spawns(root, flight, cfg):
    """Phase 18d's spawn functions over phase 18c's checkpoint: (the
    chaos injector of the f32 workers, the f32 spawn, the bf16 spawn)."""
    from paddle_tpu_torch.robustness import ChaosInjector
    from paddle_tpu_torch.serving.remote import make_subprocess_spawn
    kw = dict(num_slots=16, block_size=16, max_context=1024, chunk=CHUNK,
              start=False, prefix_cache=True)
    common = dict(seq_len=FLEET_CKPT_SEQ, program_seed=FLEET_PROGRAM_SEED,
                  flight_dir=flight, spawn_timeout_s=WORKER_SPAWN_S,
                  **kw)
    chaos = ChaosInjector()
    return (chaos, make_subprocess_spawn(root, cfg, chaos=chaos, **common),
            make_subprocess_spawn(root, cfg, dtype="bfloat16", **common))


def _boot_workers(spawns):
    """The four workers of phase 18d (two f32, two bf16), booted side by
    side, then each bf16 worker's first request served (a worker's first
    run pays one-time costs that 18d's first timed turn would carry): ->
    (proxies, seconds of the boot)."""
    _chaos, spawn32, spawn16 = spawns
    ws, boot_s = _spawn_workers(
        lambda i: (spawn32 if i < 2 else spawn16)(i), 4)
    warm = np.arange(3, 3 + FLEET_TENANT_LEN, dtype=np.int32)
    for w in ws[2:]:
        f = w.submit(warm, max_new_tokens=FLEET_NEW)
        w.run_until_idle()
        f.result(timeout=60)
    return ws, boot_s


def phase_workers(paged, root, flight, cfg, main, spawns, booting):
    """Phase 18d: two worker processes a fleet (make_subprocess_spawn,
    each on the card, restoring phase 18c's checkpoint). f32: a SIGKILL
    of worker 0 mid-stream (kill_process_at, planned as in phase 18)
    fails its requests over; the first FLEET_GATE requests' ids equal
    one in-process f32 server's from the same checkpoint, and the slot
    comes back as a new process. bf16: the fleet traffic through the two
    workers against one in-process server, in turns (tokens/s); a
    512-token prompt's chain handed from worker 0 to worker 1 over the
    RPC (export_chain / import_chain: µs a block over the wire), and
    the blocks the receiver holds, exported again, are bitwise the
    donor's bf16 bytes. Each worker's paged launches are read over the
    RPC just before and just after each run it serves (f32 worker 0 up
    to its SIGKILL, its successor from its spawn, worker 1; each bf16
    turn; the wire prefill): every run's must be > 0 and equal its
    iterations x layers. The bf16 turns serve the first
    WORKER_TURN_REQUESTS requests. The four workers were booted from
    `spawns` (``_worker_spawns``) beside phase 18c: `booting` is that
    boot's future. Flight dumps go under `flight`."""
    from paddle_tpu_torch.robustness import (CheckpointManager,
                                             SupervisorConfig,
                                             make_checkpoint_spawn)
    from paddle_tpu_torch.serving import FleetRouter, prompt_chain_keys
    kw = dict(num_slots=16, block_size=16, max_context=1024, chunk=CHUNK,
              start=False, prefix_cache=True)
    manager = CheckpointManager(root, program=main)
    prompts = fleet_requests(cfg.vocab_size)
    gate = prompts[:FLEET_GATE]
    out = {"launches": {}}
    runs = {}
    layers = cfg.num_layers
    chaos, spawn32, _spawn16 = spawns
    ws, boot_s = booting.result()
    w32, w16 = ws[:2], ws[2:]
    out["boot_4_workers_s"] = boot_s
    out["worker_devices"] = [w.get_stats()["device"] for w in ws]
    # f32: SIGKILL of worker 0 mid-flight
    ref = make_checkpoint_spawn(manager, cfg, **kw)(0)
    futs = [ref.submit(p, max_new_tokens=FLEET_GATE_NEW) for p in gate]
    ref.run_until_idle()
    want = _ids(futs)
    ref.close()
    del ref
    respawns = []

    born = {}

    def respawn(index):
        t0 = time.perf_counter()
        w = spawn32(index)
        respawns.append(time.perf_counter() - t0)
        born[w.pid] = _worker_counts(w)
        return w

    pid0 = w32[0].pid
    before = [_worker_counts(w) for w in w32]
    router = FleetRouter(w32, start=False, chaos=chaos, spawn_fn=respawn,
                         flight_dir=flight,
                         supervisor=SupervisorConfig(backoff_heartbeats=1,
                                                     warm_chains=1))

    def plan(at):
        runs["18d worker f32 w0, up to its SIGKILL"] = _worker_run(
            before[0], _worker_counts(w32[0]), layers)
        chaos.kill_process_at(at, 0)

    pump, when = _kill_when_busy(router, plan)
    futs, _w = _arrivals(
        lambda p, n: router.submit(p, max_new_tokens=n), pump, gate,
        FLEET_GATE_NEW)
    got = _ids(futs)
    reps = router.replicas()
    out["kill"] = {"at_iteration": when["at"],
                   "fired": chaos.fired["process_kill"],
                   "failovers": router.counts["failovers"],
                   "resurrections": router.counts["resurrections"],
                   "new_pid": reps[0].pid != pid0,
                   "respawn_s": respawns,
                   "ids_equal_single": got == want}
    w0 = reps[0].server
    runs["18d worker f32 w0 resurrected, re-warm and serving"] = \
        _worker_run(born.get(w0.pid, (0, 0)), _worker_counts(w0), layers)
    runs["18d worker f32 w1"] = _worker_run(
        before[1], _worker_counts(reps[1].server), layers)
    router.close()
    if not (chaos.fired["process_kill"] == 1 and
            router.counts["failovers"] >= 1 and out["kill"]["new_pid"]):
        _fail(f"18d SIGKILL: {out['kill']}")
    if got != want:
        same = sum(a == b for a, b in zip(got, want))
        _fail(f"18d f32 ids after the SIGKILL differ from one server's "
              f"({same}/{len(want)} equal)")
    # bf16: two workers against one in-process server, in turns
    model = _checkpoint_model(manager, cfg, torch.bfloat16)
    turn_prompts = prompts[:WORKER_TURN_REQUESTS]
    gen = len(turn_prompts) * FLEET_NEW
    turns = {"single": [], "workers": []}
    router = FleetRouter(w16, start=False)
    for turn in ("single", "workers", "workers", "single"):
        if turn == "single":
            _ids1, wall, _l = _single_pass(paged, model, turn_prompts,
                                           FLEET_NEW)
            turns["single"].append(gen / wall)
        else:
            before = [_worker_counts(w) for w in w16]
            _ids2, wall, _l = _router_pass(paged, router, turn_prompts,
                                           FLEET_NEW, gate_launches=False)
            turns["workers"].append(gen / wall)
            for i, w in enumerate(w16):
                runs[f"18d worker bf16 w{i}, turn {len(turns['workers'])}"] \
                    = _worker_run(before[i], _worker_counts(w), layers)
    out["tokens_per_s"] = turns
    out["workers_over_single"] = (sum(turns["workers"])
                                  / sum(turns["single"]))
    # a chain over the wire: worker 0 prefills, worker 1 adopts
    long = np.random.default_rng(SEED + 184).integers(
        3, cfg.vocab_size, WIRE_PROMPT).astype(np.int32)
    before = _worker_counts(w16[0])
    f = w16[0].submit(long, max_new_tokens=1)
    w16[0].run_until_idle()
    f.result(timeout=60)
    runs["18d worker bf16 w0, wire prefill"] = _worker_run(
        before, _worker_counts(w16[0]), layers)
    keys = prompt_chain_keys(long, 16)
    t0 = time.perf_counter()
    chunks, arrays = w16[0].export_chain(long, keys)
    t1 = time.perf_counter()
    moved = w16[1].import_chain(chunks, arrays)
    t2 = time.perf_counter()
    back, arrays2 = w16[1].export_chain(long, keys)
    same = (len(back) == len(chunks) == moved == len(keys)
            and len(arrays2) == len(arrays)
            and all(a.dtype == torch.bfloat16 for a in arrays)
            and all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                    for a, b in zip(arrays, arrays2)))
    out["wire"] = {"blocks": moved, "bytes": sum(
        a.numel() * a.element_size() for a in arrays),
        "export_us_per_block": (t1 - t0) / max(moved, 1) * 1e6,
        "import_us_per_block": (t2 - t1) / max(moved, 1) * 1e6,
        "bf16_bytes_equal_donor": same,
        "in_process_us_per_block": _wire_breakdown(model, long, keys)}
    router.close()
    out["worker_runs"] = runs
    out["launches"] = {k: r["launches"] for k, r in runs.items()}
    print("workers " + json.dumps(out))
    if not same:
        _fail(f"18d: the wire handoff's blocks differ from the donor's: "
              f"{out['wire']}")
    bad = {k: r for k, r in runs.items() if not r["ok"]}
    if bad:
        _fail(f"18d: worker runs whose paged launches are not > 0 and "
              f"iterations x {layers} layers: {bad}")
    del model
    torch.cuda.empty_cache()
    return out


def _wire_breakdown(model, prompt, keys):
    """Where a wire handoff's time goes, in this process: the same chain
    exported from a server on the card (its device-to-host copies),
    framed, read back and written into another server's pools, each µs a
    block."""
    import io
    from paddle_tpu_torch.serving.transport import pack_frame, read_frame
    from paddle_tpu_torch.serving.worker import export_chain, import_chain
    src, dst = fleet_server(model), fleet_server(model)
    f = src.submit(prompt, max_new_tokens=1)
    src.run_until_idle()
    f.result(timeout=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks, arrays = export_chain(src, prompt, keys)
    t1 = time.perf_counter()
    frame = pack_frame({"chunks": chunks}, arrays)
    t2 = time.perf_counter()
    header, blobs = read_frame(io.BytesIO(frame))
    t3 = time.perf_counter()
    moved = import_chain(dst, header["chunks"], blobs)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    n = max(moved, 1)
    src.close()
    dst.close()
    return {"export_chain": (t1 - t0) / n * 1e6,
            "pack_frame": (t2 - t1) / n * 1e6,
            "read_frame": (t3 - t2) / n * 1e6,
            "import_chain": (t4 - t3) / n * 1e6, "blocks": moved}


def _checkpoint_model(manager, cfg, dtype):
    """A serving model on the card from the checkpoint's parameters."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import GPTServingModel
    scope = fluid.Scope()
    manager.restore(fluid.Executor(fluid.CUDAPlace(0)), scope=scope,
                    restore_step_counter=False)
    return GPTServingModel(gpt.load_params(scope, cfg), cfg, dtype=dtype)


def phase_fleet_all(paged, cfg, tree, gcfg, gtree):
    """Phases 18-18d in order, the checkpoint of 18c/18d written once
    and their flight dumps, all in a temporary directory removed at the
    end."""
    import shutil
    import tempfile
    res = {"18": _phase("18 in-process fleet", phase_fleet, paged, cfg,
                        tree)}
    res["18b"] = _phase("18b disaggregated prefill/decode",
                        phase_disaggregated, paged, cfg, tree, gcfg, gtree)
    base = tempfile.mkdtemp(prefix="fleet_")
    root, flight = os.path.join(base, "ckpt"), os.path.join(base, "flight")
    try:
        os.makedirs(root)
        os.makedirs(flight)
        ccfg, main, save_s = fleet_checkpoint(root)
        print(f"fleet checkpoint: GPTConfig() f32 saved in {save_s:.2f} s")
        # 18d's four workers boot beside 18c
        spawns = _worker_spawns(root, flight, ccfg)
        pool = ThreadPoolExecutor(1)
        booting = pool.submit(_boot_workers, spawns)
        try:
            res["18c"] = _phase("18c self-healing", phase_self_healing,
                                paged, root, flight, ccfg, main)
            res["18d"] = _phase("18d out-of-process fleet", phase_workers,
                                paged, root, flight, ccfg, main, spawns,
                                booting)
        finally:
            pool.shutdown(wait=True)
            # nothing outlives 18d: workers a failed phase left behind
            from paddle_tpu_torch.serving.remote import live_workers
            for proc in live_workers():
                proc.kill()
                proc.wait()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return res


# ---------------------------------------------------------------------------
# phases 19-19d: tensor-parallel serving
# ---------------------------------------------------------------------------

def tp_mesh(tp):
    """A local 1-D tp mesh on the card: every rank in this process, each
    run in turn (one card cannot hold two NCCL ranks)."""
    from paddle_tpu_torch.parallel.mesh import make_named_mesh
    return make_named_mesh(("tp",), (tp,), ["cuda"] * tp)


def tp_server(model, tp, kv_dtype=None):
    """Phase 2's server geometry, sharded over a local tp mesh for tp > 1."""
    from paddle_tpu_torch.serving import GenerationServer
    return GenerationServer(model, num_slots=16, block_size=16,
                            max_context=1024, chunk=CHUNK, start=False,
                            kv_dtype=kv_dtype,
                            mesh=tp_mesh(tp) if tp > 1 else None)


def tp_prompts(cfg, n=None):
    """Phase 2's prompts, every one greedy: a mesh server refuses
    sampling, as the JAX package's does."""
    prompts = [p for p, _s in make_requests(cfg.vocab_size)]
    return prompts[:n]


def _tp_pass(paged, cfg, srv, prompts, new_tokens, tp, what, cap=None,
             arm=None, top2=False):
    """Serve `prompts` on `srv` until idle, the paged count set to 0 just
    before: its launches must be iterations x layers x tp, its mesh's
    reductions 2 x layers a step, and every block free after. Returns
    (ids, numbers); numbers["logps"] holds each request's committed
    logps and, with `top2`, numbers["top2"] each committed token's two
    best (logp, token) pairs of its step's logp row."""
    logps, best, step, last = {}, {}, srv.model.fused_step, {}
    emit, commit = srv._sched._emit_token, srv._sched.commit

    def ranked(*args, **kw):
        out = step(*args, **kw)
        vals, toks = torch.topk(out[2], 2, dim=-1)
        last["top2"] = (vals.cpu().tolist(), toks.cpu().tolist())
        return out

    def committed(plan, *args, **kw):
        last["slot"] = {srv._sched._slots[sid].req.rid: sid
                        for sid in plan.slot_ids
                        if srv._sched._slots[sid] is not None}
        return commit(plan, *args, **kw)

    def logged(req, tok, lp, now):
        logps.setdefault(req.rid, []).append(float(lp))
        if top2:
            sid = last["slot"][req.rid]
            vals, toks = last["top2"]
            best.setdefault(req.rid, []).append(
                list(zip(vals[sid], toks[sid])))
        return emit(req, tok, lp, now)

    srv._sched._emit_token = logged
    if top2:
        srv.model.fused_step, srv._sched.commit = ranked, committed
    futs = [srv.submit(p, max_new_tokens=new_tokens) for p in prompts]
    r0 = srv.mesh.reductions if srv.mesh is not None else 0
    wall, iters, launches, step_ms = _pump(paged, srv, arm=arm, cap=cap)
    st = srv.get_stats()
    if launches <= 0 or launches != iters * cfg.num_layers * tp:
        _fail(f"{what}: paged launches {launches} != iterations {iters} x "
              f"{cfg.num_layers} layers x tp {tp}")
    if srv.mesh is not None and \
            srv.mesh.reductions - r0 != 2 * cfg.num_layers * iters:
        _fail(f"{what}: {srv.mesh.reductions - r0} reductions over {iters} "
              f"steps, want 2 x {cfg.num_layers} a step")
    if st["blocks_free"] != st["blocks_total"]:
        _fail(f"{what}: blocks left allocated: {st}")
    if top2:
        del srv.model.fused_step
        srv._sched.commit = commit
    ids = _ids(futs)
    generated = sum(len(x) for x in ids)
    nums = {"tp": tp, "iterations": iters, "launches": launches,
            "wall_s": wall, "tokens_per_s": generated / wall,
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p99": float(np.percentile(step_ms, 99)),
            "logps": [logps[f.request_id] for f in futs]}
    if top2:
        nums["top2"] = [best[f.request_id] for f in futs]
    return ids, nums


def _tp_same(what, a, b):
    same = sum(x == y for x, y in zip(a, b))
    print(f"{what}: {same}/{len(a)} greedy requests identical")
    if same != len(a) or len(a) != len(b):
        _fail(f"{what}: ids differ")


def _tp_near_ties(what, ids, lps, ref_ids, ref_lps, ref_top2):
    """int8 KV's gate at tp > 1 against tp 1: each request's ids equal, or
    equal up to a step where, on one history, the tp-1 server itself was
    at a near-tie: the tp server's token is the tp-1 server's second
    choice there, within TP_INT8_TIE of its first in the tp-1 server's
    own logp row (`ref_top2`, _tp_pass's top2). Over the common prefix
    the logps lie within TP_INT8_TIE. The sum of rank partials rounds
    otherwise than one product, and an ulp in a K/V row flips its int8
    code by a whole step when it sits at a rounding boundary, so exact
    ids are not a property of int8 pools under tp (phase 19's dense
    gates are exact)."""
    same, worst, flips = 0, 0.0, []
    for r, (a, la, b, lb, rank) in enumerate(zip(ids, lps, ref_ids, ref_lps,
                                                 ref_top2)):
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if n:
            worst = max(worst, max(abs(x - y) for x, y in
                                   zip(la[:n], lb[:n])))
        if a == b:
            same += 1
            continue
        if n >= min(len(a), len(b)):
            _fail(f"{what}: request {r}: {len(a)} tokens, tp 1 {len(b)}")
        (first, tok1), (second, tok2) = rank[n]
        margin = first - second
        flips.append({"request": r, "step": n, "token": int(a[n]),
                      "ref_token": int(b[n]), "ref_top2": rank[n],
                      "ref_margin": margin, "logp": la[n]})
        if {tok1, tok2} != {int(a[n]), int(b[n])} or \
                not margin <= TP_INT8_TIE:
            _fail(f"{what}: request {r} diverges at step {n} (token "
                  f"{a[n]}, tp 1 {b[n]}) where the tp-1 server's two best "
                  f"were {rank[n]}: not its near-tie")
    print(f"{what}: {same}/{len(ids)} greedy requests identical; common "
          f"prefixes' logps within {worst:.3e}; divergences at near-ties "
          f"{json.dumps(flips)} (tolerance {TP_INT8_TIE})")
    if not worst <= TP_INT8_TIE:
        _fail(f"{what}: logps differ by {worst} on a common history")
    return {"identical": same, "of": len(ids), "max_logp_diff": worst,
            "divergences": flips}


def _tp_bytes(srv, tp):
    """The sharded pool's byte facts: one rank's share x tp = the logical
    pool, one kv_cache ledger row a rank summing to it, each block's share
    a tp-th of its bytes."""
    from paddle_tpu_torch.observability.compile_insight import hbm_ledger
    c = srv.cache
    rows = [e for e in hbm_ledger().snapshot()["entries"]
            if e["component"] == srv._ledger_id
            and e["kind"] == "kv_cache"]
    if c.shard_pool_bytes() * tp != c.pool_bytes() or len(rows) != tp \
            or sum(r["bytes"] for r in rows) != c.pool_bytes() \
            or srv.get_stats()["memory"]["kv_cache"] != c.pool_bytes():
        _fail(f"tp {tp} pool bytes: shard {c.shard_pool_bytes()}, pool "
              f"{c.pool_bytes()}, ledger rows {[r['bytes'] for r in rows]}")
    for pools in c.shards:
        for t in pools[0].values():
            if not t.is_contiguous() or t.shape[1] != c.heads_local:
                _fail(f"tp {tp}: a pool shard {tuple(t.shape)} is not a "
                      f"contiguous {c.heads_local}-head tensor")
    return {"pool_bytes": c.pool_bytes(),
            "shard_pool_bytes": c.shard_pool_bytes(),
            "block_bytes": c.pool_bytes() // c.num_blocks,
            "block_shard_bytes": c.shard_pool_bytes() // c.num_blocks,
            "ledger_rows": {r["name"]: r["bytes"] for r in rows}}


def _armed_mid_run(srv):
    return srv._sched.iteration >= 20


def phase_tp(paged, cfg, tree):
    """Phase 19: GPTConfig() on a local tp 2 mesh on the card. f32: phase
    2's prompts (greedy) at tp 1 and tp 2, ids equal; bf16: the same at 64
    new tokens in turns tp 1, tp 2, tp 2, tp 1 (tokens/s, step p50/p99),
    the kernel against its plain version on a call captured at H 6.
    Returns (launches by path, errors, numbers)."""
    prompts = tp_prompts(cfg)
    launches, errs, out = {}, {}, {}
    ids = {}
    for tp in (1, TP):
        srv = tp_server(make_model(cfg, tree), tp)
        ids[tp], nums = _tp_pass(paged, cfg, srv, prompts[:TP_AGREE],
                                 AGREE_TOKENS, tp, f"19 f32 tp {tp}")
        if tp == TP:
            launches[f"19 tp {TP} f32 gate"] = nums["launches"]
            out["f32_bytes"] = _tp_bytes(srv, tp)
        srv.close()
        del srv
    _tp_same(f"19 f32 tp {TP} vs tp 1", ids[TP], ids[1])
    runs = []
    for turn, tp in enumerate((1, TP, TP, 1)):
        model, cap = _serving_model(cfg, tree, torch.bfloat16)
        srv = tp_server(model, tp)
        arm = _armed_mid_run if turn == 1 else None
        _ids_bf16, nums = _tp_pass(paged, cfg, srv, prompts, NEW_TOKENS, tp,
                                   f"19 bf16 tp {tp}", cap=cap, arm=arm)
        if arm is not None:
            h = cfg.num_heads // TP
            errs[f"19 tp {TP} bf16 (rank 0, H {h})"] = check_captured(
                paged, f"19 tp {TP} bf16 (rank 0, H {h} over {h})", cap)
            out["bf16_bytes"] = _tp_bytes(srv, tp)
        if tp == TP:
            launches[f"19 tp {TP} bf16 turn {turn}"] = nums["launches"]
        del nums["logps"]
        runs.append(nums)
        srv.close()
        del srv, model
    # a bf16 KV block: layers x k, v x heads x 16 x D x 2 B (589,824 B at
    # GPTConfig()), a tp-th of it on each rank
    block = 2 * cfg.num_layers * cfg.hidden_size * 16 * 2
    if out["bf16_bytes"]["block_bytes"] != block or \
            out["bf16_bytes"]["block_shard_bytes"] * TP != block:
        _fail(f"19 bf16 block bytes {out['bf16_bytes']}, want {block}")
    tp1 = (runs[0]["tokens_per_s"] + runs[3]["tokens_per_s"]) / 2
    tp2 = (runs[1]["tokens_per_s"] + runs[2]["tokens_per_s"]) / 2
    out.update({"bf16_turns": runs, "tp2_over_tp1_tokens_per_s": tp2 / tp1})
    print("tp serve " + json.dumps(out))
    return launches, errs, out


def phase_tp_gqa(paged, gcfg, gtree):
    """Phase 19b: GPTConfig(kv_heads=4) with dense f32 weights at tp 1, 2
    and 4 (H 6 over 2, H 3 over 1 KV heads a rank), over dense f32 pools
    (ids equal tp 1's) and over int8 KV pools (the JAX package refuses
    int8 weights on a mesh): ids equal tp 1's but for near-ties
    (_tp_near_ties), the kernel against its plain version on an int8 call
    captured at each tp. Returns (launches by path, errors, numbers)."""
    prompts = tp_prompts(gcfg, TP_AGREE)
    launches, errs, out = {}, {}, {}
    for kv_dtype in (None, "int8"):
        tag = kv_dtype or "dense"
        ids, lps, top2 = {}, {}, None
        for tp in (1,) + TP_GQA:
            model, cap = _serving_model(gcfg, gtree)
            srv = tp_server(model, tp, kv_dtype=kv_dtype)
            arm = _armed_mid_run if tp > 1 and kv_dtype else None
            ids[tp], nums = _tp_pass(paged, gcfg, srv, prompts, AGREE_TOKENS,
                                     tp, f"19b {tag}/GQA tp {tp}", cap=cap,
                                     arm=arm, top2=tp == 1 and bool(kv_dtype))
            lps[tp] = nums["logps"]
            if tp == 1:
                top2 = nums.get("top2")
            if tp > 1:
                launches[f"19b tp {tp} {tag}/GQA f32"] = nums["launches"]
                _tp_bytes(srv, tp)
                what = f"19b {tag}/GQA f32 tp {tp} vs tp 1"
                if kv_dtype:
                    h, hk = gcfg.num_heads // tp, KV_HEADS // tp
                    name = f"19b tp {tp} int8 f32 (rank 0, H {h} over {hk})"
                    errs[name] = check_captured(paged, name, cap)
                    out[f"tp{tp}"] = _tp_near_ties(what, ids[tp], lps[tp],
                                                   ids[1], lps[1], top2)
                else:
                    _tp_same(what, ids[tp], ids[1])
            srv.close()
            del srv, model
    print("tp int8/GQA " + json.dumps(out))
    return launches, errs, out


class FlashCapture:
    """A prefill's attention hook: ops.flash.flash_attention (so every
    launch counts), plus a copy of its first call's inputs."""

    def __init__(self):
        self.case = None

    def __call__(self, q, k, v, causal=False, scale=None):
        from paddle_tpu_torch.ops.flash import flash_attention
        if self.case is None:
            self.case = (q.clone(), k.clone(), v.clone(), None, None, None,
                         causal)
        return flash_attention(q, k, v, scale=scale, causal=causal)


def phase_tp_prompt(flash, cfg, tree):
    """Phase 19c: make_tp_prompt_decoder at tp 2 over phase 6's 8 prompts
    of 512 tokens, 64 new, greedy. f32: ids equal make_prompt_decoder's,
    24 f32 flash launches (12 layers x 2 ranks) a prefill; bf16: 24
    tensor-core launches, the decode timed beside tp 1's; the flash kernel
    against its plain version on each run's first prefill call (B 8, H 6,
    T 512, D 64)."""
    from paddle_tpu_torch.models import gpt
    params = gpt.params_from_numpy(tree, "cuda")
    prompts = make_prompts(cfg.vocab_size)
    max_len = PROMPT_LEN + NEW_TOKENS
    mesh = tp_mesh(TP)
    want = cfg.num_layers * TP
    launches, errs, out = {}, {}, {}
    ref = gpt.make_prompt_decoder(params, cfg, PROMPT_LEN, max_len)(prompts)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cap = FlashCapture()
        decode = gpt.make_tp_prompt_decoder(params, cfg, mesh, PROMPT_LEN,
                                            max_len, dtype=dtype,
                                            attention=cap)
        torch.cuda.synchronize()
        flash.LAUNCHES = flash.TC_LAUNCHES = 0
        t0 = time.perf_counter()
        ids, scores = decode(prompts)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n, tc = flash.LAUNCHES, flash.TC_LAUNCHES
        want_tc = want if dtype == torch.bfloat16 else 0
        if n != want or tc != want_tc:
            _fail(f"19c tp {TP} {tag}: flash launches {n} (tensor-core "
                  f"{tc}), want {want} ({want_tc})")
        if tuple(ids.shape) != (len(prompts), NEW_TOKENS) or \
                not torch.isfinite(scores).all():
            _fail(f"19c tp {TP} {tag}: ids {tuple(ids.shape)} or scores "
                  f"non-finite")
        launches[f"19c tp {TP} prompt decode {tag}"] = n
        shape = " x ".join(f"{a} {n}" for a, n in zip("BHTD",
                                                      cap.case[0].shape))
        errs[tag] = check_one_flash(
            flash, f"19c tp {TP} prefill {tag} (rank 0, {shape})", cap.case)
        out[f"{tag}_s"] = sec
        if dtype == torch.float32:
            same = int((ids == ref[0]).all(dim=1).sum())
            print(f"19c f32: {same}/{len(prompts)} prompts identical at tp "
                  f"{TP} and tp 1 (make_prompt_decoder)")
            if same != len(prompts):
                _fail("19c f32 tp prompt decoder ids differ from tp 1")
    one = gpt.make_prompt_decoder(params, cfg, PROMPT_LEN, max_len,
                                  dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one(prompts)
    torch.cuda.synchronize()
    out["bf16_tp1_s"] = time.perf_counter() - t0
    new = len(prompts) * NEW_TOKENS
    out["tokens_per_s"] = {"tp1": new / out["bf16_tp1_s"],
                           f"tp{TP}": new / out["bf16_s"]}
    print("tp prompt decode " + json.dumps(out))
    return launches, errs


TP_WORLD_STREAM = (((5, 9, 11, 2, 7), 8), ((7,) * 11, 6), ((3, 4), 10),
                   ((12, 13, 14, 15, 16, 17, 18), 12))


def tp_world_server(model, mesh):
    """tests/parallel/test_serving_tp.py's server (3 slots, context 64,
    chunk 4) at the kernel's block size 16."""
    from paddle_tpu_torch.serving import GenerationServer
    return GenerationServer(model, num_slots=3, block_size=16,
                            max_context=64, chunk=4, start=False, mesh=mesh)


def _world_stream(paged, srv):
    """test_serving_tp.py's staggered stream (arrivals after 2 and 3
    steps, one mid-stream cancel) with the paged count set to 0 just
    before. Returns {ids, launches, iterations, a step's reductions, ms
    and block tables}."""
    rec = {"reductions": [], "step_ms": [], "tables": []}

    def step():
        r0 = srv.mesh.reductions if srv.mesh is not None else 0
        t0 = time.perf_counter()
        did = srv.step()
        if did:
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["reductions"].append(
                (srv.mesh.reductions if srv.mesh is not None else 0) - r0)
            rec["tables"].append([[int(b) for b in s.table]
                                  if s is not None else None
                                  for s in srv._sched._slots])
        return did

    def submit(i):
        prompt, n = TP_WORLD_STREAM[i]
        return srv.submit(np.array(prompt, np.int32), max_new_tokens=n)

    torch.cuda.synchronize()
    paged.LAUNCHES = 0
    futs = [submit(0), submit(1)]
    step()
    step()
    futs += [submit(2), submit(3)]
    step()
    if not futs[3].cancel():
        _fail("19d: mid-stream cancel refused")
    while step():
        pass
    rec["launches"] = paged.LAUNCHES
    rec["iterations"] = len(rec["step_ms"])
    rec["ids"] = [[int(t) for t in x] for x in _ids(futs[:3])]
    return rec


def tp_world_rank(rank, init, out):
    """One rank of phase 19d's world (`--tp-world-rank`): joins the gloo
    group, serves the stream on its shard of a tp 2 world mesh on cuda:0,
    and writes its record to <out>/rank<rank>.json."""
    import datetime
    import torch.distributed as dist
    from paddle_tpu_torch.models.gpt import GPTConfig, init_params
    from paddle_tpu_torch.ops.cuda import paged
    from paddle_tpu_torch.parallel.mesh import make_named_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=TP,
                            timeout=datetime.timedelta(seconds=120))
    try:
        paged.build()
        cfg = GPTConfig()
        mesh = make_named_mesh(("tp",), (TP,))
        srv = tp_world_server(make_model(cfg, init_params(cfg, seed=SEED)),
                              mesh)
        rec = _world_stream(paged, srv)
        rec.update(backend=dist.get_backend(), form=srv.get_stats()[
            "mesh"]["form"], shard_shape=list(srv.cache.pools[0]["k"].shape))
        srv.close()
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def phase_tp_world(paged, cfg, tree):
    """Phase 19d: the world form on the card: two processes on cuda:0
    joined by gloo (file:// rendezvous in a temporary directory), each
    holding its rank's params and pool shard, serve test_serving_tp's
    f32 stream: both ranks' ids equal this process's tp 1 server's, each
    rank reduces 2 x 12 times a step, launches = iterations x 12 a rank,
    the block tables are equal across ranks. A rank's failure fails the
    phase. Returns (launches by path, numbers)."""
    import shutil
    import tempfile
    srv = tp_world_server(make_model(cfg, tree), None)
    ref = _world_stream(paged, srv)
    srv.close()
    del srv
    base = tempfile.mkdtemp(prefix="tp_world_")
    init = "file://" + os.path.join(base, "rendezvous")
    procs = []
    try:
        for r in range(TP):
            log = open(os.path.join(base, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--tp-world-rank", str(r), init, base],
                stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + TP_WORLD_TIMEOUT_S
        codes = []
        for p, _log in procs:
            try:
                codes.append(p.wait(max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        if codes != [0] * TP:
            for r in range(TP):
                with open(os.path.join(base, f"rank{r}.log")) as f:
                    print(f"19d rank {r} log tail:\n" + f.read()[-3000:])
            _fail(f"19d: rank exit codes {codes}")
        recs = []
        for r in range(TP):
            with open(os.path.join(base, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(base, ignore_errors=True)
    launches, out = {}, {"tp1_step_ms_p50":
                         float(np.percentile(ref["step_ms"], 50)),
                         "tp1_iterations": ref["iterations"]}
    for r, rec in enumerate(recs):
        if rec["ids"] != ref["ids"]:
            _fail(f"19d rank {r}: ids {rec['ids']} != tp 1 {ref['ids']}")
        if set(rec["reductions"]) != {2 * cfg.num_layers}:
            _fail(f"19d rank {r}: reductions a step "
                  f"{sorted(set(rec['reductions']))}, want "
                  f"{2 * cfg.num_layers}")
        if rec["launches"] <= 0 or \
                rec["launches"] != rec["iterations"] * cfg.num_layers:
            _fail(f"19d rank {r}: launches {rec['launches']} != "
                  f"iterations {rec['iterations']} x {cfg.num_layers}")
        if rec["tables"] != recs[0]["tables"] or \
                rec["iterations"] != ref["iterations"]:
            _fail(f"19d rank {r}: block tables or iterations differ")
        if rec["shard_shape"][1] != cfg.num_heads // TP or \
                rec["form"] != "world":
            _fail(f"19d rank {r}: shard {rec['shard_shape']}, form "
                  f"{rec['form']}")
        launches[f"19d world rank {r} f32"] = rec["launches"]
        out[f"rank{r}"] = {"backend": rec["backend"],
                           "iterations": rec["iterations"],
                           "launches": rec["launches"],
                           "step_ms_p50": float(np.percentile(
                               rec["step_ms"], 50)),
                           "step_ms_p99": float(np.percentile(
                               rec["step_ms"], 99))}
    print(f"19d: both ranks' ids equal tp 1's ({len(ref['ids'])} "
          f"requests), {2 * cfg.num_layers} reductions a step")
    print("tp world " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# phases 20-20d: the training recipe (bf16 products with dynamic loss
# scaling, warmup then linear decay, the global-norm clip, weight decay;
# recompute) on phase 16's BERT-base pretraining
# ---------------------------------------------------------------------------

def build_recipe(cfg, policy=None):
    """(main, startup, loss, the learning-rate var, the amp optimizer):
    phase 16's MLM+NSP net at seq BERT_SEQ under
    amp.decorate(AdamOptimizer(linear_lr_warmup(polynomial_decay(...)),
    regularization=L2Decay), dynamic loss scaling) with
    set_gradient_clip(GradientClipByGlobalNorm), optionally inside
    RecomputeOptimizer(policy=). The program seed is build_bert's, so the
    startup draws phase 16's weights."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    lay = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 16
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _f, loss, _mlm, _acc = bert.build_pretrain_net(cfg, seq_len=BERT_SEQ)
        lr = lay.linear_lr_warmup(
            lay.polynomial_decay(RECIPE_PEAK_LR,
                                 decay_steps=RECIPE_DECAY_STEPS,
                                 end_learning_rate=0.0),
            warmup_steps=RECIPE_WARMUP, start_lr=0.0, end_lr=RECIPE_PEAK_LR)
        opt = fluid.amp.decorate(
            fluid.optimizer.AdamOptimizer(
                learning_rate=lr,
                regularization=fluid.regularizer.L2Decay(RECIPE_L2)),
            init_loss_scaling=RECIPE_SCALE, use_dynamic_loss_scaling=True)
        outer = opt if policy is None else \
            fluid.optimizer.RecomputeOptimizer(opt, policy=policy)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(RECIPE_CLIP))
        try:
            outer.minimize(loss)
        finally:
            fluid.clip.set_gradient_clip(None)
    return main, startup, loss, lr, opt


def recipe_lr(step):
    """The schedule's closed form at 0-based step `step`."""
    if step < RECIPE_WARMUP:
        return RECIPE_PEAK_LR * step / RECIPE_WARMUP
    return RECIPE_PEAK_LR * (1.0 - min(step, RECIPE_DECAY_STEPS)
                             / RECIPE_DECAY_STEPS)


def _scalar(scope, name):
    return float(scope.get(name).reshape(-1)[0])


def phase_recipe(flash, bert16):
    """Phase 20: the recipe at phase 16's configuration (BertConfig(),
    seq BERT_SEQ x batch BERT_BATCH, dropout 0.1, the ERNIE feed) for
    BERT_WARM + BERT_STEPS steps: every loss finite, the last below
    BERT_LOSS_MARGIN x the first, the first within AMP_FIRST_LOSS_RTOL of
    phase 16's f32 first loss (`bert16`: its printed record), 12 + 12 + 12
    f32 flash launches a step and no tensor-core launch (attention stays
    f32: multihead_attention is not on the white list), the rate fetched
    each step the schedule's closed form. Then a profile of
    BERT_PROFILE_STEPS more steps. Returns the run's (fwd, dQ, dK/dV, bf16
    fwd) launches and its record."""
    import paddle_tpu_torch as fluid
    cfg = bert_config()
    main, startup, loss, lr, opt = build_recipe(cfg)
    feed = bert_feed()
    exe = fluid.Executor()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    n = cfg.num_hidden_layers
    scope = fluid.Scope()
    rates = []
    with fluid.scope_guard(scope):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        _zero_counts(flash)
        losses, step_ms, per_step, tc = _train_run(
            flash, exe, main, feed, loss, BERT_WARM + BERT_STEPS, BERT_WARM,
            extra=[lr], extra_out=rates)
        counts = _bwd_counts(flash)
        peak = torch.cuda.max_memory_allocated()
        scale = _scalar(scope, opt.get_loss_scaling().name)
        good = _scalar(scope, opt._good_steps.name)
        prof = _profile_train(lambda: exe.run(main, feed=feed,
                                              fetch_list=[loss]),
                              BERT_PROFILE_STEPS)
    if per_step != {(n, n, n)} or tc != 0:
        _fail(f"recipe: flash launches fwd/dq/dkv per step {per_step}, "
              f"want {n} each; {tc} tensor-core, want 0")
    first, last = losses[0], losses[-1]
    if not np.isfinite(losses).all() or not last < BERT_LOSS_MARGIN * first:
        _fail(f"recipe: loss not finite or not below {BERT_LOSS_MARGIN} x "
              f"the first: {losses}")
    first_err = abs(first - bert16["loss_first"]) / abs(bert16["loss_first"])
    if not first_err <= AMP_FIRST_LOSS_RTOL:
        _fail(f"recipe: first loss {first} against phase 16's f32 "
              f"{bert16['loss_first']}: {first_err:.3e} > "
              f"{AMP_FIRST_LOSS_RTOL}")
    got = [float(np.asarray(r[0]).reshape(-1)[0]) for r in rates]
    want = [recipe_lr(i) for i in range(len(got))]
    lr_err = max(abs(g - w) / max(abs(w), 1e-30) if w else abs(g)
                 for g, w in zip(got, want))
    if not lr_err <= RECIPE_LR_RTOL:
        _fail(f"recipe: rates {got} against the schedule {want}")
    mean_ms = float(np.mean(step_ms))
    b, t = BERT_BATCH, BERT_SEQ
    out = {"config": "BertConfig(max_position_embeddings=512)",
           "recipe": f"amp.decorate(Adam(linear_lr_warmup(polynomial_decay("
                     f"{RECIPE_PEAK_LR}, {RECIPE_DECAY_STEPS}, 0.0), "
                     f"{RECIPE_WARMUP}, 0.0, {RECIPE_PEAK_LR}), "
                     f"L2Decay({RECIPE_L2})), {RECIPE_SCALE}, dynamic), "
                     f"GradientClipByGlobalNorm({RECIPE_CLIP})",
           "seq_len": t, "batch": b, "ops": len(main.global_block().ops),
           "ops_phase16": bert16["ops"],
           "startup_s": startup_s, "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "step_ms_mean": mean_ms,
           "tokens_per_s": b * t / (mean_ms / 1e3),
           "max_memory_allocated": peak,
           "allocated_before": before,
           "loss_first": first, "loss_last": last,
           "loss_ratio": last / first,
           "loss_first_phase16_f32": bert16["loss_first"],
           "loss_first_rel_err_vs_f32": first_err,
           "lr_first_last": [got[0], got[-1]], "lr_rel_err": lr_err,
           "loss_scale_end": scale, "good_steps_end": good,
           "flash_launches_fwd_dq_dkv": list(counts)}
    print("recipe " + json.dumps(out))
    print("profile recipe " + json.dumps(prof))
    return counts + (tc,), out, prof


def _copy_scope(scope):
    import paddle_tpu_torch as fluid
    new = fluid.Scope()
    for name in scope.names():
        new.set(name, scope.get(name).clone())
    return new


class _BackwardProbe:
    """Around one Executor step: the bytes of the forward's 2-D products
    (outputs of aten.mm / aten.addmm, read by a dispatch mode until the
    backward starts), the memory allocated as the backward starts
    (torch.autograd.grad entered: what the forward left for it, the
    checkpoints' saved products included, beside the weights and the
    optimizer state) and the peak since the last reset as it ends."""

    def __init__(self):
        self.mm_bytes = self.held = self.peak = None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        products = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        probe = self
        self.mm_bytes = 0

        class Products(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if probe.held is None and func in products:
                    probe.mm_bytes += out.numel() * out.element_size()
                return out

        grad = self._grad = torch.autograd.grad

        def backward(*a, **k):
            torch.cuda.synchronize()
            probe.held = torch.cuda.memory_allocated()
            out = grad(*a, **k)
            torch.cuda.synchronize()
            probe.peak = torch.cuda.max_memory_allocated()
            return out

        torch.autograd.grad = backward
        self._mode = Products()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        torch.autograd.grad = self._grad


def phase_recipe_recompute(flash):
    """Phase 20b: the recipe without recompute (twice: the second run
    measures what differs between two identical runs) and under
    RecomputeOptimizer(policy=) for each of RECOMPUTE_POLICIES, from
    copies of one startup scope, RECOMPUTE_STEPS steps each: the first
    step's loss and @GRADs equal the run without recompute (within
    RECOMPUTE_LOSS_TOL / RECOMPUTE_GRAD_TOL, see their comment), the later
    losses within AMP_AGREE_LOSS_TOL, the flash forward launched 24 times
    a step under recompute (the checkpoint re-runs it) and dQ, dK/dV 12
    each, and the peak memory below the run without recompute. The first
    step of each run is probed (_BackwardProbe): as the backward starts,
    "dots" holds at least RECOMPUTE_DOTS_HELD_SHARE of the forward's 2-D
    products' bytes more than "nothing", and less than the run without
    recompute. "offload" copies its saved products to pinned host memory
    (its bytes a step are printed; only it copies any). Returns (launches
    by run, record)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.optimizer import recompute
    cfg = bert_config()
    n = cfg.num_hidden_layers
    feed = bert_feed()
    base = None
    runs, launches = {}, {}
    for tag, policy in (("none", None), ("none again", None)) + tuple(
            (p, p) for p in RECOMPUTE_POLICIES):
        main, startup, loss, _lr, _opt = build_recipe(cfg, policy)
        names = [p.name + "@GRAD" for p in main.all_parameters()]
        # a new Executor a run: its step counter seeds dropout's masks
        exe = fluid.Executor()
        if base is None:
            base = fluid.Scope()
            fluid.Executor().run(startup, scope=base)
        scope = _copy_scope(base)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(flash)
        pinned0 = recompute.OFFLOADED_BYTES
        losses, grads, step_ms, per_step = [], None, [], set()
        for i in range(RECOMPUTE_STEPS):
            before = _bwd_counts(flash)
            ts = time.perf_counter()
            if i == 0:
                with _BackwardProbe() as probe:
                    out = exe.run(main, feed=feed, scope=scope,
                                  fetch_list=[loss] + names)
            else:
                out = exe.run(main, feed=feed, scope=scope,
                              fetch_list=[loss])
            step_ms.append((time.perf_counter() - ts) * 1e3)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            if i == 0:
                grads = out[1:]
            per_step.add(tuple(a - b for a, b in zip(_bwd_counts(flash),
                                                     before)))
        runs[tag] = {"losses": losses, "grads": grads,
                     "peak": torch.cuda.max_memory_allocated(),
                     "held_at_backward": probe.held,
                     "first_backward_peak": probe.peak,
                     "forward_mm_bytes": probe.mm_bytes,
                     "step_ms": step_ms, "per_step": sorted(per_step),
                     "tc": flash.TC_LAUNCHES,
                     "pinned": (recompute.OFFLOADED_BYTES - pinned0)
                     / RECOMPUTE_STEPS}
        launches[tag] = _bwd_counts(flash) + (flash.TC_LAUNCHES,)
        del scope
    plain = runs["none"]
    if plain["per_step"] != [(n, n, n)] or plain["tc"]:
        _fail(f"recompute: launches {plain['per_step']} a step without "
              f"recompute, want {n} each")
    record = {"steps": RECOMPUTE_STEPS, "names": len(plain["grads"])}
    gmax = max(float(np.abs(g).max()) for g in plain["grads"])
    for tag, run in runs.items():
        errs = [abs(a - b) / abs(b)
                for a, b in zip(run["losses"], plain["losses"])]
        grad_err = max(float(np.abs(a - b).max())
                       / (float(np.abs(b).max()) + 1e-3 * gmax)
                       for a, b in zip(run["grads"], plain["grads"]))
        record[tag] = {"peak_bytes": run["peak"],
                       "held_at_backward_bytes": run["held_at_backward"],
                       "first_backward_peak_bytes":
                           run["first_backward_peak"],
                       "forward_mm_bytes": run["forward_mm_bytes"],
                       "step_ms": run["step_ms"],
                       "losses": run["losses"],
                       "loss_rel_errs": errs, "grad_rel_err": grad_err,
                       "grads_not_bitwise": [
                           nm for nm, a, b in zip(names, run["grads"],
                                                  plain["grads"])
                           if not np.array_equal(a, b)],
                       "launches_a_step": run["per_step"],
                       "pinned_host_bytes_a_step": run["pinned"]}
        if (tag == "offload") != (run["pinned"] > 0):
            _fail(f"recompute {tag}: {run['pinned']} B a step copied to "
                  f"pinned host memory")
        if tag.startswith("none"):
            continue
        if run["per_step"] != [(2 * n, n, n)] or run["tc"]:
            _fail(f"recompute {tag}: launches {run['per_step']} a step, "
                  f"want ({2 * n}, {n}, {n}); {run['tc']} tensor-core")
        if not (errs[0] <= RECOMPUTE_LOSS_TOL
                and max(errs[1:]) <= AMP_AGREE_LOSS_TOL
                and grad_err <= RECOMPUTE_GRAD_TOL):
            _fail(f"recompute {tag}: losses {run['losses']} against "
                  f"{plain['losses']} ({errs}), gradients {grad_err:.3e}")
        if not run["peak"] < plain["peak"]:
            _fail(f"recompute {tag}: peak {run['peak']} B not below "
                  f"{plain['peak']} B without recompute")
    dots, nothing = runs["dots"], runs["nothing"]
    saved = dots["held_at_backward"] - nothing["held_at_backward"]
    record["dots_minus_nothing_held_bytes"] = saved
    print("recompute " + json.dumps(record))
    if not (RECOMPUTE_DOTS_HELD_SHARE * dots["forward_mm_bytes"] <= saved
            and dots["held_at_backward"] < plain["held_at_backward"]):
        _fail(f"recompute: as the backward starts \"dots\" holds {saved} B "
              f"more than \"nothing\", want at least "
              f"{RECOMPUTE_DOTS_HELD_SHARE} x its forward's "
              f"{dots['forward_mm_bytes']} B of 2-D products, and less than "
              f"the {plain['held_at_backward']} B without recompute")
    return launches, record


def phase_overflow(flash):
    """Phase 20c: OVERFLOW_STEPS steps of the recipe, then the
    loss-scaling var set to OVERFLOW_SCALE for one step (the scaled loss
    overflows): every parameter finite after it (the port zeroes the
    gradients with a select where the JAX package's multiply makes
    NaN), the scale decayed to 0.8 x OVERFLOW_SCALE (f32, 1e-6), the
    good-step counter 0, and the next OVERFLOW_STEPS losses finite.
    Returns the record."""
    import paddle_tpu_torch as fluid
    cfg = bert_config()
    main, startup, loss, _lr, opt = build_recipe(cfg)
    feed = bert_feed()
    exe = fluid.Executor()
    scope = fluid.Scope()
    sname, gname = opt.get_loss_scaling().name, opt._good_steps.name

    def step():
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        return float(np.asarray(out).reshape(-1)[0])

    exe.run(startup, scope=scope)
    before = [step() for _ in range(OVERFLOW_STEPS)]
    good_before = _scalar(scope, gname)
    scope.set(sname, torch.full_like(scope.get(sname), OVERFLOW_SCALE))
    at = step()
    scale, good = _scalar(scope, sname), _scalar(scope, gname)
    bad = [p.name for p in main.all_parameters()
           if not bool(torch.isfinite(scope.get(p.name)).all())]
    after = [step() for _ in range(OVERFLOW_STEPS)]
    want = 0.8 * OVERFLOW_SCALE
    record = {"losses_before": before, "good_steps_before": good_before,
              "loss_at_overflow": at, "scale_after": scale,
              "scale_want": want, "good_steps_after": good,
              "non_finite_params": bad, "losses_after": after,
              "scale_end": _scalar(scope, sname)}
    print("overflow " + json.dumps(record))
    if bad or abs(scale / want - 1.0) > 1e-6 or good != 0.0 or \
            good_before != OVERFLOW_STEPS or \
            not np.isfinite(before + [at] + after).all():
        _fail("overflow: the injected overflow step did not keep the "
              "parameters finite, decay the scale and reset the counter")
    return record


def phase_recipe_agree(flash):
    """Phase 20d: train_agree on the recipe's program at full width,
    BERT_AGREE_LAYERS layers, dropout 0, BERT_AGREE_STEPS steps on 16b's
    padded feed, at AMP_AGREE_LOSS_TOL / AMP_AGREE_GRAD_TOL (see their
    comment): the f32 flash kernels against the plain attention with
    the same bf16 products on both sides."""
    cfg = bert_config(num_hidden_layers=BERT_AGREE_LAYERS,
                      hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    feed = bert_feed()
    feed["input_mask"][1, BERT_SEQ - BERT_PAD:] = 0.0
    feed["input_mask"][5, BERT_SEQ // 2:] = 0.0
    main, startup, loss, _lr, _opt = build_recipe(cfg)
    return train_agree(flash, "recipe agree (bf16 products)",
                       (main, startup, loss), feed, BERT_AGREE_LAYERS,
                       BERT_AGREE_STEPS, loss_tol=AMP_AGREE_LOSS_TOL,
                       grad_tol=AMP_AGREE_GRAD_TOL)


def phase_recipe_all(flash, bert16, prof16):
    """Phases 20-20d, the cuBLAS bf16 GEMMs reducing split-K partials in
    f32 (as XLA accumulates a bf16 dot), the setting restored after.
    Returns (flash launches by path, 20d's errors, 20's (record,
    profile)). Garbage the earlier
    phases left in reference cycles (servers, pools) is collected first,
    so that it neither counts in 20's peak memory nor pauses its steps."""
    gc.collect()
    torch.cuda.empty_cache()
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        rlaunches, rec, prof = _phase("20 recipe", phase_recipe, flash,
                                      bert16)
        print("profile recipe vs 16 (f32): " + json.dumps({
            k: [prof[k], prof16[k]] for k in (
                "wall_ms_per_step", "device_ms_per_step",
                "device_busy_share", "device_ops_per_step",
                "flash_share_of_device")}))
        claunches, _ = _phase("20b recompute", phase_recipe_recompute,
                              flash)
        _phase("20c overflow", phase_overflow, flash)
        alaunches, aerrs = _phase("20d recipe agree", phase_recipe_agree,
                                  flash)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    paths = {f"20 recipe ({BERT_WARM + BERT_STEPS} steps)": rlaunches,
             **{f"20b recompute {tag} ({RECOMPUTE_STEPS} steps)": c
                for tag, c in claunches.items()},
             f"20d recipe agree (kernel run, {BERT_AGREE_LAYERS} layers x "
             f"{BERT_AGREE_STEPS} steps)": alaunches}
    return paths, aerrs, (rec, prof)


# ---------------------------------------------------------------------------
# phases 21-21d: data parallelism through CompiledProgram on a dp mesh
# ---------------------------------------------------------------------------

def _shard_shapes(comp, exe, feed):
    """Each feed's shard shapes as the dp walk splits it over the mesh."""
    from paddle_tpu_torch.core.compiler import DataParallelWalk
    from paddle_tpu_torch.ops import Sharded
    walk = DataParallelWalk(comp.mesh, exe.device)
    split = walk.split_feeds({k: torch.from_numpy(np.asarray(v))
                              for k, v in feed.items()})
    return {k: [list(p.shape) for p in v.parts] if isinstance(v, Sharded)
            else list(v.shape) for k, v in split.items()}


def _dp_program(main, loss, places):
    """CompiledProgram(main).with_data_parallel over `places` (None: the
    world)."""
    import paddle_tpu_torch as fluid
    return fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=places)


def phase_dp(flash, bert16, prof16):
    """Phase 21: phase 16's cell through with_data_parallel on a local dp
    DP mesh on the card. Returns ((fwd, dQ, dK/dV, bf16 fwd) launches of
    the run, its record)."""
    import paddle_tpu_torch as fluid
    cfg = bert_config()
    main, startup, loss = build_bert(cfg)
    feed = bert_feed()
    exe = fluid.Executor()
    comp = _dp_program(main, loss, [fluid.CUDAPlace(0)] * DP)
    shapes = _shard_shapes(comp, exe, feed)
    print("dp feed shards " + json.dumps(shapes))
    rows = BERT_BATCH // DP
    for k, v in feed.items():
        if shapes[k] != [[rows] + list(v.shape[1:])] * DP:
            _fail(f"dp: feed {k} {list(v.shape)} split into {shapes[k]}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = cfg.num_hidden_layers
    steps = BERT_WARM + BERT_STEPS
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        _zero_counts(flash)
        red0 = comp.mesh.reductions
        losses, step_ms, per_step, tc = _train_run(
            flash, exe, comp, feed, loss, steps, BERT_WARM)
        counts = _bwd_counts(flash)
        reductions = comp.mesh.reductions - red0
        peak = torch.cuda.max_memory_allocated()
        prof = _profile_train(lambda: exe.run(comp, feed=feed,
                                              fetch_list=[loss]),
                              BERT_PROFILE_STEPS)
    if per_step != {(DP * n,) * 3} or tc or counts != (steps * DP * n,) * 3:
        _fail(f"dp: flash launches fwd/dq/dkv per step {per_step} (run "
              f"{counts}), want {DP} x {n} each; {tc} tensor-core")
    if reductions != steps * DP_REDUCTIONS:
        _fail(f"dp: {reductions} reductions in {steps} steps, want "
              f"{DP_REDUCTIONS} a step")
    first, last = losses[0], losses[-1]
    if not np.isfinite(losses).all() or not last < BERT_LOSS_MARGIN * first:
        _fail(f"dp: loss not finite or not below {BERT_LOSS_MARGIN} x the "
              f"first: {losses}")
    mean_ms = float(np.mean(step_ms))
    out = {"config": "BertConfig(max_position_embeddings=512)",
           "mesh": f"local dp {DP} on cuda:0", "seq_len": BERT_SEQ,
           "batch": BERT_BATCH, "rows_a_rank": rows,
           "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "step_ms_mean": mean_ms,
           "tokens_per_s": BERT_BATCH * BERT_SEQ / (mean_ms / 1e3),
           "max_memory_allocated": peak, "loss_first": first,
           "loss_last": last, "loss_ratio": last / first,
           "reductions_per_step": reductions / steps,
           "flash_launches_fwd_dq_dkv": list(counts),
           "flash_launches_per_step": list(next(iter(per_step)))}
    print("dp " + json.dumps(out))
    print("profile dp " + json.dumps(prof))
    keys = ("step_ms_p50", "step_ms_p99", "tokens_per_s",
            "max_memory_allocated", "loss_first", "loss_last")
    pkeys = ("wall_ms_per_step", "device_ms_per_step", "device_busy_share",
             "device_ops_per_step", "flash_share_of_device")
    print("dp 2 vs 16 (one rank, f32): " + json.dumps(
        {**{k: [out[k], bert16[k]] for k in keys},
         **{k: [prof[k], prof16[k]] for k in pkeys}}))
    return counts + (tc,), out, prof


def dp_agree_program():
    """(main, startup, loss): phase 16's net at full width, 2 layers,
    dropout 0."""
    return build_bert(bert_config(num_hidden_layers=BERT_AGREE_LAYERS,
                                  hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0))


def dp_agree_feed():
    """16b's padded feed with unequal masked-LM weights per rank: rank
    0's rows keep one prediction each, rank 1's all of theirs."""
    feed = bert_feed()
    feed["input_mask"][1, BERT_SEQ - BERT_PAD:] = 0.0
    feed["input_mask"][5, BERT_SEQ // 2:] = 0.0
    feed["mask_weight"][:BERT_BATCH // DP, 1:] = 0.0
    return feed


def _dp_steps(flash, step, base, loss, names, steps):
    """`steps` calls of step(fetch_list) from a copy of `base`: (losses,
    the first step's @GRADs, (fwd, dQ, dK/dV, bf16 fwd) launches)."""
    import paddle_tpu_torch as fluid
    _zero_counts(flash)
    losses = []
    with fluid.scope_guard(_copy_scope(base)):
        for i in range(steps):
            out = step([loss] + (
                [nm + "@GRAD" for nm in names] if i == 0 else []))
            losses.append(out[0].double().item())
            if i == 0:
                grads = out[1:]
    return losses, grads, _bwd_counts(flash) + (flash.TC_LAUNCHES,)


def _grad_rel_err(got, want, names):
    """(the worst @GRAD error over its tensor's scale, plus 1e-3 of the
    largest gradient, as train_agree; its name)."""
    floor = 1e-3 * max(g.abs().max().item() for g in want)
    return max(((a - b).abs().max().item() / (b.abs().max().item() + floor),
                nm) for nm, a, b in zip(names, got, want))


def _staged(tag, got, want, names, first_tol, grad_tol):
    """The staged comparison of two runs (losses, grads, launches): the
    first loss within `first_tol`, the first step's @GRADs within
    `grad_tol` of their scale, later losses within DP_LATER_LOSS_TOL."""
    first = abs(got[0][0] - want[0][0]) / abs(want[0][0])
    later = max(abs(a - b) / abs(b) for a, b in zip(got[0][1:], want[0][1:]))
    grad, worst = _grad_rel_err(got[1], want[1], names)
    print(f"{tag}: losses {got[0]} vs {want[0]} (first rel err {first:.3e}, "
          f"tolerance {first_tol}; later {later:.3e}, tolerance "
          f"{DP_LATER_LOSS_TOL}); {len(names)} @GRADs, worst {grad:.3e} at "
          f"{worst} (tolerance {grad_tol})")
    if not (first <= first_tol and later <= DP_LATER_LOSS_TOL
            and grad <= grad_tol):
        _fail(f"{tag}: the runs disagree")
    return {"first_loss_rel_err": first, "later_loss_rel_err": later,
            "grad_rel_err": grad}


def _runner(exe, program, feed):
    return lambda fetch_list: exe.run(program, feed=feed,
                                      fetch_list=fetch_list,
                                      return_numpy=False)


def phase_dp_agree(flash):
    """Phase 21b: dp DP against dp 1 through the kernels, then dp DP with
    the plain attention. Returns (the dp DP kernel run's launches, the
    errors, its (losses, first-step @GRADs, parameter names))."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import attention_ops
    main, startup, loss = dp_agree_program()
    feed = dp_agree_feed()
    exe = fluid.Executor()
    base = fluid.Scope()
    with fluid.scope_guard(base):
        exe.run(startup)
    names = [p.name for p in main.all_parameters()]
    dp1 = _dp_program(main, loss, [fluid.CUDAPlace(0)])
    dp2 = _dp_program(main, loss, [fluid.CUDAPlace(0)] * DP)
    steps, layers = BERT_AGREE_STEPS, BERT_AGREE_LAYERS
    one = _dp_steps(flash, _runner(exe, dp1, feed), base, loss, names,
                    steps)
    red0 = dp2.mesh.reductions
    two = _dp_steps(flash, _runner(exe, dp2, feed), base, loss, names,
                    steps)
    reductions = dp2.mesh.reductions - red0
    real = attention_ops.dot_product_attention
    attention_ops.dot_product_attention = _plain_attention
    try:
        plain = _dp_steps(flash, _runner(exe, dp2, feed), base, loss,
                          names, steps)
    finally:
        attention_ops.dot_product_attention = real
    want1, want2 = (layers * steps,) * 3 + (0,), (DP * layers * steps,) * 3 \
        + (0,)
    if one[2] != want1 or two[2] != want2 or plain[2] != (0,) * 4:
        _fail(f"dp agree: launches dp 1 {one[2]} (want {want1}), dp {DP} "
              f"{two[2]} (want {want2}), plain {plain[2]}")
    if reductions != steps * DP_REDUCTIONS:
        _fail(f"dp agree: {reductions} reductions in {steps} steps")
    errs = {"dp2_vs_dp1": _staged(f"dp agree: dp {DP} vs dp 1", two, one,
                                  names, DP_FIRST_LOSS_TOL, DP_GRAD_TOL)}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(two[0], plain[0]))
    grad_err, worst = _grad_rel_err(two[1], plain[1], names)
    print(f"dp agree: dp {DP} kernels vs plain attention: losses "
          f"{two[0]} vs {plain[0]} (worst rel err {loss_err:.3e}, "
          f"tolerance {TRAIN_LOSS_TOL}); @GRADs worst {grad_err:.3e} at "
          f"{worst} (tolerance {TRAIN_GRAD_TOL})")
    if not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL):
        _fail("dp agree: the kernels disagree with the plain attention")
    errs["kernel_vs_plain"] = {"loss_rel_err": loss_err,
                               "grad_rel_err": grad_err}
    return two[2], errs, (two[0], two[1], names)


def phase_dp_sp(flash):
    """Phase 21c: phase 9's GPT on a local dp DP x sp 2 mesh against dp 1,
    BERT_AGREE_STEPS steps. Returns (the mesh run's launches, errors)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.mesh import make_mesh
    cfg, main, startup, loss, toks = build_train()
    feed = {"tokens": toks}
    exe = fluid.Executor()
    base = fluid.Scope()
    with fluid.scope_guard(base):
        exe.run(startup)
    names = [p.name for p in main.all_parameters()]
    sp = 2
    dp1 = _dp_program(main, loss, [fluid.CUDAPlace(0)])
    mesh = make_mesh(dp=DP, sp=sp, devices=["cuda:0"] * (DP * sp))
    dpsp = fluid.CompiledProgram(main).with_mesh(mesh)
    steps, n = BERT_AGREE_STEPS, cfg.num_layers
    one = _dp_steps(flash, _runner(exe, dp1, feed), base, loss, names,
                    steps)
    two = _dp_steps(flash, _runner(exe, dpsp, feed), base, loss, names,
                    steps)
    ring = sp * (sp + 1) // 2            # a causal ring's flash steps
    want1 = (n * steps,) * 3 + (0,)
    want2 = (n * DP * ring * steps,) * 3 + (0,)
    if one[2] != want1 or two[2] != want2:
        _fail(f"dp x sp: launches dp 1 {one[2]} (want {want1}), dp {DP} x "
              f"sp {sp} {two[2]} (want {want2})")
    errs = _staged(f"dp x sp: dp {DP} x sp {sp} vs dp 1", two, one, names,
                   DP_SP_FIRST_LOSS_TOL, DP_SP_GRAD_TOL)
    return two[2], errs


def dp_world_rank(rank, init, out):
    """One rank of phase 21d's world (`--dp-world-rank`): joins the gloo
    group, runs 21b's program through with_data_parallel() over the world
    on cuda:0 and writes its record to <out>/rank<rank>.json, its first
    step's @GRADs to <out>/rank<rank>_grads.pt."""
    import datetime
    import torch.distributed as dist
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.cuda import flash
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=DP,
                            timeout=datetime.timedelta(seconds=120))
    try:
        flash.build()
        flash.build_bwd()
        main, startup, loss = dp_agree_program()
        feed = dp_agree_feed()
        exe = fluid.Executor()
        comp = _dp_program(main, loss, None)
        mesh = comp.mesh
        if not mesh.world or mesh.held("dp") != [rank]:
            raise RuntimeError(f"not a world dp mesh: {mesh}")
        rec = {"losses": [], "reductions": [], "launches": [],
               "step_ms": []}
        gnames = [p.name + "@GRAD" for p in main.all_parameters()]
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            for i in range(BERT_AGREE_STEPS):
                before, red0 = _bwd_counts(flash), mesh.reductions
                t0 = time.perf_counter()
                out_ = exe.run(comp, feed=feed, fetch_list=[loss] + (
                    gnames if i == 0 else []), return_numpy=False)
                if i == 0:
                    torch.save([g.cpu() for g in out_[1:]],
                               os.path.join(out, f"rank{rank}_grads.pt"))
                rec["losses"].append(out_[0].double().item())
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["reductions"].append(mesh.reductions - red0)
                rec["launches"].append([a - b for a, b in zip(
                    _bwd_counts(flash), before)])
            spent = {"all_reduce": 0.0, "gradients": 0.0, "bytes": 0}
            real_ar, real_grads = dist.all_reduce, mesh.all_reduce_grads

            def timed(fn, key):
                def call(*a, **k):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    r = fn(*a, **k)
                    torch.cuda.synchronize()
                    spent[key] += time.perf_counter() - t
                    return r
                return call

            def grads(gs, *a, **k):
                spent["bytes"] = sum(g.numel() * g.element_size()
                                     for g in gs)
                return timed(real_grads, "gradients")(gs, *a, **k)

            dist.all_reduce = timed(real_ar, "all_reduce")
            mesh.all_reduce_grads = grads
            try:
                for _ in range(DP_WORLD_TIMED):
                    exe.run(comp, feed=feed, fetch_list=[loss])
            finally:
                dist.all_reduce = real_ar
                del mesh.all_reduce_grads
            gc.collect()
            rec["replicated_state_bytes"] = torch.cuda.memory_allocated() \
                - mem0
        rec.update(backend=dist.get_backend(),
                   all_reduce_ms_per_step=spent["all_reduce"]
                   / DP_WORLD_TIMED * 1e3,
                   gradient_all_reduce_ms_per_step=spent["gradients"]
                   / DP_WORLD_TIMED * 1e3,
                   gradient_bytes=spent["bytes"])
        t_shard = time.perf_counter()
        rec["shard"] = {form: shard_world_form(flash, feed, form, rank, out)
                        for form in ("both", "zero1")}
        rec["shard_s"] = time.perf_counter() - t_shard
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def shard_world_form(flash, feed, form, rank, out):
    """Phase 34c in one rank of 21d's world: 21b's program under `form`'s
    annotations ("both": FSDP + ZeRO-1, the fleet's use_fsdp; "zero1"
    alone) through with_data_parallel() over the world, BERT_AGREE_STEPS
    steps, then DP_WORLD_TIMED steps timing the gathers and all-reduces.
    Rank 0 writes its first step's @GRADs to <out>/shard_<form>_grads.pt;
    every rank records their digest, its losses, reductions and launches
    a step, the memory its state holds, and the elements of every sharded
    variable it holds. "both" then saves a sharded checkpoint to
    <out>/ckpt from both ranks and records the global state's digests."""
    import hashlib
    import torch.distributed as dist
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io.state import host_array
    from paddle_tpu_torch.parallel import ShardedTensor
    main, startup, loss = dp_agree_program()
    _annotate(main, form)
    comp = _dp_program(main, loss, None)
    mesh = comp.mesh
    gnames = [p.name + "@GRAD" for p in main.all_parameters()]
    # a new Executor: the startup's draws fold in its step counter, so
    # this one starts from 34b's state
    exe = fluid.Executor()
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    rec = {"losses": [], "reductions": [], "launches": []}
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for i in range(BERT_AGREE_STEPS):
            before, red0 = _bwd_counts(flash), mesh.reductions
            got = exe.run(comp, feed=feed, fetch_list=[loss] + (
                gnames if i == 0 else []), return_numpy=False)
            if i == 0:
                grads = [g.cpu() for g in got[1:]]
                rec["grad_digest"] = hashlib.sha1(b"".join(
                    g.numpy().tobytes() for g in grads)).hexdigest()
                if rank == 0:
                    torch.save(grads, os.path.join(
                        out, f"shard_{form}_grads.pt"))
                del grads
            rec["losses"].append(got[0].double().item())
            rec["reductions"].append(mesh.reductions - red0)
            rec["launches"].append([a - b for a, b in zip(
                _bwd_counts(flash), before)])
            del got
        laid = _laid_out(scope)
        rec["sharded_values"] = len(laid)
        rec["held_half"] = all(len(v.parts) == 1 and
                               2 * v.numel() == v.global_numel()
                               for v in laid.values())
        rec["scope_elements"], rec["share_elements"], \
            rec["whole_copies"] = _scope_shares(main, scope, mesh)
        rec["held_elements"] = sum(v.numel() for v in laid.values())
        rec["global_elements"] = sum(v.global_numel() for v in laid.values())
        rec["gathers_per_step"] = sum(p.name in laid
                                      for p in main.all_parameters())
        rec["whole_params_cut"] = sum(
            op.input("Param")[0] not in laid and
            op.input("Moment1")[0] in laid
            for op in main.global_block().ops if op.type == "adam")
        spent = {"gather": 0.0, "all_reduce": 0.0}
        real_gather, real_ar = mesh._concat, dist.all_reduce

        def timed(fn, key):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                spent[key] += time.perf_counter() - t
                return r
            return call

        mesh._concat = timed(real_gather, "gather")
        dist.all_reduce = timed(real_ar, "all_reduce")
        try:
            for _ in range(SHARD_WORLD_TIMED):
                exe.run(comp, feed=feed, fetch_list=[loss])
        finally:
            del mesh._concat
            dist.all_reduce = real_ar
        rec["gather_ms_per_step"] = spent["gather"] / SHARD_WORLD_TIMED \
            * 1e3
        rec["all_reduce_ms_per_step"] = spent["all_reduce"] \
            / SHARD_WORLD_TIMED * 1e3
        gc.collect()
        rec["state_bytes"] = torch.cuda.memory_allocated() - mem0
        if form == "both":
            fluid.io.save_checkpoint_sharded(
                exe, os.path.join(out, "ckpt"), main_program=main,
                step=BERT_AGREE_STEPS + SHARD_WORLD_TIMED).wait()
            # full() on every rank: a host copy of a world-sharded value
            # raises (host_array), as np.asarray of a JAX array does
            rec["state_digests"] = {
                n: hashlib.sha1(host_array(
                    v.full() if isinstance(v, ShardedTensor) else v)
                    .tobytes()).hexdigest()
                for n, v in ((n, scope.get(n)) for n in scope.names())}
    return rec


def phase_dp_world(ref):
    """Phase 21d: two processes on cuda:0 joined by gloo (file://
    rendezvous in a temporary directory), one dp rank each, against 21b's
    dp DP run `ref` (its losses, its first step's @GRADs and their
    parameters' names). A rank's failure fails the phase. Returns (flash
    launches by path, numbers)."""
    import shutil
    import tempfile
    base = tempfile.mkdtemp(prefix="dp_world_")
    init = "file://" + os.path.join(base, "rendezvous")
    procs = []
    try:
        for r in range(DP):
            log = open(os.path.join(base, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--dp-world-rank", str(r), init, base],
                stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + DP_WORLD_TIMEOUT_S
        codes = []
        for p, _log in procs:
            try:
                codes.append(p.wait(max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        if codes != [0] * DP:
            for r in range(DP):
                with open(os.path.join(base, f"rank{r}.log")) as f:
                    print(f"21d rank {r} log tail:\n" + f.read()[-3000:])
            _fail(f"21d: rank exit codes {codes}")
        recs = []
        for r in range(DP):
            with open(os.path.join(base, f"rank{r}.json")) as f:
                recs.append(json.load(f))
            recs[-1]["grads"] = torch.load(
                os.path.join(base, f"rank{r}_grads.pt"),
                map_location=ref[1][0].device)
        world = _world_shard_record(base, recs)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(base, ignore_errors=True)
    layers = BERT_AGREE_LAYERS
    ref_losses, ref_grads, names = ref
    launches, out = {}, {"layers": layers, "steps": BERT_AGREE_STEPS}
    for r, rec in enumerate(recs):
        grads = rec.pop("grads")
        if len(grads) != len(ref_grads):
            _fail(f"21d rank {r}: {len(grads)} @GRADs, 21b has "
                  f"{len(ref_grads)}")
        grad, worst = _grad_rel_err(grads, ref_grads, names)
        print(f"21d rank {r}: first-step @GRADs vs the local dp {DP} "
              f"run's: worst {grad:.3e} at {worst} (tolerance "
              f"{DP_GRAD_TOL})")
        if grad > DP_GRAD_TOL:
            _fail(f"21d rank {r}: @GRADs disagree with the local dp {DP} "
                  f"run's")
        got = rec["losses"]
        first = abs(got[0] - ref_losses[0]) / abs(ref_losses[0])
        later = max(abs(a - b) / abs(b) for a, b in zip(got[1:],
                                                        ref_losses[1:]))
        if not (first <= DP_FIRST_LOSS_TOL and later <= DP_LATER_LOSS_TOL):
            _fail(f"21d rank {r}: losses {got} vs the local dp {DP} run's "
                  f"{ref_losses} (first {first:.3e}, later {later:.3e})")
        if got != recs[0]["losses"]:
            _fail(f"21d: rank {r}'s losses {got} != rank 0's")
        if set(rec["reductions"]) != {DP_REDUCTIONS + 1}:
            _fail(f"21d rank {r}: reductions a step {rec['reductions']}, "
                  f"want {DP_REDUCTIONS} + one fused gradient all-reduce")
        if any(c != [layers] * 3 for c in rec["launches"]):
            _fail(f"21d rank {r}: flash launches a step {rec['launches']}, "
                  f"want {layers} each")
        n = BERT_AGREE_STEPS * layers
        launches[f"21d dp world rank {r} ({layers} layers x "
                 f"{BERT_AGREE_STEPS} steps)"] = (n, n, n, 0)
        out[f"rank{r}"] = {
            "backend": rec["backend"], "losses": got,
            "first_loss_rel_err": first, "later_loss_rel_err": later,
            "grad_rel_err": grad, "step_ms": rec["step_ms"],
            "all_reduce_ms_per_step": rec["all_reduce_ms_per_step"],
            "gradient_all_reduce_ms_per_step":
                rec["gradient_all_reduce_ms_per_step"],
            "gradient_bytes": rec["gradient_bytes"]}
    print(f"21d: both ranks' losses and @GRADs equal the local dp {DP} "
          f"run's, {DP_REDUCTIONS} + 1 reductions a step")
    print("dp world " + json.dumps(out))
    world["replicated_state_bytes"] = [r["replicated_state_bytes"]
                                       for r in recs]
    return launches, out, world


def _world_shard_record(base, recs):
    """34c's world-only gates, on the ranks' records and files before
    21d's directory goes: each rank holds half of every sharded variable
    and no whole copy of one; the per-step launches, reductions and the
    ranks' agreement; one index.json, and the world's checkpoint restores
    into a local dp DP mesh bitwise (the global state's digests). Returns
    {"forms": {form: (rank 0's losses, its first-step @GRADs, ...)},
    "launches": ..., the record}."""
    import hashlib
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io.state import host_array
    from paddle_tpu_torch.parallel import ShardedTensor, make_mesh
    layers = BERT_AGREE_LAYERS
    forms, launches, rec = {}, {}, {}
    for form in ("both", "zero1"):
        by_rank = [r["shard"][form] for r in recs]
        for r, fr in enumerate(by_rank):
            want = DP_REDUCTIONS + fr["gathers_per_step"] + 1 + \
                fr["whole_params_cut"]
            if not fr["held_half"] or fr["whole_copies"] or \
                    2 * fr["held_elements"] != fr["global_elements"] or \
                    fr["scope_elements"] != fr["share_elements"]:
                _fail(f"34c {form} rank {r}: holds {fr['held_elements']} of "
                      f"{fr['global_elements']} sharded elements, "
                      f"{fr['scope_elements']} elements in its scope for "
                      f"{fr['share_elements']} in its shares, whole "
                      f"copies {fr['whole_copies']}")
            if set(fr["reductions"]) != {want}:
                _fail(f"34c {form} rank {r}: reductions a step "
                      f"{fr['reductions']}, want {want}")
            if any(c != [layers] * 3 for c in fr["launches"]):
                _fail(f"34c {form} rank {r}: flash launches a step "
                      f"{fr['launches']}, want {layers} each")
            if fr["losses"] != by_rank[0]["losses"] or \
                    fr["grad_digest"] != by_rank[0]["grad_digest"]:
                _fail(f"34c {form}: rank {r}'s losses or @GRADs differ from "
                      f"rank 0's")
            n = BERT_AGREE_STEPS * layers
            launches[f"34c world {form} rank {r} ({layers} layers x "
                     f"{BERT_AGREE_STEPS} steps)"] = (n, n, n, 0)
        # on the host: the card's memory stays phase 34's and 34b's
        forms[form] = (by_rank[0]["losses"], torch.load(
            os.path.join(base, f"shard_{form}_grads.pt"),
            map_location="cpu"))
        rec[form] = {k: [fr[k] for fr in by_rank] for k in (
            "losses", "state_bytes", "gather_ms_per_step",
            "all_reduce_ms_per_step", "held_elements", "global_elements",
            "reductions", "gathers_per_step", "whole_params_cut",
            "scope_elements", "share_elements")}
    ck = os.path.join(base, "ckpt")
    if os.listdir(ck).count("index.json") != 1:
        _fail(f"34c: the world's checkpoint holds {os.listdir(ck)}")
    main, _startup, _loss = dp_agree_program()
    _annotate(main, "both")
    mesh = make_mesh(dp=DP, devices=["cuda:0"] * DP)
    scope = fluid.Scope()
    fluid.io.load_checkpoint_sharded(fluid.Executor(), ck, main_program=main,
                                     mesh=mesh, scope=scope)
    want = recs[0]["shard"]["both"]["state_digests"]
    got = {n: hashlib.sha1(host_array(scope.get(n)).tobytes()).hexdigest()
           for n in scope.names()}
    laid = sum(isinstance(scope.get(n), ShardedTensor) for n in got)
    if got != want or recs[1]["shard"]["both"]["state_digests"] != want \
            or not laid:
        _fail("34c: the world's checkpoint does not restore bitwise into "
              f"a local dp {DP} mesh ({laid} values laid out)")
    rec["restored_into_local_dp"] = {"values": len(got), "laid_out": laid,
                                     "bitwise": True}
    # 34c's share of 21d's wall time: the slower rank's two forms
    rec["seconds_in_21d"] = max(r["shard_s"] for r in recs)
    print("34c: each rank holds half of every sharded variable; the "
          "world's checkpoint restores bitwise into a local dp "
          f"{DP} mesh")
    return {"forms": forms, "launches": launches, "record": rec}


def check_shard_world(world, runs):
    """Phase 34c's agreement: each world form's losses and first-step
    @GRADs (rank 0's; rank 1's equal them bitwise) against 34b's local
    run of the same form, at 21d's tolerances. Returns the record."""
    rec = dict(world["record"], card=_card_line())
    for form, (losses, grads) in world["forms"].items():
        local = (runs[form][0], [g.cpu() for g in runs[form][1]])
        names = [f"{i}" for i in range(len(grads))]
        err = _staged(f"34c world {form} vs 34b local dp {DP}",
                      (losses, grads), local, names, DP_FIRST_LOSS_TOL,
                      DP_GRAD_TOL)
        rec[form]["vs_local"] = err
    rec["replicated_state_bytes_21d"] = world["replicated_state_bytes"]
    print("shard world " + json.dumps(rec))
    return rec


def phase_dp_all(flash, bert16, prof16):
    """Phases 21-21d. Returns (flash launches by path, the agreement
    errors, 21's (record, profile))."""
    dlaunches, rec, prof = _phase("21 dp BERT-base pretrain", phase_dp,
                                  flash, bert16, prof16)
    alaunches, aerrs, dp_ref = _phase("21b dp agree", phase_dp_agree,
                                      flash)
    slaunches, serrs = _phase("21c dp x sp GPT", phase_dp_sp, flash)
    wlaunches, _, world = _phase("21d dp world, two processes (and 34c)",
                                 phase_dp_world, dp_ref)
    steps = BERT_WARM + BERT_STEPS
    paths = {f"21 dp {DP} BERT-base pretrain ({steps} steps)": dlaunches,
             f"21b dp {DP} agree (kernel run, {BERT_AGREE_LAYERS} layers x "
             f"{BERT_AGREE_STEPS} steps)": alaunches,
             f"21c dp {DP} x sp 2 GPT ({BERT_AGREE_STEPS} steps)": slaunches,
             **wlaunches}
    errs = {f"21b dp {DP} vs dp 1": aerrs["dp2_vs_dp1"],
            f"21b dp {DP} kernel vs plain": aerrs["kernel_vs_plain"],
            f"21c dp {DP} x sp 2 vs dp 1": serrs}
    return paths, errs, (rec, prof), world


# ---------------------------------------------------------------------------
# phase 22: the recipe under data parallelism, with recompute
# ---------------------------------------------------------------------------

def phase_recipe_dp(flash, rec20, rec21):
    """Phase 22 under phase 20's GEMM setting (split-K partials of the
    bf16 products reduced in f32), restored after."""
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return _phase_recipe_dp(flash, rec20, rec21)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def _phase_recipe_dp(flash, rec20, rec21):
    """Phase 22: phase 20's cell (the recipe on BertConfig(), seq
    BERT_SEQ x batch BERT_BATCH, dropout 0.1, nothing cut) through
    with_data_parallel(places=[CUDAPlace(0)] * DP) for BERT_WARM +
    BERT_STEPS steps: every loss finite, the last below BERT_LOSS_MARGIN
    x the first, DP x 12 flash forward, dQ and dK/dV launches a step and
    no tensor-core launch, DP_REDUCTIONS dp reductions a step; a profile
    of BERT_PROFILE_STEPS more steps. Then RECOMPUTE_STEPS steps under
    RecomputeOptimizer("dots") at dp DP from the same startup weights:
    the first loss within RECOMPUTE_LOSS_TOL of the run without, the
    later ones within AMP_AGREE_LOSS_TOL, 2 x DP x 12 forward launches a
    step (the checkpoint re-runs the forward) and DP x 12 of each
    backward kernel, a peak memory below the run without. Prints each
    against phases 20 and 21 (`rec20`, `rec21`: (record, profile)).
    Returns ((fwd, dQ, dK/dV, bf16 fwd) launches by path, record)."""
    import paddle_tpu_torch as fluid
    cfg = bert_config()
    n = cfg.num_hidden_layers
    feed = bert_feed()
    steps = BERT_WARM + BERT_STEPS
    runs, paths = {}, {}
    for tag, policy, count in (("none", None, steps),
                               ("dots", "dots", RECOMPUTE_STEPS)):
        main, startup, loss, _lr, _opt = build_recipe(cfg, policy)
        comp = _dp_program(main, loss, [fluid.CUDAPlace(0)] * DP)
        # a new Executor a run: its step counter seeds dropout's masks
        exe = fluid.Executor()
        gc.collect()
        torch.cuda.empty_cache()
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts(flash)
            red0 = comp.mesh.reductions
            losses, step_ms, per_step, tc = _train_run(
                flash, exe, comp, feed, loss, count,
                BERT_WARM if policy is None else 1)
            run = {"losses": losses, "step_ms": step_ms,
                   "per_step": sorted(per_step), "tc": tc,
                   "reductions": comp.mesh.reductions - red0,
                   "peak": torch.cuda.max_memory_allocated(),
                   "launches": _bwd_counts(flash) + (tc,)}
            if policy is None:
                run["profile"] = _profile_train(
                    lambda: exe.run(comp, feed=feed, fetch_list=[loss]),
                    BERT_PROFILE_STEPS)
        runs[tag] = run
        paths[f"22 recipe dp {DP}" + ("" if policy is None else
                                      f" recompute {policy}")
              + f" ({count} steps)"] = run["launches"]
    plain, dots = runs["none"], runs["dots"]
    if plain["per_step"] != [(DP * n,) * 3] or plain["tc"]:
        _fail(f"recipe dp: flash launches fwd/dq/dkv per step "
              f"{plain['per_step']}, want {DP} x {n} each; {plain['tc']} "
              f"tensor-core, want 0")
    if dots["per_step"] != [(2 * DP * n, DP * n, DP * n)] or dots["tc"]:
        _fail(f"recipe dp dots: launches {dots['per_step']} a step, want "
              f"({2 * DP * n}, {DP * n}, {DP * n})")
    if plain["reductions"] != steps * DP_REDUCTIONS:
        _fail(f"recipe dp: {plain['reductions']} reductions in {steps} "
              f"steps, want {DP_REDUCTIONS} a step")
    losses = plain["losses"]
    first, last = losses[0], losses[-1]
    if not np.isfinite(losses).all() or not last < BERT_LOSS_MARGIN * first:
        _fail(f"recipe dp: loss not finite or not below {BERT_LOSS_MARGIN} "
              f"x the first: {losses}")
    errs = [abs(a - b) / abs(b) for a, b in zip(dots["losses"], losses)]
    if not (errs[0] <= RECOMPUTE_LOSS_TOL
            and max(errs[1:]) <= AMP_AGREE_LOSS_TOL):
        _fail(f"recipe dp dots: losses {dots['losses']} against "
              f"{losses[:RECOMPUTE_STEPS]} ({errs})")
    if not dots["peak"] < plain["peak"]:
        _fail(f"recipe dp dots: peak {dots['peak']} B not below "
              f"{plain['peak']} B without recompute")
    step_ms = plain["step_ms"]
    mean_ms = float(np.mean(step_ms))
    prof = plain["profile"]
    out = {"config": "BertConfig(max_position_embeddings=512)",
           "mesh": f"local dp {DP} on cuda:0", "seq_len": BERT_SEQ,
           "batch": BERT_BATCH, "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "step_ms_mean": mean_ms,
           "tokens_per_s": BERT_BATCH * BERT_SEQ / (mean_ms / 1e3),
           "max_memory_allocated": plain["peak"], "loss_first": first,
           "loss_last": last, "loss_ratio": last / first,
           "reductions_per_step": plain["reductions"] / steps,
           "flash_launches_per_step": list(plain["per_step"][0]),
           "dots": {"losses": dots["losses"], "loss_rel_errs": errs,
                    "step_ms": dots["step_ms"],
                    "max_memory_allocated": dots["peak"],
                    "peak_vs_without": dots["peak"] / plain["peak"],
                    "reductions": dots["reductions"],
                    "flash_launches_per_step": list(dots["per_step"][0])}}
    print("recipe dp " + json.dumps(out))
    print("profile recipe dp " + json.dumps(prof))
    keys = ("step_ms_p50", "step_ms_p99", "tokens_per_s",
            "max_memory_allocated", "loss_first", "loss_last")
    pkeys = ("wall_ms_per_step", "device_ms_per_step", "device_busy_share",
             "device_ops_per_step", "flash_share_of_device")
    print(f"recipe dp {DP} vs 20 (recipe dp 1) vs 21 (f32 dp {DP}): "
          + json.dumps({**{k: [out[k], rec20[0][k], rec21[0][k]]
                           for k in keys},
                        **{k: [prof[k], rec20[1][k], rec21[1][k]]
                           for k in pkeys}}))
    return paths, out


# ---------------------------------------------------------------------------
# phases 23-23c: convolutional training (ResNet-50, LeNet)
# ---------------------------------------------------------------------------

def build_resnet(depth=RESNET_DEPTH, image=RESNET_IMAGE,
                 classes=RESNET_CLASSES):
    """(main, startup, loss): bench.py's ResNet cell on the port,
    resnet.build_train_net under MomentumOptimizer(RESNET_LR,
    RESNET_MOMENTUM), f32."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 23
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = resnet.build_train_net(depth=depth, class_dim=classes,
                                      image_shape=image)[3]
        fluid.optimizer.MomentumOptimizer(
            RESNET_LR, RESNET_MOMENTUM).minimize(loss)
    return main, startup, loss


def resnet_feed(batch=RESNET_BATCH, image=RESNET_IMAGE,
                classes=RESNET_CLASSES, device="cuda"):
    """Synthetic images (standard normal) and labels from SEED, made on
    `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 23)
    return {"img": torch.randn((batch,) + tuple(image), generator=gen,
                               device=device),
            "label": torch.randint(0, classes, (batch, 1), generator=gen,
                                   device=device)}


def conv_flops(main, batch):
    """The convolutions' operations a training step: 2 x N x C_out x
    H_out x W_out x (C_in / groups) x kh x kw each for the forward, the
    input gradient (not for the first, whose input is the image) and
    the filter gradient."""
    gb = main.global_block()
    total = 0
    for op in gb.ops:
        if op.type not in ("conv2d", "depthwise_conv2d"):
            continue
        w = gb.var(op.input("Filter")[0]).shape
        o = gb.var(op.output("Output")[0]).shape
        fwd = 2 * batch * o[1] * o[2] * o[3] * w[1] * w[2] * w[3]
        data_input = gb.var(op.input("Input")[0]).is_data
        total += fwd * (2 if data_input else 3)
    return total


def _first_bn(main):
    """(the first batch_norm op, the convolution that feeds it)."""
    ops = main.global_block().ops
    bn = next(op for op in ops if op.type == "batch_norm")
    conv = next(op for op in ops
                if op.output("Output") == bn.input("X"))
    return bn, conv


def _conv_args(conv):
    return ([int(v) for v in conv.attrs["strides"]],
            [int(v) for v in conv.attrs["paddings"]])


def phase_resnet(flash, paged):
    """Phase 23: bench.py's ResNet cell at full width and depth
    (ResNet-50, 1000 classes, 3 x 224 x 224, f32, Momentum(0.1, 0.9)),
    RESNET_BATCH synthetic images on the card, one batch repeated for
    RESNET_WARM + RESNET_STEPS steps: every loss finite and the last
    below the first; the first batch norm's running mean and variance
    after the first step equal momentum x their start + (1 - momentum) x
    the batch's statistics of a plain f64 convolution of the step's
    images by the step's filter (RESNET_BN_TOL of their scale); the
    op's f32 convolution at that layer against the f64 one within
    CONV_F32_TOL (torch's own call under the process's TF32 flag, on
    here, printed beside it); a profile of RESNET_PROFILE_STEPS more
    steps; no launch of the paged or flash kernels. Returns the
    record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import nn_ops
    import torch.nn.functional as F
    main, startup, loss = build_resnet()
    feed = resnet_feed()
    bn, conv = _first_bn(main)
    strides, pads = _conv_args(conv)
    exe = fluid.Executor()
    gc.collect()
    torch.cuda.empty_cache()
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    w0 = scope.get(conv.input("Filter")[0]).clone()
    m0 = scope.get(bn.input("Mean")[0]).clone()
    v0 = scope.get(bn.input("Variance")[0]).clone()
    _zero_counts(flash)
    paged.LAUNCHES = 0
    losses, step_ms = [], []
    for i in range(RESNET_WARM + RESNET_STEPS):
        ts = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        if i >= RESNET_WARM:
            step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
        if i == 0:
            m1 = scope.get(bn.output("MeanOut")[0]).double()
            v1 = scope.get(bn.output("VarianceOut")[0]).double()
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_train(lambda: exe.run(main, feed=feed,
                                          fetch_list=[loss], scope=scope),
                          RESNET_PROFILE_STEPS, flash=False)
    kernel_launches = _bwd_counts(flash) + (flash.TC_LAUNCHES,
                                            paged.LAUNCHES)
    img = feed["img"]
    ref = F.conv2d(img.double(), w0.double(), stride=strides, padding=pads)
    var, mean = torch.var_mean(ref, dim=(0, 2, 3), correction=0)
    mom = bn.attrs.get("momentum", 0.9)
    want_m = mom * m0.double() + (1 - mom) * mean
    want_v = mom * v0.double() + (1 - mom) * var
    bn_err = max(((m1 - want_m).abs().max() / want_m.abs().max()).item(),
                 ((v1 - want_v).abs().max() / want_v.abs().max()).item())
    op_conv = nn_ops._Conv2d.apply(img, w0, tuple(strides), tuple(pads),
                                   (1, 1), 1)
    conv_err = ((op_conv.double() - ref).abs().max()
                / ref.abs().max()).item()
    torch_conv = F.conv2d(img, w0, stride=strides, padding=pads)
    torch_err = ((torch_conv.double() - ref).abs().max()
                 / ref.abs().max()).item()
    del ref, op_conv, torch_conv
    mean_ms = float(np.mean(step_ms))
    flops = conv_flops(main, RESNET_BATCH)
    out = {"config": f"resnet.build_train_net(depth={RESNET_DEPTH}, "
                     f"class_dim={RESNET_CLASSES}, image_shape="
                     f"{RESNET_IMAGE}), Momentum({RESNET_LR}, "
                     f"{RESNET_MOMENTUM}), f32",
           "batch": RESNET_BATCH, "ops": len(main.global_block().ops),
           "parameters": len(main.all_parameters()),
           "startup_s": startup_s, "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "step_ms_mean": mean_ms,
           "images_per_s": RESNET_BATCH / (mean_ms / 1e3),
           "conv_flops_per_step": flops,
           "conv_tflops_per_s_of_step": flops / (mean_ms / 1e3) / 1e12,
           "max_memory_allocated": peak, "loss_first": losses[0],
           "loss_last": losses[-1], "loss_ratio": losses[-1] / losses[0],
           "losses": losses,
           "first_bn_stats_rel_err": bn_err,
           "conv_f32_rel_err": conv_err,
           "conv_torch_with_process_flag_rel_err": torch_err,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "kernel_launches_fwd_dq_dkv_tc_paged": list(kernel_launches)}
    print("resnet " + json.dumps(out))
    print("profile resnet " + json.dumps(prof))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        _fail(f"resnet: loss not finite or not below the first: {losses}")
    if not bn_err <= RESNET_BN_TOL:
        _fail(f"resnet: the first batch norm's running statistics "
              f"{bn_err:.3e} from the plain recomputation (tolerance "
              f"{RESNET_BN_TOL})")
    if not conv_err <= CONV_F32_TOL:
        _fail(f"resnet: the op's convolution {conv_err:.3e} from f64 "
              f"(tolerance {CONV_F32_TOL}): not a full f32 product")
    if any(kernel_launches):
        _fail(f"resnet: launches of the attention kernels "
              f"{kernel_launches}, want none")
    return out


def _bn_stats(main):
    return [n for op in main.global_block().ops if op.type == "batch_norm"
            for n in op.output("MeanOut") + op.output("VarianceOut")]


def _stats_rel_err(got, want):
    return max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(got, want))


def _global_rel_err(got, want):
    """The gradients' difference over their size, as one vector: the
    norm of every tensor's difference over the norm of every `want`."""
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(got, want))
    return (num / sum(float((b.double() ** 2).sum()) for b in want)) ** 0.5


def phase_resnet_dp():
    """Phase 23b: phase 23's net through with_data_parallel(places=
    [CUDAPlace(0)] * DP) against places=[CUDAPlace(0)] (dp 1), and the
    plain Executor beside them, from one startup scope, RESNET_DP_STEPS
    steps on phase 23's batch. dp 2 normalizes with the global batch's
    statistics (ops/nn_ops.py's rule), so it computes dp 1's numbers in
    another summation order, as the plain run does (torch's batch norm
    in place of the rule's formula): each comparison of dp 2 with dp 1 is
    gated at RESNET_DP_SPREAD x the plain run's distance from dp 1, or
    the floor beside it, whichever is larger. The first loss (floor
    RESNET_DP_LOSS_TOL) and every batch norm's running statistics after
    the first step (RESNET_DP_STAT_TOL of their scale) come from the same
    weights; the first step's @GRADs as one vector (RESNET_DP_GRAD_TOL of
    its norm): the backward through 53 batch norms magnifies f32
    rounding, so their distance is measured, not assumed. The later
    losses and the statistics after the last step are printed. Returns
    the record."""
    import paddle_tpu_torch as fluid
    main, startup, loss = build_resnet()
    feed = resnet_feed()
    exe = fluid.Executor()
    gc.collect()
    torch.cuda.empty_cache()
    base = fluid.Scope()
    exe.run(startup, scope=base)
    names = [p.name for p in main.all_parameters()]
    stats = _bn_stats(main)
    runs = {}
    for tag, prog in (("dp1", _dp_program(main, loss, [fluid.CUDAPlace(0)])),
                      (f"dp{DP}", _dp_program(main, loss,
                                              [fluid.CUDAPlace(0)] * DP)),
                      ("plain", main)):
        scope = _copy_scope(base)
        losses, ms = [], []
        for i in range(RESNET_DP_STEPS):
            ts = time.perf_counter()
            out = exe.run(prog, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[loss] + ([nm + "@GRAD" for nm in names]
                                               if i == 0 else []))
            losses.append(out[0].double().item())
            ms.append((time.perf_counter() - ts) * 1e3)
            if i == 0:
                grads = out[1:]
                first_stats = [scope.get(nm).clone() for nm in stats]
        runs[tag] = {"losses": losses, "grads": grads, "step_ms": ms,
                     "first_stats": first_stats,
                     "stats": [scope.get(nm).clone() for nm in stats]}
        del scope

    def dist(a, b):
        return {"first_loss": abs(a["losses"][0] - b["losses"][0])
                / abs(b["losses"][0]),
                "later_losses": max(abs(x - y) / abs(y) for x, y in
                                    zip(a["losses"][1:], b["losses"][1:])),
                "first_stats": _stats_rel_err(a["first_stats"],
                                              b["first_stats"]),
                "last_stats": _stats_rel_err(a["stats"], b["stats"]),
                "grads": _global_rel_err(a["grads"], b["grads"]),
                "grads_worst_tensor": _grad_rel_err(a["grads"], b["grads"],
                                                    names)}
    one, two = runs["dp1"], runs[f"dp{DP}"]
    got, spread = dist(two, one), dist(runs["plain"], one)
    floors = {"first_loss": RESNET_DP_LOSS_TOL,
              "first_stats": RESNET_DP_STAT_TOL,
              "grads": RESNET_DP_GRAD_TOL}
    bounds = {k: max(f, RESNET_DP_SPREAD * spread[k])
              for k, f in floors.items()}
    out = {"losses_dp1": one["losses"], f"losses_dp{DP}": two["losses"],
           "losses_plain": runs["plain"]["losses"],
           f"dp{DP}_vs_dp1": got, "plain_vs_dp1": spread, "bounds": bounds,
           "first_bn_stats_end": {
               tag: {"mean_of_running_mean": float(r["stats"][0].mean()),
                     "mean_of_running_var": float(r["stats"][1].mean())}
               for tag, r in runs.items()},
           "step_ms": {tag: r["step_ms"] for tag, r in runs.items()}}
    print("resnet dp " + json.dumps(out))
    bad = {k: (got[k], b) for k, b in bounds.items() if not got[k] <= b}
    if bad:
        _fail(f"resnet dp: dp {DP} against dp 1 beyond the bounds: {bad}")
    return out


def phase_lenet_agree():
    """Phase 23c: the MNIST conv net (LeNet: conv-pool-bn-conv-pool-fc,
    mnist.build_train_net("conv")) under Adam(1e-3), batch LENET_BATCH
    from SEED, LENET_STEPS steps on the card and in the port on the CPU
    from one startup scope: losses within LENET_LOSS_TOL, the first
    step's @GRADs within LENET_GRAD_TOL of their scale. Returns the
    record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import mnist
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 24
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = mnist.build_train_net("conv")[3]
        fluid.optimizer.AdamOptimizer(learning_rate=1e-3).minimize(loss)
    gen = torch.Generator().manual_seed(SEED + 24)
    feed = {"img": torch.randn(LENET_BATCH, 1, 28, 28, generator=gen),
            "label": torch.randint(0, 10, (LENET_BATCH, 1), generator=gen)}
    base = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=base)
    names = [p.name for p in main.all_parameters()]
    runs = {}
    for tag, place in (("card", fluid.CUDAPlace(0)),
                       ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for nm in base.names():
            scope.set(nm, base.get(nm).to(exe.device, copy=True))
        losses = []
        for i in range(LENET_STEPS):
            out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[loss] + ([nm + "@GRAD" for nm in names]
                                               if i == 0 else []))
            losses.append(out[0].double().item())
            if i == 0:
                grads = [g.cpu() for g in out[1:]]
        runs[tag] = (losses, grads)
    card, cpu = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    grad_err, worst = _grad_rel_err(card[1], cpu[1], names)
    out = {"losses_card": card[0], "losses_cpu": cpu[0],
           "loss_rel_err": loss_err, "grad_rel_err": grad_err,
           "grad_worst": worst}
    print("lenet agree " + json.dumps(out))
    if not (loss_err <= LENET_LOSS_TOL and grad_err <= LENET_GRAD_TOL):
        _fail(f"lenet agree: the card against the CPU: losses "
              f"{loss_err:.3e} (tolerance {LENET_LOSS_TOL}), @GRADs "
              f"{grad_err:.3e} at {worst} ({LENET_GRAD_TOL})")
    return out


def phase_conv_all(flash, paged):
    """Phases 23-23c under torch's default cuDNN setting (TF32 allowed),
    restored after: the port's convolution sets its own f32 precision.
    No phase of these launches the paged or flash kernels (their counts
    are 0 after them)."""
    cudnn = torch.backends.cudnn
    was = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    _zero_counts(flash)
    paged.LAUNCHES = 0
    try:
        _phase("23 ResNet-50 train", phase_resnet, flash, paged)
        _phase("23b ResNet dp", phase_resnet_dp)
        _phase("23c LeNet agree", phase_lenet_agree)
    finally:
        cudnn.allow_tf32 = was
    counts = _bwd_counts(flash) + (flash.TC_LAUNCHES, paged.LAUNCHES)
    if any(counts):
        _fail(f"phases 23-23c launched attention kernels: {counts}")


# ---------------------------------------------------------------------------
# phases 24-24b: Transformer-base training
# ---------------------------------------------------------------------------

def transformer_config(**kw):
    """ModelHyperParams (Transformer-base) with dropout 0, as bench.py's
    cell sets it, and `kw` over it."""
    from paddle_tpu_torch.models import transformer
    return type("TransformerCell", (transformer.ModelHyperParams,),
                {"dropout": 0.0, **kw})


def build_transformer(cfg, max_len, lr=TF_LR):
    """(main, startup, loss, token_num): transformer.build_train_net under
    AdamOptimizer(lr), f32."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 24
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _f, loss, token_num = transformer.build_train_net(cfg=cfg,
                                                          max_len=max_len)
        fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    return main, startup, loss, token_num


def transformer_feed(cfg, batch, max_len, lens):
    """Synthetic ids in [2, vocab) from SEED (int64) and each row's
    source and target lengths: drawn in the (lo, hi) range `lens`, or
    given as a (src, tgt) pair a row."""
    rng = np.random.default_rng(SEED + 24)
    feed = {n: rng.integers(2, v, (batch, max_len)).astype(np.int64)
            for n, v in (("src_ids", cfg.src_vocab_size),
                         ("tgt_ids", cfg.trg_vocab_size),
                         ("lbl_ids", cfg.trg_vocab_size))}
    if isinstance(lens[0], tuple):
        pairs = np.asarray(lens, np.int64)
        feed["src_len"], feed["tgt_len"] = pairs[:, :1], pairs[:, 1:]
    else:
        for n in ("src_len", "tgt_len"):
            feed[n] = rng.integers(lens[0], lens[1] + 1,
                                   (batch, 1)).astype(np.int64)
    return feed


def _strided_copy(t):
    """A copy of t with t's strides (a view of the projections stays a
    view-shaped copy)."""
    out = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                              device=t.device)
    return out.copy_(t.detach())


def _captured_flash_calls(run, want):
    """The operands (q, k, v, bias, segq, segk, causal) of the forward
    flash calls numbered in `want` (in call order) during run(), copied
    with their strides."""
    from paddle_tpu_torch.ops import flash as flash_ops
    real = flash_ops.flash_attention_cuda
    seen, count = {}, [0]

    def spy(q, k, v, bias, segq, segk, scale, causal):
        if count[0] in want:
            seen[count[0]] = tuple(_strided_copy(t) for t in (q, k, v)) + (
                None if bias is None else bias.detach().clone(), segq, segk,
                causal)
        count[0] += 1
        return real(q, k, v, bias, segq, segk, scale, causal)

    flash_ops.flash_attention_cuda = spy
    try:
        run()
    finally:
        flash_ops.flash_attention_cuda = real
    return seen


def phase_transformer(flash):
    """Phase 24: bench.py's Transformer-base cell at full width and depth
    (transformer_config(), max_len TF_MAX_LEN, batch TF_BATCH, Adam 1e-4,
    f32), lengths from the seed in TF_LENS, TF_WARM + TF_STEPS steps on
    one batch: every step launches the f32 flash forward, dQ and dK/dV
    kernels 3 x n_layer times each (encoder self, decoder causal self,
    cross) and never calls flash_dbias (the biases come from lengths);
    every bias reaches the kernels as a (B, H, Tq, Tk) view with stride 0
    over heads and queries; every loss finite, the last below
    TF_LOSS_MARGIN x the first; a profile of TF_PROFILE_STEPS more steps.
    Then the first decoder layer's causal self-attention and its
    cross-attention, as the first step called them (their operands
    copied with their strides), against the plain version: out and lse,
    and dq, dk, dv of a seeded cotangent. Returns ((fwd, dQ, dK/dV, bf16
    fwd) launches of the run, {call: (fwd, bwd) max-abs errors}, the
    record)."""
    import paddle_tpu_torch as fluid
    cfg = transformer_config()
    main, startup, loss, token_num = build_transformer(cfg, TF_MAX_LEN)
    feed = transformer_feed(cfg, TF_BATCH, TF_MAX_LEN, TF_LENS)
    exe = fluid.Executor()
    gc.collect()
    torch.cuda.empty_cache()
    n = 3 * cfg.n_layer
    dec0 = cfg.n_layer                  # the first decoder layer's calls
    with fluid.scope_guard(fluid.Scope()):
        t0 = time.perf_counter()
        exe.run(startup)
        torch.cuda.synchronize()
        startup_s = time.perf_counter() - t0
        params = sum(fluid.global_scope().get(p.name).numel()
                     for p in main.all_parameters())
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(flash)
        dbias0 = flash.DBIAS_CALLS
        first, tok = [], []
        views = []
        calls = _captured_flash_calls(
            lambda: views.extend(_bias_views(flash, lambda: first.append(
                _train_run(flash, exe, main, feed, loss, 1, 1,
                           extra=[token_num], extra_out=tok)))),
            {dec0, dec0 + 1})
        losses, step_ms, per_step, tc = _train_run(
            flash, exe, main, feed, loss, TF_WARM + TF_STEPS - 1,
            TF_WARM - 1)
        counts = _bwd_counts(flash)
        dbias = flash.DBIAS_CALLS - dbias0
        losses = first[0][0] + losses
        per_step |= first[0][2]
        tc += first[0][3]
        peak = torch.cuda.max_memory_allocated()
        prof = _profile_train(lambda: exe.run(main, feed=feed,
                                              fetch_list=[loss]),
                              TF_PROFILE_STEPS)
    b, h, t = TF_BATCH, cfg.n_head, TF_MAX_LEN
    want_view = ((b, h, t, t), (t, 0, 0, 1))
    if len(views) != 2 * n or set(views) != {want_view}:
        _fail(f"transformer: the kernels got biases {set(views)} in "
              f"{len(views)} calls, want {2 * n} x {want_view}")
    steps = TF_WARM + TF_STEPS
    if per_step != {(n, n, n)} or tc != 0 or counts != (steps * n,) * 3:
        _fail(f"transformer: flash launches fwd/dq/dkv per step {per_step} "
              f"(run {counts}), want {n} each; {tc} tensor-core, want 0")
    if dbias != 0:
        _fail(f"transformer: flash_dbias ran {dbias} times, want 0 (the "
              f"biases come from lengths and need no gradient)")
    if not calls[dec0][-1] or calls[dec0 + 1][-1]:
        _fail("transformer: call order is not the decoder's causal self-"
              "attention, then its cross-attention")
    first_loss, last = losses[0], losses[-1]
    if not np.isfinite(losses).all() or not last < TF_LOSS_MARGIN * first_loss:
        _fail(f"transformer: loss not finite or not below {TF_LOSS_MARGIN} "
              f"x the first: {losses}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 24)
    errs = {}
    for tag, i in (("decoder causal self-attention", dec0),
                   ("cross-attention", dec0 + 1)):
        case = calls[i]
        errs[tag] = (check_one_flash(flash, f"transformer {tag}", case),
                     check_one_flash_bwd(flash, f"transformer {tag}", case,
                                         gen, False))
    mean_ms = float(np.mean(step_ms))
    real = float(np.asarray(tok[0][0]).reshape(-1)[0])
    out = {"config": "transformer.ModelHyperParams (dropout 0.0)",
           "max_len": t, "batch": b, "lengths_drawn_in": list(TF_LENS),
           "src_len_mean": float(feed["src_len"].mean()),
           "tgt_len_mean": float(feed["tgt_len"].mean()),
           "params": int(params), "ops": len(main.global_block().ops),
           "startup_s": startup_s, "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "step_ms_mean": mean_ms,
           "tokens_per_s_padded": b * t / (mean_ms / 1e3),
           "token_num": real, "tokens_per_s_real": real / (mean_ms / 1e3),
           "max_memory_allocated": peak,
           "loss_first": first_loss, "loss_last": last,
           "loss_ratio": last / first_loss, "loss_margin": TF_LOSS_MARGIN,
           "bias_view": [list(want_view[0]), list(want_view[1])],
           "flash_launches_fwd_dq_dkv": list(counts),
           "flash_dbias_calls": dbias,
           "attention_vs_plain_max_abs_err_fwd_bwd": errs}
    print("transformer " + json.dumps(out))
    print("profile transformer " + json.dumps(prof))
    return counts + (tc,), errs, out


def _card_cpu_agree(tag, program, feed, steps, loss_tol, grad_tol,
                    flash=None):
    """`steps` steps of `program` (main, startup, loss) on the card and in
    the port on the CPU from one startup scope (run on the CPU): each
    loss within `loss_tol`, the first step's @GRADs within `grad_tol` of
    their scale (_grad_rel_err). Returns (the card run's (fwd, dQ, dK/dV,
    bf16 fwd) flash launches when `flash` is given, the record)."""
    import paddle_tpu_torch as fluid
    main, startup, loss = program
    base = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=base)
    names = [p.name for p in main.all_parameters()]
    runs, counts = {}, None
    for where, place in (("card", fluid.CUDAPlace(0)),
                         ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for nm in base.names():
            scope.set(nm, base.get(nm).to(exe.device, copy=True))
        if flash is not None and where == "card":
            _zero_counts(flash)
        losses = []
        for i in range(steps):
            out = exe.run(main, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[loss] + ([nm + "@GRAD" for nm in names]
                                               if i == 0 else []))
            losses.append(out[0].double().item())
            if i == 0:
                grads = [g.cpu() for g in out[1:]]
        if flash is not None and where == "card":
            counts = _bwd_counts(flash) + (flash.TC_LAUNCHES,)
        runs[where] = (losses, grads)
    card, cpu = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    grad_err, worst = _grad_rel_err(card[1], cpu[1], names)
    out = {"losses_card": card[0], "losses_cpu": cpu[0],
           "loss_rel_err": loss_err, "grad_rel_err": grad_err,
           "grad_worst": worst}
    print(f"{tag} " + json.dumps(out))
    if not (loss_err <= loss_tol and grad_err <= grad_tol):
        _fail(f"{tag}: the card against the CPU: losses {loss_err:.3e} "
              f"(tolerance {loss_tol}), @GRADs {grad_err:.3e} at {worst} "
              f"({grad_tol})")
    return counts, out


def phase_transformer_agree(flash):
    """Phase 24b: the tiny Transformer (TF_AGREE_CFG, max_len
    TF_AGREE_LEN, lengths TF_AGREE_LENS) under Adam(1e-3),
    TF_AGREE_STEPS steps on the card (the flash kernels: 3 x 2 launches
    of each a step) and in the port on the CPU (_card_cpu_agree).
    Returns (the card run's launches, the record)."""
    cfg = transformer_config(**TF_AGREE_CFG)
    main, startup, loss, _tok = build_transformer(cfg, TF_AGREE_LEN, 1e-3)
    feed = transformer_feed(cfg, len(TF_AGREE_LENS), TF_AGREE_LEN,
                            TF_AGREE_LENS)
    counts, out = _card_cpu_agree(
        "transformer agree", (main, startup, loss), feed, TF_AGREE_STEPS,
        TF_AGREE_LOSS_TOL, TF_AGREE_GRAD_TOL, flash)
    n = 3 * cfg.n_layer * TF_AGREE_STEPS
    if counts != (n, n, n, 0):
        _fail(f"transformer agree: card launches {counts}, want {n} of "
              f"each and no tensor-core forward")
    return counts, out


# ---------------------------------------------------------------------------
# phases 25-25c: DeepFM, Wide&Deep, DIN
# ---------------------------------------------------------------------------

def build_deepfm(features=DEEPFM_FEATURES, fields=DEEPFM_FIELDS,
                 embed=DEEPFM_EMBED):
    """(main, startup, loss): deepfm.build_train_net under
    AdamOptimizer(DEEPFM_LR), f32."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import deepfm
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 25
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = deepfm.build_train_net(num_features=features,
                                      num_fields=fields,
                                      embed_dim=embed)[3]
        fluid.optimizer.AdamOptimizer(DEEPFM_LR).minimize(loss)
    return main, startup, loss


def deepfm_feed(batch=DEEPFM_BATCH, features=DEEPFM_FEATURES,
                fields=DEEPFM_FIELDS, device="cuda"):
    """Synthetic ids (uniform over the features), values in [0, 1) and
    0/1 labels from SEED, made on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 25)
    return {"feat_ids": torch.randint(0, features, (batch, fields),
                                      generator=gen, device=device),
            "feat_vals": torch.rand((batch, fields), generator=gen,
                                    device=device),
            "label": torch.randint(0, 2, (batch, 1), generator=gen,
                                   device=device).float()}


# the kernels of torch's CUDA embedding backward (by name): the sort of
# the ids, the segment bookkeeping, the partial sums and the scatter
EMBEDDING_BWD_KERNELS = ("embedding_backward", "compute_grad_weight",
                         "sum_and_scatter", "partials_per_segment",
                         "partial_segment", "segment_offsets",
                         "compute_num_of_partial_segments")


def _device_total(e):
    return getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0)


def _profile_ops(step, steps):
    """Where a step's time goes, by op: torch.profiler with host and
    device activity over `steps` calls of step(), each Executor op inside
    a record_function range named after its type. The wall and device ms
    a step, busy share, device operations a step, top kernels, the
    device ms a step of the kernels launched inside each op type's
    ranges and inside the backward's embedding gradient
    (aten::embedding_dense_backward)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function
    from paddle_tpu_torch import ops as ops_registry
    real = ops_registry.run_op

    def ranged(op, *args, **kw):
        with record_function("op:" + op.type):
            return real(op, *args, **kw)

    ops_registry.run_op = ranged
    try:
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
    finally:
        ops_registry.run_op = real
    # kernels by name; the ranges' own device-side annotations (their
    # span on the device's timeline, gaps included) are left out
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and not e.key.startswith("op:")]
    dev = {e.key: e.self_device_time_total / steps / 1e3 for e in kernels}
    busy = sum(dev.values())
    if busy <= 0:
        _fail("the profiler saw no device time")
    # an op's device time: the kernels launched inside its host range
    by_op, ops_by, emb = {}, {}, 0.0
    for e in prof.events():
        if e.device_type.name != "CPU":
            continue
        if e.name.startswith("op:"):
            by_op[e.name[3:]] = by_op.get(e.name[3:], 0.0) + _device_total(e)
            ops_by[e.name[3:]] = ops_by.get(e.name[3:], 0) + \
                _kernels_under(e)
        elif e.name == "aten::embedding_dense_backward":
            emb += _device_total(e)
    by_op = {k: v / steps / 1e3 for k, v in by_op.items() if v > 0}
    # kernels counted under each op's range (None: the trace attached no
    # kernel to a host event, so the count was not measured)
    ops_by = {k: v / steps for k, v in ops_by.items() if v > 0} or None
    emb /= steps * 1e3
    emb_kernels = sum(v for k, v in dev.items() if any(
        m in k for m in EMBEDDING_BWD_KERNELS))
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "wall_ms_per_step": wall,
            "device_ms_per_step": busy, "device_busy_share": busy / wall,
            "device_ops_per_step": sum(e.count for e in kernels) / steps,
            "embedding_backward_kernels_by_name_ms_per_step": emb_kernels,
            "device_ms_per_step_by_op": dict(sorted(
                by_op.items(), key=lambda kv: -kv[1])),
            "device_ops_per_step_by_op": ops_by,
            "adam_ms_per_step": by_op.get("adam", 0.0),
            "adam_share_of_device": by_op.get("adam", 0.0) / busy,
            "embedding_backward_ms_per_step": emb,
            "embedding_backward_share_of_device": emb / busy,
            "top_kernels_ms_per_step": [[k[:80], v] for k, v in top]}


def phase_deepfm():
    """Phase 25: bench.py's DeepFM cell (1,000,000 features, 39 fields,
    embed 10, Adam 1e-3, f32), DEEPFM_BATCH synthetic examples on the
    card, one batch for DEEPFM_WARM + DEEPFM_STEPS steps: every loss
    finite and the last below the first; examples/s, step ms, peak
    memory and a profile by op of DEEPFM_PROFILE_STEPS more steps (the
    embedding backward's and Adam's share of device time). Returns the
    record."""
    import paddle_tpu_torch as fluid
    main, startup, loss = build_deepfm()
    feed = deepfm_feed()
    exe = fluid.Executor()
    gc.collect()
    torch.cuda.empty_cache()
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    params = sum(scope.get(p.name).numel() for p in main.all_parameters())
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(DEEPFM_WARM + DEEPFM_STEPS):
        ts = time.perf_counter()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        if i >= DEEPFM_WARM:
            step_ms.append((time.perf_counter() - ts) * 1e3)
        losses.append(float(np.asarray(out).reshape(-1)[0]))
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope), DEEPFM_PROFILE_STEPS)
    mean_ms = float(np.mean(step_ms))
    out = {"config": f"deepfm.build_train_net(num_features="
                     f"{DEEPFM_FEATURES}, num_fields={DEEPFM_FIELDS}, "
                     f"embed_dim={DEEPFM_EMBED}), Adam({DEEPFM_LR}), f32",
           "batch": DEEPFM_BATCH, "params": int(params),
           "ops": len(main.global_block().ops), "startup_s": startup_s,
           "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "step_ms_mean": mean_ms,
           "examples_per_s": DEEPFM_BATCH / (mean_ms / 1e3),
           "max_memory_allocated": peak, "loss_first": losses[0],
           "loss_last": losses[-1], "loss_ratio": losses[-1] / losses[0],
           "losses": losses}
    print("deepfm " + json.dumps(out))
    print("profile deepfm " + json.dumps(prof))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        _fail(f"deepfm: loss not finite or not below the first: {losses}")
    return out


def phase_deepfm_dp():
    """Phase 25b: phase 25's net through with_data_parallel(places=
    [CUDAPlace(0)] * DP) against places=[CUDAPlace(0)] (dp 1), and the
    plain Executor beside them, from one startup scope, DEEPFM_DP_STEPS
    steps on phase 25's batch. The embeddings' @GRADs at dp 2 are each
    rank's dense scatter-add summed over dp. Each distance of dp 2 from
    dp 1 is gated at DEEPFM_DP_SPREAD x the plain run's (the embedding
    backward's order is not fixed) or its floor: the first loss, each
    embedding's first @GRAD and all first @GRADs as one vector, over
    their norms. Returns the record."""
    import paddle_tpu_torch as fluid
    main, startup, loss = build_deepfm()
    feed = deepfm_feed()
    exe = fluid.Executor()
    gc.collect()
    torch.cuda.empty_cache()
    base = fluid.Scope()
    exe.run(startup, scope=base)
    names = [p.name for p in main.all_parameters()]
    emb = [i for i, p in enumerate(main.all_parameters())
           if p.shape[0] == DEEPFM_FEATURES]
    runs = {}
    for tag, prog in (("dp1", _dp_program(main, loss, [fluid.CUDAPlace(0)])),
                      (f"dp{DP}", _dp_program(main, loss,
                                              [fluid.CUDAPlace(0)] * DP)),
                      ("plain", main)):
        scope = _copy_scope(base)
        losses, ms = [], []
        for i in range(DEEPFM_DP_STEPS):
            ts = time.perf_counter()
            out = exe.run(prog, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[loss] + ([nm + "@GRAD" for nm in names]
                                               if i == 0 else []))
            losses.append(out[0].double().item())
            ms.append((time.perf_counter() - ts) * 1e3)
            if i == 0:
                grads = out[1:]
        runs[tag] = {"losses": losses, "grads": grads, "step_ms": ms}
        del scope

    def dist(a, b):
        d = {"first_loss": abs(a["losses"][0] - b["losses"][0])
             / abs(b["losses"][0]),
             "later_losses": max(abs(x - y) / abs(y) for x, y in
                                 zip(a["losses"][1:], b["losses"][1:])),
             "grads": _global_rel_err(a["grads"], b["grads"])}
        for i in emb:
            d[names[i]] = _global_rel_err([a["grads"][i]], [b["grads"][i]])
        return d
    one, two = runs["dp1"], runs[f"dp{DP}"]
    got, spread = dist(two, one), dist(runs["plain"], one)
    floors = {"first_loss": DEEPFM_DP_LOSS_TOL,
              "grads": DEEPFM_DP_GRAD_TOL,
              **{names[i]: DEEPFM_DP_GRAD_TOL for i in emb}}
    bounds = {k: max(f, DEEPFM_DP_SPREAD * spread[k])
              for k, f in floors.items()}
    out = {"losses_dp1": one["losses"], f"losses_dp{DP}": two["losses"],
           "losses_plain": runs["plain"]["losses"],
           f"dp{DP}_vs_dp1": got, "plain_vs_dp1": spread, "bounds": bounds,
           "embedding_grads": [names[i] for i in emb],
           "step_ms": {tag: r["step_ms"] for tag, r in runs.items()}}
    print("deepfm dp " + json.dumps(out))
    bad = {k: (got[k], b) for k, b in bounds.items() if not got[k] <= b}
    if len(emb) != 2 or bad:
        _fail(f"deepfm dp: dp {DP} against dp 1 beyond the bounds: {bad} "
              f"(embeddings {[names[i] for i in emb]})")
    return out


def phase_ctr_agree():
    """Phase 25c: Wide&Deep and DIN at test_ctr_models.py's sizes (batch
    32, Adam(1e-2)), CTR_AGREE_STEPS steps on the card and in the port on
    the CPU (_card_cpu_agree). Returns the records."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import ctr_models
    rng = np.random.default_rng(SEED + 25)
    b, fields, t = 32, 8, 16
    lens = rng.integers(1, t + 1, (b, 1))
    hist = rng.integers(1, 200, (b, t))
    hist[np.arange(t)[None, :] >= lens] = 0
    nets = {
        "wide_deep": (lambda: ctr_models.build_wide_deep_net(
            num_features=500, num_wide_fields=fields,
            num_deep_fields=fields)[3],
            {"wide_ids": rng.integers(0, 500, (b, fields)),
             "deep_ids": rng.integers(0, 500, (b, fields))}),
        "din": (lambda: ctr_models.build_din_net(num_items=200,
                                                 max_hist=t)[4],
                {"hist_ids": hist, "cand_id": rng.integers(1, 200, (b, 1)),
                 "hist_len": lens})}
    out = {}
    for tag, (net, ids) in nets.items():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = SEED + 25
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            loss = net()
            fluid.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
        feed = {k: v.astype(np.int64) for k, v in ids.items()}
        feed["label"] = rng.integers(0, 2, (b, 1)).astype(np.float32)
        _c, out[tag] = _card_cpu_agree(f"{tag} agree", (main, startup, loss),
                                       feed, CTR_AGREE_STEPS, CTR_LOSS_TOL,
                                       CTR_GRAD_TOL)
    return out


def phase_ctr_all(flash, paged):
    """Phases 25-25c. None of them launches the paged or flash kernels
    (their counts are 0 after them): the lookups, products and reductions
    are torch calls, as the JAX package leaves them to XLA."""
    _zero_counts(flash)
    paged.LAUNCHES = 0
    _phase("25 DeepFM train", phase_deepfm)
    _phase("25b DeepFM dp", phase_deepfm_dp)
    _phase("25c CTR agree", phase_ctr_agree)
    counts = _bwd_counts(flash) + (flash.TC_LAUNCHES, paged.LAUNCHES)
    if any(counts):
        _fail(f"phases 25-25c launched attention kernels: {counts}")


# phases 26-26d: guarded asynchronous training, save and load, the input
# pipeline and the dataset plane
# ---------------------------------------------------------------------------

def guard_feeds(n, batch=BERT_BATCH, seed=SEED + 100):
    """`n` ERNIE feeds of phase 16's kind (int32, synthetic), each its own
    draw from the seed."""
    from paddle_tpu_torch.models import ernie
    cfg = bert_config()
    return [ernie.make_pretrain_feed(cfg, BERT_SEQ, batch, seed=seed + i,
                                     dtype=np.int32) for i in range(n)]


def guard_config():
    """Phases 26-26c's ERNIE: phase 16's widths at GUARD_LAYERS layers."""
    return bert_config(num_hidden_layers=GUARD_LAYERS)


def _fresh_bert(main, startup, guard=True):
    """(exe, scope): a fresh Executor on the card and a scope holding
    the startup's weights (the same for every fresh pair: the startup's
    random ops fold in the program's seed and step 0)."""
    import paddle_tpu_torch as fluid
    exe = fluid.Executor(guard=guard, async_window=GUARD_WINDOW)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope


def _count_syncs(fn):
    """(fn(), the file:line of each host sync torch's sync debug mode
    reported in it)."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno}" for w in seen
                 if "called a synchronizing CUDA operation"
                 in str(w.message)]


def _behind_probe(exe, main, loss, scope, feeds):
    """Whether a step's feed upload waits for the steps before it. Step
    k is dispatched with GUARD_PROBE_SLEEP_MS of device sleep queued at
    its end (before its handle's event), so that it is still on the card
    when the host turns to step k+1; then step k+1's feeds go through the
    upload run_async uses (pinned memory, non_blocking) and, as a control,
    through a pageable copy (what run() did before): step k must still be
    on the card after the first, and done after the second (a pageable
    copy waits for everything queued before it). GUARD_PROBES times,
    from an empty window. Returns {"sleep_ms", "pairs": [(behind at the
    start, behind after the pinned upload, done after the pageable
    one)]}."""
    from paddle_tpu_torch.core import executor as executor_mod
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 8)
    b.record()
    b.synchronize()
    cycles = int(GUARD_PROBE_SLEEP_MS * 10 ** 8 / a.elapsed_time(b))
    real = exe._dispatch

    def sleepy(*args, **kw):
        out = real(*args, **kw)
        torch.cuda._sleep(cycles)
        return out

    pairs = []
    for j in range(GUARD_PROBES):
        exe.drain()
        exe._dispatch = sleepy
        hk = exe.run_async(main, feed=feeds[2 * j], fetch_list=[loss],
                           scope=scope)
        exe._dispatch = real
        start = not hk.done()
        executor_mod._canon_feeds(feeds[2 * j + 1], exe.device,
                                  pinned=True)
        pinned = not hk.done()
        executor_mod._canon_feeds(feeds[2 * j + 1], exe.device,
                                  pinned=False)
        pairs.append((start, pinned, hk.done()))
    exe.drain()
    return {"sleep_ms": GUARD_PROBE_SLEEP_MS, "pairs": pairs}


def _interleaved_timing(exe, main, loss, scope, feeds):
    """run() against run_async() on one executor, in GUARD_TIMING_BLOCKS
    alternating blocks of GUARD_TIMING_STEPS steps each (host-bound
    step times drift within a call; alternating shares the drift): the
    p50 and p99 of each, a run_async step timed from one dispatch's
    return to the next's, its window drained between blocks."""
    times = {"run": [], "run_async": []}
    for blk in range(GUARD_TIMING_BLOCKS):
        tag = ("run", "run_async")[blk % 2]
        t_last = time.perf_counter()
        for f in feeds[:GUARD_TIMING_STEPS]:
            if tag == "run":
                exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            else:
                exe.run_async(main, feed=f, fetch_list=[loss], scope=scope)
            now = time.perf_counter()
            times[tag].append((now - t_last) * 1e3)
            t_last = now
        exe.drain()
    return {f"{tag}_ms_{q}": float(np.percentile(t, int(q[1:])))
            for tag, t in times.items() for q in ("p50", "p99")}


def _host_profile(step, steps=2):
    """Where a step's host time goes: cProfile over `steps` calls of
    step() (it inflates Python against native code, so shares only):
    each of the top functions by own time with its share of the total
    and its calls a step."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    total = st.total_tt
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:8]
    return {"total_s": total, "top_own_time": [
        [f"{os.path.basename(f)}:{ln}({fn})", tt / total, nc // steps]
        for (f, ln, fn), (_cc, nc, tt, _ct, _callers) in rows]}


def _nan_mask_trips_guard(flash, main, startup, loss, feed):
    """Phase 26's gated NaN case: one NaN in ERNIE's input_mask reaches
    the attention only as the additive padding bias, which the flash
    forward must turn into NaN rows (ROADMAP C11): the loss goes NaN and
    the guard raises NonFiniteError when the step's handle resolves. The
    step launches its flash kernels once a layer each. Returns what it
    saw."""
    from paddle_tpu_torch.robustness import NonFiniteError
    exe, scope = _fresh_bert(main, startup)
    feed = {k: np.array(v, copy=True) for k, v in feed.items()}
    feed["input_mask"] = feed["input_mask"].astype(np.float32)
    feed["input_mask"][0, 7] = np.nan
    _zero_counts(flash)
    handle = exe.run_async(main, feed=feed, fetch_list=[loss], scope=scope)
    try:
        handle.result()
    except NonFiniteError as e:
        err = str(e)
    else:
        _fail("guarded: a NaN in input_mask did not trip the guard (the "
              "flash forward turned the NaN bias into finite rows)")
    n = guard_config().num_hidden_layers
    if _bwd_counts(flash) != (n, n, n):
        _fail(f"guarded: the NaN-mask step launched {_bwd_counts(flash)}, "
              f"want {n} each")
    exe.close()
    return {"input_mask_nan_trips_guard": True, "error": err[:200]}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _ernie_fetch_vars(main):
    """The pooled output (the NSP head's input) and the MLM logits (the
    tied projection plus its bias) of the pretraining Program."""
    gb = main.global_block()
    pooled = next(op.input("X")[0] for op in gb.ops
                  if "nsp_fc_w" in op.input_names)
    logits = next(op.output_names[0] for op in gb.ops
                  if op.type == "elementwise_add"
                  and "mlm_out_b" in op.input_names)
    return pooled, logits


def phase_guarded(flash):
    """Phase 26: ERNIE (phase 16's program at GUARD_LAYERS layers, Adam
    1e-4, dropout 0.1) under guarded asynchronous training. Two clean
    GUARD_STEPS-step runs from one startup, one through run(), one
    through run_async() with
    window GUARD_WINDOW, both on Executor(guard=True): their distance is
    the card's own (torch's CUDA embedding backward sums in no fixed
    order). Then GuardedTrainer over the same feeds, checkpoint_every
    GUARD_CKPT_EVERY: a NaN poisoned into step GUARD_POISON_AT, the
    GUARD_WRITE_FAULT-th physical checkpoint write failing, a SIGTERM
    before step GUARD_PREEMPT_AT; a fresh Executor, scope and
    GuardedTrainer resume() from the emergency checkpoint and finish.
    Gates: one rollback and one recovered write fault, preempted at
    GUARD_PREEMPT_AT, every step's loss within GUARD_SPREAD x the clean
    runs' distance (or GUARD_LOSS_FLOOR) of the clean run's; one launch
    of each flash kernel a layer a step in every run, none of
    flash_dbias; 0 host
    syncs in every timed dispatch, and step k still on the card when
    step k+1's dispatch starts; the first layer's attention call against
    the plain version. Prints run against run_async step p50/p99, host
    dispatch ms, the guard's cost (p50, device ms and operations guarded
    against unguarded), checkpoint bytes and sync/async save and restore
    ms, and the peak memory. Returns (launches by path, (fwd, bwd) max
    abs errors, the trained (exe, scope, main), the loss tolerance, the
    record)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import checkpoint as ckpt
    from paddle_tpu_torch.robustness import (ChaosInjector,
                                             CheckpointManager,
                                             GuardedTrainer)
    cfg = guard_config()
    n = cfg.num_hidden_layers
    main, startup, loss = build_bert(cfg)
    feeds = guard_feeds(GUARD_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paths, rec = {}, {"config": f"BertConfig(max_position_embeddings=512, "
                                f"num_hidden_layers={GUARD_LAYERS}), "
                                "Adam(1e-4), dropout 0.1, f32",
                      "seq_len": BERT_SEQ, "batch": BERT_BATCH,
                      "steps": GUARD_STEPS}
    dbias0 = flash.DBIAS_CALLS

    # -- clean run 1: run(), guarded; its first step's first attention
    exe, scope = _fresh_bert(main, startup)
    _zero_counts(flash)
    clean, run_ms, per_step = [], [], set()
    calls = {}
    for i, f in enumerate(feeds):
        before = _bwd_counts(flash)
        ts = time.perf_counter()
        if i == 0:
            calls = _captured_flash_calls(lambda: clean.append(exe.run(
                main, feed=f, fetch_list=[loss], scope=scope)[0]), {0})
        else:
            clean.append(exe.run(main, feed=f, fetch_list=[loss],
                                 scope=scope)[0])
        run_ms.append((time.perf_counter() - ts) * 1e3)
        per_step.add(tuple(a - b for a, b in zip(_bwd_counts(flash),
                                                 before)))
    clean = [float(np.asarray(x).reshape(-1)[0]) for x in clean]
    paths[f"26 ERNIE clean run() ({GUARD_STEPS} steps)"] = \
        _bwd_counts(flash) + (flash.TC_LAUNCHES,)
    if per_step != {(n, n, n)}:
        _fail(f"guarded: run() flash launches per step {per_step}, want "
              f"{n} each")
    guard_prof = _profile_train(lambda: exe.run(
        main, feed=feeds[0], fetch_list=[loss], scope=scope), 3)
    del exe, scope

    # -- clean run 2: run_async(), window GUARD_WINDOW
    exe, scope = _fresh_bert(main, startup)
    _zero_counts(flash)
    handles, not_done, gaps = [], [], []
    torch.cuda.synchronize()
    t_last = time.perf_counter()
    for i, f in enumerate(feeds):
        if i == BERT_WARM:
            exe.reset_stats()
        if handles:
            not_done.append(not handles[-1].done())
        handles.append(exe.run_async(main, feed=f, fetch_list=[loss],
                                     scope=scope))
        now = time.perf_counter()
        gaps.append((now - t_last) * 1e3)
        t_last = now
    async_losses = [float(h.result()[0].reshape(-1)[0]) for h in handles]
    stats = exe.get_stats()["async"]
    counts = _bwd_counts(flash)
    probe = _behind_probe(exe, main, loss, scope, feeds)
    # the host syncs inside a dispatch, counted on steps of their own (the
    # counting slows the host, so the timed run above goes without it)
    real = exe._dispatch
    syncs = []

    def counted(*a, **kw):
        out, where = _count_syncs(lambda: real(*a, **kw))
        syncs.append(where)
        return out

    exe._dispatch = counted
    for f in feeds[:GUARD_SYNC_STEPS]:
        exe.run_async(main, feed=f, fetch_list=[loss], scope=scope)
    exe.drain()
    del exe._dispatch
    timing = _interleaved_timing(exe, main, loss, scope, feeds)
    paths[f"26 ERNIE clean run_async() ({GUARD_STEPS} steps)"] = \
        counts + (flash.TC_LAUNCHES,)
    if counts != (GUARD_STEPS * n,) * 3:
        _fail(f"guarded: run_async flash launches {counts}, want "
              f"{GUARD_STEPS * n} each")
    if any(syncs):
        _fail(f"guarded: host syncs during run_async's dispatches: "
              f"{sorted({w for step in syncs for w in step})}")
    if not all(start and pinned and waited
               for start, pinned, waited in probe["pairs"]):
        _fail(f"guarded: step k+1's pinned feed upload waited for step k, "
              f"or the pageable control did not: {probe}")
    clean_dist = _rel(async_losses, clean)
    tol = max(GUARD_SPREAD * clean_dist, GUARD_LOSS_FLOOR)
    rec.update({
        "losses_clean": clean, "clean_runs_max_rel_distance": clean_dist,
        "loss_tol": tol,
        "run_step_ms_p50": float(np.percentile(run_ms[BERT_WARM:], 50)),
        "run_step_ms_p99": float(np.percentile(run_ms[BERT_WARM:], 99)),
        "run_async_step_ms_p50": float(np.percentile(gaps[BERT_WARM:], 50)),
        "run_async_step_ms_p99": float(np.percentile(gaps[BERT_WARM:], 99)),
        "interleaved": timing,
        "dispatch_ms_avg": stats["dispatch_ms"]["avg"],
        "behind_probe": probe,
        "host_sync_wait_ms_avg": stats["host_sync_wait_ms"]["avg"],
        "syncs_during_dispatch": [len(w) for w in syncs],
        "step_k_in_flight_at_dispatch_k1": sum(not_done[BERT_WARM:]),
        "window_waits": stats["window_waits"]})
    del exe, scope, handles

    # -- the guard's cost: an unguarded run of the same steps
    exe, scope = _fresh_bert(main, startup, guard=False)
    plain_ms = []
    for f in feeds[:BERT_WARM + GUARD_COST_STEPS]:
        ts = time.perf_counter()
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        plain_ms.append((time.perf_counter() - ts) * 1e3)
    plain_prof = _profile_train(lambda: exe.run(
        main, feed=feeds[0], fetch_list=[loss], scope=scope), 3)
    rec["host_profile_run"] = _host_profile(lambda: exe.run(
        main, feed=feeds[0], fetch_list=[loss], scope=scope))
    del exe, scope
    rec["guard_cost"] = {
        "guarded_step_ms_p50": rec["run_step_ms_p50"],
        "unguarded_step_ms_p50": float(np.percentile(plain_ms[BERT_WARM:],
                                                     50)),
        "guarded_device_ms": guard_prof["device_ms_per_step"],
        "unguarded_device_ms": plain_prof["device_ms_per_step"],
        "guarded_device_ops": guard_prof["device_ops_per_step"],
        "unguarded_device_ops": plain_prof["device_ops_per_step"]}

    # -- GuardedTrainer: poison, failed write, preemption; then resume
    root = tempfile.mkdtemp(prefix="guarded-")
    try:
        got = {}

        def keep(i, out):
            got[i] = float(np.asarray(out[0]).reshape(-1)[0])

        exe, scope = _fresh_bert(main, startup)
        # the NaN goes into the MLM weights, a factor of the loss (a NaN
        # in input_mask, which reaches the attention only as its padding
        # bias, is phase 26's own gated case: _nan_mask_trips_guard)
        chaos = ChaosInjector().poison_grad_at(GUARD_POISON_AT,
                                                var="mask_weight") \
            .fail_checkpoint_write(nth=GUARD_WRITE_FAULT) \
            .sigterm_at(GUARD_PREEMPT_AT)
        _zero_counts(flash)
        t0 = time.perf_counter()
        with chaos:
            trainer = GuardedTrainer(
                exe, main, fetch_list=[loss], scope=scope,
                manager=CheckpointManager(root, keep=2, program=main,
                                          sleep_fn=lambda s: None),
                checkpoint_every=GUARD_CKPT_EVERY, chaos=chaos,
                window=GUARD_WINDOW, result_callback=keep)
            res = trainer.train(feeds)
        train_s = time.perf_counter() - t0
        dispatched = exe.get_stats()["async"]["dispatches"]
        del exe, scope, trainer
        if not (res.preempted and res.steps == GUARD_PREEMPT_AT
                and res.rollbacks == 1 and len(res.faults) == 1
                and chaos.fired["poison"] == 1
                and chaos.fired["write_fault"] == 1
                and chaos.fired["sigterm"] == 1):
            _fail(f"guarded: GuardedTrainer {res} rollbacks "
                  f"{res.rollbacks} faults {res.faults} fired "
                  f"{chaos.fired}")
        exe, scope = fluid.Executor(guard=True,
                                    async_window=GUARD_WINDOW), \
            fluid.Scope()
        t0 = time.perf_counter()
        trainer = GuardedTrainer(
            exe, main, fetch_list=[loss], scope=scope,
            manager=CheckpointManager(root, keep=2, program=main),
            checkpoint_every=GUARD_CKPT_EVERY, window=GUARD_WINDOW,
            result_callback=keep)
        meta = trainer.resume()
        res2 = trainer.train(iter(feeds[GUARD_PREEMPT_AT:]))
        resume_s = time.perf_counter() - t0
        dispatched += exe.get_stats()["async"]["dispatches"]
        counts = _bwd_counts(flash)
        paths[f"26 ERNIE GuardedTrainer ({dispatched} dispatches: "
              f"rollback, replay, preemption, resume)"] = \
            counts + (flash.TC_LAUNCHES,)
        if meta["step"] != GUARD_PREEMPT_AT or res2.steps != GUARD_STEPS \
                or sorted(got) != list(range(GUARD_STEPS)):
            _fail(f"guarded: resume from {meta['step']} to {res2.steps}, "
                  f"losses for steps {sorted(got)}")
        if counts != (dispatched * n,) * 3:
            _fail(f"guarded: trainer flash launches {counts}, want "
                  f"{dispatched * n} each ({dispatched} dispatches)")
        trained = [got[i] for i in range(GUARD_STEPS)]
        dist = _rel(trained, clean)
        if not np.isfinite(trained).all() or dist > tol:
            _fail(f"guarded: rollback/resume losses {dist:.3g} from the "
                  f"clean run's, tol {tol:.3g}: {trained} vs {clean}")

        # checkpoint writes of the trained state
        d = os.path.join(root, "timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_checkpoint(exe, d + "-sync", main, step=GUARD_STEPS,
                             scope=scope)
        sync_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        h = ckpt.save_checkpoint_async(exe, d + "-async", main,
                                       step=GUARD_STEPS, scope=scope)
        async_return_ms = (time.perf_counter() - t0) * 1e3
        h.wait()
        async_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ckpt.load_checkpoint(exe, d + "-sync", main, scope=fluid.Scope())
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(os.path.join(d + "-sync", "state.npz"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if flash.DBIAS_CALLS != dbias0:
        _fail(f"guarded: flash_dbias ran {flash.DBIAS_CALLS - dbias0} "
              f"times, want 0 (BERT's padding bias needs no gradient)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 26)
    errs = (check_one_flash(flash, "guarded layer 0", calls[0]),
            check_one_flash_bwd(flash, "guarded layer 0", calls[0], gen,
                                False))
    rec.update({
        "trainer_losses": trained, "trainer_max_rel_distance": dist,
        "rollbacks": res.rollbacks, "replayed_steps": dispatched
        - GUARD_STEPS, "checkpoints_written": res.checkpoints_written
        + res2.checkpoints_written, "fired": chaos.fired,
        "preempted_at": res.steps, "train_s": train_s,
        "resume_s": resume_s, "checkpoint_bytes": nbytes,
        "save_sync_ms": sync_ms, "save_async_return_ms": async_return_ms,
        "save_async_total_ms": async_ms, "restore_ms": restore_ms,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "flash_launches_by_path": {k: list(v) for k, v in paths.items()},
        "attention_vs_plain_max_abs_err_fwd_bwd": list(errs),
        "nan_mask": _nan_mask_trips_guard(flash, main, startup, loss,
                                          feeds[0])})
    print("guarded " + json.dumps(rec))
    print("profile guarded " + json.dumps(guard_prof))
    print("profile unguarded " + json.dumps(plain_prof))
    return paths, errs, (exe, scope, main, loss), tol, rec


def phase_save_load(flash, trained):
    """Phase 26b: save_params / save_persistables / save_inference_model
    from phase 26's trained scope, and the Fluid 1.5 formats
    (save_fluid_inference_model). Each reloads in a fresh Scope and a
    fresh Executor: the reloaded encoder's pooled output and MLM logits
    must be bitwise the trained program's clone(for_test=True) on the
    same feed, each reloaded forward launching the f32 flash forward once
    a layer and no backward; the persistables reload bitwise. Returns the
    launches by path and the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    exe, scope, main, _loss = trained
    n = guard_config().num_hidden_layers
    pooled, logits = _ernie_fetch_vars(main)
    feed_names = ["src_ids", "sent_ids", "input_mask", "mask_pos"]
    feed = {k: v for k, v in guard_feeds(1, seed=SEED + 300)[0].items()
            if k in feed_names}
    want = exe.run(main.clone(for_test=True), feed=feed,
                   fetch_list=[pooled, logits], scope=scope)
    root = tempfile.mkdtemp(prefix="saveload-")
    rec, paths = {}, {}
    try:
        t0 = time.perf_counter()
        io.save_params(exe, os.path.join(root, "params"), main, scope=scope)
        io.save_persistables(exe, os.path.join(root, "persist"), main,
                             scope=scope)
        rec["save_params_and_persistables_ms"] = \
            (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            io.save_inference_model(os.path.join(root, "inference"),
                                    feed_names, [pooled, logits], exe,
                                    main_program=main)
            io.save_fluid_inference_model(os.path.join(root, "fluid"),
                                          feed_names, [pooled, logits],
                                          exe, main_program=main)
        rec["save_inference_models_ms"] = (time.perf_counter() - t0) * 1e3
        s2 = fluid.Scope()
        io.load_persistables(fluid.Executor(), os.path.join(root,
                                                            "persist"),
                             main, scope=s2)
        bad = [v.name for v in main.list_vars() if v.persistable
               and scope.get(v.name) is not None
               and not torch.equal(s2.get(v.name), scope.get(v.name))]
        if bad:
            _fail(f"save/load: persistables not bitwise after reload: "
                  f"{bad[:5]}")
        for tag, loader in (("inference", io.load_inference_model),
                            ("fluid", io.load_fluid_inference_model)):
            exe2, s3 = fluid.Executor(), fluid.Scope()
            t0 = time.perf_counter()
            with fluid.scope_guard(s3):
                prog, feeds, fetches = loader(os.path.join(root, tag), exe2)
            rec[f"load_{tag}_ms"] = (time.perf_counter() - t0) * 1e3
            _zero_counts(flash)
            got = exe2.run(prog, feed={k: feed[k] for k in feeds},
                           fetch_list=fetches, scope=s3)
            c = _bwd_counts(flash) + (flash.TC_LAUNCHES,)
            paths[f"26b reloaded {tag} model forward"] = c
            if c != (n, 0, 0, 0):
                _fail(f"save/load {tag}: flash launches {c}, want "
                      f"({n}, 0, 0, 0)")
            for name, a, b in zip(("pooled", "mlm_logits"), got, want):
                if a.shape != b.shape or not np.array_equal(a, b):
                    _fail(f"save/load {tag}: reloaded {name} not bitwise "
                          f"the trained program's (max abs "
                          f"{np.max(np.abs(a - b))})")
        rec["bytes"] = {sub: sum(os.path.getsize(os.path.join(dp, f))
                                 for dp, _, fs in os.walk(
                                     os.path.join(root, sub)) for f in fs)
                        for sub in ("params", "persist", "inference",
                                    "fluid")}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec["pooled_shape"] = list(want[0].shape)
    rec["mlm_logits_shape"] = list(want[1].shape)
    rec["flash_launches_by_path"] = {k: list(v) for k, v in paths.items()}
    print("save_load " + json.dumps(rec))
    return paths, rec


def phase_pipelined(flash, tol):
    """Phase 26c: run_pipelined over PIPE_BATCHES ERNIE batches (the last
    PIPE_TAIL rows, padded to the batch by a FeedBucketer) from phase
    26's startup, against run() over the same bucketed feeds from the
    same startup: losses in feed order within phase 26's tolerance.
    Prints the prefetch depth and the share of each host-to-device copy
    (its own copy stream, pinned memory) that ran under earlier steps.
    Returns the launches by path and the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.bucketing import FeedBucketer
    cfg = guard_config()
    n = cfg.num_hidden_layers
    main, startup, loss = build_bert(cfg)
    feeds = guard_feeds(PIPE_BATCHES - 1, seed=SEED + 200) + \
        guard_feeds(1, batch=PIPE_TAIL, seed=SEED + 250)
    bucketer = FeedBucketer(mask_name=None)
    exe, scope = _fresh_bert(main, startup, guard=False)
    ref = [float(np.asarray(exe.run(main, feed=bucketer.bucket(f),
                                    fetch_list=[loss], scope=scope)[0])
                 .reshape(-1)[0]) for f in feeds]
    exe, scope = _fresh_bert(main, startup, guard=False)
    copies, steps = [], []
    real = exe.run_async

    def marked(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        h = real(*a, **kw)
        end.record()
        steps.append((start, end))
        return h

    exe.run_async = marked
    e0 = torch.cuda.Event(enable_timing=True)
    e0.record()
    _zero_counts(flash)
    t0 = time.perf_counter()
    outs = [float(np.asarray(o[0]).reshape(-1)[0])
            for o in exe.run_pipelined(main, feeds, fetch_list=[loss],
                                       scope=scope, bucketer=bucketer,
                                       copy_events=copies)]
    wall = time.perf_counter() - t0
    del exe.run_async
    counts = _bwd_counts(flash)
    if counts != (len(feeds) * n,) * 3:
        _fail(f"pipelined: flash launches {counts}, want "
              f"{len(feeds) * n} each")
    dist = _rel(outs, ref)
    if len(outs) != len(ref) or dist > tol:
        _fail(f"pipelined: losses {dist:.3g} from run()'s (tol {tol:.3g}): "
              f"{outs} vs {ref}")

    torch.cuda.synchronize()

    def at(e):
        return e0.elapsed_time(e)

    spans = [(at(s), at(e)) for s, e in steps]
    hidden = []
    for k, (cs, ce) in enumerate(copies):
        a, b = at(cs), at(ce)
        over = sum(max(0.0, min(b, se) - max(a, ss))
                   for ss, se in spans[:k])
        hidden.append(over / (b - a) if b > a else 1.0)
    rec = {"batches": len(feeds), "tail_rows": PIPE_TAIL,
           "bucketed_to": BERT_BATCH, "prefetch_depth": 2,
           "window": GUARD_WINDOW, "wall_s": wall,
           "max_rel_distance_from_run": dist, "loss_tol": tol,
           "copy_ms": [at(e) - at(s) for s, e in copies],
           "copy_hidden_share": hidden,
           "copy_hidden_share_after_first": float(np.mean(hidden[1:])),
           "flash_launches": list(counts)}
    print("pipelined " + json.dumps(rec))
    return {f"26c run_pipelined ({len(feeds)} batches)":
            counts + (flash.TC_LAUNCHES,)}, rec


def _slot_lines(ids, vals, labels):
    """MultiSlot text lines of DeepFM's three slots."""
    f = ids.shape[1]
    head = str(f)
    return [" ".join([head] + [str(x) for x in ids[i]] + [head]
                     + [f"{x:.4f}" for x in vals[i]]
                     + ["1", str(labels[i])])
            for i in range(len(labels))]


def deepfm_dataset(seed):
    """(main, startup, loss, dataset, parse s): phase 25's DeepFM and an
    InMemoryDataset loaded from DATASET_FILES MultiSlot files of
    DATASET_BATCHES x DEEPFM_BATCH seeded examples (written to a
    temporary directory, parsed by DATASET_THREADS threads)."""
    from paddle_tpu_torch.io import dataset as ds
    rng = np.random.default_rng(seed)
    n = DATASET_BATCHES * DEEPFM_BATCH
    ids = rng.integers(0, DEEPFM_FEATURES, (n, DEEPFM_FIELDS))
    vals = rng.random((n, DEEPFM_FIELDS)).round(4)
    labels = rng.integers(0, 2, n)
    lines = _slot_lines(ids, vals, labels)
    root = tempfile.mkdtemp(prefix="dataset-")
    try:
        files = []
        per = n // DATASET_FILES
        for i in range(DATASET_FILES):
            p = os.path.join(root, f"part-{i:05d}")
            with open(p, "w") as f:
                f.write("\n".join(lines[i * per:(i + 1) * per]) + "\n")
            files.append(p)
        main, startup, loss = build_deepfm()
        gb = main.global_block()
        d = ds.DatasetFactory().create_dataset("InMemoryDataset")
        d.set_batch_size(DEEPFM_BATCH)
        d.set_use_var([gb.var("feat_ids"), gb.var("feat_vals"),
                       gb.var("label")])
        d.set_filelist(files)
        d.set_thread(DATASET_THREADS)
        t0 = time.perf_counter()
        d.load_into_memory()
        parse_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return main, startup, loss, d, parse_s


def phase_dataset(flash, paged):
    """Phase 26d: DeepFM (phase 25's cell, batch DEEPFM_BATCH) through
    Executor.train_from_dataset over DATASET_FILES generated MultiSlot
    files (seeded numpy, written to a temporary directory),
    DATASET_BATCHES batches, InMemoryDataset with DATASET_THREADS parse
    threads: the native parser (csrc/dataset_feed.cc) must have run, and
    the losses must match run() over the same batches from the same
    startup within DEEPFM_DP_SPREAD x two such runs' distance (or
    DATASET_LOSS_FLOOR). Prints examples/s of both and the parse time.
    Launches none of the attention kernels."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import dataset as ds
    n = DATASET_BATCHES * DEEPFM_BATCH
    main, startup, loss, d, parse_s = deepfm_dataset(SEED + 26)
    if d.parser != "native":
        _fail(f"dataset: the {d.parser} parser ran, want the native one "
              f"({ds.NATIVE_BUILD_ERROR})")
    t0 = time.perf_counter()
    batches = list(d._iter_batches())
    assemble_s = time.perf_counter() - t0
    c0 = _bwd_counts(flash) + (flash.TC_LAUNCHES, paged.LAUNCHES)

    def fresh():
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        return exe, scope

    exe, scope = fresh()
    got = []
    real = exe.run

    def spied(*a, **kw):
        out = real(*a, **kw)
        got.append(float(np.asarray(out[0]).reshape(-1)[0]))
        return out

    exe.run = spied
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exe.train_from_dataset(program=main, dataset=d, scope=scope,
                           thread=DATASET_THREADS, fetch_list=[loss],
                           print_period=10 ** 9)
    torch.cuda.synchronize()
    dataset_s = time.perf_counter() - t0
    refs, run_s = [], None
    for _ in range(2):
        exe, scope = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs.append([float(np.asarray(exe.run(
            main, feed=b, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0])
            for b in batches])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    if _bwd_counts(flash) + (flash.TC_LAUNCHES, paged.LAUNCHES) != c0:
        _fail("dataset: DeepFM launched attention kernels")
    spread = _rel(refs[1], refs[0])
    tol = max(DEEPFM_DP_SPREAD * spread, DATASET_LOSS_FLOOR)
    dist = _rel(got, refs[0])
    if len(got) != DATASET_BATCHES or dist > tol:
        _fail(f"dataset: train_from_dataset losses {dist:.3g} from run()'s "
              f"(tol {tol:.3g}): {got} vs {refs[0]}")
    rec = {"examples": n, "batch": DEEPFM_BATCH, "files": DATASET_FILES,
           "threads": DATASET_THREADS, "parser": d.parser,
           "parse_s": parse_s, "batch_assembly_s": assemble_s,
           "train_from_dataset_examples_per_s": n / dataset_s,
           "run_examples_per_s": n / run_s,
           "losses": got, "max_rel_distance_from_run": dist,
           "run_spread": spread, "loss_tol": tol}
    print("dataset " + json.dumps(rec))
    return rec


def phase_guarded_all(flash, paged):
    """Phases 26-26d. Returns (flash launches by path, {path: (fwd, bwd)
    max abs errors})."""
    paths, errs, trained, tol, _ = _phase(
        f"26 ERNIE ({GUARD_LAYERS} layers) under GuardedTrainer",
        phase_guarded, flash)
    more, _ = _phase("26b save and load", phase_save_load, flash, trained)
    paths.update(more)
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    more, _ = _phase("26c run_pipelined", phase_pipelined, flash, tol)
    paths.update(more)
    _phase("26d DeepFM train_from_dataset", phase_dataset, flash, paged)
    return paths, {"26 ERNIE GuardedTrainer layer 0": errs}


# ---------------------------------------------------------------------------
# phases 27-27d: the other optimizers on ERNIE-base
# ---------------------------------------------------------------------------

WRAP_LR = 1e-4                      # Adam's rate in 27 and 27b
GM_K = 4                            # 27: sub-batches a merged step
GM_SUBS = 8                         # 27: sub-batches of BERT_BATCH (2 applies)
GM_MLM_WEIGHT = 100.0               # 27: a sub-batch's MLM weights' sum
WRAP_SPREAD = 4.0                   # x the distance of two plain runs
WRAP_FLOOR = 1e-5                   # or this share of a tensor's scale
# 27's merged gradient against the big batch's, all gradients as one
# vector: at the first apply step both come from the same weights (the
# sums' order differs); at the second the weights differ by the first
# step's distance, which Adam's per-entry normalization magnifies
GM_GRAD_FLOORS = (1e-5, 1e-4)
# ... and tensor by tensor (_grad_rel_err), at 9b's TRAIN_GRAD_TOL: batch
# 8 and batch 32 sum their rows in GEMMs of other shapes (other cuBLAS
# algorithms and splits), so a tensor whose gradient cancels, such as the
# last layer's Q projection, differs by 5.25e-5 of its scale at the first
# apply step (measured on one H100), where two identical runs differ by
# 8.1e-7: the spread cannot see it
GM_TENSOR_TOL = TRAIN_GRAD_TOL
LA_ALPHA, LA_K = 0.5, 5             # 27b: Lookahead
DECAY_COEFF = 1e-6                  # 27b: lr 1e-4 x LARK's decay 0.01
EMA_DECAY = 0.999
WRAP_STEPS = 10                     # 27b: steps (ModelAverage's window)
WRAP_WATCH = ("word_embedding", "enc0_attn_q", "mlm_out_b")
WRAP_EMA_RTOL = 1e-6                # 27b: apply() vs numpy, f32 rounding
DGC_LR, DGC_MU = 1e-3, 0.9          # 27c
DGC_BEGIN = 2                       # 27c: dense steps before the ramp
DGC_SPARSITY = 0.999
DGC_STEPS = 6
SETLR_FACTOR = 2.0                  # 27d: set_lr(factor x lr)
SETLR_RTOL = 1e-3                   # 27d: Adam's update is linear in lr
DPS_WORLD_STEPS = 2                 # 27d: data_parallel_step over a world


def wrap_config(**kw):
    """ERNIE-base, dropout 0 (27-27d compare runs)."""
    return bert_config(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0, **kw)


def build_bert_with(cfg, minimize):
    """(main, startup, loss, extra): phase 16's net at seq BERT_SEQ whose
    optimizer `minimize(fluid, main, loss, startup)` appends (and whose
    return value is `extra`)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 16
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _f, loss, _mlm, _acc = bert.build_pretrain_net(cfg, seq_len=BERT_SEQ)
        extra = minimize(fluid, main, loss, startup)
    return main, startup, loss, extra


def _adam(fluid, main, loss, startup):
    fluid.optimizer.AdamOptimizer(WRAP_LR).minimize(loss, startup)


def _start_scope(startup, like=None):
    """A scope after `startup`, its parameters replaced by copies of
    `like`'s (so that programs with different optimizer state start from
    the same weights)."""
    import paddle_tpu_torch as fluid
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    if like is not None:
        for n in like.names():
            if n in scope.names():
                scope.set(n, like.get(n).clone())
    return scope


def _concat_feeds(feeds):
    """Sub-batch feeds -> one feed, mask_pos moved to the rows' new
    place in the flattened (B T) grid."""
    out, rows = {}, 0
    for f in feeds:
        f = dict(f)
        f["mask_pos"] = f["mask_pos"] + rows * f["src_ids"].shape[1]
        rows += f["src_ids"].shape[0]
        for k, v in f.items():
            out.setdefault(k, []).append(v)
    return {k: np.concatenate(v, axis=0) for k, v in out.items()}


def _state_names(scope, params):
    """The parameters and the optimizer state an update writes (moments,
    velocities, beta pows, DGC's U and V)."""
    keys = ("moment", "beta", "velocity", "dgc_u", "dgc_v")
    return list(params) + sorted(n for n in scope.names()
                                 if any(k in n for k in keys))


def _step_record(flash, tag, n, per_step, step_ms, prof):
    """The gates every 27-27d run shares (12 + 12 + 12 flash launches a
    step, none on the tensor cores) and its printed numbers: step p50,
    device ms and operations a step, peak memory."""
    if per_step != {(n, n, n)} or flash.TC_LAUNCHES:
        _fail(f"{tag}: flash launches a step {per_step}, "
              f"{flash.TC_LAUNCHES} tensor-core, want ({n}, {n}, {n})")
    rec = {"step_ms_p50": float(np.percentile(step_ms, 50)),
           "device_ms_per_step": prof["device_ms_per_step"],
           "device_ops_per_step": prof["device_ops_per_step"],
           "device_busy_share": prof["device_busy_share"],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches_a_step": [n, n, n]}
    print(f"{tag}: " + json.dumps(rec))
    return rec


def phase_grad_merge(flash):
    """Phase 27: GradientMergeOptimizer(AdamOptimizer(WRAP_LR), k_steps=
    GM_K, avg=True) over GM_SUBS ERNIE sub-batches of BERT_BATCH (2 apply
    steps), against 2 steps of plain Adam on the same sub-batches
    concatenated to batch GM_K x BERT_BATCH, run twice (their distance is
    the card's own), all from one startup's weights. Each sub-batch's
    MLM weights are scaled to sum to GM_MLM_WEIGHT (a sub-batch's loss is
    the same at any scale of its weights), so the big batch's loss is the
    mean of its sub-batches' and its gradient the merged one. Gates: the
    merged gradient (the @GRAD the apply step hands Adam) against the big
    batch's as one vector (within WRAP_SPREAD x the two plain runs'
    distance or GM_GRAD_FLOORS) and tensor by tensor (GM_TENSOR_TOL), and
    the parameters after each apply step as one vector (_global_rel_err:
    Adam's first step is lr g / (|g| + eps), so an entry whose gradient
    sits at the rounding noise, such as a key bias's, lands anywhere in
    [-lr, lr]) within WRAP_SPREAD x the two plain runs' distance or
    WRAP_FLOOR;
    off-steps leave the parameters and Adam's state bitwise as they were;
    12 + 12 + 12 flash launches a step. Reports the off-step's and the
    apply step's device ms and the entries more than lr / 2 from the big
    batch's. Returns (launches by run, record)."""
    import paddle_tpu_torch as fluid
    cfg = wrap_config()
    n = cfg.num_hidden_layers
    feeds = guard_feeds(GM_SUBS, seed=SEED + 270)
    for f in feeds:
        f["mask_weight"] = (f["mask_weight"] * (GM_MLM_WEIGHT / f[
            "mask_weight"].sum())).astype(np.float32)
    big = [_concat_feeds(feeds[j * GM_K:(j + 1) * GM_K])
           for j in range(GM_SUBS // GM_K)]

    def merged(fluid, main, loss, startup):
        fluid.optimizer.GradientMergeOptimizer(
            fluid.optimizer.AdamOptimizer(WRAP_LR), k_steps=GM_K,
            avg=True).minimize(loss, startup)

    gmain, gstart, gloss, _ = build_bert_with(cfg, merged)
    pmain, pstart, ploss, _ = build_bert_with(cfg, _adam)
    params = [p.name for p in gmain.all_parameters()]
    gnames = [p + "@GRAD" for p in params]
    gc.collect()
    torch.cuda.empty_cache()
    base = _start_scope(gstart)
    launches, rec = {}, {"k_steps": GM_K, "sub_batches": GM_SUBS,
                         "sub_batch": BERT_BATCH, "lr": WRAP_LR}

    # the big batch, twice: the @GRADs and parameters of each step
    plain = []
    for r in range(2):
        scope = _start_scope(pstart, base)
        exe = fluid.Executor()
        _zero_counts(flash)
        run = {"losses": [], "grads": [], "params": [], "ms": []}
        per = set()
        for f in big:
            b0 = _bwd_counts(flash)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(pmain, feed=f, fetch_list=[ploss] + gnames,
                          scope=scope, return_numpy=False)
            torch.cuda.synchronize()
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            run["losses"].append(out[0].double().item())
            run["grads"].append(out[1:])
            run["params"].append({p: scope.get(p).clone() for p in params})
            per.add(tuple(a - b for a, b in zip(_bwd_counts(flash), b0)))
        plain.append(run)
        if r == 0:
            launches[f"27 big batch {GM_K * BERT_BATCH} Adam ({len(big)} "
                     f"steps)"] = _bwd_counts(flash) + (flash.TC_LAUNCHES,)
            rec["big_batch"] = _step_record(
                flash, "27 big batch", n, per, run["ms"], _profile_train(
                    lambda: exe.run(pmain, feed=big[0], fetch_list=[ploss],
                                    scope=scope), 1))
        del scope, exe

    # the merged run
    torch.cuda.reset_peak_memory_stats()
    scope = _start_scope(gstart, base)
    exe = fluid.Executor()
    state = _state_names(scope, params)
    snap, off_ok, merged_grads, merged_params = {}, [], [], []

    def before(i):
        if i % GM_K != GM_K - 1:
            snap.clear()
            snap.update({s: scope.get(s).clone() for s in state})

    _zero_counts(flash)
    per_step, step_ms, losses = set(), [], []
    for i, f in enumerate(feeds):
        before(i)
        b0 = _bwd_counts(flash)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        apply = i % GM_K == GM_K - 1
        out = exe.run(gmain, feed=f, fetch_list=[gloss] + (
            gnames if apply else []), scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(out[0].double().item())
        per_step.add(tuple(a - b for a, b in zip(_bwd_counts(flash), b0)))
        if apply:
            merged_grads.append(out[1:])
            merged_params.append({p: scope.get(p).clone() for p in params})
        else:
            changed = [s for s in state if not torch.equal(scope.get(s),
                                                           snap[s])]
            off_ok.append(not changed)
            if changed:
                _fail(f"27 gradient merge: off-step {i} changed "
                      f"{changed[:5]} ({len(changed)} of {len(state)})")
    launches[f"27 gradient merge k {GM_K} ({GM_SUBS} steps)"] = \
        _bwd_counts(flash) + (flash.TC_LAUNCHES,)
    off_prof = _profile_train(lambda: exe.run(
        gmain, feed=feeds[0], fetch_list=[gloss], scope=scope), GM_K - 1)
    on_prof = _profile_train(lambda: exe.run(
        gmain, feed=feeds[0], fetch_list=[gloss], scope=scope), 1)
    rec["run"] = _step_record(flash, "27 gradient merge", n, per_step,
                              step_ms, on_prof)
    rec["off_step_device_ms"] = off_prof["device_ms_per_step"]
    rec["apply_step_device_ms"] = on_prof["device_ms_per_step"]
    rec["off_step_device_ops"] = off_prof["device_ops_per_step"]
    rec["apply_step_device_ops"] = on_prof["device_ops_per_step"]
    rec["off_steps_bitwise"] = off_ok
    rec["losses"] = losses
    rec["big_batch_losses"] = [plain[0]["losses"], plain[1]["losses"]]
    for j in range(len(big)):
        gerr, gname = _grad_rel_err(merged_grads[j], plain[0]["grads"][j],
                                    gnames)
        gdist = _global_rel_err(merged_grads[j], plain[0]["grads"][j])
        gspread = _global_rel_err(plain[1]["grads"][j],
                                  plain[0]["grads"][j])
        gtol = max(WRAP_SPREAD * gspread, GM_GRAD_FLOORS[j])
        want = [plain[0]["params"][j][p] for p in params]
        got = [merged_params[j][p] for p in params]
        pspread = _global_rel_err([plain[1]["params"][j][p]
                                   for p in params], want)
        pdist = _global_rel_err(got, want)
        ptol = max(WRAP_SPREAD * pspread, WRAP_FLOOR)
        worst = max(((a - b).abs().max().item(), p)
                    for p, a, b in zip(params, got, want))
        far = sum(int(((a - b).abs() > WRAP_LR / 2).sum())
                  for a, b in zip(got, want))
        rec[f"apply{j}"] = {"grad_dist": gdist, "grad_spread": gspread,
                            "grad_tol": gtol, "grad_tensor_err": gerr,
                            "grad_worst": gname,
                            "param_dist": pdist, "param_spread": pspread,
                            "param_tol": ptol, "param_worst_abs": worst,
                            "entries_beyond_half_lr": far}
        print(f"27 apply step {j}: merged gradient {gdist:.3e} (tol "
              f"{gtol:.3e}, two big-batch runs {gspread:.3e}), by tensor "
              f"{gerr:.3e} at {gname} (tol {GM_TENSOR_TOL})"
              f", parameters {pdist:.3e} (tol {ptol:.3e}, two big-batch "
              f"runs {pspread:.3e}; worst entry {worst[0]:.3e} in "
              f"{worst[1]}), {far} entries beyond lr/2")
        if gdist > gtol or gerr > GM_TENSOR_TOL or pdist > ptol:
            _fail(f"27 gradient merge: apply step {j} disagrees with the "
                  f"big batch: {rec[f'apply{j}']}")
    print("grad_merge " + json.dumps(rec))
    del scope, exe, plain, merged_params, merged_grads, snap
    return launches, rec


def _host(scope, name):
    return scope.get(name).detach().to("cpu", copy=True).numpy()


def _diff_var(main, param):
    """The Lookahead temporaries of `param`: (the name of fast - slow, the
    slow var's name), from the elementwise_sub that reads both."""
    for op in main.global_block().ops:
        if op.type == "elementwise_sub" and op.input("X") == [param] and \
                ".slow" in op.input("Y")[0]:
            return op.output("Out")[0], op.input("Y")[0]
    _fail(f"27b: no Lookahead difference op for {param}")


def phase_wrappers(flash):
    """Phase 27b, LARK's shape: extend_with_decoupled_weight_decay(
    AdamOptimizer)(DECAY_COEFF, learning_rate=WRAP_LR) inside
    LookaheadOptimizer(alpha=LA_ALPHA, k=LA_K), with an
    ExponentialMovingAverage(EMA_DECAY, thres_steps=a step counter) and a
    ModelAverage, WRAP_STEPS steps. Gates on WRAP_WATCH (the word
    embedding, layer 0's Q projection, the MLM bias), read to the host
    after every step: at the sync steps fast equals slow bitwise and slow
    equals slow_prev + alpha (fast - slow_prev) in f32 (the difference
    fetched); EMA apply() equals a numpy f32 recomputation of the
    bias-corrected EMA within WRAP_EMA_RTOL, ModelAverage's the mean of
    the steps' values; restore() brings the training weights back
    bitwise and a nested apply unwinds one level; a forward of the
    clone(for_test=True) under apply() launches 12 flash forwards, and
    every step 12 + 12 + 12. Returns (launches by run, record)."""
    import paddle_tpu_torch as fluid
    cfg = wrap_config()
    n = cfg.num_hidden_layers

    def lark(fluid, main, loss, startup):
        test = main.clone(for_test=True)
        cls = fluid.contrib.extend_with_decoupled_weight_decay(
            fluid.optimizer.AdamOptimizer)
        fluid.optimizer.LookaheadOptimizer(
            cls(DECAY_COEFF, learning_rate=WRAP_LR), alpha=LA_ALPHA,
            k=LA_K).minimize(loss, startup)
        thres = fluid.layers.autoincreased_step_counter(begin=0, step=1)
        ema = fluid.optimizer.ExponentialMovingAverage(EMA_DECAY,
                                                       thres_steps=thres)
        ema.update()
        ma = fluid.optimizer.ModelAverage(
            0.15, min_average_window=WRAP_STEPS,
            max_average_window=WRAP_STEPS)
        return test, ema, ma

    main, startup, loss, (test, ema, ma) = build_bert_with(cfg, lark)
    types = [op.type for op in main.global_block().ops]
    if types.count("decoupled_weight_decay") != len(main.all_parameters()):
        _fail("27b: not one decoupled_weight_decay op a parameter")
    diffs = {p: _diff_var(main, p) for p in WRAP_WATCH}
    feeds = guard_feeds(WRAP_STEPS, seed=SEED + 271)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    slow = {p: _host(scope, diffs[p][1]) for p in WRAP_WATCH}
    ema_ref = {p: np.zeros_like(slow[p]) for p in WRAP_WATCH}
    ma_ref = {p: np.zeros_like(slow[p]) for p in WRAP_WATCH}
    syncs = []
    _zero_counts(flash)
    per_step, step_ms = set(), []
    with fluid.scope_guard(scope):
        for i, f in enumerate(feeds):
            b0 = _bwd_counts(flash)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(main, feed=f, fetch_list=[loss] + [
                diffs[p][0] for p in WRAP_WATCH], return_numpy=False)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.add(tuple(a - b for a, b in zip(_bwd_counts(flash),
                                                     b0)))
            d = float(np.asarray(_host(scope, ema._decay_name)).reshape(-1)[0])
            want = min(EMA_DECAY, (i + 1.0) / (i + 10.0))
            if abs(d - want) > 1e-6 * want:
                _fail(f"27b: EMA decay {d} at step {i}, want {want}")
            d32 = np.float32(d)
            omd = np.float32(d32 * np.float32(-1.0) + np.float32(1.0))
            for k, p in enumerate(WRAP_WATCH):
                fast = _host(scope, p)
                ema_ref[p] = ema_ref[p] * d32 + fast * omd
                ma_ref[p] = ma_ref[p] + fast
                if (i + 1) % LA_K:
                    continue
                diff = out[1 + k].detach().cpu().numpy()
                want_slow = slow[p] + np.float32(LA_ALPHA) * diff
                got_slow = _host(scope, diffs[p][1])
                if not (np.array_equal(got_slow, fast)
                        and np.array_equal(got_slow, want_slow)):
                    _fail(f"27b: step {i} {p}: fast == slow "
                          f"{np.array_equal(got_slow, fast)}, slow == "
                          f"formula {np.array_equal(got_slow, want_slow)}")
                slow[p] = got_slow
                syncs.append((i, p))
        launches = {f"27b LARK decay + Lookahead + EMA + ModelAverage "
                    f"({WRAP_STEPS} steps)": _bwd_counts(flash)
                    + (flash.TC_LAUNCHES,)}
        rec = {"sync_checks": len(syncs), "watch": list(WRAP_WATCH)}
        # apply() against the host references of the WRAP_STEPS steps
        train = {p.name: scope.get(p.name) for p in main.all_parameters()}
        t = float(np.asarray(_host(scope, ema._count_name)).reshape(-1)[0])
        corr = np.float32(1.0 - float(d32) ** t)
        _zero_counts(flash)
        with ema.apply(exe):
            applied = {p: _host(scope, p) for p in WRAP_WATCH}
            with ema.apply(exe):
                pass
            if any(not np.array_equal(_host(scope, p), applied[p])
                   for p in WRAP_WATCH):
                _fail("27b: a nested EMA apply did not unwind one level")
            exe.run(test, feed=feeds[0], fetch_list=[loss])
            if _bwd_counts(flash) != (n, 0, 0):
                _fail(f"27b: a forward under apply() launched "
                      f"{_bwd_counts(flash)}, want ({n}, 0, 0)")
        if any(scope.get(p) is not v for p, v in train.items()):
            _fail("27b: restore() did not bring back the training tensors")
        with ma.apply(exe):
            averaged = {p: _host(scope, p) for p in WRAP_WATCH}
        if any(scope.get(p) is not v for p, v in train.items()):
            _fail("27b: ModelAverage's restore lost the training tensors")
        errs = {}
        for p in WRAP_WATCH:
            e = float(np.max(np.abs(applied[p] - ema_ref[p] / corr)
                             / np.maximum(np.abs(ema_ref[p] / corr), 1e-30)))
            m = float(np.max(np.abs(averaged[p] - ma_ref[p] / np.float32(
                WRAP_STEPS)) / np.maximum(np.abs(ma_ref[p]) / WRAP_STEPS,
                                          1e-30)))
            errs[p] = {"ema_apply_rel_err": e, "model_average_rel_err": m}
            if not (e <= WRAP_EMA_RTOL and m <= WRAP_EMA_RTOL):
                _fail(f"27b: {p}: EMA apply {e:.3e}, ModelAverage {m:.3e} "
                      f"from numpy (tol {WRAP_EMA_RTOL})")
        rec.update(ema_steps=t, apply_errs=errs)
        prof = _profile_train(lambda: exe.run(
            main, feed=feeds[0], fetch_list=[loss]), 2)
        rec["run"] = _step_record(flash, "27b wrappers", n, per_step,
                                  step_ms, prof)
    if t != WRAP_STEPS or len(syncs) != len(WRAP_WATCH) * (
            WRAP_STEPS // LA_K):
        _fail(f"27b: EMA steps {t}, sync checks {len(syncs)}")
    print("wrappers " + json.dumps(rec))
    return launches, rec


def _dgc(fluid, main, loss, startup):
    fluid.optimizer.DGCMomentumOptimizer(
        DGC_LR, DGC_MU, rampup_begin_step=DGC_BEGIN,
        sparsity=(DGC_SPARSITY,)).minimize(loss, startup)


def _momentum(fluid, main, loss, startup):
    fluid.optimizer.MomentumOptimizer(DGC_LR, DGC_MU).minimize(loss, startup)


def phase_dgc(flash):
    """Phase 27c: DGCMomentumOptimizer(DGC_LR, DGC_MU, rampup_begin_step=
    DGC_BEGIN, sparsity=(DGC_SPARSITY,)) on a local dp DP mesh on this
    card (phase 21's form), DGC_STEPS steps of phase 16's feed, from one
    startup's weights. Gates: the dense steps equal MomentumOptimizer at
    dp DP (losses within DP_FIRST_LOSS_TOL, the parameters after them
    within DP_GRAD_TOL of each tensor's scale); in each sparse step each
    parameter changes in at most DGC_SPARSITY's share of its entries (+1
    for a tie) and the residual V is exactly the masked-out velocity
    (V' = V + U' where the entry was not sent, U' = V' = 0 where it was);
    the run at dp DP within WRAP_SPREAD x the distance of two dp 1 runs
    (losses; the parameters as one vector), or WRAP_FLOOR; 12 + 12 + 12
    flash launches a rank and step (24 + 24 + 24 at dp 2). The word
    embedding's 23.4 M-entry threshold is taken every step. Returns
    (launches by run, record)."""
    import paddle_tpu_torch as fluid
    cfg = wrap_config()
    n = cfg.num_hidden_layers
    feed = bert_feed()
    dmain, dstart, dloss, _ = build_bert_with(cfg, _dgc)
    mmain, mstart, mloss, _ = build_bert_with(cfg, _momentum)
    params = [p.name for p in dmain.all_parameters()]
    gc.collect()
    torch.cuda.empty_cache()
    base = _start_scope(dstart)
    places = [fluid.CUDAPlace(0)] * DP
    launches, rec = {}, {"steps": DGC_STEPS, "dp": DP,
                         "sparsity": DGC_SPARSITY, "begin": DGC_BEGIN}

    def run(main, startup, loss, places_, steps, check=None):
        scope = _start_scope(startup, base)
        prog = _dp_program(main, loss, places_) if places_ else main
        exe = fluid.Executor()
        _zero_counts(flash)
        losses, per_step, step_ms = [], set(), []
        for i in range(steps):
            prev = ({s: scope.get(s).clone()
                     for s in _state_names(scope, params)}
                    if check else None)
            b0 = _bwd_counts(flash)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(out[0].double().item())
            per_step.add(tuple(a - b for a, b in zip(_bwd_counts(flash),
                                                     b0)))
            if check:
                check(i, scope, prev)
        return scope, exe, prog, losses, per_step, step_ms

    fractions = []

    def sparse_check(i, scope, prev):
        if i < DGC_BEGIN:
            return
        row = {}
        for p in params:
            u_name = [s for s in prev if s.startswith(p + "_dgc_u")][0]
            v_name = [s for s in prev if s.startswith(p + "_dgc_v")][0]
            changed = scope.get(p) != prev[p]
            u, v = scope.get(u_name), scope.get(v_name)
            cnt, numel = int(changed.sum()), changed.numel()
            bound = int(np.floor((1 - DGC_SPARSITY) * numel)) + 1
            row[p] = cnt / numel
            sent = (u == 0) & (v == 0)
            kept_ok = torch.equal(v[~sent], (prev[v_name] + u)[~sent])
            if cnt > bound or bool((changed & ~sent).any()) or not kept_ok:
                _fail(f"27c: step {i} {p}: {cnt} of {numel} entries "
                      f"changed (bound {bound}), changed but not sent "
                      f"{int((changed & ~sent).sum())}, V = V + U' where "
                      f"not sent {kept_ok}")
        fractions.append(row)

    torch.cuda.reset_peak_memory_stats()
    scope2, exe2, prog2, l2, per2, ms2 = run(dmain, dstart, dloss, places,
                                             DGC_STEPS, sparse_check)
    launches[f"27c DGC dp {DP} ({DGC_STEPS} steps)"] = _bwd_counts(flash) \
        + (flash.TC_LAUNCHES,)
    p2 = [scope2.get(p).clone() for p in params]
    prof = _profile_train(lambda: exe2.run(prog2, feed=feed,
                                           fetch_list=[dloss],
                                           scope=scope2), 1)
    rec["run"] = _step_record(flash, f"27c DGC dp {DP}", DP * n, per2, ms2,
                              prof)
    del scope2, exe2, prog2
    # the dense steps against Momentum at dp DP
    mscope, _e, _p, ml, _per, _ms = run(mmain, mstart, mloss, places,
                                        DGC_BEGIN)
    dscope, _e, _p, dl, _per, _ms = run(dmain, dstart, dloss, places,
                                        DGC_BEGIN)
    worst = max((((dscope.get(p) - mscope.get(p)).abs().max()
                  / mscope.get(p).abs().max().clamp_min(1e-30)).item(), p)
                for p in params)
    first = abs(dl[0] - ml[0]) / abs(ml[0])
    later = max(abs(a - b) / abs(b) for a, b in zip(dl[1:], ml[1:]))
    rec["dense"] = {"losses": dl, "momentum_losses": ml,
                    "first_loss_rel_err": first, "later_loss_rel_err": later,
                    "param_rel_err": worst[0], "param_worst": worst[1]}
    del mscope, dscope
    if first > DP_FIRST_LOSS_TOL or later > DP_LATER_LOSS_TOL or \
            worst[0] > DP_GRAD_TOL:
        _fail(f"27c: the dense steps differ from Momentum: {rec['dense']}")
    # dp DP against two dp 1 runs
    one = []
    for _ in range(2):
        s1, _e, _p, l1, per1, _ms = run(dmain, dstart, dloss, None,
                                        DGC_STEPS)
        if per1 != {(n, n, n)}:
            _fail(f"27c: dp 1 launches a step {per1}")
        one.append((l1, [s1.get(p).clone() for p in params]))
        del s1
    spread_l = _rel(one[1][0], one[0][0])
    spread_p = _global_rel_err(one[1][1], one[0][1])
    dist_l, dist_p = _rel(l2, one[0][0]), _global_rel_err(p2, one[0][1])
    tol_l = max(WRAP_SPREAD * spread_l, WRAP_FLOOR)
    tol_p = max(WRAP_SPREAD * spread_p, WRAP_FLOOR)
    rec.update(losses_dp=l2, losses_dp1=one[0][0],
               loss_dist=dist_l, loss_spread=spread_l, loss_tol=tol_l,
               param_dist=dist_p, param_spread=spread_p, param_tol=tol_p,
               changed_fraction_max_by_step=[max(r.values())
                                             for r in fractions],
               changed_fraction_word_embedding=[
                   r["word_embedding"] for r in fractions])
    print("dgc " + json.dumps(rec))
    if dist_l > tol_l or dist_p > tol_p:
        _fail(f"27c: dp {DP} {dist_l:.3e} / {dist_p:.3e} from dp 1 (tol "
              f"{tol_l:.3e} / {tol_p:.3e})")
    return launches, rec


def phase_set_lr(flash):
    """27d set_lr: two runs of 2 ERNIE steps from one startup's weights,
    Adam(WRAP_LR); before the second step of run B, set_lr(SETLR_FACTOR x
    WRAP_LR). The LR var stays the same tensor on the card and holds the
    new rate; on every WRAP_WATCH tensor run B's step 1 update is
    SETLR_FACTOR x run A's and its step 0 update run A's, each within
    SETLR_RTOL as one vector (the runs differ only by the card's own
    embedding backward; Adam's update is linear in the rate). Returns
    (launches, record)."""
    import paddle_tpu_torch as fluid
    cfg = wrap_config()
    n = cfg.num_hidden_layers
    feeds = guard_feeds(2, seed=SEED + 272)
    holder = {}

    def adam(fluid, main, loss, startup):
        holder["opt"] = fluid.optimizer.AdamOptimizer(WRAP_LR)
        holder["opt"].minimize(loss, startup)

    main, startup, loss, _ = build_bert_with(cfg, adam)
    opt = holder["opt"]
    base = _start_scope(startup)
    deltas = []
    _zero_counts(flash)
    for factor in (None, SETLR_FACTOR):
        scope = _start_scope(startup, base)
        exe = fluid.Executor()
        lr_t = scope.get(opt._lr_var.name)
        w = [{p: _host(scope, p) for p in WRAP_WATCH}]
        with fluid.scope_guard(scope):
            for i, f in enumerate(feeds):
                if i == 1 and factor:
                    opt.set_lr(factor * WRAP_LR)
                exe.run(main, feed=f, fetch_list=[loss])
                w.append({p: _host(scope, p) for p in WRAP_WATCH})
        if scope.get(opt._lr_var.name) is not lr_t or \
                lr_t.device != scope.get("word_embedding").device:
            _fail("27d set_lr: the LR var was replaced or left the "
                  "parameters' device")
        want = WRAP_LR * (factor or 1.0)
        if abs(lr_t.item() - want) > 1e-6 * want:
            _fail(f"27d set_lr: the LR var holds {lr_t.item()}, want {want}")
        deltas.append([{p: w[i + 1][p] - w[i][p] for p in WRAP_WATCH}
                       for i in range(2)])
        del scope, exe
    rec = {}
    for p in WRAP_WATCH:
        a0, b0 = deltas[0][0][p], deltas[1][0][p]
        a1, b1 = deltas[0][1][p], deltas[1][1][p]
        step1 = float(np.linalg.norm(b1 - SETLR_FACTOR * a1)
                      / np.linalg.norm(SETLR_FACTOR * a1))
        step0 = float(np.linalg.norm(b0 - a0) / np.linalg.norm(a0))
        rec[p] = {"step1_rel_err_vs_factor": step1,
                  "step0_rel_diff": step0}
        if step1 > SETLR_RTOL or step0 > SETLR_RTOL:
            _fail(f"27d set_lr: {p}: {rec[p]}")
    counts = _bwd_counts(flash)
    if counts != (4 * n,) * 3:
        _fail(f"27d set_lr: flash launches {counts}, want {4 * n} each")
    print("set_lr " + json.dumps(rec))
    return {f"27d set_lr (2 runs x 2 steps)": counts
            + (flash.TC_LAUNCHES,)}, rec


def phase_dataset_dp(flash, paged):
    """27d train_from_dataset at dp DP: phase 26d's DeepFM over generated
    MultiSlot files through CompiledProgram(...).with_data_parallel() on
    a local dp DP mesh (each batch split over the ranks as run()'s walk
    splits a feed), against run() of that CompiledProgram over the same
    batches, twice (their distance is the card's own): losses within
    DEEPFM_DP_SPREAD x that distance or DATASET_LOSS_FLOOR; the dp
    reductions counted; no attention kernel. Returns the record."""
    import paddle_tpu_torch as fluid
    nex = DATASET_BATCHES * DEEPFM_BATCH
    main, startup, loss, d, _parse_s = deepfm_dataset(SEED + 273)
    if d.parser != "native":
        _fail(f"27d dataset dp: the {d.parser} parser ran")
    batches = list(d._iter_batches())
    c0 = _bwd_counts(flash) + (flash.TC_LAUNCHES, paged.LAUNCHES)
    places = [fluid.CUDAPlace(0)] * DP

    def fresh():
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        return exe, scope, _dp_program(main, loss, places)

    exe, scope, comp = fresh()
    got, real = [], exe.run

    def spied(*a, **kw):
        out = real(*a, **kw)
        got.append(float(np.asarray(out[0]).reshape(-1)[0]))
        return out

    exe.run = spied
    red0 = comp.mesh.reductions
    t0 = time.perf_counter()
    exe.train_from_dataset(program=comp, dataset=d, scope=scope,
                           thread=DATASET_THREADS, fetch_list=[loss],
                           print_period=10 ** 9)
    torch.cuda.synchronize()
    dataset_s = time.perf_counter() - t0
    reductions = comp.mesh.reductions - red0
    refs = []
    for _ in range(2):
        exe, scope, comp = fresh()
        refs.append([float(np.asarray(exe.run(
            comp, feed=b, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0])
            for b in batches])
    if _bwd_counts(flash) + (flash.TC_LAUNCHES, paged.LAUNCHES) != c0:
        _fail("27d dataset dp: DeepFM launched attention kernels")
    spread = _rel(refs[1], refs[0])
    tol = max(DEEPFM_DP_SPREAD * spread, DATASET_LOSS_FLOOR)
    dist = _rel(got, refs[0])
    rec = {"dp": DP, "batches": len(got), "losses": got,
           "max_rel_distance_from_run": dist, "run_spread": spread,
           "loss_tol": tol, "dp_reductions": reductions,
           "examples_per_s": nex / dataset_s}
    print("dataset dp " + json.dumps(rec))
    if len(got) != DATASET_BATCHES or dist > tol or reductions <= 0:
        _fail(f"27d dataset dp: {rec}")
    return rec


def _world_step_program():
    """The 2-layer, dropout-0 ERNIE of 21b/21d as a functional step for
    data_parallel_step: step(scope, feed) -> (scope, loss)."""
    import paddle_tpu_torch as fluid
    main, startup, loss = dp_agree_program()
    exe = fluid.Executor()

    def step(scope, feed):
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                      return_numpy=False)
        return scope, out[0].detach()

    return main, startup, step


def dps_world_rank(rank, init, out):
    """One rank of 27d's world (`--dps-world-rank`): joins the gloo group
    and runs data_parallel_step over it (the global batch on this rank,
    cuda:0) for DPS_WORLD_STEPS steps; writes its losses and the MLM bias
    to <out>/rank<rank>.pt."""
    import datetime
    import torch.distributed as dist
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.cuda import flash
    from paddle_tpu_torch.parallel import data_parallel_step
    from paddle_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=DP,
                            timeout=datetime.timedelta(seconds=120))
    try:
        flash.build()
        flash.build_bwd()
        mesh = make_mesh(dp=DP)
        if not mesh.world or mesh.held("dp") != [rank]:
            raise RuntimeError(f"not a world dp mesh: {mesh}")
        main, startup, step = _world_step_program()
        run = data_parallel_step(step, mesh)
        scope = fluid.Scope()
        fluid.Executor().run(startup, scope=scope)
        losses = []
        for _ in range(DPS_WORLD_STEPS):
            scope, loss = run(scope, dp_agree_feed())
            losses.append(loss.double().item())
        torch.save({"losses": losses, "launches": list(_bwd_counts(flash)),
                    "mlm_out_b": scope.get("mlm_out_b").cpu()},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_dps_world(flash):
    """27d data_parallel_step over a world: two processes on cuda:0 joined
    by gloo (as 21d), each passing the global batch, against
    data_parallel_step on the local dp DP mesh, twice (the card's own
    distance): losses and the MLM bias within WRAP_SPREAD x that distance
    or WRAP_FLOOR; each rank launches 2 + 2 + 2 flash kernels a step (2
    layers). Returns the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import data_parallel_step
    from paddle_tpu_torch.parallel.mesh import make_mesh
    base = tempfile.mkdtemp(prefix="dps_world_")
    init = "file://" + os.path.join(base, "rendezvous")
    procs, recs = [], []
    try:
        for r in range(DP):
            log = open(os.path.join(base, f"rank{r}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--dps-world-rank", str(r), init, base],
                stdout=log, stderr=subprocess.STDOUT), log))
        # the local mesh's runs while the ranks start
        local = []
        for _ in range(2):
            _main, startup, step = _world_step_program()
            run = data_parallel_step(step, make_mesh(
                dp=DP, devices=["cuda:0"] * DP))
            scope = fluid.Scope()
            fluid.Executor().run(startup, scope=scope)
            losses = []
            for _s in range(DPS_WORLD_STEPS):
                scope, loss = run(scope, dp_agree_feed())
                losses.append(loss.double().item())
            local.append((losses, scope.get("mlm_out_b").cpu()))
        deadline = time.monotonic() + DP_WORLD_TIMEOUT_S
        codes = []
        for p, _log in procs:
            try:
                codes.append(p.wait(max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        if codes != [0] * DP:
            for r in range(DP):
                with open(os.path.join(base, f"rank{r}.log")) as f:
                    print(f"27d rank {r} log tail:\n" + f.read()[-3000:])
            _fail(f"27d world: rank exit codes {codes}")
        for r in range(DP):
            recs.append(torch.load(os.path.join(base, f"rank{r}.pt")))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        shutil.rmtree(base, ignore_errors=True)
    layers = BERT_AGREE_LAYERS
    spread_l = _rel(local[1][0], local[0][0])
    spread_b = _global_rel_err([local[1][1]], [local[0][1]])
    rec = {"steps": DPS_WORLD_STEPS, "layers": layers,
           "local_losses": local[0][0], "spread": [spread_l, spread_b]}
    for r, got in enumerate(recs):
        dl = _rel(got["losses"], local[0][0])
        db = _global_rel_err([got["mlm_out_b"]], [local[0][1]])
        rec[f"rank{r}"] = {"losses": got["losses"], "loss_dist": dl,
                           "bias_dist": db, "launches": got["launches"]}
        want = [layers * DPS_WORLD_STEPS] * 3
        if dl > max(WRAP_SPREAD * spread_l, WRAP_FLOOR) or \
                db > max(WRAP_SPREAD * spread_b, WRAP_FLOOR) or \
                got["launches"] != want:
            _fail(f"27d world rank {r}: {rec[f'rank{r}']} (launches want "
                  f"{want})")
    print("dps world " + json.dumps(rec))
    return rec


def phase_optimizers_all(flash, paged):
    """Phases 27-27d. Returns (flash launches by path, records)."""
    gc.collect()
    torch.cuda.empty_cache()
    paths, recs = {}, {}
    p, recs["27"] = _phase("27 gradient merge", phase_grad_merge, flash)
    paths.update(p)
    p, recs["27b"] = _phase("27b EMA, ModelAverage, Lookahead, decoupled "
                            "decay", phase_wrappers, flash)
    paths.update(p)
    p, recs["27c"] = _phase("27c DGC at dp 2", phase_dgc, flash)
    paths.update(p)
    p, recs["27d set_lr"] = _phase("27d set_lr", phase_set_lr, flash)
    paths.update(p)
    recs["27d dataset dp"] = _phase("27d train_from_dataset at dp 2",
                                    phase_dataset_dp, flash, paged)
    recs["27d world"] = _phase("27d data_parallel_step over a world",
                               phase_dps_world, flash)
    return paths, recs


# ---------------------------------------------------------------------------
# phases 28-28e: the sequence, recurrent, CRF and CTC family
# ---------------------------------------------------------------------------

def _seq_phase(name, fn, flash, paged, *args):
    """One of phases 28-28e or 29-29c with the attention kernels' counts
    zeroed before it and gated at 0 after it: the sequence family and the
    control-flow constructs launch no attention kernel. Returns (fn's
    result, the counts)."""
    _zero_counts(flash)
    paged.LAUNCHES = 0
    gc.collect()
    torch.cuda.empty_cache()
    out = _phase(name, fn, *args)
    counts = _bwd_counts(flash) + (flash.TC_LAUNCHES, paged.LAUNCHES)
    if any(counts):
        _fail(f"phase {name} launched attention kernels: {counts}")
    return out, counts


def _timed_steps(exe, program, feed, fetch, scope, steps):
    """`steps` runs of program, each fetch to numpy (the copy ends the
    step): (the fetches of every run, each run's ms)."""
    outs, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        outs.append(exe.run(program, feed=feed, fetch_list=fetch,
                            scope=scope))
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def _seq_record(tag, config, batch, step_ms, peak, prof, **extra):
    """Print phase `tag`'s record (step p50 / p99, examples/s, peak
    memory, the profile's device ms, operations and busy share, the
    card) and its profile; return the record."""
    p50 = float(np.percentile(step_ms, 50))
    out = {"config": config, "batch": batch, "steps_timed": len(step_ms),
           "step_ms_p50": p50,
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "examples_per_s": batch / (p50 / 1e3),
           "max_memory_allocated": peak,
           "device_ms_per_step": prof["device_ms_per_step"],
           "device_ops_per_step": prof["device_ops_per_step"],
           "device_busy_share": prof["device_busy_share"],
           "card": _card_line(), **extra}
    print(f"{tag} " + json.dumps(out))
    print(f"profile {tag} " + json.dumps(prof))
    return out


class _OpArgs:
    """The inputs and attrs of one direct op call (an op's context
    outside a Program), for the timing comparisons of 28d and 28e."""

    def __init__(self, ins, attrs):
        self.ins, self.attrs = ins, attrs

    def in_(self, slot, default=None):
        return self.ins.get(slot, default)

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def wants(self, slot):
        return True


def _event_ms(fn, reps=SEQ_TIME_REPS, warmup=2):
    """The median ms of fn() between CUDA events around each call, after
    `warmup` calls. For the host-bound eager recurrences this is the span
    the card spends on a call, launch gaps included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    return float(np.median(ms))


def _fwd_bwd(fn, params):
    """fn() and its backward into `params` (a sum of the outputs)."""
    def run():
        outs = fn()
        loss = sum(o.float().sum() for o in outs)
        torch.autograd.grad(loss, params)
    return run


def build_srl(depth=SRL_DEPTH, hidden=SRL_HIDDEN, batch=SRL_BATCH,
              length=SRL_LEN):
    """(main, startup, vars): label_semantic_roles.db_lstm at the book's
    widths (word_dim SRL_WORD_DIM, mark_dim SRL_MARK_DIM, `hidden`,
    `depth`) over the conll05 dictionaries, with linear_chain_crf and
    crf_decoding sharing one transition as build_train_net wires them,
    chunk_eval (IOB, SRL_CHUNK_TYPES types) on the decoded path, and
    AdamOptimizer(SRL_LR). The model module's dictionary sizes are set to
    conll05's for the build and restored after it."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.dataset import conll05
    from paddle_tpu_torch.models import label_semantic_roles as srl
    L = fluid.layers
    saved = srl.WORD_DICT_LEN, srl.PRED_DICT_LEN, srl.LABEL_DICT_LEN
    srl.WORD_DICT_LEN, srl.PRED_DICT_LEN, srl.LABEL_DICT_LEN = (
        conll05.WORD_DICT_LEN, conll05.PRED_DICT_LEN, conll05.LABEL_DICT_LEN)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 28
    try:
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            def data(name, shape):
                return L.data(name, shape=shape, dtype="int64",
                              append_batch_size=False)
            feats = {n: data(n, [batch, length]) for n in srl.FEATURE_NAMES}
            target = data("target", [batch, length])
            lens = data("length", [batch])
            emission = srl.db_lstm(feats, word_dim=SRL_WORD_DIM,
                                   mark_dim=SRL_MARK_DIM, hidden_dim=hidden,
                                   depth=depth, length=lens)
            crf = fluid.ParamAttr(name="srl_crf")
            nll = L.linear_chain_crf(emission, target, param_attr=crf,
                                     length=lens)
            loss = L.mean(nll)
            decode = L.crf_decoding(emission, param_attr=crf, length=lens)
            chunks = L.chunk_eval(decode, target, "IOB", SRL_CHUNK_TYPES,
                                  seq_length=lens)
            fluid.optimizer.AdamOptimizer(SRL_LR).minimize(loss)
    finally:
        srl.WORD_DICT_LEN, srl.PRED_DICT_LEN, srl.LABEL_DICT_LEN = saved
    return main, startup, {"loss": loss, "nll": nll, "emission": emission,
                           "decode": decode, "chunks": list(chunks)}


def srl_feed(batch=SRL_BATCH, length=SRL_LEN, device="cuda"):
    """The first `batch` sentences of the conll05 test reader (8-31 words
    each), padded (or cut) to `length`, with their lengths: the eight
    features, "target" and "length" as int64 tensors on `device`."""
    from paddle_tpu_torch.dataset import conll05
    from paddle_tpu_torch.models import label_semantic_roles as srl
    names = srl.FEATURE_NAMES + ("target",)
    feed = {n: np.zeros((batch, length), np.int64) for n in names}
    lens = np.zeros(batch, np.int64)
    for i, sample in zip(range(batch), conll05.test()()):
        n = min(len(sample[0]), length)
        lens[i] = n
        for name, col in zip(names, sample):
            feed[name][i, :n] = col[:n]
    feed["length"] = lens
    return {k: torch.from_numpy(v).to(device) for k, v in feed.items()}


def _viterbi64(em, w, lens):
    """Each row's best path score and path, in float64 on the host."""
    start, end, trans = w[0], w[1], w[2:]
    scores, paths = [], []
    for r in range(em.shape[0]):
        delta, back = start + em[r, 0], []
        for s in range(1, int(lens[r])):
            cand = delta[:, None] + trans
            back.append(cand.argmax(0))
            delta = cand.max(0) + em[r, s]
        delta = delta + end
        tag = int(delta.argmax())
        path = [tag]
        for bp in reversed(back):
            tag = int(bp[tag])
            path.append(tag)
        scores.append(float(delta.max()))
        paths.append(path[::-1])
    return np.array(scores), paths


def _path_score64(em, w, tags):
    """The score of the tag path `tags` (a row's valid steps) in
    float64."""
    start, end, trans = w[0], w[1], w[2:]
    tags = np.asarray(tags)
    return float(start[tags[0]] + end[tags[-1]]
                 + em[np.arange(len(tags)), tags].sum()
                 + trans[tags[:-1], tags[1:]].sum())


def _near_tie_rows(em, w, lens, tol):
    """The rows whose Viterbi recursion (float64) meets two candidates
    within `tol` x (1 + |score|) of each other at some step: a tie that
    may break either way once the sums run in another order."""
    start, end, trans = w[0], w[1], w[2:]
    rows = []
    for r in range(em.shape[0]):
        delta = start + em[r, 0]
        near = False
        for s in range(1, int(lens[r])):
            cand = delta[:, None] + trans
            top = np.sort(cand, axis=0)[-2:]
            near |= bool(((top[1] - top[0]) <= tol * (1 + np.abs(top[1])))
                         .any())
            delta = cand.max(0) + em[r, s]
        last = np.sort(delta + end)[-2:]
        near |= bool(last[1] - last[0] <= tol * (1 + abs(last[1])))
        if near:
            rows.append(r)
    return rows


def _kernels_under(e):
    """The device kernels launched by a profiler event and its
    children."""
    return len(getattr(e, "kernels", ()) or ()) + sum(
        _kernels_under(c) for c in getattr(e, "cpu_children", ()) or ())


def phase_srl():
    """Phase 28: SRL at the book's widths (build_srl: hidden SRL_HIDDEN,
    depth SRL_DEPTH, the conll05 dictionaries), one batch of SRL_BATCH
    conll05 sentences padded to SRL_LEN, SRL_STEPS Adam steps on the
    card. Gates: every loss finite, the last 5 steps' mean below the
    first 5's; on the trained weights (the clone(for_test=True) Program)
    every row's NLL >= -SRL_NLL_FLOOR x its gold score's magnitude, and
    the Viterbi path's score, recomputed in float64 on the host from the
    fetched emissions and transition, >= the gold path's and within
    SRL_VITERBI_RTOL of the float64 Viterbi maximum; chunk_eval's
    precision, recall and F1 printed. Reports step p50 / p99, examples/s,
    peak memory and a profile of SRL_PROFILE_STEPS steps by op (device
    ms, operations, busy share; the forward recurrence's share)."""
    import paddle_tpu_torch as fluid
    main, startup, v = build_srl()
    feed = srl_feed()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    params = sum(scope.get(p.name).numel() for p in main.all_parameters())
    torch.cuda.reset_peak_memory_stats()
    outs, ms = _timed_steps(exe, main, feed, [v["loss"]], scope, SRL_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]
    test = main.clone(for_test=True)
    nll, em, path, *chunks = exe.run(
        test, feed=feed, scope=scope,
        fetch_list=[v["nll"], v["emission"], v["decode"]] + v["chunks"])
    w = scope.get("srl_crf").double().cpu().numpy()
    em = em.astype(np.float64)
    lens = feed["length"].cpu().numpy()
    target = feed["target"].cpu().numpy()
    best, _paths = _viterbi64(em, w, lens)
    got = np.array([_path_score64(em[r], w, path[r, :lens[r]])
                    for r in range(len(lens))])
    gold = np.array([_path_score64(em[r], w, target[r, :lens[r]])
                     for r in range(len(lens))])
    viterbi_err = float(np.max(np.abs(got - best)
                               / np.maximum(np.abs(best), 1)))
    nll_worst = float(np.min(nll.reshape(-1) / np.maximum(np.abs(gold), 1)))
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[
        v["loss"]], scope=scope), SRL_PROFILE_STEPS)
    rec_ms = prof["device_ms_per_step_by_op"].get("lstm", 0.0)
    rec_ops = (prof.get("device_ops_per_step_by_op") or {}).get("lstm")
    out = _seq_record(
        "srl", f"db_lstm(word_dim={SRL_WORD_DIM}, mark_dim={SRL_MARK_DIM}, "
        f"hidden_dim={SRL_HIDDEN}, depth={SRL_DEPTH}) + linear_chain_crf "
        f"over conll05's dictionaries, Adam({SRL_LR}), f32", SRL_BATCH,
        ms[2:], peak, prof, seq_len=SRL_LEN, params=int(params),
        tokens=int(lens.sum()), loss_first=losses[0], loss_last=losses[-1],
        losses=losses, nll_over_gold_magnitude_min=nll_worst,
        viterbi_vs_float64_max_rel_err=viterbi_err,
        viterbi_minus_gold_min=float(np.min(got - gold)),
        chunk_precision_recall_f1=[float(c.reshape(-1)[0])
                                   for c in chunks[:3]],
        chunk_counts_infer_label_correct=[int(c.reshape(-1)[0])
                                          for c in chunks[3:]],
        recurrence_fwd_ms_per_step=rec_ms,
        recurrence_fwd_share_of_device=rec_ms / prof["device_ms_per_step"],
        recurrence_fwd_ops_per_step=rec_ops,
        recurrence_fwd_share_of_ops=(
            None if rec_ops is None
            else rec_ops / prof["device_ops_per_step"]))
    if not np.isfinite(losses).all() or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        _fail(f"srl: losses not finite or not falling: {losses}")
    if nll_worst < -SRL_NLL_FLOOR:
        _fail(f"srl: a row's NLL is below -{SRL_NLL_FLOOR} x its gold "
              f"score's magnitude: {nll_worst}")
    if not (np.all(got >= gold - SRL_VITERBI_RTOL * np.abs(gold))
            and viterbi_err <= SRL_VITERBI_RTOL):
        _fail(f"srl: the Viterbi path is not optimal in float64: its "
              f"scores {got}, the maximum {best}, the gold {gold}")
    return out


def phase_srl_agree():
    """Phase 28b: build_srl cut in depth (SRL_AGREE: depth, hidden, T,
    batch), one startup scope (run on the CPU) copied to the card and to
    the CPU, TF32 off, one step on each: every row's NLL within
    SRL_AGREE_NLL_TOL relative, each @GRAD within SRL_AGREE_GRAD_TOL of
    that gradient's largest entry, the Viterbi paths (the clone(
    for_test=True) Program, before the step) equal apart from the rows
    with a float64 near tie (listed)."""
    import paddle_tpu_torch as fluid
    a = SRL_AGREE
    main, startup, v = build_srl(a["depth"], a["hidden"], a["batch"],
                                 a["length"])
    feed = {k: t.numpy() for k, t in srl_feed(a["batch"], a["length"],
                                              "cpu").items()}
    test = main.clone(for_test=True)
    base = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=base)
    names = [p.name for p in main.all_parameters()]
    runs = {}
    for where, place in (("card", fluid.CUDAPlace(0)),
                         ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for nm in base.names():
            scope.set(nm, base.get(nm).to(exe.device, copy=True))
        em, path = exe.run(test, feed=feed, scope=scope,
                           fetch_list=[v["emission"], v["decode"]])
        out = exe.run(main, feed=feed, scope=scope, fetch_list=[v["nll"]]
                      + [nm + "@GRAD" for nm in names])
        runs[where] = (em, path, out[0], out[1:])
    card, cpu = runs["card"], runs["cpu"]
    nll_err = float(np.max(np.abs(card[2] - cpu[2]) / np.abs(cpu[2])))
    grad_errs = {nm: float(np.abs(g - h).max() / np.abs(h).max())
                 for nm, g, h in zip(names, card[3], cpu[3])}
    worst = max(grad_errs, key=grad_errs.get)
    w = base.get("srl_crf").double().numpy()
    ties = _near_tie_rows(cpu[0].astype(np.float64), w, feed["length"],
                          SRL_TIE_TOL)
    differ = sorted(set(np.nonzero((card[1] != cpu[1]).any(1))[0].tolist()))
    out = {"config": a, "nll_rel_err": nll_err,
           "grad_worst": [worst, grad_errs[worst]],
           "emission_max_abs_diff": float(np.abs(card[0] - cpu[0]).max()),
           "paths_differ_rows": differ, "near_tie_rows": ties,
           "card": _card_line()}
    print("srl agree " + json.dumps(out))
    if nll_err > SRL_AGREE_NLL_TOL or grad_errs[worst] > SRL_AGREE_GRAD_TOL \
            or set(differ) - set(ties):
        _fail(f"srl agree: the card against the CPU: {out}")
    return out


def phase_srl_dp():
    """Phase 28c: phase 28's cell through with_data_parallel(places=
    [CUDAPlace(0)] * DP) against places=[CUDAPlace(0)] (dp 1), and two
    plain Executor runs beside them, from one startup scope, SRL_DP_STEPS
    steps: each loss and each first-step @GRAD of dp DP within
    SRL_DP_SPREAD x the two plain runs' distance or SRL_DP_FLOOR of its
    scale, whichever is larger; chunk_eval's counts at dp DP equal dp
    1's, on the cell's decoded paths and on one path fed to both; a
    ragged sequence_expand under dp DP refuses."""
    import paddle_tpu_torch as fluid
    main, startup, v = build_srl()
    feed = srl_feed()
    exe = fluid.Executor()
    base = fluid.Scope()
    exe.run(startup, scope=base)
    names = [p.name for p in main.all_parameters()]
    test = main.clone(for_test=True)
    one, many = [fluid.CUDAPlace(0)], [fluid.CUDAPlace(0)] * DP
    runs = {}
    for tag, prog, places in (("dp1", _dp_program(main, v["loss"], one), one),
                              (f"dp{DP}", _dp_program(main, v["loss"], many),
                               many),
                              ("plain", main, None), ("plain2", main, None)):
        scope = _copy_scope(base)
        evalp = test if places is None else fluid.CompiledProgram(
            test).with_data_parallel(places=places)
        path, *counts = exe.run(evalp, feed=feed, scope=scope,
                                fetch_list=[v["decode"]] + v["chunks"][3:])
        losses, ms = [], []
        for i in range(SRL_DP_STEPS):
            t0 = time.perf_counter()
            out = exe.run(prog, feed=feed, scope=scope, return_numpy=False,
                          fetch_list=[v["loss"]] + ([nm + "@GRAD" for nm in
                                                     names] if i == 0
                                                    else []))
            losses.append(out[0].double().item())
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                grads = [g.double() for g in out[1:]]
        runs[tag] = {"losses": losses, "grads": grads, "ms": ms,
                     "path": path, "counts": [int(c.reshape(-1)[0])
                                              for c in counts]}
        del scope
    a, b = runs[f"dp{DP}"], runs["dp1"]
    p, q = runs["plain"], runs["plain2"]
    loss_bad, grad_bad, worst = [], [], (0.0, "")
    for i, (x, y) in enumerate(zip(a["losses"], b["losses"])):
        bound = max(SRL_DP_SPREAD * abs(p["losses"][i] - q["losses"][i]),
                    SRL_DP_FLOOR * abs(y))
        if abs(x - y) > bound:
            loss_bad.append((i, x, y, bound))
    for nm, x, y, g, h in zip(names, a["grads"], b["grads"], p["grads"],
                              q["grads"]):
        err = (x - y).abs().max().item()
        bound = max(SRL_DP_SPREAD * (g - h).abs().max().item(),
                    SRL_DP_FLOOR * y.abs().max().item())
        worst = max(worst, (err / max(bound, 1e-30), nm))
        if err > bound:
            grad_bad.append((nm, err, bound))
    # chunk_eval's dp rule alone, on one decoded path fed at dp 1 and DP
    fed = {"path": b["path"], "target": feed["target"].cpu().numpy(),
           "length": feed["length"].cpu().numpy()}
    fed_counts = {}
    for tag, places in (("dp1", one), (f"dp{DP}", many)):
        prog = fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(
                prog, fluid.Program()):
            L = fluid.layers
            pv, tv = (L.data(n, shape=[SRL_BATCH, SRL_LEN], dtype="int64",
                             append_batch_size=False)
                      for n in ("path", "target"))
            lv = L.data("length", shape=[SRL_BATCH], dtype="int64",
                        append_batch_size=False)
            res = L.chunk_eval(pv, tv, "IOB", SRL_CHUNK_TYPES,
                               seq_length=lv)
        fed_counts[tag] = [float(np.asarray(r).reshape(-1)[0]) for r in
                           exe.run(fluid.CompiledProgram(prog)
                                   .with_data_parallel(places=places),
                                   feed=fed, fetch_list=list(res))]
    # the ragged sequence_expand refuses under dp
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                        fluid.Program()):
        L = fluid.layers
        xv = L.data("x", shape=[4, 3], dtype="float32",
                    append_batch_size=False)
        yv = L.data("y", shape=[6, 3], dtype="float32",
                    append_batch_size=False)
        ylv = L.data("ylen", shape=[4], dtype="int64",
                     append_batch_size=False)
        ex = L.sequence_expand(xv, yv, y_length=ylv)
    refused = None
    try:
        exe.run(fluid.CompiledProgram(prog).with_data_parallel(places=many),
                feed={"x": np.ones((4, 3), np.float32),
                      "y": np.zeros((6, 3), np.float32),
                      "ylen": np.array([1, 2, 2, 1], np.int64)},
                fetch_list=[ex])
    except NotImplementedError as err:
        refused = str(err)
    out = {"losses": {t: r["losses"] for t, r in runs.items()},
           "step_ms": {t: r["ms"] for t, r in runs.items()},
           "grad_worst_over_bound": list(worst),
           "chunk_counts": {t: r["counts"] for t, r in runs.items()},
           "paths_equal_dp": bool((a["path"] == b["path"]).all()),
           "fed_path_chunk_outputs": fed_counts,
           "ragged_expand_refused": refused, "card": _card_line()}
    print("srl dp " + json.dumps(out))
    if loss_bad or grad_bad:
        _fail(f"srl dp: dp {DP} against dp 1 beyond the bounds: losses "
              f"{loss_bad}, @GRADs {grad_bad[:5]}")
    if a["counts"] != b["counts"] or fed_counts["dp1"] != fed_counts[
            f"dp{DP}"]:
        _fail(f"srl dp: chunk_eval's counts differ: {out['chunk_counts']}, "
              f"{fed_counts} (paths equal: {out['paths_equal_dp']})")
    if refused is None:
        _fail("srl dp: a ragged sequence_expand ran at dp > 1")
    return out


def build_ocr():
    """(main, startup, vars): ocr_recognition.crnn_ctc_net at OCR_IMG,
    OCR_CLASSES classes, hidden OCR_HIDDEN, base_filters OCR_FILTERS, its
    warpctc loss over labels of their own lengths (build_train_net gives
    every label the full label_len, so the phase feeds the lengths), the
    greedy transcription and its edit distance to the labels, and
    AdamOptimizer(OCR_LR)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import ocr_recognition as ocr
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 28
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        images = L.data("pixels", shape=list(OCR_IMG), dtype="float32")
        label = L.data("label", shape=[OCR_LABEL_LEN], dtype="int64")
        lab_len = L.data("label_len", shape=[1], dtype="int64")
        logits = ocr.crnn_ctc_net(images, OCR_CLASSES, OCR_HIDDEN,
                                  OCR_FILTERS)
        loss = L.mean(L.warpctc(logits, label, blank=0,
                                label_length=lab_len))
        decoded, dec_len = ocr.greedy_transcribe(logits)
        dist, _num = L.edit_distance(decoded, label, normalized=False,
                                     input_length=dec_len,
                                     label_length=lab_len)
        fluid.optimizer.AdamOptimizer(OCR_LR).minimize(loss)
    return main, startup, {"loss": loss, "logits": logits,
                           "decoded": decoded, "dec_len": dec_len,
                           "dist": dist}


def ocr_feed(device="cuda"):
    """OCR_BATCH random images and labels of 4-OCR_LABEL_LEN ids in
    1..OCR_CLASSES (0 past each length), from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 28)
    lens = torch.randint(4, OCR_LABEL_LEN + 1, (OCR_BATCH, 1),
                         generator=gen, device=device)
    label = torch.randint(1, OCR_CLASSES + 1, (OCR_BATCH, OCR_LABEL_LEN),
                          generator=gen, device=device)
    label = label * (torch.arange(OCR_LABEL_LEN, device=device)[None]
                     < lens)
    return {"pixels": torch.rand((OCR_BATCH,) + OCR_IMG, generator=gen,
                                 device=device),
            "label": label, "label_len": lens}


def phase_ocr():
    """Phase 28d: CRNN-CTC (build_ocr; the conv tower gives 48 columns of
    384 features), OCR_STEPS Adam steps on one batch of OCR_BATCH: the
    last loss below OCR_MARGIN x the first; then on the clone(for_test=
    True) Program the greedy transcription (-1-padded: each row's count
    equals its non -1 entries) and its edit distance to the labels.
    The port's warpctc recursion against F.ctc_loss (reduction none) on
    the trained log-probs, feasible rows within OCR_CTC_RTOL, and both
    ops' ms; the bidirectional GRU's two gru ops against a cuDNN
    torch.nn.GRU of the same width, forward and forward + backward (both
    library calls timed only, used nowhere on the path)."""
    import paddle_tpu_torch as fluid
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import ctc_ops
    main, startup, v = build_ocr()
    feed = ocr_feed()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    outs, ms = _timed_steps(exe, main, feed, [v["loss"]], scope, OCR_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]
    test = main.clone(for_test=True)
    logits, dec, dlen, dist = exe.run(
        test, feed=feed, scope=scope, return_numpy=False,
        fetch_list=[v["logits"], v["decoded"], v["dec_len"], v["dist"]])
    counts_ok = bool(((dec != -1).sum(1) == dlen.reshape(-1)).all())
    # the CTC recursion against the library's on the same log-probs
    lp = torch.log_softmax(logits.float(), dim=-1)
    b, t = lp.shape[:2]
    in_len = torch.full((b,), t, dtype=torch.int64, device=lp.device)
    lab_len = feed["label_len"].reshape(-1)
    mine = ctc_ops.ctc_loss(lp, feed["label"], in_len, lab_len)
    lib = F.ctc_loss(lp.transpose(0, 1), feed["label"], in_len, lab_len,
                     blank=0, reduction="none", zero_infinity=False)
    feasible = torch.isfinite(lib)
    ctc_err = float(((mine - lib).abs() / lib.abs())[feasible].max())
    ctc_ms = _event_ms(lambda: ctc_ops.ctc_loss(lp, feed["label"], in_len,
                                                lab_len))
    lib_ms = _event_ms(lambda: F.ctc_loss(
        lp.transpose(0, 1), feed["label"], in_len, lab_len, blank=0,
        reduction="none"))
    gru = _gru_times(b, t, 3 * OCR_HIDDEN, OCR_HIDDEN)
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[
        v["loss"]], scope=scope), OCR_PROFILE_STEPS)
    out = _seq_record(
        "ocr", f"ocr_recognition.crnn_ctc_net(img {OCR_IMG}, "
        f"num_classes={OCR_CLASSES}, hidden={OCR_HIDDEN}, base_filters="
        f"{OCR_FILTERS}) + warpctc (labels 4-{OCR_LABEL_LEN}), "
        f"Adam({OCR_LR}), f32", OCR_BATCH, ms[2:], peak, prof,
        columns=t, loss_first=losses[0], loss_last=losses[-1],
        loss_ratio=losses[-1] / losses[0], losses=losses,
        decoded_counts_match_non_pad=counts_ok,
        decoded_len_mean=float(dlen.float().mean()),
        edit_distance_mean=float(dist.float().mean()),
        warpctc_vs_f_ctc_loss_max_rel_err=ctc_err,
        feasible_rows=int(feasible.sum()),
        warpctc_fwd_ms=ctc_ms, f_ctc_loss_fwd_ms=lib_ms, gru=gru)
    if not losses[-1] < OCR_MARGIN * losses[0]:
        _fail(f"ocr: the last loss {losses[-1]} is not below {OCR_MARGIN} "
              f"x the first {losses[0]}")
    if not counts_ok or not feasible.all() or ctc_err > OCR_CTC_RTOL:
        _fail(f"ocr: decoded counts {counts_ok}, warpctc against "
              f"F.ctc_loss {ctc_err} over {int(feasible.sum())} feasible "
              f"rows (tolerance {OCR_CTC_RTOL})")
    return out


def _gru_times(b, t, d, h):
    """ms of the port's two gru ops (forward and reverse, the
    bidirectional layer of bigru_stack) on (b, t, d) against a cuDNN
    torch.nn.GRU(d, h, bidirectional=True): forward, and forward +
    backward into the weights."""
    from paddle_tpu_torch.ops import rnn_ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 281)
    x = _rand((b, t, d), gen)
    ws = [(_rand((d, 3 * h), gen) * 0.05).requires_grad_(),
          (_rand((h, 3 * h), gen) * 0.05).requires_grad_(),
          _rand((3 * h,), gen).requires_grad_()]

    def port():
        return [rnn_ops.gru(_OpArgs({"Input": x, "WeightX": ws[0],
                                     "WeightH": ws[1], "Bias": ws[2]},
                                    {"is_reverse": rev}))["Hidden"]
                for rev in (False, True)]

    cudnn = torch.nn.GRU(d, h, batch_first=True, bidirectional=True).cuda()

    def lib():
        return [cudnn(x)[0]]

    return {"shape_b_t_d_h": [b, t, d, h],
            "port_fwd_ms": _event_ms(port),
            "cudnn_fwd_ms": _event_ms(lib),
            "port_fwd_bwd_ms": _event_ms(_fwd_bwd(port, ws)),
            "cudnn_fwd_bwd_ms": _event_ms(_fwd_bwd(
                lib, list(cudnn.parameters())))}


def _lstm_times(b, t, d, h):
    """ms of the port's lstm op on (b, t, d) with ragged lengths against
    a cuDNN torch.nn.LSTM(d, h) on the same input (no lengths): forward,
    and forward + backward into the weights."""
    from paddle_tpu_torch.ops import rnn_ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 282)
    x = _rand((b, t, d), gen)
    lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    ws = [(_rand((d, 4 * h), gen) * 0.05).requires_grad_(),
          (_rand((h, 4 * h), gen) * 0.05).requires_grad_(),
          _rand((4 * h,), gen).requires_grad_()]

    def port():
        return [rnn_ops.lstm(_OpArgs({"Input": x, "WeightX": ws[0],
                                      "WeightH": ws[1], "Bias": ws[2],
                                      "Length": lens}, {}))["Hidden"]]

    cudnn = torch.nn.LSTM(d, h, batch_first=True).cuda()

    def lib():
        return [cudnn(x)[0]]

    return {"shape_b_t_d_h": [b, t, d, h],
            "port_fwd_ms": _event_ms(port),
            "cudnn_fwd_ms": _event_ms(lib),
            "port_fwd_bwd_ms": _event_ms(_fwd_bwd(port, ws)),
            "cudnn_fwd_bwd_ms": _event_ms(_fwd_bwd(
                lib, list(cudnn.parameters())))}


def phase_sentiment():
    """Phase 28e: lstm_text.stacked_lstm_net at the book's widths (emb
    SENT_EMB, hid SENT_HID: each LSTM's hidden is SENT_HID / 4, stacked
    SENT_STACK, alternating direction) on imdb.train()'s 5147-word
    dictionary, SENT_BATCH reviews cut to SENT_LEN, cross entropy,
    Adam(SENT_LR), SENT_STEPS steps on one batch: every loss finite;
    examples/s; one lstm op against a cuDNN torch.nn.LSTM of the same
    width (timed only)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.dataset import imdb
    from paddle_tpu_torch.models import lstm_text
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 28
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        words = L.data("words", shape=[SENT_LEN], dtype="int64")
        seq_len = L.data("seq_len", shape=[1], dtype="int64")
        label = L.data("label", shape=[1], dtype="int64")
        pred = lstm_text.stacked_lstm_net(
            words, seq_len, input_dim=imdb.WORD_DICT_SIZE, class_dim=2,
            emb_dim=SENT_EMB, hid_dim=SENT_HID, stacked_num=SENT_STACK)
        loss = L.mean(L.cross_entropy(pred, label))
        fluid.optimizer.AdamOptimizer(SENT_LR).minimize(loss)
    ids = np.zeros((SENT_BATCH, SENT_LEN), np.int64)
    lens = np.zeros((SENT_BATCH, 1), np.int64)
    labels = np.zeros((SENT_BATCH, 1), np.int64)
    for i, (doc, lab) in zip(range(SENT_BATCH), imdb.train()()):
        n = max(1, min(len(doc), SENT_LEN))
        ids[i, :n], lens[i, 0], labels[i, 0] = doc[:n], n, lab
    feed = {k: torch.from_numpy(a).cuda() for k, a in
            (("words", ids), ("seq_len", lens), ("label", labels))}
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    outs, ms = _timed_steps(exe, main, feed, [loss], scope, SENT_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope), SENT_PROFILE_STEPS)
    out = _seq_record(
        "sentiment", f"lstm_text.stacked_lstm_net(emb_dim={SENT_EMB}, "
        f"hid_dim={SENT_HID}, stacked_num={SENT_STACK}) over imdb's "
        f"{imdb.WORD_DICT_SIZE} words, Adam({SENT_LR}), f32", SENT_BATCH,
        ms[2:], peak, prof, seq_len=SENT_LEN, tokens=int(lens.sum()),
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        lstm=_lstm_times(SENT_BATCH, SENT_LEN, SENT_HID, SENT_HID // 4))
    if not np.isfinite(losses).all():
        _fail(f"sentiment: a loss is not finite: {losses}")
    return out


def phase_recommender():
    """Phase 28e: recommender.build_train_net() at its module widths
    (6041 users, 3953 movies, towers of 200, sequence_conv + sum pools of
    the title and categories, cos_sim), REC_BATCH synthetic ratings from
    the seed, Adam(REC_LR), REC_STEPS steps on one batch: the last loss
    below the first."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import recommender as rec
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 28
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _vars, _infer, loss = rec.build_train_net()
        fluid.optimizer.AdamOptimizer(REC_LR).minimize(loss)
    rng = np.random.default_rng(SEED + 28)
    b = REC_BATCH

    def ids(high, width=1):
        return rng.integers(0, high, (b, width))

    feed = {"user_id": ids(6041), "gender_id": ids(2), "age_id": ids(7),
            "job_id": ids(21), "movie_id": ids(3953),
            "category_ids": ids(19, rec.MAX_CAT_LEN),
            "category_len": rng.integers(1, rec.MAX_CAT_LEN + 1, (b, 1)),
            "title_ids": ids(5175, rec.MAX_TITLE_LEN),
            "title_len": rng.integers(1, rec.MAX_TITLE_LEN + 1, (b, 1))}
    feed = {k: torch.from_numpy(a.astype(np.int64)).cuda()
            for k, a in feed.items()}
    feed["score"] = torch.from_numpy(rng.uniform(1, 5, (b, 1)).astype(
        np.float32)).cuda()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    outs, ms = _timed_steps(exe, main, feed, [loss], scope, REC_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope), REC_PROFILE_STEPS)
    out = _seq_record(
        "recommender", f"recommender.build_train_net() (6041 users, 3953 "
        f"movies), Adam({REC_LR}), f32", REC_BATCH, ms[2:], peak, prof,
        loss_first=losses[0], loss_last=losses[-1], losses=losses)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        _fail(f"recommender: the loss did not fall: {losses}")
    return out


def phase_seq_all(flash, paged):
    """Phases 28-28e. None launches an attention kernel: each is gated
    at 0 flash and paged launches (_seq_phase). Returns (the counts over
    the phases, records)."""
    recs, total = {}, (0, 0, 0, 0, 0)
    for key, name, fn in (
            ("28", "28 SRL train", phase_srl),
            ("28b", "28b SRL card vs CPU", phase_srl_agree),
            ("28c", "28c SRL dp 2", phase_srl_dp),
            ("28d", "28d CRNN-CTC OCR", phase_ocr),
            ("28e sentiment", "28e stacked-LSTM sentiment", phase_sentiment),
            ("28e recommender", "28e recommender", phase_recommender)):
        recs[key], counts = _seq_phase(name, fn, flash, paged)
        total = tuple(x + y for x, y in zip(total, counts))
    return total, recs


# ---------------------------------------------------------------------------
# phases 29-29c: control flow through the Fluid entry points, and
# contrib.decoder's seq2seq at WMT14's widths
# ---------------------------------------------------------------------------

S2S_SRC_EMB, S2S_TRG_EMB = "s2s_src_emb", "s2s_trg_emb"
S2S_OUT_W, S2S_OUT_B = "s2s_out.w", "s2s_out.b"


def _s2s_encoder(fluid, L, batch, length, vocab, width):
    """The source side: an embedding, an fc to 3 x width, a dynamic_gru
    of width over the padded source with its lengths, and its last step
    through an fc with tanh (the decoder's initial state)."""
    src = fluid.data("src", [batch, length], "int64")
    src_len = fluid.data("src_len", [batch], "int64")
    emb = L.embedding(src, size=[vocab, width],
                      param_attr=fluid.ParamAttr(name=S2S_SRC_EMB))
    proj = L.fc(emb, size=3 * width, num_flatten_dims=2,
                param_attr=fluid.ParamAttr(name="s2s_enc_proj.w"),
                bias_attr=fluid.ParamAttr(name="s2s_enc_proj.b"))
    hid = L.dynamic_gru(proj, width, length=src_len,
                        param_attr=fluid.ParamAttr(name="s2s_enc_gru"),
                        bias_attr=fluid.ParamAttr(name="s2s_enc_gru.b"))
    return L.fc(L.sequence_last_step(hid, length=src_len), size=width,
                act="tanh", param_attr=fluid.ParamAttr(name="s2s_enc_out.w"),
                bias_attr=fluid.ParamAttr(name="s2s_enc_out.b"))


def _s2s_cell(fluid, L, dec, encoded, width):
    """The decoder's StateCell: h' = fc(concat([x, h]), width, tanh)."""
    cell = dec.StateCell(inputs={"x": None},
                         states={"h": dec.InitState(init=encoded)},
                         out_state="h")

    @cell.state_updater
    def updater(state_cell):
        nh = L.fc(L.concat([state_cell.get_input("x"),
                            state_cell.get_state("h")], axis=-1),
                  size=width, act="tanh",
                  param_attr=fluid.ParamAttr(name="s2s_dec_step.w"),
                  bias_attr=fluid.ParamAttr(name="s2s_dec_step.b"))
        state_cell.set_state("h", nh)

    return cell


def build_s2s(batch=S2S_BATCH, length=S2S_LEN, vocab=S2S_VOCAB,
              width=S2S_WIDTH):
    """(main, startup, test, vars): the seq2seq of phase 29, trained
    teacher-forced: _s2s_encoder, a TrainingDecoder over the time-major
    ids (T, B) with a target embedding (vocab x width) into _s2s_cell
    and a softmax fc of vocab on each step's state, cross_entropy and
    mean, Adam(S2S_LR). `test` is main before the optimizer (for the
    replay); vars: loss, probs (T, B, vocab)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.contrib import decoder as dec
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        encoded = _s2s_encoder(fluid, L, batch, length, vocab, width)
        tf_ids = fluid.data("tf_ids", [length, batch], "int64")
        labels = fluid.data("labels", [length, batch], "int64")
        cell = _s2s_cell(fluid, L, dec, encoded, width)
        decoder = dec.TrainingDecoder(cell)
        with decoder.block():
            cur = decoder.step_input(tf_ids)
            emb = L.embedding(cur, size=[vocab, width],
                              param_attr=fluid.ParamAttr(name=S2S_TRG_EMB))
            cell.compute_state(inputs={"x": emb})
            decoder.output(L.fc(
                cell.get_state("h"), size=vocab, act="softmax",
                param_attr=fluid.ParamAttr(name=S2S_OUT_W),
                bias_attr=fluid.ParamAttr(name=S2S_OUT_B)))
        probs = decoder()
        loss = L.mean(L.cross_entropy(L.reshape(probs, shape=[-1, vocab]),
                                      L.reshape(labels, shape=[-1, 1])))
        test = main.clone(for_test=True)
        fluid.optimizer.AdamOptimizer(S2S_LR).minimize(loss)
    return main, startup, test, {"loss": loss, "probs": probs}


def build_s2s_beam(batch=S2S_BATCH, length=S2S_LEN, vocab=S2S_VOCAB,
                   width=S2S_WIDTH):
    """(main, ids, scores): BeamSearchDecoder(beam_size=S2S_BEAM,
    max_len=length, end_id=S2S_END, length_penalty=0) from the same
    encoder and cell, the embedding and score head named as phase 29's,
    so that it reads phase 29's parameters by name."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.contrib import decoder as dec
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        encoded = _s2s_encoder(fluid, L, batch, length, vocab, width)
        init_ids = fluid.data("init_ids", [batch], "int64")
        init_scores = fluid.data("init_scores", [batch, 1], "float32")
        bsd = dec.BeamSearchDecoder(
            _s2s_cell(fluid, L, dec, encoded, width), init_ids, init_scores,
            target_dict_dim=vocab, word_dim=width, max_len=length,
            beam_size=S2S_BEAM, end_id=S2S_END, length_penalty=0.0,
            emb_param_attr=fluid.ParamAttr(name=S2S_TRG_EMB),
            score_param_attr=fluid.ParamAttr(name=S2S_OUT_W),
            score_bias_attr=fluid.ParamAttr(name=S2S_OUT_B))
        bsd.decode()
        ids, scores = bsd()
    return main, ids, scores


def s2s_feed(batch=S2S_BATCH, length=S2S_LEN, device="cuda"):
    """The first `batch` pairs of wmt14.train() (16-32 words each, ids of
    its 30000-word dictionaries): the source padded to `length` with its
    lengths; the target time-major, teacher-forced (<s>, then the target)
    and as labels (the target, then <e>), cut to `length` and padded with
    <e>; the beam's start ids (<s>) and scores. int64 / f32 tensors on
    `device`."""
    from paddle_tpu_torch.dataset import wmt14
    src = np.zeros((batch, length), np.int64)
    lens = np.zeros(batch, np.int64)
    tf = np.full((length, batch), S2S_END, np.int64)
    lab = np.full((length, batch), S2S_END, np.int64)
    for i, (s, t, _) in zip(range(batch), wmt14.train(S2S_VOCAB)()):
        n = min(len(s), length)
        src[i, :n], lens[i] = s[:n], n
        seq = np.concatenate([[S2S_BOS], t])[:length]
        tf[:len(seq), i] = seq
        out = np.concatenate([t, [S2S_END]])[:length]
        lab[:len(out), i] = out
    feed = {"src": src, "src_len": lens, "tf_ids": tf, "labels": lab,
            "init_ids": np.full(batch, S2S_BOS, np.int64),
            "init_scores": np.zeros((batch, 1), np.float32)}
    return {k: torch.from_numpy(v).to(device) for k, v in feed.items()}


def _pick(feed, *names):
    return {n: feed[n] for n in names}


def _dispatch_syncs(exe, program, feed, fetch, scope):
    """The file:line of each host sync torch reported in one dispatch of
    `program` (run_async's half of a step: the ops walked, the launches
    queued, feeds through pinned memory); the step is then finished."""
    _, where = _count_syncs(lambda: exe._dispatch(
        program, feed, fetch, scope, in_flight=True))
    torch.cuda.synchronize()
    return where


def phase_s2s():
    """Phase 29: contrib.decoder's seq2seq at WMT14's widths (build_s2s:
    vocab S2S_VOCAB, width S2S_WIDTH), S2S_BATCH wmt14.train() pairs
    padded to S2S_LEN, S2S_STEPS Adam steps on a fixed batch. Gates: every
    loss finite, the last 5 steps' mean below the first 5's. Prints the
    host syncs of one training dispatch (not gated), step p50 / p99,
    peak memory and a profile of one step by op (the recurrences' share
    of the operations). Returns (the record, the trained state)."""
    import paddle_tpu_torch as fluid
    main, startup, test, v = build_s2s()
    feed = s2s_feed()
    train_feed = _pick(feed, "src", "src_len", "tf_ids", "labels")
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    params = sum(scope.get(p.name).numel() for p in main.all_parameters())
    torch.cuda.reset_peak_memory_stats()
    outs, ms = _timed_steps(exe, main, train_feed, [v["loss"]], scope,
                            S2S_STEPS)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]
    syncs = _dispatch_syncs(exe, main, train_feed, [v["loss"]], scope)
    prof = _profile_ops(lambda: exe.run(main, feed=train_feed, fetch_list=[
        v["loss"]], scope=scope), S2S_PROFILE_STEPS)
    ops_by = prof.get("device_ops_per_step_by_op") or {}
    ms_by = prof["device_ms_per_step_by_op"]
    rec = _seq_record(
        "s2s", f"seq2seq: embedding {S2S_VOCAB} x {S2S_WIDTH}, fc 3 x "
        f"{S2S_WIDTH}, dynamic_gru {S2S_WIDTH}, TrainingDecoder over "
        f"StateCell fc(concat([x, h]), {S2S_WIDTH}, tanh), softmax fc "
        f"{S2S_VOCAB}, Adam({S2S_LR}), f32", S2S_BATCH, ms[2:], peak, prof,
        seq_len=S2S_LEN, params=int(params),
        tokens=int(feed["src_len"].sum()), loss_first=losses[0],
        loss_last=losses[-1], losses=losses,
        syncs_in_a_training_dispatch=len(syncs),
        sync_sites=sorted(set(syncs)),
        decoder_fwd_ms_per_step=ms_by.get("static_rnn", 0.0),
        decoder_fwd_share_of_ops=(ops_by.get("static_rnn", 0)
                                  / prof["device_ops_per_step"]),
        encoder_gru_fwd_share_of_ops=(ops_by.get("gru", 0)
                                      / prof["device_ops_per_step"]))
    if not np.isfinite(losses).all() or \
            not np.mean(losses[-5:]) < np.mean(losses[:5]):
        _fail(f"s2s: losses not finite or not falling: {losses}")
    return rec, (exe, scope, test, v, feed)


def _log_softmax64(p):
    """log_softmax(log(p + 1e-9)) over the last axis, in float64: the
    beam's per-step log-probabilities of a softmax head."""
    lp = np.log(p.astype(np.float64) + 1e-9)
    m = lp.max(-1, keepdims=True)
    return lp - (m + np.log(np.exp(lp - m).sum(-1, keepdims=True)))


def _replay_scores(exe, test, v, feed, scope, ids):
    """Each beam of each row (ids: (B, K, T)) replayed teacher-forced
    through phase 29's Program, one beam rank a run: <s> then its ids,
    the softmax fetched, the float64 sum of the log-probabilities of its
    ids up to and including the first <e>. Returns (B, K) sums and the
    replayed steps."""
    want = np.zeros(ids.shape[:2])
    steps = np.zeros(ids.shape[:2], np.int64)
    for k in range(ids.shape[1]):
        beam = ids[:, k, :].T                       # (T, B)
        rfeed = dict(_pick(feed, "src", "src_len"))
        tf = np.concatenate([np.full((1, beam.shape[1]), S2S_BOS),
                             beam[:-1]])
        rfeed["tf_ids"] = torch.from_numpy(tf).to(feed["src"].device)
        rfeed["labels"] = torch.from_numpy(
            np.ascontiguousarray(beam)).to(feed["src"].device)
        probs = exe.run(test, feed=rfeed, fetch_list=[v["probs"]],
                        scope=scope)[0]
        for b in range(beam.shape[1]):
            row = beam[:, b]
            n = int(np.argmax(row == S2S_END)) + 1 \
                if (row == S2S_END).any() else len(row)
            lp = _log_softmax64(probs[:n, b])
            want[b, k] = lp[np.arange(n), row[:n]].sum()
            steps[b, k] = n
    return want, steps


def phase_s2s_beam(trained):
    """Phase 29b: BeamSearchDecoder(beam_size=S2S_BEAM, max_len=S2S_LEN,
    end_id=S2S_END, length_penalty=0) reading phase 29's trained
    parameters by name, for its S2S_BATCH sources. Gates: the ids are
    (S2S_BATCH, S2S_BEAM, S2S_LEN) in [0, S2S_VOCAB); the scores sorted
    best first; each row's beams (the top one, and the others, whose
    paths run longer on the briefly trained weights) replayed
    teacher-forced through phase 29's Program score (in float64,
    log_softmax(log(p + 1e-9)) of their ids up to and including the
    first end id) within S2S_REPLAY_RTOL of the beam's score. Prints the decode's ms for the batch (p50 of
    S2S_DECODES after one warm), the host syncs of one decode's dispatch
    and a profile of one decode."""
    exe, scope, test, v, feed = trained
    bmain, ids_v, scores_v = build_s2s_beam()
    bfeed = _pick(feed, "src", "src_len", "init_ids", "init_scores")
    fetch = [ids_v, scores_v]
    exe.run(bmain, feed=bfeed, fetch_list=fetch, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    outs, ms = _timed_steps(exe, bmain, bfeed, fetch, scope, S2S_DECODES)
    peak = torch.cuda.max_memory_allocated()
    ids, scores = outs[-1]
    syncs = _dispatch_syncs(exe, bmain, bfeed, fetch, scope)
    prof = _profile_ops(lambda: exe.run(bmain, feed=bfeed, fetch_list=fetch,
                                        scope=scope), 1)
    want_shape = (S2S_BATCH, S2S_BEAM, S2S_LEN)
    if ids.shape != want_shape or ids.min() < 0 or ids.max() >= S2S_VOCAB:
        _fail(f"s2s beam: ids {ids.shape} in [{ids.min()}, {ids.max()}], "
              f"want {want_shape} in [0, {S2S_VOCAB})")
    if (np.diff(scores, axis=1) > 0).any():
        _fail(f"s2s beam: scores not sorted best first: {scores}")
    want, steps = _replay_scores(exe, test, v, feed, scope, ids)
    rel = np.abs(scores - want) / np.maximum(np.abs(want), 1e-30)
    top = ids[:, 0, :]
    rec = _seq_record(
        "s2s beam", f"BeamSearchDecoder(beam_size={S2S_BEAM}, max_len="
        f"{S2S_LEN}, end_id={S2S_END}, length_penalty=0) on phase 29's "
        f"parameters", S2S_BATCH, ms, peak, prof,
        decode_ms_p50=float(np.median(ms)),
        syncs_in_a_decode_dispatch=len(syncs),
        sync_sites=sorted(set(syncs)),
        replay_max_rel_err=float(rel.max()),
        replay_top_beam_max_rel_err=float(rel[:, 0].max()),
        replayed_steps_by_beam_mean=steps.mean(0).tolist(),
        replayed_steps_max=int(steps.max()),
        top_beam_rows_ending_in_end_id=int((top == S2S_END).any(1).sum()),
        top_beam_distinct_ids=int(len(np.unique(top))),
        top_score_mean=float(scores[:, 0].mean()))
    if rel.max() > S2S_REPLAY_RTOL:
        _fail(f"s2s beam: beams' scores against their float64 replay "
              f"{rel.max()} > {S2S_REPLAY_RTOL}: {scores} vs {want}")
    return rec


def _beam_ties(card, cpu, tol):
    """The rows whose beams differ between the card's and the CPU's
    (ids, scores): a row is a near tie when every beam whose ids differ
    has the same score on both within `tol` relative (the two searches
    found equally good beams). Returns (differing rows, near ties)."""
    differ, ties = [], []
    for b in range(card[0].shape[0]):
        beams = np.nonzero((card[0][b] != cpu[0][b]).any(-1))[0]
        if not len(beams):
            continue
        differ.append(b)
        s, t = card[1][b, beams], cpu[1][b, beams]
        if (np.abs(s - t) <= tol * np.abs(t)).all():
            ties.append(b)
    return differ, ties


def phase_s2s_agree():
    """Phase 29c, first half: phase 29's Program and 29b's decoder cut to
    S2S_AGREE (batch, T) at the same widths, one startup scope (run on
    the CPU) copied to the card and to the CPU, TF32 off: the loss within
    S2S_AGREE_LOSS_TOL relative, each @GRAD within S2S_AGREE_GRAD_TOL of
    that gradient's largest entry, the beam ids equal apart from listed
    near ties (_beam_ties with S2S_TIE_TOL). Then the card's step p50,
    peak memory and a profile of one step at that size."""
    import paddle_tpu_torch as fluid
    a = S2S_AGREE
    main, startup, _, v = build_s2s(a["batch"], a["length"])
    bmain, ids_v, scores_v = build_s2s_beam(a["batch"], a["length"])
    feed = s2s_feed(a["batch"], a["length"], "cpu")
    train_feed = _pick(feed, "src", "src_len", "tf_ids", "labels")
    bfeed = _pick(feed, "src", "src_len", "init_ids", "init_scores")
    base = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=base)
    names = [p.name for p in main.all_parameters()]
    runs, card = {}, None
    for where, place in (("card", fluid.CUDAPlace(0)),
                         ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for nm in base.names():
            scope.set(nm, base.get(nm).to(exe.device, copy=True))
        beams = exe.run(bmain, feed=bfeed, fetch_list=[ids_v, scores_v],
                        scope=scope)
        out = exe.run(main, feed=train_feed, fetch_list=[v["loss"]]
                      + [nm + "@GRAD" for nm in names], scope=scope)
        runs[where] = (beams, out[0], out[1:])
        if where == "card":
            card = (exe, scope)
    loss_err = float(np.abs(runs["card"][1] - runs["cpu"][1]).max()
                     / np.abs(runs["cpu"][1]).max())
    grad_errs = {nm: float(np.abs(g - h).max() / np.abs(h).max())
                 for nm, g, h in zip(names, runs["card"][2], runs["cpu"][2])}
    worst = max(grad_errs, key=grad_errs.get)
    differ, ties = _beam_ties(runs["card"][0], runs["cpu"][0], S2S_TIE_TOL)
    exe, scope = card
    cfeed = {k: t.cuda() for k, t in train_feed.items()}
    torch.cuda.reset_peak_memory_stats()
    _, ms = _timed_steps(exe, main, cfeed, [v["loss"]], scope, 5)
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_ops(lambda: exe.run(main, feed=cfeed, fetch_list=[
        v["loss"]], scope=scope), 1)
    rec = _seq_record(
        "s2s agree", dict(a, vocab=S2S_VOCAB, width=S2S_WIDTH), a["batch"],
        ms[2:], peak, prof, loss_rel_err=loss_err,
        grad_worst=[worst, grad_errs[worst]],
        beam_score_max_rel_diff=float(np.max(
            np.abs(runs["card"][0][1] - runs["cpu"][0][1])
            / np.abs(runs["cpu"][0][1]))),
        beam_rows_differ=differ, beam_near_tie_rows=ties)
    if loss_err > S2S_AGREE_LOSS_TOL or \
            grad_errs[worst] > S2S_AGREE_GRAD_TOL or set(differ) - set(ties):
        _fail(f"s2s agree: the card against the CPU: {rec}")
    return rec


def _cf_program(build):
    """build(fluid, layers) in a Program of its own: (main, startup,
    fetch vars)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        res = build(fluid, L)
    return main, startup, list(res) if isinstance(res, (list, tuple)) \
        else [res]


def _cf_case(exe, build, feed=None, steps=1):
    """One construct's Program on the card: (each of `steps` runs'
    fetches as numpy, the host syncs of one more dispatch)."""
    import paddle_tpu_torch as fluid
    main, startup, res = _cf_program(build)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = feed or {}
    outs = [exe.run(main, feed=feed, fetch_list=res, scope=scope)
            for _ in range(steps)]
    return outs, _dispatch_syncs(exe, main, feed, res, scope)


def _cf_while(limit):
    def build(fluid, L):
        i = L.fill_constant((1,), "int64", 0)
        n = L.fill_constant((1,), "int64", limit)
        acc = L.fill_constant((1,), "float32", 0.0)
        c = L.less_than(i, n)
        w = L.While(c)
        with w.block():
            L.assign(acc + L.cast(i, "float32"), acc)
            L.increment(i, 1)
            L.less_than(i, n, cond=c)
        return acc, i
    return build


def _cf_cond(a_val):
    def build(fluid, L):
        a = L.fill_constant((1,), "float32", a_val)
        five = L.fill_constant((1,), "float32", 5.0)
        return L.cond(L.less_than(a, five), lambda: a * 2,
                      lambda: five * 2)
    return build


def _cf_switch_case(fluid, L):
    idx = L.fill_constant((), "int64", 1)
    return L.switch_case(idx, {
        k: (lambda v=v: L.fill_constant((1,), "float32", v))
        for k, v in enumerate((10.0, 20.0, 30.0))})


def _cf_static_rnn(fluid, L):
    x = L.data("x", [4, 2, 3], append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        mem = rnn.memory(shape=[2, 3], value=0.0)
        new = mem + x_t
        rnn.update_memory(mem, new)
        rnn.step_output(new)
    return rnn()


# the Switch schedule: 1.0 while the step counter is below 4, 0.5 below
# 8, else 0.1
CF_SCHEDULE = ((4, 1.0), (8, 0.5), (None, 0.1))


def _cf_schedule(fluid, L):
    step = L.autoincreased_step_counter(begin=1)
    lr = L.create_global_var((1,), 0.0, "float32", persistable=True,
                             name="cf_lr")
    sw = L.Switch()
    with sw.block():
        for bound, value in CF_SCHEDULE:
            case = sw.default() if bound is None else sw.case(
                L.less_than(step, L.fill_constant((1,), "int64", bound)))
            with case:
                L.assign(L.fill_constant((1,), "float32", value), lr)
    return lr, step


def _cf_ifelse(fluid, L):
    x = L.data("x", [4, 1], append_batch_size=False)
    ie = L.IfElse(L.greater_than(x, L.fill_constant((1,), "float32", 0.0)))
    with ie.true_block():
        ie.output(L.scale(ie.input(x), 2.0))
    with ie.false_block():
        ie.output(L.scale(ie.input(x), 1.0, bias=-1.0))
    return ie()[0]


def _cf_dynamic_rnn(fluid, L):
    x = fluid.data("x", [3, 5, 2], "float32")
    lens = fluid.data("len", [3], "int64")
    drnn = L.DynamicRNN()
    with drnn.block():
        cur = drnn.step_input(x, length=lens)
        mem = drnn.memory(shape=[3, 2], value=0.0)
        acc = L.elementwise_add(mem, cur)
        drnn.update_memory(mem, acc)
        drnn.output(acc)
    return drnn()


def _cf_arrays(fluid, L):
    arr = L.array_write(L.fill_constant([2, 3], "float32", 1.0), 0)
    L.array_write(L.fill_constant([2, 3], "float32", 2.0), 1, array=arr)
    out, index = L.tensor_array_to_tensor(arr, axis=1)
    stacked, _ = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
    return out, index, stacked, L.array_length(arr)


def _cf_while_loop(fluid, L):
    i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    s = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    return L.while_loop(cond=lambda i, s: (i < 5.0).reshape(()),
                        body=lambda i, s: [i + 1.0, s + i],
                        loop_vars=[i, s])


def _cf_py_func(fluid, L):
    x = L.data("x", [2, 4], append_batch_size=False)
    out = L.create_global_var([2, 4], 0.0, "float32", name="cf_pyout")
    return L.py_func(lambda a: np.sort(a, axis=-1), x, out)


def _cf_print(fluid, L):
    x = L.fill_constant([2], "float32", 5.0)
    return L.Print(x, message="dbg:"), x


def _check(name, got, want, recs, syncs, iterations=None):
    """One construct's closed-form check and its record."""
    for g, w in zip(got, want):
        if np.asarray(g).shape != np.asarray(w).shape or \
                not np.allclose(g, w, rtol=1e-6, atol=1e-6):
            _fail(f"control flow {name}: got {got}, want {want}")
    recs[name] = {"syncs_a_dispatch": len(syncs),
                  "sync_sites": sorted(set(syncs))}
    if iterations is not None:
        recs[name]["iterations"] = iterations


def _while_host_us(exe):
    """The host µs a While iteration costs: a dispatch of CF_WHILE_LONG
    iterations against one of 10, each the median of three, over the
    iterations between."""
    import paddle_tpu_torch as fluid
    ms = {}
    for limit in (10, CF_WHILE_LONG):
        main, startup, res = _cf_program(_cf_while(limit))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        _, t = _timed_steps(exe, main, {}, res, scope, 4)
        ms[limit] = float(np.median(t[1:]))
    return (ms[CF_WHILE_LONG] - ms[10]) / (CF_WHILE_LONG - 10) * 1e3, ms


def phase_cf_constructs():
    """Phase 29c, second half: each construct of the JAX package's
    control-flow tests on the card, against its closed-form answer:
    While's 45 / 10, cond both ways, switch_case 20, StaticRNN's cumsum,
    a Switch piecewise schedule on autoincreased_step_counter over
    CF_SWITCH_STEPS steps (each step's LR its boundary value), IfElse's
    row merge, DynamicRNN's frozen accumulator, the arrays through
    tensor_array_to_tensor, while_loop's 5 / 10, py_func's sort and
    Print's text. The host syncs of one dispatch of each: StaticRNN,
    DynamicRNN, Switch and IfElse (select) gated at 0; While, cond,
    switch_case, while_loop and py_func printed beside their iteration
    counts. Prints the host µs a While iteration costs."""
    import contextlib
    import io as _io
    import paddle_tpu_torch as fluid
    exe = fluid.Executor()
    recs = {}
    outs, syncs = _cf_case(exe, _cf_while(10))
    _check("While", outs[0], [[45.0], [10]], recs, syncs, 10)
    for a_val, want in ((3.0, 6.0), (7.0, 10.0)):
        outs, syncs = _cf_case(exe, _cf_cond(a_val))
        _check(f"cond({a_val} < 5)", outs[0], [[want]], recs, syncs, 1)
    outs, syncs = _cf_case(exe, _cf_switch_case)
    _check("switch_case", outs[0], [[20.0]], recs, syncs)
    x = np.arange(24).reshape(4, 2, 3).astype("float32")
    outs, syncs = _cf_case(exe, _cf_static_rnn, {"x": x})
    _check("StaticRNN", outs[0], [np.cumsum(x, 0)], recs, syncs, 4)
    outs, syncs = _cf_case(exe, _cf_schedule, steps=CF_SWITCH_STEPS)
    for k, out in enumerate(outs):
        step = k + 1
        want = next(v for b, v in CF_SCHEDULE if b is None or step < b)
        _check("Switch schedule", out, [[want], [step]], recs, syncs)
    x = np.array([[-2.0], [3.0], [0.5], [-0.1]], np.float32)
    outs, syncs = _cf_case(exe, _cf_ifelse, {"x": x})
    _check("IfElse (select)", outs[0], [np.where(x > 0, 2 * x, x - 1)],
           recs, syncs)
    xd = np.random.default_rng(0).standard_normal((3, 5, 2)).astype(
        np.float32)
    lens = np.array([5, 2, 4], np.int64)
    want = np.cumsum(xd, 1) * (np.arange(5)[None, :, None]
                               < lens[:, None, None])
    outs, syncs = _cf_case(exe, _cf_dynamic_rnn, {"x": xd, "len": lens})
    _check("DynamicRNN", outs[0], [want], recs, syncs, 5)
    ones, twos = np.ones((2, 3)), np.full((2, 3), 2.0)
    outs, syncs = _cf_case(exe, _cf_arrays)
    _check("arrays", outs[0], [np.concatenate([ones, twos], 1), [3, 3],
                               np.stack([ones, twos]), 2], recs, syncs)
    outs, syncs = _cf_case(exe, _cf_while_loop)
    _check("while_loop", outs[0], [[5.0], [10.0]], recs, syncs, 5)
    xp = np.array([[3, 1, 2, 0], [9, 7, 8, 6]], np.float32)
    outs, syncs = _cf_case(exe, _cf_py_func, {"x": xp})
    _check("py_func", outs[0], [np.sort(xp, -1)], recs, syncs)
    main, startup, (out, x_var) = _cf_program(_cf_print)
    text = _io.StringIO()
    with contextlib.redirect_stdout(text):
        got = exe.run(main, fetch_list=[out])
    want_text = f"dbg:{x_var.name} shape=(2,) value= [5. 5.]\n"
    if text.getvalue() != want_text:
        _fail(f"control flow Print: printed {text.getvalue()!r}, want "
              f"{want_text!r}")
    _check("Print", got, [[5.0, 5.0]], recs, [])
    recs["Print"]["text"] = text.getvalue()
    us, ms = _while_host_us(exe)
    recs["While"]["host_us_per_iteration"] = us
    recs["While"]["dispatch_ms_by_iterations"] = ms
    out = {"constructs": recs, "card": _card_line()}
    print("control flow " + json.dumps(out))
    synced = [n for n in ("StaticRNN", "Switch schedule", "IfElse (select)",
                          "DynamicRNN") if recs[n]["syncs_a_dispatch"]]
    if synced:
        _fail(f"control flow: host syncs in {synced}: "
              f"{ {n: recs[n] for n in synced} }")
    return out


def phase_cf_all(flash, paged):
    """Phases 29-29c. None launches an attention kernel: each is gated at
    0 flash and paged launches (_seq_phase). Returns (the counts over the
    phases, records)."""
    recs, total = {}, (0, 0, 0, 0, 0)
    (recs["29"], trained), counts = _seq_phase(
        "29 seq2seq train", phase_s2s, flash, paged)
    total = tuple(x + y for x, y in zip(total, counts))
    for key, name, fn, args in (
            ("29b", "29b seq2seq beam search", phase_s2s_beam, (trained,)),
            ("29c agree", "29c seq2seq card vs CPU", phase_s2s_agree, ()),
            ("29c constructs", "29c control-flow constructs",
             phase_cf_constructs, ())):
        recs[key], counts = _seq_phase(name, fn, flash, paged, *args)
        total = tuple(x + y for x, y in zip(total, counts))
    del trained
    return total, recs


# ---------------------------------------------------------------------------
# phases 30-30c: detection through the Fluid entry points
# ---------------------------------------------------------------------------

def _det_program(build, lr=None, loss_at=-1):
    """build() (a detection_demo function) in a fresh Program under a fresh
    unique_name guard, so that two builds name their parameters alike;
    with `lr`, Adam minimizes what build returns at `loss_at`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = build()
        if lr is not None:
            fluid.optimizer.AdamOptimizer(learning_rate=lr).minimize(
                out[loss_at])
    return main, startup, out


def _op_io(program, op_type, slot, output=False):
    op = next(o for o in program.global_block().ops if o.type == op_type)
    return (op.output if output else op.input)(slot)[0]


def ssd_feed(batch=SSD_BATCH, image=SSD_IMAGE, boxes=SSD_BOXES,
             classes=SSD_CLASSES, device="cuda"):
    """Seeded images and `boxes` normalized gt boxes an image (centers
    uniform, sides 0.05-0.5 of the image, clipped to it), labels 1 to
    classes - 1."""
    rng = np.random.RandomState(SEED + 30)
    c = rng.uniform(0.1, 0.9, (batch, boxes, 2))
    half = rng.uniform(0.025, 0.25, (batch, boxes, 2))
    gt = np.clip(np.concatenate([c - half, c + half], -1), 0.0, 1.0)
    feed = {"img": rng.randn(batch, 3, image, image).astype(np.float32),
            "gt_box": gt.astype(np.float32),
            "gt_label": rng.randint(1, classes, (batch, boxes, 1))
            .astype(np.int64)}
    return {k: torch.from_numpy(v).to(device) for k, v in feed.items()}


def phase_ssd():
    """Phase 30: build_ssd_net at SSD300's width, SSD_STEPS Adam steps on
    one seeded batch. Gates: every loss finite, the last 3 steps' mean
    below the first 3's, 0 host syncs in a training dispatch. Prints step
    p50 / p99, images/s, device ms and operations, busy share, peak
    memory and the top ops. Returns (the record, the scope and feed)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import detection_demo
    main, startup, out = _det_program(
        lambda: detection_demo.build_ssd_net(
            num_classes=SSD_CLASSES, image_size=SSD_IMAGE,
            max_boxes=SSD_BOXES), lr=SSD_LR, loss_at=3)
    loss = out[3]
    feed = ssd_feed()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    first, box = exe.run(main, feed=feed, scope=scope, fetch_list=[
        loss, _op_io(main, "ssd_loss", "PriorBox")])
    outs, ms = _timed_steps(exe, main, feed, [loss], scope, SSD_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(np.asarray(o[0]).reshape(-1)[0])
              for o in [[first]] + outs]
    syncs = _dispatch_syncs(exe, main, feed, [loss], scope)
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope), SSD_PROFILE_STEPS)
    rec = _seq_record(
        "ssd", f"build_ssd_net(num_classes={SSD_CLASSES}, image_size="
        f"{SSD_IMAGE}, max_boxes={SSD_BOXES}), Adam({SSD_LR}), f32",
        SSD_BATCH, ms[1:], peak, prof, priors=int(box.shape[0]),
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        syncs_in_a_training_dispatch=len(syncs),
        sync_sites=sorted(set(syncs)))
    if box.shape[0] != 7942:
        _fail(f"ssd: {box.shape[0]} priors, want 7942")
    if not np.isfinite(losses).all() or \
            not np.mean(losses[-3:]) < np.mean(losses[:3]):
        _fail(f"ssd: losses not finite or not falling: {losses}")
    if syncs:
        _fail(f"ssd: host syncs in a training dispatch: {syncs}")
    return rec, (scope, feed)


def _rows_set(rows):
    """An image's valid NMS rows (class >= 0), sorted: its survivor set."""
    rows = np.asarray(rows)
    rows = rows[rows[:, 0] >= 0]
    return rows[np.lexsort(rows.T[::-1])]


def phase_ssd_infer(trained):
    """Phase 30b: build_infer_net at phase 30's width, clone(for_test=True),
    on phase 30's weights and images. Gates: 0 host syncs in a dispatch;
    the card's decoded boxes and class scores (detection_output's NMS
    inputs) within SSD_AGREE_TOL of the CPU run's (the scope copied);
    the NMS op run on the CPU on the card's boxes and scores gives the
    card's (32, 200, 6) rows (classes and survivor sets equal, rows within
    SSD_AGREE_TOL); multiclass_nms_host over csrc/nms.cc keeps each
    image's survivor set and takes the native path. Prints ms a batch,
    device ms, the NMS op's device ms and operations, its host enqueue
    ms, and how many end-to-end rows of the CPU run differ (near ties of
    the top-400 and top-200 cuts, not gated)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.inference import postprocess
    from paddle_tpu_torch.models import detection_demo
    from paddle_tpu_torch.ops import _REGISTRY
    scope, train_feed = trained
    main, _startup, (img, nmsed) = _det_program(
        lambda: detection_demo.build_infer_net(num_classes=SSD_CLASSES,
                                               image_size=SSD_IMAGE))
    test = main.clone(for_test=True)
    missing = [p.name for p in main.all_parameters() if p.name not in scope]
    if missing:
        _fail(f"ssd infer: phase 30's scope lacks {missing}")
    nms_op = next(o for o in test.global_block().ops
                  if o.type == "multiclass_nms")
    bname, sname = nms_op.input("BBoxes")[0], nms_op.input("Scores")[0]
    attrs = dict(nms_op.attrs)
    feed = {"img": train_feed["img"]}
    exe = fluid.Executor()
    fetch = [nmsed, bname, sname]
    out = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
    syncs = _dispatch_syncs(exe, test, feed, [nmsed], scope)
    torch.cuda.reset_peak_memory_stats()
    _, ms = _timed_steps(exe, test, feed, [nmsed], scope,
                         SSD_INFER_RUNS + 1)
    peak = torch.cuda.max_memory_allocated()
    prof = _profile_ops(lambda: exe.run(test, feed=feed, fetch_list=[nmsed],
                                        scope=scope), 2)
    card_out, boxes, probs = out
    # the NMS op alone on the card: the host's enqueue ms and the card's
    nms = _REGISTRY["multiclass_nms"]
    args = _OpArgs({"BBoxes": torch.from_numpy(boxes).cuda(),
                    "Scores": torch.from_numpy(probs).cuda()}, attrs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = nms(args)["Out"]
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    nms_ms = _event_ms(lambda: nms(args), reps=3, warmup=1)
    if not np.array_equal(again.cpu().numpy(), card_out):
        _fail("ssd infer: the NMS op alone differs from the program's")
    # the CPU: the whole program on the copied scope, and the op alone on
    # the card's boxes and scores
    cpu_scope = fluid.Scope()
    for nm in scope.names():
        v = scope.get(nm)
        if isinstance(v, torch.Tensor):
            cpu_scope.set(nm, v.detach().to("cpu", copy=True))
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        test, feed={"img": feed["img"].cpu().numpy()}, fetch_list=fetch,
        scope=cpu_scope)
    net_err = {k: float(np.abs(a - b).max() / np.abs(b).max())
               for k, a, b in (("boxes", boxes, cpu[1]),
                               ("scores", probs, cpu[2]))}
    cpu_nms = nms(_OpArgs({"BBoxes": torch.from_numpy(boxes),
                           "Scores": torch.from_numpy(probs)}, attrs))["Out"]
    cpu_nms = cpu_nms.numpy()
    nms_err = float(np.abs(cpu_nms - card_out).max())
    sets_equal = all(np.array_equal(_rows_set(a)[:, 0], _rows_set(b)[:, 0])
                     and _rows_set(a).shape == _rows_set(b).shape
                     for a, b in zip(card_out, cpu_nms))
    e2e_differ = int(sum(
        _rows_set(a).shape != _rows_set(b).shape or
        bool(np.abs(_rows_set(a) - _rows_set(b)).max() > SSD_AGREE_TOL)
        for a, b in zip(card_out, cpu[0])))
    before = dict(postprocess.PATHS)
    t0 = time.perf_counter()
    host, lod = postprocess.multiclass_nms_host(
        boxes, probs, score_threshold=attrs["score_threshold"],
        nms_threshold=attrs["nms_threshold"], nms_top_k=attrs["nms_top_k"],
        keep_top_k=attrs["keep_top_k"],
        background_label=attrs["background_label"])
    host_ms = (time.perf_counter() - t0) * 1e3
    host_same = all(np.array_equal(_rows_set(card_out[i]),
                                   _rows_set(host[lod[i]:lod[i + 1]]))
                    for i in range(card_out.shape[0]))
    ops_by = prof.get("device_ops_per_step_by_op") or {}
    rec = _seq_record(
        "ssd infer", f"build_infer_net(num_classes={SSD_CLASSES}, "
        f"image_size={SSD_IMAGE}), clone(for_test=True); detection_output "
        f"nms_top_k {attrs['nms_top_k']}, keep_top_k {attrs['keep_top_k']}",
        SSD_BATCH, ms[1:], peak, prof, out_shape=list(card_out.shape),
        detections=int((card_out[..., 0] >= 0).sum()),
        syncs_in_a_dispatch=len(syncs), sync_sites=sorted(set(syncs)),
        card_vs_cpu_net_rel_err=net_err, nms_card_vs_cpu_max_abs=nms_err,
        nms_survivor_sets_equal=sets_equal,
        end_to_end_images_differ_vs_cpu=e2e_differ,
        host_nms_sets_equal=host_same, host_nms_ms=host_ms,
        host_nms_paths={k: postprocess.PATHS[k] - before[k]
                        for k in before},
        nms_device_ms=prof["device_ms_per_step_by_op"].get(
            "multiclass_nms", 0.0),
        nms_device_ops=ops_by.get("multiclass_nms"),
        nms_alone_event_ms=nms_ms, nms_alone_enqueue_ms=enqueue_ms)
    if syncs:
        _fail(f"ssd infer: host syncs in a dispatch: {syncs}")
    if max(net_err.values()) > SSD_AGREE_TOL:
        _fail(f"ssd infer: the card's boxes / scores vs the CPU's: {net_err}")
    if not sets_equal or nms_err > SSD_AGREE_TOL:
        _fail(f"ssd infer: the NMS op on the CPU vs the card: {nms_err}, "
              f"sets equal {sets_equal}")
    if not host_same or postprocess.PATHS["native"] != before["native"] + 1:
        _fail("ssd infer: the host NMS's survivor sets or path differ")
    return rec


def frcnn_feed(batch, image, max_gt, classes, device="cuda", seed=None):
    """Seeded images, max_gt gt boxes an image (corners uniform, sides
    image/25 to image/4, inside the image), labels 1 to classes - 1,
    im_info (image, image, 1)."""
    rng = np.random.RandomState(SEED + 31 if seed is None else seed)
    side = rng.uniform(image / 25, image / 4, (batch, max_gt, 2))
    x0 = rng.uniform(0, 1, (batch, max_gt, 2)) * (image - 1 - side)
    feed = {"img": rng.randn(batch, 3, image, image).astype(np.float32),
            "gt_box": np.concatenate([x0, x0 + side], -1).astype(np.float32),
            "gt_label": rng.randint(1, classes, (batch, max_gt))
            .astype(np.int64),
            "im_info": np.tile(np.array([image, image, 1.0], np.float32),
                               (batch, 1))}
    return {k: torch.from_numpy(v).to(device) for k, v in feed.items()}


def phase_frcnn():
    """Phase 30c, first half: build_faster_rcnn_train at FRCNN,
    FRCNN_STEPS Adam steps on one seeded batch. Gates: every loss finite,
    the last 3 steps' mean below the first 3's. Prints the step record
    and the host syncs of one training dispatch (where from)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import detection_demo
    main, startup, out = _det_program(
        lambda: detection_demo.build_faster_rcnn_train(**FRCNN), lr=FRCNN_LR)
    loss = out[-1]
    feed = frcnn_feed(FRCNN["batch"], FRCNN["image_size"], FRCNN["max_gt"],
                      FRCNN["num_classes"])
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.reset_peak_memory_stats()
    first, anchors = exe.run(main, feed=feed, scope=scope, fetch_list=[
        loss, _op_io(main, "anchor_generator", "Anchors", output=True)])
    outs, ms = _timed_steps(exe, main, feed, [loss], scope, FRCNN_STEPS - 1)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(np.asarray(o[0]).reshape(-1)[0])
              for o in [[first]] + outs]
    syncs = _dispatch_syncs(exe, main, feed, [loss], scope)
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope), FRCNN_PROFILE_STEPS)
    rec = _seq_record(
        "frcnn", f"build_faster_rcnn_train({FRCNN}), Adam({FRCNN_LR}), f32",
        FRCNN["batch"], ms[1:], peak, prof,
        anchors_an_image=int(np.prod(anchors.shape[:3])),
        loss_first=losses[0], loss_last=losses[-1], losses=losses,
        syncs_in_a_training_dispatch=len(syncs),
        sync_sites=sorted(set(syncs)))
    if not np.isfinite(losses).all() or \
            not np.mean(losses[-3:]) < np.mean(losses[:3]):
        _fail(f"frcnn: losses not finite or not falling: {losses}")
    return rec


def _iou_np(a, b):
    """(..., M, 4) x (..., G, 4) -> (..., M, G), as the ops compute it."""
    ix1 = np.maximum(a[..., :, None, 0], b[..., None, :, 0])
    iy1 = np.maximum(a[..., :, None, 1], b[..., None, :, 1])
    ix2 = np.minimum(a[..., :, None, 2], b[..., None, :, 2])
    iy2 = np.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)

    def area(x):
        return np.maximum(x[..., 2] - x[..., 0], 0) * \
            np.maximum(x[..., 3] - x[..., 1], 0)

    return inter / np.maximum(area(a)[..., :, None] + area(b)[..., None, :]
                              - inter, 1e-10)


def phase_frcnn_agree():
    """Phase 30c, second half: build_faster_rcnn_train at its demo sizes
    with FRCNN_AGREE (every anchor and roi sampled, so the draws are
    sets), one CPU startup copied to the card and the CPU, one step each.
    Gates: the inputs' IoUs (anchors against 0.3 / 0.7, the CPU's
    proposals and the gt against 0.5) at least FRCNN_MARGIN away; the
    loss within FRCNN_LOSS_TOL relative; each @GRAD within FRCNN_GRAD_TOL
    of its largest entry."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import detection_demo
    main, startup, out = _det_program(
        lambda: detection_demo.build_faster_rcnn_train(**FRCNN_AGREE),
        lr=FRCNN_LR)
    loss = out[-1]
    feed = {k: v.numpy() for k, v in frcnn_feed(2, 64, 4, 5, "cpu").items()}
    base = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=base)
    names = [p.name for p in main.all_parameters()]
    rois = _op_io(main, "generate_proposals", "RpnRois", output=True)
    anchors = _op_io(main, "anchor_generator", "Anchors", output=True)
    runs = {}
    for where, place in (("card", fluid.CUDAPlace(0)),
                         ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for nm in base.names():
            scope.set(nm, base.get(nm).to(exe.device, copy=True))
        runs[where] = exe.run(main, feed=feed, scope=scope, fetch_list=[
            loss, rois, anchors] + [nm + "@GRAD" for nm in names])
    card, cpu = runs["card"], runs["cpu"]
    gt = feed["gt_box"]
    cand = np.concatenate([cpu[1], gt], 1)
    ok = (cand[..., 2] > cand[..., 0]) & (cand[..., 3] > cand[..., 1])
    margin = min(
        float(np.abs(_iou_np(cpu[2].reshape(-1, 4), gt)[..., None]
                     - np.array([0.3, 0.7])).min()),
        float(np.abs(_iou_np(cand, gt)[ok] - 0.5).min()))
    loss_err = float(abs(card[0].reshape(-1)[0] - cpu[0].reshape(-1)[0])
                     / abs(cpu[0].reshape(-1)[0]))
    grad_errs = {nm: float(np.abs(g - h).max() / max(np.abs(h).max(),
                                                       1e-12))
                 for nm, g, h in zip(names, card[3:], cpu[3:])}
    worst = max(grad_errs, key=grad_errs.get)
    out = {"config": FRCNN_AGREE, "iou_margin": margin,
           "loss": float(cpu[0].reshape(-1)[0]), "loss_rel_err": loss_err,
           "grad_worst": [worst, grad_errs[worst]], "card": _card_line()}
    print("frcnn agree " + json.dumps(out))
    if margin < FRCNN_MARGIN:
        _fail(f"frcnn agree: an IoU within {margin} of its threshold")
    if loss_err > FRCNN_LOSS_TOL or grad_errs[worst] > FRCNN_GRAD_TOL:
        _fail(f"frcnn agree: the card against the CPU: {out}")
    return out


def phase_det_all(flash, paged):
    """Phases 30-30c. None launches an attention kernel: each is gated at
    0 flash and paged launches (_seq_phase). Returns (the counts over the
    phases, records)."""
    recs, total = {}, (0, 0, 0, 0, 0)
    (recs["30"], trained), counts = _seq_phase(
        "30 SSD train", phase_ssd, flash, paged)
    total = tuple(x + y for x, y in zip(total, counts))
    for key, name, fn, args in (
            ("30b", "30b SSD detection_output", phase_ssd_infer, (trained,)),
            ("30c", "30c Faster R-CNN train", phase_frcnn, ()),
            ("30c agree", "30c Faster R-CNN card vs CPU", phase_frcnn_agree,
             ())):
        recs[key], counts = _seq_phase(name, fn, flash, paged, *args)
        total = tuple(x + y for x, y in zip(total, counts))
    del trained
    return total, recs


# ---------------------------------------------------------------------------
# phases 31-31g: the vision nets and the activation family
# ---------------------------------------------------------------------------

def _vision_program(build, opt=None, seed=SEED + 31):
    """build() in a fresh Program under a fresh unique_name guard; with
    `opt` (a function of fluid returning an optimizer) it minimizes what
    build returns (the loss). Returns (main, startup, loss)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        loss = build()
        if opt is not None:
            opt(fluid).minimize(loss)
    return main, startup, loss


def _vision_momentum(lr, decay=None):
    def make(fluid):
        reg = fluid.regularizer.L2Decay(decay) if decay else None
        return fluid.optimizer.MomentumOptimizer(lr, MN_MOMENTUM,
                                                 regularization=reg)
    return make


def _vision_adam(lr):
    return lambda fluid: fluid.optimizer.AdamOptimizer(learning_rate=lr)


def _mobilenet(version, image, classes, width_mult=1.0):
    from paddle_tpu_torch.models import mobilenet
    return lambda: mobilenet.build_train_net(
        version=version, class_dim=classes, image_shape=image,
        width_mult=width_mult)[3]


def _images_feed(batch, image, classes, device="cuda", seed=SEED + 31):
    """Standard normal images and labels from `seed`, made on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"img": torch.randn((batch,) + tuple(image), generator=gen,
                               device=device),
            "label": torch.randint(0, classes, (batch, 1), generator=gen,
                                   device=device)}


def _falls(losses):
    return bool(np.isfinite(losses).all()
                and np.mean(losses[-3:]) < np.mean(losses[:3]))


def _train_phase(tag, config, batch, main, startup, loss, feed, warm,
                 steps, profile_steps=0):
    """warm + steps runs of main on one feed from startup: every loss
    finite and the last 3 losses' mean below the first 3's, 0 host syncs
    in a training dispatch. Prints the step record (with a profile by
    op when profile_steps). Returns the record."""
    import paddle_tpu_torch as fluid
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs, ms = _timed_steps(exe, main, feed, [loss], scope, warm + steps)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]
    syncs = _dispatch_syncs(exe, main, feed, [loss], scope)

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    if profile_steps:
        prof = _profile_ops(step, profile_steps)
    else:
        prof = _profile_train(step, 1, flash=False)
    rec = _seq_record(tag, config, batch, ms[warm:], peak, prof,
                      ops=len(main.global_block().ops),
                      loss_first=losses[0], loss_last=losses[-1],
                      losses=losses, syncs_in_a_training_dispatch=len(syncs),
                      sync_sites=sorted(set(syncs)))
    if not _falls(losses):
        _fail(f"{tag}: losses not finite or not falling: {losses}")
    if syncs:
        _fail(f"{tag}: host syncs in a training dispatch: {syncs}")
    return rec


def phase_mobilenet_v2():
    """Phase 31: MobileNet-v2 at ImageNet width (MNV2_*), Momentum(0.1,
    0.9) with L2 4e-5, MNV2_WARM + MNV2_STEPS steps on one seeded batch
    of 64. Gates: every loss finite, the last 3 losses' mean below the
    first 3's, 0 host syncs in a training dispatch. Prints step p50 /
    p99, images/s, device ms, operations, busy share, peak memory and
    the device ms by op type (_profile_ops)."""
    main, startup, loss = _vision_program(
        _mobilenet(2, MNV2_IMAGE, MNV2_CLASSES),
        _vision_momentum(MN_LR, MN_DECAY))
    return _train_phase(
        "mobilenet_v2", f"mobilenet.build_train_net(version=2, class_dim="
        f"{MNV2_CLASSES}, image_shape={MNV2_IMAGE}, width_mult=1.0), "
        f"Momentum({MN_LR}, {MN_MOMENTUM}), L2Decay({MN_DECAY}), f32",
        MNV2_BATCH, main, startup, loss,
        _images_feed(MNV2_BATCH, MNV2_IMAGE, MNV2_CLASSES), MNV2_WARM,
        MNV2_STEPS, MN_PROFILE_STEPS)


def _card_vs_cpu(tag, main, startup, fetch, feed, params, config):
    """One run of main on the card and on the CPU from one CPU startup
    (copied to each): the first fetch (a loss) relative, each of
    `params`' @GRADs' largest difference over the run's largest @GRAD.
    Fails past VISION_LOSS_TOL / VISION_GRAD_TOL. Returns (the record,
    each side's scope)."""
    import paddle_tpu_torch as fluid
    base = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=base)
    grads = [p + "@GRAD" for p in params]
    runs, scopes = {}, {}
    for where, place in (("card", fluid.CUDAPlace(0)),
                         ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for nm in base.names():
            scope.set(nm, base.get(nm).to(exe.device, copy=True))
        runs[where] = exe.run(main, feed=feed, scope=scope,
                              fetch_list=list(fetch) + grads)
        scopes[where] = scope
    card, cpu = runs["card"], runs["cpu"]
    n = len(fetch)
    ref = float(np.asarray(cpu[0]).reshape(-1)[0])
    loss_err = abs(float(np.asarray(card[0]).reshape(-1)[0]) - ref) / abs(ref)
    gmax = max(float(np.abs(h).max()) for h in cpu[n:])
    errs = {g: float(np.abs(a - h).max()) / gmax
            for g, a, h in zip(grads, card[n:], cpu[n:])}
    own = {g: float(np.abs(a - h).max()) / max(float(np.abs(h).max()),
                                                1e-30)
           for g, a, h in zip(grads, card[n:], cpu[n:])}
    worst = max(errs, key=errs.get)
    worst_own = max(own, key=own.get)
    rec = {"config": config, "loss": ref, "loss_rel_err": loss_err,
           "grads": len(grads), "grad_worst_of_step_scale":
               [worst, errs[worst]],
           "grad_worst_of_own_scale": [worst_own, own[worst_own]],
           "card": _card_line()}
    print(f"{tag} agree " + json.dumps(rec))
    if not loss_err <= VISION_LOSS_TOL or not errs[worst] <= VISION_GRAD_TOL:
        _fail(f"{tag} agree: the card against the CPU: {rec}")
    return rec, scopes


def _np_feed(feed):
    return {k: v.cpu().numpy() for k, v in feed.items()}


def phase_mobilenet_v1_agree():
    """Phase 31b: MobileNet v1 at phase 31's width and recipe,
    MNV1_STEPS steps with phase 31's gates; then v2 at MN_AGREE, one
    step on the card and on the CPU from one CPU startup: the loss
    within VISION_LOSS_TOL, every @GRAD within VISION_GRAD_TOL of the
    step's largest."""
    main, startup, loss = _vision_program(
        _mobilenet(1, MNV2_IMAGE, MNV2_CLASSES),
        _vision_momentum(MN_LR, MN_DECAY))
    rec = _train_phase(
        "mobilenet_v1", f"mobilenet.build_train_net(version=1, class_dim="
        f"{MNV2_CLASSES}, image_shape={MNV2_IMAGE}), Momentum({MN_LR}, "
        f"{MN_MOMENTUM}), L2Decay({MN_DECAY}), f32", MNV2_BATCH, main,
        startup, loss, _images_feed(MNV2_BATCH, MNV2_IMAGE, MNV2_CLASSES),
        0, MNV1_STEPS)
    a = MN_AGREE
    main, startup, loss = _vision_program(
        _mobilenet(2, a["image"], 10, a["width_mult"]),
        _vision_momentum(MN_LR, MN_DECAY))
    agree, _ = _card_vs_cpu(
        "mobilenet_v2", main, startup, [loss],
        _np_feed(_images_feed(a["batch"], a["image"], 10, "cpu")),
        [p.name for p in main.all_parameters()], f"v2 at {a}")
    return {"v1": rec, "v2_agree": agree}


def _deeplab(image, classes, filters):
    from paddle_tpu_torch.models import deeplab
    return lambda: deeplab.build_train_net(
        img_shape=(3, image, image), num_classes=classes,
        base_filters=filters)[2]


def deeplab_feed(batch, image, classes, device="cuda", seed=SEED + 32):
    """Seeded images and labels constant over 32 x 32 blocks (a pattern
    the net can fit)."""
    rng = np.random.RandomState(seed)
    blocks = -(-image // 32)
    lab = np.kron(rng.randint(0, classes, (batch, blocks, blocks)),
                  np.ones((32, 32), np.int64))[:, :image, :image]
    feed = {"pixels": rng.rand(batch, 3, image, image).astype(np.float32),
            "label": np.ascontiguousarray(lab).astype(np.int64)}
    return {k: torch.from_numpy(v).to(device) for k, v in feed.items()}


def phase_deeplab():
    """Phase 31c: DeepLabv3+ at PASCAL VOC's crop (DL_*), Adam(1e-3),
    DL_STEPS steps on one seeded batch of 8: phase 31's gates; then at
    DL_AGREE one step on the card and on the CPU from one startup."""
    main, startup, loss = _vision_program(
        _deeplab(DL_IMAGE, DL_CLASSES, DL_FILTERS), _vision_adam(DL_LR))
    rec = _train_phase(
        "deeplab", f"deeplab.build_train_net(img_shape=(3, {DL_IMAGE}, "
        f"{DL_IMAGE}), num_classes={DL_CLASSES}, base_filters="
        f"{DL_FILTERS}), Adam({DL_LR}), f32", DL_BATCH, main, startup, loss,
        deeplab_feed(DL_BATCH, DL_IMAGE, DL_CLASSES), 0, DL_STEPS)
    a = DL_AGREE
    main, startup, loss = _vision_program(
        _deeplab(a["image"], DL_CLASSES, a["filters"]), _vision_adam(DL_LR))
    agree, _ = _card_vs_cpu(
        "deeplab", main, startup, [loss],
        _np_feed(deeplab_feed(a["batch"], a["image"], DL_CLASSES, "cpu")),
        [p.name for p in main.all_parameters()], f"deeplab at {a}")
    return {"train": rec, "agree": agree}


def _tsm(seg, image, classes, base, blocks):
    def build():
        from paddle_tpu_torch import layers
        from paddle_tpu_torch.models import tsm
        video = layers.data("video", shape=[seg, 3, image, image],
                            dtype="float32")
        label = layers.data("label", shape=[1], dtype="int64")
        logits = tsm.tsm_net(video, seg, classes, base_ch=base,
                             num_blocks=blocks)
        return layers.mean(layers.softmax_with_cross_entropy(logits,
                                                             label))
    return build


def tsm_feed(batch, seg, image, classes, device="cuda", seed=SEED + 33):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"video": torch.randn((batch, seg, 3, image, image),
                                 generator=gen, device=device),
            "label": torch.randint(0, classes, (batch, 1), generator=gen,
                                   device=device)}


def phase_tsm():
    """Phase 31d: TSM at Kinetics width (TSM_*), Momentum(0.01, 0.9),
    TSM_STEPS steps on 4 seeded videos: phase 31's gates; then at
    TSM_AGREE one step on the card and on the CPU from one startup."""
    main, startup, loss = _vision_program(
        _tsm(TSM_SEG, TSM_IMAGE, TSM_CLASSES, TSM_BASE, TSM_BLOCKS),
        _vision_momentum(TSM_LR))
    ops = main.global_block().ops
    shifts = sum(op.type == "temporal_shift" for op in ops)
    if shifts != sum(TSM_BLOCKS):
        _fail(f"tsm: {shifts} temporal_shift ops, want {sum(TSM_BLOCKS)}")
    rec = _train_phase(
        "tsm", f"tsm.tsm_net(seg_num={TSM_SEG}, {TSM_IMAGE}², class_dim="
        f"{TSM_CLASSES}, base_ch={TSM_BASE}, num_blocks={TSM_BLOCKS}), "
        f"Momentum({TSM_LR}, {MN_MOMENTUM}), f32", TSM_BATCH, main,
        startup, loss, tsm_feed(TSM_BATCH, TSM_SEG, TSM_IMAGE, TSM_CLASSES),
        0, TSM_STEPS)
    a = TSM_AGREE
    main, startup, loss = _vision_program(
        _tsm(a["seg"], a["image"], 10, a["base"], a["blocks"]),
        _vision_momentum(TSM_LR))
    agree, _ = _card_vs_cpu(
        "tsm", main, startup, [loss],
        _np_feed(tsm_feed(a["batch"], a["seg"], a["image"], 10, "cpu")),
        [p.name for p in main.all_parameters()], f"tsm at {a}")
    return {"train": rec, "agree": agree, "temporal_shifts": shifts}


def _gan_programs():
    """build_gan's D and G Programs under one fresh startup, each with
    Adam(GAN_LR) over its own tower's parameters."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import gan
    startup = fluid.Program()
    startup.random_seed = SEED + 34
    with unique_name.guard(), fluid.program_guard(fluid.Program(),
                                                  startup):
        nets = gan.build_gan(batch_size=GAN_BATCH)
        for prog, loss, params in (("d_program", "d_loss", "d_params"),
                                   ("g_program", "g_loss", "g_params")):
            nets[prog].random_seed = SEED + 34
            with fluid.program_guard(nets[prog]):
                fluid.optimizer.AdamOptimizer(learning_rate=GAN_LR).minimize(
                    nets[loss], parameter_list=nets[params])
    return nets, startup


def gan_feeds(step, device="cuda"):
    """Step `step`'s seeded real images (in [-1, 1]) and D / G noise."""
    rng = np.random.RandomState(SEED + 340 + step)
    feeds = {"d": {"img": rng.uniform(-1, 1, (GAN_BATCH, 1, 28, 28)),
                   "noise": rng.randn(GAN_BATCH, 100)},
             "g": {"noise": rng.randn(GAN_BATCH, 100)}}
    return {k: {n: torch.from_numpy(v.astype(np.float32)).to(device)
                for n, v in f.items()} for k, f in feeds.items()}


def phase_gan():
    """Phase 31e: DCGAN at its width, GAN_STEPS alternating D and G Adam
    steps on seeded batches of 32: both losses finite at every step, 0
    host syncs in a D and in a G dispatch; then the first D step and the
    first G step after it on the card and on the CPU from one startup:
    each loss within VISION_LOSS_TOL, its tower's @GRADs within
    VISION_GRAD_TOL of the step's largest."""
    import paddle_tpu_torch as fluid
    nets, startup = _gan_programs()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    d_losses, g_losses, ms = [], [], []
    for i in range(GAN_STEPS):
        f = gan_feeds(i)
        t0 = time.perf_counter()
        d, = exe.run(nets["d_program"], feed=f["d"],
                     fetch_list=[nets["d_loss"]], scope=scope)
        g, = exe.run(nets["g_program"], feed=f["g"],
                     fetch_list=[nets["g_loss"]], scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        d_losses.append(float(np.asarray(d).reshape(-1)[0]))
        g_losses.append(float(np.asarray(g).reshape(-1)[0]))
    f = gan_feeds(GAN_STEPS)
    syncs = _dispatch_syncs(exe, nets["d_program"], f["d"],
                            [nets["d_loss"]], scope) + _dispatch_syncs(
        exe, nets["g_program"], f["g"], [nets["g_loss"]], scope)
    # the first D then G step on each side from one CPU startup
    base = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=base)
    f0 = {k: _np_feed(v) for k, v in gan_feeds(0, "cpu").items()}
    runs = {}
    for where, place in (("card", fluid.CUDAPlace(0)),
                         ("cpu", fluid.CPUPlace())):
        e = fluid.Executor(place)
        sc = fluid.Scope()
        for nm in base.names():
            sc.set(nm, base.get(nm).to(e.device, copy=True))
        runs[where] = [e.run(nets[prog], feed=f0[key], scope=sc,
                             fetch_list=[nets[loss]] + [
                                 p + "@GRAD" for p in nets[params]])
                       for prog, key, loss, params in (
                           ("d_program", "d", "d_loss", "d_params"),
                           ("g_program", "g", "g_loss", "g_params"))]
    errs = {}
    for i, tower in enumerate(("d", "g")):
        card, cpu = runs["card"][i], runs["cpu"][i]
        ref = float(np.asarray(cpu[0]).reshape(-1)[0])
        gmax = max(float(np.abs(h).max()) for h in cpu[1:])
        errs[tower] = [abs(float(np.asarray(card[0]).reshape(-1)[0]) - ref)
                       / abs(ref),
                       max(float(np.abs(a - h).max()) / gmax
                           for a, h in zip(card[1:], cpu[1:]))]
    rec = {"config": f"gan.build_gan(), ngf / ndf 64, NOISE_DIM 100, "
                     f"batch {GAN_BATCH}, Adam({GAN_LR}) each tower, f32",
           "steps": GAN_STEPS, "d_losses": d_losses, "g_losses": g_losses,
           "d_plus_g_ms_p50": float(np.percentile(ms[1:], 50)),
           "syncs_in_d_and_g_dispatches": len(syncs),
           "first_steps_card_vs_cpu_loss_grad": errs, "card": _card_line()}
    print("gan " + json.dumps(rec))
    if not (np.isfinite(d_losses).all() and np.isfinite(g_losses).all()):
        _fail(f"gan: losses not finite: {rec}")
    if syncs:
        _fail(f"gan: host syncs in a dispatch: {syncs}")
    if any(e[0] > VISION_LOSS_TOL or e[1] > VISION_GRAD_TOL
           for e in errs.values()):
        _fail(f"gan: the card against the CPU: {errs}")
    return rec


def _book_nets():
    """(name, build, optimizer, feed, steps) of each book net at the JAX
    tests' sizes: VGG-16-bn on CIFAR-10's shapes (batch 128, dropout on),
    fit_a_line
    (uci_housing's 13 features, 64 rows), word2vec (a 100-word
    dictionary, batch 16), SimNet bow and cnn (vocabulary 200, 12
    tokens, 32 triples)."""
    from paddle_tpu_torch.models import fit_a_line, simnet, vgg, word2vec
    rng = np.random.RandomState(SEED + 35)
    q = rng.randint(1, 200, (32, 12))
    pos = rng.randint(1, 200, (32, 12))
    pos[:, :6] = q[:, :6]
    lens = np.full((32, 1), 12)
    triples = {"q_ids": q, "q_len": lens, "p_ids": pos, "p_len": lens,
               "n_ids": rng.randint(1, 200, (32, 12)), "n_len": lens}
    w_true = rng.randn(13, 1)
    xs = rng.randn(64, 13)
    # CIFAR-sized images that carry their class: a fixed pattern a class
    # under noise
    labels = rng.randint(0, 10, (128, 1))
    images = rng.randn(10, 3, 32, 32)[labels[:, 0]] \
        + 0.5 * rng.randn(128, 3, 32, 32)
    nets = [
        ("vgg16_bn_cifar10", lambda: vgg.build_train_net(class_dim=10)[3],
         _vision_adam(1e-3), {"img": images.astype(np.float32), "label": labels},
         VGG_STEPS),
        ("fit_a_line", lambda: fit_a_line.build_train_net()[3],
         lambda fluid: fluid.optimizer.SGDOptimizer(0.05),
         {"x": xs.astype(np.float32),
          "y": (xs @ w_true + 0.01 * rng.randn(64, 1)).astype(np.float32)},
         BOOK_STEPS),
        ("word2vec", lambda: word2vec.build_train_net(100)[3], _vision_adam(1e-3),
         dict({f"word_{i}": rng.randint(0, 100, (16, 1)) for i in range(4)},
              next_word=rng.randint(0, 100, (16, 1))), BOOK_STEPS)]
    for tower in ("bow", "cnn"):
        nets.append((f"simnet_{tower}", lambda t=tower: simnet.
                     build_pairwise_net(vocab_size=200, max_len=12,
                                        tower=t)[1], _vision_adam(5e-3), triples,
                     BOOK_STEPS))
    return nets


def phase_book():
    """Phase 31f: each book net its steps (BOOK_STEPS, VGG_STEPS) on one
    batch on the card: every loss finite, the last 3 losses' mean below
    the first 3's."""
    import paddle_tpu_torch as fluid
    recs = {}
    for name, build, opt, feed, steps in _book_nets():
        main, startup, loss = _vision_program(build, opt)
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        dev = {k: torch.from_numpy(np.asarray(v)).to("cuda")
               for k, v in feed.items()}
        outs, ms = _timed_steps(exe, main, dev, [loss], scope, steps)
        losses = [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]
        recs[name] = {"ops": len(main.global_block().ops),
                      "step_ms_p50": float(np.percentile(ms[1:], 50)),
                      "loss_first": losses[0], "loss_last": losses[-1]}
        if not _falls(losses):
            _fail(f"book {name}: losses not finite or not falling: "
                  f"{losses}")
    recs["card"] = _card_line()
    print("book " + json.dumps(recs))
    return recs


# the 70 ops this slice registers
SLICE_OPS = (
    "abs acos asin atan brelu elu erf hard_shrink hard_sigmoid hard_swish "
    "leaky_relu log_softmax logsigmoid maxout mish pow prelu reciprocal "
    "relu6 round rsqrt selu sin soft_relu softplus softshrink softsign "
    "stanh swish tanh_shrink thresholded_relu "
    "conv2d_transpose depthwise_conv2d_transpose conv3d conv3d_transpose "
    "pool3d adaptive_pool3d max_pool2d_with_index max_pool3d_with_index "
    "unpool spp bilinear_interp nearest_interp trilinear_interp group_norm "
    "instance_norm data_norm spectral_norm lrn affine_channel "
    "temporal_shift grid_sampler affine_grid unfold deformable_conv "
    "deformable_conv_v1 fsp similarity_focus bilinear_tensor_product "
    "l2_normalize norm cumsum "
    "uniform_random_batch_size_like gaussian_random_batch_size_like "
    "truncated_gaussian_random randint sampling_id random_crop multinomial "
    "bernoulli").split()
RANDOM_OPS = SLICE_OPS[-8:]


class _CardCtx(_OpArgs):
    """One direct op call's context on `device`; rng() seeds a generator
    there with `seed`."""

    dp_rank = None
    is_test = False

    def __init__(self, ins, attrs, device, seed=0):
        super().__init__(ins, attrs)
        self.device = device
        self.seed = seed

    def has_in(self, slot):
        return slot in self.ins

    def in_list(self, slot):
        v = self.ins.get(slot, [])
        return v if isinstance(v, list) else [v]

    def is_sharded(self, slot):
        return False

    def rng(self, shared=False):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        return gen


def _slice_op_cases():
    """{op: (inputs as numpy, attrs, output slot, grad slots)} for every
    deterministic op of SLICE_OPS, at small seeded shapes with each
    op's edge: the pools' index ties, padding past the window's half,
    every interpolation mode, grid points off the image, offsets off the
    image."""
    rng = np.random.RandomState(SEED + 36)

    def r(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def away(x, *pts):
        for p in pts:
            x[np.abs(x - p) < 0.05] = p + 0.1
        return x

    x = away(r(4, 6, 5, 5, lo=-3, hi=3), 0.0)
    ties = rng.randint(0, 4, (2, 3, 9, 8)).astype(np.float32)
    cases = {name: ({"X": away(r(4, 6, 5, 5, lo=-3, hi=3), *pts)}, attrs,
                    "Out", ("X",))
             for name, attrs, pts in (
                 ("abs", {}, (0,)), ("atan", {}, ()), ("erf", {}, ()),
                 ("brelu", {"t_min": -1.0, "t_max": 1.0}, (-1, 1)),
                 ("elu", {"alpha": 0.7}, (0,)),
                 ("hard_shrink", {"threshold": 0.4}, (-0.4, 0.4)),
                 ("hard_sigmoid", {}, (-2.5, 2.5)),
                 ("hard_swish", {}, (-3, 3)),
                 ("leaky_relu", {"alpha": 0.1}, (0,)),
                 ("log_softmax", {"axis": 1}, ()), ("logsigmoid", {}, ()),
                 ("mish", {}, ()), ("relu6", {"threshold": 2.0}, (0, 2)),
                 ("round", {}, ()), ("selu", {}, (0,)), ("sin", {}, ()),
                 ("soft_relu", {"threshold": 2.0}, (-2, 2)),
                 ("softplus", {}, ()), ("softshrink", {"lambda": 0.5},
                                        (-0.5, 0.5)),
                 ("softsign", {}, ()), ("stanh", {}, ()),
                 ("swish", {"beta": 1.3}, ()), ("tanh_shrink", {}, ()),
                 ("thresholded_relu", {"threshold": 0.8}, (0.8,)))}
    cases.update({
        "acos": ({"X": r(4, 9, lo=-0.9, hi=0.9)}, {}, "Out", ("X",)),
        "asin": ({"X": r(4, 9, lo=-0.9, hi=0.9)}, {}, "Out", ("X",)),
        "pow": ({"X": r(4, 9, lo=0.2, hi=3)}, {"factor": 2.5}, "Out",
                ("X",)),
        "reciprocal": ({"X": r(4, 9, lo=0.3, hi=3)}, {}, "Out", ("X",)),
        "rsqrt": ({"X": r(4, 9, lo=0.3, hi=3)}, {}, "Out", ("X",)),
        "maxout": ({"X": x}, {"groups": 3}, "Out", ("X",)),
        "prelu": ({"X": x, "Alpha": r(6, lo=0, hi=0.5)},
                  {"mode": "channel"}, "Out", ("X", "Alpha")),
        "conv2d_transpose": ({"Input": r(2, 4, 7, 6), "Filter": r(4, 3, 3, 4),
                              "Bias": r(6)},
                             {"strides": [2, 2], "paddings": [1, 1],
                              "groups": 2}, "Output",
                             ("Input", "Filter", "Bias")),
        "depthwise_conv2d_transpose": (
            {"Input": r(2, 4, 5, 5), "Filter": r(4, 1, 3, 3)},
            {"strides": [2, 2], "paddings": [1, 1], "groups": 4}, "Output",
            ("Input", "Filter")),
        "conv3d": ({"Input": r(2, 3, 5, 6, 6), "Filter": r(4, 3, 3, 3, 2)},
                   {"strides": [1, 2, 1], "paddings": [1, 0, 1],
                    "dilations": [1, 1, 2]}, "Output", ("Input", "Filter")),
        "conv3d_transpose": ({"Input": r(1, 4, 3, 4, 3),
                              "Filter": r(4, 2, 2, 3, 3), "Bias": r(2)},
                             {"strides": [2, 1, 2], "paddings": [0, 1, 1]},
                             "Output", ("Input", "Filter", "Bias")),
        "pool3d": ({"X": r(2, 3, 5, 6, 4)},
                   {"pooling_type": "avg", "ksize": [3, 3, 3],
                    "strides": [2, 2, 1], "paddings": [1, 2, 1]}, "Out",
                   ("X",)),
        "adaptive_pool3d": ({"X": rng.randint(0, 4, (2, 3, 5, 7, 6))
                             .astype(np.float32)},
                            {"pool_size": [2, 3, 4], "pooling_type": "max",
                             "require_index": True}, "Mask", ()),
        "max_pool2d_with_index": ({"X": ties},
                                  {"ksize": [3, 3], "strides": [2, 2],
                                   "paddings": [1, 1]}, "Mask", ()),
        "max_pool3d_with_index": ({"X": rng.randint(0, 4, (2, 2, 5, 4, 5))
                                   .astype(np.float32)},
                                  {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                                   "paddings": [1, 0, 1]}, "Mask", ()),
        "unpool": ({"X": r(2, 3, 3, 4),
                    "Indices": (np.arange(4)[None, :] * 2 + np.arange(
                        3)[:, None] * 16)[None, None].repeat(2, 0).repeat(
                            3, 1).astype(np.int64)},
                   {"ksize": [2, 2], "strides": [2, 2]}, "Out", ("X",)),
        "spp": ({"X": r(2, 3, 7, 9)}, {"pyramid_height": 3}, "Out", ("X",)),
        "bilinear_interp": ({"X": r(2, 3, 5, 6)},
                            {"out_h": 9, "out_w": 13, "align_corners": False,
                             "align_mode": 1}, "Out", ("X",)),
        "nearest_interp": ({"X": r(2, 3, 5, 6)},
                           {"out_h": 9, "out_w": 4}, "Out", ("X",)),
        "trilinear_interp": ({"X": r(1, 2, 3, 4, 5)},
                             {"out_d": 5, "out_h": 3, "out_w": 7,
                              "align_corners": False, "align_mode": 0},
                             "Out", ("X",)),
        "group_norm": ({"X": r(2, 6, 4, 5), "Scale": r(6), "Bias": r(6)},
                       {"groups": 3}, "Y", ("X", "Scale", "Bias")),
        "instance_norm": ({"X": r(2, 3, 4, 5), "Scale": r(3), "Bias": r(3)},
                          {}, "Y", ("X", "Scale", "Bias")),
        "data_norm": ({"X": r(8, 5),
                       "BatchSize": r(5, lo=50, hi=100),
                       "BatchSum": r(5) * 10,
                       "BatchSquareSum": r(5, lo=50, hi=100)},
                      {"summary_decay_rate": 0.9}, "Y", ("X",)),
        "spectral_norm": ({"Weight": r(4, 3, 2, 2), "U": r(4), "V": r(12)},
                          {"power_iters": 3}, "Out", ("Weight",)),
        "lrn": ({"X": r(2, 7, 3, 3)}, {"n": 5, "k": 2.0, "alpha": 1e-2},
                "Out", ("X",)),
        "affine_channel": ({"X": r(2, 3, 4, 5), "Scale": r(3), "Bias": r(3)},
                           {}, "Out", ("X", "Scale", "Bias")),
        "temporal_shift": ({"X": r(8, 16, 3, 3)}, {"seg_num": 4}, "Out",
                           ("X",)),
        "grid_sampler": ({"X": r(2, 3, 5, 6),
                          "Grid": r(2, 3, 4, 2, lo=-1.6, hi=1.6)}, {},
                         "Output", ("X", "Grid")),
        "affine_grid": ({"Theta": r(2, 2, 3)},
                        {"output_shape": [2, 3, 4, 5]}, "Output",
                        ("Theta",)),
        "unfold": ({"X": r(2, 3, 6, 7)},
                   {"kernel_sizes": [2, 3], "strides": [2, 1],
                    "paddings": [1, 2, 0, 1], "dilations": [1, 2]}, "Y",
                   ("X",)),
        "deformable_conv": ({"Input": r(2, 3, 6, 6),
                             "Offset": r(2, 18, 4, 4, lo=-2, hi=2),
                             "Filter": r(4, 3, 3, 3),
                             "Mask": r(2, 9, 4, 4, lo=0, hi=1)}, {},
                            "Output", ("Input", "Offset", "Filter", "Mask")),
        "deformable_conv_v1": ({"Input": r(2, 3, 6, 6),
                                "Offset": r(2, 18, 4, 4, lo=-2, hi=2),
                                "Filter": r(4, 3, 3, 3)}, {}, "Output",
                               ("Input", "Offset", "Filter")),
        "fsp": ({"X": r(2, 3, 4, 5), "Y": r(2, 6, 4, 5)}, {}, "Out",
                ("X", "Y")),
        "similarity_focus": ({"X": r(2, 3, 4, 5)},
                             {"axis": 1, "indexes": [0, 2]}, "Out", ()),
        "bilinear_tensor_product": ({"X": r(4, 3), "Y": r(4, 5),
                                     "Weight": r(6, 3, 5), "Bias": r(6)},
                                    {}, "Out", ("X", "Y", "Weight", "Bias")),
        "l2_normalize": ({"X": r(4, 5, 3)}, {"axis": 1}, "Out", ("X",)),
        "norm": ({"X": r(4, 5, 3)}, {"axis": -1}, "Norm", ("X",)),
        "cumsum": ({"X": r(3, 4, 50)}, {"axis": -1, "exclusive": True,
                                        "reverse": True}, "Out", ("X",)),
    })
    return cases


def _op_inputs(ins, grad, device, with_grad):
    """{slot: tensor or list of tensors} on `device`; the `grad` slots
    require gradients where with_grad."""
    def one(k, v):
        return torch.tensor(v, device=device,
                            requires_grad=with_grad and k in grad)
    return {k: [one(k, e) for e in v] if isinstance(v, list) else one(k, v)
            for k, v in ins.items()}


def _op_out(out):
    """An output slot as one tensor (a list of outputs, such as split's,
    flattened and joined)."""
    if isinstance(out, list):
        return torch.cat([o.reshape(-1) for o in out])
    return out


def _registry_op(name):
    """The registry's op a case names: its name's first word (a case such
    as "var_conv_2d stride 2" is one of several of one op)."""
    from paddle_tpu_torch.ops import _REGISTRY
    return _REGISTRY[name.split()[0]]


def _op_call(op, ins, attrs, slot, grad, device, cot=None, call=None):
    """The op's `slot` on `device` (numpy) and, with `cot`, the gradients
    of sum(out x cot) with respect to the `grad` inputs. `call` (a
    function of the op's context) runs in place of the registry's op."""
    t = _op_inputs(ins, grad, device, cot is not None)
    out = _op_out((call or _registry_op(op))(_CardCtx(t, attrs,
                                                      device))[slot])
    grads = []
    if cot is not None and grad:
        leaves = [e for k in grad for e in (t[k] if isinstance(t[k], list)
                                            else [t[k]])]
        grads = torch.autograd.grad(
            (out * torch.from_numpy(cot).to(device)).sum(), leaves)
    return (out.detach().cpu().numpy(),
            [g.detach().cpu().numpy() for g in grads])


def _op_syncs(op, ins, attrs, device="cuda"):
    """The host syncs torch reported in one call of the op on the card,
    its inputs made there first."""
    t = _op_inputs(ins, (), device, False)
    torch.cuda.synchronize()
    _, where = _count_syncs(lambda: _registry_op(op)(_CardCtx(t, attrs,
                                                              device)))
    torch.cuda.synchronize()
    return where


def _op_rel_err(a, b):
    scale = float(np.abs(b).max()) if b.size else 0.0
    return float(np.abs(a - b).max()) / scale if scale else \
        float(np.abs(a - b).max()) if a.size else 0.0


def _random_op_checks(device):
    """Each random op on `device`: the same draws from one seed twice,
    others from another seed, and its bounds. Returns {op: note}."""
    probs = np.tile(np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.0, 0.2, 0.1]],
                             np.float32), (512, 1))
    img = np.arange(2 * 3 * 6 * 7, dtype=np.float32).reshape(2, 3, 6, 7)
    cases = {
        "uniform_random_batch_size_like": (
            {"Input": np.zeros((512, 3), np.float32)},
            {"shape": [-1, 64], "min": -2.0, "max": 3.0},
            lambda o: o.shape == (512, 64) and o.min() >= -2 and o.max() < 3),
        "gaussian_random_batch_size_like": (
            {"Input": np.zeros((512, 3), np.float32)},
            {"shape": [-1, 64], "mean": 1.0, "std": 2.0},
            lambda o: o.shape == (512, 64) and abs(o.mean() - 1) < 0.05),
        "truncated_gaussian_random": (
            {}, {"shape": [512, 64], "mean": 0.5, "std": 2.0},
            lambda o: np.abs(o - 0.5).max() <= 4.0 + 1e-5),
        "randint": ({}, {"shape": [512, 64], "low": -3, "high": 4},
                    lambda o: o.dtype == np.int64 and o.min() == -3
                    and o.max() == 3),
        "sampling_id": ({"X": probs}, {},
                        lambda o: o.shape == (1024,) and o.min() >= 0
                        and o.max() <= 3 and not (o[1::2] == 1).any()),
        "random_crop": ({"X": img}, {"shape": [4, 5]},
                        lambda o: np.array_equal(
                            o, img[:, :, int(o[0, 0, 0, 0]) // 7 % 6:
                                   int(o[0, 0, 0, 0]) // 7 % 6 + 4,
                                   int(o[0, 0, 0, 0]) % 7:
                                   int(o[0, 0, 0, 0]) % 7 + 5])),
        "multinomial": ({"X": probs}, {"num_samples": 3},
                        lambda o: o.shape == (1024, 3)
                        and not (o[1::2] == 1).any()),
        "bernoulli": ({"X": np.full((512, 64), 0.3, np.float32)}, {},
                      lambda o: set(np.unique(o)) <= {0.0, 1.0}
                      and abs(o.mean() - 0.3) < 0.02),
    }
    from paddle_tpu_torch.ops import _REGISTRY
    notes = {}
    for op, (ins, attrs, ok) in cases.items():
        t = {k: torch.from_numpy(v).to(device) for k, v in ins.items()}
        draws = [_REGISTRY[op](_CardCtx(t, attrs, device, seed))["Out"]
                 .cpu().numpy() for seed in (7, 7, 8)]
        if not np.array_equal(draws[0], draws[1]):
            _fail(f"31g {op}: two draws from one seed differ")
        if np.array_equal(draws[0], draws[2]) and op != "random_crop":
            _fail(f"31g {op}: two seeds give the same draws")
        if not ok(draws[0]):
            _fail(f"31g {op}: a draw out of its bounds")
        notes[op] = f"{draws[0].shape} {draws[0].dtype}"
    return notes


def _ops_card_vs_cpu(tag, cases, calls=None):
    """Each op of `cases` ({op: (inputs, attrs, slot, grad slots)}) on
    the card against the same op on the CPU from one seeded input,
    forward and the gradient of one seeded cotangent (OPS_FWD_TOL /
    OPS_GRAD_TOL of the output's / the gradient's largest magnitude;
    integer and bool outputs equal). `calls` ({op: function of the op's
    context}) runs a case through its function in place of the
    registry's op. Returns {op: [forward, gradient]}."""
    errs = {}
    for op, (ins, attrs, slot, grad) in cases.items():
        call = (calls or {}).get(op)
        cpu, _ = _op_call(op, ins, attrs, slot, grad, "cpu", call=call)
        floating = np.issubdtype(cpu.dtype, np.floating)
        cot = np.asarray(np.random.RandomState(SEED + 37).randn(
            *cpu.shape), np.float32) if floating else None
        cpu, cpu_g = _op_call(op, ins, attrs, slot, grad, "cpu", cot, call)
        card, card_g = _op_call(op, ins, attrs, slot, grad, "cuda", cot,
                                call)
        if card.shape != cpu.shape or card.dtype != cpu.dtype:
            _fail(f"{tag} {op}: {card.shape} {card.dtype} on the card, "
                  f"{cpu.shape} {cpu.dtype} on the CPU")
        if not floating:
            if not np.array_equal(card, cpu):
                _fail(f"{tag} {op}: integer {slot} differs on the card")
            errs[op] = [0.0, 0.0]
            continue
        errs[op] = [_op_rel_err(card, cpu), max([_op_rel_err(a, b) for a, b in
                                          zip(card_g, cpu_g)] or [0.0])]
        if errs[op][0] > OPS_FWD_TOL or errs[op][1] > OPS_GRAD_TOL:
            _fail(f"{tag} {op}: card vs CPU (forward, gradient) {errs[op]}")
    return errs


def _ops_record(ops, errs, **extra):
    worst_f = max(errs, key=lambda k: errs[k][0])
    worst_g = max(errs, key=lambda k: errs[k][1])
    return {"ops": len(ops), "deterministic": len(errs), **extra,
            "worst_forward": [worst_f, errs[worst_f][0]],
            "worst_gradient": [worst_g, errs[worst_g][1]],
            "errs": {k: [float(f"{v[0]:.3g}"), float(f"{v[1]:.3g}")]
                     for k, v in errs.items()},
            "card": _card_line()}


def phase_slice_ops():
    """Phase 31g: every op of SLICE_OPS on the card. The deterministic
    ones against the same op on the CPU (_ops_card_vs_cpu: pools'
    indices on ties equal); the random ones from one seed twice (equal),
    from another (different), within their bounds."""
    cases = _slice_op_cases()
    if sorted(list(cases) + list(RANDOM_OPS)) != sorted(SLICE_OPS):
        _fail("31g: the op table does not cover the slice's ops")
    errs = _ops_card_vs_cpu("31g", cases)
    rec = _ops_record(SLICE_OPS, errs, random=_random_op_checks("cuda"))
    print("slice ops " + json.dumps(rec))
    return rec


def phase_vision_all(flash, paged):
    """Phases 31-31g. None launches an attention kernel: each is gated at
    0 flash and paged launches (_seq_phase). Returns (the counts over the
    phases, records)."""
    recs, total = {}, (0, 0, 0, 0, 0)
    for key, name, fn in (
            ("31", "31 MobileNet-v2 train", phase_mobilenet_v2),
            ("31b", "31b MobileNet v1, v2 card vs CPU",
             phase_mobilenet_v1_agree),
            ("31c", "31c DeepLabv3+", phase_deeplab),
            ("31d", "31d TSM", phase_tsm),
            ("31e", "31e DCGAN", phase_gan),
            ("31f", "31f book nets", phase_book),
            ("31g", "31g the slice's ops card vs CPU", phase_slice_ops)):
        recs[key], counts = _seq_phase(name, fn, flash, paged)
        total = tuple(x + y for x, y in zip(total, counts))
    return total, recs


# ---------------------------------------------------------------------------
# phases 32-32d: the tensor, math, loss and metric ops
# ---------------------------------------------------------------------------

def _auc_program(with_auc=True):
    """Phase 25's DeepFM (its width, Adam(DEEPFM_LR), f32), with
    layers.auc(prob, label, AUC_THRESHOLDS) in the Program where
    with_auc: (main, startup, loss, prob, [auc, stat_pos, stat_neg])."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import deepfm
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 25
    metric = []
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _i, _v, label, loss, prob = deepfm.build_train_net(
            num_features=DEEPFM_FEATURES, num_fields=DEEPFM_FIELDS,
            embed_dim=DEEPFM_EMBED)
        if with_auc:
            auc, _batch, stats = fluid.layers.auc(
                prob, label, num_thresholds=AUC_THRESHOLDS)
            metric = [auc] + stats
        fluid.optimizer.AdamOptimizer(DEEPFM_LR).minimize(loss)
    return main, startup, loss, prob, metric


def ctr_batches(n, seed, device="cuda"):
    """`n` synthetic DeepFM batches made on `device` from `seed`: ids
    uniform over the features, values in [0, 1), labels 1 with
    probability METRIC_POS_RATE."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (DEEPFM_BATCH, DEEPFM_FIELDS)
    return [{"feat_ids": torch.randint(0, DEEPFM_FEATURES, shape,
                                       generator=gen, device=device),
             "feat_vals": torch.rand(shape, generator=gen, device=device),
             "label": (torch.rand((DEEPFM_BATCH, 1), generator=gen,
                                  device=device) < METRIC_POS_RATE).float()}
            for _ in range(n)]


def _auc_hists_np(prob, label):
    """numpy's (positive, negative) histograms of one batch with the
    auc op's buckets: int(p (buckets - 1)) of the f32 product, clipped."""
    p = np.asarray(prob, np.float32).reshape(len(prob), -1)[:, -1]
    bucket = np.clip(p * np.float32(AUC_THRESHOLDS), 0,
                     AUC_THRESHOLDS).astype(np.int64)
    lab = np.asarray(label, np.float64).reshape(-1)
    n = AUC_THRESHOLDS + 1
    return (np.bincount(bucket, weights=lab, minlength=n),
            np.bincount(bucket, weights=1.0 - lab, minlength=n))


def _auc_np(pos, neg):
    """The op's trapezoid area over the histograms, in float64."""
    pos, neg = np.asarray(pos, np.float64), np.asarray(neg, np.float64)
    above = np.cumsum(pos[::-1])[::-1]
    return float((neg * (above - pos / 2)).sum()
                 / max(pos.sum() * neg.sum(), 1.0))


def _auc_steps(tag, exe, program, fetch, batches, scope):
    """One step a batch, fetching [loss, auc, prob, stat_pos, stat_neg]:
    after each, the statistics must equal numpy's histograms of every
    fetched probability and label so far, exactly, and the AUC be within
    AUC_TOL of numpy's over the statistics. Returns (losses, AUCs, the
    AUCs' distances, step ms)."""
    pos = np.zeros(AUC_THRESHOLDS + 1)
    neg = np.zeros(AUC_THRESHOLDS + 1)
    losses, aucs, dists, ms = [], [], [], []
    for i, feed in enumerate(batches):
        t0 = time.perf_counter()
        loss, auc, prob, s_pos, s_neg = exe.run(
            program, feed=feed, fetch_list=fetch, scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        hp, hn = _auc_hists_np(prob, feed["label"].cpu().numpy())
        pos, neg = pos + hp, neg + hn
        if not (np.array_equal(s_pos.astype(np.float64), pos)
                and np.array_equal(s_neg.astype(np.float64), neg)):
            _fail(f"{tag}: step {i}'s statistics are not numpy's "
                  f"histograms of the fetched probabilities (positives "
                  f"{s_pos.sum()} vs {pos.sum()}, negatives {s_neg.sum()} "
                  f"vs {neg.sum()})")
        losses.append(float(np.ravel(loss)[0]))
        aucs.append(float(np.ravel(auc)[0]))
        dists.append(abs(aucs[-1] - _auc_np(s_pos, s_neg)))
    if max(dists) > AUC_TOL:
        _fail(f"{tag}: AUC off numpy's by {max(dists)}")
    if pos.sum() + neg.sum() != len(batches) * DEEPFM_BATCH:
        _fail(f"{tag}: the statistics count {pos.sum() + neg.sum()} "
              f"examples, want {len(batches) * DEEPFM_BATCH}")
    return losses, aucs, dists, ms


def phase_deepfm_auc():
    """Phase 32: DeepFM at bench.py's width (phase 25's) with the
    streaming layers.auc(prob, label, 4095) in the training Program,
    METRIC_STEPS steps over a new batch each (_auc_steps' gates: the
    statistics numpy's histograms of the card's own probabilities,
    exactly; the AUC within AUC_TOL of numpy's); the losses' last three
    below their first three; 0 host syncs in a dispatch. Then step p50
    over METRIC_TIMED steps with the metric and without it (phase 25's
    Program), and the auc op's device ms and operations a step
    (_profile_ops)."""
    import paddle_tpu_torch as fluid
    main, startup, loss, prob, metric = _auc_program()
    batches = ctr_batches(METRIC_STEPS, SEED + 40)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    losses, aucs, dists, _ms = _auc_steps(
        "32", exe, main, [loss, metric[0], prob] + metric[1:], batches, scope)
    syncs = _dispatch_syncs(exe, main, batches[0], [loss, metric[0]], scope)
    if not _falls(losses):
        _fail(f"32: losses not finite or not falling: {losses}")
    if syncs:
        _fail(f"32: host syncs in a training dispatch: {syncs}")
    feed = batches[-1]
    _, with_ms = _timed_steps(exe, main, feed, [loss], scope, METRIC_TIMED)
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope), DEEPFM_PROFILE_STEPS)
    plain, pstart, ploss, _p, _m = _auc_program(with_auc=False)
    pscope = fluid.Scope()
    exe.run(pstart, scope=pscope)
    _, without_ms = _timed_steps(exe, plain, feed, [ploss], pscope,
                                 METRIC_TIMED)
    by_op = prof["device_ms_per_step_by_op"]
    ops_by = prof["device_ops_per_step_by_op"] or {}
    rec = {"config": f"deepfm.build_train_net(num_features="
                     f"{DEEPFM_FEATURES}, num_fields={DEEPFM_FIELDS}, "
                     f"embed_dim={DEEPFM_EMBED}) + layers.auc(prob, label, "
                     f"num_thresholds={AUC_THRESHOLDS}), Adam({DEEPFM_LR}), "
                     f"f32",
           "batch": DEEPFM_BATCH, "steps": METRIC_STEPS, "losses": losses,
           "aucs": aucs, "auc_vs_numpy_max": max(dists),
           "syncs_in_a_training_dispatch": len(syncs),
           "step_ms_p50_with_auc": float(np.percentile(with_ms, 50)),
           "step_ms_p50_without_auc": float(np.percentile(without_ms, 50)),
           "auc_op_device_ms_per_step": by_op.get("auc", 0.0),
           "auc_op_device_ops_per_step": ops_by.get("auc"),
           "device_ms_per_step": prof["device_ms_per_step"],
           "device_ops_per_step": prof["device_ops_per_step"],
           "device_busy_share": prof["device_busy_share"],
           "card": _card_line()}
    print("deepfm auc " + json.dumps(rec))
    print("profile deepfm auc " + json.dumps(prof))
    return rec


def phase_deepfm_auc_dp():
    """Phase 32b: phase 32's Program through with_data_parallel at dp DP
    on one card and at dp 1, from one startup, AUC_DP_STEPS new batches
    each: at each dp the statistics numpy's histograms of the fetched
    global-batch probabilities (the global batch counted once: they sum
    to steps x the batch, not half or twice that); each step's AUC at dp
    DP within AUC_TOL of dp 1's."""
    import paddle_tpu_torch as fluid
    main, startup, loss, prob, metric = _auc_program()
    batches = ctr_batches(AUC_DP_STEPS, SEED + 41)
    exe = fluid.Executor()
    base = fluid.Scope()
    exe.run(startup, scope=base)
    runs = {}
    for dp in (1, DP):
        prog = _dp_program(main, loss, [fluid.CUDAPlace(0)] * dp)
        runs[dp] = _auc_steps(f"32b dp {dp}", exe, prog,
                              [loss, metric[0], prob] + metric[1:], batches,
                              _copy_scope(base))
    gap = max(abs(a - b) for a, b in zip(runs[1][1], runs[DP][1]))
    rec = {"dp": DP, "steps": AUC_DP_STEPS, "aucs_dp1": runs[1][1],
           f"aucs_dp{DP}": runs[DP][1], "losses_dp1": runs[1][0],
           f"losses_dp{DP}": runs[DP][0], "auc_gap_max": gap,
           "examples_counted": AUC_DP_STEPS * DEEPFM_BATCH,
           "step_ms": {f"dp{d}": r[3] for d, r in runs.items()},
           "card": _card_line()}
    print("deepfm auc dp " + json.dumps(rec))
    if gap > AUC_TOL:
        _fail(f"32b: dp {DP}'s AUC off dp 1's by {gap}")
    return rec


def _confusion_np(pred, label, n):
    """numpy's (n, n) confusion matrix, rows the labels; pixels labelled
    outside [0, n) left out (the ignore label)."""
    pred, label = np.asarray(pred).reshape(-1), np.asarray(label).reshape(-1)
    keep = (label >= 0) & (label < n)
    return np.bincount(label[keep] * n + pred[keep],
                       minlength=n * n).reshape(n, n).astype(np.float64)


def _miou_np(cm):
    inter = np.diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    return float((inter / np.maximum(union, 1))[union > 0].mean())


def phase_deeplab_miou():
    """Phase 32c: phase 31c's DeepLabv3+ (PASCAL VOC's 513² crop, 21
    classes, base 64, batch 8, Adam 1e-3) with layers.argmax of the
    transposed logits and layers.mean_iou(pred, label, 21) in the
    Program (tests/models/test_deeplab.py:26-28), MIOU_STEPS steps:
    OutWrong and OutCorrect equal to numpy's confusion matrix of the
    fetched argmax and the labels, exactly (8 x 513² pixels < 2^24 are
    exact in f32), the mIoU within MIOU_TOL of numpy's, 0 host syncs in
    a dispatch. Then one mean_iou call on the card with a MIOU_IGNORE
    share of the labels set to 255 (_miou_ignore_call)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.models import deeplab
    box = {}

    def build():
        _img, label, loss, logits = deeplab.build_train_net(
            img_shape=(3, DL_IMAGE, DL_IMAGE), num_classes=DL_CLASSES,
            base_filters=DL_FILTERS)
        pred = L.reshape(L.argmax(L.transpose(logits, [0, 2, 3, 1]),
                                  axis=-1), [-1, DL_IMAGE, DL_IMAGE])
        box["pred"] = pred
        box["metric"] = list(L.mean_iou(pred, label, DL_CLASSES))
        return loss

    main, startup, loss = _vision_program(build, _vision_adam(DL_LR))
    feed = deeplab_feed(DL_BATCH, DL_IMAGE, DL_CLASSES)
    labels = feed["label"].cpu().numpy()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fetch = [loss] + box["metric"] + [box["pred"]]
    losses, dists = [], []
    for i in range(MIOU_STEPS):
        lv, miou, wrong, correct, pred = exe.run(main, feed=feed,
                                                 fetch_list=fetch,
                                                 scope=scope)
        cm = _confusion_np(pred, labels, DL_CLASSES)
        inter = np.diag(cm)
        if not (np.array_equal(correct.astype(np.float64), inter) and
                np.array_equal(wrong.astype(np.float64), cm.sum(1) - inter)):
            _fail(f"32c: step {i}'s OutCorrect / OutWrong are not numpy's "
                  f"confusion matrix of the fetched argmax")
        dists.append(abs(float(miou[0]) - _miou_np(cm)))
        losses.append(float(np.ravel(lv)[0]))
    syncs = _dispatch_syncs(exe, main, feed, [loss, box["metric"][0]], scope)
    _, ms = _timed_steps(exe, main, feed, [loss, box["metric"][0]], scope,
                         MIOU_TIMED)
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[
        loss, box["metric"][0]], scope=scope), 1)
    ignore = _miou_ignore_call(pred, labels)
    by_op = prof["device_ms_per_step_by_op"]
    ops_by = prof["device_ops_per_step_by_op"] or {}
    rec = {"config": f"deeplab.build_train_net(img_shape=(3, {DL_IMAGE}, "
                     f"{DL_IMAGE}), num_classes={DL_CLASSES}, base_filters="
                     f"{DL_FILTERS}) + argmax + mean_iou, Adam({DL_LR}), f32",
           "batch": DL_BATCH, "steps": MIOU_STEPS, "losses": losses,
           "miou_vs_numpy_max": max(dists),
           "syncs_in_a_training_dispatch": len(syncs),
           "step_ms_p50": float(np.percentile(ms, 50)),
           "mean_iou_op_device_ms_per_step": by_op.get("mean_iou", 0.0),
           "arg_max_op_device_ms_per_step": by_op.get("arg_max", 0.0),
           "mean_iou_op_device_ops_per_step": ops_by.get("mean_iou"),
           "device_ms_per_step": prof["device_ms_per_step"],
           "device_ops_per_step": prof["device_ops_per_step"],
           "device_busy_share": prof["device_busy_share"],
           "ignore_label_call": ignore, "card": _card_line()}
    print("deeplab miou " + json.dumps(rec))
    if max(dists) > MIOU_TOL:
        _fail(f"32c: mIoU off numpy's by {max(dists)}")
    if syncs:
        _fail(f"32c: host syncs in a training dispatch: {syncs}")
    return rec


def _miou_ignore_call(pred, labels):
    """One mean_iou op call on the card and on the CPU with a MIOU_IGNORE
    share of the labels (seeded) set to 255: the card must not assert,
    its outputs must equal the CPU's, and the pixels it counts numpy's
    with those left out."""
    from paddle_tpu_torch.ops import _REGISTRY
    labels = labels.copy()
    hit = np.random.RandomState(SEED + 42).rand(*labels.shape) < MIOU_IGNORE
    labels[hit] = 255
    ins = {"Predictions": np.asarray(pred), "Labels": labels}
    attrs = {"num_classes": DL_CLASSES}
    outs = {}
    for device in ("cpu", "cuda"):
        o = _REGISTRY["mean_iou"](_CardCtx(_op_inputs(ins, (), device,
                                                      False), attrs, device))
        outs[device] = {k: v.cpu().numpy() for k, v in o.items()}
    torch.cuda.synchronize()
    for k in outs["cpu"]:
        if not np.array_equal(outs["cuda"][k], outs["cpu"][k]):
            _fail(f"32c: the 255-labelled mean_iou's {k} differs on the "
                  f"card")
    counted = float(outs["cuda"]["OutWrong"].sum()
                    + outs["cuda"]["OutCorrect"].sum())
    want = _confusion_np(pred, labels, DL_CLASSES).sum()
    if counted != want or want != labels.size - hit.sum():
        _fail(f"32c: the 255-labelled mean_iou counted {counted} pixels, "
              f"want {labels.size - hit.sum()}")
    return {"ignored_pixels": int(hit.sum()), "counted_pixels": counted,
            "miou": float(outs["cuda"]["OutMeanIou"][0])}


# the 71 ops this slice registers
METRIC_SLICE_OPS = (
    "arg_max arg_min argsort assign_value crop crop_tensor diag embedding "
    "expand_as eye flatten flatten2 gather_nd get_tensor_from_selected_rows "
    "hash linspace lod_append lod_reset lookup_table_v2 merge_selected_rows "
    "multiplex pad pad2d pad_constant_like pixel_shuffle rank reverse "
    "scatter scatter_nd scatter_nd_add shape shard_index shuffle_channel "
    "size space_to_depth split stack strided_slice tile transpose unique "
    "unique_with_counts unstack where where_index_select "
    "conv_shift dot fill has_inf has_nan l1_norm minus squared_l2_norm "
    "bpr_loss center_loss dice_loss hinge_loss huber_loss kldiv_loss "
    "margin_rank_loss modified_huber_loss mse_loss npair_loss rank_loss "
    "squared_l2_distance teacher_student_sigmoid_loss "
    "auc continuous_value_model filter_by_instag mean_iou "
    "positive_negative_pair").split()
# the ops whose host syncs phase 32d gates at 0: the fixed-size scans
# and the flags
NO_SYNC_OPS = ("where", "unique", "unique_with_counts", "has_inf",
               "has_nan")


def _metric_op_cases():
    """{op: (inputs as numpy, attrs, output slot, grad slots)} for every
    op of METRIC_SLICE_OPS at seeded shapes with each op's edge:
    out-of-range and negative indices, ties, signed zeros and NaN in the
    sorts, reflect padding, ids past 2^31 in hash, VOC's ignore label
    255 in mean_iou."""
    rng = np.random.RandomState(SEED + 43)

    def r(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def ints(hi, *shape):
        return rng.randint(0, hi, shape).astype(np.int64)

    x = r(4, 6, 5)
    ties = rng.randint(0, 5, (64, 257)).astype(np.float32)
    ties[0, :4] = [0.0, -0.0, np.nan, 0.0]
    seg = ints(21, 8, 65, 65)
    seg[:, :3] = 255
    p = rng.rand(4096).astype(np.float32)
    return {
        "arg_max": ({"X": ties}, {"axis": 1}, "Out", ()),
        "arg_min": ({"X": ties}, {"axis": 0}, "Out", ()),
        "argsort": ({"X": ties}, {"axis": -1, "descending": True},
                    "Indices", ()),
        "assign_value": ({}, {"shape": [3, 4], "dtype": "float32",
                              "values": r(12).tolist()}, "Out", ()),
        "crop": ({"X": x, "Offsets": np.array([-1, 4, 1], np.int32)},
                 {"shape": [2, 3, 3]}, "Out", ("X",)),
        "crop_tensor": ({"X": x}, {"shape": [-1, 3, 4],
                                   "offsets": [1, 2, 1]}, "Out", ("X",)),
        "diag": ({"Diagonal": r(64)}, {}, "Out", ("Diagonal",)),
        "embedding": ({"W": r(1000, 16), "Ids": ints(1000, 256, 1)}, {},
                      "Out", ("W",)),
        "expand_as": ({"X": r(4, 1, 6), "target_tensor": r(8, 5, 6)}, {},
                      "Out", ("X",)),
        "eye": ({}, {"num_rows": 5, "num_columns": 7}, "Out", ()),
        "flatten": ({"X": x}, {"axis": 2}, "Out", ("X",)),
        "flatten2": ({"X": x}, {"axis": 1}, "Out", ("X",)),
        "gather_nd": ({"X": r(6, 5, 4), "Index": np.array(
            [[1, 2], [7, -1], [-8, 3], [5, 4]], np.int64)}, {}, "Out",
            ("X",)),
        "get_tensor_from_selected_rows": ({"X": x}, {}, "Out", ("X",)),
        "hash": ({"X": np.array([[3], [-5], [2 ** 31 + 7], [2 ** 40]],
                                np.int64)},
                 {"num_hash": 4, "mod_by": 100000007}, "Out", ()),
        "linspace": ({}, {"start": -2.0, "stop": 3.0, "num": 1001}, "Out",
                     ()),
        "lod_append": ({"X": x}, {}, "Out", ("X",)),
        "lod_reset": ({"X": x}, {}, "Out", ("X",)),
        "lookup_table_v2": ({"W": r(50, 8), "Ids": ints(50, 9, 3)},
                            {"padding_idx": 0}, "Out", ("W",)),
        "merge_selected_rows": ({"X": x}, {}, "Out", ("X",)),
        "multiplex": ({"X": [r(6, 4), r(6, 4), r(6, 4)],
                       "Ids": np.array([[0], [2], [-1], [1], [0], [2]],
                                       np.int64)}, {}, "Out", ("X",)),
        "pad": ({"X": x}, {"paddings": [1, 0, 2, 3, 0, 1],
                           "pad_value": 0.5}, "Out", ("X",)),
        "pad2d": ({"X": r(2, 3, 9, 8)}, {"paddings": [2, 1, 3, 0],
                                         "mode": "reflect"}, "Out", ("X",)),
        "pad_constant_like": ({"X": r(6, 7, 5), "Y": x},
                              {"pad_value": -1.0}, "Out", ("Y",)),
        "pixel_shuffle": ({"X": r(2, 12, 5, 4)}, {"upscale_factor": 2},
                          "Out", ("X",)),
        "rank": ({"Input": x}, {}, "Out", ()),
        "reverse": ({"X": x}, {"axis": [0, 2]}, "Out", ("X",)),
        "scatter": ({"X": r(8, 3), "Ids": np.array([6, 0, -3, 9, 3],
                                                   np.int64),
                     "Updates": r(5, 3)}, {"overwrite": True}, "Out",
                    ("X", "Updates")),
        "scatter_nd": ({"Index": np.array([[0, 1], [0, 1], [3, 2], [9, 0]],
                                          np.int64), "Updates": r(4, 6)},
                       {"shape": [4, 3, 6]}, "Out", ("Updates",)),
        "scatter_nd_add": ({"X": r(4, 3, 6), "Index": np.array(
            [[0, 1], [0, 1], [-1, 2], [2, 7]], np.int64),
            "Updates": r(4, 6)}, {}, "Out", ("X", "Updates")),
        "shape": ({"Input": x}, {}, "Out", ()),
        "shard_index": ({"X": ints(1000, 64, 1)},
                        {"index_num": 1000, "nshards": 3, "shard_id": 1},
                        "Out", ()),
        "shuffle_channel": ({"X": r(2, 12, 4, 4)}, {"group": 3}, "Out",
                            ("X",)),
        "size": ({"Input": x}, {}, "Out", ()),
        "space_to_depth": ({"X": r(2, 3, 8, 6)}, {"blocksize": 2}, "Out",
                           ("X",)),
        "split": ({"X": x}, {"axis": 1, "sections": [1, 3, 2]}, "Out",
                  ("X",)),
        "stack": ({"X": [r(3, 5), r(3, 5), r(3, 5)]}, {"axis": 1}, "Y",
                  ("X",)),
        "strided_slice": ({"Input": x}, {"axes": [0, 2], "starts": [3, -1],
                                         "ends": [-100, 0],
                                         "strides": [-2, -1]}, "Out",
                          ("Input",)),
        "tile": ({"X": r(3, 4)}, {"repeat_times": [2, 1, 3]}, "Out",
                 ("X",)),
        "transpose": ({"X": x}, {"axis": [2, 0, 1]}, "Out", ("X",)),
        "unique": ({"X": ints(500, 100000)}, {}, "Index", ()),
        "unique_with_counts": ({"X": ints(500, 100000)}, {}, "Count", ()),
        "unstack": ({"X": x}, {"axis": 1}, "Y", ("X",)),
        "where": ({"Condition": rng.rand(512, 1024) < 0.3}, {}, "Out", ()),
        "where_index_select": ({"Condition": rng.rand(4, 6) < 0.5,
                                "X": r(4, 6), "Y": r(4, 6)}, {}, "Out",
                               ("X", "Y")),
        "conv_shift": ({"X": r(8, 13), "Y": r(8, 5)}, {}, "Out",
                       ("X", "Y")),
        "dot": ({"X": r(16, 32), "Y": r(16, 32)}, {}, "Out", ("X", "Y")),
        "fill": ({}, {"shape": [2, 3], "value": r(6).tolist(),
                      "dtype": "float32"}, "Out", ()),
        "has_inf": ({"X": np.append(r(4095), np.inf).astype(np.float32)},
                    {}, "Out", ()),
        "has_nan": ({"X": r(4096)}, {}, "Out", ()),
        "l1_norm": ({"X": x}, {}, "Out", ("X",)),
        "minus": ({"X": x, "Y": r(4, 6, 5)}, {}, "Out", ("X", "Y")),
        "squared_l2_norm": ({"X": x}, {}, "Out", ("X",)),
        "bpr_loss": ({"X": r(16, 7), "Label": ints(7, 16, 1)}, {}, "Y",
                     ("X",)),
        "center_loss": ({"X": r(16, 6), "Label": np.append(
            ints(5, 14), [7, -1]).reshape(16, 1), "Centers": r(5, 6),
            "CenterUpdateRate": np.array([0.3], np.float32)},
            {"need_update": True}, "CentersOut", ()),
        "dice_loss": ({"X": r(4, 8, 5, lo=0, hi=1),
                       "Label": ints(6, 4, 8, 1)}, {}, "Out", ("X",)),
        "hinge_loss": ({"Logits": r(32, 1, lo=-2, hi=2),
                        "Labels": ints(2, 32, 1).astype(np.float32)}, {},
                       "Loss", ("Logits",)),
        "huber_loss": ({"X": r(32, 1, lo=-2, hi=2),
                        "Y": r(32, 1, lo=-2, hi=2)}, {"delta": 0.5},
                       "Out", ("X", "Y")),
        "kldiv_loss": ({"X": r(8, 10, lo=-3, hi=0),
                        "Target": r(8, 10, lo=0, hi=1)},
                       {"reduction": "batchmean"}, "Loss", ("X",)),
        "margin_rank_loss": ({"Label": np.sign(r(32, 1)), "X1": r(32, 1),
                              "X2": r(32, 1)}, {"margin": 0.1}, "Out",
                             ("X1", "X2")),
        "modified_huber_loss": ({"X": r(32, 1, lo=-3, hi=3),
                                 "Y": ints(2, 32, 1).astype(np.float32)},
                                {}, "Out", ("X",)),
        "mse_loss": ({"X": x, "Y": r(4, 6, 5)}, {}, "Out", ("X", "Y")),
        "npair_loss": ({"Anchor": r(12, 8), "Positive": r(12, 8),
                        "Labels": ints(4, 12)}, {"l2_reg": 0.01}, "Out",
                       ("Anchor", "Positive")),
        "rank_loss": ({"Label": ints(2, 32, 1).astype(np.float32),
                       "Left": r(32, 1), "Right": r(32, 1)}, {}, "Out",
                      ("Left", "Right")),
        "squared_l2_distance": ({"X": x, "Y": r(4, 6, 5)}, {}, "Out",
                                ("X", "Y")),
        "teacher_student_sigmoid_loss": (
            {"X": r(8, 1, lo=-4, hi=4), "Label": np.array(
                [[-2], [-1], [0], [0.4], [1], [1.7], [-2], [0.9]],
                np.float32)}, {}, "Y", ("X",)),
        "auc": ({"Predict": np.stack([1 - p, p], 1),
                 "Label": ints(2, 4096, 1),
                 "StatPos": np.zeros(AUC_THRESHOLDS + 1, np.float32),
                 "StatNeg": np.zeros(AUC_THRESHOLDS + 1, np.float32)}, {},
                "StatPosOut", ()),
        "continuous_value_model": ({"X": r(16, 8, lo=0, hi=5),
                                    "CVM": r(16, 2)}, {"use_cvm": True},
                                   "Y", ("X",)),
        "filter_by_instag": ({"Ins": r(16, 4), "Ins_tag": ints(6, 16, 3),
                              "Filter_tag": np.array([1, 4], np.int64)},
                             {}, "IndexMap", ()),
        "mean_iou": ({"Predictions": ints(21, 8, 65, 65), "Labels": seg},
                     {"num_classes": 21}, "OutCorrect", ()),
        "positive_negative_pair": (
            {"Score": r(64, 1), "Label": ints(3, 64, 1).astype(np.float32),
             "QueryID": ints(4, 64, 1)}, {}, "PositivePair", ()),
    }


def _draw_ok(tag, draw, mean, std, lo=None, hi=None):
    """A draw's mean within MEAN_SE standard errors, its spread within
    DRAW_STD_RTOL, its values within [lo, hi]."""
    d = np.asarray(draw, np.float64)
    bad = []
    if abs(d.mean() - mean) > MEAN_SE * std / np.sqrt(d.size):
        bad.append(f"mean {d.mean()} vs {mean}")
    if abs(d.std() / std - 1) > DRAW_STD_RTOL:
        bad.append(f"std {d.std()} vs {std}")
    if lo is not None and (d.min() < lo or d.max() > hi):
        bad.append(f"range [{d.min()}, {d.max()}] vs [{lo}, {hi}]")
    if bad:
        _fail(f"32d {tag}: {bad}")
    return {"mean": float(d.mean()), "std": float(d.std()),
            "min": float(d.min()), "max": float(d.max())}


def _distributions_on_card():
    """The four distributions' entropy, log_prob and kl_divergence run
    by the Executor on the card and on the CPU (OPS_FWD_TOL); Normal,
    Uniform and Categorical draws of INIT_SHAPE's size on the card,
    their moments and bounds. Returns the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 44
    n = int(np.prod(INIT_SHAPE))
    logits = np.log(np.array([[0.1, 0.6, 0.3]], np.float32))
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        nrm = L.Normal(np.array([0.3, -1.2], np.float32),
                       np.array([0.7, 2.1], np.float32))
        uni = L.Uniform(np.array([0.0, -2.0], np.float32),
                        np.array([1.5, 3.0], np.float32))
        cat = L.Categorical(np.array([[0.2, 1.3, -0.5]], np.float32))
        mvn = L.MultivariateNormalDiag(
            np.array([0.3, 0.5], np.float32),
            np.array([[0.4, 0], [0, 0.5]], np.float32))
        mvn2 = L.MultivariateNormalDiag(
            np.array([0.2, 0.4], np.float32),
            np.array([[0.3, 0], [0, 0.4]], np.float32))
        value = L.assign(np.array([0.9, 0.1], np.float32))
        exact = [nrm.entropy(), nrm.log_prob(value),
                 nrm.kl_divergence(L.Normal(-0.4, 1.3)), uni.entropy(),
                 uni.log_prob(value), cat.entropy(),
                 cat.kl_divergence(L.Categorical(logits)),
                 cat.log_prob(L.assign(np.array([[2]], np.int64))),
                 mvn.entropy(), mvn.kl_divergence(mvn2)]
        draws = [L.Normal(1.0, 2.0).sample(list(INIT_SHAPE)),
                 L.Uniform(-1.0, 3.0).sample(list(INIT_SHAPE)),
                 L.Categorical(logits).sample([n])]
    runs = {}
    for where, place in (("card", fluid.CUDAPlace(0)),
                         ("cpu", fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fetch = exact + (draws if where == "card" else [])
        runs[where] = exe.run(main, fetch_list=fetch, scope=scope)
    errs = [_op_rel_err(np.asarray(a, np.float32), np.asarray(b, np.float32))
            for a, b in zip(runs["card"][:len(exact)], runs["cpu"])]
    if max(errs) > OPS_FWD_TOL:
        _fail(f"32d distributions: card vs CPU {errs}")
    normal, uniform, cats = runs["card"][len(exact):]
    freq = np.bincount(cats.reshape(-1), minlength=3) / cats.size
    want = np.array([0.1, 0.6, 0.3])
    if not (np.abs(freq - want) < MEAN_SE * np.sqrt(
            want * (1 - want) / cats.size)).all():
        _fail(f"32d Categorical.sample: frequencies {freq} vs {want}")
    return {"exact_card_vs_cpu": [float(f"{e:.3g}") for e in errs],
            "normal": _draw_ok("Normal.sample", normal, 1.0, 2.0),
            "uniform": _draw_ok("Uniform.sample", uniform, 1.0,
                                4 / np.sqrt(12), -1.0, 3.0),
            "categorical_freq": freq.tolist(), "draws": n}


def _initializers_on_card():
    """MSRA (uniform and normal), TruncatedNormal, Bilinear and
    NumpyArrayInitializer at INIT_SHAPE through a startup Program on the
    card: the random ones' moments and bounds, Bilinear equal to the
    bilinear kernel computed here in numpy, NumpyArray equal to its
    value. Returns the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import initializer as I
    from paddle_tpu_torch import layers as L
    value = np.random.RandomState(SEED + 45).rand(*INIT_SHAPE).astype(
        np.float32)
    inits = {"msra_uniform": I.MSRA(uniform=True),
             "msra_normal": I.MSRA(uniform=False),
             "truncated_normal": I.TruncatedNormal(0.5, 2.0),
             "bilinear": I.Bilinear(),
             "numpy_array": I.NumpyArrayInitializer(value)}
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 46
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        for name, init in inits.items():
            L.create_parameter(list(INIT_SHAPE), "float32", name=name,
                               default_initializer=init)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    got = {name: scope.get(name) for name in inits}
    if any(t.device.type != "cuda" for t in got.values()):
        _fail("32d: an initializer's value is not on the card")
    got = {k: v.cpu().numpy() for k, v in got.items()}
    fan_in = INIT_SHAPE[1] * INIT_SHAPE[2] * INIT_SHAPE[3]
    limit = np.sqrt(6.0 / fan_in)
    f = np.ceil(INIT_SHAPE[3] / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    taps = [(1 - abs(i / f - c)) for i in range(INIT_SHAPE[2])]
    kernel = np.broadcast_to(np.outer(taps, taps).astype(np.float32),
                             INIT_SHAPE)
    # the standard normal truncated to [-2, 2]: variance 1 - 4 phi(2) /
    # (Phi(2) - Phi(-2))
    trunc_std = 2.0 * np.sqrt(1 - 4 * np.exp(-2) / np.sqrt(2 * np.pi)
                              / 0.9544997361036416)
    rec = {"shape": list(INIT_SHAPE),
           "msra_uniform": _draw_ok("MSRA uniform", got["msra_uniform"],
                                    0.0, limit / np.sqrt(3), -limit, limit),
           "msra_normal": _draw_ok("MSRA normal", got["msra_normal"], 0.0,
                                   np.sqrt(2.0 / fan_in)),
           "truncated_normal": _draw_ok("TruncatedNormal",
                                        got["truncated_normal"], 0.5,
                                        trunc_std, -3.5, 4.5)}
    if not np.array_equal(got["bilinear"], kernel):
        _fail("32d: the Bilinear initializer's kernel is not the bilinear "
              "kernel")
    if not np.array_equal(got["numpy_array"], value):
        _fail("32d: the NumpyArrayInitializer's value differs on the card")
    rec["bilinear_exact"] = rec["numpy_array_exact"] = True
    return rec


def phase_metric_ops():
    """Phase 32d: every op of METRIC_SLICE_OPS on the card against the
    same op on the CPU (_ops_card_vs_cpu), the host syncs of each op's
    call on the card (those of NO_SYNC_OPS gated at 0); the four
    distributions and the MSRA, TruncatedNormal, Bilinear and NumpyArray
    initializers on the card."""
    cases = _metric_op_cases()
    if sorted(cases) != sorted(METRIC_SLICE_OPS) or \
            len(METRIC_SLICE_OPS) != 71:
        _fail("32d: the op table does not cover the slice's 71 ops")
    errs = _ops_card_vs_cpu("32d", cases)
    syncs = {op: len(_op_syncs(op, ins, attrs))
             for op, (ins, attrs, _s, _g) in cases.items()}
    rec = _ops_record(METRIC_SLICE_OPS, errs,
                      syncs={k: v for k, v in syncs.items() if v},
                      no_sync_ops={op: syncs[op] for op in NO_SYNC_OPS},
                      distributions=_distributions_on_card(),
                      initializers=_initializers_on_card())
    print("metric slice ops " + json.dumps(rec))
    if any(syncs[op] for op in NO_SYNC_OPS):
        _fail(f"32d: host syncs in {rec['no_sync_ops']}")
    return rec


def phase_metric_all(flash, paged):
    """Phases 32-32d. None launches an attention kernel: each is gated at
    0 flash and paged launches (_seq_phase). Returns (the counts over the
    phases, records)."""
    recs, total = {}, (0, 0, 0, 0, 0)
    for key, name, fn in (
            ("32", "32 DeepFM with the streaming AUC", phase_deepfm_auc),
            ("32b", "32b DeepFM AUC at dp 2", phase_deepfm_auc_dp),
            ("32c", "32c DeepLabv3+ with mean_iou", phase_deeplab_miou),
            ("32d", "32d the slice's ops card vs CPU", phase_metric_ops)):
        recs[key], counts = _seq_phase(name, fn, flash, paged)
        total = tuple(x + y for x, y in zip(total, counts))
    return total, recs


# ---------------------------------------------------------------------------
# phases 33-33e: the quant, sampling and match ops with quant/ and slim/
# ---------------------------------------------------------------------------

def _qat_mobilenet(image, classes, width_mult=1.0):
    """MobileNet-v1 (phase 31b's recipe) with quant.QuantizationTransform
    applied before minimize (channel-wise abs-max on the conv and
    depthwise filters, per tensor on the fc, moving-average abs-max on
    the activations, 8/8 bits): (main, startup, loss, the test-mode clone
    of the QAT forward, the prediction)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.models import mobilenet
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 33
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _img, _lab, pred, loss, _a1, _a5 = mobilenet.build_train_net(
            version=1, class_dim=classes, image_shape=image,
            width_mult=width_mult)
        quant.QuantizationTransform().apply(main, startup)
        test = main.clone(for_test=True)
        _vision_momentum(MN_LR, MN_DECAY)(fluid).minimize(loss)
    return main, startup, loss, test, pred


def _int8_exact(scope, names):
    """Each `{name}.int8` in the scope against numpy's clip(round_half_
    even(w / max|w| x 127), -128, 127) of the fetched float weight:
    (how many, how many differ)."""
    checked = bad = 0
    for n in names:
        q = scope.get(n + ".int8")
        if q is None:
            continue
        w = scope.get(n).cpu().numpy()
        want = np.clip(np.round(w / np.abs(w).max() * np.float32(127.0)),
                       -128, 127)
        checked += 1
        bad += int(q.dtype != torch.int8 or
                   not np.array_equal(q.cpu().numpy(), want))
    return checked, bad


def phase_qat_mobilenet(v1_rec=None):
    """Phase 33: QAT MobileNet-v1 at ImageNet width (_qat_mobilenet at
    phase 31b's 224², 1000 classes, batch 64), QAT_STEPS Momentum steps
    on one seeded batch. Gates: every loss finite and the last 3 below
    the first 3; after each step the image's moving-average scale within
    QAT_SCALE_RTOL of numpy's f32 recurrence s <- 0.9 s + 0.1 max|img|
    from 1; 0 host syncs in a dispatch. Then QuantizationFreezePass and
    ConvertToInt8Pass on a copy of the test-mode clone: the frozen
    program's output within QAT_FREEZE_TOL of the clone's on one batch,
    every conv and fc weight's int8 exactly numpy's. Records step p50,
    device ms and operations, the fake-quant ops' share of the forward's
    device time, beside phase 31b's float v1 step (`v1_rec`)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import slim
    main, startup, loss, test, pred = _qat_mobilenet(MNV2_IMAGE,
                                                     MNV2_CLASSES)
    feed = _images_feed(MNV2_BATCH, MNV2_IMAGE, MNV2_CLASSES)
    img_max = np.float32(np.abs(feed["img"].cpu().numpy()).max())
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = np.float32(1.0)
    losses, ms, scale_errs = [], [], []
    for _ in range(QAT_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss, "img.quant_scale"],
                      scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        s = np.float32(0.9) * s + np.float32(0.1) * img_max
        losses.append(float(np.ravel(out[0])[0]))
        scale_errs.append(abs(float(np.ravel(out[1])[0]) - float(s))
                          / float(s))
    peak = torch.cuda.max_memory_allocated()
    syncs = _dispatch_syncs(exe, main, feed, [loss], scope)
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope), QAT_PROFILE_STEPS)
    by_op = prof["device_ms_per_step_by_op"]
    fq_ms = sum(v for k, v in by_op.items() if "quantize" in k)
    frozen = test.clone()
    slim.QuantizationFreezePass(scope).apply(frozen)
    batch = {"img": feed["img"]}
    qat_out = exe.run(test, feed=batch, fetch_list=[pred], scope=scope)[0]
    frz_out = exe.run(frozen, feed=batch, fetch_list=[pred], scope=scope)[0]
    freeze_err = float(np.abs(frz_out - qat_out).max())
    slim.ConvertToInt8Pass(scope).apply(frozen)
    weights = [p.name for p in test.all_parameters()
               if len(p.shape) in (2, 4)]
    checked, bad = _int8_exact(scope, weights)
    rec = _seq_record(
        "qat_mobilenet_v1", f"QuantizationTransform() on mobilenet."
        f"build_train_net(version=1, class_dim={MNV2_CLASSES}, image_shape="
        f"{MNV2_IMAGE}), Momentum({MN_LR}, {MN_MOMENTUM}), L2Decay("
        f"{MN_DECAY}), f32", MNV2_BATCH, ms, peak, prof,
        ops=len(main.global_block().ops), losses=losses,
        img_scale_rel_err_max=max(scale_errs), img_max=float(img_max),
        syncs_in_a_training_dispatch=len(syncs),
        fake_quant_ops=sum(op.type.startswith("fake_")
                           for op in main.global_block().ops),
        fake_quant_device_ms_per_step_forward=fq_ms,
        fake_quant_share_of_device=fq_ms / prof["device_ms_per_step"],
        freeze_max_abs_diff=freeze_err, int8_weights=checked,
        int8_mismatches=bad, float_v1_31b={
            k: (v1_rec or {}).get(k) for k in (
                "step_ms_p50", "device_ms_per_step", "device_ops_per_step",
                "ops")})
    if not _falls(losses):
        _fail(f"33: losses not finite or not falling: {losses}")
    if max(scale_errs) > QAT_SCALE_RTOL:
        _fail(f"33: the image's EMA scale off numpy's recurrence by "
              f"{max(scale_errs)}")
    if syncs:
        _fail(f"33: host syncs in a training dispatch: {syncs}")
    if freeze_err > QAT_FREEZE_TOL:
        _fail(f"33: the frozen output off the QAT clone's by {freeze_err}")
    if bad or checked != len(weights):
        _fail(f"33: int8 weights: {checked} of {len(weights)} converted, "
              f"{bad} not numpy's")
    return rec


def _quant_codes(out, scale):
    """A fake quant-dequant output's integer codes: round(out x 127 /
    scale)."""
    return np.round(np.asarray(out, np.float64) * 127.0
                    / float(np.ravel(scale)[0])).astype(np.int64)


QAT_ACT_OP = "fake_quantize_dequantize_moving_average_abs_max"


def _pin_outs(pins):
    """Make the registry's QAT_ACT_OP give each op whose Out is a key of
    `pins` that value forward (its own Out plus the detached difference,
    so its gradient stays its own). Returns a function that undoes it."""
    from paddle_tpu_torch.ops import _REGISTRY
    impl = _REGISTRY[QAT_ACT_OP]

    def pinned(ctx):
        outs = impl(ctx)
        want = pins.get(ctx.op.output("Out")[0])
        if want is None:
            return outs
        out = outs["Out"]
        return dict(outs, Out=out + (want.to(out.device) - out).detach())

    _REGISTRY[QAT_ACT_OP] = pinned
    return lambda: _REGISTRY.__setitem__(QAT_ACT_OP, impl)


def _first_flip(qops, card, cpu):
    """The first quantize op whose codes differ between the card's and the
    CPU's fetched (X, Out, OutScale) triples: (its index, a record of the
    flip), or (None, None)."""
    for i in range(len(qops)):
        xc, oc, sc = card[3 * i: 3 * i + 3]
        xp, op_, sp = cpu[3 * i: 3 * i + 3]
        kc, kp = _quant_codes(oc, sc), _quant_codes(op_, sp)
        if np.array_equal(kc, kp):
            continue
        diff = kc != kp
        s = float(np.ravel(sp)[0])
        v = np.clip(np.abs(xp.astype(np.float64)), 0, s) * 127.0 / s
        half = np.abs(v - np.floor(v) - 0.5)[diff]
        return i, {"op": i, "input": qops[i].input("X")[0],
                   "codes_differing": int(diff.sum()), "of": int(kc.size),
                   "code_diff_max": int(np.abs(kc - kp).max()),
                   "input_err_of_max": _op_rel_err(xc, xp),
                   "half_way_distance_max": float(half.max())}
    return None, None


def phase_qat_agree():
    """Phase 33b: one QAT step of MobileNet-v1 at MN_AGREE on the card
    and on the CPU from one CPU startup: the loss within VISION_LOSS_TOL
    and every trainable parameter's @GRAD within VISION_GRAD_TOL of the
    step's largest. A rounding flip (a value on a code's half-way point
    that the two devices' summation orders put on either side) moves the
    next layers' inputs by a whole quantization step, far past these
    tolerances. So the CPU step runs again, with the first quantize op
    whose codes differ given the card's Out (_pin_outs), until no codes
    differ; each such op must have inputs within OPS_FWD_TOL of the
    card's, every differing code off by one, and each such value within
    QAT_FLIP_EPS of a half-way point (a genuine flip). The last CPU run,
    on the card's codes throughout, is held to the tolerances."""
    import paddle_tpu_torch as fluid
    a = MN_AGREE
    main, startup, loss, _test, _pred = _qat_mobilenet(
        a["image"], 10, a["width_mult"])
    params = [p.name for p in main.all_parameters() if p.trainable]
    qops = [op for op in main.global_block().ops if op.type == QAT_ACT_OP]
    watch = [n for op in qops for n in (
        op.input("X")[0], op.output("Out")[0], op.output("OutScale")[0])]
    grads = [p + "@GRAD" for p in params]
    feed = _np_feed(_images_feed(a["batch"], a["image"], 10, "cpu"))
    base = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=base)
    n = 1 + len(grads)

    def step(place, pins):
        exe = fluid.Executor(place)
        scope = fluid.Scope()
        for nm in base.names():
            scope.set(nm, base.get(nm).to(exe.device, copy=True))
        undo = _pin_outs(pins)
        try:
            return exe.run(main, feed=feed, scope=scope,
                           fetch_list=[loss] + grads + watch)
        finally:
            undo()

    def errs(card, cpu):
        ref = float(np.ravel(cpu[0])[0])
        gmax = max(float(np.abs(h).max()) for h in cpu[1:n])
        return (abs(float(np.ravel(card[0])[0]) - ref) / abs(ref),
                max(float(np.abs(g - h).max()) for g, h in
                    zip(card[1:n], cpu[1:n])) / gmax)

    card = step(fluid.CUDAPlace(0), {})
    pins, flips, genuine = {}, [], True
    cpu = step(fluid.CPUPlace(), pins)
    unpinned = errs(card, cpu)
    while genuine:
        i, flip = _first_flip(qops, card[n:], cpu[n:])
        if i is None:
            break
        flips.append(flip)
        name = qops[i].output("Out")[0]
        genuine = (name not in pins
                   and flip["input_err_of_max"] <= OPS_FWD_TOL
                   and flip["code_diff_max"] == 1
                   and flip["half_way_distance_max"] <= QAT_FLIP_EPS)
        pins[name] = torch.from_numpy(card[n + 3 * i + 1])
        if genuine:
            cpu = step(fluid.CPUPlace(), pins)
    loss_err, gerr = errs(card, cpu)
    rec = {"config": f"QAT v1 at {a}", "loss": float(np.ravel(cpu[0])[0]),
           "loss_rel_err": loss_err, "grads": len(grads),
           "grad_worst_of_step_scale": gerr, "quantize_ops": len(qops),
           "rounding_flips": flips, "cpu_runs": 1 + len(flips),
           "before_the_card_codes": {"loss_rel_err": unpinned[0],
                                     "grad_worst_of_step_scale":
                                         unpinned[1]},
           "card": _card_line()}
    print("qat_mobilenet_v1 agree " + json.dumps(rec))
    if not genuine:
        _fail(f"33b: codes differ but not by a rounding flip: {flips[-1]}")
    if not (loss_err <= VISION_LOSS_TOL and gerr <= VISION_GRAD_TOL):
        _fail(f"33b: the card against the CPU on the card's codes: {rec}")
    return rec


def _fc_of_softmax(program):
    """The logits (the last softmax's input) and the fc feeding it: (the
    logits' name, the mul's input and weight names)."""
    ops = program.global_block().ops
    sm = [op for op in ops if op.type == "softmax"][-1]
    mul = [op for op in ops if op.type == "mul"][-1]
    return sm.input("X")[0], mul.input("X")[0], mul.input("Y")[0]


def _cpu_scope(scope):
    import paddle_tpu_torch as fluid
    out = fluid.Scope()
    for n in scope.names():
        out.set(n, scope.get(n).to("cpu", copy=True))
    return out


def phase_ptq_resnet():
    """Phase 33c: PTQ ResNet-50 inference at 224², 1000 classes (the
    test-mode clone of resnet.resnet from a seeded startup):
    calibrate_program over PTQ_CALIB seeded batches of PTQ_CALIB_BATCH,
    then apply_ptq at each weight granularity. Gates: every scale equals
    numpy's max|act| over the activations fetched again, exactly; the
    scales calibrated on the card over the batch of PTQ_BATCH within
    PTQ_SCALE_RTOL of those calibrated on the CPU from a copy of the
    scope; the card's PTQ logits at batch PTQ_BATCH within PTQ_UNITS of
    the CPU's (both from the card's scales),
    in units of the last layer's quantization step (u_j = s / 127
    ||W_:j||). Records the float and PTQ forward ms (p50 over PTQ_TIMED
    batches of PTQ_CALIB_BATCH), the PTQ logits' relative error and top-1
    agreement against the float ones."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 34
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=list(RESNET_IMAGE),
                                dtype="float32")
        resnet.resnet(img, class_dim=RESNET_CLASSES, depth=RESNET_DEPTH)
    infer = main.clone(for_test=True)
    logits, fc_in, fc_w = _fc_of_softmax(infer)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = [{"img": _images_feed(PTQ_CALIB_BATCH, RESNET_IMAGE,
                                  RESNET_CLASSES, seed=SEED + 34 + k)["img"]}
             for k in range(PTQ_CALIB)]
    with fluid.scope_guard(scope):
        scales = quant.calibrate_program(exe, infer, feeds)
    names = quant.ptq.collect_activation_names(infer)
    want = {n: 0.0 for n in names}
    for f in feeds:
        for n, v in zip(names, exe.run(infer, feed=f, fetch_list=names,
                                       scope=scope)):
            want[n] = max(want[n], float(np.max(np.abs(v))))
    scale_bad = [n for n in names if scales[n] != want[n]]
    batch = {"img": feeds[0]["img"][:PTQ_BATCH]}
    cpu_batch = {"img": batch["img"].cpu()}
    fp32 = exe.run(infer, feed=batch, fetch_list=[logits], scope=scope)[0]
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), _cpu_scope(scope)
    with fluid.scope_guard(scope):
        card_sc = quant.calibrate_program(exe, infer, [batch])
    with fluid.scope_guard(cpu_scope):
        cpu_sc = quant.calibrate_program(cpu_exe, infer, [cpu_batch])
    scale_err = {n: abs(card_sc[n] - cpu_sc[n]) / cpu_sc[n] for n in names}
    worst = max(scale_err, key=scale_err.get)
    w = scope.get(fc_w).double().cpu().numpy()
    units = scales[fc_in] / 127.0 * np.sqrt((w * w).sum(0))
    recs = {}
    for gran in ("tensor", "channel"):
        prog = infer.clone()
        quant.apply_ptq(prog, scales, weight_granularity=gran)
        card = exe.run(prog, feed=batch, fetch_list=[logits], scope=scope)[0]
        cpu = cpu_exe.run(prog, feed=cpu_batch, fetch_list=[logits],
                          scope=cpu_scope)[0]
        in_units = float((np.abs(card.astype(np.float64) - cpu)
                          / units[None]).max())
        full = {"img": feeds[0]["img"]}
        _, f_ms = _timed_steps(exe, infer, full, [logits], scope, PTQ_TIMED)
        _, q_ms = _timed_steps(exe, prog, full, [logits], scope, PTQ_TIMED)
        recs[gran] = {
            "ops": len(prog.global_block().ops),
            "card_vs_cpu_in_units_max": in_units,
            "ptq_vs_fp32_rel_err": float(np.linalg.norm(card - fp32)
                                         / np.linalg.norm(fp32)),
            "top1_agreement_vs_fp32": float(
                (card.argmax(1) == fp32.argmax(1)).mean()),
            "fp32_forward_ms_p50": float(np.percentile(f_ms, 50)),
            "ptq_forward_ms_p50": float(np.percentile(q_ms, 50))}
        if not in_units <= PTQ_UNITS:
            _fail(f"33c {gran}: the card's PTQ logits off the CPU's by "
                  f"{in_units} units of the last layer's step")
    rec = {"config": f"resnet.resnet(depth={RESNET_DEPTH}, class_dim="
                     f"{RESNET_CLASSES}) at {RESNET_IMAGE}, test mode, "
                     f"calibrate_program over {PTQ_CALIB} x "
                     f"{PTQ_CALIB_BATCH}, apply_ptq",
           "calibrated": len(names), "scale_mismatches": len(scale_bad),
           "scales_card_vs_cpu_worst": [worst, scale_err[worst]],
           "fc_input_scale": scales[fc_in], "batch": PTQ_BATCH,
           "timed_batch": PTQ_CALIB_BATCH, "by_granularity": recs,
           "card": _card_line()}
    print("ptq resnet50 " + json.dumps(rec))
    if scale_bad:
        _fail(f"33c: scales not numpy's max|act|: {scale_bad[:5]}")
    if not scale_err[worst] <= PTQ_SCALE_RTOL:
        _fail(f"33c: the card's scales off the CPU's: {worst} "
              f"{scale_err[worst]}")
    return rec


def _zipf_ids(rng, shape, r):
    """Log-uniform (Zipfian) ids in [0, r): word frequencies' shape."""
    u = rng.random_sample(shape)
    return np.clip((np.exp(u * np.log(r + 1.0)) - 1.0).astype(np.int64), 0,
                   r - 1)


def lm_feed(device="cuda", seed=SEED + 35):
    """One seeded N-gram batch of LM_BATCH: word_0..3 and next_word (B,
    1) int64, log-uniform over LM_VOCAB."""
    rng = np.random.RandomState(seed)
    return {name: torch.from_numpy(_zipf_ids(rng, (LM_BATCH, 1), LM_VOCAB))
            .to(device) for name in ["word_0", "word_1", "word_2", "word_3",
                                     "next_word"]}


def _lm_program(head):
    """models/word2vec.py's N-gram trunk (build_trunk) at LM_VOCAB with
    `head` ("softmax": the model's own, build_train_net; "nce",
    "hsigmoid", "sampled_softmax") under Adam(LM_LR): (main, startup,
    loss, hidden, the head's op)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import word2vec
    L = fluid.layers
    vocab = LM_VOCAB
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 35
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        if head == "softmax":
            _w, _n, _pred, loss = word2vec.build_train_net(vocab)
            hidden = main.global_block().var(next(
                op for op in main.global_block().ops
                if op.type == "sigmoid").output("Out")[0])
        else:
            _w, nxt, hidden = word2vec.build_trunk(vocab)
            if head == "nce":
                loss = L.mean(L.nce(hidden, nxt, vocab,
                                    num_neg_samples=NCE_NEG,
                                    sampler="log_uniform"))
            elif head == "hsigmoid":
                loss = L.mean(L.hsigmoid(hidden, nxt, vocab))
            else:
                loss = L.mean(L.sampled_softmax_with_cross_entropy(
                    L.fc(hidden, vocab), nxt, SSM_SAMPLES))
        fluid.optimizer.AdamOptimizer(LM_LR).minimize(loss)
    op_type = {"softmax": "softmax", "nce": "nce",
               "hsigmoid": "hierarchical_sigmoid",
               "sampled_softmax": "sample_logits"}[head]
    op = [o for o in main.global_block().ops if o.type == op_type][-1]
    return main, startup, loss, hidden, op


def _softplus64(x):
    return np.logaddexp(0.0, x)


def _log_uniform_q64(c, r):
    c = np.asarray(c, np.float64)
    return np.log1p(1.0 / (c + 1.0)) / np.log(r + 1.0)


def _head_cost64(head, w, b, h, label, draws, vocab):
    """The step's mean cost in float64 numpy from the head's weight and
    bias as they were before the step (`w`, `b`: the card's copies, whose
    needed rows or columns come to the host), the fetched hidden rows
    `h`, the labels and the op's own draws."""
    h = h.astype(np.float64)
    lab = label.reshape(-1)

    def rows(t, idx):
        return t[torch.from_numpy(np.ascontiguousarray(idx)).to(
            t.device)].double().cpu().numpy()

    if head == "softmax":
        logits = h @ w.double().cpu().numpy() + b.double().cpu().numpy()
        mx = logits.max(1, keepdims=True)
        lse = np.log(np.exp(logits - mx).sum(1)) + mx[:, 0]
        return float((lse - logits[np.arange(len(lab)), lab]).mean())
    if head == "nce":
        neg = draws[0, 1:]
        k = float(len(neg))
        pos = (h * rows(w, lab)).sum(1) + rows(b, lab) - \
            np.log(k * _log_uniform_q64(lab, vocab))
        ng = h @ rows(w, neg).T + rows(b, neg)[None] - \
            np.log(k * _log_uniform_q64(neg, vocab))[None]
        return float((_softplus64(-pos) + _softplus64(ng).sum(1)).mean())
    if head == "hsigmoid":
        depth = max(int(vocab - 1).bit_length(), 1)
        code = lab[:, None] + vocab
        bits = np.arange(depth)[None]
        node = (code >> (bits + 1)) - 1
        bit = (code >> bits) & 1
        nd = np.maximum(node, 0)
        s = np.einsum("bd,bld->bl", h, rows(w, nd)) + rows(b, nd)
        return float(np.where(node >= 0, _softplus64(s) - bit * s, 0.0)
                     .sum(1).mean())
    samples = draws[0, 1:]
    idx = np.concatenate([lab[:, None], np.broadcast_to(
        samples[None], (len(lab), len(samples)))], 1)
    cols, inv = np.unique(idx, return_inverse=True)
    sub = h @ rows(w.t(), cols).T + rows(b, cols)
    picked = sub[np.arange(len(lab))[:, None], inv.reshape(idx.shape)]
    picked = picked - np.log(_log_uniform_q64(idx, vocab) * len(samples)
                             + 1e-20)
    picked[:, 1:] += np.where(samples[None] == lab[:, None], -1e20, 0.0)
    mx = picked.max(1, keepdims=True)
    lse = np.log(np.exp(picked - mx).sum(1)) + mx[:, 0]
    return float((lse - picked[:, 0]).mean())


def _head_weights(head, op):
    """The names of the head's weight and bias."""
    if head in ("nce",):
        return op.input("Weight")[0], op.input("Bias")[0]
    if head == "hsigmoid":
        return op.input("W")[0], op.input("Bias")[0]
    return None


def _fc_weights_before(program, logits_name):
    """The fc producing `logits_name` (mul + elementwise_add): its weight
    and bias names."""
    ops = program.global_block().ops
    add = next(o for o in ops if o.type == "elementwise_add"
               and o.output("Out")[0] == logits_name)
    mul = next(o for o in ops if o.type == "mul"
               and o.output("Out")[0] == add.input("X")[0])
    return mul.input("Y")[0], add.input("Y")[0]


def phase_lm_head(head):
    """One large-vocabulary head of phase 33d (_lm_program): HEAD_STEPS
    Adam steps on one seeded batch of LM_BATCH. Gates: every loss finite
    and the last 3 below the first 3 (NCE's: its cost on the first step's
    draws, in float64 from the weights before each step); 0 host syncs
    in a dispatch; the
    first step's cost within HEAD_COST_RTOL of float64 numpy's from the
    weights before that step, the fetched hidden rows and the op's own
    draws (SampleLabels / Samples). Records step p50, device ms and
    operations, peak memory."""
    import paddle_tpu_torch as fluid
    main, startup, loss, hidden, op = _lm_program(head)
    feed = lm_feed()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = _head_weights(head, op) or _fc_weights_before(
        main, op.input("X" if head == "softmax" else "Logits")[0])
    before = [scope.get(n).detach().clone() for n in names]
    draws_var = {"nce": "SampleLabels", "sampled_softmax": "Samples"}.get(
        head)
    fetch = [loss, hidden] + ([op.output(draws_var)[0]] if draws_var
                              else [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    ms = [(time.perf_counter() - t0) * 1e3]
    labels = feed["next_word"].cpu().numpy()
    draws = first[2] if draws_var else None
    want = _head_cost64(head, before[0], before[1], first[1], labels, draws,
                        LM_VOCAB)
    losses, falling = [float(np.ravel(first[0])[0])], [want]
    for _ in range(HEAD_STEPS - 1):
        if head == "nce":
            before = [scope.get(n).detach().clone() for n in names]
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss, hidden],
                      scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.ravel(out[0])[0]))
        if head == "nce":
            # NCE's cost over each step's new draws spreads far past what
            # 6 steps learn: its fall is read on the first step's draws,
            # in float64 from the weights before each step
            falling.append(_head_cost64(head, before[0], before[1], out[1],
                                        labels, draws, LM_VOCAB))
    del before
    if head != "nce":
        falling = losses
    peak = torch.cuda.max_memory_allocated()
    cost_err = abs(losses[0] - want) / abs(want)
    syncs = _dispatch_syncs(exe, main, feed, [loss], scope)
    prof = _profile_ops(lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope), 1)
    head_ms = prof["device_ms_per_step_by_op"].get(op.type, 0.0)
    rec = _seq_record(
        f"lm_{head}", f"word2vec trunk (embed 32, hidden 256, sigmoid) at "
        f"vocab {LM_VOCAB}, head {head}, Adam({LM_LR}), f32", LM_BATCH, ms,
        peak, prof, ops=len(main.global_block().ops), losses=losses,
        cost_vs_float64_rel=cost_err, cost_float64=want,
        **({"costs_on_the_first_draws": falling} if head == "nce"
           else {}),
        head_op_device_ms_per_step_forward=head_ms,
        syncs_in_a_training_dispatch=len(syncs),
        sync_sites=sorted(set(syncs)))
    if not (np.isfinite(losses).all() and _falls(falling)):
        _fail(f"33d {head}: losses not finite or not falling: {losses} "
              f"{falling}")
    if syncs:
        _fail(f"33d {head}: host syncs in a training dispatch: {syncs}")
    if not cost_err <= HEAD_COST_RTOL:
        _fail(f"33d {head}: the cost off float64 numpy's by {cost_err}")
    return rec


def phase_lm_heads():
    """Phase 33d: the four heads (phase_lm_head: the model's full softmax
    as the yardstick, NCE, hsigmoid, the sampled softmax) at LM_VOCAB;
    then KS_DRAWS draws of the log-uniform sampler on the card at
    LM_VOCAB (sampling_ops.draw_classes, the op's draw half): their
    empirical CDF within KS_TOL of log(c + 2) / log(R + 1) at every
    drawn id."""
    from paddle_tpu_torch.ops import sampling_ops
    recs = {}
    for head in ("softmax", "nce", "hsigmoid", "sampled_softmax"):
        recs[head] = phase_lm_head(head)
        gc.collect()
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 36)
    d = sampling_ops.draw_classes(gen, "log_uniform", KS_DRAWS, LM_VOCAB,
                                  None, "cuda")
    if d.dtype != torch.int64:
        _fail(f"33d: draws are {d.dtype}, want int64")
    ids, counts = np.unique(d.cpu().numpy(), return_counts=True)
    ks = float(np.abs(np.cumsum(counts) / KS_DRAWS
                      - np.log(ids + 2.0) / np.log(LM_VOCAB + 1.0)).max())
    recs["log_uniform_ks"] = {"draws": KS_DRAWS, "range": LM_VOCAB,
                              "distinct": int(len(ids)), "ks": ks,
                              "card": _card_line()}
    print("lm log-uniform sampler " + json.dumps(recs["log_uniform_ks"]))
    if not (ids.min() >= 0 and ids.max() < LM_VOCAB and ks <= KS_TOL):
        _fail(f"33d: log-uniform draws off the Zipf CDF: KS {ks}")
    return recs


# the slice's 19 ops (10c.6f)
QUANT_SLICE_OPS = (
    "fake_quantize_abs_max fake_quantize_dequantize_abs_max "
    "fake_channel_wise_quantize_abs_max "
    "fake_channel_wise_quantize_dequantize_abs_max "
    "quantize_dequantize_static_scale fake_quantize_moving_average_abs_max "
    "fake_quantize_dequantize_moving_average_abs_max "
    "fake_dequantize_max_abs fake_channel_wise_dequantize_max_abs "
    "fake_quantize_range_abs_max moving_average_abs_max_scale "
    "nce hierarchical_sigmoid sample_logits "
    "match_matrix_tensor var_conv_2d sequence_scatter "
    "sequence_topk_avg_pooling tree_conv").split()


def _tbcnn_edges(rng, trees, nodes):
    """`trees` random trees of `nodes` nodes as TBCNN's (B, E, 2) edges,
    1-based (parent, child) in BFS order, one tree cut short by a (0, 0)
    pair."""
    edges = np.zeros((trees, nodes, 2), np.int64)
    for t in range(trees):
        for c in range(2, nodes + 1):
            edges[t, c - 2] = (rng.randint(1, c), c)
    edges[-1, nodes // 2] = 0
    return edges


def _quant_op_cases():
    """{case: (inputs, attrs, slot, grad slots)} for every op of
    QUANT_SLICE_OPS at 33e's sizes (MatchPyramid's pair, TBCNN's trees, a
    MobileNet activation and filter); a case's op is its name's first
    word. The samplers' cases hold the full op's inputs and, under
    "Draws", seeded draws that their score halves read
    (SAMPLER_SCORE_HALVES) and the full op does not."""
    rng = np.random.RandomState(SEED + 37)

    def r(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    act = r(16, 64, 28, 28, lo=-4, hi=4)
    filt = r(128, 64, 3, 3)
    ema = {"X": act, "InScale": np.array([2.5], np.float32)}
    qx, ty = r(8, MP_QUERY, MP_EMBED), r(8, MP_TITLE, MP_EMBED)
    mm = r(8, MP_CHANNELS, MP_QUERY, MP_TITLE)
    ql = rng.randint(1, MP_QUERY + 1, 8).astype(np.int64)
    tl = rng.randint(1, MP_TITLE + 1, 8).astype(np.int64)
    vocab, b, d = 50_000, 512, 256
    label = _zipf_ids(rng, (b, 1), vocab)
    ids = rng.randint(-2, MP_TITLE + 2, (8, 64)).astype(np.int64)
    q = "fake_quantize_"
    cases = {
        q + "abs_max": ({"X": act}, {}, "Out", ("X",)),
        q + "dequantize_abs_max": ({"X": act}, {}, "Out", ("X",)),
        "fake_channel_wise_quantize_abs_max": (
            {"X": filt}, {"quant_axis": 0}, "Out", ("X",)),
        "fake_channel_wise_quantize_dequantize_abs_max": (
            {"X": filt}, {"quant_axis": 0}, "OutScale", ("X",)),
        "quantize_dequantize_static_scale": (
            {"X": act}, {"scale": 3.0}, "Out", ("X",)),
        q + "moving_average_abs_max": (
            ema, {"moving_rate": 0.9}, "Out", ("X", "InScale")),
        q + "dequantize_moving_average_abs_max": (
            ema, {"moving_rate": 0.9}, "OutScale", ("X", "InScale")),
        "fake_dequantize_max_abs": (
            {"X": np.round(act * 30), "Scale": np.array([4.0], np.float32)},
            {"max_range": 127.0}, "Out", ()),
        "fake_channel_wise_dequantize_max_abs": (
            {"X": np.round(filt * 127),
             "Scales": [np.abs(r(128)) + 0.1, np.float32(3.0)]},
            {"quant_bits": [8, 8], "quant_axis": 0}, "Out", ()),
        q + "range_abs_max": (
            {"X": act, "InScale": np.array([0.0], np.float32)},
            {"moving_rate": 0.9}, "Out", ("X",)),
        "moving_average_abs_max_scale": (
            ema, {"moving_rate": 0.9}, "OutScale", ("X", "InScale")),
        "nce": ({"Input": r(b, d), "Weight": r(vocab, d), "Bias": r(vocab),
                 "Label": label,
                 "Draws": _zipf_ids(rng, (NCE_NEG,), vocab)},
                {"num_total_classes": vocab, "num_neg_samples": NCE_NEG,
                 "sampler": "log_uniform"}, "Cost",
                ("Input", "Weight", "Bias")),
        "hierarchical_sigmoid": (
            {"X": r(b, d), "W": r(vocab - 1, d), "Bias": r(vocab - 1),
             "Label": label}, {"num_classes": vocab}, "Out",
            ("X", "W", "Bias")),
        "sample_logits": ({"Logits": r(b, vocab, lo=-3, hi=3),
                           "Labels": label,
                           "Draws": _zipf_ids(rng, (SSM_SAMPLES,), vocab)},
                          {"num_samples": SSM_SAMPLES}, "Loss", ("Logits",)),
        "match_matrix_tensor": (
            {"X": qx, "Y": ty, "W": r(MP_EMBED, MP_CHANNELS, MP_EMBED),
             "XLength": ql, "YLength": tl}, {}, "Out", ("X", "Y", "W")),
        "var_conv_2d": ({"X": mm, "W": r(8, MP_CHANNELS, 3, 3), "Row": ql,
                         "Col": tl}, {"strides": [1, 1]}, "Out", ("X", "W")),
        "var_conv_2d stride 2": ({"X": mm, "W": r(8, MP_CHANNELS, 3, 3),
                                  "Row": ql, "Col": tl},
                                 {"strides": [2, 2]}, "Out", ("X", "W")),
        "sequence_scatter": ({"X": r(8, MP_TITLE), "Ids": ids,
                              "Updates": r(8, 64),
                              "Length": rng.randint(1, 65, 8)}, {}, "Out",
                             ("X", "Updates")),
        "sequence_topk_avg_pooling": (
            {"X": r(8, 8, MP_QUERY, MP_TITLE), "Row": ql, "Col": tl},
            {"topks": [1, 3, 5, 10]}, "Out", ("X",))}
    for k in (2, 3):
        cases[f"tree_conv max_depth {k}"] = (
            {"NodesVector": r(TB_TREES, TB_NODES, TB_FEATURE),
             "EdgeSet": _tbcnn_edges(rng, TB_TREES, TB_NODES),
             "Filter": r(TB_FEATURE, 3, TB_OUT, 1), "Bias": r(TB_OUT, 1)},
            {"max_depth": k}, "Out", ("NodesVector", "Filter", "Bias"))
    return cases


def _nce_on_draws(ctx):
    """nce's score half over the case's "Draws"."""
    from paddle_tpu_torch.ops import sampling_ops
    return sampling_ops.nce_score(
        ctx.in_("Input"), ctx.in_("Weight"), ctx.in_("Bias"),
        ctx.in_("Label"), ctx.in_("Draws"), ctx.attr("num_total_classes"),
        ctx.attr("sampler"))


def _sample_logits_on_draws(ctx):
    """sample_logits' score half over the case's "Draws"."""
    from paddle_tpu_torch.ops import sampling_ops
    return sampling_ops.sample_logits_score(
        ctx.in_("Logits"), ctx.in_("Labels"), ctx.in_("Draws"))


# the samplers, held card against CPU through their score halves on
# given draws (a draw of the card's generator is not the CPU's)
SAMPLER_SCORE_HALVES = {"nce": _nce_on_draws,
                        "sample_logits": _sample_logits_on_draws}


def phase_prune_distill():
    """33e's slim on the card. Pruning: slim.Pruner at PRUNE_RATIO on
    every conv filter of MobileNet-v1 at phase 33's width, after minimize,
    PRUNE_STEPS Momentum steps with L2 decay: every pruned entry exactly
    0 after each step. Distillation: a ResNet-50 teacher (its test-mode
    clone) merged into a MobileNet-v1 student at 224², batch
    DISTILL_BATCH, by slim.merge_programs; the student's task loss plus
    soft_label_loss at temperature DISTILL_T over the two nets' logits,
    DISTILL_STEPS Momentum steps: the teacher's persistables bitwise
    unchanged, the loss finite."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import slim
    from paddle_tpu_torch.models import mobilenet, resnet
    main, startup, loss = _vision_program(
        _mobilenet(1, MNV2_IMAGE, MNV2_CLASSES),
        _vision_momentum(MN_LR, MN_DECAY))
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.all_parameters() if len(p.shape) == 4]
    pruner = slim.Pruner()
    pruner.prune(main, scope, {n: PRUNE_RATIO for n in names},
                 startup_program=startup)
    masks = {n: torch.from_numpy(pruner.masks[n]).cuda() for n in names}
    feed = _images_feed(MNV2_BATCH, MNV2_IMAGE, MNV2_CLASSES)
    p_losses, nonzero = [], []
    for _ in range(PRUNE_STEPS):
        p_losses.append(float(np.ravel(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope)[0])[0]))
        nonzero.append(int(sum(int((scope.get(n)[masks[n] == 0] != 0).sum())
                               for n in names)))
    sparsity = min(pruner.sparsity(scope).values())
    # distillation: the teacher first, then the student, in one name
    # space (their startups fill one scope)
    t_main, t_start = fluid.Program(), fluid.Program()
    s_main, s_start = fluid.Program(), fluid.Program()
    t_main.random_seed = t_start.random_seed = SEED + 38
    s_main.random_seed = s_start.random_seed = SEED + 39
    with fluid.unique_name.guard():
        with fluid.program_guard(t_main, t_start):
            img = fluid.layers.data("img", shape=list(MNV2_IMAGE),
                                    dtype="float32")
            resnet.resnet(img, class_dim=MNV2_CLASSES, depth=RESNET_DEPTH)
        with fluid.program_guard(s_main, s_start):
            s_loss = mobilenet.build_train_net(
                version=1, class_dim=MNV2_CLASSES, image_shape=MNV2_IMAGE)[3]
    teacher = t_main.clone(for_test=True)
    t_logits = _fc_of_softmax(teacher)[0]
    s_logits = _fc_of_softmax(s_main)[0]
    d_scope = fluid.Scope()
    exe.run(t_start, scope=d_scope)
    exe.run(s_start, scope=d_scope)
    slim.merge_programs(s_main, teacher, prefix="teacher_", share=("img",),
                        scope=d_scope)
    t_names = ["teacher_" + n for n in teacher.global_block().vars
               if teacher.global_block().vars[n].persistable]
    t_before = {n: d_scope.get(n).clone() for n in t_names
                if d_scope.get(n) is not None}
    opt_start = fluid.Program()
    with fluid.unique_name.guard("distill_"), \
            fluid.program_guard(s_main, opt_start):
        blk = s_main.global_block()
        kd = slim.soft_label_loss(blk.var(s_logits),
                                  blk.var("teacher_" + t_logits),
                                  temperature=DISTILL_T)
        total = fluid.layers.elementwise_add(blk.var(s_loss.name), kd)
        _vision_momentum(MN_LR, MN_DECAY)(fluid).minimize(total)
    exe.run(opt_start, scope=d_scope)
    d_feed = _images_feed(DISTILL_BATCH, MNV2_IMAGE, MNV2_CLASSES,
                          seed=SEED + 39)
    d_losses = [float(np.ravel(exe.run(s_main, feed=d_feed,
                                       fetch_list=[total],
                                       scope=d_scope)[0])[0])
                for _ in range(DISTILL_STEPS)]
    changed = [n for n, v in t_before.items()
               if not torch.equal(d_scope.get(n), v)]
    rec = {"prune": {"weights": len(names), "ratio": PRUNE_RATIO,
                     "steps": PRUNE_STEPS, "losses": p_losses,
                     "pruned_entries_nonzero_after_each_step": nonzero,
                     "min_sparsity": sparsity},
           "distill": {"teacher": f"resnet{RESNET_DEPTH} (test mode)",
                       "student": "mobilenet v1", "batch": DISTILL_BATCH,
                       "temperature": DISTILL_T, "losses": d_losses,
                       "teacher_persistables": len(t_before),
                       "teacher_changed": len(changed)},
           "card": _card_line()}
    print("slim prune distill " + json.dumps(rec))
    if any(nonzero) or sparsity < PRUNE_RATIO:
        _fail(f"33e: pruned weights off zero or sparsity {sparsity}: "
              f"{nonzero}")
    if changed or not t_before or not np.isfinite(d_losses).all():
        _fail(f"33e: distillation changed the teacher ({changed[:3]}) or "
              f"lost a finite loss {d_losses}")
    return rec


def phase_quant_ops():
    """Phase 33e: every op of QUANT_SLICE_OPS on the card against the
    same op on the CPU from one seeded input (_quant_op_cases through
    _ops_card_vs_cpu; the samplers through their score halves on given
    draws), the host syncs of each op's call on the card (the samplers'
    with their draw) gated at 0; then pruning and distillation (phase_prune_distill)."""
    cases = _quant_op_cases()
    if {c.split()[0] for c in cases} != set(QUANT_SLICE_OPS) or \
            len(QUANT_SLICE_OPS) != 19:
        _fail("33e: the op table does not cover the slice's 19 ops")
    errs = _ops_card_vs_cpu("33e", cases, SAMPLER_SCORE_HALVES)
    # the full ops, the samplers with their draws
    syncs = {c: len(_op_syncs(c, ins, attrs))
             for c, (ins, attrs, _s, _g) in cases.items()}
    rec = _ops_record(QUANT_SLICE_OPS, errs, syncs=syncs)
    print("quant slice ops " + json.dumps(rec))
    if any(syncs.values()):
        _fail(f"33e: host syncs in {syncs}")
    rec["slim"] = phase_prune_distill()
    return rec


def phase_quant_all(flash, paged, v1_rec=None):
    """Phases 33-33e. None launches an attention kernel: each is gated at
    0 flash and paged launches (_seq_phase). Returns (the counts over the
    phases, records)."""
    recs, total = {}, (0, 0, 0, 0, 0)
    for key, name, fn, args in (
            ("33", "33 QAT MobileNet-v1", phase_qat_mobilenet, (v1_rec,)),
            ("33b", "33b QAT card vs CPU", phase_qat_agree, ()),
            ("33c", "33c PTQ ResNet-50", phase_ptq_resnet, ()),
            ("33d", "33d the heads at 793,471 words", phase_lm_heads, ()),
            ("33e", "33e the slice's ops card vs CPU, slim",
             phase_quant_ops, ())):
        recs[key], counts = _seq_phase(name, fn, flash, paged, *args)
        total = tuple(x + y for x, y in zip(total, counts))
    return total, recs


# ---------------------------------------------------------------------------
# phases 34-34d: sharded state under CompiledProgram
# ---------------------------------------------------------------------------

def _annotate(main, form):
    """The transpiler's annotations of `form`: ZeRO-1
    (shard_optimizer_state), FSDP (shard_params_fsdp) or both (the
    fleet's use_fsdp); "plain" none."""
    from paddle_tpu_torch.parallel import (shard_optimizer_state,
                                           shard_params_fsdp)
    if form in ("zero1", "both"):
        shard_optimizer_state(main)
    if form in ("fsdp", "both"):
        shard_params_fsdp(main, min_size=FSDP_MIN_SIZE)
    return main


def _laid_out(scope):
    from paddle_tpu_torch.parallel import ShardedTensor
    return {n: scope.get(n) for n in scope.names()
            if isinstance(scope.get(n), ShardedTensor)}


def _scope_shares(main, scope, mesh):
    """(the elements `scope` holds, summed over every value: a sharded
    value's parts, any other tensor whole; the elements it holds when each
    persistable holds its share by its dist_attr's placement over `mesh`
    and the rest whole; the persistables a dist_attr lays out that the
    scope holds whole). A whole copy of a sharded variable makes the
    first exceed the second."""
    from paddle_tpu_torch.parallel import ShardedTensor
    from paddle_tpu_torch.parallel.sharded import placement_spec
    attrs = {v.name: getattr(v, "dist_attr", None) for v in main.list_vars()}
    held = share = 0
    whole = []
    for n in scope.names():
        v = scope.get(n)
        if not isinstance(v, (torch.Tensor, ShardedTensor)):
            continue
        held += v.numel()
        spec = placement_spec(attrs.get(n), tuple(v.shape), mesh)
        ways = int(np.prod([mesh.shape[a] for e in spec if e is not None
                            for a in (e if isinstance(e, tuple)
                                      else (e,))]))
        share += int(np.prod(v.shape)) // ways
        if ways > 1 and not isinstance(v, ShardedTensor):
            whole.append(n)
    return held, share, whole


def _shard_shapes_want(main, mesh):
    """{name: [part shape] * parts} of every parameter a dist_attr lays
    out over `mesh`, by the placement rule (JAX's _var_sharding)."""
    from paddle_tpu_torch.parallel.sharded import (is_replicated,
                                                   placement_spec)
    out = {}
    for p in main.all_parameters():
        spec = placement_spec(p.dist_attr, tuple(p.shape), mesh)
        if is_replicated(spec):
            continue
        n = 1
        shape = list(p.shape)
        for d, e in enumerate(spec):
            if e is not None:
                k = mesh.shape[e]
                shape[d] //= k
                n *= k
        out[p.name] = [shape] * n
    return out


def _tp_reductions(layers):
    """The tp rules' reductions a BERT step: the vocab-split lookup, each
    layer's attention and FFN sums, and the gather of the vocab-split
    MLM logits that softmax_with_cross_entropy reads whole."""
    return 2 * layers + 2


def phase_tp_train(flash, bert16, prof16):
    """Phase 34: phase 16's cell with apply_shard_rules under
    CompiledProgram(main).with_mesh(make_mesh(tp=2, devices=["cuda:0"] *
    2)): BERT_WARM + TP_TRAIN_STEPS steps and a profile, 24 + 24 + 24
    flash launches a step (12 layers x 2 ranks, 6 heads each), the tp
    rules' reductions, the parts' shapes; then the 2-layer net at tp 2
    against tp 1. Returns ((fwd, dQ, dK/dV, bf16 fwd) launches of the
    run, its record)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import apply_shard_rules, make_mesh
    cfg = bert_config()
    main, startup, loss = build_bert(cfg)
    apply_shard_rules(main)
    mesh = make_mesh(tp=TP, devices=["cuda:0"] * TP)
    comp = fluid.CompiledProgram(main).with_mesh(mesh)
    feed = bert_feed()
    exe = fluid.Executor()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = cfg.num_hidden_layers
    steps = BERT_WARM + TP_TRAIN_STEPS
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        _zero_counts(flash)
        red0 = mesh.reductions
        losses, step_ms, per_step, tc = _train_run(
            flash, exe, comp, feed, loss, steps, BERT_WARM)
        counts = _bwd_counts(flash)
        reductions = mesh.reductions - red0
        peak = torch.cuda.max_memory_allocated()
        shapes = {k: [list(p.shape) for p in v.parts]
                  for k, v in _laid_out(scope).items()}
        prof = _profile_train(lambda: exe.run(comp, feed=feed,
                                              fetch_list=[loss]),
                              BERT_PROFILE_STEPS)
    want_shapes = _shard_shapes_want(main, mesh)
    if per_step != {(TP * n,) * 3} or tc or counts != (steps * TP * n,) * 3:
        _fail(f"tp: flash launches fwd/dq/dkv per step {per_step} (run "
              f"{counts}), want {TP} x {n} each; {tc} tensor-core")
    if reductions != steps * _tp_reductions(n):
        _fail(f"tp: {reductions} reductions in {steps} steps, want "
              f"{_tp_reductions(n)} a step")
    h, v = cfg.hidden_size, cfg.vocab_size       # 768 and 30522
    if {k: x for k, x in shapes.items() if k in want_shapes} != \
            want_shapes or shapes["enc0_attn_q"] != [[h, h // TP]] * TP \
            or shapes["word_embedding"] != [[v // TP, h]] * TP:
        _fail(f"tp: parts {shapes}, want {want_shapes}")
    first, last = losses[0], losses[-1]
    if not np.isfinite(losses).all() or not last < BERT_LOSS_MARGIN * first:
        _fail(f"tp: loss not finite or not below {BERT_LOSS_MARGIN} x the "
              f"first: {losses}")
    agree = _tp_agree(flash)
    mean_ms = float(np.mean(step_ms))
    out = {"config": "BertConfig(max_position_embeddings=512)",
           "mesh": f"local tp {TP} on cuda:0", "card": _card_line(),
           "seq_len": BERT_SEQ, "batch": BERT_BATCH,
           "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "step_ms_mean": mean_ms,
           "tokens_per_s": BERT_BATCH * BERT_SEQ / (mean_ms / 1e3),
           "max_memory_allocated": peak, "loss_first": first,
           "loss_last": last, "loss_ratio": last / first,
           "reductions_per_step": reductions / steps,
           "flash_launches_fwd_dq_dkv": list(counts),
           "flash_launches_per_step": list(next(iter(per_step))),
           "parts": {k: shapes[k] for k in ("enc0_attn_q", "enc0_attn_o",
                                            "enc0_ffn0_w", "enc0_ffn1_w",
                                            "word_embedding")},
           "tp2_vs_tp1": agree[1]}
    print("tp train " + json.dumps(out))
    print("profile tp train " + json.dumps(prof))
    keys = ("step_ms_p50", "step_ms_p99", "tokens_per_s",
            "max_memory_allocated", "loss_first", "loss_last")
    pkeys = ("wall_ms_per_step", "device_ms_per_step", "device_busy_share",
             "device_ops_per_step", "flash_share_of_device")
    print(f"tp {TP} vs 16 (f32): " + json.dumps(
        {**{k: [out[k], bert16[k]] for k in keys},
         **{k: [prof[k], prof16[k]] for k in pkeys}}))
    return counts + (tc,), out, agree[0]


def _tp_agree(flash):
    """34's agreement: the 2-layer net (dropout 0) at tp 2 against tp 1
    through the kernels, BERT_AGREE_STEPS steps: the first loss within
    DP_FIRST_LOSS_TOL, the first step's gathered @GRADs within DP_GRAD_TOL
    of their scale. Returns (the tp 2 run's launches, errors)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import apply_shard_rules, make_mesh
    main, startup, loss = dp_agree_program()
    apply_shard_rules(main)
    feed = dp_agree_feed()
    exe = fluid.Executor()
    base = fluid.Scope()
    with fluid.scope_guard(base):
        exe.run(startup)
    names = [p.name for p in main.all_parameters()]
    runs = {}
    for tp in (1, TP):
        comp = fluid.CompiledProgram(main).with_mesh(
            make_mesh(tp=tp, devices=["cuda:0"] * tp))
        runs[tp] = _dp_steps(flash, _runner(exe, comp, feed), base, loss,
                             names, BERT_AGREE_STEPS)
    layers, steps = BERT_AGREE_LAYERS, BERT_AGREE_STEPS
    want = {1: (layers * steps,) * 3 + (0,),
            TP: (TP * layers * steps,) * 3 + (0,)}
    if runs[1][2] != want[1] or runs[TP][2] != want[TP]:
        _fail(f"tp agree: launches tp 1 {runs[1][2]}, tp {TP} "
              f"{runs[TP][2]}, want {want}")
    return runs[TP][2], _staged(f"tp agree: tp {TP} vs tp 1", runs[TP],
                                runs[1], names, DP_FIRST_LOSS_TOL,
                                DP_GRAD_TOL)


def _same_bits(a, b):
    return a[0] == b[0] and all(torch.equal(x, y)
                                for x, y in zip(a[1], b[1]))


def phase_shard_dp(flash, rec21, prof21):
    """Phase 34b: ZeRO-1 and FSDP at a local dp DP on cuda:0. The 12-layer
    net under both for BERT_WARM + SHARD_STEPS steps and a profile (first:
    its peak memory then holds nothing else, as phase 21's); then the
    2-layer net four ways (plain, ZeRO-1, FSDP, both) for BERT_AGREE_STEPS
    steps, gated bitwise (the CPU twin's result: a gather concatenates the
    same values and the optimizer ops are elementwise). Returns
    ((fwd, dQ, dK/dV, bf16 fwd) launches of the 12-layer run, the
    2-layer runs by form, the both-form scope after BERT_AGREE_STEPS, its
    program and loss, the record)."""
    import paddle_tpu_torch as fluid
    exe = fluid.Executor()
    cfg = bert_config()
    main, startup, loss = build_bert(cfg)
    _annotate(main, "both")
    comp = _dp_program(main, loss, [fluid.CUDAPlace(0)] * DP)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = cfg.num_hidden_layers
    steps = BERT_WARM + SHARD_STEPS
    big = fluid.Scope()
    with fluid.scope_guard(big):
        exe.run(startup)
        _zero_counts(flash)
        red0 = comp.mesh.reductions
        losses, step_ms, per_step, tc = _train_run(
            flash, exe, comp, bert_feed(), loss, steps, BERT_WARM)
        counts = _bwd_counts(flash)
        reductions = comp.mesh.reductions - red0
        peak = torch.cuda.max_memory_allocated()
        laid = _laid_out(big)
        params = sum(p.name in laid for p in main.all_parameters())
        prof = _profile_train(lambda: exe.run(comp, feed=bert_feed(),
                                              fetch_list=[loss]),
                              BERT_PROFILE_STEPS)
    del big
    feed = dp_agree_feed()
    # a new Executor: the startup's draws fold in its step counter, so the
    # forms start from the state 34c's world ranks start from
    exe = fluid.Executor()
    runs, agree = {}, {}
    base = None
    for form in SHARD_FORMS:
        main, startup, loss = dp_agree_program()
        _annotate(main, form)
        if base is None:
            base = fluid.Scope()
            with fluid.scope_guard(base):
                exe.run(startup)
            names = [p.name for p in main.all_parameters()]
        comp = _dp_program(main, loss, [fluid.CUDAPlace(0)] * DP)
        red0 = comp.mesh.reductions
        runs[form] = _dp_steps(flash, _runner(exe, comp, feed), base, loss,
                               names, BERT_AGREE_STEPS)
        agree[form] = {"losses": runs[form][0],
                       "reductions_per_step": (comp.mesh.reductions - red0)
                       / BERT_AGREE_STEPS}
        if form == "both":
            both = (main, loss, comp)
        if not _same_bits(runs[form], runs["plain"]):
            _fail(f"34b: {form} at dp {DP} is not plain dp {DP}'s bits: "
                  f"losses {runs[form][0]} vs {runs['plain'][0]}")
    want = (DP * BERT_AGREE_LAYERS * BERT_AGREE_STEPS,) * 3 + (0,)
    if any(r[2] != want for r in runs.values()):
        _fail(f"34b: launches {[r[2] for r in runs.values()]}, want {want}")
    # the both-form scope after BERT_AGREE_STEPS, for 34d
    scope = _copy_scope(base)
    with fluid.scope_guard(scope):
        for _ in range(BERT_AGREE_STEPS):
            exe.run(both[2], feed=feed, fetch_list=[both[1]])
    if per_step != {(DP * n,) * 3} or tc or counts != (steps * DP * n,) * 3:
        _fail(f"34b: flash launches fwd/dq/dkv per step {per_step} (run "
              f"{counts}), want {DP} x {n} each; {tc} tensor-core")
    if reductions != steps * (DP_REDUCTIONS + params):
        _fail(f"34b: {reductions} reductions in {steps} steps, want "
              f"{DP_REDUCTIONS} + {params} gathers a step")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        _fail(f"34b: loss not finite or not falling: {losses}")
    mean_ms = float(np.mean(step_ms))
    out = {"config": "BertConfig(max_position_embeddings=512)",
           "mesh": f"local dp {DP} on cuda:0, FSDP + ZeRO-1",
           "card": _card_line(), "forms_2_layers": agree,
           "bitwise_across_forms": True, "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_mean": mean_ms,
           "max_memory_allocated": peak, "loss_first": losses[0],
           "loss_last": losses[-1], "sharded_params": params,
           "sharded_values": len(laid),
           "reductions_per_step": reductions / steps,
           "flash_launches_fwd_dq_dkv": list(counts)}
    print("shard dp " + json.dumps(out))
    print("profile shard dp " + json.dumps(prof))
    print(f"34b FSDP + ZeRO-1 vs 21 plain dp {DP}: " + json.dumps(
        {"step_ms_p50": [out["step_ms_p50"], rec21["step_ms_p50"]],
         "max_memory_allocated": [peak, rec21["max_memory_allocated"]],
         **{k: [prof[k], prof21[k]] for k in ("device_ms_per_step",
                                              "device_ops_per_step")}}))
    paths = {f"34b FSDP + ZeRO-1 dp {DP} BERT-base ({steps} steps)":
             counts + (tc,),
             f"34b dp {DP} forms (kernel runs, {len(SHARD_FORMS)} x "
             f"{BERT_AGREE_LAYERS} layers x {BERT_AGREE_STEPS} steps)":
             tuple(sum(r[2][i] for r in runs.values()) for i in range(4))}
    return paths, runs, (both[0], both[1], scope), out


def _state_bits(scope):
    """{name: the global value on the host} of every persistable."""
    from paddle_tpu_torch.io.state import host_array
    return {n: host_array(scope.get(n)) for n in scope.names()}


def phase_shard_ckpt(flash, state):
    """Phase 34d: 34b's 2-layer FSDP + ZeRO-1 scope at dp DP after
    BERT_AGREE_STEPS steps: an async sharded save, CKPT_DIVERGE diverging
    steps, a restore onto the dp DP mesh (bitwise, with its specs), onto
    a dp CKPT_ELASTIC_DP mesh (loaded whole and laid out by the walk:
    word_embedding's 30522 rows stay replicated there; a load with that
    mesh raises as jax.device_put would) and onto no mesh; CKPT_CONTINUE
    steps on each within DP_LATER_LOSS_TOL of the dp DP continuation."""
    import shutil
    import tempfile
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.compiler import DataParallelWalk
    from paddle_tpu_torch.io.checkpoint import _safe_name
    from paddle_tpu_torch.parallel import ShardedTensor, make_mesh
    main, loss, scope = state
    feed = dp_agree_feed()
    other = dict(feed)
    other["mask_label"] = np.roll(feed["mask_label"], 1)
    exe = fluid.Executor()
    mesh = make_mesh(dp=DP, devices=["cuda:0"] * DP)
    comp = fluid.CompiledProgram(main).with_mesh(mesh)
    _zero_counts(flash)
    with fluid.scope_guard(scope):
        exe.run(comp, feed=feed, fetch_list=[loss])   # lays it out on mesh
    laid = _laid_out(scope)
    root = tempfile.mkdtemp(prefix="shard_ckpt_")
    try:
        ck = os.path.join(root, "ckpt")
        saved = _state_bits(scope)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            handle = fluid.io.save_checkpoint_sharded(
                exe, ck, main_program=main, step=BERT_AGREE_STEPS + 1,
                async_save=True)
        handle.wait()
        save_s = time.perf_counter() - t0
        files = os.listdir(os.path.join(ck, "shards"))
        written = sum(os.path.getsize(os.path.join(ck, "shards", f))
                      for f in files)
        for name, v in laid.items():
            # a file's array, not its size: the .npy header outweighs a
            # 2-element moment's half
            mine = [np.load(os.path.join(ck, "shards", f), mmap_mode="r")
                    for f in files
                    if f.rsplit("--", 1)[0] == _safe_name(name)]
            if len(mine) != DP or any(a.nbytes >= saved[name].nbytes
                                      for a in mine):
                _fail(f"34d: {name} has {len(mine)} shard files of "
                      f"{[a.nbytes for a in mine]} B, want {DP} each "
                      f"smaller than the {saved[name].nbytes} B array")
        with fluid.scope_guard(scope):
            for _ in range(CKPT_DIVERGE):
                exe.run(comp, feed=other, fetch_list=[loss])
        if all(np.array_equal(_state_bits(scope)[n], saved[n])
               for n in laid):
            _fail("34d: the diverging steps changed nothing")
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            meta = fluid.io.load_checkpoint_sharded(exe, ck,
                                                    main_program=main,
                                                    mesh=mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if meta["step"] != BERT_AGREE_STEPS + 1:
            _fail(f"34d: restored step {meta['step']}")
        got = _state_bits(scope)
        bad = [n for n in saved if not np.array_equal(got[n], saved[n])]
        specs = [n for n, v in laid.items()
                 if not isinstance(scope.get(n), ShardedTensor)
                 or scope.get(n).spec != v.spec]
        if bad or specs:
            _fail(f"34d: dp {DP} restore not bitwise for {bad[:5]}, "
                  f"specs lost for {specs[:5]}")
        ref = _continue(exe, comp, feed, loss, scope)
        mesh4 = make_mesh(dp=CKPT_ELASTIC_DP,
                          devices=["cuda:0"] * CKPT_ELASTIC_DP)
        try:
            fluid.io.load_checkpoint_sharded(exe, ck, main_program=main,
                                             mesh=mesh4, scope=fluid.Scope())
            _fail(f"34d: a load onto dp {CKPT_ELASTIC_DP} laid "
                  f"word_embedding's 30522 rows out")
        except ValueError:
            pass
        out = {"card": _card_line(), "bytes_written": written,
               "files": len(files), "save_s": save_s,
               "restore_s": restore_s,
               "save_gb_per_s": written / save_s / 1e9,
               "restore_gb_per_s": written / restore_s / 1e9,
               "sharded_values": len(laid),
               f"continuation_dp{DP}": ref}
        for tag, mesh_n in ((f"dp{CKPT_ELASTIC_DP}", mesh4),
                            ("no_mesh", None)):
            new = fluid.Scope()
            with fluid.scope_guard(new):
                fluid.io.load_checkpoint_sharded(exe, ck, main_program=main)
            if mesh_n is not None:
                DataParallelWalk(mesh_n, exe.device).place_state(main, new)
                if isinstance(new.get("word_embedding"), ShardedTensor):
                    _fail(f"34d: word_embedding laid out at dp "
                          f"{CKPT_ELASTIC_DP}")
                prog = fluid.CompiledProgram(main).with_mesh(mesh_n)
            else:
                prog = main
            got = _state_bits(new)
            bad = [n for n in saved if not np.array_equal(got[n], saved[n])]
            if bad:
                _fail(f"34d: {tag} restore not bitwise for {bad[:5]}")
            losses = _continue(exe, prog, feed, loss, new)
            err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            if err > DP_LATER_LOSS_TOL:
                _fail(f"34d: {tag} continuation {losses} vs dp {DP}'s {ref}")
            out[f"continuation_{tag}"] = losses
            out[f"continuation_{tag}_rel_err"] = err
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = _bwd_counts(flash) + (flash.TC_LAUNCHES,)
    # dp 2: 1 + CKPT_DIVERGE + CKPT_CONTINUE steps; dp 4: CKPT_CONTINUE;
    # the plain Program: CKPT_CONTINUE steps of one rank
    layers = BERT_AGREE_LAYERS
    n = layers * (DP * (1 + CKPT_DIVERGE + CKPT_CONTINUE)
                  + CKPT_ELASTIC_DP * CKPT_CONTINUE + CKPT_CONTINUE)
    if launches != (n, n, n, 0):
        _fail(f"34d: flash launches {launches}, want {n} each")
    print("shard ckpt " + json.dumps(out))
    return {f"34d sharded checkpoint ({layers} layers, dp {DP}, dp "
            f"{CKPT_ELASTIC_DP} and plain steps)": launches}, out


def _continue(exe, program, feed, loss, scope):
    import paddle_tpu_torch as fluid
    with fluid.scope_guard(scope):
        return [float(np.asarray(exe.run(program, feed=feed,
                                         fetch_list=[loss])[0])
                      .reshape(-1)[0]) for _ in range(CKPT_CONTINUE)]


def phase_shard_all(flash, bert16, prof16, rec21, world):
    """Phases 34-34d (34c ran inside 21d's two processes: `world` is its
    record, checked here against 34b's local runs). Returns (flash
    launches by path, records)."""
    tlaunches, trec, tagree = _phase("34 tp 2 BERT-base", phase_tp_train,
                                     flash, bert16, prof16)
    spaths, runs, state, srec = _phase("34b ZeRO-1 / FSDP dp 2",
                                       phase_shard_dp, flash, *rec21)
    wrec = _phase("34c world FSDP / ZeRO-1 (checked)", check_shard_world,
                  world, runs)
    cpaths, crec = _phase("34d sharded checkpoint", phase_shard_ckpt,
                          flash, state)
    paths = {f"34 tp {TP} BERT-base ({BERT_WARM + TP_TRAIN_STEPS} steps)":
             tlaunches,
             f"34 tp {TP} agree (kernel run, {BERT_AGREE_LAYERS} layers x "
             f"{BERT_AGREE_STEPS} steps)": tagree,
             **spaths, **world["launches"], **cpaths}
    return paths, {"34": trec, "34b": srec, "34c": wrec, "34d": crec}


# ---------------------------------------------------------------------------
# phases 35-35c: fleet collective training (launcher, fleet, strategy)
# ---------------------------------------------------------------------------

def build_bert_fleet(cfg, flt):
    """build_bert's net with its Adam through fleet:
    flt.distributed_optimizer(AdamOptimizer(1e-4)).minimize(loss), which
    applies the strategy (tp's shard rules, ZeRO-1)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 16
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _f, loss, _mlm, _acc = bert.build_pretrain_net(cfg, seq_len=BERT_SEQ)
        flt.distributed_optimizer(
            fluid.optimizer.AdamOptimizer(1e-4)).minimize(loss)
    return main, startup, loss


def _fleet(tp=TP, zero=0, devices=None):
    """A Fleet initialized with DistributedStrategy(tp_degree=`tp`,
    zero_stage=`zero`): over the launcher's world, or a one-process mesh
    of `devices`."""
    from paddle_tpu_torch.parallel import fleet as fleet_mod
    s = fleet_mod.DistributedStrategy()
    s.tp_degree, s.zero_stage, s.local_devices = tp, zero, devices
    return fleet_mod.Fleet().init(strategy=s)


def _first_steps(flash, main, startup, loss, program, feed, steps):
    """`steps` steps of `program` after a fresh Executor's run of
    `startup` (the draws every run of this program starts from, a world
    rank's too): (losses, the first step's @GRADs on the card, their
    names, (fwd, dQ, dK/dV) launches a step)."""
    import paddle_tpu_torch as fluid
    exe = fluid.Executor()
    names = [p.name for p in main.all_parameters()]
    losses, per_step = [], []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        for i in range(steps):
            before = _bwd_counts(flash)
            out = exe.run(program, feed=feed, fetch_list=[loss] + (
                [n + "@GRAD" for n in names] if i == 0 else []),
                return_numpy=False)
            per_step.append([a - b for a, b in zip(_bwd_counts(flash),
                                                   before)])
            losses.append(out[0].double().item())
            if i == 0:
                grads = out[1:]
    return losses, grads, names, per_step


def _grad_gate(got, want, names, want_names, tol):
    """(the worst @GRAD error over its tensor's scale plus 1e-3 of the
    largest gradient (_grad_rel_err's), its name, and whether every
    tensor is within `tol` of its scale); the two runs' parameter names
    must be equal, or the tensors would be paired wrongly."""
    if list(names) != list(want_names):
        raise RuntimeError("the reference's parameters differ")
    floor = 1e-3 * max(g.abs().max().item() for g in want)
    worst, name = 0.0, None
    for nm, a, b in zip(names, got, want):
        err = (a - b).abs().max().item() / (b.abs().max().item() + floor)
        if err > worst:
            worst, name = err, nm
    return worst, name, worst <= tol


def _save_ref(path, ref):
    losses, grads, names, _per_step = ref
    torch.save({"losses": losses, "grads": [g.cpu() for g in grads],
                "names": names}, path)


def _against(path, losses, grads, names, tol):
    """A world rank's run against the parent's reference at `path`: the
    errors of 21's staged comparison (first loss within
    DP_FIRST_LOSS_TOL, later losses, @GRADs within `tol` of their scale
    by _grad_gate), computed on the card."""
    ref = torch.load(path, map_location="cuda:0")
    first = abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0])
    later = max([abs(a - b) / abs(b) for a, b in
                 zip(losses[1:], ref["losses"][1:])] or [0.0])
    grad, worst, ok = _grad_gate(grads, ref["grads"], names, ref["names"],
                                 tol)
    return {"first_loss_rel_err": first, "later_loss_rel_err": later,
            "grad_rel_err": grad, "worst": worst, "grad_tol": tol,
            "ok": ok and first <= DP_FIRST_LOSS_TOL
            and later <= DP_LATER_LOSS_TOL}


class _timed_gloo:
    """Time every torch.distributed call of the step whose index (from 0,
    counted by the Executor's runs inside) is `at`: the calls are wrapped
    for that step only."""

    def __init__(self, acc, at):
        import torch.distributed as dist
        self.acc, self.at, self.dist = acc, at, dist
        self.real = {k: getattr(dist, k) for k in (
            "all_reduce", "all_gather", "batch_isend_irecv")}

    def __enter__(self):
        import paddle_tpu_torch as fluid
        self.step = 0
        self.run = fluid.Executor.run
        acc, real, dist, me = self.acc, self.real, self.dist, self

        def timed(fn):
            def call(*a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                acc["ms"] += (time.perf_counter() - t) * 1e3
                acc["calls"] += 1
                return r
            return call

        def run(exe, *a, **k):
            if me.step == me.at:
                for name, fn in real.items():
                    setattr(dist, name, timed(fn))
            try:
                return me.run(exe, *a, **k)
            finally:
                for name, fn in real.items():
                    setattr(dist, name, fn)
                me.step += 1

        fluid.Executor.run = run
        return self

    def __exit__(self, *exc):
        import paddle_tpu_torch as fluid
        fluid.Executor.run = self.run
        for name, fn in self.real.items():
            setattr(self.dist, name, fn)
        return False


def _world_tp(flash, flt, out):
    """Phase 35's main form in one rank: phase 34's cell through fleet
    (tp 2 over the world), FLEET_STEPS steps: losses, launches and
    reductions a step, the first step's @GRADs against the parent's local
    tp 2 run, one step's step ms and (a later one's) gloo ms, the scope's
    shares."""
    import paddle_tpu_torch as fluid
    main, startup, loss = build_bert_fleet(bert_config(), flt)
    mesh = flt.mesh()
    comp = fluid.CompiledProgram(main).with_mesh(mesh)
    feed = bert_feed()
    exe = fluid.Executor()
    names = [p.name for p in main.all_parameters()]
    rec = {"losses": [], "launches": [], "reductions": [], "step_ms": []}
    gloo = {"ms": 0.0, "calls": 0}
    tc0 = flash.TC_LAUNCHES
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        _wait_go(out)
        with _timed_gloo(gloo, FLEET_STEPS - 1):
            for i in range(FLEET_STEPS):
                before, red0 = _bwd_counts(flash), mesh.reductions
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = exe.run(comp, feed=feed, fetch_list=[loss] + (
                    [n + "@GRAD" for n in names] if i == 0 else []),
                    return_numpy=False)
                rec["losses"].append(got[0].double().item())
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                rec["reductions"].append(mesh.reductions - red0)
                rec["launches"].append([a - b for a, b in zip(
                    _bwd_counts(flash), before)])
                if i == 0:
                    grads = got[1:]
        rec["shares"] = list(_scope_shares(main, scope, mesh))
    rec["tc"] = flash.TC_LAUNCHES - tc0
    rec["gloo_ms_last_step"] = gloo["ms"]
    rec["gloo_calls_last_step"] = gloo["calls"]
    rec["vs_local"] = _against(os.path.join(out, "ref_tp.pt"),
                               rec["losses"][:1], grads, names,
                               FLEET_GRAD_TOL)
    rec["peak_memory"] = torch.cuda.max_memory_allocated()
    return rec


def _wait_go(out):
    """Block until the parent writes <out>/go: 35's ranks boot, build and
    start up while 35c's world runs, and take their timed steps alone."""
    deadline = time.monotonic() + FLEET_WORLD_TIMEOUT_S
    while not os.path.exists(os.path.join(out, "go")):
        if time.monotonic() > deadline:
            raise RuntimeError("no go from the parent")
        time.sleep(0.05)


def _world_sp(flash, out):
    """Phase 35's second form in the same processes: the 2-layer net over
    the world's sp 2 line (dp 1), BERT_AGREE_STEPS steps, against the
    parent's local sp 2 run; the ring's K/V rotate between the two
    processes."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import make_mesh
    main, startup, loss = dp_agree_program()
    mesh = make_mesh(sp=2)
    comp = fluid.CompiledProgram(main).with_mesh(mesh)
    tc0 = flash.TC_LAUNCHES
    losses, grads, names, per_step = _first_steps(
        flash, main, startup, loss, comp, dp_agree_feed(), BERT_AGREE_STEPS)
    return {"losses": losses, "launches": per_step,
            "tc": flash.TC_LAUNCHES - tc0,
            "vs_local": _against(os.path.join(out, "ref_sp.pt"), losses,
                                 grads, names, DP_GRAD_TOL)}


def _world_ops(rank, n):
    """The collective ops on CUDA tensors over the world's dp line inside
    ``collective.mapped``, against numpy: {op: (max relative error, exact
    required)}. prod runs over mixed signs and a zero."""
    from paddle_tpu_torch.ops import _REGISTRY
    from paddle_tpu_torch.parallel import collective, make_mesh
    mesh = make_mesh(dp=n)
    mixed = np.arange(n * 6, dtype=np.float32).reshape(n, 6) - 4.0
    mixed[0, 1] = 0.0
    rows = np.stack([np.arange(n * 4, dtype=np.float32) + 10 * r
                     for r in range(n)])
    mine = torch.from_numpy(mixed[rank].copy()).cuda()
    row = torch.from_numpy(rows[rank].copy()).cuda()
    cases = [
        ("c_allreduce_sum", mine, mixed.sum(0), False),
        ("c_allreduce_max", mine, mixed.max(0), True),
        ("c_allreduce_min", mine, mixed.min(0), True),
        ("c_allreduce_prod", mine, mixed.prod(0), False),
        ("c_broadcast", mine, mixed[1], True),
        ("c_allgather", mine[None], mixed, True),
        ("c_reducescatter", row, rows.sum(0).reshape(n, -1)[rank], False),
        ("alltoall", row, np.concatenate([rows[s].reshape(n, -1)[rank]
                                          for s in range(n)]), True)]
    errs = {}
    with collective.mapped(mesh):
        for op, x, want, exact in cases:
            class Ctx:
                def in_(self, slot, default=None):
                    return x

                def attr(self, name, default=None):
                    return {"axis_name": "dp", "root": 1}.get(name,
                                                              default)
            got = _REGISTRY[op](Ctx())["Out"]
            if got.device != x.device:
                raise RuntimeError(f"{op} left the card")
            diff = np.abs(got.cpu().numpy() - want)
            errs[op] = [float((diff / np.maximum(np.abs(want), 1.0)).max()),
                        exact]
    return errs


def _world_shuffle(flt, rank, n, out):
    """InMemoryDataset.global_shuffle(fleet=) over the processes, each
    having loaded its own file of 4 records: the union of the shards."""
    import torch.distributed as dist
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import dataset as ds
    with fluid.program_guard(fluid.Program(), fluid.Program()):
        xvar = fluid.layers.data("x", shape=[1], dtype="int64")
    path = os.path.join(out, f"shuffle{rank}.txt")
    with open(path, "w") as f:
        for v in range(rank * 4, rank * 4 + 4):
            f.write(f"1 {v}\n")
    d = ds.InMemoryDataset()
    d.set_batch_size(2)
    d.set_use_var([xvar])
    d.set_filelist([path])
    d.set_shuffle_seed(11)
    d.load_into_memory()
    d.global_shuffle(fleet=flt)
    mine = sorted(int(b["x"][r, 0]) for b in d._iter_batches()
                  for r in range(b["x"].shape[0]))
    every = [None] * n
    dist.all_gather_object(every, mine)
    return sorted(v for m in every for v in m)


def fleet_world_rank(form, out):
    """One rank of phase 35's, 35c's or 36b's world (`--fleet-world-rank`;
    36b's is pp_world_rank), started by ``python -m
    paddle_tpu_torch.distributed.launch``:
    fleet.init joins the world (gloo: the launcher's layout puts every
    rank on cuda:0), then 35 runs the tp 2 form, the sp 2 form, the
    collective ops, the barrier and the shuffle; 35c the dp 2 x tp 2 +
    ZeRO-1 form at 2 layers. Writes <out>/rank<r>.json."""
    import torch.distributed as dist
    from paddle_tpu_torch.ops.cuda import flash
    if form == "36b":
        return pp_world_rank(out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    flt = _fleet(zero=1 if form == "35c" else 0)
    rank, n = flt.worker_index(), flt.worker_num()
    try:
        flash.build()
        flash.build_bwd()
        rec = {"backend": flt.backend, "rank": rank,
               "mesh": dict(flt.mesh().shape),
               "boot_s": time.perf_counter() - t0}
        if form == "35":
            rec["tp"] = _world_tp(flash, flt, out)
            rec["sp"] = _world_sp(flash, out)
            rec["ops"] = _world_ops(rank, n)
            t = time.perf_counter()
            flt.barrier_worker()
            rec["barrier_ms"] = (time.perf_counter() - t) * 1e3
            rec["shuffle_union"] = _world_shuffle(flt, rank, n, out)
        else:
            import paddle_tpu_torch as fluid
            main, startup, loss = _fleet_agree_program(flt)
            mesh = flt.mesh()
            comp = fluid.CompiledProgram(main).with_mesh(mesh)
            exe = fluid.Executor()
            names = [p.name for p in main.all_parameters()]
            scope = fluid.Scope()
            losses, per_step = [], []
            tc0 = flash.TC_LAUNCHES
            with fluid.scope_guard(scope):
                exe.run(startup)
                for i in range(BERT_AGREE_STEPS):
                    before = _bwd_counts(flash)
                    got = exe.run(comp, feed=dp_agree_feed(),
                                  fetch_list=[loss] + ([
                                      p + "@GRAD" for p in names]
                                      if i == 0 else []),
                                  return_numpy=False)
                    per_step.append([a - b for a, b in zip(
                        _bwd_counts(flash), before)])
                    losses.append(got[0].double().item())
                    if i == 0:
                        grads = got[1:]
                rec["shares"] = list(_scope_shares(main, scope, mesh))
            rec.update(losses=losses, launches=per_step,
                       tc=flash.TC_LAUNCHES - tc0, coords=mesh.coords(),
                       vs_local=_against(os.path.join(out, "ref_mixed.pt"),
                                         losses, grads, names, DP_GRAD_TOL))
        flt.barrier_worker()
        rec["seconds"] = time.perf_counter() - t0
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _fleet_agree_program(flt):
    """dp_agree_program's net (2 layers, dropout 0) through fleet's
    distributed optimizer."""
    return build_bert_fleet(bert_config(
        num_hidden_layers=BERT_AGREE_LAYERS, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0), flt)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_world(form, nproc, base):
    """`nproc` ranks of this script (`--fleet-world-rank form <dir>`)
    through the port's launcher with ``--selected_gpus=0,...,0`` (every
    rank on cuda:0: gloo by the layout), in its own session. The
    launcher's file runs as a script, as ``python -m
    paddle_tpu_torch.distributed.launch`` runs the same code, without
    importing the package into the launcher's process. Returns (form,
    nproc, its directory, the launcher)."""
    import paddle_tpu_torch.distributed as pdist
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(base, form)
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable,
           os.path.join(os.path.dirname(pdist.__file__), "launch.py"),
           f"--nproc_per_node={nproc}",
           f"--selected_gpus={','.join(['0'] * nproc)}",
           f"--started_port={_free_port()}",
           f"--log_dir={os.path.join(out, 'log')}",
           os.path.abspath(__file__), "--fleet-world-rank", form, out]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
    with open(os.path.join(out, "launcher.log"), "w") as log:
        proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    return form, nproc, out, proc


def _finish_world(world, started):
    """Wait for a started world (at most FLEET_WORLD_TIMEOUT_S after
    `started`, then its group is killed): the ranks' records; a rank's
    failure fails the phase."""
    form, nproc, out, proc = world
    try:
        rc = proc.wait(max(1.0, started + FLEET_WORLD_TIMEOUT_S
                           - time.perf_counter()))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        rc = None
    if rc != 0:
        for r in range(nproc):
            path = os.path.join(out, "log", f"workerlog.{r}")
            if os.path.exists(path):
                with open(path) as f:
                    print(f"{form} rank {r} log tail:\n" + f.read()[-3000:])
        _fail(f"{form}: the launcher exited {rc}")
    recs = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def _gate(tag, cmp, bad):
    print(f"{tag}: first loss rel err {cmp['first_loss_rel_err']:.3e} "
          f"(tolerance {DP_FIRST_LOSS_TOL}), later "
          f"{cmp['later_loss_rel_err']:.3e}, @GRADs worst "
          f"{cmp['grad_rel_err']:.3e} at {cmp['worst']} (tolerance "
          f"{cmp['grad_tol']})")
    if not cmp["ok"]:
        bad.append(f"{tag}: the runs disagree")


def fleet_references(flash, rec34, base):
    """35's references in this process, into <base>/35: a local tp 2
    first step of phase 34's cell (its loss phase 34's) and a local sp 2
    run of the 2-layer net (_first_steps from a fresh startup)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import apply_shard_rules, make_mesh
    out = os.path.join(base, "35")
    os.makedirs(out, exist_ok=True)
    main, startup, loss = build_bert(bert_config())
    apply_shard_rules(main)
    comp = fluid.CompiledProgram(main).with_mesh(
        make_mesh(tp=TP, devices=["cuda:0"] * TP))
    ref = _first_steps(flash, main, startup, loss, comp, bert_feed(), 1)
    if abs(ref[0][0] - rec34["loss_first"]) > DP_FIRST_LOSS_TOL * abs(
            rec34["loss_first"]):
        _fail(f"35: the local tp 2 reference {ref[0][0]} is not phase "
              f"34's first loss {rec34['loss_first']}")
    _save_ref(os.path.join(out, "ref_tp.pt"), ref)
    del ref
    smain, sstart, sloss = dp_agree_program()
    scomp = fluid.CompiledProgram(smain).with_mesh(
        make_mesh(sp=2, devices=["cuda:0"] * 2))
    _save_ref(os.path.join(out, "ref_sp.pt"), _first_steps(
        flash, smain, sstart, sloss, scomp, dp_agree_feed(),
        BERT_AGREE_STEPS))
    gc.collect()
    torch.cuda.empty_cache()


def _rank_launches(rec):
    """A world rank's (fwd, dQ, dK/dV, bf16 fwd) flash launches over its
    run, summed from the counts it read around each step."""
    return tuple(int(sum(c[k] for c in rec["launches"]))
                 for k in range(3)) + (int(rec["tc"]),)


def phase_fleet_world(rec34, world, started):
    """Phase 35: two processes on cuda:0 through the port's launcher,
    fleet.init choosing gloo by the layout. BERT-base (phase 16/34's
    cell) under DistributedStrategy(tp_degree=2) through fleet's
    distributed Adam and CompiledProgram(main).with_mesh(fleet.mesh()),
    FLEET_STEPS steps; then the 2-layer net at sp 2 over the world, the
    collective ops on CUDA tensors, barrier_worker and global_shuffle;
    against fleet_references'. `world` was started at `started` and its
    ranks wait, started up, for the go written here. Returns (launches
    by path, record)."""
    t0 = time.perf_counter()
    with open(os.path.join(world[2], "go"), "w"):
        pass
    recs = _finish_world(world, started)
    world_s = time.perf_counter() - t0
    n = bert_config().num_hidden_layers
    layers = BERT_AGREE_LAYERS
    launches, out = {}, {"world_s": world_s, "card": _card_line()}
    bad = []
    for r, rec in enumerate(recs):
        tp = rec["tp"]
        if rec["backend"] != "gloo" or rec["mesh"]["tp"] != TP:
            bad.append(f"35 rank {r}: backend {rec['backend']}, mesh "
                  f"{rec['mesh']}")
        if any(c != [n] * 3 for c in tp["launches"]) or tp["tc"]:
            bad.append(f"35 rank {r}: flash launches a step {tp['launches']}"
                       f" ({tp['tc']} bf16), want {n} each (6 heads a "
                       f"rank), 0 bf16")
        if abs(tp["losses"][0] - rec34["loss_first"]) > DP_FIRST_LOSS_TOL \
                * abs(rec34["loss_first"]):
            bad.append(f"35 rank {r}: first loss {tp['losses'][0]} vs phase "
                  f"34's {rec34['loss_first']}")
        _gate(f"35 rank {r} tp {TP} world vs local tp {TP}", tp["vs_local"],
              bad)
        held, share, whole = tp["shares"]
        if held != share or whole:
            bad.append(f"35 rank {r}: the scope holds {held} elements, the "
                  f"shares {share}; whole: {whole}")
        sp = rec["sp"]
        if any(c != [2 * layers] * 3 for c in sp["launches"]) or sp["tc"]:
            bad.append(f"35 rank {r}: sp flash launches a step "
                       f"{sp['launches']} ({sp['tc']} bf16), want "
                       f"{2 * layers} each, 0 bf16")
        _gate(f"35 rank {r} sp 2 world vs local sp 2", sp["vs_local"],
              bad)
        for op, (err, exact) in rec["ops"].items():
            if (exact and err != 0.0) or err > 1e-6:
                bad.append(f"35 rank {r}: {op} off numpy by {err}")
        if rec["shuffle_union"] != list(range(4 * TP)):
            bad.append(f"35 rank {r}: global_shuffle's union "
                  f"{rec['shuffle_union']}")
        launches[f"35 fleet tp {TP} world rank {r} ({FLEET_STEPS} "
                 f"steps)"] = _rank_launches(tp)
        launches[f"35 fleet sp 2 world rank {r} ({layers} layers x "
                 f"{BERT_AGREE_STEPS} steps)"] = _rank_launches(sp)
        out[f"rank{r}"] = {
            "losses": tp["losses"], "step_ms": tp["step_ms"],
            "reductions_per_step": tp["reductions"],
            "gloo_ms_last_step": tp["gloo_ms_last_step"],
            "gloo_calls_last_step": tp["gloo_calls_last_step"],
            "vs_local_tp": tp["vs_local"], "elements_held": held,
            "peak_memory": tp["peak_memory"], "sp_losses": sp["losses"],
            "vs_local_sp": sp["vs_local"], "ops": rec["ops"],
            "barrier_ms": rec["barrier_ms"], "boot_s": rec["boot_s"],
            "seconds": rec["seconds"]}
    print("fleet world " + json.dumps(out))
    if bad:
        _fail("; ".join(bad))
    return launches, out


def phase_fleet_local(flash, rec21):
    """Phase 35b: fleet on one process, DistributedStrategy(tp_degree=2,
    zero_stage=1) over local_devices ["cuda:0"] * 4: dp 2 x tp 2 on one
    mesh. BERT-base for BERT_WARM + FLEET_B_STEPS steps and a profile;
    its first loss against phase 21's dp 2, its first step's @GRADs
    against a local dp 2 first step, each within FLEET_GRAD_TOL of its
    scale (the 12-layer reordering). Returns ((fwd, dQ, dK/dV, bf16 fwd)
    launches, record)."""
    import paddle_tpu_torch as fluid
    flt = _fleet(zero=1, devices=["cuda:0"] * 4)
    mesh = flt.mesh()
    if dict(mesh.shape) != {"dp": 2, "pp": 1, "ep": 1, "sp": 1, "tp": 2}:
        _fail(f"35b: fleet's mesh {mesh}")
    cfg = bert_config()
    main, startup, loss = build_bert_fleet(cfg, flt)
    comp = fluid.CompiledProgram(main).with_mesh(mesh)
    feed = bert_feed()
    dmain, dstart, dloss = build_bert(cfg)
    dref = _first_steps(flash, dmain, dstart, dloss, _dp_program(
        dmain, dloss, [fluid.CUDAPlace(0)] * DP), feed, 1)
    got = _first_steps(flash, main, startup, loss, comp, feed, 1)
    first = abs(got[0][0] - rec21["loss_first"]) / abs(rec21["loss_first"])
    grad, worst, ok = _grad_gate(got[1], dref[1], got[2], dref[2],
                                 FLEET_GRAD_TOL)
    print(f"35b: dp 2 x tp 2 first loss {got[0][0]} vs phase 21's "
          f"{rec21['loss_first']} (rel err {first:.3e}, tolerance "
          f"{DP_FIRST_LOSS_TOL}); @GRADs vs a dp 2 first step worst "
          f"{grad:.3e} at {worst} (tolerance {FLEET_GRAD_TOL})")
    if first > DP_FIRST_LOSS_TOL or not ok:
        _fail("35b: dp 2 x tp 2 disagrees with dp 2")
    del dref, got
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    exe = fluid.Executor()
    n = cfg.num_hidden_layers
    steps = BERT_WARM + FLEET_B_STEPS
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        _zero_counts(flash)
        red0 = mesh.reductions
        losses, step_ms, per_step, tc = _train_run(
            flash, exe, comp, feed, loss, steps, BERT_WARM)
        counts = _bwd_counts(flash)
        reductions = mesh.reductions - red0
        peak = torch.cuda.max_memory_allocated()
        shares = _scope_shares(main, scope, mesh)
        prof = _profile_train(lambda: exe.run(comp, feed=feed,
                                              fetch_list=[loss]),
                              BERT_PROFILE_STEPS)
    per = DP * TP * n
    if per_step != {(per,) * 3} or tc or counts != (steps * per,) * 3:
        _fail(f"35b: flash launches a step {per_step} (run {counts}), want "
              f"{per} each (dp 2 x tp 2 positions x {n} layers)")
    if shares[2]:
        _fail(f"35b: laid-out persistables held whole: {shares[2]}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        _fail(f"35b: loss not finite or not falling: {losses}")
    del scope
    out = {"config": "BertConfig(max_position_embeddings=512)",
           "strategy": "tp_degree=2, zero_stage=1, local_devices="
                       "['cuda:0'] * 4", "mesh": "local dp 2 x tp 2",
           "card": _card_line(), "steps_timed": len(step_ms),
           "step_ms_p50": float(np.percentile(step_ms, 50)),
           "step_ms_p99": float(np.percentile(step_ms, 99)),
           "tokens_per_s": BERT_BATCH * BERT_SEQ / (
               float(np.mean(step_ms)) / 1e3),
           "max_memory_allocated": peak, "loss_first": losses[0],
           "loss_last": losses[-1], "first_loss_rel_err_vs_21": first,
           "grad_rel_err_vs_dp2": grad, "grad_tol": FLEET_GRAD_TOL,
           "reductions_per_step": reductions / steps,
           "flash_launches_per_step": list(next(iter(per_step))),
           "elements_held": shares[0],
           "device_ms_per_step": prof["device_ms_per_step"],
           "device_busy_share": prof["device_busy_share"],
           "flash_share_of_device": prof["flash_share_of_device"]}
    print("fleet local " + json.dumps(out))
    return counts + (tc,), out


def fleet_world4_reference(flash, base):
    """35c's reference in this process, into <base>/35c: 35b's form (the
    fleet strategy tp_degree=2, zero_stage=1 over four positions of
    cuda:0) on the 2-layer net, BERT_AGREE_STEPS steps. Returns its
    launches a step."""
    import paddle_tpu_torch as fluid
    out = os.path.join(base, "35c")
    os.makedirs(out, exist_ok=True)
    flt = _fleet(zero=1, devices=["cuda:0"] * 4)
    main, startup, loss = _fleet_agree_program(flt)
    ref = _first_steps(flash, main, startup, loss,
                       fluid.CompiledProgram(main).with_mesh(flt.mesh()),
                       dp_agree_feed(), BERT_AGREE_STEPS)
    _save_ref(os.path.join(out, "ref_mixed.pt"), ref)
    return ref[3]


def phase_fleet_world4(world, started, per_step_local):
    """Phase 35c: four processes on cuda:0 through the launcher (`world`,
    started at `started` while this process computed 35's references),
    fleet's tp 2 + ZeRO-1 over a world of 4 (dp 2 x tp 2), the 2-layer
    net for BERT_AGREE_STEPS steps against its local form; each rank's
    scope holds the dist_attrs' shares. Returns (launches by path,
    record)."""
    recs = _finish_world(world, started)
    layers = BERT_AGREE_LAYERS
    launches, out, bad = {}, {}, []
    for r, rec in enumerate(recs):
        if rec["backend"] != "gloo" or rec["mesh"]["dp"] != DP:
            bad.append(f"35c rank {r}: backend {rec['backend']}, mesh "
                  f"{rec['mesh']}")
        if any(c != [layers] * 3 for c in rec["launches"]) or rec["tc"]:
            bad.append(f"35c rank {r}: flash launches a step "
                       f"{rec['launches']} ({rec['tc']} bf16), want "
                       f"{layers} each, 0 bf16")
        _gate(f"35c rank {r} dp 2 x tp 2 world vs local", rec["vs_local"],
              bad)
        held, share, whole = rec["shares"]
        if held != share or whole:
            bad.append(f"35c rank {r}: the scope holds {held} elements, the "
                  f"shares {share}; whole: {whole}")
        launches[f"35c fleet dp 2 x tp 2 world rank {r} ({layers} layers "
                 f"x {BERT_AGREE_STEPS} steps)"] = _rank_launches(rec)
        out[f"rank{r}"] = {"coords": rec["coords"], "losses": rec["losses"],
                           "vs_local": rec["vs_local"],
                           "elements_held": held, "boot_s": rec["boot_s"],
                           "seconds": rec["seconds"]}
    print(f"35c: the local form's launches a step {per_step_local[0]} over "
          f"4 positions")
    print("fleet world4 " + json.dumps(out))
    if bad:
        _fail("; ".join(bad))
    return launches, out


def phase_fleet_train_all(flash, rec34, rec21):
    """Phases 35-35c. 35c's four ranks boot and run, and 35's two boot
    and start up, while this process computes 35's references (35c's
    own reference is made first); 35's timed steps (after its go) and
    35b, whose times are reported, run alone. Returns (flash launches by
    path, records)."""
    base = tempfile.mkdtemp(prefix="fleet_")
    worlds = []
    try:
        lper = _phase("35c reference (local, 2 layers)",
                      fleet_world4_reference, flash, base)
        started = time.perf_counter()
        world4 = _start_world("35c", DP * TP, base)
        worlds.append(world4)
        world2 = _start_world("35", TP, base)
        worlds.append(world2)
        _phase("35 references (local tp 2, sp 2), beside 35c's world",
               fleet_references, flash, rec34, base)
        cl, crec = _phase("35c fleet dp 2 x tp 2 world, four processes",
                          phase_fleet_world4, world4, started, lper)
        wl, wrec = _phase("35 fleet tp 2 world, two processes (after its "
                          "go)", phase_fleet_world, rec34, world2, started)
        ll, lrec = _phase("35b fleet dp 2 x tp 2 + ZeRO-1, local",
                          phase_fleet_local, flash, rec21)
    finally:
        for world in worlds:
            if world[3].poll() is None:
                os.killpg(world[3].pid, 9)
                world[3].wait()
        shutil.rmtree(base, ignore_errors=True)
    steps = BERT_WARM + FLEET_B_STEPS
    paths = {**wl, f"35b fleet dp 2 x tp 2 local ({steps} steps)": ll,
             **cl}
    return paths, {"35": wrec, "35b": lrec, "35c": crec}

# ---------------------------------------------------------------------------
# phases 36-36c: pipeline and expert parallelism (item 11a)
# ---------------------------------------------------------------------------

PP = 4                              # 36, 36b: pp 4
PP_MICRO = 4                        # 36, 36b: microbatches a step (2 rows)
PP_CUT_BLOCKS = (2, 5, 8)           # 36: the stages end after these blocks
PP_STEPS = 4                        # 36: Adam steps, pipelined and plain
PP_FIRST_LOSS_TOL = 1e-6            # 36 vs the plain step, relative
PP_LATER_LOSS_TOL = 1e-5
PP_WORLD_LAYERS = 4                 # 36b: one block a stage
PP_WORLD_STEPS = 2
F1B_MICRO = (8, 16)                 # 36: 1F1B's microbatch counts
F1B_ROWS = 2                        # 36: 1F1B's rows a microbatch (of 512)
F1B_WIDTH, F1B_HEADS = 768, 12      # 36: 1F1B's block (GPT-base's)
F1B_LOSS_TOL = 1e-6                 # 1F1B vs the sequential autograd run
F1B_GRAD_TOL = 1e-5                 # of each stacked gradient's scale
F1B_PEAK_TOL = 0.05                 # M 16's in-flight peak vs M 8's
# 36c: Switch-Base-8's FFN (Fedus et al., Switch Transformers, and the
# published switch-base-8 config): d_model 768, d_ff 3072, 8 experts,
# top-1, capacity factor 1.25, over 8 x 512 tokens
MOE_D, MOE_FF, MOE_EXPERTS, MOE_CF = 768, 3072, 8, 1.25
MOE_ROWS, MOE_LEN = 8, 512
MOE_EP = 4
MOE_STEPS = 3
MOE_LR = 1e-3
MOE_TIE_TOL = 1e-6                  # a token's top-two gate probabilities
MOE_OUT_TOL = 1e-5                  # card vs CPU, ep vs dense, of the scale
MOE_NODROP_CF = 8.0                 # a capacity nothing overflows
MOE_GRADS = ("moe_gate_w", "moe_w_up", "moe_w_down")


def block_outputs(program, layers):
    """The residual sum that ends each GPT block: the add reading the
    biased output of the block's second FFN product."""
    ops = program.global_block().ops
    outs = []
    for i in range(layers):
        bias = next(op for op in ops if op.type == "elementwise_add"
                    and f"gpt{i}_ffn1_b" in op.input_names)
        res = next(op for op in ops if op.type == "elementwise_add"
                   and bias.output_names[0] in op.input_names)
        outs.append(res.output_names[0])
    return outs


def build_gpt_pp(layers=None, cuts=None, flt=None):
    """Phase 9's net (build_train: its seed, so its startup weights, its
    batch), at `layers` blocks if given; with `cuts` its Adam runs
    through PipelineOptimizer(cut_list= the last residual add of those
    blocks, num_microbatches=PP_MICRO), through fleet's distributed
    optimizer with `flt`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt
    kw = {} if layers is None else {"num_layers": layers}
    cfg = gpt.GPTConfig(max_position=max(TRAIN_SEQ, 1024), dropout=0.0,
                        **kw)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 7
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _tokens, loss, _logits = gpt.build_lm_net(cfg, seq_len=TRAIN_SEQ)
        opt = fluid.optimizer.AdamOptimizer(1e-4)
        if cuts is not None:
            names = block_outputs(main, cfg.num_layers)
            opt = fluid.optimizer.PipelineOptimizer(
                opt, cut_list=[[names[i]] for i in cuts],
                num_microbatches=PP_MICRO)
        if flt is not None:
            opt = flt.distributed_optimizer(opt)
        opt.minimize(loss)
    rng = np.random.default_rng(SEED + 8)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    return cfg, main, startup, loss, toks.astype(np.int64)


def _pp_mesh():
    from paddle_tpu_torch.parallel import make_mesh
    return make_mesh(pp=PP, devices=["cuda:0"] * PP)


def _pp_steps(flash, exe, program, loss, names, feed, scope, steps):
    """`steps` steps: (losses, step ms, the first step's @GRADs on the
    card, (fwd, dQ, dK/dV) launches a step, bf16 forward launches)."""
    losses, ms, per_step = [], [], []
    tc0 = flash.TC_LAUNCHES
    grads = None
    for i in range(steps):
        before = _bwd_counts(flash)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exe.run(program, feed=feed, fetch_list=[loss] + (
            [n + "@GRAD" for n in names] if i == 0 else []), scope=scope,
            return_numpy=False)
        losses.append(out[0].double().item())
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(_bwd_counts(flash),
                                                    before)))
        if i == 0:
            grads = out[1:]
    return losses, ms, grads, per_step, flash.TC_LAUNCHES - tc0


def _gpt_block(p, x):
    """One pre-norm GPT-2 block (f32, causal) over ops/flash.py: 1F1B's
    stage at full width."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.flash import flash_attention
    b, t, d = x.shape
    h = F1B_HEADS
    y = F.layer_norm(x, (d,), p["ln1_s"], p["ln1_b"], 1e-5)
    q, k, v = (y @ p["w_qkv"] + p["b_qkv"]).view(b, t, 3, h, d // h) \
        .permute(2, 0, 3, 1, 4)
    a = flash_attention(q, k, v, causal=True).transpose(1, 2).reshape(
        b, t, d)
    x = x + a @ p["w_o"] + p["b_o"]
    y = F.layer_norm(x, (d,), p["ln2_s"], p["ln2_b"], 1e-5)
    return x + F.gelu(y @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _mse(y, a):
    return torch.mean((y - a) ** 2)


def _block_params(stages, d, gen):
    """Stacked (S, ...) GPT-2 block weights on the card, N(0, 0.02)."""
    def w(*shape):
        return torch.randn((stages,) + shape, generator=gen,
                           device="cuda") * 0.02
    ones = torch.ones(stages, d, device="cuda")
    zeros = torch.zeros(stages, d, device="cuda")
    return {"ln1_s": ones, "ln1_b": zeros, "w_qkv": w(d, 3 * d),
            "b_qkv": w(3 * d), "w_o": w(d, d), "b_o": w(d),
            "ln2_s": ones.clone(), "ln2_b": zeros.clone(),
            "w1": w(d, 4 * d), "b1": w(4 * d), "w2": w(4 * d, d),
            "b2": w(d)}


def _sequential_1f1b_ref(params, xm, aux):
    """The stages in sequence, microbatch by microbatch, one autograd
    graph: (loss, {name: stacked gradient})."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    stages = next(iter(params.values())).shape[0]
    total = 0.0
    for k in range(xm.shape[0]):
        h = xm[k]
        for s in range(stages):
            h = _gpt_block({n: v[s] for n, v in leaves.items()}, h)
        total = total + _mse(h, aux[k])
    loss = total / xm.shape[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def phase_1f1b(flash):
    """36's 1F1B part: pipeline_1f1b over four positions of cuda:0, one
    pre-norm GPT-2 block a stage (f32, causal, over ops/flash.py) at
    width 768, F1B_ROWS x 512 a microbatch, at each M of F1B_MICRO:
    loss and stacked gradients against the sequential autograd run; 2M
    forward launches and M dQ + M dK/dV a stage; the schedule's
    in-flight peak (the memory the call adds) at the largest M within
    F1B_PEAK_TOL of the smallest's; schedule_stats' bubble equal to
    bubble_fraction. Returns (launches by path, record)."""
    from paddle_tpu_torch.parallel import make_mesh
    from paddle_tpu_torch.parallel import pipeline as pp_mod
    mesh = make_mesh(pp=PP, devices=["cuda:0"] * PP)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 360)
    d = F1B_WIDTH
    params = _block_params(PP, d, gen)
    paths, rec, bad = {}, {}, []
    for m in F1B_MICRO:
        xm = torch.randn(m, F1B_ROWS, TRAIN_SEQ, d, generator=gen,
                         device="cuda")
        aux = torch.randn(m, F1B_ROWS, TRAIN_SEQ, d, generator=gen,
                          device="cuda")
        ref_loss, ref_grads = _sequential_1f1b_ref(params, xm, aux)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts(flash)
        t0 = time.perf_counter()
        loss, grads = pp_mod.pipeline_1f1b(_gpt_block, _mse, params, xm,
                                           aux, mesh)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        counts = _bwd_counts(flash) + (flash.TC_LAUNCHES,)
        names = sorted(grads)
        worst, at, ok = _grad_gate([grads[n] for n in names],
                                   [ref_grads[n] for n in names], names,
                                   names, F1B_GRAD_TOL)
        loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
        st = pp_mod.schedule_stats(_gpt_block, _mse, params, xm, aux, mesh)
        want = (2 * m * PP, m * PP, m * PP, 0)
        if counts != want:
            bad.append(f"1F1B M {m}: launches {counts}, want {want}")
        if loss_err > F1B_LOSS_TOL or not ok:
            bad.append(f"1F1B M {m}: loss rel err {loss_err:.3e}, @GRADs "
                       f"{worst:.3e} at {at}")
        if st["bubble_fraction"] != pp_mod.bubble_fraction(m, PP) or \
                st["ticks"] != 2 * m + 2 * PP - 2:
            bad.append(f"1F1B M {m}: schedule_stats {st}")
        paths[f"36 1F1B GPT-2 block x {PP} stages, M {m} (one call)"] = \
            counts
        rec[f"M{m}"] = {"loss": loss.item(), "loss_rel_err": loss_err,
                        "grad_rel_err": worst, "worst": at,
                        "run_ms": run_ms, "inflight_peak_bytes": peak,
                        "schedule_stats": st, "launches": counts}
        del xm, aux, ref_grads, grads
    lo, hi = (rec[f"M{m}"]["inflight_peak_bytes"] for m in
              (min(F1B_MICRO), max(F1B_MICRO)))
    rec["peak_ratio"] = hi / lo
    if abs(hi - lo) > F1B_PEAK_TOL * lo:
        bad.append(f"1F1B: in-flight peak {hi} B at M {max(F1B_MICRO)} vs "
                   f"{lo} B at M {min(F1B_MICRO)}")
    print("1f1b " + json.dumps(rec))
    if bad:
        _fail("; ".join(bad))
    return paths, rec


def phase_pp(flash, base):
    """Phase 36: phase 9's GPT-base (12 layers, width 768, seq 512, batch
    8) through PipelineOptimizer(Adam, cut_list= the last residual add
    of blocks 2, 5 and 8, num_microbatches=4) and CompiledProgram
    .with_mesh(make_mesh(pp=4)) on four positions of cuda:0, PP_STEPS
    steps from phase 9's startup weights, against the plain step from
    the same weights: first loss within PP_FIRST_LOSS_TOL, later ones
    PP_LATER_LOSS_TOL, the first step's @GRADs (the tied gpt_word_emb's
    included) within FLEET_GRAD_TOL of their scale, 48 + 48 + 48 f32
    flash launches a step (12 layers x M 4), none bf16, a falling loss;
    step ms, one profiled step, peak memory. Then 1F1B (phase_1f1b) and
    36b's reference: the local pp 4 form at PP_WORLD_LAYERS layers,
    saved under <base>/36b. Returns (launches by path, record)."""
    import paddle_tpu_torch as fluid
    cfg, main, startup, loss, toks = build_gpt_pp()
    _c, pmain, _ps, ploss, _t = build_gpt_pp(cuts=PP_CUT_BLOCKS)
    feed = {"tokens": toks}
    names = [p.name for p in main.all_parameters()]
    gc.collect()
    torch.cuda.empty_cache()
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get(n).clone() for n in scope.names()}
    plain, plain_ms, grads, _ps, _tc = _pp_steps(
        flash, exe, main, loss, names, feed, scope, PP_STEPS)
    del exe, scope
    pscope = fluid.Scope()
    for n, v in init.items():
        pscope.set(n, v)
    del init
    torch.cuda.reset_peak_memory_stats()
    comp = fluid.CompiledProgram(pmain).with_mesh(_pp_mesh())
    exe = fluid.Executor()
    _zero_counts(flash)
    losses, ms, pgrads, per_step, tc = _pp_steps(
        flash, exe, comp, ploss, names, feed, pscope, PP_STEPS)
    counts = _bwd_counts(flash) + (tc,)
    peak = torch.cuda.max_memory_allocated()
    first = abs(losses[0] - plain[0]) / abs(plain[0])
    later = max(abs(a - b) / abs(b) for a, b in zip(losses[1:], plain[1:]))
    worst, at, ok = _grad_gate(pgrads, grads, names, names, FLEET_GRAD_TOL)
    tied = _grad_gate([pgrads[names.index("gpt_word_emb")]],
                      [grads[names.index("gpt_word_emb")]],
                      ["gpt_word_emb"], ["gpt_word_emb"], FLEET_GRAD_TOL)
    del grads, pgrads
    prof = _profile_train(lambda: exe.run(comp, feed=feed,
                                          fetch_list=[ploss], scope=pscope),
                          1)
    del exe, pscope
    n = cfg.num_layers * PP_MICRO
    bad = []
    if set(per_step) != {(n, n, n)} or tc:
        bad.append(f"36: flash launches a step {per_step} ({tc} bf16), "
                   f"want {n} each, 0 bf16")
    if first > PP_FIRST_LOSS_TOL or later > PP_LATER_LOSS_TOL or not ok:
        bad.append(f"36: pipelined vs plain: first loss {first:.3e}, later "
                   f"{later:.3e}, @GRADs {worst:.3e} at {at}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        bad.append(f"36: losses not finite and falling: {losses}")
    rec = {"config": "GPTConfig(max_position=1024, dropout=0.0) x 12 "
                     f"layers, pp {PP}, M {PP_MICRO}, cuts after blocks "
                     f"{list(PP_CUT_BLOCKS)}",
           "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "losses": losses, "plain_losses": plain,
           "first_loss_rel_err": first, "later_loss_rel_err": later,
           "grad_rel_err": worst, "worst": at,
           "word_emb_grad_rel_err": tied[0],
           "step_ms": ms, "plain_step_ms": plain_ms,
           "step_ms_p50_after_first": float(np.percentile(ms[1:], 50)),
           "plain_step_ms_p50_after_first":
               float(np.percentile(plain_ms[1:], 50)),
           "max_memory_allocated": peak, "launches": counts,
           "profile": prof}
    print("pp " + json.dumps(rec))
    if bad:
        _fail("; ".join(bad))
    paths = {f"36 GPT-base pp {PP} local ({PP_STEPS} steps)":
             counts}
    more, rec["1f1b"] = phase_1f1b(flash)
    paths.update(more)
    # 36b's reference: the local pp 4 form at PP_WORLD_LAYERS layers
    out = os.path.join(base, "36b")
    os.makedirs(out, exist_ok=True)
    wmain, wstart, wloss = build_gpt_pp(
        PP_WORLD_LAYERS, range(PP_WORLD_LAYERS - 1))[1:4]
    _save_ref(os.path.join(out, "ref_pp.pt"), _first_steps(
        flash, wmain, wstart, wloss, fluid.CompiledProgram(wmain)
        .with_mesh(_pp_mesh()), feed, PP_WORLD_STEPS))
    gc.collect()
    torch.cuda.empty_cache()
    return paths, rec


def build_moe(cf=MOE_CF, flt=None):
    """36c's Program: layers.moe at Switch-Base-8's FFN width over (8,
    512, 768) inputs, tests/parallel/test_moe_framework.py's loss
    (mean of the outputs' squared norms + 0.01 x the aux loss), SGD
    (through fleet's distributed optimizer with `flt`)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 36
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data("x", shape=[MOE_LEN, MOE_D], dtype="float32")
        out, aux = layers.moe(x, d_ff=MOE_FF, num_experts=MOE_EXPERTS,
                              capacity_factor=cf,
                              param_attr=fluid.ParamAttr(name="moe"))
        loss = layers.mean(layers.reduce_sum(layers.square(out), dim=-1)) \
            + layers.reduce_sum(aux) * 0.01
        opt = fluid.optimizer.SGDOptimizer(learning_rate=MOE_LR)
        if flt is not None:
            opt = flt.distributed_optimizer(opt)
        opt.minimize(loss)
    return main, startup, out, aux, loss


def moe_feed():
    x = np.random.default_rng(SEED + 37).standard_normal(
        (MOE_ROWS, MOE_LEN, MOE_D))
    return {"x": x.astype(np.float32)}


def _moe_run(exe, program, scope, out, aux, loss, steps):
    """(losses, the first step's Out, the first step's @GRADs, step ms)."""
    losses, ms = [], []
    for i in range(steps):
        if exe.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = exe.run(program, feed=moe_feed(), fetch_list=[loss, aux] + (
            [out] + [n + "@GRAD" for n in MOE_GRADS] if i == 0 else []),
            scope=scope, return_numpy=False)
        losses.append(got[0].double().item())
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first_out, grads = got[2], got[3:]
    return losses, first_out, grads, ms


def _moe_gating(x, gate_w, shards, capacity):
    """Each ep shard's gating as moe_apply computes it: (experts, the
    top-two gate probabilities' gap, kept)."""
    from paddle_tpu_torch.parallel import moe
    experts, gaps, kept = [], [], []
    for block in x.reshape(-1, x.shape[-1]).chunk(shards, 0):
        logits = block @ gate_w
        e, _g, _a = moe.top1_gating(logits, capacity)
        top2 = torch.softmax(logits, -1).topk(2, -1).values
        _slot, ok = moe._slots(e, gate_w.shape[1], capacity)
        experts.append(e)
        gaps.append(top2[:, 0] - top2[:, 1])
        kept.append(ok)
    return torch.cat(experts), torch.cat(gaps), torch.cat(kept)


def phase_moe(flash, base):
    """Phase 36c: layers.moe at Switch-Base-8's FFN width (d_model 768,
    d_ff 3072, 8 experts, top-1, capacity factor 1.25) in a Program over
    8 x 512 tokens, MOE_STEPS SGD steps: dense on the card, ep 4 on four
    positions of cuda:0 (two experts a position, the tokens split over
    ep, the all-to-all a regrouping), and ep 4 on the CPU from the
    card's startup weights. Gates: each token's expert equal card vs CPU
    (a token whose top-two gate probabilities lie within MOE_TIE_TOL may
    differ: counted), the first step's outputs within MOE_OUT_TOL of
    their scale over the tokens both sides route alike; at capacity
    factor MOE_NODROP_CF ep 4 equals dense within MOE_OUT_TOL; no flash
    launch. Prints the dropped share at 1.25. The local ep 4 run is 36b's
    ep reference, saved under <base>/36b. Returns (launches by path,
    record)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import make_mesh, moe
    main, startup, out, aux, loss = build_moe()
    _zero_counts(flash)
    tc0 = flash.TC_LAUNCHES
    rec = {"config": "Switch-Base-8's FFN: d_model 768, d_ff 3072, 8 "
                     "experts, top-1, capacity factor 1.25 (Fedus et al., "
                     "switch-base-8)", "tokens": MOE_ROWS * MOE_LEN}
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get(n).clone() for n in scope.names()}
    dense, _o, _g, dense_ms = _moe_run(exe, main, scope, out, aux, loss,
                                       MOE_STEPS)
    # ep 4 on the card, from a fresh startup (36b's ranks start so)
    names = [p.name for p in main.all_parameters()]
    comp = fluid.CompiledProgram(main).with_mesh(
        make_mesh(ep=MOE_EP, devices=["cuda:0"] * MOE_EP))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    ep, ep_out, ep_grads, ep_ms = _moe_run(exe, comp, scope, out, aux, loss,
                                           MOE_STEPS)
    laid = scope.get("moe_w_up")
    parts = [tuple(p.shape) for p in getattr(laid, "parts", [])]
    out_dir = os.path.join(base, "36b")
    os.makedirs(out_dir, exist_ok=True)
    _save_ref(os.path.join(out_dir, "ref_ep.pt"),
              (ep, list(ep_grads), names, None))
    # ep 4 on the CPU, from the card's startup weights
    cpu_scope = fluid.Scope()
    for n, v in init.items():
        cpu_scope.set(n, v.cpu())
    cpu = fluid.Executor(fluid.CPUPlace())
    ccomp = fluid.CompiledProgram(main).with_mesh(
        make_mesh(ep=MOE_EP, devices=["cpu"] * MOE_EP))
    cpu_loss, cpu_out, _g, cpu_ms = _moe_run(cpu, ccomp, cpu_scope, out, aux,
                                             loss, 1)
    x = torch.from_numpy(moe_feed()["x"])
    tokens = MOE_ROWS * MOE_LEN
    cap = int(MOE_CF * (tokens // MOE_EP) / MOE_EXPERTS) + 1
    e_card, gap, ok_card = _moe_gating(x.cuda(), init["moe_gate_w"],
                                       MOE_EP, cap)
    e_cpu, _gap, ok_cpu = _moe_gating(x, init["moe_gate_w"].cpu(), MOE_EP,
                                      cap)
    e_card, gap, ok_card = e_card.cpu(), gap.cpu(), ok_card.cpu()
    flips = e_card != e_cpu
    ties = int((gap <= MOE_TIE_TOL).sum())
    same = ~flips & (ok_card == ok_cpu)
    a = ep_out.reshape(tokens, MOE_D).cpu()[same]
    b = cpu_out.reshape(tokens, MOE_D)[same]
    out_err = (a - b).abs().max().item() / b.abs().max().item()
    # capacity factor MOE_NODROP_CF: nothing drops, ep 4 is dense
    w = {k: init[f"moe_{k}"] for k in ("gate_w", "w_up", "w_down")}
    xc = x.cuda()
    nd_ep, _a = moe.moe_apply(xc, w["gate_w"], w["w_up"], w["w_down"],
                              MOE_NODROP_CF, mesh=make_mesh(
                                  ep=MOE_EP, devices=["cuda:0"] * MOE_EP))
    nd_dense, _a = moe.moe_apply(xc, w["gate_w"], w["w_up"], w["w_down"],
                                 MOE_NODROP_CF)
    nodrop_err = ((nd_ep - nd_dense).abs().max()
                  / nd_dense.abs().max()).item()
    counts = _bwd_counts(flash) + (flash.TC_LAUNCHES - tc0,)
    rec.update({
        "dense_losses": dense, "ep_losses": ep, "cpu_ep_first_loss":
        cpu_loss[0], "dense_step_ms": dense_ms, "ep_step_ms": ep_ms,
        "cpu_ep_step_ms": cpu_ms, "ep_parts": parts,
        "capacity_per_shard": cap,
        "dropped_share": 1.0 - ok_card.float().mean().item(),
        "expert_flips_card_vs_cpu": int(flips.sum()),
        "near_ties": ties, "tokens_compared": int(same.sum()),
        "out_rel_err_card_vs_cpu": out_err,
        "first_loss_rel_err_card_vs_cpu":
            abs(ep[0] - cpu_loss[0]) / abs(cpu_loss[0]),
        "nodrop_ep_vs_dense_rel_err": nodrop_err, "launches": counts})
    print("moe " + json.dumps(rec))
    bad = []
    if flips.any() and (gap[flips] > MOE_TIE_TOL).any():
        bad.append(f"36c: {int(flips.sum())} tokens' experts differ card "
                   f"vs CPU, not all near-ties")
    if out_err > MOE_OUT_TOL or nodrop_err > MOE_OUT_TOL:
        bad.append(f"36c: outputs card vs CPU {out_err:.3e}, ep vs dense "
                   f"at cf {MOE_NODROP_CF} {nodrop_err:.3e}")
    if parts != [(MOE_EXPERTS // MOE_EP, MOE_D, MOE_FF)] * MOE_EP:
        bad.append(f"36c: the expert weights' parts {parts}")
    if counts != (0, 0, 0, 0) or not np.isfinite(dense + ep).all():
        bad.append(f"36c: flash launches {counts}, losses {dense} {ep}")
    if bad:
        _fail("; ".join(bad))
    return {"36c layers.moe dense, ep 4, CPU ep 4 (gated at 0)": counts}, rec


def pp_world_rank(out):
    """One rank of phase 36b's world (`--fleet-world-rank 36b <dir>`):
    fleet.init with DistributedStrategy(pp_degree=4) joins the world
    (gloo: every rank on cuda:0), the GPT at PP_WORLD_LAYERS layers runs
    one block a rank through fleet's distributed PipelineOptimizer,
    PP_WORLD_STEPS steps after the parent's go; then the same world runs
    36c's MoE Program under DistributedStrategy(ep_degree=4). Each
    against the parent's local form. Writes <out>/rank<r>.json."""
    import torch.distributed as dist
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.cuda import flash
    from paddle_tpu_torch.parallel import fleet as fleet_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    s = fleet_mod.DistributedStrategy()
    s.pp_degree = PP
    flt = fleet_mod.Fleet().init(strategy=s)
    rank = flt.worker_index()
    try:
        flash.build()
        flash.build_bwd()
        mesh = flt.mesh()
        rec = {"backend": flt.backend, "rank": rank,
               "mesh": dict(mesh.shape), "coords": mesh.coords(),
               "boot_s": time.perf_counter() - t0}
        _c, main, startup, loss, toks = build_gpt_pp(
            PP_WORLD_LAYERS, range(PP_WORLD_LAYERS - 1), flt)
        comp = fluid.CompiledProgram(main).with_mesh(mesh)
        exe, scope = fluid.Executor(), fluid.Scope()
        names = [p.name for p in main.all_parameters()]
        exe.run(startup, scope=scope)
        _wait_go(out)
        gloo = {"ms": 0.0, "calls": 0}
        with _timed_gloo(gloo, PP_WORLD_STEPS - 1):
            losses, ms, grads, per_step, tc = _pp_steps(
                flash, exe, comp, loss, names, {"tokens": toks}, scope,
                PP_WORLD_STEPS)
        rec["pp"] = {"losses": losses, "step_ms": ms,
                     "launches": per_step, "tc": tc,
                     "gloo_ms_last_step": gloo["ms"],
                     "gloo_calls_last_step": gloo["calls"],
                     "peak_memory": torch.cuda.max_memory_allocated(),
                     "vs_local": _against(os.path.join(out, "ref_pp.pt"),
                                          losses, grads, names,
                                          DP_GRAD_TOL)}
        del exe, scope, grads
        s = fleet_mod.DistributedStrategy()
        s.ep_degree = MOE_EP
        flt = fleet_mod.Fleet().init(strategy=s)
        main, startup, _o, _a, loss = build_moe(flt=flt)
        comp = fluid.CompiledProgram(main).with_mesh(flt.mesh())
        tc0 = flash.TC_LAUNCHES
        losses, grads, names, per_step = _first_steps(
            flash, main, startup, loss, comp, moe_feed(), MOE_STEPS)
        rec["ep"] = {"losses": losses, "launches": per_step,
                     "tc": flash.TC_LAUNCHES - tc0,
                     "mesh": dict(flt.mesh().shape),
                     "vs_local": _against(os.path.join(out, "ref_ep.pt"),
                                          losses, grads, names,
                                          DP_GRAD_TOL)}
        flt.barrier_worker()
        rec["seconds"] = time.perf_counter() - t0
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def phase_pp_world(world, started):
    """Phase 36b: four processes on cuda:0 through the port's launcher
    (gloo by the layout): DistributedStrategy(pp_degree=4) on phase 9's
    GPT at PP_WORLD_LAYERS layers, full width, one block a rank, the cut
    sent down the pp line and its cotangent back up, every gradient
    all-reduced over pp: the first loss within DP_FIRST_LOSS_TOL of 36's
    local form at PP_WORLD_LAYERS layers, the @GRADs within DP_GRAD_TOL
    of their scale, M 4 launches of each f32 flash kernel a step a rank;
    then DistributedStrategy(ep_degree=4) in the same world on 36c's
    Program against 36c's local ep 4. `world` was started at
    `started`; its ranks wait, started up, for the go written here.
    Returns (launches by path, record)."""
    t0 = time.perf_counter()
    with open(os.path.join(world[2], "go"), "w"):
        pass
    recs = _finish_world(world, started)
    out = {"world_s": time.perf_counter() - t0, "card": _card_line()}
    launches, bad = {}, []
    for r, rec in enumerate(recs):
        pp, ep = rec["pp"], rec["ep"]
        if rec["backend"] != "gloo" or rec["mesh"]["pp"] != PP \
                or rec["coords"]["pp"] != r:
            bad.append(f"36b rank {r}: backend {rec['backend']}, mesh "
                       f"{rec['mesh']}, coords {rec['coords']}")
        if any(tuple(c) != (PP_MICRO,) * 3 for c in pp["launches"]) \
                or pp["tc"]:
            bad.append(f"36b rank {r}: flash launches a step "
                       f"{pp['launches']} ({pp['tc']} bf16), want "
                       f"{PP_MICRO} each (one block x M {PP_MICRO}), 0 bf16")
        _gate(f"36b rank {r} pp {PP} world vs local pp {PP} at "
              f"{PP_WORLD_LAYERS} layers", pp["vs_local"], bad)
        if any(c != [0, 0, 0] for c in ep["launches"]) or ep["tc"] \
                or ep["mesh"]["ep"] != MOE_EP:
            bad.append(f"36b rank {r}: ep mesh {ep['mesh']}, flash "
                       f"launches {ep['launches']}")
        _gate(f"36b rank {r} ep {MOE_EP} world vs local ep {MOE_EP}",
              ep["vs_local"], bad)
        launches[f"36b pp {PP} world rank {r} ({PP_WORLD_STEPS} steps)"] = \
            _rank_launches(pp)
        out[f"rank{r}"] = {k: rec[k] for k in ("boot_s", "seconds")}
        out[f"rank{r}"]["pp"] = pp
        out[f"rank{r}"]["ep"] = ep
    print("pp world " + json.dumps(out))
    if bad:
        _fail("; ".join(bad))
    return launches, out


def phase_pp_all(flash):
    """Phases 36-36c. 36b's four ranks boot and start up while this
    process runs 36 and 36c, which write 36b's references; 36b's steps
    run after its go. Returns (flash launches by path, records)."""
    base = tempfile.mkdtemp(prefix="pp_")
    world = None
    try:
        started = time.perf_counter()
        world = _start_world("36b", PP, base)
        paths, rec36 = _phase("36 GPT-base pp 4 local, 1F1B", phase_pp,
                              flash, base)
        more, rec36c = _phase("36c layers.moe at Switch-Base-8's width",
                              phase_moe, flash, base)
        paths.update(more)
        more, rec36b = _phase("36b pp 4 and ep 4 world, four processes "
                              "(after its go)", phase_pp_world, world,
                              started)
        paths.update(more)
    finally:
        if world is not None and world[3].poll() is None:
            os.killpg(world[3].pid, 9)
            world[3].wait()
        shutil.rmtree(base, ignore_errors=True)
    return paths, {"36": rec36, "36b": rec36b, "36c": rec36c}


# ---------------------------------------------------------------------------
# phases 37-37f: inference through Fluid's entry point (item 11b): the
# Predictor on BERT-base, generation_server at GPT width, the AOT artifact,
# the batching server, the paged decode adapter and Executor.explain
# ---------------------------------------------------------------------------

INFER_SEQ = 128                     # 37: the BERT-base classifier's seq
INFER_LABELS = 3
INFER_BUCKETS = (1, 8, 32)
INFER_BATCHES = (3, 8, 40)          # 40 splits into 32 + 8
INFER_CALIB = 4                     # 37: enable_int8's calibration batches
INFER_BF16_ATOL = 3e-2              # bf16 weights vs f32: probabilities
INFER_INT8_REL = 0.1                # enable_int8 vs f32: max|d| / max|ref|
INFER_TP_REL = 2e-5                 # tp 2 vs one device
# the f32 Predictor against the for_test clone run with the plain dense
# attention put in (the kernel against its plain version through 12
# layers), on the bucket runs of INFER_PLAIN_BATCHES rows; the same clone
# with the key padding dropped must lie farther than this
INFER_PLAIN_REL = 1e-5
INFER_PLAIN_BATCHES = (8, 40)       # bucket runs 8, and 32 + 8
INFER_AOT_BATCHES = (1, 8)          # 37c
INFER_AOT_REL = 1e-5
GEN_REQUESTS = 16                   # 37b: phase 2's first 16 prompts
GEN_NEW = 32
BATCH_THREADS = 8                   # 37d: 8 threads x 16 single rows
BATCH_PER_THREAD = 16
BATCH_ROWS = 32                     # distinct rows the requests cycle
DECODE_ROWS = 16                    # 37e: 16 rows x 128 positions,
DECODE_LEN = 128
DECODE_STEPS = 64                   # 64 greedy steps over them


def _max_rel(a, b):
    """max |a - b| over max |b| (the scale of the reference)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def infer_feed(cfg, rows, seed):
    """The classifier's three inputs for `rows` rows (int64 ids), with the
    key padding of 16b on two rows so the kernels get a non-zero bias."""
    from paddle_tpu_torch.models import bert
    full = bert.make_pretrain_feed(cfg, INFER_SEQ, rows, seed=seed)
    feed = {k: full[k] for k in ("input_mask", "sent_ids", "src_ids")}
    feed["input_mask"][0, INFER_SEQ - 40:] = 0.0
    if rows > 1:
        feed["input_mask"][rows - 1, INFER_SEQ // 2:] = 0.0
    return feed


def _rows(feed, lo, hi):
    return {k: v[lo:hi] for k, v in feed.items()}


def _flash_delta(flash, fn):
    """(fn's result, (fwd, dQ, dK/dV, bf16 fwd) launches it made)."""
    _zero_counts(flash)
    out = fn()
    return out, _bwd_counts(flash) + (flash.TC_LAUNCHES,)


def _add_counts(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _plain_run(flash, fn, attention=None):
    """(fn's result, its (fwd, dQ, dK/dV, bf16 fwd) launches) with
    attention_ops.dot_product_attention replaced by `attention` (by
    default the plain dense attention, as 16b and 21 put it in), restored
    after."""
    from paddle_tpu_torch.ops import attention_ops
    real = attention_ops.dot_product_attention
    attention_ops.dot_product_attention = attention or _plain_attention
    try:
        return _flash_delta(flash, fn)
    finally:
        attention_ops.dot_product_attention = real


def _attention_without_padding(q, k, v, bias=None, scale=None,
                               causal=False, segment_ids=None):
    """A wrong attention for 37's power check: the plain one with the
    classifier's key-padding bias dropped."""
    return _plain_attention(q, k, v, None, scale, causal, segment_ids)


def check_infer_kernel(flash, cfg, feed):
    """The forward kernel against its plain version (``check_one_flash``)
    at the shapes the inference path gives it: B 1, 3, 8 and 32 (37's
    bucket runs and its 3-row run) x H 12 x T INFER_SEQ x D 64 in f32, and
    B 8 in bf16 (the bf16 Predictor), q/k/v head-transposed views of
    (B, T, H, D), under the classifier's key-padding bias made from the
    feed's input_mask as bert_encoder makes it. Returns {case:
    max_abs_err}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 373)
    h = cfg.num_attention_heads
    d = cfg.hidden_size // h
    errs = {}
    for dtype, tag, batches in ((torch.float32, "f32", (1, 3, 8, 32)),
                                (torch.bfloat16, "bf16", (8,))):
        for b in batches:
            q, k, v = (torch.randn(b, INFER_SEQ, h, d, device="cuda",
                                   generator=gen).to(dtype).transpose(1, 2)
                       for _ in range(3))
            mask = torch.from_numpy(feed["input_mask"][:b]).cuda()
            bias = (mask * 1e9 - 1e9).reshape(b, 1, 1, INFER_SEQ)
            name = f"37 path shape B {b} {tag}"
            errs[name] = check_one_flash(flash, name,
                                         (q, k, v, bias, None, None, False))
    return errs


def phase_predictor(flash, base):
    """Phase 37: BERT-base (phase 16's bert_config(), 12 x 768) as a
    3-label classifier at seq INFER_SEQ, random weights from the startup
    on the card, exported by save_inference_model and served by
    create_predictor with buckets INFER_BUCKETS: predict_batch of 3, 8
    and 40 rows against Executor.run of the for_test clone on the rows of
    each Predictor run (40 as 32 + 8; <= 1e-6 of the probabilities'
    scale), 12 flash launches a bucket run; the forward kernel against
    its plain version at the path's shapes (``check_infer_kernel``); the
    bucket runs of INFER_PLAIN_BATCHES rows within INFER_PLAIN_REL of the
    clone run with the plain dense attention (no flash launch), which the
    clone without key padding must miss; the bf16 (also against its
    scope run with the plain attention), int8 (4 calibration batches),
    reference-__model__ and tp 2 Predictors of the same export. Returns
    (the f32 Predictor, its test program, flash launches by path,
    record)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.io.fluid_proto import save_fluid_inference_model
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.observability.metrics import global_registry
    from paddle_tpu_torch.parallel import ShardedTensor, make_mesh
    cfg = bert_config()
    n = cfg.num_hidden_layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 37
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _f, _loss, _acc, probs = bert.build_classifier_net(
            cfg, seq_len=INFER_SEQ, num_labels=INFER_LABELS)
    test = main.clone(for_test=True)
    names = ["input_mask", "sent_ids", "src_ids"]
    feed = infer_feed(cfg, max(INFER_BATCHES), SEED + 37)
    exe = fluid.Executor()
    rec, paths = {}, {}
    scope = fluid.Scope()
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        exe.run(startup)
        model_dir = os.path.join(base, "bert_cls")
        fluid.io.save_inference_model(model_dir, names, [probs], exe,
                                      main_program=main)
        save_fluid_inference_model(os.path.join(base, "bert_ref"), names,
                                   [probs], exe, main_program=main)
        # each reference runs the rows a Predictor run gets: 40 rows as
        # the split's 32 + 8 (one 40-row run differs in f32 rounding: its
        # products have another M; printed, not gated)
        top = INFER_BUCKETS[-1]
        refs = {b: np.concatenate([
            exe.run(test, feed=_rows(feed, lo, min(lo + top, b)),
                    fetch_list=[probs])[0] for lo in range(0, b, top)])
            for b in INFER_BATCHES}
        whole40 = exe.run(test, feed=_rows(feed, 0, max(INFER_BATCHES)),
                          fetch_list=[probs])[0]
        # the same bucket runs with the plain dense attention put in: what
        # the kernel is held to on the path's shapes; and the power of
        # that gate, a run without the key padding
        plain, plain_c = _plain_run(flash, lambda: {b: np.concatenate([
            exe.run(test, feed=_rows(feed, lo, min(lo + top, b)),
                    fetch_list=[probs])[0] for lo in range(0, b, top)])
            for b in INFER_PLAIN_BATCHES})
        unpadded, unpadded_c = _plain_run(
            flash, lambda: exe.run(test, feed=_rows(feed, 0, 8),
                                   fetch_list=[probs])[0],
            _attention_without_padding)
    del scope
    if plain_c != (0, 0, 0, 0) or unpadded_c != (0, 0, 0, 0):
        _fail(f"37: the plain references launched {plain_c} / "
              f"{unpadded_c} flash kernels")
    paths["37 plain references, bucket runs 8 and 32 + 8 (gated at 0)"] = \
        plain_c
    rec["kernel_at_path_shapes"] = check_infer_kernel(flash, cfg, feed)
    rec["export_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = inference.create_predictor(
        inference.AnalysisConfig(model_dir).set_batch_buckets(
            INFER_BUCKETS))
    rec["load_s"] = time.perf_counter() - t0
    if pred.device.type != "cuda":
        _fail(f"37: the Predictor runs on {pred.device}, want the card")
    pred.warmup([_rows(feed, 0, b) for b in INFER_BUCKETS])
    total = (0, 0, 0, 0)
    errs, ms, plain_errs = {}, {}, {}
    for b in INFER_BATCHES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, c = _flash_delta(flash, lambda: pred.predict_batch(
            _rows(feed, 0, b)))
        ms[b] = (time.perf_counter() - t0) * 1e3
        if b in plain:
            plain_errs[b] = _max_rel(out[0], plain[b])
        runs = -(-b // INFER_BUCKETS[-1])
        if c != (n * runs, 0, 0, 0):
            _fail(f"37: predict_batch({b}) launched {c}, want {n} x "
                  f"{runs} f32 forwards")
        total = _add_counts(total, c)
        if out[0].shape != (b, INFER_LABELS):
            _fail(f"37: predict_batch({b}) gave {out[0].shape}")
        errs[b] = _max_rel(out[0], refs[b])
        if not errs[b] <= 1e-6:
            _fail(f"37: predict_batch({b}) is {errs[b]} from Executor.run")
    paths["37 Predictor f32 predict_batch 3, 8, 40"] = total
    rec["vs_plain_attention"] = {
        "max_rel": {str(b): e for b, e in plain_errs.items()},
        "limit": INFER_PLAIN_REL,
        "without_key_padding_max_rel": _max_rel(unpadded, plain[8])}
    if not max(plain_errs.values()) <= INFER_PLAIN_REL:
        _fail(f"37: the f32 Predictor against plain attention "
              f"{rec['vs_plain_attention']}")
    if not rec["vs_plain_attention"]["without_key_padding_max_rel"] \
            > INFER_PLAIN_REL:
        _fail(f"37: the plain gate cannot see dropped key padding "
              f"{rec['vs_plain_attention']}")
    rec["predict_batch"] = {str(b): {"ms": ms[b], "max_rel": errs[b],
                                     "bitwise": bool(np.array_equal(
                                         pred.predict_batch(
                                             _rows(feed, 0, b))[0],
                                         refs[b]))}
                            for b in INFER_BATCHES}
    rec["predict_batch_40_vs_one_40_row_run_max_rel"] = _max_rel(
        pred.predict_batch(_rows(feed, 0, max(INFER_BATCHES)))[0], whole40)
    x8 = _rows(feed, 0, 8)
    ref8 = pred.run(x8)[0]
    # bf16: every float tensor of the scope bf16, f32 feeds
    pb = inference.create_predictor(
        inference.AnalysisConfig(model_dir).enable_bf16())
    out, c = _flash_delta(flash, lambda: pb.run(x8))
    paths["37 Predictor bf16 run"] = c
    err = float(np.max(np.abs(out[0] - ref8)))
    rec["bf16"] = {"max_abs_vs_f32": err, "atol": INFER_BF16_ATOL,
                   "flash_launches": list(c),
                   "kernel": "flash_fwd_tc_kernel (bf16)" if c[3] == n
                   else "flash_fwd_kernel (f32)"}
    if not err <= INFER_BF16_ATOL or c[0] != n:
        _fail(f"37: bf16 Predictor {err} from f32 (atol "
              f"{INFER_BF16_ATOL}), launches {c}")
    # the bf16 scope again with the plain dense attention put in
    pout, pc = _plain_run(flash, lambda: pb.run(x8))
    paths["37 Predictor bf16 plain reference (gated at 0)"] = pc
    rec["bf16"]["max_abs_vs_plain_attention"] = float(
        np.max(np.abs(out[0] - pout[0])))
    if pc != (0, 0, 0, 0) or not \
            rec["bf16"]["max_abs_vs_plain_attention"] <= INFER_BF16_ATOL:
        _fail(f"37: bf16 Predictor against plain attention "
              f"{rec['bf16']['max_abs_vs_plain_attention']} (atol "
              f"{INFER_BF16_ATOL}), plain launches {pc}")
    del pb
    # int8: per-channel weights, static activation scales from 4 batches
    reg = global_registry()
    w0 = reg.counter("inference.int8.weights").value()
    a0 = reg.counter("inference.int8.calibrated_activations").value()
    calib = [_rows(infer_feed(cfg, 8, SEED + 370 + i), 0, 8)
             for i in range(INFER_CALIB)]
    t0 = time.perf_counter()
    pq = inference.create_predictor(
        inference.AnalysisConfig(model_dir).enable_int8(calib))
    calib_s = time.perf_counter() - t0
    out, c = _flash_delta(flash, lambda: pq.run(x8))
    paths["37 Predictor int8 run"] = c
    rel = _max_rel(out[0], ref8)
    moved = (reg.counter("inference.int8.weights").value() - w0,
             reg.counter("inference.int8.calibrated_activations").value()
             - a0)
    rec["int8"] = {"max_rel_vs_f32": rel, "limit": INFER_INT8_REL,
                   "weights": pq.int8_weight_tensors,
                   "calibrated_activations":
                       pq.int8_calibrated_activations,
                   "counters_moved": list(moved),
                   "load_and_calibrate_s": calib_s}
    if not rel < INFER_INT8_REL or moved != (
            pq.int8_weight_tensors, pq.int8_calibrated_activations) \
            or min(moved) <= 0:
        _fail(f"37: int8 Predictor {rec['int8']}")
    del pq
    # the reference's __model__ layout of the same weights
    pr = inference.create_predictor(os.path.join(base, "bert_ref"))
    out = pr.run(x8)[0]
    rec["reference_layout_max_rel"] = _max_rel(out, ref8)
    if not rec["reference_layout_max_rel"] <= 1e-6:
        _fail(f"37: __model__ Predictor {rec['reference_layout_max_rel']} "
              f"from the native export")
    del pr
    # tp 2 on a local mesh: two positions of cuda:0
    mesh = make_mesh(tp=TP, devices=["cuda:0"] * TP)
    pt = inference.create_predictor(
        inference.AnalysisConfig(model_dir).enable_tensor_parallel(mesh))
    red = []
    outs = []
    tp_c = (0, 0, 0, 0)
    for _ in range(2):
        r0 = mesh.reductions
        o, c = _flash_delta(flash, lambda: pt.run(x8))
        tp_c = _add_counts(tp_c, c)
        outs.append(o[0])
        red.append(mesh.reductions - r0)
    paths["37 Predictor tp 2 (2 runs)"] = tp_c
    sharded = sum(1 for nm in pt.scope.names()
                  if isinstance(pt.scope.get(nm), ShardedTensor)
                  and "tp" in tuple(pt.scope.get(nm).spec))
    rec["tp"] = {"max_rel_vs_one_device": _max_rel(outs[0], ref8),
                 "runs_equal": bool(np.array_equal(outs[0], outs[1])),
                 "tp_sharded_persistables": sharded,
                 "reductions_per_run": red, "flash_launches": list(tp_c)}
    if not rec["tp"]["max_rel_vs_one_device"] <= INFER_TP_REL \
            or sharded < 4 or min(red) <= 0 or tp_c[0] != 2 * TP * n:
        _fail(f"37: tp Predictor {rec['tp']}")
    del pt
    print("predictor " + json.dumps(rec))
    return pred, paths, rec


def _gen_server_ids(srv, requests):
    """Serve `requests` to the end: (ids a request, stats, paged launches,
    wall s)."""
    from paddle_tpu_torch.ops.cuda import paged
    futs = [srv.submit(p, max_new_tokens=GEN_NEW, sampling=s)
            for p, s in requests]
    paged.LAUNCHES = 0
    t0 = time.perf_counter()
    while srv.step():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged.LAUNCHES
    st = srv.get_stats()
    ids = [list(f.result(timeout=0).token_ids) for f in futs]
    srv.close()
    return ids, st, launches, wall


def phase_generation(base):
    """Phase 37b: GPTConfig()'s LM net, random weights from its startup on
    the card, exported by save_inference_model; Predictor with
    enable_generation (16 slots, block 16) serving phase 2's first 16
    prompts in f32, ids bitwise those of a GenerationServer built
    directly from the same parameters; then enable_int8: int8 weights
    (6 a layer) and an int8 pool, ids bitwise those of a direct server
    over quantize_int8() with kv_dtype="int8". One fused step signature,
    the kernel engaged, paged launches = iterations x layers. Returns
    (the f32 Predictor's scope and cfg, paged launches by path, int8
    launches by path, record)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.serving import GenerationServer, GPTServingModel
    cfg = GPTConfig()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED + 371
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        _tokens, _loss, logits = gpt.build_lm_net(cfg, seq_len=INFER_SEQ)
    exe = fluid.Executor()
    path = os.path.join(base, "gpt")
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(path, ["tokens"], [logits], exe,
                                      main_program=main)
    requests = make_requests(cfg.vocab_size)[:GEN_REQUESTS]
    opts = dict(num_slots=16, block_size=16, max_context=1024,
                chunk=CHUNK, start=False)
    rec, by_path, by_path8 = {}, {}, {}
    pred = inference.create_predictor(
        inference.AnalysisConfig(path).enable_generation(cfg, **opts))
    for tag, p, kv, int8 in (("f32", pred, None, False), ("int8", None,
                                                          "int8", True)):
        if int8:
            p = inference.create_predictor(
                inference.AnalysisConfig(path).enable_int8()
                .enable_generation(cfg, **opts))
        ids, st, launches, wall = _gen_server_ids(p.generation_server(),
                                                  requests)
        model = GPTServingModel(gpt.load_params(pred.scope, cfg), cfg)
        if int8:
            model.quantize_int8()
        dids, dst, dlaunches, dwall = _gen_server_ids(
            GenerationServer(model, kv_dtype=kv, **opts), requests)
        r = {"ids_equal_direct": ids == dids,
             "iterations": st["iterations"], "launches": launches,
             "fused_step_signatures": st["fused_step_signatures"],
             "kernel": st["kernel"], "wall_s": wall, "direct_wall_s": dwall,
             "tokens_per_s": sum(map(len, ids)) / wall}
        if int8:
            r["kv_quant"] = st["kv_quant"]
            if st["kv_quant"] is None or st["kv_quant"]["kv_dtype"] != \
                    "int8" or st["kv_quant"]["int8_weights"] != \
                    6 * cfg.num_layers:
                _fail(f"37b: enable_int8 server kv_quant {st['kv_quant']}")
        rec[tag] = r
        if not r["ids_equal_direct"] or st["fused_step_signatures"] != 1 \
                or not st["kernel"]["engaged"] \
                or launches != st["iterations"] * cfg.num_layers \
                or dlaunches != dst["iterations"] * cfg.num_layers:
            _fail(f"37b: generation_server {tag}: {r}")
        name = f"37b generation_server {tag} ({GEN_REQUESTS} requests)"
        (by_path8 if int8 else by_path)[name] = launches
        (by_path8 if int8 else by_path)[name + ", direct server"] = \
            dlaunches
        del p
    print("generation " + json.dumps(rec))
    return pred, cfg, by_path, by_path8, rec


def phase_aot(flash, held, base):
    """Phase 37c: save_aot_model of 37's f32 Predictor's program and scope
    at batches INFER_AOT_BATCHES on the card: every call of the exported
    graphs an aten op or paddle_tpu_torch.flash_attention_fwd (and the
    getitem that unpacks its two outputs); load_aot_model after the
    Predictor, with its Program and scope, is dropped (`held` holds the
    last reference), outputs within INFER_AOT_REL of Predictor.run, 12
    flash launches a run through the op, batch 5 refused. Returns (flash
    launches, record)."""
    from paddle_tpu_torch import inference
    import operator
    cfg = bert_config()
    n = cfg.num_hidden_layers
    d = os.path.join(base, "aot")
    pred = held.pop()
    program, feeds, fetches = pred.program, pred.feed_names, \
        pred.fetch_names
    feed = infer_feed(cfg, 8, SEED + 372)
    want = {b: pred.run(_rows(feed, 0, b))[0] for b in INFER_AOT_BATCHES}
    t0 = time.perf_counter()
    files = inference.save_aot_model(d, program, feeds, fetches,
                                      example_batches=INFER_AOT_BATCHES,
                                      scope=pred.scope)
    export_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in files)
    del pred, program
    gc.collect()
    t0 = time.perf_counter()
    model = inference.load_aot_model(d)
    load_s = time.perf_counter() - t0
    # the loaded exported graphs' calls
    op = torch.ops.paddle_tpu_torch.flash_attention_fwd.default
    kinds = {}
    for b, f in zip(INFER_AOT_BATCHES, files):
        targets = [nd.target for nd in model.exported[b].graph.nodes
                   if nd.op == "call_function"]
        bad = {str(t) for t in targets if not (
            t is op or t is operator.getitem or (
                isinstance(t, torch._ops.OpOverload)
                and t.namespace == "aten"))}
        if bad or targets.count(op) != n:
            _fail(f"37c: {f} calls {bad}, {targets.count(op)} flash ops")
        kinds[f] = {"aten_kinds": len({str(t) for t in targets
                                       if t is not op
                                       and t is not operator.getitem}),
                    "nodes": len(targets), "flash_ops": targets.count(op)}
    counts = (0, 0, 0, 0)
    errs = {}
    for b in INFER_AOT_BATCHES:
        out, c = _flash_delta(flash, lambda: model.run(_rows(feed, 0, b)))
        if c != (n, 0, 0, 0):
            _fail(f"37c: the artifact at batch {b} launched {c}")
        counts = _add_counts(counts, c)
        errs[b] = _max_rel(out[0], want[b])
        if not errs[b] <= INFER_AOT_REL:
            _fail(f"37c: artifact batch {b} {errs[b]} from Predictor.run")
    try:
        model.run(infer_feed(cfg, 5, SEED))
        _fail("37c: batch 5 ran on an artifact of batches 1 and 8")
    except ValueError as e:
        if "no compiled signature" not in str(e):
            raise
    rec = {"files": files, "export_s": export_s, "artifact_bytes": nbytes,
           "load_s": load_s, "graphs": kinds,
           "max_rel_vs_predictor": {str(b): e for b, e in errs.items()},
           "flash_launches": list(counts)}
    del model
    print("aot " + json.dumps(rec))
    return counts, rec


class _BatchLog:
    """The engine under the batching server: records each batch's rows."""

    def __init__(self, pred):
        self.pred = pred
        self.sizes = []

    def predict_batch(self, feeds):
        self.sizes.append(int(next(iter(feeds.values())).shape[0]))
        return self.pred.predict_batch(feeds)


def phase_batching(flash, pred):
    """Phase 37d: BatchingServer (the native queue) over 37's f32
    Predictor: BATCH_THREADS threads x BATCH_PER_THREAD single-row
    requests cycling BATCH_ROWS rows, each request's row within 1e-5 of
    that row alone through Predictor.run, the mean batch above 1;
    requests/s and p50 / p99 latency. Returns (flash launches, record)."""
    import threading
    from paddle_tpu_torch.inference import serving
    cfg = bert_config()
    feed = infer_feed(cfg, BATCH_ROWS, SEED + 373)
    alone = [pred.run(_rows(feed, i, i + 1))[0] for i in range(BATCH_ROWS)]
    eng = _BatchLog(pred)
    srv = serving.BatchingServer(eng, max_batch=INFER_BUCKETS[-1],
                                 max_delay_ms=5.0)
    if srv.backend != "native":
        _fail(f"37d: the batching server runs the {srv.backend} queue")
    lat, errs = [], []
    lock = threading.Lock()

    def client(tid):
        for j in range(BATCH_PER_THREAD):
            i = (tid * BATCH_PER_THREAD + j) % BATCH_ROWS
            t0 = time.perf_counter()
            out = srv.submit(_rows(feed, i, i + 1)).result(timeout=300)
            dt = (time.perf_counter() - t0) * 1e3
            with lock:
                lat.append(dt)
                errs.append(_max_rel(out[0], alone[i]))

    _zero_counts(flash)
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(BATCH_THREADS)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        srv.close()
    wall = time.perf_counter() - t0
    counts = _bwd_counts(flash) + (flash.TC_LAUNCHES,)
    total = BATCH_THREADS * BATCH_PER_THREAD
    rec = {"backend": srv.backend, "requests": len(lat),
           "requests_per_s": len(lat) / wall,
           "latency_ms_p50": float(np.percentile(lat, 50)),
           "latency_ms_p99": float(np.percentile(lat, 99)),
           "batches": len(eng.sizes),
           "mean_batch": float(np.mean(eng.sizes)),
           "max_rel_vs_alone": max(errs),
           "flash_launches": list(counts)}
    if len(lat) != total or not rec["mean_batch"] > 1 \
            or not max(errs) <= 1e-5:
        _fail(f"37d: batching server {rec}")
    print("batching " + json.dumps(rec))
    return counts, rec


def phase_paged_decode(gen_scope, cfg):
    """Phase 37e: DECODE_STEPS steps of greedy_decode through
    gpt.build_kv_step over build_paged_decode_cache (DECODE_ROWS rows x
    DECODE_LEN positions) against over init_kv_cache of the same size,
    with 37b's parameters: ids bitwise equal
    in f32 and in bf16; with int8 pools the ids' agreement with the f32
    dense decode is reported; the pool's blocks come back."""
    from paddle_tpu_torch.inference import decoding as dec
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import (PagedKVCache,
                                          build_paged_decode_cache)
    d = cfg.hidden_size // cfg.num_heads
    base = gpt.load_params(gen_scope, cfg)
    bos = torch.from_numpy(np.random.default_rng(SEED + 374).integers(
        0, cfg.vocab_size, DECODE_ROWS)).cuda()
    rec, ids = {}, {}
    for tag, dt, kv in (("f32", torch.float32, None),
                        ("bf16", torch.bfloat16, None),
                        ("int8", torch.float32, "int8")):
        params = gpt._to_device(gpt._cast_params(base, dt), "cuda")
        step = gpt.build_kv_step(params, cfg, DECODE_LEN)
        pool = PagedKVCache(cfg.num_layers, cfg.num_heads, d,
                            num_blocks=1 + DECODE_ROWS * DECODE_LEN // 16,
                            block_size=16, dtype=dt, kv_dtype=kv)
        free0 = pool.num_free
        t0 = time.perf_counter()
        layers, _tables, blocks = build_paged_decode_cache(
            pool, DECODE_ROWS, DECODE_LEN)
        ids_p, _ = dec.greedy_decode(step, layers, bos, DECODE_STEPS)
        torch.cuda.synchronize()
        paged_s = time.perf_counter() - t0
        pool.free(blocks)
        r = {"paged_s": paged_s, "pool_free_back": pool.num_free == free0}
        if kv is None:
            t0 = time.perf_counter()
            dense = dec.init_kv_cache(DECODE_ROWS, cfg.num_layers,
                                      cfg.num_heads, DECODE_LEN, d,
                                      dtype=dt)
            ids_d, _ = dec.greedy_decode(step, dense, bos, DECODE_STEPS)
            torch.cuda.synchronize()
            r["dense_s"] = time.perf_counter() - t0
            r["ids_bitwise_dense"] = bool(torch.equal(ids_p, ids_d))
            if not r["ids_bitwise_dense"]:
                _fail(f"37e: {tag} paged ids differ from dense")
        else:
            r["ids_agree_f32_dense"] = float(
                (ids_p == ids["f32"]).float().mean())
        ids[tag] = ids_p
        if not r["pool_free_back"]:
            _fail(f"37e: {tag} pool has {pool.num_free} free, want {free0}")
        rec[tag] = r
        del pool, layers
    print("paged decode " + json.dumps(rec))
    return rec


def _scope_versions(scope):
    return {n: scope.get(n)._version for n in scope.names()}


def phase_explain(pred):
    """Phase 37f: Executor.explain on 37's classifier (the Predictor's
    loaded program and scope, 8 rows) and on phase 16's BERT-base
    training Program (Adam, its startup run here): no step
    runs (step counter and every scope tensor's _version unchanged),
    flops > 0, the program attribution's fwd_flops the sum of
    model_stat's per-op-type counts, peak >= param + optimizer bytes;
    the estimate beside max_memory_allocated over one real step (a
    finding, no gate)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.utils import model_stat
    cfg = bert_config()
    rec = {}
    x8 = infer_feed(cfg, 8, SEED + 375)
    main, startup, loss = build_bert(cfg)
    feed = bert_feed()
    for tag, prog, scope, f, fetch in (
            ("classifier", pred.program, pred.scope, x8,
             pred.fetch_names[0]),
            ("bert_train", main, None, feed, loss)):
        exe = pred._exe if scope is not None else fluid.Executor()
        if scope is None:
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
        counter, versions = exe._step_counter, _scope_versions(scope)
        t0 = time.perf_counter()
        rep = exe.explain(prog, feed=f, fetch_list=[fetch], scope=scope)
        explain_s = time.perf_counter() - t0
        if exe._step_counter != counter or \
                _scope_versions(scope) != versions:
            _fail(f"37f: explain({tag}) moved the step counter or wrote "
                  f"the scope")
        b = next(iter(f.values())).shape[0]
        per_op = model_stat.count_flops(prog, b)[1]
        prog_rep = rep["static"]["program"]
        mem = rep["memory"]
        if not rep["flops"] > 0 or prog_rep["fwd_flops"] != \
                sum(per_op.values()) or prog_rep["per_op_type"] != \
                dict(sorted(per_op.items(), key=lambda kv: -kv[1])) \
                or not rep["peak_hbm_bytes"] >= mem["param_bytes"] \
                + mem["optimizer_bytes"]:
            _fail(f"37f: explain({tag}) {rep['flops']} flops, attribution "
                  f"{prog_rep['fwd_flops']} vs {sum(per_op.values())}, "
                  f"peak {rep['peak_hbm_bytes']} vs {mem}")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        exe.run(prog, feed=f, fetch_list=[fetch], scope=scope)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        rec[tag] = {"explain_s": explain_s, "flops": rep["flops"],
                    "model_stat_fwd_flops": prog_rep["fwd_flops"],
                    "bytes_accessed": rep["bytes_accessed"],
                    "peak_hbm_bytes_estimate": rep["peak_hbm_bytes"],
                    "param_bytes": mem["param_bytes"],
                    "optimizer_bytes": mem["optimizer_bytes"],
                    "aten_calls": rep["static"]["aten"]["eqns"],
                    "max_memory_allocated_step": peak,
                    "allocated_before_step": base,
                    "estimate_over_measured": rep["peak_hbm_bytes"] / peak}
        if tag == "bert_train":
            del scope, exe
    print("explain " + json.dumps(rec))
    return rec


def phase_inference_all(flash):
    """Phases 37, 37b, 37d, 37e, 37f, then 37c (its artifact loads once
    37's Predictor is dropped); exports under one temporary directory the
    phases remove. Returns (flash launches by path, paged launches by
    path, int8 paged launches by path, records)."""
    base = tempfile.mkdtemp(prefix="infer_")
    recs = {}
    try:
        pred, paths, recs["37"] = _phase(
            "37 Predictor on BERT-base", phase_predictor, flash, base)
        gpred, gcfg, by_path, by_path8, recs["37b"] = _phase(
            "37b generation_server at GPT width", phase_generation, base)
        paths["37d batching server"], recs["37d"] = _phase(
            "37d batching server", phase_batching, flash, pred)
        recs["37e"] = _phase("37e paged decode adapter at GPT width",
                             phase_paged_decode, gpred.scope, gcfg)
        del gpred
        recs["37f"] = _phase("37f explain", phase_explain, pred)
        # 37c last: the artifact loads once the Predictor is gone
        held = [pred]
        del pred
        paths["37c AOT artifact (batches 1 and 8)"], recs["37c"] = _phase(
            "37c AOT artifact on BERT-base", phase_aot, flash, held, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return paths, by_path, by_path8, recs


def times_of(flag, root):
    """Phase 10 (`--bwd-times-of`) or phase 8 (`--fwd-times-of`) alone on
    the flash kernels of the package under `root` (a checkout of another
    commit, for a comparison inside one call): builds its flash libraries
    and prints the phase's rows, then the card line."""
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


HOST_TURNS, HOST_TURN_REPS = 21, 100    # --host-cost-of's turns


def host_cost_of(root):
    """`--host-cost-of <checkout>`: the host microseconds of one
    flash_attention_cuda call (phase 16's attention: B 8, H 12, T 512,
    D 64, f32, a (B, 1, 1, T) key-padding bias) with the package under
    `root` (the median of HOST_TURNS turns; with the registered op, the
    op's CUDA kernel called as a plain function in turns beside it: the
    dispatcher's hop in one process), then phase 16 alone on it (its step
    p50), then the card line. Run a parent checkout and this one in one
    call, in turns, to compare the registered op with the parent's direct
    ctypes call."""
    sys.path.insert(0, os.path.abspath(root))
    from paddle_tpu_torch.ops.cuda import flash
    if not flash.__file__.startswith(os.path.abspath(root)):
        _fail(f"{flash.__file__} is not under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _phase("build", flash.build)
    b, h, t, d = BERT_BATCH, 12, BERT_SEQ, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
               for _ in range(3))
    bias = torch.zeros(b, 1, 1, t, device="cuda")
    calls = {"flash_attention_cuda": lambda: flash.flash_attention_cuda(
        q, k, v, bias)}
    op = getattr(flash, "flash_attention_fwd_op", None)
    if op is not None:
        # the wrapper's checks, then the registered op's CUDA kernel called
        # as a plain function: the same call without the dispatcher's hop
        calls["launch_without_dispatcher"] = lambda: op(
            q, k, v, flash._check(q, k, v, bias, None, None), None, None,
            flash._scale(q, None), False)
    us = _host_us_turns(calls)
    _, rec, _ = _phase("16 BERT-base pretrain", phase_bert, flash)
    print(_card_line())
    print(json.dumps({"host_cost_of": root,
                      "flash_call_host_us": us["flash_attention_cuda"],
                      "host_us_median_of_turns": us,
                      "phase16_step_ms_p50": rec["step_ms_p50"]}))


def _host_us_turns(calls, turns=HOST_TURNS, reps=HOST_TURN_REPS):
    """{name: the median over `turns` of the mean host microseconds of
    one call in `reps` calls}, the calls of `calls` taking turns in one
    process (each turn waits for the card first): a comparison that
    process-to-process spread does not reach."""
    got = {name: [] for name in calls}
    for fn in calls.values():
        fn()
    for _ in range(turns):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            got[name].append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return {name: float(np.median(v)) for name, v in got.items()}


def inference_phases():
    """`--inference-phases`: the build and phases 37-37f alone, then the
    card line and their launch counts."""
    from paddle_tpu_torch.ops.cuda import flash
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _phase("build", build_all)
    t37 = time.perf_counter()
    paths, gen, gen8, _ = phase_inference_all(flash)
    print(f"phases 37-37f: {time.perf_counter() - t37:.1f} s")
    print(_card_line())
    print(json.dumps({"inference_phases": {"flash": paths, "paged": gen,
                                           "paged_int8": gen8}}))


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
    if len(sys.argv) == 5 and sys.argv[1] == "--tp-world-rank":
        tp_world_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    if len(sys.argv) == 5 and sys.argv[1] == "--dp-world-rank":
        dp_world_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    if len(sys.argv) == 5 and sys.argv[1] == "--dps-world-rank":
        dps_world_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--fleet-world-rank":
        fleet_world_rank(sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--host-cost-of":
        host_cost_of(sys.argv[2])
        return
    if sys.argv[1:] == ["--inference-phases"]:
        inference_phases()
        return
    if len(sys.argv) > 1:
        _fail(f"arguments {sys.argv[1:]}: want none, --inference-phases, "
              f"or --bwd-times-of, --fwd-times-of, --paged-of or "
              f"--host-cost-of <checkout>")
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
    _phase("1fn flash kernel NaN cases", check_flash_nan, flash)
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
    bert_launches, bert16, prof16 = _phase("16 BERT-base pretrain",
                                           phase_bert, flash)
    bagree_launches, bagree_errs = _phase("16b BERT agree",
                                          phase_bert_agree, flash)
    packed_launches, pagree_launches, pagree_errs = _phase(
        "16c packed pretrain", phase_packed, flash)
    ring_launches, ring_errs = _phase("17 ring attention", phase_ring,
                                      flash)
    fleet = phase_fleet_all(paged, cfg, tree, gcfg, gtree)
    tp_launches, tp_errs, _ = _phase("19 tp serving, local mesh", phase_tp,
                                     paged, cfg, tree)
    tpg_launches, tpg_errs, _ = _phase("19b tp GQA, dense and int8 KV",
                                       phase_tp_gqa, paged, gcfg, gtree)
    tpp_launches, tpp_errs = _phase("19c tp prompt decoding",
                                    phase_tp_prompt, flash, cfg, tree)
    tpw_launches, _ = _phase("19d tp world, two processes", phase_tp_world,
                             paged, cfg, tree)
    recipe_paths, recipe_errs, rec20 = phase_recipe_all(flash, bert16,
                                                        prof16)
    dp_paths, dp_errs, rec21, world34c = phase_dp_all(flash, bert16, prof16)
    recipe_dp_paths, _ = _phase("22 recipe dp", phase_recipe_dp, flash,
                                rec20, rec21)
    phase_conv_all(flash, paged)
    tf_launches, tf_errs, _ = _phase("24 Transformer-base train",
                                     phase_transformer, flash)
    tfa_launches, tfa_errs = _phase("24b Transformer agree",
                                    phase_transformer_agree, flash)
    phase_ctr_all(flash, paged)
    guard_paths, guard_errs = phase_guarded_all(flash, paged)
    opt_paths, _ = phase_optimizers_all(flash, paged)
    seq_counts, _ = phase_seq_all(flash, paged)
    cf_counts, _ = phase_cf_all(flash, paged)
    det_counts, _ = phase_det_all(flash, paged)
    vis_counts, vis_recs = phase_vision_all(flash, paged)
    met_counts, _ = phase_metric_all(flash, paged)
    quant_counts, _ = phase_quant_all(flash, paged, vis_recs["31b"]["v1"])
    t34 = time.perf_counter()
    c34 = world34c["record"]["seconds_in_21d"]
    shard_paths, shard_recs = phase_shard_all(flash, bert16, prof16, rec21,
                                              world34c)
    del world34c
    print(f"phases 34-34d: {time.perf_counter() - t34 + c34:.1f} s (34c's "
          f"{c34:.1f} s inside 21d's processes)")
    t35 = time.perf_counter()
    fleet_paths, _ = phase_fleet_train_all(flash, shard_recs["34"],
                                           rec21[0])
    print(f"phases 35-35c: {time.perf_counter() - t35:.1f} s")
    t36 = time.perf_counter()
    pp_paths, _ = phase_pp_all(flash)
    print(f"phases 36-36c: {time.perf_counter() - t36:.1f} s")
    t37 = time.perf_counter()
    infer_paths, gen_paths, gen_paths8, infer_recs = phase_inference_all(
        flash)
    infer_errs = infer_recs["37"]["kernel_at_path_shapes"]
    print(f"phases 37-37f: {time.perf_counter() - t37:.1f} s")
    path_errs = {**perrs, **serrs, **derrs, **terrs, **tp_errs}
    by_path = {
        "2 serve": launches,
        "11 prefix f32 warm pass": prefix["f32"]["launches_warm"],
        "12 spec verify (target, small draft, f32)":
            spec["small_draft_f32"]["target_launches"],
        "12 spec draft D 32 (f32)":
            spec["small_draft_f32"]["draft_launches"],
        "28-28e sequence family (gated at 0)": seq_counts[4],
        "29-29c control flow (gated at 0)": cf_counts[4],
        "30-30c detection (gated at 0)": det_counts[4],
        "31-31g vision nets (gated at 0)": vis_counts[4],
        "32-32d tensor, loss and metric ops (gated at 0)": met_counts[4],
        "33-33e quant, sampling and match ops (gated at 0)":
            quant_counts[4],
        **dlaunches, **tlaunches, **plaunches,
        **fleet["18"]["launches"], **fleet["18b"]["launches"],
        "18c self-healing f32 (3 replicas + resurrections)":
            fleet["18c"]["launches"],
        **fleet["18d"]["launches"], **tp_launches, **tpw_launches,
        **gen_paths,
        **{k: v for k, v in tpg_launches.items() if "dense" in k}}
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
            "x D 64, bs 16, M 64, bf16; launches_by_path counts phases 2, "
            "11-15, 18-18d and 19-19d, max_abs_err includes their captured "
            "calls (path_errs)"),
        kernel_entry(
            "paged_attention_int8",
            "paddle_tpu/ops/pallas/paged.py:151-219 (_paged_kernel int8 "
            "branch, launch :282), paddle_tpu/ops/pallas/paged.py:435-437 "
            "(_paged_kernel_v2 int8 dequant, launch :505)",
            launches8, [errs[f"int8_{n}{d}_bf16"] for n in SHAPES
                        for d in ("", "_d128")]
            + [nan_errs[f"nan_{n}_int8_bf16q"] for n in NAN_SHAPES]
            + list(tpg_errs.values()), times8,
            "fused-step decode: 16 lanes x H 12 over H_kv 4 x C 16 (one "
            "valid column) x D 64, bs 16, M 64, int8 pools, bf16 q; "
            "launches_by_path counts phases 2b, 18b and 19b, max_abs_err "
            "includes 19b's captured calls (path_errs)"),
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
    kernels[1]["launches_by_path"] = {"2b serve int8": launches8,
                                      **fleet["18b"]["launches_int8"],
                                      **gen_paths8,
                                      **{k: v for k, v in tpg_launches.items()
                                         if "int8" in k}}
    kernels[1]["path_errs"] = tpg_errs
    kernels[0]["path_errs"] = path_errs
    # the flash kernels' paths: (fwd, dQ, dK/dV, bf16 fwd) launches of
    # each run, counted from 0 just before it
    flash_paths = {
        f"16 BERT-base pretrain ({BERT_WARM + BERT_STEPS} steps)":
            bert_launches,
        "16b BERT agree (kernel run, 2 layers x 3 steps)": bagree_launches,
        "16c packed pretrain (10 steps)": packed_launches,
        "16c packed agree (kernel run, 2 layers x 1 step)": pagree_launches,
        **{f"17 ring sp {RING_SP} {case} (one call)": c
           for case, c in ring_launches.items()},
        **recipe_paths, **dp_paths, **recipe_dp_paths, **shard_paths,
        **fleet_paths, **pp_paths, **infer_paths,
        f"24 Transformer-base train ({TF_WARM + TF_STEPS} steps)":
            tf_launches,
        "24b Transformer agree (card run, 2 + 2 layers x 3 steps)":
            tfa_launches,
        **guard_paths, **opt_paths,
        "28-28e sequence family (gated at 0)": seq_counts[:4],
        "29-29c control flow (gated at 0)": cf_counts[:4],
        "30-30c detection (gated at 0)": det_counts[:4],
        "31-31g vision nets (gated at 0)": vis_counts[:4],
        "32-32d tensor, loss and metric ops (gated at 0)": met_counts[:4],
        "33-33e quant, sampling and match ops (gated at 0)":
            quant_counts[:4]}
    tpp_name = f"19c tp {TP} prompt decode"
    kernels[2]["launches_by_path"] = {
        "6 prompt decode": flaunches,
        **{name: c[3] for name, c in flash_paths.items()},
        tpp_name + " bf16": tpp_launches[tpp_name + " bf16"]}
    kernels[3]["launches_by_path"] = {"9 train": f32_launches, **{
        name: c[0] - c[3] for name, c in flash_paths.items()},
        tpp_name + " f32": tpp_launches[tpp_name + " f32"]}
    kernels[2]["max_abs_err"] = max([kernels[2]["max_abs_err"],
                                     tpp_errs["bf16"]] + [
        e for name, e in infer_errs.items() if name.endswith("bf16")])
    kernels[4]["launches_by_path"] = {"9 train": blaunches, **{
        name: c[1] + c[2] for name, c in flash_paths.items()}}
    kernels[3]["max_abs_err"] = max(
        [kernels[3]["max_abs_err"], tpp_errs["f32"]]
        + [e for name, e in infer_errs.items() if name.endswith("f32")]
        + [e[0] for e in ring_errs.values()]
        + [e[0] for e in tf_errs.values()]
        + [e[0] for e in guard_errs.values()])
    kernels[4]["max_abs_err"] = max(
        [kernels[4]["max_abs_err"]] + [e[1] for e in ring_errs.values()]
        + [e[1] for e in tf_errs.values()]
        + [e[1] for e in guard_errs.values()])
    agree = {"16b BERT agree": bagree_errs,
             **{f"24 Transformer-base {call} (out, grads: max abs)": list(e)
                for call, e in tf_errs.items()},
             "24b Transformer agree (card vs CPU)": tfa_errs,
             **{f"{call} (out, grads: max abs)": list(e)
                for call, e in guard_errs.items()},
             "16c packed agree": pagree_errs,
             "20d recipe agree (bf16 products)": recipe_errs,
             **dp_errs,
             **{f"17 ring {case} (out, grads: max abs)": list(e)
                for case, e in ring_errs.items()}}
    kernels[3]["path_errs"] = kernels[4]["path_errs"] = agree
    kernels[2]["path_errs"] = {tpp_name + " prefill bf16": tpp_errs["bf16"],
                               **{name: e for name, e in infer_errs.items()
                                  if name.endswith("bf16")}}
    kernels[3]["path_errs"] = dict(agree, **{
        tpp_name + " prefill f32": tpp_errs["f32"]}, **{
        name: e for name, e in infer_errs.items() if name.endswith("f32")})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
