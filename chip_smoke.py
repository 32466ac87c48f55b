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
18. the in-process fleet: bench.py's fleet traffic at full-width lengths
   (18 tenant system prompts of 128 tokens, 85 % of 96 requests one of
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
   new process; bf16: the fleet traffic through two workers against one
   in-process server, in turns, and a 512-token prompt's chain handed
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
   a bf16 dot), the attention in f32 through the flash kernels. 30 steps
   on one batch: every loss finite, the last below 0.95 x the first, the
   first within 1e-2 of phase 16's f32 first loss (the same weights, feed
   and dropout masks), 12 + 12 + 12 flash launches a step and none of the
   tensor-core kernel, the rate fetched each step the schedule's closed
   form; prints step ms p50/p99, tokens/s, the peak memory, the loss
   scale and good-step count at the end, and a profile of 3 more steps
   beside phase 16's (wall and device ms, busy share, device operations
   a step);
20b. the recipe under ``RecomputeOptimizer(policy="dots")`` and
   ``"nothing"`` beside two runs without recompute, from copies of one
   startup scope, 3 steps each: the first loss equal, the first step's
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
   whose two ranks run in turn on the card, 30 steps on phase 16's feed
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
   through ``with_data_parallel(places=[CUDAPlace(0)] * 2)``, 30 steps:
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
   seed, one batch for 30 steps, under torch's default cuDNN setting
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
   feeds full lengths): 30 steps on one batch; every step launches the
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
   the card from the seed, 30 steps on one batch: every loss finite and
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
26. ERNIE-base (phase 16's program and cell, Adam 1e-4, dropout 0.1)
   under guarded asynchronous training, 30 distinct ERNIE feeds: two
   clean runs from one startup on ``Executor(guard=True,
   async_window=2)``, one through ``run()``, one through ``run_async()``
   (their distance is the card's own); the host syncs inside 5 warm
   dispatches (torch's sync debug mode: 0); an upload probe (step k ends
   with 50 ms of device sleep: step k+1's pinned feed upload must leave
   it on the card, a pageable copy must wait for it); run against
   run_async in alternating blocks; the guard's cost (an unguarded run:
   p50, device ms and operations); then ``GuardedTrainer``
   (checkpoint_every 5) with a NaN poisoned into step 12's MLM weights,
   the 3rd physical checkpoint write failing and a SIGTERM before step
   20, and a fresh Executor, scope and ``GuardedTrainer.resume()`` to
   step 30: one rollback, the write retried, every step's loss within
   4x the clean runs' distance (or 1e-5) of the clean run's; 12 + 12 +
   12 flash launches a step in every run, flash_dbias 0, the first
   layer's attention against the plain version; checkpoint bytes, sync
   and async save and restore ms, peak memory;
26b. save_params / save_persistables / save_inference_model and the
   Fluid 1.5 formats (save_fluid_inference_model) from 26's trained
   scope, each reloaded in a fresh Scope and Executor: the pooled output
   and the MLM logits bitwise the trained program's clone(for_test=True),
   12 forward launches a reloaded forward, the persistables bitwise;
26c. ``run_pipelined`` over 20 ERNIE batches (the last 5 rows, padded to
   8 by a FeedBucketer) against run() over the same feeds from the same
   startup: losses in feed order within 26's tolerance; the prefetch
   depth and each copy's share hidden under earlier steps;
26d. phase 25's DeepFM through ``train_from_dataset`` over 4 generated
   MultiSlot files (16,384 examples, 4 native parse threads, 8 batches
   of 2048): the native parser ran, the losses match run() over the same
   batches; examples/s of both. No attention kernel.

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
of phases 11-15, 18-18d (the workers' own counts among them) and 19-19d
(19d's ranks' own) in ``launches_by_path``, the int8 entry those of
phases 2b, 18b and 19b, the flash entries those of phases 16-17, 19c,
20-20d, 21-21d, 22, 24-24b and 26-26c, with 16b/16c/17/19b/19c/20d/21b/
21c/24/24b/26's errors in ``path_errs``); the
line before
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
# phases 18-18d: bench.py's fleet traffic (its tenant long tail) at
# full-width lengths, 16 slots, block 16, chunk 16, context 1024
FLEET_TENANTS = 18
FLEET_TENANT_LEN = 128
FLEET_SHARED = 0.85                 # share of requests behind a tenant
FLEET_REQUESTS = 96
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
RECOMPUTE_POLICIES = ("dots", "nothing")
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
# phases 23-23c: bench.py's ResNet cell (bench.py:285-313), on the port
RESNET_DEPTH = 50
RESNET_CLASSES = 1000
RESNET_IMAGE = (3, 224, 224)
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_BATCH = 32                   # a card (PaddleCV: 256 over 8 cards)
RESNET_WARM = 3
RESNET_STEPS = 27
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
TF_STEPS = 27
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
DEEPFM_STEPS = 27
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
# phases 26-26c: ERNIE-base (phase 16's program) under guarded
# asynchronous training: GUARD_STEPS steps of distinct ERNIE feeds, the
# async window GUARD_WINDOW, a checkpoint every GUARD_CKPT_EVERY steps, a
# NaN poisoned into step GUARD_POISON_AT, the GUARD_WRITE_FAULT-th
# physical checkpoint write failing, a SIGTERM before step
# GUARD_PREEMPT_AT
GUARD_STEPS = 30
GUARD_WINDOW = 2
GUARD_CKPT_EVERY = 5
GUARD_POISON_AT = 12
GUARD_WRITE_FAULT = 3
GUARD_PREEMPT_AT = 20
GUARD_COST_STEPS = 10               # the unguarded run's timed steps
# 26's upload probe: step k ends with this much device sleep, so it is
# still on the card when step k+1's feeds are uploaded; GUARD_PROBES times
GUARD_PROBE_SLEEP_MS = 50.0
GUARD_PROBES = 3
GUARD_SYNC_STEPS = 5                # warm dispatches with syncs counted
GUARD_TIMING_BLOCKS = 4             # run / run_async blocks, alternating
GUARD_TIMING_STEPS = 8
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
    routing over the fleet traffic (FLEET_REQUESTS requests, one
    arriving a router step, FLEET_NEW greedy tokens), bf16: tokens/s
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
    prompts = fleet_requests(cfg.vocab_size)
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


def phase_workers(paged, root, flight, cfg, main):
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
    iterations x layers. Flight dumps go under `flight`."""
    from paddle_tpu_torch.robustness import (ChaosInjector,
                                             CheckpointManager,
                                             SupervisorConfig,
                                             make_checkpoint_spawn)
    from paddle_tpu_torch.serving import FleetRouter, prompt_chain_keys
    from paddle_tpu_torch.serving.remote import make_subprocess_spawn
    kw = dict(num_slots=16, block_size=16, max_context=1024, chunk=CHUNK,
              start=False, prefix_cache=True)
    manager = CheckpointManager(root, program=main)
    prompts = fleet_requests(cfg.vocab_size)
    gate = prompts[:FLEET_GATE]
    out = {"launches": {}}
    runs = {}
    layers = cfg.num_layers
    common = dict(seq_len=FLEET_CKPT_SEQ, program_seed=FLEET_PROGRAM_SEED,
                  flight_dir=flight, spawn_timeout_s=WORKER_SPAWN_S,
                  **kw)
    chaos = ChaosInjector()
    spawn32 = make_subprocess_spawn(root, cfg, chaos=chaos, **common)
    spawn16 = make_subprocess_spawn(root, cfg, dtype="bfloat16", **common)
    ws, boot_s = _spawn_workers(
        lambda i: (spawn32 if i < 2 else spawn16)(i), 4)
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
    gen = len(prompts) * FLEET_NEW
    turns = {"single": [], "workers": []}
    router = FleetRouter(w16, start=False)
    for turn in ("single", "workers", "workers", "single"):
        if turn == "single":
            _ids1, wall, _l = _single_pass(paged, model, prompts, FLEET_NEW)
            turns["single"].append(gen / wall)
        else:
            before = [_worker_counts(w) for w in w16]
            _ids2, wall, _l = _router_pass(paged, router, prompts,
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
        res["18c"] = _phase("18c self-healing", phase_self_healing, paged,
                            root, flight, ccfg, main)
        res["18d"] = _phase("18d out-of-process fleet", phase_workers,
                            paged, root, flight, ccfg, main)
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
    recompute. Returns (launches by run, record)."""
    import paddle_tpu_torch as fluid
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
                     "tc": flash.TC_LAUNCHES}
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
                       "launches_a_step": run["per_step"]}
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
        rec.update(backend=dist.get_backend(),
                   all_reduce_ms_per_step=spent["all_reduce"]
                   / DP_WORLD_TIMED * 1e3,
                   gradient_all_reduce_ms_per_step=spent["gradients"]
                   / DP_WORLD_TIMED * 1e3,
                   gradient_bytes=spent["bytes"])
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


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
    return launches, out


def phase_dp_all(flash, bert16, prof16):
    """Phases 21-21d. Returns (flash launches by path, the agreement
    errors, 21's (record, profile))."""
    dlaunches, rec, prof = _phase("21 dp BERT-base pretrain", phase_dp,
                                  flash, bert16, prof16)
    alaunches, aerrs, dp_ref = _phase("21b dp agree", phase_dp_agree,
                                      flash)
    slaunches, serrs = _phase("21c dp x sp GPT", phase_dp_sp, flash)
    wlaunches, _ = _phase("21d dp world, two processes", phase_dp_world,
                          dp_ref)
    steps = BERT_WARM + BERT_STEPS
    paths = {f"21 dp {DP} BERT-base pretrain ({steps} steps)": dlaunches,
             f"21b dp {DP} agree (kernel run, {BERT_AGREE_LAYERS} layers x "
             f"{BERT_AGREE_STEPS} steps)": alaunches,
             f"21c dp {DP} x sp 2 GPT ({BERT_AGREE_STEPS} steps)": slaunches,
             **wlaunches}
    errs = {f"21b dp {DP} vs dp 1": aerrs["dp2_vs_dp1"],
            f"21b dp {DP} kernel vs plain": aerrs["kernel_vs_plain"],
            f"21c dp {DP} x sp 2 vs dp 1": serrs}
    return paths, errs, (rec, prof)


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
    by_op, emb = {}, 0.0
    for e in prof.events():
        if e.device_type.name != "CPU":
            continue
        if e.name.startswith("op:"):
            by_op[e.name[3:]] = by_op.get(e.name[3:], 0.0) + _device_total(e)
        elif e.name == "aten::embedding_dense_backward":
            emb += _device_total(e)
    by_op = {k: v / steps / 1e3 for k, v in by_op.items() if v > 0}
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


def _nan_bias_report(flash):
    """Reported, not gated (ROADMAP C11): one key's additive bias NaN in
    a (2, 2, 64, 64) f32 call. Whether the f32 flash forward's rows of
    that batch and the plain version's are finite, and the kernel's
    largest distance from the plain version with that key masked."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 27)
    q, k, v = (torch.randn(2, 2, 64, 64, generator=gen, device="cuda")
               for _ in range(3))
    bias = torch.zeros(2, 1, 1, 64, device="cuda")
    bias[0, 0, 0, 0] = float("nan")
    b4 = bias.expand(2, 2, 64, 64)
    out, _lse = flash.flash_attention_cuda(q, k, v, b4, None, None, None,
                                           False)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / 8.0
    plain = torch.softmax(s + b4, -1) @ v
    masked = torch.softmax(s + torch.nan_to_num(b4, nan=float("-inf")),
                           -1) @ v
    return {"kernel_rows_finite": bool(torch.isfinite(out[0]).all()),
            "plain_rows_finite": bool(torch.isfinite(plain[0]).all()),
            "kernel_max_abs_from_masked": float((out - masked).abs().max())}


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
    """Phase 26: ERNIE-base (phase 16's program, Adam 1e-4, dropout 0.1)
    under guarded asynchronous training. Two clean GUARD_STEPS-step runs
    from one startup, one through run(), one through run_async() with
    window GUARD_WINDOW, both on Executor(guard=True): their distance is
    the card's own (torch's CUDA embedding backward sums in no fixed
    order). Then GuardedTrainer over the same feeds, checkpoint_every
    GUARD_CKPT_EVERY: a NaN poisoned into step GUARD_POISON_AT, the
    GUARD_WRITE_FAULT-th physical checkpoint write failing, a SIGTERM
    before step GUARD_PREEMPT_AT; a fresh Executor, scope and
    GuardedTrainer resume() from the emergency checkpoint and finish.
    Gates: one rollback and one recovered write fault, preempted at
    GUARD_PREEMPT_AT, every step's loss within GUARD_SPREAD x the clean
    runs' distance (or GUARD_LOSS_FLOOR) of the clean run's; 12 + 12 +
    12 flash launches a step in every run, none of flash_dbias; 0 host
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
    cfg = bert_config()
    n = cfg.num_hidden_layers
    main, startup, loss = build_bert(cfg)
    feeds = guard_feeds(GUARD_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paths, rec = {}, {"config": "BertConfig(max_position_embeddings=512), "
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
        # in input_mask reaches the attention only as its padding bias)
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
        "nan_bias_report": _nan_bias_report(flash)})
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
    same feed, each reloaded forward launching the f32 flash forward 12
    times and no backward; the persistables reload bitwise. Returns the
    launches by path and the record."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    exe, scope, main, _loss = trained
    n = bert_config().num_hidden_layers
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
    cfg = bert_config()
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
    rng = np.random.default_rng(SEED + 26)
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
        "26 ERNIE-base under GuardedTrainer", phase_guarded, flash)
    more, _ = _phase("26b save and load", phase_save_load, flash, trained)
    paths.update(more)
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    more, _ = _phase("26c run_pipelined", phase_pipelined, flash, tol)
    paths.update(more)
    _phase("26d DeepFM train_from_dataset", phase_dataset, flash, paged)
    return paths, {"26 ERNIE GuardedTrainer layer 0": errs}


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
    dp_paths, dp_errs, rec21 = phase_dp_all(flash, bert16, prof16)
    recipe_dp_paths, _ = _phase("22 recipe dp", phase_recipe_dp, flash,
                                rec20, rec21)
    phase_conv_all(flash, paged)
    tf_launches, tf_errs, _ = _phase("24 Transformer-base train",
                                     phase_transformer, flash)
    tfa_launches, tfa_errs = _phase("24b Transformer agree",
                                    phase_transformer_agree, flash)
    phase_ctr_all(flash, paged)
    guard_paths, guard_errs = phase_guarded_all(flash, paged)
    path_errs = {**perrs, **serrs, **derrs, **terrs, **tp_errs}
    by_path = {
        "2 serve": launches,
        "11 prefix f32 warm pass": prefix["f32"]["launches_warm"],
        "12 spec verify (target, small draft, f32)":
            spec["small_draft_f32"]["target_launches"],
        "12 spec draft D 32 (f32)":
            spec["small_draft_f32"]["draft_launches"],
        **dlaunches, **tlaunches, **plaunches,
        **fleet["18"]["launches"], **fleet["18b"]["launches"],
        "18c self-healing f32 (3 replicas + resurrections)":
            fleet["18c"]["launches"],
        **fleet["18d"]["launches"], **tp_launches, **tpw_launches,
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
                                      **{k: v for k, v in tpg_launches.items()
                                         if "int8" in k}}
    kernels[1]["path_errs"] = tpg_errs
    kernels[0]["path_errs"] = path_errs
    # the flash kernels' paths: (fwd, dQ, dK/dV, bf16 fwd) launches of
    # each run, counted from 0 just before it
    flash_paths = {
        "16 BERT-base pretrain (30 steps)": bert_launches,
        "16b BERT agree (kernel run, 2 layers x 3 steps)": bagree_launches,
        "16c packed pretrain (10 steps)": packed_launches,
        "16c packed agree (kernel run, 2 layers x 1 step)": pagree_launches,
        **{f"17 ring sp {RING_SP} {case} (one call)": c
           for case, c in ring_launches.items()},
        **recipe_paths, **dp_paths, **recipe_dp_paths,
        f"24 Transformer-base train ({TF_WARM + TF_STEPS} steps)":
            tf_launches,
        "24b Transformer agree (card run, 2 + 2 layers x 3 steps)":
            tfa_launches,
        **guard_paths}
    tpp_name = f"19c tp {TP} prompt decode"
    kernels[2]["launches_by_path"] = {
        "6 prompt decode": flaunches,
        **{name: c[3] for name, c in flash_paths.items()},
        tpp_name + " bf16": tpp_launches[tpp_name + " bf16"]}
    kernels[3]["launches_by_path"] = {"9 train": f32_launches, **{
        name: c[0] for name, c in flash_paths.items()},
        tpp_name + " f32": tpp_launches[tpp_name + " f32"]}
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"],
                                    tpp_errs["bf16"])
    kernels[4]["launches_by_path"] = {"9 train": blaunches, **{
        name: c[1] + c[2] for name, c in flash_paths.items()}}
    kernels[3]["max_abs_err"] = max(
        [kernels[3]["max_abs_err"], tpp_errs["f32"]]
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
    kernels[2]["path_errs"] = {tpp_name + " prefill bf16": tpp_errs["bf16"]}
    kernels[3]["path_errs"] = dict(agree, **{
        tpp_name + " prefill f32": tpp_errs["f32"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
