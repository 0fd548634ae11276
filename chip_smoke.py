"""End-to-end check of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), the torch and
   CUDA versions, and the time to build the CUDA kernels from the sources
   under src/repro_torch/kernels/csrc (one nvcc process per source, all
   started together).
2. Kernels: each kernel of the training paths against its plain PyTorch
   version on the card, at the paths' shapes (the smollm-135m gradient
   pool: 134,515,008 elements in 11 leaves; padded to 134,545,408 =
   4106 chunks of 32,768 for CSC), timed with CUDA events (median of 20
   runs after 3 warm-up runs), beside the bytes bound and, where one
   PyTorch call computes the same function, that call's time (timed only;
   the port never calls it).
   - pool_pack: the lazy packs (grads f32->bf16, params f32->f32) and the
     CSC packs (both f32->f32 into the padded pool), bit for bit, pool
     and staging buffer; the chunk census to 1e-6 relative.
   - pool_unpack_update: lazy's 6 spans with an all-true and a random
     mask and with per-tensor ratios, CSC's 7 spans of the padded pool
     with a chunk-granular mask (the last span holds no leaf), and the
     whole padded pool in one launch with f32[T+1] ratios (LARS
     monolithic), bit for bit.
   - chunk_l1norm: the census of an f32 pool of 4106 x 32,768 (and of its
     bf16 cast) to 1e-6 relative against the plain version and
     torch.linalg.vector_norm, the same bits on two launches and, f32, at
     a grid of 77 CTAs.
   - csc_compact: the gather of k = 616 and k = 3233 sorted chunk ids,
     bit for bit against the plain version and torch.index_select, also
     at a grid of 77 CTAs.
   These two short kernels also print back_to_back_ms and
   library_back_to_back_ms (B2B launches in one event region, divided by
   B2B: the device's time once the host runs ahead), enqueue_ms and
   library_enqueue_ms (the host's time to enqueue one launch), and the
   launch plan; ms and library_ms stay one launch an event region, host
   time included, as in earlier runs.
   - ring_allreduce: N = 2, 4, 8 ranks in this process, each on its own
     stream (the in-process workspace), on the 6 lazy buckets, the whole
     lazy pool and the CSC steady wire buffer (616 x 32,768) in bf16, and
     the first bucket in f32, int8 and fp8-e4m3 (sums past 448); bit for
     bit against the plain ring with the kernel's segment, every rank the
     same bits, the first bucket also in place (out = x);
     library_ms is torch.stack(xs).float().sum(0); enqueue_ms the host
     time to enqueue the N launches; the 6 lazy buckets at N = 2 are also
     timed back to back in one region.
   - fused_update: the whole f32 pool, all-true and random mask, with and
     without the scale, bit for bit; then optim.update_pool, the entry
     point that reaches it, for 3 steps with its launches counted.
   - pool_unpack_update also with the guard's ``ok`` over the whole
     padded pool: ok = true equal to the launch without it, ok = false
     (NaN gradients) writing nothing; both timed.
   - Non-finite words (the ``nan_words`` line): NaN, +-Inf and 2^120 in
     the gradient leaves through the lazy bf16 pack, the CSC f32 pack and
     the census, and through the ring at N = 2 on the first lazy bucket
     with a NaN on one rank, each against its plain version with NaN
     compared by class; the NaN word each one emits.
   Then the optimizer ops, which are PyTorch ops and no kernel (as in
   the JAX package): one step's LARS trust ratios over the lazy spans and
   over CSC's masked spans (equal to the whole-pool ratios), and one AdamW
   update sweep over CSC's 7 spans, each timed beside its bytes bound.
   Then the ring on the low-bit wires' words (the ``quantized_ring``
   line): N = 2, 4, 8 ranks, each quantizing a θ bucket of its own
   gradients with the scales of the summed census; int8 equal to the flat
   integer sum bit for bit, fp8-e4m3 within the JAX package's gate (448 x
   the largest scale x 2^-4) of the f32 sum of the same words, with no
   NaN code (0x7F, 0xFF) in any word.
3. Train: smollm-135m at full width and depth (batch 16, sequence 1024,
   bf16 wire, kernels on) inside a world-size-1 NCCL group, through the
   CLI's loop (``repro_torch.launch.train``) on the synthetic stream,
   then through the Trainer it builds on one repeated batch:
   (a) lazy, momentum SGD, theta = 4 Mi elements: 6 + 6 steps;
   (b) CSC, momentum SGD, chunks of 32,768, sparsity 0.85 reached after
       4 warm-up steps: step 0 dense (7 buckets), steps 1-3 at k = 3233,
       2361, 1488, steps 4-7 at k = 616 (5 wire buckets); 8 + 8 steps;
   (d) LARS (lr LARS_LR), (b)'s CSC settings, staged: 8 + 8 steps, every
       update launch carrying the span's ratios;
   (e) LARS, lazy, staged (the CLI) and then monolithic (a Trainer with
       overlap='monolithic': one whole-pool update launch a step), 6 + 6
       steps each from one seed; the repeated batch's losses of the two
       modes equal to 1e-6 relative, the largest parameter difference
       printed;
   (f) AdamW (lr ADAMW_LR), (b)'s CSC settings, staged: 8 + 8 steps, no
       update kernel (AdamW is PyTorch ops);
   (c) collective_algo="pallas_ring", world size 2 as two processes on
       this card (this script with --ring-rank), a gloo group for the
       set-up and the cross-process (CUDA IPC) ring workspace, one per
       level group, shared by every bucket: lazy, 3 steps on the stream,
       then 3 on one repeated batch, the first step's post-reduce pool
       equal to the plain ring of the two ranks' packed pools (on rank
       0's CPU); then CSC, 5 steps (the dense step, the ramp, one steady
       step at k = 616: the ring reduces the compacted wire buffer).
       Every bucket through the ring kernel, both ranks the same
       parameters after every step; each rank's peak device memory.
       Then (k), guarded lazy (``GuardConfig()``), 4 steps with a NaN
       written into rank 0's pool only at step 2: both ranks trip there
       and only there (the poison crossed the ring in-band), keep the same
       parameters, and launch the ring as often a step as unguarded.
   The numeric guard (``GuardConfig()``: loss scale 2^15), in the NCCL
   group, each fault 4096 pool elements wide, injected by the Trainer's
   fault hook after the pack:
   (g) lazy, staged, (a)'s settings, 8 steps on the stream: a NaN at step
       2, 2^120 at step 4, an exponent-MSB bit flip at step 6 (at least
       one flipped word must have been inside [2^-8, 2) and land at 2^119
       or more);
   (h) CSC, staged, (b)'s settings: a NaN in the dense warm-up step 0,
       2^120 in the steady step 5;
   (i) LARS, lazy, monolithic, (e)'s monolithic settings: a NaN at step
       2, 2^120 at step 4.
   In each, exactly the faulted steps trip; at each trip the parameters,
   the momentum and (CSC) hg and the chunk norms equal bit for bit the
   clones taken before the step; the scale halves at each trip from
   2^15; clean losses are finite; the dispatch counts equal the step
   plans' (a tripped step still launches its predicated updates); the
   clean steps' median time goes beside (a)'s, (b)'s and (e)'s.
   (j) GuardConfig(init_scale=1.0), no fault, against unguarded (twice):
       6 lazy steps on one repeated batch give the same losses and final
       parameters bit for bit (or, if the two unguarded runs differ,
       stay within their spread).
   The low-bit wires (``--wire-format``; lazy runs chunk the pool at
   32,768 as CSC does, so it has 7 buckets, the last padding only):
   (l) int8, lazy, staged, 6 + 6 steps: the pack takes the chunk census
       (``pool_pack``'s census path), 2 packs and 7 updates a step, 8
       all-reduces a step (7 buckets and the census sum), 134,561,832
       wire bytes a step against (a)'s 269,030,016 (analytic); on one
       step, on the device, dequant(q) + residual_new equals g +
       residual_old to f32 rounding;
   (m) int8, CSC, staged, 8 + 8 steps: the dense warm-up on the native
       wire, then k = 616 on int8 (20,201,512 wire bytes a step, the
       census included); on a steady step the residual moves at exactly
       the selected chunks;
   (n) fp8-e4m3, lazy, staged then monolithic, 6 + 6 steps each from one
       seed: the repeated batch's losses and final parameters the same
       bits, every parameter and the residual finite;
   (o) guarded int8 (``GuardConfig()``), lazy with (g)'s faults and CSC
       with (h)'s: exactly the faulted steps trip, each skip bit-identical
       on the device, the residual included, and the dispatch and
       all-reduce counts equal the step plans';
   (p) in (c)'s two processes over the ring: int8, lazy (3 + 3 steps) and
       CSC (5 steps); every lazy ring launch and every sparse CSC one
       carries int8 words (the dense warm-up bf16), the two ranks keep
       the same parameters.
   Each low-bit run's steady step time and peak memory go beside its bf16
   twin's of this call. Every run in the NCCL group also counts its
   ``dist.all_reduce`` calls against the step plans'.
   The training window as a CUDA graph (``Trainer.build_train_window``,
   in the NCCL group; the runs above pass ``--window-steps 1``, one
   eager step at a time):
   (q) lazy, (a)'s settings, a window of 8 steps: the first window
       (warm-up on scratch clones, capture, replay) the same losses and
       final parameters and momentum, bit for bit, as 8 eager steps of
       the CLI's loop from the same seed on the same batches; then a
       replayed window timed (step ms = window ms / 8, beside the eager
       steps'), the capture's and warm-up's host seconds, peak memory
       beside eager, the capture's launches against 8 x the plan's, the
       all-reduces of the first window (the warm-up body's and the
       capture's) and none in the replayed ones, the synchronizing
       calls of one window and its read (``set_sync_debug_mode``: 1)
       against an eager step's, and one window and two eager steps
       under ``torch.profiler``: the device's busy time and idle share,
       the kernels a step, the pool kernels' and the GEMMs' time;
   (r) (q) with ``pipeline_tail_buckets=2``: the same bits as (q)'s
       window, a flushed state; 4 head updates a step, 2 lane updates at
       each step's start and 2 at the flush (each with a pack of its
       span's masters), (q)'s all-reduces;
   (s) CSC through the CLI at ``--window-steps 4`` (``--csc-warmup 8``,
       16 steps: the snapped stages 1 and 2 run 4 steps each, the steady
       stage 4 two windows): one graph a stage, freed when the stage
       ends (one graph pool alive at each window's end), the capture's
       launches the stage plan's x 4, the losses of eager steps under
       the same snapped schedule bit for bit, the peak reserved memory
       under one graph's pool plus the state and its warm-up clone; the
       step time of the steady stage's replayed window beside the eager
       twin's steady steps;
   (t) guarded lazy windows of 8 with (g)'s faults fired by the
       device-step hook inside the graph, unpipelined and with a tail of
       2: exactly steps 2, 4, 6 trip in the stacked ``guard_tripped``;
       an in-graph digest of the parameters and momentum shows each skip
       bit-identical (the rejected lane included); the losses (g)'s; the
       pipelined window the unpipelined one's bits;
   (u) in (c)'s two processes over the ring, a lazy window of 3 with a
       tail of 2, graphed on both ranks, on the lazy run's batches: the
       same losses as that eager run, the same parameters on both ranks
       after each window, every ring launch the warm-up body's or the
       capture's (the replays run the rest).
   ``GuardLane`` on the card (the ``guard_lane_windowed`` line), lazy and
   CSC: ``window=4`` gives the per-step records.
   Checkpoints, restarts, resume and elastic (smollm-135m at full
   width, bf16 wire, momentum SGD, kernels on):
   (v) lazy windows of 8, 16 steps under ``TrainSupervisor.run_windows``
       in the NCCL group, a checkpoint every 8, batches from a
       ``DataPipeline``, a host fault raised at step 12 after the window
       8-15 ran: one restart, restored to 8, saves at 8 and the final 16,
       one capture (the restore went into the live tensors)
       with the launches its plan says, every loss of the final pass and
       the final parameters and momentum bit for bit an uninterrupted
       16-step window run; save's blocking
       seconds, the writer's seconds, bytes a checkpoint, restore
       seconds, and the step time of windows with a write in flight
       against those without;
   (w) CSC through the CLI at ``--window-steps 4`` (``--csc-warmup 8``)
       in new processes, each with ``--steps 16``: one preempted by a
       SIGTERM after step 8 (its handler stops the run there, with the
       checkpoint at 8), then a process with the same flags resuming
       that directory at 8 to 16: its losses, and the SHA-256 of every
       leaf of its final checkpoint (parameters, momentum, hg, chunk
       norms), those of an uninterrupted 16-step CLI run;
   (x) in (c)'s two processes over the ring, CSC at ``--window-steps
       1``, 12 steps under the supervisor with a collective checkpoint at
       8 (``hg`` [2, pool]); then this process restores step 8 into a
       host state of that layout, re-splits ``hg`` to one row
       (``reshard_hg``: the column total as numpy sums it), saves it at
       8, and a one-rank Trainer restores it in place (the re-split row
       and rank 0's parameters and momentum bit for bit, a one-rank plan
       key) and trains steps 8-11 on the same global batch, within
       ELASTIC_RTOL of the two ranks' losses, a bound that two controls
       (the restored hg zeroed, rank 0's row alone) exceed.
   Every checkpoint goes under a temporary directory of the script's
   (the CLI's default directory too), after a check that 16 GiB are
   free; it is emptied after each phase and removed at the end. Every
   CLI run must end with no restart of its supervisor.
   Long sequences on the dense models, after every phase above:
   (z) attention at olmo-1b's layer shape (batch 4, sequence 4096, 16
       heads of 128) and at musicgen-large's (batch 4, 1500 frames, 32
       heads of 64), bf16, causal: the flash-attention kernel (the
       port's path on the card) and its plain version, the blockwise
       full grid, blockwise causal_skip and full attention (the port's
       CPU forms) and F.scaled_dot_product_attention (a yardstick the
       port never calls: library_ms); each form's output and q, k, v
       gradients within 2^-6 of the largest full-attention value of full
       attention's, and within 2^-6 relative RMS of it per 1024-position
       (musicgen: 500) block and head (a planted rescale of the last
       query block must fail that bound), the two blockwise forms as
       close to each other; forward and forward + backward ms (CUDA
       events) against the causal FLOPs at 989 TFLOP/s, the memory
       autograd holds after the forward, and each one's peak;
   (au) the afmoe kernels at the trinity-mini-train cell's shapes (bf16):
       the grouped GEMM (``grouped_mm``: forward, dX and dW) over the 32
       held experts of 4 x 8192 tokens routed top-8 by trinity-mini-ep4's
       sigmoid router (262,144 slots, ~65,000 held), for the gate/up
       product (2048 -> 1024) and the down one (1024 -> 2048), against
       the plain version within one bf16 ulp of the largest value
       (2^-7), the rows past the experts' 0, dW the same bits twice, and
       a product through the next expert's weights (the control) outside
       that bound; the windowed flash kernels (4 x 8192, 32 heads of
       128, window 2048), forward and backward, against the plain version
       within the card tests' bounds (2^-6 of the largest value, 2^-7
       relative RMS, the log-sum-exp 2^-14), the causal kernels' output
       (the control) outside them; each timed (CUDA events) beside the
       plain version, its bound (the products' FLOPs over the held rows
       or the kept pairs at 989 TFLOP/s) and a library call the port
       never calls (``torch._grouped_mm``; F.scaled_dot_product_attention
       with the window as a mask), and one product and one windowed
       attention through ``ops`` and autograd, counted once each;
   the pool kernels at olmo-1b's lazy pool (8 leaves, 1,176,764,416
       elements): the bf16 gradient pack, the f32 master pack and the
       8-span update, bit for bit against their plain versions, timed
       beside them, torch.cat and the bytes bound (parts of the
       pool_pack and pool_unpack_update entries);
   in a new world-size-1 NCCL group:
   (y) olmo-1b at full width and depth (16 layers, d_model 2048,
       non-parametric LayerNorm, 1,176,764,416 parameters), lazy, bf16
       wire, kernels on, through ``train.build`` with ``--seq-len 4096
       --batch 16 --attn-chunk 1024`` and ``microbatches=4`` on the
       TrainConfig (4 x 4096 tokens a microbatch): 2 steps on one
       repeated batch, then one under the profiler; finite losses that
       fall, every attention call through the flash-attention kernel
       (``flash_attention.kernel``: each layer's forward and its remat
       recompute, whatever --attn-chunk), the pack and update launches
       and the all-reduces the plan's; step ms, tokens/s, peak memory,
       the first step's seconds, and the model and executed FLOP shares
       of the dense bf16 peak
       (``step_flops``: the model's 6 N T and causal attention; the
       path's remat forward and full masked grid on top);
   (aa) stablelm-12b and qwen3-32b at their published widths (LayerNorm
       with bias at 5120; QK-norm, GQA 64/8 on heads of 128), their depth
       cut to 2 layers (1.58 G and 2.53 G parameters), the same way as
       (y) at 2 x 4096 tokens in 2 microbatches, 2 steps each; then
       olmo-smoke, stablelm-smoke and qwen3-smoke through the CLI and
       the Trainer (``train_run``), CSC (2 warm-up steps, sparsity 0.5,
       chunks of 2048), sequence 256 with 64-token attention chunks: 5 +
       5 steps each, finite losses that fall on the repeated batch,
       chunk_l1norm and csc_compact launched, every attention call
       through the flash-attention kernel;
   (ab) smollm-135m lazy ((a)'s settings) at microbatches 2: 4 eager
       steps against a window of 4 as a CUDA graph on the same batches,
       the same bits, the capture's launches the plan's x 4; the same
       guarded with a NaN at step 2 (that step alone trips, its skip
       bit-identical by an in-graph digest, the eager guarded bits);
       then int8 lazy with ``--no-error-feedback``, 6 + 6 steps: finite
       losses that fall, no residual carried (size 0).
   The MoE, vlm and audio families, in a new world-size-1 NCCL group
   (lazy, bf16 wire, momentum SGD, kernels on, 2 steps on one repeated
   batch and one profiled, as (y)), after the MoE layer at grok1- and
   arctic-smoke's widths on the card against its CPU run in f32 (planted
   ties, capacity 0.5: the same routing and dropped slots, the outputs
   within 1e-5 of the largest):
   (ac) arctic-480b at its published widths (d_model 7168, 56 / 8 heads
       of 128, expert d_ff 4864, dense residual 4864, vocab 32000, top-2,
       capacity 1.25), cut to 1 layer and 16 of its 128 experts
       (2,354,451,456 parameters), 2 x 4096 tokens in 2 microbatches
       (640 slots an expert a microbatch), --attn-chunk 1024: step ms,
       tokens/s, peak memory, the model (active experts) and executed
       (the E x cap padded slots) FLOP shares, the aux losses, the slots
       each expert got and the share dropped (the remat recompute
       routing as the forward did), and the profiled step's device time
       by model part (routing, dispatch, expert GEMMs, combine, the dense
       residual MLP, attention, the pool kernels);
   (ad) internvl2-26b at its published widths (d_model 6144, 48 / 8
       heads, d_ff 16384, vocab 92672), 2 layers, 2 sequences of 256
       vision + 4096 text positions (blocks of 544) in 2 microbatches
       through the Trainer on ``models.registry.make_batch`` batches;
   (ae) musicgen-large whole (48 layers, 4 codebooks; 2,454,065,152
       parameters), 8 x 1500 frames (30 s at 50 Hz) in 2 microbatches,
       full attention;
   (af) grok1-, arctic- and musicgen-smoke through the CLI in CSC
       ((aa)'s smoke settings), internvl2-smoke through the Trainer on
       make_batch batches: finite losses that fall, the census and the
       gather launched; grok1-smoke lazy in a graphed window of 4
       against 4 eager steps (the eager bits; MoE routing inside the
       graph), and guarded with a NaN at step 2 (that step's skip
       bit-identical). grok-1-314b is not run at its published widths:
       one layer with its 8 experts holds 6.53 G parameters (~97 GiB of
       state).
   The ssm and hybrid families, in a new world-size-1 NCCL group (as the
   families above), after Mamba-1's and Mamba-2's layers in bf16 on the
   card against their CPU run at the smoke widths on two 128-position
   chunks (the output and every gradient within 2^-5 of the largest
   |value|) and the two cores alone at (ag)'s and (ah)'s widths (the
   selective scan and the SSD, forward and forward + backward ms against
   their bounds):
   (ag) falcon-mamba-7b at its published widths (d_model 4096, d_inner
       8192, d_state 16, dt_rank 256, vocab 65024, untied head), cut to 4
       layers (953,929,728 parameters), 2 x 4096 tokens in 2
       microbatches, remat per layer: step ms, tokens/s, peak memory, the
       model and executed FLOP shares (the scan counts none) and the
       profiled step's device time by kernel class and idle share;
   (ah) zamba2-2.7b whole (54 Mamba-2 layers in 9 groups of 6, the shared
       attention block after each group; 2,422,670,240 parameters), 2 x
       4096 in 2 microbatches, full attention, the same numbers;
   (ai) falcon-mamba-smoke and zamba2-smoke through the CLI, lazy (2
       steps) and CSC ((aa)'s settings, 3 steps), on 256 positions, then
       3 steps on one repeated batch: finite losses that fall, no
       restart, the census and the gather launched in CSC; zamba2-smoke
       lazy in a graphed window of 4 against 4 eager steps (the eager
       bits; the nested remat and the shared block inside the graph).
   Serving, after every training phase, bf16 weights drawn on
   the card (``launch.serve.serve_params``), steps from
   ``Trainer.build_serve_step``:
   first every smoke family's prefill (2 x 16) and 4 teacher-forced
   decode steps in f32 on the card against the same run on the CPU
   (each call's logits within 1e-4 of the largest |logit|);
   (aj) the serve CLI (``launch.serve.main``) in this process:
       smollm-135m at full size, 8 x 1024 then 32 tokens, and the six
       smoke families (smollm, grok-1, internvl2 text only, musicgen,
       falcon-mamba, zamba2) at 2 x 16 then 4: prefill and decode
       tokens/s, peak memory, cache bytes; the tokens of their shape
       and in [0, vocab);
   (ak) smollm-135m at full size: the teacher-forced decode of 16
       positions against the prefill's logits (both forms, within 2^-4
       of the largest |logit|, a bound measured on the CPU first);
       prefill_32k's length (1 x 32,768, batch cut from 32, blockwise
       with causal_skip) timed after a 1 x 2048 warm-up; decode_32k's
       cache (64 x 32,768, batch cut from 128: 48.3 GB) after a 64 x 512
       prefill, 8 timed steps after 2 untimed in each form, the two
       forms from one state within 2^-4, one step under
       ``set_sync_debug_mode("error")``, the bytes bound and its share,
       one layer's decode attention in both forms beside SDPA's over the
       positions written (a yardstick the port never calls);
   (al) falcon-mamba-7b whole (64 layers, 7.27 G parameters): 1 x 1024
       prefill (its recurrent states left zero, as JAX's prefill leaves
       them), 32 decode steps (2 untimed), one profiled (launches a step,
       idle share), one under the sync check; the drawing's and the
       run's peak memory, the bound share;
   (am) zamba2-2.7b whole at long_500k's cache (1 x 524,288 positions,
       48.3 GB of KV cache): the same, 16 decode steps.
   Serving launches none of the six kernels: the counts, set to 0 before
   the group, are read after it (``launches_serving`` in each kernel's
   entry).
   The timeline and the soak, after serving:
   (an) ``launch.dryrun --timeline`` in dense, lazy and CSC (each table's
       summary line), then the elastic soak (``runtime.soak``) at its
       defaults (300 simulated steps on 64 x 8 GPUs, a 24-step guard
       lane) with the lane on the card against the same run with the
       lane on the CPU: the whole trace equal (its records are integers,
       booleans and powers of two); ``dryrun --soak`` prints the card
       trace's table; the lane's launches by kernel (pack, update,
       census, gather: ``launches_soak_lane``) and the phase's seconds.
   The model axis (tensor parallelism, ``Trainer(cfg, device, mesh)``):
   (ao) olmo-1b at its published widths and whole depth (16 layers,
       d_model 2048, 16 heads, d_ff 8192, vocab 50304, tied), 1 x 4096
       tokens, blockwise attention beyond 1024, lazy, bf16 wire, momentum
       SGD, kernels on, 3 steps on one repeated batch and one more timed
       whole, the model group's all-reduces counted: first at (1, 1) in
       this process, then at mesh (1, 2) as two processes on this card (the
       model group over gloo, through pinned host memory; the two
       contexts time-sliced), the weights drawn on the card from the
       seed and cut per rank. The losses within 6e-3 relative of the
       (1, 1) run's (JAX's own bound for this comparison), each leaf
       block's update norm within 2^-4 of the (1, 1) block's, the local
       pool half the (1, 1) pool, the model group's all-reduces a step
       as Megatron's form with remat counts them (5 x layers + 5), the
       pool kernels' launches the step plans'; each rank's step ms and
       peak memory, the all-reduces' bytes and seconds. Then olmo-smoke
       in CSC through the CLI at ``--mesh 1x2``, 3 steps (the census and
       the gather on each rank's local pool, the selection on the model
       group's summed norms; the replicated leaves' digests equal on both
       ranks after every step: olmo has none). ``launches_model_axis``:
       both ranks' launches.
   (ap) the other families under the model axis, the same way: arctic-
       480b at (ac)'s cut (its published widths, 1 of 35 layers, 16 of
       128 experts), 1 x 4096 tokens, lazy, bf16 wire, 2 steps on one
       repeated batch and one more timed whole, at (1, 1) here
       and at (1, 2) in two processes: its rules shard the experts (8 a
       rank), the vocabulary and the dense residual's hidden units and
       leave attention and the router replicated. (ao)'s bounds on the
       losses and each leaf block's update norm; the first step's routing
       (slots per expert, dropped share) the same at both meshes; the
       model group's all-reduces a step 1 + 3 x layers + 4; each rank's
       parameters its blocks and the replicated leaves whole; each rank's
       step ms, peak memory, the all-reduces' bytes and seconds. Then the
       smoke configurations of arctic-480b, grok-1-314b, internvl2-26b
       (on ``make_batch`` batches), musicgen-large, falcon-mamba-7b and
       zamba2-2.7b in f32 (TF32 off), 2 lazy steps, and falcon-mamba-smoke
       in CSC, each at (1, 1) and (1, 2): losses and update norms within
       1e-4 (CSC: its first loss), the replicated leaves' digests equal on
       both ranks after every step. ``launches_model_axis_families``: both
       ranks' launches.
   (aq) the update path under the model axis, in (ao)'s two rank
       processes right after (ao) (its (1, 1) runs in this process before
       them): olmo-1b at its published widths, 4 of its 16 layers, 2 x
       4096 tokens in 2 microbatches, blockwise attention beyond 1024,
       lazy, staged, kernels on, with the numeric guard (GuardConfig()),
       the int8 wire with error feedback and LARS, 2 steps on one
       repeated batch and one more timed whole, at (1, 1) and
       (1, 2). The losses within 6e-3; no step trips; the model group's
       all-reduces a step 2 x (5 x layers + 5) + 1 (each microbatch's
       Megatron sums and the guard's group verdict); LARS's trust ratios
       are per shard (a rank's local spans), so each leaf block's
       first-step update norm over the ratio its update used is held
       within 2^-4 of the (1, 1) block's over the whole leaf's ratio.
       Then olmo-smoke with AdamW, monolithic, on the fp8 wire at both
       meshes (losses within 6e-3, update norms within 2^-4); at (1, 2)
       arctic-smoke in CSC through the CLI, 4 sparse steps, its
       replicated attention and router the same bits on both ranks after
       every step (ROADMAP.md C.1); and olmo-smoke guarded on the int8
       wire with a NaN in rank 1's block of a sharded leaf at step 1: both
       ranks trip there and only there, keep their parameters, momentum
       and residual bit for bit (a digest before and after), halve the
       scale, and commit the next step. ``launches_model_axis_update_path``:
       both ranks' launches; pool_pack, pool_unpack_update, chunk_l1norm
       and csc_compact must each have launched.
   (ar) the rest of training under the model axis, after (ap), in four
       processes on this card: olmo-1b at its published widths, 2 of its
       16 layers, 1 x 4096 tokens a data rank, blockwise attention beyond
       1024, lazy, bf16 wire, kernels on, 3 steps on one repeated batch
       at mesh (2, 2) with the flat collective and then with pallas_ring:
       each model index's data ring launches ring_allreduce once a bucket
       a step (the count equals the plan's), the flat run none; the two
       data ranks of a model index see the same losses; the ring's losses
       within 6e-3 of the flat run's and each leaf block's update norm
       within 2^-4; step ms and peak memory a rank. Then ranks 0 and 1 in
       a new group of two at (1, 2), olmo-smoke in CSC on the bf16 wire:
       a checkpoint at step 2 (JAX's global layout, rank 0 writing)
       restored in place gives the uninterrupted next step bit for bit;
       the CLI with --ckpt-dir, a checkpoint every 2 steps and a host fault
       after step 3 restarts once and gives the fault-free losses; and
       build_train_window refuses on the card, naming the model group's
       gloo sums. ``launches_model_axis_collectives``: every rank's
       launches.
   The kernels' dispatch counts are set to 0 just before each run and
   read just after: every kernel of the run's path must have launched,
   exactly as often as its step plans say, and no plain version may have
   run. Every loss must be finite and the repeated batch's last loss below
   its first.

Prints one JSON line per kernel, one for the NaN words, one for the
optimizer ops, one for the quantized ring, the MoE layer's card-against-
CPU line, the Mamba layers' card-against-CPU line, the scan and SSD
timings' line, the serving line, the timeline and soak line, the model
axis line, the model axis update path line, the other families' model
axis line, the rest of training's model axis line (ar), one per train
run (the
long sequences' and the families' runs too), the attention line, the windowed GuardLane's, the host seconds of
each group of phases and of the script in all, the card's nvidia-smi
line, the kernel summary line (each kernel with ``in_graph``: whether a
captured window launched it, and ``launches_by_run``), then ``{"ok":
true, "device": {...}}`` as the last line. Any failed check ends the run
with a non-zero exit before that line. Exits non-zero without a result
when no CUDA device is visible.

    python3 chip_smoke.py --short-kernels [--src DIR]

runs only the device line, the build and the chunk_l1norm and csc_compact
phases, on the package under DIR/repro_torch (default: this tree's src):
a parent's checkout timed the same way as this tree, in one call. It
prints their JSON lines and the card's line, and no result line.

"""
from __future__ import annotations

import json
import math
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

BATCH = 16
SEQ = 1024
BUCKET_ELEMS = 4_194_304
CHUNK = 32768
REPS, WARMUP = 20, 3
B2B = 20  # launches in one event region for the back-to-back times
LAZY_STEPS = 6
CSC_STEPS = 8
# Steps on the one repeated batch after the stream's steps, in the runs
# of (a)-(n) that watch no later step and count no launches over both
# passes: enough to show the loss falling.
REPEAT_STEPS = 3
CSC_SPARSITY, CSC_WARMUP = 0.85, 4
CSC_KS = (616, 3233)  # the steady stage's k, and the first sparse stage's
# smollm-135m's attention launches a step: its 30 layers' forwards and
# their remat recomputes.
SMOLLM_ATTN = 60
# The CSC run's launches, from its step plans: 2 packs a step, 7 update
# spans a step, 1 census a step, 1 gather a sparse step; and the model's
# attention.
CSC_COUNTS = {"pool_pack.kernel": 16, "pool_unpack_update.kernel": 56,
              "chunk_l1norm.kernel": 8, "csc_compact.kernel": 7,
              "flash_attention.kernel": SMOLLM_ATTN * CSC_STEPS}
# AdamW has no update kernel (plain PyTorch ops, as in the JAX package).
ADAMW_CSC_COUNTS = {k: v for k, v in CSC_COUNTS.items()
                    if k != "pool_unpack_update.kernel"}
# LARS's trust ratio (eta = 0.001) sets each tensor's step to about
# lr * 1e-3 of its norm: 0.5 % a step at 5.0, at which runs (d) and (e)
# check that the repeated batch's loss falls.
LARS_LR = 5.0
ADAMW_LR = 1e-3

# Device-memory bandwidth by card (NVIDIA data sheets), for the bounds.
HBM_BYTES_PER_S = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12,
                   "H100": 3.35e12, "H200": 4.8e12}
F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores

UPDATE_LIBRARY_NOTE = ("no single PyTorch call computes this function "
                       "(e.g. torch._fused_sgd_ applies lr after the "
                       "momentum, not inside it)")
PACK_LIBRARY_NOTE = ("torch.cat(leaves [+ a zero tail for the padded pool], "
                     "out=staging): the pack without a census in one call; "
                     "timed only, the port never calls it")
CENSUS_LIBRARY_NOTE = ("torch.linalg.vector_norm(pool.view(C, chunk), ord=1, "
                       "dim=1); timed only, the port never calls it")
COMPACT_LIBRARY_NOTE = ("torch.index_select(pool.view(C, chunk), 0, idx); "
                        "timed only, the port never calls it")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def hbm_rate(name: str) -> float:
    for key in HBM_BYTES_PER_S:  # most specific names first
        if key in name:
            return HBM_BYTES_PER_S[key]
    fail(f"no memory bandwidth on record for {name!r}")


def bound_ms(nbytes: float, flops: float, rate: float):
    t_bytes, t_ops = nbytes / rate * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(torch, fn) -> float:
    """B2B launches in one event region, divided by B2B: the device's time
    a launch once the host's enqueue runs ahead of it (median of REPS
    regions after the warm-up)."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(B2B):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / B2B)
    return statistics.median(times)


def enqueue_ms(torch, fn) -> float:
    """Host time to enqueue one launch on an idle device (median of REPS):
    above the kernel's time, it sets a launch timed alone."""
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def short_kernel_times(torch, kernel, library) -> dict:
    """A short kernel and its library call: per launch (``ms``,
    ``library_ms``, one launch an event region, comparable with earlier
    runs), back to back (B2B launches a region) and the host's enqueue."""
    return dict(ms=time_ms(torch, kernel),
                back_to_back_ms=back_to_back_ms(torch, kernel),
                enqueue_ms=enqueue_ms(torch, kernel),
                library_ms=time_ms(torch, library),
                library_back_to_back_ms=back_to_back_ms(torch, library),
                library_enqueue_ms=enqueue_ms(torch, library))


def max_rel(torch, got, want) -> float:
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def entry(name, source, replaces, parts, per_step, library_note, **extra):
    """One kernel's summary entry: the per-step sums of the CSC step's
    parts (``per_step`` names them), every part beside them."""
    sel = [parts[p] for p in per_step]
    lib = [p["library_ms"] for p in sel]
    bound_by = {p["bound_by"] for p in sel}
    check(len(bound_by) == 1, f"{name}: parts bound by {bound_by}")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=None, max_abs_err=max(p["max_abs_err"] for p in
                                       parts.values()),
        ms=sum(p["ms"] for p in sel), plain_ms=sum(p["plain_ms"] for p in sel),
        bound_ms=sum(p["bound_ms"] for p in sel), bound_by=bound_by.pop(),
        library_ms=None if None in lib else sum(lib),
        library_note=library_note, ported=True, per_step=list(per_step),
        parts=parts, **extra)


def pack_phase(torch, pool_mod, kpack, shapes, dev, rate):
    """pool_pack at the lazy and the CSC step's shapes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flat = pool_mod.GradientPool(shapes)
    padded = pool_mod.GradientPool(shapes, pad_to=CHUNK)
    check(flat.padding == 0 and padded.size == 134_545_408,
          f"pool sizes {flat.size}, {padded.size}")
    grads = [torch.randn(s, generator=gen, device=dev) for s in flat.sizes]
    params = [torch.randn(s, generator=gen, device=dev) for s in flat.sizes]
    parts = {}
    for label, pool, leaves, wire in (
            ("lazy_grads_to_bf16", flat, grads, torch.bfloat16),
            ("lazy_params_to_f32", flat, params, torch.float32),
            ("csc_grads_to_f32_padded", padded, grads, torch.float32),
            ("csc_params_to_f32_padded", padded, params, torch.float32)):
        n, covered = pool.size, pool.unpadded_size
        args = (leaves, pool.offsets, pool.sizes, n, 0, wire)
        staging = torch.full((n,), 7.0, dtype=wire, device=dev)
        got, _ = kpack.launch(*args, out=staging)
        want, _ = kpack.plain(*args)
        torch.cuda.synchronize()
        check(got.data_ptr() == staging.data_ptr(), "pack ignored staging")
        err = (got.float() - want.float()).abs().max().item()
        check(torch.equal(got, want), f"pool_pack {label}: kernel != plain "
              f"(max abs diff {err})")
        ms = time_ms(torch, lambda: kpack.launch(*args, out=staging))
        plain_ms = time_ms(torch, lambda: kpack.plain(*args))
        # The library yardstick: one torch.cat into the staging buffer,
        # with a zero tail as its last input where the pool is padded.
        tail = [torch.zeros(pool.padding, dtype=wire, device=dev)] \
            if pool.padding else []
        lib = torch.full((n,), 7.0, dtype=wire, device=dev)
        torch.cat(leaves + tail, out=lib)
        torch.cuda.synchronize()
        check(torch.equal(lib, want), f"torch.cat {label} != plain pack")
        library_ms = time_ms(torch, lambda: torch.cat(leaves + tail, out=lib))
        nbytes = covered * 4 + n * torch.empty((), dtype=wire).element_size()
        b_ms, b_by = bound_ms(nbytes, covered, rate)
        parts[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            max_abs_err=err)
        del got, want, staging, lib, tail
    # The padded table with the chunk census (the quantized-wire form).
    got, norms = kpack.launch(grads, padded.offsets, padded.sizes,
                              padded.size, CHUNK, torch.bfloat16)
    want, want_n = kpack.plain(grads, padded.offsets, padded.sizes,
                               padded.size, CHUNK, torch.bfloat16)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "pool_pack census pool: kernel != plain")
    census_rel = max_rel(torch, norms, want_n)
    check(census_rel <= 1e-6, f"pool_pack census rel err {census_rel}")
    ms_census = time_ms(torch, lambda: kpack.launch(
        grads, padded.offsets, padded.sizes, padded.size, CHUNK,
        torch.bfloat16))
    del got, want, norms, want_n, grads, params
    torch.cuda.empty_cache()
    return entry("pool_pack", "src/repro_torch/kernels/csrc/pool_pack.cu",
                 "src/repro/kernels/pool_pack.py:134", parts,
                 ("csc_grads_to_f32_padded", "csc_params_to_f32_padded"),
                 PACK_LIBRARY_NOTE, census_ms=ms_census,
                 census_max_rel_err=census_rel)


def update_phase(torch, pool_mod, csc, kunpack, shapes, dev, rate):
    """pool_unpack_update over lazy's 6 spans and CSC's 7 (with ratios on
    one lazy span), and over the whole padded CSC pool in one launch with
    per-tensor ratios (LARS monolithic)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    lr = torch.tensor(0.2, dtype=torch.float32, device=dev)
    kw = dict(lr=lr, momentum=0.9, weight_decay=1e-4)
    parts = {}
    for label, pool in (("lazy_6_spans", pool_mod.GradientPool(shapes)),
                        ("csc_7_spans",
                         pool_mod.GradientPool(shapes, pad_to=CHUNK))):
        n = pool.size
        views = [pool.bucket_view(s, e)
                 for s, e in pool.bucket_boundaries(BUCKET_ELEMS)]
        master = torch.randn(n, generator=gen, device=dev)
        grads = torch.randn(n, generator=gen, device=dev) * 1e-2
        mom = torch.randn(n, generator=gen, device=dev) * 1e-2
        if label.startswith("lazy"):
            check(len(views) == 6, f"{len(views)} lazy spans, expected 6")
            masks = {"all-true mask": torch.ones(n, dtype=torch.bool,
                                                 device=dev),
                     "random mask": torch.rand(n, generator=gen,
                                               device=dev) < 0.7}
        else:
            check(len(views) == 7 and views[-1].num_tensors == 0,
                  f"CSC spans {[(v.start, v.num_tensors) for v in views]}")
            norms = torch.rand(n // CHUNK, generator=gen, device=dev)
            _, chunk_mask = csc.select_chunks(norms, CSC_KS[0])
            masks = {"chunk mask": csc.element_mask(chunk_mask, CHUNK)}
        timed_mask = next(iter(masks.values()))

        def outputs():
            return ([torch.empty(s, device=dev) for s in pool.sizes],
                    torch.empty(n, device=dev))

        k_out, p_out = outputs(), outputs()

        def step(fn, out, mask):
            leaves, mom_out = out
            for v in views:
                s, e = v.start, v.end
                fn(master[s:e], grads[s:e], mom[s:e], mask[s:e], v.offsets,
                   v.sizes, out_leaves=leaves[v.leaf_lo:v.leaf_hi],
                   out_momentum=mom_out[s:e], **kw)

        err = 0.0
        for mlabel, mask in masks.items():
            step(kunpack.launch, k_out, mask)
            step(kunpack.plain, p_out, mask)
            torch.cuda.synchronize()
            for a, b in zip(k_out[0] + [k_out[1]], p_out[0] + [p_out[1]]):
                d = (a - b).abs().max().item()
                err = max(err, d)
                check(torch.equal(a, b), f"pool_unpack_update ({label}, "
                      f"{mlabel}): kernel != plain (max abs diff {d})")
        if label.startswith("lazy"):
            # Per-tensor ratios on one span (LARS staged, lazy).
            v = views[0]
            r = torch.rand(v.num_tensors, generator=gen, device=dev)
            args = (master[:v.size], grads[:v.size], mom[:v.size],
                    masks["random mask"][:v.size], v.offsets, v.sizes)
            a = kunpack.launch(*args, ratios=r, **kw)
            b = kunpack.plain(*args, ratios=r, **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y)
                      for x, y in zip(a[0] + [a[1]], b[0] + [b[1]])),
                  "pool_unpack_update with ratios: kernel != plain")
        else:
            # LARS monolithic: the whole padded pool in one launch, with
            # f32[T+1] ratios (the trailing entry is the padding's).
            r = torch.rand(pool.num_tensors + 1, generator=gen, device=dev)
            mask = masks["chunk mask"]

            def whole(fn, out):
                fn(master, grads, mom, mask, pool.offsets, pool.sizes,
                   ratios=r, out_leaves=out[0], out_momentum=out[1], **kw)

            whole(kunpack.launch, k_out)
            whole(kunpack.plain, p_out)
            torch.cuda.synchronize()
            w_err = max((a - b).abs().max().item()
                        for a, b in zip(k_out[0] + [k_out[1]],
                                        p_out[0] + [p_out[1]]))
            check(all(torch.equal(a, b) for a, b in
                      zip(k_out[0] + [k_out[1]], p_out[0] + [p_out[1]])),
                  f"pool_unpack_update, whole CSC pool with ratios: kernel "
                  f"!= plain (max abs diff {w_err})")
            nbytes = n * 17 + pool.unpadded_size * 4 + r.numel() * 4
            b_ms, b_by = bound_ms(nbytes, n * 7, rate)
            parts["csc_whole_pool_ratios"] = dict(
                ms=time_ms(torch, lambda: whole(kunpack.launch, k_out)),
                plain_ms=time_ms(torch, lambda: whole(kunpack.plain, p_out)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                max_abs_err=w_err, launches_per_step=1)
            parts.update(ok_predicate_parts(torch, kunpack, pool, master,
                                            grads, mom, mask, r, k_out, kw,
                                            (b_ms, b_by, nbytes), rate, dev))
        ms = time_ms(torch, lambda: step(kunpack.launch, k_out, timed_mask))
        plain_ms = time_ms(torch, lambda: step(kunpack.plain, p_out,
                                               timed_mask))
        # Reads master, grads, momentum (4 B) and the mask (1 B); writes
        # the momentum and, where a leaf owns the element, the leaf.
        nbytes = n * 17 + pool.unpadded_size * 4
        b_ms, b_by = bound_ms(nbytes, n * 7, rate)
        parts[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            max_abs_err=err, launches_per_step=len(views))
        del master, grads, mom, masks, timed_mask, k_out, p_out
        torch.cuda.empty_cache()
    return entry("pool_unpack_update",
                 "src/repro_torch/kernels/csrc/pool_unpack.cu",
                 "src/repro/kernels/pool_unpack.py:132", parts,
                 ("csc_7_spans",), UPDATE_LIBRARY_NOTE)


def ok_predicate_parts(torch, kunpack, pool, master, grads, mom, mask, r,
                       want, kw, bound, rate, dev):
    """The guard's ``ok`` on the whole-pool launch with ratios, writing
    into live leaves and the momentum in place: ok = true gives ``want``
    (the launch without ok) bit for bit; ok = false, fed NaN gradients,
    writes nothing. Both timed beside the plain version."""
    ok_t = torch.ones(1, dtype=torch.bool, device=dev)
    ok_f = torch.zeros(1, dtype=torch.bool, device=dev)
    live = ([torch.full((s,), 7.0, device=dev) for s in pool.sizes],
            mom.clone())

    def guarded(fn, ok, g):
        fn(master, g, live[1], mask, pool.offsets, pool.sizes, ratios=r,
           out_leaves=live[0], out_momentum=live[1], ok=ok, **kw)

    guarded(kunpack.launch, ok_t, grads)
    torch.cuda.synchronize()
    check(all(bits_equal(torch, a, b) for a, b in
              zip(live[0] + [live[1]], want[0] + [want[1]])),
          "pool_unpack_update with ok = true != the launch without ok")
    nan = torch.full_like(grads, float("nan"))
    before = [x.clone() for x in live[0] + [live[1]]]
    guarded(kunpack.launch, ok_f, nan)
    torch.cuda.synchronize()
    check(all(bits_equal(torch, a, b) for a, b in
              zip(live[0] + [live[1]], before)),
          "pool_unpack_update with ok = false wrote its outputs")
    del before
    b_ms, b_by, nbytes = bound
    # The same in-place launch without and with ok = true, timed in turns
    # (without, with, with, without): the predicate's cost, if any.
    pair = {None: [], True: []}
    for flag in (None, True, True, None):
        pair[flag].append(time_ms(torch, lambda: guarded(
            kunpack.launch, ok_t if flag else None, grads)))
    out = {"csc_whole_pool_ratios_ok_true": dict(
        ms=statistics.mean(pair[True]),
        ms_without_ok_same_calls=statistics.mean(pair[None]),
        ms_turns=[pair[None][0], pair[True][0], pair[True][1],
                  pair[None][1]],
        plain_ms=time_ms(torch, lambda: guarded(kunpack.plain, ok_t, grads)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        max_abs_err=0.0)}
    # ok = false reads one byte a CTA and writes nothing: its device time
    # hides under the host's enqueue, so back to back and the enqueue too.
    f_ms, f_by = bound_ms(1, 0, rate)

    def skip():
        guarded(kunpack.launch, ok_f, nan)

    out["csc_whole_pool_ratios_ok_false"] = dict(
        ms=time_ms(torch, skip), back_to_back_ms=back_to_back_ms(torch, skip),
        enqueue_ms=enqueue_ms(torch, skip),
        plain_ms=time_ms(torch, lambda: guarded(kunpack.plain, ok_f, nan)),
        library_ms=None, bound_ms=f_ms, bound_by=f_by, bytes=1,
        max_abs_err=0.0)
    del live, nan
    return out


def census_phase(torch, kcl, num_chunks, dev, rate, grids=True):
    """chunk_l1norm on the CSC pool, f32 (the path's form) and bf16; with
    ``grids``, the f32 census also at a grid of 77 CTAs (the same bits)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    n = num_chunks * CHUNK
    pool = torch.randn(n, generator=gen, device=dev)
    parts = {}
    for label, x in (("f32", pool), ("bf16", pool.to(torch.bfloat16))):
        got = kcl.launch(x, CHUNK)
        again = kcl.launch(x, CHUNK)
        want = kcl.plain(x, CHUNK)
        lib = torch.linalg.vector_norm(x.view(num_chunks, CHUNK).float()
                                       if label == "bf16" else
                                       x.view(num_chunks, CHUNK), ord=1,
                                       dim=1)
        torch.cuda.synchronize()
        # The same |x| summed in another order: f32 rounding only, 1e-6
        # against the plain sum. vector_norm's order is its own (on the
        # CPU it differs from the plain sum by 1.4e-6): 1e-5 there.
        rel, rel_lib = max_rel(torch, got, want), max_rel(torch, got, lib)
        check(rel <= 1e-6, f"chunk_l1norm {label}: rel err {rel} vs plain")
        check(rel_lib <= 1e-5, f"chunk_l1norm {label}: rel err {rel_lib} "
              f"vs torch.linalg.vector_norm")
        check(torch.equal(got, again),
              f"chunk_l1norm {label}: two launches differ")
        part = dict(max_abs_err=(got - want).abs().max().item(),
                    max_rel_err=rel, max_rel_err_library=rel_lib)
        if grids and label == "f32":
            other = kcl.launch(x, CHUNK, grid=77)
            torch.cuda.synchronize()
            check(torch.equal(got, other),
                  f"chunk_l1norm {label}: the norms differ at 77 CTAs")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            part["plan"] = kcl.plan(num_chunks, CHUNK, 4, 16, sms)
            del other
        if label == "f32":
            part.update(short_kernel_times(
                torch, lambda: kcl.launch(x, CHUNK),
                lambda: torch.linalg.vector_norm(x.view(num_chunks, CHUNK),
                                                 ord=1, dim=1)))
            part["plain_ms"] = time_ms(torch, lambda: kcl.plain(x, CHUNK))
            nbytes = n * 4 + num_chunks * 4
            part["bound_ms"], part["bound_by"] = bound_ms(nbytes, 2 * n,
                                                          rate)
            part["bytes"] = nbytes
        parts[label] = part
        del got, again, want, lib
    del pool
    torch.cuda.empty_cache()
    return entry("chunk_l1norm",
                 "src/repro_torch/kernels/csrc/chunk_l1norm.cu",
                 "src/repro/kernels/chunk_l1norm.py:50", parts, ("f32",),
                 CENSUS_LIBRARY_NOTE)


def compact_phase(torch, kcc, num_chunks, dev, rate, grids=True):
    """csc_compact on the CSC pool at the steady and the first sparse k;
    with ``grids``, also at a grid of 77 CTAs (the same bytes)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    pool = torch.randn(num_chunks * CHUNK, generator=gen, device=dev)
    parts = {}
    for k in CSC_KS:
        idx = torch.sort(torch.randperm(num_chunks, generator=gen,
                                        device=dev)[:k]).values
        got = kcc.launch(pool, idx, CHUNK)
        want = kcc.plain(pool, idx, CHUNK)
        lib = torch.index_select(pool.view(num_chunks, CHUNK), 0, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"csc_compact k={k}: kernel != plain")
        check(torch.equal(got, lib.reshape(-1)),
              f"csc_compact k={k}: kernel != torch.index_select")
        part = dict(max_abs_err=(got - want).abs().max().item())
        if grids:
            other = kcc.launch(pool, idx, CHUNK, grid=77)
            torch.cuda.synchronize()
            check(torch.equal(got, other),
                  f"csc_compact k={k}: kernel at 77 CTAs != plain")
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            part["plan"] = kcc.plan(k, num_chunks, CHUNK * 4, 4, 16, sms)
            del other
        nbytes = 2 * k * CHUNK * 4 + k * 8
        b_ms, b_by = bound_ms(nbytes, 0, rate)
        part.update(short_kernel_times(
            torch, lambda: kcc.launch(pool, idx, CHUNK),
            lambda: torch.index_select(pool.view(num_chunks, CHUNK), 0, idx)))
        part.update(plain_ms=time_ms(torch, lambda: kcc.plain(pool, idx,
                                                              CHUNK)),
                    bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        parts[f"k={k}"] = part
        del got, want, lib
    del pool
    torch.cuda.empty_cache()
    return entry("csc_compact", "src/repro_torch/kernels/csrc/csc_compact.cu",
                 "src/repro/kernels/csc_compact.py:39", parts,
                 (f"k={CSC_KS[0]}",), COMPACT_LIBRARY_NOTE)


RING_NS = (2, 4, 8)
RING_LIBRARY_NOTE = ("torch.stack(xs).float().sum(0): the same sum in one "
                     "call, without the ring's wire rounding (so not the "
                     "same bits); timed only, the port never calls it")
FUSED_LIBRARY_NOTE = ("no single PyTorch call computes this function (e.g. "
                      "torch._fused_sgd_ applies lr after the momentum, not "
                      "inside it)")


def bits_equal(torch, a, b) -> bool:
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def abs_err(a, b) -> float:
    """Largest |a - b| over elements where both are numbers."""
    return (a.float() - b.float()).abs().nan_to_num(0.0).max().item()


def ring_inputs(torch, n, size, dtype, gen, dev):
    """N ranks' inputs: f32/bf16 normal; int8 words within 127 // N (on
    the grid); fp8 words anywhere in ±448, so the sums overflow the
    format and its overflow rule is exercised."""
    if dtype == torch.int8:
        q = 127 // n
        return [torch.randint(-q, q + 1, (size,), generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(n)]
    if dtype == torch.float8_e4m3fn:
        return [((torch.rand(size, generator=gen, device=dev) - 0.5) * 896
                 ).to(dtype) for _ in range(n)]
    return [torch.randn(size, generator=gen, device=dev).to(dtype)
            for _ in range(n)]


def ring_phase(torch, kring, pool_mod, shapes, dev, rate):
    """ring_allreduce with N = 2, 4, 8 ranks in this process, each rank on
    its own stream (the in-process workspace): smollm-135m's 6 lazy
    buckets, the whole lazy pool and the CSC steady wire buffer in bf16,
    and the first bucket in f32, int8 and fp8-e4m3; bit for bit against
    the plain ring with the kernel's segment, every rank the same bits."""
    pool = pool_mod.GradientPool(shapes)
    buckets = pool.bucket_boundaries(BUCKET_ELEMS)
    check(len(buckets) == 6, f"{len(buckets)} lazy buckets, expected 6")
    first = buckets[0][1] - buckets[0][0]
    cases = ([(f"lazy_bucket_{i}", e - s, torch.bfloat16)
              for i, (s, e) in enumerate(buckets)]
             + [("lazy_pool", pool.size, torch.bfloat16),
                (f"csc_wire_k{CSC_KS[0]}", CSC_KS[0] * CHUNK, torch.bfloat16),
                ("lazy_bucket_0_f32", first, torch.float32),
                ("lazy_bucket_0_int8", first, torch.int8),
                ("lazy_bucket_0_fp8", first, torch.float8_e4m3fn)])
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    parts = {}
    for n in RING_NS:
        ws = kring.RingWorkspace.in_process(n, dev)
        streams = [torch.cuda.Stream(dev) for _ in range(n)]
        for label, size, dt in cases:
            xs = ring_inputs(torch, n, size, dt, gen, dev)
            p = kring.plan(size, n, dt, sms=sms)
            got = kring.launch_ranks(xs, ws, streams=streams)
            want = kring.plain(xs, None, p["seg_elems"])
            torch.cuda.synchronize()
            for r in range(n):
                check(bits_equal(torch, got[r], want[r]),
                      f"ring_allreduce N={n} {label} rank {r}: kernel != "
                      f"plain (max abs diff {abs_err(got[r], want[r])})")
                check(bits_equal(torch, got[r], got[0]),
                      f"ring_allreduce N={n} {label}: ranks differ")
            err = max(abs_err(g, w) for g, w in zip(got, want))
            if label == "lazy_bucket_0":
                # In place (out = x), as the trainer calls it.
                same = [x.clone() for x in xs]
                kring.launch_ranks(same, ws, outs=same, streams=streams)
                torch.cuda.synchronize()
                check(all(bits_equal(torch, a, w) for a, w in zip(same, want)),
                      f"ring_allreduce N={n} {label} in place: kernel != "
                      f"plain")
                del same
            del want
            ms = time_ms(torch, lambda: kring.launch_ranks(
                xs, ws, outs=got, streams=streams))
            # Host time to enqueue the N launches (streams, events, ctypes).
            enqueue = enqueue_ms(torch, lambda: kring.launch_ranks(
                xs, ws, outs=got, streams=streams))
            plain_ms = time_ms(torch, lambda: kring.plain(
                xs, None, p["seg_elems"]))
            library_ms = time_ms(torch, lambda: torch.stack(xs).float()
                                 .sum(0))
            # All N ranks share one device memory: count every rank.
            nbytes = n * kring.bound_bytes(size, n, dt, dt)
            b_ms, b_by = bound_ms(nbytes, n * (n - 1) * -(-size // n), rate)
            parts[f"N={n} {label}"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, max_abs_err=err,
                enqueue_ms=enqueue,
                elems=size, ranks=n, lanes=p["lanes"],
                seg_elems=p["seg_elems"], rounds=p["rounds"],
                dtype=str(dt).split(".")[-1])
            del xs, got
            torch.cuda.empty_cache()
        if n == 2:
            # The 6 lazy buckets launched back to back, as a training step
            # launches them: the host's enqueue of a bucket overlaps the
            # ring before it.
            bufs = [ring_inputs(torch, n, e - s, torch.bfloat16, gen, dev)
                    for s, e in buckets]
            outs = [[torch.empty_like(x) for x in b] for b in bufs]

            def six():
                for b, o in zip(bufs, outs):
                    kring.launch_ranks(b, ws, outs=o, streams=streams)
            back_to_back_ms = time_ms(torch, six)
            del bufs, outs
        del ws
        torch.cuda.empty_cache()
    return entry("ring_allreduce",
                 "src/repro_torch/kernels/csrc/ring_reduce.cu",
                 "src/repro/kernels/ring_reduce.py:302", parts,
                 tuple(f"N=2 lazy_bucket_{i}" for i in range(6)),
                 RING_LIBRARY_NOTE, fp8_saturates=kring.fp8_saturates(),
                 lazy_buckets_back_to_back_ms=back_to_back_ms,
                 note=("ms is the N ranks' launches together on one card: "
                       "the ring runs through this card's memory, not "
                       "over NVLink"))


def nan_word(torch, x) -> str:
    """The bits of the first NaN word of ``x`` in hex, or None."""
    at = torch.isnan(x.float()).nonzero()
    if at.numel() == 0:
        return None
    bits = {2: torch.int16, 4: torch.int32}[x.element_size()]
    word = int(x.view(bits)[at[0, 0]].item()) & (2 ** (8 * x.element_size())
                                                  - 1)
    return f"0x{word:0{2 * x.element_size()}X}"


def same_class(torch, got, want) -> bool:
    """NaN where ``want`` has NaN (any NaN word), the same bits
    elsewhere."""
    nan = torch.isnan(want.float())
    bits = {2: torch.int16, 4: torch.int32}[got.element_size()]
    return (torch.equal(torch.isnan(got.float()), nan)
            and torch.equal(got.view(bits)[~nan], want.view(bits)[~nan]))


def nonfinite_phase(torch, kpack, kcl, kring, pool_mod, shapes, dev):
    """The words the guard feeds the kernels: NaN, +-Inf and 2^120 in
    smollm-135m's gradient leaves through the lazy pack (f32 -> bf16) and
    the CSC pack (f32 -> f32, padded), the census of the CSC pool, and
    the ring at N = 2 on the first lazy bucket with a NaN and 2^120 on
    rank 0 and an Inf on rank 1; each against its plain version, NaN by
    class. Records the NaN word each one emits."""
    gen = torch.Generator(device=dev).manual_seed(7)
    flat = pool_mod.GradientPool(shapes)
    padded = pool_mod.GradientPool(shapes, pad_to=CHUNK)
    grads = [torch.randn(sz, generator=gen, device=dev) * 1e-3
             for sz in flat.sizes]
    specials = ((0, 5, float("nan")), (1, 7, float("inf")),
                (3, 11, -float("inf")), (5, 13, 2.0 ** 120),
                (10, 17, float("nan")))
    for leaf, at, v in specials:
        grads[leaf][at] = v
    words = {}
    for label, pool, wire in (("lazy_bf16", flat, torch.bfloat16),
                              ("csc_f32", padded, torch.float32)):
        args = (grads, pool.offsets, pool.sizes, pool.size, 0, wire)
        got, _ = kpack.launch(*args)
        want, _ = kpack.plain(*args)
        torch.cuda.synchronize()
        check(same_class(torch, got, want),
              f"pool_pack {label} with NaN/Inf/2^120: kernel != plain")
        words[f"pool_pack {label}"] = nan_word(torch, got)
        words[f"plain pack {label}"] = nan_word(torch, want)
        if label == "csc_f32":
            norms, want_n = kcl.launch(got, CHUNK), kcl.plain(got, CHUNK)
            torch.cuda.synchronize()
            fin = torch.isfinite(want_n)
            bad = {(pool.offsets[leaf] + at) // CHUNK
                   for leaf, at, v in specials if not math.isfinite(v)}
            check(torch.equal(torch.isnan(norms), torch.isnan(want_n))
                  and torch.equal(torch.isinf(norms), torch.isinf(want_n))
                  and int((~fin).sum()) == len(bad),
                  "chunk_l1norm with NaN/Inf: classes differ from plain")
            rel = max_rel(torch, norms[fin], want_n[fin])
            check(rel <= 1e-6, f"chunk_l1norm with 2^120: rel err {rel}")
            words["chunk_l1norm"] = nan_word(torch, norms)
            words["plain census"] = nan_word(torch, want_n)
        del got, want
    del grads
    bucket = flat.bucket_boundaries(BUCKET_ELEMS)[0]
    size = bucket[1] - bucket[0]
    xs = ring_inputs(torch, 2, size, torch.bfloat16, gen, dev)
    xs[0][123] = float("nan")
    xs[0][size // 2] = 2.0 ** 120
    xs[1][size - 5] = float("inf")
    ws = kring.RingWorkspace.in_process(2, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = kring.plan(size, 2, torch.bfloat16, sms=sms)
    got = kring.launch_ranks(xs, ws)
    want = kring.plain(xs, None, p["seg_elems"])
    torch.cuda.synchronize()
    for r in range(2):
        check(same_class(torch, got[r], want[r])
              and bits_equal(torch, got[r], got[0])
              and bool(torch.isnan(got[r][123].float()))
              and bool(torch.isinf(got[r][size - 5].float())),
              f"ring_allreduce N=2 with NaN/Inf on rank {r}: != plain by "
              f"class")
    words["ring_allreduce bf16"] = nan_word(torch, got[0])
    words["plain ring bf16"] = nan_word(torch, want[0])
    del xs, got, want, ws
    torch.cuda.empty_cache()
    return words


def fused_update_phase(torch, kfu, optim, ops, base, dev, rate):
    """fused_update on the whole 134,515,008-element f32 pool, all-true
    and random mask, each with and without the scale, bit for bit against
    the plain version; then ``optim.update_pool`` (the entry point that
    reaches it) driven for 3 steps with the counts set to 0 just before."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 134_515_008
    master = torch.randn(n, generator=gen, device=dev)
    grads = torch.randn(n, generator=gen, device=dev) * 1e-2
    mom = torch.randn(n, generator=gen, device=dev) * 1e-2
    scale = torch.rand(n, generator=gen, device=dev) + 0.5
    masks = {"all-true mask": torch.ones(n, dtype=torch.bool, device=dev),
             "random mask": torch.rand(n, generator=gen, device=dev) < 0.7}
    kw = dict(lr=torch.tensor(0.05, device=dev), momentum=0.9,
              weight_decay=1e-4)
    parts = {}
    for mlabel, mask in masks.items():
        for slabel, s in (("no scale", None), ("scale", scale)):
            args = (master, grads, mom, mask)
            got = kfu.launch(*args, scale=s, **kw)
            want = kfu.plain(*args, scale=s, **kw)
            torch.cuda.synchronize()
            err = max(abs_err(a, b) for a, b in zip(got, want))
            check(all(bits_equal(torch, a, b) for a, b in zip(got, want)),
                  f"fused_update ({mlabel}, {slabel}): kernel != plain "
                  f"(max abs diff {err})")
            del got, want
            nbytes = n * (25 if s is not None else 21)
            b_ms, b_by = bound_ms(nbytes, n * 7, rate)
            parts[f"{mlabel}, {slabel}"] = dict(
                ms=time_ms(torch, lambda: kfu.launch(*args, scale=s, **kw)),
                plain_ms=time_ms(torch, lambda: kfu.plain(*args, scale=s,
                                                          **kw)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                max_abs_err=err)
            torch.cuda.empty_cache()
    cfg = base.OptimizerConfig(learning_rate=0.05, momentum=0.9,
                               weight_decay=1e-4)
    state = optim.SGDState(momentum=mom)
    w = master
    ops.reset_counts()
    for _ in range(3):
        w, state = optim.update_pool("momentum_sgd", w, grads, state,
                                     masks["random mask"], cfg, kw["lr"],
                                     use_kernels=True)
    torch.cuda.synchronize()
    counts = dict(ops.dispatch_counts)
    check(counts == {"fused_update.kernel": 3},
          f"optim.update_pool: dispatch counts {counts}")
    check(bool(torch.isfinite(w).all()), "optim.update_pool: non-finite")
    del master, grads, mom, scale, masks, w, state
    torch.cuda.empty_cache()
    return entry("fused_update",
                 "src/repro_torch/kernels/csrc/fused_update.cu",
                 "src/repro/kernels/fused_update.py:73", parts,
                 ("all-true mask, no scale",), FUSED_LIBRARY_NOTE,
                 launches_update_pool=counts["fused_update.kernel"])


def optimizer_phase(torch, pool_mod, csc, optim, lars_mod, base, shapes,
                    dev, rate):
    """LARS's trust ratios and AdamW's update are PyTorch ops in the port,
    as they are jnp in the JAX package: no kernel, so no kernel entry.
    Timed here beside their bytes bounds: one step's LARS ratios over the
    lazy spans (no mask) and over CSC's spans (the chunk mask zeroes the
    unselected gradients), each equal to the whole-pool ratios; one AdamW
    update sweep over CSC's 7 spans (``optim.update_view``, as the staged
    engine runs it)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    lars_cfg = base.OptimizerConfig(name="lars", learning_rate=LARS_LR)
    out = {}
    for label, pool in (("lazy_6_spans", pool_mod.GradientPool(shapes)),
                        ("csc_7_spans",
                         pool_mod.GradientPool(shapes, pad_to=CHUNK))):
        n = pool.size
        views = [pool.bucket_view(s, e)
                 for s, e in pool.bucket_boundaries(BUCKET_ELEMS)]
        master = torch.randn(n, generator=gen, device=dev)
        grads = torch.randn(n, generator=gen, device=dev) * 1e-2
        mask = None
        if label.startswith("csc"):
            norms = torch.rand(n // CHUNK, generator=gen, device=dev)
            mask = csc.element_mask(csc.select_chunks(norms, CSC_KS[0])[1],
                                    CHUNK)
        lars = lars_mod.LARSScaler(pool)

        def ratios():
            return [lars.ratios_view(
                v, master[v.start:v.end], grads[v.start:v.end], lars_cfg,
                None if mask is None else mask[v.start:v.end])
                for v in views]

        spans = torch.cat(ratios())
        whole = lars.ratios(master, grads, lars_cfg, mask)
        torch.cuda.synchronize()
        check(spans.shape == (pool.num_tensors,)
              and bool(torch.isfinite(spans).all()),
              f"LARS ratios {label}: {spans}")
        rel = max_rel(torch, spans, whole[:pool.num_tensors])
        check(rel <= 1e-6, f"LARS ratios {label}: per span != whole pool "
              f"(rel err {rel})")
        nbytes = n * 8 + (n if mask is not None else 0)
        b_ms, b_by = bound_ms(nbytes, 4 * n, rate)
        out[f"lars_ratios_{label}"] = dict(
            ms=time_ms(torch, ratios), bound_ms=b_ms, bound_by=b_by,
            bytes=nbytes, ratios=spans.tolist())
        if label.startswith("csc"):
            adamw_cfg = base.OptimizerConfig(name="adamw",
                                              learning_rate=ADAMW_LR)
            state = optim.init_state("adamw", n, dev)
            leaves = [torch.empty(sz, device=dev) for sz in pool.sizes]
            lr = torch.tensor(ADAMW_LR, device=dev)

            def sweep():
                for v in views:
                    s, e = v.start, v.end
                    optim.update_view(
                        "adamw", v, master[s:e], grads[s:e],
                        optim.AdamWState(*(x[s:e] for x in state)),
                        mask[s:e], adamw_cfg, lr,
                        out_leaves=leaves[v.leaf_lo:v.leaf_hi])

            sweep()
            torch.cuda.synchronize()
            check(torch.equal(state.counts, mask.to(torch.int32))
                  and all(bool(torch.isfinite(x).all()) for x in leaves),
                  "AdamW sweep: counts or leaves wrong after one sweep")
            # Reads master, grads, mu, nu, counts (4 B) and the mask (1 B);
            # writes mu, nu, counts and, where a leaf owns the element, the
            # leaf.
            nbytes = n * 33 + pool.unpadded_size * 4
            b_ms, b_by = bound_ms(nbytes, 20 * n, rate)
            out["adamw_update_csc_7_spans"] = dict(
                ms=time_ms(torch, sweep), bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes)
            del state, leaves
        del master, grads, mask
        torch.cuda.empty_cache()
    return out


ATTN_KEY = "flash_attention.kernel"


def attention_layers(m) -> int:
    """A model's attention layers: none in ssm, the shared block once a
    group in hybrid, every layer otherwise."""
    return {"ssm": 0, "hybrid": m.num_layers // m.hybrid_attn_every
            }.get(m.family, m.num_layers)


def attention_counts(cfg, steps: int) -> dict:
    """The flash-attention forward launches ``steps`` steps of a
    TrainConfig take on the card (``ATTN_KEY``; none without attention):
    a microbatch, each attention layer's forward and, under layer remat,
    its recompute."""
    n = attention_layers(cfg.model) \
        * (2 if cfg.remat == "layer" else 1) * cfg.microbatches * steps
    return {ATTN_KEY: n} if n else {}


def expected_counts(trainer, steps, first=0):
    """The kernel launches ``steps`` steps of this trainer's paths from
    step ``first`` on need, from its step plans: 2 packs a step; the SGD
    and LARS updates one a span (staged) or one a step (monolithic),
    AdamW's none; CSC's census one a step and its gather one a sparse
    step; the model's attention (``attention_counts``)."""
    gf = trainer.gf
    plans = [gf.plan(gf.stage_for_step(s))
             for s in range(first, first + steps)]
    want = {"pool_pack.kernel": 2 * steps}
    if trainer.opt_name != "adamw":  # AdamW has no update kernel
        want["pool_unpack_update.kernel"] = steps \
            if gf.cfg.overlap == "monolithic" \
            else sum(len(p.update_spans) for p in plans)
    if gf.cfg.csc_enabled:
        sparse = sum(not p.warmup for p in plans)
        # A low-bit sparse step also takes the wire buffer's send census.
        want["chunk_l1norm.kernel"] = steps + (
            sparse if gf.wire_spec is not None else 0)
        want["csc_compact.kernel"] = sparse
    want.update(attention_counts(trainer.cfg, steps))
    return want


def launched(counts) -> set:
    """The kernels ``counts`` launched at least once."""
    return {k for k, v in counts.items() if v}


def expected_collectives(trainer, steps):
    """The all-reduces ``steps`` steps issue, from the step plans
    (``GradientFlow.num_collectives``: the buckets, CSC's norm census,
    the low-bit dense and lazy census sum); in a world-size-1 group every
    one is a ``dist.all_reduce`` and the metrics take none."""
    gf = trainer.gf
    return sum(gf.num_collectives(gf.stage_for_step(s))
               for s in range(steps))


class CountAllReduce:
    """Counts ``torch.distributed.all_reduce`` calls while entered."""

    def __init__(self, dist):
        self.dist, self.calls = dist, 0

    def __enter__(self):
        self.original = self.dist.all_reduce

        def counted(*args, **kwargs):
            self.calls += 1
            return self.original(*args, **kwargs)

        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.original


def count_ratio_launches(kunpack):
    """Wrap ``kunpack.launch`` (which ``ops.pool_unpack_update`` calls) to
    tally its launches with and without ``ratios``. Returns (tally,
    restore)."""
    launch = kunpack.launch
    tally = {"with_ratios": 0, "without_ratios": 0}

    def counted(*args, ratios=None, **kwargs):
        tally["with_ratios" if ratios is not None else "without_ratios"] += 1
        return launch(*args, ratios=ratios, **kwargs)

    def restore():
        kunpack.launch = launch

    kunpack.launch = counted
    return tally, restore


def stream_steps(torch, trainer, cfg, seed, steps, batch_fn=None):
    """``steps`` steps on the synthetic stream (or on ``batch_fn(cfg,
    step)``'s batches), as the CLI's loop runs them
    (``repro_torch.launch.train.train``), for a Trainer the CLI cannot
    build (``overlap='monolithic'`` has no flag) or a batch its stream
    cannot give (a vlm's). Returns (losses, step seconds)."""
    from repro_torch.data.synthetic import SyntheticLM
    data = SyntheticLM(cfg.model.vocab_size, seed=seed,
                       num_codebooks=cfg.model.num_codebooks)
    state = trainer.init_state(seed)
    fns, losses, seconds = {}, [], []
    for s in range(steps):
        stage = trainer.gf.stage_for_step(s)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage)
        batch = batch_fn(cfg, s) if batch_fn is not None \
            else data.batch(s, cfg.global_batch, cfg.seq_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = fns[stage.index](state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return losses, seconds


def train_run(torch, ops, train_mod, synthetic, label, argv, steps,
              overlap="staged", keep_params=False, watch=None,
              microbatches=1, batch_fn=None, repeat=None):
    """(a) ``steps`` steps on the synthetic stream, timed: the CLI's loop,
    or with ``overlap='monolithic'`` or ``microbatches`` > 1 (no CLI flag
    sets either) the same loop on a Trainer built with them; and (b)
    ``repeat`` (default ``steps``) steps of such a Trainer on ONE batch,
    each step under the stage the CLI would pick. On a fresh batch each
    step, a few steps at the CLI's learning rate move the loss less than
    the batch-to-batch spread, so (a) cannot show learning; a repeated
    batch can. ``keep_params``: also return (b)'s final parameters as one flat
    tensor on the host. ``watch`` maps a step of (b) to ``fn(trainer,
    state)``, called just before it, which returns ``after(state)``,
    called just after it, which returns findings for the run's line.
    ``batch_fn(cfg, step)``: the batches (a vlm's, which the CLI's stream
    cannot give) for a Trainer in (a), its step 0's the one batch of
    (b)."""
    import dataclasses
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)
    repeat = steps if repeat is None else repeat

    cli = overlap == "staged" and microbatches == 1 and batch_fn is None

    def build():
        trainer, cfg = train_mod.build(args)
        if cli:
            return trainer, cfg
        cfg = cfg.replace(microbatches=microbatches,
                          gradientflow=dataclasses.replace(
                              cfg.gradientflow, overlap=overlap))
        return Trainer(cfg, device=args.device), cfg

    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    if cli:
        trainer, losses, seconds, run = train_mod.train(args)
        clear_checkpoints()
        check(run["restarts"] == 0 and run["preempted"] is None,
              f"{label}: the CLI's supervisor {run}")
    else:
        trainer, cfg = build()
        losses, seconds = stream_steps(torch, trainer, cfg, args.seed, steps,
                                       batch_fn)
    counts = dict(ops.dispatch_counts)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"{label}: non-finite loss {losses}")
    want = expected_counts(trainer, steps)
    check(counts == want, f"{label}: dispatch counts {counts}, expected "
          f"{want}")
    stages = [trainer.gf.stage_for_step(s) for s in range(steps)]
    del trainer
    torch.cuda.empty_cache()

    trainer, cfg = build()
    state = trainer.init_state(args.seed)
    batch = batch_fn(cfg, 0) if batch_fn is not None else \
        synthetic.SyntheticLM(cfg.model.vocab_size, seed=args.seed,
                              num_codebooks=cfg.model.num_codebooks) \
        .batch(0, cfg.global_batch, cfg.seq_len)
    fns = {}
    ops.reset_counts()
    fixed, findings = [], {}
    import torch.distributed as dist
    with CountAllReduce(dist) as collectives:
        for s in range(repeat):
            stage = trainer.gf.stage_for_step(s)
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            after = watch[s](trainer, state) if s in (watch or {}) else None
            state, metrics = fns[stage.index](state, batch)
            fixed.append(float(metrics["loss"]))
            if after is not None:
                findings.update(after(state))
    fixed_counts = dict(ops.dispatch_counts)
    want_fixed = expected_counts(trainer, repeat)
    want_collectives = expected_collectives(trainer, repeat)
    check(collectives.calls == want_collectives, f"{label}: "
          f"{collectives.calls} all-reduces, expected {want_collectives}")
    # On the host, so no later run's peak memory holds it.
    final = torch.cat([p.reshape(-1) for p in
                       trainer.pool.flat_leaves(state.params)]).cpu() \
        if keep_params else None
    check(all(bool(torch.isfinite(p).all())
              for p in trainer.pool.flat_leaves(state.params)),
          f"{label}: non-finite parameters")
    residual_abs_max = residual_numel = None
    if trainer.gf.wire_spec is not None:
        residual_numel = state.gf.residual.numel()
        if trainer.gf_cfg.feedback_enabled:
            residual_abs_max = state.gf.residual.abs().max().item()
            check(math.isfinite(residual_abs_max) and residual_abs_max > 0,
                  f"{label}: residual |max| {residual_abs_max}")
        else:  # --no-error-feedback: no residual is carried, as in JAX
            check(residual_numel == 0, f"{label}: a residual of "
                  f"{residual_numel} elements without error feedback")
    wire_bytes = [trainer.gf.wire_bytes_per_step(st) for st in stages]
    del state, fns, trainer
    torch.cuda.empty_cache()
    print(f"{label}, one batch, repeated: losses {fixed}", flush=True)
    check(fixed_counts == want_fixed, f"{label} (repeated batch): dispatch "
          f"counts {fixed_counts}, expected {want_fixed}")
    check(all(math.isfinite(x) for x in fixed),
          f"{label}: non-finite loss {fixed}")
    check(fixed[-1] < fixed[0], f"{label}: loss did not fall on one batch: "
          f"{fixed}")
    run = dict(losses=losses, repeated_batch_losses=fixed,
               step_ms=[t * 1e3 for t in seconds],
               stage=[s.index for s in stages],
               num_selected=[s.num_selected for s in stages],
               peak_mem_gib=peak / 2 ** 30, dispatch_counts=counts,
               collectives=collectives.calls, wire_bytes_per_step=wire_bytes,
               wire_format=args.wire_format,
               residual_abs_max=residual_abs_max, **findings,
               optimizer=args.optimizer, lr=args.lr, overlap=overlap)
    if microbatches != 1 or residual_numel == 0:
        run.update(microbatches=microbatches, residual_numel=residual_numel,
                   error_feedback=not args.no_error_feedback)
    return (run, final) if keep_params else run


# -- the low-bit wires -------------------------------------------------------

# Analytic wire bytes a step (GradientFlow.wire_bytes_per_step): lazy on
# int8 (the padded pool's 1-byte words and the f32 census) against bf16,
# and CSC's steady k = 616 on int8 (its norm census carries the scales).
WIRE_LAZY_BYTES = {"int8": 134_561_832, "native": 269_030_016}
WIRE_CSC_K616_BYTES = 20_201_512


def watch_error_feedback(torch, wire):
    """(l)'s error-feedback identity on one step, on the device: the packed
    pool ``g`` and the residual before the step, and the words and scales
    of its quantize, are kept; then ``dequant(q) + residual_new`` must
    equal ``g + residual_old`` to f32 rounding: |difference| <= 2^-23 (|g
    + residual_old| + |residual_new|) at every element."""

    def before(trainer, state):
        kept = {"r_old": state.gf.residual.clone()}
        pack_into, quantize = trainer.pool.pack_into, wire.quantize_pool

        def keep_pack(*args, **kwargs):
            out = pack_into(*args, **kwargs)
            kept["g"] = out[0].clone()
            return out

        def keep_quantize(g, scales, **kwargs):
            q, err = quantize(g, scales, **kwargs)
            kept["q"], kept["scales"] = q.clone(), scales.clone()
            return q, err

        trainer.pool.pack_into, wire.quantize_pool = keep_pack, keep_quantize

        def after(state):
            del trainer.pool.pack_into  # the class's method again
            wire.quantize_pool = quantize
            send = kept.pop("g").add_(kept.pop("r_old"))
            r_new = state.gf.residual
            diff = wire.dequantize_pool(kept.pop("q"), kept["scales"], CHUNK)
            diff.add_(r_new).sub_(send).abs_()
            bound = send.abs_().add_(r_new.abs()).mul_(2.0 ** -23)
            excess = diff.sub(bound).max().item()
            found = dict(ef_identity_max_abs_diff=diff.max().item(),
                         ef_identity_r_new_abs_max=r_new.abs().max().item())
            del send, diff, bound
            torch.cuda.empty_cache()
            check(excess <= 0, f"(l) error feedback: dequant(q) + r_new != "
                  f"g + r_old beyond f32 rounding ({found})")
            return found

        return after

    return before


def watch_residual_at_selection(torch, csc):
    """(m) on a steady step (k = 616): the chunks whose residual moved are
    exactly the selected ones (from the chunk norms before the step)."""

    def before(trainer, state):
        k = trainer.gf.stage_for_step(state.step).num_selected
        sel, _ = csc.select_chunks(state.gf.chunk_norms, k)
        r_old = state.gf.residual.clone()

        def after(state):
            moved = (state.gf.residual != r_old).view(-1, CHUNK).any(1)
            moved = moved.nonzero()[:, 0]
            same = torch.equal(moved, sel)
            check(k == CSC_KS[0] and same, f"(m) the residual moved at "
                  f"{moved.numel()} chunks, {k} selected, equal: {same}")
            return dict(residual_moved_chunks=moved.numel(),
                        residual_moved_only_at_selection=same)

        return after

    return before


def quantized_ring_phase(torch, kring, wire, dev, rate):
    """The ring on the words the low-bit wires give it: N = 2, 4, 8 ranks
    in this process, each quantizing its own gradients (one θ bucket of
    normal values, rank r's times r + 1) with the scales of their summed
    census (``wire.scales_from_census``, ``wire.quantize_pool``). int8:
    every rank gets the flat integer sum bit for bit (the grid is exact).
    fp8-e4m3: the dequantized sum within the JAX package's gate (448 x the
    largest scale x 2^-4) of the dequantized f32 sum of the same words,
    and no NaN code (0x7F or 0xFF) in any word, sent or summed."""
    gen = torch.Generator(device=dev).manual_seed(8)
    size = BUCKET_ELEMS
    out = {}
    for n in RING_NS:
        ws = kring.RingWorkspace.in_process(n, dev)
        streams = [torch.cuda.Stream(dev) for _ in range(n)]
        gs = [torch.randn(size, generator=gen, device=dev) * (r + 1)
              for r in range(n)]
        census = sum(wire.chunk_l1(g, CHUNK) for g in gs)
        for fmt in ("int8", "fp8_e4m3"):
            spec = wire.resolve(fmt)
            sc = wire.scales_from_census(census, chunk_elems=CHUNK,
                                         num_shards=n, spec=spec)
            qs = [wire.quantize_pool(g, sc, chunk_elems=CHUNK, spec=spec,
                                     num_shards=n)[0] for g in gs]
            exact = torch.stack([q.float() for q in qs]).sum(0)
            got = kring.launch_ranks(qs, ws, streams=streams)
            torch.cuda.synchronize()
            check(all(bits_equal(torch, g, got[0]) for g in got),
                  f"quantized ring N={n} {fmt}: ranks differ")
            nan_codes = 0
            if fmt == "int8":
                err = (got[0].float() - exact).abs().max().item()
                check(exact.abs().max().item() <= 127 and torch.equal(
                    got[0].to(torch.int32), exact.to(torch.int32)),
                    f"quantized ring N={n} int8 != the flat sum (max abs "
                    f"diff {err})")
                gate = 0.0
            else:
                nan_codes = sum(int(((x.view(torch.uint8) & 0x7F) == 0x7F)
                                    .sum()) for x in qs + got)
                err = (wire.dequantize_pool(got[0], sc, CHUNK)
                       - wire.dequantize_pool(exact, sc, CHUNK)
                       ).abs().max().item()
                gate = 448.0 * sc.max().item() * 2.0 ** -4
                check(nan_codes == 0 and err <= gate,
                      f"quantized ring N={n} fp8: {nan_codes} NaN codes, "
                      f"max abs err {err} against the gate {gate}")
            nbytes = n * kring.bound_bytes(size, n, spec.dtype, spec.dtype)
            b_ms, b_by = bound_ms(nbytes, n * (n - 1) * -(-size // n), rate)
            out[f"N={n} {fmt}"] = dict(
                ms=time_ms(torch, lambda: kring.launch_ranks(
                    qs, ws, outs=got, streams=streams)),
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err, gate=gate,
                nan_codes=nan_codes, rank_clip=wire.rank_clip(spec, n),
                elems=size)
            del qs, exact, got
        del ws, gs, census
        torch.cuda.empty_cache()
    return out


# -- the numeric guard -------------------------------------------------------

GUARD_WIDTH = 4096  # pool elements a fault covers
# (step, kind, pool offset, width). (g): three buckets apart, 8 steps.
GUARD_LAZY_FAULTS = ((2, "nan", 1_000_000, GUARD_WIDTH),
                     (4, "overflow", 60_000_000, GUARD_WIDTH),
                     (6, "bitflip", 120_000_000, GUARD_WIDTH))
GUARD_LAZY_STEPS = 8
# (h): the dense warm-up step and a steady sparse step (k = 616). CSC
# unscales before its census, so the overflow limit (2^-9 of the wire's
# max, ~2^119) meets the injected 2^120 divided by the scale (2^14 by
# step 5): 4096 such words sum to 2^118 and pass as legitimate, as in
# the JAX package. The overflow covers a whole chunk (2^121) to trip.
GUARD_CSC_FAULTS = ((0, "nan", 1_000_000, GUARD_WIDTH),
                    (5, "overflow", 1831 * CHUNK, CHUNK))
# (i): LARS lazy monolithic, as (e)'s monolithic run, 6 steps.
GUARD_MONO_FAULTS = ((2, "nan", 1_000_000, GUARD_WIDTH),
                     (4, "overflow", 60_000_000, GUARD_WIDTH))


def fault_events(faults):
    from repro_torch.runtime.faults import FaultEvent
    return [FaultEvent(step=st, kind=kind, offset=off, width=width)
            for st, kind, off, width in faults]


def probing_hook(torch, events, probe):
    """``runtime.faults.make_hook(events)``; for a bitflip event it also
    counts, on the device, the words inside the detectable envelope
    [2^-8, 2) before the flip and the words at 2^119 or more (or Inf)
    after it: that guards the check (a flip of words outside the envelope
    can shrink them), not the path."""
    from repro_torch.runtime.faults import make_hook
    hook = make_hook(events)
    flips = {ev.step: ev for ev in events if ev.kind == "bitflip"}

    def probed(gpool, step):
        ev = flips.get(step)
        if ev is None:
            return hook(gpool, step)
        seg = gpool[ev.offset:ev.offset + ev.width]
        a = seg.float().abs()
        probe["in_envelope"] = ((a >= 2.0 ** -8) & (a < 2.0)).sum()
        out = hook(gpool, step)
        a = seg.float().abs()
        probe["flipped_to_2^119_or_more"] = (a >= 2.0 ** 119).sum()
        return out

    return probed


def state_tensors(trainer, state):
    """Clones of the parameters (one flat tensor), the optimizer state and
    the GradientFlow state (CSC's hg and chunk norms, the low-bit wires'
    residual)."""
    import torch
    flat = torch.cat([p.reshape(-1) for p in
                      trainer.pool.flat_leaves(state.params)])
    return [flat] + [x.clone() for x in tuple(state.opt) + tuple(state.gf)
                     if x.numel()]


def guarded_run(torch, ops, train_mod, label, argv, steps, faults,
                overlap="staged", steady_from=1):
    """``steps`` guarded steps (``GuardConfig()``: scale 2^15) on the
    synthetic stream with ``faults`` injected by the fault hook, built as
    the CLI builds ``argv``. Exactly the faulted steps must trip; each
    trip must leave parameters, optimizer state and CSC's state
    bit-identical (clones taken before the step, compared on the device);
    the scale halves at each trip; clean losses are finite; the dispatch
    counts equal the step plans' (a tripped step still launches its
    predicated updates). ``steady_step_ms`` is the median of the clean
    steps from ``steady_from`` on."""
    import dataclasses
    from repro_torch.configs.base import GuardConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)
    _, cfg = train_mod.build(args)
    cfg = cfg.replace(gradientflow=dataclasses.replace(
        cfg.gradientflow, overlap=overlap, guard=GuardConfig()))
    trainer = Trainer(cfg, device=args.device)
    events = fault_events(faults)
    at = {ev.step for ev in events}
    probe = {}
    hook = probing_hook(torch, events, probe)
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    state = trainer.init_state(args.seed)
    fns, losses, step_ms, tripped, scales, skipped, frozen = \
        {}, [], [], [], [], [], []
    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    collectives = CountAllReduce(torch.distributed)
    for st in range(steps):
        stage = trainer.gf.stage_for_step(st)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage,
                                                        fault_hook=hook)
        batch = data.batch(st, cfg.global_batch, cfg.seq_len)
        before = state_tensors(trainer, state) if st in at else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with collectives:
            state, metrics = fns[stage.index](state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tripped.append(float(metrics["guard_tripped"]))
        scales.append(float(state.guard.scale))
        skipped.append(int(state.guard.skipped))
        if before is not None:
            # No empty_cache here: the next step would pay cudaMalloc.
            frozen.append(all(bits_equal(torch, a, b) for a, b in
                              zip(before, state_tensors(trainer, state))))
            del before
    counts = dict(ops.dispatch_counts)
    peak = torch.cuda.max_memory_allocated()
    probe = {k: int(v) for k, v in probe.items()}
    want_scales, scale = [], 2.0 ** 15
    for st in range(steps):
        scale /= 2 if st in at else 1
        want_scales.append(scale)
    print(f"{label}: tripped {tripped}, scale {scales}, losses {losses}",
          flush=True)
    check(tripped == [float(st in at) for st in range(steps)],
          f"{label}: tripped at {tripped}, faults at {sorted(at)}")
    check(len(frozen) == len(at) and all(frozen),
          f"{label}: a tripped step changed the state ({frozen})")
    check(scales == want_scales, f"{label}: scales {scales}")
    check(skipped[-1] == len(at), f"{label}: skipped {skipped}")
    check(all(math.isfinite(x) for st, x in enumerate(losses)
              if st not in at), f"{label}: non-finite clean loss {losses}")
    want = expected_counts(trainer, steps)
    check(counts == want, f"{label}: dispatch counts {counts}, expected "
          f"{want}")
    want_collectives = expected_collectives(trainer, steps)
    check(collectives.calls == want_collectives, f"{label}: "
          f"{collectives.calls} all-reduces, expected {want_collectives}")
    if any(ev.kind == "bitflip" for ev in events):
        check(probe.get("in_envelope", 0) >= 1
              and probe.get("flipped_to_2^119_or_more", 0) >= 1,
              f"{label}: bit flip probe {probe}")
    stages = [trainer.gf.stage_for_step(st) for st in range(steps)]
    del state, fns, trainer
    torch.cuda.empty_cache()
    clean = [step_ms[st] for st in range(steady_from, steps) if st not in at]
    return dict(losses=losses, step_ms=step_ms, tripped=tripped,
                scale=scales, skipped=skipped, trips_bit_identical=frozen,
                faults=[list(f) for f in faults],
                bitflip_probe=probe, stage=[x.index for x in stages],
                num_selected=[x.num_selected for x in stages],
                peak_mem_gib=peak / 2 ** 30, dispatch_counts=counts,
                collectives=collectives.calls, wire_format=args.wire_format,
                optimizer=args.optimizer, lr=args.lr, overlap=overlap,
                first_step_ms=step_ms[0],
                steady_step_ms=statistics.median(clean),
                tripped_step_ms=[step_ms[st] for st in sorted(at)],
                tokens_per_s=BATCH * SEQ / (statistics.median(clean) / 1e3))


def neutrality_run(torch, ops, train_mod, synthetic, argv, steps):
    """(j): ``steps`` lazy steps on one repeated batch from one seed,
    unguarded, under ``GuardConfig(init_scale=1.0)`` (no fault), and
    unguarded again, each step timed and each run's peak memory read.
    The guarded run must give the unguarded losses and final parameters
    bit for bit; if the two unguarded runs differ from each other, the
    guarded one must stay within their spread."""
    import dataclasses
    from repro_torch.configs.base import GuardConfig
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)
    _, cfg0 = train_mod.build(args)
    out = []
    # Unguarded, guarded, unguarded: the two guard-free runs bracket the
    # guarded one, so the step times compare in turns too.
    for guard in (None, GuardConfig(init_scale=1.0), None):
        cfg = cfg0.replace(gradientflow=dataclasses.replace(
            cfg0.gradientflow, guard=guard))
        trainer = Trainer(cfg, device=args.device)
        state = trainer.init_state(args.seed)
        batch = synthetic.SyntheticLM(cfg.model.vocab_size,
                                      seed=args.seed).batch(0, BATCH, SEQ)
        step = trainer.build_train_step()
        ops.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # The final parameters on the host, so no run's peak holds them.
        out.append((losses, state_tensors(trainer, state)[0].cpu(),
                    dict(ops.dispatch_counts),
                    [float(x) for x in state.guard] if guard else None,
                    step_ms, peak))
        del state, trainer
        torch.cuda.empty_cache()
    (la, pa, _, _, ma, peak_a), (lg, pg, counts, scaler, mg, peak_g), \
        (lb, pb, _, _, mb, peak_b) = out
    spread = (pa - pb).abs().max().item()
    diff = (pg - pa).abs().max().item()
    loss_spread = max(abs(x - y) for x, y in zip(la, lb))
    loss_diff = max(abs(x - y) for x, y in zip(lg, la))
    same = la == lb and bits_equal(torch, pa, pb)
    print(f"(j) neutrality: unguarded runs the same bits: {same}; guarded "
          f"vs unguarded: largest parameter difference {diff}, loss "
          f"difference {loss_diff}", flush=True)
    if same:
        check(lg == la and bits_equal(torch, pg, pa),
              f"(j) init_scale=1.0 guarded != unguarded: losses {lg} vs "
              f"{la}, largest parameter difference {diff}")
    else:
        check(diff <= spread and loss_diff <= loss_spread,
              f"(j) guarded outside the unguarded spread: {diff} > "
              f"{spread} or {loss_diff} > {loss_spread}")
    check(scaler == [1.0, float(steps), 0.0], f"(j) scaler {scaler}")
    return dict(losses=lg, unguarded_losses=[la, lb],
                unguarded_runs_bitwise_equal=same,
                unguarded_max_param_spread=spread,
                guarded_max_param_diff=diff, loss_diff=loss_diff,
                dispatch_counts=counts, scaler_after=scaler,
                step_ms_unguarded_guarded_unguarded=[ma, mg, mb],
                steady_step_ms_unguarded_guarded_unguarded=[
                    statistics.median(m[1:]) for m in (ma, mg, mb)],
                peak_mem_gib_unguarded_guarded_unguarded=[peak_a, peak_g,
                                                          peak_b])


# -- the window as a CUDA graph, and the cross-step pipeline -----------------

WINDOW_K = 8       # (q), (r), (t): steps a window
WINDOW_TIMED = 1   # replayed windows timed after the first
PIPELINE_TAIL = 2  # (r), (t), (u): deferred buckets
# (s): CSC through the CLI at K = 4. The warm-up stages (first steps 0,
# 2, 4, 6, 8 at --csc-warmup 8) snap to 0, 0, 4, 8, 8: stage 1 (k =
# 3233) and stage 2 (k = 2361) run 4 steps each, the steady stage 4
# (k = 616) 8, two windows (the second a replay, timed); the dense
# stage 0 and stage 3 are shadowed.
CSC_WINDOW_K, CSC_WINDOW_WARMUP, CSC_WINDOW_STEPS = 4, 8, 16
CSC_WINDOW_STAGES = [1] * 4 + [2] * 4 + [4] * 8
CSC_WINDOW_K_SELECTED = [3233] * 4 + [2361] * 4 + [616] * 8
# (u): the two-process ring window.
RING_WINDOW_K = 3


class CountSyncs:
    """Counts the synchronizing CUDA calls PyTorch warns about
    (``torch.cuda.set_sync_debug_mode``) while entered."""

    def __init__(self, torch):
        self.torch, self.calls = torch, 0

    def __enter__(self):
        import warnings
        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)
        self.calls = sum("synchroniz" in str(w.message) for w in self._log)


def graph_pool_bytes(torch) -> dict:
    """Reserved bytes of each CUDA graph memory pool alive (the
    allocator's segments outside the default pool)."""
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id", (0, 0)))
        if pid != (0, 0):
            pools[str(pid)] = pools.get(str(pid), 0) + seg["total_size"]
    return pools


class MemoryLog(list):
    """The CLI's window record (``train(record=...)``), each entry given
    the graph pools alive and the peak reserved memory at its window's
    end."""

    def __init__(self, torch):
        super().__init__()
        self.torch = torch

    def append(self, item):
        item["graph_pool_bytes"] = graph_pool_bytes(self.torch)
        item["max_reserved_bytes"] = self.torch.cuda.max_memory_reserved()
        super().append(item)


def flat_state(torch, trainer, state):
    """The parameters and the momentum as one flat host tensor."""
    return torch.cat([p.reshape(-1) for p in
                      trainer.pool.flat_leaves(state.params)]
                     + [state.opt.momentum]).cpu()


def state_bytes(torch, trainer) -> int:
    """Bytes of a TrainState's tensors: the f32 parameters, the momentum,
    the staging pool, CSC's hg and chunk norms."""
    n = trainer.pool.size
    staging = torch.empty((), dtype=trainer._pack_dtype).element_size()
    out = 4 * trainer.pool.unpadded_size + 4 * n + staging * n
    if trainer.gf_cfg.csc_enabled:
        out += 4 * n + 4 * trainer.gf.num_chunks
    return out


def window_counts(plan, steps, cfg):
    """The launches a capture of ``steps`` momentum-SGD step bodies of
    ``cfg`` under ``plan`` makes: 2 packs a step and an update a span,
    CSC's census a step and its gather a sparse step; with a deferred
    tail, the tail spans' updates at each step's start and at the flush
    instead, each with a pack of its span's masters; the model's
    attention (``attention_counts``)."""
    tail = plan.pipeline_tail
    want = {"pool_pack.kernel": 2 * steps + tail * (steps + 1),
            "pool_unpack_update.kernel": (len(plan.update_spans) - tail)
            * steps + tail * (steps + 1)}
    if plan.mode == "csc":
        want["chunk_l1norm.kernel"] = steps
        if not plan.warmup:
            want["csc_compact.kernel"] = steps
    want.update(attention_counts(cfg, steps))
    return want


# The repo's kernels, by the names of their CUDA functions.
POOL_KERNELS = ("pool_pack_kernel", "pool_unpack_update_kernel",
                "chunk_l1norm", "csc_compact", "fused_update_kernel",
                "ring_kernel")


# The rest of the device's kernels by class, by words in their names (the
# first class that matches).
KERNEL_CLASSES = (("softmax", ("softmax",)),
                  ("reduction", ("reduce", "norm_kernel", "logsumexp")),
                  ("copy_cat_index", ("copy", "cat", "gather", "scatter",
                                      "index", "fill")),
                  ("elementwise", ("elementwise", "unrolled", "vectorized")))
TOP_KERNELS = 8


def device_profile(torch, fn, steps, parts=None):
    """Run ``fn`` (``steps`` train steps, ending in a host read) under
    ``torch.profiler`` and split the device's time from the trace's
    kernels: busy (the union of the kernels' intervals) against the wall
    time on the host clock, so the idle share, and per step the kernel
    count and the time of the repo's pool kernels, of the GEMMs and of
    the rest. With ``parts`` (a ``ModelParts`` entered around the call)
    the kernels are also split by the model part that launched them
    (``part_ms_per_step``, see ``attribute_parts``). Times include the
    profiler's own overhead."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                     for e in events if e.get("cat") == "kernel")
    check(len(kernels) > 0, "the profiler saw no device kernel")
    busy, end = 0.0, None
    for a, b, _ in kernels:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    split = {"pool_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    classes, by_name = {}, {}
    for a, b, name in kernels:
        low = name.lower()
        key = "pool_kernels" if any(k in name for k in POOL_KERNELS) else \
            "gemm" if any(k in low for k in ("gemm", "nvjet", "cutlass",
                                             "xmma")) else "other"
        ms = (b - a) / 1e3 / steps
        split[key] += ms
        if key == "other":
            key = next((c for c, words in KERNEL_CLASSES
                        if any(w in low for w in words)), "other")
        classes[key] = classes.get(key, 0.0) + ms
        by_name[name] = by_name.get(name, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    extra = {}
    if parts is not None:
        extra["part_ms_per_step"] = {
            k: v / steps for k, v in attribute_parts(events).items()}
        extra["part_note"] = PARTS_NOTE
    return dict(wall_ms=wall, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / 1e3 / wall,
                kernels_per_step=len(kernels) / steps,
                kernel_ms_per_step=split, class_ms_per_step=classes,
                top_kernels_ms_per_step=[[n[:120], t] for n, t in top],
                steps=steps,
                note="torch.profiler (CUPTI); its overhead included",
                **extra)


PART_PREFIX = "model_part:"
PARTS_NOTE = ("device ms a step by the model part that launched each "
              "kernel: inside a part's range (the forward and the remat "
              "recompute), or in the backward of an op that ran inside "
              "one (the autograd sequence number); pool_kernels by name; "
              "the rest (embedding, norms, head, loss, casts, the "
              "optimizer's PyTorch ops) 'other'")


class ModelParts:
    """While entered, each model part's function runs inside a
    ``torch.profiler.record_function`` range named after the part: the
    MoE layer's routing (``moe.gate``), dispatch, expert GEMMs and
    combine, arctic's dense residual MLP (``mlp.apply``) and attention
    (``attention.apply_train``, the projections included)."""

    PARTS = (("moe", "gate", "routing"), ("moe", "dispatch", "dispatch"),
             ("moe", "experts", "expert_gemms"),
             ("moe", "combine", "combine"),
             ("mlp", "apply", "dense_mlp"),
             ("attention", "apply_train", "attention"))

    def __enter__(self):
        import importlib
        from torch.profiler import record_function

        self.saved = []
        for mod_name, fn_name, part in self.PARTS:
            mod = importlib.import_module(
                f"repro_torch.models.layers.{mod_name}")
            fn = getattr(mod, fn_name)

            def ranged(*a, _fn=fn, _part=part, **k):
                with record_function(PART_PREFIX + _part):
                    return _fn(*a, **k)

            self.saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, ranged)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, fn in self.saved:
            setattr(mod, fn_name, fn)


def _containing(spans, tid, ts):
    """The payload of the latest-starting span of ``spans[tid]`` (sorted
    (start, end, payload) triples) that contains ``ts``, or None."""
    import bisect
    rows = spans.get(tid, ())
    i = bisect.bisect_right(rows, (ts, float("inf"), "~")) - 1
    for j in range(i, max(i - 8, -1), -1):
        a, b, payload = rows[j]
        if a <= ts <= b:
            return payload
    return None


def attribute_parts(events) -> dict:
    """Device ms by model part, from a chrome trace's events: a kernel
    belongs to the part whose range (a ``ModelParts`` user annotation)
    contains its launch (the forward, and the remat recompute on any
    thread); else to the part in whose range the forward op ran whose
    backward (an op with a forward thread, of the same autograd sequence
    number) launched it; else, by name, to 'pool_kernels'; else to
    'other'. Sequence numbers count per thread: only the forward ops of
    the thread that ran the first part (the caller's) are matched, the
    thread whose graph the backward runs (a remat recompute's graph is
    never differentiated)."""
    anns, ops = {}, []
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation" and name.startswith(PART_PREFIX):
            anns.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0),
                 name[len(PART_PREFIX):]))
        elif cat == "cpu_op" and e.get("args", {}).get(
                "Sequence number") is not None:
            ops.append(e)
    if not anns:
        return {}
    main = min(anns, key=lambda tid: min(a for a, _, _ in anns[tid]))
    for rows in anns.values():
        rows.sort()
    seq_part, backward = {}, {}
    for e in ops:
        if e["tid"] == main and not e["args"].get("Fwd thread id"):
            part = _containing(anns, main, e["ts"])
            if part is not None:
                seq_part.setdefault(e["args"]["Sequence number"], part)
    for e in ops:
        part = seq_part.get(e["args"]["Sequence number"])
        if e["args"].get("Fwd thread id") and part is not None:
            backward.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), part))
    for rows in backward.values():
        rows.sort()
    # cuBLAS launches through the driver API ('cuda_driver' events).
    launch = {e["args"]["correlation"]: (e["tid"], e["ts"])
              for e in events if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        part = None
        where = launch.get(e.get("args", {}).get("correlation"))
        if where is not None:
            part = _containing(anns, *where) or _containing(backward,
                                                            *where)
        if part is None:
            part = "pool_kernels" if any(k in e["name"]
                                         for k in POOL_KERNELS) else "other"
        out[part] = out.get(part, 0.0) + e["dur"] / 1e3
    return out


class MoERouting:
    """While entered, counts the slots ``moe.slots`` routes to each expert
    and the slots it drops, on the device (no host read until
    ``summary``)."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from repro_torch.models.layers import moe
        self.mod, self.saved = moe, moe.slots
        torch = self.torch

        def counted(expert_idx, num_experts, cap):
            dst, kept = self.saved(expert_idx, num_experts, cap)
            flat = expert_idx.reshape(-1)
            per = (flat[:, None] == torch.arange(
                num_experts, device=flat.device)).sum(0)
            self.calls.append(torch.cat([per, (~kept).sum()[None]]))
            return dst, kept

        self.mod.slots = counted
        return self

    def __exit__(self, *exc):
        self.mod.slots = self.saved

    def summary(self, remat: bool) -> dict:
        """Slots a step routed to each expert (summed over its layers and
        microbatches), dropped slots, and their share. With remat each
        routing runs twice (the forward and the recompute), which must
        agree: counted once."""
        rows = [tuple(c.tolist()) for c in self.calls]
        if remat:
            check(all(rows.count(r) % 2 == 0 for r in rows),
                  f"the remat recompute routed otherwise: {rows}")
        div = 2 if remat else 1
        per = [sum(r[i] for r in rows) // div
               for i in range(len(rows[0]) - 1)]
        dropped = sum(r[-1] for r in rows) // div
        return dict(slots_per_expert=per, dropped_slots=dropped,
                    slots=sum(per), dropped_share=dropped / sum(per),
                    routings=len(rows) // div)


def stacked(torch, batches):
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def window_trainer(train_mod, argv, tail, guard=None):
    import dataclasses
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)
    _, cfg = train_mod.build(args)
    cfg = cfg.replace(gradientflow=dataclasses.replace(
        cfg.gradientflow, pipeline_tail_buckets=tail, guard=guard))
    return args, cfg, Trainer(cfg, device=args.device)


def window_run(torch, dist, ops, train_mod, label, argv, tail, twin=None):
    """(q)/(r): a lazy window of WINDOW_K steps as a CUDA graph on the
    synthetic stream, in the NCCL group: the first window (capture, then
    replay) against ``twin`` (None: WINDOW_K eager steps of the CLI's
    loop from the same seed, timed; else (q)'s result), the same bits;
    then WINDOW_TIMED replayed windows timed, one profiled
    (``device_profile``) and one with its synchronizing calls counted
    (eager: two more steps' each). The
    capture's launches against the plan's, the all-reduces of the first
    window (the warm-up body and the capture) and of the replayed ones,
    the peak memory. Returns (run, twin)."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.trainer import is_flushed

    args, cfg, trainer = window_trainer(train_mod, argv, tail)
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    batches = [data.batch(s, BATCH, SEQ)
               for s in range(WINDOW_K * (1 + WINDOW_TIMED))]
    out = {}
    if twin is None:
        state = trainer.init_state(args.seed)
        step = trainer.build_train_step()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms, enqueue_ms = [], [], []
        for s in range(WINDOW_K):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batches[s])
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        twin = dict(losses=losses, final=flat_state(torch, trainer, state))
        with CountSyncs(torch) as syncs:
            for s in range(WINDOW_K, WINDOW_K + 2):
                state, m = step(state, batches[s])
                float(m["loss"])

        def two_steps():
            nonlocal state
            for s in range(WINDOW_K + 2, WINDOW_K + 4):
                state, m = step(state, batches[s])
                float(m["loss"])

        out["eager_profile"] = device_profile(torch, two_steps, 2)
        e = statistics.median(step_ms[1:])
        # enqueue: the host's time to return from a step, before the read
        # of its loss waits for the device.
        out.update(eager_step_ms=step_ms, eager_steady_step_ms=e,
                   eager_enqueue_ms=statistics.median(enqueue_ms[1:]),
                   eager_peak_mem_gib=torch.cuda.max_memory_allocated()
                   / 2 ** 30, eager_syncs_per_step=syncs.calls / 2)
        del state, step
    plan = trainer.engine.plan_for()
    check(plan.pipeline_tail == tail
          and (trainer._pipeline_plan() is not None) == bool(tail),
          f"{label}: plan tail {plan.pipeline_tail}, expected {tail}")
    state = trainer.init_state(args.seed)
    window = trainer.build_train_window(WINDOW_K)
    ops.reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with CountAllReduce(dist) as first:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = window(state, stacked(torch, batches[:WINDOW_K]))
        losses = m["loss"].tolist()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved()
    pools = graph_pool_bytes(torch)
    final = flat_state(torch, trainer, state)
    win_ms, win_enqueue_ms = [], []
    with CountAllReduce(dist) as replayed:
        for w in range(1, 1 + WINDOW_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = window(state, stacked(
                torch, batches[w * WINDOW_K:(w + 1) * WINDOW_K]))
            win_enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            m["loss"].tolist()
            torch.cuda.synchronize()
            win_ms.append((time.perf_counter() - t0) * 1e3)
    def one_window():
        nonlocal state
        state, m = window(state, stacked(torch, batches[:WINDOW_K]))
        m["loss"].tolist()

    out["profile"] = device_profile(torch, one_window, WINDOW_K)
    with CountSyncs(torch) as syncs:
        one_window()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stats, counts = dict(window.stats), dict(ops.dispatch_counts)
    flushed, sbytes = is_flushed(state), state_bytes(torch, trainer)
    window.release()
    del state, window, trainer
    torch.cuda.empty_cache()
    print(f"{label}: losses {losses}; window ms {win_ms}", flush=True)
    same = losses == twin["losses"] and bits_equal(torch, final,
                                                   twin["final"])
    check(same, f"{label}: the graphed window != its twin (losses {losses} "
          f"vs {twin['losses']}, largest state difference "
          f"{(final - twin['final']).abs().max().item()})")
    check(flushed, f"{label}: the returned state carries a live lane")
    check(len(pools) == 1, f"{label}: graph pools alive after the capture "
          f"{pools} (an earlier window's not freed)")
    want = window_counts(plan, WINDOW_K, cfg)
    check(stats["capture_counts"] == want, f"{label}: the capture launched "
          f"{stats['capture_counts']}, the plan says {want}")
    check(stats["captures"] == 1 and stats["replays"] == 3 + WINDOW_TIMED,
          f"{label}: {stats['captures']} captures, {stats['replays']} "
          f"replays")
    check(first.calls == (WINDOW_K + 1) * len(plan.tasks)
          and replayed.calls == 0,
          f"{label}: all-reduce calls {first.calls} in the first window "
          f"(warm-up body + capture), {replayed.calls} in the replayed ones")
    check(syncs.calls == 1, f"{label}: {syncs.calls} synchronizing calls "
          f"in a window and its read")
    step_ms = statistics.median(win_ms) / WINDOW_K
    out.update(losses=losses, window_ms=win_ms, steady_step_ms=step_ms,
               window_enqueue_ms=win_enqueue_ms,
               tokens_per_s=BATCH * SEQ / (step_ms / 1e3),
               first_window_s=first_s, warmup_s=stats["warmup_s"],
               capture_s=stats["capture_s"],
               capture_counts=stats["capture_counts"],
               expected_capture_counts=want,
               warmup_counts=stats["warmup_counts"],
               dispatch_counts=counts, replays=stats["replays"],
               all_reduce_calls_first_window=first.calls,
               all_reduce_calls_replayed_windows=replayed.calls,
               syncs_per_window=syncs.calls, peak_mem_gib=peak,
               reserved_after_capture_gib=reserved / 2 ** 30,
               graph_pool_gib={k: v / 2 ** 30 for k, v in pools.items()},
               state_gib=sbytes / 2 ** 30, pipeline_tail=tail,
               window_steps=WINDOW_K, same_bits_as_twin=same,
               twin="eager steps" if "eager_step_ms" in out
               else "(q), the unpipelined window")
    if "eager_steady_step_ms" in out:
        e = out["eager_steady_step_ms"]
        out["steady_delta_pct"] = 100.0 * (step_ms - e) / e
    return out, twin


def csc_window_run(torch, ops, train_mod, label, argv):
    """(s): CSC through the CLI at --window-steps 4 over the snapped
    warm-up stages, one graph a stage, each freed when its stage ends;
    then the same steps eagerly under the same snapped schedule: the same
    losses bit for bit. At each window's end at most one graph pool is
    alive; the peak reserved memory stays under one stage graph's pool
    plus the state, plus the warm-up's scratch clone of the state."""
    from repro_torch.core.schedule import (snap_stages_to_window, stage_at,
                                           stage_first_steps)
    from repro_torch.data.synthetic import SyntheticLM

    args = train_mod.parse_args(argv)
    record = MemoryLog(torch)
    ops.reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, losses, _, run = train_mod.train(args, record=record)
    clear_checkpoints()
    check(run["restarts"] == 0 and run["preempted"] is None,
          f"{label}: the CLI's supervisor {run}")
    peak_reserved = torch.cuda.max_memory_reserved()
    sbytes = state_bytes(torch, trainer)
    counts = dict(ops.dispatch_counts)
    stages = snap_stages_to_window(trainer.gf.stages, CSC_WINDOW_K)
    firsts = stage_first_steps(stages)
    plans = [trainer.gf.plan(stage_at(stages, r["start"], firsts))
             for r in record]
    del trainer
    torch.cuda.empty_cache()
    # The eager twin under the same snapped schedule.
    trainer, cfg = train_mod.build(args)
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    state = trainer.init_state(args.seed)
    fns, eager, ran, eager_ms = {}, [], [], []
    for s in range(CSC_WINDOW_STEPS):
        stage = stage_at(stages, s, firsts)
        if stage.index not in fns:
            fns[stage.index] = trainer.build_train_step(stage)
        # Timed as the CLI times a step: the batch made, the card idle.
        batch = data.batch(s, BATCH, SEQ)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fns[stage.index](state, batch)
        eager.append(float(m["loss"]))
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        ran.append((stage.index, stage.num_selected))
    del state, fns, trainer
    torch.cuda.empty_cache()
    print(f"{label}: losses {losses}; eager {eager}", flush=True)
    check(ran == list(zip(CSC_WINDOW_STAGES, CSC_WINDOW_K_SELECTED)),
          f"{label}: stages (index, k) {ran}")
    check([r["stage"] for r in record]
          == CSC_WINDOW_STAGES[::CSC_WINDOW_K],
          f"{label}: windows' stages {[r['stage'] for r in record]}")
    check(losses == eager, f"{label}: graphed losses {losses} != eager "
          f"{eager} under the same snapped stages")
    pools = [r["graph_pool_bytes"] for r in record]
    check(all(len(p) == 1 for p in pools)
          and len({k for p in pools for k in p}) == len(set(
              CSC_WINDOW_STAGES)),
          f"{label}: graph pools alive at the windows' ends {pools}")
    for i, (r, plan) in enumerate(zip(record, plans)):
        st = r["stats"]
        want = window_counts(plan, CSC_WINDOW_K, cfg)
        replays = sum(x["stage"] == r["stage"] for x in record[:i + 1])
        check(st["captures"] == 1 and st["replays"] == replays
              and st["capture_counts"] == want,
              f"{label}: window at {r['start']}: {st}, expected capture "
              f"counts {want}, {replays} replays")
    largest = max(v for p in pools for v in p.values())
    bound = largest + 2 * sbytes + 2 ** 29
    check(peak_reserved <= bound, f"{label}: peak reserved "
          f"{peak_reserved / 2 ** 30:.3f} GiB above one graph pool "
          f"({largest / 2 ** 30:.3f}) + the state and its warm-up clone "
          f"(2 x {sbytes / 2 ** 30:.3f}) + 0.5 GiB")
    # Each stage's first window pays its warm-up and capture; the steady
    # stage's later windows are replays alone, timed against the eager
    # twin's steady steps after the stage's first.
    steady = CSC_WINDOW_STAGES[-1]
    replay_ms = [r["seconds"] * 1e3 / CSC_WINDOW_K for r in record
                 if r["stage"] == steady][1:]
    first = CSC_WINDOW_STAGES.index(steady)
    twin_ms = eager_ms[first + 1:]
    step_ms = statistics.median(replay_ms)
    twin = statistics.median(twin_ms)
    return dict(losses=losses, eager_losses=eager,
                stages=[r["stage"] for r in record],
                num_selected=CSC_WINDOW_K_SELECTED,
                window_ms=[r["seconds"] * 1e3 for r in record],
                steady_step_ms=step_ms, steady_replay_step_ms=replay_ms,
                eager_steady_step_ms=twin, eager_step_ms=eager_ms,
                steady_delta_pct=100.0 * (step_ms / twin - 1.0),
                capture_counts=[r["stats"]["capture_counts"]
                                for r in record],
                warmup_s=[r["stats"]["warmup_s"] for r in record],
                capture_s=[r["stats"]["capture_s"] for r in record],
                graph_pool_gib=[{k: v / 2 ** 30 for k, v in p.items()}
                                for p in pools],
                reserved_gib_at_window_ends=[r["reserved_bytes"] / 2 ** 30
                                             for r in record],
                peak_reserved_gib=peak_reserved / 2 ** 30,
                state_gib=sbytes / 2 ** 30, dispatch_counts=counts,
                window_steps=CSC_WINDOW_K, same_bits_as_eager=True)


def guarded_window_run(torch, ops, train_mod, label, argv, tail, faults,
                       twin_losses, twin=None):
    """(t): a guarded lazy window of WINDOW_K steps as a CUDA graph with
    ``faults`` fired by the device-step hook inside it. The hook also
    records, inside the graph, a digest of the parameters and momentum
    (each tensor's int32 words summed) as each step's update starts:
    a tripped step t leaves digest t+1 equal to digest t (and a clean
    one changes it). Exactly the faulted steps trip; the losses equal
    ``twin_losses`` (the eager guarded run (g)); with ``twin`` (the
    unpipelined window's) the losses and the state the same bits."""
    from repro_torch.configs.base import GuardConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.trainer import is_flushed
    from repro_torch.runtime.faults import make_hook

    args, cfg, trainer = window_trainer(train_mod, argv, tail,
                                        guard=GuardConfig())
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    state = trainer.init_state(args.seed)
    hook = make_hook(fault_events(faults))
    live = trainer.pool.flat_leaves(state.params) + [state.opt.momentum]
    digests = []

    def probed(gpool, step):
        digests.append(torch.stack([x.view(torch.int32).sum(
            dtype=torch.int64) for x in live]))
        return hook(gpool, step)

    window = trainer.build_train_window(WINDOW_K, fault_hook=probed)
    ops.reset_counts()
    state, m = window(state, stacked(torch, [data.batch(s, BATCH, SEQ)
                                             for s in range(WINDOW_K)]))
    losses, tripped = m["loss"].tolist(), m["guard_tripped"].tolist()
    after = torch.stack([x.view(torch.int32).sum(dtype=torch.int64)
                         for x in live])
    d = torch.stack(digests[-WINDOW_K:] + [after]).cpu()
    at = {f[0] for f in faults}
    frozen = [bool(torch.equal(d[t + 1], d[t])) for t in sorted(at)]
    moved = [not torch.equal(d[t + 1], d[t]) for t in range(WINDOW_K)
             if t not in at]
    scale, skipped = float(state.guard.scale), int(state.guard.skipped)
    final = flat_state(torch, trainer, state)
    stats, flushed = dict(window.stats), is_flushed(state)
    counts = dict(ops.dispatch_counts)
    window.release()
    del state, window, trainer, live, digests
    torch.cuda.empty_cache()
    print(f"{label}: tripped {tripped}, losses {losses}", flush=True)
    check(tripped == [float(t in at) for t in range(WINDOW_K)],
          f"{label}: tripped {tripped}, faults at {sorted(at)}")
    check(all(frozen) and all(moved), f"{label}: a tripped step moved the "
          f"state ({frozen}) or a clean one did not ({moved})")
    check(scale == 2.0 ** 15 / 2 ** len(at) and skipped == len(at),
          f"{label}: scale {scale}, skipped {skipped}")
    check(flushed, f"{label}: the returned state carries a live lane")
    check(losses == twin_losses, f"{label}: losses {losses} != the eager "
          f"guarded run's {twin_losses}")
    if twin is not None:
        check(losses == twin["losses"] and bits_equal(torch, final,
                                                      twin["final"]),
              f"{label}: the pipelined guarded window != the unpipelined")
    return dict(losses=losses, tripped=tripped, faults=[list(f) for f in
                                                        faults],
                trips_bit_identical=frozen, clean_steps_moved=moved,
                scale_after=scale, skipped=skipped,
                capture_counts=stats["capture_counts"],
                dispatch_counts=counts, replays=stats["replays"],
                pipeline_tail=tail, window_steps=WINDOW_K), \
        dict(losses=losses, final=final)


def guard_lane_phase(torch, dev):
    """``GuardLane`` on the card, lazy and CSC: the windowed lane
    (window=4) gives the per-step records."""
    from repro_torch.runtime.faults import FaultEvent, GuardLane, truth_table

    faults = [FaultEvent(step=2, kind="nan", offset=8, width=4),
              FaultEvent(step=5, kind="overflow", offset=40, width=4),
              FaultEvent(step=6, kind="bitflip", offset=100, width=6)]
    out = {}
    for mode in ("lazy", "csc"):
        per_step = GuardLane(mode=mode, device=dev).run(9, faults)
        windowed = GuardLane(mode=mode, device=dev).run(9, faults, window=4)
        check(windowed == per_step, f"GuardLane {mode}: window=4 records "
              f"{windowed} != per-step {per_step}")
        table = truth_table(windowed)
        check(table["false_trips"] == 0 and all(
            row["caught"] == row["injected"]
            for row in table["classes"].values()),
              f"GuardLane {mode}: {table}")
        out[mode] = table
    return out


# -- long sequences on the dense models --------------------------------------

# (y): olmo-1b at full width and depth, train_4k's sequence, 16 x 4096
# tokens a step in 4 microbatches of 4 x 4096, blockwise attention beyond
# 1024 tokens (the Trainer's default full masked grid, causal_skip off).
OLMO_BATCH, OLMO_SEQ, OLMO_CHUNK, OLMO_STEPS = 16, 4096, 1024, 2
OLMO_ARGV = ["--arch", "olmo-1b", "--seq-len", str(OLMO_SEQ), "--batch",
             str(OLMO_BATCH), "--attn-chunk", str(OLMO_CHUNK), "--gf-mode",
             "lazy", "--use-kernels", "--window-steps", "1", "--log-every",
             "1", "--steps", str(OLMO_STEPS)]
OLMO_MICROBATCHES = 4
OLMO_POOL = 1_176_764_416  # elements in 8 leaves: the first above 2^30
BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA's data sheet, 700 W)
# (z): attention at olmo-1b's layer shape and at musicgen-large's (b, S,
# heads, head_dim), bf16, each with the blocks its blockwise forms and
# per-block bound take.
ATTN_CHUNK = 1024
ATTN_CASES = {"olmo-1b": ((4, 4096, 16, 128), ATTN_CHUNK),
              "musicgen-large": ((4, 1500, 32, 64), 500)}
ATTN_REPS = 5
# Each form against full attention (and the two blockwise forms against
# each other), outputs and gradients: bf16 rounds each product's output
# to 8 bits of mantissa at other places in each form, and the blockwise
# accumulator sums 4 key blocks in bf16, so values differ by about one
# bf16 ulp of the largest value (2^-7 of it at most); bound: 2^-6 of the
# largest |full attention| value (measured on the CPU at S = 4096: one
# ulp, 0.0156 of a largest 2.7; the two blockwise forms the same bits).
ATTN_TOL = 2.0 ** -6
# Each form's output and gradients are also held to full attention's per
# ATTN_CHUNK-position block and head: the RMS of the error over the
# block's rows and head_dim within ATTN_BLOCK_TOL of the RMS of full
# attention's there. A late row's values average over thousands of keys
# and are small beside the first rows', so the bound on the whole tensor
# alone would pass a fault confined to late blocks (measured on the CPU
# at S = 4096, 2 x 4 heads: at most 0.0075, the median 0.0042-0.0063; a
# late query block rescaled by 1 + 2^-4 reads 2^-4 and must fail).
ATTN_BLOCK_TOL = 2.0 ** -6
ATTN_CONTROL_SCALE = 1.0 + 2.0 ** -4
# (au): the afmoe kernels at the trinity-mini-train cell's shapes: its
# 4 x 8192 tokens routed by trinity-mini-ep4's sigmoid router (weights
# N(0, 0.02)) onto the 32 experts it holds, each MoE product (K, N); its
# sliding layers' attention (b, S, heads, head_dim) and window.
AFMOE_ARCH = "trinity-mini-ep4"
AFMOE_TOKENS = 4 * 8192
AFMOE_PRODUCTS = {"gate_up": (2048, 1024), "down": (1024, 2048)}
AFMOE_ATTN_SHAPE = (4, 8192, 32, 128)
AFMOE_WINDOW = 2048
# The kernel and the plain version both sum bf16 products in f32 and
# round once to bf16: they differ where the two orders of the sum round
# across a bf16 step, one ulp of a value, 2^-7 of the largest at most. A
# product through the wrong expert's weights (the control) errs by the
# values themselves.
GMM_TOL = 2.0 ** -7
# The windowed kernels against their plain version: the card tests'
# bounds (tests/test_torch_cuda.py: the largest error within 2^-6 of the
# largest value, the relative RMS within 2^-7, the log-sum-exp 2^-14).
FLASH_MAX_TOL, FLASH_RMS_TOL, FLASH_LSE_TOL = 2.0 ** -6, 2.0 ** -7, 2.0 ** -14
# (aa): the three smoke configurations through the Trainer, CSC, with
# attention blockwise (64-token chunks of 256).
SMOKE_ARCHS = ("olmo-1b", "stablelm-12b", "qwen3-32b")
SMOKE_STEPS = 5
SMOKE_ARGV = ["--reduced", "--use-kernels", "--gf-mode", "csc", "--batch",
              "8", "--seq-len", "256", "--attn-chunk", "64",
              "--chunk-elems", "2048", "--bucket-elems", "65536",
              "--sparsity", "0.5", "--csc-warmup", "2", "--window-steps",
              "1", "--log-every", "1", "--steps", str(SMOKE_STEPS)]
# (aa): stablelm-12b and qwen3-32b at their published widths (LayerNorm
# with bias at 5120, QK-norm on 128-wide heads, GQA 32/8 with heads of
# 160 and 64/8 with heads of 128), cut to 2 layers (1.58 G and 2.53 G
# parameters, the only reduction), lazy, bf16 wire, kernels on: 2 x 4096
# tokens a step in 2 microbatches, blockwise beyond 1024 tokens.
WIDE_ARCHS, WIDE_LAYERS, WIDE_BATCH, WIDE_STEPS = (
    ("stablelm-12b", "qwen3-32b"), 2, 2, 2)
WIDE_MICROBATCHES = 2


def wide_argv(arch):
    return ["--arch", arch, "--seq-len", str(OLMO_SEQ), "--batch",
            str(WIDE_BATCH), "--attn-chunk", str(OLMO_CHUNK), "--gf-mode",
            "lazy", "--use-kernels", "--window-steps", "1", "--log-every",
            "1", "--steps", str(WIDE_STEPS)]


# (ab): smollm-135m lazy at microbatches 2, a window of 4 against 4
# eager steps; a NaN at step 2 inside the guarded window.
MB_K = 4
MB_FAULTS = ((2, "nan", 1_000_000, GUARD_WIDTH),)


class CountAttention:
    """Counts the calls of ``attention.blockwise_attention`` and
    ``full_attention`` (``attend`` looks both up in the module) while
    entered."""

    def __init__(self):
        from repro_torch.models.layers import attention
        self.mod, self.calls = attention, {"blockwise": 0, "full": 0}

    def __enter__(self):
        self.saved = (self.mod.blockwise_attention, self.mod.full_attention)
        block, full = self.saved

        def counted_block(*a, **k):
            self.calls["blockwise"] += 1
            return block(*a, **k)

        def counted_full(*a, **k):
            self.calls["full"] += 1
            return full(*a, **k)

        self.mod.blockwise_attention = counted_block
        self.mod.full_attention = counted_full
        return self

    def __exit__(self, *exc):
        self.mod.blockwise_attention, self.mod.full_attention = self.saved


def step_flops(cfg, pool) -> dict:
    """The FLOPs of one training step, two ways. ``model``: what the
    model needs, 6 per matmul weight per token (forward 2, backward 4)
    and the attention's two products (QK^T and PV) over the causal half
    of the S x S grid, forward and backward (6 S h hd a token a layer),
    no recompute. A MoE layer's weights count as the router and ``top_k``
    of its ``num_experts`` experts a token (the active weights). A vlm's
    vision positions run through the layers and attention but not the
    head; an audio model has one head a codebook. ``executed``: what this
    run's path computes: the experts over every microbatch's E x cap
    slots, padding and dropped slots included (``moe.capacity``), the
    per-layer remat's second forward of the layers (2 per layer weight
    per position) and the attention over the whole masked grid in the
    forward, the remat forward and the backward (16 S h hd a token a
    layer). The embedding counts once, as the head's matmul (tied or
    not: the input lookup is no product).

    ssm (Mamba-1): the ``layers/`` leaves as weights and no attention;
    the selective scan counts no FLOPs, being elementwise (no product of
    two matrices). hybrid (Mamba-2 and the shared block): the
    ``mamba_layers/`` leaves once a position, the ``shared_attn/`` leaves
    once a position per application (``groups``), attention in
    ``groups`` layers, and the SSD's products a layer, in chunks of Q =
    min(SCAN_CHUNK, S): C·B^T (2 Q d_state a position) and the
    (Q x Q)-weighted sum of x (2 Q d_inner) over the causal half under
    ``model`` and the whole masked grid under ``executed``, and the
    state's two products (C·h and the x ⊗ B update, 4 d_inner d_state)
    in both. The hybrid's nested remat runs each Mamba-2 block's forward
    three times (the forward, its group's recompute, its own), so
    ``executed`` counts 10 per backbone weight and 5 forwards of the SSD
    (the shared block's weights and attention: 8 and 16, as a layer's).
    """
    from repro_torch.models.layers import mamba, mamba2, moe
    m = cfg.model
    vision = m.num_vision_tokens if m.family == "vlm" else 0
    seq = cfg.seq_len + vision
    rows = cfg.global_batch * seq            # positions through the layers
    text = cfg.global_batch * cfg.seq_len    # positions through the head
    codebooks = m.num_codebooks \
        if m.family == "audio" and m.num_codebooks > 1 else 1
    head = codebooks * m.vocab_size * m.d_model

    def leaves(prefix, ndim=None):
        return sum(s.size for s in pool.specs if s.name.startswith(prefix)
                   and (ndim is None or len(s.shape) == ndim))

    ssd_model = ssd_run = 0
    if m.family == "ssm":
        weights = rows * leaves("layers/")
        weights_model, weights_run, attn = 6 * weights, 8 * weights, 0
    elif m.family == "hybrid":
        groups = m.num_layers // m.hybrid_attn_every
        backbone = rows * leaves("mamba_layers/")
        shared = rows * groups * leaves("shared_attn/")
        weights_model = 6 * (backbone + shared)
        weights_run = 10 * backbone + 8 * shared
        attn = seq * m.num_heads * m.resolved_head_dim * groups
        d_inner, _, _, d_state, _ = mamba2.dims(m)
        q = min(mamba.SCAN_CHUNK, seq)
        state = 4 * d_inner * d_state
        ssd_model = 3 * rows * m.num_layers * (q * (d_state + d_inner)
                                               + state)
        ssd_run = 5 * rows * m.num_layers * (2 * q * (d_state + d_inner)
                                             + state)
    else:
        # The stacked experts are the 4-D (L, E, ., .) leaves of the FFN.
        experts = leaves("layers/ffn/", 4)
        dense = leaves("layers/") - experts
        attn = seq * m.num_heads * m.resolved_head_dim * m.num_layers
        active = slots = 0
        if m.moe is not None:
            per_expert = experts / m.moe.num_experts
            active = rows * m.moe.top_k * per_expert
            slots = cfg.microbatches * m.moe.num_experts * moe.capacity(
                m, rows // cfg.microbatches) * per_expert
        weights_model = 6 * (rows * dense + active)
        weights_run = 8 * (rows * dense + slots)
    return dict(model=float(weights_model + 6 * text * head
                            + 6 * rows * attn + ssd_model),
                executed=float(weights_run + 6 * text * head
                               + 16 * rows * attn + ssd_run))


FLOPS_NOTE = ("model: 6 per matmul weight per token (MoE: the router and "
              "top_k of the experts; the head over the text positions, "
              "one a codebook; hybrid: the shared block once an "
              "application), attention's QK^T and PV over the causal "
              "half x3 (forward, backward), the SSD's in-chunk products "
              "over the causal half and its state products x3, Mamba-1's "
              "elementwise scan none, no remat; executed: the experts "
              "over every microbatch's E x cap slots, the remat forward "
              "(2 per layer weight; the hybrid's nested remat 4 per "
              "backbone weight), attention over the whole masked grid x4 "
              "(forward, remat, backward), the SSD over the whole masked "
              "grid x5; shares against 989 TFLOP/s dense bf16")


def olmo_pool_kernel_parts(torch, pool_mod, kpack, kunpack, shapes, dev,
                           rate):
    """pool_pack and pool_unpack_update at olmo-1b's lazy pool (8 leaves,
    1,176,764,416 elements, 64-bit offsets past 2^31 bytes): the bf16
    gradient pack and the f32 master pack, and the 8-span update, each
    bit for bit against its plain version and timed beside it and its
    bytes bound. Returns (pack parts, update parts)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    pool = pool_mod.GradientPool(shapes)
    n = pool.size
    check(n == OLMO_POOL and pool.num_tensors == 8,
          f"olmo-1b pool {n} in {pool.num_tensors} leaves")
    leaves = [torch.randn(s, generator=gen, device=dev) for s in pool.sizes]
    pack = {}
    for label, wire in (("olmo_1b_lazy_grads_to_bf16", torch.bfloat16),
                        ("olmo_1b_params_to_f32", torch.float32)):
        args = (leaves, pool.offsets, pool.sizes, n, 0, wire)
        staging = torch.empty((n,), dtype=wire, device=dev)
        got, _ = kpack.launch(*args, out=staging)
        want, _ = kpack.plain(*args)
        torch.cuda.synchronize()
        err = abs_err(got, want)
        check(torch.equal(got, want), f"pool_pack {label}: kernel != plain "
              f"(max abs diff {err})")
        del want
        lib = torch.empty((n,), dtype=wire, device=dev)
        nbytes = n * 4 + n * torch.empty((), dtype=wire).element_size()
        b_ms, b_by = bound_ms(nbytes, n, rate)
        pack[label] = dict(
            ms=time_ms(torch, lambda: kpack.launch(*args, out=staging)),
            plain_ms=time_ms(torch, lambda: kpack.plain(*args)),
            library_ms=time_ms(torch, lambda: torch.cat(leaves, out=lib)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, max_abs_err=err,
            pool_elems=n)
        del got, staging, lib
        torch.cuda.empty_cache()
    del leaves
    torch.cuda.empty_cache()
    lr = torch.tensor(0.2, dtype=torch.float32, device=dev)
    kw = dict(lr=lr, momentum=0.9, weight_decay=1e-4)
    views = [pool.bucket_view(s, e)
             for s, e in pool.bucket_boundaries(BUCKET_ELEMS)]
    check(len(views) == 8, f"{len(views)} olmo-1b lazy spans, expected 8")
    master = torch.randn(n, generator=gen, device=dev)
    grads = torch.randn(n, generator=gen, device=dev) * 1e-2
    mom = torch.randn(n, generator=gen, device=dev) * 1e-2
    mask = torch.ones(n, dtype=torch.bool, device=dev)

    def outputs():
        return ([torch.empty(s, device=dev) for s in pool.sizes],
                torch.empty(n, device=dev))

    def step(fn, out):
        for v in views:
            s, e = v.start, v.end
            fn(master[s:e], grads[s:e], mom[s:e], mask[s:e], v.offsets,
               v.sizes, out_leaves=out[0][v.leaf_lo:v.leaf_hi],
               out_momentum=out[1][s:e], **kw)

    k_out = outputs()
    step(kunpack.launch, k_out)
    want = outputs()
    step(kunpack.plain, want)
    torch.cuda.synchronize()
    err = max(abs_err(a, b) for a, b in zip(k_out[0] + [k_out[1]],
                                             want[0] + [want[1]]))
    check(all(torch.equal(a, b) for a, b in zip(k_out[0] + [k_out[1]],
                                                 want[0] + [want[1]])),
          f"pool_unpack_update at olmo-1b's pool: kernel != plain (max abs "
          f"diff {err})")
    nbytes = n * 17 + n * 4
    b_ms, b_by = bound_ms(nbytes, n * 7, rate)
    update = {"olmo_1b_lazy_8_spans": dict(
        ms=time_ms(torch, lambda: step(kunpack.launch, k_out)),
        plain_ms=time_ms(torch, lambda: step(kunpack.plain, want)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
        max_abs_err=err, launches_per_step=len(views), pool_elems=n)}
    del master, grads, mom, mask, k_out, want
    torch.cuda.empty_cache()
    for parts in (pack, update):
        for p in parts.values():
            p["share_of_bound"] = p["bound_ms"] / p["ms"]
    return pack, update


def block_rms_err(torch, x, want, block=ATTN_CHUNK) -> float:
    """The largest, over ``block``-position blocks and heads of (b, S, h,
    hd) tensors, of the RMS of ``x - want`` over the block's rows and
    head_dim relative to the RMS of ``want`` there."""
    b, s, h, hd = want.shape
    shape = (b, s // block, block, h, hd)
    ref = want.float().view(shape)
    err = (x.float().view(shape) - ref).pow(2).sum((2, 4)).sqrt()
    return (err / ref.pow(2).sum((2, 4)).sqrt()).max().item()


def attention_phase(torch, dev):
    """(z) attention at each ATTN_CASES shape (bf16, causal): the
    flash-attention kernel and its plain version, the blockwise full
    grid, blockwise causal_skip and full attention (the port's CPU
    forms) and F.scaled_dot_product_attention (a yardstick the port never
    calls). Each form's output and its q, k, v gradients (for one fixed
    cotangent) against full attention's, and the two blockwise forms
    against each other, within ATTN_TOL of the largest value, and against
    full attention's within ATTN_BLOCK_TOL per block and head
    (``block_rms_err``; a planted late-block rescale must fail that
    bound); forward (no_grad) and forward + backward timed with CUDA
    events (median of ATTN_REPS after a warm-up), the memory autograd
    holds after the forward, and the peak of each. Returns a summary a
    case."""
    return {case: attention_case(torch, dev, shape, block)
            for case, (shape, block) in ATTN_CASES.items()}


def attention_case(torch, dev, shape, block):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ops
    from repro_torch.models.layers import attention

    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, cot = [torch.randn(shape, generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(4)]
    b, s, h, hd = shape
    forms = {
        "flash_kernel": ops.flash_attention,
        "flash_plain": flash_attention.plain_attention,
        "blockwise_full_grid": lambda q_, k_, v_: attention.
        blockwise_attention(q_, k_, v_, causal=True, chunk_q=block,
                            chunk_k=block, causal_skip=False),
        "blockwise_causal_skip": lambda q_, k_, v_: attention.
        blockwise_attention(q_, k_, v_, causal=True, chunk_q=block,
                            chunk_k=block, causal_skip=True),
        "full": lambda q_, k_, v_: attention.full_attention(
            q_, k_, v_, causal=True),
        "sdpa_yardstick": lambda q_, k_, v_: F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            is_causal=True).transpose(1, 2)}

    def train(fn):
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, grad_outputs=cot)
        return [out.detach()] + list(grads)

    def events_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(ATTN_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    results, out = {}, {}
    for name, fn in forms.items():
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        results[name] = train(fn)
        torch.cuda.synchronize()
        peak_train = torch.cuda.max_memory_allocated() - base
        # What autograd keeps between the forward and the backward.
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        before = torch.cuda.memory_allocated()
        o = fn(*leaves)
        saved = torch.cuda.memory_allocated() - before
        del o, leaves
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            fn(q, k, v)
        torch.cuda.synchronize()
        peak_fwd = torch.cuda.max_memory_allocated() - base
        with torch.no_grad():
            fwd_ms = events_ms(lambda: fn(q, k, v))
        out[name] = dict(forward_ms=fwd_ms,
                         forward_backward_ms=events_ms(lambda: train(fn)),
                         forward_peak_gib=peak_fwd / 2 ** 30,
                         forward_backward_peak_gib=peak_train / 2 ** 30,
                         autograd_saved_gib=saved / 2 ** 30)
    names = ("out", "dq", "dk", "dv")
    full = results["full"]
    for name, got in results.items():
        errs, block_errs = {}, {}
        for label, x, want in zip(names, got, full):
            errs[label] = abs_err(x, want)
            bound = ATTN_TOL * want.float().abs().max().item()
            check(errs[label] <= bound, f"(z) {shape} {name} {label}: max "
                  f"abs err {errs[label]} against full attention, bound "
                  f"{bound}")
            block_errs[label] = block_rms_err(torch, x, want, block)
            check(block_errs[label] <= ATTN_BLOCK_TOL, f"(z) {shape} {name} "
                  f"{label}: per-block relative RMS error "
                  f"{block_errs[label]} against full attention, bound "
                  f"{ATTN_BLOCK_TOL}")
        out[name]["max_abs_err_vs_full"] = errs
        out[name]["block_rms_err_vs_full"] = block_errs
    # Control: full attention's output with its last query block off by
    # a wrong rescale must fail the per-block bound.
    want = full[0]
    planted = want.clone()
    planted[:, -block:] = (planted[:, -block:].float()
                           * ATTN_CONTROL_SCALE).to(planted.dtype)
    control = dict(block_rms_err=block_rms_err(torch, planted, want, block),
                   max_abs_err=abs_err(planted, want),
                   whole_tensor_bound=ATTN_TOL
                   * want.float().abs().max().item())
    control["whole_tensor_bound_catches"] = \
        control["max_abs_err"] > control["whole_tensor_bound"]
    check(control["block_rms_err"] > ATTN_BLOCK_TOL, f"(z) {shape}: the "
          f"planted late-block rescale passes the per-block bound: "
          f"{control}")
    del planted
    grid, skip = results["blockwise_full_grid"], \
        results["blockwise_causal_skip"]
    forms_err = {label: abs_err(a, b)
                 for label, a, b in zip(names, grid, skip)}
    for label, want in zip(names, full):
        check(forms_err[label] <= ATTN_TOL * want.float().abs().max().item(),
              f"(z) {shape}: the blockwise forms disagree on {label}: "
              f"{forms_err}")
    # FLOPs of the two products over the causal half (the least the card
    # could do), at the dense bf16 peak; forward, and x3 with backward.
    flops = 4 * b * h * s * s * hd / 2
    kernel = out["flash_kernel"]
    summary = dict(shape=dict(batch=b, seq=s, heads=h, head_dim=hd),
                   dtype="bfloat16", chunk=block, forms=out,
                   blockwise_forms_max_abs_err=forms_err,
                   blockwise_forms_same_bits=all(
                       torch.equal(a, b_) for a, b_ in zip(grid, skip)),
                   tolerance=f"{ATTN_TOL} x max|full attention|",
                   block_tolerance=f"{ATTN_BLOCK_TOL} x the RMS of full "
                   f"attention per {block}-position block and head",
                   planted_late_rescale=control,
                   causal_flops_forward=flops,
                   bound_forward_ms=flops / BF16_FLOPS * 1e3,
                   bound_forward_backward_ms=3 * flops / BF16_FLOPS * 1e3,
                   kernel_share_of_bound=dict(
                       forward=flops / BF16_FLOPS * 1e3
                       / kernel["forward_ms"],
                       forward_backward=3 * flops / BF16_FLOPS * 1e3
                       / kernel["forward_backward_ms"]),
                   library_ms=dict(
                       forward=out["sdpa_yardstick"]["forward_ms"],
                       forward_backward=out["sdpa_yardstick"]
                       ["forward_backward_ms"]),
                   sdpa_note="F.scaled_dot_product_attention: a yardstick "
                   "timed here only (library_ms); the port never calls it")
    del results, full, grid, skip, q, k, v, cot
    torch.cuda.empty_cache()
    print(f"(z) attention at {shape}: " + ", ".join(
        f"{n} {o['forward_ms']:.2f} / {o['forward_backward_ms']:.2f} ms"
        for n, o in out.items()), flush=True)
    return summary


def events_ms(torch, fn, reps=ATTN_REPS) -> float:
    """fn's device time, CUDA events around each of ``reps`` runs after
    one warm-up (median)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_max_err(got, want) -> float:
    """max |got - want| over max |want|, in f32."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def flash_errs(got, want) -> dict:
    """got's largest error over max |want| and its relative RMS error."""
    got, want = got.float(), want.float()
    return dict(max_err_of_max=rel_max_err(got, want),
                rel_rms=((got - want).pow(2).mean().sqrt()
                         / want.pow(2).mean().sqrt()).item())


def flash_close(errs) -> bool:
    return errs["max_err_of_max"] <= FLASH_MAX_TOL \
        and errs["rel_rms"] <= FLASH_RMS_TOL


def afmoe_phase(torch, dev) -> dict:
    """(au) the afmoe kernels at the trinity-mini-train cell's shapes
    against their plain versions, timed beside their bound and a library
    call; the launches ``ops`` counted for one product and one windowed
    attention through autograd."""
    from repro_torch.kernels import ops
    ops.reset_counts()
    out = {"grouped_mm": gmm_case(torch, dev, ops),
           "windowed_flash_attention": window_case(torch, dev, ops)}
    want = {"grouped_mm.kernel": len(AFMOE_PRODUCTS),
            "flash_attention.kernel": 1}
    check(dict(ops.dispatch_counts) == want, f"(au) launches "
          f"{dict(ops.dispatch_counts)}, expected {want}")
    out["dispatch_counts"] = dict(ops.dispatch_counts)
    return out


def gmm_case(torch, dev, ops) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import grouped_mm as gm
    from repro_torch.models.layers import moe

    cfg = get_arch(AFMOE_ARCH)[0]
    m = cfg.moe
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(AFMOE_TOKENS, cfg.d_model, generator=gen, device=dev)
    router = torch.randn(cfg.d_model, m.num_experts, generator=gen,
                         device=dev) * 0.02
    _, idx = moe.route_sigmoid(x @ router, m.top_k, m.route_scale)
    _, counts = moe.sort_slots(idx, m.held)
    del x, router, idx
    rows = AFMOE_TOKENS * m.top_k
    held = int(counts.sum())
    out = dict(experts=m.held, rows=rows, held_rows=held,
               rows_an_expert=dict(min=int(counts.min()),
                                   max=int(counts.max())),
               tolerance=f"{GMM_TOL} x max|plain|", products={})
    for name, (k, n) in AFMOE_PRODUCTS.items():
        a = torch.randn(rows, k, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(m.held, k, n, generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
        dy = torch.randn(rows, n, generator=gen, device=dev).to(
            torch.bfloat16)
        wt = w.transpose(1, 2)
        calls = {"fwd": (lambda: gm.launch(a, w, counts),
                         lambda: gm.plain(a, w, counts)),
                 "dx": (lambda: gm.launch(dy, wt, counts),
                        lambda: gm.plain(dy, wt, counts)),
                 "dw": (lambda: gm.launch_dw(a, dy, counts),
                        lambda: gm.plain_dw(a, dy, counts))}
        flops = 2 * held * k * n
        part = dict(k=k, n=n, flops=flops,
                    bound_ms=flops / BF16_FLOPS * 1e3)
        for label, (kernel, plain) in calls.items():
            got = kernel()
            t0 = time.perf_counter()
            want = plain()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            err = rel_max_err(got, want)
            check(err <= GMM_TOL, f"(au) grouped_mm {name} {label}: "
                  f"{err} of max|plain| against the plain version, bound "
                  f"{GMM_TOL}")
            if label != "dw":
                check(bool((got[held:] == 0).all()), f"(au) grouped_mm "
                      f"{name} {label}: the rows past the experts' are not 0")
            ms = events_ms(torch, kernel)
            part[label] = dict(ms=ms, max_err_of_max=err, plain_ms=plain_s
                               * 1e3, share_of_bound=part["bound_ms"] / ms,
                               same_bits_twice=torch.equal(kernel(), got))
            del got, want
        check(part["dw"]["same_bits_twice"], f"(au) grouped_mm {name}: dW "
              f"changed its bits between two launches")
        # Control: the product through the next expert's weights.
        control = rel_max_err(gm.launch(a, w.roll(1, 0), counts),
                              gm.plain(a, w, counts))
        check(control > GMM_TOL, f"(au) grouped_mm {name}: the wrong "
              f"expert's weights read {control}, within the bound")
        part["wrong_expert_control_err_of_max"] = control
        part["library"] = gmm_library(torch, a, w, dy, counts)
        # One product through ops and autograd (counted once).
        leaves = [a.detach().requires_grad_(True),
                  w.detach().requires_grad_(True)]
        torch.autograd.grad(ops.grouped_mm(*leaves, counts), leaves, dy)
        out["products"][name] = part
        del a, w, wt, dy, leaves
        torch.cuda.empty_cache()
    return out


def gmm_library(torch, a, w, dy, counts) -> dict:
    """torch._grouped_mm at the same products (a yardstick the port never
    calls): its ms forward, dX and dW, or why it did not run."""
    # The call takes groups of a multiple of 8 rows (16-byte strides): each
    # expert's count rounded up, the extra rows the slots after them.
    ends = torch.cumsum((counts + 7) // 8 * 8, 0, dtype=torch.int32)
    a, dy = a[:int(ends[-1])], dy[:int(ends[-1])]
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return dict(error="torch._grouped_mm is missing")
    # The call wants each expert's B with unit stride along K.
    wk = w.transpose(1, 2).contiguous().transpose(1, 2)
    wtk = w.contiguous().transpose(1, 2)
    # dW's operands (K, rows) and (rows, N) with unit stride along the rows.
    at, dyk = a.t().contiguous(), dy.t().contiguous().t()
    out = {}
    for label, call in (("fwd_ms", lambda: fn(a, wk, offs=ends)),
                        ("dx_ms", lambda: fn(dy, wtk, offs=ends)),
                        ("dw_ms", lambda: fn(at, dyk, offs=ends))):
        try:
            out[label] = events_ms(torch, call)
        except RuntimeError as exc:
            out[label] = None
            out[label.replace("_ms", "_error")] = str(exc)[:300]
    return out


def window_case(torch, dev, ops) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    b, s, h, hd = AFMOE_ATTN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = [torch.randn(AFMOE_ATTN_SHAPE, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4)]
    win = AFMOE_WINDOW
    o, lse = fa.launch(q, k, v, window=win)
    grads = fa.launch_backward(q, k, v, o, lse, do, window=win)
    t0 = time.perf_counter()
    want_o, want_lse = fa.plain(q, k, v, window=win)
    want = fa.plain_backward(q, k, v, o, lse, do, window=win)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    errs = {"lse": (lse - want_lse).abs().max().item()}
    check(errs["lse"] <= FLASH_LSE_TOL, f"(au) windowed attention: the "
          f"log-sum-exp errs {errs['lse']}, bound {FLASH_LSE_TOL}")
    for label, got, ref in zip(("o", "dq", "dk", "dv"), (o, *grads),
                               (want_o, *want)):
        errs[label] = flash_errs(got, ref)
        check(flash_close(errs[label]), f"(au) windowed attention "
              f"{label}: {errs[label]} against the plain version, bounds "
              f"{FLASH_MAX_TOL} of max|plain|, {FLASH_RMS_TOL} relative RMS")
    # Control: the causal kernels' output (no window) against the plain
    # windowed one.
    control = flash_errs(fa.launch(q, k, v)[0], want_o)
    check(not flash_close(control), f"(au) windowed attention: the causal "
          f"output reads {control}, within the bounds")
    del want_o, want_lse, want, grads
    # The least time: 2 products forward and 5 backward over the pairs
    # the window keeps.
    pairs = sum(min(i + 1, win) for i in range(s))
    flops = 2 * b * h * pairs * hd
    fwd_ms = events_ms(torch, lambda: fa.launch(q, k, v, window=win))
    bwd_ms = events_ms(torch, lambda: fa.launch_backward(
        q, k, v, o, lse, do, window=win))
    mask = (torch.arange(s, device=dev)[:, None]
            - torch.arange(s, device=dev)[None, :])
    mask = (mask >= 0) & (mask < win)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_fwd = events_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    torch.autograd.grad(ops.flash_attention(*leaves, win), leaves, do)
    out = dict(shape=dict(batch=b, seq=s, heads=h, head_dim=hd, window=win),
               errors=errs, causal_control_err_of_max=control,
               plain_ms=plain_s * 1e3, forward_ms=fwd_ms,
               backward_ms=bwd_ms, kept_pairs=pairs,
               bound_forward_ms=2 * flops / BF16_FLOPS * 1e3,
               bound_backward_ms=5 * flops / BF16_FLOPS * 1e3,
               library_forward_ms=lib_fwd,
               library_note="F.scaled_dot_product_attention with the "
               "window as a boolean mask, forward: a yardstick the port "
               "never calls")
    out["share_of_bound"] = dict(
        forward=out["bound_forward_ms"] / fwd_ms,
        backward=out["bound_backward_ms"] / bwd_ms)
    del q, k, v, do, o, lse, mask, leaves
    torch.cuda.empty_cache()
    return out


def model_run(torch, dist, ops, train_mod, synthetic, label, argv,
              microbatches, cut=None, batch_fn=None, moe_split=False):
    """(y), (aa), (ac)-(ae), (ag) and (ah): a model through
    ``train.build`` with ``microbatches`` on the TrainConfig (and the
    ModelConfig fields in ``cut`` replaced: ``num_layers``, or
    ``num_experts`` of its MoEConfig), in the NCCL group: the steps of
    ``--steps`` on one repeated batch (the synthetic stream's first, or
    ``batch_fn(cfg)``), each timed (host clock from a sync to a sync),
    then one more step under ``torch.profiler``. Finite losses that
    fall; every attention call through the flash-attention kernel,
    whatever ``--attn-chunk`` (the layers' forwards and their remat
    recompute, each microbatch); the pool
    kernels' and the all-reduces' counts the step plan's; step ms (median
    after the first), tokens/s, peak memory, the first step's seconds,
    and the model and executed FLOP shares of the dense bf16 peak
    (``step_flops``). ``moe_split``: the profiled step also splits the
    device's time into the MoE layer's parts (``moe_parts``) and counts
    the slots each expert got and the share dropped. The attention calls
    are the attention layers' (none for ssm; the hybrid's shared block
    once a group)."""
    import dataclasses
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)
    _, cfg = train_mod.build(args)
    model, reduced = cfg.model, {}
    for field, value in (cut or {}).items():
        if field == "num_experts":
            reduced[field] = [model.moe.num_experts, value]
            model = dataclasses.replace(model, moe=dataclasses.replace(
                model.moe, num_experts=value))
        else:
            reduced[field] = [getattr(model, field), value]
            model = dataclasses.replace(model, **{field: value})
    cfg = cfg.replace(model=model, microbatches=microbatches)
    m = cfg.model
    seq = cfg.seq_len + (m.num_vision_tokens if m.family == "vlm" else 0)
    check(not cfg.causal_skip, f"{label}: causal_skip on")
    trainer = Trainer(cfg, device=args.device)
    t0 = time.perf_counter()
    # Drawn on the card from the seed: the CPU draw takes ~10 s a billion
    # parameters.
    state = trainer.init_state(params=trainer.model.init_params(
        args.seed, trainer.device, on_device=True))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = batch_fn(cfg) if batch_fn is not None else synthetic.SyntheticLM(
        m.vocab_size, seed=args.seed, num_codebooks=m.num_codebooks) \
        .batch(0, cfg.global_batch, cfg.seq_len)
    step = trainer.build_train_step()
    steps = args.steps
    losses, aux, seconds = [], [], []
    ops.reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first = MoERouting(torch) if moe_split else None
    with CountAttention() as attn, CountAllReduce(dist) as coll:
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0 and first is not None:
                # The initial weights' routing, on the untimed first step.
                with first:
                    state, metrics = step(state, batch)
            else:
                state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            aux.append(float(metrics["aux_loss"]))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            print(f"{label}: loss {losses[-1]:.4f} aux {aux[-1]:.3g} in "
                  f"{seconds[-1]:.3f} s", flush=True)
    counts = dict(ops.dispatch_counts)
    peak = torch.cuda.max_memory_allocated()

    def one_step():
        nonlocal state
        state, metrics = step(state, batch)
        float(metrics["loss"])

    routing = None
    if moe_split:
        with MoERouting(torch) as probe, ModelParts() as parts:
            profile = device_profile(torch, one_step, 1, parts=parts)
        routing = dict(first_step=first.summary(cfg.remat == "layer"),
                       profiled_step=probe.summary(cfg.remat == "layer"))
    else:
        profile = device_profile(torch, one_step, 1)
    flops = step_flops(cfg, trainer.pool)
    want = expected_counts(trainer, steps)
    want_coll = expected_collectives(trainer, steps)
    pool_elems = trainer.pool.size
    del state, step, trainer
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses + aux),
          f"{label}: non-finite loss {losses} or aux {aux}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall on one "
          f"batch: {losses}")
    check(counts == want, f"{label}: dispatch counts {counts}, expected "
          f"{want}")
    check(coll.calls == want_coll, f"{label}: {coll.calls} all-reduces, "
          f"expected {want_coll}")
    # Every attention call through the kernel, whatever attn_chunk (its
    # launches are in ``counts``, held to the plans above); none elsewhere.
    check(attn.calls == {"blockwise": 0, "full": 0}, f"{label}: attention "
          f"calls {attn.calls}")
    check((m.moe is not None) == all(a > 0 for a in aux),
          f"{label}: aux losses {aux} for family {m.family}")
    step_ms = statistics.median(seconds[1:]) * 1e3
    tokens = cfg.global_batch * cfg.seq_len
    run = dict(arch=args.arch, config="CONFIG", family=m.family,
               batch=cfg.global_batch, seq_len=cfg.seq_len,
               positions=seq, microbatches=microbatches,
               attn_chunk=cfg.attn_chunk, causal_skip=cfg.causal_skip,
               d_model=m.d_model, heads=m.num_heads, kv_heads=m.num_kv_heads,
               head_dim=m.resolved_head_dim, d_ff=m.d_ff, norm=m.norm,
               activation=m.activation, qk_norm=m.qk_norm,
               num_layers=m.num_layers, vocab=m.vocab_size,
               reduced=reduced, losses=losses, aux_losses=aux,
               step_ms=[t * 1e3 for t in seconds],
               steady_step_ms=step_ms, first_step_s=seconds[0],
               init_state_s=init_s, tokens_per_s=tokens / (step_ms / 1e3),
               peak_mem_gib=peak / 2 ** 30, dispatch_counts=counts,
               expected_counts=want, collectives=coll.calls,
               attention_calls=attn.calls, model_flops=flops["model"],
               model_flops_share_of_bf16_peak=flops["model"]
               / (step_ms / 1e3) / BF16_FLOPS,
               executed_flops=flops["executed"],
               executed_flops_share_of_bf16_peak=flops["executed"]
               / (step_ms / 1e3) / BF16_FLOPS,
               flops_note=FLOPS_NOTE, profile=profile,
               pool_elems=pool_elems)
    if m.moe is not None:
        from repro_torch.models.layers import moe
        run.update(experts=m.moe.num_experts, top_k=m.moe.top_k,
                   capacity_factor=m.moe.capacity_factor,
                   capacity_per_microbatch=moe.capacity(
                       m, cfg.global_batch // microbatches * seq),
                   dense_residual=m.moe.dense_residual, routing=routing)
    if m.family == "vlm":
        run.update(vision_tokens=m.num_vision_tokens)
    if m.family == "audio":
        run.update(codebooks=m.num_codebooks)
    if m.ssm is not None:
        from repro_torch.models.layers import mamba, mamba2
        run.update(ssm=dataclasses.asdict(m.ssm),
                   attention_layers=attention_layers(m))
        if m.family == "ssm":
            d_inner, dt_rank, _, _ = mamba.dims(m)
            run.update(d_inner=d_inner, dt_rank=dt_rank,
                       scan_chunk=mamba.SCAN_CHUNK)
        else:
            d_inner, heads, _, _, _ = mamba2.dims(m)
            run.update(d_inner=d_inner, ssd_heads=heads,
                       scan_chunk=mamba.SCAN_CHUNK,
                       hybrid_attn_every=m.hybrid_attn_every)
    return run


def microbatch_window_run(torch, ops, train_mod, synthetic, label, argv,
                          guard=None, faults=(), microbatches=2):
    """(ab) smollm-135m lazy at microbatches 2, and (af) grok1-smoke lazy
    at ``microbatches`` 1 (the argv's model, batch and sequence): MB_K
    eager steps, then a window of MB_K as a CUDA graph from the same seed
    on the same batches: the same losses and final parameters and
    momentum, bit for bit, and the capture's launches the plan's x MB_K.
    Guarded, the ``faults`` fire through the device-step hook in both;
    exactly the faulted steps trip, and an in-graph digest shows each
    skip bit-identical. The eager steps and one replayed window timed."""
    import dataclasses
    from repro_torch.launch.trainer import Trainer, is_flushed
    from repro_torch.runtime.faults import make_hook

    args = train_mod.parse_args(argv)
    _, cfg = train_mod.build(args)
    cfg = cfg.replace(microbatches=microbatches,
                      gradientflow=dataclasses.replace(cfg.gradientflow,
                                                       guard=guard))
    data = synthetic.SyntheticLM(cfg.model.vocab_size, seed=args.seed,
                                 num_codebooks=cfg.model.num_codebooks)
    batches = [data.batch(s, cfg.global_batch, cfg.seq_len)
               for s in range(2 * MB_K)]
    hook = make_hook(fault_events(faults)) if faults else None
    trainer = Trainer(cfg, device=args.device)
    state = trainer.init_state(args.seed)
    step = trainer.build_train_step(fault_hook=hook)
    eager, eager_ms, eager_tripped = [], [], []
    ops.reset_counts()
    for s in range(MB_K):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[s])
        eager.append(float(m["loss"]))
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        if guard is not None:
            eager_tripped.append(float(m["guard_tripped"]))
    eager_counts = dict(ops.dispatch_counts)
    want_eager = expected_counts(trainer, MB_K)
    twin = flat_state(torch, trainer, state)
    del state, step, trainer
    torch.cuda.empty_cache()

    trainer = Trainer(cfg, device=args.device)
    state = trainer.init_state(args.seed)
    live = trainer.pool.flat_leaves(state.params) + [state.opt.momentum]
    digests = []

    def probed(gpool, step_t):
        digests.append(torch.stack([x.view(torch.int32).sum(
            dtype=torch.int64) for x in live]))
        return hook(gpool, step_t) if hook is not None else gpool

    window = trainer.build_train_window(MB_K, fault_hook=probed)
    ops.reset_counts()
    state, m = window(state, stacked(torch, batches[:MB_K]))
    losses = m["loss"].tolist()
    tripped = m["guard_tripped"].tolist() if guard is not None else None
    after = torch.stack([x.view(torch.int32).sum(dtype=torch.int64)
                         for x in live])
    d = torch.stack(digests[-MB_K:] + [after]).cpu()
    final = flat_state(torch, trainer, state)
    flushed = is_flushed(state)
    stats = dict(window.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = window(state, stacked(torch, batches[MB_K:]))
    m["loss"].tolist()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) * 1e3
    plan = trainer.engine.plan_for()
    window.release()
    del state, window, trainer, live, digests
    torch.cuda.empty_cache()
    at = {f[0] for f in faults}
    frozen = [bool(torch.equal(d[t + 1], d[t])) for t in sorted(at)]
    moved = [not torch.equal(d[t + 1], d[t]) for t in range(MB_K)
             if t not in at]
    print(f"{label}: eager {eager}, window {losses}, tripped {tripped}",
          flush=True)
    check(all(math.isfinite(x) for t, x in enumerate(eager) if t not in at),
          f"{label}: non-finite loss {eager}")
    check(eager_counts == want_eager, f"{label}: eager dispatch counts "
          f"{eager_counts}, expected {want_eager}")
    same = losses == eager and bits_equal(torch, final, twin)
    check(same, f"{label}: the graphed window != the eager steps (losses "
          f"{losses} vs {eager}, largest state difference "
          f"{(final - twin).abs().max().item()})")
    check(flushed, f"{label}: the returned state carries a live lane")
    want = window_counts(plan, MB_K, cfg)
    check(stats.get("capture_counts") == want, f"{label}: the capture "
          f"launched {stats.get('capture_counts')}, the plan says {want}")
    if guard is not None:
        want_trips = [float(t in at) for t in range(MB_K)]
        check(tripped == want_trips and eager_tripped == want_trips,
              f"{label}: tripped {tripped} (eager {eager_tripped}), "
              f"faults at {sorted(at)}")
        check(all(frozen) and all(moved), f"{label}: a tripped step moved "
              f"the state ({frozen}) or a clean one did not ({moved})")
    return dict(arch=args.arch, config="SMOKE" if args.reduced else
                "CONFIG", batch=cfg.global_batch, seq_len=cfg.seq_len,
                microbatches=microbatches, losses=losses, eager_losses=eager,
                tripped=tripped, faults=[list(f) for f in faults],
                trips_bit_identical=frozen, clean_steps_moved=moved,
                same_bits_as_eager=same, eager_step_ms=eager_ms,
                eager_steady_step_ms=statistics.median(eager_ms[1:]),
                replayed_window_step_ms=replay_ms / MB_K,
                capture_counts=stats.get("capture_counts"),
                expected_capture_counts=want, warmup_s=stats["warmup_s"],
                capture_s=stats["capture_s"], dispatch_counts=eager_counts,
                window_steps=MB_K)


def long_sequence_phase(torch, dist, ops, train_mod, synthetic, pool_mod,
                        kpack, kunpack, dev, rate):
    """(y), (aa) and (ab) in one world-size-1 NCCL group, after the
    pool kernels at olmo-1b's pool. Returns (runs, pack parts, update
    parts)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    shapes = build_model(get_arch("olmo-1b")[0]).param_shapes()
    pack, update = olmo_pool_kernel_parts(torch, pool_mod, kpack, kunpack,
                                          shapes, dev, rate)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    runs = {}
    try:
        run = model_run(torch, dist, ops, train_mod, synthetic,
                        "(y) olmo-1b, 16 x 4096, lazy", OLMO_ARGV,
                        OLMO_MICROBATCHES)
        check(run["pool_elems"] == OLMO_POOL and run["batch"] == OLMO_BATCH
              and run["seq_len"] == OLMO_SEQ, f"(y): pool "
              f"{run['pool_elems']}, {run['batch']} x {run['seq_len']}")
        runs["olmo_1b_lazy_4k_microbatches"] = run
        for arch in WIDE_ARCHS:
            runs[f"{arch}_2_layers_lazy_4k_microbatches"] = model_run(
                torch, dist, ops, train_mod, synthetic,
                f"(aa) {arch} at full width, {WIDE_LAYERS} layers, "
                f"{WIDE_BATCH} x {OLMO_SEQ}, lazy", wide_argv(arch),
                WIDE_MICROBATCHES, cut={"num_layers": WIDE_LAYERS})
        for arch in SMOKE_ARCHS:
            name = get_arch(arch)[0].name
            with CountAttention() as attn:
                run = train_run(torch, ops, train_mod, synthetic,
                                f"(aa) {name} smoke, csc, flash attention",
                                ["--arch", arch] + SMOKE_ARGV, SMOKE_STEPS)
            got = run["dispatch_counts"]
            check(got.get("chunk_l1norm.kernel", 0) > 0
                  and got.get("csc_compact.kernel", 0) > 0,
                  f"(aa) {arch}: CSC kernels {got}")
            # Every attention call through the kernel: its launches are
            # in the counts train_run held to the plans; none elsewhere.
            check(attn.calls == {"blockwise": 0, "full": 0},
                  f"(aa) {arch}: attention calls {attn.calls}")
            run.update(arch=arch, config="SMOKE", attention_calls=attn.calls)
            runs[f"{arch}_smoke_csc_flash_attention"] = run
        runs["mb2_lazy_window"] = microbatch_window_run(
            torch, ops, train_mod, synthetic,
            "(ab) smollm-135m lazy, microbatches 2, window", LAZY_ARGV)
        from repro_torch.configs.base import GuardConfig
        runs["mb2_guarded_lazy_window"] = microbatch_window_run(
            torch, ops, train_mod, synthetic,
            "(ab) smollm-135m guarded lazy, microbatches 2, window",
            LAZY_ARGV, guard=GuardConfig(), faults=MB_FAULTS)
        run = train_run(
            torch, ops, train_mod, synthetic,
            "(ab) int8 lazy, no error feedback, microbatches 2",
            LAZY_ARGV + ["--chunk-elems", str(CHUNK), "--wire-format",
                         "int8", "--no-error-feedback"], LAZY_STEPS,
            microbatches=2, repeat=REPEAT_STEPS)
        run.update(arch="smollm-135m", batch=BATCH, seq_len=SEQ)
        runs["mb2_int8_lazy_no_feedback"] = run
    finally:
        dist.destroy_process_group()
    return runs, pack, update


# -- the MoE, vlm and audio families ----------------------------------------

# (ac) arctic-480b at its published widths (d_model 7168, 56 / 8 heads of
# 128, expert d_ff 4864, the dense residual MLP 4864, vocab 32000, top-2,
# capacity factor 1.25), its depth cut to 1 layer and its experts to 16
# of 128 (2,354,451,456 parameters; all 128 experts at one layer hold
# 14.07 G, ~210 GiB of state), 2 x 4096 tokens in 2 microbatches (640
# slots an expert a microbatch), blockwise attention beyond 1024 tokens.
# grok-1-314b is not run at its published widths: one layer with its 8
# experts holds 6.53 G parameters (~97 GiB of state).
FAM_STEPS = 2
ARCTIC_ARGV = ["--arch", "arctic-480b", "--seq-len", str(OLMO_SEQ),
               "--batch", str(WIDE_BATCH), "--attn-chunk", str(OLMO_CHUNK),
               "--gf-mode", "lazy", "--use-kernels", "--window-steps", "1",
               "--log-every", "1", "--steps", str(FAM_STEPS)]
ARCTIC_CUT = {"num_layers": 1, "num_experts": 16}
ARCTIC_POOL, ARCTIC_CAP = 2_354_451_456, 640
# (ad) internvl2-26b at its published widths (d_model 6144, 48 / 8 heads,
# d_ff 16384, vocab 92672), 2 layers (1,918,924,800 parameters): 2
# sequences of 256 vision + 4096 text positions in 2 microbatches from
# ``models.registry.make_batch``, blockwise beyond 1024 (4352 positions
# in blocks of 544, ``_pick_chunk``'s choice and the JAX package's).
VLM_ARGV = ["--arch", "internvl2-26b", "--seq-len", str(OLMO_SEQ),
            "--batch", str(WIDE_BATCH), "--attn-chunk", str(OLMO_CHUNK),
            "--gf-mode", "lazy", "--use-kernels", "--window-steps", "1",
            "--log-every", "1", "--steps", str(FAM_STEPS)]
VLM_LAYERS, VLM_POOL, VLM_BLOCK = 2, 1_918_924_800, 544
# (ae) musicgen-large whole (48 layers, d_model 2048, 32 heads, GELU,
# LayerNorm, 4 codebooks of 2048; 2,454,065,152 parameters): 8 x 1500
# frames (30 s at EnCodec's 50 Hz, arXiv:2306.05284) in 2 microbatches,
# full attention.
AUDIO_ARGV = ["--arch", "musicgen-large", "--seq-len", "1500", "--batch",
              "8", "--gf-mode", "lazy", "--use-kernels", "--window-steps",
              "1", "--log-every", "1", "--steps", str(FAM_STEPS)]
AUDIO_POOL = 2_454_065_152
# (af): the smoke configurations in CSC ((aa)'s settings), the vlm's
# through the Trainer on make_batch batches; grok1-smoke lazy in a graphed
# window of MB_K against MB_K eager steps, and guarded with a NaN at 2.
FAMILY_SMOKE_CLI = ("grok-1-314b", "arctic-480b", "musicgen-large")
MOE_WINDOW_ARGV = ["--arch", "grok-1-314b", "--reduced", "--use-kernels",
                   "--gf-mode", "lazy", "--batch", "8", "--seq-len", "256",
                   "--window-steps", "1", "--log-every", "1"]
# Inside grok1-smoke's 935,552-element pool (MB_FAULTS' offset is past it).
MOE_FAULTS = ((2, "nan", 100_000, GUARD_WIDTH),)
# The MoE layer on the card against its CPU run, f32 (TF32 off): the
# routing and the dropped slots equal, outputs and aux within MOE_TOL of
# the largest |value| (the products' sums run in other orders).
MOE_TOL = 1e-5


def vlm_batch_fn(torch, seed):
    """``fn(cfg, step)``: ``models.registry.make_batch``'s batch for step
    ``step`` of a train cell of cfg's shape (a generator seeded with
    (seed, step))."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import registry

    def fn(cfg, step):
        gen = torch.Generator().manual_seed(seed * 1_000_003 + step)
        return registry.make_batch(cfg.model, ShapeConfig(
            seq_len=cfg.seq_len, global_batch=cfg.global_batch),
            cfg.global_batch, gen)
    return fn


def moe_layer_check(torch, dev) -> dict:
    """The MoE layer at grok1- and arctic-smoke's widths, f32, on the card
    and on the CPU from the same weights and tokens, with planted ties
    (zero tokens: every expert ties; two equal router columns): the
    expert indices and the kept slots equal, the outputs and aux within
    MOE_TOL of the largest value; some slots drop (capacity factor 0.5)."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models.layers import moe

    out = {}
    for arch in ("grok-1-314b", "arctic-480b"):
        cfg = get_smoke(arch)[0]
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
        gen = torch.Generator().manual_seed(11)
        shapes = moe.spec(cfg)

        def draw(tree):
            return {k: draw(v) if isinstance(v, dict)
                    else v.init(gen, v.shape) for k, v in tree.items()}
        params = draw(shapes)
        params["router"][:, 1] = params["router"][:, 0]
        x = torch.randn((4, 256, cfg.d_model), generator=gen)
        x.view(-1, cfg.d_model)[::7] = 0.0
        res = {}
        for where in ("cpu", dev):
            p = {k: ({j: w.to(where) for j, w in v.items()}
                     if isinstance(v, dict) else v.to(where))
                 for k, v in params.items()}
            xt = x.to(where).reshape(-1, cfg.d_model)
            gates, idx, aux = moe.gate(p, xt, cfg)
            _, kept = moe.slots(idx, cfg.moe.num_experts,
                                moe.capacity(cfg, xt.shape[0]))
            y, aux2 = moe.apply(p, x.to(where), cfg)
            res[str(where)] = [t.cpu() for t in (idx, kept, y, aux2)]
        (i0, k0, y0, a0), (i1, k1, y1, a1) = res["cpu"], res[str(dev)]
        err = (y1 - y0).abs().max().item()
        top = y0.abs().max().item()
        out[arch] = dict(routing_equal=bool(torch.equal(i0, i1)),
                         kept_equal=bool(torch.equal(k0, k1)),
                         dropped=int((~k0).sum()), max_abs_err=err,
                         max_abs=top, aux_cpu=float(a0), aux_card=float(a1))
        check(out[arch]["routing_equal"] and out[arch]["kept_equal"]
              and out[arch]["dropped"] > 0,
              f"the MoE layer ({arch}) on the card routed otherwise than "
              f"on the CPU: {out[arch]}")
        check(err <= MOE_TOL * top and abs(float(a1) - float(a0))
              <= MOE_TOL * abs(float(a0)),
              f"the MoE layer ({arch}) on the card != its CPU run: "
              f"{out[arch]}")
    return out


def families_phase(torch, dist, ops, train_mod, synthetic, dev):
    """(ac)-(af) in a new world-size-1 NCCL group, after the MoE layer's
    card-against-CPU check. Returns (runs, the check's findings)."""
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import GuardConfig
    from repro_torch.models.layers import attention

    layer = moe_layer_check(torch, dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    runs = {}
    try:
        run = model_run(torch, dist, ops, train_mod, synthetic,
                        "(ac) arctic-480b, 1 layer, 16 experts, 2 x 4096",
                        ARCTIC_ARGV, WIDE_MICROBATCHES, cut=ARCTIC_CUT,
                        moe_split=True)
        check(run["pool_elems"] == ARCTIC_POOL
              and run["capacity_per_microbatch"] == ARCTIC_CAP,
              f"(ac): pool {run['pool_elems']}, capacity "
              f"{run['capacity_per_microbatch']}")
        runs["arctic_480b_1_layer_16_experts_lazy_4k_microbatches"] = run
        run = model_run(torch, dist, ops, train_mod, synthetic,
                        "(ad) internvl2-26b, 2 layers, 2 x (256 + 4096)",
                        VLM_ARGV, WIDE_MICROBATCHES,
                        cut={"num_layers": VLM_LAYERS},
                        batch_fn=lambda cfg: vlm_batch_fn(torch, 0)(cfg, 0))
        block = attention._pick_chunk(run["positions"], OLMO_CHUNK)
        check(run["pool_elems"] == VLM_POOL and block == VLM_BLOCK,
              f"(ad): pool {run['pool_elems']}, attention block {block}")
        run["attn_block"] = block
        runs["internvl2_26b_2_layers_lazy_4k_microbatches"] = run
        run = model_run(torch, dist, ops, train_mod, synthetic,
                        "(ae) musicgen-large, 8 x 1500 frames", AUDIO_ARGV,
                        WIDE_MICROBATCHES)
        check(run["pool_elems"] == AUDIO_POOL and not run["reduced"],
              f"(ae): pool {run['pool_elems']}, cut {run['reduced']}")
        runs["musicgen_large_lazy_1500_microbatches"] = run
        for arch in FAMILY_SMOKE_CLI + ("internvl2-26b",):
            name = get_smoke(arch)[0].name
            vlm = arch == "internvl2-26b"
            run = train_run(torch, ops, train_mod, synthetic,
                            f"(af) {name}, csc"
                            + (", Trainer, make_batch" if vlm else ", CLI"),
                            ["--arch", arch] + SMOKE_ARGV, SMOKE_STEPS,
                            batch_fn=vlm_batch_fn(torch, 0) if vlm else None)
            got = run["dispatch_counts"]
            check(got.get("chunk_l1norm.kernel", 0) > 0
                  and got.get("csc_compact.kernel", 0) > 0,
                  f"(af) {arch}: CSC kernels {got}")
            run.update(arch=arch, config="SMOKE",
                       through="Trainer" if vlm else "CLI")
            runs[f"{arch}_smoke_csc"] = run
        runs["moe_smoke_lazy_window"] = microbatch_window_run(
            torch, ops, train_mod, synthetic,
            "(af) grok1-smoke lazy, window", MOE_WINDOW_ARGV
            + ["--steps", str(MB_K)], microbatches=1)
        runs["moe_smoke_guarded_lazy_window"] = microbatch_window_run(
            torch, ops, train_mod, synthetic,
            "(af) grok1-smoke guarded lazy, window", MOE_WINDOW_ARGV
            + ["--steps", str(MB_K)], guard=GuardConfig(), faults=MOE_FAULTS,
            microbatches=1)
    finally:
        dist.destroy_process_group()
    return runs, layer


# -- the ssm and hybrid families --------------------------------------------

# (ag) falcon-mamba-7b at its published widths (d_model 4096, d_inner 8192,
# d_state 16, dt_rank 256, d_conv 4, vocab 65024, untied head), cut to 4 of
# its 64 layers (953,929,728 parameters; the whole model's 7.27 G hold
# ~116 GB of state): 2 x 4096 tokens in 2 microbatches, remat per layer.
MAMBA_ARGV = ["--arch", "falcon-mamba-7b", "--seq-len", str(OLMO_SEQ),
              "--batch", str(WIDE_BATCH), "--gf-mode", "lazy",
              "--use-kernels", "--window-steps", "1", "--log-every", "1",
              "--steps", str(FAM_STEPS)]
MAMBA_LAYERS, MAMBA_POOL = 4, 953_929_728
# (ah) zamba2-2.7b whole (54 Mamba-2 layers in 9 groups of 6, d_model
# 2560, d_inner 5120, 80 SSD heads of 64, d_state 64, the shared block's
# 32 heads and d_ff 10240, vocab 32000; 2,422,670,240 parameters): 2 x
# 4096 tokens in 2 microbatches, full attention in the shared block.
ZAMBA_ARGV = ["--arch", "zamba2-2.7b", "--seq-len", str(OLMO_SEQ),
              "--batch", str(WIDE_BATCH), "--gf-mode", "lazy",
              "--use-kernels", "--window-steps", "1", "--log-every", "1",
              "--steps", str(FAM_STEPS)]
ZAMBA_POOL = 2_422_670_240
# (ai): the smoke configurations through the CLI, lazy (2 steps) and CSC
# ((aa)'s settings, 3 steps) on 256 positions (two 128-position chunks),
# then 3 steps on one repeated batch each; zamba2-smoke lazy in a graphed
# window of MB_K against MB_K eager steps.
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-2.7b")
SSM_SMOKE_ARGV = ["--reduced", "--use-kernels", "--batch", "8", "--seq-len",
                  "256", "--chunk-elems", "2048", "--bucket-elems", "65536",
                  "--sparsity", "0.5", "--csc-warmup", "2", "--window-steps",
                  "1", "--log-every", "1"]
SSM_SMOKE_STEPS = {"lazy": 2, "csc": 3}
SSM_REPEAT = 3
ZAMBA_WINDOW_ARGV = ["--arch", "zamba2-2.7b", "--reduced", "--use-kernels",
                     "--gf-mode", "lazy", "--batch", "8", "--seq-len", "256",
                     "--window-steps", "1", "--log-every", "1", "--steps",
                     str(MB_K)]
# The two layers on the card against their CPU run, bf16, smoke widths,
# 2 x 256 positions (two chunks): the output and every gradient within
# SSM_TOL of the tensor's largest |value| (4 bf16 ulps at the top of the
# range; the CPU tests hold the CPU run against JAX's within the same).
SSM_TOL = 2.0 ** -5


def ssm_layer_check(torch, dev) -> dict:
    """``mamba.apply_train`` (falcon-mamba-smoke) and
    ``mamba2.apply_train`` (zamba2-smoke) in bf16 on the card and on the
    CPU, from the same weights, input and output gradient: the output
    and the gradients of every parameter and of x within SSM_TOL."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.layers import mamba, mamba2

    out = {}
    for arch, mod in zip(SSM_ARCHS, (mamba, mamba2)):
        cfg = get_smoke(arch)[0]
        gen = torch.Generator().manual_seed(13)
        params = {k: s.init(gen, s.shape) for k, s in mod.spec(cfg).items()}
        x = torch.randn((2, 2 * mamba.SCAN_CHUNK, cfg.d_model),
                        generator=gen)
        ct = torch.randn(x.shape, generator=gen)
        res = {}
        for where in ("cpu", dev):
            p = {k: v.to(where, torch.bfloat16).requires_grad_(True)
                 for k, v in params.items()}
            xt = x.to(where, torch.bfloat16).requires_grad_(True)
            y = mod.apply_train(p, xt, cfg)
            grads = torch.autograd.grad(y, list(p.values()) + [xt],
                                        ct.to(where, torch.bfloat16))
            res[str(where)] = [t.detach().float().cpu() for t in (y, *grads)]
        errs = {}
        for name, a, b in zip(["out", *params, "x"], res["cpu"],
                              res[str(dev)]):
            errs[name] = dict(max_abs_err=(b - a).abs().max().item(),
                              max_abs=a.abs().max().item())
        out[arch] = dict(layer=mod.__name__.rsplit(".", 1)[-1],
                         dtype="bfloat16", shape=list(x.shape),
                         chunks=x.shape[1] // mamba.SCAN_CHUNK, tol=SSM_TOL,
                         tensors=errs)
        bad = [n for n, e in errs.items()
               if not e["max_abs_err"] <= SSM_TOL * e["max_abs"]]
        check(not bad, f"the {arch} layer on the card != its CPU run in "
              f"bf16 at {bad}: {errs}")
    return out


def ssm_core_times(torch, dev, rate) -> dict:
    """The two state-space cores alone, in the port's PyTorch ops, on one
    row of 4096 positions in chunks of 128: Mamba-1's selective scan
    (``mamba._scan_chunk``, the chunk loop) at (ag)'s layer widths and
    Mamba-2's SSD (``mamba2._ssd_chunk``) at (ah)'s, f32, forward and
    forward + backward (CUDA events, median of REPS after WARMUP), against
    the bound of the function: the inputs read once and the output
    written once at the card's memory rate, or the operations the
    recurrence needs (the scan: 7 an (position, channel, state); the SSD:
    its products over the causal half, as ``step_flops``'s model count) at
    67 TFLOP/s f32, whichever is longer; forward + backward: 3x the
    operations and 2x the bytes. The SSD runs as ``apply_train`` runs it
    (``mamba2._ssd_chunks``: every chunk's products at once)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import mamba, mamba2

    gen = torch.Generator(device=dev).manual_seed(5)
    n, f32 = OLMO_SEQ, torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)

    def timed(inputs, run, nbytes, flops):
        grad_out = None

        def fwd():
            with torch.no_grad():
                run()

        def fwd_bwd():
            nonlocal grad_out
            y = run()
            if grad_out is None:
                grad_out = torch.randn_like(y)
            torch.autograd.grad(y, inputs, grad_out)

        fwd_bound, by = bound_ms(nbytes, flops, rate)
        both_bound, both_by = bound_ms(2 * nbytes, 3 * flops, rate)
        return dict(forward_ms=time_ms(torch, fwd), forward_bound_ms=fwd_bound,
                    forward_bound_by=by,
                    forward_backward_ms=time_ms(torch, fwd_bwd),
                    forward_backward_bound_ms=both_bound,
                    forward_backward_bound_by=both_by)

    cfg = get_arch("falcon-mamba-7b")[0]
    di, _, ds, _ = mamba.dims(cfg)
    q = mamba.SCAN_CHUNK
    x, b, c = randn(1, n, di), randn(1, n, ds), randn(1, n, ds)
    delta = mamba.softplus(randn(1, n, di) - 4.6)
    a = -torch.arange(1, ds + 1, device=dev, dtype=f32).expand(di, ds)
    scan_in = [t.requires_grad_(True) for t in (x, delta, b, c)]

    def scan():
        h, ys = torch.zeros((1, di, ds), device=dev), []
        for k in range(n // q):
            s = slice(k * q, (k + 1) * q)
            y, h = mamba._scan_chunk(x[:, s], delta[:, s], b[:, s], c[:, s],
                                     a, h)
            ys.append(y)
        return torch.cat(ys, dim=1)

    out = {"selective_scan": dict(
        shape=dict(batch=1, positions=n, chunk=q, d_inner=di, d_state=ds),
        **timed(scan_in, scan, 4 * (3 * n * di + 2 * n * ds + di * ds),
                7 * n * di * ds))}

    cfg = get_arch("zamba2-2.7b")[0]
    di, h, hd, ds, _ = mamba2.dims(cfg)
    xh, b, c = randn(1, n // q, q, h, hd), randn(1, n // q, q, ds), \
        randn(1, n // q, q, ds)
    loga = -mamba.softplus(randn(1, n // q, q, h) - 4.6)
    ssd_in = [t.requires_grad_(True) for t in (xh, b, c, loga)]

    def ssd():
        return mamba2._ssd_chunks(xh, b, c, loga)

    out["ssd"] = dict(
        shape=dict(batch=1, positions=n, chunk=q, heads=h, head_dim=hd,
                   d_state=ds),
        **timed(ssd_in, ssd, 4 * (2 * n * di + 2 * n * ds + n * h),
                n * (q * (ds + di) + 4 * di * ds)))
    return out


def ssm_phase(torch, dist, ops, train_mod, synthetic, dev, rate):
    """(ag)-(ai) in a new world-size-1 NCCL group, after the two layers'
    card-against-CPU check and the cores' timings. Returns (runs, the
    check's findings, the timings)."""
    from repro_torch.configs import get_smoke

    layer = ssm_layer_check(torch, dev)
    cores = ssm_core_times(torch, dev, rate)
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    runs = {}
    try:
        run = model_run(torch, dist, ops, train_mod, synthetic,
                        "(ag) falcon-mamba-7b, 4 layers, 2 x 4096",
                        MAMBA_ARGV, WIDE_MICROBATCHES,
                        cut={"num_layers": MAMBA_LAYERS})
        check(run["pool_elems"] == MAMBA_POOL, f"(ag): pool "
              f"{run['pool_elems']}")
        runs["falcon_mamba_7b_4_layers_lazy_4k_microbatches"] = run
        run = model_run(torch, dist, ops, train_mod, synthetic,
                        "(ah) zamba2-2.7b, 2 x 4096", ZAMBA_ARGV,
                        WIDE_MICROBATCHES)
        check(run["pool_elems"] == ZAMBA_POOL and not run["reduced"],
              f"(ah): pool {run['pool_elems']}, cut {run['reduced']}")
        runs["zamba2_2_7b_lazy_4k_microbatches"] = run
        for arch in SSM_ARCHS:
            name = get_smoke(arch)[0].name
            for mode, steps in SSM_SMOKE_STEPS.items():
                run = train_run(torch, ops, train_mod, synthetic,
                                f"(ai) {name}, {mode}, CLI",
                                ["--arch", arch, "--gf-mode", mode, "--steps",
                                 str(steps)] + SSM_SMOKE_ARGV, steps,
                                repeat=SSM_REPEAT)
                got = run["dispatch_counts"]
                check(mode != "csc" or (got.get("chunk_l1norm.kernel", 0) > 0
                                        and got.get("csc_compact.kernel", 0)
                                        > 0),
                      f"(ai) {arch}: CSC kernels {got}")
                run.update(arch=arch, config="SMOKE", through="CLI")
                runs[f"{arch}_smoke_{mode}"] = run
        runs["zamba2_smoke_lazy_window"] = microbatch_window_run(
            torch, ops, train_mod, synthetic,
            "(ai) zamba2-smoke lazy, window", ZAMBA_WINDOW_ARGV,
            microbatches=1)
    finally:
        dist.destroy_process_group()
    return runs, layer, cores


# -- serving (after every training phase) -----------------------------------

# (aj): the serve CLI (``launch.serve.main``) in this process: smollm-135m
# at full size, then the six smoke families (internvl2 text only, as the
# CLI serves it).
SERVE_FULL_ARGV = ["--arch", "smollm-135m", "--batch", "8", "--prompt-len",
                   "1024", "--gen", "32"]
SERVE_SMOKE_ARCHS = ("smollm-135m", "grok-1-314b", "internvl2-26b",
                     "musicgen-large", "falcon-mamba-7b", "zamba2-2.7b")
SERVE_SMOKE_ARGV = ["--reduced", "--batch", "2", "--prompt-len", "16",
                    "--gen", "4"]
# (ak): smollm-135m at full size. decode_32k's cache of 32,768 positions
# with its batch cut from 128 to 64 rows (128 rows are a 96.6 GB cache),
# filled by a 64 x 512 prefill; prefill_32k's length with its batch cut
# from 32 to 1 (time), after a 1 x 2048 warm-up.
DECODE_LEN, DECODE_BATCH, DECODE_PROMPT = 32768, 64, 512
PREFILL_WARMUP = 2048
DECODE_UNTIMED, DECODE_TIMED = 2, 8
# (al) falcon-mamba-7b whole (64 layers) and (am) zamba2-2.7b whole at
# long_500k's cache (1 x 524,288 positions): a 1 x 1024 prefill, then
# decode steps, the first DECODE_UNTIMED untimed.
LONG_LEN = 524288
SSM_SERVE_PROMPT = 1024
MAMBA_SERVE_STEPS, ZAMBA_SERVE_STEPS = 32, 16
# Every smoke family's prefill and SERVE_CHECK_STEPS teacher-forced decode
# steps in f32 (TF32 off) on the card against the same run on the CPU:
# each call's logits within SERVE_F32_TOL of the CPU's largest |logit|.
SERVE_F32_TOL = 1e-4
SERVE_CHECK_STEPS = 4
# smollm-135m at full size in bf16: the decode of TEACHER_POSITIONS
# prompt tokens one at a time against the prefill's logits, and (ak)'s two
# decode forms against each other from one state, within SERVE_BF16_TOL
# of the largest |logit|. Measured on the CPU first (2 x 16 positions, two
# seeds, both forms): the decode 0.0125-0.0204 of the largest |logit| from
# the prefill. The bound is 2^-4, three times the largest.
SERVE_BF16_TOL = 2.0 ** -4
TEACHER_POSITIONS = 16


def tree_to(tree, dev):
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def tree_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in tree_leaves(tree))


def cache_bytes(torch, abstract) -> int:
    """Bytes of a serving cache from its (shape, dtype) pairs."""
    if hasattr(abstract, "_fields"):
        return sum(cache_bytes(torch, f) for f in abstract)
    shape, dtype = abstract
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def serve_steps(torch, dev, cfg, batch, max_len):
    """A Trainer's serving steps (``build_serve_step``): prefill, decode,
    decode with ``split_combine``."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch.trainer import Trainer

    trainer = Trainer(TrainConfig(model=cfg, global_batch=batch,
                                  seq_len=max_len), device=dev)
    sc = ShapeConfig(name="serve", seq_len=max_len, global_batch=batch,
                     kind="decode")
    return (trainer.model,
            trainer.build_serve_step(sc, mode="prefill")[0],
            trainer.build_serve_step(sc, mode="decode")[0],
            trainer.build_serve_step(sc, mode="decode",
                                     split_combine=True)[0])


def timed_call(torch, fn):
    """(fn(), its ms on the host clock from an idle device to the end of
    its device work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def decode_steps(torch, step, params, cache, nxt, untimed, timed):
    """Greedy decode steps, ``untimed`` then ``timed`` (``timed_call``
    each, the argmax included). Returns (the timed steps' ms, cache, the
    next tokens, the last logits)."""
    from repro_torch.launch.serve import greedy

    ms, logits = [], None
    for i in range(untimed + timed):
        (logits, cache), t = timed_call(
            torch, lambda: step(params, {"tokens": nxt}, cache))
        nxt = greedy(logits)
        if i >= untimed:
            ms.append(t)
    return ms, cache, nxt, logits


def no_host_sync(torch, label, fn):
    """``fn()`` (one decode step) under ``set_sync_debug_mode('error')``:
    a host synchronisation inside it fails the run."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    except RuntimeError as e:
        fail(f"{label}: a decode step synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)


def decode_summary(ms, batch, nbytes, rate) -> dict:
    step = statistics.median(ms)
    bound = nbytes / rate * 1e3
    return dict(decode_step_ms=ms, decode_median_ms=step,
                decode_tokens_per_s=batch / (step / 1e3),
                decode_bytes=nbytes, decode_bound_ms=bound,
                decode_bound_by="bytes", decode_bound_share=bound / step)


def serve_card_vs_cpu(torch, dev) -> dict:
    """Every smoke family's prefill of 2 x 16 and SERVE_CHECK_STEPS decode
    steps (teacher-forced), f32 weights, compute and cache, on the card
    and on the CPU: each call's logits within SERVE_F32_TOL."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    out, n = {}, 16
    for arch in SERVE_SMOKE_ARCHS:
        cfg = dataclasses.replace(get_smoke(arch)[0], compute_dtype="float32")
        model = build_model(cfg)
        params = model.init_params(21, torch.device("cpu"))
        gen = torch.Generator().manual_seed(22)
        shape = (2, n + SERVE_CHECK_STEPS) + (
            (cfg.num_codebooks,) if cfg.family == "audio" else ())
        toks = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             dtype=torch.int32)
        res = {}
        for where in (torch.device("cpu"), dev):
            p = tree_to(params, where)
            cache = model.init_cache(2, n + SERVE_CHECK_STEPS,
                                     torch.float32, where)
            kw = dict(compute_dtype=torch.float32)
            lg, cache = model.serve_step(p, {"tokens": toks[:, :n].to(where)},
                                         cache, mode="prefill", **kw)
            calls = [lg.cpu()]
            for t in range(n, n + SERVE_CHECK_STEPS):
                lg, cache = model.serve_step(
                    p, {"tokens": toks[:, t:t + 1].to(where)}, cache,
                    mode="decode", **kw)
                calls.append(lg.cpu())
            res[where.type] = calls
        errs = [rel_err(g, w) for g, w in zip(res["cuda"], res["cpu"])]
        out[arch] = dict(family=cfg.family, prefill=[2, n],
                         decode_steps=SERVE_CHECK_STEPS,
                         max_rel_err_per_call=errs, tol=SERVE_F32_TOL)
        check(max(errs) <= SERVE_F32_TOL, f"serving, {arch} smoke: the "
              f"card's logits != the CPU's in f32: {errs}")
    return out


def serve_cli_runs(torch, serve, dev) -> dict:
    """(aj): the CLI at full size (smollm-135m) and on the six smoke
    families: its rates, peak memory and cache bytes; the tokens of their
    shape and in [0, vocab)."""
    from repro_torch.configs import get_arch, get_smoke
    from repro_torch.models import build_model

    cases = [("smollm-135m", SERVE_FULL_ARGV, get_arch("smollm-135m")[0])]
    cases += [(f"{arch} smoke", ["--arch", arch] + SERVE_SMOKE_ARGV,
               get_smoke(arch)[0]) for arch in SERVE_SMOKE_ARCHS]
    runs = {}
    for label, argv, cfg in cases:
        argv = argv + ["--device", str(dev)]
        args = serve.parse_args(argv)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        gen = serve.main(argv, stats=stats)
        k = (cfg.num_codebooks,) if cfg.family == "audio" else ()
        check(tuple(gen.shape) == (args.batch, args.gen) + k
              and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size,
              f"(aj) {label}: tokens {tuple(gen.shape)} in "
              f"[{int(gen.min())}, {int(gen.max())}]")
        runs[label] = dict(
            argv=argv, family=cfg.family, tokens_shape=list(gen.shape),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            cache_bytes=cache_bytes(torch, build_model(cfg).abstract_cache(
                args.batch, args.prompt_len + args.gen)), **stats)
        print(f"(aj) {label}: prefill {stats['prefill_tokens_per_s']:,.0f} "
              f"tok/s, decode {stats['decode_tokens_per_s']:,.0f} tok/s",
              flush=True)
    return runs


def decode_32k_run(torch, serve, dev, rate) -> dict:
    """(ak): smollm-135m at full size in bf16: prefill_32k's length, then
    decode_32k's cache (naive and split_combine timed, and held against
    each other from one state), one naive step profiled (launches, the
    device's time by kernel class), one decode step checked for host syncs,
    one layer's decode attention in both forms beside SDPA's (a yardstick
    the port never calls), and the teacher-forced decode against the
    prefill."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import attention
    from repro_torch.models.params import index_struct

    cfg = get_arch("smollm-135m")[0]
    model, prefill, decode, decode_split = serve_steps(
        torch, dev, cfg, DECODE_BATCH, DECODE_LEN)
    params = serve.serve_params(model, 0, dev)
    wbytes = tree_bytes(params)
    out = dict(weights_bytes=wbytes)

    # The teacher-forced decode against the prefill, both forms.
    toks = serve.draw_prompts(cfg, 2, TEACHER_POSITIONS, 1, dev)
    want, _ = prefill(params, {"tokens": toks},
                      model.init_cache(2, TEACHER_POSITIONS, device=dev))
    errs = {}
    for form, step in (("naive", decode), ("split_combine", decode_split)):
        cache = model.init_cache(2, TEACHER_POSITIONS, device=dev)
        got = []
        for t in range(TEACHER_POSITIONS):
            lg, cache = step(params, {"tokens": toks[:, t:t + 1]}, cache)
            got.append(lg[:, 0])
        errs[form] = rel_err(torch.stack(got, 1), want)
    out["teacher_forced"] = dict(positions=TEACHER_POSITIONS,
                                 max_rel_err=errs, tol=SERVE_BF16_TOL)
    check(max(errs.values()) <= SERVE_BF16_TOL, f"(ak): the teacher-forced "
          f"decode != the prefill's logits: {errs}")
    del want, cache

    # prefill_32k: 1 x 32,768 into a 32,768-position cache.
    toks = serve.draw_prompts(cfg, 1, DECODE_LEN, 2, dev)
    prefill(params, {"tokens": toks[:, :PREFILL_WARMUP]},
            model.init_cache(1, DECODE_LEN, device=dev))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(1, DECODE_LEN, device=dev)
    (lg, cache), ms = timed_call(
        torch, lambda: prefill(params, {"tokens": toks}, cache))
    check(bool(lg.isfinite().all()) and int(cache.index[0]) == DECODE_LEN,
          f"(ak) prefill_32k: finite {bool(lg.isfinite().all())}, index "
          f"{cache.index.tolist()}")
    out["prefill_32k"] = dict(
        shape=[1, DECODE_LEN], ms=ms, tokens_per_s=DECODE_LEN / (ms / 1e3),
        attention="blockwise, causal_skip, chunk 2048",
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"(ak) prefill_32k: {ms:.1f} ms", flush=True)
    del lg, cache, toks

    # decode_32k: 64 rows of 32,768 positions after a 64 x 512 prefill.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(DECODE_BATCH, DECODE_LEN, device=dev)
    cbytes = cache_bytes(torch, model.abstract_cache(DECODE_BATCH,
                                                     DECODE_LEN))
    prompts = serve.draw_prompts(cfg, DECODE_BATCH, DECODE_PROMPT, 3, dev)
    (lg, cache), prefill_ms = timed_call(
        torch, lambda: prefill(params, {"tokens": prompts}, cache))
    nxt = serve.greedy(lg)
    del lg
    naive_ms, cache, nxt, _ = decode_steps(
        torch, decode, params, cache, nxt, DECODE_UNTIMED, DECODE_TIMED)
    # The two forms from one state: a naive step, the index rewound by
    # one, the same token through split_combine (it writes the same keys
    # and values at the same position).
    lg_naive, cache = decode(params, {"tokens": nxt}, cache)
    cache.index.sub_(1)
    lg_split, cache = decode_split(params, {"tokens": nxt}, cache)
    forms_err = rel_err(lg_split, lg_naive)
    check(forms_err <= SERVE_BF16_TOL, f"(ak): split_combine's logits != "
          f"the naive form's: {forms_err}")
    nxt = serve.greedy(lg_split)
    del lg_naive, lg_split
    split_ms, cache, nxt, _ = decode_steps(
        torch, decode_split, params, cache, nxt, DECODE_UNTIMED,
        DECODE_TIMED)

    def one_step():
        nonlocal cache, nxt
        logits, cache = decode(params, {"tokens": nxt}, cache)
        nxt = serve.greedy(logits)

    prof = device_profile(torch, one_step, 1)
    no_host_sync(torch, "(ak)", lambda: decode(params, {"tokens": nxt},
                                              cache))
    n = DECODE_PROMPT + 2 * (DECODE_UNTIMED + DECODE_TIMED) + 3
    check(cache.index.tolist() == [n] * cfg.num_layers,
          f"(ak): cache index {cache.index.tolist()}, expected {n}")
    nbytes = wbytes + cbytes
    out["decode_32k"] = dict(
        batch=DECODE_BATCH, cache_len=DECODE_LEN, cache_bytes=cbytes,
        prefill_shape=[DECODE_BATCH, DECODE_PROMPT], prefill_ms=prefill_ms,
        naive=decode_summary(naive_ms, DECODE_BATCH, nbytes, rate),
        split_combine=decode_summary(split_ms, DECODE_BATCH, nbytes, rate),
        forms_max_rel_err=forms_err, forms_tol=SERVE_BF16_TOL,
        naive_profile=prof, no_host_sync_in_a_step=True,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"(ak) decode_32k: naive {statistics.median(naive_ms):.1f} ms, "
          f"split_combine {statistics.median(split_ms):.1f} ms a step",
          flush=True)

    # One layer's decode attention (apply_decode, the projections
    # included; its index rewound after each call) in both forms, and
    # SDPA over the same keys and values (the positions written so far).
    layer = index_struct(cache, 0)
    p0 = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = torch.randn((DECODE_BATCH, 1, cfg.d_model), device=dev,
                    dtype=torch.bfloat16)

    def layer_call(split):
        def fn():
            attention.apply_decode(p0, x, cfg, layer, split_combine=split)
            layer.index.sub_(1)
        return fn

    hd, written = cfg.resolved_head_dim, int(layer.index)
    q = torch.randn((DECODE_BATCH, cfg.num_heads, 1, hd), device=dev,
                    dtype=torch.bfloat16)
    k = layer.k[:, :written].transpose(1, 2).contiguous()
    v = layer.v[:, :written].transpose(1, 2).contiguous()
    layer_bytes = cbytes // cfg.num_layers
    out["decode_32k"]["one_layer_attention"] = dict(
        naive_ms=time_ms(torch, layer_call(False)),
        split_combine_ms=time_ms(torch, layer_call(True)),
        sdpa_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True)),
        sdpa_note=f"F.scaled_dot_product_attention over the {written} "
                  f"positions written, GQA; a yardstick, not on the path",
        cache_bytes=layer_bytes, bound_ms=layer_bytes / rate * 1e3)
    del cache, layer, k, v, params
    torch.cuda.empty_cache()
    return out


def ssm_serve_run(torch, serve, dev, rate, arch, max_len, steps,
                  label) -> dict:
    """(al)/(am): ``arch`` whole in bf16, weights drawn on the card and
    cast leaf by leaf: a 1 x SSM_SERVE_PROMPT prefill (the recurrent
    states untouched, as in JAX), ``steps`` decode steps (the first
    DECODE_UNTIMED untimed), one profiled (launches, idle share), one
    checked for host syncs."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)[0]
    model, prefill, decode, _ = serve_steps(torch, dev, cfg, 1, max_len)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, draw_ms = timed_call(
        torch, lambda: serve.serve_params(model, 0, dev))
    draw_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wbytes = tree_bytes(params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(1, max_len, device=dev)
    abstract = model.abstract_cache(1, max_len)
    cbytes = cache_bytes(torch, abstract)
    states = cache.mamba if hasattr(cache, "mamba") else cache
    sbytes = cache_bytes(torch, abstract.mamba if hasattr(
        abstract, "mamba") else abstract)
    prompts = serve.draw_prompts(cfg, 1, SSM_SERVE_PROMPT, 4, dev)
    (lg, cache), prefill_ms = timed_call(
        torch, lambda: prefill(params, {"tokens": prompts}, cache))
    check(bool(lg.isfinite().all()) and not any(
        bool(s.any()) for s in states), f"{label}: prefill logits finite "
          f"{bool(lg.isfinite().all())}; its recurrent states must stay "
          f"zero (the reference's prefill fills none)")
    nxt = serve.greedy(lg)
    del lg
    ms, cache, nxt, lg = decode_steps(torch, decode, params, cache, nxt,
                                      DECODE_UNTIMED,
                                      steps - DECODE_UNTIMED)
    check(bool(lg.isfinite().all()), f"{label}: decode logits not finite")

    def one_step():
        nonlocal cache, nxt
        logits, cache = decode(params, {"tokens": nxt}, cache)
        nxt = serve.greedy(logits)
        torch.cuda.synchronize()

    prof = device_profile(torch, one_step, 1)
    no_host_sync(torch, label, lambda: decode(params, {"tokens": nxt},
                                              cache))
    # Each step reads the weights and the whole cache (the states read
    # and written; the naive decode attention scores every KV position).
    nbytes = wbytes + cbytes + sbytes
    out = dict(arch=arch, layers=cfg.num_layers, weights_bytes=wbytes,
               params=sum(v.numel() for v in tree_leaves(params)),
               draw_ms=draw_ms, draw_peak_mem_gib=draw_peak,
               cache_len=max_len, cache_bytes=cbytes, state_bytes=sbytes,
               prefill_shape=[1, SSM_SERVE_PROMPT], prefill_ms=prefill_ms,
               prefill_tokens_per_s=SSM_SERVE_PROMPT / (prefill_ms / 1e3),
               **decode_summary(ms, 1, nbytes, rate),
               launches_per_decode_step=prof["kernels_per_step"],
               decode_idle_share=prof["idle_share"],
               decode_profile=prof, no_host_sync_in_a_step=True,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"{label}: prefill {prefill_ms:.1f} ms, decode "
          f"{out['decode_median_ms']:.1f} ms a step", flush=True)
    del params, cache, states, lg
    torch.cuda.empty_cache()
    return out


def serving_phase(torch, ops, dev, rate) -> dict:
    """(aj)-(am) and the serving checks, the kernels' dispatch counts set
    to 0 before and read after: serving launches none of the repo's
    kernels (no ``pl.pallas_call`` lies on the JAX package's serving
    path either)."""
    from repro_torch.launch import serve

    ops.reset_counts()
    out = {"card_vs_cpu_f32": serve_card_vs_cpu(torch, dev)}
    out["cli"] = serve_cli_runs(torch, serve, dev)
    out["smollm_135m_32k"] = decode_32k_run(torch, serve, dev, rate)
    out["falcon_mamba_7b_whole"] = ssm_serve_run(
        torch, serve, dev, rate, "falcon-mamba-7b",
        SSM_SERVE_PROMPT + MAMBA_SERVE_STEPS + 2, MAMBA_SERVE_STEPS,
        "(al) falcon-mamba-7b")
    out["zamba2_2_7b_whole_500k"] = ssm_serve_run(
        torch, serve, dev, rate, "zamba2-2.7b", LONG_LEN, ZAMBA_SERVE_STEPS,
        "(am) zamba2-2.7b")
    out["dispatch_counts"] = dict(ops.dispatch_counts)
    # Prefill's attention takes the kernel; no pool kernel is launched.
    check(launched(out["dispatch_counts"]) == {ATTN_KEY},
          f"serving launched a pool kernel: {out['dispatch_counts']}")
    return out


# -- checkpoints, restarts, resume, elastic ---------------------------------

# Every checkpoint of this script goes under a temporary directory of its
# own (the CLI's default one too: ``tempfile.tempdir`` and, for the
# processes it starts, TMPDIR point there), emptied after each phase and
# removed at the end.
CKPT_ROOT = None
CKPT_FREE_BYTES = 16 * 2 ** 30  # (w)'s two directories hold ~6.5 GB
# (v): lazy windows of K = 8 under the supervisor, a checkpoint every 8,
# a host fault raised at step 12 inside the window 8-15 after its replay
# ran (the live tensors then hold step 16's values).
SUP_STEPS, SUP_EVERY, SUP_FAULT = 16, 8, 12
SUP_RESTORED = SUP_FAULT // WINDOW_K * WINDOW_K
# (w): a 16-step CSC run preempted (SIGTERM) after step 8, then a new
# process with the same flags, which resumes at 8.
RESUME_STEPS, RESUME_FIRST, RESUME_EVERY = 16, 8, 8
# (x): two ranks over the ring, CSC, 12 steps (the schedule's length), a
# checkpoint at 8; then one rank from 8. The bound on its losses' largest
# relative difference from the two ranks' lies between the sound reading
# and the controls' (NVIDIA H100 80GB HBM3, 700 W: 9.26e-6 sound; the
# restored hg zeroed 5.27e-5, rank 0's row alone 1.65e-5).
ELASTIC_STEPS, ELASTIC_AT, ELASTIC_RTOL = 12, 8, 1.25e-5


def make_ckpt_root() -> None:
    """The script's checkpoint directory, after checking the disk holds
    the largest phase's checkpoints."""
    global CKPT_ROOT
    import shutil
    import tempfile
    parent = tempfile.gettempdir()
    free = shutil.disk_usage(parent).free
    check(free >= CKPT_FREE_BYTES, f"checkpoints: {free / 2 ** 30:.1f} GiB "
          f"free under {parent}, the checkpoint phases need "
          f"{CKPT_FREE_BYTES / 2 ** 30:.0f} GiB")
    CKPT_ROOT = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    tempfile.tempdir = CKPT_ROOT
    os.environ["TMPDIR"] = CKPT_ROOT


def clear_checkpoints() -> None:
    """Remove every checkpoint a phase left (the CLI saves at its end)."""
    import shutil
    if CKPT_ROOT is not None:
        for name in os.listdir(CKPT_ROOT):
            shutil.rmtree(os.path.join(CKPT_ROOT, name), ignore_errors=True)


def remove_ckpt_root() -> None:
    import shutil
    import tempfile
    if CKPT_ROOT is not None:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        tempfile.tempdir = None


def ckpt_dir(name: str) -> str:
    path = os.path.join(CKPT_ROOT, name)
    os.makedirs(path)
    return path


def timed_manager(path):
    """A ``CheckpointManager`` that also times each ``save`` call (its
    blocking part: the snapshot; the final save's write too) and each
    ``restore``."""
    from repro_torch.checkpoint.manager import CheckpointManager

    class Timed(CheckpointManager):
        def __init__(self, directory):
            super().__init__(directory, keep=3)
            self.saves, self.restores = [], []

        def save(self, step, state, blocking=False, logical=False):
            t0 = time.perf_counter()
            super().save(step, state, blocking=blocking, logical=logical)
            self.saves.append(dict(step=int(step), blocking=blocking,
                                   seconds=time.perf_counter() - t0))

        def restore(self, like, step=None, logical=False):
            t0 = time.perf_counter()
            out = super().restore(like, step=step, logical=logical)
            self.restores.append(dict(step=out[0],
                                      seconds=time.perf_counter() - t0))
            return out

    return Timed(path)


def supervisor_run(torch, ops, train_mod, label, argv):
    """(v): lazy windows of WINDOW_K under ``TrainSupervisor.run_windows``
    (a checkpoint every SUP_EVERY steps, batches from a ``DataPipeline``),
    a host fault raised at step SUP_FAULT after the window 8-15 ran:
    one restart, a restore of step 8 into the live tensors, and the
    window's one graph replayed on them. Against an uninterrupted run of
    the same windows from the same seed in this process: every loss of
    the final pass and the final parameters and momentum, bit for bit.
    Times each save's blocking part, the writer thread, the restore, and
    each window, which either overlaps a write in flight or not."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.runtime.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor)

    args, cfg, trainer = window_trainer(train_mod, argv, 0)
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    batches = [data.batch(s, BATCH, SEQ) for s in range(SUP_STEPS)]
    # The uninterrupted run: no supervisor, no checkpoint.
    state = trainer.init_state(args.seed)
    window = trainer.build_train_window(WINDOW_K)
    ref_losses, ref_ms = [], []
    for w in range(0, SUP_STEPS, WINDOW_K):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = window(state, stacked(torch, batches[w:w + WINDOW_K]))
        ref_losses += m["loss"].tolist()
        torch.cuda.synchronize()
        ref_ms.append((time.perf_counter() - t0) * 1e3)
    ref_final = flat_state(torch, trainer, state)
    window.release()
    del state, window
    torch.cuda.empty_cache()

    ckpt = timed_manager(ckpt_dir("v"))
    sup = TrainSupervisor(ckpt, SupervisorConfig(checkpoint_every=SUP_EVERY))
    pipe = DataPipeline(data, BATCH, SEQ, prefetch=0)  # as the CLI's
    state = trainer.init_state(args.seed)
    window = trainer.build_train_window(WINDOW_K)
    losses, windows, restored = {}, [], []
    fired = {"done": False}

    def window_fn(step, length, state):
        bs = [pipe.next_at(step + i) for i in range(length)]
        writing = ckpt.writing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = window(state, stacked(torch, bs))
        got = m["loss"].tolist()
        torch.cuda.synchronize()
        windows.append(dict(start=step, ms=(time.perf_counter() - t0) * 1e3,
                            write_in_flight=writing))
        if step <= SUP_FAULT < step + length and not fired["done"]:
            fired["done"] = True
            raise RuntimeError(f"host fault at step {SUP_FAULT}")
        losses.update(zip(range(step, step + length), got))
        return state

    def on_restore(step):
        restored.append(step)
        pipe.skip_to(step)

    ops.reset_counts()
    pipe.start(0)
    try:
        state = sup.run_windows(state, 0, SUP_STEPS, window_fn, WINDOW_K,
                                on_restore=on_restore)
    finally:
        pipe.stop()
    final = flat_state(torch, trainer, state)
    stats, counts = dict(window.stats), dict(ops.dispatch_counts)
    plan = trainer.engine.plan_for()
    # The warm-up runs one step body, the capture WINDOW_K; every replay
    # (the restarted window's too) launches nothing from the host.
    want_warmup, want_capture = window_counts(plan, 1, cfg), \
        window_counts(plan, WINDOW_K, cfg)
    steps_on_disk = ckpt.available_steps()
    window.release()
    del state, window, trainer
    torch.cuda.empty_cache()
    got = [losses[s] for s in range(SUP_STEPS)]
    print(f"{label}: losses {got}; saves {ckpt.saves}; writes "
          f"{ckpt.writes}; restores {ckpt.restores}", flush=True)
    saved = list(range(SUP_EVERY, SUP_STEPS + 1, SUP_EVERY))
    check(sup.restarts == 1 and restored == [SUP_RESTORED], f"{label}: "
          f"restarts {sup.run_stats()}, restored to {restored}")
    check([x["step"] for x in ckpt.saves] == saved
          and [x["step"] for x in ckpt.writes] == saved,
          f"{label}: saves {ckpt.saves}, writes {ckpt.writes}")
    check(steps_on_disk == saved[-3:], f"{label}: on disk "
          f"{steps_on_disk} (keep=3)")
    check(stats["captures"] == 1, f"{label}: {stats['captures']} captures "
          f"(a restore into the live tensors keeps the graph)")
    check(stats["warmup_counts"] == want_warmup
          and stats["capture_counts"] == want_capture
          and counts == {k: want_warmup[k] + want_capture[k]
                         for k in want_capture},
          f"{label}: counts {counts}, warm-up {stats['warmup_counts']}, "
          f"capture {stats['capture_counts']}; the plan says "
          f"{want_warmup} and {want_capture}")
    check(got == ref_losses, f"{label}: final pass losses {got} != the "
          f"uninterrupted run's {ref_losses}")
    check(bits_equal(torch, final, ref_final), f"{label}: the final state "
          f"differs from the uninterrupted run's by "
          f"{(final - ref_final).abs().max().item()}")
    # Replayed windows only (the first captures): with a write in flight,
    # and without (the uninterrupted run's, and the supervised run's
    # window replayed after the restore, which waits for the write).
    over = [w["ms"] / WINDOW_K for w in windows[1:] if w["write_in_flight"]]
    quiet = [w["ms"] / WINDOW_K for w in windows[1:]
             if not w["write_in_flight"]] + [t / WINDOW_K
                                             for t in ref_ms[1:]]
    check(over and quiet, f"{label}: windows {windows}")
    o, q = statistics.median(over), statistics.median(quiet)
    clear_checkpoints()
    return dict(losses=got, windows=windows,
                reference_window_ms=ref_ms,
                step_ms_write_in_flight=over, step_ms_no_write=quiet,
                median_step_ms_write_in_flight=o,
                median_step_ms_no_write=q,
                write_overlap_delta_pct=100.0 * (o / q - 1.0),
                save_blocking_s=ckpt.saves, writer=ckpt.writes,
                bytes_per_checkpoint=[x["bytes"] for x in ckpt.writes],
                restore_s=ckpt.restores, restarts=sup.run_stats(),
                restored_to=restored, steps_on_disk=steps_on_disk,
                window_stats=stats, dispatch_counts=counts,
                expected_capture_counts=want_capture,
                checkpoint_every=SUP_EVERY, fault_step=SUP_FAULT,
                window_steps=WINDOW_K, same_bits_as=f"an uninterrupted "
                f"{SUP_STEPS}-step window run in this process",
                hash_on_writer_thread=True)


class PreemptAfter(list):
    """The CLI's window record (``train(record=...)``) that sends this
    process a SIGTERM, as a scheduler's preemption notice, when the
    window ending at ``step`` has run: the CLI's handler then stops the
    run at that window's edge, with its checkpoint there."""

    def __init__(self, step: int):
        super().__init__()
        self.step = step

    def append(self, item):
        super().append(item)
        if item["start"] + item["length"] == self.step:
            import signal
            os.kill(os.getpid(), signal.SIGTERM)


def cli_worker(out: str, argv, preempt_at=None) -> None:
    """One CLI run in a process of its own (``--cli-train OUT
    [--preempt-at STEP] -- argv``): ``repro_torch.launch.train.train`` on
    ``argv``, preempted by a SIGTERM after step ``preempt_at`` if given;
    its losses, step seconds, windows and supervisor stats to ``out`` as
    JSON."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import train as train_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops

    record = [] if preempt_at is None else PreemptAfter(preempt_at)
    ops.reset_counts()
    _, losses, seconds, run = train_mod.train(train_mod.parse_args(argv),
                                              record=record)
    with open(out, "w") as f:
        json.dump(dict(losses=losses, seconds=seconds, run=run,
                       counts=dict(ops.dispatch_counts), windows=[
                           dict(start=r["start"], length=r["length"],
                                stage=r["stage"]) for r in record]), f)


def cli_processes(runs):
    """Run each (out, argv, preempt_at) of ``runs`` as a ``cli_worker``
    process, all at once; their results."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cli-train", out,
         *([] if at is None else ["--preempt-at", str(at)]), "--", *argv])
        for out, argv, at in runs]
    try:
        deadline = time.monotonic() + 600
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        fail("CLI processes did not finish within 600 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"CLI processes: exit codes {[p.returncode for p in procs]}")
    results = []
    for out, _, _ in runs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def manifest(path: str, step: int) -> dict:
    with open(os.path.join(path, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def resume_phase(label, csc_argv):
    """(w): CSC through the CLI at --window-steps 4 in new processes, each
    with --steps RESUME_STEPS: one is preempted by a SIGTERM after step
    RESUME_FIRST (its checkpoints every RESUME_EVERY up to there), and
    beside it one runs all the steps; then a third, launched with the
    first's flags, resumes its directory at RESUME_FIRST and runs to the
    end. Its losses are the uninterrupted run's for those steps, and its
    final checkpoint holds the same bits (the SHA-256 of every leaf:
    parameters, momentum, hg, chunk norms). No process restarted a
    window."""
    total = RESUME_STEPS
    argv = csc_argv + ["--csc-warmup", str(CSC_WINDOW_WARMUP),
                       "--window-steps", str(CSC_WINDOW_K), "--log-every",
                       "4", "--ckpt-every", str(RESUME_EVERY), "--steps",
                       str(total)]
    part, whole = ckpt_dir("w_part"), ckpt_dir("w_whole")
    outs = [os.path.join(CKPT_ROOT, f"w_{n}.json")
            for n in ("first", "whole", "resumed")]
    t0 = time.perf_counter()
    first, ref = cli_processes([
        (outs[0], argv + ["--ckpt-dir", part], RESUME_FIRST),
        (outs[1], argv + ["--ckpt-dir", whole], None)])
    on_disk = sorted(int(n[5:]) for n in os.listdir(part))
    (resumed,) = cli_processes([(outs[2], argv + ["--ckpt-dir", part],
                                 None)])
    seconds = time.perf_counter() - t0
    got = [m for m in manifest(part, total)["leaves"]]
    want = [m for m in manifest(whole, total)["leaves"]]
    same = {m["name"]: m["sha256"] == w["sha256"]
            for m, w in zip(got, want) if not m.get("scratch")}
    print(f"{label}: resumed losses {resumed['losses']}; uninterrupted "
          f"{ref['losses'][RESUME_FIRST:]}", flush=True)
    runs = [first["run"], ref["run"], resumed["run"]]
    check(all(r["restarts"] == 0 for r in runs)
          and [r["preempted"] for r in runs] == [RESUME_FIRST, None, None],
          f"{label}: the processes' supervisor stats {runs}")
    check(on_disk == list(range(RESUME_EVERY, RESUME_FIRST + 1,
                                RESUME_EVERY)),
          f"{label}: the first process left {on_disk}")
    check(resumed["windows"][0]["start"] == RESUME_FIRST, f"{label}: the "
          f"resumed process started at {resumed['windows'][0]}")
    check(first["losses"] == ref["losses"][:RESUME_FIRST], f"{label}: the "
          f"first process's losses differ from the uninterrupted run's")
    check(resumed["losses"] == ref["losses"][RESUME_FIRST:], f"{label}: "
          f"resumed losses {resumed['losses']} != uninterrupted "
          f"{ref['losses'][RESUME_FIRST:]}")
    check([m["name"] for m in got] == [m["name"] for m in want]
          and all(same.values()), f"{label}: final leaves differ: "
          f"{[k for k, v in same.items() if not v]}")
    check({"gf/hg", "gf/chunk_norms", "opt/momentum"} <= set(same),
          f"{label}: leaves {sorted(same)}")
    counts = resumed["counts"]
    check(all(counts.get(f"{k}.kernel", 0) > 0 for k in (
        "pool_pack", "pool_unpack_update", "chunk_l1norm", "csc_compact"))
          and not any(k.endswith(".plain") for k in counts),
          f"{label}: the resumed process's counts {counts}")
    clear_checkpoints()
    return dict(losses=resumed["losses"],
                uninterrupted_losses=ref["losses"],
                first_losses=first["losses"],
                resumed_windows=resumed["windows"],
                resumed_step_ms=[t * 1e3 for t in resumed["seconds"]],
                uninterrupted_step_ms=[t * 1e3 for t in ref["seconds"]],
                first_process_checkpoints=on_disk, dispatch_counts=counts,
                preempted_at=first["run"]["preempted"],
                leaves_same_sha256=same, seconds_all_processes=seconds,
                window_steps=CSC_WINDOW_K, same_bits_as=f"an uninterrupted "
                f"{RESUME_STEPS}-step CLI run in another process")


def elastic_phase(torch, ops, train_mod, ring, csc_argv, path):
    """(x), after (c)'s two ranks ran 12 CSC steps over the ring with a
    checkpoint at 8 (``ring``: rank 0's record): one process follows the
    elastic pattern — restore step 8 into a host state of the two-rank
    layout, ``reshard_hg`` to one row, save again at 8 — then a Trainer
    at N = 1 restores in place and trains steps 8-11 on the same global
    batch. The column total of hg as numpy sums it, the live hg the
    re-split row bit for bit, rank 0's parameters and momentum at 8, a
    one-rank plan, the launches its plans say, and losses within
    ELASTIC_RTOL of the two ranks'. Two controls, the restored hg zeroed
    and rank 0's row alone in its place, must exceed that bound."""
    import dataclasses
    import hashlib

    import numpy as np
    from repro_torch.checkpoint import reshard
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(csc_argv + ["--steps", str(ELASTIC_STEPS)])
    _, cfg = train_mod.build(args)
    cfg = cfg.replace(gradientflow=dataclasses.replace(
        cfg.gradientflow, collective_algo="pallas_ring"))
    trainer = Trainer(cfg)
    ckpt = timed_manager(path)
    meta = {m["name"]: m for m in manifest(path, ELASTIC_AT)["leaves"]}
    check(meta["gf/hg"]["shape"] == [2, trainer.pool.size], f"(x): the "
          f"two ranks saved hg of {meta['gf/hg']['shape']}")
    check(reshard.plan([(n, m["shape"]) for n, m in meta.items()], 1) == [],
          "(x): the reshard plan found a problem")
    old = reshard.host_like(trainer.init_state(args.seed), 2)
    _, old = ckpt.restore(old, step=ELASTIC_AT, logical=True)
    t0 = time.perf_counter()
    new = reshard.reshard_state(old, 1)
    reshard_s = time.perf_counter() - t0
    total = old.gf.hg.numpy().sum(axis=0)
    check(np.array_equal(new.gf.hg.numpy()[0], total),
          "(x): the re-split hg's column total differs from numpy's sum")
    ckpt.save(ELASTIC_AT, new, blocking=True, logical=True)
    resplit, row0 = new.gf.hg[0].clone(), old.gf.hg[0].clone()
    del old, new
    data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
    state = trainer.init_state(args.seed)
    fns = {}

    def one_rank(hg=None):
        """Step ELASTIC_AT restored into the live one-rank state (``hg``,
        if given, then written over its hg: a control), steps 8-11;
        (losses, digest of the restored parameters and momentum, whether
        the live hg is the re-split row bit for bit)."""
        nonlocal state
        _, state = ckpt.restore(state, step=ELASTIC_AT)
        same_hg = torch.equal(state.gf.hg.cpu(), resplit)
        flat = torch.cat([p.reshape(-1) for p in
                          trainer.pool.flat_leaves(state.params)]
                         + [state.opt.momentum]).cpu()
        digest = hashlib.sha256(flat.numpy().tobytes()).hexdigest()
        del flat
        if hg is not None:
            state.gf.hg.copy_(hg)
        losses = []
        for s in range(ELASTIC_AT, ELASTIC_STEPS):
            stage = trainer.gf.stage_for_step(s)
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            state, m = fns[stage.index](state, data.batch(s, BATCH, SEQ))
            losses.append(float(m["loss"]))
        return losses, digest, same_hg

    two = ring["losses"][ELASTIC_AT:]

    def max_rel(losses):
        return max(abs(a / b - 1.0) for a, b in zip(losses, two))

    ops.reset_counts()
    losses, digest, same_hg = one_rank()
    counts = dict(ops.dispatch_counts)
    key, theta = trainer.gf.plan_cache_key(), trainer.gf.bucket_elems
    want = expected_counts(trainer, ELASTIC_STEPS - ELASTIC_AT, ELASTIC_AT)
    # The controls (launches not counted): what the bound must see.
    controls = {name: max_rel(one_rank(hg)[0]) for name, hg in (
        ("hg_zeroed", torch.zeros_like(resplit)),
        ("rank0_row_alone", row0))}
    del state, fns, trainer
    torch.cuda.empty_cache()
    rel = [abs(a / b - 1.0) for a, b in zip(losses, two)]
    print(f"(x): one rank {losses}; two ranks {two}; relative {rel}; "
          f"controls {controls}", flush=True)
    check(same_hg, "(x): the live hg after the in-place restore differs "
          "from the re-split row")
    check(digest == ring["digest_at_ckpt"], "(x): the restored parameters "
          "and momentum differ from rank 0's at the checkpoint")
    check(key[4] == 1 and key[6] == (("data", 1),) and key[4] != ring[
        "plan_key"][4], f"(x): plan key {key}, two ranks' "
          f"{ring['plan_key']}")
    check(max(rel) <= ELASTIC_RTOL < min(controls.values()), f"(x): losses "
          f"{losses} against the two ranks' {two}: relative {rel}, the "
          f"controls {controls}, the bound {ELASTIC_RTOL}")
    check(counts == want, f"(x): counts {counts}, the plans say {want}")
    clear_checkpoints()
    return dict(losses=losses, two_rank_losses=two, relative_diff=rel,
                rtol=ELASTIC_RTOL, control_max_relative_diff=controls,
                live_hg_is_resplit_row=same_hg, plan_key=repr(key),
                theta=theta, two_rank_plan_key=repr(tuple(ring["plan_key"])),
                two_rank_theta=ring["theta"],
                hg_rows_saved=meta["gf/hg"]["shape"],
                restore_s=ckpt.restores, save_s=ckpt.saves,
                writer=ckpt.writes, reshard_s=reshard_s,
                two_rank_writes=ring["writes"],
                dispatch_counts=counts, same_params_as_rank0_at=ELASTIC_AT)


COMMON_ARGV = ["--arch", "smollm-135m", "--use-kernels", "--bucket-elems",
               str(BUCKET_ELEMS), "--batch", str(BATCH), "--seq-len",
               str(SEQ), "--log-every", "1", "--window-steps", "1"]
LAZY_ARGV = COMMON_ARGV + ["--gf-mode", "lazy", "--steps", str(LAZY_STEPS)]
CSC_ARGV = COMMON_ARGV + ["--gf-mode", "csc", "--chunk-elems", str(CHUNK),
                          "--sparsity", str(CSC_SPARSITY), "--csc-warmup",
                          str(CSC_WARMUP), "--steps", str(CSC_STEPS)]


def train_phase(torch, dist, ops, train_mod, synthetic, kunpack, csc,
                wire):
    """The full-width step in one world-size-1 NCCL group, each run with
    its own dispatch counts: (a) lazy and (b) CSC with momentum SGD;
    (d) LARS, CSC, staged; (e) LARS, lazy, staged then monolithic; (f)
    AdamW, CSC, staged; the guard, (g)-(j); the low-bit wires, (l)-(o)."""
    lazy_args, csc_args = LAZY_ARGV, CSC_ARGV
    lars = ["--optimizer", "lars", "--lr", str(LARS_LR)]
    # The low-bit wires' lazy runs chunk the pool as CSC does.
    int8 = ["--wire-format", "int8"]
    int8_lazy_args = lazy_args + ["--chunk-elems", str(CHUNK)] + int8
    fp8_lazy_args = lazy_args + ["--chunk-elems", str(CHUNK),
                                 "--wire-format", "fp8_e4m3"]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    runs = {}
    try:
        runs["lazy"] = train_run(torch, ops, train_mod, synthetic, "lazy",
                                 lazy_args, LAZY_STEPS, repeat=REPEAT_STEPS)
        runs["csc"] = train_run(torch, ops, train_mod, synthetic, "csc",
                                csc_args, CSC_STEPS, repeat=REPEAT_STEPS)
        tally, restore = count_ratio_launches(kunpack)
        try:
            # Every step of both passes: the tally below counts them.
            runs["lars_csc"] = train_run(torch, ops, train_mod, synthetic,
                                         "(d) lars, csc, staged",
                                         csc_args + lars, CSC_STEPS)
        finally:
            restore()
        runs["lars_csc"]["update_launches"] = dict(tally)
        lars_lazy = {}
        for overlap in ("staged", "monolithic"):
            lars_lazy[overlap] = train_run(
                torch, ops, train_mod, synthetic,
                f"(e) lars, lazy, {overlap}", lazy_args + lars, LAZY_STEPS,
                overlap=overlap, keep_params=True, repeat=REPEAT_STEPS)
        runs["adamw_csc"] = train_run(
            torch, ops, train_mod, synthetic, "(f) adamw, csc, staged",
            csc_args + ["--optimizer", "adamw", "--lr", str(ADAMW_LR)],
            CSC_STEPS, repeat=REPEAT_STEPS)
        runs["guarded_lazy"] = guarded_run(
            torch, ops, train_mod, "(g) guarded lazy, staged", lazy_args,
            GUARD_LAZY_STEPS, GUARD_LAZY_FAULTS)
        runs["guarded_csc"] = guarded_run(
            torch, ops, train_mod, "(h) guarded csc, staged", csc_args,
            CSC_STEPS, GUARD_CSC_FAULTS, steady_from=CSC_WARMUP)
        runs["guarded_lars_lazy_monolithic"] = guarded_run(
            torch, ops, train_mod, "(i) guarded lars, lazy, monolithic",
            lazy_args + lars, LAZY_STEPS, GUARD_MONO_FAULTS,
            overlap="monolithic")
        runs["neutral_lazy"] = neutrality_run(
            torch, ops, train_mod, synthetic, lazy_args, LAZY_STEPS)
        runs["int8_lazy"] = train_run(
            torch, ops, train_mod, synthetic, "(l) int8, lazy, staged",
            int8_lazy_args, LAZY_STEPS, repeat=REPEAT_STEPS,
            watch={1: watch_error_feedback(torch, wire)})
        runs["int8_csc"] = train_run(
            torch, ops, train_mod, synthetic, "(m) int8, csc, staged",
            csc_args + int8, CSC_STEPS,
            watch={CSC_STEPS - 1: watch_residual_at_selection(torch, csc)})
        fp8 = {}
        for overlap in ("staged", "monolithic"):
            fp8[overlap] = train_run(
                torch, ops, train_mod, synthetic,
                f"(n) fp8-e4m3, lazy, {overlap}", fp8_lazy_args, LAZY_STEPS,
                overlap=overlap, keep_params=True, repeat=REPEAT_STEPS)
        runs["guarded_int8_lazy"] = guarded_run(
            torch, ops, train_mod, "(o) guarded int8, lazy, staged",
            int8_lazy_args, GUARD_LAZY_STEPS, GUARD_LAZY_FAULTS)
        runs["guarded_int8_csc"] = guarded_run(
            torch, ops, train_mod, "(o) guarded int8, csc, staged",
            csc_args + int8, CSC_STEPS, GUARD_CSC_FAULTS,
            steady_from=CSC_WARMUP)
        runs["window_lazy"], twin = window_run(
            torch, dist, ops, train_mod, "(q) lazy, graphed window",
            lazy_args, 0)
        runs["window_lazy_pipelined"], _ = window_run(
            torch, dist, ops, train_mod, "(r) lazy, pipelined graphed window",
            lazy_args, PIPELINE_TAIL, twin=twin)
        runs["window_csc_cli"] = csc_window_run(
            torch, ops, train_mod, "(s) csc, CLI windows",
            csc_args + ["--csc-warmup", str(CSC_WINDOW_WARMUP), "--steps",
                        str(CSC_WINDOW_STEPS), "--window-steps",
                        str(CSC_WINDOW_K)])
        runs["window_guarded_lazy"], gtwin = guarded_window_run(
            torch, ops, train_mod, "(t) guarded lazy, graphed window",
            lazy_args, 0, GUARD_LAZY_FAULTS,
            runs["guarded_lazy"]["losses"])
        runs["window_guarded_lazy_pipelined"], _ = guarded_window_run(
            torch, ops, train_mod,
            "(t) guarded lazy, pipelined graphed window", lazy_args,
            PIPELINE_TAIL, GUARD_LAZY_FAULTS,
            runs["guarded_lazy"]["losses"], twin=gtwin)
        runs["supervisor_lazy_window"] = supervisor_run(
            torch, ops, train_mod, "(v) lazy windows under the supervisor",
            lazy_args)
    finally:
        dist.destroy_process_group()
    for label in ("csc", "lars_csc"):
        got = runs[label]["dispatch_counts"]
        check(got == CSC_COUNTS, f"{label}: dispatch counts {got}, "
              f"expected {CSC_COUNTS}")
    got = runs["adamw_csc"]["dispatch_counts"]
    check(got == ADAMW_CSC_COUNTS, f"adamw_csc: dispatch counts {got}, "
          f"expected {ADAMW_CSC_COUNTS}")
    tally = runs["lars_csc"]["update_launches"]
    check(tally == {"with_ratios": 2 * CSC_COUNTS[
        "pool_unpack_update.kernel"], "without_ratios": 0},
          f"lars_csc: update launches {tally}: each must carry ratios")
    for label in ("csc", "lars_csc", "adamw_csc", "int8_csc",
                  "guarded_int8_csc"):
        check(runs[label]["num_selected"] == [4106, 3233, 2361, 1488]
              + [616] * 4, f"{label}: stages select "
              f"{runs[label]['num_selected']}")
    # (l): the padded pool's 7 buckets (the last padding only, as CSC's
    # warm-up has) and the census sum: 8 all-reduces a step (counted on
    # the repeated batch's steps), 7 updates.
    got = runs["int8_lazy"]
    check(got["dispatch_counts"] == {
        "pool_pack.kernel": 2 * LAZY_STEPS,
        "pool_unpack_update.kernel": 7 * LAZY_STEPS,
        "flash_attention.kernel": SMOLLM_ATTN * LAZY_STEPS}
          and got["collectives"] == 8 * REPEAT_STEPS,
          f"(l): counts {got['dispatch_counts']}, all-reduces "
          f"{got['collectives']}")
    check(got["wire_bytes_per_step"] == [WIRE_LAZY_BYTES["int8"]]
          * LAZY_STEPS and runs["lazy"]["wire_bytes_per_step"]
          == [WIRE_LAZY_BYTES["native"]] * LAZY_STEPS,
          f"(l) wire bytes {got['wire_bytes_per_step']} against (a)'s "
          f"{runs['lazy']['wire_bytes_per_step']}")
    # (m): the native warm-up, then k = 616 on int8 with its census.
    got = runs["int8_csc"]
    check(got["wire_bytes_per_step"][-1] == WIRE_CSC_K616_BYTES
          and got["wire_bytes_per_step"][0]
          == runs["csc"]["wire_bytes_per_step"][0],
          f"(m) wire bytes {got['wire_bytes_per_step']}")
    # (n): staged and monolithic from one seed on one batch, bit for bit.
    (staged8, p8s), (mono8, p8m) = fp8["staged"], fp8["monolithic"]
    same = staged8["repeated_batch_losses"] == mono8[
        "repeated_batch_losses"] and bits_equal(torch, p8s, p8m)
    fp8_diff = (p8s - p8m).abs().max().item()
    check(same, f"(n) fp8 lazy: staged != monolithic (losses "
          f"{staged8['repeated_batch_losses']} vs "
          f"{mono8['repeated_batch_losses']}, largest parameter difference "
          f"{fp8_diff})")
    del p8s, p8m
    torch.cuda.empty_cache()
    mono8["bitwise_equal_to_staged"] = same
    runs["fp8_lazy"], runs["fp8_lazy_monolithic"] = staged8, mono8
    # (e): staged and monolithic from one seed on one batch.
    (staged, p_staged), (mono, p_mono) = (lars_lazy["staged"],
                                          lars_lazy["monolithic"])
    a, b = staged["repeated_batch_losses"], mono["repeated_batch_losses"]
    check(all(abs(x - y) <= 1e-6 * abs(y) for x, y in zip(a, b)),
          f"(e) lars lazy: staged losses {a} != monolithic {b} (rtol 1e-6)")
    max_param_diff = (p_staged - p_mono).abs().max().item()
    print(f"(e) lars lazy, staged vs monolithic on one batch: largest "
          f"parameter difference {max_param_diff}", flush=True)
    del p_staged, p_mono
    torch.cuda.empty_cache()
    mono["max_param_diff_vs_staged"] = max_param_diff
    runs["lars_lazy"], runs["lars_lazy_monolithic"] = staged, mono
    for label, run in runs.items():
        if "steady_step_ms" in run or "step_ms" not in run:
            continue  # the guarded runs count their clean steps only
        steady = run["step_ms"][CSC_WARMUP if "csc" in label else 1:]
        run["first_step_ms"] = run["step_ms"][0]
        run["steady_step_ms"] = statistics.median(steady)
        run["tokens_per_s"] = BATCH * SEQ / (run["steady_step_ms"] / 1e3)
    for guarded, plain in GUARD_PAIRS.items():
        g, u = runs[guarded]["steady_step_ms"], runs[plain]["steady_step_ms"]
        runs[guarded].update(unguarded=plain, unguarded_steady_step_ms=u,
                             steady_delta_pct=100.0 * (g - u) / u)
    for low, native in WIRE_PAIRS.items():
        w, u = runs[low]["steady_step_ms"], runs[native]["steady_step_ms"]
        runs[low].update(native_twin=native, native_steady_step_ms=u,
                         steady_delta_pct=100.0 * (w - u) / u,
                         native_peak_mem_gib=runs[native]["peak_mem_gib"])
    return runs


# Each guarded run and the unguarded run of this call it is timed against.
GUARD_PAIRS = {"guarded_lazy": "lazy", "guarded_csc": "csc",
               "guarded_lars_lazy_monolithic": "lars_lazy_monolithic",
               "guarded_int8_lazy": "int8_lazy",
               "guarded_int8_csc": "int8_csc"}
# Each low-bit run and its bf16 twin of this call (one rank: no wire
# saved, the quantize, dequantize and residual passes added).
WIRE_PAIRS = {"int8_lazy": "lazy", "int8_csc": "csc", "fp8_lazy": "lazy",
              "fp8_lazy_monolithic": "lazy"}


RING_STEPS = 3  # on the stream, then as many on one repeated batch
RING_CSC_STEPS = CSC_WARMUP + 1  # the dense step, the ramp, one steady step
# (k): the guarded lazy ring run, a NaN on rank 0 only at step 2.
RING_GUARD_STEPS, RING_GUARD_FAULT = 4, (2, "nan", 1_000_000, GUARD_WIDTH)


def ring_train_worker(rank: int, port: int, out: str,
                      elastic_dir: str) -> None:
    """One rank of the ring runs (a process of its own): smollm-135m at
    full width and depth, bf16 wire, momentum SGD, kernels on,
    ``collective_algo="pallas_ring"``, world size 2 over gloo (NCCL
    refuses two ranks on one card), this rank's half of each global
    batch. First lazy mode, then CSC through its dense step, its ramp and
    one steady step (the ring then reduces the compacted wire buffer);
    last (x), CSC under the supervisor with checkpoints in
    ``elastic_dir``. Writes its findings to ``out`` as JSON."""
    import dataclasses
    import hashlib

    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ring_reduce as kring
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.trainer import Trainer

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    common = ["--arch", "smollm-135m", "--use-kernels", "--bucket-elems",
              str(BUCKET_ELEMS), "--batch", str(BATCH), "--seq-len", str(SEQ),
              "--window-steps", "1"]

    def ring_trainer(extra, guard=None, tail=0):
        args = train_mod.parse_args(common + extra)
        _, cfg = train_mod.build(args)
        cfg = cfg.replace(gradientflow=dataclasses.replace(
            cfg.gradientflow, collective_algo="pallas_ring", guard=guard,
            pipeline_tail_buckets=tail))
        return args, cfg, Trainer(cfg)

    def digest(trainer, state):
        flat = torch.cat([p.reshape(-1) for p in
                          trainer.pool.flat_leaves(state.params)])
        return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()

    def drive_window(trainer, args, cfg, windows, batch_of):
        """(u): ``windows`` windows of RING_WINDOW_K steps, each a replay
        of one CUDA graph, on the batches ``batch_of(step)``; the losses,
        the launches of the warm-up, of the capture and in all, and
        whether the ranks held the same parameters after every window."""
        from repro_torch.launch.trainer import is_flushed

        data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
        state = trainer.init_state(args.seed)
        window = trainer.build_train_window(RING_WINDOW_K)
        plan = trainer.engine.plan_for()
        ops.reset_counts()
        losses, digests = [], []
        for w in range(windows):
            steps = range(w * RING_WINDOW_K, (w + 1) * RING_WINDOW_K)
            bs = [data.batch(batch_of(s), BATCH // 2, SEQ, shard=rank)
                  for s in steps]
            state, m = window(state, {k: torch.stack([b[k] for b in bs])
                                      for k in bs[0]})
            losses += m["loss"].tolist()
            digests.append(digest(trainer, state))
        both = [None, None]
        dist.all_gather_object(both, digests)
        out = dict(losses=losses, counts=dict(ops.dispatch_counts),
                   stats=dict(window.stats), tasks=len(plan.tasks),
                   pipeline_tail=plan.pipeline_tail,
                   flushed=is_flushed(state),
                   same_params_every_window=both[0] == both[1])
        window.release()
        return out

    def drive(trainer, args, cfg, steps, batch_of, hook=None):
        """``steps`` steps on the batches ``batch_of(step)``, each under
        its stage (and the fault hook, if any); the counts, the losses,
        the step times, the guard's verdicts and whether the ranks held
        the same parameters after every step."""
        data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
        state = trainer.init_state(args.seed)
        fns, losses, step_ms, digests, tripped = {}, [], [], [], []
        stages = [trainer.gf.stage_for_step(s) for s in range(steps)]
        ops.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        for s, stage in enumerate(stages):
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(
                    stage, fault_hook=hook)
            batch = data.batch(batch_of(s), BATCH // 2, SEQ, shard=rank)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = fns[stage.index](state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if "guard_tripped" in metrics:
                tripped.append(float(metrics["guard_tripped"]))
            flat = torch.cat([p.reshape(-1) for p in
                              trainer.pool.flat_leaves(state.params)])
            digests.append(hashlib.sha256(
                flat.cpu().numpy().tobytes()).hexdigest())
            del flat
        counts = dict(ops.dispatch_counts)
        peak = torch.cuda.max_memory_allocated()
        residual_finite = bool(torch.isfinite(state.gf.residual).all())
        both = [None, None]
        dist.all_gather_object(both, digests)
        plans = [trainer.gf.plan(st) for st in stages]
        want = expected_counts(trainer, steps)
        want["ring_allreduce.kernel"] = sum(len(p.tasks) for p in plans)
        return dict(losses=losses, step_ms=step_ms, counts=counts,
                    expected_counts=want,
                    buckets=[len(p.tasks) for p in plans],
                    num_selected=[st.num_selected for st in stages],
                    peak_mem_gib=peak / 2 ** 30,
                    same_params_every_step=both[0] == both[1],
                    residual_finite=residual_finite,
                    digests=digests, tripped=tripped,
                    skipped=int(state.guard.skipped) if tripped else None)

    def drive_elastic(trainer, args, cfg):
        """(x): ELASTIC_STEPS eager CSC steps under
        ``TrainSupervisor.run_windows`` (window 1), batches from a
        ``DataPipeline`` of this rank's shard, a collective checkpoint
        every ELASTIC_AT steps into ``elastic_dir`` and a final one.
        Returns the losses, a digest of the parameters and momentum the
        checkpoint at ELASTIC_AT holds, the plan key, θ and the writes."""
        from repro_torch.checkpoint.manager import CheckpointManager
        from repro_torch.data.pipeline import DataPipeline
        from repro_torch.runtime.fault_tolerance import (SupervisorConfig,
                                                         TrainSupervisor)

        data = SyntheticLM(cfg.model.vocab_size, seed=args.seed)
        pipe = DataPipeline(data, BATCH // 2, SEQ, shard=rank, prefetch=0)
        ckpt = CheckpointManager(elastic_dir)
        sup = TrainSupervisor(ckpt, SupervisorConfig(
            checkpoint_every=ELASTIC_AT))
        fns, losses, found = {}, [], {}

        def window_fn(step, length, state):
            if step == ELASTIC_AT:
                flat = torch.cat([p.reshape(-1) for p in
                                  trainer.pool.flat_leaves(state.params)]
                                 + [state.opt.momentum]).cpu()
                found["digest"] = hashlib.sha256(
                    flat.numpy().tobytes()).hexdigest()
            stage = trainer.gf.stage_for_step(step)
            if stage.index not in fns:
                fns[stage.index] = trainer.build_train_step(stage)
            state, m = fns[stage.index](state, pipe.next_at(step))
            losses.append(float(m["loss"]))
            return state

        ops.reset_counts()
        pipe.start(0)
        try:
            sup.run_windows(trainer.init_state(args.seed), 0, ELASTIC_STEPS,
                            window_fn, 1, on_restore=pipe.skip_to)
        finally:
            pipe.stop()
        plans = [trainer.gf.plan(trainer.gf.stage_for_step(s))
                 for s in range(ELASTIC_STEPS)]
        want = expected_counts(trainer, ELASTIC_STEPS)
        want["ring_allreduce.kernel"] = sum(len(p.tasks) for p in plans)
        return dict(losses=losses, digest_at_ckpt=found["digest"],
                    plan_key=list(trainer.gf.plan_cache_key()),
                    theta=trainer.gf.bucket_elems, writes=ckpt.writes,
                    counts=dict(ops.dispatch_counts), expected_counts=want,
                    restarts=sup.restarts)

    result = {"rank": rank}
    csc_flags = ["--gf-mode", "csc", "--chunk-elems", str(CHUNK),
                 "--sparsity", str(CSC_SPARSITY), "--csc-warmup",
                 str(CSC_WARMUP)]
    try:
        args, cfg, trainer = ring_trainer(["--gf-mode", "lazy"])
        plan = trainer.engine.plan_for(None)
        check(all(t.algo.name == "pallas_ring" for t in plan.tasks),
              f"buckets' algorithms {[t.algo for t in plan.tasks]}")
        # Capture the first step's packed pool and its post-reduce pool
        # (the ring sums each bucket in place in the wire pool).
        captured = {}
        run = trainer.engine.run

        def capture(plan_, gpool, *a, **k):
            if captured:
                return run(plan_, gpool, *a, **k)
            captured["pre"] = gpool.detach().cpu().clone()
            outs = run(plan_, gpool, *a, **k)
            torch.cuda.synchronize()
            captured["post"] = gpool.detach().cpu().clone()
            return outs

        trainer.engine.run = capture
        result["lazy"] = drive(trainer, args, cfg, 2 * RING_STEPS,
                               lambda s: min(s, RING_STEPS))
        # The first step's post-reduce pool against the plain ring of the
        # two ranks' packed pools, on rank 0's CPU.
        pre = captured["pre"].view(torch.int16)
        post = captured["post"].view(torch.int16)
        if rank == 1:
            dist.send(pre, 0)
            dist.send(post, 0)
        else:
            pre1, post1 = torch.empty_like(pre), torch.empty_like(post)
            dist.recv(pre1, 1)
            dist.recv(post1, 1)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            ok = True
            for t in plan.tasks:
                xs = [x[t.start:t.end].view(torch.bfloat16)
                      for x in (pre, pre1)]
                seg = kring.plan(t.size, 2, torch.bfloat16,
                                 sms=sms)["seg_elems"]
                want = ref.ring_allreduce_ranks(xs, seg_elems=seg)[0]
                ok &= torch.equal(want.view(torch.int16),
                                  post[t.start:t.end])
                ok &= torch.equal(want.view(torch.int16),
                                  post1[t.start:t.end])
            result["first_step_matches_plain_ring"] = bool(ok)
        del trainer, captured, pre, post
        torch.cuda.empty_cache()

        # (k) guarded, a NaN written into rank 0's pool only: the ring
        # carries it to rank 1 in-band, so both ranks must trip.
        from repro_torch.configs.base import GuardConfig
        from repro_torch.runtime.faults import make_hook
        hook = make_hook(fault_events([RING_GUARD_FAULT])) \
            if rank == 0 else None
        args, cfg, trainer = ring_trainer(["--gf-mode", "lazy"],
                                          guard=GuardConfig())
        result["lazy_guarded"] = drive(trainer, args, cfg, RING_GUARD_STEPS,
                                       lambda s: s, hook=hook)
        del trainer
        torch.cuda.empty_cache()

        args, cfg, trainer = ring_trainer(csc_flags)
        result["csc"] = drive(trainer, args, cfg, RING_CSC_STEPS,
                              lambda s: s)
        del trainer
        torch.cuda.empty_cache()

        # (p) the int8 wire over the ring, lazy then CSC: the dtype of the
        # words of every ring launch is recorded.
        words = {}
        launch = kring.launch

        def recorded(x, *a, **k):
            key = str(x.dtype).split(".")[-1]
            words[key] = words.get(key, 0) + 1
            return launch(x, *a, **k)

        kring.launch = recorded
        try:
            int8 = ["--wire-format", "int8"]
            args, cfg, trainer = ring_trainer(
                ["--gf-mode", "lazy", "--chunk-elems", str(CHUNK)] + int8)
            words.clear()
            result["int8_lazy"] = drive(trainer, args, cfg, 2 * RING_STEPS,
                                        lambda s: min(s, RING_STEPS))
            result["int8_lazy"]["ring_words"] = dict(words)
            del trainer
            torch.cuda.empty_cache()
            args, cfg, trainer = ring_trainer(csc_flags + int8)
            words.clear()
            result["int8_csc"] = drive(trainer, args, cfg, RING_CSC_STEPS,
                                       lambda s: s)
            result["int8_csc"]["ring_words"] = dict(words)
            del trainer
        finally:
            kring.launch = launch
        torch.cuda.empty_cache()

        # (u) the lazy window as a CUDA graph on both ranks with a
        # deferred tail, on the batches of the lazy run above.
        args, cfg, trainer = ring_trainer(["--gf-mode", "lazy"],
                                          tail=PIPELINE_TAIL)
        result["lazy_window"] = drive_window(
            trainer, args, cfg, 2 * RING_STEPS // RING_WINDOW_K,
            lambda s: min(s, RING_STEPS))
        del trainer
        torch.cuda.empty_cache()

        # (x) CSC under the supervisor, a checkpoint at ELASTIC_AT.
        args, cfg, trainer = ring_trainer(
            csc_flags + ["--steps", str(ELASTIC_STEPS)])
        result["elastic"] = drive_elastic(trainer, args, cfg)
        del trainer
        kring.release_workspaces()
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)


def ring_ranks():
    """The two ring processes (``ring_train_worker``), run to their end;
    (their records, the directory of (x)'s checkpoints)."""
    port = free_port()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"ring_train_rank{r}.json")
            for r in range(2)]
    for o in outs:
        if os.path.exists(o):
            os.remove(o)
    elastic_dir = ckpt_dir("x")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--ring-rank", str(r), "--port", str(port),
                               "--out", outs[r], "--elastic-dir",
                               elastic_dir]) for r in range(2)]
    try:
        deadline = time.monotonic() + 600
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        fail("ring train run: ranks did not finish within 600 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"ring train run: rank exit codes {[p.returncode for p in procs]}")
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    # (x): both ranks log the same losses and a checkpoint at ELASTIC_AT
    # and at the end, one row of hg each in it (checked by elastic_phase).
    for r in ranks:
        got = r["elastic"]
        check(got["losses"] == ranks[0]["elastic"]["losses"]
              and len(got["losses"]) == ELASTIC_STEPS
              and got["restarts"] == 0
              and got["counts"] == got["expected_counts"]
              and all(math.isfinite(x) for x in got["losses"]),
              f"(x) rank {r['rank']}: {got}")
    check([w["step"] for w in ranks[0]["elastic"]["writes"]]
          == [ELASTIC_AT, ELASTIC_STEPS] and not ranks[1]["elastic"]["writes"],
          f"(x): writes rank 0 {ranks[0]['elastic']['writes']}, rank 1 "
          f"{ranks[1]['elastic']['writes']}")
    return ranks, elastic_dir


def ring_train_phase(torch, dev):
    """(c) the ring in the trainer: two processes on the one card, one
    rank each, over the cross-process (IPC) ring workspace; lazy, then
    CSC; last (x)'s two-rank part."""
    mode = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu="
                           "compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(f"compute mode: {mode.stdout.strip()}", flush=True)
    ranks, elastic_dir = ring_ranks()
    runs = {}
    for label in ("lazy", "csc", "int8_lazy", "int8_csc"):
        for r in ranks:
            got = r[label]
            check(got["residual_finite"],
                  f"ring train {label}: non-finite residual")
            check(got["counts"] == got["expected_counts"],
                  f"ring train {label} rank {r['rank']}: dispatch counts "
                  f"{got['counts']}, expected {got['expected_counts']}")
            check(got["same_params_every_step"],
                  f"ring train {label}: the ranks' parameters differ")
            check(all(math.isfinite(x) for x in got["losses"]),
                  f"ring train {label}: non-finite loss {got['losses']}")
        check(ranks[0][label]["losses"] == ranks[1][label]["losses"],
              f"ring train {label}: the ranks logged different losses")
        runs[label] = ranks[0][label]
    for label in ("lazy", "int8_lazy"):
        rep = runs[label]["losses"][RING_STEPS:]
        check(rep[-1] < rep[0], f"ring train {label}: loss did not fall on "
              f"one batch: {rep}")
    # (p): every lazy ring launch carries int8 words; CSC's dense warm-up
    # step stays bf16 (native), its sparse steps' buckets carry int8.
    key = "ring_allreduce.kernel"
    for r in ranks:
        lazy8, csc8 = r["int8_lazy"], r["int8_csc"]
        want_csc = {"bfloat16": csc8["buckets"][0],
                    "int8": sum(csc8["buckets"][1:])}
        check(lazy8["ring_words"] == {"int8": lazy8["counts"][key]},
              f"(p) rank {r['rank']}: lazy ring words {lazy8['ring_words']}")
        check(csc8["ring_words"] == want_csc and csc8["counts"][key]
              == sum(csc8["buckets"]),
              f"(p) rank {r['rank']}: CSC ring words {csc8['ring_words']}, "
              f"expected {want_csc}")
    check(ranks[0]["first_step_matches_plain_ring"],
          "ring train: the first step's post-reduce pool != the plain ring "
          "of the two ranks' packed pools")
    check(runs["csc"]["num_selected"][-1] < runs["csc"]["num_selected"][0],
          f"ring train csc: no sparse step ({runs['csc']['num_selected']})")
    # (k): both ranks trip at the faulted step only, keep the same
    # parameters (the skip: the digests before and after it are equal),
    # and launch the ring exactly as often a step as the unguarded run.
    fault_step = RING_GUARD_FAULT[0]
    want_trips = [float(s == fault_step) for s in range(RING_GUARD_STEPS)]
    per_step = ranks[0]["lazy"]["counts"][key] / (2 * RING_STEPS)
    for r in ranks:
        got = r["lazy_guarded"]
        check(got["tripped"] == want_trips and got["skipped"] == 1,
              f"ring guarded rank {r['rank']}: tripped {got['tripped']}")
        check(got["digests"][fault_step] == got["digests"][fault_step - 1],
              f"ring guarded rank {r['rank']}: the tripped step changed "
              f"the parameters")
        check(got["counts"] == got["expected_counts"]
              and got["counts"][key] == per_step * RING_GUARD_STEPS,
              f"ring guarded rank {r['rank']}: counts {got['counts']}, "
              f"unguarded {per_step} ring launches a step")
        check(got["same_params_every_step"],
              "ring guarded: the ranks' parameters differ")
    # (u): every ring launch of the windows is the warm-up body's or the
    # capture's (the replays run the rest); the losses are the eager lazy
    # run's on the same batches, bit for bit, on both ranks.
    for r in ranks:
        got = r["lazy_window"]
        st, tasks = got["stats"], got["tasks"]
        check(got["pipeline_tail"] == PIPELINE_TAIL and got["flushed"],
              f"(u) rank {r['rank']}: tail {got['pipeline_tail']}, flushed "
              f"{got['flushed']}")
        check(st["capture_counts"].get(key) == RING_WINDOW_K * tasks
              and st["warmup_counts"].get(key) == tasks
              and got["counts"][key] == (RING_WINDOW_K + 1) * tasks
              and st["captures"] == 1
              and st["replays"] == 2 * RING_STEPS // RING_WINDOW_K,
              f"(u) rank {r['rank']}: ring launches {got['counts']}, "
              f"window stats {st}")
        check(got["losses"] == r["lazy"]["losses"],
              f"(u) rank {r['rank']}: window losses {got['losses']} != the "
              f"eager run's {r['lazy']['losses']}")
        check(got["same_params_every_window"],
              "(u): the ranks' parameters differ after a window")
    note = ("world size 2 as two processes on one card: the ranks take "
            "turns on the device, so a step time is no wire's; the ring "
            "runs through this card's memory, not NVLink")
    lazy, csc_run = runs["lazy"], runs["csc"]
    return (ranks[0]["elastic"], elastic_dir,
            dict(losses=lazy["losses"][:RING_STEPS],
                 repeated_batch_losses=lazy["losses"][RING_STEPS:],
                 step_ms=[r["lazy"]["step_ms"] for r in ranks],
                 steady_step_ms=statistics.median(
                     lazy["step_ms"][1:RING_STEPS]),
                 dispatch_counts=lazy["counts"],
                 peak_mem_gib=[r["lazy"]["peak_mem_gib"] for r in ranks],
                 compute_mode=mode.stdout.strip(), note=note),
            dict(losses=csc_run["losses"],
                 step_ms=[r["csc"]["step_ms"] for r in ranks],
                 num_selected=csc_run["num_selected"],
                 ring_buckets=csc_run["buckets"],
                 dispatch_counts=csc_run["counts"],
                 peak_mem_gib=[r["csc"]["peak_mem_gib"] for r in ranks],
                 compute_mode=mode.stdout.strip(), note=note),
            dict(losses=[r["lazy_guarded"]["losses"] for r in ranks],
                 tripped=[r["lazy_guarded"]["tripped"] for r in ranks],
                 fault=list(RING_GUARD_FAULT) + ["rank 0"],
                 step_ms=[r["lazy_guarded"]["step_ms"] for r in ranks],
                 dispatch_counts=ranks[0]["lazy_guarded"]["counts"],
                 unguarded_ring_launches_per_step=per_step,
                 compute_mode=mode.stdout.strip(), note=note),
            dict(losses=ranks[0]["lazy_window"]["losses"],
                 window_stats=[r["lazy_window"]["stats"] for r in ranks],
                 dispatch_counts=ranks[0]["lazy_window"]["counts"],
                 pipeline_tail=PIPELINE_TAIL, window_steps=RING_WINDOW_K,
                 same_bits_as="the eager lazy ring run",
                 compute_mode=mode.stdout.strip(), note=note),
            *(dict(losses=runs[label]["losses"],
                   step_ms=[r[label]["step_ms"] for r in ranks],
                   num_selected=runs[label]["num_selected"],
                   ring_buckets=runs[label]["buckets"],
                   ring_words=runs[label]["ring_words"],
                   dispatch_counts=runs[label]["counts"],
                   peak_mem_gib=[r[label]["peak_mem_gib"] for r in ranks],
                   same_params_every_step=True, wire_format="int8",
                   compute_mode=mode.stdout.strip(), note=note)
              for label in ("int8_lazy", "int8_csc")))


# -- (an) the timeline and the soak, (ao) the model axis ---------------------

SOAK_LANE_KERNELS = ("pool_pack.kernel", "pool_unpack_update.kernel",
                     "chunk_l1norm.kernel", "csc_compact.kernel")


def soak_phase(torch, ops, dev) -> dict:
    """(an): ``launch.dryrun --timeline`` in each mode, then the soak at
    its defaults (300 steps, a 24-step guard lane) with the lane on the
    card against the same run with the lane on the CPU: the whole trace
    equal; ``dryrun --soak`` prints the card trace's table. The kernels'
    counts are set to 0 before the card run and read after it."""
    import contextlib
    import io

    from repro_torch.launch import dryrun
    from repro_torch.runtime import soak

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dryrun.main(argv)
        return buf.getvalue()

    t0 = time.perf_counter()
    timelines = {}
    for mode in ("dense", "lazy", "csc"):
        text = cli(["--timeline", "--timeline-mode", mode])
        check(text.startswith("[timeline] AlexNet-class pool")
              and "overlap efficiency" in text,
              f"(an) dryrun --timeline --timeline-mode {mode}: {text[:300]}")
        timelines[mode] = [ln for ln in text.splitlines()
                           if ln.startswith("backward ")][0]
    cfg = soak.SoakConfig()
    ops.reset_counts()
    t1 = time.perf_counter()
    card = soak.SoakHarness(cfg, ckpt_dir("an_card"), device=dev).run()
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    counts = dict(ops.dispatch_counts)
    t1 = time.perf_counter()
    cpu = soak.SoakHarness(cfg, ckpt_dir("an_cpu"), device="cpu").run()
    cpu_s = time.perf_counter() - t1
    check(card == cpu, "(an) the soak trace with the lane on the card != "
          "the trace with the lane on the CPU")
    table = cli(["--soak"])
    check(table.rstrip("\n") == soak.render_trace(card),
          f"(an) dryrun --soak printed {table[-400:]}")
    clear_checkpoints()
    fin = card["final"]
    check(fin["aborted"] is None and fin["completed_steps"] == cfg.num_steps
          and fin["elastic_events"] == 2,
          f"(an) soak final {fin}")
    for mode in ("lazy", "csc"):
        tt = card["guard"][mode]["truth_table"]
        check(tt["false_trips"] == 0 and all(
            r["caught"] == r["injected"] for r in tt["classes"].values()),
              f"(an) guard lane {mode}: {tt}")
    check(all(counts.get(k, 0) > 0 for k in SOAK_LANE_KERNELS)
          and not any(v for k, v in counts.items() if k.endswith(".plain")),
          f"(an) the lane's launches {counts}")
    return dict(timelines=timelines, lane_launches=counts,
                soak_card_lane_s=card_s, soak_cpu_lane_s=cpu_s,
                final=fin, seconds=time.perf_counter() - t0)


# (ao): olmo-1b at its published widths and whole depth, 1 x 4096 tokens,
# blockwise attention beyond 1024, lazy, bf16 wire, momentum SGD, kernels
# on; TP_STEPS timed steps on one repeated batch, then one more timed
# whole, the model group's all-reduces counted.
TP_LAYERS = 16
TP_CUT = {"num_layers": TP_LAYERS}
TP_STEPS = 3
TP_ARGV = ["--arch", "olmo-1b", "--seq-len", "4096", "--batch", "1",
           "--attn-chunk", "1024", "--gf-mode", "lazy", "--use-kernels",
           "--window-steps", "1", "--steps", str(TP_STEPS)]
# Then olmo-smoke in CSC through the CLI at --mesh 1x2: step 0 at the
# ramp's first sparse stage, steps 1-2 at the steady k.
TP_SMOKE_ARGV = ["--arch", "olmo-1b", "--reduced", "--gf-mode", "csc",
                 "--csc-warmup", "1", "--chunk-elems", "2048", "--batch", "2",
                 "--seq-len", "128", "--use-kernels", "--window-steps", "1",
                 "--steps", "3"]
# JAX's own bound for a (2, 2) against a (1, 1) bf16 loss stream
# (tests/test_distributed.py), and each leaf block's update norm against
# the (1, 1) run's.
TP_LOSS_RTOL = 6e-3
TP_UPDATE_RTOL = 2.0 ** -4


def axis_trainer(train_mod, argv, cut=None, f32=False, guard=False,
                 microbatches=1, overlap=None, algo=None):
    """An (ao), (ap) or (aq) trainer: ``train.build`` of ``argv`` (its
    ``--mesh``), the ModelConfig fields in ``cut`` replaced (``num_layers``,
    or ``num_experts`` of its MoEConfig), in f32 when ``f32``; with the
    numeric guard (``GuardConfig()``), ``microbatches``, ``overlap`` and
    the collective ``algo`` set, which the CLI has no flags for."""
    import dataclasses
    from repro_torch.configs.base import GuardConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.trainer import Trainer

    args = train_mod.parse_args(argv)
    _, cfg = train_mod.build(args)
    m = cfg.model
    for field, value in (cut or {}).items():
        m = dataclasses.replace(m, moe=dataclasses.replace(
            m.moe, num_experts=value)) if field == "num_experts" \
            else dataclasses.replace(m, **{field: value})
    if f32:
        m = dataclasses.replace(m, compute_dtype="float32")
    gf = cfg.gradientflow
    if guard:
        gf = dataclasses.replace(gf, guard=GuardConfig())
    if overlap:
        gf = dataclasses.replace(gf, overlap=overlap)
    if algo:
        gf = dataclasses.replace(gf, collective_algo=algo)
    cfg = cfg.replace(model=m, gradientflow=gf, microbatches=microbatches)
    shape = args.mesh_shape
    return args, cfg, Trainer(cfg, device=args.device, mesh=make_mesh(
        shape) if shape[-1] > 1 else None)


def update_norms(torch, trainer, init, final, blocks: int) -> dict:
    """{leaf: [|final - initial| of each of the ``blocks`` model ranks'
    blocks]}: the whole tree's leaves cut by the architecture's rules
    (the (1, 1) run), or one entry, this rank's own block."""
    from repro_torch.configs import rules_for
    from repro_torch.core.pool import flatten_tree
    from repro_torch.parallel import sharding

    rules = rules_for(trainer.cfg.model)
    out = {}
    for (path, spec), (_, a), (_, b) in zip(flatten_tree(trainer.specs),
                                            flatten_tree(init),
                                            flatten_tree(final)):
        d = (b - a).float()
        parts = [sharding.shard_tree(d, spec, rules, blocks, r)
                 for r in range(blocks)] if blocks > 1 else [d]
        out["/".join(path)] = [float(torch.linalg.vector_norm(x))
                               for x in parts]
    return out


def _tree_clone(tree):
    return {k: _tree_clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def replicated_names(trainer):
    """The leaves the trainer's rules replicate (none without a model
    axis)."""
    from repro_torch.core.pool import flatten_tree
    from repro_torch.parallel import sharding

    if trainer.rules is None:
        return []
    return ["/".join(path) for path, spec in flatten_tree(trainer.specs)
            if sharding.model_dim(spec, trainer.rules) is None]


def tensor_digest(tensors) -> str:
    """sha256 of the tensors' bytes on the host, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(-1).numpy().tobytes())
    return h.hexdigest()


def replica_digest(trainer, params) -> str:
    """The digest of every leaf the rules replicate: the same string on
    every rank of a model group when their copies hold the same bits."""
    from repro_torch.core.pool import flatten_tree

    names = set(replicated_names(trainer))
    return tensor_digest([x for path, x in flatten_tree(params)
                          if "/".join(path) in names])


def state_digest(state) -> str:
    """The digest of the parameters, the optimizer state and GradientFlow's
    (hg, chunk norms, the low-bit residual): what a skipped step keeps."""
    import torch
    from repro_torch.core.pool import flatten_tree

    return tensor_digest([x for _, x in flatten_tree(state.params)]
                         + [x for part in (state.opt, state.gf)
                            for x in part if isinstance(x, torch.Tensor)])


class StepDigests:
    """While entered, every train step that ``train_mod.build``'s trainers
    build appends the replicated leaves' digest (``replica_digest``) after
    it runs to ``digests``: the CLI's steps, which return no state."""

    def __init__(self, train_mod, digests):
        self.train_mod, self.digests = train_mod, digests

    def __enter__(self):
        self.real = real = self.train_mod.build
        digests = self.digests

        def build(args):
            trainer, cfg = real(args)
            inner = trainer.build_train_step

            def build_step(*a, **k):
                step = inner(*a, **k)

                def run(state, batch):
                    state, metrics = step(state, batch)
                    digests.append(replica_digest(trainer, state.params))
                    return state, metrics

                return run

            trainer.build_train_step = build_step
            return trainer, cfg

        self.train_mod.build = build
        return self

    def __exit__(self, *exc):
        self.train_mod.build = self.real


def tp_expected_all_reduces(layers: int) -> int:
    """The model group's all-reduces a step of olmo-1b's Megatron form
    with per-layer remat: the embedding's sum; per layer the attention's
    and the MLP's output sums, their input gradients' sums, and the
    attention's output sum again in the recompute (which stops once the
    backward has every tensor it saved, before the MLP's output sum:
    ``torch.utils.checkpoint``'s early stop); the head's input gradient;
    the vocab-parallel cross-entropy's max, sum of exponentials and
    target logit."""
    return 1 + 5 * layers + 1 + 3


def tp_worker(rank: int, port: int, out: str, as_dir: str) -> None:
    """One rank of (ao), (aq) and (as) at mesh (1, 2): two processes on
    this card, the model group over gloo. The olmo-1b run (``axis_run``),
    then olmo-smoke in CSC through the CLI (``train.train``), then (aq)'s
    runs (``aq_runs``), then (as)'s serving (``as_rank_runs``, against
    the references under ``as_dir``), each with the counts set to 0
    before and read after. Writes its findings to ``out`` as JSON."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        run = axis_run(torch, ops, train_mod, synthetic, "(ao)",
                       TP_ARGV + ["--mesh", "1x2"], 1, cut=TP_CUT)
        run["rank"] = rank
        ops.reset_counts()
        args = train_mod.parse_args(TP_SMOKE_ARGV + ["--mesh", "1x2"])
        digests = []
        with StepDigests(train_mod, digests):
            smoke_trainer, losses, _, stats = train_mod.train(args)
        run["smoke_csc"] = dict(
            losses=losses, dispatch_counts=dict(ops.dispatch_counts),
            replica_digests=digests,
            replicated_leaves=len(replicated_names(smoke_trainer)),
            num_selected=[smoke_trainer.gf.stage_for_step(s).num_selected
                          for s in range(args.steps)],
            num_chunks=smoke_trainer.gf.num_chunks,
            local_pool_elems=smoke_trainer.pool.size,
            global_pool_elems=smoke_trainer.global_pool,
            expected_counts=expected_counts(smoke_trainer, args.steps))
        t0 = time.perf_counter()
        run["aq"] = dict(runs=aq_runs(torch, ops, train_mod, synthetic,
                                      "1x2"))
        run["aq"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        run["as"] = as_rank_runs(torch, ops, as_dir)
        run["as"]["seconds"] = time.perf_counter() - t0
        with open(out, "w") as f:
            json.dump(run, f)
    finally:
        dist.destroy_process_group()


def model_axis_phase(torch, ops, train_mod, synthetic):
    """(ao), (aq) and (as): the (1, 1) runs in this process, then the two
    (1, 2) ranks (``tp_worker``) on the same weights. (ao): the losses
    within TP_LOSS_RTOL of the (1, 1) run's, each leaf block's update
    norm within TP_UPDATE_RTOL, the model group's all-reduces a step as
    the Megatron form counts them, the local pool half the (1, 1) pool;
    (aq): see ``aq_checks``; (as): see ``as_checks``. Returns ((ao)'s
    record, (aq)'s, (as)'s)."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    ref = axis_run(torch, ops, train_mod, synthetic, "(ao)", TP_ARGV, 2,
                   cut=TP_CUT)
    ref_norms = ref.pop("update_norms")
    ref_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    aq_ref = aq_runs(torch, ops, train_mod, synthetic, None)
    aq_ref_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    as_dir = tempfile.mkdtemp(prefix="chip_smoke_as_")
    as_ref = as_reference(torch, ops, as_dir)
    as_ref["seconds"] = time.perf_counter() - t1
    port = free_port()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"tp_rank{r}.json") for r in range(2)]
    for o in outs:
        if os.path.exists(o):
            os.remove(o)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--tp-rank", str(r), "--port", str(port),
                               "--out", outs[r], "--as-dir", as_dir])
             for r in range(2)]
    try:
        deadline = time.monotonic() + 460
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        fail("(ao)/(aq)/(as): the ranks did not finish within 460 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(as_dir, ignore_errors=True)
    check(all(p.returncode == 0 for p in procs),
          f"(ao)/(aq): rank exit codes {[p.returncode for p in procs]}")
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    aq_ranks = [dict(r.pop("aq"), rank=r["rank"]) for r in ranks]
    as_ranks = [dict(r.pop("as"), rank=r["rank"]) for r in ranks]
    want_ar = tp_expected_all_reduces(TP_LAYERS)
    for r in ranks:
        lab = f"(ao) rank {r['rank']}"
        check(r["losses"] == ranks[0]["losses"],
              f"{lab}: losses {r['losses']} != rank 0's")
        err = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                      ref["losses"]))
        check(err <= TP_LOSS_RTOL and all(math.isfinite(x)
                                          for x in r["losses"]),
              f"{lab}: losses {r['losses']} against (1, 1) {ref['losses']}")
        r["loss_rel_err_vs_1x1"] = err
        check(2 * r["local_pool_elems"] == ref["local_pool_elems"]
              == r["global_pool_elems"],
              f"{lab}: local pool {r['local_pool_elems']}, (1, 1) pool "
              f"{ref['local_pool_elems']}")
        check(all(s["all_reduces"] == want_ar
                  for s in r["model_all_reduces"]),
              f"{lab}: model all-reduces a step {r['model_all_reduces']}, "
              f"expected {want_ar}")
        worst = 0.0
        for name, (got,) in r["update_norms"].items():
            want = ref_norms[name][r["model_index"]]
            if want:
                worst = max(worst, abs(got - want) / want)
        check(worst <= TP_UPDATE_RTOL,
              f"{lab}: update norms off by {worst} relative")
        r["update_norm_rel_err_vs_1x1"] = worst
        sm = r["smoke_csc"]
        check(sm["dispatch_counts"] == sm["expected_counts"]
              and sm["dispatch_counts"].get("csc_compact.kernel", 0) > 0
              and all(math.isfinite(x) for x in sm["losses"]),
              f"{lab} smoke CSC: {sm}")
        # CSC's summed selection: the replicated leaves' copies the same
        # bits on both ranks after every step (olmo has none: its norms
        # are non-parametric; (aq) checks a family that has them).
        check(sm["replica_digests"]
              == ranks[0]["smoke_csc"]["replica_digests"]
              and len(sm["replica_digests"]) == len(sm["losses"]),
              f"{lab} smoke CSC: replicated leaves differ across ranks")
        del r["update_norms"]
    note = ("mesh (1, 2) as two processes on one card: the ranks take "
            "turns on the device (time-sliced), and the model group's "
            "all-reduces go through pinned host memory and gloo; a step "
            "time is no NVLink's")
    counts = {}
    for r in ranks:
        for src in (r["dispatch_counts"], r["smoke_csc"]["dispatch_counts"]):
            for k, v in src.items():
                counts[k] = counts.get(k, 0) + v
    tp = dict(
        arch="olmo-1b", mesh=[1, 2], layers=TP_LAYERS,
        reduced=({} if TP_LAYERS == 16 else {"num_layers": [16, TP_LAYERS]}),
        tokens=4096, reference_1x1=dict(
            losses=ref["losses"], steady_step_ms=ref["steady_step_ms"],
            peak_mem_gib=ref["peak_mem_gib"],
            pool_elems=ref["local_pool_elems"],
            dispatch_counts=ref["dispatch_counts"], seconds=ref_s),
        ranks=ranks, expected_model_all_reduces_per_step=want_ar,
        loss_rtol=TP_LOSS_RTOL, update_rtol=TP_UPDATE_RTOL,
        dispatch_counts_both_ranks=counts, note=note,
        seconds=time.perf_counter() - t0)
    aq = aq_checks(aq_ref, aq_ranks, aq_ref_s, note)
    serving = as_checks(as_ref, as_ranks, note)
    serving["reference_seconds"] = as_ref["seconds"]
    return tp, aq, serving


# -- (aq) the update path under the model axis -------------------------------

# (aq): olmo-1b at its published widths (d_model 2048, 16 heads, d_ff
# 8192, vocab 50304) and AQ_LAYERS of its 16 layers, 2 x 4096 tokens in
# AQ_MICROBATCHES microbatches, blockwise attention beyond 1024, lazy,
# staged, kernels on, with the numeric guard (GuardConfig()), the int8
# wire with error feedback and LARS: AQ_STEPS steps on one repeated batch
# and one more timed whole, at (1, 1) in
# this process and at mesh (1, 2) in (ao)'s two rank processes.
AQ_LAYERS = 4
AQ_CUT = {"num_layers": AQ_LAYERS}
AQ_STEPS = 2
AQ_MICROBATCHES = 2
AQ_ARGV = ["--arch", "olmo-1b", "--seq-len", "4096", "--batch", "2",
           "--attn-chunk", "1024", "--gf-mode", "lazy", "--use-kernels",
           "--window-steps", "1", "--steps", str(AQ_STEPS), "--optimizer",
           "lars", "--wire-format", "int8"]
# Then at both meshes olmo-smoke with AdamW, monolithic, on the fp8 wire
# (f32 compute, TF32 off).
AQ_ADAMW_ARGV = ["--arch", "olmo-1b", "--reduced", "--use-kernels",
                 "--batch", "2", "--seq-len", "128", "--window-steps", "1",
                 "--steps", "2", "--gf-mode", "lazy", "--optimizer",
                 "adamw", "--lr", "1e-3", "--wire-format", "fp8_e4m3"]
# At (1, 2) only: arctic-smoke in CSC through the CLI, every step sparse
# (the ramp's first stage, then the steady k): its attention and router
# are replicated, the leaves whose copies parted before the summed
# selection (ROADMAP.md C.1).
AQ_CSC_STEPS = 4
AQ_CSC_ARGV = ["--arch", "arctic-480b", "--reduced", "--gf-mode", "csc",
               "--csc-warmup", "1", "--chunk-elems", "2048", "--batch", "2",
               "--seq-len", "128", "--use-kernels", "--window-steps", "1",
               "--steps", str(AQ_CSC_STEPS), "--mesh", "1x2"]
# And olmo-smoke guarded on the int8 wire with error feedback, 3 steps
# on one batch, a NaN written into rank 1's block of its first sharded
# leaf at step 1 (rank 0's pool stays clean).
AQ_FAULT_ARGV = ["--arch", "olmo-1b", "--reduced", "--use-kernels",
                 "--batch", "2", "--seq-len", "128", "--window-steps", "1",
                 "--steps", "3", "--gf-mode", "lazy", "--wire-format",
                 "int8", "--mesh", "1x2"]
AQ_FAULT_STEP = 1


def aq_expected_all_reduces(layers: int, microbatches: int) -> int:
    """(ao)'s Megatron count for each microbatch's forward and backward,
    and the guard's one group verdict a step."""
    return microbatches * tp_expected_all_reduces(layers) + 1


def aq_runs(torch, ops, train_mod, synthetic, mesh):
    """(aq)'s runs of one process at ``mesh`` (``--mesh`` 1x2, or None
    for (1, 1)): the olmo-1b update path, the AdamW smoke run and, at
    (1, 2), the CSC CLI run and the one-rank fault."""
    extra = ["--mesh", mesh] if mesh else []
    blocks = 1 if mesh else 2
    runs = {"olmo-1b": axis_run(
        torch, ops, train_mod, synthetic, "(aq)", AQ_ARGV + extra, blocks,
        cut=AQ_CUT, guard=True, microbatches=AQ_MICROBATCHES,
        lars_first=True)}
    runs["olmo-1b-smoke adamw monolithic fp8"] = axis_run(
        torch, ops, train_mod, synthetic, "(aq)", AQ_ADAMW_ARGV + extra,
        blocks, timed=False, f32=True, overlap="monolithic")
    if mesh:
        runs["arctic-480b-smoke csc cli"] = aq_csc_cli(ops, train_mod)
        runs["olmo-1b-smoke guarded int8 fault"] = aq_fault_run(
            torch, ops, train_mod, synthetic)
    return runs


def aq_csc_cli(ops, train_mod) -> dict:
    """The CSC CLI at ``--mesh 1x2`` with the replicated leaves' digest
    taken after every step (``StepDigests``)."""
    ops.reset_counts()
    args = train_mod.parse_args(AQ_CSC_ARGV)
    digests = []
    before = model_axis_counts()
    with StepDigests(train_mod, digests):
        trainer, losses, _, _ = train_mod.train(args)
    counts = dict(ops.dispatch_counts)
    return dict(losses=losses, dispatch_counts=counts,
                expected_counts=expected_counts(trainer, args.steps),
                num_selected=[trainer.gf.stage_for_step(s).num_selected
                              for s in range(args.steps)],
                num_chunks=trainer.gf.num_chunks, replica_digests=digests,
                replicated_leaves=len(replicated_names(trainer)),
                model_all_reduces=model_axis_counts(before)["all_reduces"])


def model_axis_counts(before=None) -> dict:
    """The model group's all-reduces and their bytes
    (``runtime.trace``'s ``model_axis`` counters), less ``before``'s."""
    from repro_torch.runtime import trace

    now = dict(trace.counters["model_axis"])
    return {k: v - before[k] for k, v in now.items()} if before else now


def aq_fault_run(torch, ops, train_mod, synthetic) -> dict:
    """AQ_FAULT_ARGV guarded at (1, 2) with a NaN in rank 1's block of the
    first sharded leaf at step AQ_FAULT_STEP: each step's verdict, scale
    and whether the whole state (parameters, momentum, residual) kept its
    bits (``state_digest`` before and after)."""
    from repro_torch.core.pool import flatten_tree
    from repro_torch.parallel import sharding
    from repro_torch.runtime import faults

    args, cfg, trainer = axis_trainer(train_mod, AQ_FAULT_ARGV, guard=True)
    params = trainer.shard_params(trainer.model.init_params(
        args.seed, trainer.device, on_device=True))
    state = trainer.init_state(params=params)
    batch = synthetic.SyntheticLM(cfg.model.vocab_size, seed=args.seed) \
        .batch(0, cfg.global_batch, cfg.seq_len)
    leaf = next(i for i, (_, spec) in enumerate(flatten_tree(trainer.specs))
                if sharding.model_dim(spec, trainer.rules) is not None)
    events = [faults.FaultEvent(step=AQ_FAULT_STEP, kind="nan",
                                offset=trainer.pool.offsets[leaf] + 3,
                                width=4)] \
        if trainer.mesh.model_index == 1 else []
    step = trainer.build_train_step(fault_hook=faults.make_hook(events))
    ops.reset_counts()
    tripped, scales, kept, losses = [], [], [], []
    for _ in range(args.steps):
        before = state_digest(state)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        tripped.append(float(metrics["guard_tripped"]))
        scales.append(float(state.guard.scale))
        kept.append(state_digest(state) == before)
    counts = dict(ops.dispatch_counts)
    want = expected_counts(trainer, args.steps)
    check(counts == want, f"(aq) fault run: dispatch counts {counts}, "
          f"expected {want}")
    return dict(losses=losses, tripped=tripped, scales=scales, kept=kept,
                injected=len(events), leaf=trainer.pool.specs[leaf].name,
                dispatch_counts=counts, expected_counts=want)


def aq_checks(ref, ranks, ref_s, note) -> dict:
    """(aq)'s checks on the two ranks' runs against the (1, 1) runs:

    * olmo-1b: the ranks' losses equal and within TP_LOSS_RTOL of (1, 1)'s,
      no step tripped, the model group's all-reduces a step
      ``aq_expected_all_reduces``. LARS's trust ratios are per shard in
      both packages (a rank's local spans), so a sharded leaf's block
      moves by its own ratio at (1, 2) and by the whole leaf's at (1, 1):
      the update norms are compared with that ratio divided out. From the
      zero momentum the first step moves a block by lr * ratio * |g + wd
      w| over it, so each block's first-step update norm over the ratio
      its update used is held within TP_UPDATE_RTOL of the (1, 1) block's
      over the whole leaf's ratio;
    * the AdamW smoke run: the ranks' losses equal and within TP_LOSS_RTOL
      of (1, 1)'s, each leaf block's update norm within TP_UPDATE_RTOL;
    * the CSC CLI: every step sparse, the ranks' losses equal and finite,
      the replicated leaves' digests equal on both ranks after every step;
    * the fault: only rank 1 injected; both ranks trip at AQ_FAULT_STEP
      and only there, keep every bit of their state there, halve the
      scale from GuardConfig().init_scale, and commit the other steps.
    """
    counts = {}
    want_ar = aq_expected_all_reduces(AQ_LAYERS, AQ_MICROBATCHES)
    spread = 0.0
    for r in ranks:
        idx = r["rank"]
        for label, run in r["runs"].items():
            lab = f"(aq) rank {idx} {label}"
            first = ranks[0]["runs"][label]
            check(run["losses"] == first["losses"]
                  and all(math.isfinite(x) for x in run["losses"]),
                  f"{lab}: losses {run['losses']} != rank 0's")
            for k, v in run["dispatch_counts"].items():
                counts[k] = counts.get(k, 0) + v
            if label in ref:
                want = ref[label]
                err = max(rel(a, b) for a, b in zip(run["losses"],
                                                    want["losses"]))
                check(err <= TP_LOSS_RTOL, f"{lab}: losses {run['losses']} "
                      f"against (1, 1) {want['losses']}")
                run["loss_rel_err_vs_1x1"] = err
                check(run["global_pool_elems"] == 2 * run["local_pool_elems"],
                      f"{lab}: local pool {run['local_pool_elems']}")
            if label == "olmo-1b":
                check(not any(run["tripped"]) and not any(want["tripped"]),
                      f"{lab}: tripped {run['tripped']}, (1, 1) "
                      f"{want['tripped']}")
                check(all(s["all_reduces"] == want_ar
                          for s in run["model_all_reduces"]),
                      f"{lab}: model all-reduces a step "
                      f"{run['model_all_reduces']}, expected {want_ar}")
                worst = 0.0
                for name, ((n, ratio),) in \
                        run["first_step_update_and_ratio"].items():
                    wn, wr = want["first_step_update_and_ratio"][name][idx]
                    if wn:
                        worst = max(worst, rel(n / ratio, wn / wr))
                        spread = max(spread, abs(ratio / wr - 1.0))
                check(worst <= TP_UPDATE_RTOL, f"{lab}: first-step update "
                      f"norms over their ratios off by {worst} relative")
                run["first_step_update_over_ratio_rel_err_vs_1x1"] = worst
                del run["first_step_update_and_ratio"]
            elif label in ref:
                worst = 0.0
                for name, (got,) in run["update_norms"].items():
                    w = want["update_norms"][name][idx]
                    if w:
                        worst = max(worst, rel(got, w))
                check(worst <= TP_UPDATE_RTOL,
                      f"{lab}: update norms off by {worst} relative")
                run["update_norm_rel_err_vs_1x1"] = worst
            elif "csc" in label:
                check(all(k < run["num_chunks"]
                          for k in run["num_selected"])
                      and len(run["num_selected"]) >= 3
                      and run["dispatch_counts"] == run["expected_counts"]
                      and run["dispatch_counts"].get("csc_compact.kernel", 0)
                      > 0, f"{lab}: {run}")
                check(run["replicated_leaves"] > 0
                      and len(run["replica_digests"]) == AQ_CSC_STEPS
                      and run["replica_digests"]
                      == first["replica_digests"],
                      f"{lab}: the replicated leaves differ across ranks")
            else:
                from repro_torch.configs.base import GuardConfig
                init = GuardConfig().init_scale
                want_trip = [float(t == AQ_FAULT_STEP)
                             for t in range(len(run["tripped"]))]
                check(run["tripped"] == want_trip
                      and run["kept"] == [t == AQ_FAULT_STEP
                                          for t in range(len(run["kept"]))]
                      and run["scales"] == first["scales"]
                      == [init if t < AQ_FAULT_STEP else init / 2
                          for t in range(len(run["scales"]))]
                      and run["injected"] == idx,
                      f"{lab}: tripped {run['tripped']}, kept {run['kept']}, "
                      f"scales {run['scales']}, injected {run['injected']}")
            run.pop("update_norms", None)
    for run in ref.values():
        run.pop("update_norms", None)
        run.pop("first_step_update_and_ratio", None)
    return dict(
        arch="olmo-1b", mesh=[1, 2], layers=AQ_LAYERS,
        reduced={"num_layers": [16, AQ_LAYERS]}, tokens=2 * 4096,
        microbatches=AQ_MICROBATCHES, reference_1x1=ref,
        reference_seconds=ref_s, ranks=ranks,
        expected_model_all_reduces_per_step=want_ar,
        loss_rtol=TP_LOSS_RTOL, update_rtol=TP_UPDATE_RTOL,
        lars_ratio_spread_vs_1x1=spread, dispatch_counts_both_ranks=counts,
        note=note, seconds=ref_s + max(r["seconds"] for r in ranks))


# -- (as) serving under the model axis ---------------------------------------

# (as): serving at mesh (1, 2) as (ao)'s two rank processes, after (aq),
# against the (1, 1) run in this process on the same bf16 weights (drawn
# from AS_SEED, ``serve.serve_params``), prompts and teacher-forced decode
# tokens (the (1, 1) naive run's greedy tokens): (as-1) olmo-1b whole at
# its published widths (its rules split the KV heads over 'model'), batch
# 4; (as-2) qwen3-32b at its widths with 2 of its 64 layers (8 KV heads
# that the rules leave replicated: the cache is split by position, the
# query heads sharded), batch 2, naive, split_combine and flash_decode's
# rules. A 512-token prompt and 32 decode steps each, a cache of 544
# positions in bf16, bf16 compute.
AS_SEED = 0
AS_PROMPT, AS_DECODE = 512, 32
AS_CASES = {
    "as-1": dict(arch="olmo-1b", cut={}, batch=4,
                 variants=(("naive", {}),
                           ("split_combine", {"split_combine": True}))),
    "as-2": dict(arch="qwen3-32b", cut={"num_layers": 2}, batch=2,
                 variants=(("naive", {}),
                           ("split_combine", {"split_combine": True}),
                           ("flash_decode", {"flash_decode": True}))),
}
# Each call's logits against the (1, 1) naive run's, bf16 sums in
# another order: the largest gap relative to the largest |logit|.
AS_LOGIT_RTOL = 2.0 ** -4


def _cache_tensors(cache):
    if hasattr(cache, "_fields"):
        return [t for f in cache for t in _cache_tensors(f)]
    return [cache]


def no_sync_but_model_group(torch, label, axis, fn):
    """``fn()`` (one decode step) under ``set_sync_debug_mode('error')``,
    the model group's all-reduces excepted (their gloo transport stages
    each tensor through host memory, which waits for the stream by
    design): any other host synchronisation fails the run."""
    real = axis.all_reduce_

    def staged(x, *a, **k):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(x, *a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")
    axis.all_reduce_ = staged
    try:
        return no_host_sync(torch, label, fn)
    finally:
        del axis.all_reduce_


def as_case(torch, dev, label, case, mesh_shape, ref):
    """One (as) case at ``mesh_shape`` ((1, 2)) or on one device (None):
    each variant's prefill and AS_DECODE decode steps, teacher-forced by
    ``ref['tokens']`` (the (1, 1) naive run's greedy tokens; None: its
    own), timed a call each (host clock, synchronised). Returns the
    record and, without a reference, the reference (tokens and each
    call's logits)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.trainer import Trainer

    c = AS_CASES[case]
    cfg = dataclasses.replace(get_arch(c["arch"])[0], **c["cut"])
    b, n = c["batch"], AS_PROMPT + AS_DECODE
    trainer = Trainer(TrainConfig(model=cfg, global_batch=b, seq_len=n),
                      device=dev,
                      mesh=make_mesh(mesh_shape) if mesh_shape else None)
    sc = ShapeConfig(name="serve", seq_len=n, global_batch=b, kind="decode")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = trainer.serve_local(trainer.shard_params(
        serve_mod.serve_params(trainer.model, AS_SEED, dev)))
    torch.cuda.empty_cache()
    prompts = serve_mod.draw_prompts(cfg, b, AS_PROMPT, AS_SEED, dev)
    out = dict(arch=c["arch"], reduced=c["cut"], batch=b, prompt=AS_PROMPT,
               decode_steps=AS_DECODE, mesh=list(mesh_shape or (1, 1)),
               param_bytes=sum(t.numel() * t.element_size() for t in
                               _tree_tensors(params)), variants={})
    new_ref = None
    for name, kw in c["variants"]:
        prefill, rules = trainer.build_serve_step(sc, mode="prefill")
        decode, d_rules = trainer.build_serve_step(sc, mode="decode", **kw)
        cache = trainer.init_serve_cache(sc, rules)
        axis = decode.model_axis
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(params, {"tokens": prompts}, cache)
        first = lg[:, -1].float()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        del lg
        src = ref if ref is not None else new_ref
        forced = src["tokens"] if src is not None else None
        own = [torch.argmax(first, dim=-1)]
        logits, ms, stats = [first], [], []
        for t in range(AS_DECODE):
            tok = (forced[:, t] if forced is not None else own[-1]) \
                .view(b, 1).to(torch.int32)
            before = model_axis_counts()
            call = (lambda tok=tok: decode(params, {"tokens": tok}, cache))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if t == 1:
                lg, cache = no_host_sync(torch, f"{label} {name}", call) \
                    if axis is None else no_sync_but_model_group(
                        torch, f"{label} {name}", axis, call)
            else:
                lg, cache = call()
            row = lg[:, 0].float()
            own.append(torch.argmax(row, dim=-1))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(row)
            if axis is not None:
                stats.append(model_axis_counts(before))
        rec = dict(prefill_ms=prefill_ms, decode_ms=ms,
                   decode_median_ms=statistics.median(ms[:-1]),
                   # k and v (the per-layer index, replicated, apart)
                   cache_bytes=sum(t.numel() * t.element_size()
                                   for t in _cache_tensors(cache)
                                   if t.dim() > 1),
                   rules={k: v for k, v in d_rules.items()
                          if k in ("serve_batch", "kv_seq", "kv_heads",
                                   "heads", "qkv")},
                   tokens_finite=all(bool(torch.isfinite(x).all())
                                     for x in logits))
        if axis is not None:
            rec.update(
                model_all_reduces=[s["all_reduces"] for s in stats],
                model_all_reduce_bytes=stats[0]["bytes"],
                expected_model_all_reduces=(
                    trainer.expected_serve_all_reduces("decode", d_rules)),
                expected_prefill_all_reduces=(
                    trainer.expected_serve_all_reduces("prefill", rules)))
        stacked = torch.stack(logits)                     # (1 + D, b, V)
        tokens = torch.stack(own, dim=1)                  # (b, 1 + D)
        if ref is None and name == "naive":
            new_ref = dict(tokens=tokens, logits=stacked)
        want = ref if ref is not None else new_ref
        top = want["logits"].abs().amax(dim=-1)           # (1 + D, b)
        gap = ((stacked - want["logits"]).abs().amax(dim=-1) / top)
        rec["logit_rel_gap_vs_1x1_naive"] = float(gap.max())
        parted = (tokens != want["tokens"]).any(dim=0).nonzero()
        rec["greedy_first_parts_at_step"] = \
            int(parted[0]) if len(parted) else None
        rec["logits_digest"] = tensor_digest([stacked])
        out["variants"][name] = rec
        del cache, stacked, logits
        torch.cuda.empty_cache()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params
    torch.cuda.empty_cache()
    return out, new_ref


def _tree_tensors(tree):
    return [t for v in tree.values() for t in (
        _tree_tensors(v) if isinstance(v, dict) else [v])]


def as_reference(torch, ops, ref_dir):
    """The (1, 1) runs of (as) in this process; their references saved
    under ``ref_dir`` for the ranks. Returns {case: record}."""
    ops.reset_counts()
    out = {}
    for case in AS_CASES:
        t0 = time.perf_counter()
        rec, ref = as_case(torch, torch.device("cuda"), f"({case}) 1x1",
                           case, None, None)
        torch.save({k: v.cpu() for k, v in ref.items()},
                   os.path.join(ref_dir, f"{case}.pt"))
        rec["seconds"] = time.perf_counter() - t0
        out[case] = rec
    out["dispatch_counts"] = dict(ops.dispatch_counts)
    return out


def as_rank_runs(torch, ops, ref_dir) -> dict:
    """One rank's (as) runs at mesh (1, 2), each teacher-forced by the
    (1, 1) reference, the kernels' counts set to 0 before and read
    after."""
    ops.reset_counts()
    out = {}
    for case in AS_CASES:
        t0 = time.perf_counter()
        dev = torch.device("cuda")
        ref = {k: v.to(dev) for k, v in torch.load(
            os.path.join(ref_dir, f"{case}.pt")).items()}
        out[case], _ = as_case(torch, dev, f"({case})", case, (1, 2), ref)
        out[case]["seconds"] = time.perf_counter() - t0
    out["dispatch_counts"] = dict(ops.dispatch_counts)
    return out


def as_checks(ref, ranks, note) -> dict:
    """(as): per rank and variant, finite logits within AS_LOGIT_RTOL of
    the (1, 1) naive run's, the ranks' logits the same bits, the model
    group's all-reduces of every decode step the expected function's,
    the cache half the (1, 1) cache, no host sync but the model group's
    (checked in the run), flash_decode's logits the naive's bits, and no
    pool kernel launched."""
    counts = {}
    for r in ranks:
        for k, v in r["dispatch_counts"].items():
            counts[k] = counts.get(k, 0) + v
    check(launched(counts) | launched(ref["dispatch_counts"]) <= {ATTN_KEY},
          f"(as) launched a pool kernel: {counts}")
    for case in AS_CASES:
        one = ref[case]
        for name, want in one["variants"].items():
            for r in ranks:
                got = r[case]["variants"][name]
                lab = f"({case}) {name} rank {r['rank']}"
                check(got["tokens_finite"] and
                      got["logit_rel_gap_vs_1x1_naive"] <= AS_LOGIT_RTOL,
                      f"{lab}: logits {got['logit_rel_gap_vs_1x1_naive']} "
                      f"from (1, 1)'s (bound {AS_LOGIT_RTOL})")
                check(got["logits_digest"]
                      == ranks[0][case]["variants"][name]["logits_digest"],
                      f"{lab}: logits differ from rank 0's")
                check(all(x == got["expected_model_all_reduces"]
                          for x in got["model_all_reduces"]),
                      f"{lab}: model all-reduces a decode step "
                      f"{got['model_all_reduces']}, expected "
                      f"{got['expected_model_all_reduces']}")
                check(2 * got["cache_bytes"] == want["cache_bytes"],
                      f"{lab}: cache {got['cache_bytes']} B a rank, (1, 1) "
                      f"{want['cache_bytes']} B")
        if "flash_decode" in one["variants"]:
            for r in ranks:
                v = r[case]["variants"]
                check(v["flash_decode"]["logits_digest"]
                      == v["naive"]["logits_digest"],
                      f"({case}) rank {r['rank']}: flash_decode's logits "
                      f"are not the naive step's")
    return dict(reference_1x1={k: ref[k] for k in AS_CASES},
                ranks=[{k: r[k] for k in list(AS_CASES) + ["rank",
                                                            "seconds"]}
                       for r in ranks],
                logit_rtol=AS_LOGIT_RTOL, dispatch_counts_both_ranks=counts,
                note=note)


# -- (ap) the model axis for the other families ------------------------------

# (ap): arctic-480b at (ac)'s cut (its published widths, 1 of 35 layers,
# 16 of 128 experts: 2,354,451,456 parameters) at 1 x 4096 tokens,
# blockwise attention beyond 1024, lazy, bf16 wire, momentum SGD, kernels
# on; AP_STEPS timed steps on one repeated batch and one more timed
# whole, at (1, 1) in this process and at mesh
# (1, 2) as two processes on this card. Its rules shard the experts
# (expert parallelism: each rank holds 8 of the 16) and leave attention
# replicated. Held to (ao)'s bounds.
AP_STEPS = 2
AP_ARGV = ["--arch", "arctic-480b", "--seq-len", str(OLMO_SEQ), "--batch",
           "1", "--attn-chunk", str(OLMO_CHUNK), "--gf-mode", "lazy",
           "--use-kernels", "--window-steps", "1", "--steps", str(AP_STEPS)]
# Embedding sum; the MoE layer's output sum (its dense residual's with
# it), its input's and its gates' gradient sums (the recompute stops
# before the output sum, as (ao)'s does); the head's input gradient; the
# cross-entropy's max, sum of exponentials and target logit.
AP_ALL_REDUCES = 1 + 3 * ARCTIC_CUT["num_layers"] + 1 + 3
# Then every other family's smoke configuration in f32 compute (TF32
# off), AP_SMOKE_STEPS lazy steps on one batch at (1, 1) and at (1, 2)
# from the same seed, and falcon-mamba-smoke in CSC (the ramp's first
# sparse stage, then the next: the census and the gather on each rank's
# local pool). f32 sums in other orders: the losses and each leaf
# block's update norm within AP_SMOKE_RTOL; CSC selects on the model
# group's summed norms at (1, 2) and on the whole pool's at (1, 1), so
# only its first loss (before any update) is held to the (1, 1) run's.
# Every smoke run's replicated leaves the same bits on both ranks after
# every step.
AP_SMOKE = ("arctic-480b", "grok-1-314b", "internvl2-26b", "musicgen-large",
            "falcon-mamba-7b", "zamba2-2.7b")
AP_SMOKE_STEPS = 2
AP_SMOKE_ARGV = ["--reduced", "--use-kernels", "--batch", "2", "--seq-len",
                 "128", "--window-steps", "1", "--steps",
                 str(AP_SMOKE_STEPS)]
AP_CSC_ARGV = ["--gf-mode", "csc", "--csc-warmup", "1", "--chunk-elems",
               "2048"]
AP_SMOKE_RTOL = 1e-4


def axis_run(torch, ops, train_mod, synthetic, label, argv, blocks,
             cut=None, timed=True, f32=False, guard=False, microbatches=1,
             overlap=None, digests=False, lars_first=False):
    """One process's (ao), (ap) or (aq) run (``axis_trainer``) on one
    repeated batch (the synthetic stream's first; the vlm's from
    ``make_batch``): weights drawn on the card from the seed (the whole
    tree, then this rank's blocks), the counts set to 0 before the steps
    and read after them, the dispatch counts the step plans', step ms,
    peak memory, the model group's all-reduces a step, the routing of the
    first step (the MoE), each leaf block's update norm (``update_norms``
    over ``blocks`` blocks); guarded, each step's verdict; ``digests``:
    the replicated leaves' digest after each step; ``lars_first``: each
    leaf block's first-step update norm beside the trust ratio its update
    used; ``timed``: one more step, timed whole."""
    args, cfg, trainer = axis_trainer(train_mod, argv, cut, f32, guard,
                                      microbatches, overlap)
    m = cfg.model
    first_ratios = {}
    if lars_first:
        real_ratios = trainer.lars.ratios_view

        def ratios_view(view, *a, **k):
            r = real_ratios(view, *a, **k)
            if not first_ratios.get("done"):
                for i, x in zip(range(view.leaf_lo, view.leaf_hi),
                                r.tolist()):
                    first_ratios[trainer.pool.specs[i].name] = x
            return r

        trainer.lars.ratios_view = ratios_view
    params = trainer.shard_params(trainer.model.init_params(
        args.seed, trainer.device, on_device=True))
    init = _tree_clone(params)
    state = trainer.init_state(params=params)
    if m.family == "vlm":
        batch = vlm_batch_fn(torch, args.seed)(cfg, 0)
    else:
        batch = synthetic.SyntheticLM(
            m.vocab_size, seed=args.seed, num_codebooks=m.num_codebooks) \
            .batch(0, cfg.global_batch, cfg.seq_len)
    axis = trainer.model_axis
    steps = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    losses, seconds, per_step, routing = [], [], [], None
    tripped, digest, first = [], [], None
    for t in range(args.steps):
        stage = trainer.gf.stage_for_step(t)
        if stage.index not in steps:
            steps[stage.index] = trainer.build_train_step(stage)
        before = model_axis_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if t == 0 and m.moe is not None:
            with MoERouting(torch) as probe:
                state, metrics = steps[stage.index](state, batch)
                losses.append(float(metrics["loss"]))
            routing = probe.summary(cfg.remat == "layer")
        else:
            state, metrics = steps[stage.index](state, batch)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if axis is not None:
            per_step.append(model_axis_counts(before))
        if guard:
            tripped.append(float(metrics["guard_tripped"]))
        if digests:
            digest.append(replica_digest(trainer, state.params))
        if lars_first and t == 0:
            first_ratios["done"] = True
            norms0 = update_norms(torch, trainer, init, state.params, blocks)
            first = {name: [[n, first_ratios[name]] for n in ns]
                     for name, ns in norms0.items()}
    counts = dict(ops.dispatch_counts)
    peak = torch.cuda.max_memory_allocated()
    want = expected_counts(trainer, args.steps)
    lab = f"{label} {args.arch} at {args.mesh_shape}"
    check(counts == want, f"{lab}: dispatch counts {counts}, expected "
          f"{want}")
    check(all(math.isfinite(x) for x in losses), f"{lab}: losses {losses}")
    norms = update_norms(torch, trainer, init, state.params, blocks)
    timed_step = None
    if timed and axis is not None:
        before = model_axis_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = steps[trainer.gf.stage_for_step(
            args.steps).index](state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        timed_step = dict(model_axis_counts(before),
                          step_s=time.perf_counter() - t0)
    from repro_torch.configs import rules_for
    from repro_torch.parallel import sharding
    out = dict(arch=args.arch, config="SMOKE" if args.reduced else "CONFIG",
               family=m.family, mesh=list(args.mesh_shape),
               mode=cfg.gradientflow.mode, compute_dtype=m.compute_dtype,
               losses=losses, step_ms=[x * 1e3 for x in seconds],
               steady_step_ms=statistics.median(seconds[1:]) * 1e3,
               peak_mem_gib=peak / 2 ** 30, dispatch_counts=counts,
               model_index=trainer.mesh.model_index if trainer.mesh else 0,
               params=sharding.count_params(trainer.specs),
               local_params=sharding.count_params(trainer.local_specs),
               local_params_at_2=sharding.count_params(
                   sharding.localize_specs(trainer.specs,
                                           rules_for(m), 2)),
               local_pool_elems=trainer.pool.size,
               global_pool_elems=trainer.global_pool, update_norms=norms,
               model_all_reduces=per_step, timed_step=timed_step)
    if routing is not None:
        out["routing"] = routing
    if guard:
        out["tripped"] = tripped
        out["scale"] = float(state.guard.scale)
    if digests:
        out["replica_digests"] = digest
        out["replicated_leaves"] = len(replicated_names(trainer))
    if first is not None:
        out["first_step_update_and_ratio"] = first
    del state, steps, trainer
    torch.cuda.empty_cache()
    return out


def ap_smoke_argv(arch, csc=False):
    return ["--arch", arch] + AP_SMOKE_ARGV + (
        AP_CSC_ARGV if csc else ["--gf-mode", "lazy"])


def ap_runs(torch, ops, train_mod, synthetic, mesh):
    """The (ap) runs of one process at ``mesh`` (a ``--mesh`` value, or
    None for (1, 1)): arctic-480b, then the smoke configurations, then
    falcon-mamba-smoke in CSC."""
    extra = ["--mesh", mesh] if mesh else []
    blocks = 1 if mesh else 2
    runs = {"arctic-480b": axis_run(torch, ops, train_mod, synthetic,
                                    "(ap)", AP_ARGV + extra, blocks,
                                    cut=ARCTIC_CUT)}
    for arch in AP_SMOKE:
        runs[f"{arch}-smoke lazy"] = axis_run(
            torch, ops, train_mod, synthetic, "(ap)",
            ap_smoke_argv(arch) + extra, blocks, timed=False, f32=True,
            digests=True)
    runs["falcon-mamba-7b-smoke csc"] = axis_run(
        torch, ops, train_mod, synthetic, "(ap)",
        ap_smoke_argv("falcon-mamba-7b", csc=True) + extra, blocks,
        timed=False, f32=True, digests=True)
    return runs


def ap_worker(rank: int, port: int, out: str) -> None:
    """One rank of (ap) at mesh (1, 2): two processes on this card, the
    model group over gloo (``ap_runs``). Writes its runs to ``out`` as
    JSON."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        runs = ap_runs(torch, ops, train_mod, synthetic, "1x2")
        with open(out, "w") as f:
            json.dump(dict(rank=rank, runs=runs), f)
    finally:
        dist.destroy_process_group()


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def model_axis_families_phase(torch, ops, train_mod, synthetic) -> dict:
    """(ap): the (1, 1) runs in this process, then the two (1, 2) ranks
    (``ap_worker``) on the same weights. Every run: the ranks' losses
    equal, each rank's update norms those of its blocks in the (1, 1)
    run, its local parameters the rules' blocks and every replicated
    leaf whole. arctic-480b: (ao)'s bounds, the model group's
    all-reduces a step AP_ALL_REDUCES, the first step's routing (slots
    per expert, dropped share: its one layer sees the same input at
    both meshes) the (1, 1) run's; the smoke runs AP_SMOKE_RTOL (CSC:
    its first loss)."""
    t0 = time.perf_counter()
    ref = ap_runs(torch, ops, train_mod, synthetic, None)
    ref_s = time.perf_counter() - t0
    import shutil
    import tempfile

    port = free_port()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ap_")
    outs = [os.path.join(out_dir, f"ap_rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--ap-rank", str(r), "--port", str(port),
                               "--out", outs[r]]) for r in range(2)]
    try:
        deadline = time.monotonic() + 300
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        check(all(p.returncode == 0 for p in procs),
              f"(ap): rank exit codes {[p.returncode for p in procs]}")
        ranks = []
        for o in outs:
            with open(o) as f:
                ranks.append(json.load(f))
    except subprocess.TimeoutExpired:
        fail("(ap): the ranks did not finish within 300 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    counts = {}
    for r in ranks:
        for label, run in r["runs"].items():
            lab = f"(ap) rank {r['rank']} {label}"
            want = ref[label]
            first = ranks[0]["runs"][label]
            check(run["losses"] == first["losses"],
                  f"{lab}: losses {run['losses']} != rank 0's")
            # The replicated leaves the same bits on both ranks after
            # every step (CSC: the summed selection, ROADMAP.md C.1).
            check(run.get("replica_digests") == first.get("replica_digests"),
                  f"{lab}: the replicated leaves differ across ranks")
            wide = label == "arctic-480b"
            csc = run["mode"] == "csc"
            # CSC: the first loss only (the sparse steps select on the
            # model group's summed norms at (1, 2), on the whole pool's at
            # (1, 1): other chunks from the first step on).
            n = 1 if csc else len(want["losses"])
            err = max(rel(a, b) for a, b in zip(run["losses"][:n],
                                                want["losses"][:n]))
            bound = TP_LOSS_RTOL if wide else AP_SMOKE_RTOL
            check(err <= bound, f"{lab}: losses {run['losses']} against "
                  f"(1, 1) {want['losses']}")
            run["loss_rel_err_vs_1x1"] = err
            # A rank holds its blocks and every replicated leaf whole.
            check(run["local_params"] == want["local_params_at_2"]
                  and run["global_pool_elems"]
                  == 2 * run["local_pool_elems"],
                  f"{lab}: local parameters {run['local_params']}, (1, 1) "
                  f"cut at 2 {want['local_params_at_2']}")
            per = [(s["all_reduces"], s["bytes"])
                   for s in run["model_all_reduces"]]
            check(per[0][0] > 0 and all(x == per[0] for x in per),
                  f"{lab}: model all-reduces a step "
                  f"{run['model_all_reduces']}")
            if not csc:
                idx = 0 if r["rank"] == 0 else 1
                worst = 0.0
                for name, (got,) in run["update_norms"].items():
                    w = want["update_norms"][name][idx]
                    if w:
                        worst = max(worst, rel(got, w))
                check(worst <= (TP_UPDATE_RTOL if wide else AP_SMOKE_RTOL),
                      f"{lab}: update norms off by {worst} relative")
                run["update_norm_rel_err_vs_1x1"] = worst
            else:
                check(run["dispatch_counts"].get("csc_compact.kernel", 0)
                      > 0, f"{lab}: no gather launched")
            if "routing" in run:
                check(run["routing"] == want["routing"],
                      f"{lab}: routing {run['routing']} against (1, 1) "
                      f"{want['routing']}")
            if wide:
                check(run["model_all_reduces"][0]["all_reduces"]
                      == AP_ALL_REDUCES, f"{lab}: "
                      f"{run['model_all_reduces'][0]['all_reduces']} model "
                      f"all-reduces a step, expected {AP_ALL_REDUCES}")
            del run["update_norms"]
            for k, v in run["dispatch_counts"].items():
                counts[k] = counts.get(k, 0) + v
    for run in ref.values():
        del run["update_norms"]
    note = ("mesh (1, 2) as two processes on one card: the ranks take "
            "turns on the device (time-sliced), and the model group's "
            "all-reduces go through pinned host memory and gloo; a step "
            "time is no NVLink's")
    return dict(reference_1x1=ref, reference_seconds=ref_s, ranks=ranks,
                expected_model_all_reduces_per_step_arctic=AP_ALL_REDUCES,
                loss_rtol=TP_LOSS_RTOL, update_rtol=TP_UPDATE_RTOL,
                smoke_rtol=AP_SMOKE_RTOL, dispatch_counts_both_ranks=counts,
                note=note, seconds=time.perf_counter() - t0)


_PHASE_T = [T_START]


# -- (ar) the rest of training under the model axis -------------------------

# (ar-1): olmo-1b at its published widths (d_model 2048, 16 heads, d_ff
# 8192, vocab 50304), AR_LAYERS of its 16 layers, 1 x 4096 tokens a data
# rank (a global batch of 2), blockwise attention beyond 1024, lazy, bf16
# wire, momentum SGD, kernels on, at mesh (2, 2) as four processes on this
# card: AR_STEPS steps on one repeated batch with the flat collective, then
# with pallas_ring (each model index's data ring of two ranks: the ring
# kernel over CUDA IPC workspaces, one a data group). The ring's losses
# within JAX's own 6e-3 of the flat run's, each leaf block's update norm
# within 2^-4 (TP_LOSS_RTOL, TP_UPDATE_RTOL).
AR_LAYERS = 2
AR_CUT = {"num_layers": AR_LAYERS}
AR_STEPS = 3
AR_ARGV = ["--arch", "olmo-1b", "--seq-len", "4096", "--batch", "2",
           "--attn-chunk", "1024", "--gf-mode", "lazy", "--use-kernels",
           "--window-steps", "1", "--steps", str(AR_STEPS), "--mesh", "2x2"]
# (ar-2)-(ar-4): ranks 0 and 1 in a new group of two at mesh (1, 2),
# olmo-smoke in CSC (one dense warm-up step, then sparse: the census and
# the gather on the local pool) on the bf16 wire with kernels: (ar-2) a
# checkpoint at step 2 (hg rows, chunk norms, momentum in JAX's global
# layout) restored in place, the next step bit for bit the uninterrupted
# one; (ar-3) the CLI with --ckpt-dir, a checkpoint every 2 steps and a
# host fault after step 3: one restart, the fault-free run's losses; (ar-4)
# build_train_window on the card refuses, naming the model group's gloo
# sums (a CUDA graph cannot hold them).
AR_SMOKE_ARGV = ["--arch", "olmo-1b", "--reduced", "--seq-len", "128",
                 "--batch", "2", "--gf-mode", "csc", "--csc-warmup", "1",
                 "--chunk-elems", "2048", "--use-kernels", "--mesh", "1x2"]
AR_CLI_ARGV = AR_SMOKE_ARGV + ["--steps", "4", "--window-steps", "1",
                               "--ckpt-every", "2"]
AR_FAULT_AFTER = 3


def ring_launches(trainer, steps: int) -> int:
    """The ``ring_allreduce`` launches ``steps`` steps of a dense or lazy
    plan need: one a pallas_ring bucket and a level of more than one
    rank."""
    gf = trainer.gf
    levels = sum(lv.size > 1 for lv in gf.cfg.topology.levels)
    return levels * sum(
        sum(t.algo.name == "pallas_ring" for t in gf.plan(
            gf.stage_for_step(s)).tasks) for s in range(steps))


def ar_run(torch, ops, train_mod, synthetic, algo: str) -> dict:
    """One (ar-1) rank's run under ``algo``: weights drawn on the card
    from the seed, this rank's data shard of the first batch repeated,
    the counts set to 0 before the steps and read after, step ms, peak
    memory, each leaf block's update norm."""
    args, cfg, trainer = axis_trainer(train_mod, AR_ARGV, AR_CUT, algo=algo)
    mesh = trainer.mesh
    params = trainer.shard_params(trainer.model.init_params(
        args.seed, trainer.device, on_device=True))
    init = _tree_clone(params)
    state = trainer.init_state(params=params)
    n = trainer.num_data
    batch = synthetic.SyntheticLM(cfg.model.vocab_size, seed=args.seed) \
        .batch(0, cfg.global_batch // n, cfg.seq_len, shard=mesh.data_index)
    step = trainer.build_train_step()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    losses, seconds = [], []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = dict(ops.dispatch_counts)
    want = expected_counts(trainer, args.steps)
    rings = ring_launches(trainer, args.steps)
    if rings:
        want["ring_allreduce.kernel"] = rings
    lab = f"(ar-1) {algo} rank {mesh.rank}"
    check(counts == want, f"{lab}: dispatch counts {counts}, expected "
          f"{want}")
    check(all(math.isfinite(x) for x in losses), f"{lab}: losses {losses}")
    out = dict(algo=algo, losses=losses,
               step_ms=[x * 1e3 for x in seconds],
               steady_step_ms=statistics.median(seconds[1:]) * 1e3,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               dispatch_counts=counts, ring_launches_per_step=rings
               / args.steps,
               buckets=len(trainer.engine.plan_for().tasks),
               algos=sorted({t.algo.name
                             for t in trainer.engine.plan_for().tasks}),
               local_pool_elems=trainer.pool.size,
               global_pool_elems=trainer.global_pool,
               update_norms=update_norms(torch, trainer, init, state.params,
                                         1))
    del state, step, trainer
    torch.cuda.empty_cache()
    return out


class FailOnce(list):
    """The CLI's window record, raising once after the window that ends
    at ``step`` (a host fault inside the window's call)."""

    def __init__(self, step):
        super().__init__()
        self.step, self.fired = step, False

    def append(self, item):
        super().append(item)
        if item["start"] + item["length"] == self.step and not self.fired:
            self.fired = True
            raise RuntimeError(f"host fault after step {self.step}")


def ar_smoke(torch, ops, train_mod, synthetic, path: str) -> dict:
    """(ar-2)-(ar-4) on one rank of the (1, 2) group; checkpoints under
    ``path`` (shared by both ranks)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    out = {}
    args, cfg, trainer = axis_trainer(train_mod, AR_SMOKE_ARGV)
    mgr = CheckpointManager(os.path.join(path, "ar2"),
                            layout=trainer.checkpoint_layout())
    state = trainer.init_state(args.seed)
    batch = synthetic.SyntheticLM(cfg.model.vocab_size, seed=args.seed) \
        .batch(0, cfg.global_batch, cfg.seq_len)
    steps = {}

    def step(state):
        stage = trainer.gf.stage_for_step(state.step)
        if stage.index not in steps:
            steps[stage.index] = trainer.build_train_step(stage)
        return steps[stage.index](state, batch)

    ops.reset_counts()
    for _ in range(2):
        state, _ = step(state)
    mgr.save(2, state, blocking=True)
    state, m = step(state)
    first = (float(m["loss"]), state_digest(state))
    restored, state = mgr.restore(state)
    check(restored == 2 and state.step == 2, f"(ar-2) restored {restored}")
    state, m = step(state)
    again = (float(m["loss"]), state_digest(state))
    out["ckpt"] = dict(step_after=first[0], restored_step_after=again[0],
                       bit_for_bit=first == again,
                       global_shapes={
                           m["name"]: m["shape"] for m in manifest(
                               os.path.join(path, "ar2"), 2)["leaves"]},
                       dispatch_counts=dict(ops.dispatch_counts))
    # (ar-4): the window refuses on the card, naming the gloo model group;
    # any other failure propagates.
    try:
        trainer.build_train_window(2)
        out["window_refusal"] = None
    except ValueError as e:
        out["window_refusal"] = str(e)
    del state, step, trainer
    runs = {}
    for name, record in (("fault", FailOnce(AR_FAULT_AFTER)),
                         ("clean", [])):
        args = train_mod.parse_args(AR_CLI_ARGV + [
            "--ckpt-dir", os.path.join(path, f"ar3_{name}")])
        ops.reset_counts()
        _, losses, _, stats = train_mod.train(args, record=record)
        runs[name] = dict(losses=losses, restarts=stats["restarts"],
                          restart_causes=stats["restart_causes"],
                          dispatch_counts=dict(ops.dispatch_counts))
    out["cli"] = runs
    return out


def ar_worker(rank: int, ports, out: str, path: str) -> None:
    """One rank of (ar): (ar-1) in the group of four, then on ranks 0 and
    1 (ar-2)-(ar-4) in a new group of two. Writes its findings to ``out``
    as JSON."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.kernels import ring_reduce
    from repro_torch.launch import train as train_mod

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{ports[0]}", world_size=4, rank=rank)
    record = dict(rank=rank)
    try:
        record["runs"] = [ar_run(torch, ops, train_mod, synthetic, algo)
                          for algo in ("flat", "pallas_ring")]
        ring_reduce.release_workspaces()
    finally:
        dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                                f"{ports[1]}", world_size=2, rank=rank)
        try:
            record["smoke"] = ar_smoke(torch, ops, train_mod, synthetic,
                                       path)
        finally:
            dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(record, f)


def ar_phase() -> dict:
    """(ar): the four (ar-1) rank processes (two of which go on to
    (ar-2)-(ar-4)); the checks of each part."""
    t0 = time.perf_counter()
    ports = [free_port(), free_port()]
    path = ckpt_dir("ar")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"ar_rank{r}.json") for r in range(4)]
    for o in outs:
        if os.path.exists(o):
            os.remove(o)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--ar-rank", str(r), "--port",
                               f"{ports[0]},{ports[1]}", "--out", outs[r],
                               "--ckpt", path]) for r in range(4)]
    try:
        deadline = time.monotonic() + 300
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        fail("(ar): the ranks did not finish within 300 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"(ar): rank exit codes {[p.returncode for p in procs]}")
    ranks = []
    for o in outs:
        with open(o) as f:
            ranks.append(json.load(f))
    clear_checkpoints()
    return dict(ar_checks(ranks), seconds=time.perf_counter() - t0)


def ar_checks(ranks) -> dict:
    """(ar)'s checks on the four ranks' records; its line's record."""
    counts = {}
    for r in ranks:
        flat, ring = r["runs"]
        lab = f"(ar-1) rank {r['rank']}"
        check(flat["algos"] == ["flat"] and ring["algos"] == ["pallas_ring"]
              and "ring_allreduce.kernel" not in flat["dispatch_counts"]
              and ring["ring_launches_per_step"] == ring["buckets"] > 0,
              f"{lab}: algorithms {flat['algos']} / {ring['algos']}, ring "
              f"launches a step {ring['ring_launches_per_step']} for "
              f"{ring['buckets']} buckets")
        # The two data ranks of a model index see the same losses.
        mate = ranks[r["rank"] ^ 2]["runs"]
        check(flat["losses"] == mate[0]["losses"]
              and ring["losses"] == mate[1]["losses"],
              f"{lab}: losses differ from its data mate's")
        err = max(rel(a, b) for a, b in zip(ring["losses"], flat["losses"]))
        check(err <= TP_LOSS_RTOL, f"{lab}: ring losses {ring['losses']} "
              f"against flat {flat['losses']}")
        worst = max(rel(g[0], w[0])
                    for name, g in ring["update_norms"].items()
                    for w in [flat["update_norms"][name]] if w[0])
        check(worst <= TP_UPDATE_RTOL,
              f"{lab}: update norms off by {worst} relative")
        ring["loss_rel_err_vs_flat"], ring["update_norm_rel_err_vs_flat"] = \
            err, worst
        for run in r["runs"]:
            del run["update_norms"]
            for k, v in run["dispatch_counts"].items():
                counts[k] = counts.get(k, 0) + v
    for r in ranks[:2]:
        sm = r["smoke"]
        lab = f"(ar) rank {r['rank']}"
        check(sm["ckpt"]["bit_for_bit"], f"{lab} (ar-2): restored step "
              f"{sm['ckpt']['restored_step_after']} != "
              f"{sm['ckpt']['step_after']}")
        msg = sm["window_refusal"]
        check(msg is not None and "model group's gloo sums" in msg,
              f"{lab} (ar-4): window on the card: {msg}")
        cli = sm["cli"]
        check(cli["fault"]["restarts"] == 1 and cli["clean"]["restarts"] == 0
              and cli["fault"]["losses"] == cli["clean"]["losses"]
              and len(cli["clean"]["losses"]) == 4,
              f"{lab} (ar-3): {cli}")
        for src in (sm["ckpt"]["dispatch_counts"],
                    cli["fault"]["dispatch_counts"]):
            for k, v in src.items():
                counts[k] = counts.get(k, 0) + v
    check(all(counts.get(k, 0) > 0 for k in SOAK_LANE_KERNELS
              + ("ring_allreduce.kernel",))
          and not any(k.endswith(".plain") for k in counts),
          f"(ar) launches {counts}")
    note = ("mesh (2, 2) as four processes on one card: the ranks take "
            "turns on the device (time-sliced); the model group's sums go "
            "through pinned host memory and gloo, the flat data sum too; "
            "pallas_ring's data ring is the CUDA kernel over IPC "
            "workspaces. A step time is no NVLink's")
    return dict(arch="olmo-1b", mesh=[2, 2], layers=AR_LAYERS,
                reduced={"num_layers": [16, AR_LAYERS]}, tokens_per_rank=4096,
                steps=AR_STEPS, ranks=ranks, loss_rtol=TP_LOSS_RTOL,
                update_rtol=TP_UPDATE_RTOL, dispatch_counts_all_ranks=counts,
                note=note)


def phase_seconds(label: str) -> None:
    """Print the host seconds since the last such line (a guide to what
    each phase costs of the script's time limit)."""
    now = time.perf_counter()
    print(f"chip_smoke: {label}: {now - _PHASE_T[-1]:.1f} s", flush=True)
    _PHASE_T.append(now)


def print_serving_ranks(rec, name, power) -> None:
    """(as) a line a case, variant and rank: prefill and decode ms, the
    model group's all-reduces a decode step (count, bytes, seconds of
    the timed step) against the expected count, cache bytes, peak
    memory, the logits' gap to (1, 1) and where the greedy tokens part."""
    for case in AS_CASES:
        runs = [("1x1", rec["reference_1x1"][case])] + [
            (f"rank {r['rank']}", r[case]) for r in rec["ranks"]]
        for who, run in runs:
            for var, v in run["variants"].items():
                print(json.dumps(dict(
                    serve=f"({case}) {run['arch']}", variant=var, who=who,
                    mesh=run["mesh"], prefill_ms=v["prefill_ms"],
                    decode_median_ms=v["decode_median_ms"],
                    model_all_reduces=v.get("model_all_reduces", [0])[0],
                    expected=v.get("expected_model_all_reduces", 0),
                    all_reduce_bytes=v.get("model_all_reduce_bytes", 0),
                    cache_bytes=v["cache_bytes"],
                    peak_mem_gib=run["peak_mem_gib"],
                    logit_rel_gap=v["logit_rel_gap_vs_1x1_naive"],
                    greedy_parts_at=v["greedy_first_parts_at_step"],
                    no_host_sync=True, gpu=name, power_limit=power)),
                    flush=True)


def print_long_runs(runs, name, power) -> None:
    for label, run in runs.items():
        print(json.dumps(dict(train=run["arch"], mode=label, gpu=name,
                              power_limit=power, **{
                                  k: v for k, v in run.items()
                                  if k != "arch"})), flush=True)


def main() -> None:
    import torch
    if "--ring-rank" in sys.argv:
        argv = sys.argv[1:]
        ring_train_worker(int(argv[argv.index("--ring-rank") + 1]),
                          int(argv[argv.index("--port") + 1]),
                          argv[argv.index("--out") + 1],
                          argv[argv.index("--elastic-dir") + 1])
        return
    if "--tp-rank" in sys.argv:
        argv = sys.argv[1:]
        tp_worker(int(argv[argv.index("--tp-rank") + 1]),
                  int(argv[argv.index("--port") + 1]),
                  argv[argv.index("--out") + 1],
                  argv[argv.index("--as-dir") + 1])
        return
    if "--ap-rank" in sys.argv:
        argv = sys.argv[1:]
        ap_worker(int(argv[argv.index("--ap-rank") + 1]),
                  int(argv[argv.index("--port") + 1]),
                  argv[argv.index("--out") + 1])
        return
    if "--ar-rank" in sys.argv:
        argv = sys.argv[1:]
        ar_worker(int(argv[argv.index("--ar-rank") + 1]),
                  [int(x) for x in argv[argv.index("--port") + 1].split(",")],
                  argv[argv.index("--out") + 1],
                  argv[argv.index("--ckpt") + 1])
        return
    if "--cli-train" in sys.argv:
        argv = sys.argv[1:]
        head = argv[:argv.index("--")]
        cli_worker(head[head.index("--cli-train") + 1],
                   argv[argv.index("--") + 1:],
                   int(head[head.index("--preempt-at") + 1])
                   if "--preempt-at" in head else None)
        return
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        sys.exit(2)
    argv = sys.argv[1:]
    # --short-kernels [--src DIR]: only the census and the gather phases,
    # on the kernels of the tree at DIR (e.g. a parent's checkout, to time
    # both trees the same way in one call).
    short_only = "--short-kernels" in argv
    src = os.path.abspath(argv[argv.index("--src") + 1]) if "--src" in argv \
        else os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: the repro_torch package is missing under {src}",
              file=sys.stderr)
        sys.exit(3)
    sys.path.insert(0, src)
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.core import pool as pool_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import chunk_l1norm as kcl
    from repro_torch.kernels import csc_compact as kcc
    from repro_torch.models import build_model

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    power = smi_line.split(",")[-1].strip()
    name = torch.cuda.get_device_name(0)
    rate = hbm_rate(name)
    print(f"device: {name}; nvidia-smi: {smi_line}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; memory-rate "
          f"bound at {rate / 1e12} TB/s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s (nvcc, one "
          f"process per source, in parallel)", flush=True)
    for lib in build.SOURCES:
        for line in build.build_log(lib).splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                print(f"  {lib}: {line.strip()}")

    dev = torch.device("cuda", 0)
    shapes = build_model(get_arch("smollm-135m")[0]).param_shapes()
    num_chunks = pool_mod.GradientPool(shapes, pad_to=CHUNK).size // CHUNK
    if short_only:
        # The parent's wrappers may take no grid: time, do not vary it.
        own = src == os.path.join(ROOT, "src")
        for e in (census_phase(torch, kcl, num_chunks, dev, rate, own),
                  compact_phase(torch, kcc, num_chunks, dev, rate, own)):
            print(json.dumps(dict(kernel=e["name"], src=src, gpu=name,
                                  power_limit=power, parts=e["parts"])),
                  flush=True)
        print(smi_line)
        return
    make_ckpt_root()
    try:
        run_all(torch, dist, dev, rate, name, power, smi_line, shapes,
                num_chunks)
    finally:
        remove_ckpt_root()


def run_all(torch, dist, dev, rate, name, power, smi_line, shapes,
            num_chunks):
    """Every phase after the build (see the module docstring); the
    result line last."""
    from repro_torch.core import csc
    from repro_torch.core import pool as pool_mod
    from repro_torch.core import wire
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.kernels import chunk_l1norm as kcl
    from repro_torch.kernels import csc_compact as kcc
    from repro_torch.kernels import fused_update as kfu
    from repro_torch.kernels import ring_reduce as kring
    from repro_torch.kernels import pool_pack as kpack
    from repro_torch.kernels import pool_unpack as kunpack
    from repro_torch.launch import train as train_mod
    from repro_torch import optim
    from repro_torch.configs import base
    from repro_torch.optim import lars as lars_mod

    entries = [
        pack_phase(torch, pool_mod, kpack, shapes, dev, rate),
        update_phase(torch, pool_mod, csc, kunpack, shapes, dev, rate),
        census_phase(torch, kcl, num_chunks, dev, rate),
        compact_phase(torch, kcc, num_chunks, dev, rate),
        ring_phase(torch, kring, pool_mod, shapes, dev, rate),
        fused_update_phase(torch, kfu, optim, ops, base, dev, rate)]
    for e in entries:
        print(json.dumps(dict(kernel=e["name"], gpu=name, power_limit=power,
                              parts=e["parts"])), flush=True)
    print(json.dumps(dict(nan_words=nonfinite_phase(
        torch, kpack, kcl, kring, pool_mod, shapes, dev), gpu=name,
        power_limit=power)), flush=True)
    print(json.dumps(dict(optimizer_ops=optimizer_phase(
        torch, pool_mod, csc, optim, lars_mod, base, shapes, dev, rate),
        gpu=name, power_limit=power)), flush=True)
    print(json.dumps(dict(quantized_ring=quantized_ring_phase(
        torch, kring, wire, dev, rate), gpu=name, power_limit=power)),
        flush=True)

    phase_seconds("device, build and kernels")
    runs = train_phase(torch, dist, ops, train_mod, synthetic, kunpack,
                       csc, wire)
    phase_seconds("train (a)-(v)")
    runs["resume_csc_cli"] = resume_phase("(w) csc, CLI resumed", CSC_ARGV)
    (elastic, elastic_dir, ring, ring_csc, ring_guarded, ring_window,
     ring_int8, ring_int8_csc) = ring_train_phase(torch, dev)
    runs["elastic_csc_2_to_1"] = elastic_phase(
        torch, ops, train_mod, elastic, CSC_ARGV, elastic_dir)
    runs["lazy_pallas_ring_2_processes"] = ring
    runs["csc_pallas_ring_2_processes"] = ring_csc
    runs["guarded_lazy_pallas_ring_2_processes"] = ring_guarded
    runs["int8_lazy_pallas_ring_2_processes"] = ring_int8
    runs["int8_csc_pallas_ring_2_processes"] = ring_int8_csc
    runs["window_lazy_pipelined_pallas_ring_2_processes"] = ring_window
    phase_seconds("resume, ring and elastic (w), (c), (k), (p), (u), (x)")
    # Long sequences on the dense models, after every earlier phase.
    attn = attention_phase(torch, dev)
    print(json.dumps(dict(attention=attn, gpu=name, power_limit=power)),
          flush=True)
    afmoe = afmoe_phase(torch, dev)
    print(json.dumps(dict(afmoe_kernels=afmoe, gpu=name, power_limit=power)),
          flush=True)
    long_runs, olmo_pack, olmo_update = long_sequence_phase(
        torch, dist, ops, train_mod, synthetic, pool_mod, kpack, kunpack,
        dev, rate)
    phase_seconds("long sequences (z), (au), (y)-(ab)")
    family_runs, moe_layer = families_phase(torch, dist, ops, train_mod,
                                            synthetic, dev)
    phase_seconds("families (ac)-(af)")
    print(json.dumps(dict(moe_layer_card_vs_cpu=moe_layer, gpu=name,
                          power_limit=power)), flush=True)
    long_runs.update(family_runs)
    ssm_runs, ssm_layers, ssm_cores = ssm_phase(
        torch, dist, ops, train_mod, synthetic, dev, rate)
    phase_seconds("ssm and hybrid (ag)-(ai)")
    print(json.dumps(dict(ssm_layers_card_vs_cpu=ssm_layers, gpu=name,
                          power_limit=power)), flush=True)
    print(json.dumps(dict(ssm_cores=ssm_cores, gpu=name,
                          power_limit=power)), flush=True)
    long_runs.update(ssm_runs)
    serving = serving_phase(torch, ops, dev, rate)
    phase_seconds("serving")
    print(json.dumps(dict(serving=serving, gpu=name, power_limit=power)),
          flush=True)
    soak_run = soak_phase(torch, ops, dev)
    print(json.dumps(dict(soak_and_timeline=soak_run, gpu=name,
                          power_limit=power)), flush=True)
    phase_seconds("timeline and soak (an)")
    tp, aq, as_rec = model_axis_phase(torch, ops, train_mod, synthetic)
    print(json.dumps(dict(model_axis=tp, gpu=name, power_limit=power)),
          flush=True)
    print(json.dumps(dict(model_axis_update_path=aq, gpu=name,
                          power_limit=power)), flush=True)
    print_serving_ranks(as_rec, name, power)
    print(json.dumps(dict(model_axis_serving=as_rec, gpu=name,
                          power_limit=power)), flush=True)
    phase_seconds("model axis (ao), its update path (aq) and serving (as)")
    ap = model_axis_families_phase(torch, ops, train_mod, synthetic)
    print(json.dumps(dict(model_axis_families=ap, gpu=name,
                          power_limit=power)), flush=True)
    phase_seconds("model axis, the other families (ap)")
    ar = ar_phase()
    print(json.dumps(dict(model_axis_collectives=ar, gpu=name,
                          power_limit=power)), flush=True)
    phase_seconds("model axis, the rest of training (ar)")
    for e in entries:
        extra = {"pool_pack": olmo_pack,
                 "pool_unpack_update": olmo_update}.get(e["name"], {})
        e["parts"].update(extra)
        e["max_abs_err"] = max(p["max_abs_err"] for p in e["parts"].values())
    print_long_runs(long_runs, name, power)
    for label, run in runs.items():
        print(json.dumps(dict(train="smollm-135m", mode=label, batch=BATCH,
                              seq_len=SEQ, gpu=name, power_limit=power,
                              **run)), flush=True)
    for e in entries:
        key = f"{e['name']}.kernel"
        if e["name"] == "ring_allreduce":
            # Rank 0's launches in the two-process ring runs.
            e["launches"] = ring["dispatch_counts"][key]
            e["launches_csc"] = ring_csc["dispatch_counts"][key]
        elif e["name"] == "fused_update":
            e["launches"] = e.pop("launches_update_pool")
        else:
            e["launches"] = runs["csc"]["dispatch_counts"][key]
            e["launches_by_run"] = {
                label: run["dispatch_counts"].get(key, 0)
                for label, run in list(runs.items())
                + list(long_runs.items()) if "pallas" not in label
                and "dispatch_counts" in run}
    for e in entries:
        key = f"{e['name']}.kernel"
        e["launches_serving"] = serving["dispatch_counts"].get(key, 0)
        # (an) the soak's guard lane; (ao) both model-axis ranks, the
        # olmo-1b run and the smoke CSC run.
        e["launches_soak_lane"] = soak_run["lane_launches"].get(key, 0)
        e["launches_model_axis"] = tp["dispatch_counts_both_ranks"].get(
            key, 0)
        # (ap) both ranks: arctic-480b, the smoke families, CSC.
        e["launches_model_axis_families"] = \
            ap["dispatch_counts_both_ranks"].get(key, 0)
        # (aq) both ranks: the olmo-1b update path, the AdamW smoke run,
        # the CSC CLI, the fault.
        e["launches_model_axis_update_path"] = \
            aq["dispatch_counts_both_ranks"].get(key, 0)
        # (ar) every rank: (ar-1)'s flat and pallas_ring runs at (2, 2),
        # (ar-2)'s steps and (ar-3)'s faulted CLI run at (1, 2).
        e["launches_model_axis_collectives"] = \
            ar["dispatch_counts_all_ranks"].get(key, 0)
        # (as) both ranks and the (1, 1) runs: serving launches none.
        e["launches_model_axis_serving"] = \
            as_rec["dispatch_counts_both_ranks"].get(key, 0)
    check(all(soak_run["lane_launches"].get(k, 0) > 0
              and tp["dispatch_counts_both_ranks"].get(k, 0) > 0
              and ap["dispatch_counts_both_ranks"].get(k, 0) > 0
              for k in SOAK_LANE_KERNELS),
          f"(an)/(ao)/(ap) launches: lane {soak_run['lane_launches']}, "
          f"model axis {tp['dispatch_counts_both_ranks']}, families "
          f"{ap['dispatch_counts_both_ranks']}")
    check(all(aq["dispatch_counts_both_ranks"].get(k, 0) > 0
              for k in SOAK_LANE_KERNELS),
          f"(aq) launches {aq['dispatch_counts_both_ranks']}")
    check(all(e["launches"] > 0 for e in entries),
          f"launches {[(e['name'], e['launches']) for e in entries]}")
    # Which kernels a captured window launched: (q)'s lazy path, (s)'s
    # CSC stages, (u)'s ring.
    captured = dict(runs["window_lazy"]["capture_counts"])
    for counts in runs["window_csc_cli"]["capture_counts"] + [
            c["capture_counts"] for c in ring_window["window_stats"]]:
        for k, v in counts.items():
            captured[k] = captured.get(k, 0) + v
    for e in entries:
        e["in_graph"] = captured.get(f"{e['name']}.kernel", 0) > 0
        e["graph_capture_launches"] = captured.get(f"{e['name']}.kernel", 0)
    check([e["name"] for e in entries if not e["in_graph"]]
          == ["fused_update"], f"kernels captured in a window: {captured}")
    print(json.dumps(dict(guard_lane_windowed=guard_lane_phase(torch, dev),
                          gpu=name, power_limit=power)), flush=True)
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all, the "
          f"kernel build included", flush=True)
    print(smi_line)
    print(json.dumps({"kernels": entries, "not_ported": [],
                      "gpu": name, "nvidia_smi": smi_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
