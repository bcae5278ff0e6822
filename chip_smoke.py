#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vitiq_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each of
which raises (exit code 1) on failure:

1. device: a CUDA GPU must be present; the card's name and power limit.
2. build: the kernels of `vitiq_torch/csrc/*.cu` are compiled with nvcc for
   sm_90a (one nvcc per source, all started together) and loaded. K5's three
   kernels (attention_fwd, attention_bwd_dq, attention_bwd_dkdv at d_head
   16/32/64) must not spill (`ptxas -v`) and must run HGMMA (their SASS);
   their registers and each one's blocks an SM at one and two warpgroups
   (`fa.ring_info`) are printed. Every instance of K6's s8 GEMM stage
   (gemm_s8_kernel, `k6.S8_INSTANCES`) must be in the build, must not spill
   and must run IGMMA (the integer warpgroup MMA; HGMMA is the bf16 one) and
   no HGMMA. Every instance of K7's two int8 attention cores (d_head
   16/32/64 with and without their DUMP variants) must not spill: the wgmma
   core (attention_int8_kernel) must run IGMMA, the one-tile core
   (attention_int8_sync_kernel) IMMA; and every instance of K2's pooling
   kernel (cls_pool_kernel, d_model 64/128/256) HMMA (mma.sync) without a
   spill (`check_k2k7_build`).
3. kernels: K1 (full fused layers) and K2 (the CLS-row layer) on the GPU
   against their plain PyTorch version on the GPU, on the same bf16 inputs
   and seeded random weights, at the ViT flagship (L=129, F=512, B=256),
   rawIQ flagship (L=65, F=1024, B=256) and conv1d flagship (L=1025,
   F=1024, B=64) shapes, D=128, H=8: each of five K1 layers and the K2 layer
   on the plain version's input to it (|kernel - plain| <= 3e-2 + 1.6e-2 *
   |plain|; K2 also against its own plain version, which rounds qt and the
   pooled tokens where the kernel does), and the five K1 layers as one stack
   (6e-2 + 3.2e-2 * |plain|);
   see LAYER_TOL and STACK_TOL; then the same at the widths past d_model 128
   / d_head 32 (WIDE_SHAPES: rawiq_best's D=256, H=8, L=65, F=1024;
   vit_tiny_2016's D=64, H=4, L=17; d_head 64 at D=128, H=2, L=129; B=256).
   Then K5-fwd and K5-bwd (the standalone
   packed attention) against their plain versions at L 1, 17, 1025, 1040
   and 4097 (past what K1's core holds in shared memory), d_head 16, 32 and
   64, B=64 (B=4 at 4097), and at the parallel phase's TP 2 shape
   (K5_TP_SHAPE: B=256, L=129, 4 heads of d_head 16 sliced from a 192-wide
   qkv): out within GRAD_REL in the L2 norm and
   elementwise within K5_OUT_TOL (scaled to the output's rms), the f32
   log-sum-exp within K5_LSE_ATOL, dq, dk, dv each within GRAD_REL in the L2
   norm (max |difference| printed; at L=1, where dq and dk are zero, within
   GRAD_REL of the plain norm plus 1e-6, as tests/test_torch_cuda.py holds
   them); out and lse also against the kernel's own one-pass function
   (`fa.attention_onepass_plain`: GRAD_REL, K5_LSE_ATOL); q, k, v as column
   slices of qkv and as contiguous copies give the same bits, and so do 30
   repeated launches of each.
   cls-pool: K2's pooling kernel alone (`fel.cls_pool`) on the qt K2's
   stages give, at the flagship and wide shapes and d_model 256 at d_head
   16 (B=256, conv1d B=64), against `fel.cls_pool_reference`: GRAD_REL in
   the L2 norm and LAYER_TOL, 30 launches the same bits.
   k1-parts: K1's kernels one by one at the same shapes (B=256, conv1d
   B=64): its four wgmma GEMM stages (QKV, out-projection + LN1, FFN1 +
   ReLU, FFN2 + LN2), each on the plain version's input to it, within one
   bf16 ulp of an f32 product of the same operands (`check_ulp`), and its
   one-pass attention core on the QKV stage's qkv against
   `fel.attention_onepass_reference` (1% in the L2 norm, elementwise within
   K5_OUT_TOL scaled to the output's rms).
   int8-kernels: K6 (the int8 W8A8 layer) against its plain version at the
   three flagship shapes (B=256, B=256, B=64), d_head 16 and 32: each of
   five layers on the plain version's input and the five layers with the K2
   CLS tail (on dequantized weights) as one stack, by relative L2 and a max
   in quantization steps (K6_LAYER_TOL, K6_STACK_TOL, both printed), and the
   same at WIDE_SHAPES (the stack carries each layer's levels to the next);
   K6's FFN1 GEMM stage alone, which must equal the plain int8 GEMM bit for
   bit, and at rawiq_best's width all four (QKV, out-projection and FFN2 on
   their 256-wide tiles, FFN1). int8-stages: K6's four s8 stage forms alone,
   as the layer launches them (`k6.qkv_stage`, `out_proj_stage`,
   `ffn1_stage`, `ffn2_stage`), at the ViT, rawIQ, rawiq_best and
   vit_tiny_2016 (D, F) and M = 256 L, 1088 (64 mod 128) and 1000 rows,
   against `k6.s8_stage_reference`: QKV and FFN1 (and FFN1's merged row max)
   bit for bit, the LayerNorm stages within K6_LAYER_TOL with their levels
   and scales bit for bit `levels_of` their own bf16 output; 30 launches of
   each stage and of the layer give the same bits, and the layer given x's
   levels equals the layer quantizing x.
   int8attn-kernels: K7 (the int8-attention layer) against its plain version
   at the three flagship shapes (B=256, B=256, conv1d L=1025 at B=64, d_head
   16) and rawiq_best's (D=256, d_head 32, B=256): each of five layers on the
   plain version's input and the five layers with the K2 CLS tail as one
   stack, held as K6 is (K7_LAYER_TOL, K7_STACK_TOL), with K1 on the same
   input, which the layer check must turn away; its core alone on one qkv,
   in each of its two forms at every shape (a layer takes the mma.sync
   core up to 96 tokens, the wgmma core past them: `k7.core_route`),
   whose s32 scores and s32 P [v | 1] tile products (on its own int8
   probabilities) must equal the plain version's bit for bit, its
   probabilities and outputs differing in fewer than K7_CORE_DIFFER of them,
   and 30 launches without the dump giving its outputs' bits.
4. serve: the ViT flagship (d128/L6/H8, bf16 `tpu` numerics, seeded random
   weights) answers ragged requests of 1, 37, 256 and 1000 raw [B, 1024, 2]
   frames through `Server` with buckets (256, 1024). Every launch counter is
   reset just before and read just after: K1 must have launched once per full
   layer and K2 once per request. Logits are checked against the same
   weights on the f32 `reference` path on the GPU: max |dlogit| < 0.05 and
   argmax agreement >= 0.99 on rows whose reference top-2 margin exceeds
   4 * max |dlogit|. The rawIQ flagship (seg-16, FFN 1024) repeats the check
   with non-trivial stats (RAW_STATS) through `build_forward_and_preprocess`,
   which gives it the fused raw embedding (raw frames straight into one
   GEMM), as the JAX package serves it; its f32 path keeps the unfused chain.
   The conv1d flagship (1025 tokens) repeats it with requests of 1, 37 and
   256 through buckets (64, 256), and again with VITIQ_NO_FUSED_LAYER=1,
   where each request must launch K5-fwd once per layer and K1/K2 never.
   serve-wide: rawiq_best (d256/L9/H8, through the fused raw embedding:
   K1 8 and K2 1 per request), rawiq_best_mp (mean pooling: K1 9, K2 0),
   vit_tiny_2016 (d64, 128-sample frames) and vit_tpu_production (d_head
   64) the same way, each within 0.05 of its f32 path.
   int8-serve: each flagship's int8 W8A8 twin (`build_int8_serving_fn`,
   quantized from the same random weights) serves the same ragged requests
   through `Server`; every counter is reset before each request and read
   after it: K6 n_layers - 1 times, K2 once, nothing else. Its logits are
   held to the f32 path with the JAX package's bound, max |dlogit| < 0.35 *
   max(|ref|, 1), and to the unfused int8 path on the card
   (VITIQ_NO_FUSED_LAYER=1, which must launch nothing); argmax agreement
   printed; rawiq_best the same way (K6 8, K2 1 per request).
5. train-kernels: K3-fwd and K3-bwd (the fused training layer, recompute
   regime) on the GPU against their plain PyTorch versions at the ViT
   flagship shape (B=256, L=129, F=512, H=8, dropout 0.1) and the rawIQ one
   (B=256, L=65, F=1024, H=8, dropout 0.2), then K4-fwd and K4-bwd (the
   stash regime) at the rawIQ shape: the forward, dx and K4's bf16 stash
   tensors within LAYER_TOL (attn and pbar also within GRAD_REL in the L2
   norm), K4's f32 1/std within 1e-3 relative, each of
   the 12 weight, bias and LN gradients within GRAD_REL of the plain
   gradient in the L2 norm (max |difference| printed). K4-bwd runs on the
   plain version's stash, so that it alone is under test. Then K3 at
   rawiq_best's shape (D=256, L=65, dropout 0.1 and 0) and K4 at
   rawiq_best_mp's (D=256, L=64). Then both at the widths added past
   d_model 128 / d_head 32 (WIDE_TRAIN_K3, WIDE_TRAIN_K4): d_head 64 (D=128,
   H=2: L=129 through K3, L=65 through K4), d_model 64 (H=4, L=17, both)
   and an FFN width of 320 (64-wide GEMM tiles, both), dropout on, where the
   forward output and dx are also held within GRAD_REL in the L2 norm. Then
   K4's two attention passes alone (`flt.stash_attention_fwd` / `_bwd`, the
   wgmma kernels wg_attention_fwd and wg_attention_bwd_stash) at the four
   shapes K4 trains (K4_PASS_SHAPES, B=256) against their plain versions on
   the same inputs: attn and dqkv within LAYER_TOL, pbar within PBAR_ULPS
   bf16 ulps (its padding exactly 0), attn, pbar, dqkv and each frame's
   column sums within GRAD_REL in the L2 norm, the backward also on the
   forward kernel's own attn and pbar against the plain chain (GRAD_REL), and
   30 launches of each pass giving the first launch's bits. Then K3's two
   attention passes alone (`flt.recompute_attention_fwd` / `_bwd`, routed
   by shape as K3 routes them: the wgmma kernels wg_recompute_attention_fwd
   and wg_recompute_attention_bwd up to 144 keys, but the mma.sync forward at
   d_head 16 past 80 keys; the mma.sync passes past 144) at every shape K3
   trains, L 17 and one routed L past 144 (K3_PASS_SHAPES, B=256), held the
   same way: attn and dqkv within LAYER_TOL and GRAD_REL, the forward's row
   stats within STATS_TOL (m within 1e-5 of max(|m|, 1), l within 1e-3
   relative), the column sums within GRAD_REL, the backward on the forward
   kernel's own attn and stats against the plain chain, 30 launches of each
   giving the same bits; each shape's route and the wgmma passes' blocks an
   SM printed. The build phase fails unless every instance of K4's passes
   (K4_ATTENTION_INSTANCES) and of K3's (K3_ATTENTION_INSTANCES) is in the
   build, spills nothing and runs HGMMA. Then the plain dropout sites'
   kernel (`check_hash_dropout`) at the main path's activations
   (DROP_SHAPES) against its plain version on the card, bit for bit.
6. train: the ViT flagship and the rawIQ flagship (bf16 `tpu` numerics,
   seeded random weights) each take 20 `make_train_step` steps at B=256 on
   one repeated random batch at lr 1e-3, the rawIQ one on raw frames through
   the fused raw embedding. The launch counters are reset just before each
   step and read just after: every ViT step must launch K3-fwd and K3-bwd
   once per layer (6 each) and K4 and K5 never; every rawIQ step K4-fwd and
   K4-bwd 6 times each and K3 and K5 never, the regimes the JAX package's
   stash gate picks (Lp 144 and 80); each the plain dropout sites' kernel
   twice (the embedding's dropout, forward and backward). The loss must stay finite and end
   below where it started. One step's gradient at dropout 0 from the same weights is held
   against the plain bf16 layers (VITIQ_FUSED_TRAIN=0, cosine >= 0.999) and
   the f32 `reference` path (cosine >= 0.995). The conv1d flagship takes 20
   steps at B=64 through the plain layers, rematerialized (VITIQ_TRAIN_REMAT
   auto), with K5 as their attention: every step must launch K5-fwd 12
   times (6 forward, 6 recompute) and K5-bwd 6 times, the plain dropout
   sites' kernel 56 times (2 + 9 a layer), K3 and K4 never; its
   gradient at dropout 0 is held to the f32 path at B=8 (cosine >= 0.995).
   rawiq_best takes 20 steps at B=256 through K3 (9 forward and 9 backward
   launches a step), rawiq_best_mp through K4 (9 + 9), each gradient held to
   the plain bf16 layers and the f32 path at cosine >= 0.995.
   evaluate: the ViT flagship (3 classes) trains with `run_training` on the
   default synthetic corpus (3 x 2048 frames, seed 0, EVAL_EPOCHS epochs at
   B=128, lr 3e-4) into a temporary experiment directory (the JAX package's
   files: config.json, normalization_stats.json, checkpoints, model_best.npz,
   its test evaluation, summary.json), which is then evaluated on its test
   split by `run_evaluation` on the card, in float, int8 and float with
   VITIQ_ATTN_INT8=1: the reports parse back, float test accuracy >=
   EVAL_MIN_ACC and int8 and int8 attention within 2 points of it. Every
   phase counts its launches: K3 6 + 6 per train step, K1 5 (float), K6 5
   (int8) or K7 5 (int8 attention) and K2 1 per evaluated batch.
   rawiq_best repeats it with BEST_EVAL_EPOCHS epochs at lr 1e-4 (K3 9 + 9
   per step, its validation passes through K1/K2 at d256), gated on
   launches and report files, not accuracy.
   cli-train: rawiq_best through `python -m vitiq_torch.cli train` (the
   preset from a --config JSON with save_freq 1, --source synthetic
   --numerics tpu), 2 epochs, then --resume auto to a third, all with
   VITIQ_ATTN_INT8=1: K3 9 + 9 per step, K7 8 and K2 1 per evaluated batch,
   nothing else; the resumed history holds 3 epochs. The resumed call runs
   under `torch.profiler` (its device busy time and idle share).
   train-wide: vit_tiny_2016 (d64/L4/H4, 17 tokens) through K4 (4 + 4
   launches a step) and vit_tpu_production (d128/L6/H2, d_head 64) through
   K3 (6 + 6), 20 steps each at B=4096, loss falling, one dropout-free
   step's gradient at B=256 held to the plain bf16 layers and the f32 path
   at cosine >= 0.995.
   head-to-head: `python -m vitiq_torch.cli head-to-head --source synthetic
   --numerics tpu --no_plots --num_epochs H2H_EPOCHS`, then the same with
   --n_head 2 (d_head 64 in both arms), each in a temporary working
   directory: the ViT arm trains through K3 only, the rawIQ arm through K4
   only (n_layers + n_layers a step), both evaluate through K1/K2 (n_layers
   - 1 and 1 per batch), nothing else launches; both summary.json files and
   both CSVs exist; the printed insights' overall_improvement is the
   difference of the two test accuracies (x 100, within 0.01). Each arm's
   accuracy and the wall time are printed; the first call runs under
   `torch.profiler` (device busy time and idle share).
   stream-train: the data path from file to card. A synthetic 3-class
   split (STREAM_TRAIN_FRAMES train and STREAM_VALID_FRAMES valid frames of
   [1024, 2] f32, made from a seed) is packed with `pack_split_to_npy`
   (STREAM_SHARD_ROWS rows a shard) into a temporary directory and read
   back with `PackedDataSource` (whether the native gather ran is printed;
   its rows must equal the source's). One epoch of `StreamFeed` batches
   through `device_prefetch` must arrive on the card byte for byte. The ViT
   flagship (3 classes, dropout 0.1) trains STREAM_EPOCHS epochs at
   B=STREAM_BATCH through `fit(profile=True)` on that feed, four times from
   the same weights in turns (each batch copied to the card in turn, through
   the prefetcher, through the prefetcher, copied in turn): the four
   parameter sets must be equal bit for bit, each run must launch K3 6 + 6
   a step and K1 5 and K2 1 a validation batch, nothing else, and the
   history must carry step_p50 / step_p90. Each run's epoch wall times and
   step percentiles are printed, and its second epoch runs under
   `torch.profiler` (device kernel time, copy time, idle share).
   `evaluate_feed` and `predict_feed` on the trained model over the train
   split must equal their per-batch-sync versions (each batch's sums and
   argmax read to the host), each timed. The trained weights, saved as a
   reference `.pth`, are evaluated by `python -m vitiq_torch.cli evaluate
   --torch-checkpoint` with a synthetic config on the card: K1 5 and K2 1
   a batch, and its predictions equal `run_evaluation`'s on the same
   weights.
   dsp: the DSP front-end on the card. timing_recovery_kernel
   (csrc/timing.cu: filtered frames to symbols, the coarse phase, the
   Gardner and Mueller-Mueller loops, the circular mean, the strobes) is
   built without a spill (all six instances) and held on synthetic frames
   RRC-shaped at sps 2 and sps 4 (B=4096, 2,048 samples), both loops: in
   positions mode to its plain loop (`tk.timing_scan_plain`) bit for bit,
   full (L//sps steps) and 64 steps from p0; in symbols mode to
   `tk.timing_symbols_plain`, full (bit for bit) and hybrid (window 64: the
   phase within PHASE_TOL, every strobe farther than that from a
   half-integer equal), also at B=4095 and B=1; 30 launches the same bits;
   the matched filter within 1e-5 of
   a float64 np.convolve (not TF32); vitiq's contract bar
   (tests/test_dsp.py:104-130) with `extract_symbols` on the card. Then one
   request of 4,096 frames each through `Server` at full width, against the
   f32 path on the same input (the serving gates), every counter reset
   just before and read just after (K1 5, K2 1, and timing_recovery_kernel
   once for the loops, in symbols mode; each loop request under
   `torch.profiler` runs the matched filter, that one kernel, the arm's
   preprocess and the model, and nothing else): the rawIQ flagship at 1,024
   symbols from 2,048-sample
   frames at sps 2 with each of the four timing methods (the loops hybrid)
   and with the Gardner and Mueller-Mueller full loops; the rawIQ flagship
   on amp_phase features and the ViT flagship on spectrogram images
   (1,024-sample frames); the streaming classifier (64 windows of the
   64-channel channelizer, the ViT flagship). Each is timed (frames/s a
   call, the front-end and the model alone), the streaming call with the
   channelizer alone, the device's idle share of one SPS serving call
   (`torch.profiler`) printed, and timing_recovery_kernel timed in symbols
   mode against the composition the front-end ran before (the positions-mode
   kernel inside tensor operations) and its plain version, and in positions
   mode against the plain loop, beside its bounds (`symbol_bounds`,
   `scan_bounds`: the bytes the run's strobes touch, the chain).
   dsp-train: the gradient of one K4 step of the rawIQ flagship on the sps-2
   front-end's symbols against the plain bf16 layers and the f32 path (the
   train phase's cosine limits); then
   `cli train --sps 2 --timing_method gardner` of the rawIQ flagship on
   synthetic 2,048-sample frames RRC-shaped at sps 2 (3 classes,
   DSP_TRAIN_EPOCHS epochs; its front-end under `torch.profiler` first: the
   matched filter, one timing_recovery_kernel, the arm's preprocess): K4 6 +
   6 and timing_recovery_kernel once a step, K1 5, K2 1 and
   timing_recovery_kernel once an evaluated batch, a falling train loss,
   and `cli evaluate` of its checkpoint printing the run's test accuracy.
   ``--dsp`` runs only the device, build and dsp phases.
   export: the serving artifact (`serve.export_serving`, `ServingArtifact`).
   The ViT flagship and rawiq_best (both at full width: d128/L6/H8, 129
   tokens; d256/L9/H8, 65 tokens) at buckets EXPORT_BUCKETS, and the rawIQ
   flagship at sps 2 (Gardner hybrid, 2,048-sample frames) at
   EXPORT_SPS_BUCKETS, each from a port-written experiment directory
   (config.json, normalization_stats.json, model_best.npz of seeded
   weights) through `export_from_experiment`, then loaded on the card (one
   CUDA graph a bucket, largest first, one memory pool). Each bucket's
   captured launches (`captured_launches`) must equal what one eager request
   launches (K1 n_layers - 1, K2 1, timing_recovery_kernel 1 at sps 2; a
   replay of the sps-2 graph runs the matched filter, that kernel, the
   arm's preprocess and the model in that order). Ragged
   requests (EXPORT_SIZES, EXPORT_SPS_SIZES) through the graphs must equal
   the eager `Server` on the same weights bit for bit (else within
   EXPORT_TOL with the same argmax, counted and printed; every request goes
   through the graphs before the eager ones, so a returned result that a
   later replay overwrote would differ), and the logits pass the serving
   gates against the f32 `reference` path. `torch.profiler` over
   EXPORT_REPLAYS replays of bucket 8 must show per replay each of the
   port's serving kernels (SERVING_KERNELS, by full name) as many times as
   one eager request launches it. Host-side counters do not tick on a
   replay, so every replay of the phase runs under `torch.profiler`: its
   kernels, counted by name, must equal the requests times one eager
   request's (K1's attention_core_kernel, K2's cls_pool_kernel, the scan
   kernel), and those counts are the phase's launches (`export_launches` in
   the kernels line's K1, K2, pooling and scan entries; one K1 call
   launches one attention_core_kernel, one K2 call one cls_pool_kernel).
   mdf: MDF-NET (`models/mdf.py`) at B=MDF_BATCH on the card against the
   CPU, under cuDNN's TF32 flag on, PyTorch's default, which the module
   turns off in its forward and backward (`mdf_check`): logits and a
   training step's loss within MDF_REL, gradients against float64
   (MDF_COND), one Adam step; a control whose backward runs under the flag
   must fail the gradient gate.
   ``--export`` runs only the device, build, export and mdf phases.
   scan-train: device-scan training, K train steps as one captured CUDA
   graph (`train/loop.make_train_scan_step`). The ViT flagship (K3) and the
   rawIQ flagship (K4) at full width, `tpu` numerics, dropout SCAN_DROP,
   B=SCAN_BATCH, each trained through `fit` for SCAN_EPOCHS epochs twice
   from the same weights and seeds, with ``device_scan_steps`` 0 and SCAN_K,
   on a synthetic 3-class split of two full superbatches and three single
   steps an epoch (SCAN_TRAIN frames): the histories (but the epoch times)
   and the final parameters must be equal bit for bit; each run's ms a step
   over its epochs (host clock, evaluation included) and peak device memory
   are printed. Then per arm one group of SCAN_K steps eager against the
   scan step (its first call the eager warm-up and the capture, the next a
   replay) on the same data (`scan_graph_check`): parameters and moments
   bit for bit, `torch.profiler`'s kernels of the replay by name equal to
   those of the eager group's steps (profiled SCAN_PROFILE_STEPS steps a
   window, the windows summed), and K3's or K4's launches counted in
   the replay's own trace (`replay_launches`: each wrapper's kernel
   instances in one eager call, the replay's instances solved for the two
   wrappers' counts, every instance accounted for) equal to SCAN_K times a
   step's (`scan_launches` in the kernels line's K3 / K4 entries), and ms a
   step eager and through the graph (host
   clock and CUDA events), the device's idle share (its kernels' time under
   `torch.profiler` against the unprofiled host clock), the capture time and
   the peak memory. The conv1d flagship at depth SCAN_CONV1D_LAYERS with
   K=SCAN_CONV1D_K (K5, each layer rematerialized) is held the same way.
   sweep: `sweep.run_pso_sweep(n_particles=4, iters=2, train_steps=30,
   bucket=True)` on the card (its evaluations, architectures captured and
   wall time printed), then one architecture evaluated through eager steps
   and through its graph (the first call capturing, the second replaying):
   the trained parameters and the accuracy equal, the three times printed.
   ``--scan`` runs only the device, build, scan-train and sweep phases;
   ``--sweep`` the sweep phase and a longer sweep (`sweep_scale_check`:
   SWEEP_SCALE and the largest architecture at its train_steps: times,
   graphs captured, peak memory); ``--steps`` only the train steps whose
   dropout the plain sites' kernel draws (`time_steps`), which also runs on
   a tree without that kernel.
   parallel: the device mesh (`vitiq_torch/parallel/`) in two worlds of two
   ranks, each a process spawned by `parallel.comm.spawn` on the card (gloo
   when the machine has fewer cards than ranks, NCCL otherwise; the backend
   printed) after this process built the kernel library: DP 2 trains the
   ViT flagship through K3 at a global B=512 (256 a rank), dropout 0, then
   evaluates 2,048 frames through K1/K2 sharded; TP 2 trains it through the
   plain layers with K5 on 4 heads and FFN 256 a rank at dropout 0.1
   (the FFN hidden site's mask drawn over the shard's lanes). Each against
   one process on the same inputs (TP against the plain layers,
   VITIQ_FUSED_TRAIN=0): every step's loss within PARALLEL_LOSS_GAP
   relative, the first step's gradient cosine >= COSINE_F32, argmax
   agreement >= PARALLEL_AGREE on rows of top-2 margin >= PARALLEL_MARGIN,
   each rank's launches of K3, K1, K2 and K5 (counters zeroed in the rank
   just before its main path), a step's host time per world beside one
   process's (two ranks share one card: not a gain), and the phase within
   PARALLEL_SECONDS. parallel-cli: ``cli train`` of the ViT flagship
   (``--numerics tpu``, one epoch on a small synthetic corpus) under
   torchrun, ``--data_parallel 2`` then ``--model_parallel 2``: exit 0, the
   backend printed, summary.json, model_best.npz in the one-process layout.
   ``--parallel`` runs only the device, build, parallel and parallel-cli
   phases. The hash-dropout phase also holds the kernel's column
   shards (`lane0`) to the whole activation's bits.
   bench: the throughput module (`vitiq_torch/bench.py`). The three
   geometries no earlier phase serves, rawiq_seg64 (17 tokens, K1 5 + K2 1
   a request), rawiq_seg64_mp (16 tokens) and rawiq_mp (64 tokens; the
   two mean-pool arms K1 6, K2 never), through `Server` against the f32
   path (`serve_check`: 0.05 and 0.99, the fused raw embedding);
   rawiq_seg64_mp trained 20 steps through K4 at L=16, K3 never launching
   (`train_check`, cosine >= COSINE_F32 against the f32 path); the ViT
   flagship's last BENCH_TAIL rows at B=16384 (2,113,536 token rows: the
   FFN hidden past 2^31 bytes) against the same rows served alone, in bf16
   (K1/K2) and int8 (K6/K2), within EXPORT_TOL with the same argmax. Then
   `bench.run_benchmarks` once for every ``cli bench --which`` but
   ingestion (h5py, absent here) and all, at the bench's own batches
   (B=16384 serving; train_step B=4096), plus conv1d_infer at n_head 2
   (d_head 64 past K1's shared memory: the plain layers with K5-fwd; at
   BENCH_K5_BATCH),
   `bench_train_step` of rawiq_best (K3) and rawiq_seg64_mp (K4) at
   B=8192, each in its own `torch.profiler` window, the timing cut by
   BENCH_KNOBS and BENCH_STEPS: every value positive and finite, every
   graph-timed step bit for bit its eager step (the bench raises
   otherwise), the kernels launched in each window counted by name
   (`bench_launches`; the kernels line's `bench_launches`), the bench's
   kernels each launched. ``--bench`` runs only the device, build and
   bench phases.
7. timing (CUDA events after warm-up): per-layer kernel time against the
   plain version (K1 and K2 at the three shapes, B=4096 and, at 1025 tokens,
   B=256; K3 at the ViT and rawIQ shapes and K4 at the rawIQ one, B=4096;
   K5-fwd and K5-bwd at B=256, L=1025), each beside its bound (the larger of
   its FLOPs over 989 TFLOP/s and its compulsory bytes over 3.35 TB/s) and,
   as yardsticks the port never calls, nn.TransformerEncoderLayer's time
   beside K1 (ViT and rawIQ shapes, B=4096, conv1d B=256, with whether its
   fused fast path ran), scaled_dot_product_attention's beside K5
   (forward; backward on a kept graph), and nn.TransformerEncoderLayer's
   training forward + backward (bf16, dropout 0) beside K3's and K4's at
   the ViT, rawIQ and rawiq_best shapes (B=4096); K6 per layer at B=4096 (ViT, rawIQ)
   against its plain version and K1, its bound (int8 GEMM operations over
   1979 TOP/s plus bf16 attention FLOPs over 989 TFLOP/s, or its bytes), its
   time by stage (`torch.profiler`: the row-quantization pass, QKV,
   attention, out-proj + LN1, FFN1, FFN2 + LN2) beside K1's by stage on the
   same shape, and its FFN1 stage (levels in, as the layer runs it) against
   torch._int_mm at that shape (also at rawiq_best's); serving frames/s and
   p50 latency at B=4096 (ViT, rawIQ) and B=2048 (conv1d), through the
   kernels and through the plain layer loop, and at B=4096 (ViT, rawIQ)
   through the int8 path; K7 per layer at B=4096 (ViT, rawIQ, rawiq_best)
   and B=256 (conv1d), and its int8 core alone (the routed form, and each
   form), against its plain version
   and K1 (and K1's core) in the same call, with its bound (K1's
   GEMM FLOPs at 989 TFLOP/s plus its s8 score and P [v | 1] operations at
   1979 TOP/s, or its bytes; no PyTorch call computes the layer, so no
   library time; the core alone by its s8 operations or its bytes); K2
   beside both its bounds (`k2`, the layer's function with K and V formed,
   and `k2_cls`, the reassociated work it does) and its pooling kernel alone
   beside its plain version, its bound and scaled_dot_product_attention on
   the same qt and x (one query a head, x as keys and values, scale ln 2: a
   yardstick the port never calls); rawiq_best's layer at B=4096 (K1, K2, K6, K3 at
   L=65, K4 at rawiq_best_mp's L=64, each beside its plain version and bound,
   and nn.TransformerEncoderLayer(256, 8, 1024)), its serving (bf16 and
   int8) and train steps (rawiq_best through K3, with a `torch.profiler`
   breakdown by kernel, rawiq_best_mp through K4); ViT (B=4096) and conv1d
   (B=2048) serving with VITIQ_ATTN_INT8=1 (K7 + K2); serving p50 latency
   at the small batches SMALL_BATCHES (ViT flagship and rawiq_best through
   K1 + K2, eager and through a serving artifact's graphs) and the host time
   of one K1 call at B=1 (`time_small_batches`);
   train-step frames/s and peak device memory: the ViT flagship through K3
   and through the plain layers, the rawIQ flagship through K4, through K3
   (VITIQ_TRAIN_STASH=0) and through the plain layers (B=4096), the conv1d
   flagship with remat (auto) and without (VITIQ_TRAIN_REMAT=0) (B=256),
   and a `torch.profiler` breakdown of the conv1d step (device kernel time
   by kernel, idle share; K5's three kernels a launch, K5-bwd by pass); K3
   and K4 at the added widths per layer at B=4096
   (vit_tpu_production: K3 at L=129, H=2; the rawIQ flagship at n_head 2: K4
   at L=65; vit_tiny_2016: K3 and K4 at D=64, L=17) with their bounds, and
   the vit_tpu_production and vit_tiny_2016 train steps at B=4096 through
   K3 / K4 and through the plain layers with K5 (VITIQ_FUSED_TRAIN=0, the
   path they took before K3/K4 took their widths); K3-fwd and K3-bwd
   (rawiq_best, ViT) and K4-fwd and K4-bwd (rawIQ, rawiq_best_mp) by stage
   with `torch.profiler`; K4's attention passes alone at B=4096 beside their
   plain versions and their byte floors (`attention_pass_bounds`), with the
   stash's bytes a frame and layer; K3's attention passes alone at B=4096 at
   the shapes K3 trains (K3_PASS_TIMED) beside their plain versions, their
   bounds (`recompute_pass_bounds`) and scaled_dot_product_attention's
   forward and backward on [B, H, L, dh] bf16 (a yardstick the port never
   calls); beside the card's name and power limit.
8. probes: the counterparts of the TPU probes under scripts/
   (`vitiq_torch/probes/`, `csrc/probes.cu`). The `ptxas -v` lines of the
   probe kernels (none may spill), of K1's one-pass core with and without
   P3's NOEXP flag (K1's registers must be fel.K1_ATTENTION_REGISTERS) and
   of every instance of K1's wgmma GEMM stage and core (none may spill),
   and their SASS (cuobjdump): HGMMA in K1's GEMM stages and core, MUFU.EX2
   in K1's core, P3 keeping every FMNMX of K1's running max with no
   MUFU.EX2. The probes' main path, every
   probe counter reset just before and read just after: P1
   (`mask_ops.report`, as `python -m vitiq_torch.probes.mask_ops`) builds, launches
   and holds each of its 11 variants to its plain version (elementwise bit
   for bit, exp2 within 2 ulp, mm_* within 1e-5 of the sum of |products|);
   P2 (`refcost.measure` at REFCOST_ARGS) times its three arms and prints
   the per-operand price; P3 (`exp.time_stacks`) times the no-exp 6-layer
   stack against K1's at P3_SHAPES. Then each probe kernel against its plain
   version with its time, bound and PyTorch yardstick (P1: torch.add or
   torch.exp2 on the same input; P2: each arm bit for bit against in + 1,
   beside torch._foreach_add and x + 1; P1's and P2's kernels and those
   yardsticks also by their device time alone, `device_ms`, since a P1
   wrapper call's host cost is ~20x its kernel; P3 at each P3 shape, its layer within
   1e-2 relative L2 over the rows whose sums of scores are not small beside
   their magnitudes (over all rows too at the ViT and conv1d shapes) and its
   attention core alone within 1e-2 in each such row on the same qkv), and
   K1's and P3's time
   by stage (`torch.profiler`: QKV, attention, out-proj + LN1, FFN1, FFN2 +
   LN2) at the ViT (B=4096), conv1d (B=256) and rawiq_best (B=4096) shapes,
   with the exp's share of K1's attention stage and layer. k2k7-stages: K2
   (q, qt, pool, V, out-proj + LN1, FFN1, FFN2 + LN2) and K7 (QKV, its int8
   core, out-proj + LN1, FFN1, FFN2 + LN2) by stage (`torch.profiler`) at
   the ViT, rawIQ, conv1d and rawiq_best shapes (K2K7_SHAPES).

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.

``python3 chip_smoke.py --latency`` runs only the device and build phases
and `time_small_batches`, and prints its numbers as one JSON line (to
compare two trees of the port in one call: copy this script into each tree's
root and run it there; its artifact p50s need a tree with
`serve.ServingArtifact`). ``--k4`` does the same with `time_k4`: K4's layers
by stage and the train steps that go through it; ``--k3`` with `time_k3`:
K3's layers at the shapes it trains, each by stage, and the train steps
through K3; ``--k2k7`` with `time_k2k7`: K2, K7 and K1 a layer, K7's and
K1's cores alone, K2 and K7 by stage, at K2K7_SHAPES, serving in bf16 and
under VITIQ_ATTN_INT8=1 at the four arms, and K7's two core forms over L
(K7_SWEEP_L). ``--latency`` also times K2's host time a call at B=1.

The launches of K2's pooling kernel and K7's two cores are counted by the C
code where it launches each (`fel.kernel_launches`); the kernels line gives
those counts from the main path's runs (the ViT flagship's serve phase, and
the ViT flagship's and rawiq_best's evaluations under VITIQ_ATTN_INT8=1).
timing_recovery_kernel's launches are counted by timing.cu
(`tk.kernel_launches`) over the dsp phase's serving requests; it has no TPU
twin (the JAX package runs the loops as a lax.scan), which its entry says. The K1, K2, pooling and
scan entries also give `export_launches`: the export phase's launches of
each through the graphs, from its `torch.profiler` traces. The K3 and K4
entries give `scan_launches`: the launches of one replay of the scan-train
phase's graph (SCAN_K steps), counted in that replay's own `torch.profiler`
trace. Every entry gives `bench_launches`: its launches in the bench
phase's profiled windows (zero for a kernel off the bench's path). The
plain dropout sites' kernel (`hash_dropout_kernel`, no TPU twin:
the JAX package draws these masks with jax.random) gives the conv1d train
phase's launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from vitiq_torch.config import DataConfig, ExperimentConfig, TrainConfig
from vitiq_torch.config import (
    flagship_conv1d_config,
    flagship_rawiq_config,
    flagship_vit_config,
    rawiq_best_config,
    rawiq_best_mp_config,
    rawiq_mp_config,
    rawiq_seg64_config,
    rawiq_seg64_mp_config,
    vit_tiny_2016_config,
)
from vitiq_torch import bench
from vitiq_torch.eval import ClassificationReportParser
from vitiq_torch.models import AMCModel
from vitiq_torch.models.layers import EncoderLayer
from vitiq_torch.ops.cuda import _build
from vitiq_torch.ops.cuda import flash_attention as fa
from vitiq_torch.ops.cuda import fused_encoder_layer as fel
from vitiq_torch.ops.cuda import fused_encoder_layer_int8 as k6
from vitiq_torch.ops.cuda import fused_encoder_layer_int8attn as k7
from vitiq_torch.ops.cuda import fused_layer_train as flt
from vitiq_torch.ops.cuda import timing as tk
from vitiq_torch.ops.metrics import label_smoothed_cross_entropy
from vitiq_torch.ops.quant import QuantizedEncoderLayer, quantize_params_int8
from vitiq_torch.probes import exp as p3
from vitiq_torch.probes import mask_ops, refcost
from vitiq_torch.probes._timing import time_amortized
from vitiq_torch import cli
from vitiq_torch.runner import run_evaluation, run_training
from vitiq_torch.serve import (
    Server,
    build_forward_and_preprocess,
    build_int8_serving_fn,
    build_serving_fn,
)
from vitiq_torch.train.checkpoint import load_params, save_params
from vitiq_torch.train import fit, make_train_step
from vitiq_torch.train.optim import create_train_state, make_optimizer

# (atol, rtol) on bf16 outputs, |kernel - plain| <= atol + rtol * |plain|.
# One layer on the same input: about two bf16 ulps (2^-7 relative each) plus
# an absolute floor near zero -- the two sum in different orders, so bf16
# roundings may flip. A stack of layers: twice that, since each layer's flips
# feed the next one's input.
LAYER_TOL = (3e-2, 1.6e-2)
STACK_TOL = (6e-2, 3.2e-2)
LOGIT_GATE, AGREE_GATE = 0.05, 0.99
# K3-bwd's gradients are sums over B*L rows taken in another order than the
# plain version's, from operands whose bf16 roundings may flip: each within
# 1% of the plain gradient in the L2 norm.
GRAD_REL = 1e-2
# K5-fwd's out, |kernel - plain| <= 0.08 * rms(plain) + 1.6e-2 * |plain|: an
# output of attention over L keys of unit-variance scores has an rms near
# sqrt(e / L) (~0.05 at L=1025), so the floor follows it, while the relative
# part keeps LAYER_TOL's two bf16 ulps. The f32 log-sum-exp (log2 units) sums
# the same f32 p in another order: within 1e-3 (a dropped key or a denominator
# a few tenths of a percent off moves it more).
K5_OUT_TOL = (0.08, 1.6e-2)
K5_LSE_ATOL = 1e-3
# (B, L, n_head, D) of K5 in the parallel phase's TP 2 world: the ViT
# flagship's 8 heads of d_head 16 split over 2 ranks, B=256 at 129 tokens
K5_TP_SHAPE = (256, 129, 4, 64)
# K4's forward pass alone, pbar = bf16(bf16(exp2(s - max)) / l) on the same
# qkv as the plain version: s sums the same bf16 products in another order and
# the quotients are IEEE's, so only a bf16 rounding of p or of p / l may flip.
# A flipped p moves p / l by under 2 ulps of the quotient's binade (p at the
# foot of its binade, p / l near the top of its own); rounding the quotient,
# across a binade edge, adds one more. Each element within PBAR_ULPS bf16
# ulps of |plain| (LAYER_TOL's absolute part is twice a typical entry, 1 / L).
PBAR_ULPS = 3
COSINE_PLAIN, COSINE_F32 = 0.999, 0.995
TRAIN_DROP, TRAIN_SEED = 0.1, 1234
STATS = {"i_mean": 0.0, "i_std": 1.0, "q_mean": 0.0, "q_std": 1.0}
RAW_STATS = {"i_mean": 0.1, "i_std": 1.3, "q_mean": -0.2, "q_std": 0.9}
RAW_DROP = 0.2  # the rawIQ flagship's dropout
BEST_DROP = 0.1  # rawiq_best's
K3 = ("fused_train_layer_fwd", "fused_train_layer_bwd")
K4 = ("fused_train_layer_fwd_stash", "fused_train_layer_bwd_stash")
GRAD_NAMES = ("dWqkv", "dbqkv", "dWo", "dbo", "dg1", "dbe1", "dW1", "db1", "dW2", "db2", "dg2",
              "dbe2")
FRAME_LEN = 1024
SOURCE = "vitiq_torch/csrc/fused_encoder_layer.cu"
TPU_SOURCE = "vitiq/ops/pallas/fused_encoder_layer.py"
TRAIN_SOURCE = "vitiq_torch/csrc/fused_layer_train.cu"
TRAIN_TPU_SOURCE = "vitiq/ops/pallas/fused_layer_train.py"
ATTN_SOURCE = "vitiq_torch/csrc/flash_attention.cu"
ATTN_TPU_SOURCE = "vitiq/ops/pallas/flash_attention.py"
K5 = ("fused_attention_fwd", "fused_attention_bwd")
CONV1D_L = 1025  # the conv1d flagship's tokens, CLS included
# the plain dropout sites' kernel (`flt.hash_dropout`): its counter, what it
# stands in for in the JAX package (the plain layers' and the embedding's
# jax.random.bernoulli dropout, no TPU kernel), and where the check holds it
# to its plain version: the main path's activations (the conv1d flagship's
# FFN hidden, attention output and embedding at B=64; the ViT and rawIQ
# flagships' embeddings at B=256), bf16 and f32
DROP_KERNEL = "hash_dropout"
DROP_JAX = "vitiq/models/layers.py:76"
DROP_SHAPES = (((64, CONV1D_L, 1024), torch.bfloat16), ((64, CONV1D_L, 128), torch.bfloat16),
               ((256, 129, 128), torch.bfloat16), ((256, 65, 128), torch.float32),
               ((8, CONV1D_L, 128), torch.float32), ((3, 17, 96), torch.bfloat16))
# timed at the conv1d flagship's FFN hidden in its B=256 train step
DROP_TIME_SHAPE = (256, CONV1D_L, 1024)
# the hash's 32-bit operations a position: the lane's product and xor, the
# seed add, fmix32's three shifts, three xors and two products, the mask,
# the compare, the scale
DROP_OPS = 14
K6 = "fused_encoder_layer_int8"
# K6 against its plain version: (relative L2, max in quantization steps),
# ||kernel - plain|| <= rel ||plain|| and every element within `steps` of a
# row's absmax / 127 of the plain output. Past the exact int8 products a
# one-ulp bf16 flip in an activation (K1's attention core sums in another
# order) can move a downstream quantized value by a level, so K6 is not held
# by bf16 ulps per element. One layer on the plain version's input: 1e-2 and
# 2 steps; the five-layer stack with its K2 CLS tail: 2e-2 and 4 steps.
K6_LAYER_TOL = (1e-2, 2.0)
K6_STACK_TOL = (2e-2, 4.0)
# int8 serving against the f32 path: the JAX package's own bound,
# max |dlogit| < 0.35 * max(|ref|, 1) (tests/test_quant.py:74); evaluation of
# a trained model: int8 test accuracy within 2 points of float
# (tests/test_quant.py:131-132).
INT8_LOGIT_BOUND, INT8_ACC_POINTS = 0.35, 0.02
K7 = "fused_encoder_layer_int8attn"
# K7 against its plain version, held as K6 is (relative L2, max in
# quantization steps): its int8 core repeats the plain version's roundings,
# but a one-ulp bf16 flip in q or k from its QKV GEMM (summed in another
# order) can move a quantized level and so a probability by one of 127
# steps. One layer: 1e-3 relative L2, below what K1's bf16 core in K7's
# place reads (1.5e-3 to 2.1e-3 on the CPU, and checked on the card at each
# shape); the stack with its K2 tail: K6's 2e-2 and 4 steps, which that
# mutation passes (its five layers of bf16 flips read as much as the core
# does), so the core alone is gated too: s32 score and P [v | 1] products
# on the same quantized operands bit for bit, fewer than K7_CORE_DIFFER of
# its int8 probabilities and bf16 outputs differing from the plain
# version's (K1's core differs in ~75% of outputs), and the same bits with
# and without the dump.
K7_LAYER_TOL, K7_STACK_TOL = (1e-3, 2.0), K6_STACK_TOL
K7_CORE_DIFFER = (1e-3, 1e-2)
# the evaluate phase's training: the ViT flagship stays at chance for ~15
# epochs at lr 3e-4, B=128 on this corpus before it learns (lr 1e-3 at B=256
# or 64 and lr 1e-4 at B=256 did not leave chance in 16-40 epochs), so early
# stopping is off (patience = epochs)
EVAL_EPOCHS, EVAL_BATCH, EVAL_LR = 40, 128, 3e-4
EVAL_MIN_ACC = 0.5  # 3 classes: chance is 1/3
# rawiq_best's evaluate phase: a short run_training (its validation passes
# run K1/K2 at d256), then run_evaluation in float, int8 and int8 attention;
# launches and report files are gated, not accuracy
BEST_EVAL_EPOCHS, BEST_EVAL_LR = 2, 1e-4
# rawiq_best through `cli train`: 2 epochs with a checkpoint after each, then
# resume="auto" to a third, validation under VITIQ_ATTN_INT8=1
BEST_CLI_EPOCHS = 2
# the head-to-head phase: both arms for a few epochs on the default corpus
# (launch- and file-gated, not accuracy-gated)
H2H_EPOCHS = 3
DEVICE = torch.device("cuda", 0)
# the JAX package's recommended ViT (n_head 2, d_head 64) under `tpu` numerics
VIT_TPU_PRODUCTION = dataclasses.replace(ExperimentConfig.vit_tpu_production().model,
                                         numerics="tpu")
# Published peaks of one H100 SXM:
# dense bf16 tensor-core FLOP/s, int8 tensor-core OP/s and HBM bytes/s. A
# kernel's bound is the larger of its operations and its compulsory bytes
# (inputs read once, outputs written once) over these.
PEAK_FLOPS, PEAK_INT8_OPS, PEAK_BYTES = 989e12, 1979e12, 3.35e12
SFU_EXP2_PER_CLOCK_SM, N_SM = 16, 132  # Hopper's special-function units


# the stream-train phase: a synthetic 3-class split packed to shards (about
# 220 MiB of [1024, 2] f32 frames), streamed to the card and trained on
STREAM_TRAIN_FRAMES, STREAM_VALID_FRAMES, STREAM_SHARD_ROWS = 24_576, 4_096, 8_192
STREAM_BATCH, STREAM_EPOCHS, STREAM_SEED = 4096, 2, 17


# train_gemm_kernel<EPI, BN, RESIDENT, XH16> instances the layers reach
TRAIN_GEMM_INSTANCES = 33


# wg_attention_fwd<DH, NG> (NG 2, 4, 5) and wg_attention_bwd_stash<DH, NG,
# RESIDENT> (2, 4, 5 resident; 4 streamed) at d_head 16, 32, 64: K4's passes
K4_ATTENTION_INSTANCES = 21
# wg_recompute_attention_bwd<DH, NG> (NG 2, 4, 5, 9) and
# wg_recompute_attention_fwd<DH, NG> (the same but <16, 9>, whose shapes the
# routing sends to the mma.sync forward) at d_head 16, 32, 64: K3's passes
K3_ATTENTION_INSTANCES = 12 + 11


def check_train_spills() -> None:
    """The build's `ptxas -v` report of csrc/fused_layer_train.cu: print the
    registers of each attention block and of each GEMM stage instance
    (train_gemm_kernel), and fail if any function of the file spills (the
    d_head-64 backward parks its column sums in shared memory so that it need
    not) or a stage instance or an instance of K4's or K3's wgmma attention
    passes (wg_attention_*, wg_recompute_attention_*) has no HGMMA in its
    SASS (cuobjdump, beside nvcc)."""
    import re

    report = _build.ptxas_report("fused_layer_train")
    for name, dh, regs in re.findall(r"entry function '[^']*?(train_attention\w*?)ILi(\d+)E.*?"
                                     r"Used (\d+) registers", report, re.S):
        print(f"  ptxas {name}<{dh}>: {regs} registers", flush=True)
    spilled = sum(map(int, re.findall(r"(\d+) bytes spill", report)))
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
                           str(_build.build())], capture_output=True, text=True, timeout=600,
                          check=True).stdout
    bodies = [block.split("\n", 1) for block in sass.split("Function : ")[1:]]
    entries = _build.ptxas_entries(report)
    passes = {n: v for n, v in entries.items() if "wg_attention" in n}
    if len(passes) != K4_ATTENTION_INSTANCES:
        raise AssertionError(f"{len(passes)} instances of K4's attention passes in the build, "
                             f"want {K4_ATTENTION_INSTANCES}")
    for name, (regs, stores, loads) in sorted(passes.items()):
        kind = re.search(r"(wg_attention_\w+?)ILi(\d+)ELi(\d+)E(?:Lb(\d)E)?", name).groups()
        body = [b for n, b in bodies if n.strip() == name]
        hgmma = body[0].count("HGMMA") if len(body) == 1 else 0
        regime = "" if kind[3] is None else ", resident" if kind[3] == "1" else ", streamed"
        label = f"{kind[0]}<{kind[1]}, {kind[2]}{regime}>"
        print(f"  ptxas {label}: {regs} registers, {stores + loads} bytes spilled, {hgmma} HGMMA "
              f"in its SASS", flush=True)
        if not hgmma:
            raise AssertionError(f"{label} runs no HGMMA")
    k3_passes = {n: v for n, v in entries.items() if "wg_recompute_attention" in n}
    if len(k3_passes) != K3_ATTENTION_INSTANCES:
        raise AssertionError(f"{len(k3_passes)} instances of K3's wgmma attention passes in the "
                             f"build, want {K3_ATTENTION_INSTANCES}")
    for name, (regs, stores, loads) in sorted(k3_passes.items()):
        kind = re.search(r"(wg_recompute_attention_\w+?)ILi(\d+)ELi(\d+)E", name).groups()
        body = [b for n, b in bodies if n.strip() == name]
        hgmma = body[0].count("HGMMA") if len(body) == 1 else 0
        label = f"{kind[0]}<{kind[1]}, {kind[2]}>"
        print(f"  ptxas {label}: {regs} registers, {stores + loads} bytes spilled, {hgmma} HGMMA "
              f"in its SASS", flush=True)
        if not hgmma:
            raise AssertionError(f"{label} runs no HGMMA")
    stages = {n: v for n, v in entries.items() if "train_gemm_kernel" in n}
    if len(stages) != TRAIN_GEMM_INSTANCES:
        raise AssertionError(f"{len(stages)} train_gemm_kernel instances in the build, want "
                             f"{TRAIN_GEMM_INSTANCES}")
    for name, (regs, stores, loads) in sorted(stages.items()):
        epi, bn, resident, xh16 = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E", name).groups()
        tag = f"train_gemm_kernelILi{epi}ELi{bn}ELb{resident}ELb{xh16}E"
        body = [b for n, b in bodies if tag in n]
        hgmma = body[0].count("HGMMA") if len(body) == 1 else 0
        kind = f"{epi}, {bn}, {'resident' if resident == '1' else 'streamed'}"
        print(f"  ptxas train_gemm_kernel<{kind}{', bf16 xh' if xh16 == '1' else ''}>: {regs} "
              f"registers, {stores + loads} bytes spilled, {hgmma} HGMMA in its SASS", flush=True)
        if not hgmma:
            raise AssertionError(f"train_gemm_kernel<{kind}, {xh16}> runs no HGMMA")
    print(f"  ptxas fused_layer_train.cu: {spilled} bytes spilled in all", flush=True)
    if spilled:
        raise AssertionError(f"fused_layer_train.cu spills {spilled} bytes")


def check_k5_build() -> None:
    """K5's three kernels at d_head 16/32/64 in the build: their `ptxas -v`
    registers and spills (none may spill), HGMMA in each one's SASS
    (cuobjdump, beside nvcc), and their launch shape (`fa.ring_info`: the
    ring's shared memory, blocks an SM at one and two warpgroups, the
    warpgroups a block takes)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.build())], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    bodies = dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])
    for name in fa.KERNELS:
        for dh in fa.SUPPORTED_D_HEAD:
            tag = fa.kernel_tag(name, dh)
            regs, stores, loads = _build.kernel_resources("flash_attention", tag)
            body = [b for n, b in bodies.items() if tag in n]
            hgmma = body[0].count("HGMMA") if len(body) == 1 else 0
            print(f"  K5 {name}<{dh}>: {regs} registers, {stores + loads} bytes spilled, "
                  f"{hgmma} HGMMA in its SASS; {fa.ring_info(name, dh)}", flush=True)
            if stores or loads or not hgmma:
                raise AssertionError(f"K5 {name}<{dh}> spills or runs no HGMMA")


def check_k6_build() -> None:
    """K6's s8 GEMM stage instances (gemm_s8_kernel) in the build: their
    `ptxas -v` registers and spills (none may spill), and their SASS
    (cuobjdump, beside nvcc) must run IGMMA, the integer warpgroup MMA (an
    HGMMA there is the empty `HGMMA.64x8x16.F16 RZ` that ptxas adds beside
    registers it fences, as in K1's stages); every instance of
    `k6.S8_INSTANCES` must be there."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.build())], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    bodies = [block.split("\n", 1) for block in sass.split("Function : ")[1:]]
    entries = {k6.s8_instance_of(n): v for n, v in
               _build.ptxas_entries(_build.ptxas_report("fused_encoder_layer")).items()
               if k6.s8_instance_of(n)}
    if sorted(entries) != sorted(k6.S8_INSTANCES):
        raise AssertionError(f"gemm_s8_kernel instances {sorted(entries)}, want "
                             f"{sorted(k6.S8_INSTANCES)}")
    for inst, (regs, stores, loads) in sorted(entries.items()):
        body = [b for n, b in bodies if k6.s8_instance_of(n) == inst]
        igmma = body[0].count("IGMMA.64x") if len(body) == 1 else 0
        op, bn, resident = inst
        print(f"  K6 gemm_s8_kernel<{op}, {bn}, {'resident' if resident else 'streamed'}>: "
              f"{regs} registers, {stores + loads} bytes spilled, {igmma} IGMMA in its SASS",
              flush=True)
        if stores or loads or not igmma:
            raise AssertionError(f"K6 gemm_s8_kernel {inst} spills or runs no IGMMA")


def check_k2k7_build() -> None:
    """K7's cores (attention_int8_kernel and attention_int8_sync_kernel at
    d_head 16/32/64, with and without their DUMP variants) and K2's pooling
    kernel (cls_pool_kernel at d_model 64, 128 and 256, and 256 with two
    head blocks) in the build: their `ptxas -v` registers and spills (none
    may spill), and their SASS (cuobjdump, beside nvcc): IGMMA (the integer
    warpgroup MMA) in every wgmma core, IMMA (s8 mma.sync) in every
    one-tile core, HMMA (mma.sync) in every pooling kernel."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.build())], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    bodies = dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])
    entries = _build.ptxas_entries(_build.ptxas_report("fused_encoder_layer"))
    for tag, op, want in (("attention_int8_kernel", "IGMMA.64x", 6),
                          ("attention_int8_sync_kernel", "IMMA", 6), ("cls_pool_kernel", "HMMA", 4)):
        mine = {n: v for n, v in entries.items() if tag in n}
        if len(mine) != want:
            raise AssertionError(f"{len(mine)} instances of {tag} in the build, want {want}")
        for name, (regs, stores, loads) in sorted(mine.items()):
            short = name[name.index(tag):]
            body = [b for n, b in bodies.items() if short in n]
            count = body[0].count(op) if len(body) == 1 else 0
            print(f"  {short.split('EEv')[0]}: {regs} registers, {stores + loads} bytes spilled, "
                  f"{count} {op.split('.')[0]} in its SASS", flush=True)
            if stores or loads or not count:
                raise AssertionError(f"{short} spills or runs no {op}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def random_layers(n_layers: int, ffn: int, seed: int, device, D: int = 128, H: int = 8):
    gen = torch.Generator().manual_seed(seed)
    layers = [EncoderLayer(D, ffn, H, device=device, generator=gen).eval()
              for _ in range(n_layers)]
    with torch.no_grad():  # LayerNorm affine away from (1, 0)
        for layer in layers:
            for norm in (layer.norm1, layer.norm2):
                norm.gamma.copy_(1.0 + 0.1 * torch.randn(D, generator=gen))
                norm.beta.copy_(0.1 * torch.randn(D, generator=gen))
    return layers


def check_close(label: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    atol, rtol = tol
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite kernel output")
    err = (got - want).abs()
    max_abs = err.max().item()
    excess = (err - (atol + rtol * want.abs())).max().item()
    print(f"  {label}: max |kernel - plain| = {max_abs:.6g}, mean {err.mean().item():.6g} "
          f"(max excess over {atol} + {rtol}*|plain|: {excess:.6g})", flush=True)
    if excess > 0:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return max_abs


# The widths past d_model 128 / d_head 32 the serving kernels take, at the
# shapes of the geometries that need them: (name, L, FFN, D, H).
WIDE_SHAPES = (("rawiq_best", 65, 1024, 256, 8), ("vit_tiny_2016", 17, 256, 64, 4),
               ("d_head 64", 129, 512, 128, 2))


def check_kernels(device, conv1d_batch: int = 64, batch: int = 256) -> dict:
    """Each K1 layer and the K2 layer on the same input as the plain version
    (the plain output of the layer before), then the 5-layer K1 stack end to
    end, at the flagship shapes (D=128, H=8) and WIDE_SHAPES. Returns the
    largest per-layer difference of each kernel."""
    errs = {"k1": 0.0, "k2": 0.0}
    gen = torch.Generator().manual_seed(7)
    shapes = [("vit", 129, 512, 128, 8), ("rawiq", 65, 1024, 128, 8),
              ("conv1d", CONV1D_L, 1024, 128, 8), *WIDE_SHAPES]
    for seed, (name, L, ffn, D, H) in enumerate(shapes):
        B = conv1d_batch if L == CONV1D_L else batch
        wide = "" if (D, H) == (128, 8) else f" D={D} H={H}"
        print(f"phase kernels: K1/K2 vs plain version on the GPU, {name} shape B={B} L={L} "
              f"F={ffn}{wide}", flush=True)
        layers = random_layers(6, ffn, seed=11 + seed, device=device, D=D, H=H)
        ops = [fel.layer_operands(layer, H) for layer in layers]
        x = torch.randn((B, L, D), generator=gen).to(device, torch.bfloat16)
        with torch.no_grad():
            h = x
            for i in range(5):
                got = fel.fused_encoder_layer(h, ops[i], H)
                want = fel.fused_layer_reference(h, ops[i], H, L)
                torch.cuda.synchronize()
                errs["k1"] = max(errs["k1"], check_close(
                    f"{name} K1 layer {i} (L={L}, F={ffn}{wide})", got, want, LAYER_TOL))
                h = want
            stack = fel.fused_encoder_layer_stack(x, layers[:5], H)
            torch.cuda.synchronize()
            check_close(f"{name} K1 5-layer stack", stack, h, STACK_TOL)
            cls_ops = fel.cls_operands(ops[5], H)
            got = fel.fused_encoder_layer_cls(h, cls_ops, H)
            want = fel.fused_layer_reference(h, ops[5], H, 1)
            own = fel.fused_layer_cls_reference(h, cls_ops, H)
            torch.cuda.synchronize()
            errs["k2"] = max(errs["k2"], check_close(
                f"{name} K2 CLS layer (L={L}, F={ffn}{wide})", got, want, LAYER_TOL))
            check_close(f"{name} K2 CLS layer against its own plain version (qt and xbar "
                        f"rounded as the kernel rounds them)", got, own, LAYER_TOL)
    return errs


def check_cls_pool(device, batch: int = 256, conv1d_batch: int = 64,
                   launches: int = 30) -> float:
    """K2's pooling kernel alone (`fel.cls_pool`) against its plain version
    (`fel.cls_pool_reference`) on the qt that K2's q and qt stages give (in
    plain PyTorch, from seeded random layers) at the flagship shapes, the
    wide ones and d_model 256 at d_head 16 (two head blocks), B=256 (conv1d
    B=64): within GRAD_REL in the L2 norm and elementwise within LAYER_TOL
    (the two sum the same bf16 products in other orders, so a p may round
    the other way), `launches` launches giving the first launch's bits.
    Returns the max |difference|."""
    worst = 0.0
    shapes = [("vit", 129, 128, 8), ("rawiq", 65, 128, 8), ("conv1d", CONV1D_L, 128, 8),
              ("rawiq_best", 65, 256, 8), ("vit_tiny_2016", 17, 64, 4), ("d_head 64", 129, 128, 2),
              ("d_model 256 at d_head 16", 33, 256, 16)]
    gen = torch.Generator().manual_seed(17)
    print(f"phase cls-pool: K2's pooling kernel vs its plain version on the GPU, {launches} "
          f"launches the same bits", flush=True)
    for seed, (name, L, D, H) in enumerate(shapes):
        B = conv1d_batch if L == CONV1D_L else batch
        layer = random_layers(1, 256, seed=71 + seed, device=device, D=D, H=H)[0]
        ops = fel.cls_operands(fel.layer_operands(layer, H), H)
        x = torch.randn((B, L, D), generator=gen).to(device, torch.bfloat16)
        with torch.no_grad():
            q = (fel._mm(x[:, 0], ops[0][:, :D]) + ops[1][:D]).to(torch.bfloat16)
            qt = (fel._mm(q, ops[12]) + ops[14]).to(torch.bfloat16).reshape(B, H, D).contiguous()
            got = fel.cls_pool(x, qt)
            same = all(torch.equal(got, fel.cls_pool(x, qt)) for _ in range(launches - 1))
            want = fel.cls_pool_reference(x, qt)
            torch.cuda.synchronize()
        label = f"{name} cls_pool B={B} L={L} D={D} H={H}"
        check_rel(label, got, want)
        worst = max(worst, check_close(label, got, want, LAYER_TOL))
        if not same:
            raise AssertionError(f"{label}: {launches} launches do not give the same bits")
    return worst


def check_ulp(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A GEMM stage against an f32 product of the same bf16 operands: every
    element within one bf16 ulp of max(|plain|, rms(plain) / 64) (the two f32
    sums run in other orders, so an output near zero may move by more than
    its own ulp). Returns the max |difference|."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad kernel output {tuple(got.shape)}")
    floor = want.square().mean().sqrt() / 64
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(want.abs(), floor))) - 7)
    err = (got - want).abs()
    worst = (err / ulp).max().item()
    print(f"  {label}: max |kernel - plain| = {err.max().item():.6g}, at most {worst:.3g} bf16 "
          f"ulp (limit 1)", flush=True)
    if worst > 1:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return err.max().item()


def check_k1_parts(device, conv1d_batch: int = 64, batch: int = 256) -> float:
    """K1's kernels one by one on the card at the main path's shapes (the
    three flagships and WIDE_SHAPES, D=128 H=8 unless stated): its four wgmma
    GEMM stages (QKV; out-projection + LN1; FFN1 + ReLU; FFN2 + LN2), each on
    the plain version's input to it, within one bf16 ulp of an f32 product
    of the same operands (`check_ulp`), and its one-pass attention core on
    the QKV stage's qkv against `fel.attention_onepass_reference`: within 1%
    in the L2 norm and elementwise within K5_OUT_TOL (scaled to the output's
    rms). Returns the largest difference."""
    worst = 0.0
    gen = torch.Generator().manual_seed(17)
    shapes = [("vit", 129, 512, 128, 8), ("rawiq", 65, 1024, 128, 8),
              ("conv1d", CONV1D_L, 1024, 128, 8), *WIDE_SHAPES]
    for seed, (name, L, ffn, D, H) in enumerate(shapes):
        B = conv1d_batch if L == CONV1D_L else batch
        print(f"phase k1-parts: K1's GEMM stages and attention core vs their plain versions, "
              f"{name} shape B={B} L={L} F={ffn} D={D} H={H}", flush=True)
        ops = fel.layer_operands(random_layers(1, ffn, seed=31 + seed, device=device, D=D, H=H)[0],
                                 H)
        wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2, g2, be2 = ops
        x = torch.randn((B * L, D), generator=gen).to(device, torch.bfloat16)
        with torch.no_grad():
            qkv = fel.gemm_stage(x, wqkv, bqkv)
            want_qkv = fel.gemm_stage_reference(x, wqkv, bqkv)
            torch.cuda.synchronize()
            worst = max(worst, check_ulp(f"{name} QKV stage [{B * L}, {D}] x [{D}, {3 * D}]",
                                         qkv, want_qkv))
            attn = fel.attention_core(qkv.view(B, L, 3 * D), H)
            want = fel.attention_onepass_reference(qkv.view(B, L, 3 * D), H)
            torch.cuda.synchronize()
            rms = want.float().square().mean().sqrt().item()
            label = f"{name} attention core (L={L}, d_head {D // H})"
            worst = max(worst, check_close(label, attn, want, (K5_OUT_TOL[0] * rms, K5_OUT_TOL[1])),
                        check_rel(label, attn, want))
            attn = want.view(B * L, D)
            x1 = fel.gemm_stage_reference(attn, wo, bo, res=x, gamma=g1, beta=be1)
            hid = fel.gemm_stage_reference(x1, w1, b1, relu=True)
            for label, args, kw in (("out-projection + LN1", (attn, wo, bo),
                                     {"res": x, "gamma": g1, "beta": be1}),
                                    ("FFN1 + ReLU", (x1, w1, b1), {"relu": True}),
                                    ("FFN2 + LN2", (hid, w2, b2),
                                     {"res": x1, "gamma": g2, "beta": be2})):
                got = fel.gemm_stage(*args, **kw)
                want = fel.gemm_stage_reference(*args, **kw)
                torch.cuda.synchronize()
                a, w = args[0], args[1]
                worst = max(worst, check_ulp(f"{name} {label} stage [{a.shape[0]}, {a.shape[1]}] x "
                                             f"[{w.shape[0]}, {w.shape[1]}]", got, want))
        del x, qkv, attn, x1, hid
        torch.cuda.empty_cache()
    return worst


def check_rel(label: str, got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """||got - want|| <= GRAD_REL ||want|| + floor (printed with max
    |difference|); returns the max |difference|. `floor` is for gradients
    that are zero in exact arithmetic (K5's dq and dk at one token)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad kernel output {tuple(got.shape)}")
    err, norm = (got - want).norm().item(), want.norm().item()
    max_abs = (got - want).abs().max().item()
    print(f"  {label}: ||kernel - plain|| / ||plain|| = {err / max(norm, 1e-30):.6g} (limit "
          f"{GRAD_REL}{f' + {floor} / ||plain||' if floor else ''}; ||plain|| {norm:.6g}), "
          f"max |kernel - plain| = {max_abs:.6g}, max |plain| = {want.abs().max().item():.6g}",
          flush=True)
    if not err <= GRAD_REL * norm + floor:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return max_abs


def check_pbar(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """pbar against the plain pbar on the same qkv: every element within
    PBAR_ULPS bf16 ulps of |plain| (the ulp floored at the smallest normal),
    its padding included; returns the max |difference|."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad kernel output {tuple(got.shape)}")
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    err = (got - want).abs()
    worst = (err / ulp).max().item()
    print(f"  {label}: max |kernel - plain| = {err.max().item():.6g}, at most {worst:.3g} bf16 "
          f"ulp (limit {PBAR_ULPS})", flush=True)
    if worst > PBAR_ULPS:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return err.max().item()


def check_attention_kernels(device, B: int = 64) -> dict:
    """K5-fwd and K5-bwd against their plain versions on the same bf16
    inputs (q, k, v the column slices of one [B, L, 3D] qkv, as the model
    passes them), at D=128, L 1, 17, 1025, 1040 and 4097 (B=4 there) and
    d_head 16, 32 and 64, and at the TP 2 world's shape (K5_TP_SHAPE: the
    ViT flagship's 4 heads a rank, D=64 from a 192-wide qkv). K5-fwd: out
    within GRAD_REL of the plain output in the L2 norm and elementwise
    within K5_OUT_TOL (its atol a share of the plain output's rms, which
    falls as 1/sqrt(L): a tolerance fixed at LAYER_TOL's 3e-2 would pass a
    kernel that drops a key or mis-sums the denominator at L=1025), and the
    f32 lse within K5_LSE_ATOL of the plain one; out and
    lse also against the kernel's own function, `fa.attention_onepass_plain`
    (GRAD_REL, K5_LSE_ATOL). K5-bwd: dq, dk, dv each within GRAD_REL of the
    plain gradient in the L2 norm (at L=1, where dq and dk are zero in exact
    arithmetic, plus 1e-6). Contiguous copies of q, k, v and 30 repeated
    launches of both must give the same bits. Returns the largest
    difference of each kernel."""
    errs = {"k5f": 0.0, "k5b": 0.0}
    gen = torch.Generator().manual_seed(9)
    shapes = [(4 if L > 2048 else B, L, n_head, 128) for L in (1, 17, CONV1D_L, 1040, 4097)
              for n_head in (8, 4, 2)] + [K5_TP_SHAPE]
    for b, L, n_head, D in shapes:
        dh = D // n_head
        print(f"phase attention-kernels: K5 vs plain version on the GPU, B={b} L={L} "
              f"H={n_head} d_head={dh}", flush=True)
        qkv = torch.randn((b, L, 3 * D), generator=gen).to(device, torch.bfloat16)
        dout = (0.1 * torch.randn((b, L, D), generator=gen)).to(device, torch.bfloat16)
        q, k, v = qkv.split(D, dim=-1)
        with torch.no_grad():
            out, lse = fa.fused_attention_fwd(q, k, v, n_head)
            grads = fa.fused_attention_bwd(q, k, v, out, lse, dout, n_head)
            torch.cuda.synchronize()
            want, want_lse = fa.attention_plain(q, k, v, n_head)
            one, one_lse = fa.attention_onepass_plain(q, k, v, n_head)
            want_grads = fa.attention_bwd_reference(q, k, v, out, dout, n_head)
        label = f"(L={L}, H={n_head}, d_head {dh})"
        rms = want.float().square().mean().sqrt().item()
        tol = (K5_OUT_TOL[0] * rms, K5_OUT_TOL[1])
        print(f"  K5-fwd out {label}: rms of the plain output {rms:.6g}, atol {tol[0]:.6g}",
              flush=True)
        errs["k5f"] = max(errs["k5f"], check_close(f"K5-fwd out {label}", out, want, tol),
                          check_rel(f"K5-fwd out {label}", out, want))
        check_rel(f"K5-fwd out vs its one-pass function {label}", out, one)
        for name, ref in (("plain", want_lse), ("one-pass", one_lse)):
            if lse.shape != ref.shape or not torch.isfinite(lse).all():
                raise AssertionError(f"K5-fwd lse {label}: bad shape or values")
            lse_err = (lse - ref).abs().max().item()
            print(f"  K5-fwd lse {label} vs the {name} version: max |kernel - plain| = "
                  f"{lse_err:.6g} (limit {K5_LSE_ATOL})", flush=True)
            if not lse_err <= K5_LSE_ATOL:
                raise AssertionError(f"K5-fwd lse {label}: kernel disagrees with the "
                                     f"{name} version")
        for name, grad, want_grad in zip(("dq", "dk", "dv"), grads, want_grads):
            floor = 1e-6 if L == 1 and name != "dv" else 0.0
            errs["k5b"] = max(errs["k5b"], check_rel(f"K5-bwd {name} {label}", grad,
                                                     want_grad, floor))
        with torch.no_grad():
            dense = [t.contiguous() for t in (q, k, v)]
            got = [*fa.fused_attention_fwd(*dense, n_head)]
            got += fa.fused_attention_bwd(*dense, got[0], got[1], dout, n_head)
            same = all(torch.equal(x, y) for x, y in zip(got, (out, lse, *grads)))
            for _ in range(30):
                got = [*fa.fused_attention_fwd(q, k, v, n_head)]
                got += fa.fused_attention_bwd(q, k, v, out, lse, dout, n_head)
                same = same and all(torch.equal(x, y) for x, y in
                                    zip(got, (out, lse, *grads)))
        print(f"  K5 {label}: contiguous inputs and 30 repeated launches give the same "
              f"bits: {same}", flush=True)
        if not same:
            raise AssertionError(f"K5 {label}: the bits moved between launches or layouts")
        del qkv, dout, q, k, v, out, lse, grads, want, one, want_grads, dense, got
    torch.cuda.empty_cache()
    return errs


def gate_logits(label: str, got, want, n: int, num_classes: int) -> float:
    """The serving gates on the logits of n frames against the f32 path's:
    finite, of the expected shape, max |dlogit| < LOGIT_GATE, argmax
    agreement >= AGREE_GATE on the rows whose f32 top-2 margin exceeds 4 max
    |dlogit|."""
    if got.shape != (n, num_classes) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad logits {tuple(got.shape)}")
    max_abs = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    confident = (top2[:, 0] - top2[:, 1]) > 4 * max_abs
    agree = (got.argmax(-1) == want.argmax(-1)).float()
    agree_conf = agree[confident].mean().item() if confident.any() else 1.0
    print(f"  {label}: B={n}; max |dlogit| vs f32 path {max_abs:.6g}; argmax agreement "
          f"{agree.mean().item():.4f} (confident rows: {agree_conf:.4f} over "
          f"{int(confident.sum())})", flush=True)
    if not max_abs < LOGIT_GATE:
        raise AssertionError(f"{label}: bf16 logits diverge from the f32 path")
    if agree_conf < AGREE_GATE:
        raise AssertionError(f"{label}: argmax diverges on confident rows")
    return max_abs


def serve_check(label: str, model_cfg, stats, device, sizes, buckets, k5_route=False,
                data: DataConfig = None, frames=None, scans: int = 0) -> dict:
    """Serve ragged requests through the kernels; compare with the f32 path.
    By default each request must launch K1 once per full layer and K2 once
    (a model that pools on the CLS row), or K1 once per layer and K2 never
    (mean pooling); with `k5_route` (VITIQ_NO_FUSED_LAYER=1, the plain layer
    loop) K5-fwd once per layer and K1/K2 never. No other kernel may launch,
    and timing_recovery_kernel `scans` times a request, every time in
    symbols mode (`tk.timing_symbols`). Requests are random
    frames of the model's `seq_length` samples, or the first `sizes` of
    `frames`; `data` (default: iq features at sps 1) sets the experiment's
    front-end."""
    n_layers = model_cfg.n_layers
    frame_len = model_cfg.seq_length if frames is None else frames.shape[1]
    data = dataclasses.replace(data or DataConfig(), synthetic_frame_len=frame_len)
    exp = ExperimentConfig(model=model_cfg, data=data)
    model = AMCModel(model_cfg, generator=torch.Generator().manual_seed(0))
    cls = model.cls_pooling
    ref_cfg = ExperimentConfig(model=dataclasses.replace(model_cfg, numerics="reference"),
                               data=data)
    ref_model = AMCModel(ref_cfg.model)
    ref_model.load_state_dict(model.state_dict())
    serve = build_serving_fn(exp, model, stats, device)
    server = Server(serve, frame_len, buckets, device)
    ref_serve = build_serving_fn(ref_cfg, ref_model, stats, device)
    if frames is None:
        gen = torch.Generator().manual_seed(1)
        requests = [torch.randn((n, frame_len, 2), generator=gen).to(device) for n in sizes]
    else:
        requests = [x.to(device) for x in torch.split(frames[:sum(sizes)], list(sizes))]
    want_per_request = ({"fused_encoder_layer": 0, "fused_encoder_layer_cls": 0,
                         K5[0]: n_layers, K5[1]: 0} if k5_route else
                        {"fused_encoder_layer": n_layers - int(cls),
                         "fused_encoder_layer_cls": int(cls), K5[0]: 0, K5[1]: 0})
    want_per_request = {k: v for k, v in want_per_request.items() if v}

    if k5_route:
        os.environ["VITIQ_NO_FUSED_LAYER"] = "1"
    try:
        reset_all_launches()
        tk.reset_launches()
        outs = []
        for x in requests:
            before = all_launches()
            outs.append(server.run(x))
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in all_launches().items() if v != before[k]}
            if got != want_per_request:
                raise AssertionError(f"{label}: request of {x.shape[0]} launched {got}, "
                                     f"expected {want_per_request}")
        counts = {**fel.launches, **fa.launches}
        kernel_counts = fel.kernel_launches()
        scan_counts = (tk.launches["timing_symbols"], tk.kernel_launches(),
                       tk.launches["timing_scan"])
    finally:
        os.environ.pop("VITIQ_NO_FUSED_LAYER", None)
    if kernel_counts["cls_pool_kernel"] != counts["fused_encoder_layer_cls"]:
        raise AssertionError(f"{label}: {kernel_counts['cls_pool_kernel']} pooling kernels "
                             f"launched by {counts['fused_encoder_layer_cls']} K2 calls")
    if scan_counts != (scans * len(requests),) * 2 + (0,):
        raise AssertionError(f"{label}: timing_recovery_kernel launched {scan_counts} (symbols "
                             f"mode, the C count, positions mode), expected {scans} a request "
                             "in symbols mode")

    got = torch.cat(outs)
    want = torch.cat([ref_serve(x) for x in requests])
    torch.cuda.synchronize()
    front = "fused raw embedding" if model.raw_stats is not None else "preprocess + embedding"
    print(f"  {label}: requests {list(sizes)} via buckets {list(buckets)} ({front}); launches "
          f"K1 {counts['fused_encoder_layer']}, K2 {counts['fused_encoder_layer_cls']}, "
          f"K5-fwd {counts[K5[0]]}, timing_recovery_kernel {scan_counts[1]}", flush=True)
    max_abs = gate_logits(label, got, want, sum(sizes), model_cfg.num_classes)
    del ref_model, ref_serve
    torch.cuda.empty_cache()
    return {"counts": counts, "kernel_counts": kernel_counts, "max_abs": max_abs, "model": model,
            "exp": exp, "stats": stats, "raw_embed": model.raw_stats is not None,
            "serve": serve, "scans": scan_counts[1]}


def time_serving(label: str, serve, batch: int, device, card: str, iters: int = 20,
                 frame_len: int = FRAME_LEN) -> None:
    x = torch.randn((batch, frame_len, 2), generator=torch.Generator().manual_seed(2)).to(device)
    for _ in range(3):
        serve(x)
    torch.cuda.synchronize()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        serve(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    ms = cuda_ms(lambda: serve(x), iters, warmup=0)
    p50 = statistics.median(lat) * 1e3
    print(f"  {label} serving B={batch}: p50 latency {p50:.4f} ms (host clock, synced), "
          f"{batch / (ms / 1e3):.1f} frames/s (CUDA events, {ms:.4f} ms/batch)  [{card}]",
          flush=True)
    return {"p50_ms": p50, "frames_per_s": batch / (ms / 1e3), "ms": ms}


# the small batches a live-decision user sends: serving p50 there is the
# host's launch path more than the card's work
SMALL_BATCHES = (1, 8, 32)


def p50_and_busy(call, iters: int) -> tuple:
    """A request's p50 (host clock, synced per request, `iters` requests
    after 5 warm-up ones) and the device's busy time a request (its kernels'
    time under `torch.profiler`, over 10 requests after PROFILE_PAD sleeps:
    the profiler drops a window's first records), ms."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(200_000)
        torch.cuda.synchronize()
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    busy = sum(device_us(e) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
               and e.time_range.start >= 0 and "spin_kernel" not in e.name)
    return statistics.median(lat) * 1e3, busy / 1e4


def time_small_batches(device, card: str, iters: int = 100) -> dict:
    """Serving p50 latency (host clock, synced per request, `iters` requests)
    at SMALL_BATCHES for the ViT flagship and rawiq_best through K1 + K2
    (random weights) beside the device's busy time a request (the kernels'
    time under `torch.profiler`, over 10 requests), eager (`build_serving_fn`)
    and through a serving artifact of the same weights with the buckets
    SMALL_BATCHES (one CUDA graph a bucket: `artifact_p50_ms_b*`, its busy
    time counting the input copy and the output clone around the replay;
    left out on a tree without `serve.ServingArtifact`); both models' eager
    serving rate at B=4096 (`time_serving`: `*_frames_per_s_b4096`); and the
    host time of one K1 call at B=1 on the ViT shape: the mean over `iters`
    calls issued without a sync, and the p50 of synced calls."""
    import tempfile

    from vitiq_torch import serve as serving

    artifacts = hasattr(serving, "ServingArtifact")
    out = {}
    for label, model_cfg, stats in (("vit", flagship_vit_config("tpu"), STATS),
                                    ("rawiq_best", rawiq_best_config("tpu"), RAW_STATS)):
        exp = ExperimentConfig(model=model_cfg,
                               data=DataConfig(synthetic_frame_len=model_cfg.seq_length))
        model = AMCModel(model_cfg, generator=torch.Generator().manual_seed(0))
        art = None
        if artifacts:
            with tempfile.TemporaryDirectory() as tmp:
                exp_dir = write_experiment(Path(tmp) / "experiment", exp, model, stats)
                art = serving.ServingArtifact.load(serving.export_from_experiment(
                    exp_dir, Path(tmp) / "artifact", batch_sizes=SMALL_BATCHES,
                    platforms=["cuda"]), device=device)
        serve = build_serving_fn(exp, model, stats, device)
        for batch in SMALL_BATCHES:
            x = torch.randn((batch, model_cfg.seq_length, 2),
                            generator=torch.Generator().manual_seed(batch)).to(device)
            out[f"{label}_p50_ms_b{batch}"], out[f"{label}_device_ms_b{batch}"] = p50_and_busy(
                lambda: serve(x), iters)
            if art is not None:
                (out[f"{label}_artifact_p50_ms_b{batch}"],
                 out[f"{label}_artifact_device_ms_b{batch}"]) = p50_and_busy(lambda: art.run(x),
                                                                             iters)
        out[f"{label}_frames_per_s_b4096"] = time_serving(
            f"{label} (kernels)", serve, 4096, device, card,
            frame_len=model_cfg.seq_length)["frames_per_s"]
        del model, serve, art
    ops = fel.layer_operands(random_layers(1, 512, seed=5, device=device)[0], 8)
    x = torch.randn((1, 129, 128), generator=torch.Generator().manual_seed(6))
    x = x.to(device, torch.bfloat16)
    with torch.no_grad():
        for _ in range(5):
            fel.fused_encoder_layer(x, ops, 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fel.fused_encoder_layer(x, ops, 8)
        host = (time.perf_counter() - t0) / iters
        torch.cuda.synchronize()
        lat = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fel.fused_encoder_layer(x, ops, 8)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    out["k1_host_us_b1"] = host * 1e6
    out["k1_p50_us_b1"] = statistics.median(lat) * 1e6
    # K2 at B=1 on the same shape: its 15 operands where the tree takes them
    cls_ops = fel.cls_operands(ops, 8) if hasattr(fel, "cls_operands") else ops
    k2 = time_host("K2 at B=1, L=129", lambda: fel.fused_encoder_layer_cls(x, cls_ops, 8), card,
                   iters)
    out["k2_host_us_b1"], out["k2_p50_us_b1"] = k2["host_us"], k2["p50_us"]
    print("  small batches: " + ", ".join(f"{k} {v:.4f}" for k, v in out.items())
          + f" (serving p50: host clock, synced, {iters} requests, eager and through the "
          f"artifact's graphs; K1 and K2 at B=1, L=129: "
          f"host time a call unsynced, p50 synced)  [{card}]", flush=True)
    return out


def train_operands(ffn: int, seed: int, device, D: int = 128, H: int = 8):
    layer = random_layers(1, ffn, seed, device, D, H)[0]
    return [t.detach().contiguous() for t in flt.flat_weights(layer, torch.bfloat16)]


def check_grads(label: str, grads, want) -> float:
    """Each gradient within GRAD_REL of the plain one in the L2 norm; returns
    the largest max |difference|."""
    return max(check_rel(f"{label} {name}", got, ref)
               for name, got, ref in zip(GRAD_NAMES, grads, want))


def train_inputs(gen, B: int, L: int, D: int, device):
    x = torch.randn((B, L, D), generator=gen).to(device, torch.bfloat16)
    dy = (0.05 * torch.randn((B, L, D), generator=gen)).to(device, torch.bfloat16)
    return x, dy


# K3 and K4 at the widths past d_model 128 / d_head 32 the training kernels
# take since they were widened: (name, L, FFN, dropout, D, H). d_head 64:
# vit_tpu_production's 129 tokens (K3) and the rawIQ flagship at n_head 2
# (65 tokens, Lp 80: K4); d_model 64: vit_tiny_2016's 17 tokens (K4, and K3
# where VITIQ_TRAIN_STASH=0 sends it); an FFN width that 64 divides and 128
# does not (64-wide GEMM tiles), both kernels.
WIDE_TRAIN_K3 = (("vit_tpu_production (d_head 64)", 129, 512, TRAIN_DROP, 128, 2),
                 ("vit_tiny_2016 (d_model 64)", 17, 256, TRAIN_DROP, 64, 4),
                 ("FFN 320", 65, 320, RAW_DROP, 128, 8))
WIDE_TRAIN_K4 = (("rawIQ flagship at n_head 2 (d_head 64)", 65, 1024, RAW_DROP, 128, 2),
                 ("vit_tiny_2016 (d_model 64)", 17, 256, TRAIN_DROP, 64, 4),
                 ("FFN 320", 65, 320, RAW_DROP, 128, 8))


def check_train_kernels(device, B: int = 256) -> dict:
    """K3-fwd and K3-bwd against their plain versions at both flagship
    shapes (dropout on) and at rawiq_best's (D=256, dropout on and off),
    then K4-fwd and K4-bwd at the rawIQ flagship's and at rawiq_best_mp's
    (D=256, L=64), dropout on; then both at WIDE_TRAIN_K3 / WIDE_TRAIN_K4,
    dropout on, where the forward output and dx are also held within
    GRAD_REL in the L2 norm. Returns the largest difference of each
    kernel."""
    errs = {"k3f": 0.0, "k3b": 0.0, "k4f": 0.0, "k4b": 0.0}
    gen = torch.Generator().manual_seed(8)
    for name, L, ffn, drop, D, H in (("vit", 129, 512, TRAIN_DROP, 128, 8),
                                     ("rawiq", 65, 1024, RAW_DROP, 128, 8),
                                     ("rawiq_best", 65, 1024, BEST_DROP, 256, 8),
                                     ("rawiq_best", 65, 1024, 0.0, 256, 8), *WIDE_TRAIN_K3):
        wide = (D, H) != (128, 8) or ffn % 128
        print(f"phase train-kernels: K3 vs plain version on the GPU, {name} shape B={B} L={L} "
              f"F={ffn} D={D} H={H}, dropout {drop}", flush=True)
        ops = train_operands(ffn, 21, device, D, H)
        x, dy = train_inputs(gen, B, L, D, device)
        args = (H, drop, TRAIN_SEED, 3)
        with torch.no_grad():
            y = flt.fused_train_layer_fwd(x, ops, *args)
            want = flt.fused_train_layer_reference(x, ops, *args)
            torch.cuda.synchronize()
            errs["k3f"] = max(errs["k3f"], check_close(f"{name} K3-fwd", y, want, LAYER_TOL))
            if wide:
                check_rel(f"{name} K3-fwd", y, want)
            dx, grads = flt.fused_train_layer_bwd(x, dy, ops, *args)
            want_dx, want_grads = flt.fused_train_layer_backward_reference(x, dy, ops, *args)
            torch.cuda.synchronize()
        errs["k3b"] = max(errs["k3b"], check_close(f"{name} K3-bwd dx", dx, want_dx, LAYER_TOL),
                          check_grads(f"{name} K3-bwd", grads, want_grads))
        if wide:
            check_rel(f"{name} K3-bwd dx", dx, want_dx)

    for name, L, ffn, drop, D, H in (("rawiq", 65, 1024, RAW_DROP, 128, 8),
                                     ("rawiq_best_mp", 64, 1024, BEST_DROP, 256, 8),
                                     *WIDE_TRAIN_K4):
        wide = (D, H) != (128, 8) or ffn % 128
        print(f"phase train-kernels: K4 vs plain version on the GPU, {name} shape B={B} L={L} "
              f"F={ffn} D={D} H={H}, dropout {drop}", flush=True)
        ops = train_operands(ffn, 21, device, D, H)
        x, dy = train_inputs(gen, B, L, D, device)
        args = (H, drop, TRAIN_SEED, 3)
        label = "K4" if name == "rawiq" else f"{name} K4"
        with torch.no_grad():
            y, stash = flt.fused_train_layer_fwd_stash(x, ops, *args)
            want, want_stash = flt.fused_train_layer_stash_reference(x, ops, *args)
            torch.cuda.synchronize()
            k4f = check_close(f"{label}-fwd y", y, want, LAYER_TOL)
            if wide:
                check_rel(f"{label}-fwd y", y, want)
            for part, got, ref in zip(("attn", "xh1", "xh2", "r1", "r2", "pbar"), stash,
                                      want_stash):
                if got.dtype != ref.dtype:
                    raise AssertionError(f"K4-fwd {part}: dtype {got.dtype} != {ref.dtype}")
                tol = (0.0, 1e-3) if part in ("r1", "r2") else LAYER_TOL
                k4f = max(k4f, check_close(f"{label}-fwd stash {part}", got, ref, tol))
                if part in ("attn", "pbar"):
                    check_rel(f"{label}-fwd stash {part}", got, ref)
            dx, grads = flt.fused_train_layer_bwd_stash(x, dy, want_stash, ops, *args)
            want_dx, want_grads = flt.fused_train_layer_stash_backward_reference(
                x, dy, want_stash, ops, *args)
            torch.cuda.synchronize()
        errs["k4f"] = max(errs["k4f"], k4f)
        errs["k4b"] = max(errs["k4b"], check_close(f"{label}-bwd dx", dx, want_dx, LAYER_TOL),
                          check_grads(f"{label}-bwd", grads, want_grads))
        if wide:
            check_rel(f"{label}-bwd dx", dx, want_dx)
        del stash, want_stash
    return errs


def check_stage_rel(label: str, got: torch.Tensor, want: torch.Tensor, rel: float = 1e-5) -> float:
    """f32 sums (column sums, split-K partials) within `rel` of the plain
    version's in the L2 norm; returns the max |difference|."""
    err, norm = (got - want).norm().item(), want.norm().item()
    print(f"  {label}: ||kernel - plain|| / ||plain|| = {err / max(norm, 1e-30):.6g} (limit {rel})",
          flush=True)
    if not (torch.isfinite(got).all() and err <= rel * norm):
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return (got - want).abs().max().item()


def check_train_stages(device, batch: int = 256) -> float:
    """K3/K4's GEMM stages one by one at the main path's shapes (the ViT
    flagship's and rawiq_best's layers, `batch` frames; every instance those
    layers launch): each stage of `flt.stage_plan` on random operands
    against `flt.train_gemm_plain`, its bf16 and f32 rows within one bf16 ulp
    (`check_ulp`), its column sums and split-K partials within 1e-5 in the
    L2 norm. Returns the largest difference."""
    worst = 0.0
    gen = torch.Generator().manual_seed(23)
    for name, L, D, F in (("vit", 129, 128, 512), ("rawiq_best", 65, 256, 1024)):
        M = batch * L
        print(f"phase train-kernels: K3/K4's GEMM stages alone vs their plain versions, {name} "
              f"shape M={M} D={D} F={F}", flush=True)
        for stage, epi, K, N in flt.stage_plan(D, F):
            if epi == "partial":  # act [M, K] and the gradient [M, N], split as a layer splits
                a, b, kw = flt.random_stage_operands(epi, K, M, N, L, gen, device, TRAIN_SEED)
                kw["splits"] = flt.weight_grad_splits(M)
            else:
                a, b, kw = flt.random_stage_operands(epi, M, K, N, L, gen, device, TRAIN_SEED)
            with torch.no_grad():
                got = flt.train_gemm(a, b, epi, **kw)
                want = flt.train_gemm_plain(a, b, epi, **kw)
                torch.cuda.synchronize()
            label = f"{name} {stage} ({epi}, K={K}, N={N})"
            if epi == "partial":
                worst = max(worst, check_stage_rel(label, got, want))
            elif epi in ("dpre", "ln_bwd", "ln_fwd"):
                for i in range({"dpre": 1, "ln_bwd": 2, "ln_fwd": 3}[epi]):
                    worst = max(worst, check_ulp(f"{label} out {i}", got[i], want[i]))
                if epi != "ln_fwd":
                    for i, (g, w) in enumerate(zip(got[-1].reshape(-1, N), want[-1].reshape(-1, N))):
                        worst = max(worst, check_stage_rel(f"{label} column sums {i}", g, w))
            else:
                worst = max(worst, check_ulp(label, got, want))
            del a, b, kw, got, want
        torch.cuda.empty_cache()
    return worst


def check_hash_dropout(device, launches: int = 30) -> float:
    """The plain dropout sites' kernel alone (`flt.hash_dropout_apply`, rate
    TRAIN_DROP, a device-tensor seed) at DROP_SHAPES against its plain
    version (`flt.hash_dropout_plain`) run on the card on the same inputs:
    bit for bit (tolerance 0), on activations and on a gradient, with about
    the rate's share dropped; then `launches` launches the same bits.
    Returns the largest absolute difference (0.0)."""
    print(f"phase hash-dropout: the plain sites' dropout kernel vs its plain version on the "
          f"GPU, bit for bit, {launches} launches the same bits", flush=True)
    gen = torch.Generator().manual_seed(8)
    seed = torch.tensor([TRAIN_SEED], dtype=torch.int32, device=device)
    worst = 0.0
    for i, (shape, dtype) in enumerate(DROP_SHAPES):
        salt = flt.site_salt(i, 1)
        x = torch.randn(shape, generator=gen).to(device, dtype)
        got = flt.hash_dropout_apply(x, TRAIN_DROP, seed, salt)
        want = flt.hash_dropout_plain(x, TRAIN_DROP, seed, salt)
        err = (got.float() - want.float()).abs().max().item()
        dropped = (want == 0).float().mean().item()
        worst = max(worst, err)
        same = all(torch.equal(flt.hash_dropout_apply(x, TRAIN_DROP, seed, salt), got)
                   for _ in range(launches - 1))
        print(f"  {tuple(shape)} {str(dtype)[6:]}: max |kernel - plain| {err:.3g}, dropped "
              f"{dropped:.4f}, bits equal {torch.equal(got, want)}, {launches} launches the same "
              f"bits {same}", flush=True)
        if not torch.equal(got, want) or not same or abs(dropped - TRAIN_DROP) > 0.02:
            raise AssertionError(f"hash_dropout {tuple(shape)} {dtype}: the kernel differs from "
                                 f"its plain version ({err}) or between launches, or dropped "
                                 f"{dropped}")
    # a column shard of the TP 2 FFN hidden site: lanes numbered from its
    # first column, the whole activation's mask over them
    x = torch.randn((256, 129, 512), generator=gen).to(device, torch.bfloat16)
    salt = flt.site_salt(3, 1)
    whole = flt.hash_dropout_apply(x, TRAIN_DROP, seed, salt)
    for j in range(2):
        part = x[..., 256 * j:256 * (j + 1)].contiguous()
        got = flt.hash_dropout_apply(part, TRAIN_DROP, seed, salt, lane0=256 * j)
        if not torch.equal(got, whole[..., 256 * j:256 * (j + 1)]) or not torch.equal(
                got, flt.hash_dropout_plain(part, TRAIN_DROP, seed, salt, lane0=256 * j)):
            raise AssertionError(f"hash_dropout with lane0 {256 * j}: not the whole "
                                 f"activation's mask over its lanes")
    print("  (256, 129, 256) bf16 column shards at lane0 0 and 256: the whole (256, 129, 512) "
          "activation's bits", flush=True)
    return worst


def time_hash_dropout(device, card: str) -> dict:
    """The plain sites' dropout kernel at DROP_TIME_SHAPE in bf16 (CUDA
    events after warm-up) against its plain version on the card, with its
    bound: x read once and the output written once over the HBM rate, or
    DROP_OPS 32-bit operations a position over the f32 rate outside the
    tensor cores."""
    x = torch.randn(DROP_TIME_SHAPE, generator=torch.Generator().manual_seed(4)).to(
        device, torch.bfloat16)
    seed = torch.tensor([TRAIN_SEED], dtype=torch.int32, device=device)
    salt = flt.site_salt(0, 1)
    ms = cuda_ms(lambda: flt.hash_dropout_apply(x, TRAIN_DROP, seed, salt), 20)
    plain_ms = cuda_ms(lambda: flt.hash_dropout_plain(x, TRAIN_DROP, seed, salt), 5)
    nbytes = 2 * x.numel() * x.element_size() + 4
    byte_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, DROP_OPS * x.numel() / PEAK_F32_FLOPS * 1e3
    bnd = (byte_ms, "bytes") if byte_ms >= ops_ms else (ops_ms, "operations")
    print(f"  hash_dropout_kernel {DROP_TIME_SHAPE} bf16: {ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]} ({nbytes} bytes, "
          f"{DROP_OPS * x.numel()} operations), {ms / bnd[0]:.2f}x the bound  [{card}]",
          flush=True)
    del x
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound": bnd}


def check_train_bits(device, launches: int = 30) -> None:
    """K3-fwd, K3-bwd (rawiq_best) and K4-bwd (the rawIQ flagship) over ~100K
    rows, so that each warpgroup of a persistent GEMM stage refills its ring
    many times: `launches` launches give the first launch's bits (a ring
    slot refilled before every warp had released it would move some)."""
    gen = torch.Generator().manual_seed(29)
    B = 1600
    for label, ffn, D, drop in (("rawiq_best K3", 1024, 256, BEST_DROP),
                                ("rawIQ flagship K4", 1024, 128, RAW_DROP)):
        ops = train_operands(ffn, 19, device, D, 8)
        x, dy = train_inputs(gen, B, 65, D, device)
        args = (8, drop, TRAIN_SEED, 1)
        with torch.no_grad():
            if label.endswith("K3"):
                runs = {"K3-fwd": lambda: (flt.fused_train_layer_fwd(x, ops, *args),),
                        "K3-bwd": lambda: flt.fused_train_layer_bwd(x, dy, ops, *args)}
            else:
                _, st = flt.fused_train_layer_fwd_stash(x, ops, *args)
                runs = {"K4-bwd": lambda: flt.fused_train_layer_bwd_stash(x, dy, st, ops, *args)}
            for kernel, run in runs.items():
                first = run()
                flat = [first[0], *first[1]] if len(first) == 2 else list(first)
                for _ in range(launches):
                    again = run()
                    again = [again[0], *again[1]] if len(again) == 2 else list(again)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(flat, again)):
                        raise AssertionError(f"{label} {kernel}: launches differ")
                print(f"  {label} {kernel} B={B} L=65 D={D}: {launches} launches give the same "
                      f"bits", flush=True)
        del x, dy, ops, runs
        torch.cuda.empty_cache()


# K4's attention passes alone at the shapes K4 trains: (name, L, D, H) at
# B=256 in the checks, B=4096 in the timings
K4_PASS_SHAPES = (("rawiq", 65, 128, 8), ("rawiq_best_mp", 64, 256, 8),
                  ("rawIQ flagship at n_head 2", 65, 128, 2), ("vit_tiny_2016", 17, 64, 4))


def stash_pass_inputs(gen, B: int, L: int, D: int, H: int, device):
    """qkv [B, L, 3D] and dattn [B, L, D] (bf16, seeded), and the plain
    forward pass's attn and pbar on that qkv."""
    qkv = torch.randn((B, L, 3 * D), generator=gen).to(device, torch.bfloat16)
    dattn = (0.1 * torch.randn((B, L, D), generator=gen)).to(device, torch.bfloat16)
    with torch.no_grad():
        attn, pbar = flt.stash_attention_fwd_plain(qkv, H)
    return qkv, dattn, attn, pbar


def check_stash_passes(device, B: int = 256, shapes=K4_PASS_SHAPES, launches: int = 30) -> dict:
    """K4's two attention passes alone against their plain versions on the
    same inputs (`flt.stash_attention_fwd` / `_bwd` against
    `stash_attention_fwd_plain` / `_bwd_plain`): attn and dqkv within
    LAYER_TOL, pbar within PBAR_ULPS bf16 ulps (its padding exactly 0), attn,
    pbar, dqkv and each frame's column sums within GRAD_REL in the L2 norm;
    the backward on the plain attn and pbar, so that it alone is under test.
    Then the backward on the forward kernel's attn and pbar, its dqkv and
    column sums within GRAD_REL of the plain chain's. Then `launches`
    launches of each pass give the first launch's bits. Returns the largest
    difference of each pass."""
    errs = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator().manual_seed(31)
    for name, L, D, H in shapes:
        print(f"phase train-kernels: K4's attention passes alone vs their plain versions, {name} "
              f"shape B={B} L={L} D={D} H={H} (d_head {D // H}; tiles "
              f"{flt.stash_tile_plan(L)})", flush=True)
        qkv, dattn, attn_p, pbar_p = stash_pass_inputs(gen, B, L, D, H, device)
        with torch.no_grad():
            attn, pbar = flt.stash_attention_fwd(qkv, H)
            dqkv, part = flt.stash_attention_bwd(qkv, attn_p, dattn, pbar_p, H)
            want_dqkv, want_part = flt.stash_attention_bwd_plain(qkv, attn_p, dattn, pbar_p, H)
            torch.cuda.synchronize()
        if pbar.shape != pbar_p.shape or torch.count_nonzero(pbar[..., L:]).item():
            raise AssertionError(f"{name}: pbar's shape {tuple(pbar.shape)} or its padding is off")
        errs["fwd"] = max(errs["fwd"], check_close(f"{name} K4 attention fwd attn", attn, attn_p,
                                                   LAYER_TOL),
                          check_rel(f"{name} K4 attention fwd attn", attn, attn_p),
                          check_pbar(f"{name} K4 attention fwd pbar", pbar, pbar_p),
                          check_rel(f"{name} K4 attention fwd pbar", pbar, pbar_p))
        errs["bwd"] = max(errs["bwd"], check_close(f"{name} K4 attention bwd dqkv", dqkv,
                                                   want_dqkv, LAYER_TOL),
                          check_rel(f"{name} K4 attention bwd dqkv", dqkv, want_dqkv),
                          check_rel(f"{name} K4 attention bwd column sums", part, want_part))
        with torch.no_grad():
            dqkv_k, part_k = flt.stash_attention_bwd(qkv, attn, dattn, pbar, H)
            torch.cuda.synchronize()
        check_rel(f"{name} K4 attention fwd -> bwd dqkv (the kernels' chain)", dqkv_k, want_dqkv)
        check_rel(f"{name} K4 attention fwd -> bwd column sums (the kernels' chain)", part_k,
                  want_part)
        del dqkv_k, part_k
        with torch.no_grad():
            for label, run, first in (("fwd", lambda: flt.stash_attention_fwd(qkv, H),
                                       (attn, pbar)),
                                      ("bwd", lambda: flt.stash_attention_bwd(qkv, attn_p, dattn,
                                                                              pbar_p, H),
                                       (dqkv, part))):
                for _ in range(launches):
                    again = run()
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(first, again)):
                        raise AssertionError(f"{name} K4 attention {label}: launches differ")
            print(f"  {name} K4 attention fwd and bwd: {launches} launches each give the same "
                  f"bits", flush=True)
        del qkv, dattn, attn_p, pbar_p, attn, pbar, dqkv, part, want_dqkv, want_part
        torch.cuda.empty_cache()
    return errs


def time_stash_passes(device, card: str, B: int = 4096, shapes=K4_PASS_SHAPES) -> dict:
    """K4's attention passes alone at B=4096 (CUDA events, 20 launches)
    against their plain versions and their bounds (`attention_pass_bounds`:
    the byte floor of the function's inputs and outputs, pbar L x L, beside
    its FLOPs), and the stash's bytes a frame and layer."""
    out = {}
    gen = torch.Generator().manual_seed(32)
    for name, L, D, H in shapes:
        qkv, dattn, attn, pbar = stash_pass_inputs(gen, B, L, D, H, device)
        with torch.no_grad():
            t = {"fwd_ms": cuda_ms(lambda: flt.stash_attention_fwd(qkv, H), 20),
                 "fwd_plain_ms": cuda_ms(lambda: flt.stash_attention_fwd_plain(qkv, H), 3,
                                         warmup=1),
                 "bwd_ms": cuda_ms(lambda: flt.stash_attention_bwd(qkv, attn, dattn, pbar, H), 20),
                 "bwd_plain_ms": cuda_ms(
                     lambda: flt.stash_attention_bwd_plain(qkv, attn, dattn, pbar, H), 3,
                     warmup=1)}
        t.update(attention_pass_bounds(B, L, D, H))
        rest = 3 * L * D * 2 + 2 * L * 4  # attn, xh1, xh2 (bf16), r1, r2 (f32)
        print(f"  {name} K4 attention passes B={B} L={L} D={D} H={H}: fwd {t['fwd_ms']:.4f} ms vs "
              f"plain {t['fwd_plain_ms']:.4f} ms (bound {t['fwd'][0]:.4f} ms by {t['fwd'][1]}, "
              f"{t['fwd'][0] / t['fwd_ms']:.3f} of it); bwd {t['bwd_ms']:.4f} ms vs plain "
              f"{t['bwd_plain_ms']:.4f} ms (bound {t['bwd'][0]:.4f} ms by {t['bwd'][1]}, "
              f"{t['bwd'][0] / t['bwd_ms']:.3f} of it); the stash "
              f"{rest + H * L * flt.stash_cols(L) * 2} bytes a frame and layer (pbar's rows padded "
              f"to {flt.stash_cols(L)}; {rest + H * L * L * 2} unpadded)  [{card}]", flush=True)
        out[name] = t
        del qkv, dattn, attn, pbar
        torch.cuda.empty_cache()
    return out


# K3's attention passes alone: (name, L, D, H) at B=256 in the checks (every
# shape K3 trains, L 17 at vit_tiny_2016's width and one L past 144, which
# the routing sends to the mma.sync passes), B=4096 in the timings (the
# shapes K3 trains)
K3_PASS_SHAPES = (("vit", 129, 128, 8), ("rawiq_best", 65, 256, 8),
                  ("vit_tpu_production", 129, 128, 2),
                  ("rawIQ flagship (VITIQ_TRAIN_STASH=0)", 65, 128, 8),
                  ("vit_tiny_2016 (VITIQ_TRAIN_STASH=0)", 17, 64, 4),
                  ("L 160 (routed to mma.sync)", 160, 128, 8))
K3_PASS_TIMED = K3_PASS_SHAPES[:5]
# K3's forward pass alone against its plain version: m sums the same bf16
# products as the plain version's scores in another order (f32), so within
# 1e-5 of max(|m|, 1) (the rounding of a sum of d_head products of order 1
# scales with the products, not with a max near 0); l within 1e-3 relative,
# since one p whose bf16 rounding flips moves l by one ulp of that p.
STATS_TOL = (1e-5, 1e-3)


def check_stats(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The forward pass's stats [B, H, L, 2] against the plain ones: m within
    STATS_TOL[0] of max(|m|, 1), l within STATS_TOL[1] relative; returns the
    largest |difference|."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad stats {tuple(got.shape)}")
    dm = ((got[..., 0] - want[..., 0]).abs() / want[..., 0].abs().clamp_min(1.0)).max().item()
    dl = ((got[..., 1] - want[..., 1]).abs() / want[..., 1]).max().item()
    print(f"  {label}: m within {dm:.3g} of max(|m|, 1) (limit {STATS_TOL[0]}), l within "
          f"{dl:.3g} relative (limit {STATS_TOL[1]})", flush=True)
    if not (dm <= STATS_TOL[0] and dl <= STATS_TOL[1]):
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return (got - want).abs().max().item()


def recompute_pass_inputs(gen, B: int, L: int, D: int, H: int, device):
    """qkv [B, L, 3D] and dattn [B, L, D] (bf16, seeded), and the plain
    forward pass's attn and stats on that qkv."""
    qkv = torch.randn((B, L, 3 * D), generator=gen).to(device, torch.bfloat16)
    dattn = (0.1 * torch.randn((B, L, D), generator=gen)).to(device, torch.bfloat16)
    with torch.no_grad():
        attn, stats = flt.recompute_attention_fwd_plain(qkv, H)
    return qkv, dattn, attn, stats


def check_recompute_passes(device, B: int = 256, shapes=K3_PASS_SHAPES,
                           launches: int = 30) -> dict:
    """K3's two attention passes alone against their plain versions on the
    same inputs (`flt.recompute_attention_fwd` / `_bwd`, routed by shape as
    K3 routes them, against `recompute_attention_fwd_plain` / `_bwd_plain`):
    attn and dqkv within LAYER_TOL and GRAD_REL in the L2 norm, the stats
    within STATS_TOL, each frame's column sums within GRAD_REL; the backward
    on the plain attn and stats, so that it alone is under test. Then the
    backward on the forward kernel's attn and stats, its dqkv and column
    sums within GRAD_REL of the plain chain's. Then `launches` launches of
    each pass give the first launch's bits. Prints each shape's route and
    the wgmma passes' blocks an SM. Returns the largest difference of each
    pass."""
    errs = {"fwd": 0.0, "bwd": 0.0}
    gen = torch.Generator().manual_seed(33)
    for name, L, D, H in shapes:
        plan = flt.recompute_tile_plan(L, D // H)
        blocks = flt.recompute_blocks_per_sm(L, D, H)
        route = {k: "wgmma" if plan[f"{k}_wgmma"] else "mma.sync" for k in ("fwd", "bwd")}
        print(f"phase train-kernels: K3's attention passes alone vs their plain versions, {name} "
              f"shape B={B} L={L} D={D} H={H} (d_head {D // H}; forward {route['fwd']}, backward "
              f"{route['bwd']}; {plan['groups']} 16-key groups; blocks an SM of the wgmma "
              f"passes: forward {blocks[0]}, backward {blocks[1]})", flush=True)
        qkv, dattn, attn_p, stats_p = recompute_pass_inputs(gen, B, L, D, H, device)
        with torch.no_grad():
            attn, stats = flt.recompute_attention_fwd(qkv, H)
            dqkv, part = flt.recompute_attention_bwd(qkv, attn_p, dattn, stats_p, H)
            want_dqkv, want_part = flt.recompute_attention_bwd_plain(qkv, attn_p, dattn, stats_p,
                                                                     H)
            torch.cuda.synchronize()
        errs["fwd"] = max(errs["fwd"], check_close(f"{name} K3 attention fwd attn", attn, attn_p,
                                                   LAYER_TOL),
                          check_rel(f"{name} K3 attention fwd attn", attn, attn_p),
                          check_stats(f"{name} K3 attention fwd stats", stats, stats_p))
        errs["bwd"] = max(errs["bwd"], check_close(f"{name} K3 attention bwd dqkv", dqkv,
                                                   want_dqkv, LAYER_TOL),
                          check_rel(f"{name} K3 attention bwd dqkv", dqkv, want_dqkv),
                          check_rel(f"{name} K3 attention bwd column sums", part, want_part))
        with torch.no_grad():
            dqkv_k, part_k = flt.recompute_attention_bwd(qkv, attn, dattn, stats, H)
            torch.cuda.synchronize()
        check_rel(f"{name} K3 attention fwd -> bwd dqkv (the kernels' chain)", dqkv_k, want_dqkv)
        check_rel(f"{name} K3 attention fwd -> bwd column sums (the kernels' chain)", part_k,
                  want_part)
        del dqkv_k, part_k
        with torch.no_grad():
            for label, run, first in (("fwd", lambda: flt.recompute_attention_fwd(qkv, H),
                                       (attn, stats)),
                                      ("bwd", lambda: flt.recompute_attention_bwd(
                                          qkv, attn_p, dattn, stats_p, H), (dqkv, part))):
                for _ in range(launches):
                    again = run()
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(first, again)):
                        raise AssertionError(f"{name} K3 attention {label}: launches differ")
            print(f"  {name} K3 attention fwd and bwd: {launches} launches each give the same "
                  f"bits", flush=True)
        del qkv, dattn, attn_p, stats_p, attn, stats, dqkv, part, want_dqkv, want_part
        torch.cuda.empty_cache()
    return errs


def recompute_pass_bounds(B: int, L: int, D: int = 128, H: int = 8) -> dict:
    """K3's attention passes alone (`attention_bounds`' byte model): the
    forward reads qkv and writes attn and the f32 (m, l) of each row, 4 L^2
    dh FLOPs a frame-head (Q K^T, P V); the backward reads qkv, attn, dattn
    and the stats and writes dqkv and a frame's column sums (3D f32), 10 L^2
    dh (S formed again, dP, dV, dQ, dK)."""
    dh, act, stats = D // H, B * L * D * 2.0, B * H * L * 8.0
    return {"fwd": bound(4.0 * B * H * L * L * dh, 3 * act + act + stats),
            "bwd": bound(10.0 * B * H * L * L * dh,
                         3 * act + 2 * act + stats + 3 * act + B * 3 * D * 4.0)}


def time_recompute_passes(device, card: str, B: int = 4096, shapes=K3_PASS_TIMED) -> dict:
    """K3's attention passes alone at B=4096 (CUDA events, 20 launches)
    against their plain versions, their bounds (`recompute_pass_bounds`) and
    the yardstick torch.nn.functional.scaled_dot_product_attention on [B, H,
    L, dh] bf16 (forward, and backward alone on a kept graph; the same
    function without K3's roundings), which the port never calls."""
    out = {}
    gen = torch.Generator().manual_seed(34)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, L, D, H in shapes:
        qkv, dattn, attn, stats = recompute_pass_inputs(gen, B, L, D, H, device)
        with torch.no_grad():
            t = {"fwd_ms": cuda_ms(lambda: flt.recompute_attention_fwd(qkv, H), 20),
                 "fwd_plain_ms": cuda_ms(lambda: flt.recompute_attention_fwd_plain(qkv, H), 3,
                                         warmup=1),
                 "bwd_ms": cuda_ms(lambda: flt.recompute_attention_bwd(qkv, attn, dattn, stats,
                                                                       H), 20),
                 "bwd_plain_ms": cuda_ms(lambda: flt.recompute_attention_bwd_plain(
                     qkv, attn, dattn, stats, H), 3, warmup=1)}
        heads = [x.reshape(B, L, H, D // H).transpose(1, 2).contiguous().requires_grad_(True)
                 for x in qkv.split(D, dim=-1)]
        dheads = dattn.reshape(B, L, H, D // H).transpose(1, 2).contiguous()
        with torch.no_grad():
            t["sdpa_fwd_ms"] = cuda_ms(lambda: sdpa(*heads), 20)
        o = sdpa(*heads)
        t["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(o, heads, dheads,
                                                               retain_graph=True), 20)
        t.update(recompute_pass_bounds(B, L, D, H))
        plan = flt.recompute_tile_plan(L, D // H)
        print(f"  {name} K3 attention passes B={B} L={L} D={D} H={H}: fwd "
              f"({'wgmma' if plan['fwd_wgmma'] else 'mma.sync'}) {t['fwd_ms']:.4f} ms vs plain "
              f"{t['fwd_plain_ms']:.4f} ms vs SDPA {t['sdpa_fwd_ms']:.4f} ms (bound "
              f"{t['fwd'][0]:.4f} ms by {t['fwd'][1]}, {t['fwd_ms'] / t['fwd'][0]:.2f}x it); bwd "
              f"({'wgmma' if plan['bwd_wgmma'] else 'mma.sync'}) {t['bwd_ms']:.4f} ms vs plain "
              f"{t['bwd_plain_ms']:.4f} ms vs SDPA backward {t['sdpa_bwd_ms']:.4f} ms (bound "
              f"{t['bwd'][0]:.4f} ms by {t['bwd'][1]}, {t['bwd_ms'] / t['bwd'][0]:.2f}x it)  "
              f"[{card}]", flush=True)
        out[name] = t
        del qkv, dattn, attn, stats, heads, dheads, o
        torch.cuda.empty_cache()
    return out


def flat_grad(model, inputs, labels, seed) -> torch.Tensor:
    """The gradient of one training step's loss, flat in f32."""
    model.train()
    loss = label_smoothed_cross_entropy(model(inputs, seed=seed), labels, 0.1)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return torch.cat([g.reshape(-1).float() for g in grads])


def train_experiment(cfg, batch: int) -> ExperimentConfig:
    return ExperimentConfig(model=cfg, data=DataConfig(synthetic_frame_len=cfg.seq_length),
                            train=TrainConfig(batch_size=batch, learning_rate=1e-3))


def train_steps(label: str, exp, model, pre, frames, labels, want: dict, steps: int) -> dict:
    """`steps` make_train_step steps on one batch. The training kernels'
    launch counters (K3, K4, K5, the plain dropout sites' kernel) are reset
    just before each step and read
    just after: every step must launch exactly `want`. The loss must stay
    finite and end below where it started. Returns the launches summed."""
    step = make_train_step(make_optimizer(exp.train), exp.train.label_smoothing, pre)
    state = create_train_state(model, exp.train)
    counts = {k: 0 for k in want}
    losses = []
    for i in range(steps):
        flt.reset_launches()
        fa.reset_launches()
        state, metrics = step(state, frames, labels, exp.train.dropout_seed)
        losses.append(float(metrics["loss"]))
        got = {**flt.launches, **fa.launches, **flt.dropout_launches}
        if got != want:
            raise AssertionError(f"{label} train step {i} launched {got}, expected {want}")
        counts = {k: counts[k] + got[k] for k in counts}
    print(f"  launches over {steps} steps: {counts}; loss step 1 {losses[0]:.6g}, step "
          f"{steps // 2} {losses[steps // 2 - 1]:.6g}, step {steps} {losses[-1]:.6g}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: training loss did not fall: {losses[0]} -> {losses[-1]}")
    return counts


def train_check(label: str, cfg, stats, kernels, device, cos_plain: float = COSINE_PLAIN,
                batch: int = 256, grad_batch: int = 0) -> dict:
    """20 train steps of a model at `batch` through the training kernels
    `kernels` (K3 or K4, the other never launching), then the gradient of
    one dropout-free step at `grad_batch` (default `batch`) against the
    plain bf16 (cosine >= `cos_plain`) and the f32 paths. The model and its
    preprocess come from `build_forward_and_preprocess`, so the rawIQ arms
    take raw frames through the fused raw embedding."""
    print(f"phase train: {label}, 20 make_train_step steps, B={batch}, lr 1e-3", flush=True)
    exp = train_experiment(cfg, batch)
    model, pre = build_forward_and_preprocess(
        exp, AMCModel(cfg, generator=torch.Generator().manual_seed(0)), stats, device)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(5)
    frames = torch.randn((batch, cfg.seq_length, 2), generator=gen).to(device)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen).to(device)
    n = cfg.n_layers
    others = K4 if kernels == K3 else K3
    # the embedding's dropout, forward and backward, through the plain
    # sites' kernel
    want = {kernels[0]: n, kernels[1]: n, others[0]: 0, others[1]: 0, K5[0]: 0, K5[1]: 0,
            DROP_KERNEL: 2 if cfg.drop_prob > 0 else 0}
    counts = train_steps(label, exp, model, pre, frames, labels, want, 20)

    cfg0 = dataclasses.replace(cfg, drop_prob=0.0)
    grad_batch = grad_batch or batch
    grad_parity(label, train_experiment(cfg0, grad_batch), stats, init, frames[:grad_batch],
                labels[:grad_batch], kernels, device, cos_plain)
    del model
    torch.cuda.empty_cache()
    return {"counts": counts, "stats": stats}


def grad_parity(label: str, exp, stats, init, frames, labels, kernels, device,
                cos_plain: float = COSINE_PLAIN) -> None:
    """The gradient of one dropout-free step (exp's model, weights `init`,
    the experiment's front-end on raw `frames`) through the training kernels
    `kernels` (K3 or K4: the backward once a layer) against the plain bf16
    layers (VITIQ_FUSED_TRAIN=0, cosine >= `cos_plain`) and the f32
    `reference` path (cosine >= COSINE_F32) on the same frames."""
    cfg = exp.model
    n = cfg.n_layers
    fused, pre = build_forward_and_preprocess(exp, cfg, stats, device)
    fused.load_state_dict(init)
    inputs = pre(frames)
    flt.reset_launches()
    g_fused = flat_grad(fused, inputs, labels, TRAIN_SEED)
    if flt.launches[kernels[1]] != n:
        raise AssertionError(f"the dropout-free step did not run {kernels[1]}")
    os.environ["VITIQ_FUSED_TRAIN"] = "0"
    try:
        g_plain = flat_grad(fused, inputs, labels, TRAIN_SEED)
    finally:
        del os.environ["VITIQ_FUSED_TRAIN"]
    ref_cfg = dataclasses.replace(cfg, numerics="reference")
    ref, ref_pre = build_forward_and_preprocess(dataclasses.replace(exp, model=ref_cfg), ref_cfg,
                                                stats, device)
    ref.load_state_dict(init)
    g_ref = flat_grad(ref, ref_pre(frames), labels, TRAIN_SEED)
    cos_p = torch.nn.functional.cosine_similarity(g_fused, g_plain, dim=0).item()
    cos_f32 = torch.nn.functional.cosine_similarity(g_fused, g_ref, dim=0).item()
    print(f"  gradient cosine at dropout 0, B={frames.shape[0]}: vs plain bf16 layers {cos_p:.6f} "
          f"(limit {cos_plain}), vs f32 reference path {cos_f32:.6f} (limit {COSINE_F32})",
          flush=True)
    if not cos_p >= cos_plain or not cos_f32 >= COSINE_F32:
        raise AssertionError(f"{label}: fused training gradients diverge from the plain paths")
    del fused, ref
    torch.cuda.empty_cache()


def conv1d_train_check(device, batch: int = 64, steps: int = 20, grad_batch: int = 8) -> dict:
    """20 train steps of the conv1d flagship (1025 tokens) at B=64 on raw
    frames through the fused raw embedding: the fused training stack turns
    the shape down, so every layer is a plain layer rematerialized in the
    backward (VITIQ_TRAIN_REMAT auto) with K5 as its attention. Every step
    must launch K5-fwd 12 times (6 forward, 6 recompute) and K5-bwd 6 times,
    the plain dropout sites' kernel 56 times (the embedding's forward and
    backward, each layer's three sites in the forward, the recompute and
    the backward), K3 and K4 never; the loss must stay finite and fall. Then one step's
    gradient at dropout 0 against the f32 `reference` path at B=8."""
    cfg = flagship_conv1d_config("tpu")
    n = cfg.n_layers
    print(f"phase train: conv1d flagship ({cfg.num_tokens} tokens), {steps} make_train_step "
          f"steps, B={batch}, lr 1e-3, dropout {cfg.drop_prob}", flush=True)
    exp = train_experiment(cfg, batch)
    model, pre = build_forward_and_preprocess(
        exp, AMCModel(cfg, generator=torch.Generator().manual_seed(0)), RAW_STATS, device)
    if model.raw_stats is None:
        raise AssertionError("the conv1d flagship must train through the fused raw embedding")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(5)
    frames = torch.randn((batch, cfg.seq_length, 2), generator=gen).to(device)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen).to(device)
    # the plain dropout sites' kernel: the embedding's and each layer's three
    # in the forward, the recompute and the backward
    want = {K5[0]: 2 * n, K5[1]: n, **{k: 0 for k in flt.launches}, DROP_KERNEL: 2 + 9 * n}
    counts = train_steps("conv1d flagship", exp, model, pre, frames, labels, want, steps)
    del model
    torch.cuda.empty_cache()

    cfg0 = dataclasses.replace(cfg, drop_prob=0.0)
    fused, pre0 = build_forward_and_preprocess(train_experiment(cfg0, grad_batch), cfg0,
                                               RAW_STATS, device)
    fused.load_state_dict(init)
    fa.reset_launches()
    g_fused = flat_grad(fused, pre0(frames[:grad_batch]), labels[:grad_batch], TRAIN_SEED)
    if fa.launches[K5[1]] != n:
        raise AssertionError("the dropout-free step did not run K5-bwd once per layer")
    ref_cfg = dataclasses.replace(cfg0, numerics="reference")
    ref, ref_pre = build_forward_and_preprocess(train_experiment(ref_cfg, grad_batch), ref_cfg,
                                                RAW_STATS, device)
    ref.load_state_dict(init)
    g_ref = flat_grad(ref, ref_pre(frames[:grad_batch]), labels[:grad_batch], TRAIN_SEED)
    cos_f32 = torch.nn.functional.cosine_similarity(g_fused, g_ref, dim=0).item()
    print(f"  gradient cosine at dropout 0, B={grad_batch}: vs f32 reference path {cos_f32:.6f} (limit "
          f"{COSINE_F32})", flush=True)
    if not cos_f32 >= COSINE_F32:
        raise AssertionError("conv1d: K5 training gradients diverge from the f32 path")
    return {"counts": counts}


def time_train_step(label: str, cfg, stats, batch: int, device, card: str, iters: int,
                    env=None) -> float:
    """ms per `make_train_step` step at `batch` (CUDA events after two warm-up
    steps) and the step's peak device memory, with `env` set around it."""
    os.environ.update(env or {})
    try:
        exp = train_experiment(cfg, batch)
        model, pre = build_forward_and_preprocess(exp, cfg, stats, device)
        gen = torch.Generator().manual_seed(6)
        frames = torch.randn((batch, cfg.seq_length, 2), generator=gen).to(device)
        labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen).to(device)
        step = make_train_step(make_optimizer(exp.train), exp.train.label_smoothing, pre)
        box = [create_train_state(model, exp.train)]

        def one():
            box[0] = step(box[0], frames, labels, exp.train.dropout_seed)[0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(one, iters, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        for key in env or {}:
            del os.environ[key]
    print(f"  {label} train step B={batch}: {ms:.4f} ms/step, {batch / (ms / 1e3):.1f} frames/s "
          f"(CUDA events); peak device memory {peak:.3f} GiB  [{card}]", flush=True)
    del box, model
    torch.cuda.empty_cache()
    return ms


def device_us(e) -> float:
    """A profiler event's own device time, us."""
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def device_kernels(prof) -> list:
    """The profiled device kernels (one stream: their times add up to the
    device's busy time)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]


def profile_train_step(label: str, cfg, stats, batch: int, device, card: str,
                       steps: int = 3, top: int = 12, watch=()) -> None:
    """Where a train step's time goes: `torch.profiler` over `steps` steps
    after two warm-up steps; the device's busy time (the sum of its kernels'
    times: one stream) against the host clock gives the idle share, and the
    kernels with the most device time are printed with their counts, and
    every kernel whose name holds one of `watch` with its time a launch."""
    exp = train_experiment(cfg, batch)
    model, pre = build_forward_and_preprocess(exp, cfg, stats, device)
    gen = torch.Generator().manual_seed(6)
    frames = torch.randn((batch, cfg.seq_length, 2), generator=gen).to(device)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen).to(device)
    step = make_train_step(make_optimizer(exp.train), exp.train.label_smoothing, pre)
    box = [create_train_state(model, exp.train)]

    def one():
        box[0] = step(box[0], frames, labels, exp.train.dropout_seed)[0]

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    kernels = device_kernels(prof)
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / steps
    print(f"  {label} profile B={batch}, {steps} steps: host wall {wall_ms:.4f} ms/step "
          f"(profiler on), device kernel time {busy_ms:.4f} ms/step, idle share "
          f"{1 - busy_ms / wall_ms:.4f}  [{card}]", flush=True)
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"    {device_us(e) / 1e3 / steps:9.4f} ms/step  {e.count // steps:4d}x  "
              f"{e.key[:100]}", flush=True)
    for e in kernels:
        for name in watch:
            if f"{name}<" not in e.key:
                continue
            kernel = e.key[e.key.index(f"{name}<"):].split("(")[0]
            print(f"  {label}: {kernel} {device_us(e) / 1e3 / steps:.4f} ms/step, "
                  f"{e.count // steps}x, {device_us(e) / 1e3 / e.count:.4f} ms a launch  "
                  f"[{card}]", flush=True)
    del box, model
    torch.cuda.empty_cache()


def time_train_layers(label: str, L: int, ffn: int, drop: float, device, card: str,
                      stash: bool, D: int = 128, k3: bool = True, B: int = 4096,
                      H: int = 8) -> dict:
    """K3 (unless not `k3`) and with `stash` K4 against their plain versions
    on one layer at B=4096, with their bounds."""
    ops = train_operands(ffn, 13, device, D, H)
    gen = torch.Generator().manual_seed(4)
    x, dy = train_inputs(gen, B, L, D, device)
    args = (H, drop, TRAIN_SEED, 0)
    t = layer_bounds(B, L, ffn, D, H)
    t.update(staged_floors(B, L, ffn, D, H))
    line = f"  {label} train layer B={B} L={L} F={ffn} D={D} H={H} dropout {drop}:"
    with torch.no_grad():
        if k3:
            t.update({
                "k3f_ms": cuda_ms(lambda: flt.fused_train_layer_fwd(x, ops, *args), 10),
                "k3f_plain_ms": cuda_ms(lambda: flt.fused_train_layer_reference(x, ops, *args), 3,
                                        warmup=1),
                "k3b_ms": cuda_ms(lambda: flt.fused_train_layer_bwd(x, dy, ops, *args), 10),
                "k3b_plain_ms": cuda_ms(
                    lambda: flt.fused_train_layer_backward_reference(x, dy, ops, *args), 3,
                    warmup=1),
            })
            line += (f" K3-fwd {t['k3f_ms']:.4f} ms vs plain {t['k3f_plain_ms']:.4f} ms (bound "
                     f"{t['k3f'][0]:.4f} ms by {t['k3f'][1]}, staged byte floor "
                     f"{t['k3f_floor']:.4f} ms); K3-bwd {t['k3b_ms']:.4f} ms vs plain "
                     f"{t['k3b_plain_ms']:.4f} ms (bound {t['k3b'][0]:.4f} ms by {t['k3b'][1]}, "
                     f"staged byte floor {t['k3b_floor']:.4f} ms);")
        if stash:
            _, st = flt.fused_train_layer_fwd_stash(x, ops, *args)
            t.update({
                "k4f_ms": cuda_ms(lambda: flt.fused_train_layer_fwd_stash(x, ops, *args), 10),
                "k4f_plain_ms": cuda_ms(
                    lambda: flt.fused_train_layer_stash_reference(x, ops, *args), 3, warmup=1),
                "k4b_ms": cuda_ms(lambda: flt.fused_train_layer_bwd_stash(x, dy, st, ops, *args),
                                  10),
                "k4b_plain_ms": cuda_ms(lambda: flt.fused_train_layer_stash_backward_reference(
                    x, dy, st, ops, *args), 3, warmup=1),
            })
            line += (f" K4-fwd {t['k4f_ms']:.4f} ms vs plain {t['k4f_plain_ms']:.4f} ms (bound "
                     f"{t['k4f'][0]:.4f} ms by {t['k4f'][1]}, staged byte floor "
                     f"{t['k4f_floor']:.4f} ms); K4-bwd {t['k4b_ms']:.4f} ms vs plain "
                     f"{t['k4b_plain_ms']:.4f} ms (bound {t['k4b'][0]:.4f} ms by {t['k4b'][1]}, "
                     f"staged byte floor {t['k4b_floor']:.4f} ms)")
            del st
    print(line + f"  [{card}]", flush=True)
    del x, dy
    torch.cuda.empty_cache()
    return t


# --------------------------------------------------------------------------
# K6: int8 W8A8 serving and the evaluation of a saved experiment
# --------------------------------------------------------------------------

def reset_all_launches() -> None:
    for module in (fel, k6, k7, fa, flt):
        module.reset_launches()


def all_launches() -> dict:
    return {**fel.launches, **k6.launches, **k7.launches, **fa.launches, **flt.launches}


def quantize_layers(layers):
    """`QuantizedEncoderLayer`s quantized from float `EncoderLayer`s."""
    out = []
    for layer in layers:
        q = QuantizedEncoderLayer(layer.norm1.gamma.shape[0], layer.ffn.linear1.weight.shape[0],
                                  device=layer.norm1.gamma.device)
        q.load_state_dict(quantize_params_int8(layer.state_dict()))
        out.append(q)
    return out


def check_int8(label: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    """K6 or K7 against its plain version: relative L2 and a max counted in
    quantization steps (see K6_LAYER_TOL); returns the max |difference|."""
    rel, steps = tol
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad kernel output {tuple(got.shape)}")
    err = (got - want).abs()
    rel_l2 = ((got - want).norm() / want.norm()).item()
    step = want.abs().amax(dim=-1, keepdim=True) / 127
    max_steps = (err / step).max().item()
    print(f"  {label}: ||kernel - plain|| / ||plain|| = {rel_l2:.6g} (limit {rel}), "
          f"max |kernel - plain| = {err.max().item():.6g} = {max_steps:.4g} quantization "
          f"steps (limit {steps})", flush=True)
    if not (rel_l2 <= rel and max_steps <= steps):
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    return err.max().item()


def check_int8_stage(label: str, a, wq, ws, bias, relu: bool, prequant: bool) -> None:
    """One K6 GEMM stage alone against the plain int8 GEMM, bit for bit."""
    got = k6.int8_gemm(a, wq, ws, bias, relu=relu, prequant=prequant)
    want = k6.int8_gemm_reference(a, wq, ws, bias)
    want = (torch.relu(want) if relu else want).to(torch.bfloat16)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    print(f"  {label} [{a.shape[0]}, {a.shape[1]}] x [{a.shape[1]}, {wq.shape[0]}] "
          f"({'rows quantized by the separate pass' if prequant else 'rows quantized in the GEMM'}"
          f"): bit-identical to the plain int8 GEMM: {same}", flush=True)
    if not same:
        raise AssertionError(f"{label}: K6's GEMM stage is not exact")


def check_int8_kernels(device, batch: int = 256, conv1d_batch: int = 64) -> float:
    """K6 against its plain version at the three flagship shapes, d_head 16
    and 32, and at WIDE_SHAPES: each of five layers on the plain version's
    input to it, then the five K6 layers with the K2 CLS tail as one stack;
    one GEMM stage (FFN1) bit for bit, and at rawiq_best's width all four
    (QKV, out-projection, FFN1, FFN2). Returns the largest per-layer
    difference."""
    worst = 0.0
    gen = torch.Generator().manual_seed(17)
    shapes = [("vit", 129, 512, 128, (8, 4)), ("rawiq", 65, 1024, 128, (8, 4)),
              ("conv1d", CONV1D_L, 1024, 128, (8, 4)),
              *((name, L, ffn, D, (H,)) for name, L, ffn, D, H in WIDE_SHAPES)]
    for seed, (name, L, ffn, D, heads) in enumerate(shapes):
        B = conv1d_batch if L == CONV1D_L else batch
        layers = quantize_layers(random_layers(6, ffn, seed=31 + seed, device=device, D=D))
        x = torch.randn((B, L, D), generator=gen).to(device, torch.bfloat16)
        for n_head in heads:
            wide = "" if D == 128 else f" D={D}"
            print(f"phase int8-kernels: K6 vs plain version on the GPU, {name} shape B={B} "
                  f"L={L} F={ffn}{wide} H={n_head} (d_head {D // n_head})", flush=True)
            ops = [k6.int8_layer_operands(layer, n_head) for layer in layers[:5]]
            with torch.no_grad():
                h = x
                for i in range(5):
                    got = k6.fused_encoder_layer_int8(h, ops[i], n_head)
                    want = k6.fused_layer_int8_reference(h, ops[i], n_head)
                    torch.cuda.synchronize()
                    worst = max(worst, check_int8(f"{name} K6 layer {i}", got, want,
                                                  K6_LAYER_TOL))
                    h = want
                stack = k6.fused_encoder_layer_int8_stack(x, layers, n_head, cls_only=True)
                want = fel.fused_layer_reference(  # the layer's 12 of K2's 15
                    h, k6.dequant_layer_operands(layers[5], n_head)[:12], n_head, 1)
                torch.cuda.synchronize()
                check_int8(f"{name} 5 K6 layers + K2 CLS tail", stack, want, K6_STACK_TOL)
        a = h.reshape(-1, D)
        w1, s1, b1 = ops[0][8:11]
        check_int8_stage(f"{name} K6 FFN1 GEMM stage alone", a, w1, s1, b1, True, True)
        if D == 256:  # rawiq_best: the other three stages too, on their own tiles
            wqkv, sqkv, bqkv, wo, so, bo = ops[0][:6]
            w2, s2, b2 = ops[0][11:14]
            hid = k6.int8_gemm(a, w1, s1, b1, relu=True, prequant=True)
            check_int8_stage(f"{name} K6 QKV GEMM stage alone", a, wqkv, sqkv, bqkv, False, True)
            check_int8_stage(f"{name} K6 out-projection GEMM stage alone", a, wo, so, bo, False,
                             False)
            check_int8_stage(f"{name} K6 FFN2 GEMM stage alone", hid, w2, s2, b2, False, False)
            del hid
        del layers, x, h, stack, want, a
        torch.cuda.empty_cache()
    return worst


def check_int8_stages(device, batch: int = 256, launches: int = 30) -> None:
    """K6's four s8 stage forms alone, as the layer launches them, against
    `k6.s8_stage_reference` on the same inputs, at the ViT, rawIQ,
    rawiq_best and vit_tiny_2016 (D, F) and M = batch * L, 1088 (64 mod 128:
    a streamed stage's last tile half empty) and 1000 (ragged) rows: QKV and
    FFN1 bit for bit (FFN1's row max too, merged by atomicMax over its
    slabs), the out-projection and FFN2 (bf16 rows quantized in the stage,
    LayerNorm epilogue) within K6_LAYER_TOL, their levels and scales bit for
    bit `k6.levels_of` their own bf16 output; `launches` launches of each
    stage and of the layer give the same bits, and the layer given x's levels
    equals the layer quantizing x, its own output levels `levels_of` its
    output."""
    gen = torch.Generator().manual_seed(29)
    for name, L, ffn, D, H in (("vit", 129, 512, 128, 8), ("rawiq", 65, 1024, 128, 8),
                               ("rawiq_best", 65, 1024, 256, 8),
                               ("vit_tiny_2016", 17, 256, 64, 4)):
        layer = quantize_layers(random_layers(1, ffn, seed=41, device=device, D=D))[0]
        ops = k6.int8_layer_operands(layer, H)
        wqkv, sqkv, bqkv, wo, so, bo, g1, be1, w1, s1, b1, w2, s2, b2, g2, be2 = ops
        for M in (batch * L, 1088, 1000):
            x, attn, res = ((2 * torch.randn((M, D), generator=gen)).to(device, torch.bfloat16)
                            for _ in range(3))
            x_levels = k6.levels_of(x)
            qkv = k6.qkv_stage(x_levels, wqkv, sqkv, bqkv)
            x1, x1_levels = k6.out_proj_stage(attn, wo, so, bo, res, g1, be1)
            hid, hmax = k6.ffn1_stage(x1_levels, w1, s1, b1)
            y, y_levels = k6.ffn2_stage(hid, hmax, w2, s2, b2, x1, g2, be2)
            torch.cuda.synchronize()
            same = {
                "QKV": torch.equal(qkv, k6.s8_stage_reference(wqkv, sqkv, bqkv,
                                                              levels=x_levels)[0]),
                "FFN1": all(torch.equal(g, w) for g, w in zip(
                    (hid, hmax), k6.s8_stage_reference(w1, s1, b1, levels=x1_levels, relu=True,
                                                       slab=k6.s8_slab_width(ffn))[:2])),
                "out-proj levels": all(torch.equal(g, w) for g, w in
                                       zip(x1_levels, k6.levels_of(x1))),
                "FFN2 levels": all(torch.equal(g, w) for g, w in zip(y_levels, k6.levels_of(y))),
            }
            print(f"  {name} K6 s8 stages D={D} F={ffn} M={M}: bit for bit "
                  + ", ".join(f"{k} {v}" for k, v in same.items()), flush=True)
            check_int8(f"{name} K6 out-proj + LN1 stage M={M}", x1,
                       k6.s8_stage_reference(wo, so, bo, a=attn, ln=(res, g1, be1))[0],
                       K6_LAYER_TOL)
            check_int8(f"{name} K6 FFN2 + LN2 stage M={M}", y,
                       k6.s8_stage_reference(w2, s2, b2, a=hid, amax=hmax, ln=(x1, g2, be2))[0],
                       K6_LAYER_TOL)
            if not all(same.values()):
                raise AssertionError(f"{name} M={M}: a K6 s8 stage is not its plain version")
            if M != batch * L:
                continue
            runs = {"QKV": lambda: (k6.qkv_stage(x_levels, wqkv, sqkv, bqkv),),
                    "out-proj": lambda: k6.out_proj_stage(attn, wo, so, bo, res, g1, be1),
                    "FFN1": lambda: k6.ffn1_stage(x1_levels, w1, s1, b1),
                    "FFN2": lambda: k6.ffn2_stage(hid, hmax, w2, s2, b2, x1, g2, be2)}
            xb = x.reshape(batch, L, D)
            layer_plain = k6.fused_encoder_layer_int8(xb, ops, H)
            runs["layer"] = lambda: k6.fused_encoder_layer_int8(xb, ops, H, out_levels=True)
            first = {k: [t for part in run() for t in (part if isinstance(part, tuple)
                                                       else (part,))]
                     for k, run in runs.items()}
            if not torch.equal(first["layer"][0], layer_plain):
                raise AssertionError(f"{name}: K6 with out_levels differs from K6 without")
            if not all(torch.equal(g, w) for g, w in zip(first["layer"][1:],
                                                          k6.levels_of(layer_plain))):
                raise AssertionError(f"{name}: K6's output levels are not levels_of its output")
            carried = k6.fused_encoder_layer_int8(xb, ops, H,
                                                  x_levels=k6.levels_of(xb))
            if not torch.equal(carried, layer_plain):
                raise AssertionError(f"{name}: K6 given x's levels differs from K6 quantizing x")
            for k, run in runs.items():
                for _ in range(launches - 1):
                    again = [t for part in run() for t in (part if isinstance(part, tuple)
                                                           else (part,))]
                    if not all(torch.equal(a, b) for a, b in zip(first[k], again)):
                        raise AssertionError(f"{name}: K6's {k} changed its bits over "
                                             f"{launches} launches")
            print(f"  {name} K6 s8 stages and layer: {launches} launches each give the same bits; "
                  f"the layer given x's levels equals the layer quantizing x", flush=True)
        del layer, ops, x, attn, res, qkv, x1, hid, y
        torch.cuda.empty_cache()


def int8_serve_check(label: str, model_cfg, stats, device, sizes, buckets) -> dict:
    """Serve ragged requests through `Server` over the int8 W8A8 twin of a
    model (random weights): every counter is reset just before each request
    and read just after, and each request must launch K6 once per full layer
    and K2 once (CLS pooling; K6 once per layer under mean pooling), nothing
    else. The logits are held to the f32 `reference` path of the same float
    weights (vitiq's bound) and to the port's unfused int8 path on the card
    (VITIQ_NO_FUSED_LAYER=1)."""
    n, frame_len = model_cfg.n_layers, model_cfg.seq_length
    exp = ExperimentConfig(model=model_cfg, data=DataConfig(synthetic_frame_len=frame_len))
    model = AMCModel(model_cfg, generator=torch.Generator().manual_seed(0))
    cls = model.cls_pooling
    ref_cfg = ExperimentConfig(model=dataclasses.replace(model_cfg, numerics="reference"),
                               data=exp.data)
    ref_model = AMCModel(ref_cfg.model)
    ref_model.load_state_dict(model.state_dict())
    serve_fn = build_int8_serving_fn(exp, model, stats, device)
    server = Server(serve_fn, frame_len, buckets, device)
    gen = torch.Generator().manual_seed(1)
    requests = [torch.randn((b, frame_len, 2), generator=gen).to(device) for b in sizes]
    want_counts = {k: 0 for k in all_launches()}
    want_counts.update({K6: n - int(cls), "fused_encoder_layer_cls": int(cls)})
    outs, counts = [], {k: 0 for k in want_counts}
    for x in requests:
        reset_all_launches()
        outs.append(server.run(x))
        torch.cuda.synchronize()
        got = all_launches()
        if got != want_counts:
            raise AssertionError(f"{label}: request of {x.shape[0]} launched {got}, "
                                 f"expected {want_counts}")
        counts = {k: counts[k] + got[k] for k in counts}
    got = torch.cat(outs)
    os.environ["VITIQ_NO_FUSED_LAYER"] = "1"
    try:
        reset_all_launches()
        unfused = torch.cat([server.run(x) for x in requests])
        torch.cuda.synchronize()
        if any(all_launches().values()):
            raise AssertionError(f"{label}: the unfused int8 path launched {all_launches()}")
    finally:
        del os.environ["VITIQ_NO_FUSED_LAYER"]
    ref_serve = build_serving_fn(ref_cfg, ref_model, stats, device)
    want = torch.cat([ref_serve(x) for x in requests])
    torch.cuda.synchronize()
    if got.shape != (sum(sizes), model_cfg.num_classes) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad int8 logits {tuple(got.shape)}")
    limit = INT8_LOGIT_BOUND * max(want.abs().max().item(), 1.0)
    max_ref = (got - want).abs().max().item()
    max_unfused = (got - unfused).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    agree_unfused = (got.argmax(-1) == unfused.argmax(-1)).float().mean().item()
    print(f"  {label} int8: requests {list(sizes)} via buckets {list(buckets)}; launches "
          f"K6 {counts[K6]}, K2 {counts['fused_encoder_layer_cls']}, K1 "
          f"{counts['fused_encoder_layer']}; max |dlogit| vs f32 path {max_ref:.6g} (limit "
          f"{limit:.6g}), argmax agreement {agree:.4f}; vs the unfused int8 path on the card "
          f"{max_unfused:.6g}, agreement {agree_unfused:.4f}", flush=True)
    if not (max_ref < limit and max_unfused < limit):
        raise AssertionError(f"{label}: int8 logits beyond the bound")
    del ref_model, ref_serve
    torch.cuda.empty_cache()
    return {"counts": counts, "serve": serve_fn}


def evaluate_check(device, label: str = "the ViT flagship", model_cfg=None,
                   epochs: int = EVAL_EPOCHS, lr: float = EVAL_LR, frames_per_class: int = 2048,
                   train_kernels=K3, gate_accuracy: bool = True) -> dict:
    """Train a model (3 classes; the ViT flagship unless `model_cfg`) with
    `run_training` on the default synthetic corpus (3 classes x 2048 frames,
    seed 0) into a temporary experiment directory (config.json,
    normalization_stats.json, checkpoints, model_best.npz, its own test
    evaluation, summary.json), then evaluate the saved experiment on its test
    split through `run_evaluation` on the card in float, int8 (K6) and float
    with VITIQ_ATTN_INT8=1 (K7). The launches are counted: every train step
    runs `train_kernels` once per layer, forward and backward, K7 never; each
    batch `run_evaluation` evaluates runs K1 (float), K6 (int8) or K7 (int8
    attention) once per full layer and K2 once, nothing else. The reports
    must parse; with `gate_accuracy`, float accuracy >= EVAL_MIN_ACC and int8
    and int8-attention accuracy within INT8_ACC_POINTS of float."""
    import tempfile
    from pathlib import Path

    model_cfg = dataclasses.replace(model_cfg or flagship_vit_config("tpu"), num_classes=3)
    n = model_cfg.n_layers
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ExperimentConfig(model=model_cfg,
                               data=DataConfig(synthetic_frames_per_class=frames_per_class),
                               train=TrainConfig(batch_size=EVAL_BATCH, num_epochs=epochs,
                                                 learning_rate=lr, patience=epochs,
                                                 save_freq=epochs),
                               experiment_name="evaluate", checkpoint_dir=tmp,
                               log_dir=str(Path(tmp) / "logs"))
        print(f"phase evaluate: run_training of {label} (3 classes) on the synthetic corpus "
              f"({len(cfg.data.synthetic_classes)} x {cfg.data.synthetic_frames_per_class} "
              f"frames, seed {cfg.data.synthetic_seed}), {epochs} epochs at B={EVAL_BATCH}, "
              f"lr {lr}", flush=True)
        t0 = time.perf_counter()
        reset_all_launches()
        summary = run_training(cfg, verbose=False, device=device, make_plots=False)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        run_launches = all_launches()
        history = summary["history"]
        n_train = int(cfg.data.train_size * 3 * frames_per_class)
        steps = n_train // EVAL_BATCH * summary["epochs_run"]
        print(f"  run_training {summary['epochs_run']} epochs in {t_run:.1f} s (training "
              f"{summary['train_wall_seconds']:.1f} s), val acc {history['val_acc'][0]:.4f} -> "
              f"{history['val_acc'][-1]:.4f} (best val loss {summary['best_val_loss']:.4f}), "
              f"its test accuracy {summary['test_overall_accuracy'] * 100:.2f}%; launches "
              f"{ {k: v for k, v in run_launches.items() if v} }", flush=True)
        trained = {k: run_launches[k] for k in (*K3, *K4, *K5, K7)}
        want_trained = {k: n * steps if k in train_kernels else 0 for k in trained}
        if trained != want_trained or not run_launches["fused_encoder_layer_cls"]:
            raise AssertionError(f"run_training launched {run_launches}; expected {want_trained} "
                                 f"over {steps} steps and K1/K2 in its evaluation passes")
        exp_dir = Path(tmp) / "evaluate"
        for name in ("config.json", "normalization_stats.json", "model_best.npz",
                     "model_final.npz", "checkpoint_final.npz", "checkpoint_final.json",
                     f"checkpoint_epoch_{epochs}.npz", "summary.json",
                     "evaluation/test_classification_report.txt"):
            if not (exp_dir / name).exists():
                raise AssertionError(f"run_training did not write {name}")
        for mode, kernel in (("float", "fused_encoder_layer"), ("int8", K6), ("int8attn", K7)):
            reset_all_launches()
            if mode == "int8attn":
                os.environ["VITIQ_ATTN_INT8"] = "1"
            try:
                r = run_evaluation(str(exp_dir), "test", int8=mode == "int8", device=device,
                                   make_plots=False, verbose=False)
            finally:
                os.environ.pop("VITIQ_ATTN_INT8", None)
            torch.cuda.synchronize()
            prefix = "test_int8" if mode == "int8" else "test"
            parsed = ClassificationReportParser(
                exp_dir / "evaluation" / f"{prefix}_classification_report.txt")
            if parsed.overall_accuracy != round(r["overall_accuracy"] * 100, 2) or len(
                    parsed.class_metrics) != 3:
                raise AssertionError(f"{prefix} report does not parse back")
            if not (exp_dir / "evaluation" / f"{prefix}_results.pkl").exists():
                raise AssertionError(f"{prefix}_results.pkl missing")
            launched = {k: v for k, v in all_launches().items() if v}
            counted = fel.kernel_launches()
            batches = -(-len(r["labels"]) // EVAL_BATCH)
            want = {kernel: (n - 1) * batches, "fused_encoder_layer_cls": batches}
            if launched != want:
                raise AssertionError(f"run_evaluation({mode}) launched {launched}, "
                                     f"expected {want}")
            # where the C code launches them: K2's pooling kernel once a K2
            # call, one of K7's two cores once a K7 layer
            cores = counted["attention_int8_kernel"] + counted["attention_int8_sync_kernel"]
            if (counted["cls_pool_kernel"] != batches
                    or cores != (want[K7] if mode == "int8attn" else 0)):
                raise AssertionError(f"run_evaluation({mode}) launched the counted kernels "
                                     f"{counted}; expected {batches} pooling kernels and a K7 "
                                     f"core a K7 layer")
            snr = ", ".join(f"{k:+d} dB {v * 100:.2f}%" for k, v in r["snr_accuracies"].items())
            print(f"  run_evaluation({mode}) on {len(r['labels'])} test frames: accuracy "
                  f"{r['overall_accuracy'] * 100:.2f}% ({snr}); launches {launched}", flush=True)
            out[mode] = r
            out[mode + "_launches"] = launched
            out[mode + "_kernels"] = counted
    acc_f = out["float"]["overall_accuracy"]
    for mode in ("int8", "int8attn"):
        acc = out[mode]["overall_accuracy"]
        agree = float((out["float"]["predictions"] == out[mode]["predictions"]).mean())
        print(f"  test accuracy float {acc_f * 100:.2f}%, {mode} {acc * 100:.2f}% (difference "
              f"{(acc - acc_f) * 100:+.2f} points, limit {INT8_ACC_POINTS * 100:.0f}"
              f"{'' if gate_accuracy else ', not gated'}); prediction agreement {agree:.4f}",
              flush=True)
        if gate_accuracy and abs(acc - acc_f) > INT8_ACC_POINTS:
            raise AssertionError(f"{mode} test accuracy is not within 2 points of float")
    if gate_accuracy and acc_f < EVAL_MIN_ACC:
        raise AssertionError(f"the trained model reached only {acc_f:.4f} test accuracy")
    torch.cuda.empty_cache()
    return {"float_acc": acc_f, "int8_acc": out["int8"]["overall_accuracy"],
            "int8attn_acc": out["int8attn"]["overall_accuracy"],
            "k7_launches": out["int8attn_launches"][K7],
            "kernel_launches": out["int8attn_kernels"]}


def best_cli_train_check(device, card: str,
                         frames_per_class: int = DataConfig.synthetic_frames_per_class) -> dict:
    """`python -m vitiq_torch.cli train` of rawiq_best (d256/L9/H8, the
    preset, with --source synthetic --numerics tpu and a --config JSON that
    sets save_freq 1 and a temporary checkpoint directory) for BEST_CLI_EPOCHS
    epochs, then again with --resume auto and one epoch more, in this
    process, with VITIQ_ATTN_INT8=1 set: every train step must launch K3
    9 + 9 times, every evaluated batch (validation and the final test pass)
    K7 8 times and K2 once, and nothing else; the history must hold
    BEST_CLI_EPOCHS + 1 epochs."""
    import tempfile
    from pathlib import Path

    total = BEST_CLI_EPOCHS + 1
    print(f"phase cli-train: rawiq_best through `cli train` ({BEST_CLI_EPOCHS} epochs, then "
          f"--resume auto to {total}), VITIQ_ATTN_INT8=1", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ExperimentConfig.rawiq_best(**{"train.save_freq": 1, "checkpoint_dir": tmp,
                                             "log_dir": str(Path(tmp) / "logs"),
                                             "experiment_name": "rawiq_best"})
        cfg_path = Path(tmp) / "rawiq_best.json"
        cfg.to_json(str(cfg_path))
        args = ["train", "--config", str(cfg_path), "--source", "synthetic", "--numerics", "tpu",
                "--frames_per_class", str(frames_per_class), "--device", str(device),
                "--no_plots"]
        data = DataConfig()
        n = int(data.train_size * 3 * frames_per_class)
        n_valid = int(data.valid_size * 3 * frames_per_class)
        n_test = 3 * frames_per_class - n - n_valid
        B = cfg.train.batch_size
        spe, valid_b, test_b = n // B, -(-n_valid // B), -(-n_test // B)
        counts = {}
        os.environ["VITIQ_ATTN_INT8"] = "1"
        try:
            for epochs, extra in ((BEST_CLI_EPOCHS, []), (total, ["--resume", "auto"])):
                run_epochs = epochs - (0 if not extra else BEST_CLI_EPOCHS)
                reset_all_launches()
                activities = [torch.profiler.ProfilerActivity.CPU,
                              torch.profiler.ProfilerActivity.CUDA]
                # the resumed epoch runs under the profiler: device busy time
                # and idle share of a whole cli train call
                profiling = (torch.profiler.profile(activities=activities) if extra
                             else contextlib.nullcontext())
                with profiling as prof:
                    t0 = time.perf_counter()
                    cli.main(args + ["--num_epochs", str(epochs), *extra])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                got = all_launches()
                if extra:
                    busy = sum(device_us(e) for e in device_kernels(prof)) / 1e6
                    print(f"  profile of the resumed call (profiler on): host wall {wall:.4f} s, "
                          f"device kernel time {busy:.4f} s, idle share {1 - busy / wall:.4f}  "
                          f"[{card}]", flush=True)
                batches = run_epochs * valid_b + test_b
                want = {k: 0 for k in got}
                want.update({K3[0]: 9 * spe * run_epochs, K3[1]: 9 * spe * run_epochs,
                             K7: 8 * batches, "fused_encoder_layer_cls": batches})
                print(f"  cli train --num_epochs {epochs} {' '.join(extra)}: {run_epochs} "
                      f"epoch(s) in {wall:.1f} s; launches "
                      f"{ {k: v for k, v in got.items() if v} }", flush=True)
                if got != want:
                    raise AssertionError(f"cli train launched {got}, expected {want}")
                for k, v in got.items():
                    counts[k] = counts.get(k, 0) + v
        finally:
            del os.environ["VITIQ_ATTN_INT8"]
        exp_dir = Path(tmp) / "rawiq_best"
        summary = json.loads((exp_dir / "summary.json").read_text())
        manifest = json.loads((exp_dir / "checkpoint_final.json").read_text())
        history = manifest["history"]
        print(f"  resumed run: epochs_run {summary['epochs_run']}, history of "
              f"{len(history['val_loss'])} epochs, val loss "
              f"{[round(v, 4) for v in history['val_loss']]}, test accuracy "
              f"{summary['test_overall_accuracy'] * 100:.2f}%; checkpoints "
              f"{sorted(p.name for p in exp_dir.glob('checkpoint_epoch_*.json'))}", flush=True)
        if summary["epochs_run"] != total or len(history["val_loss"]) != total or not all(
                math.isfinite(v) for v in history["val_loss"]):
            raise AssertionError(f"the resumed rawiq_best run has a history of "
                                 f"{len(history['val_loss'])} epochs, expected {total}")
    return counts


def head_to_head_check(device, card: str, n_head: int = 0, profile: bool = False) -> dict:
    """`python -m vitiq_torch.cli head-to-head --source synthetic --numerics
    tpu --no_plots --num_epochs H2H_EPOCHS [--n_head N]`, in this process, in
    a temporary working directory: the ViT flagship's geometry (vit_reference)
    and the rawIQ flagship's (rawiq_reference) trained on the same default
    corpus (3 x 2048 frames), each evaluated on its test split, then
    compared. The counters, reset just before, must show K3 only for the
    ViT arm's steps (n_layers + n_layers each), K4 only for the rawIQ arm's
    (at n_head 2, d_head 64: K3 at Lp 144 and K4 at Lp 80 as the stash gate
    picks), K1 n_layers - 1 and K2 once per evaluated batch of either arm
    (validation each epoch, then the test pass) and nothing else. Both
    summary.json files and both CSVs must exist, and the printed insights'
    overall_improvement must equal the difference of the two test
    accuracies times 100 within 0.01 (the reports hold percentages to two
    decimals). With `profile`, the call runs under `torch.profiler`: its
    device busy time and idle share."""
    import io
    import tempfile
    from pathlib import Path

    args = ["head-to-head", "--source", "synthetic", "--numerics", "tpu", "--num_epochs",
            str(H2H_EPOCHS), "--device", str(device), "--no_plots"]
    if n_head:
        args += ["--n_head", str(n_head)]
    vit_cfg, raw_cfg = cli.head_to_head_configs(cli.build_parser().parse_args(args))
    print(f"phase head-to-head: python -m vitiq_torch.cli {' '.join(args)} (ViT d{vit_cfg.model.d_model}"
          f"/L{vit_cfg.model.n_layers}/H{vit_cfg.model.n_head}, rawIQ d{raw_cfg.model.d_model}/"
          f"L{raw_cfg.model.n_layers}/H{raw_cfg.model.n_head})", flush=True)
    want = {k: 0 for k in all_launches()}
    kernels = {}
    for arm, cfg in (("vit", vit_cfg), ("rawiq", raw_cfg)):
        m, data, B = cfg.model, cfg.data, cfg.train.batch_size
        L = m.num_tokens
        k = K4 if flt.stash_enabled(L, m.n_head, m.d_model, B) else K3
        if not flt.fused_train_supported(L, m.d_model, m.ffn_hidden, m.n_head):
            raise AssertionError(f"the {arm} arm's shape must train through K3/K4")
        kernels[arm] = k
        n = len(data.synthetic_classes) * data.synthetic_frames_per_class
        n_train, n_valid = int(data.train_size * n), int(data.valid_size * n)
        steps = H2H_EPOCHS * (n_train // B)
        batches = H2H_EPOCHS * -(-n_valid // B) + -(-(n - n_train - n_valid) // B)
        for name in k:
            want[name] += m.n_layers * steps
        want["fused_encoder_layer"] += (m.n_layers - 1) * batches
        want["fused_encoder_layer_cls"] += batches
    if kernels != {"vit": K3, "rawiq": K4}:
        raise AssertionError(f"the arms train through {kernels}, expected K3 (ViT) and K4 (rawIQ)")
    cwd = os.getcwd()
    out = io.StringIO()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_all_launches()
            with (torch.profiler.profile(activities=activities) if profile
                  else contextlib.nullcontext()) as prof:
                with contextlib.redirect_stdout(out):
                    t0 = time.perf_counter()
                    cli.main(args)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            got = all_launches()
            text = out.getvalue()
            result = json.loads(text[text.rindex("\n{\n") + 1:])
            files = [Path(result[arm]["experiment_dir"]) / "summary.json"
                     for arm in ("vit", "rawiq")]
            files += [Path(result["comparison_dir"]) / name
                      for name in ("summary_comparison.csv", "detailed_comparison.csv")]
            missing = [str(f) for f in files if not f.exists()]
            epochs = {arm: json.loads((Path(result[arm]["experiment_dir"])
                                       / "checkpoint_final.json").read_text())["history"]
                      ["epoch_time"] for arm in ("vit", "rawiq")}
        finally:
            os.chdir(cwd)
    print(f"  launches {{ {', '.join(f'{k}: {v}' for k, v in got.items() if v)} }}", flush=True)
    if got != want:
        raise AssertionError(f"head-to-head launched {got}, expected {want}")
    if missing:
        raise AssertionError(f"head-to-head did not write {missing}")
    vit_acc = result["vit"]["test_overall_accuracy"]
    raw_acc = result["rawiq"]["test_overall_accuracy"]
    improvement = result["insights"]["overall_improvement"]
    print(f"  {H2H_EPOCHS} epochs each: ViT test accuracy {vit_acc * 100:.2f}% (epochs_run "
          f"{result['vit']['epochs_run']}), rawIQ {raw_acc * 100:.2f}% (epochs_run "
          f"{result['rawiq']['epochs_run']}); insights overall_improvement {improvement:+.2f} "
          f"points, top improved {result['insights'].get('top_improved')}; wall "
          f"{wall:.4f} s{' (profiler on)' if profile else ''}  [{card}]", flush=True)
    # the wall split: each arm's fit (its epochs: train steps + validation) and
    # the rest (corpus, model build, checkpoint writes, test pass, comparison)
    fits = {arm: result[arm]["train_wall_seconds"] for arm in ("vit", "rawiq")}
    for arm in ("vit", "rawiq"):
        later = epochs[arm][1:]
        print(f"  {arm} arm: fit {fits[arm]:.4f} s, epochs "
              f"{', '.join(f'{e:.4f}' for e in epochs[arm])} s (train steps + validation); "
              f"after the first, {n_train * len(later) / sum(later):.1f} training frames/s "
              f"with validation  [{card}]", flush=True)
    print(f"  wall {wall:.4f} s = fits {sum(fits.values()):.4f} s + the rest "
          f"{wall - sum(fits.values()):.4f} s (corpus, model build, checkpoint writes, test "
          f"pass, comparison)  [{card}]", flush=True)
    if not abs(improvement - 100 * (raw_acc - vit_acc)) <= 0.01 + 1e-9:
        raise AssertionError(f"insights overall_improvement {improvement} != 100 * "
                             f"({raw_acc} - {vit_acc})")
    if profile:
        busy = sum(device_us(e) for e in device_kernels(prof)) / 1e6
        print(f"  profile of the head-to-head call: host wall {wall:.4f} s (profiler on), "
              f"device kernel time {busy:.4f} s, idle share {1 - busy / wall:.4f}  [{card}]",
              flush=True)
    return {"counts": got, "wall_s": wall}


class SyntheticRows:
    """A packing source over `n` frames made from `seed`: 3 classes, each a
    tone of its own frequency in unit noise, and an SNR label; `read_rows`,
    `labels_for` and `snrs_for` as `pack_split_to_npy` reads them."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        self.y = rng.integers(0, 3, n).astype(np.int32)
        self.z = rng.choice(np.array([-8.0, 0.0, 8.0, 20.0], np.float32), n)
        phase = 2 * np.pi * np.outer(np.arange(1, 4) / 32, np.arange(FRAME_LEN))
        tones = np.stack([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)
        self.x = rng.standard_normal((n, FRAME_LEN, 2), dtype=np.float32)
        self.x += tones[self.y]

    def read_rows(self, rows):
        return self.x[rows]

    def labels_for(self, rows, label_map):
        return self.y[rows]

    def snrs_for(self, rows):
        return self.z[rows]


def copied_in_turn(batch_iter, device, prefetch_depth: int = 3):
    """`fit`'s feed without the prefetcher: each batch's arrays copied to the
    card in the consumer, the host waiting for each copy."""
    for item in batch_iter:
        yield tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    if isinstance(a, np.ndarray) else a for a in item)


def same_bytes(got: torch.Tensor, want: np.ndarray) -> bool:
    return (got.dtype == torch.from_numpy(want[:0]).dtype and tuple(got.shape) == want.shape
            and torch.equal(got.cpu().view(torch.uint8), torch.from_numpy(want).view(torch.uint8)))


def evaluate_feed_per_batch(eval_step, model, feed, batch_size: int, device) -> dict:
    """`evaluate_feed` with each batch copied in turn and its three sums read
    to the host (the loop before its sums moved to the device)."""
    loss_sum = correct_sum = count = 0.0
    for bx, by, mask in copied_in_turn(feed.eval_batches(batch_size), device):
        m = eval_step(model, bx, by, mask)
        loss_sum += float(m["loss_sum"])
        correct_sum += float(m["correct_sum"])
        count += float(m["count"])
    return {"loss": loss_sum / count, "accuracy": correct_sum / count}


@torch.no_grad()
def predict_feed_per_batch(forward_fn, feed, batch_size: int, preprocess_fn,
                           device) -> np.ndarray:
    """`predict_feed` with each batch copied in turn and its argmax read to
    the host before the next batch."""
    preds = []
    for bx, _, _ in feed.raw_batches(batch_size):
        x = torch.from_numpy(np.asarray(bx, np.float32)).to(device)
        if len(bx) < batch_size:
            x = torch.cat([x, x.new_zeros((batch_size - len(bx),) + tuple(x.shape[1:]))])
        preds.append(forward_fn(preprocess_fn(x)).argmax(dim=-1)[:len(bx)].cpu().numpy())
    return np.concatenate(preds)


def stream_train_check(device, card: str, batch: int = STREAM_BATCH,
                       n_train: int = STREAM_TRAIN_FRAMES, n_valid: int = STREAM_VALID_FRAMES,
                       shard_rows: int = STREAM_SHARD_ROWS) -> dict:
    """The stream-train phase (see the module docstring): pack, stream,
    train with and without the prefetcher, evaluate, and evaluate the saved
    weights as a reference checkpoint through `cli evaluate
    --torch-checkpoint`."""
    import pickle
    import tempfile

    from vitiq_torch.data import PackedDataSource, StreamFeed, native, pack_split_to_npy
    from vitiq_torch.data.pipeline import device_prefetch
    from vitiq_torch.eval import predict_feed
    from vitiq_torch.train import loop
    from vitiq_torch.train.checkpoint import save_params

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        rows = SyntheticRows(n_train + n_valid, STREAM_SEED)
        label_map = {"BPSK": 0, "QPSK": 1, "16QAM": 2}
        pack_split_to_npy(rows, np.arange(n_train), label_map, tmp / "train", shard_rows)
        pack_split_to_npy(rows, np.arange(n_train, n_train + n_valid), label_map, tmp / "valid",
                          shard_rows)
        mib = sum(f.stat().st_size for f in tmp.rglob("*") if f.is_file()) / 2 ** 20
        train_src, valid_src = PackedDataSource(tmp / "train"), PackedDataSource(tmp / "valid")
        sample = np.random.default_rng(0).integers(0, n_train, 2 * batch)
        if not np.array_equal(train_src.read_rows(sample), rows.x[sample]):
            raise AssertionError("PackedDataSource.read_rows does not return the packed rows")
        print(f"phase stream-train: {n_train} train + {n_valid} valid frames packed in "
              f"{time.perf_counter() - t0:.2f} s ({mib:.1f} MiB, {shard_rows} rows a shard); "
              f"native gather {'ran' if native.available() else 'unavailable: numpy ran'}",
              flush=True)
        train_feed = StreamFeed(train_src.batch_stream, train_src.num_rows, shuffle_seed=2,
                                source=train_src)
        valid_feed = StreamFeed(valid_src.batch_stream, valid_src.num_rows, source=valid_src)

        host = list(train_feed.train_batches(0, batch))
        got = 0
        for (hx, hy), (dx, dy) in zip(host, device_prefetch(train_feed.train_batches(0, batch),
                                                            device, 3)):
            on_card = all(isinstance(t, torch.Tensor) and t.device == device for t in (dx, dy))
            if (device.type == "cuda" and not on_card) or not (
                    same_bytes(torch.as_tensor(dx), hx) and same_bytes(torch.as_tensor(dy), hy)):
                raise AssertionError(f"prefetched batch {got} differs from its host batch")
            got += 1
        if got != len(host) or got != n_train // batch:
            raise AssertionError(f"{got} batches reached the card, expected {len(host)}")
        print(f"  bytes: {got} streamed batches of [{batch}, {FRAME_LEN}, 2] f32 reached the "
              "card through device_prefetch byte for byte", flush=True)
        del host

        model_cfg = dataclasses.replace(flagship_vit_config("tpu"), num_classes=3)
        exp = ExperimentConfig(model=model_cfg,
                               train=TrainConfig(batch_size=batch, num_epochs=STREAM_EPOCHS,
                                                 learning_rate=3e-4))
        steps = n_train // batch * STREAM_EPOCHS
        n = model_cfg.n_layers
        valid_batches = -(-n_valid // batch) * STREAM_EPOCHS
        want = {k: 0 for k in all_launches()}
        want.update({K3[0]: n * steps, K3[1]: n * steps,
                     "fused_encoder_layer": (n - 1) * valid_batches,
                     "fused_encoder_layer_cls": valid_batches})
        runs = []
        real = loop.device_prefetch
        # in turns, so that neither feed alone carries the first run's warm-up
        for label, feed in (("copied in turn", copied_in_turn), ("prefetch", real),
                            ("prefetch", real), ("copied in turn", copied_in_turn)):
            model = AMCModel(model_cfg, generator=torch.Generator().manual_seed(STREAM_SEED))
            model, pre = build_forward_and_preprocess(exp, model, STATS, device)
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            marks = {}

            def profile_last_epoch(epoch, state, history):
                torch.cuda.synchronize()
                if epoch == STREAM_EPOCHS - 2:
                    prof.start()
                    marks["t0"] = time.perf_counter()
                elif epoch == STREAM_EPOCHS - 1:
                    marks["wall"] = time.perf_counter() - marks["t0"]
                    prof.stop()

            loop.device_prefetch = feed
            reset_all_launches()
            try:
                res = loop.fit(exp, model, train_feed, valid_feed, preprocess_fn=pre,
                               epoch_callback=profile_last_epoch, verbose=False, profile=True)
            finally:
                loop.device_prefetch = real
            torch.cuda.synchronize()
            launched = all_launches()
            if launched != want:
                raise AssertionError(f"fit ({label}) launched {launched}, expected {want}")
            h = res.history
            if len(h.get("step_p50", [])) != STREAM_EPOCHS or len(h["step_p90"]) != STREAM_EPOCHS:
                raise AssertionError(f"fit ({label}) history lacks step_p50/step_p90: {h}")
            events = device_kernels(prof)
            copies = sum(device_us(e) for e in events if e.key.startswith("Memcpy")) / 1e6
            busy = sum(device_us(e) for e in events if not e.key.startswith(("Memcpy",
                                                                              "Memset"))) / 1e6
            print(f"  fit ({label}), {STREAM_EPOCHS} epochs of {n_train // batch} steps at "
                  f"B={batch}: epoch wall {[round(t, 4) for t in h['epoch_time']]} s, step "
                  f"p50 {[round(t * 1e3, 4) for t in h['step_p50']]} ms, p90 "
                  f"{[round(t * 1e3, 4) for t in h['step_p90']]} ms, train loss "
                  f"{[round(v, 4) for v in h['train_loss']]}; last epoch under the profiler: "
                  f"host wall {marks['wall']:.4f} s, device kernel time {busy:.4f} s, copies "
                  f"{copies:.4f} s, idle share {1 - busy / marks['wall']:.4f}  [{card}]",
                  flush=True)
            runs.append({"label": label, "model": model, "pre": pre, "history": h,
                         "params": [p.detach().clone() for p in model.parameters()],
                         "idle": 1 - busy / marks["wall"]})
        first = runs[0]
        for r in runs[1:]:
            if not all(torch.equal(p, q) for p, q in zip(first["params"], r["params"])):
                raise AssertionError("the parameters trained through the prefetcher differ from "
                                     "those trained with each batch copied in turn")
            if r["history"]["train_loss"] != first["history"]["train_loss"]:
                raise AssertionError("the runs' train losses differ")
        print(f"  the {len(first['params'])} parameter tensors of the {len(runs)} runs, with and "
              "without the prefetcher, are equal bit for bit", flush=True)
        out["fit"] = [{"feed": r["label"], "epoch_time": r["history"]["epoch_time"],
                       "step_p50": r["history"]["step_p50"],
                       "step_p90": r["history"]["step_p90"], "idle": r["idle"]} for r in runs]

        model, pre = runs[1]["model"], runs[1]["pre"]
        model.eval()
        eval_step = loop.make_eval_step(exp.train.label_smoothing, pre)
        times = {}
        for name, call in (("evaluate_feed", lambda: loop.evaluate_feed(eval_step, model,
                                                                        train_feed, batch)),
                           ("evaluate_feed per batch", lambda: evaluate_feed_per_batch(
                               eval_step, model, train_feed, batch, device)),
                           ("predict_feed", lambda: predict_feed(model, train_feed, batch, device,
                                                                 pre)[0]),
                           ("predict_feed per batch", lambda: predict_feed_per_batch(
                               model, train_feed, batch, pre, device))):
            results = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results.append(call())
                torch.cuda.synchronize()
                times.setdefault(name, []).append(time.perf_counter() - t0)
            out[name] = results[-1]
        if out["evaluate_feed"] != out["evaluate_feed per batch"]:
            raise AssertionError(f"evaluate_feed {out['evaluate_feed']} != its per-batch "
                                 f"version {out['evaluate_feed per batch']}")
        if not np.array_equal(out["predict_feed"], out["predict_feed per batch"]):
            raise AssertionError("predict_feed's predictions differ from its per-batch version")
        print(f"  evaluate_feed {out['evaluate_feed']} equals its per-batch version; "
              f"predict_feed's {len(out['predict_feed'])} predictions equal theirs; seconds a "
              f"pass over {n_train} frames: "
              + ", ".join(f"{k} {[round(t, 4) for t in v]}" for k, v in times.items())
              + f"  [{card}]", flush=True)
        out["eval_times"] = times
        train_feed.close()
        valid_feed.close()

        ref_exp = ExperimentConfig(model=model_cfg, data=DataConfig(synthetic_frames_per_class=512),
                                   train=TrainConfig(batch_size=128))
        ref_exp.to_json(str(tmp / "synthetic.json"))
        torch.save({"model_state_dict": model.state_dict()}, tmp / "vit_flagship.pth")
        reset_all_launches()
        cli.main(["evaluate", "--torch-checkpoint", str(tmp / "vit_flagship.pth"), "--config",
                  str(tmp / "synthetic.json"), "--output", str(tmp / "reference"), "--device",
                  str(device), "--no_plots"])
        torch.cuda.synchronize()
        launched = {k: v for k, v in all_launches().items() if v}
        with open(tmp / "reference" / "test_results.pkl", "rb") as f:
            ref = pickle.load(f)
        batches = -(-len(ref["predictions"]) // 128)
        if launched != {"fused_encoder_layer": (n - 1) * batches,
                        "fused_encoder_layer_cls": batches}:
            raise AssertionError(f"cli evaluate --torch-checkpoint launched {launched}")
        exp_dir = tmp / "experiment"
        exp_dir.mkdir()
        ref_exp.to_json(str(exp_dir / "config.json"))
        save_params(exp_dir / "model_best", model.state_dict(), model_cfg)
        r = run_evaluation(str(exp_dir), device=device, make_plots=False, verbose=False)
        if not np.array_equal(r["predictions"], ref["predictions"]):
            raise AssertionError("cli evaluate --torch-checkpoint and run_evaluation predict "
                                 "differently on the same weights")
        print(f"  cli evaluate --torch-checkpoint on {len(ref['predictions'])} test frames: "
              f"accuracy {ref['overall_accuracy'] * 100:.2f}%, launches {launched}; its "
              "predictions equal run_evaluation's on the same weights", flush=True)
        out["reference_launches"] = launched
    del runs, model
    torch.cuda.empty_cache()
    return out


def check_rejects_k1(name: str, k1_out: torch.Tensor, want: torch.Tensor) -> None:
    """The K7 layer check must turn away K1's output (K1's bf16 core in
    K7's place) on the same input: its relative L2 exceeds K7_LAYER_TOL's."""
    rel_l2 = ((k1_out.float() - want.float()).norm() / want.float().norm()).item()
    print(f"  {name} K1 in K7's place, read by the K7 layer check: ||K1 - K7 plain|| / "
          f"||K7 plain|| = {rel_l2:.6g} (must exceed {K7_LAYER_TOL[0]})", flush=True)
    if not rel_l2 > K7_LAYER_TOL[0]:
        raise AssertionError(f"{name}: K7's layer tolerance does not tell K1's core from K7's")


def check_int8attn_kernels(device, batch: int = 256, conv1d_batch: int = 64,
                           core_batch: int = 2) -> float:
    """K7 against its plain version at the three flagship shapes (d_head 16)
    and rawiq_best's (D=256, d_head 32): each of five layers on the plain
    version's input to it, then the five K7 layers with the K2 CLS tail as
    one stack, held as K6 is (K7_LAYER_TOL, K7_STACK_TOL), with K1 on the
    first layer's input read by the same check, which must turn it away; and
    K7's core alone on one qkv (`core_batch` frames), in each of its two
    forms (the wgmma core and the one-tile mma.sync core, each at every
    shape; a layer takes the form `k7.core_route` gives), whose s32 scores
    and s32 tile products P [v | 1] (taken with the kernel's own int8
    probabilities) must equal the plain version's bit for bit, with the
    probabilities and outputs that differ held by K7_CORE_DIFFER and the
    outputs equal to 30 launches without the dump. Returns the largest
    per-layer difference and each form's largest |difference| from the
    core's plain output."""
    worst = 0.0
    core_err = {"wgmma": 0.0, "sync": 0.0}
    gen = torch.Generator().manual_seed(23)
    shapes = [("vit", 129, 512, 128), ("rawiq", 65, 1024, 128), ("conv1d", CONV1D_L, 1024, 128),
              ("rawiq_best", 65, 1024, 256)]
    for seed, (name, L, ffn, D) in enumerate(shapes):
        B = conv1d_batch if L == CONV1D_L else batch
        wide = "" if D == 128 else f" D={D}"
        print(f"phase int8attn-kernels: K7 vs plain version on the GPU, {name} shape B={B} "
              f"L={L} F={ffn}{wide} H=8 (d_head {D // 8})", flush=True)
        layers = random_layers(6, ffn, seed=41 + seed, device=device, D=D)
        ops = [fel.layer_operands(layer, 8) for layer in layers]
        x = torch.randn((B, L, D), generator=gen).to(device, torch.bfloat16)
        with torch.no_grad():
            h = x
            for i in range(5):
                got = k7.fused_encoder_layer_int8attn(h, ops[i], 8)
                want = k7.fused_layer_int8attn_reference(h, ops[i], 8)
                torch.cuda.synchronize()
                worst = max(worst, check_int8(f"{name} K7 layer {i}", got, want, K7_LAYER_TOL))
                if i == 0:
                    check_rejects_k1(name, fel.fused_encoder_layer(h, ops[0], 8), want)
                h = want
            stack = k7.fused_encoder_layer_int8attn_stack(x, layers, 8, cls_only=True)
            want = fel.fused_layer_reference(h, ops[5], 8, 1)
            torch.cuda.synchronize()
            check_int8(f"{name} 5 K7 layers + K2 CLS tail", stack, want, K7_STACK_TOL)
            qkv = (fel._mm(h[:core_batch], ops[0][0]) + ops[0][1]).to(torch.bfloat16)
            own = k7.attention_int8_products(qkv, 8)
            ref = k7.attention_int8_reference(qkv, 8)
        for form in ("wgmma", "sync"):
            with torch.no_grad():
                core, dump = k7.attention_int8(qkv, 8, dump=True, core=form)
                same_bits = all(torch.equal(core, k7.attention_int8(qkv, 8, core=form))
                                for _ in range(30))
                torch.cuda.synchronize()
                plain = k7.attention_int8_products(qkv, 8, probs=dump["probs"])
            same_s = torch.equal(dump["scores"], plain["scores"])
            same_pv = torch.equal(dump["pv"], plain["pv"])
            n_probs = int((dump["probs"] != own["probs"]).sum())
            n_out = int((core != ref).sum())
            core_err[form] = max(core_err[form], (core.float() - ref.float()).abs().max().item())
            routed = " (the layer's route)" if k7.core_route(L) == form else ""
            print(f"  {name} K7 {form} core{routed} alone B={core_batch}: s32 scores equal to the "
                  f"plain version's: {same_s}; s32 P [v | 1] tile products on the kernel's "
                  f"probabilities equal: {same_pv}; int8 probabilities that differ {n_probs} of "
                  f"{dump['probs'].numel()}, outputs that differ {n_out} of {core.numel()} "
                  f"(limits {K7_CORE_DIFFER[0]:g} and {K7_CORE_DIFFER[1]:g} of them); the same "
                  f"outputs without the dump, 30 launches: {same_bits}", flush=True)
            if not (same_s and same_pv):
                raise AssertionError(f"{name}: K7's {form} int8 products are not the plain "
                                     f"version's")
            if not (n_probs < K7_CORE_DIFFER[0] * dump["probs"].numel()
                    and n_out < K7_CORE_DIFFER[1] * core.numel() and same_bits):
                raise AssertionError(f"{name}: K7's {form} core disagrees with its plain version")
            del core, dump, plain
        del layers, x, h, stack, want, qkv, own, ref
        torch.cuda.empty_cache()
    return worst, core_err


def time_serving_layers(name: str, L: int, ffn: int, B: int, D: int, device, card: str) -> dict:
    """K1 and K2 on one layer at [B, L, D] (H = 8) against their plain
    versions, with their bounds (K2's two: `k2`, the layer's function with
    K and V formed, and `k2_cls`, the reassociated work it does); K2's
    pooling kernel alone on the qt its stages give, against its plain
    version and the yardstick scaled_dot_product_attention (one query a
    head over x as keys and values, log2 units: scale ln 2), which the port
    never calls."""
    ops = fel.layer_operands(random_layers(1, ffn, seed=13, device=device, D=D)[0], 8)
    cls_ops = fel.cls_operands(ops, 8)
    x = torch.randn((B, L, D), generator=torch.Generator().manual_seed(3))
    x = x.to(device, torch.bfloat16)
    with torch.no_grad():
        q = (fel._mm(x[:, 0], ops[0][:, :D]) + ops[1][:D]).to(torch.bfloat16)
        qt = (fel._mm(q, cls_ops[12]) + cls_ops[14]).to(torch.bfloat16).reshape(B, 8, D)
        kv = x[:, None].expand(B, 8, L, D)
        t = {
            "k1_ms": cuda_ms(lambda: fel.fused_encoder_layer(x, ops, 8), 20),
            "k1_plain_ms": cuda_ms(lambda: fel.fused_layer_reference(x, ops, 8, L), 10),
            "k2_ms": cuda_ms(lambda: fel.fused_encoder_layer_cls(x, cls_ops, 8), 20),
            "k2_plain_ms": cuda_ms(lambda: fel.fused_layer_cls_reference(x, cls_ops, 8), 10),
            "pool_ms": cuda_ms(lambda: fel.cls_pool(x, qt), 20),
            "pool_plain_ms": cuda_ms(lambda: fel.cls_pool_reference(x, qt), 10),
            "pool_sdpa_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt[:, :, None], kv, kv, scale=math.log(2.0)), 20),
        }
    t.update(layer_bounds(B, L, ffn, D))
    wide = "" if D == 128 else f" D={D}"
    print(f"  {name} layer B={B} L={L} F={ffn}{wide}: K1 {t['k1_ms']:.4f} ms vs plain "
          f"{t['k1_plain_ms']:.4f} ms (bound {t['k1'][0]:.4f} ms by {t['k1'][1]}); K2 "
          f"{t['k2_ms']:.4f} ms vs plain {t['k2_plain_ms']:.4f} ms (bound "
          f"{t['k2'][0]:.4f} ms by {t['k2'][1]}; of the reassociated work "
          f"{t['k2_cls'][0]:.4f} ms by {t['k2_cls'][1]}); its pooling kernel "
          f"{t['pool_ms']:.4f} ms vs plain {t['pool_plain_ms']:.4f} ms vs "
          f"scaled_dot_product_attention {t['pool_sdpa_ms']:.4f} ms (bound {t['pool'][0]:.4f} ms "
          f"by {t['pool'][1]})  [{card}]", flush=True)
    del x, kv, qt
    torch.cuda.empty_cache()
    return t


# K6's kernels a layer call, in launch order
K6_STAGES = ("row quantization", "QKV", "attention", "out-proj + LN1", "FFN1", "FFN2 + LN2")


# Profile windows a stage split may take. The profiler can miss the first
# kernels of a window (a full smoke run kept 7 of a window's 20 K1 calls
# whole, the first kernel it kept being a call's last), so a window starts
# with PROFILE_PAD launches of `torch.cuda._sleep` (`spin_kernel`, about
# 0.1 ms each, left out of the split) and a split takes windows until they
# hold half a window's calls.
PROFILE_WINDOWS = 4
PROFILE_PAD = 256


def profile_whole_calls(call, calls: int, split, label: str) -> list:
    """`torch.profiler` over windows of `calls` calls of call(), after two
    warm-up calls: each window's device kernels that started inside it, in
    start order and without its pad, go to split(kernels), which returns the
    calls it holds whole. Windows repeat, up to PROFILE_WINDOWS, until they hold at least
    calls // 2 whole calls; a window that holds fewer than `calls` is
    reported. Returns the whole calls."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    whole = []
    for window in range(1, PROFILE_WINDOWS + 1):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
                          and e.time_range.start >= 0 and "spin_kernel" not in e.name),
                         key=lambda e: e.time_range.start)
        held = split(kernels)
        whole += held
        if len(held) < calls:
            print(f"  {label}: profile window {window} held {len(held)} of {calls} calls whole "
                  f"({len(kernels)} kernels)", flush=True)
        if len(whole) >= calls // 2:
            return whole
    raise AssertionError(f"{label}: {len(whole)} whole calls in {PROFILE_WINDOWS} profile windows "
                         f"of {calls}")


def profile_stages(layer, labels, kind, calls: int = 20) -> list:
    """A layer's time by stage: `profile_whole_calls` over calls of layer(),
    each call's kernels told apart by kind(name) in launch order (`labels`,
    as kinds). Returns each stage's ms, averaged over the calls held whole."""
    n = len(labels)

    def split(kernels):
        kinds = [kind(e.name) for e in kernels]
        return [kernels[i:i + n] for i in range(len(kernels) - n + 1)
                if kinds[i:i + n] == labels]

    whole = profile_whole_calls(layer, calls, split, "/".join(labels))
    return [sum(device_us(c[i]) for c in whole) / len(whole) / 1e3 for i in range(n)]


def k6_kind(name: str) -> str:
    """A K6 call's kernel by name: the row-quantization pass, the attention
    core, an s8 stage reading levels or quantizing bf16 rows."""
    if "rowquant_kernel" in name:
        return "rowquant"
    if "attention_core_kernel" in name:
        return "attention"
    if "gemm_s8_kernel" in name:
        return "quant_a" if "MmaS8QuantA" in name else "levels"
    return name


def time_int8_layers(name: str, L: int, ffn: int, device, card: str, B: int = 4096,
                     D: int = 128) -> dict:
    """K6 on one layer at [B, L, D] against its plain version and K1 on the
    same float weights, both by stage (`torch.profiler`); its FFN1 stage alone
    as the layer runs it (x1's levels in: `k6.ffn1_stage`) against the
    yardstick torch._int_mm (int8 x int8 -> int32 only: no dequant
    epilogue, no row max), which the port never calls, and with its rows
    quantized by the separate pass (`int8_gemm`, prequant)."""
    float_layer = random_layers(1, ffn, seed=13, device=device, D=D)[0]
    ops = k6.int8_layer_operands(quantize_layers([float_layer])[0], 8)
    ops1 = fel.layer_operands(float_layer, 8)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((B, L, D), generator=gen).to(device, torch.bfloat16)
    a = torch.randn((B * L, D), generator=gen).to(device, torch.bfloat16)
    a_levels = k6.levels_of(a)
    a8 = a_levels.q
    w1, s1, b1 = ops[8:11]
    with torch.no_grad():
        t = {
            "k6_ms": cuda_ms(lambda: k6.fused_encoder_layer_int8(x, ops, 8), 20),
            "k6_plain_ms": cuda_ms(lambda: k6.fused_layer_int8_reference(x, ops, 8), 5, warmup=1),
            "k1_ms": cuda_ms(lambda: fel.fused_encoder_layer(x, ops1, 8), 20),
            "k6_ffn1_ms": cuda_ms(lambda: k6.ffn1_stage(a_levels, w1, s1, b1), 20),
            "k6_ffn1_prequant_ms": cuda_ms(
                lambda: k6.int8_gemm(a, w1, s1, b1, relu=True, prequant=True), 20),
            "int_mm_ms": cuda_ms(lambda: torch._int_mm(a8, w1.t()), 20),
        }
        t["k6_stages"] = profile_stages(
            lambda: k6.fused_encoder_layer_int8(x, ops, 8),
            ["rowquant", "levels", "attention", "quant_a", "levels", "quant_a"], k6_kind)
        t["k1_stages"] = profile_stages(lambda: fel.fused_encoder_layer(x, ops1, 8), K1_KINDS,
                                        k1_kind)
    b = layer_bounds(B, L, ffn, D)
    t.update({"k6": b["k6"], "k6_ffn1": b["k6_ffn1"]})
    print(f"  {name} int8 layer B={B} L={L} F={ffn} D={D}: K6 {t['k6_ms']:.4f} ms vs plain "
          f"{t['k6_plain_ms']:.4f} ms vs K1 {t['k1_ms']:.4f} ms (K6 bound {b['k6'][0]:.4f} ms by "
          f"{b['k6'][1]}); FFN1 stage [{B * L}, {D}] x [{D}, {ffn}] from levels: K6 stage "
          f"{t['k6_ffn1_ms']:.4f} ms vs torch._int_mm {t['int_mm_ms']:.4f} ms (stage bound "
          f"{b['k6_ffn1'][0]:.4f} ms by {b['k6_ffn1'][1]}); with the row-quantization pass "
          f"(int8_gemm, prequant) {t['k6_ffn1_prequant_ms']:.4f} ms  [{card}]", flush=True)
    print(f"  {name} K6 layer by stage (torch.profiler): " + ", ".join(
        f"{s} {v:.4f} ms" for s, v in zip(K6_STAGES, t["k6_stages"]))
        + f"; sum {sum(t['k6_stages']):.4f} ms. K1 by stage: " + ", ".join(
        f"{s} {v:.4f} ms" for s, v in zip(K1_STAGES, t["k1_stages"]))
        + f"; sum {sum(t['k1_stages']):.4f} ms  [{card}]", flush=True)
    del x, a, a8, a_levels
    torch.cuda.empty_cache()
    return t


def time_int8attn_layers(name: str, L: int, ffn: int, device, card: str, B: int = 4096,
                         D: int = 128) -> dict:
    """K7 on one layer at [B, L, D] (H = 8) against its plain version and K1
    on the same weights, with its bound; no PyTorch call computes an
    int8-attention layer, so it has no library time."""
    ops = fel.layer_operands(random_layers(1, ffn, seed=13, device=device, D=D)[0], 8)
    x = torch.randn((B, L, D), generator=torch.Generator().manual_seed(3)).to(device,
                                                                             torch.bfloat16)
    qkv = (fel._mm(x, ops[0]) + ops[1]).to(torch.bfloat16)
    with torch.no_grad():
        t = {
            "k7_ms": cuda_ms(lambda: k7.fused_encoder_layer_int8attn(x, ops, 8), 20),
            "k7_plain_ms": cuda_ms(lambda: k7.fused_layer_int8attn_reference(x, ops, 8), 5,
                                   warmup=1),
            "k7_k1_ms": cuda_ms(lambda: fel.fused_encoder_layer(x, ops, 8), 20),
            "k7_core_ms": cuda_ms(lambda: k7.attention_int8(qkv, 8), 20),
            "k7_wgmma_ms": cuda_ms(lambda: k7.attention_int8(qkv, 8, core="wgmma"), 20),
            "k7_sync_ms": cuda_ms(lambda: k7.attention_int8(qkv, 8, core="sync"), 20),
            "k7_core_plain_ms": cuda_ms(lambda: k7.attention_int8_reference(qkv, 8), 3,
                                        warmup=1),
            "k1_core_ms": cuda_ms(lambda: fel.attention_core(qkv, 8), 20),
        }
    b = layer_bounds(B, L, ffn, D)
    t["k7"], t["k7_core"] = b["k7"], b["k7_core"]
    print(f"  {name} int8-attention layer B={B} L={L} F={ffn} D={D}: K7 {t['k7_ms']:.4f} ms vs "
          f"plain {t['k7_plain_ms']:.4f} ms vs K1 {t['k7_k1_ms']:.4f} ms (K7 bound "
          f"{t['k7'][0]:.4f} ms by {t['k7'][1]}; library none: no PyTorch call computes an "
          f"int8-attention layer); its int8 core alone ({k7.core_route(L)}, the layer's route) "
          f"{t['k7_core_ms']:.4f} ms (wgmma {t['k7_wgmma_ms']:.4f} ms, mma.sync "
          f"{t['k7_sync_ms']:.4f} ms) vs plain {t['k7_core_plain_ms']:.4f} ms vs K1's core "
          f"{t['k1_core_ms']:.4f} ms (bound {t['k7_core'][0]:.4f} ms by {t['k7_core'][1]})  "
          f"[{card}]", flush=True)
    del x, qkv
    torch.cuda.empty_cache()
    return t


# --------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work
# --------------------------------------------------------------------------

def bound(flops: float, nbytes: float, int8_ops: float = 0.0):
    """(ms, "operations" or "bytes"): the larger of the operations' time
    (bf16 FLOPs over the bf16 tensor-core peak plus int8 operations over the
    int8 peak) and the compulsory bytes over the HBM rate."""
    t_ops = (flops / PEAK_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gemm_flops(rows: int, D: int, F: int, kv_rows=None) -> float:
    """FLOPs of one layer's forward GEMMs for `rows` output rows: q for
    `rows`, k and v for `kv_rows` (default `rows`), out-projection, FFN."""
    kv_rows = rows if kv_rows is None else kv_rows
    return 2.0 * rows * D * D + 4.0 * kv_rows * D * D + 2.0 * rows * D * D + 4.0 * rows * D * F


def weight_bytes(D: int, F: int) -> float:
    """The 12 layer operands: bf16 matrices, f32 vectors."""
    return (4 * D * D + 2 * D * F) * 2.0 + (10 * D + F) * 4.0


def layer_bounds(B: int, L: int, F: int, D: int = 128, H: int = 8) -> dict:
    """Bounds of K1-K4 and K6 at [B, L, D] activations. Dropout, the LN and
    softmax arithmetic and K6's quantization add no tensor-core operations; a
    backward's GEMMs are twice the forward's (input and weight gradients),
    its attention 8 L^2 dh per frame-head (dP, dV, dQ, dK). K6: its GEMMs
    as int8 operations, its attention as bf16 FLOPs; its weights int8 with
    f32 scales, biases and LN parameters. `k6_ffn1` is K6's FFN1 stage
    alone (int8 levels and their scales in, bf16 hidden and each row's max
    out). K7: K1's GEMMs as bf16 FLOPs, its
    attention as int8 operations, the scores 2 L^2 dh and P [v | 1] 2 L^2
    (dh + 1) per frame-head (the function's one ones column; the TPU
    kernel pads [v | ones] to 2 dh for its MXU, which the function does not
    need)."""
    M, dh = B * L, D // H
    act = M * D * 2.0
    attn = 4.0 * B * H * L * L * dh
    fwd = gemm_flops(M, D, F) + attn
    attn_bwd = 8.0 * B * H * L * L * dh
    grads = (4 * D * D + 2 * D * F + 10 * D + F) * 4.0
    stash = 3 * act + 2 * M * 4.0 + B * H * L * L * 2.0
    int8_weights = (4 * D * D + 2 * D * F) * 1.0 + (14 * D + 2 * F) * 4.0
    return {
        "k6": bound(attn, 2 * act + int8_weights, int8_ops=gemm_flops(M, D, F)),
        "k6_ffn1": bound(0.0, M * D + M * 4.0 + M * F * 2.0 + M * 4.0 + D * F + 2 * F * 4.0,
                         int8_ops=2.0 * M * D * F),
        "k7": bound(gemm_flops(M, D, F), 2 * act + weight_bytes(D, F),
                    int8_ops=2.0 * B * H * L * L * (2 * dh + 1)),
        "k1": bound(fwd, 2 * act + weight_bytes(D, F)),
        "k2": bound(gemm_flops(B, D, F, kv_rows=M) + 4.0 * B * H * L * dh,
                    act + B * D * 2.0 + weight_bytes(D, F)),
        # K2 as it computes the layer, no K or V formed: q, qt (D^2 a frame),
        # the pooling's scores and mean (4 L H D), the V stage (D^2), the tail
        "k2_cls": bound(8.0 * B * D * D + 4.0 * B * H * L * D + 4.0 * B * D * F,
                        act + B * D * 2.0 + weight_bytes(D, F)),
        # K2's pooling kernel: x and qt read, xbar written
        "pool": bound(4.0 * B * H * L * D, act + 2 * B * H * D * 2.0),
        # K7's core alone: qkv read, out written, its s8 products
        "k7_core": bound(0.0, 4 * act, int8_ops=2.0 * B * H * L * L * (2 * dh + 1)),
        "k3f": bound(fwd, 2 * act + weight_bytes(D, F)),
        # the recompute regime: the forward again, then the gradients
        "k3b": bound(fwd + 2 * gemm_flops(M, D, F) + attn_bwd,
                     3 * act + grads + weight_bytes(D, F)),
        "k4f": bound(fwd, 2 * act + stash + weight_bytes(D, F)),
        # from the stash: qkv and the FFN hidden rebuilt, then the gradients
        "k4b": bound(2 * gemm_flops(M, D, F) + 6.0 * M * D * D + 2.0 * M * D * F + attn_bwd,
                     3 * act + stash + grads + weight_bytes(D, F)),
    }


def staged_floors(B: int, L: int, F: int, D: int = 128, H: int = 8) -> dict:
    """The staged byte floor of K3 and K4 (ms at the HBM rate): the bytes
    their stages move through device memory when each stage reads each of
    its inputs once and writes each of its outputs once (the intermediates
    the staged design keeps in device memory included: qkv, attn, x1, the FFN
    hidden, the f32 LN inputs and residual gradients, the row stats, the
    split-K partials and column-sum partials and their reductions, K4's
    stash). It sits above `layer_bounds`, which counts the layer's inputs and
    outputs only."""
    M = B * L
    b16, b32, hid, row = M * D * 2.0, M * D * 4.0, M * F * 2.0, M * 4.0
    stats, pbar = B * H * L * 2 * 4.0, B * H * L * L * 2.0
    splits = min(64, max(1, M // 2048))
    rt = (M + 63) // 64

    def wgrad(k1, n):  # act and grad read, partials written and read, the sum written
        return 2 * splits * k1 * n * 4.0 + k1 * n * 4.0

    def sums(n, s):  # column-sum partials written and read, the sums written
        return 2 * s * rt * n * 4.0 + s * n * 4.0

    w = weight_bytes(D, F)
    fwd = (4 * b16) + (4 * b16) + (3 * b16) + (b16 + hid) + (hid + 2 * b16)
    recompute = fwd - b16 + stats + 2 * (b32 + row)  # no y; the row stats, xh and 1/std
    grads = ((b16 + b32 + row) + (b16 + b32) + sums(D, 3)   # ln_bwd_rows
             + (hid + b16) + wgrad(F, D)                    # dW2
             + (b16 + 2 * hid) + sums(F, 1)                 # FFN2 input gradient
             + (b16 + hid) + wgrad(D, F)                    # dW1
             + (hid + 2 * b32 + row + b32 + b16) + sums(D, 3)  # FFN1 input gradient + LN1
             + (2 * b16) + wgrad(D, D)                      # dWo
             + (2 * b16)                                    # out-projection input gradient
             + (5 * b16 + stats + 3 * b16) + (2 * B + 1) * 3 * D * 4.0  # attention backward
             + (4 * b16) + wgrad(D, 3 * D)                  # dWqkv
             + (3 * b16 + b32 + b16))                       # QKV input gradient + dx
    stash = 2 * b16 + 2 * row + pbar
    k4_grads = grads - 2 * (b32 - b16) + pbar - stats        # bf16 xh; pbar for the row stats
    rebuild = 4 * b16 + 2 * b16 + (b16 + hid)                # qkv, x1, the FFN hidden
    floor = {"k3f": fwd + w, "k3b": recompute + grads + 2 * w, "k4f": fwd + stash + w,
             "k4b": rebuild + k4_grads + 2 * w}
    return {f"{k}_floor": v / PEAK_BYTES * 1e3 for k, v in floor.items()}


def attention_bounds(B: int, L: int, D: int = 128, H: int = 8) -> dict:
    """K5: forward 4 L^2 dh FLOPs per frame-head (Q K^T, P V), reading q, k, v
    and writing out and the f32 lse; backward 10 L^2 dh (S recomputed, dP,
    dV, dQ, dK), reading q, k, v, out, dout and the lse, writing dq, dk, dv."""
    dh, act, lse = D // H, B * L * D * 2.0, B * H * L * 4.0
    return {"k5f": bound(4.0 * B * H * L * L * dh, 4 * act + lse),
            "k5b": bound(10.0 * B * H * L * L * dh, 8 * act + lse)}


def attention_pass_bounds(B: int, L: int, D: int = 128, H: int = 8) -> dict:
    """K4's attention passes alone: the forward reads qkv and writes attn and
    pbar (B H L^2 bf16: the function's, without the stash's padding), 4 L^2
    dh FLOPs a frame-head (Q K^T, P V); the backward reads qkv, attn, dattn
    and pbar and writes dqkv (and a frame's column sums, 3D f32), 8 L^2 dh
    (dP, dQ, dK, dV)."""
    dh, act, pbar = D // H, B * L * D * 2.0, B * H * L * L * 2.0
    return {"fwd": bound(4.0 * B * H * L * L * dh, 3 * act + act + pbar),
            "bwd": bound(8.0 * B * H * L * L * dh,
                         3 * act + 2 * act + pbar + 3 * act + B * 3 * D * 4.0)}


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.split()[0]) * 1e6


def time_attention(device, card: str, B: int = 256, L: int = CONV1D_L, H: int = 8) -> dict:
    """K5-fwd and K5-bwd on one layer's attention at the conv1d train shape,
    against their plain versions and against the yardstick
    torch.nn.functional.scaled_dot_product_attention on [B, H, L, dh] bf16
    (forward, and backward alone on a kept graph), which the port never
    calls."""
    gen = torch.Generator().manual_seed(10)
    qkv = torch.randn((B, L, 384), generator=gen).to(device, torch.bfloat16)
    dout = (0.1 * torch.randn((B, L, 128), generator=gen)).to(device, torch.bfloat16)
    q, k, v = qkv.split(128, dim=-1)
    with torch.no_grad():
        out, lse = fa.fused_attention_fwd(q, k, v, H)
        t = {
            "k5f_ms": cuda_ms(lambda: fa.fused_attention_fwd(q, k, v, H), 20),
            "k5f_plain_ms": cuda_ms(lambda: fa.attention_plain(q, k, v, H), 3, warmup=1),
            "k5b_ms": cuda_ms(lambda: fa.fused_attention_bwd(q, k, v, out, lse, dout, H), 20),
            "k5b_plain_ms": cuda_ms(lambda: fa.attention_bwd_reference(q, k, v, out, dout, H),
                                    3, warmup=1),
        }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = [t_.reshape(B, L, H, 128 // H).transpose(1, 2).contiguous().requires_grad_(True)
             for t_ in (q, k, v)]
    dheads = dout.reshape(B, L, H, 128 // H).transpose(1, 2).contiguous()
    with torch.no_grad():
        t["sdpa_fwd_ms"] = cuda_ms(lambda: sdpa(*heads), 20)
    o = sdpa(*heads)
    t["sdpa_bwd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(o, heads, dheads, retain_graph=True), 20)
    t.update(attention_bounds(B, L, 128, H))
    exps = B * H * L * L
    t["sfu_ms"] = exps / (SFU_EXP2_PER_CLOCK_SM * N_SM * max_sm_clock_hz()) * 1e3
    print(f"  K5 attention B={B} L={L} H={H} d_head {128 // H}: K5-fwd {t['k5f_ms']:.4f} ms vs "
          f"plain {t['k5f_plain_ms']:.4f} ms vs SDPA {t['sdpa_fwd_ms']:.4f} ms (bound "
          f"{t['k5f'][0]:.4f} ms by {t['k5f'][1]}); K5-bwd {t['k5b_ms']:.4f} ms vs plain "
          f"{t['k5b_plain_ms']:.4f} ms vs SDPA backward {t['sdpa_bwd_ms']:.4f} ms (bound "
          f"{t['k5b'][0]:.4f} ms by {t['k5b'][1]}); fwd+bwd K5 {t['k5f_ms'] + t['k5b_ms']:.4f} "
          f"ms vs SDPA {t['sdpa_fwd_ms'] + t['sdpa_bwd_ms']:.4f} ms; {exps} exp2 per pass, "
          f"{t['sfu_ms']:.4f} ms at {SFU_EXP2_PER_CLOCK_SM}/clock/SM and the max SM clock  "
          f"[{card}]", flush=True)
    del qkv, dout, q, k, v, out, lse, heads, dheads, o
    torch.cuda.empty_cache()
    return t


def time_k1_library(name: str, L: int, ffn: int, device, card: str, batch: int = 4096,
                    D: int = 128) -> float:
    """The yardstick for K1: torch.nn.TransformerEncoderLayer (post-norm,
    ReLU, eps 1e-12, no dropout) in eval and no-grad bf16 on one layer's
    weights, which the port never calls; prints whether PyTorch took its
    fused fast path (the aten::_transformer_encoder_layer_fwd kernel) and its
    largest difference from K1."""
    layer = random_layers(1, ffn, seed=14, device=device, D=D)[0]
    lib = torch.nn.TransformerEncoderLayer(D, 8, ffn, dropout=0.0, batch_first=True,
                                           norm_first=False, layer_norm_eps=1e-12)
    att = layer.attention
    with torch.no_grad():
        lib.self_attn.in_proj_weight.copy_(torch.cat([att.w_q.weight, att.w_k.weight,
                                                      att.w_v.weight]))
        lib.self_attn.in_proj_bias.copy_(torch.cat([att.w_q.bias, att.w_k.bias, att.w_v.bias]))
        lib.self_attn.out_proj.weight.copy_(att.w_concat.weight)
        lib.self_attn.out_proj.bias.copy_(att.w_concat.bias)
        for mine, theirs in ((layer.ffn.linear1, lib.linear1), (layer.ffn.linear2, lib.linear2)):
            theirs.weight.copy_(mine.weight)
            theirs.bias.copy_(mine.bias)
        for mine, theirs in ((layer.norm1, lib.norm1), (layer.norm2, lib.norm2)):
            theirs.weight.copy_(mine.gamma)
            theirs.bias.copy_(mine.beta)
    lib = lib.to(device, torch.bfloat16).eval()
    x = torch.randn((batch, L, D), generator=torch.Generator().manual_seed(3))
    x = x.to(device, torch.bfloat16)
    with torch.no_grad():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            y = lib(x)
        fast = any("_transformer_encoder_layer_fwd" in e.key for e in prof.key_averages())
        diff = (y.float() - fel.fused_encoder_layer(x, fel.layer_operands(layer, 8), 8).float())
        ms = cuda_ms(lambda: lib(x), 20)
    print(f"  {name} layer B={batch} L={L} F={ffn} D={D}: nn.TransformerEncoderLayer {ms:.4f} ms "
          f"(fused fast path taken: {fast}; max |it - K1| {diff.abs().max().item():.6g})  "
          f"[{card}]", flush=True)
    del lib, x, y, diff
    torch.cuda.empty_cache()
    return ms


def time_train_library(name: str, L: int, ffn: int, device, card: str, t: dict,
                       batch: int = 4096, D: int = 128, H: int = 8) -> float:
    """The yardstick for K3's and K4's forward + backward (in `t`, from
    `time_train_layers`): torch.nn.TransformerEncoderLayer (post-norm, ReLU,
    eps 1e-12, dropout 0) in training mode and bf16, its forward and then
    the gradients of x and of its weights from one output gradient, which
    the port never calls. Its dropout (none) is not vitiq's training layer's,
    so it is a yardstick of speed, not a parity check."""
    lib = torch.nn.TransformerEncoderLayer(D, H, ffn, dropout=0.0, batch_first=True,
                                           norm_first=False, layer_norm_eps=1e-12)
    lib = lib.to(device, torch.bfloat16).train()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((batch, L, D), generator=gen).to(device, torch.bfloat16).requires_grad_(True)
    dy = (0.1 * torch.randn((batch, L, D), generator=gen)).to(device, torch.bfloat16)

    def one():
        lib.zero_grad(set_to_none=True)
        x.grad = None
        lib(x).backward(dy)

    ms = cuda_ms(one, 10)
    line = f"  {name} train layer B={batch} L={L} F={ffn} D={D} H={H}: " \
           f"nn.TransformerEncoderLayer training forward + backward {ms:.4f} ms"
    for kernel in ("k3", "k4"):
        if f"{kernel}f_ms" in t:
            line += (f"; {kernel.upper()}-fwd + {kernel.upper()}-bwd "
                     f"{t[f'{kernel}f_ms'] + t[f'{kernel}b_ms']:.4f} ms")
    print(line + f"  [{card}]", flush=True)
    del lib, x, dy
    torch.cuda.empty_cache()
    return ms


# --------------------------------------------------------------------------
# the probes (P1-P3): the TPU lowering and cost probes' counterparts
# --------------------------------------------------------------------------

PROBES_SOURCE = "vitiq_torch/csrc/probes.cu"
# the TPU probes' kernels (file:line of each kernel function)
P1_TPU_LINES = dict(zip(mask_ops.VARIANTS + mask_ops.MM_VARIANTS,
                        (26, 30, 35, 40, 46, 51, 56, 97, 101, 105, 110)))
P1_TPU_SOURCE = "scripts/tpu_probe_mask_ops.py"
P2_TPU = "scripts/tpu_probe_refcost.py:38"
P3_TPU = "scripts/tpu_probe_exp.py:26"
# P2 at 205 grid steps of G = 40: the reference's defaults (8192, 40) fail
# its own check that G divide the batch.
REFCOST_ARGS = (8200, 40, 16)
# P3 against its plain version (`p3.check_layer`, `p3.check_core`): at every
# P3 shape its layer over the rows whose sums of scores are not small beside
# their magnitudes, its attention core alone on the same qkv row by row; and
# its layer over all rows here. At rawiq_best's seeded batch the layer's
# all-rows relative L2 rests on one frame row whose denominator's sign the
# bf16 rounding of qkv decides: it is printed there, with that row.
P3_ALL_ROWS = ("vit", "conv1d")
# P3's stacks (6 layers) beside K1's: the TPU probe's own shape, and where K1
# loses to nn.TransformerEncoderLayer (conv1d, rawiq_best):
# (name, B, L, D, F, H)
P3_SHAPES = (("vit", 8192, 129, 128, 512, 8), ("conv1d", 256, CONV1D_L, 128, 1024, 8),
             ("rawiq_best", 4096, 65, 256, 1024, 8))
K1_STAGES = ("QKV", "attention", "out-proj + LN1", "FFN1", "FFN2 + LN2")
# a K1 call's five kernels, told by template and order: the QKV GEMM (bias
# epilogue), the attention core, out-proj + LN1 (LN epilogue), FFN1 (bias
# epilogue with ReLU), FFN2 + LN2
K1_KINDS = ["bias", "attention", "ln", "bias", "ln"]


def k1_kind(name: str) -> str:
    if "attention_core_kernel" in name:
        return "attention"
    if "gemm_wgmma_kernel<0," in name:
        return "bias"
    return "ln" if "gemm_wgmma_kernel<2," in name else name


def check_probe_builds() -> None:
    """The `ptxas -v` lines of the probes' kernels and of K1's attention
    kernel with and without the NOEXP flag; fails if a probe kernel spills
    or K1's attention kernels' registers moved."""
    for name in mask_ops.VARIANTS + mask_ops.MM_VARIANTS:
        regs, stores, loads = mask_ops.kernel_resources(name)
        print(f"  ptxas {name}: {regs} registers, {stores + loads} bytes spilled", flush=True)
        if stores or loads:
            raise AssertionError(f"probe kernel {name} spills")
    regs, stores, loads = _build.kernel_resources("probes", "refcost_kernel")
    print(f"  ptxas refcost_kernel: {regs} registers, {stores + loads} bytes spilled", flush=True)
    if stores or loads:
        raise AssertionError("refcost_kernel spills")
    for dh, regs in fel.K1_ATTENTION_REGISTERS.items():
        k1 = _build.kernel_resources("fused_encoder_layer", fel.attention_kernel_tag(dh))
        noexp = _build.kernel_resources("fused_encoder_layer", fel.attention_kernel_tag(dh, True))
        print(f"  ptxas attention_core_kernel<{dh}, false> (K1): {k1}; <{dh}, true> (P3): {noexp} "
              f"(registers, spill stores, spill loads; K1's stated: {regs})", flush=True)
        if k1 != (regs, 0, 0) or noexp[1:] != (0, 0):
            raise AssertionError(f"K1's attention core <{dh}> changed or spills: {k1}, P3 {noexp}")
    check_k1_spills()


def check_k1_spills() -> None:
    """Every instance of K1's wgmma GEMM stage and one-pass attention core in
    the build's `ptxas -v` report: printed, and none may spill."""
    entries = _build.ptxas_entries(_build.ptxas_report("fused_encoder_layer"))
    mine = {n: v for n, v in entries.items()
            if "gemm_wgmma_kernel" in n or "attention_core_kernel" in n}
    if len(mine) < 10:
        raise AssertionError(f"{len(mine)} of K1's kernels in the ptxas report")
    for name, (regs, stores, loads) in sorted(mine.items()):
        short = name[name.index("gemm_wgmma" if "gemm_wgmma" in name else "attention_core"):]
        print(f"  ptxas {short.split('EEEv')[0]}: {regs} registers, {stores + loads} bytes spilled",
              flush=True)
    spilled = [n for n, (_, stores, loads) in mine.items() if stores or loads]
    if spilled:
        raise AssertionError(f"K1's kernels spill: {spilled}")


def check_noexp_sass() -> None:
    """In the built library's SASS (cuobjdump, beside nvcc): K1's one-pass
    core (attention_core_kernel<DH, false>) runs its products on HGMMA and
    its exp2 on MUFU.EX2; P3's instance (NOEXP) keeps every FMNMX (the
    running max) of K1's and has no MUFU.EX2; every instance of K1's GEMM
    stage (gemm_wgmma_kernel) runs HGMMA."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.build())], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    bodies = dict(block.split("\n", 1) for block in sass.split("Function : ")[1:])
    for dh in fel.K1_ATTENTION_REGISTERS:
        k1 = [b for n, b in bodies.items() if fel.attention_kernel_tag(dh) in n]
        noexp = [b for n, b in bodies.items() if fel.attention_kernel_tag(dh, True) in n]
        if len(k1) != 1 or len(noexp) != 1:
            raise AssertionError(f"attention core <{dh}>: {len(k1)} and {len(noexp)} SASS bodies")
        fmnmx, ex2, hgmma = ((k1[0].count(op), noexp[0].count(op))
                             for op in ("FMNMX", "MUFU.EX2", "HGMMA"))
        print(f"  SASS attention_core_kernel<{dh}>: FMNMX {fmnmx[0]} (K1) / {fmnmx[1]} (P3), "
              f"MUFU.EX2 {ex2[0]} / {ex2[1]}, HGMMA {hgmma[0]} / {hgmma[1]}", flush=True)
        if fmnmx[1] != fmnmx[0] or ex2[1] or not ex2[0]:
            raise AssertionError(f"P3's core <{dh}> lost its max or kept an exp2, or K1's core "
                                 f"has no MUFU.EX2")
        if not hgmma[0] or not hgmma[1]:
            raise AssertionError(f"the attention core <{dh}> runs no HGMMA")
    gemms = {n: b.count("HGMMA") for n, b in bodies.items() if "gemm_wgmma_kernel" in n}
    print(f"  SASS gemm_wgmma_kernel: {len(gemms)} instances, HGMMA in each: "
          f"{sorted(set(gemms.values()))}", flush=True)
    if len(gemms) < 6 or not all(gemms.values()):
        raise AssertionError("a GEMM stage of K1 runs no HGMMA")


def drive_probes(device, card: str) -> dict:
    """The probes' main path: each probe's entry point as its command line
    runs it (`mask_ops.main` on all 11 variants, `refcost.measure` at
    REFCOST_ARGS, `exp.time_stacks` at P3_SHAPES), every probe launch counter
    reset just before and read just after."""
    for module in (mask_ops, refcost, p3):
        module.reset_launches()
    print("  python -m vitiq_torch.probes.mask_ops (the seven elementwise variants and the "
          "mm_* ones):", flush=True)
    p1_err = mask_ops.report(mask_ops.VARIANTS + mask_ops.MM_VARIANTS, device)
    if None in p1_err.values():
        raise AssertionError("a P1 variant failed")
    print(f"  python -m vitiq_torch.probes.refcost {' '.join(map(str, REFCOST_ARGS))}:",
          flush=True)
    refcost_rows = refcost.measure(*REFCOST_ARGS, device=device)
    stacks = {}
    for name, B, L, D, F, H in P3_SHAPES:
        t = p3.time_stacks(B, L, D, F, H, device)
        stacks[name] = t
        print(f"  python -m vitiq_torch.probes.exp {B} {L} {D} {F} {H} ({name}): no-exp "
              f"{p3.N_LAYERS}-layer stack {t['noexp_ms']:.4f} ms/batch, K1's "
              f"{t['k1_ms']:.4f} ms/batch: the exp is {t['exp_share']:.4f} of K1's time  "
              f"[{card}]", flush=True)
    return {"p1": dict(mask_ops.launches), "p2": dict(refcost.launches),
            "p3": p3.launches["fused_encoder_layer_noexp"], "p1_err": p1_err,
            "refcost": refcost_rows, "stacks": stacks}


def device_ms(fn, calls: int = 100) -> float:
    """The device time of one call of fn(): its kernels' own time under
    `torch.profiler` over `calls` back-to-back calls after a warm-up, summed
    and divided by `calls`. The host's time between launches does not count
    (`cuda_ms` counts it where the host is slower than the kernel)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(200_000)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(device_us(e) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
             and e.time_range.start >= 0 and "spin_kernel" not in e.name)
    return us / calls / 1e3


def check_probes(device, card: str, probes: dict) -> dict:
    """Each probe kernel against its plain version beside the main path's
    readings in `probes` (P1's errors as `mask_ops.report` took them; P2
    each arm bit for bit against ``in + 1``; P3 by `p3.check_layer` and
    `p3.check_core` at each P3 shape), and each one's time per launch beside
    its plain version, its bound and a PyTorch call that computes the same
    function where there is one (P2's kernel time is `refcost.measure`'s).
    P1's and P2's kernels run for a microsecond or less, under the host's
    cost of a wrapper call: each is also timed by its device time alone
    (`device_ms`), beside the PyTorch call's device time."""
    out = {}
    args = mask_ops.inputs(device)
    for name in mask_ops.VARIANTS + mask_ops.MM_VARIANTS:
        err = probes["p1_err"][name]
        mm = name.startswith("mm_")
        fn = (lambda: mask_ops.mm_mask(name, args["xm"], args["w"])) if mm else (
            lambda: mask_ops.mask_op(name, args["x"]))
        x, n = args["x"], args["x"].numel()
        if mm:
            nbytes = (args["xm"].numel() + args["w"].numel()) * 2.0 + n * 4.0
            bnd = bound(2.0 * n * mask_ops.K, nbytes)
            library_ms = None  # no one call takes bf16 operands to an f32 product plus a mask
        else:
            bnd = bound(0.0, 2 * n * 4.0)
            row = None if name == "exp2" else mask_ops.mask_row(name, device)
            library_ms = cuda_ms((lambda: torch.exp2(x)) if row is None else
                                 (lambda: torch.add(x, row)), 200)
        library_device_ms = None if mm else device_ms(
            (lambda: torch.exp2(x)) if row is None else (lambda: torch.add(x, row)))
        out[name] = {"err": err, "ms": cuda_ms(fn, 200),
                     "plain_ms": cuda_ms(lambda: mask_ops.reference(name, args), 200),
                     "bound": bnd, "library_ms": library_ms, "device_ms": device_ms(fn),
                     "library_device_ms": library_device_ms}
        print(f"  P1 {name}: max |kernel - plain| = {err:.6g}; {out[name]['ms']:.4f} ms a "
              f"launch vs plain {out[name]['plain_ms']:.4f} ms"
              + ("" if library_ms is None else f" vs one PyTorch call {library_ms:.4f} ms")
              + f" (bound {bnd[0]:.6f} ms by {bnd[1]}); device time {out[name]['device_ms']:.6f}"
              + ("" if mm else f" ms vs the PyTorch call's {library_device_ms:.6f}")
              + f" ms  [{card}]", flush=True)

    batch, g, nr = REFCOST_ARGS
    for (tag, nrefs, width), row in zip(refcost.arms(nr), probes["refcost"], strict=True):
        xs = refcost.arm_inputs(nrefs, width, batch, device)
        got, want = refcost.refcost(xs, g), refcost.refcost_reference(xs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"P2 {tag}: the kernel's in + 1 differs from the plain version's")
        del got, want
        library = "torch._foreach_add" if nrefs > 1 else "x + 1"
        # the plain version and the PyTorch call timed as `measure` timed the kernel alone
        t = {"err": 0.0, "ms": row["kernel_ms"],
             "plain_ms": time_amortized(lambda seed, *xs: refcost.refcost_reference(xs), xs) * 1e3,
             "library_ms": time_amortized((lambda seed, *xs: torch._foreach_add(xs, 1))
                                          if nrefs > 1 else (lambda seed, x: x + 1), xs) * 1e3,
             "bound": bound(0.0, 2.0 * sum(x.numel() for x in xs) * 2),
             "device_ms": device_ms(lambda: refcost.refcost(xs, g)),
             "library_device_ms": device_ms((lambda: torch._foreach_add(xs, 1)) if nrefs > 1
                                            else (lambda: xs[0] + 1))}
        print(f"  P2 {tag} ({2 * nrefs} operands of width {width}): bit for bit; kernel "
              f"{t['ms']:.4f} ms vs plain {t['plain_ms']:.4f} ms vs {library} "
              f"{t['library_ms']:.4f} ms (bound {t['bound'][0]:.4f} ms by {t['bound'][1]}); "
              f"{t['ms'] / (batch // g) * 1e3:.4f} us a block; device time {t['device_ms']:.4f} "
              f"ms vs {library}'s {t['library_device_ms']:.4f} ms  [{card}]", flush=True)
        out[tag] = t
        del xs
        torch.cuda.empty_cache()

    for name, _, L, D, F, H in P3_SHAPES:
        B = 32 if L == CONV1D_L else 256
        ops = p3.stack_operands(1, D, F, H, device, seed=3)[0]
        x = torch.randn((B, L, D), generator=torch.Generator().manual_seed(1))
        x = x.to(device, torch.bfloat16)
        layer = p3.check_layer(x, ops, H, all_rows=name in P3_ALL_ROWS)
        with torch.no_grad():
            core = p3.check_core((fel._mm(x, ops[0]) + ops[1]).to(torch.bfloat16), H)
        print(f"  P3 {name} layer B={B} L={L} D={D} H={H}: ||kernel - plain|| / ||plain|| "
              f"{layer['rel_held']:.6g} over the {layer['held']:.4f} of rows held in every head "
              f"(limit {p3.LAYER_REL}), {layer['rel']:.6g} over all rows ("
              + (f"limit {p3.LAYER_REL}" if name in P3_ALL_ROWS else "printed, not gated")
              + f"); max |kernel - plain| {layer['max_abs']:.6g}; worst row "
              f"{layer['worst_row_rel']:.6g} at conditioning {layer['worst_row_cond']:.3g}. Its "
              f"core on the same qkv: worst held row {core['row_rel_held']:.6g} (limit "
              f"{p3.CORE_ROW_REL}; {core['held']:.4f} of rows held, conditioning >= "
              f"{p3.COND_FLOOR}), {core['rel']:.6g} over all rows", flush=True)
        if name == "vit":
            out["p3_err"] = layer["max_abs"]
        del x
        torch.cuda.empty_cache()

    ops = p3.stack_operands(1, 128, 512, 8, device, seed=13)[0]
    x = torch.randn((4096, 129, 128), generator=torch.Generator().manual_seed(3))
    x = x.to(device, torch.bfloat16)
    with torch.no_grad():
        out["p3"] = {"ms": cuda_ms(lambda: p3.fused_encoder_layer_noexp(x, ops, 8), 20),
                     "plain_ms": cuda_ms(lambda: p3.fused_layer_noexp_reference(x, ops, 8), 5,
                                         warmup=1),
                     "k1_ms": cuda_ms(lambda: fel.fused_encoder_layer(x, ops, 8), 20),
                     "bound": layer_bounds(4096, 129, 512)["k1"]}
    print(f"  P3 vit layer B=4096 L=129: no-exp {out['p3']['ms']:.4f} ms vs plain "
          f"{out['p3']['plain_ms']:.4f} ms vs K1 {out['p3']['k1_ms']:.4f} ms (bound K1's, "
          f"{out['p3']['bound'][0]:.4f} ms by {out['p3']['bound'][1]}; library none: no "
          f"PyTorch call computes it)  [{card}]", flush=True)
    del x
    torch.cuda.empty_cache()
    return out


def profile_k1_stages(name: str, B: int, L: int, D: int, F: int, H: int, device, card: str,
                      calls: int = 20) -> dict:
    """K1's time by stage: `torch.profiler` over `calls` layer calls of K1
    and of P3 (K1 without its exp) at [B, L, D], the five stage kernels of
    each call in launch order (QKV, attention, out-proj + LN1, FFN1, FFN2 +
    LN2). Prints each stage's ms and share, and the exp's share of the
    attention stage and of the layer."""
    ops = p3.stack_operands(1, D, F, H, device, seed=13)[0]
    x = torch.randn((B, L, D), generator=torch.Generator().manual_seed(3)).to(device,
                                                                             torch.bfloat16)
    split = {}
    with torch.no_grad():
        for label, layer in (("K1", fel.fused_encoder_layer),
                             ("no-exp", p3.fused_encoder_layer_noexp)):
            stages = profile_stages(lambda: layer(x, ops, H), K1_KINDS, k1_kind, calls)
            split[label] = stages
            total = sum(stages)
            print(f"  {name} {label} layer B={B} L={L} D={D} F={F} by stage (torch.profiler): "
                  + ", ".join(f"{s} {t:.4f} ms ({t / total:.3f})"
                              for s, t in zip(K1_STAGES, stages))
                  + f"; sum {total:.4f} ms  [{card}]", flush=True)
    k1, ne = split["K1"], split["no-exp"]
    split["exp_share_attention"] = (k1[1] - ne[1]) / k1[1]
    split["exp_share_layer"] = (sum(k1) - sum(ne)) / sum(k1)
    print(f"  {name}: the exp is {split['exp_share_attention']:.4f} of K1's attention stage and "
          f"{split['exp_share_layer']:.4f} of its layer  [{card}]", flush=True)
    del x
    torch.cuda.empty_cache()
    return split


# K3-bwd's GEMM stages in launch order, by epilogue (the weight gradients,
# all `partial`, by their order).
K3_GEMM_STAGES = [stage for stage, _, _, _ in flt.stage_plan(128, 512)]
# K3-fwd's and K4-fwd's GEMM stages (the forward's four) and K4-bwd's (the
# rebuilt QKV and FFN1, then the gradient stages), in launch order
K3_FWD_GEMM_STAGES = K4_FWD_GEMM_STAGES = K3_GEMM_STAGES[:4]
K4_BWD_GEMM_STAGES = [K3_GEMM_STAGES[0], K3_GEMM_STAGES[2], *K3_GEMM_STAGES[4:]]


def kernel_name(name: str) -> str:
    """A kernel's function name, from the profiler's demangled signature."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return (base.split() or [name])[-1].split("::")[-1]


def profile_layer_stages(label: str, call, gemm_stages, calls: int) -> dict:
    """One layer call's time by stage: `profile_whole_calls` over calls of
    `call`, each call's kernels told apart by kernel and order (its GEMM
    stages, `train_gemm_kernel`, in the order of `gemm_stages`; every other
    kernel by its function name). A call starts at its QKV stage and is whole
    when it holds every GEMM stage. Returns ms a call by stage, averaged over
    the calls held whole."""

    def split(kernels):
        starts = [i for i, e in enumerate(kernels) if "train_gemm_kernel<0," in e.name]
        held = []
        for i, j in zip(starts, starts[1:] + [len(kernels)]):
            gemms = [e for e in kernels[i:j] if "train_gemm_kernel<" in e.name]
            if len(gemms) != len(gemm_stages):
                continue
            stages = dict.fromkeys(gemm_stages, 0.0)
            for stage, e in zip(gemm_stages, gemms):
                stages[stage] += device_us(e)
            for e in kernels[i:j]:
                if "train_gemm_kernel<" not in e.name:
                    kind = kernel_name(e.name)
                    stages[kind] = stages.get(kind, 0.0) + device_us(e)
            held.append(stages)
        return held

    with torch.no_grad():
        whole = profile_whole_calls(call, calls, split, label)
    out = {}
    for stages in whole:
        for k, v in stages.items():
            out[k] = out.get(k, 0.0) + v
    return {k: v / len(whole) / 1e3 for k, v in out.items()}


def print_split(label: str, split: dict, card: str) -> None:
    total = sum(split.values())
    print(f"  {label} by stage (torch.profiler): "
          + ", ".join(f"{k} {v:.4f} ms ({v / total:.3f})" for k, v in split.items())
          + f"; sum {total:.4f} ms  [{card}]", flush=True)


def profile_k3_stages(name: str, B: int, L: int, D: int, F: int, H: int, drop: float, device,
                      card: str, calls: int = 10) -> dict:
    """K3-fwd's and K3-bwd's time by stage (`profile_layer_stages`): K3-fwd's
    four GEMM stages, K3-bwd's twelve in `flt.stage_plan`'s order (the
    recompute's four first, then each weight gradient before its input
    gradient); then every other kernel of a call by name (the attention
    passes, LN2's backward rows, the fixed-order reductions)."""
    ops = train_operands(F, 13, device, D, H)
    x, dy = train_inputs(torch.Generator().manual_seed(4), B, L, D, device)
    args = (H, drop, TRAIN_SEED, 0)
    out = {}
    for kind, call, stages in (
            ("fwd", lambda: flt.fused_train_layer_fwd(x, ops, *args), K3_FWD_GEMM_STAGES),
            ("bwd", lambda: flt.fused_train_layer_bwd(x, dy, ops, *args), K3_GEMM_STAGES)):
        label = f"{name} K3-{kind} B={B} L={L} D={D} F={F} H={H}"
        out[kind] = profile_layer_stages(label, call, stages, calls)
        print_split(label, out[kind], card)
    del x, dy, ops
    torch.cuda.empty_cache()
    return out


def profile_k4_stages(name: str, B: int, L: int, D: int, F: int, H: int, drop: float, device,
                      card: str, calls: int = 10) -> dict:
    """K4-fwd's and K4-bwd's time by stage (`profile_layer_stages`): K4-fwd's
    four GEMM stages; K4-bwd's ten GEMM stages (the rebuilt QKV and FFN1,
    then each weight gradient before its input gradient); then every other
    kernel of a call by name (K4-fwd's attention pass, which writes pbar;
    K4-bwd's attention backward on the stashed pbar, the rebuild of x1,
    LN2's backward rows, the fixed-order reductions)."""
    ops = train_operands(F, 13, device, D, H)
    x, dy = train_inputs(torch.Generator().manual_seed(4), B, L, D, device)
    args = (H, drop, TRAIN_SEED, 0)
    out = {}
    with torch.no_grad():
        _, st = flt.fused_train_layer_fwd_stash(x, ops, *args)
    for kind, call, stages in (
            ("fwd", lambda: flt.fused_train_layer_fwd_stash(x, ops, *args), K4_FWD_GEMM_STAGES),
            ("bwd", lambda: flt.fused_train_layer_bwd_stash(x, dy, st, ops, *args),
             K4_BWD_GEMM_STAGES)):
        label = f"{name} K4-{kind} B={B} L={L} D={D} F={F} H={H}"
        out[kind] = profile_layer_stages(label, call, stages, calls)
        print_split(label, out[kind], card)
    del x, dy, ops, st
    torch.cuda.empty_cache()
    return out


def time_k4(device, card: str) -> dict:
    """`--k4`: K4-fwd and K4-bwd a layer at the four shapes K4 trains (K3 too
    at the rawIQ flagship's and vit_tiny_2016's), K3 at the other training
    shapes, K4 by stage at rawIQ and rawiq_best_mp, K4's host time at
    vit_tiny_2016's shape (`time_k4_host`), and the train steps
    through K4 (vit_tiny_2016, the rawIQ flagship, rawiq_best_mp) and the
    rawIQ flagship's through K3, all at B=4096. Uses no wrapper of K4's
    passes alone, so that it runs in a tree of the port from before them
    too."""
    out = {"layers": {}}
    for name, L, ffn, drop, D, H, stash, k3 in (
            ("rawiq", 65, 1024, RAW_DROP, 128, 8, True, True),
            ("rawiq_best_mp", 64, 1024, BEST_DROP, 256, 8, True, False),
            ("rawIQ flagship at n_head 2", 65, 1024, RAW_DROP, 128, 2, True, False),
            ("vit_tiny_2016", 17, 256, TRAIN_DROP, 64, 4, True, True),
            ("vit", 129, 512, TRAIN_DROP, 128, 8, False, True),
            ("rawiq_best", 65, 1024, BEST_DROP, 256, 8, False, True),
            ("vit_tpu_production", 129, 512, TRAIN_DROP, 128, 2, False, True)):
        t = time_train_layers(name, L, ffn, drop, device, card, stash, D=D, k3=k3, H=H)
        out["layers"][name] = {k: v for k, v in t.items() if k.endswith("_ms")}
    out["k4_stages"] = {name: profile_k4_stages(name, 4096, L, D, F, H, drop, device, card)
                        for name, L, D, F, H, drop in (
                            ("rawiq", 65, 128, 1024, 8, RAW_DROP),
                            ("rawiq_best_mp", 64, 256, 1024, 8, BEST_DROP))}
    out["k4_host"] = time_k4_host(device, card)
    raw = flagship_rawiq_config("tpu")
    out["steps"] = {label: time_train_step(label, cfg, stats, 4096, device, card, 20, env)
                    for label, cfg, stats, env in (
                        ("vit_tiny_2016 (K4 kernels)", vit_tiny_2016_config("tpu"), STATS, None),
                        ("rawiq flagship (K4 kernels)", raw, RAW_STATS, None),
                        ("rawiq_best_mp (K4 kernels)", rawiq_best_mp_config("tpu"), RAW_STATS,
                         None),
                        ("rawiq flagship (K3 kernels, VITIQ_TRAIN_STASH=0)", raw, RAW_STATS,
                         {"VITIQ_TRAIN_STASH": "0"}))}
    return out


# K3's training shapes for `--k3`: (name, L, FFN, dropout, D, H)
K3_TRAIN_SHAPES = (("vit", 129, 512, TRAIN_DROP, 128, 8),
                   ("rawiq_best", 65, 1024, BEST_DROP, 256, 8),
                   ("vit_tpu_production", 129, 512, TRAIN_DROP, 128, 2),
                   ("rawiq (VITIQ_TRAIN_STASH=0)", 65, 1024, RAW_DROP, 128, 8))


def time_k3(device, card: str) -> dict:
    """`--k3`: K3-fwd and K3-bwd a layer at the shapes K3 trains
    (K3_TRAIN_SHAPES: the ViT flagship, rawiq_best, vit_tpu_production, the
    rawIQ flagship's under VITIQ_TRAIN_STASH=0) beside their plain versions,
    each by stage (`profile_k3_stages`), and the train steps through K3 at
    those configurations, all at B=4096. Uses no wrapper of K3's passes
    alone, so that it runs in a tree of the port from before them too."""
    out = {"layers": {}, "stages": {}}
    for name, L, ffn, drop, D, H in K3_TRAIN_SHAPES:
        t = time_train_layers(name, L, ffn, drop, device, card, False, D=D, H=H)
        out["layers"][name] = {k: v for k, v in t.items() if k.endswith("_ms")}
        out["stages"][name] = profile_k3_stages(name, 4096, L, D, ffn, H, drop, device, card)
    raw = flagship_rawiq_config("tpu")
    out["steps"] = {label: time_train_step(label, cfg, stats, 4096, device, card, 20, env)
                    for label, cfg, stats, env in (
                        ("vit flagship (K3 kernels)", flagship_vit_config("tpu"), STATS, None),
                        ("rawiq_best (K3 kernels)", rawiq_best_config("tpu"), RAW_STATS, None),
                        ("vit_tpu_production (K3 kernels)", VIT_TPU_PRODUCTION, STATS, None),
                        ("rawiq flagship (K3 kernels, VITIQ_TRAIN_STASH=0)", raw, RAW_STATS,
                         {"VITIQ_TRAIN_STASH": "0"}))}
    return out


# K2's kernels a call, in launch order: its stages, and their kinds
# (`stage_kind`); in a tree where K2 still formed K and V (an earlier tree
# under --k2k7): q, K and V for every row, its two-pass core, the tail
K2_STAGES = ("q", "qt", "pool", "V", "out-proj + LN1", "FFN1", "FFN2 + LN2")
K2_KINDS = ["bias", "bias", "attention", "bias", "ln", "bias", "ln"]
K2_STAGES_KV = ("q", "K and V", "attention", "out-proj + LN1", "FFN1", "FFN2 + LN2")
K2_KINDS_KV = ["bias", "bias", "attention", "ln", "bias", "ln"]


def stage_kind(name: str) -> str:
    """A layer's kernel by kind: a bf16 GEMM stage by its epilogue, any
    attention core or the pooling kernel as "attention"."""
    if "gemm_wgmma_kernel<0," in name:
        return "bias"
    if "gemm_wgmma_kernel<2," in name:
        return "ln"
    return "attention" if "attention" in name or "cls_pool" in name else name


def profile_k2_k7_stages(name: str, B: int, L: int, D: int, F: int, H: int, device,
                         card: str, calls: int = 20) -> dict:
    """K2's and K7's time by stage at [B, L, D] (`profile_stages`): K2's
    seven kernels (q, qt, pool, V, out-proj + LN1, FFN1, FFN2 + LN2; six
    with K and V in a tree from before it pooled x), K7's five (QKV, its int8
    core, out-proj + LN1, FFN1, FFN2 + LN2)."""
    ops = fel.layer_operands(random_layers(1, F, seed=13, device=device, D=D, H=H)[0], H)
    pooled = hasattr(fel, "cls_operands")
    cls_ops = fel.cls_operands(ops, H) if pooled else ops
    stages, kinds = (K2_STAGES, K2_KINDS) if pooled else (K2_STAGES_KV, K2_KINDS_KV)
    x = torch.randn((B, L, D), generator=torch.Generator().manual_seed(3)).to(device,
                                                                             torch.bfloat16)
    with torch.no_grad():
        k2 = profile_stages(lambda: fel.fused_encoder_layer_cls(x, cls_ops, H), kinds, stage_kind,
                            calls)
        k7s = profile_stages(lambda: k7.fused_encoder_layer_int8attn(x, ops, H), K1_KINDS,
                             stage_kind, calls)
    for label, names, split in (("K2", stages, k2), ("K7", K1_STAGES, k7s)):
        total = sum(split)
        print(f"  {name} {label} layer B={B} L={L} D={D} F={F} H={H} by stage (torch.profiler): "
              + ", ".join(f"{s} {v:.4f} ms ({v / total:.3f})" for s, v in zip(names, split))
              + f"; sum {total:.4f} ms  [{card}]", flush=True)
    del x
    torch.cuda.empty_cache()
    return {"k2_stages": dict(zip(stages, k2)), "k7_stages": dict(zip(K1_STAGES, k7s))}


# K2's and K7's timed shapes: (name, L, FFN, D, H, B)
K2K7_SHAPES = (("vit", 129, 512, 128, 8, 4096), ("rawiq", 65, 1024, 128, 8, 4096),
               ("conv1d", CONV1D_L, 1024, 128, 8, 256), ("rawiq_best", 65, 1024, 256, 8, 4096))


# K7's core in each form over L (--k2k7, where the tree has both): the
# lengths about the route's edge (96 tokens), at d_head 16 and 32
K7_SWEEP_L = (17, 33, 49, 65, 81, 96, 97, 113, 128, 129, 145, 161, 193, 257)


def time_k7_forms(device, card: str, B: int = 4096) -> dict:
    """K7's two core forms alone (CUDA events) at each L of K7_SWEEP_L,
    d_model 128 and 256 with 8 heads (d_head 16 and 32): the times the
    route by L (`k7.core_route`) rests on."""
    out = {}
    for D in (128, 256):
        for L in K7_SWEEP_L:
            qkv = torch.randn((B, L, 3 * D), generator=torch.Generator().manual_seed(L)).to(
                device, torch.bfloat16)
            with torch.no_grad():
                t = {form: cuda_ms(lambda: k7.attention_int8(qkv, 8, core=form), 20)
                     for form in ("wgmma", "sync")}
            out[f"d{D}_L{L}"] = t
            print(f"  K7 core forms B={B} L={L} D={D} H=8: wgmma {t['wgmma']:.4f} ms, mma.sync "
                  f"{t['sync']:.4f} ms (route: {k7.core_route(L)})  [{card}]", flush=True)
            del qkv
    torch.cuda.empty_cache()
    return out


def time_int8attn_serving(device, card: str) -> dict:
    """Serving under VITIQ_ATTN_INT8=1 (K7 on the full layers, K2 on the
    CLS row) and in bf16 (K1 + K2), frames/s by CUDA events, at the four
    arms (B=4096, conv1d 2048), random weights: only public entry points,
    so it runs in an earlier tree too (--k2k7)."""
    out = {}
    for label, model_cfg, stats, batch in (
            ("vit", flagship_vit_config("tpu"), STATS, 4096),
            ("rawiq", flagship_rawiq_config("tpu"), RAW_STATS, 4096),
            ("conv1d", flagship_conv1d_config("tpu"), RAW_STATS, 2048),
            ("rawiq_best", rawiq_best_config("tpu"), RAW_STATS, 4096)):
        exp = ExperimentConfig(model=model_cfg,
                               data=DataConfig(synthetic_frame_len=model_cfg.seq_length))
        model = AMCModel(model_cfg, generator=torch.Generator().manual_seed(0))
        serve = build_serving_fn(exp, model, stats, device)
        out[label] = {"bf16": time_serving(f"{label} (bf16: K1 + K2)", serve, batch, device, card,
                                           frame_len=model_cfg.seq_length)}
        os.environ["VITIQ_ATTN_INT8"] = "1"
        try:
            out[label]["int8attn"] = time_serving(
                f"{label} (int8 attention, VITIQ_ATTN_INT8=1: K7 + K2)", serve, batch, device,
                card, frame_len=model_cfg.seq_length)
        finally:
            del os.environ["VITIQ_ATTN_INT8"]
        del model, serve
        torch.cuda.empty_cache()
    return out


def time_k2k7(device, card: str) -> dict:
    """`--k2k7`: K2, K7 and K1 a layer and K7's and K1's attention cores
    alone (CUDA events), and K2 and K7 by stage, at K2K7_SHAPES; serving
    under VITIQ_ATTN_INT8=1 and in bf16 at the four arms; and, where the
    tree has K7's two core forms, each alone over K7_SWEEP_L. Uses only
    wrappers an earlier tree of the port has too (K2 with its 15 operands
    where this tree takes them), so that it also runs copied into a tree in
    which K2 still formed K and V: parent, this, this, parent in one
    call."""
    out = {}
    forms = hasattr(k7, "core_route")
    for name, L, F, D, H, B in K2K7_SHAPES:
        ops = fel.layer_operands(random_layers(1, F, seed=13, device=device, D=D, H=H)[0], H)
        cls_ops = fel.cls_operands(ops, H) if hasattr(fel, "cls_operands") else ops
        x = torch.randn((B, L, D), generator=torch.Generator().manual_seed(3)).to(
            device, torch.bfloat16)
        with torch.no_grad():
            qkv = (fel._mm(x, ops[0]) + ops[1]).to(torch.bfloat16)
            t = {"k2_ms": cuda_ms(lambda: fel.fused_encoder_layer_cls(x, cls_ops, H), 20),
                 "k7_ms": cuda_ms(lambda: k7.fused_encoder_layer_int8attn(x, ops, H), 20),
                 "k1_ms": cuda_ms(lambda: fel.fused_encoder_layer(x, ops, H), 20),
                 "k7_core_ms": cuda_ms(lambda: k7.attention_int8(qkv, H), 20),
                 "k1_core_ms": cuda_ms(lambda: fel.attention_core(qkv, H), 20)}
            if forms:
                for form in ("wgmma", "sync"):
                    t[f"k7_{form}_ms"] = cuda_ms(lambda: k7.attention_int8(qkv, H, core=form), 20)
        each = (f"; wgmma {t['k7_wgmma_ms']:.4f} ms, mma.sync {t['k7_sync_ms']:.4f} ms"
                if forms else "")
        print(f"  {name} B={B} L={L} D={D} F={F} H={H}: K2 {t['k2_ms']:.4f} ms, K7 "
              f"{t['k7_ms']:.4f} ms (its core {t['k7_core_ms']:.4f} ms{each}), K1 "
              f"{t['k1_ms']:.4f} ms (its core {t['k1_core_ms']:.4f} ms)  [{card}]", flush=True)
        del x, qkv
        torch.cuda.empty_cache()
        t.update(profile_k2_k7_stages(name, B, L, D, F, H, device, card))
        out[name] = t
    out["serving"] = time_int8attn_serving(device, card)
    if forms:
        out["k7_forms"] = time_k7_forms(device, card)
    return out


def time_host(label: str, call, card: str, calls: int = 50) -> dict:
    """The host's time of one layer call: the mean host clock of a call
    without a synchronize (the wrapper's checks, the workspace, the C entry's
    tensor maps and launches), the synced p50 of a call, and the time a call
    back to back (CUDA events: the larger of the host's and the device's)."""
    with torch.no_grad():
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        host, synced = [], []
        for _ in range(calls):
            t0 = time.perf_counter()
            call()
            host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            synced.append(time.perf_counter() - t0)
        device_ms = cuda_ms(call, calls)
    out = {"host_us": statistics.mean(host) * 1e6, "p50_us": statistics.median(synced) * 1e6,
           "device_us": device_ms * 1e3}
    print(f"  {label}: {out['host_us']:.1f} us a call unsynced, p50 {out['p50_us']:.1f} us "
          f"synced, device {out['device_us']:.1f} us a call (CUDA events, back to back)  "
          f"[{card}]", flush=True)
    return out


def time_k3_host(device, card: str, B: int = 128, calls: int = 50) -> dict:
    """`time_host` of one K3-bwd call at rawiq_best's shape and `cli train`'s
    batch (B=128, L=65, D=256)."""
    ops = train_operands(1024, 13, device, 256, 8)
    x, dy = train_inputs(torch.Generator().manual_seed(4), B, 65, 256, device)
    args = (8, BEST_DROP, TRAIN_SEED, 0)
    out = time_host(f"K3-bwd host time at B={B} L=65 D=256 (rawiq_best, cli train's batch)",
                    lambda: flt.fused_train_layer_bwd(x, dy, ops, *args), card, calls)
    del x, dy, ops
    torch.cuda.empty_cache()
    return out


def time_k4_host(device, card: str, B: int = 4096) -> dict:
    """`time_host` of K4-fwd and K4-bwd at vit_tiny_2016's shape (L=17,
    D=64, H=4, F=256), whose train step waits on the host."""
    ops = train_operands(256, 13, device, 64, 4)
    x, dy = train_inputs(torch.Generator().manual_seed(4), B, 17, 64, device)
    args = (4, TRAIN_DROP, TRAIN_SEED, 0)
    with torch.no_grad():
        _, st = flt.fused_train_layer_fwd_stash(x, ops, *args)
    out = {kind: time_host(f"K4-{kind} host time at vit_tiny_2016's shape B={B}", call, card)
           for kind, call in (("fwd", lambda: flt.fused_train_layer_fwd_stash(x, ops, *args)),
                              ("bwd", lambda: flt.fused_train_layer_bwd_stash(x, dy, st, ops,
                                                                              *args)))}
    del x, dy, ops, st
    torch.cuda.empty_cache()
    return out


# The dsp phase: the SPS front-end (RRC matched filter, then timing recovery:
# the error-feedback loops in timing_recovery_kernel), the amp_phase and
# spectrogram features and the streaming classifier (the 64-channel
# polyphase channelizer), each served at full width through K1/K2, and an
# SPS training run through K4.
DSP_BATCH = 4096
DSP_SPS = 2
DSP_SPS_FRAME = DSP_SPS * FRAME_LEN  # 2,048 samples -> the rawIQ flagship's 1,024 symbols
DSP_CHANNELS = 64  # the streaming classifier's channels; 64 windows of them
DSP_TRAIN_EPOCHS, DSP_TRAIN_BATCH, DSP_TRAIN_LR = 4, 256, 1e-3
DSP_WINDOW = 64  # the hybrid's loop steps (DataConfig.timing_hybrid_window)
TIMING_SOURCE = "vitiq_torch/csrc/timing.cu"
TIMING_JAX_LOOPS = "vitiq/dsp/timing.py:76"  # _gardner_scan's lax.scan: no TPU kernel
TIMING_KERNEL = "timing_recovery_kernel"
# its instances: <METHOD, MODE, GROUP> for both methods, positions (mode 0)
# and the full loop's symbols (mode 1) at GROUP 8, the hybrid's at GROUP 16
TIMING_INSTANCES = {f"ILi{m}ELi{mode}ELi{g}E": f"{name} {label}"
                    for m, name in enumerate(("gardner", "mueller_muller"))
                    for mode, g, label in ((0, 8, "positions"), (1, 8, "symbols, full loop"),
                                           (1, 16, "symbols, hybrid"))}
# symbols mode against its plain version: the hybrid's phase within PHASE_TOL
# of a sample (its sums of sin and cos are taken in another order); a strobe
# within PHASE_TOL of a half-integer may round to the other side
PHASE_TOL = 1e-4
# a Gardner step's float32 operations a frame: three interpolation points
# (clip, floor, two subtractions, then two products and a sum in I and in Q),
# the error and the update; Mueller-Mueller's two points and signs are fewer
SCAN_OPS_PER_STEP = {"gardner": 40, "mueller_muller": 34}
COARSE_OPS_PER_SAMPLE = 4  # two squares, their sum, the phase's running sum
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
# the chain bound: a step's loads wait on the previous step's position, so
# a frame takes at least steps x (one dependent load); a shared-memory (or
# L1) load's load-to-use latency on Hopper is taken as 32 cycles (assumed,
# not measured)
L1_LOAD_CYCLES = 32


def check_timing_build() -> None:
    """Every instance of timing_recovery_kernel is built and none spills."""
    entries = {n: v for n, v in _build.ptxas_entries(_build.ptxas_report("timing")).items()
               if TIMING_KERNEL in n}
    labels = {tag: label for tag, label in TIMING_INSTANCES.items()
              if any(tag in n for n in entries)}
    if len(entries) != len(TIMING_INSTANCES) or len(labels) != len(TIMING_INSTANCES):
        raise AssertionError(f"{len(entries)} {TIMING_KERNEL} instances in the build, expected "
                             f"{len(TIMING_INSTANCES)}: {sorted(entries)}")
    for name, (regs, stores, loads) in sorted(entries.items()):
        label = next(v for tag, v in labels.items() if tag in name)
        print(f"  {TIMING_KERNEL}<{label}>: {regs} registers, spill {stores}/{loads} bytes",
              flush=True)
        if stores or loads:
            raise AssertionError(f"{TIMING_KERNEL}<{label}> spills")


def dsp_frames(n: int, frame_len: int, sps: int, seed: int = 0) -> torch.Tensor:
    """n synthetic frames of the default classes and SNRs, RRC-shaped at
    `sps` samples a symbol (iid symbols at sps 1), [n, frame_len, 2] f32 on
    the host."""
    from vitiq_torch.data import SyntheticAMCDataset

    data = DataConfig()
    ds = SyntheticAMCDataset(classes=data.synthetic_classes, frames_per_class=-(-n // 3),
                             frame_len=frame_len, snrs_db=data.synthetic_snr_db, seed=seed,
                             shaping_sps=sps)
    perm = np.random.default_rng(seed).permutation(len(ds.X))[:n]
    return torch.from_numpy(np.ascontiguousarray(ds.X[perm]))


def held_symbols(label: str, got: torch.Tensor, want: torch.Tensor, positions: torch.Tensor,
                 phase=None) -> tuple:
    """Symbols mode against its plain version (`tk.timing_symbols_plain`,
    whose strobes are `positions`): equal at every strobe more than
    PHASE_TOL from a half-integer, and the hybrid's phase (where given)
    within PHASE_TOL of the plain one. Returns (the phase's largest error,
    the strobes near a half-integer, the symbols that differ)."""
    near = (positions - positions.floor() - 0.5).abs() <= PHASE_TOL
    differ = (got != want).any(-1)
    err = 0.0 if phase is None else (phase - positions[:, 0]).abs().max().item()
    if got.shape != want.shape or (differ & ~near).any() or not err <= PHASE_TOL:
        raise AssertionError(f"{TIMING_KERNEL} {label}: {int((differ & ~near).sum())} symbols "
                             f"differ from the plain version away from a half-integer; phase "
                             f"error {err:.3g} (limit {PHASE_TOL})")
    return err, int(near.sum()), int(differ.sum())


def check_timing_kernel(device, frames, launches: int = 30) -> dict:
    """timing_recovery_kernel on the card at the SPS serving path's shape
    (B=4096 frames of 2,048 samples, at sps 2 and at sps 4), both loops.
    Positions mode (`tk.timing_scan`) against the plain loop
    (`tk.timing_scan_plain`): the full loop (L//sps steps from sps) and 64
    steps from p0, positions and valid flags bit for bit (the kernel rounds
    as the loop's operations do). Symbols mode (`tk.timing_symbols`) against
    `tk.timing_symbols_plain`, the full loop and the hybrid (window 64), also
    at B=4095 and B=1: the full loop's symbols bit for bit, the hybrid's by
    `held_symbols`. Every case: 30 launches give the same bits."""
    from vitiq_torch.dsp.filtering import matched_filter_batch

    worst = {"positions": 0.0, "phase": 0.0}
    for sps, x in ((2, frames), (4, dsp_frames(frames.shape[0], frames.shape[1], 4, seed=3))):
        f = matched_filter_batch(x.to(device), sps)
        B, L, _ = f.shape
        n_sym = L // sps
        p0 = (torch.arange(B, device=device) % sps).float() + sps
        for method in tk.METHODS:
            def again(call, want):
                return all(torch.equal(call(), want) for _ in range(launches))

            # positions mode; the full loop's positions also give its symbols
            full = None
            for label, steps, start in (("full", n_sym, None), ("hybrid", DSP_WINDOW, p0)):
                want = tk.timing_scan_plain(f, sps, steps, method, p0=start)
                got = tk.timing_scan(f, sps, steps, method, p0=start)
                torch.cuda.synchronize()
                err = (got[0] - want[0]).abs().max().item()
                same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                repeat = again(lambda: tk.timing_scan(f, sps, steps, method, p0=start)[0], got[0])
                print(f"  {TIMING_KERNEL} positions {method} {label} sps {sps} B={B} L={L} "
                      f"steps={steps}: max |kernel - plain| {err:.6g}, bit for bit {same}, "
                      f"{launches} launches the same bits {repeat}", flush=True)
                if not (same and repeat):
                    raise AssertionError(f"{TIMING_KERNEL} positions {method} {label} sps {sps} "
                                         "disagrees with its plain loop")
                worst["positions"] = max(worst["positions"], err)
                full = want[0] if full is None else full

            # symbols mode: timing_symbols_plain is strobe_symbols(symbol_positions)
            for label, window in (("full", 0), ("hybrid", DSP_WINDOW)):
                positions = full if not window else tk.symbol_positions(f, sps, method, window)
                want = tk.strobe_symbols(f, positions)
                for b in (B, B - 1, 1):
                    fb = f[:b]
                    phase = torch.empty(b, device=device) if window else None
                    got = tk.timing_symbols(fb, sps, method, window, phase=phase)
                    torch.cuda.synchronize()
                    if window:
                        err, near, differ = held_symbols(f"{method} {label} sps {sps} B={b}", got,
                                                         want[:b], positions[:b], phase)
                    elif not torch.equal(got, want[:b]):
                        raise AssertionError(f"{TIMING_KERNEL} symbols {method} full sps {sps} "
                                             f"B={b}: not the plain version's bits")
                    else:
                        err, near, differ = 0.0, 0, 0
                    repeat = b < B or again(lambda: tk.timing_symbols(fb, sps, method, window),
                                            got)
                    print(f"  {TIMING_KERNEL} symbols {method} {label} sps {sps} B={b} L={L}: "
                          + ("bit for bit" if not window else
                             f"phase within {err:.3g} of the plain version's, {differ} symbols "
                             f"differ, {near} strobes within {PHASE_TOL} of a half-integer")
                          + ("" if b < B else f"; {launches} launches the same bits {repeat}"),
                          flush=True)
                    if not repeat:
                        raise AssertionError(f"{TIMING_KERNEL} symbols {method} {label}: "
                                             "launches differ")
                    worst["phase"] = max(worst["phase"], err)
    return worst


def check_fir(device) -> None:
    """The matched filter on the card (a grouped float32 convolution, TF32
    off inside its scope) within 1e-5 of the signal's peak from a float64
    np.convolve (TF32 shows about 1e-3); the global flag left as it was."""
    from vitiq_torch.dsp.filtering import matched_filter_batch
    from vitiq_torch.dsp.taps import rrc_filter

    before = torch.backends.cudnn.allow_tf32
    x = np.random.default_rng(11).standard_normal((64, DSP_SPS_FRAME, 2)).astype(np.float32)
    for sps in (2, 4):
        got = matched_filter_batch(torch.from_numpy(x).to(device), sps).cpu().numpy()
        taps = rrc_filter(sps=sps)
        want = np.stack([[np.convolve(xb[:, c].astype(np.float64), taps, mode="same")
                          for c in range(2)] for xb in x]).transpose(0, 2, 1)
        rel = np.abs(got - want).max() / np.abs(want).max()
        print(f"  FIR sps {sps} ({len(taps)} taps) on the card vs float64: max error "
              f"{rel:.3g} of the peak (gate 1e-5)", flush=True)
        if not rel <= 1e-5:
            raise AssertionError(f"the matched filter at sps {sps} is not float32")
    if torch.backends.cudnn.allow_tf32 != before:
        raise AssertionError("the matched filter changed the global TF32 flag")


def check_contract_bar(device) -> None:
    """vitiq's DSP contract bar (tests/test_dsp.py:104-130) with the filter
    and the loops on the card: QPSK, 100 symbols, sps 2, 20 dB: recovery
    rate within 0.9-1.1 and mean timing error <= 0.75 samples for each
    method; BPSK at sps 2 and 4: 0.85-1.15 and <= 0.3 sps."""
    from vitiq_torch.data import generate_test_signal
    from vitiq_torch.dsp import extract_symbols

    cases = [("QPSK", 100, 2, 4, (0.9, 1.1), 0.75)] + [
        ("BPSK", 80, sps, 5, (0.85, 1.15), 0.3 * sps) for sps in (2, 4)]
    for mod, n, sps, seed, (lo, hi), bar in cases:
        i, q, true_idx = generate_test_signal(mod, n, sps, 20.0, seed=seed)
        for method in ("simple_energy", "simple_correlation", "gardner", "mueller_muller"):
            rec = extract_symbols(i, q, sps=sps, method=method, device=device)["symbol_indices"]
            rate = len(rec) / n
            err = float(np.mean([np.min(np.abs(true_idx - r)) for r in rec]))
            if not (lo <= rate <= hi and err <= bar):
                raise AssertionError(f"{mod} sps {sps} {method}: rate {rate:.2f}, mean "
                                     f"timing error {err:.3f} (bar {bar})")
        print(f"  contract bar on the card: {mod} sps {sps}, 4 methods within rate "
              f"[{lo}, {hi}] and mean timing error <= {bar}", flush=True)


def streaming_check(device, card: str, windows: int = DSP_CHANNELS) -> dict:
    """The streaming classifier (64-channel polyphase channelizer, then the
    ViT flagship on every channel's frame) over `windows` wideband windows of
    64 x 1,024 complex samples (tones in channels 3 and 17 over noise),
    against the f32 path with the same weights (`gate_logits`); K1 5
    and K2 1 per call, nothing else; then its frames/s and the channelizer's
    time alone."""
    from vitiq_torch.dsp.channelizer import (design_prototype_lowpass, polyphase_channelize,
                                             synthesize_multitone)
    from vitiq_torch.streaming import make_streaming_classifier

    cfg = flagship_vit_config("tpu")
    model = AMCModel(cfg, generator=torch.Generator().manual_seed(0))
    ref = AMCModel(dataclasses.replace(cfg, numerics="reference"))
    ref.load_state_dict(model.state_dict())
    classify = make_streaming_classifier(cfg, model, STATS, DSP_CHANNELS, device=device)
    ref_classify = make_streaming_classifier(dataclasses.replace(cfg, numerics="reference"),
                                             ref, STATS, DSP_CHANNELS, device=device)
    w = torch.from_numpy(np.concatenate([
        synthesize_multitone(DSP_CHANNELS, cfg.seq_length, active=((3, 1.0), (17, 0.5)),
                             seed=i, noise_db=-10.0) for i in range(windows)])).to(device)
    reset_all_launches()
    got = classify(w)
    torch.cuda.synchronize()
    counts = {k: v for k, v in all_launches().items() if v}
    want_counts = {"fused_encoder_layer": cfg.n_layers - 1, "fused_encoder_layer_cls": 1}
    if counts != want_counts:
        raise AssertionError(f"streaming: launched {counts}, expected {want_counts}")
    want = ref_classify(w)
    n = windows * DSP_CHANNELS
    gate_logits(f"streaming ({windows} windows x {DSP_CHANNELS} channels, ViT flagship)",
                got.reshape(n, -1), want.reshape(n, -1), n, cfg.num_classes)
    del ref, ref_classify
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: classify(w), 10)
    taps = design_prototype_lowpass(DSP_CHANNELS, 8)
    chan_ms = cuda_ms(lambda: polyphase_channelize(w, DSP_CHANNELS, taps), 20)
    print(f"  streaming B={windows} windows x {DSP_CHANNELS} channels: {n / (ms / 1e3):.1f} "
          f"frames/s ({ms:.4f} ms a call; the channelizer alone {chan_ms:.4f} ms)  [{card}]",
          flush=True)
    return {"frames_per_s": n / (ms / 1e3), "ms": ms, "channelizer_ms": chan_ms}


def time_front_end(label: str, res: dict, stats, x, device, card: str, iters: int = 10) -> dict:
    """Frames/s of one serving call at B frames, and its two parts alone:
    the front-end (`build_preprocess`) and the model on its output."""
    from vitiq_torch.serve import build_preprocess

    x = x.to(device)
    pre = build_preprocess(res["exp"], stats, device)
    model = res["model"]
    with torch.no_grad():
        inputs = pre(x)
        front_ms = cuda_ms(lambda: pre(x), iters)
        model_ms = cuda_ms(lambda: model(inputs), iters)
        ms = cuda_ms(lambda: res["serve"](x), iters)
    B = x.shape[0]
    print(f"  {label} serving B={B}: {B / (ms / 1e3):.1f} frames/s ({ms:.4f} ms a call); "
          f"front-end alone {front_ms:.4f} ms, model alone {model_ms:.4f} ms  [{card}]",
          flush=True)
    return {"frames_per_s": B / (ms / 1e3), "ms": ms, "front_ms": front_ms,
            "model_ms": model_ms}


def span_bytes(positions: torch.Tensor, L: int, sps: int) -> int:
    """The bytes of each frame's span that steps at `positions` [B, steps]
    touch, from the sample under the first strobe less one symbol to the one
    past the last strobe, clipped to the frame, read once in whole 32-byte
    sectors (8 bytes a sample)."""
    first = positions.min(dim=1).values.sub(sps).clamp(0, L - 1).floor().long()
    last = (positions.max(dim=1).values.clamp(0, L - 1).floor().long() + 1).clamp(max=L - 1)
    sectors = (last * 8 + 7) // 32 - (first * 8) // 32 + 1
    return int(sectors.sum().item()) * 32


def timing_bound(nbytes: int, ops: int, steps: int, clock_hz=None) -> dict:
    """(bound, chain): the larger of the bytes over the HBM rate and the
    float32 operations over the non-tensor-core peak, and the chain of
    `steps` dependent loads, L1_LOAD_CYCLES each, at `clock_hz` (default the
    card's max SM clock)."""
    byte_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    chain_ms = steps * L1_LOAD_CYCLES / (clock_hz or max_sm_clock_hz()) * 1e3
    bound = (byte_ms, "bytes") if byte_ms >= ops_ms else (ops_ms, "operations")
    return {"bound": bound, "chain_ms": chain_ms, "bytes": nbytes, "ops": ops}


def scan_bounds(positions: torch.Tensor, L: int, sps: int, method: str, p0=None,
                clock_hz=None) -> dict:
    """Positions mode's bounds on this run's data, from the positions
    [B, steps] it wrote: bytes (`span_bytes`; p0 read; positions and valid
    flags written), operations and the chain (`timing_bound`)."""
    B, steps = positions.shape
    nbytes = span_bytes(positions, L, sps) + (B * 4 if p0 is not None else 0) + B * steps * 5
    return timing_bound(nbytes, B * steps * SCAN_OPS_PER_STEP[method], steps, clock_hz)


def symbol_bounds(f: torch.Tensor, positions: torch.Tensor, sps: int, method: str,
                  window: int, clock_hz=None) -> dict:
    """Symbols mode's bounds on this run's data: the hybrid reads every
    sample once (its coarse phase) and the full loop the span its strobes
    `positions` touch (`span_bytes`); both write the symbols [B, L//sps, 2]
    f32. Operations: the loop's steps, and the hybrid's coarse pass."""
    B, L, _ = f.shape
    n_sym = L // sps
    steps = window or n_sym
    nbytes = (B * L * 8 if window else span_bytes(positions, L, sps)) + B * n_sym * 8
    ops = B * steps * SCAN_OPS_PER_STEP[method] + (B * L * COARSE_OPS_PER_SAMPLE if window else 0)
    return timing_bound(nbytes, ops, steps, clock_hz)


def time_timing_recovery(device, card: str, frames) -> dict:
    """timing_recovery_kernel at B=4096, 2,048 samples, sps 2, both loops,
    the hybrid's 64 steps (the serving default) and the full loop's 1,024: in
    symbols mode (`tk.timing_symbols`, the front-end's call) against the
    composition the front-end ran before (`tk.timing_symbols_plain` around the
    positions-mode kernel: the coarse phase, the circular mean and the gather
    as tensor operations) and against the plain version (the same around the
    plain loop), each beside its bounds; and in positions mode
    (`tk.timing_scan`) against the plain loop."""
    from vitiq_torch.dsp.filtering import matched_filter_batch

    f = matched_filter_batch(frames.to(device), DSP_SPS)
    B, L, _ = f.shape
    p0 = (torch.arange(B, device=device) % DSP_SPS).float() + DSP_SPS
    out = {}
    for method in tk.METHODS:
        for label, window in (("hybrid", DSP_WINDOW), ("full", 0)):
            steps = window or L // DSP_SPS
            start = p0 if window else None
            ms = cuda_ms(lambda: tk.timing_symbols(f, DSP_SPS, method, window), 20)
            comp_ms = cuda_ms(lambda: tk.timing_symbols_plain(f, DSP_SPS, method, window,
                                                              scan=tk.timing_scan), 10)
            plain_ms = cuda_ms(lambda: tk.timing_symbols_plain(f, DSP_SPS, method, window), 1,
                               warmup=0)
            pos_ms = cuda_ms(lambda: tk.timing_scan(f, DSP_SPS, steps, method, p0=start), 20)
            # the full loop's plain positions cost what its plain symbols do (the
            # gather is a few kernels beside 1,024 steps of ~45): not timed twice
            pos_plain_ms = (None if not window else
                            cuda_ms(lambda: tk.timing_scan_plain(f, DSP_SPS, steps, method,
                                                                 p0=start), 1, warmup=0))
            positions = tk.timing_scan(f, DSP_SPS, steps, method, p0=start)[0]
            b = symbol_bounds(f, tk.symbol_positions(f, DSP_SPS, method, window, tk.timing_scan),
                              DSP_SPS, method, window)
            pb = scan_bounds(positions, L, DSP_SPS, method, start)
            print(f"  {TIMING_KERNEL} {method} {label} B={B} L={L} steps={steps}: symbols mode "
                  f"{ms:.4f} ms against the composition around positions mode {comp_ms:.4f} ms "
                  f"and the plain version {plain_ms:.4f} ms; bound {b['bound'][0]:.6f} ms "
                  f"({b['bound'][1]}: {b['bytes']} bytes, {b['ops']} operations), "
                  f"{ms / b['bound'][0]:.1f}x the bound; chain bound {b['chain_ms']:.4f} ms. "
                  f"Positions mode {pos_ms:.4f} ms"
                  + ("" if pos_plain_ms is None else
                     f" against the plain loop {pos_plain_ms:.4f} ms")
                  + f", bound {pb['bound'][0]:.6f} ms ({pb['bytes']} bytes touched)  [{card}]",
                  flush=True)
            out[f"{method}_{label}"] = {"ms": ms, "plain_ms": plain_ms, "composition_ms": comp_ms,
                                        "positions_ms": pos_ms, "positions_plain_ms": pos_plain_ms,
                                        "positions_bound": pb["bound"], **b}
    return out


def kernel_sequence(call, tries: int = 3) -> tuple:
    """(call()'s result, the names of what it ran on the device, kernels and
    copies, in the order they started), from one `torch.profiler` window
    (PROFILE_PAD sleeps first: the profiler drops a window's first
    records). Every call given here launches work, and a window has come
    back empty on the card (two kernels at B=8 in one run of the same tree
    that recorded them in another): an empty window is profiled again, up
    to `tries` windows."""
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
            out = call()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
                  and e.time_range.start >= 0 and "spin_kernel" not in e.name]
        if events:
            break
        print("  torch.profiler recorded nothing of a call; profiling it again", flush=True)
    return out, [e.name for e in sorted(events, key=lambda e: e.time_range.start)]


def front_end_parts(exp: ExperimentConfig, stats, x: torch.Tensor, device) -> tuple:
    """What the SPS front-end of `exp` runs on x before and after timing
    recovery, each alone: the matched filter's kernels (its taps made once,
    as `build_preprocess` makes them) and the arm's preprocess on the
    symbols."""
    from vitiq_torch.dsp.filtering import matched_filter_batch, rrc_weights
    from vitiq_torch.serve import _build_arm_preprocess

    sps, data = exp.data.sps, exp.data
    w = rrc_weights(sps, device=device)
    arm_pre = _build_arm_preprocess(exp, stats, device)
    filtered, fir = kernel_sequence(lambda: matched_filter_batch(x, sps, weights=w))
    symbols = tk.timing_symbols(filtered, sps, data.timing_method, data.timing_hybrid_window)
    inputs, arm = kernel_sequence(lambda: arm_pre(symbols))
    return fir, arm, inputs


def check_front_end_order(label: str, names: list, fir: list, arm: list, model=()) -> int:
    """Every timing_recovery_kernel in `names` (the device's work in start
    order) comes right after the matched filter's kernels `fir` and right
    before the arm's preprocess `arm` (and the model's `model`, where
    given): no other kernel runs between the FIR and the model. Returns how
    many there were."""
    at = [i for i, name in enumerate(names) if kernel_name(name) == TIMING_KERNEL]
    for i in at:
        after = names[i + 1:i + 1 + len(arm) + len(model)]
        if names[max(0, i - len(fir)):i] != list(fir) or after != list(arm) + list(model):
            seen = names[max(0, i - len(fir) - 2):i + 3 + len(arm)]
            raise AssertionError(f"{label}: the device ran {seen} around {TIMING_KERNEL}, "
                                 f"expected the matched filter's {fir}, then the arm's "
                                 f"preprocess {arm}")
    return len(at)


def profile_sps_call(serve, x, device, card: str, calls: int = 10) -> float:
    """The device's idle share of one SPS serving call: the kernels' device
    time (torch.profiler) against the host clock of the synced call, with
    the profiler on, and against the median host clock of `calls` synced
    calls without it (the profiler adds host time a launch)."""
    x = x.to(device)
    walls = []
    for _ in range(calls + 1):
        t0 = time.perf_counter()
        serve(x)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    bare_ms = statistics.median(walls[1:]) * 1e3
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        serve(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    print(f"  profile of one SPS serving call (Gardner, hybrid) B={x.shape[0]}: host wall "
          f"{wall_ms:.4f} ms (profiler on), device kernel time {busy_ms:.4f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; without the profiler, host wall p50 {bare_ms:.4f} ms "
          f"over {calls} calls, idle share {1 - busy_ms / bare_ms:.4f}  [{card}]", flush=True)
    for e in sorted(kernels, key=device_us, reverse=True)[:12]:
        print(f"    {device_us(e) / 1e3:9.4f} ms  {e.count:4d}x  {e.key[:100]}", flush=True)
    return 1 - busy_ms / bare_ms


def dsp_cli_train_check(device, card: str,
                        frames_per_class: int = DataConfig.synthetic_frames_per_class,
                        batch: int = DSP_TRAIN_BATCH) -> dict:
    """The gradient of one K4 step of the rawIQ flagship on the sps-2
    front-end's symbols (Gardner, hybrid) against the plain bf16 layers and
    the f32 path (`grad_parity`, the K4 phase's limits). Then `python -m
    vitiq_torch.cli train` of the rawIQ flagship (the
    rawiq_reference preset, `tpu` numerics) at sps 2 with the Gardner loop
    (hybrid) on synthetic frames RRC-shaped at 2 samples a symbol (2,048
    samples -> 1,024 symbols, 3 classes), DSP_TRAIN_EPOCHS epochs in this
    process: every train step launches K4 6 + 6 times and
    timing_recovery_kernel once, every evaluated batch K1 5, K2 1 and
    timing_recovery_kernel once; the
    train loss falls; then `cli evaluate` of the checkpoint prints the run's
    test accuracy."""
    import io
    import tempfile

    print(f"phase dsp-train: the rawIQ flagship through `cli train --sps 2 --timing_method "
          f"gardner` ({DSP_TRAIN_EPOCHS} epochs, B={batch}) and `cli evaluate`", flush=True)
    cfg0 = dataclasses.replace(flagship_rawiq_config("tpu"), drop_prob=0.0,
                               seq_length=DSP_SPS_FRAME // DSP_SPS)
    exp0 = ExperimentConfig(model=cfg0, data=DataConfig(
        synthetic_frame_len=DSP_SPS_FRAME, sps=DSP_SPS, timing_method="gardner"),
        train=TrainConfig(batch_size=batch, learning_rate=DSP_TRAIN_LR))
    init = AMCModel(cfg0, generator=torch.Generator().manual_seed(0)).state_dict()
    frames = dsp_frames(batch, DSP_SPS_FRAME, DSP_SPS, seed=7).to(device)
    labels = torch.randint(0, 3, (batch,), generator=torch.Generator().manual_seed(7)).to(device)
    tk.reset_launches()
    grad_parity("rawIQ flagship at sps 2 (Gardner, hybrid)", exp0, RAW_STATS, init, frames,
                labels, K4, device)
    if tk.kernel_launches() != 2:
        raise AssertionError(f"the sps-2 gradient check did not run {TIMING_KERNEL} twice")
    # the front-end `cli train` builds (build_forward_and_preprocess ->
    # build_preprocess): the FIR, one timing_recovery_kernel, the arm's
    # preprocess, nothing else
    from vitiq_torch.serve import build_preprocess

    pre = build_preprocess(exp0, RAW_STATS, device)
    fir, arm, _ = front_end_parts(exp0, RAW_STATS, frames, device)
    _, names = kernel_sequence(lambda: pre(frames))
    if (check_front_end_order("the training front-end", names, fir, arm) != 1
            or len(names) != len(fir) + 1 + len(arm)):
        raise AssertionError(f"the training front-end ran {names}")
    print(f"  the training front-end (B={batch}): the matched filter ({len(fir)} kernels), one "
          f"{TIMING_KERNEL}, the arm's preprocess ({len(arm)}), nothing else", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = ExperimentConfig.rawiq_reference(**{
            "checkpoint_dir": tmp, "log_dir": str(Path(tmp) / "logs"),
            "experiment_name": "sps2_gardner", "train.save_freq": 100})
        cfg_path = Path(tmp) / "sps2.json"
        cfg.to_json(str(cfg_path))
        data = DataConfig()
        fpc = frames_per_class
        args = ["train", "--config", str(cfg_path), "--source", "synthetic", "--numerics", "tpu",
                "--sps", str(DSP_SPS), "--timing_method", "gardner", "--frame_len",
                str(DSP_SPS_FRAME), "--seq_length", str(DSP_SPS_FRAME // DSP_SPS),
                "--shaping_sps", str(DSP_SPS), "--batch_size", str(batch),
                "--frames_per_class", str(fpc),
                "--learning_rate", str(DSP_TRAIN_LR), "--num_epochs", str(DSP_TRAIN_EPOCHS),
                "--device", str(device), "--no_plots"]
        n = int(data.train_size * 3 * fpc)
        n_valid = int(data.valid_size * 3 * fpc)
        n_test = 3 * fpc - n - n_valid
        spe = n // batch
        batches = DSP_TRAIN_EPOCHS * -(-n_valid // batch) + -(-n_test // batch)
        reset_all_launches()
        tk.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in all_launches().items() if v}
        steps = spe * DSP_TRAIN_EPOCHS
        want = {K4[0]: 6 * steps, K4[1]: 6 * steps, "fused_encoder_layer": 5 * batches,
                "fused_encoder_layer_cls": batches}
        scans = (tk.launches["timing_symbols"], tk.kernel_launches())
        print(f"  cli train: {DSP_TRAIN_EPOCHS} epochs of {spe} steps in {wall:.1f} s (data "
              f"generation included); launches {got}, {TIMING_KERNEL} {scans[1]}", flush=True)
        if got != want or scans != (steps + batches,) * 2:
            raise AssertionError(f"cli train at sps 2 launched {got} and {TIMING_KERNEL} "
                                 f"{scans}, expected {want} and {steps + batches}")
        exp_dir = Path(tmp) / "sps2_gardner"
        summary = json.loads((exp_dir / "summary.json").read_text())
        loss = json.loads((exp_dir / "checkpoint_final.json").read_text())["history"][
            "train_loss"]
        saved = json.loads((exp_dir / "config.json").read_text())["data"]
        print(f"  train loss by epoch {[round(v, 4) for v in loss]}, test accuracy "
              f"{summary['test_overall_accuracy'] * 100:.2f}%; config.json sps {saved['sps']}, "
              f"{saved['timing_method']}, window {saved['timing_hybrid_window']}", flush=True)
        if not loss[-1] < loss[0] or (saved["sps"], saved["timing_method"]) != (2, "gardner"):
            raise AssertionError("the sps-2 training run did not learn or lost its front-end")
        out = io.StringIO()
        tk.reset_launches()
        with contextlib.redirect_stdout(out):
            cli.main(["evaluate", "--checkpoint", str(exp_dir), "--device", str(device),
                      "--no_plots"])
        line = f"overall accuracy: {summary['test_overall_accuracy'] * 100:.2f}%"
        printed = [ln for ln in out.getvalue().splitlines() if ln.startswith("overall")]
        print(f"  cli evaluate: {printed} (the run's test {line}); {TIMING_KERNEL} "
              f"{tk.kernel_launches()}", flush=True)
        if line not in out.getvalue() or tk.kernel_launches() == 0:
            raise AssertionError("cli evaluate did not re-derive the sps-2 front-end")
    return {"scans": scans[1], "loss": loss}


def check_sps_request(label: str, res: dict, x: torch.Tensor, device, parts=None) -> tuple:
    """One SPS serving call (`res["serve"]`, the eager Server's function) on
    x under `torch.profiler`: the device runs the matched filter, one
    timing_recovery_kernel, the arm's preprocess and the model, in that
    order and nothing else (`check_front_end_order`). `parts` are those
    three alone (the kernels of `front_end_parts` and of the model), as an
    earlier call returned them for the same configuration and shapes;
    returns them."""
    if parts is None:
        fir, arm, inputs = front_end_parts(res["exp"], res["stats"], x, device)
        with torch.no_grad():
            _, model = kernel_sequence(lambda: res["model"](inputs))
        parts = (fir, arm, model)
    fir, arm, model = parts
    with torch.no_grad():
        _, names = kernel_sequence(lambda: res["serve"](x))
    if check_front_end_order(label, names, fir, arm, model) != 1 or (
            names[:len(fir)] != fir or len(names) != len(fir) + 1 + len(arm) + len(model)):
        raise AssertionError(f"{label}: one request ran {len(names)} kernels, not the matched "
                             f"filter's {len(fir)}, one {TIMING_KERNEL}, the arm's {len(arm)} "
                             f"and the model's {len(model)}")
    print(f"  {label}: one request ran the matched filter ({len(fir)} kernels), one "
          f"{TIMING_KERNEL}, the arm's preprocess ({len(arm)}) and the model ({len(model)}), "
          "nothing else (torch.profiler)", flush=True)
    return parts


def dsp_check(device, card: str) -> dict:
    """The dsp phase (see the module docstring)."""
    t0 = time.perf_counter()
    print(f"phase dsp: the SPS front-end, the features and the streaming classifier on "
          f"{card}", flush=True)
    check_timing_build()
    frames = dsp_frames(DSP_BATCH, DSP_SPS_FRAME, DSP_SPS)
    err = check_timing_kernel(device, frames)
    check_fir(device)
    check_contract_bar(device)
    raw, vit = flagship_rawiq_config("tpu"), flagship_vit_config("tpu")
    raw_sps = dataclasses.replace(raw, seq_length=DSP_SPS_FRAME // DSP_SPS)
    sps_cases = [("gardner", DSP_WINDOW), ("mueller_muller", DSP_WINDOW),
                 ("simple_energy", DSP_WINDOW), ("simple_correlation", DSP_WINDOW),
                 ("gardner", 0), ("mueller_muller", 0)]
    served, times = {}, {}
    tk_total = 0
    x_dev, parts = frames.to(device), None  # the loop cases share their FIR, arm and model
    for method, window in sps_cases:
        label = f"rawIQ flagship, sps 2, {method}" + (", full loop" if window == 0 else "")
        data = DataConfig(synthetic_frame_len=DSP_SPS_FRAME, sps=DSP_SPS, timing_method=method,
                          timing_hybrid_window=window)
        res = serve_check(label, raw_sps, RAW_STATS, device, (DSP_BATCH,), (DSP_BATCH,),
                          data=data, frames=frames, scans=int(method in tk.METHODS))
        tk_total += res["scans"]
        times[label] = time_front_end(label, res, RAW_STATS, frames, device, card)
        if method in tk.METHODS:
            parts = check_sps_request(label, res, x_dev, device, parts)
        served[(method, window)] = res
    x1024 = frames[:, :FRAME_LEN].contiguous()
    for label, cfg, data in (
            ("rawIQ flagship, amp_phase", raw, DataConfig(features="amp_phase")),
            ("ViT flagship, spectrogram", vit, DataConfig(features="spectrogram"))):
        res = serve_check(label, cfg, RAW_STATS, device, (DSP_BATCH,), (DSP_BATCH,), data=data,
                          frames=x1024)
        times[label] = time_front_end(label, res, RAW_STATS, x1024, device, card)
    times["streaming"] = streaming_check(device, card)
    times["idle_share"] = profile_sps_call(served[("gardner", DSP_WINDOW)]["serve"], frames,
                                           device, card)
    times["scan"] = time_timing_recovery(device, card, frames)
    train = dsp_cli_train_check(device, card)
    print(f"  dsp phase {time.perf_counter() - t0:.1f} s", flush=True)
    return {"err": err, "launches": tk_total, "times": times, "train": train}


# the export phase: each artifact's buckets and the ragged requests served
# through it; a request's logits through the graph must equal the eager
# Server's bit for bit, or (where an op runs otherwise under capture) within
# EXPORT_TOL with the same argmax
EXPORT_BUCKETS = (1, 8, 32, 256, 4096)
EXPORT_SIZES = (1, 5, 8, 20, 32, 200, 256, 1000, 4096)
EXPORT_SPS_BUCKETS, EXPORT_SPS_SIZES = (8, 4096), (3, 8, 1000, 4096)
EXPORT_TOL = 1e-3
EXPORT_REPLAYS = 3  # replays under the profiler against one eager request
# the port's kernels on a float serving path, by function name
SERVING_KERNELS = ("gemm_wgmma_kernel", "attention_core_kernel", "cls_pool_kernel",
                   TIMING_KERNEL)
# the kernel that one call of each counted wrapper launches once: K1's
# attention core, K2's pooling kernel, timing recovery (symbols mode)
CALL_KERNELS = {"fused_encoder_layer": "attention_core_kernel",
                "fused_encoder_layer_cls": "cls_pool_kernel", "timing_symbols": TIMING_KERNEL}


def write_experiment(root: Path, exp: ExperimentConfig, model, stats) -> Path:
    """A training-run directory as `run_training` writes it (config.json,
    normalization_stats.json, model_best.npz) with `model`'s weights."""
    root.mkdir(parents=True)
    exp.to_json(str(root / "config.json"))
    (root / "normalization_stats.json").write_text(json.dumps(stats))
    save_params(root / "model_best", model.state_dict(), exp.model)
    return root


def serving_kernel_names(call) -> tuple:
    """(call()'s result, the port's serving kernels (SERVING_KERNELS) it
    launched on the device, by full name), from one `torch.profiler` window
    (PROFILE_PAD sleeps first: the profiler drops a window's first
    records)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(200_000)
        torch.cuda.synchronize()
        out = call()
        torch.cuda.synchronize()
    return out, Counter(e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
                        and e.time_range.start >= 0 and kernel_name(e.name) in SERVING_KERNELS)


def by_function(names: Counter) -> Counter:
    """Kernel launches by full name -> by function name."""
    out = Counter()
    for name, n in names.items():
        out[kernel_name(name)] += n
    return out


def export_case(root: Path, label: str, model_cfg, stats, data: DataConfig, buckets, sizes,
                device) -> dict:
    """One artifact of the export phase (see the module docstring): a
    port-written experiment directory with seeded weights, exported by
    `export_from_experiment` and loaded on the card (one graph a bucket),
    then ragged requests through it, every one of them before the eager
    `Server`'s (so a result that a later replay overwrote would differ from
    it), against the eager `Server` and the f32 path. Every replay runs
    under `torch.profiler`; returns their kernels by function name
    (`launches`) and the times."""
    from vitiq_torch.serve import ServingArtifact, export_from_experiment

    frame_len = model_cfg.seq_length * max(1, data.sps)
    data = dataclasses.replace(data, synthetic_frame_len=frame_len)
    exp = ExperimentConfig(model=model_cfg, data=data)
    model = AMCModel(model_cfg, generator=torch.Generator().manual_seed(0))
    exp_dir = write_experiment(root / "experiment", exp, model, stats)
    t0 = time.perf_counter()
    art_dir = export_from_experiment(exp_dir, root / "artifact", batch_sizes=buckets,
                                     platforms=["cuda"])
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = ServingArtifact.load(art_dir, device=device)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    eager = AMCModel(model_cfg)
    eager.load_state_dict(load_params(exp_dir / "model_best.npz", model_cfg))
    server = Server(build_serving_fn(exp, eager, stats, device), frame_len, buckets, device)
    cls = int(eager.cls_pooling)
    want = {"fused_encoder_layer": model_cfg.n_layers - cls, "fused_encoder_layer_cls": cls,
            "timing_symbols": int(data.sps > 1 and data.timing_method in tk.METHODS)}
    want = {k: v for k, v in want.items() if v}
    before = {**all_launches(), **tk.launches}
    server.run(torch.zeros((buckets[0], frame_len, 2), device=device))
    torch.cuda.synchronize()
    eager_counts = {k: v - before[k] for k, v in {**all_launches(), **tk.launches}.items()
                    if v != before[k]}
    if eager_counts != want:
        raise AssertionError(f"{label}: an eager request launched {eager_counts}, expected {want}")
    for b in buckets:
        if art.captured_launches[b] != eager_counts:
            raise AssertionError(f"{label}: bucket {b}'s graph captured "
                                 f"{art.captured_launches[b]}, an eager request launches "
                                 f"{eager_counts}")

    if data.sps > 1:
        frames = dsp_frames(sum(sizes), frame_len, data.sps)
    else:
        frames = torch.randn((sum(sizes), frame_len, 2), generator=torch.Generator().manual_seed(1))
    requests = [x.to(device) for x in torch.split(frames, list(sizes))]
    outs, traced = serving_kernel_names(lambda: [art.run(x) for x in requests])
    launches = by_function(traced)
    for counter, n in eager_counts.items():
        kernel = CALL_KERNELS[counter]
        if launches[kernel] != len(requests) * n:
            raise AssertionError(f"{label}: {len(requests)} requests through the graphs launched "
                                 f"{kernel} {launches[kernel]} times (torch.profiler), one eager "
                                 f"request {n}")
    not_exact, max_diff = 0, 0.0
    for x, got in zip(requests, outs):
        ref = server.run(x)
        if not torch.equal(got, ref):
            diff = (got - ref).abs().max().item()
            not_exact, max_diff = not_exact + 1, max(max_diff, diff)
            if not (diff <= EXPORT_TOL and torch.equal(got.argmax(-1), ref.argmax(-1))):
                raise AssertionError(f"{label}: request of {x.shape[0]} through the graph differs "
                                     f"from the eager Server by {diff:.6g}")
    got = torch.cat(outs)
    ref_cfg = ExperimentConfig(model=dataclasses.replace(model_cfg, numerics="reference"),
                               data=data)
    ref_model = AMCModel(ref_cfg.model)
    ref_model.load_state_dict(eager.state_dict())
    ref_serve = build_serving_fn(ref_cfg, ref_model, stats, device)
    want_logits = torch.cat([ref_serve(x) for x in requests])
    torch.cuda.synchronize()
    print(f"  {label}: exported in {t_export:.2f} s, loaded (warm-up + {len(buckets)} captures) "
          f"in {t_load:.2f} s; requests {list(sizes)} via buckets {list(buckets)}: "
          f"{len(requests) - not_exact} of {len(requests)} equal the eager Server bit for bit"
          + (f", {not_exact} within {max_diff:.6g}" if not_exact else "")
          + f"; each graph captured {eager_counts}", flush=True)
    max_abs = gate_logits(label + " (graph)", got, want_logits, sum(sizes), model_cfg.num_classes)
    del ref_model, ref_serve

    b = 8
    x8 = requests[0].new_zeros((b, frame_len, 2)).copy_(frames[:b])
    _, eager_names = serving_kernel_names(lambda: server.run(x8))
    _, graph_names = serving_kernel_names(
        lambda: [art.run(x8) for _ in range(EXPORT_REPLAYS)])
    per_replay = {k: v / EXPORT_REPLAYS for k, v in graph_names.items()}
    if not eager_names or per_replay != dict(eager_names):
        raise AssertionError(f"{label}: {EXPORT_REPLAYS} replays launched {dict(graph_names)}, "
                             f"one eager request {dict(eager_names)}")
    print(f"  {label}: torch.profiler, bucket {b}: each of {EXPORT_REPLAYS} replays launched "
          + ", ".join(f"{k} {v}" for k, v in sorted(by_function(eager_names).items()))
          + f" ({len(eager_names)} instances), as one eager request does", flush=True)
    launches.update(by_function(graph_names))
    if want.get("timing_symbols"):  # the replay's front-end: the FIR, timing recovery, the arm
        fir, arm, inputs = front_end_parts(exp, stats, x8, device)
        with torch.no_grad():
            _, model = kernel_sequence(lambda: eager(inputs))
        _, order = kernel_sequence(lambda: art.run(x8))
        if check_front_end_order(label + " (graph)", order, fir, arm, model) != 1:
            raise AssertionError(f"{label}: a replay of bucket {b} ran {TIMING_KERNEL} other "
                                 "than once")
        print(f"  {label}: a replay of bucket {b} ran the matched filter, one {TIMING_KERNEL}, "
              "the arm's preprocess and the model in that order (torch.profiler)", flush=True)
    print(f"  {label}: {len(requests) + EXPORT_REPLAYS} replays under torch.profiler launched "
          + ", ".join(f"{k} {v}" for k, v in sorted(launches.items())), flush=True)
    del art, server, eager
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs": max_abs, "not_exact": not_exact, "load_s": t_load}


# the scan-train phase (see the module docstring)
SCAN_K, SCAN_BATCH, SCAN_EPOCHS, SCAN_DROP = 64, 256, 2, 0.1
SCAN_TRAIN = 2 * SCAN_K * SCAN_BATCH + 3 * SCAN_BATCH  # 33,536 frames: 131 steps an epoch
SCAN_VALID = 2048
SCAN_CONV1D_LAYERS, SCAN_CONV1D_K, SCAN_CONV1D_BATCH = 2, 4, 64
SCAN_REPEATS = 3  # timed groups eager and through the graph
# eager steps a profiled window: one window of a K=64 group's eager steps
# (1-2 s of host launches) lost two to five steps' kernels on the card,
# so the group is profiled in windows of this many steps and summed
SCAN_PROFILE_STEPS = 8
# the port's training kernels, by function name (K3 / K4's stages and
# passes, K5's kernels)
TRAIN_KERNELS = ("train_gemm_kernel", "train_attention_fwd", "train_attention_bwd",
                 "wg_attention_fwd", "wg_attention_bwd_stash", "wg_recompute_attention_fwd",
                 "wg_recompute_attention_bwd", "ln_bwd_rows", "rebuild_ln_out",
                 "reduce_rows", "hash_dropout_kernel") + fa.KERNELS


def scan_corpus(n: int, L: int, seed: int) -> tuple:
    """n [L, 2] f32 frames of 3 classes (the class shifts the I mean by
    0.5 a step) and their labels, made from `seed`."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n).astype(np.int32)
    x = rng.standard_normal((n, L, 2), dtype=np.float32)
    x[:, :, 0] += 0.5 * (y[:, None] - 1)
    return x, y


def training_kernels(call) -> tuple:
    """(call()'s result, its TRAIN_KERNELS launches by full name) from one
    `torch.profiler` window (PROFILE_PAD sleeps first; device activity only:
    the host's op records of 64 eager steps took the profiler minutes to
    order), and the device time of every kernel in the window, ms."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(200_000)
        torch.cuda.synchronize()
        out = call()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
              and e.time_range.start >= 0 and "spin_kernel" not in e.name]
    names = Counter(e.name for e in events if kernel_name(e.name) in TRAIN_KERNELS)
    return out, names, sum(device_us(e) for e in events) / 1e3


def wrapper_kernels(cfg, wrappers, batch: int, device) -> dict:
    """The kernel instances (TRAIN_KERNELS by full name, `training_kernels`)
    that one eager call of each of `wrappers` (K3 or K4: its forward, then
    its backward) launches on one layer of `cfg` at `batch` frames, the
    shapes of the scan step's layers: {wrapper: Counter}."""
    layer = EncoderLayer(cfg.d_model, cfg.ffn_hidden, cfg.n_head, device=device,
                         generator=torch.Generator().manual_seed(0))
    ops = flt.flat_weights(layer, torch.bfloat16)
    gen = torch.Generator().manual_seed(9)
    shape = (batch, cfg.num_tokens, cfg.d_model)
    x = torch.randn(shape, generator=gen).to(device, torch.bfloat16)
    dy = (0.1 * torch.randn(shape, generator=gen)).to(device, torch.bfloat16)
    seed = torch.tensor([TRAIN_SEED], dtype=torch.int32, device=device)
    args = (cfg.n_head, cfg.drop_prob, seed, 0)
    if wrappers == K4:
        stash = flt.fused_train_layer_fwd_stash(x, ops, *args)[1]
        calls = {K4[0]: lambda: flt.fused_train_layer_fwd_stash(x, ops, *args),
                 K4[1]: lambda: flt.fused_train_layer_bwd_stash(x, dy, stash, ops, *args)}
    else:
        calls = {K3[0]: lambda: flt.fused_train_layer_fwd(x, ops, *args),
                 K3[1]: lambda: flt.fused_train_layer_bwd(x, dy, ops, *args)}
    return {name: training_kernels(call)[1] for name, call in calls.items()}


def replay_launches(label: str, names: Counter, per_call: dict) -> dict:
    """Each of two wrappers' launches in a profiled window, from the window's
    own kernel instances (`names`) and each wrapper's instances in one call
    (`per_call`, `wrapper_kernels`): one wrapper's count from an instance
    that it launches and the other does not (K3-bwd's attention backward,
    K4's passes), the other's from its own first instance less what the
    first wrapper put there (K3-bwd recomputes K3-fwd's forward). Raises
    unless every instance of either wrapper is accounted for exactly."""
    (a, ca), (b, cb) = per_call.items()
    only_b = [n for n in cb if n not in ca]
    only_a = [n for n in ca if n not in cb]
    if only_b:
        nb = names[only_b[0]] / cb[only_b[0]]
        first = next(iter(ca))
        na = (names[first] - nb * cb[first]) / ca[first]
    elif only_a:
        na = names[only_a[0]] / ca[only_a[0]]
        first = next(iter(cb))
        nb = (names[first] - na * ca[first]) / cb[first]
    else:
        raise AssertionError(f"{label}: {a} and {b} launch the same kernel instances")
    counts = {a: int(round(na)), b: int(round(nb))}
    for n in set(ca) | set(cb):
        if names[n] != counts[a] * ca[n] + counts[b] * cb[n]:
            raise AssertionError(f"{label}: {names[n]} launches of {kernel_name(n)} are not "
                                 f"{counts[a]} x {ca[n]} ({a}) + {counts[b]} x {cb[n]} ({b})")
    return counts


def scan_experiment(cfg, batch: int, k: int, epochs: int = 1) -> ExperimentConfig:
    return ExperimentConfig(model=dataclasses.replace(cfg, drop_prob=SCAN_DROP),
                            data=DataConfig(synthetic_frame_len=cfg.seq_length),
                            train=TrainConfig(batch_size=batch, num_epochs=epochs,
                                              learning_rate=1e-3, device_scan_steps=k))


def scan_fit_pair(label: str, cfg, stats, device, card: str) -> dict:
    """`fit` twice from the same weights and seeds, per batch and through
    the scan graph: histories and parameters bit for bit (see the module
    docstring)."""
    train = scan_corpus(SCAN_TRAIN, cfg.seq_length, 1)
    valid = scan_corpus(SCAN_VALID, cfg.seq_length, 2)
    steps = SCAN_TRAIN // SCAN_BATCH
    runs = {}
    for k in (0, SCAN_K):
        exp = scan_experiment(cfg, SCAN_BATCH, k, SCAN_EPOCHS)
        model, pre = build_forward_and_preprocess(
            exp, AMCModel(exp.model, generator=torch.Generator().manual_seed(0)), stats, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        res = fit(exp, model, train, valid, preprocess_fn=pre, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[k] = {"history": res.history, "params": [p.detach().clone() for p in
                                                      model.parameters()],
                   "launches": {n: v for n, v in all_launches().items() if v},
                   "wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "epoch_ms_step": [t * 1e3 / steps for t in res.history["epoch_time"]]}
        del model, res
        torch.cuda.empty_cache()
    eager, scan = runs[0], runs[SCAN_K]
    for key in ("train_loss", "train_acc", "val_loss", "val_acc", "lr"):
        if eager["history"][key] != scan["history"][key]:
            raise AssertionError(f"{label}: fit's {key} through the scan graph "
                                 f"{scan['history'][key]} differs from per batch "
                                 f"{eager['history'][key]}")
    for i, (a, b) in enumerate(zip(eager["params"], scan["params"])):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: parameter {i} after the scanned fit differs from "
                                 f"the per-batch fit's by {(a - b).abs().max().item():.3g}")
    for k, run in runs.items():
        print(f"  {label} fit, device_scan_steps {k}, {SCAN_EPOCHS} epochs x {steps} steps at "
              f"B={SCAN_BATCH}: {run['wall_s']:.2f} s; ms/step over each epoch (host clock, "
              f"its evaluation of {SCAN_VALID} frames included) "
              + ", ".join(f"{v:.4f}" for v in run["epoch_ms_step"])
              + f"; peak device memory {run['peak_gib']:.3f} GiB; host counters "
              f"{run['launches']}  [{card}]", flush=True)
    print(f"  {label}: the histories ({eager['history']['train_loss']} train loss) and the "
          f"{len(eager['params'])} parameters are equal bit for bit", flush=True)
    return runs


def scan_graph_check(label: str, cfg, stats, per_step: dict, device, card: str,
                     k: int = SCAN_K, batch: int = SCAN_BATCH, wrappers=None) -> dict:
    """One group of k steps eager against the scan step's warm-up + capture,
    then one group eager against a replay, from the same weights, on the
    same batches; then SCAN_REPEATS groups of each timed (see the module
    docstring). `per_step`: each counted wrapper's launches in one eager
    step. `wrappers` (K3 or K4): count their launches in the replay's own
    trace (`replay_launches`), which must be k times `per_step`'s. Returns
    the eager group's host counters (`launches`), the replay's traced
    launches of `wrappers` (`scan_launches`) and the times."""
    from vitiq_torch.train.loop import make_train_scan_step

    exp = scan_experiment(cfg, batch, k)
    models = [build_forward_and_preprocess(
        exp, AMCModel(exp.model, generator=torch.Generator().manual_seed(0)), stats, device)
        for _ in range(2)]
    (model_e, pre_e), (model_g, pre_g) = models
    tx_e, tx_g = make_optimizer(exp.train), make_optimizer(exp.train)
    step = make_train_step(tx_e, exp.train.label_smoothing, pre_e)
    scan = make_train_scan_step(tx_g, exp.train.label_smoothing, pre_g)
    state_e = create_train_state(model_e, exp.train)
    state_g = create_train_state(model_g, exp.train)
    gen = torch.Generator().manual_seed(7)
    groups = [(torch.randn((k, batch, cfg.seq_length, 2), generator=gen).to(device),
               torch.randint(0, 3, (k, batch), generator=gen).to(device)) for _ in range(2)]
    seed = exp.train.dropout_seed

    def eager_group(xs, ys):
        for x, y in zip(xs, ys):
            step(state_e, x, y, seed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scan(state_g, *groups[0], seed)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    capture_s = next(iter(scan.capture_seconds.values()))
    reset_all_launches()
    eager_group(*groups[0])
    torch.cuda.synchronize()
    counts = {n: v for n, v in all_launches().items() if v}
    if counts != {n: k * v for n, v in per_step.items()}:
        raise AssertionError(f"{label}: {k} eager steps launched {counts}, expected {per_step} "
                             "a step")
    eager_names, eager_busy = Counter(), 0.0
    for c in range(0, k, SCAN_PROFILE_STEPS):
        part = [t[c:c + SCAN_PROFILE_STEPS] for t in groups[1]]
        _, names, busy = training_kernels(lambda: eager_group(*part))
        eager_names += names
        eager_busy += busy
    reset_all_launches()
    _, graph_names, graph_busy = training_kernels(lambda: scan(state_g, *groups[1], seed))
    if device.type == "cuda" and any(all_launches().values()):
        raise AssertionError(f"{label}: a replay ticked the host counters {all_launches()}")
    if not eager_names or graph_names != eager_names:
        raise AssertionError(f"{label}: the replay of {k} steps launched {dict(graph_names)}, "
                             f"the {k} eager steps {dict(eager_names)}")
    replayed = {}
    if wrappers:
        per_call = wrapper_kernels(exp.model, wrappers, batch, device)
        replayed = replay_launches(label, graph_names, per_call)
        if replayed != {n: k * per_step[n] for n in wrappers}:
            raise AssertionError(f"{label}: the replay's trace counts {replayed}, expected "
                                 f"{k} x {per_step}")
        print(f"  {label}: the replay's trace counts {replayed} (by "
              + ", ".join(f"{w}: {len(c)} kernel instances a call" for w, c in per_call.items())
              + ")", flush=True)
    for name, a, b in (("parameters", model_e.parameters(), model_g.parameters()),
                       ("moments", (state_e.opt_state.mu, state_e.opt_state.nu),
                        (state_g.opt_state.mu, state_g.opt_state.nu))):
        for i, (x, y) in enumerate(zip(a, b)):
            if not torch.equal(x, y):
                raise AssertionError(f"{label}: {name} {i} through the graph differ from eager "
                                     f"by {(x - y).abs().max().item():.3g}")
    if not int(state_e.step) == int(state_g.step) == 2 * k:
        raise AssertionError(f"{label}: steps {int(state_e.step)} / {int(state_g.step)}")

    def timed(call) -> tuple:
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(SCAN_REPEATS):
            call()
        end.record()
        end.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / (SCAN_REPEATS * k)
        return host, start.elapsed_time(end) / (SCAN_REPEATS * k)

    xs, ys = groups[1]
    out = {}
    for way, call, busy in (("eager", lambda: eager_group(xs, ys), eager_busy),
                            ("graph", lambda: scan(state_g, xs, ys, seed), graph_busy)):
        host, events = timed(call)
        out[way] = {"host_ms": host, "event_ms": events, "busy_ms": busy / k,
                    "idle": 1 - busy / k / host}
    print(f"  {label} scan graph, K={k}, B={batch}: first call (K eager steps + capture) "
          f"{first_s:.3f} s, capture {capture_s:.3f} s, peak device memory {peak:.3f} GiB; "
          f"a replay launched {sum(graph_names.values())} training kernels "
          f"({len(graph_names)} instances), as the {k} eager steps, which launched {counts}; "
          "parameters and moments bit for bit", flush=True)
    for way, t in out.items():
        print(f"  {label} {way}: {t['host_ms']:.4f} ms/step (host clock), {t['event_ms']:.4f} "
              f"ms/step (CUDA events), device kernel time {t['busy_ms']:.4f} ms/step, idle "
              f"share {t['idle']:.4f}  [{card}]", flush=True)
    del models, model_e, model_g, state_e, state_g, scan, groups
    torch.cuda.empty_cache()
    return {"launches": counts, "scan_launches": replayed, "times": out, "capture_s": capture_s,
            "first_s": first_s, "peak_gib": peak}


def sweep_check(device, card: str) -> dict:
    """The sweep phase (see the module docstring)."""
    from vitiq_torch.data import SyntheticAMCDataset
    from vitiq_torch.sweep import make_amc_fitness, run_pso_sweep

    print(f"phase sweep: PSO through one captured graph an architecture on {card}", flush=True)
    t0 = time.perf_counter()
    res = run_pso_sweep(n_particles=4, iters=2, train_steps=30, bucket=True, verbose=False,
                        device=device)
    wall = time.perf_counter() - t0
    print(f"  run_pso_sweep(n_particles=4, iters=2, train_steps=30, bucket=True): "
          f"{res['evaluations']} evaluations, {res['distinct_architectures_compiled']} "
          f"architectures captured, {wall:.2f} s; best accuracy "
          f"{res['best_val_accuracy']:.4f} at {res['best_hparams']}  [{card}]", flush=True)
    ds = SyntheticAMCDataset(classes=("BPSK", "QPSK", "16QAM"), frames_per_class=512,
                             frame_len=256, seed=0)
    split = int(0.85 * len(ds))
    fitness = make_amc_fitness((ds.X[:split], ds.Y[:split]), (ds.X[split:], ds.Y[split:]), 3,
                               256, train_steps=30, bucket=True, device=device)
    hp = {"arm": "rawiq", "segment_size": 16, "d_model": 128, "n_head": 8, "n_layers": 4,
          "ffn_hidden": 512, "drop_prob": 0.1, "learning_rate": 1e-3, "batch_size": 64}
    times, accs, params = {}, {}, {}
    for way, eager in (("eager", True), ("capture", False), ("replay", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accs[way] = fitness.eval_hp(hp, eager=eager)
        torch.cuda.synchronize()
        times[way] = time.perf_counter() - t0
        arch = next(iter(fitness.compile_cache.values()))
        params[way] = [p.detach().clone() for p in arch.model.parameters()]
    for way in ("capture", "replay"):
        if accs[way] != accs["eager"] or not all(
                torch.equal(a, b) for a, b in zip(params[way], params["eager"])):
            raise AssertionError(f"sweep: the evaluation through the graph ({way}: accuracy "
                                 f"{accs[way]}) differs from eager steps ({accs['eager']})")
    print(f"  one architecture ({hp}), 30 steps + the valid split: eager {times['eager']:.3f} "
          f"s, first graph call (eager warm-up + capture) {times['capture']:.3f} s, replay "
          f"{times['replay']:.3f} s; accuracy {accs['eager']:.4f} and the trained parameters "
          f"equal bit for bit  [{card}]", flush=True)
    del fitness
    torch.cuda.empty_cache()
    return {"result": res, "wall_s": wall, "times": times}


# the sweep at a longer budget (`--sweep`): a smaller swarm at the README's
# card example's train_steps, and the search space's largest architecture
SWEEP_SCALE = dict(n_particles=6, iters=3, train_steps=400)
SWEEP_LARGEST = {"arm": "rawiq", "segment_size": 4, "d_model": 512, "n_head": 16, "n_layers": 8,
                 "ffn_hidden": 2048, "drop_prob": 0.1, "learning_rate": 1e-3,
                 "batch_size": 128}


def sweep_scale_check(device, card: str) -> dict:
    """`run_pso_sweep(**SWEEP_SCALE, bucket=True)`: wall time, evaluations,
    graphs captured, the fitness's peak device memory; then SWEEP_LARGEST
    (the bounds' widest, deepest rawIQ model at the largest batch and the
    shortest segment, 64 tokens) for SWEEP_SCALE's train_steps: its first
    evaluation (eager warm-up + capture), the capture alone, a replayed
    evaluation, its peak memory and the cache's bytes for it
    (`_Arch.nbytes`). Nothing is gated but that they run."""
    from vitiq_torch.data import SyntheticAMCDataset
    from vitiq_torch.sweep import make_amc_fitness, run_pso_sweep

    steps = SWEEP_SCALE["train_steps"]
    print(f"phase sweep-scale: {SWEEP_SCALE} and the largest architecture on {card}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = run_pso_sweep(bucket=True, verbose=False, device=device, **SWEEP_SCALE)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  run_pso_sweep({SWEEP_SCALE}, bucket=True): {res['evaluations']} evaluations, "
          f"{res['distinct_architectures_compiled']} graphs captured, {wall:.2f} s, peak device "
          f"memory {peak:.3f} GiB  [{card}]", flush=True)
    torch.cuda.empty_cache()
    ds = SyntheticAMCDataset(classes=("BPSK", "QPSK", "16QAM"), frames_per_class=512,
                             frame_len=256, seed=0)
    split = int(0.85 * len(ds))
    fitness = make_amc_fitness((ds.X[:split], ds.Y[:split]), (ds.X[split:], ds.Y[split:]), 3,
                               256, train_steps=steps, bucket=True, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    for way in ("first", "replay"):
        t0 = time.perf_counter()
        fitness.eval_hp(SWEEP_LARGEST)
        torch.cuda.synchronize()
        times[way] = time.perf_counter() - t0
    arch = next(iter(fitness.compile_cache.values()))
    capture = next(iter(arch.scan.capture_seconds.values()))
    largest_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {SWEEP_LARGEST}, {steps} steps: first evaluation (eager warm-up + capture) "
          f"{times['first']:.3f} s, capture {capture:.3f} s, replayed evaluation "
          f"{times['replay']:.3f} s; peak device memory {largest_peak:.3f} GiB, the cache's "
          f"bytes for it {arch.nbytes / 2 ** 30:.3f} GiB  [{card}]", flush=True)
    del fitness, arch
    torch.cuda.empty_cache()
    return {"wall_s": wall, "peak_gib": peak, "largest": times, "capture_s": capture,
            "largest_peak_gib": largest_peak}


# `--steps`: the train steps whose dropout the plain sites' kernel draws, as
# the full run's timing phase times them; the flag runs on a tree without
# the kernel too, so that two trees compare in one call
def time_steps(device, card: str) -> dict:
    vit, raw = flagship_vit_config("tpu"), flagship_rawiq_config("tpu")
    conv = flagship_conv1d_config("tpu")
    plain = {"VITIQ_FUSED_TRAIN": "0"}
    cases = (("vit flagship (K3 kernels)", vit, STATS, 4096, 5, None),
             ("vit flagship (plain layers, VITIQ_FUSED_TRAIN=0)", vit, STATS, 4096, 3, plain),
             ("rawiq flagship (K4 kernels)", raw, RAW_STATS, 4096, 5, None),
             ("rawiq flagship (plain layers, VITIQ_FUSED_TRAIN=0)", raw, RAW_STATS, 4096, 3,
              plain),
             ("conv1d flagship (K5, remat auto)", conv, RAW_STATS, 256, 5, None),
             ("conv1d flagship (K5, VITIQ_TRAIN_REMAT=0)", conv, RAW_STATS, 256, 5,
              {"VITIQ_TRAIN_REMAT": "0"}),
             ("vit_tpu_production (plain layers with K5, VITIQ_FUSED_TRAIN=0)",
              VIT_TPU_PRODUCTION, STATS, 4096, 3, plain),
             ("vit_tiny_2016 (plain layers with K5, VITIQ_FUSED_TRAIN=0)",
              vit_tiny_2016_config("tpu"), STATS, 4096, 3, plain))
    return {label: time_train_step(label, cfg, stats, batch, device, card, iters, env)
            for label, cfg, stats, batch, iters, env in cases}


def scan_train_check(device, card: str) -> dict:
    """The scan-train phase (see the module docstring)."""
    t0 = time.perf_counter()
    print(f"phase scan-train: K={SCAN_K} train steps a captured CUDA graph on {card}", flush=True)
    vit_cfg, raw_cfg = flagship_vit_config("tpu"), flagship_rawiq_config("tpu")
    out = {}
    for label, cfg, stats, kernels in (("ViT flagship (K3)", vit_cfg, STATS, K3),
                                       ("rawIQ flagship (K4)", raw_cfg, RAW_STATS, K4)):
        t1 = time.perf_counter()
        pair = scan_fit_pair(label, cfg, stats, device, card)
        t2 = time.perf_counter()
        out[label] = {"fit": pair, **scan_graph_check(label, cfg, stats,
                                                      {n: cfg.n_layers for n in kernels},
                                                      device, card, k=SCAN_K, batch=SCAN_BATCH,
                                                      wrappers=kernels)}
        print(f"  {label}: fit pair {t2 - t1:.1f} s, graph check "
              f"{time.perf_counter() - t2:.1f} s", flush=True)
    conv = dataclasses.replace(flagship_conv1d_config("tpu"), n_layers=SCAN_CONV1D_LAYERS)
    # remat runs each layer's forward, K5-fwd with it, again in the backward
    out["conv1d"] = scan_graph_check(f"conv1d flagship at depth {SCAN_CONV1D_LAYERS} (K5, remat)",
                                     conv, RAW_STATS, {K5[0]: 2 * conv.n_layers,
                                                       K5[1]: conv.n_layers},
                                     device, card, k=SCAN_CONV1D_K, batch=SCAN_CONV1D_BATCH)
    print(f"  scan-train phase {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def export_check(device, card: str) -> dict:
    """The export phase (see the module docstring)."""
    import tempfile

    t0 = time.perf_counter()
    print(f"phase export: serving artifacts, one CUDA graph a bucket, on {card}", flush=True)
    raw_sps = dataclasses.replace(flagship_rawiq_config("tpu"),
                                  seq_length=DSP_SPS_FRAME // DSP_SPS)
    cases = (("vit flagship", flagship_vit_config("tpu"), STATS, DataConfig(), EXPORT_BUCKETS,
              EXPORT_SIZES),
             ("rawiq_best", rawiq_best_config("tpu"), RAW_STATS, DataConfig(), EXPORT_BUCKETS,
              EXPORT_SIZES),
             ("rawIQ flagship, sps 2, gardner (hybrid)", raw_sps, RAW_STATS,
              DataConfig(sps=DSP_SPS, timing_method="gardner"), EXPORT_SPS_BUCKETS,
              EXPORT_SPS_SIZES))
    launches, results = Counter(), {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, model_cfg, stats, data, buckets, sizes) in enumerate(cases):
            res = export_case(Path(tmp) / str(i), label, model_cfg, stats, data, buckets, sizes,
                              device)
            launches.update(res["launches"])
            results[label] = res
    print(f"  export phase {time.perf_counter() - t0:.1f} s; launches through the graphs "
          f"(torch.profiler) {dict(launches)}", flush=True)
    return {"launches": launches, "results": results}


MDF_BATCH, MDF_CLASSES = 1024, 19
MDF_REL = 1e-4
# a gradient that float32 itself resolves no better than this (the CPU's f32
# gradient against its float64 one, relative L2) is held to float64 within
# MDF_COND times the CPU's own error instead of MDF_REL: the first conv
# layers' weight gradients sum ~1M products through ReLU and max-pool, where
# f32 roundings flip which input a pool window passes on (the CPU's f32 reads
# up to ~1e-3 from float64 there, the later layers and the LSTM 1e-7-1e-5)
MDF_COND = 4.0


def mdf_run(name: str, model, x, labels, f32_conv, preprocess) -> tuple:
    """(logits, loss, gradients) of one cross-entropy step of MDF-NET on x,
    dropout off, in float64 on the host; the card's run ("card") then takes
    one Adam step, whose parameters and loss must stay finite. The control
    ("card, backward with TF32 on") runs its towers and LSTM in `f32_conv`
    and its head outside, as `MultiDomainModel.forward` does, but without
    its `_F32Region`, so autograd runs their backward under the global
    flag."""
    inputs = preprocess(x)
    if name.startswith("card, "):
        with f32_conv():
            fused = model._features(*inputs)
        out = model.head(torch.relu(model.fuse1(fused))).float()
    else:
        out = model(*inputs, train=True)  # no generator: dropout off, the eval forward
    loss = torch.nn.functional.cross_entropy(out, labels)
    loss.backward()
    grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()}
    if name == "card":
        torch.optim.Adam(model.parameters(), lr=1e-3).step()
        after = torch.nn.functional.cross_entropy(model(*inputs, train=True), labels).item()
        if not (math.isfinite(after) and all(torch.isfinite(p).all()
                                              for p in model.parameters())):
            raise AssertionError(f"MDF-NET's Adam step on the card: loss {after}")
    return out.detach().double().cpu(), loss.item(), grads


def mdf_check(device) -> dict:
    """MDF-NET (`models/mdf.py`) on the card against the same module on the
    CPU at B=MDF_BATCH, with TF32 off in its convolutions and LSTM, forward
    and backward: the forward's logits and a training step's loss
    (cross-entropy, dropout off) within MDF_REL relative of the CPU's f32,
    and each parameter's gradient within MDF_REL of the CPU's float64
    gradient, or within MDF_COND times the CPU's own f32 error where float32
    resolves it no better (see MDF_COND); then one Adam step, whose
    parameters and loss must stay finite. The card's runs set cuDNN's global
    TF32 flag on, PyTorch's default (a `reference` model turns it off for
    the process: `ops.numerics.policy_for`), and it must be on after the
    step. A control runs the backward of the towers and the LSTM under that
    flag (their forward in `f32_conv`, without the module's `_F32Region`):
    its gradients must fail the gate, or the region would guard nothing."""
    import copy

    from vitiq_torch.dsp.filtering import f32_conv
    from vitiq_torch.dsp.frontend import preprocess_batch_mdf
    from vitiq_torch.models.mdf import create_multi_domain_model

    cudnn = torch.backends.cudnn
    print("phase mdf: MDF-NET on the card vs the CPU", flush=True)
    t0 = time.perf_counter()
    cpu = create_multi_domain_model(MDF_CLASSES, generator=torch.Generator().manual_seed(0))
    x = torch.randn((MDF_BATCH, 1024, 2), generator=torch.Generator().manual_seed(3))
    labels = torch.arange(MDF_BATCH) % MDF_CLASSES
    runs = {}
    for name, dev, dtype in (("cpu", "cpu", torch.float32), ("f64", "cpu", torch.float64),
                             ("card", device, torch.float32),
                             ("card, backward with TF32 on", device, torch.float32)):
        tf32_on = (cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                               deterministic=cudnn.deterministic, allow_tf32=True)
                   if dev == device else contextlib.nullcontext())
        with tf32_on:
            runs[name] = mdf_run(name, copy.deepcopy(cpu).to(dev, dtype), x.to(dev, dtype),
                                 labels.to(dev), f32_conv, preprocess_batch_mdf)
            if dev == device and not cudnn.allow_tf32:
                raise AssertionError("MDF-NET left cuDNN's TF32 flag changed")

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    (l_cpu, loss_cpu, g_cpu), (_, _, g64), (l_card, loss_card, g_card) = (
        runs["cpu"], runs["f64"], runs["card"])
    worst = {"logits": rel(l_card, l_cpu), "loss": abs(loss_card - loss_cpu) / abs(loss_cpu)}

    def excesses(grads):
        out = {}
        for n in g64:
            err, own = rel(grads[n], g64[n]), rel(g_cpu[n], g64[n])
            out[n] = (err / max(MDF_REL, MDF_COND * own), err, own)
        return out

    control = excesses(runs["card, backward with TF32 on"][2])
    c = max(control, key=lambda k: control[k][0])
    print(f"  MDF-NET control, the backward with TF32 on: worst against its limit {c} "
          f"{control[c][1]:.3g} (CPU f32 {control[c][2]:.3g}, {control[c][0]:.3g} of its "
          f"limit); the largest "
          + ", ".join(f"{k} {v[1]:.3g} (CPU {v[2]:.3g})" for k, v in sorted(
              control.items(), key=lambda kv: -kv[1][1])[:3]), flush=True)
    if control[c][0] <= 1.0:
        raise AssertionError("MDF-NET's control passes the gradient gate: its backward with "
                             "TF32 on is as close to float64 as the module's own")
    excess = excesses(g_card)
    n = max(excess, key=lambda k: excess[k][0])
    print(f"  MDF-NET B={MDF_BATCH}: relative L2 card vs CPU: logits {worst['logits']:.3g}, "
          f"loss {worst['loss']:.3g}; gradients vs float64: worst against its limit {n} "
          f"{excess[n][1]:.3g} (CPU f32 {excess[n][2]:.3g}); the largest "
          + ", ".join(f"{k} {v[1]:.3g} (CPU {v[2]:.3g})" for k, v in sorted(
              excess.items(), key=lambda kv: -kv[1][1])[:3])
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    if max(worst.values()) > MDF_REL or excess[n][0] > 1.0:
        raise AssertionError(f"MDF-NET on the card differs from the CPU: {worst}, gradient "
                             f"{n} {excess[n][1:]}")
    return {**worst, "grads": {k: v[1] for k, v in excess.items()}}


# the parallel phase: the ViT flagship over two ranks on the card (spawned
# processes; two ranks share one card over gloo unless the machine has two)
PARALLEL_BATCH, PARALLEL_TP_BATCH, PARALLEL_STEPS = 512, 256, 6
PARALLEL_EVAL = 2048
# per-step loss against one process (vitiq's DP bound, tests/test_train.py),
# argmax agreement on rows whose top-2 logit margin is at least
# PARALLEL_MARGIN, and the phase's time limit
PARALLEL_LOSS_GAP, PARALLEL_AGREE, PARALLEL_MARGIN = 2e-3, 0.99, 0.05
PARALLEL_SECONDS = 90.0


def parallel_model(drop: float, device):
    """The ViT flagship (`tpu` numerics, seed 0, dropout `drop`) on `device`
    and its preprocess."""
    cfg = dataclasses.replace(flagship_vit_config("tpu"), drop_prob=drop)
    exp = train_experiment(cfg, PARALLEL_BATCH)
    return build_forward_and_preprocess(
        exp, AMCModel(cfg, generator=torch.Generator().manual_seed(0)), STATS, device) + (exp,)


def parallel_inputs(tmp: Path, kind: str):
    d = torch.load(tmp / f"inputs_{kind}.pt")
    return d["frames"], d["labels"], d["eval"]


def timed_steps(exp, model, pre, frames, labels, steps: int) -> tuple:
    """`steps` make_train_step steps on one batch: (losses, host ms a step
    after the first, the device synchronized)."""
    step = make_train_step(make_optimizer(exp.train, model), exp.train.label_smoothing, pre)
    state = create_train_state(model, exp.train)
    losses, t = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, frames, labels, exp.train.dropout_seed)
        losses.append(float(metrics["loss"]))
        if frames.is_cuda:
            torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    return losses, 1e3 * statistics.mean(t[1:])


def parallel_rank(rank: int, world: int, tmp: str, kind: str, steps: int,
                  eval_batch: int) -> None:
    """One rank of the DP 2 (`kind` "dp": K3 training at dropout 0, then K1/K2
    evaluation) or TP 2 ("tp": the plain layers with K5 at the flagship's
    dropout) world: the first step's whole gradient, PARALLEL_STEPS steps'
    losses, the launches of the main path's kernels (counters zeroed just
    before it), written to `tmp`."""
    from vitiq_torch.data.feeds import ArrayFeed
    from vitiq_torch.eval import predict_feed
    from vitiq_torch.parallel import comm
    from vitiq_torch.parallel.mesh import full_state_dict, make_mesh, shard_batch, shard_model

    tmp = Path(tmp)
    device = torch.device("cpu")
    if torch.cuda.is_available():
        _build.library()  # built by the parent: the ranks only load it
        device = torch.device("cuda", torch.cuda.current_device())
    frames, labels, eval_x = parallel_inputs(tmp, kind)
    dp = kind == "dp"
    mesh = make_mesh(data=2) if dp else make_mesh(data=1, model=2)
    model, pre, exp = parallel_model(0.0 if dp else TRAIN_DROP, device)
    shard_model(model, mesh)
    if dp:
        frames, labels = shard_batch((frames, labels), mesh)
    frames, labels = frames.to(device), labels.to(device)
    names = [n for n, _ in model.named_parameters()]
    model.train()
    loss = label_smoothed_cross_entropy(model(pre(frames), seed=TRAIN_SEED), labels, 0.1)
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    grads = full_state_dict(model, grads)
    grad = torch.cat([grads[n].reshape(-1).float() for n in names])
    comm.all_reduce_(grad, mesh.data_group)
    grad /= mesh.data_size
    reset_all_launches()
    losses, ms = timed_steps(exp, model, pre, frames, labels, steps)
    out = {"backend": comm.dist.get_backend(), "grad": grad.cpu(), "losses": losses, "ms": ms,
           "train_launches": all_launches()}
    if dp:
        reset_all_launches()
        model.eval()
        out["preds"] = predict_feed(model, ArrayFeed(eval_x.numpy(), np.zeros(len(eval_x),
                                                                              np.int32)),
                                    eval_batch, device, pre)[0]
        out["eval_launches"] = all_launches()
    torch.save(out, tmp / f"{kind}{rank}.pt")


def parallel_check(device, card: str) -> dict:
    """The parallel phase: the ViT flagship in two worlds of two ranks
    (`parallel.comm.spawn`, each rank a process on the card, after this
    process has built the kernel library) against one process on the same
    inputs: DP 2 trains through K3 at a global B=PARALLEL_BATCH, dropout 0,
    then evaluates PARALLEL_EVAL frames through K1/K2 sharded; TP 2 trains
    through the plain layers with K5 on 4 heads and FFN 256 a rank at the
    flagship's dropout, against one process's plain layers
    (VITIQ_FUSED_TRAIN=0) at B=PARALLEL_TP_BATCH. Gated: every step's loss
    within PARALLEL_LOSS_GAP relative, the first step's gradient cosine >=
    COSINE_F32, argmax agreement >= PARALLEL_AGREE on confident rows, each
    rank's launches of K3 (DP), K1/K2 (DP eval) and K5 (TP), and the phase
    within PARALLEL_SECONDS. Returns each rank's launches."""
    import tempfile

    from vitiq_torch.data.feeds import ArrayFeed
    from vitiq_torch.eval import predict_feed
    from vitiq_torch.parallel import comm

    t_start = time.perf_counter()
    print(f"phase parallel: the ViT flagship over 2 ranks (DP 2, then TP 2) on {card}",
          flush=True)
    gen = torch.Generator().manual_seed(23)
    L = flagship_vit_config("tpu").seq_length
    frames = torch.randn((PARALLEL_BATCH, L, 2), generator=gen)
    labels = torch.randint(0, flagship_vit_config("tpu").num_classes, (PARALLEL_BATCH,),
                           generator=gen)
    eval_x = torch.randn((PARALLEL_EVAL, L, 2), generator=gen)
    n = flagship_vit_config("tpu").n_layers
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        tmp = Path(tmp)
        runs = (("dp", PARALLEL_BATCH, 0.0), ("tp", PARALLEL_TP_BATCH, TRAIN_DROP))
        for kind, batch, _ in runs:
            torch.save({"frames": frames[:batch], "labels": labels[:batch], "eval": eval_x},
                       tmp / f"inputs_{kind}.pt")
        for kind, batch, drop in runs:
            env = {} if kind == "dp" else {"VITIQ_FUSED_TRAIN": "0"}
            os.environ.update(env)
            try:
                model, pre, exp = parallel_model(drop, device)
                x, y = frames[:batch].to(device), labels[:batch].to(device)
                g_one = flat_grad(model, pre(x), y, TRAIN_SEED)
                one_losses, one_ms = timed_steps(exp, model, pre, x, y, PARALLEL_STEPS)
                if kind == "dp":
                    model.eval()
                    preds = predict_feed(model, ArrayFeed(eval_x.numpy(),
                                                          np.zeros(PARALLEL_EVAL, np.int32)),
                                         PARALLEL_BATCH, device, pre)[0]
                    with torch.no_grad():
                        top2 = torch.cat([model(pre(eval_x[i:i + PARALLEL_BATCH].to(device)))
                                          .topk(2, dim=-1).values
                                          for i in range(0, PARALLEL_EVAL, PARALLEL_BATCH)])
                    confident = (top2[:, 0] - top2[:, 1] >= PARALLEL_MARGIN).cpu().numpy()
            finally:
                for k in env:
                    del os.environ[k]
            del model
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            comm.spawn(parallel_rank, 2, str(tmp), kind, PARALLEL_STEPS, PARALLEL_BATCH,
                       device=device.type)
            world_s = time.perf_counter() - t0
            ranks = [torch.load(tmp / f"{kind}{r}.pt", weights_only=False) for r in range(2)]
            label = (f"DP 2 (K3, B={batch}, {batch // 2} a rank, dropout 0)" if kind == "dp"
                     else f"TP 2 (plain layers with K5, 4 heads and FFN 256 a rank, B={batch}, "
                     f"dropout {TRAIN_DROP})")
            print(f"  {label}: backend {ranks[0]['backend']}, world up and done in "
                  f"{world_s:.1f} s on {card}", flush=True)
            gaps = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], one_losses)]
            print(f"    losses {['%.6g' % v for v in ranks[0]['losses']]} vs one process "
                  f"{['%.6g' % v for v in one_losses]}: max relative gap {max(gaps):.3g} "
                  f"(limit {PARALLEL_LOSS_GAP})", flush=True)
            cos = torch.nn.functional.cosine_similarity(ranks[0]["grad"], g_one.cpu(),
                                                        dim=0).item()
            print(f"    first step's gradient cosine vs one process {cos:.6f} (limit "
                  f"{COSINE_F32})", flush=True)
            print(f"    ms a step (host clock, synchronized; two ranks share the card, not a "
                  f"gain): ranks {ranks[0]['ms']:.2f} / {ranks[1]['ms']:.2f}, one process "
                  f"{one_ms:.2f}, on {card}", flush=True)
            if ranks[0]["losses"] != ranks[1]["losses"]:
                raise AssertionError(f"{label}: the ranks' reduced losses differ")
            if not max(gaps) <= PARALLEL_LOSS_GAP or not cos >= COSINE_F32:
                raise AssertionError(f"{label}: the world's training diverges from one process")
            want = ({K3[0]: n * PARALLEL_STEPS, K3[1]: n * PARALLEL_STEPS, K5[0]: 0, K5[1]: 0}
                    if kind == "dp" else
                    {K3[0]: 0, K3[1]: 0, K5[0]: n * PARALLEL_STEPS, K5[1]: n * PARALLEL_STEPS})
            for r, res in enumerate(ranks):
                got = {k: res["train_launches"][k] for k in want}
                print(f"    rank {r} train launches: {got}", flush=True)
                if got != want:
                    raise AssertionError(f"{label} rank {r} launched {got}, expected {want}")
            results[kind] = ranks
        ranks = results["dp"]
        eval_want = {"fused_encoder_layer": (n - 1) * PARALLEL_EVAL // PARALLEL_BATCH,
                     "fused_encoder_layer_cls": PARALLEL_EVAL // PARALLEL_BATCH}
        for r, res in enumerate(ranks):
            got = {k: res["eval_launches"][k] for k in eval_want}
            print(f"    rank {r} K1/K2 launches over {PARALLEL_EVAL} frames: {got}", flush=True)
            if got != eval_want:
                raise AssertionError(f"DP 2 evaluation rank {r} launched {got}, expected "
                                     f"{eval_want}")
            if not np.array_equal(res["preds"], ranks[0]["preds"]):
                raise AssertionError("the ranks' gathered predictions differ")
        agree = float((ranks[0]["preds"][confident] == preds[confident]).mean())
        print(f"  DP 2 evaluation (K1/K2, {PARALLEL_BATCH // 2} rows a rank a batch): argmax "
              f"agreement with one process {agree:.4f} on {int(confident.sum())} confident rows "
              f"(margin >= {PARALLEL_MARGIN}; limit {PARALLEL_AGREE}), "
              f"{float((ranks[0]['preds'] == preds).mean()):.4f} on all", flush=True)
        if not agree >= PARALLEL_AGREE:
            raise AssertionError("the sharded evaluation disagrees with one process")
    seconds = time.perf_counter() - t_start
    print(f"  parallel phase {seconds:.1f} s (limit {PARALLEL_SECONDS:.0f}) on {card}",
          flush=True)
    if seconds > PARALLEL_SECONDS:
        raise AssertionError(f"the parallel phase took {seconds:.1f} s")
    return {"dp_train": [r["train_launches"] for r in results["dp"]],
            "dp_eval": [r["eval_launches"] for r in results["dp"]],
            "tp_train": [r["train_launches"] for r in results["tp"]]}


PARALLEL_CLI_FRAMES = 512  # synthetic frames a class for the torchrun runs


def parallel_cli_check(card: str) -> dict:
    """The parallel-cli phase: ``cli train`` of the ViT flagship (``--arm vit
    --numerics tpu``, the 3-class synthetic corpus at PARALLEL_CLI_FRAMES a
    class, one epoch, B=256) under torchrun (`torch.distributed.run
    --standalone --nproc_per_node 2`), once with ``--data_parallel 2`` and
    once with ``--model_parallel 2``, in a temporary directory. Each must
    exit 0, print its backend, and leave a summary.json of one epoch and a
    model_best.npz in the one-process layout (`load_params`). Returns each
    run's seconds and test accuracy."""
    import tempfile

    print(f"phase parallel-cli: `cli train` of the ViT flagship under torchrun, DP 2 and TP 2, "
          f"on {card}", flush=True)
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = {}
    for flag in ("--data_parallel", "--model_parallel"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "2", "-m", "vitiq_torch.cli", "train", "--arm", "vit",
                   "--source", "synthetic", "--numerics", "tpu", "--frames_per_class",
                   str(PARALLEL_CLI_FRAMES), "--num_epochs", "1", "--no_plots", flag, "2"]
            t0 = time.perf_counter()
            run = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                                 timeout=300)
            seconds = time.perf_counter() - t0
            if run.returncode != 0:
                print(run.stdout[-4000:], run.stderr[-4000:], flush=True)
                raise AssertionError(f"torchrun cli train {flag} 2 exited {run.returncode}")
            backend = [ln for ln in run.stdout.splitlines() if ln.startswith("process group:")]
            exp_dir = Path(tmp) / "result" / "checkpoints" / "exp"
            summary = json.loads((exp_dir / "summary.json").read_text())
            cfg = ExperimentConfig.from_json(str(exp_dir / "config.json"))
            whole = AMCModel(cfg.model)
            whole.load_state_dict(load_params(exp_dir / "model_best.npz", cfg.model))
            print(f"  {flag} 2: exit 0 in {seconds:.1f} s (world start included) on {card}; "
                  f"{backend[0] if backend else 'no backend line'}; epochs "
                  f"{summary['epochs_run']}, test accuracy "
                  f"{summary['test_overall_accuracy']:.4f}; model_best.npz loads into a "
                  f"one-process model ({sum(p.numel() for p in whole.parameters()):,} "
                  f"parameters)", flush=True)
            if not backend or summary["epochs_run"] != 1:
                raise AssertionError(f"torchrun cli train {flag} 2: no backend line or no epoch")
            out[flag.strip("-")] = {"seconds": seconds,
                                    "test_accuracy": summary["test_overall_accuracy"]}
    return out


# the bench phase: the timing of every bench cut to a shallow slope
# (vitiq's knobs) and BENCH_STEPS eager calls a window, at the bench's own
# batches
BENCH_KNOBS = {"VITIQ_BENCH_K_SMALL": "2", "VITIQ_BENCH_K_CAP": "6", "VITIQ_BENCH_REPS": "2"}
BENCH_STEPS = 3
BENCH_WHICH = tuple(w for w in cli.BENCH_CHOICES if w not in ("ingestion", "all"))
BENCH_TAIL = 256  # the B=16384 batch's last rows, served again alone
BENCH_K5_BATCH = 256  # conv1d_infer at n_head 2: the plain layers take ~0.5 s at B=2048
# the kernels the bench phase must launch (`bench_launches` keys)
BENCH_KERNELS = ("fused_encoder_layer", "fused_encoder_layer_cls", "fused_encoder_layer_int8",
                 "cls_pool_kernel", "fused_train_layer_fwd", "fused_train_layer_bwd",
                 "wg_recompute_attention_fwd", "wg_recompute_attention_bwd",
                 "fused_train_layer_fwd_stash", "fused_train_layer_bwd_stash",
                 "fused_attention_fwd", "hash_dropout_kernel", TIMING_KERNEL)


def bench_window(call) -> tuple:
    """(call()'s result, every kernel it launched on the device by full
    name) from one `torch.profiler` window of device activity
    (PROFILE_PAD sleeps first, as `training_kernels`)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(200_000)
        torch.cuda.synchronize()
        out = call()
        torch.cuda.synchronize()
    return out, Counter(e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
                        and e.time_range.start >= 0 and "spin_kernel" not in e.name)


def bench_launches(windows: dict) -> dict:
    """Each kernels-line entry's launches (keyed by the first word of its
    name) in the bench phase's windows {label: kernel names}, from the
    kernels that one call of each wrapper launches once: K1 and K6 one
    attention_core_kernel (K6's are the int8_infer window's), K2 one
    cls_pool_kernel (in float and int8 serving alike), K3-fwd one attention
    forward pass and K3-bwd one forward (its recompute) and one backward
    pass, K4-fwd one wg_attention_fwd and K4-bwd one wg_attention_bwd_stash,
    K5-fwd one attention_fwd and K5-bwd one attention_bwd_dq; P3 is K1's
    core with its NOEXP flag (`<DH, true>`)."""
    fn, int8 = Counter(), Counter()
    for label, names in windows.items():
        for name, n in names.items():
            f = kernel_name(name)
            if f == "attention_core_kernel" and ", true>" in name:
                f = "attention_core_kernel_noexp"
            (int8 if label == "int8_infer" else fn)[f] += n
    k3b = fn["wg_recompute_attention_bwd"] + fn["train_attention_bwd"]
    k2 = fn["cls_pool_kernel"] + int8["cls_pool_kernel"]
    return {
        "fused_encoder_layer": fn["attention_core_kernel"],
        "fused_encoder_layer_cls": k2,
        "fused_encoder_layer_int8": int8["attention_core_kernel"],
        "cls_pool_kernel": k2,
        "fused_encoder_layer_int8attn": (fn["attention_int8_kernel"]
                                         + fn["attention_int8_sync_kernel"]),
        "attention_int8_kernel": fn["attention_int8_kernel"],
        "attention_int8_sync_kernel": fn["attention_int8_sync_kernel"],
        "fused_train_layer_fwd": (fn["wg_recompute_attention_fwd"] + fn["train_attention_fwd"]
                                  - k3b),
        "fused_train_layer_bwd": k3b,
        "wg_recompute_attention_fwd": fn["wg_recompute_attention_fwd"],
        "wg_recompute_attention_bwd": fn["wg_recompute_attention_bwd"],
        "fused_train_layer_fwd_stash": fn["wg_attention_fwd"],
        "fused_train_layer_bwd_stash": fn["wg_attention_bwd_stash"],
        "fused_attention_fwd": fn["attention_fwd"],
        "fused_attention_bwd": fn["attention_bwd_dq"],
        "hash_dropout_kernel": fn["hash_dropout_kernel"],
        TIMING_KERNEL: fn[TIMING_KERNEL],
        "mask_op_kernel": fn["mask_op_kernel"],
        "mm_mask_kernel": fn["mm_mask_kernel"],
        "refcost_kernel": fn["refcost_kernel"],
        "fused_encoder_layer_noexp": fn["attention_core_kernel_noexp"],
    }


def bench_tail_check(label: str, serve, x: torch.Tensor) -> float:
    """The logits of x's last BENCH_TAIL rows served in the whole batch
    against the same rows served alone: within EXPORT_TOL, the same argmax
    (a row's result does not depend on the batch it rides in; past 2^31
    bytes of an operand a 32-bit offset would break that)."""
    with torch.no_grad():
        whole = serve(x)[-BENCH_TAIL:]
        alone = serve(x[-BENCH_TAIL:].contiguous())
    torch.cuda.synchronize()
    if not (torch.isfinite(whole).all() and torch.isfinite(alone).all()):
        raise AssertionError(f"{label}: non-finite logits at B={x.shape[0]}")
    diff = (whole - alone).abs().max().item()
    same = bool((whole.argmax(-1) == alone.argmax(-1)).all())
    print(f"  {label}: the last {BENCH_TAIL} of B={x.shape[0]} rows against them alone: max "
          f"|dlogit| {diff:.6g} (limit {EXPORT_TOL}), argmax {'equal' if same else 'DIFFERS'}",
          flush=True)
    if not diff <= EXPORT_TOL or not same:
        raise AssertionError(f"{label}: rows served at B={x.shape[0]} differ from the same rows "
                             "alone")
    return diff


def check_bench_result(label: str, res: dict) -> None:
    """Every rate of a bench result positive and finite; a graph-timed step
    checked against its eager step."""
    for key in ("value", "eager_value"):
        if key in res and not (math.isfinite(res[key]) and res[key] > 0):
            raise AssertionError(f"bench {label}: {key} = {res[key]}")
    if "value" not in res:
        raise AssertionError(f"bench {label}: no value in {res}")
    graph = res.get("timing_method", res.get("step_timing")) == "graph-slope"
    if graph and res.get("graph_equals_eager") is not True:
        raise AssertionError(f"bench {label}: graph-timed step not checked against its eager step")


def bench_check(device, card: str) -> dict:
    """The bench phase (see the module docstring); returns `bench_launches`
    of its windows."""
    t_phase = time.perf_counter()
    print("phase bench: the three geometries no earlier phase serves, through Server, bf16 "
          "kernels vs f32 path", flush=True)
    for label, cfg, per_request in (
            ("rawiq_seg64 (17 tokens)", rawiq_seg64_config("tpu"), "K1 5 + K2 1"),
            ("rawiq_seg64_mp (16 tokens, mean-pool)", rawiq_seg64_mp_config("tpu"), "K1 6"),
            ("rawiq_mp (64 tokens, mean-pool)", rawiq_mp_config("tpu"), "K1 6")):
        res = serve_check(f"{label}, {per_request} a request", cfg, RAW_STATS, device,
                          (1, 37, 256, 1000), (256, 1024))
        if not res["raw_embed"]:
            raise AssertionError(f"{label} must be served through the fused raw embedding")
        del res
    train_check("rawiq_seg64_mp (K4 at L=16)", rawiq_seg64_mp_config("tpu"), RAW_STATS, K4, device,
                COSINE_F32)

    print(f"phase bench: the ViT flagship at B=16384 against its last {BENCH_TAIL} rows alone",
          flush=True)
    s = bench.fused_infer_setup("vit", 16384, device=device)
    x = s["x"]
    bench_tail_check("vit flagship bf16 (K1 + K2)",
                     lambda t: s["infer"](torch.zeros((), device=device), t)[1], x)
    cfg = s["cfg"]
    int8 = build_int8_serving_fn(ExperimentConfig(model=cfg, data=DataConfig()), s["model"],
                                 bench.FLAGSHIP_STATS, device)
    bench_tail_check("vit flagship int8 (K6 + K2)", int8, x)
    del s, x, int8
    torch.cuda.empty_cache()

    runs = [(w, lambda w=w: bench.run_benchmarks(w, steps=BENCH_STEPS, device=device))
            for w in BENCH_WHICH]
    runs += [("conv1d_infer --n_head 2 (K5-fwd)",
              lambda: bench.run_benchmarks("conv1d_infer", BENCH_K5_BATCH, BENCH_STEPS, n_head=2,
                                           device=device)),
             ("rawiq_best train B=8192 (K3)",
              lambda: bench.bench_train_step("rawiq_best", 8192, BENCH_STEPS, device=device)),
             ("rawiq_seg64_mp train B=8192 (K4)",
              lambda: bench.bench_train_step("rawiq_seg64_mp", 8192, BENCH_STEPS,
                                             device=device))]
    print(f"phase bench: run_benchmarks for every --which but ingestion and all, each under "
          f"torch.profiler, {BENCH_KNOBS}, {BENCH_STEPS} eager calls a window, on {card}:",
          flush=True)
    old = {k: os.environ.get(k) for k in BENCH_KNOBS}
    os.environ.update(BENCH_KNOBS)
    windows = {}
    try:
        for label, call in runs:
            t0 = time.perf_counter()
            res, windows[label] = bench_window(call)
            check_bench_result(label, res)
            rate = f"{res['value']:.1f} {res['unit']}"
            if "eager_value" in res:
                method = res.get("step_timing", res.get("timing_method"))
                rate += f" {method}, eager {res['eager_value']:.1f}"
            batch = res.get("batch_size", res.get("windows_per_call"))
            print(f"  {label}: {res['metric']} B={batch} {rate} (k_big {res.get('k_big')}; "
                  f"{time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
            torch.cuda.empty_cache()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counts = bench_launches(windows)
    print(f"  bench launches by kernel: {counts}", flush=True)
    missing = [k for k in BENCH_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the bench phase never launched {missing}")
    print(f"  bench phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    device = DEVICE
    card = card_line()
    print(f"phase device: {torch.cuda.get_device_name(0)} (count "
          f"{torch.cuda.device_count()}); nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    print("phase build:", flush=True)
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)} {[s.name for s in _build.sources()]} -> "
          f"{lib.relative_to(_build.BUILD_DIR.parents[1])} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if sys.argv[1:] == ["--latency"]:
        print(f"phase latency: small serving batches on {card}:", flush=True)
        print(json.dumps({"latency": time_small_batches(device, card)}), flush=True)
        return 0
    if sys.argv[1:] == ["--k4"]:
        print(f"phase k4: K4's layers, stages and train steps on {card}:", flush=True)
        print(json.dumps({"k4": time_k4(device, card)}), flush=True)
        return 0
    if sys.argv[1:] == ["--k3"]:
        print(f"phase k3: K3's layers, stages and train steps on {card}:", flush=True)
        print(json.dumps({"k3": time_k3(device, card)}), flush=True)
        return 0
    if sys.argv[1:] == ["--dsp"]:
        dsp_check(device, card)
        return 0
    if sys.argv[1:] == ["--export"]:
        export_check(device, card)
        mdf_check(device)
        return 0
    if sys.argv[1:] == ["--scan"]:
        scan_train_check(device, card)
        sweep_check(device, card)
        return 0
    if sys.argv[1:] == ["--sweep"]:
        sweep_check(device, card)
        sweep_scale_check(device, card)
        return 0
    if sys.argv[1:] == ["--steps"]:
        print(f"phase steps: train steps through the plain dropout sites on {card}:", flush=True)
        print(json.dumps({"steps": time_steps(device, card)}), flush=True)
        return 0
    if sys.argv[1:] == ["--parallel"]:
        launches = parallel_check(device, card)
        print(json.dumps({"parallel_launches": launches, "parallel_cli": parallel_cli_check(card)}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--bench"]:
        print(json.dumps({"bench_launches": bench_check(device, card)}), flush=True)
        return 0
    if sys.argv[1:] == ["--k2k7"]:
        print(f"phase k2k7: K2's and K7's layers, K7's core and their stages on {card}:",
              flush=True)
        print(json.dumps({"k2k7": time_k2k7(device, card)}), flush=True)
        return 0
    check_train_spills()
    check_k5_build()
    check_k6_build()
    check_k2k7_build()

    errs = check_kernels(device)
    errs["cls_pool"] = check_cls_pool(device)
    errs["k1_parts"] = check_k1_parts(device)
    errs.update(check_attention_kernels(device))
    errs["k6"] = check_int8_kernels(device)
    print("phase int8-stages: K6's s8 stages alone vs their plain versions on the GPU",
          flush=True)
    check_int8_stages(device)
    errs["k7"], core_errs = check_int8attn_kernels(device)
    errs["k7_core"], errs["k7_sync_core"] = core_errs["wgmma"], core_errs["sync"]

    print("phase serve: ragged requests through Server, bf16 kernels vs f32 path", flush=True)
    vit = serve_check("vit flagship", flagship_vit_config("tpu"), STATS, device,
                      (1, 37, 256, 1000), (256, 1024))
    rawiq = serve_check("rawiq flagship", flagship_rawiq_config("tpu"), RAW_STATS, device,
                        (1, 37, 256, 1000), (256, 1024))
    conv1d = serve_check("conv1d flagship", flagship_conv1d_config("tpu"), RAW_STATS, device,
                         (1, 37, 256), (64, 256))
    serve_check("conv1d flagship (plain layer loop, VITIQ_NO_FUSED_LAYER=1)",
                flagship_conv1d_config("tpu"), RAW_STATS, device, (1, 37, 256), (64, 256),
                k5_route=True)
    if vit["raw_embed"] or not rawiq["raw_embed"] or not conv1d["raw_embed"]:
        raise AssertionError("the fused raw embedding must serve the rawIQ arms only")

    print("phase serve-wide: the geometries past d_model 128 / d_head 32 through Server, bf16 "
          "kernels vs f32 path", flush=True)
    best = serve_check("rawiq_best", rawiq_best_config("tpu"), RAW_STATS, device,
                       (1, 37, 256), (64, 256))
    serve_check("rawiq_best_mp", rawiq_best_mp_config("tpu"), RAW_STATS, device, (1, 37),
                (64,))
    serve_check("vit_tiny_2016", vit_tiny_2016_config("tpu"), STATS, device, (1, 37, 256),
                (64, 256))
    serve_check("vit_tpu_production (d_head 64)", VIT_TPU_PRODUCTION, STATS, device,
                (1, 37, 256), (64, 256))
    if not best["raw_embed"]:
        raise AssertionError("rawiq_best must be served through the fused raw embedding")

    print("phase int8-serve: ragged requests through Server, int8 W8A8 (K6 + K2) vs the f32 "
          "path and the unfused int8 path", flush=True)
    vit8 = int8_serve_check("vit flagship", flagship_vit_config("tpu"), STATS, device,
                            (1, 37, 256, 1000), (256, 1024))
    raw8 = int8_serve_check("rawiq flagship", flagship_rawiq_config("tpu"), RAW_STATS, device,
                            (1, 37, 256, 1000), (256, 1024))
    int8_serve_check("conv1d flagship", flagship_conv1d_config("tpu"), RAW_STATS, device,
                     (1, 37, 256), (64, 256))
    best8 = int8_serve_check("rawiq_best", rawiq_best_config("tpu"), RAW_STATS, device,
                             (1, 37, 256), (64, 256))

    errs.update(check_train_kernels(device))
    errs.update({f"k4_{k}_pass": v for k, v in check_stash_passes(device).items()})
    errs.update({f"k3_{k}_pass": v for k, v in check_recompute_passes(device).items()})
    errs["k3_stages"] = check_train_stages(device)
    check_train_bits(device)
    errs[DROP_KERNEL] = check_hash_dropout(device)
    vit_train = train_check("ViT flagship", flagship_vit_config("tpu"), STATS, K3, device)
    raw_train = train_check("rawIQ flagship", flagship_rawiq_config("tpu"), RAW_STATS, K4, device)
    conv_train = conv1d_train_check(device)
    best_train = train_check("rawiq_best", rawiq_best_config("tpu"), RAW_STATS, K3, device,
                             COSINE_F32)
    train_check("rawiq_best_mp", rawiq_best_mp_config("tpu"), RAW_STATS, K4, device, COSINE_F32)
    vit_eval = evaluate_check(device)
    best_eval = evaluate_check(device, "rawiq_best", rawiq_best_config("tpu"),
                               epochs=BEST_EVAL_EPOCHS, lr=BEST_EVAL_LR, gate_accuracy=False)
    best_cli_train_check(device, card)
    train_check("vit_tiny_2016 (d_model 64)", vit_tiny_2016_config("tpu"), STATS, K4, device,
                COSINE_F32, batch=4096, grad_batch=256)
    train_check("vit_tpu_production (d_head 64)", VIT_TPU_PRODUCTION, STATS, K3, device,
                COSINE_F32, batch=4096, grad_batch=256)
    head_to_head_check(device, card, profile=True)
    head_to_head_check(device, card, n_head=2)
    t0 = time.perf_counter()
    stream_train_check(device, card)
    print(f"  stream-train phase {time.perf_counter() - t0:.1f} s", flush=True)
    dsp = dsp_check(device, card)
    exported = export_check(device, card)["launches"]
    mdf_check(device)
    scanned = scan_train_check(device, card)
    sweep_check(device, card)
    torch.cuda.empty_cache()
    parallel = parallel_check(device, card)
    parallel_cli_check(card)
    torch.cuda.empty_cache()
    benched = bench_check(device, card)

    print(f"phase timing (CUDA events after warm-up) on {card}:", flush=True)
    times = {name: time_serving_layers(name, L, ffn, B, D, device, card)
             for name, L, ffn, B, D in (("vit", 129, 512, 4096, 128),
                                        ("rawiq", 65, 1024, 4096, 128),
                                        ("conv1d", CONV1D_L, 1024, 256, 128),
                                        ("rawiq_best", 65, 1024, 4096, 256))}
    for name, L, ffn, D in (("vit", 129, 512, 128), ("rawiq", 65, 1024, 128),
                            ("rawiq_best", 65, 1024, 256)):
        times[name]["k1_library_ms"] = time_k1_library(name, L, ffn, device, card, D=D)
        times[name].update(time_int8_layers(name, L, ffn, device, card, D=D))
    times["conv1d"]["k1_library_ms"] = time_k1_library("conv1d", CONV1D_L, 1024, device, card,
                                                       batch=256)
    for name, L, ffn, B, D in (("vit", 129, 512, 4096, 128), ("rawiq", 65, 1024, 4096, 128),
                               ("conv1d", CONV1D_L, 1024, 256, 128),
                               ("rawiq_best", 65, 1024, 4096, 256)):
        times[name].update(time_int8attn_layers(name, L, ffn, device, card, B=B, D=D))
    times["vit"].update(time_train_layers("vit", 129, 512, TRAIN_DROP, device, card, False))
    times["rawiq"].update(time_train_layers("rawiq", 65, 1024, RAW_DROP, device, card, True))
    times["rawiq_best"].update(time_train_layers("rawiq_best", 65, 1024, BEST_DROP, device, card,
                                                 False, D=256))
    # the other widths' layers: printed with their bounds, not in the kernels line
    time_train_layers("rawiq_best_mp", 64, 1024, BEST_DROP, device, card, True, D=256, k3=False)
    time_train_layers("rawIQ flagship at n_head 2", 65, 1024, RAW_DROP, device, card, True,
                      k3=False, H=2)
    times["vit_tpu_production"] = time_train_layers("vit_tpu_production", 129, 512, TRAIN_DROP,
                                                    device, card, False, H=2)
    times["vit_tiny_2016"] = time_train_layers("vit_tiny_2016", 17, 256, TRAIN_DROP, device, card,
                                               True, D=64, H=4)
    for name, L, ffn, D, H in (("vit", 129, 512, 128, 8), ("rawiq", 65, 1024, 128, 8),
                               ("rawiq_best", 65, 1024, 256, 8),
                               ("vit_tpu_production", 129, 512, 128, 2),
                               ("vit_tiny_2016", 17, 256, 64, 4)):
        times[name]["train_library_ms"] = time_train_library(name, L, ffn, device, card,
                                                             times[name], D=D, H=H)
    for name, L, D, F, H, drop in (("rawiq_best", 65, 256, 1024, 8, BEST_DROP),
                                   ("vit", 129, 128, 512, 8, TRAIN_DROP)):
        profile_k3_stages(name, 4096, L, D, F, H, drop, device, card)
    times["k4_passes"] = time_stash_passes(device, card)
    times["k3_passes"] = time_recompute_passes(device, card)
    for name, L, D, F, H, drop in (("rawiq", 65, 128, 1024, 8, RAW_DROP),
                                   ("rawiq_best_mp", 64, 256, 1024, 8, BEST_DROP)):
        profile_k4_stages(name, 4096, L, D, F, H, drop, device, card)
    time_k3_host(device, card)
    times["conv1d"].update(time_attention(device, card))
    times[DROP_KERNEL] = time_hash_dropout(device, card)

    vit_cfg, raw_cfg = flagship_vit_config("tpu"), flagship_rawiq_config("tpu")
    conv_cfg = flagship_conv1d_config("tpu")
    time_train_step("vit flagship (K3 kernels)", vit_cfg, STATS, 4096, device, card, 5)
    profile_train_step("vit flagship (K3 kernels)", vit_cfg, STATS, 4096, device, card)
    time_train_step("vit flagship (plain layers, VITIQ_FUSED_TRAIN=0)", vit_cfg, STATS, 4096,
                    device, card, 3, {"VITIQ_FUSED_TRAIN": "0"})
    time_train_step("rawiq flagship (K4 kernels)", raw_cfg, RAW_STATS, 4096, device, card, 5)
    profile_train_step("rawiq flagship (K4 kernels)", raw_cfg, RAW_STATS, 4096, device, card)
    time_train_step("rawiq flagship (K3 kernels, VITIQ_TRAIN_STASH=0)", raw_cfg, RAW_STATS, 4096,
                    device, card, 5, {"VITIQ_TRAIN_STASH": "0"})
    time_train_step("rawiq flagship (plain layers, VITIQ_FUSED_TRAIN=0)", raw_cfg, RAW_STATS,
                    4096, device, card, 3, {"VITIQ_FUSED_TRAIN": "0"})
    time_train_step("conv1d flagship (K5, remat auto)", conv_cfg, RAW_STATS, 256, device, card,
                    5)
    time_train_step("conv1d flagship (K5, VITIQ_TRAIN_REMAT=0)", conv_cfg, RAW_STATS, 256, device,
                    card, 5, {"VITIQ_TRAIN_REMAT": "0"})
    profile_train_step("conv1d flagship (K5, remat auto)", conv_cfg, RAW_STATS, 256, device, card,
                       watch=fa.KERNELS)
    time_train_step("rawiq_best (K3 kernels)", rawiq_best_config("tpu"), RAW_STATS, 4096, device,
                    card, 5)
    profile_train_step("rawiq_best (K3 kernels)", rawiq_best_config("tpu"), RAW_STATS, 4096,
                       device, card)
    time_train_step("rawiq_best_mp (K4 kernels)", rawiq_best_mp_config("tpu"), RAW_STATS, 4096,
                    device, card, 5)
    profile_train_step("rawiq_best_mp (K4 kernels)", rawiq_best_mp_config("tpu"), RAW_STATS, 4096,
                       device, card)
    for label, cfg, kernels in (("vit_tpu_production", VIT_TPU_PRODUCTION, "K3"),
                                ("vit_tiny_2016", vit_tiny_2016_config("tpu"), "K4")):
        time_train_step(f"{label} ({kernels} kernels)", cfg, STATS, 4096, device, card, 5)
        time_train_step(f"{label} (plain layers with K5, VITIQ_FUSED_TRAIN=0)", cfg, STATS, 4096,
                        device, card, 3, {"VITIQ_FUSED_TRAIN": "0"})

    for label, res, batch in (("vit flagship", vit, 4096), ("rawiq flagship", rawiq, 4096),
                              ("conv1d flagship", conv1d, 2048)):
        serve = build_serving_fn(res["exp"], res["model"], res["stats"], device)
        time_serving(label + " (kernels)", serve, batch, device, card)
        os.environ["VITIQ_NO_FUSED_LAYER"] = "1"
        try:
            time_serving(label + " (plain layer loop, VITIQ_NO_FUSED_LAYER=1)", serve, batch,
                         device, card)
        finally:
            del os.environ["VITIQ_NO_FUSED_LAYER"]
    for label, res in (("vit flagship", vit8), ("rawiq flagship", raw8)):
        time_serving(label + " (int8 W8A8: K6 + K2)", res["serve"], 4096, device, card)
    time_serving("rawiq_best (kernels)",
                 build_serving_fn(best["exp"], best["model"], best["stats"], device), 4096,
                 device, card)
    time_serving("rawiq_best (int8 W8A8: K6 + K2)", best8["serve"], 4096, device, card)
    time_small_batches(device, card)
    os.environ["VITIQ_ATTN_INT8"] = "1"
    try:
        for label, res, batch in (("vit flagship", vit, 4096), ("conv1d flagship", conv1d, 2048)):
            serve = build_serving_fn(res["exp"], res["model"], res["stats"], device)
            time_serving(label + " (int8 attention, VITIQ_ATTN_INT8=1: K7 + K2)", serve, batch,
                         device, card)
    finally:
        del os.environ["VITIQ_ATTN_INT8"]

    print(f"phase probes: P1-P3 (vitiq_torch/probes/, csrc/probes.cu, K1's NOEXP flag) on "
          f"{card}:", flush=True)
    check_probe_builds()
    check_noexp_sass()
    probes = drive_probes(device, card)
    probe_times = check_probes(device, card, probes)
    for name, B, L, D, F in (("vit", 4096, 129, 128, 512), ("conv1d", 256, CONV1D_L, 128, 1024),
                             ("rawiq_best", 4096, 65, 256, 1024)):
        profile_k1_stages(name, B, L, D, F, 8, device, card)
    print(f"phase k2k7-stages: K2 and K7 by stage on {card}:", flush=True)
    for name, L, F, D, H, B in K2K7_SHAPES:
        profile_k2_k7_stages(name, B, L, D, F, H, device, card)

    counts, k3, k4, k5 = vit["counts"], vit_train["counts"], raw_train["counts"], conv_train["counts"]
    vt, rt, ct, bt = times["vit"], times["rawiq"], times["conv1d"], times["rawiq_best"]
    # K3's passes run inside K3-fwd (the forward) and K3-bwd (the forward in
    # its recompute, then the backward): their launches are K3's at shapes
    # the routing sends to them (rawiq_best's forward, the ViT flagship's
    # backward; `flt.recompute_tile_plan`)
    kp, bk3 = times["k3_passes"], best_train["counts"]
    # the scan-train phase's replays of K3 / K4, counted in the replay's own
    # torch.profiler trace (`replay_launches`)
    scan_k3 = scanned["ViT flagship (K3)"]["scan_launches"]
    scan_k4 = scanned["rawIQ flagship (K4)"]["scan_launches"]
    if not (flt.recompute_tile_plan(65, 32)["fwd_wgmma"]
            and flt.recompute_tile_plan(129, 16)["bwd_wgmma"]):
        raise AssertionError("K3's wgmma passes are not on the main path's route")

    def par(world, name):  # each rank's launches in the parallel phase
        return [r[name] for r in parallel[world]]

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd, library_ms):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}

    # `launches` are the serve phase's zeroed counters; `export_launches` the
    # export phase's launches through the graphs, which host counters do not
    # see, from its torch.profiler traces (one K1 call launches one
    # attention_core_kernel, one K2 call one cls_pool_kernel)
    kernels = [
        {**entry("fused_encoder_layer (K1, full layers)", SOURCE, f"{TPU_SOURCE}:717",
                 counts["fused_encoder_layer"], errs["k1"], vt["k1_ms"], vt["k1_plain_ms"],
                 vt["k1"], vt["k1_library_ms"]),
         "export_launches": exported["attention_core_kernel"],
         "parallel_launches": par("dp_eval", "fused_encoder_layer")},
        {**entry("fused_encoder_layer_cls (K2, CLS row)", SOURCE, f"{TPU_SOURCE}:920",
                 counts["fused_encoder_layer_cls"], errs["k2"], vt["k2_ms"], vt["k2_plain_ms"],
                 vt["k2"], None),
         "export_launches": exported["cls_pool_kernel"],
         "parallel_launches": par("dp_eval", "fused_encoder_layer_cls")},
        entry("fused_encoder_layer_int8 (K6, W8A8 full layers)", SOURCE, f"{TPU_SOURCE}:1695",
              vit8["counts"][K6], errs["k6"], vt["k6_ms"], vt["k6_plain_ms"], vt["k6"], None),
        {**entry("cls_pool_kernel (K2's pooling: the CLS query's attention as one read of x)",
                 SOURCE, f"{TPU_SOURCE}:371", vit["kernel_counts"]["cls_pool_kernel"],
                 errs["cls_pool"], vt["pool_ms"], vt["pool_plain_ms"], vt["pool"],
                 vt["pool_sdpa_ms"]),
         "export_launches": exported["cls_pool_kernel"]},
        entry("fused_encoder_layer_int8attn (K7, int8-attention full layers)", SOURCE,
              f"{TPU_SOURCE}:812", vit_eval["k7_launches"], errs["k7"], vt["k7_ms"],
              vt["k7_plain_ms"], vt["k7"], None),
        entry("attention_int8_kernel (K7's int8 attention core on s8 wgmma, past 96 tokens: "
              "the ViT flagship)", SOURCE, f"{TPU_SOURCE}:812",
              vit_eval["kernel_launches"]["attention_int8_kernel"], errs["k7_core"],
              vt["k7_core_ms"], vt["k7_core_plain_ms"], vt["k7_core"], None),
        entry("attention_int8_sync_kernel (K7's int8 attention core on mma.sync, up to 96 "
              "tokens: rawiq_best)", SOURCE, f"{TPU_SOURCE}:812",
              best_eval["kernel_launches"]["attention_int8_sync_kernel"], errs["k7_sync_core"],
              bt["k7_core_ms"], bt["k7_core_plain_ms"], bt["k7_core"], None),
        {**entry("fused_train_layer_fwd (K3-fwd)", TRAIN_SOURCE, f"{TRAIN_TPU_SOURCE}:417",
                 k3["fused_train_layer_fwd"], errs["k3f"], vt["k3f_ms"], vt["k3f_plain_ms"],
                 vt["k3f"], None),
         "scan_launches": scan_k3[K3[0]], "parallel_launches": par("dp_train", K3[0])},
        {**entry("fused_train_layer_bwd (K3-bwd)", TRAIN_SOURCE, f"{TRAIN_TPU_SOURCE}:674",
                 k3["fused_train_layer_bwd"], errs["k3b"], vt["k3b_ms"], vt["k3b_plain_ms"],
                 vt["k3b"], None),
         "scan_launches": scan_k3[K3[1]], "parallel_launches": par("dp_train", K3[1])},
        entry("wg_recompute_attention_fwd (K3's attention forward pass, rawiq_best)",
              TRAIN_SOURCE, f"{TRAIN_TPU_SOURCE}:202", bk3[K3[0]] + bk3[K3[1]],
              errs["k3_fwd_pass"], kp["rawiq_best"]["fwd_ms"], kp["rawiq_best"]["fwd_plain_ms"],
              kp["rawiq_best"]["fwd"], kp["rawiq_best"]["sdpa_fwd_ms"]),
        entry("wg_recompute_attention_bwd (K3's attention backward pass, ViT)", TRAIN_SOURCE,
              f"{TRAIN_TPU_SOURCE}:1195", k3[K3[1]], errs["k3_bwd_pass"], kp["vit"]["bwd_ms"],
              kp["vit"]["bwd_plain_ms"], kp["vit"]["bwd"], kp["vit"]["sdpa_bwd_ms"]),
        {**entry("fused_train_layer_fwd_stash (K4-fwd)", TRAIN_SOURCE,
                 f"{TRAIN_TPU_SOURCE}:478", k4["fused_train_layer_fwd_stash"], errs["k4f"],
                 rt["k4f_ms"], rt["k4f_plain_ms"], rt["k4f"], None),
         "scan_launches": scan_k4[K4[0]]},
        {**entry("fused_train_layer_bwd_stash (K4-bwd)", TRAIN_SOURCE,
                 f"{TRAIN_TPU_SOURCE}:674", k4["fused_train_layer_bwd_stash"], errs["k4b"],
                 rt["k4b_ms"], rt["k4b_plain_ms"], rt["k4b"], None),
         "scan_launches": scan_k4[K4[1]]},
        {**entry("fused_attention_fwd (K5-fwd)", ATTN_SOURCE, f"{ATTN_TPU_SOURCE}:62",
                 k5[K5[0]], errs["k5f"], ct["k5f_ms"], ct["k5f_plain_ms"], ct["k5f"],
                 ct["sdpa_fwd_ms"]),
         "parallel_launches": par("tp_train", K5[0])},
        {**entry("fused_attention_bwd (K5-bwd)", ATTN_SOURCE, f"{ATTN_TPU_SOURCE}:176",
                 k5[K5[1]], errs["k5b"], ct["k5b_ms"], ct["k5b_plain_ms"], ct["k5b"],
                 ct["sdpa_bwd_ms"]),
         "parallel_launches": par("tp_train", K5[1])},
    ]
    dt = times[DROP_KERNEL]
    kernels.append({**entry("hash_dropout_kernel (the plain dropout sites: the embedding's and "
                            "the plain layers'; no TPU twin: the JAX package draws these masks "
                            "with jax.random.bernoulli)", TRAIN_SOURCE, DROP_JAX,
                            k5[DROP_KERNEL], errs[DROP_KERNEL], dt["ms"], dt["plain_ms"],
                            dt["bound"], None),
                    "tpu_twin": False})
    scan = dsp["times"]["scan"]["gardner_hybrid"]
    kernels.append({**entry(f"{TIMING_KERNEL} (the SPS front-end's timing recovery: the coarse "
                            "phase, the Gardner / Mueller-Mueller loops, the circular mean, the "
                            "strobes; timed in symbols mode, Gardner, hybrid; no TPU twin: the "
                            "JAX package runs a lax.scan)", TIMING_SOURCE, TIMING_JAX_LOOPS,
                            dsp["launches"], dsp["err"]["phase"], scan["ms"], scan["plain_ms"],
                            scan["bound"], None),
                    "export_launches": exported[TIMING_KERNEL], "tpu_twin": False})
    for name in mask_ops.VARIANTS + mask_ops.MM_VARIANTS:
        t = probe_times[name]
        kernel = "mm_mask_kernel" if name.startswith("mm_") else "mask_op_kernel"
        kernels.append({**entry(f"{kernel} {name} (P1)", PROBES_SOURCE,
                                f"{P1_TPU_SOURCE}:{P1_TPU_LINES[name]}", probes["p1"][name],
                                t["err"], t["ms"], t["plain_ms"], t["bound"], t["library_ms"]),
                        "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"]})
    for tag, nrefs, width in refcost.arms(REFCOST_ARGS[2]):
        t = probe_times[tag]
        kernels.append({**entry(f"refcost_kernel {tag}: {2 * nrefs} operands (P2)",
                                PROBES_SOURCE, P2_TPU,
                                probes["p2"].get(refcost.arm_key(nrefs, width), 0), t["err"],
                                t["ms"], t["plain_ms"], t["bound"], t["library_ms"]),
                        "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"]})
    t = probe_times["p3"]
    kernels.append(entry("fused_encoder_layer_noexp (P3, K1 without its exp)", SOURCE, P3_TPU,
                         probes["p3"], probe_times["p3_err"], t["ms"], t["plain_ms"],
                         t["bound"], None))
    for k in kernels:
        k["bench_launches"] = benched[k["name"].split(" ")[0]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    print(f"chip_smoke.py: every phase passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
