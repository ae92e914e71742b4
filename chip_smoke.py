#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dcgan_sr_tpu_torch) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each fatal on failure:
  1. card name and power limit (nvidia-smi); build of every kernel of every
     path from csrc/ with nvcc (one nvcc per source — bulge.cu,
     bulge_wgmma.cu, preprocess.cu, fused_nhwc.cu, fused_nhwc_wgmma.cu —
     started together),
     timed, with the `-Xptxas -v` resource lines.
  2. kernels: first the fp32 wgmma kernels' layout probe (two k-steps of
     wgmma .tf32 on raw fp32 words: the result must be the product of the
     words truncated to TF32, which pins the core-matrix layout and shows
     how the tensor cores read an fp32 word).  Then the fused bulge kernel
     (ops/bulge.py), each fp32 implementation that takes the shape (the
     wgmma kernel of csrc/bulge_wgmma.cu the paths run, the mma.sync kernel
     and the earlier FMA kernel of csrc/bulge.cu), against its plain
     PyTorch version on the card
     (cuDNN with TF32 off), at the gray-3 serve shapes x (1,16,256,256),
     (4,16,1024,1024) and (1,16,2048,2048) (the pair's input at LR 32, 128
     and 256) and the eval batch (100,16,256,256), in all three BN
     statistics modes, with the fixture's
     layer-3/4 weights; then at the ragged and small geometries of
     tests/test_torch_cuda.py, at ragged shapes the wgmma kernel takes (W
     % 4 == 0) and at 70,000 images.  Times per call for each launch of each
     implementation, taken in turns (fma, mma, wgmma, wgmma, mma, fma), the
     plain version and the cuDNN unfused composition; it is an error if
     `bulge()`'s choice is not the fastest.
  3. where a request's time goes: device time of one generator forward at
     LR 256x256, step by step (each layer, and the fused pair), fused and
     unfused, in both BN modes.
  4. path: `python -m dcgan_sr_tpu_torch.serve` on 127.0.0.1 with the
     full-width gray-3 fixture, once with --parity-bn and once with the
     default running-stats BN.  2x requests at LR 32x32, 100x72 and 256x256,
     one restore request, one 8-way concurrent burst, then a run of timed
     256x256 requests; every response is held against the plain-version
     generator's output on the card, and /healthz must show the kernels'
     launch counts move from 0.
  5. kernel: the fused preprocess (ops/preprocess.py, csrc/preprocess.cu)
     against its plain PyTorch version on the card at the trainer's shapes
     (100,1,64,64) flags off, (100,3,64,64) gray+pm1 and pm1 only,
     (1280,1,8,8), the ragged (3,3,50,38), and a bandwidth probe
     (8,3,2048,2048) gray+pm1 that is no path shape.  Times per call for
     the kernel, the plain version and the avg_pool2d composition; at the
     path shapes, for the kernel and that composition alike, the host's time
     to queue a call, the eager time per call, and the device time per call
     from a captured CUDA graph of 100 calls, replayed (the captured outputs
     equal the plain version's bit for bit).
  6. the training step, kernel against plain: from one initial state (seed
     0) and the same two batches, two gray-3 steps at full width (ngf 8,
     ndf 64, batch 100) through build_train_step(cfg) and two through the
     same step with preprocess_plain; the preprocess launch count must move
     by exactly 2, then by 0.
  7. path: `python -m dcgan_sr_tpu_torch.cli --config gray-3 --synthetic
     --steps 6 --scan 2 --epochs 1 --seed 1 --checkpoint-dir <tmp>` as a
     user starts it, at full width: finite losses on reference-shaped log
     lines, 6 preprocess launches run (the CLI's last line counts the
     launches that ran, train/multi_step.py `launches_run`: the warm-up
     chunk's 2, and the graph's 2 captured launches x 2 replays; its
     "graph launches" line: 1 capture, 2 replays), both checkpoints written, the G
     file loaded through load_generator and used to upscale one image, and
     `--resume` continuing at epoch 2 with Adam's step count 8.
  8. where a step's time goes: CUDA events after each stage of the step
     (2 warm-up steps, then 10 queued without waiting in between), the whole
     step in ms and images/s, the host's time to queue a step, peak
     device memory, and the training generator's forward layer by layer
     (cuDNN's autotuning had changed neither by 1%, so it is not rerun).
  9. kernel: the channels-last fused pair (ops/fused_nhwc.py), each
     implementation it has at a shape (the TMA and wgmma kernel of
     csrc/fused_nhwc_wgmma.cu and the mma.sync kernel of csrc/fused_nhwc.cu
     at their triples, the FMA kernel everywhere), against its plain
     PyTorch version on the card at (B, Ci, Cm, Co, H, W) = (2,5,4,6,16,16)
     tm 8, (1,16,8,16,32,32) tm 16, (3,3,2,3,8,8) tm 8 (the shapes of
     tests/test_pallas_fused.py), (2,32,16,32,32,37) tm 16,
     (1,16,8,16,256,256) and (100,16,8,16,256,256) tm 32, and
     (70000,16,8,16,8,8) tm 8 (more images than a grid dimension takes);
     the chosen one also against the bulge kernel on the same inputs.  At
     (100,16,8,16,256,256): each launch of the two tensor-core kernels and
     the whole call (`pair_ms`, transposes included) timed in turns (mma,
     wgmma, wgmma, mma), an error if the chosen one is the slower; the FMA
     kernel once, the plain version's two phases, the cuDNN composition
     and K2's kernel on the same x.
 10. kernel: the bulge kernel at the overlap pipeline's shapes, with the
     overlap fixture's layer-3/4 weights (Ci 32, Cm 16, Co 32): x
     (225,32,32,32) pooled, (14400,32,32,32) running and grouped by 225;
     all three fp32 implementations, timed in turns.
 11. path: `python -m dcgan_sr_tpu_torch.bench_fused --kernel nhwc` and
     `--kernel bulge` as subprocesses at the default batch 100, hw 256,
     fp32; the JSON line parsed, max_abs_diff held to the y tolerance, the
     launch counts on the line before it moved from 0, every launch by the
     implementation the shape gets (wgmma, both kernels; the line before
     that).
 12. path: the overlap pipeline (infer/tiled.py make_overlap_sr_fn) for
     gray-patch-batch-overlap at full width from its fixture, 64 images of
     64x64 from a seed, per-image-tile BN and running-stats BN, fused
     against fuse=False: tiles and the naive stitch within the y tolerance;
     the device seam stitch equal to the host replay on the fused tiles bit
     for bit in both seam modes; lr_input on the degraded images giving the
     same input tiles bit for bit and the same output tiles to 1e-5; where the pipeline's time goes, stage by stage, at this
     batch and at one LR 256x256 image, and the pipeline with the pair by
     each fp32 kernel in turns; MP/s of both BN modes from
     bench_infer.measure (random-init weights from a seed; every fp32
     launch by the wgmma kernel), then with the pair by the mma.sync and
     wgmma kernels in turns; the patch generator's forward at 14,400 tiles,
     layer by layer.
 13. path: `python -m dcgan_sr_tpu_torch.serve --config
     gray-patch-batch-overlap --ckpt fixtures/overlap_textured_net_G.npz`,
     with --parity-bn and default: 2x requests at LR 32x32, 100x72 and
     256x256, one restore request, one 8-way burst, then timed requests at
     LR 64x64 and 256x256.  Every response is held against the fuse=False
     pipeline on the card; /healthz must show bulge_main moved from 0, every
     launch by the fp32 wgmma kernel (as in phase 4).
     `python -m dcgan_sr_tpu_torch.upscale --mode overlap` and `--mode
     grid` (graypatch fixture) each write one image.
 14. kernel: K2 in bf16 (x, weights, h fed to the second product and y in
     bf16; statistics and BN in fp32) against its plain bf16 version on the
     card, through bulge()'s own choice — the wgmma kernel
     (csrc/bulge_wgmma.cu) at every path shape: x (1,16,2048,2048) with the
     gray-3 fixture's pair, (225,32,32,32) and (14400,32,32,32) with the
     overlap fixture's, every statistics mode (grouped by 225 at 14,400
     tiles), and the ragged shapes of BF16_RAGGED (the mma.sync kernel of
     bulge.cu where W % 8 != 0 or Ci = 8); the mma.sync kernel also by name
     at (225,32,32,32) and at the ragged shapes the wgmma kernel takes.  At
     the three path shapes each launch of the two kernels timed in turns
     (mma, wgmma, wgmma, mma), beside the plain version, the cuDNN bf16
     composition and the bound at the bf16 rate, with the host's time to
     queue a main launch and the tensor-map encode alone; an error if
     bulge()'s choice is the slower kernel.  Alone: `python -c "import
     chip_smoke as c; c.bf16_kernel_phase_alone()"`.
 15. the bf16 training step at bench.py's geometry, K = 20 steps a call
     (train/multi_step.py): gray-3 (100,1,64,64), rgb-full (100,3,64,64),
     gray-patch-batch (1280,1,8,8) = 20 images, full width from a seed,
     bench's workload (bench.workload) run twice, untimed: finite losses,
     the stage breakdown, and for gray-3 whether G backward still runs
     cuDNN's fp32 dgrad_engine / wgrad_alg0_engine (profiler).  The second
     chunk is a CUDA graph replay: 40 launches run = the wrapper's 40 (20
     warm-up, 20 at capture) - 20 captured + 20 replayed (`launches_run`).
     The images/s of these trainers are phase 27's bench lines, which also
     print the gray-3 bf16 step beside phase 8's fp32 step.
 16. path: `python -m dcgan_sr_tpu_torch.serve --bf16 --warmup` for gray-3
     and gray-patch-batch-overlap, both BN modes, four servers started
     together: timed requests at LR 64 and 256 first (the first after the
     warmup at most 3x the p50 of the next ten), then the requests of phase
     4, each held to the unfused bf16 generator in this process; /healthz
     must show the bf16 kernel's launches (and no fp32 launch) move after
     the warmup, every one by the wgmma kernel.  bench_infer's bf16
     pipeline (both BN modes) with the pair by each bf16 kernel by name in
     turns (its records are phase 27's); `bench_fused --kernel bulge
     --dtype bf16` as a subprocess.
 17. path: training on image files.  200 CelebA-like 178x218 JPEGs of
     smooth random textures, written here from a seed, as one class
     folder; `python -m dcgan_sr_tpu_torch.cli --config gray --data-root
     <folder> --device-augment --steps 6 --scan 3` and `--config rgb-full
     ... --device-preprocess`, batch 100, full width: K1 run once a step in
     its rgb->gray+pm1 and pm1 modes (counted as in phase 7: the second
     chunk is a graph replay).  Beside it, one batch's
     device crop + K1 against the host trainHook + the plain preprocess on
     equal-seeded rngs (bit for bit), and the gray trainer in this process:
     images/s, the data stage's ms a step, the device's busy share
     (torch.profiler) and the step's time with the batch already on the card;
     the same 6 steps again with stage_ahead (the data stage beside the
     plain loop's).
 18. path: the indexed trainer and the eval protocol: files 000001-000300
     and 200001-200200 of the same kind, `--config gray-3 --data-root
     <dir> --steps 3 --eval --eval-sets 2 --samples-dir <dir>` (with
     `--native-loader` where the committed native/libdcgansr.so loads; the
     loader that ran is printed): the Train-set and Test-set lines, K2
     counted in the launch line, four PNGs.
 19. the eval protocol on the card against the CPU: the committed gray-3
     fixture (evaluate_slice on TexturedImages at batch 100: one file_set
     on the card and on the CPU, then three on the card, timed) and the
     overlap fixture (evaluate_overlap_slice, 100 images, running
     statistics; per-image tiles on the card only), PSNR within 1e-3 dB and
     SSIM within 1e-4 of the CPU's plain path, seam > naive > bilinear on
     the card, eval images/s, K2's launches (every one by the fp32 wgmma
     kernel).
 21. kernel: the channels-last pair in bf16 (x, the packed weights, the
     planes fed to the second product and y in bf16), by the wgmma kernel
     and the mma.sync kernel at the triples each was built for, against its
     plain bf16 version at the three channel triples, ragged shapes, 70,000
     images and bench_fused's (100,16,8,16,256,256) tm 32: y within two
     bf16 steps of max |y| with at most 1% of y's elements different at
     all, moments to 1e-5; at bench_fused's shape each launch of the two
     timed in turns (mma, wgmma, wgmma, mma), the whole call in turns,
     beside the plain version, the cuDNN bf16 composition and the bound at
     the bf16 rate; `python -m dcgan_sr_tpu_torch.bench_fused --kernel
     nhwc` (bf16 by default) as a subprocess, every launch by wgmma.
 22. the trainer's K-step chunk as one CUDA graph (train/multi_step.py),
     bf16 at bench.py's geometry, K = 20: for gray-3, rgb-full and
     gray-patch-batch, the eager loop and the graph in turns (eager, graph,
     graph, eager): ms a step, images/s, the device's busy share from
     torch.profiler over 5 eager steps and one replayed chunk.  The graph
     is held to the eager loop on one replayed chunk, under cuDNN's
     deterministic algorithms, by a runner of its own: after the warm-up
     chunk (its own batches), two eager twins start from a copy of the
     graph's state and run the next chunk (other batches) beside its
     replay; per-step losses within twice the eager twins' spread
     (printed).  Adam's step count advances by K a replay.  Adam's update
     (ops/adam.py: the step count on the card) timed in turns against the
     form with a host-side step size, over each trainer's G and D: host
     us to queue, device us.  Then `python -m dcgan_sr_tpu_torch.cli --config gray-3
     --synthetic --bf16 --feed-bf16 --steps 40 --scan 20` with and without
     `--stage-ahead` through cli.main: the data stage, images/s and K1's
     launches run (40).
 23. path: Torch7 `.t7` checkpoints (compat/).  The gray-3 and overlap
     fixtures exported to `.t7`; in this process, under cuDNN's
     deterministic algorithms, the --t7 and --ckpt gray-3 services give
     equal bytes for twelve requests (ten at LR 256) in fp32 and bf16;
     `python -m dcgan_sr_tpu_torch.serve --t7 ... --warmup`, fp32 and
     --bf16, started together with the --ckpt servers: p50 at LR 256, each
     response against the --ckpt server's and the in-process one (phase 4's
     level; the pixels that differ printed beside --ckpt's own run-to-run
     count); `upscale --config gray-patch-batch-overlap` on a directory of
     8 images from --t7 and --ckpt, fp32 and bf16, byte-equal files.  K2's
     launches counted on each --t7 path.
 24. the trainer's opt-in rewrites.  The gray-3 fp32 step at batch 100,
     standard against --fast-ops: the first step's losses from one state
     (rtol 1e-4, deterministic cuDNN), then the stage breakdown in turns
     (standard, fast, fast, standard): ms a step, G forward, G backward, D,
     Adam.  The bf16 K = 20 chunk's replay, standard against fast, in
     turns, for gray-3 and gray-patch-batch.  --compact-params against
     standard over one replayed fp32 chunk: losses and every state leaf
     bit for bit after unpack_state, the masters' storage unchanged.
     `python -m dcgan_sr_tpu_torch.cli --config gray-3 --synthetic --steps
     6 --scan 3 --fast-ops --compact-params` (through cli.main), then
     `--resume`: K1 run 6 times each, compact checkpoints.  Between them
     the knob table as users start it, `python -m
     dcgan_sr_tpu_torch.profile_table --steps 5 --reps 2` (bf16) and with
     `--fp32` (tools/profile_step.py's rows and JSON line; K1 run 15 times
     a training row, G's forward alone 15 launches of each K2 kernel, all
     by the wgmma kernel), its rows printed beside the times in turns.
 25. data parallel (parallel/, `--dp`).  (a) In this process, a NCCL world
     of one: build_dp_train_step against the single-device step from one
     copied state, gray-3 batch 100, fp32 (TF32 off) and bf16: the first
     step's losses and Adam's first moment under deterministic cuDNN (a
     world of one adds only the collectives), then ms a step in turns (dp,
     single, single, dp) and the device ms of NCCL's kernels a step
     (torch.profiler).  (b) The bf16 K = 20 chunk of both as CUDA graphs,
     the DP one with its NCCL collectives captured, in turns (single, dp,
     dp, single) beside phase 22's graph; then `python -m
     torch.distributed.run --standalone --nproc_per_node 1 -m
     dcgan_sr_tpu_torch.cli --dp --bf16 --feed-bf16 --steps 40 --scan 20`:
     its replayed chunk's images/s, one capture and one replay, K1 run 40
     times.  (c) `upscale --dp` over 7 images for gray-3 and
     gray-patch-batch-overlap from their fixtures, fp32 and bf16, in this
     process as a launcher's rank of a world of one, byte-equal to the run
     without --dp under deterministic cuDNN, K2 counted; and (fp32) under
     the launcher itself, held to the plain run as phase 4 holds a server.
     (d) Two ranks on the one card over gloo with CUDA tensors, gray-3
     batch 100 (50 a rank), the DP step against the single-device step
     from one state under deterministic cuDNN (tests/test_torch_dp.py's
     tolerances: metrics rtol 1e-3
     / atol 1e-4 and each network's gradient norm to 1e-3 in fp32; Adam's
     first moment leaf by leaf at rtol 1e-4 / atol 1e-6 in float64, where
     only the DP decomposition differs); both ranks launch K1.
 26. the user tools (python -m dcgan_sr_tpu_torch.<tool>), at full width,
     each in this process (every kernel's count from 0 just before it)
     unless said otherwise: overlap_protocol on the overlap fixture over
     the held-out sets 10000:10005 in both BN modes, its five rows held to
     PARITY.md within 0.02 dB / 3e-4 (phase 19 holds the same overlap eval
     on the card to the CPU); select_checkpoint --full --select-sets 1 on
     3 gray-3 epochs that cli.main trained (--textured, 10 steps each)
     beside a torn 4th (its SKIPPED line, 45 K2 launches of each kernel),
     and `python -m ...select_checkpoint --select-sets 1` without --full as
     a subprocess (the same BEST line); validate_bf16 at 20 steps (its
     warm-up chunk and the capture), twice (the same PSNR/SSIM pairs and
     verdict both times, under deterministic cuDNN; its verdict, and the
     spread of two runs of each dtype; K1 run 40 times each), then `python
     -m dcgan_sr_tpu_torch.validate_bf16` as a subprocess, the CLI's
     default: 100 steps of each dtype from the JAX tool's own initial
     state (fixtures/gray3_jax_init_key5.npz, the JAX package's gray-3
     init at PRNGKey(5)), its two score lines and verdict line printed
     (PASS and FAIL are both findings; its exit code must say the same),
     K1 run 200 times, K2 4 stats and 4 main launches;
     zssr_photo --bf16 --steps 100 on a seeded 384x512 photo;
     serve_load (--size 100x72 --warm 10) against a gray-3 server started
     with --warmup --warmup-rect --max-size 128 (a ladder of 5 LR extents;
     the first request, non-square, within 3x the p50 of the next ten);
     loader_bench over 5 batches; and
     quality_protocol on a baseline directory written in
     tools/torch_baseline.py's format from the gray-3 fixture's G (its
     result.json scored by the torch.nn modules themselves on the card,
     TF32 off; the imported G's scores within 1e-3 dB / 1e-4 of those; the
     twin trained 3 epochs of 1000 images).  Each tool's K1 and K2
     launches go into the kernels line.
 27. the measurement entry points.  `python -m dcgan_sr_tpu_torch.bench`
     as a subprocess at its full geometry: the header, the launch line and
     the five metric lines in bench.py's order (gray-3 last), each with a
     value > 0, its [min, median, max] spread, the card's name and power
     limit, and vs_baseline = value / BASELINE_MEASURED.json's baseline
     (the file unchanged); K1 run 80 times a trainer, every bf16 K2 launch
     by the wgmma kernel (80 stats, 160 main); `host` the fingerprint tag
     of utils/host.py on every line, `host_desc` in the header.  Then, in
     this process: `bench_infer --self-ensemble 8`, with and without
     `--ensemble-batched` (both BN modes, 8 images a call; every bf16 K2
     launch by the wgmma kernel, 8 or 1 generator calls a pipeline call),
     each line beside bench's N = 1 line;
     `attr_variant --config gray-3 --batch 100 --steps 5 --reps 2` (the JAX
     tool's keys, every prefix row), `attr_overlap` at 64 images with
     `--steps 5 --reps 2` in both modes (K2's counts exact, every launch by
     the wgmma kernel), `feed_ab --config rgb-full --steps 8 --scan 4
     --rounds 2` (its lines in ABBA order: a check of its plumbing at
     smoke depth, no A/B finding) and `probe_image_io` (nine PNGs).  K1's
     launches of attr_variant and feed_ab are those that ran, as each tool
     reads them from its runner (`main(..., launches=)`).  The gray-3
     bench step is printed beside phase 8's fp32 step and phase 15's
     profile.  The phase prints its seconds.
 28. the ported options that had never run on the card, at full width,
     each held to the same command run with --cpu in this process (fp32
     bytes within 1 level of 255, tiled on all but 1% of the pixels; eval
     slice means PSNR 1e-3 dB, SSIM 1e-4), every K2 launch fp32 and by the
     wgmma kernel: `--g-ema 0.999` in the K-step CUDA graph (gray-3 batch
     100, K = 3: the replayed chunk's EMA moves and agrees with two eager
     twins from a copy of its state, deterministic cuDNN), then `cli
     --g-ema 0.999 --scan 3` for 2 epochs of 6 steps (K1 run 12 times, the
     EMA branch in both checkpoints); `upscale --self-ensemble 8` with and
     without `--ensemble-batched`, both BN modes, on directories of two
     images, gray-3 64x64 and overlap 32x32 (8 main launches against 1); `--self-ensemble 8` on
     a 48x64 image (4 members: the same bytes as `--self-ensemble 4`);
     `--true-2x` on LR directories (gray-3, overlap); `--resize 64`;
     `--ema` (gray-3 from the CLI's checkpoint, the overlap fixture with a
     seeded perturbation as its EMA branch: other pixels than the params
     branch's); `serve --self-ensemble 8 --parity-bn` and `serve --ema`
     started together, each response against an SRService on the CPU;
     `cli --eval --eval-sets 1 --self-ensemble 8 --ensemble-batched` with
     batchSize=5 on a checkpoint of the gray-3 fixture; `select_checkpoint
     --ema` on the CLI's second checkpoint and `overlap_protocol --ema --sets
     10000:10001` (other scores than the params branch's).
 20. (printed last) a {"kernels": [...]} line (K1 and its two raw-RGB
     modes, K2 stats, K2 main (the fp32 wgmma kernel the paths run, with
     the mma.sync and FMA kernels' times in turns, their eval launches and
     times at the eval shape), K2 stats bf16, K2 main bf16 (the wgmma kernel
     the paths run, with the mma.sync kernel's times in turns), K3 stats,
     K3 main, K3
     stats bf16, K3 main bf16), then the contract line {"ok": true,
     "device": {...}}.

Tolerances (max |kernel - plain|, both fp32 on the card):
  mean, var of the hidden tensor  1e-5 abs + 1e-5 rel (tests/test_pallas_fused.py)
  y                               2e-4 abs + 2e-4 rel (the same file): the
                                  fused and cuDNN sums run in different
                                  orders; the tensor-core kernel's products
                                  are error-compensated TF32 (three mma's a
                                  product), not one TF32 pass, which would
                                  leave 1e-2
  served PNG bytes                1 level of 255: an fp32 difference of a few
                                  ulp can move a pixel across a rounding edge
  served PNG bytes, tiled         1 level of 255 on all but 1% of the pixels
                                  of a response: the seam DP is discontinuous,
                                  a 1e-7 difference between the fused and the
                                  unfused tiles can flip a near-tie and swap
                                  pixels between two tiles (the count is
                                  printed)
  seam stitch, device vs host     0 on the same tiles
  preprocess hr, lr               0: the kernel sums in the plain version's
                                  order and contracts nothing into an FMA
  device crop + K1 vs host hook   0: the crop is a gather of the canvas's
                                  own values, then as above
  eval, card vs CPU               slice means: PSNR 1e-3 dB, SSIM 1e-4 (the
                                  generator agrees to the y tolerance; SSIM's
                                  convolution runs with TF32 off)
  bf16 bulge and K3 y             2 bf16 steps of max |y| on every element,
                                  at most 1% of elements different at all:
                                  h is rounded to bf16 after an fp32 sum in
                                  another order, and may round the other
                                  way; then y rounds once more (statistics
                                  as for fp32)
  bf16 served PNG bytes           2 levels of 255 on all but 5% of a
                                  response's pixels, against the UNFUSED
                                  bf16 generator (TOL_U8_BF16 below)
  --t7 vs --ckpt                  0 in one process under deterministic
                                  cuDNN (same weights, same program); a
                                  --t7 server against the --ckpt server
                                  and the in-process output as served
                                  bytes above (cuDNN's default convT may
                                  sum with atomics)
  --fast-ops first step vs        losses rtol 1e-4 (deterministic cuDNN):
  standard                        the same function, fp32 sums in another
                                  order
  --compact-params vs standard    0 (deterministic cuDNN)
  captured chunk vs eager loop    per-step losses of one replayed chunk
                                  within twice the largest spread of two
                                  eager runs of that chunk from a copy of
                                  the graph's state, and at its first step
                                  (a forward) within twice their spread
                                  there; plus 1e-6 relative; all under
                                  cuDNN's deterministic algorithms (its
                                  default backward sums with atomics, which
                                  20 GAN steps amplify chaotically)
  step, kernel vs plain           hr and lr are bit-equal, but cuDNN's
                                  backward sums atomically, and Adam's first
                                  steps are sign-like: losses rtol 1e-4
                                  (step 1) and rtol 2e-3 / atol 2e-4 (step
                                  2); every updated leaf max |diff| <
                                  2 * 2.1 * lr with at most max(8, 5%) of its
                                  elements off by more than 5e-5
                                  (tests/test_torch_train_step.py)
"""

import functools
import http.client
import io
import itertools
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "fixtures", "gray3_textured_net_G.npz")
OVERLAP_FIXTURE = os.path.join(REPO, "fixtures", "overlap_textured_net_G.npz")
GRID_FIXTURE = os.path.join(REPO, "fixtures", "graypatch_textured_net_G.npz")
TILED_FLIP_SHARE = 0.01
# The same script's numbers with the FMA kernel on every path (an earlier
# run on an NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's: keyed by bn_eval, or by (parity, LR size) for the tiled requests.
EARLIER = {
    "bench_infer_mp_s": {False: 2.445, True: 3.181},
    "overlap_pipeline_ms": {False: 107.485, True: 82.4954},
    "tiled_p50_ms": {(True, 64): 20.63, (False, 64): 18.38,
                     (True, 256): 145.51, (False, 256): 118.94},
    "gray3_p50_ms": {"parity-bn": 39.36, "running": 36.63},
}
TOL_STATS = 1e-5
TOL_Y = 2e-4
TOL_U8 = 1
# published H100 SXM peaks: fp32 outside the tensor cores, TF32 in them
# (dense; an error-compensated product is three TF32 products), HBM bandwidth
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_3XTF32 = PEAK_TF32 / 3
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12          # dense bf16 on the tensor cores
# bf16 kernel against its plain version: y within this many bf16 steps of
# max |y| (h's rounding to bf16 may go the other way on one side, and y's
# own rounding once more), at most this share of y's elements different
TOL_Y_BF16_STEPS = 2
TOL_Y_BF16_SHARE = 0.01
# bf16 served bytes against the unfused bf16 generator: the fused pair
# rounds h to bf16 once where the unfused layers round it after the convT
# and again after the affine, a step of |h| (2^-8 relative) that moves a
# pixel by up to a few levels downstream (on the CPU at LR 32-128: gray-3
# 3.5% of pixels beyond 1 level, 0.1% beyond 2; tiled 5% and 1.2%, seam
# flips included)
TOL_U8_BF16 = 2
TOL_U8_BF16_SHARE = 0.05
# bench_fused --dtype bf16: the same two roundings of h, at y of O(1)
TOL_BENCH_BF16 = 0.125
# the pair's input when gray-3 serves LR 32, 128 and 256, and when the eval
# harness scores a batch of 100 (fineSize 64: LR 32, upsampled to 256)
SHAPES = [(1, 16, 256, 256), (4, 16, 1024, 1024), (100, 16, 256, 256),
          (1, 16, 2048, 2048)]
EVAL_SHAPE = (100, 16, 256, 256)


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(flops, nbytes, peak=PEAK_FP32):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def in_turns(fns, iters):
    """Times of {name: fn} taken in turns inside this process: in order,
    then in reverse (first, second, second, first; or first, second, third,
    third, second, first).  Returns ({name: mean ms of its two turns},
    {name: the better of the two})."""
    order = list(fns.items())
    got = {name: [] for name, _ in order}
    for name, fn in order + order[::-1]:
        got[name].append(time_ms(fn, iters))
    return ({k: sum(v) / 2 for k, v in got.items()},
            {k: min(v) for k, v in got.items()})


def _close(a, b, tol):
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


def takes(K, impl, x, wT, wC):
    """Does implementation `impl` take these inputs (ops/bulge.py's static
    checks: its triples, and the wgmma kernel's tensor map)?"""
    try:
        K._impl_for(impl, x, wT, wC)
    except ValueError:
        return False
    return True


def hold_pair(K, args, mode, run, groups, label, step=None):
    """bulge() with each implementation that takes the shape against the
    plain version on the same inputs (in slices of `step` images where the
    unfused hidden tensor of the whole batch would not fit), within the y
    and statistics tolerances.  Returns {impl: (max |dy|, max |dstats|)}."""
    import torch
    x = args[0]
    bsz = x.shape[0]
    step = step or bsz
    impls = [i for i in K.IMPLS if takes(K, i, x, args[1], args[4])]
    got = {impl: K.bulge(*args, stats=mode, running=run, groups=groups,
                         impl=impl) for impl in impls}
    torch.cuda.synchronize()
    err = {impl: [0.0, 0.0] for impl in impls}
    per = bsz // groups if groups else None
    for i in range(0, bsz, step):
        sl = slice(i, min(i + step, bsz))
        g = None if groups is None else (sl.stop - sl.start) // per
        yp, (mp, vp) = K.bulge_plain(x[sl], *args[1:], stats=mode,
                                     running=run, groups=g)
        for impl, (y, (m, v)) in got.items():
            check(bool(torch.isfinite(y[sl]).all()),
                  f"non-finite y, {impl}, {label}")
            check(_close(y[sl], yp, TOL_Y), f"bulge kernel ({impl}) disagrees "
                  f"with its plain version at {label}")
            err[impl][0] = max(err[impl][0], (y[sl] - yp).abs().max().item())
            if mode == "running":
                continue
            if mode == "per_image":
                ms, vs = m[sl], v[sl]
            elif groups is not None:
                ms, vs = m[i // per:i // per + g], v[i // per:i // per + g]
            elif step >= bsz:
                ms, vs = m, v
            else:       # statistics pooled over more than this slice
                continue
            check(_close(ms, mp, TOL_STATS) and _close(vs, vp, TOL_STATS),
                  f"bulge statistics ({impl}) disagree at {label}")
            err[impl][1] = max(err[impl][1], (ms - mp).abs().max().item(),
                               (vs - vp).abs().max().item())
        del yp
    print(f"kernel {label} {mode:9s} groups {groups}: " + "; ".join(
        f"{impl} max|dy| {e[0]:.3e} max|dstats| {e[1]:.3e}"
        for impl, e in err.items()), flush=True)
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# the ragged and small geometries of tests/test_torch_cuda.py, and a batch
# beyond 65,535 images: (B, Ci, Cm, Co, H, W)
RAGGED = [(2, 16, 8, 16, 37, 45), (1, 8, 4, 8, 16, 20),
          (1, 32, 16, 32, 24, 40), (3, 16, 8, 16, 1, 3),
          (70000, 8, 4, 8, 16, 16),
          # shapes the fp32 wgmma kernel takes (W % 4 == 0), cut by the
          # image's edge at both its band heights, and 70,000 images
          (2, 16, 8, 16, 37, 44), (3, 16, 8, 16, 1, 4),
          (2, 32, 16, 32, 21, 36), (70000, 16, 8, 16, 8, 16)]


def pair_times(K, N, x, wT, wC, scale, bias, rmean, rvar, iters,
               per_image=True):
    """ms per call at one shape: each launch of each implementation that
    takes the shape, in turns (fma, mma, wgmma, wgmma, mma, fma), the pair
    through `bulge()`, the plain version and the stock-PyTorch composition,
    with both bounds."""
    import torch
    import torch.nn.functional as F

    b, ci, h, w = x.shape
    cm, co = wT.shape[1], wC.shape[0]
    mu = rmean.expand(b, cm).contiguous()
    gain = (torch.rsqrt(rvar + 1e-5) * scale).expand(b, cm).contiguous()
    dims = (2, 3) if per_image else (0, 2, 3)
    with N.fp32_convs():
        lib_stats = lambda: torch.var_mean(  # noqa: E731
            F.conv_transpose2d(x, wT, stride=2, padding=1), dim=dims,
            correction=0)
        lib_pair_run = lambda: F.conv2d(F.relu(F.batch_norm(  # noqa: E731
            F.conv_transpose2d(x, wT, stride=2, padding=1), rmean, rvar,
            scale, bias, training=False)), wC, stride=2, padding=1)
        impls = [i for i in K.IMPLS[::-1] if takes(K, i, x, wT, wC)]
        st, st_best = in_turns(
            {impl: (lambda impl=impl: K.launch_stats(x, wT, impl))
             for impl in impls}, iters)
        mn, mn_best = in_turns(
            {impl: (lambda impl=impl: K.launch_main(
                x, wT, wC, mu, gain, bias, impl)) for impl in impls},
            iters)
        chosen = K.choose_impl(ci, cm, co, h, w)
        r = {
            "impl": chosen,
            "stats_ms": st[chosen], "main_ms": mn[chosen],
            **{f"stats_{i}_ms": st[i] for i in impls},
            **{f"main_{i}_ms": mn[i] for i in impls},
            "pair_run_ms": time_ms(lambda: K.bulge(
                x, wT, scale, bias, wC, stats="running",
                running=(rmean, rvar)), iters),
            "plain_stats_ms": time_ms(lambda: N.batch_stats(
                N.conv_transpose2d(x, wT, 2, 1), per_image=per_image), iters),
            "plain_main_ms": time_ms(lambda: K.bulge_plain(
                x, wT, scale, bias, wC, stats="running",
                running=(rmean, rvar)), iters),
            "lib_stats_ms": time_ms(lib_stats, iters),
            "lib_main_ms": time_ms(lib_pair_run, iters),
        }
        if per_image:
            r["pair_img_ms"] = time_ms(lambda: K.bulge(
                x, wT, scale, bias, wC, stats="per_image"), iters)
            r["plain_pair_img_ms"] = time_ms(lambda: K.bulge_plain(
                x, wT, scale, bias, wC, stats="per_image"), iters)
    hw = b * h * w
    flops_convT = 2 * 16 * hw * ci * cm
    flops_conv = 2 * 16 * hw * co * cm
    slots = -(-h // 8) * -(-w // 32)
    f_stats = flops_convT + 3 * 4 * hw * cm
    f_main = f_stats + flops_conv
    b_stats = 4 * (hw * ci + wT.numel() + b * slots * 2 * cm)
    b_main = 4 * (hw * ci + hw * co + wT.numel() + wC.numel()
                  + 2 * b * cm + cm)
    # the kernel's own rate (three TF32 products per fp32 product), and the
    # fp32 FMA rate the FMA kernel's rows were held to
    peak = PEAK_3XTF32 if chosen in ("wgmma", "mma") else PEAK_FP32
    r["stats_bound"] = bound(f_stats, b_stats, peak)
    r["main_bound"] = bound(f_main, b_main, peak)
    r["stats_bound_fp32_fma"] = bound(f_stats, b_stats)
    r["main_bound_fp32_fma"] = bound(f_main, b_main)
    for k in ("stats", "main"):
        r[f"{k}_share_of_bound"] = r[f"{k}_bound"][0] / r[f"{k}_ms"]
    # the better turn of each, with 5% and 10 us of slack: at launch-bound
    # shapes both implementations take the host's time to queue a call, and
    # one stall of the host in one turn is not the kernel's
    check(mn_best[chosen] <= min(mn_best.values()) * 1.05 + 0.01
          and st_best[chosen] <= min(st_best.values()) * 1.05 + 0.01,
          f"bulge() runs {chosen} at {tuple(x.shape)}, which is the slower "
          f"implementation in this run: stats {st}, main {mn}")
    return r


def _fmt(r):
    return json.dumps({k: (round(v, 4) if isinstance(v, float) else
                           [round(v[0], 4), v[1]] if isinstance(v, tuple)
                           else v) for k, v in r.items()})


def kernel_phase(params, state):
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import nn as N

    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    wT, wC = t(params[3]["w"]), t(params[4]["w"])
    scale, bias = t(params[3]["bn_scale"]), t(params[3]["bn_bias"])
    rmean, rvar = t(state[3]["bn"]["mean"]), t(state[3]["bn"]["var"])
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"bulge_stats": 0.0, "bulge_main": 0.0}
    tf32_probe_phase()

    def note(e, hw):
        chosen = e[K.choose_impl(*pair, *hw)]
        err["bulge_main"] = max(err["bulge_main"], chosen[0])
        err["bulge_stats"] = max(err["bulge_stats"], chosen[1])

    rows = []
    pair = (wT.shape[0], wT.shape[1], wC.shape[0])
    for shape in SHAPES:
        x = torch.rand(shape, generator=gen, device=dev)
        for mode in K.STATS_MODES:
            run = (rmean, rvar) if mode == "running" else None
            note(hold_pair(K, (x, wT, scale, bias, wC), mode, run, None,
                           str(shape)), shape[2:])
        r = pair_times(K, N, x, wT, wC, scale, bias, rmean, rvar,
                       50 if shape[0] * shape[2] <= 256 else 5)
        print(f"times {shape}: " + _fmt(r), flush=True)
        rows.append((shape, r))
        del x
        torch.cuda.empty_cache()

    # masked edges, the padded Cm 4, and more images than a grid dimension
    for bsz, ci, cm, co, h, w in RAGGED:
        rng = np.random.RandomState(bsz)
        a = (torch.randn((bsz, ci, h, w), generator=gen, device=dev),
             t(0.1 * rng.randn(ci, cm, 4, 4)), t(1 + 0.1 * rng.randn(cm)),
             t(0.1 * rng.randn(cm)), t(0.1 * rng.randn(co, cm, 4, 4)))
        run = (t(0.1 * rng.randn(cm)), t(0.5 + rng.rand(cm)))
        pair = (ci, cm, co)
        for mode in (("running",) if bsz > 65535 else K.STATS_MODES):
            note(hold_pair(K, a, mode, run if mode == "running" else None,
                           None, str((bsz, ci, cm, co, h, w)),
                           step=35000 if bsz > 65535 else None), (h, w))
        del a
        torch.cuda.empty_cache()
    return err, rows


def tf32_probe_phase():
    """The fp32 wgmma kernels' layout test on the card (ops/bulge.py
    tf32_probe): two k-steps of m64n32k8 .tf32 on raw fp32 words, A from
    registers, B in to_wgmma_tf32's layout.  The result must be the product
    of the operands truncated to TF32 (a & 0xffffe000) to fp32 accuracy:
    that pins the core-matrix layout and k-step offset the kernels use, and
    answers how the tensor cores read an fp32 word (truncation, not
    rounding to nearest; the kernels store hi truncated either way)."""
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import bulge_mma as M

    rng = np.random.RandomState(13)
    a = torch.tensor(rng.randn(64, 16), dtype=torch.float32)
    b = torch.tensor(rng.randn(16, 32), dtype=torch.float32)
    packed = torch.from_numpy(M.to_wgmma_tf32(b.numpy()).copy())
    d = K.tf32_probe(a.cuda(), packed.cuda()).cpu().double()

    def rounded(v):
        u = v.numpy().view(np.uint32).astype(np.int64)
        u = ((u + 0x1000) & ~0x1FFF) & 0xFFFFFFFF
        return torch.from_numpy(u.astype(np.uint32).view(np.float32)).double()
    dt = (d - M.trunc_tf32(a).double() @ M.trunc_tf32(b).double()).abs().max()
    dn = (d - rounded(a) @ rounded(b)).abs().max()
    dx = (d - a.double() @ b.double()).abs().max()
    print(f"tf32 layout probe: max |d - truncated product| {dt.item():.3e}, "
          f"|d - rounded product| {dn.item():.3e}, |d - fp64 product| "
          f"{dx.item():.3e}: wgmma reads an fp32 word as "
          f"{'its truncation' if dt < 1e-5 else 'something else'}",
          flush=True)
    check(dt < 1e-5 and dn > 1e-3, "the tf32 wgmma layout probe disagrees "
          "with the layout or the truncation the fp32 kernels assume")


# ---------------------------------------------------------------------------
# phase 3: where a forward's time goes
# ---------------------------------------------------------------------------

def forward_breakdown(net, x, bn_stats, iters=5, groups=None):
    """Mean device ms of one generator forward and of each step in it: a
    layer between its module hooks, or a fused pair (which runs outside
    any layer's call) in the gap between two layers' hooks."""
    import torch

    marks = []

    def mark(tag):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((tag, e))

    hooks = []
    for i, layer in enumerate(net.layers):
        hooks.append(layer.register_forward_pre_hook(
            lambda m, a, i=i: mark(("start", i))))
        hooks.append(layer.register_forward_hook(
            lambda m, a, o, i=i: mark(("end", i))))
    acc = {}
    try:
        with torch.inference_mode():
            net(x, bn_stats=bn_stats, groups=groups)
            for _ in range(iters):
                marks.clear()
                mark(("start", None))
                net(x, bn_stats=bn_stats, groups=groups)
                mark(("end", None))
                torch.cuda.synchronize()
                for (a, e0), (b, e1) in zip(marks, marks[1:]):
                    if a[0] == "start" and b[0] == "end" and a[1] == b[1]:
                        kind = net.spec[a[1]]["kind"]
                        label = f"layer {a[1]} {kind}"
                    elif a[0] == "end" and b[0] == "start" and a[1] is not None \
                            and b[1] is not None and b[1] > a[1] + 1:
                        label = f"layers {a[1] + 1}-{b[1] - 1} fused pair"
                    else:
                        label = "between layers"
                    acc[label] = acc.get(label, 0.0) + e0.elapsed_time(e1)
                acc["total"] = acc.get("total", 0.0) + \
                    marks[0][1].elapsed_time(marks[-1][1])
    finally:
        for h in hooks:
            h.remove()
    return {k: round(v / iters, 4) for k, v in acc.items()}


# ---------------------------------------------------------------------------
# phase 4: the served path
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _png(arr8):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr8).save(buf, format="PNG")
    return buf.getvalue()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _healthz(port):
    status, body = _request(port, "GET", "/healthz")
    check(status == 200, f"/healthz answered {status}")
    return json.loads(body)


def start_server(cfg, parity, log, fixture=FIXTURE, extra=(), t7=None):
    """Start the port's server as a user does; returns (process, port).  The
    caller starts both BN modes' servers together (a process takes seconds
    to reach the card) and drives them one after the other.  `t7` serves
    that Torch checkpoint in place of the fixture."""
    port = _free_port()
    weights = ["--t7", t7] if t7 else ["--ckpt", fixture]
    cmd = [sys.executable, "-m", "dcgan_sr_tpu_torch.serve", "--config",
           cfg.variant, *weights, "--port", str(port),
           "--max-batch", "8", *extra]
    if parity:
        cmd.append("--parity-bn")
    return subprocess.Popen(cmd, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT), port


def stop_server(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def wait_up(server, name):
    """/healthz of a started server once it answers (after its warmup)."""
    proc, port = server
    t0 = time.monotonic()
    while True:
        check(proc.poll() is None, f"server ({name}) exited with "
              f"{proc.returncode}")
        try:
            return _healthz(port)
        except (ConnectionError, OSError):
            check(time.monotonic() - t0 < 300, "server did not come up")
            time.sleep(0.5)


def _timed_requests(port, rng, size, name, cfg):
    """11 sequential 2x requests of one image; returns (client ms of each, in
    order, and the server's last 10 batch ms, sorted)."""
    import numpy as np
    body = _png((rng.rand(*size) * 255).astype(np.uint8))
    lat = []
    for _ in range(11):
        t1 = time.perf_counter()
        status, _ = _request(port, "POST", "/upscale", body)
        lat.append((time.perf_counter() - t1) * 1e3)
        check(status == 200, f"timed request answered {status}")
    hz = _healthz(port)
    print(f"timed ({cfg.variant}, {name}, LR {size[0]}x{size[1]}): "
          f"client ms {[round(v, 2) for v in lat]}; server batch ms "
          f"(last 10) {hz['recent_batch_ms'][-10:]}", flush=True)
    return lat, sorted(hz["recent_batch_ms"][-10:])


def serve_phase(cfg, parity, ref_service, server, timed=((256, 256),),
                flip_share=0.0, levels=TOL_U8, bf16=False):
    """Drive a started server (`start_server`), hold every response against
    `ref_service` (the plain-version generator on the card): within `levels`
    of 255 on all but `flip_share` of a response's pixels.  A bf16 server
    (`bf16`, started with --bf16 --warmup) has run its warmup when it
    answers: its timed requests come first, and the first of each size
    after the warmup must take at most 3x the median of the ten after it;
    launch counts are read from its first /healthz on.  Returns the server's
    kernel launch counts, the timed-request latencies per size (the first
    left out) and the burst's batch count."""
    import numpy as np
    from PIL import Image

    from dcgan_sr_tpu_torch.image.io import load_image

    proc, port = server
    name = ("parity-bn" if parity else "running-stats BN") + \
        (", bf16" if bf16 else "")
    try:
        h0 = wait_up(server, name)
        print(f"server ({name}) up", flush=True)
        check(h0["device"].startswith("cuda"), f"server on {h0['device']}")
        if bf16:
            check(h0["dtype"] == "bf16", f"server not in bf16: {h0}")
        else:
            check(all(v == 0 for v in h0["kernel_launches"].values()),
                  f"launch counts not 0 at start: {h0['kernel_launches']}")

        rng = np.random.RandomState(1 if parity else 2)
        lats = {}
        if bf16:
            for size in timed:
                lat, batch = _timed_requests(port, rng, size, name, cfg)
                first, rest = lat[0], sorted(lat[1:])
                check(first <= 3 * rest[len(rest) // 2],
                      f"first request after warmup took {first:.2f} ms, "
                      f"p50 of the next ten {rest[len(rest) // 2]:.2f} ms "
                      f"({name}, LR {size})")
                lats[size] = (rest, batch, first)
        worst, flipped, pixels = 0, 0, 0

        def post(arr8, mode="2x"):
            nonlocal worst, flipped, pixels
            body = _png(arr8)
            q = "?mode=restore" if mode == "restore" else ""
            status, out = _request(port, "POST", "/upscale" + q, body)
            check(status == 200, f"POST {arr8.shape} {mode}: {status} {out[:200]}")
            got = np.asarray(Image.open(io.BytesIO(out)), np.int16)
            h, w = arr8.shape
            want_hw = (2 * h, 2 * w) if mode == "2x" else (h, w)
            check(got.shape == want_hw, f"response {got.shape} != {want_hw}")
            img = load_image(io.BytesIO(body), nc=1)[0]
            ref = ref_service.submit(img, mode)
            ref8 = np.clip(np.round(ref * 255.0), 0, 255).astype(np.int16)
            diff = np.abs(got - ref8)
            d, off = int(diff.max()), int((diff > levels).sum())
            worst = max(worst, d)
            flipped += off
            pixels += diff.size
            check(off <= flip_share * diff.size, f"response differs from the "
                  f"plain generator by up to {d} levels on {off} of "
                  f"{diff.size} pixels ({arr8.shape}, {mode})")

        for hw in ((32, 32), (100, 72), (256, 256)):
            post((rng.rand(*hw) * 255).astype(np.uint8))
        post((rng.rand(200, 160) * 255).astype(np.uint8), "restore")
        burst = [(rng.rand(64, 64) * 255).astype(np.uint8) for _ in range(8)]
        b0 = _healthz(port)["batches"]
        errors = []

        def run(th):
            try:
                th()
            except Exception as e:  # reported below, after the join
                errors.append(e)

        gate = threading.Barrier(len(burst))   # all 8 POSTs leave together
        threads = [threading.Thread(target=run, args=(
            lambda a=a: (gate.wait(timeout=60), post(a)),)) for a in burst]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        check(not errors and not any(th.is_alive() for th in threads),
              f"burst failed: {errors}")
        burst_batches = _healthz(port)["batches"] - b0
        check(burst_batches < 8, "8 concurrent requests did not coalesce")

        # timed requests, 2x, sequential, one warm first at each size
        if not bf16:
            for size in timed:
                lat, batch = _timed_requests(port, rng, size, name, cfg)
                lats[size] = (sorted(lat[1:]), batch)
        hz = _healthz(port)
        check(hz["errors"] == 0, f"server counted {hz['errors']} errors")
        check(hz["requests"] >= 3 + 1 + 8 + 11 * len(timed),
              f"requests {hz['requests']}")
        counts = {k: v - h0["kernel_launches"][k] if bf16 else v
                  for k, v in hz["kernel_launches"].items()}
        by_impl = hz["bulge_impl_launches"]
        print(f"served ({cfg.variant}, {name}): {hz['requests']} images in "
              f"{hz['batches']} batches (burst of 8 in {burst_batches}), max "
              f"byte diff vs plain {worst}, {flipped} of {pixels} compared "
              f"pixels off by more than {levels}, launches after the first "
              f"/healthz {counts}, by implementation {by_impl}, batch_ms "
              f"p50 {hz['batch_ms_p50']}", flush=True)
        mine = "wgmma_bf16" if bf16 else "wgmma"
        check(by_impl[mine] > 0 and all(v == 0 for k, v in by_impl.items()
                                        if k != mine),
              f"the served path ran {by_impl}")
        return counts, lats, burst_batches
    finally:
        stop_server(proc)


# ---------------------------------------------------------------------------
# phase 5: the preprocess kernel against its plain version
# ---------------------------------------------------------------------------

# (shape, rgb_to_gray, to_pm1, is a shape of the training path)
PRE_CASES = [((100, 1, 64, 64), False, False, True),
             ((100, 3, 64, 64), True, True, True),
             ((100, 3, 64, 64), False, True, True),
             ((1280, 1, 8, 8), False, False, True),
             ((3, 3, 50, 38), True, True, False),
             ((8, 3, 2048, 2048), True, True, False)]


def host_queue_us(fn, calls=1000):
    """Host time to queue one call: the host clock over `calls` calls with
    no synchronisation in between."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def graph_ms(fn, calls=100, replays=20):
    """Device ms per call of `fn` from a CUDA graph of `calls` calls,
    replayed; and the captured calls' outputs after the last replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                    # first use outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(calls)]
    ms = time_ms(graph.replay, replays) / calls
    torch.cuda.synchronize()
    return ms, outs


def preprocess_phase():
    import torch
    import torch.nn.functional as F

    from dcgan_sr_tpu_torch.ops import preprocess as P

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    worst, rows = 0.0, []
    for shape, gray, pm1, on_path in PRE_CASES:
        x = torch.rand(shape, generator=gen, device=dev)
        n0 = P.launches["preprocess"]
        hr, lr = P.preprocess(x, rgb_to_gray=gray, to_pm1=pm1)
        check(P.launches["preprocess"] == n0 + 1, "launch count did not move")
        hp, lp = P.preprocess_plain(x, rgb_to_gray=gray, to_pm1=pm1)
        torch.cuda.synchronize()
        check(hr.shape == hp.shape and lr.shape == lp.shape,
              f"preprocess shapes {tuple(hr.shape)} {tuple(lr.shape)}")
        check(bool(torch.isfinite(hr).all() and torch.isfinite(lr).all()),
              f"non-finite preprocess output {shape}")
        e_hr = (hr - hp).abs().max().item()
        e_lr = (lr - lp).abs().max().item()
        worst = max(worst, e_hr, e_lr)
        check(e_hr == 0.0 and e_lr == 0.0, f"preprocess kernel differs from "
              f"its plain version at {shape} gray={gray} pm1={pm1}: "
              f"hr {e_hr:.3e} lr {e_lr:.3e}")

        def library():
            y = x
            if gray:
                y = 0.21 * y[:, 0:1] + 0.72 * y[:, 1:2] + 0.07 * y[:, 2:3]
            if pm1:
                y = y * 2.0 - 1.0
            if y is x:
                y = x.clone()         # hr is an output: written once
            return y, F.avg_pool2d(y, 2)

        iters = 10 if x.numel() > 1 << 24 else 200
        n_in, n_hr, n_lr = x.numel(), hr.numel(), lr.numel()
        flops = n_hr * ((5 if gray else 0) + (2 if pm1 else 0)) + 4 * n_lr
        b_ms, b_by = bound(flops, 4 * (n_in + n_hr + n_lr))
        kernel = lambda: P.preprocess(x, rgb_to_gray=gray, to_pm1=pm1)  # noqa: E731
        r = {"shape": list(shape), "gray": gray, "pm1": pm1,
             "on_path": on_path, "max_abs_err": max(e_hr, e_lr),
             "eager_ms": time_ms(kernel, iters),
             "plain_ms": time_ms(lambda: P.preprocess_plain(
                 x, rgb_to_gray=gray, to_pm1=pm1), iters),
             "library_ms": time_ms(library, iters),
             "bound_ms": b_ms, "bound_by": b_by}
        if on_path:
            # what the wrapper costs the host, and the kernel's own time: 100
            # calls captured into one CUDA graph, replayed
            r["host_queue_us"] = host_queue_us(kernel)
            r["library_host_queue_us"] = host_queue_us(library)
            n0 = P.launches["preprocess"]
            r["graph_ms"], outs = graph_ms(kernel)
            check(P.launches["preprocess"] == n0 + 101, "a captured call "
                  "counts once, at capture (1 warm-up + 100 captured)")
            check(all(torch.equal(o[0], hp) and torch.equal(o[1], lp)
                      for o in (outs[0], outs[49], outs[-1])),
                  f"captured preprocess differs from its plain version at "
                  f"{shape} gray={gray} pm1={pm1}")
            check(P.launches["preprocess"] == n0 + 101,
                  "replays must not move the launch count")
            r["library_graph_ms"], outs = graph_ms(library)
            del outs
        r["ms"] = r.get("graph_ms", r["eager_ms"])
        r["GB_per_s"] = 4 * (n_in + n_hr + n_lr) / (r["ms"] * 1e-3) / 1e9
        print("preprocess " + json.dumps(
            {k: (round(v, 5) if isinstance(v, float) else v)
             for k, v in r.items()}), flush=True)
        rows.append(r)
        del x, hr, lr, hp, lp
        torch.cuda.empty_cache()
    return worst, rows


# ---------------------------------------------------------------------------
# phase 6: the training step, kernel against plain
# ---------------------------------------------------------------------------

def _batches(cfg, n, device):
    """n consecutive trainer batches of the procedural source, on the card."""
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.data.synthetic import SyntheticImages
    src = SyntheticImages(cfg.fineSize, nc=cfg.nc, seed=1234)
    return [torch.from_numpy(np.ascontiguousarray(
        src.load_batch(i, cfg.batchSize))).to(device) for i in range(n)]


def step_phase(cfg):
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.ops import preprocess as P
    from dcgan_sr_tpu_torch.train.step import (build_train_step,
                                               init_train_state,
                                               state_from_numpy,
                                               state_to_numpy)

    dev = torch.device("cuda")
    st = init_train_state(cfg, torch.Generator().manual_seed(0), device=dev)
    twin = state_from_numpy(cfg, state_to_numpy(st), device=dev)
    batches = _batches(cfg, 2, dev)
    check(tuple(batches[0].shape) == (100, 1, 64, 64),
          f"trainer batch is {tuple(batches[0].shape)}")
    runs = []
    for state, fn, moves in ((st, P.preprocess, 2), (twin, P.preprocess_plain, 0)):
        step = build_train_step(cfg, preprocess_fn=fn)
        n0 = P.launches["preprocess"]
        losses = []
        for hr in batches:
            _, m = step(state, hr)
            losses.append({k: v.item() for k, v in m.items()})
        torch.cuda.synchronize()
        check(P.launches["preprocess"] - n0 == moves,
              f"preprocess launches moved by {P.launches['preprocess'] - n0}, "
              f"expected {moves}")
        runs.append(losses)
    for it, (a, b) in enumerate(zip(*runs)):
        tol = (1e-4, 0.0) if it == 0 else (2e-3, 2e-4)
        for k in a:
            check(np.isfinite(a[k]) and np.isfinite(b[k]), f"{k} not finite")
            check(abs(a[k] - b[k]) <= tol[1] + tol[0] * abs(b[k]),
                  f"step {it + 1} {k}: kernel {a[k]} vs plain {b[k]}")
    worst, flips = 0.0, 0
    ta, tb = state_to_numpy(st), state_to_numpy(twin)
    for field in ("g_params", "d_params"):
        for la, lb in zip(ta[field], tb[field]):
            for key in la:
                diff = np.abs(la[key] - lb[key])
                worst = max(worst, float(diff.max()))
                off = int((diff > 5e-5).sum())
                flips += off
                check(diff.max() < 2 * 2.1 * cfg.lr and
                      off <= max(8, 0.05 * diff.size),
                      f"{field} {key}: max diff {diff.max():.3e}, {off} of "
                      f"{diff.size} off")
    check(st.g_opt["t"] == twin.g_opt["t"] == 2, "Adam step counts")
    print(f"step kernel-vs-plain: losses {json.dumps(runs[0])}; plain "
          f"{json.dumps(runs[1])}; max leaf diff {worst:.3e}, {flips} elements "
          f"off by more than 5e-5", flush=True)
    return st


# ---------------------------------------------------------------------------
# phase 7: the trainer as users start it
# ---------------------------------------------------------------------------

LOG_LINE = re.compile(
    r"^Epoch: \[(\d+)\]\[ *(\d+) / *(\d+)\]\t Time: [\d.]+  DataTime: [\d.]+  "
    r"  Err_G: ([\d.eE+-]+|nan|inf)  Err_D: ([\d.eE+-]+|nan|inf)$")
# variables the config reads as overrides: a stray one would change the width
CONFIG_ENV = ("batchSize", "ngf", "ndf", "ntrain", "niter", "name", "lr",
              "fineSize", "loadSize", "nThreads")


def _trainer(args):
    env = {k: v for k, v in os.environ.items() if k not in CONFIG_ENV}
    cmd = [sys.executable, "-m", "dcgan_sr_tpu_torch.cli", *args]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-8000:])
    check(r.returncode == 0, f"{' '.join(cmd)} exited with {r.returncode}")
    return r.stdout.splitlines()


def k1_run(lines):
    """K1's launches that ran in a CLI run, from its last line (the
    launches run: train/multi_step.py `launches_run`), and its "graph
    launches" line (None without --scan)."""
    counts = _launch_line(lines)
    g = [json.loads(l[len("graph launches: "):]) for l in lines
         if l.startswith("graph launches: ")]
    return counts["preprocess"], (g[0] if g else None)


def trainer_phase(cfg):
    import math

    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.infer.tiled import make_full_sr_fn
    from dcgan_sr_tpu_torch.train.checkpoint import (checkpoint_path,
                                                     load_generator)

    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        lines = _trainer(["--config", "gray-3", "--synthetic", "--steps", "6",
                          "--scan", "2", "--epochs", "1", "--seed", "1",
                          "--checkpoint-dir", ck])
        wall = time.perf_counter() - t0
        check("ngf=8" in lines[0] and "ndf=64" in lines[0]
              and "batchSize=100" in lines[0], f"not full width: {lines[0]}")
        steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
        check(len(steps) == 3 and all(steps), f"log lines: {lines}")
        check([m.group(2) for m in steps] == ["1", "3", "5"]
              and all(m.group(1) == "1" and m.group(3) == "6" for m in steps),
              "log lines are not the ends of three 2-step chunks of 6")
        vals = [float(m.group(i)) for m in steps for i in (4, 5)]
        check(len(vals) == 6 and all(math.isfinite(v) for v in vals),
              f"Err_G/Err_D not finite: {vals}")
        counts = _launch_line(lines)
        run, graph = k1_run(lines)
        check(graph is not None and graph["captures"] == 1
              and graph["replays"] == 2, f"graph line: {graph}")
        check(run == 6, f"trainer ran K1 {run} times in 6 steps: {counts}, "
              f"graphs {graph}")
        for net in "GD":
            check(os.path.isfile(checkpoint_path(ck, cfg.name, 1, net)),
                  f"no epoch-1 checkpoint of net {net}")
        for l in lines[1:]:
            print("trainer| " + l, flush=True)
        print(f"trainer: 6 steps of batch 100 in {wall:.1f}s of process time "
              f"(start, build reuse, init, data, steps, checkpoints)",
              flush=True)

        # the trained G serves: load as the server does, upscale one image
        net, _ = load_generator(cfg, checkpoint_path(ck, cfg.name, 1, "G"),
                                need_state=True, device="cuda")
        lr = torch.rand((1, 1, 48, 40), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(5))
        fake = make_full_sr_fn(net, lr_input=True)(lr)
        torch.cuda.synchronize()
        check(tuple(fake.shape) == (1, 1, 96, 80)
              and bool(torch.isfinite(fake).all())
              and 0.0 <= fake.min().item() and fake.max().item() <= 1.0,
              f"upscale from the trained G: {tuple(fake.shape)}")

        lines = _trainer(["--config", "gray-3", "--synthetic", "--steps", "2",
                          "--epochs", "2", "--seed", "1", "--checkpoint-dir",
                          ck, "--resume"])
        check("resumed from epoch 1" in lines, "did not resume")
        steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
        check(len(steps) == 2 and all(m and m.group(1) == "2" for m in steps),
              "resume did not start at epoch 2")
        check(os.path.isfile(checkpoint_path(ck, cfg.name, 2, "G")),
              "no epoch-2 checkpoint after resume")
        with np.load(checkpoint_path(ck, cfg.name, 2, "G")) as data:
            check(int(data["_opt_/_t_"]) == 8, "Adam step count after resume")
        return counts


# ---------------------------------------------------------------------------
# phase 8: where a step's time goes
# ---------------------------------------------------------------------------

STAGES = ("preprocess", "g_forward", "d_real_forward_backward",
          "d_fake_forward", "d_fake_pullbacks", "g_backward", "adam_updates")


def step_breakdown(cfg, state, smi, warm=2, iters=10, batches=None,
                   benchmarks=(False, True)):
    """Device time of each stage of the step, from CUDA events the step
    records as it queues each stage.  The host queues all `iters` steps
    without waiting (as the trainer does between two log lines), so a
    stage's time is the device's, not the host's time to enqueue it; the
    step's own time is the wall clock over the steps, ending in a
    synchronize."""
    import torch

    from dcgan_sr_tpu_torch.train.step import build_train_step

    dev = torch.device("cuda")
    step = build_train_step(cfg)
    batches = batches or _batches(cfg, 4, dev)
    out = {}
    for bench in benchmarks:
        torch.backends.cudnn.benchmark = bench
        try:
            for i in range(warm):
                step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks = []

            def mark(name):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append((name, e))

            t0 = time.perf_counter()
            for i in range(iters):
                mark("start")
                step(state, batches[i % len(batches)], mark=mark)
            queued = (time.perf_counter() - t0) / iters * 1e3
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / iters * 1e3
        finally:
            torch.backends.cudnn.benchmark = False
        check([n for n, _ in marks] == (["start"] + list(STAGES)) * iters,
              f"stages {[n for n, _ in marks[:len(STAGES) + 1]]}")
        acc = dict.fromkeys(STAGES, 0.0)
        for (_, e0), (name, e1) in zip(marks, marks[1:]):
            if name != "start":
                acc[name] += e0.elapsed_time(e1)
        r = {k: round(v / iters, 4) for k, v in acc.items()}
        r["stages_sum_ms"] = round(sum(acc.values()) / iters, 4)
        r["host_queue_ms"] = round(queued, 4)
        r["step_ms"] = round(wall, 4)
        r["images_per_s"] = round(cfg.images_consumed_per_step
                                  / (wall / 1e3), 2)
        r["peak_memory_GB"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
        print(f"step breakdown, {cfg.variant} {cfg.compute_dtype}, batch "
              f"{cfg.batchSize}, cudnn.benchmark={bench} (ms, mean of "
              f"{iters}) on {smi}: " + json.dumps(r), flush=True)
        out[bench] = r
    return out


# ---------------------------------------------------------------------------
# phase 9: the channels-last fused pair against its plain version
# ---------------------------------------------------------------------------

# ((B, Ci, Cm, Co, H, W), tm): the shapes of tests/test_pallas_fused.py,
# the wider triple at a ragged width, bench_fused's, and more images than a
# grid dimension takes
NHWC_CASES = [((2, 5, 4, 6, 16, 16), 8), ((1, 16, 8, 16, 32, 32), 16),
              ((3, 3, 2, 3, 8, 8), 8), ((2, 32, 16, 32, 32, 37), 16),
              ((1, 16, 8, 16, 256, 256), 32),
              ((100, 16, 8, 16, 256, 256), 32), ((70000, 16, 8, 16, 8, 8), 8)]


def nhwc_phase():
    """K3 by each implementation it has at each case against its plain
    version, the chosen one also against K2 (or the unfused pair); at
    bench_fused's shape the two tensor-core implementations timed in turns,
    the FMA kernel once.  Returns the chosen implementation's worst errors
    and the timing row."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import fused_nhwc as F3
    from dcgan_sr_tpu_torch.ops import nn as N

    dev = torch.device("cuda")
    err = {"fused_nhwc_stats": 0.0, "fused_nhwc_main": 0.0}
    row = None
    for (b, ci, cm, co, h, w), tm in NHWC_CASES:
        rng = np.random.RandomState(0)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        x = torch.randn((b, ci, h, w), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(b))
        wT, wC = t(0.1 * rng.randn(ci, cm, 4, 4)), t(0.1 * rng.randn(co, cm, 4, 4))
        scale, bias = t(1 + 0.1 * rng.randn(cm)), t(0.1 * rng.randn(cm))
        args = (x, wT, scale, bias, wC)
        geom = (b, ci, cm, co, h, w)
        chosen = F3.choose_impl(ci, cm, co, h, w)
        n0 = dict(F3.launches)
        got = {chosen: F3.fused_convT_bn_relu_conv(*args, tm=tm)}
        check(F3.launches == {k: c + (not k.endswith("_bf16"))
                              for k, c in n0.items()},
              "K3's fp32 launch counts did not move by one each")
        for impl in F3.IMPLS:
            if impl not in got and F3.built_for(impl, ci, cm, co):
                got[impl] = F3.fused_convT_bn_relu_conv(*args, tm=tm,
                                                        impl=impl)
        yp, (mp, vp) = F3.fused_nhwc_plain(*args, tm=tm)
        torch.cuda.synchronize()
        for impl, (y, (m, v)) in got.items():
            check(tuple(y.shape) == (b, co, h, w)
                  and bool(torch.isfinite(y).all()),
                  f"K3 ({impl}) output {tuple(y.shape)}")
            ey, em, ev = ((y - yp).abs().max().item(),
                          (m - mp).abs().max().item(),
                          (v - vp).abs().max().item())
            check(_close(y, yp, TOL_Y) and _close(m, mp, TOL_STATS)
                  and _close(v, vp, TOL_STATS),
                  f"K3 ({impl}) disagrees with its plain version at {geom}")
            print(f"K3 {geom} tm {tm} {impl}: max|dy| {ey:.3e} max|dmean| "
                  f"{em:.3e} max|dvar| {ev:.3e}", flush=True)
            if impl == chosen:
                err["fused_nhwc_main"] = max(err["fused_nhwc_main"], ey)
                err["fused_nhwc_stats"] = max(err["fused_nhwc_stats"], em, ev)
        del yp
        y, (m, v) = got[chosen]
        if K.build().bulge_supported(cm, co):
            yk, (mk, vk) = K.bulge(*args)
            other = "K2"
        else:
            yk, (mk, vk) = K.bulge_plain(*args)
            other = "unfused"
        ek = (y - yk).abs().max().item()
        check(_close(y, yk, TOL_Y) and _close(m, mk, TOL_STATS)
              and _close(v, vk, TOL_STATS),
              f"K3 disagrees with {other} at {geom}")
        print(f"K3 {geom} tm {tm} {chosen} vs {other}: max|dy| {ek:.3e}",
              flush=True)
        del got, y, yk
        if b != 100:
            del x
            torch.cuda.empty_cache()
            continue

        # times per launch at bench_fused's geometry: each launch of the two
        # tensor-core implementations in turns (mma, wgmma, wgmma, mma), and
        # the whole call; the FMA kernel once
        xn = x.permute(0, 2, 3, 1).contiguous()
        xl = F3._pad_nhwc(x).contiguous()
        wtall, wcall = F3._pack_wT(wT), F3._pack_wC(wC)
        ops = {impl: F3.operands(wT, wC, impl) for impl in F3.IMPLS}
        gain = torch.rsqrt(v + 1e-5) * scale
        bn = F3._bn_rows(m, v, scale, bias, 1e-5)
        tc = ("mma", "wgmma")

        def stats(impl):
            return lambda: F3.launch_stats(xn, ops[impl][0], cm, tm, impl)

        def main_(impl):
            return lambda: F3.launch_main(xn, *ops[impl], bn, cm, co, tm,
                                          impl)

        def whole(impl):
            return lambda: F3.fused_convT_bn_relu_conv(*args, tm=tm,
                                                       impl=impl)
        st, st_best = in_turns({i: stats(i) for i in tc}, 10)
        mn, mn_best = in_turns({i: main_(i) for i in tc}, 10)
        pair, _ = in_turns({i: whole(i) for i in tc}, 5)
        k2_gain = gain.expand(b, cm).contiguous()
        with N.fp32_convs():
            row = {
                "shape": [b, ci, h, w], "tm": tm, "impl": chosen,
                "stats_ms": st[chosen], "main_ms": mn[chosen],
                "pair_ms": pair[chosen],
                "stats_wgmma_ms": st["wgmma"], "stats_mma_ms": st["mma"],
                "main_wgmma_ms": mn["wgmma"], "main_mma_ms": mn["mma"],
                "pair_wgmma_ms": pair["wgmma"], "pair_mma_ms": pair["mma"],
                "stats_fma_ms": time_ms(stats("fma"), 3),
                "main_fma_ms": time_ms(main_("fma"), 3),
                "pair_fma_ms": time_ms(whole("fma"), 2),
                "plain_stats_ms": time_ms(lambda: F3.plain_stats(xl, wtall, tm), 3),
                "plain_main_ms": time_ms(lambda: F3.plain_main(
                    xl, wtall, wcall, m, gain, bias, tm), 3),
                "lib_stats_ms": time_ms(lambda: torch.var_mean(
                    F.conv_transpose2d(x, wT, stride=2, padding=1),
                    dim=(0, 2, 3), correction=0), 3),
                "lib_main_ms": time_ms(lambda: F.conv2d(F.relu(F.batch_norm(
                    F.conv_transpose2d(x, wT, stride=2, padding=1), m, v,
                    scale, bias, training=False)), wC, stride=2, padding=1), 3),
                "K2_stats_ms": time_ms(lambda: K.launch_stats(x, wT), 10),
                "K2_main_ms": time_ms(lambda: K.launch_main(
                    x, wT, wC, m.expand(b, cm).contiguous(), k2_gain,
                    bias), 10),
                "K2_pair_ms": time_ms(lambda: K.bulge(*args), 5),
            }
        # the better turn of each, with 5% of slack
        check(mn_best[chosen] <= min(mn_best.values()) * 1.05
              and st_best[chosen] <= min(st_best.values()) * 1.05,
              f"fused_convT_bn_relu_conv runs {chosen} at {geom}, which is "
              f"the slower implementation in this run: stats {st}, main {mn}")
        hw = b * h * w
        flops_T = 2 * hw * (4 * ci) * (4 * cm)       # the packed products
        flops_C = 2 * hw * (16 * cm) * co
        slots = F3.M.Schedule(b, h, w, tm).n_items
        f_stats = flops_T + 3 * 4 * hw * cm
        f_main = f_stats + flops_C
        b_stats = 4 * (hw * ci + wtall.numel() + slots * 2 * cm)
        b_main = 4 * (hw * ci + hw * co + wtall.numel() + wcall.numel()
                      + 12 * cm)
        # the kernel's own rate (three TF32 products per fp32 product), and
        # the fp32 FMA rate the FMA kernel is held to
        peak = PEAK_3XTF32 if chosen in tc else PEAK_FP32
        row["stats_bound"] = bound(f_stats, b_stats, peak)
        row["main_bound"] = bound(f_main, b_main, peak)
        row["stats_bound_fp32_fma"] = bound(f_stats, b_stats)
        row["main_bound_fp32_fma"] = bound(f_main, b_main)
        for k in ("stats", "main"):
            row[f"{k}_share_of_bound"] = row[f"{k}_bound"][0] / row[f"{k}_ms"]
        print("K3 times: " + _fmt(row), flush=True)
        del x, xn, xl
        torch.cuda.empty_cache()
    return err, row


# ---------------------------------------------------------------------------
# phase 10: the bulge kernel at the overlap pipeline's shapes
# ---------------------------------------------------------------------------

def overlap_kernel_phase(params, state):
    """K2 with the overlap generator's layers 3-4 on batches of 32x32 tiles:
    one image's 225 tiles pooled, and 64 images' 14,400 tiles with running
    statistics and with statistics grouped by image; both implementations
    against the plain version, and their times in turns."""
    import torch

    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import nn as N

    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    wT, wC = t(params[3]["w"]), t(params[4]["w"])
    scale, bias = t(params[3]["bn_scale"]), t(params[3]["bn_bias"])
    rmean, rvar = t(state[3]["bn"]["mean"]), t(state[3]["bn"]["var"])
    ci, cm, co = wT.shape[0], wT.shape[1], wC.shape[0]
    check((ci, cm, co) == (32, 16, 32), f"overlap pair is {(ci, cm, co)}")
    gen = torch.Generator(device=dev).manual_seed(4)
    chosen = K.choose_impl(ci, cm, co, 32, 32)
    worst, rows = [0.0, 0.0], []
    for bsz, mode, groups in ((225, "pooled", None), (14400, "running", None),
                              (14400, "pooled", 64)):
        x = torch.rand((bsz, ci, 32, 32), generator=gen, device=dev)
        run = (rmean, rvar) if mode == "running" else None
        # whole images: the unfused hidden tensor of 16 images is 0.9 GB
        e = hold_pair(K, (x, wT, scale, bias, wC), mode, run, groups,
                      f"({bsz},32,32,32)", step=225 * 16)[chosen]
        worst = [max(a, b) for a, b in zip(worst, e)]
        if groups is None:
            r = pair_times(K, N, x, wT, wC, scale, bias, rmean, rvar,
                           20 if bsz == 225 else 5, per_image=False)
            print(f"K2 overlap times ({bsz},32,32,32): " + _fmt(r), flush=True)
            rows.append(((bsz, ci, 32, 32), r))
        del x
        torch.cuda.empty_cache()
    return worst, rows


# ---------------------------------------------------------------------------
# phase 11: bench_fused as users start it
# ---------------------------------------------------------------------------

def _module(args, timeout=600):
    return _module_run(args, timeout)[1]


def _module_run(args, timeout=600, codes=(0,)):
    """`python -m <args>` from the repo without the config env vars: (its
    exit code, its output lines); a code outside `codes` fails the script."""
    env = {k: v for k, v in os.environ.items() if k not in CONFIG_ENV}
    cmd = [sys.executable, "-m", *args]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode not in codes:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-8000:])
    check(r.returncode in codes, f"{' '.join(cmd)} exited with {r.returncode}")
    return r.returncode, r.stdout.splitlines()


def bench_fused_phase():
    out = {}
    for kernel, names in (("nhwc", ("fused_nhwc_stats", "fused_nhwc_main")),
                          ("bulge", ("bulge_stats", "bulge_main"))):
        lines = _module(["dcgan_sr_tpu_torch.bench_fused", "--kernel", kernel,
                         "--dtype", "fp32", "--iters", "10"])
        rec = json.loads(lines[-1])
        check(lines[-2].startswith("kernel launches: "), lines[-2])
        counts = json.loads(lines[-2][len("kernel launches: "):])
        check(lines[-3].startswith("implementation launches: "), lines[-3])
        by_impl = json.loads(lines[-3][len("implementation launches: "):])
        check((rec["batch"], rec["hw"], rec["kernel"], rec["dtype"])
              == (100, 256, kernel, "fp32"), f"bench_fused ran {rec}")
        check(rec["device"].startswith("cuda"), f"bench_fused on {rec['device']}")
        # y is O(1) here: the y tolerance is 2e-4 abs + rel
        check(0 <= rec["max_abs_diff"] <= 2 * TOL_Y,
              f"bench_fused --kernel {kernel}: max_abs_diff {rec['max_abs_diff']}")
        for n in names:
            check(counts[n] > 0, f"bench_fused --kernel {kernel} did not "
                  f"launch {n}: {counts}")
        # at Ci 16 / Cm 8 / Co 16 both pairs run on their wgmma kernels
        mine = by_impl["fused_nhwc" if kernel == "nhwc" else "bulge"]
        want = "wgmma"
        check(mine[want] == counts[names[0]] + counts[names[1]]
              and sum(mine.values()) == mine[want],
              f"bench_fused --kernel {kernel} launched {by_impl}")
        print(f"bench_fused --kernel {kernel}: " + json.dumps(rec)
              + " launches " + json.dumps(counts) + " by implementation "
              + json.dumps(by_impl), flush=True)
        out[kernel] = (rec, counts)
    return out


# ---------------------------------------------------------------------------
# phase 12: the overlap pipeline
# ---------------------------------------------------------------------------

def overlap_breakdown(cfg, net, images, bn_eval, lr_input):
    """Device ms of each stage of make_overlap_sr_fn's pipeline on `images`,
    each stage timed alone (CUDA events, a synchronize between stages)."""
    import torch

    from dcgan_sr_tpu_torch.image.ops import box_downsample2
    from dcgan_sr_tpu_torch.image.patches import (extract_overlap_patches,
                                                  stitch_overlap_naive)
    from dcgan_sr_tpu_torch.infer.seam_device import seam_stitch_device
    from dcgan_sr_tpu_torch.infer.tiled import make_overlap_sr_fn

    p, ov = cfg.patchSize, cfg.overlap
    n = images.shape[0]
    fine = tuple(d * (2 if lr_input else 1) for d in images.shape[-2:])
    ep, eov = (p // 2, ov // 2) if lr_input else (p, ov)
    with torch.inference_mode():
        def extract():
            tiles = extract_overlap_patches(images, ep, eov)
            return tiles if lr_input else box_downsample2(tiles)

        tiles = extract()
        t = tiles.shape[1]
        lr = tiles.reshape(-1, 1, p // 2, p // 2)
        gen = (lambda: net(lr, bn_stats="running")) if bn_eval else \
            (lambda: net(lr, bn_stats="pooled", groups=n))
        fake = gen()[:, 0].reshape(n, t, p, p)
        whole = make_overlap_sr_fn(cfg, net, fine=fine, bn_eval=bn_eval,
                                   lr_input=lr_input)
        iters = 5
        r = {"tiles": n * t,
             "extract_ms": time_ms(extract, iters),
             "generator_ms": time_ms(gen, iters),
             "naive_ms": time_ms(lambda: stitch_overlap_naive(fake, fine, p, ov),
                                 iters),
             "seam_ms": time_ms(lambda: seam_stitch_device(fake, fine, p, ov),
                                iters),
             "pipeline_ms": time_ms(lambda: whole(images), iters)}
        t0 = time.perf_counter()
        for _ in range(iters):
            out = whole(images)["seam"].cpu()
        r["pipeline_with_fetch_wall_ms"] = (time.perf_counter() - t0) / iters * 1e3
        del out
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in r.items()}


def overlap_phase(cfg, fused, plain, smi, fused_fma, fused_mma):
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch import bench_infer
    from dcgan_sr_tpu_torch.image.ops import box_downsample2
    from dcgan_sr_tpu_torch.image.patches import extract_overlap_patches
    from dcgan_sr_tpu_torch.infer.seam import seam_stitch
    from dcgan_sr_tpu_torch.infer.tiled import make_overlap_sr_fn
    from dcgan_sr_tpu_torch.ops import bulge as K

    dev = torch.device("cuda")
    imgs = torch.from_numpy(np.random.RandomState(0).rand(64, 64, 64)
                            .astype(np.float32)).to(dev)
    p, ov, fine = cfg.patchSize, cfg.overlap, cfg.fineSize
    counts = dict.fromkeys(K.launches, 0)
    for bn_eval in (False, True):
        name = "running-stats BN" if bn_eval else "per-image-tile BN"
        for k in K.launches:
            K.launches[k] = 0
        got = make_overlap_sr_fn(cfg, fused, bn_eval=bn_eval)(imgs)
        both = make_overlap_sr_fn(cfg, fused, bn_eval=bn_eval,
                                  both_seams=True)(imgs)
        half = make_overlap_sr_fn(cfg, fused, bn_eval=bn_eval, lr_input=True)(
            box_downsample2(imgs))
        torch.cuda.synchronize()
        check(K.launches["bulge_main"] == 3 and
              K.launches["bulge_stats"] == (0 if bn_eval else 3),
              f"overlap pipeline launched {K.launches} ({name})")
        for k in counts:
            counts[k] += K.launches[k]
        want = make_overlap_sr_fn(cfg, plain, bn_eval=bn_eval)(imgs)
        torch.cuda.synchronize()
        check(tuple(got["seam"].shape) == (64, 64, 64)
              and tuple(got["tiles"].shape) == (64, 225, 8, 8)
              and bool(torch.isfinite(got["seam"]).all()),
              f"overlap output {tuple(got['seam'].shape)}")
        et = (got["tiles"] - want["tiles"]).abs().max().item()
        en = (got["naive"] - want["naive"]).abs().max().item()
        check(_close(got["tiles"], want["tiles"], TOL_Y)
              and _close(got["naive"], want["naive"], TOL_Y),
              f"fused overlap pipeline disagrees with fuse=False ({name}): "
              f"tiles {et:.3e} naive {en:.3e}")
        flips = int(((got["seam"] - want["seam"]).abs() > TOL_Y).sum())
        # lr_input: the generator's input tiles are the protocol path's bit
        # for bit; its output is held to 1e-5, because two runs of one
        # pipeline need not agree to the bit here (cuDNN computes a convT as
        # a backward-data convolution; whether this run repeated is printed)
        lr_a = extract_overlap_patches(box_downsample2(imgs), p // 2, ov // 2)
        lr_b = box_downsample2(extract_overlap_patches(imgs, p, ov))
        check(torch.equal(lr_a, lr_b), "half-geometry tiles of the degraded "
              "images differ from the degraded full tiles")
        again = make_overlap_sr_fn(cfg, fused, bn_eval=bn_eval)(imgs)
        repeats = torch.equal(again["tiles"], got["tiles"])
        eh = (half["tiles"] - got["tiles"]).abs().max().item()
        check(_close(half["tiles"], got["tiles"], 1e-5),
              f"lr_input tiles differ from the protocol path's ({name}) by "
              f"{eh:.3e}")
        del again, lr_a, lr_b
        # device seam == host replay on the same (fused) tiles, 16 images
        # (each run's own tiles: two runs need not agree to the bit)
        for mode, res in ((False, got), (True, both)):
            host = np.stack([seam_stitch(t, fine, p, ov, both_seams=mode)
                             for t in res["tiles"][:16].cpu().numpy()])
            check(np.array_equal(res["seam"][:16].cpu().numpy(), host),
                  f"device seam != host seam (both_seams={mode}, {name})")
        print(f"overlap pipeline, 64 images of 64x64, {name}: fused vs "
              f"fuse=False max|dtiles| {et:.3e} max|dnaive| {en:.3e}, "
              f"{flips} of {got['seam'].numel()} seam pixels differ by more "
              f"than {TOL_Y}; device seam == host seam on 16 images in both "
              f"seam modes; lr_input input tiles equal, output tiles within "
              f"{eh:.3e}; a second run of the pipeline "
              f"{'repeats' if repeats else 'does not repeat'} bit for bit",
              flush=True)
        print(f"overlap breakdown, 64 images of 64x64, {name} (ms) on {smi}: "
              + json.dumps(overlap_breakdown(cfg, fused, imgs, bn_eval, False))
              + f"; pipeline_ms before the tensor-core kernel: "
              f"{EARLIER['overlap_pipeline_ms'][bn_eval]}", flush=True)
        # end to end on the card, the two implementations of the pair in turns
        with torch.inference_mode():
            for label, batch, lr_in in (
                    ("64 images of 64x64", imgs, False),
                    ("one LR 256x256 image", torch.rand(
                        (1, 256, 256), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(6)),
                     True),
                    ("one LR 64x64 image", torch.rand(
                        (1, 64, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(8)),
                     True)):
                fine_hw = tuple(d * (2 if lr_in else 1) for d in batch.shape[-2:])
                fns = {impl: make_overlap_sr_fn(cfg, net, fine=fine_hw,
                                                bn_eval=bn_eval, lr_input=lr_in)
                       for impl, net in (("fma", fused_fma),
                                         ("mma", fused_mma),
                                         ("wgmma", fused))}
                t, _ = in_turns({k: (lambda f=f: f(batch))
                                 for k, f in fns.items()}, 5)
                print(f"overlap pipeline, {label}, {name}, pair by the FMA "
                      f"kernel {t['fma']:.4f} ms, by the mma.sync kernel "
                      f"{t['mma']:.4f} ms, by the wgmma kernel (the "
                      f"default) {t['wgmma']:.4f} ms (in turns), on {smi}",
                      flush=True)
        one = torch.rand((1, 256, 256), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(6))
        print(f"overlap breakdown, one LR 256x256 image, {name} (ms) on {smi}: "
              + json.dumps(overlap_breakdown(cfg, fused, one, bn_eval, True)),
              flush=True)
        del got, both, half, want
        torch.cuda.empty_cache()
    for bn_eval in (False, True):
        for k in K.launches:
            K.launches[k] = 0
        for k in K.impl_launches:
            K.impl_launches[k] = 0
        rec = bench_infer.overlap_record(bn_eval=bn_eval, device="cuda",
                                         steps=10, dtype="fp32")
        fp32 = K.launches["bulge_stats"] + K.launches["bulge_main"]
        check(rec["value"] > 0 and K.launches["bulge_main"] > 0
              and K.impl_launches["wgmma"] == fp32
              and sum(K.impl_launches.values()) == fp32,
              f"bench_infer: {rec}, launches {K.launches}, by "
              f"implementation {K.impl_launches} (every fp32 launch by the "
              f"wgmma kernel)")
        for k in counts:
            counts[k] += K.launches[k]
        print(f"bench_infer on {smi}: " + json.dumps(rec) + " launches "
              + json.dumps(K.launches) + " by implementation "
              + json.dumps(K.impl_launches) + "; before the tensor-core "
              f"kernel: {EARLIER['bench_infer_mp_s'][bn_eval]} MP/s",
              flush=True)
    # the same measurement with the pair by each fp32 tensor-core kernel by
    # name, in turns (mma, wgmma, wgmma, mma): comparison runs, not counted
    for bn_eval in (False, True):
        got = {"mma": [], "wgmma": []}
        for impl in ("mma", "wgmma", "wgmma", "mma"):
            got[impl] += bench_infer.measure(bn_eval=bn_eval, reps=1,
                                             steps=10, bulge_impl=impl,
                                             dtype="fp32")
        print(f"bench_infer fp32 {'bn_eval' if bn_eval else 'parity BN'}, "
              f"pair by each kernel in turns (MP/s, 2 x 1 repetitions) on "
              f"{smi}: " + json.dumps({k: [round(v, 3) for v in vs]
                                       for k, vs in got.items()}), flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 13: the tiled server and the upscale tool
# ---------------------------------------------------------------------------

def tiled_upscale_phase():
    """`upscale --mode overlap` and `--mode grid`, the two processes side by
    side (nothing here is timed)."""
    import numpy as np
    from PIL import Image

    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in.png")
        Image.fromarray((np.random.RandomState(9).rand(70, 90) * 255)
                        .astype(np.uint8)).save(src)
        runs = (("gray-patch-batch-overlap", "overlap", OVERLAP_FIXTURE),
                ("gray-patch", "grid", GRID_FIXTURE))
        out, failed = {}, []

        def run(config, mode, fixture):
            try:
                out[mode] = _module([
                    "dcgan_sr_tpu_torch.upscale", "--config", config, "--mode",
                    mode, "--ckpt", fixture, "--bn-eval", "--input", src,
                    "--output", os.path.join(d, mode + ".png")])
            except Exception as e:      # re-raised below, on the main thread
                failed.append(e)

        threads = [threading.Thread(target=run, args=r) for r in runs]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if failed:
            raise failed[0]
        for _, mode, _ in runs:
            dst = os.path.join(d, mode + ".png")
            check(os.path.isfile(dst) and Image.open(dst).size == (90, 70),
                  f"upscale --mode {mode} wrote no 70x90 image")
            psnr = [l for l in out[mode] if l.startswith(f"mode={mode}")]
            check(len(psnr) == 1 and "PSNR(G)=" in psnr[0], f"{out[mode]}")
            print(f"upscale --mode {mode}: {psnr[0]}", flush=True)


# ---------------------------------------------------------------------------
# phase 14: the bulge kernel in bf16 against its plain version
# ---------------------------------------------------------------------------

# ragged and small geometries (B, Ci, Cm, Co, H, W), every triple; the last
# three are ragged shapes the wgmma kernel takes (W % 8 == 0)
BF16_RAGGED = [(2, 16, 8, 16, 37, 45), (1, 32, 16, 32, 24, 40),
               (1, 8, 4, 8, 16, 20), (3, 16, 8, 16, 1, 3),
               (2, 16, 8, 16, 37, 40), (3, 16, 8, 16, 1, 8),
               (2, 32, 16, 32, 13, 24)]


def bf16_step(y):
    """One bf16 step (2^-7 relative) at the magnitude of max |y|."""
    import math
    m = y.abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def hold_bf16(K, args, mode, run, groups, label, step=None, impl=None):
    """bulge() on bf16 x, by `impl` (None: the wrapper's own choice), against
    bulge_plain on the same bf16 x (in slices of `step` images where the
    unfused hidden tensor would not fit): y within TOL_Y_BF16_STEPS bf16
    steps of max |y|, at most TOL_Y_BF16_SHARE of y's elements different at
    all, statistics within TOL_STATS.  Returns (the implementation that ran,
    max |dy|, max |dstats|, share of y elements that differ)."""
    import torch
    x = args[0]
    bsz = x.shape[0]
    step = step or bsz
    ran = impl or K._impl_for(None, x, args[1], args[4])
    n0, i0 = dict(K.launches), dict(K.impl_launches)
    y, (m, v) = K.bulge(*args, stats=mode, running=run, groups=groups,
                        impl=impl)
    torch.cuda.synchronize()
    check(y.dtype == torch.bfloat16 and m.dtype == torch.float32,
          f"bf16 bulge gave y {y.dtype}, stats {m.dtype}")
    moved = 1 + (mode != "running")
    check(K.launches["bulge_main_bf16"] == n0["bulge_main_bf16"] + 1
          and K.launches["bulge_main"] == n0["bulge_main"]
          and K.impl_launches[ran + "_bf16"] == i0[ran + "_bf16"] + moved
          and sum(K.impl_launches.values()) == sum(i0.values()) + moved,
          f"bf16 bulge ({ran}) launched {K.launches} {K.impl_launches} "
          f"(before {n0} {i0})")
    err, differ, per = [0.0, 0.0], 0, bsz // groups if groups else None
    for i in range(0, bsz, step):
        sl = slice(i, min(i + step, bsz))
        g = None if groups is None else (sl.stop - sl.start) // per
        yp, (mp, vp) = K.bulge_plain(x[sl], *args[1:], stats=mode,
                                     running=run, groups=g)
        d = (y[sl].float() - yp.float()).abs()
        check(bool(torch.isfinite(y[sl]).all()), f"non-finite y, {label}")
        check(d.max().item() <= TOL_Y_BF16_STEPS * bf16_step(yp.float()),
              f"bf16 bulge kernel ({ran}) differs from its plain version by "
              f"{d.max().item():.3e} at {label} {mode}")
        err[0] = max(err[0], d.max().item())
        differ += int((d > 0).sum())
        del yp, d
        if mode == "running":
            continue
        if mode == "per_image":
            ms, vs = m[sl], v[sl]
        elif groups is not None:
            ms, vs = m[i // per:i // per + g], v[i // per:i // per + g]
        elif step >= bsz:
            ms, vs = m, v
        else:       # statistics pooled over more than this slice
            continue
        check(_close(ms, mp, TOL_STATS) and _close(vs, vp, TOL_STATS),
              f"bf16 bulge statistics ({ran}) disagree at {label} {mode}")
        err[1] = max(err[1], (ms - mp).abs().max().item(),
                     (vs - vp).abs().max().item())
    share = differ / y.numel()
    check(share <= TOL_Y_BF16_SHARE, f"bf16 bulge ({ran}): {share:.4%} of y "
          f"differs from the plain version at {label} {mode}")
    print(f"kernel bf16 {ran:5s} {label} {mode:9s} groups {groups}: max|dy| "
          f"{err[0]:.3e} max|dstats| {err[1]:.3e}, {share:.4%} of y differs",
          flush=True)
    return ran, err[0], err[1], share


def host_us(fn, calls=200):
    """The host's time to queue one call, us (no wait for the card)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def bf16_pair_times(K, N, x32, wT, wC, scale, bias, rmean, rvar, iters):
    """ms per call of each bf16 launch by the two kernels, in turns (mma,
    wgmma, wgmma, mma); the plain bf16 version, the cuDNN bf16 composition
    (convT, var_mean / batch_norm, ReLU, conv), the bound at the bf16 rate;
    the host's time to queue each kernel's main launch, and the wgmma
    launcher's tensor-map encode alone.  It is an error if bulge()'s choice
    is the slower kernel here."""
    import torch
    import torch.nn.functional as F

    xb = x32.to(torch.bfloat16)
    x32 = xb.float()
    b, ci, h, w = x32.shape
    cm, co = wT.shape[1], wC.shape[0]
    mu = rmean.expand(b, cm).contiguous()
    gain = (torch.rsqrt(rvar + 1e-5) * scale).expand(b, cm).contiguous()
    wTb, wCb = wT.to(torch.bfloat16), wC.to(torch.bfloat16)
    st, st_best = in_turns(
        {i: (lambda i=i: K.launch_stats(xb, wT, i)) for i in ("mma", "wgmma")},
        iters)
    mn, mn_best = in_turns(
        {i: (lambda i=i: K.launch_main(xb, wT, wC, mu, gain, bias, i))
         for i in ("mma", "wgmma")}, iters)
    chosen = K.choose_impl(ci, cm, co, h, w, torch.bfloat16)
    lib_stats = lambda: torch.var_mean(  # noqa: E731
        F.conv_transpose2d(xb, wTb, stride=2, padding=1), dim=(0, 2, 3),
        correction=0)
    lib_main = lambda: F.conv2d(F.relu(F.batch_norm(  # noqa: E731
        F.conv_transpose2d(xb, wTb, stride=2, padding=1), rmean, rvar,
        scale, bias, training=False)), wCb, stride=2, padding=1)
    reps = 1000
    t = time.perf_counter()
    check(K._wlib.bulge_wgmma_encode(xb.data_ptr(), b, ci, h, w, reps) == 0,
          "tensor-map encode failed")
    encode = (time.perf_counter() - t) / reps * 1e6
    with N.fp32_convs():
        r = {"impl": chosen, "stats_ms": st[chosen], "main_ms": mn[chosen],
             "stats_wgmma_ms": st["wgmma"], "main_wgmma_ms": mn["wgmma"],
             "stats_mma_ms": st["mma"], "main_mma_ms": mn["mma"],
             "plain_stats_ms": time_ms(lambda: N.batch_stats(
                 N.conv_transpose2d(x32, wTb.float(), 2, 1)), iters),
             "plain_main_ms": time_ms(lambda: K.bulge_plain(
                 xb, wT, scale, bias, wC, stats="running",
                 running=(rmean, rvar)), iters),
             "lib_stats_ms": time_ms(lib_stats, iters),
             "lib_main_ms": time_ms(lib_main, iters),
             "host_us_main": {i: host_us(lambda i=i: K.launch_main(
                 xb, wT, wC, mu, gain, bias, i)) for i in ("mma", "wgmma")},
             "encode_us": encode}
    hw = b * h * w
    flops_convT = 2 * 16 * hw * ci * cm
    f_stats = flops_convT + 3 * 4 * hw * cm
    f_main = f_stats + 2 * 16 * hw * co * cm
    slots = -(-h // 8) * -(-w // 32)
    b_stats = 2 * (hw * ci + wT.numel()) + 4 * b * slots * 2 * cm
    b_main = 2 * (hw * ci + hw * co + wT.numel() + wC.numel()) \
        + 4 * (2 * b * cm + cm)
    r["stats_bound"] = bound(f_stats, b_stats, PEAK_BF16)
    r["main_bound"] = bound(f_main, b_main, PEAK_BF16)
    for k in ("stats", "main"):
        r[f"{k}_share_of_bound"] = r[f"{k}_bound"][0] / r[f"{k}_ms"]
    # the better turn of each, with phase 2's slack
    check(mn_best[chosen] <= min(mn_best.values()) * 1.05 + 0.01
          and st_best[chosen] <= min(st_best.values()) * 1.05 + 0.01,
          f"bulge() runs {chosen} on bf16 x {tuple(x32.shape)}, which is the "
          f"slower kernel in this run: stats {st}, main {mn}")
    return r


def bf16_kernel_phase(params, state, oparams, ostate):
    """K2 in bf16 against its plain version on the card: through bulge()'s
    own choice (the wgmma kernel at the path shapes) at gray-3 LR 256, one
    image's and 64 images' overlap tiles, every statistics mode, and ragged
    shapes; the mma.sync kernel by name at one image's tiles and the ragged
    shapes.  Times of both kernels in turns at the three path shapes.
    Returns ({impl: {kernel: worst |diff|}}, [(shape, times)])."""
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import nn as N

    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731

    def weights(p, s):
        return (t(p[3]["w"]), t(p[4]["w"]), t(p[3]["bn_scale"]),
                t(p[3]["bn_bias"]), t(s[3]["bn"]["mean"]), t(s[3]["bn"]["var"]))

    gen = torch.Generator(device=dev).manual_seed(10)
    err = {i: {"bulge_stats_bf16": 0.0, "bulge_main_bf16": 0.0}
           for i in K.BF16_IMPLS}

    def hold(*a, **kw):
        ran, dy, ds, _ = hold_bf16(K, *a, **kw)
        err[ran]["bulge_main_bf16"] = max(err[ran]["bulge_main_bf16"], dy)
        err[ran]["bulge_stats_bf16"] = max(err[ran]["bulge_stats_bf16"], ds)

    rows = []
    cases = ((weights(params, state), (1, 16, 2048, 2048),
              [(m, None) for m in K.STATS_MODES], None, 5, ()),
             (weights(oparams, ostate), (225, 32, 32, 32),
              [(m, None) for m in K.STATS_MODES], None, 20, ("mma",)),
             (weights(oparams, ostate), (14400, 32, 32, 32),
              [("running", None), ("pooled", 64)], 225 * 16, 5, ()))
    for (wT, wC, scale, bias, rmean, rvar), shape, modes, step, iters, \
            also in cases:
        x = torch.rand(shape, generator=gen, device=dev)
        xb = x.to(torch.bfloat16)
        for mode, groups in modes:
            run = (rmean, rvar) if mode == "running" else None
            for impl in (None,) + also:
                hold((xb, wT, scale, bias, wC), mode, run, groups,
                     str(shape), step=step, impl=impl)
        r = bf16_pair_times(K, N, x, wT, wC, scale, bias, rmean, rvar, iters)
        print(f"bf16 times {shape}: " + _fmt(r), flush=True)
        rows.append((shape, r))
        del x, xb
        torch.cuda.empty_cache()
    for bsz, ci, cm, co, h, w in BF16_RAGGED:
        rng = np.random.RandomState(bsz + ci)
        a = (torch.randn((bsz, ci, h, w), generator=gen, device=dev).to(
            torch.bfloat16), t(0.1 * rng.randn(ci, cm, 4, 4)),
             t(1 + 0.1 * rng.randn(cm)), t(0.1 * rng.randn(cm)),
             t(0.1 * rng.randn(co, cm, 4, 4)))
        run = (t(0.1 * rng.randn(cm)), t(0.5 + rng.rand(cm)))
        chosen = K._impl_for(None, a[0], a[1], a[4])
        for mode in K.STATS_MODES:
            for impl in (None, "mma") if chosen == "wgmma" else (None,):
                hold(a, mode, run if mode == "running" else None, None,
                     str((bsz, ci, cm, co, h, w)), impl=impl)
    return err, rows


def bf16_kernel_phase_alone():
    """Phase 14 by itself, with both fixtures' layer-3/4 weights:
    python -c "import chip_smoke as c; c.bf16_kernel_phase_alone()"."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.models import generator_spec, init_network
    from dcgan_sr_tpu_torch.train.checkpoint import load_branch

    trees = []
    for variant, path in (("gray-3", FIXTURE),
                          ("gray-patch-batch-overlap", OVERLAP_FIXTURE)):
        p, s = init_network(generator_spec(get_config(
            variant, env_override=False)), torch.Generator().manual_seed(0))
        with np.load(path) as data:
            trees += [load_branch(data, "params", p),
                      load_branch(data, "state", s)]
    return bf16_kernel_phase(*trees)


# ---------------------------------------------------------------------------
# phase 15: the bf16 training step at bench.py's geometry
# ---------------------------------------------------------------------------

# (variant, the step's batch as bench.py feeds it, bench.py:38-45)
BF16_TRAIN = (("gray-3", (100, 1, 64, 64)), ("rgb-full", (100, 3, 64, 64)),
              ("gray-patch-batch", (1280, 1, 8, 8)))
K_STEPS = 20


def _cli_batches(cfg, n, device):
    """n consecutive trainer batches as the CLI builds them (the patch
    variants' grids, the pm1 range), on the card."""
    import torch

    from dcgan_sr_tpu_torch import cli
    _, batch_fn = cli.build_data(cfg, type("Args", (), {"synthetic": True})())
    return torch.stack([torch.from_numpy(batch_fn(1, i)) for i in range(n)]
                       ).to(device)


def profile_kernels(cfg, state, batches):
    """profile_step.profile_steps over 3 steps (every kernel), per step: the
    device's busy share of the wall time, its kernel and copy ms and
    launches, the device ms of cuDNN's fp32 backward engines named in
    PERF.md (dgrad_engine, wgrad_alg0_engine), and the six kernels that take
    most."""
    from dcgan_sr_tpu_torch.profile_step import profile_steps

    r = profile_steps(cfg, state, batches, 3, top=None)
    kernels = r["device_top"]
    return {"device_busy_share": round(r["device_busy_share"], 4),
            "device_ms_per_step": round(sum(ms for _, _, ms in kernels), 4),
            "launches_per_step": r["launches_per_step"],
            "cudnn_fp32_backward_ms": {
                k: round(sum(ms for name, _, ms in kernels if k in name), 4)
                for k in ("dgrad_engine", "wgrad_alg0_engine")},
            "top_kernels": [(name[:60], round(ms, 4))
                            for name, _, ms in kernels[:6]]}


def bf16_step_phase(smi):
    """K = 20 bf16 steps a call (train/multi_step.py) for each of bench.py's
    three trainers at full width from a seed, bench's workload
    (bench.workload) run twice, untimed (its images/s are phase 27's bench
    lines): the launches that ran, finite losses, the stage breakdown (10
    queued single steps); for gray-3, whether G backward still runs cuDNN's
    fp32 engines.  Returns {variant: its record}."""
    import math

    import torch

    from dcgan_sr_tpu_torch import bench
    from dcgan_sr_tpu_torch.ops import preprocess as P
    from dcgan_sr_tpu_torch.train.multi_step import launches_run

    dev = torch.device("cuda")
    out = {}
    for variant, shape in BF16_TRAIN:
        n0 = P.launches["preprocess"]
        w = bench.workload(variant, K_STEPS, dev)
        cfg, state, multi, hr = w.cfg, w.state, w.runner, w.batches
        check(cfg.compute_dtype == "bfloat16"
              and tuple(hr.shape[1:]) == shape, f"{variant} batch {hr.shape}")
        for _ in range(2):
            _, metrics = multi(state, hr)
        last = {k: v[-1].item() for k, v in metrics.items()}
        # the first call's chunk runs eagerly and is then captured (counted,
        # not run); the second is a replay
        run = launches_run({"preprocess": P.launches["preprocess"] - n0},
                           multi)["preprocess"]
        check(multi.replays == 1 and run == 2 * K_STEPS,
              f"{variant}: preprocess ran {run} times in {2 * K_STEPS} "
              f"steps ({multi.stats()})")
        check(all(math.isfinite(v) for v in last.values()),
              f"{variant} bf16 losses {last}")
        imgs = cfg.images_consumed_per_step
        r = {"losses_after_40_steps": {k: round(v, 5) for k, v in
                                       last.items()}}
        bd = step_breakdown(cfg, state, smi, batches=list(hr[:4]),
                            benchmarks=(False,))[False]
        r["breakdown"] = bd
        r["profile"] = profile_kernels(cfg, state, list(hr[:4]))
        print(f"bf16 train step, {variant} {shape} ({imgs} images a step), "
              f"K={K_STEPS} a call, on {smi}: " + json.dumps(r), flush=True)
        out[variant] = r
        del state, hr, multi, w
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 16: bf16 serving, bench_infer and bench_fused in bf16
# ---------------------------------------------------------------------------

def bf16_serve_phase(smi):
    """`serve --bf16 --warmup` for gray-3 and the tiled config, both BN
    modes, the four servers started together and driven one after the
    other once all are up; each response held to the unfused bf16 generator
    in this process.  Returns the launch counts after warmup."""
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.serve import SRService
    from dcgan_sr_tpu_torch.train.checkpoint import load_branch

    launches = dict.fromkeys(K.launches, 0)
    runs = []
    for variant, fixture, timed in (
            ("gray-3", FIXTURE, ((64, 64), (256, 256))),
            ("gray-patch-batch-overlap", OVERLAP_FIXTURE,
             ((64, 64), (256, 256)))):
        cfg = get_config(variant, env_override=False)
        spec = generator_spec(cfg)
        params, state = init_network(spec, torch.Generator().manual_seed(0))
        with np.load(fixture) as data:
            params = load_branch(data, "params", params)
            state = load_branch(data, "state", state)
        plain = Network(spec, params, state, device="cuda", fuse=False)
        for parity in (True, False):
            runs.append((cfg, fixture, timed, plain, parity))
    with tempfile.TemporaryFile() as log:
        servers = [start_server(cfg, parity, log, fixture,
                                extra=("--bf16", "--warmup"))
                   for cfg, fixture, _, _, parity in runs]
        try:
            for srv, (cfg, _, _, _, parity) in zip(servers, runs):
                wait_up(srv, f"{cfg.variant} bf16")
            for srv, (cfg, _, timed, plain, parity) in zip(servers, runs):
                bn = "parity-bn" if parity else "running"
                ref = SRService(cfg, plain, max_batch=8, window_ms=0,
                                bn_eval=not parity, u8_io=True,
                                compute_dtype=torch.bfloat16)
                try:
                    counts, lats, _ = serve_phase(
                        cfg, parity, ref, srv, timed=timed,
                        flip_share=TOL_U8_BF16_SHARE, levels=TOL_U8_BF16,
                        bf16=True)
                finally:
                    ref.close()
                check(counts["bulge_main_bf16"] > 0
                      and (counts["bulge_stats_bf16"] > 0) == parity
                      and counts["bulge_main"] == 0,
                      f"bf16 server ({cfg.variant}, {bn}) launched {counts}")
                for k, v in counts.items():
                    launches[k] += v
                for (h, w), (lat, batch, first) in lats.items():
                    p50 = lat[len(lat) // 2]
                    print(f"latency (bf16, {cfg.variant}, {bn}) LR {h}x{w} -> "
                          f"{2 * h}x{2 * w}: client p50 {p50:.2f} ms, first "
                          f"request after warmup {first:.2f} ms, server batch "
                          f"median {batch[len(batch) // 2]:.2f} ms, "
                          f"{4 * h * w / 1e6 / (p50 / 1e3):.2f} MP/s out, on "
                          f"{smi}", flush=True)
        except Exception:
            log.seek(0)
            sys.stderr.write(log.read().decode(errors="replace")[-8000:])
            raise
        finally:
            for proc, _ in servers:
                stop_server(proc)
        log.seek(0)
        for line in log.read().decode(errors="replace").splitlines():
            if line.startswith("warmup:"):
                print("server| " + line, flush=True)
    return launches


def bf16_bench_phase(smi):
    """The bf16 overlap pipeline (bench_infer.measure, both BN modes) with
    the pair by each bf16 kernel by name, in turns, and `bench_fused
    --kernel bulge --dtype bf16` as a subprocess.  Returns the bf16
    kernels' launch counts of bench_fused."""
    from dcgan_sr_tpu_torch import bench_infer
    from dcgan_sr_tpu_torch.ops import bulge as K

    counts = dict.fromkeys(K.launches, 0)
    # bench_infer's bf16 records, and their launches by implementation, are
    # phase 27's (python -m dcgan_sr_tpu_torch.bench); here the pipeline
    # with the pair by each bf16 kernel by name, in turns (mma, wgmma,
    # wgmma, mma): comparison runs, not counted
    for bn_eval in (False, True):
        got = {"mma": [], "wgmma": []}
        for impl in ("mma", "wgmma", "wgmma", "mma"):
            got[impl] += bench_infer.measure(bn_eval=bn_eval, reps=1,
                                             steps=10, bulge_impl=impl)
        print(f"bench_infer bf16 {'bn_eval' if bn_eval else 'parity BN'}, "
              f"pair by each kernel in turns (MP/s, 2 x 1 repetitions) on "
              f"{smi}: " + json.dumps({k: [round(v, 3) for v in vs]
                                       for k, vs in got.items()}), flush=True)
    lines = _module(["dcgan_sr_tpu_torch.bench_fused", "--kernel", "bulge",
                     "--dtype", "bf16", "--iters", "10"])
    rec = json.loads(lines[-1])
    fused_counts = json.loads(lines[-2][len("kernel launches: "):])
    by_impl = json.loads(lines[-3][len("implementation launches: "):])
    check((rec["batch"], rec["hw"], rec["dtype"], rec["kernel"])
          == (100, 256, "bf16", "bulge") and rec["device"].startswith("cuda"),
          f"bench_fused bf16 ran {rec}")
    check(0 <= rec["max_abs_diff"] <= TOL_BENCH_BF16,
          f"bench_fused bf16: max_abs_diff {rec['max_abs_diff']}")
    check(fused_counts["bulge_stats_bf16"] > 0
          and fused_counts["bulge_main_bf16"] > 0
          and by_impl["bulge"]["wgmma_bf16"] == fused_counts["bulge_stats_bf16"]
          + fused_counts["bulge_main_bf16"]
          and by_impl["bulge"]["mma_bf16"] == 0
          and by_impl["bulge"]["mma"] == by_impl["bulge"]["fma"] == 0
          and by_impl["bulge"]["wgmma"] == 0,
          f"bench_fused bf16 launched {fused_counts}, {by_impl}")
    print(f"bench_fused --kernel bulge --dtype bf16 on {smi}: "
          + json.dumps(rec) + " launches " + json.dumps(fused_counts),
          flush=True)
    for k in counts:
        counts[k] += fused_counts[k]
    return counts


# ---------------------------------------------------------------------------
# phases 17-19: training on image files, and the eval protocol
# ---------------------------------------------------------------------------

def write_jpegs(directory, names, seed, hw=(218, 178)):
    """CelebA-like JPEGs (178x218, the aligned crops' size) of smooth random
    textures: a coarse random field, bilinear-upscaled, plus a little
    noise, from a seed."""
    import numpy as np
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    for name in names:
        base = Image.fromarray((rng.rand(h // 16, w // 16, 3) * 255).astype(
            np.uint8)).resize((w, h), Image.BILINEAR)
        arr = np.asarray(base, np.float32) + rng.randn(h, w, 3) * 6.0
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            os.path.join(directory, name), quality=90)


def _launch_line(lines):
    check(lines[-1].startswith("kernel launches: "), lines[-1])
    return json.loads(lines[-1][len("kernel launches: "):])


FOLDER_RUNS = (("gray", "--device-augment", "rgb_to_gray+to_pm1"),
               ("rgb-full", "--device-preprocess", "to_pm1"))


def folder_crop_check(ds, cfg):
    """One step's (hr, lr) from the device crop + K1 against the host
    trainHook + the plain preprocess on equal-seeded rngs: the crops bit
    for bit (tests/test_torch_device_augment.py), and K1 bit for bit
    against its plain version (phase 5's tolerance)."""
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.image.ops import crop_hflip_at
    from dcgan_sr_tpu_torch.ops import preprocess as P

    canvas, tops, lefts, flips = ds.sample_canvas(cfg.batchSize,
                                                  np.random.RandomState(21))
    host = ds.sample(cfg.batchSize, np.random.RandomState(21), normalize=False)
    n0 = P.launches["preprocess"]
    crop = crop_hflip_at(torch.from_numpy(canvas).cuda(), tops, lefts, flips,
                         cfg.fineSize)
    hr, lr = P.preprocess(crop, rgb_to_gray=cfg.nc == 1, to_pm1=True)
    hp, lp = P.preprocess_plain(torch.from_numpy(host).cuda(),
                                rgb_to_gray=cfg.nc == 1, to_pm1=True)
    torch.cuda.synchronize()
    check(P.launches["preprocess"] == n0 + 1, "K1 did not launch")
    check(torch.equal(crop.cpu(), torch.from_numpy(host)),
          "the device crop differs from the host trainHook's")
    err = max((hr - hp).abs().max().item(), (lr - lp).abs().max().item())
    check(err == 0.0, f"device crop + K1 differs from the host hook + plain "
          f"preprocess by {err}")
    return {"shape": list(crop.shape), "max_abs_err": err}


def _zero_counts():
    """Every kernel wrapper's launch count set to 0."""
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import preprocess as P

    for counts in (K.launches, P.launches):
        for k in counts:
            counts[k] = 0


def _cli(args, env=None):
    """The trainer's entry point, cli.main, in this process as a user's
    `python -m dcgan_sr_tpu_torch.cli` runs it: the launch counts from 0,
    no config override from the environment but `env`'s, its output
    captured."""
    from dcgan_sr_tpu_torch import cli

    _zero_counts()
    return _in_process(cli.main, args, env)[1]


def _step_ms(step, state, batch, iters=5):
    """Mean wall ms of `iters` train steps whose batch is already on the
    card, synchronised at both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, batch)
    torch.cuda.synchronize()
    return round((time.perf_counter() - t0) / iters * 1e3, 4)


class _Drain:
    """A consumer thread that keeps taking batches from a loader, so that
    its workers decode all the time while the main thread times steps."""

    def __init__(self, loader):
        self.loader, self.stop = loader, threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.stop.is_set():
            self.loader.get_batch()

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()


def host_contention(root, state, step, batch):
    """Does decoding on the host slow the device step, and does decode
    scale with its threads?  The gray step with its batch already on the
    card, timed with no loader and beside 1 and 4 workers that decode all
    the while; and the loader alone (images/s) at 1 and 4 workers: decode
    held by the interpreter lock would give about the same at both."""
    from dcgan_sr_tpu_torch import cli
    from dcgan_sr_tpu_torch.core import get_config

    args = type("Args", (), {"synthetic": False, "data_root": root})()
    out = {"cpu_cores": len(os.sched_getaffinity(0)),
           "step_ms_no_loader": _step_ms(step, state, batch)}
    for n in (1, 4):
        cfg = get_config("gray", env_override=False, device_augment=True,
                         device_preprocess=True, manualSeed=1, nThreads=n)
        loader, _ = cli.build_data(cfg, args)
        try:
            loader.get_batch()                      # the first, warm
            t0 = time.perf_counter()
            for _ in range(4):
                loader.get_batch()
            out[f"loader_images_per_s_{n}_threads"] = round(
                4 * cfg.batchSize / (time.perf_counter() - t0), 2)
            with _Drain(loader):
                out[f"step_ms_{n}_threads_decoding"] = _step_ms(
                    step, state, batch)
        finally:
            loader.close()
    out["step_ms_no_loader_after"] = _step_ms(step, state, batch)
    return out


def folder_trainer_phase(smi, root):
    """Phase 17: the folder trainers through their entry point (gray with
    --device-augment, rgb-full with --device-preprocess, batch 100, full
    width), K1 once a step in its raw-RGB modes; then the gray one driven
    here: images/s, the data stage's ms, the device's busy share, and
    whether decoding threads slow the step (host_contention)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dcgan_sr_tpu_torch import cli
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.data.folder import FolderDataset
    from dcgan_sr_tpu_torch.ops import preprocess as P
    from dcgan_sr_tpu_torch.profile_step import _device_us
    from dcgan_sr_tpu_torch.train.loop import train_epochs
    from dcgan_sr_tpu_torch.train.multi_step import (build_multi_step,
                                                     launches_run)
    from dcgan_sr_tpu_torch.train.step import build_train_step, init_train_state

    counts = {}
    for variant, flag, mode in FOLDER_RUNS:
        t0 = time.perf_counter()
        lines = _cli(["--config", variant, "--data-root", root, flag,
                      "--steps", "6", "--scan", "3", "--epochs", "1",
                      "--seed", "1"])
        wall = time.perf_counter() - t0
        cfg_line = next(l for l in lines if l.startswith("config: "))
        check("batchSize=100" in cfg_line and "device_preprocess=True"
              in cfg_line, f"not the folder trainer at batch 100: {cfg_line}")
        steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
        check(len(steps) == 2 and all(steps), f"log lines: {lines}")
        run, graph = k1_run(lines)
        check(run == 6 and graph["replays"] == 1, f"{variant} {flag}: K1 "
              f"ran {run} times in 6 steps (graphs {graph})")
        counts[mode] = run
        for l in lines:
            if not l.startswith("config: "):
                print(f"folder trainer {variant}| " + l, flush=True)
        print(f"folder trainer {variant} {flag}: 6 steps in {wall:.1f}s "
              f"through cli.main", flush=True)

    cfg = get_config("gray", env_override=False, device_augment=True,
                     device_preprocess=True, manualSeed=1)
    args = type("Args", (), {"synthetic": False, "data_root": root})()
    loader, batch_fn = cli.build_data(cfg, args)
    try:
        crop = folder_crop_check(FolderDataset(
            root, cfg.loadSize, cfg.fineSize, cfg.nc), cfg)
        state = init_train_state(cfg, torch.Generator().manual_seed(1),
                                 device="cuda")
        quiet = lambda line: None  # noqa: E731
        # one runner for every run here: the warm run's chunk runs eagerly
        # and is captured, every later chunk is a replay
        multi = build_multi_step(cfg)
        train_epochs(cfg, state, batch_fn, niter=1, steps_per_epoch=3,
                     scan_steps=3, multi_step_fn=multi, log_fn=quiet)
        timed = {}
        for staged in (False, True):
            n0, since = P.launches["preprocess"], multi.stats()
            lines = []
            t0 = time.perf_counter()
            train_epochs(cfg, state, batch_fn, niter=1, steps_per_epoch=6,
                         scan_steps=3, multi_step_fn=multi,
                         log_fn=lines.append, stage_ahead=staged)
            wall = time.perf_counter() - t0
            counted = P.launches["preprocess"] - n0
            run = launches_run({"preprocess": counted}, multi,
                               since)["preprocess"]
            check(counted == 0 and run == 6,
                  f"K1 once a step, every chunk a replay: counted {counted}, "
                  f"ran {run}")
            data_s = [float(re.search(r"DataTime: ([\d.]+)", l).group(1))
                      for l in lines if l.startswith("Epoch:")]
            timed[staged] = (wall, data_s)
        wall, data_s = timed[False]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            train_epochs(cfg, state, batch_fn, niter=1, steps_per_epoch=3,
                         scan_steps=3, multi_step_fn=multi, log_fn=quiet)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t1
        device_us = sum(_device_us(r) for r in prof.key_averages()
                        if r.device_type == DeviceType.CUDA)
        dev_batch = tuple(torch.from_numpy(a).cuda() for a in batch_fn(1, 0))
    finally:
        loader.close()
    step = build_train_step(cfg)
    step(state, dev_batch)                                # warm
    swall, sdata = timed[True]
    r = {"images_per_s": round(6 * cfg.batchSize / wall, 2),
         "step_ms": round(wall / 6 * 1e3, 4),
         "data_stage_ms_per_step": round(sum(data_s) / 6 * 1e3, 4),
         "stage_ahead": {
             "images_per_s": round(6 * cfg.batchSize / swall, 2),
             "step_ms": round(swall / 6 * 1e3, 4),
             "data_stage_ms_per_step": round(sum(sdata) / 6 * 1e3, 4)},
         "device_busy_share": round(device_us * 1e-6 / pwall, 4),
         "device_ms_per_step": round(device_us / 3 * 1e-3, 4),
         "n_threads": cfg.nThreads, "crop_check": crop,
         "host_contention": host_contention(root, state, step, dev_batch)}
    print(f"folder trainer gray --device-augment, batch 100, 178x218 JPEGs, "
          f"{cfg.nThreads} loader threads, on {smi}: " + json.dumps(r),
          flush=True)
    return counts, r


def indexed_eval_phase(smi, route, samples):
    """Phase 18: the indexed trainer (gray-3, batch 100) on files
    000001-000300 (three steps) and 200001-200200 (the test slice), then
    --eval --eval-sets 2 and --samples-dir, with --native-loader where the
    committed library loads here; through cli.main."""
    from dcgan_sr_tpu_torch.data import native

    args = ["--config", "gray-3", "--data-root", route, "--steps", "3",
            "--epochs", "1", "--seed", "1", "--eval", "--eval-sets", "2",
            "--samples-dir", samples]
    if native.available():
        args.append("--native-loader")
    t0 = time.perf_counter()
    lines = _cli(args)
    wall = time.perf_counter() - t0
    loader = ("native" if "using native C++ indexed loader" in lines else
              "python")
    check(not any("not found" in l for l in lines), "the indexed route was "
          "not found")
    ref = [l for l in lines if l.startswith("[")]
    for tag in ("Train-set", "Test-set"):
        got = [l for l in ref if l.startswith(f"[{tag}]")]
        check(len(got) == 4 and all("train-Size: 200" in l for l in got),
              f"{tag} lines: {got}")
    c = _launch_line(lines)
    check(c["bulge_stats"] > 0 and c["bulge_main"] > 0,
          f"K2 was not launched by the eval: {c}")
    check(c["preprocess"] == 3, f"K1 launched {c['preprocess']} times")
    pngs = sorted(f for f in os.listdir(samples) if f.endswith(".png"))
    check(len(pngs) == 4, f"sample PNGs: {pngs}")
    for l in ref + [l for l in lines if l.startswith(("PSNR", "SSIM"))]:
        print("indexed trainer| " + l, flush=True)
    print(f"indexed trainer + eval, gray-3 batch 100, {loader} loader "
          f"(native library loads here: {native.available()}"
          f"{'' if native.available() else ', ' + str(native.load_error())}"
          f"): {wall:.1f}s through cli.main, launches {json.dumps(c)}, "
          f"PNGs {pngs}", flush=True)
    return c, loader


EVAL_SETS = {"gray-3": [2001, 2002, 2003], "overlap": [10000]}


def eval_phase(smi):
    """Phase 19: the committed gray-3 and overlap fixtures scored on the
    card (K2 in the fused eval generator) and on the CPU (the plain pair)
    on the same TexturedImages at batch 100: PSNR within 1e-3 dB, SSIM
    within 1e-4; seam > naive > bilinear on the card; eval images/s over
    three batches (gray-3) and one (overlap, both BN modes)."""
    import torch

    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.data.synthetic import TexturedImages
    from dcgan_sr_tpu_torch.evaluation import (evaluate_overlap_slice,
                                               evaluate_slice)
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.train.checkpoint import load_generator

    out = {}
    cfg = get_config("gray-3", env_override=False)
    src = TexturedImages(cfg.fineSize, nc=1, seed=1234)
    card, _ = load_generator(cfg, FIXTURE, device="cuda")
    cpu, _ = load_generator(cfg, FIXTURE, device="cpu")
    sets = EVAL_SETS["gray-3"]
    for fs in sets:
        src.load_batch(fs, 100)               # render outside the clocks
    # the first set on the card (also the warm-up) and on the CPU
    r_card = evaluate_slice(cfg, card, src, sets[:1], batch_size=100)
    t0 = time.perf_counter()
    r_cpu = evaluate_slice(cfg, cpu, src, sets[:1], batch_size=100)
    cpu_wall = time.perf_counter() - t0
    for d in (K.launches, K.impl_launches):
        for k in d:
            d[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_all = evaluate_slice(cfg, card, src, sets, batch_size=100)
    wall = time.perf_counter() - t0
    launches = dict(K.launches)
    check(launches["bulge_stats"] == len(sets) and launches["bulge_main"]
          == len(sets) and K.impl_launches["wgmma"] == 2 * len(sets)
          and sum(K.impl_launches.values()) == 2 * len(sets),
          f"the eval launched K2 {launches}, by implementation "
          f"{K.impl_launches} (every one by the fp32 wgmma kernel)")
    total = dict(launches)
    fields = ("psnr_bilinear", "psnr_generator", "ssim_bilinear",
              "ssim_generator")
    diff = {f: abs(getattr(r_card, f) - getattr(r_cpu, f)) for f in fields}
    for f, d in diff.items():
        check(d <= (1e-3 if f.startswith("psnr") else 1e-4),
              f"gray-3 eval {f}: card {getattr(r_card, f)} cpu "
              f"{getattr(r_cpu, f)}")
    out["gray-3"] = {"card": vars(r_card), "cpu": vars(r_cpu),
                     "abs_diff": diff, "card_3_sets": vars(r_all),
                     "images_per_s": round(r_all.n_images / wall, 2),
                     "cpu_images_per_s": round(r_cpu.n_images / cpu_wall, 2),
                     "launches": launches}
    del card
    torch.cuda.empty_cache()

    ocfg = get_config("gray-patch-batch-overlap", env_override=False)
    card, _ = load_generator(ocfg, OVERLAP_FIXTURE, need_state=True,
                             device="cuda")
    cpu, _ = load_generator(ocfg, OVERLAP_FIXTURE, need_state=True,
                            device="cpu")
    sets = EVAL_SETS["overlap"]
    for fs in sets:
        src.load_batch(fs, 100)
    orow = {}
    for bn_eval in (True, False):       # the CPU holds the claim's mode
        evaluate_overlap_slice(ocfg, card, src, sets, batch_size=100,
                               bn_eval=bn_eval)                # warm
        for d in (K.launches, K.impl_launches):
            for k in d:
                d[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = evaluate_overlap_slice(ocfg, card, src, sets, batch_size=100,
                                    bn_eval=bn_eval)
        wall = time.perf_counter() - t0
        ol = dict(K.launches)
        fp32 = ol["bulge_stats"] + ol["bulge_main"]
        check(ol["bulge_main"] > 0 and (ol["bulge_stats"] > 0) != bn_eval
              and K.impl_launches["wgmma"] == fp32
              and sum(K.impl_launches.values()) == fp32,
              f"the overlap eval launched K2 {ol}, by implementation "
              f"{K.impl_launches}")
        for k in ("bulge_stats", "bulge_main"):
            total[k] += ol[k]
        d = None
        if bn_eval:
            rp = evaluate_overlap_slice(ocfg, cpu, src, sets, batch_size=100,
                                        bn_eval=bn_eval)
            of = ("psnr_bilinear", "psnr_naive", "psnr_seam",
                  "ssim_bilinear", "ssim_naive", "ssim_seam")
            d = {f: abs(getattr(rc, f) - getattr(rp, f)) for f in of}
            for f, v in d.items():
                check(v <= (1e-3 if f.startswith("psnr") else 1e-4),
                      f"overlap eval (bn_eval={bn_eval}) {f}: card "
                      f"{getattr(rc, f)} cpu {getattr(rp, f)}")
            check(rc.psnr_seam > rc.psnr_naive > rc.psnr_bilinear,
                  f"the overlap fixture's claim fails on the card: {vars(rc)}")
        orow["bn_eval" if bn_eval else "per_image_tiles"] = {
            "card": vars(rc), "abs_diff": d, "launches": ol,
            "images_per_s": round(rc.n_images / wall, 2)}
    out["overlap"] = orow
    out["launches"] = total
    print(f"eval on the card against the CPU, TexturedImages at batch 100, "
          f"on {smi}: " + json.dumps(out, default=float), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 21: the channels-last pair in bf16
# ---------------------------------------------------------------------------

# ((B, Ci, Cm, Co, H, W), tm): the three built triples, ragged widths, a
# pass clipped at its band's end, more images than a grid dimension takes,
# and bench_fused's shape (timed)
K3_BF16_CASES = [((2, 8, 4, 8, 32, 37), 8), ((2, 16, 8, 16, 64, 100), 32),
                 ((2, 32, 16, 32, 32, 33), 16), ((3, 16, 8, 16, 6, 3), 6),
                 ((70000, 16, 8, 16, 8, 8), 8),
                 ((100, 16, 8, 16, 256, 256), 32)]


def hold_k3_bf16(F3, args, tm, label, impl):
    """K3 on bf16 x by `impl` against its plain bf16 version on the same
    inputs: y within TOL_Y_BF16_STEPS bf16 steps of max |y| with at most
    TOL_Y_BF16_SHARE of its elements different at all, moments within
    TOL_STATS; only the bf16 launch counts move, by `impl`.  Returns (max
    |dy|, max |dstats|, share of y that differs, y, mean, var)."""
    import torch
    n0, i0 = dict(F3.launches), dict(F3.impl_launches)
    y, (m, v) = F3.fused_convT_bn_relu_conv(*args, tm=tm, impl=impl)
    yp, (mp, vp) = F3.fused_nhwc_plain(*args, tm=tm)
    torch.cuda.synchronize()
    check(y.dtype == torch.bfloat16 and m.dtype == torch.float32,
          f"K3 bf16 gave y {y.dtype}, moments {m.dtype}")
    check(F3.launches == {k: c + k.endswith("_bf16") for k, c in n0.items()}
          and F3.impl_launches == {**i0, impl + "_bf16":
                                   i0[impl + "_bf16"] + 2},
          f"K3 bf16 ({impl}) launched {F3.launches}, {F3.impl_launches} "
          f"(before {n0}, {i0})")
    check(bool(torch.isfinite(y).all()), f"non-finite K3 bf16 y at {label}")
    d = (y.float() - yp.float()).abs()
    ey, share = d.max().item(), (d > 0).float().mean().item()
    check(ey <= TOL_Y_BF16_STEPS * bf16_step(yp.float()),
          f"K3 bf16 differs from its plain version by {ey:.3e} at {label}")
    check(share <= TOL_Y_BF16_SHARE,
          f"K3 bf16: {share:.4%} of y differs at {label}")
    check(_close(m, mp, TOL_STATS) and _close(v, vp, TOL_STATS),
          f"K3 bf16 moments disagree at {label}")
    es = max((m - mp).abs().max().item(), (v - vp).abs().max().item())
    print(f"K3 bf16 {label} tm {tm} {impl}: max|dy| {ey:.3e} (a bf16 step of "
          f"max|y|: {bf16_step(yp.float()):.3e}), {share:.4%} of y differs, "
          f"max|dstats| {es:.3e}", flush=True)
    return ey, es, share, y, m, v


def k3_bf16_phase(smi):
    """Phase 21: K3 in bf16 by the wgmma and the mma.sync kernel against its
    plain version, the two kernels' launches timed in turns at
    bench_fused's shape, and bench_fused --kernel nhwc (bf16 by default) as
    users start it.  Returns ({kernel: worst |diff| of the chosen
    implementation}, the timing row, bench_fused's launch counts)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dcgan_sr_tpu_torch.ops import fused_nhwc as F3
    from dcgan_sr_tpu_torch.ops import nn as N

    dev = torch.device("cuda")
    err = {"fused_nhwc_stats_bf16": 0.0, "fused_nhwc_main_bf16": 0.0}
    row = None
    for (b, ci, cm, co, h, w), tm in K3_BF16_CASES:
        rng = np.random.RandomState(b + ci)
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
        xb = torch.randn((b, ci, h, w), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(b)
                         ).to(torch.bfloat16)
        wT, wC = t(0.1 * rng.randn(ci, cm, 4, 4)), t(0.1 * rng.randn(co, cm, 4, 4))
        scale, bias = t(1 + 0.1 * rng.randn(cm)), t(0.1 * rng.randn(cm))
        args = (xb, wT, scale, bias, wC)
        geom = (b, ci, cm, co, h, w)
        chosen = F3.choose_impl(ci, cm, co, h, w, torch.bfloat16)
        for impl in ("wgmma", "mma"):
            if not F3.built_for(impl, ci, cm, co):
                continue
            ey, es, share, y, m, v = hold_k3_bf16(F3, args, tm, str(geom),
                                                  impl)
            del y
            if impl == chosen:
                err["fused_nhwc_main_bf16"] = max(err["fused_nhwc_main_bf16"],
                                                  ey)
                err["fused_nhwc_stats_bf16"] = max(
                    err["fused_nhwc_stats_bf16"], es)
        if b != 100:
            del xb
            torch.cuda.empty_cache()
            continue
        # times per launch at bench_fused's shape: the wgmma and the
        # mma.sync kernel on the same bf16 values, in turns (mma, wgmma,
        # wgmma, mma), and the whole call likewise
        x32 = xb.float()
        xn = xb.permute(0, 2, 3, 1).contiguous()
        tc = ("mma", "wgmma")
        ops = {k: F3.operands(wT, wC, k, torch.bfloat16) for k in tc}
        bn = F3._bn_rows(m, v, scale, bias, 1e-5)
        st, st_best = in_turns(
            {k: (lambda k=k: F3.launch_stats(xn, ops[k][0], cm, tm, k))
             for k in tc}, 10)
        mn, mn_best = in_turns(
            {k: (lambda k=k: F3.launch_main(xn, *ops[k], bn, cm, co, tm, k))
             for k in tc}, 10)
        pair, _ = in_turns(
            {k: (lambda k=k: F3.fused_convT_bn_relu_conv(*args, tm=tm,
                                                         impl=k))
             for k in tc}, 5)
        check(mn_best[chosen] <= min(mn_best.values()) * 1.05
              and st_best[chosen] <= min(st_best.values()) * 1.05,
              f"K3 bf16 runs {chosen} at {geom}, which is the slower "
              f"implementation in this run: stats {st}, main {mn}")
        as_bf16 = lambda a: a.to(torch.bfloat16).float()  # noqa: E731
        xl = F3._pad_nhwc(x32).contiguous()
        wtall, wcall = (as_bf16(F3._pack_wT(wT)), as_bf16(F3._pack_wC(wC)))
        gain = scale / torch.sqrt(v + 1e-5)
        wTb, wCb = wT.to(torch.bfloat16), wC.to(torch.bfloat16)
        with N.fp32_convs():
            row = {
                "shape": [b, ci, h, w], "tm": tm, "dtype": "bf16",
                "impl": chosen,
                "stats_ms": st[chosen], "main_ms": mn[chosen],
                "stats_mma_ms": st["mma"], "main_mma_ms": mn["mma"],
                "pair_ms": pair[chosen], "pair_mma_ms": pair["mma"],
                "plain_stats_ms": time_ms(
                    lambda: F3.plain_stats(xl, wtall, tm), 3),
                "plain_main_ms": time_ms(lambda: F3.plain_main(
                    xl, wtall, wcall, m, gain, bias, tm,
                    round_parts=as_bf16), 3),
                "lib_stats_ms": time_ms(lambda: torch.var_mean(
                    F.conv_transpose2d(xb, wTb, stride=2, padding=1).float(),
                    dim=(0, 2, 3), correction=0), 5),
                "lib_main_ms": time_ms(lambda: F.conv2d(F.relu(F.batch_norm(
                    F.conv_transpose2d(xb, wTb, stride=2, padding=1), m, v,
                    scale, bias, training=False)), wCb, stride=2,
                    padding=1), 5),
            }
        hw = b * h * w
        slots = F3.M.Schedule(b, h, w, tm).n_items
        f_stats = 2 * hw * (4 * ci) * (4 * cm) + 3 * 4 * hw * cm
        f_main = f_stats + 2 * hw * (16 * cm) * co
        # each input byte read once, each output byte written once
        b_stats = 2 * (hw * ci + 16 * ci * cm) + 4 * slots * 2 * cm
        b_main = 2 * (hw * ci + hw * co + 16 * ci * cm + 16 * cm * co) \
            + 4 * 12 * cm
        row["stats_bound"] = bound(f_stats, b_stats, PEAK_BF16)
        row["main_bound"] = bound(f_main, b_main, PEAK_BF16)
        for k in ("stats", "main"):
            row[f"{k}_share_of_bound"] = row[f"{k}_bound"][0] / row[f"{k}_ms"]
        row["wgmma_over_mma"] = {"stats": st["mma"] / st["wgmma"],
                                 "main": mn["mma"] / mn["wgmma"]}
        print(f"K3 bf16 times on {smi}: " + _fmt(row), flush=True)
        del x32, xn, xl, xb
        torch.cuda.empty_cache()

    # bench_fused --kernel nhwc as users start it: bf16 by default
    lines = _module(["dcgan_sr_tpu_torch.bench_fused", "--kernel", "nhwc",
                     "--iters", "10"])
    rec = json.loads(lines[-1])
    counts = json.loads(lines[-2][len("kernel launches: "):])
    by_impl = json.loads(lines[-3][len("implementation launches: "):])
    check((rec["batch"], rec["hw"], rec["kernel"], rec["dtype"])
          == (100, 256, "nhwc", "bf16"), f"bench_fused ran {rec}")
    check(0 <= rec["max_abs_diff"] <= TOL_BENCH_BF16,
          f"bench_fused --kernel nhwc: max_abs_diff {rec['max_abs_diff']}")
    names = ("fused_nhwc_stats_bf16", "fused_nhwc_main_bf16")
    check(all(counts[n] > 0 for n in names)
          and counts["fused_nhwc_stats"] == counts["fused_nhwc_main"] == 0
          and by_impl["fused_nhwc"]["wgmma_bf16"] == sum(counts[n]
                                                          for n in names)
          and sum(by_impl["fused_nhwc"].values()) == sum(counts[n]
                                                         for n in names),
          f"bench_fused --kernel nhwc launched {counts}, {by_impl}")
    print(f"bench_fused --kernel nhwc (bf16 default) on {smi}: "
          + json.dumps(rec) + " launches " + json.dumps(counts), flush=True)
    return err, row, counts


# ---------------------------------------------------------------------------
# phase 22: the trainer's K-step chunk as one CUDA graph
# ---------------------------------------------------------------------------

def _busy(fn, steps):
    """(device busy share of the wall time, device ms a step) of one call of
    fn, `steps` train steps, under torch.profiler; (None, None) where the
    profiler reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dcgan_sr_tpu_torch.profile_step import _device_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    us = sum(_device_us(r) for r in prof.key_averages()
             if r.device_type == DeviceType.CUDA)
    if us <= 0:
        return None, None
    return round(us * 1e-6 / wall, 4), round(us * 1e-3 / steps, 4)


def _adam_host_step_size_(params, grads, state, *, lr=2e-4, beta1=0.5,
                          beta2=0.999, eps=1e-8):
    """ops/adam.py's update with the step count a Python int and the step
    size a Python float (one addcdiv pass, nothing computed on the card for
    the step size; a CUDA graph would freeze it): the yardstick of Adam's
    cost on the eager path."""
    import math

    import torch

    state["t"] += 1
    t = state["t"]
    step_size = lr * math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
    m, v = state["m"], state["v"]
    torch._foreach_mul_(m, beta1)
    torch._foreach_add_(m, grads, alpha=1.0 - beta1)
    torch._foreach_mul_(v, beta2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - beta2)
    denom = torch._foreach_sqrt(v)
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(params, m, denom, value=-step_size)


def adam_forms(state, n=50):
    """Adam's update of G and D as one step runs it (D, then G), `n` steps,
    in turns (card, host, host, card): ops/adam.py (the step count a device
    tensor) against `_adam_host_step_size_`, on copies of the state's
    parameters with fixed gradients.  Per step: the host's us to queue it
    and the device's us (CUDA events)."""
    import torch

    from dcgan_sr_tpu_torch.ops.adam import adam_init, adam_update_
    from dcgan_sr_tpu_torch.train.step import params_of

    nets = [[p.detach().clone() for p in params_of(net)]
            for net in (state.d, state.g)]
    grads = [[torch.randn_like(p) * 1e-2 for p in ps] for ps in nets]
    forms = {"card_t": (adam_update_, [adam_init(ps) for ps in nets]),
             "host_t": (_adam_host_step_size_,
                        [{**adam_init(ps), "t": 0} for ps in nets])}
    out = {k: {"host_us": [], "device_us": []} for k in forms}
    for name in ("card_t", "host_t", "host_t", "card_t"):
        fn, opts = forms[name]
        for ps, gs, st in zip(nets, grads, opts):    # warm
            with torch.no_grad():
                fn(ps, gs, st)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(n):
            for ps, gs, st in zip(nets, grads, opts):
                with torch.no_grad():
                    fn(ps, gs, st)
        host = time.perf_counter() - t0
        e1.record()
        torch.cuda.synchronize()
        out[name]["host_us"].append(round(host / n * 1e6, 2))
        out[name]["device_us"].append(round(e0.elapsed_time(e1) / n * 1e3,
                                            2))
    return out


def _replay_and_twins(cfg, chunks, dev):
    """Under cuDNN's deterministic algorithms: a runner warms up on
    chunks[0] and captures its graph; two eager twins start from copies of
    its state; the graph's replay of chunks[1] and the twins' runs of it.
    Returns their per-step losses, (metrics, K) arrays each.  (cuDNN's
    default bf16 backward sums with atomics, and K GAN steps carry that
    noise chaotically: 0.08-0.84 in a loss over 20 steps.)"""
    import torch

    from dcgan_sr_tpu_torch.train.multi_step import build_multi_step
    from dcgan_sr_tpu_torch.train.step import (init_train_state,
                                               state_from_numpy,
                                               state_to_numpy)

    prev = _deterministic()
    try:
        sg = init_train_state(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        mg, me = build_multi_step(cfg), build_multi_step(cfg)
        mg(sg, chunks[0])
        snap = state_to_numpy(sg)
        se, se2 = (state_from_numpy(cfg, snap, device=dev) for _ in range(2))
        return tuple(
            torch.stack([m[k] for k in sorted(m)]).float().cpu().numpy()
            for m in (mg(sg, chunks[1])[1], me.eager(se, chunks[1])[1],
                      me.eager(se2, chunks[1])[1]))
    finally:
        _deterministic(prev)


def graph_step_phase(smi):
    """Phase 22: the eager loop and the CUDA graph of a K = 20 chunk in
    turns for bench.py's three bf16 trainers; one replayed chunk against
    two eager runs of it from a copy of the graph's state; Adam's two
    forms in turns; then the CLI with and without --stage-ahead.  Returns
    {variant: row}."""
    import math

    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.train.multi_step import build_multi_step
    from dcgan_sr_tpu_torch.train.step import (init_train_state,
                                               state_from_numpy,
                                               state_to_numpy)

    dev = torch.device("cuda")
    out = {}
    for variant, shape in BF16_TRAIN:
        t_variant = time.perf_counter()
        cfg = get_config(variant, env_override=False,
                         compute_dtype="bfloat16")
        # two chunks of their own batches: the warm-up (eager, then the
        # capture) and the compared replay; the timed turns reuse them
        hr = _cli_batches(cfg, 2 * K_STEPS, dev)
        chunks = (hr[:K_STEPS], hr[K_STEPS:])
        lg, le1, le2 = _replay_and_twins(cfg, chunks, dev)
        sg = init_train_state(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        mg, me = build_multi_step(cfg), build_multi_step(cfg)
        mg(sg, chunks[0])
        # the timed eager loop starts where the warm-up left the graph
        se = state_from_numpy(cfg, state_to_numpy(sg), device=dev)
        # step 0 is a forward from one state on one batch: the replay must
        # agree with the twins as they agree among themselves (a replay
        # that trained on stale input would not); later steps within twice
        # the twins' largest spread over the chunk
        spread = np.abs(le1 - le2)
        diff = np.abs(lg - le1)
        floor = 1e-6 * (1 + np.abs(le1).max())
        check(bool(np.isfinite(lg).all())
              and (diff[:, 0] <= 2 * spread[:, 0] + floor).all()
              and diff.max() <= 2 * spread.max() + floor,
              f"{variant}: the replayed chunk differs from eager by "
              f"{diff.max():.3e} ({diff[:, 0].max():.3e} at its first "
              f"step), the eager twins by {spread.max():.3e} "
              f"({spread[:, 0].max():.3e})")

        def timed(name, chunk):
            fn, st = (me.eager, se) if name == "eager" else (mg, sg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = fn(st, chunk)
            m["errG"][-1].item()
            return (time.perf_counter() - t0) / K_STEPS * 1e3

        turns = {"eager": [], "graph": []}
        for name, c in (("eager", 0), ("graph", 0), ("graph", 1),
                        ("eager", 1)):
            turns[name].append(timed(name, chunks[c]))
        check(mg.captures == 1 and mg.replays == 2
              and int(sg.g_opt["t"]) == int(sg.d_opt["t"]) == 3 * K_STEPS,
              f"{variant}: {mg.stats()}, t {int(sg.g_opt['t'])}: Adam's "
              f"step count advances by K a replay")
        # the profiler's own host cost grows with the launches it records:
        # the eager loop is profiled over 5 steps, the graph over a replay
        busy = {"eager": _busy(lambda: me.eager(se, hr[:5]), 5),
                "graph": _busy(lambda: mg(sg, chunks[0]), K_STEPS)}
        imgs = cfg.images_consumed_per_step
        r = {"images_a_step": imgs, "K": K_STEPS,
             "max_abs_diff_graph_vs_eager": float(diff.max()),
             "eager_run_to_run_spread": float(spread.max()),
             "diff_first_step": float(diff[:, 0].max()),
             "eager_spread_first_step": float(spread[:, 0].max())}
        for name, ts in turns.items():
            ms = sum(ts) / 2
            share, dms = busy[name]
            r[name] = {"step_ms": round(ms, 4), "turns_ms": [round(v, 4)
                                                               for v in ts],
                       "images_per_s": round(imgs / (ms / 1e3), 2),
                       "device_busy_share": share,
                       "device_ms_per_step": dms}
        r["graph_over_eager"] = round(r["eager"]["step_ms"]
                                      / r["graph"]["step_ms"], 4)
        check(all(math.isfinite(v) for v in (r["eager"]["step_ms"],
                                             r["graph"]["step_ms"])),
              f"{variant} step times")
        r["adam_per_step"] = adam_forms(sg)
        r["phase_s"] = round(time.perf_counter() - t_variant, 1)
        print(f"graph vs eager, bf16 {variant} {shape}, K={K_STEPS}, on "
              f"{smi}: " + json.dumps(r), flush=True)
        out[variant] = r
        del sg, se, mg, me, hr, chunks
        torch.cuda.empty_cache()

    # the trainer as users start it, with and without --stage-ahead
    for staged in (False, True):
        args = ["--config", "gray-3", "--synthetic", "--bf16", "--feed-bf16",
                "--steps", "40", "--scan", str(K_STEPS), "--epochs", "1",
                "--seed", "1"] + (["--stage-ahead"] if staged else [])
        t0 = time.perf_counter()
        lines = _cli(args)
        wall = time.perf_counter() - t0
        steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
        check(len(steps) == 2 and all(steps), f"log lines: {lines}")
        run, graph = k1_run(lines)
        check(run == 40 and graph["captures"] == 1 and graph["replays"] == 1,
              f"cli --scan {K_STEPS}: K1 ran {run} times, graphs {graph}")
        data = [float(re.search(r"DataTime: ([\d.]+)", l).group(1))
                for l in lines if l.startswith("Epoch:")]
        times = [float(re.search(r"Time: ([\d.]+)", l).group(1))
                 for l in lines if l.startswith("Epoch:")]
        r = {"wall_s": round(wall, 3), "chunk_time_s": times,
             "chunk_data_time_s": data,
             "replayed_chunk_images_per_s": round(
                 K_STEPS * 100 / times[1], 2), "k1_run": run}
        print(f"cli gray-3 --bf16 --feed-bf16 --scan {K_STEPS} "
              f"{'--stage-ahead ' if staged else ''}on {smi}: "
              + json.dumps(r), flush=True)
        out[f"cli_stage_ahead_{staged}"] = r
    return out



# ---------------------------------------------------------------------------
# phase 23: Torch7 .t7 checkpoints on the served paths
# ---------------------------------------------------------------------------

def _in_process(main, args, env=None):
    """An entry point's main(args) in this process as a user's `python -m`
    runs it: no config override from the environment but those of `env`
    (a user's `batchSize=5 python -m ...`), its output captured.  Returns
    (its return value, its output lines)."""
    import contextlib

    saved = {k: os.environ.pop(k) for k in CONFIG_ENV if k in os.environ}
    os.environ.update(env or {})
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            ret = main(args)
    except BaseException:
        sys.stderr.write(out.getvalue()[-4000:])
        raise
    finally:
        for k in env or {}:
            os.environ.pop(k, None)
        os.environ.update(saved)
    return ret, out.getvalue().splitlines()


def _deterministic(on=True):
    """cuDNN's deterministic algorithms on or off (its default backward may
    sum with atomics); returns the previous setting."""
    import torch
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    return prev


def _u8(arr):
    import numpy as np
    return np.clip(np.round(np.asarray(arr) * 255.0), 0, 255).astype(np.int16)


def t7_phase(smi):
    """Phase 23: the gray-3 and overlap fixtures exported as Torch7 `.t7`
    files (compat/torch_export.py), then served and upscaled from them
    beside the same weights from `--ckpt`.  Same weights, same program:
    under cuDNN's deterministic algorithms, in this process, the --t7 and
    --ckpt gray-3 services answer twelve requests (ten at LR 256) with
    equal bytes in fp32 and bf16, and `upscale --config
    gray-patch-batch-overlap` on a directory writes equal files.  As users
    start it, `serve --t7 --warmup` (fp32 and --bf16, started together with
    the --ckpt servers) answers the same requests; cuDNN's default convT
    (a backward-data algorithm) may sum with atomics, so a --t7 server is
    held to the --ckpt server as phase 4 holds a server to its reference
    (fp32: 1 level of 255; bf16: 2 levels on all but 5%), and the count of
    differing pixels is printed beside the --ckpt servers' own run-to-run
    count in this process.  K2's launches counted on each path (from 0 at
    each server's first /healthz after its warmup, and before each upscale
    run).  Returns {kernel: launches} over the --t7 runs."""
    import numpy as np
    import torch
    from PIL import Image

    from dcgan_sr_tpu_torch import upscale
    from dcgan_sr_tpu_torch.compat import export_torch_generator
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.image.io import load_image
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.serve import SRService
    from dcgan_sr_tpu_torch.train.checkpoint import load_generator

    launches = dict.fromkeys(K.launches, 0)
    with tempfile.TemporaryDirectory() as d:
        t7 = {}
        for variant, fixture in (("gray-3", FIXTURE),
                                 ("gray-patch-batch-overlap",
                                  OVERLAP_FIXTURE)):
            net, _ = load_generator(get_config(variant, env_override=False),
                                    fixture, device="cpu")
            t7[variant] = export_torch_generator(
                os.path.join(d, f"{variant}_net_G.t7"), net.spec,
                *net.trees())
            print(f"exported {os.path.basename(fixture)} -> "
                  f"{os.path.getsize(t7[variant])} bytes of .t7", flush=True)

        cfg = get_config("gray-3", env_override=False)
        rng = np.random.RandomState(23)
        imgs8 = ([(rng.rand(256, 256) * 255).astype(np.uint8)
                  for _ in range(10)]
                 + [(rng.rand(*hw) * 255).astype(np.uint8)
                    for hw in ((32, 32), (100, 72))])
        bodies = [_png(a) for a in imgs8]
        imgs = [load_image(io.BytesIO(b), nc=1)[0] for b in bodies]

        # in this process: --t7 against --ckpt, deterministic algorithms
        nets = {"t7": load_generator(cfg, t7=t7["gray-3"], device="cuda")[0],
                "ckpt": load_generator(cfg, FIXTURE, device="cuda")[0]}
        ref = {}
        for bf16 in (False, True):
            svcs = {src: SRService(cfg, net, max_batch=8, window_ms=0,
                                   u8_io=True, compute_dtype=(
                                       torch.bfloat16 if bf16 else None))
                    for src, net in nets.items()}
            try:
                prev = _deterministic()
                try:
                    out = {src: [_u8(svc.submit(im)) for im in imgs]
                           for src, svc in svcs.items()}
                finally:
                    _deterministic(prev)
                same = [np.array_equal(a, b)
                        for a, b in zip(out["t7"], out["ckpt"])]
                check(all(same), f"--t7 {'bf16' if bf16 else 'fp32'} in "
                      f"process: {same.count(False)} of {len(same)} outputs "
                      f"differ from --ckpt's under deterministic algorithms")
                # the program's own run-to-run, default algorithms
                again = [[_u8(svcs["ckpt"].submit(im)) for im in imgs[:3]]
                         for _ in range(2)]
                rr = sum(int((a != b).sum()) for a, b in zip(*again))
            finally:
                for svc in svcs.values():
                    svc.close()
            ref[bf16] = (out["ckpt"], rr)
            print(f"--t7 vs --ckpt in process, gray-3 "
                  f"{'bf16' if bf16 else 'fp32'}, deterministic cuDNN: "
                  f"{len(same)} outputs equal byte for byte; --ckpt run to "
                  f"run with cuDNN's default algorithms, 3 LR 256 requests: "
                  f"{rr} pixels differ, on {smi}", flush=True)
        del nets
        torch.cuda.empty_cache()

        # as users start them: --t7 and --ckpt servers, fp32 and --bf16
        runs = [(src, bf16) for bf16 in (False, True) for src in ("t7", "ckpt")]
        got = {}
        with tempfile.TemporaryFile() as log:
            servers = [start_server(
                cfg, False, log, extra=("--warmup",) + (
                    ("--bf16",) if bf16 else ()),
                t7=t7["gray-3"] if src == "t7" else None)
                for src, bf16 in runs]
            try:
                for srv, (src, bf16) in zip(servers, runs):
                    name = f"--{src}{' --bf16' if bf16 else ''}"
                    h0 = wait_up(srv, name)
                    out, lat = [], []
                    for body in bodies:
                        t1 = time.perf_counter()
                        status, resp = _request(srv[1], "POST", "/upscale",
                                                body)
                        lat.append((time.perf_counter() - t1) * 1e3)
                        check(status == 200, f"{name}: POST answered {status}")
                        out.append(np.asarray(Image.open(io.BytesIO(resp)),
                                              np.int16))
                    hz = _healthz(srv[1])
                    counts = {k: v - h0["kernel_launches"][k]
                              for k, v in hz["kernel_launches"].items()}
                    main_k = "bulge_main_bf16" if bf16 else "bulge_main"
                    check(counts[main_k] > 0 and hz["errors"] == 0,
                          f"serve {name} launched {counts}")
                    if src == "t7":
                        for k, v in counts.items():
                            launches[k] += v
                    got[src, bf16] = out
                    print(f"serve gray-3 {name}: LR 256x256 p50 "
                          f"{sorted(lat[:10])[5]:.2f} ms (client ms "
                          f"{[round(v, 2) for v in lat[:10]]}), launches "
                          f"after the warmup {counts}, on {smi}", flush=True)
            except Exception:
                log.seek(0)
                sys.stderr.write(log.read().decode(errors="replace")[-8000:])
                raise
            finally:
                for proc, _ in servers:
                    stop_server(proc)
            log.seek(0)
            text = log.read().decode(errors="replace")
            check(text.count(f"loaded Torch checkpoint {t7['gray-3']}") == 2,
                  "the --t7 servers did not say what they loaded")
        for bf16 in (False, True):
            levels, share = ((TOL_U8_BF16, TOL_U8_BF16_SHARE) if bf16
                             else (TOL_U8, 0.0))
            diffs = [np.abs(a - b) for a, b in zip(got["t7", bf16],
                                                   got["ckpt", bf16])]
            for ds, other in (("--ckpt server", diffs),
                              ("in-process --ckpt", [
                                  np.abs(a - b) for a, b in zip(
                                      got["t7", bf16], ref[bf16][0])])):
                off = [int((x > levels).sum()) for x in other]
                check(all(o <= share * x.size for o, x in zip(off, other)),
                      f"serve --t7 {'bf16' if bf16 else 'fp32'} against the "
                      f"{ds}: {off} pixels beyond {levels} levels")
            print(f"serve --t7 vs --ckpt server, {'bf16' if bf16 else 'fp32'}"
                  f": {sum(int((x == 0).all()) for x in diffs)} of "
                  f"{len(diffs)} responses equal byte for byte, "
                  f"{sum(int((x > 0).sum()) for x in diffs)} pixels differ "
                  f"(max {max(int(x.max()) for x in diffs)} levels), on {smi}",
                  flush=True)

        # bulk overlap SR from a directory, in this process
        src_dir = os.path.join(d, "in")
        os.makedirs(src_dir)
        for i, hw in enumerate(((64, 64),) * 6 + ((70, 90), (48, 100))):
            Image.fromarray((rng.rand(*hw) * 255).astype(np.uint8)).save(
                os.path.join(src_dir, f"{i}.png"))
        files = {}
        for bf16 in (False, True):
            for src in ("t7", "ckpt"):
                weights = (["--t7", t7["gray-patch-batch-overlap"]]
                           if src == "t7" else ["--ckpt", OVERLAP_FIXTURE])
                dst = os.path.join(d, f"out_{src}_{bf16}")
                for k in K.launches:
                    K.launches[k] = 0
                prev = _deterministic()
                t0 = time.perf_counter()
                try:
                    _, lines = _in_process(upscale.main, [
                        "--config", "gray-patch-batch-overlap", "--bn-eval",
                        "--input", src_dir, "--output", dst, *weights]
                        + (["--bf16"] if bf16 else []))
                finally:
                    _deterministic(prev)
                wall = time.perf_counter() - t0
                counts = dict(K.launches)
                main_k = "bulge_main_bf16" if bf16 else "bulge_main"
                check(counts[main_k] > 0, f"upscale --{src} launched {counts}")
                if src == "t7":
                    check(f"loaded Torch checkpoint "
                          f"{t7['gray-patch-batch-overlap']}" in lines,
                          f"upscale --t7 said {lines[:2]}")
                    for k, v in counts.items():
                        launches[k] += v
                files[src, bf16] = {n: open(os.path.join(dst, n), "rb").read()
                                    for n in sorted(os.listdir(dst))}
                print(f"upscale gray-patch-batch-overlap --{src}"
                      f"{' --bf16' if bf16 else ''}, 8 images, deterministic "
                      f"cuDNN: {len(files[src, bf16])} files in {wall:.2f} s, "
                      f"launches {counts}, on {smi}", flush=True)
            check(len(files["t7", bf16]) == 8
                  and files["t7", bf16] == files["ckpt", bf16],
                  f"upscale --t7 {'bf16' if bf16 else 'fp32'} wrote other "
                  f"bytes than --ckpt")
    print(f"t7 paths: K2 launches {launches}, on {smi}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 24: the trainer's opt-in rewrites --fast-ops and --compact-params
# ---------------------------------------------------------------------------

def opt_in_phase(smi):
    """Phase 24: the gray-3 fp32 step at batch 100, standard against
    --fast-ops (first-step losses from one state; stage times in turns);
    the bf16 K = 20 graph chunk, standard against fast, in turns, for
    gray-3 and gray-patch-batch; --compact-params against standard over one
    replayed fp32 chunk (bit for bit); the knob table (profile_table), bf16
    and --fp32; the CLI with both flags, then --resume.  Returns {kernel:
    launches run} of the knob table and the CLI runs."""
    import math

    import numpy as np
    import torch

    from dcgan_sr_tpu_torch import profile_table
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.models import discriminator_spec, generator_spec
    from dcgan_sr_tpu_torch.ops.compact import pack_state, unpack_state
    from dcgan_sr_tpu_torch.train.checkpoint import checkpoint_path
    from dcgan_sr_tpu_torch.train.multi_step import build_multi_step
    from dcgan_sr_tpu_torch.train.step import (build_train_step,
                                               init_train_state, params_of,
                                               state_from_numpy,
                                               state_to_numpy)

    dev = torch.device("cuda")
    cfgs = {name: get_config("gray-3", env_override=False, **over)
            for name, over in (("standard", {}), ("fast", {"fast_ops": True}))}
    snap = state_to_numpy(init_train_state(
        cfgs["standard"], torch.Generator().manual_seed(0), device=dev))
    batches = _batches(cfgs["standard"], 4, dev)

    # the first step's losses from one state, deterministic algorithms
    prev = _deterministic()
    try:
        first = {}
        for name, cfg in cfgs.items():
            st = state_from_numpy(cfg, snap, device=dev)
            _, m = build_train_step(cfg)(st, batches[0])
            first[name] = {k: float(v) for k, v in m.items()}
    finally:
        _deterministic(prev)
    for k, v in first["standard"].items():
        check(math.isfinite(first["fast"][k])
              and abs(first["fast"][k] - v) <= 1e-4 * abs(v) + 1e-7,
              f"fast fp32 first step {k}: {first['fast'][k]} vs {v}")
    print(f"fp32 gray-3 first step, standard vs --fast-ops, deterministic "
          f"cuDNN, on {smi}: " + json.dumps(first), flush=True)

    # the fp32 step's stages in turns (standard, fast, fast, standard)
    states = {name: state_from_numpy(cfg, snap, device=dev)
              for name, cfg in cfgs.items()}
    turns = {"standard": [], "fast": []}
    for name in ("standard", "fast", "fast", "standard"):
        turns[name].append(step_breakdown(
            cfgs[name], states[name], smi, batches=batches,
            benchmarks=(False,))[False])
    fp32 = {}
    for name, rs in turns.items():
        mean = lambda f: round(sum(f(r) for r in rs) / len(rs), 4)  # noqa: E731
        fp32[name] = {
            "step_ms": mean(lambda r: r["step_ms"]),
            "turns_step_ms": [r["step_ms"] for r in rs],
            "g_forward_ms": mean(lambda r: r["g_forward"]),
            "g_backward_ms": mean(lambda r: r["g_backward"]),
            "d_ms": mean(lambda r: r["d_real_forward_backward"]
                         + r["d_fake_forward"] + r["d_fake_pullbacks"]),
            "adam_ms": mean(lambda r: r["adam_updates"]),
            "peak_memory_GB": max(r["peak_memory_GB"] for r in rs)}
    fp32["fast_over_standard"] = round(fp32["fast"]["step_ms"]
                                       / fp32["standard"]["step_ms"], 4)
    print(f"fp32 gray-3 step, batch 100, standard vs --fast-ops in turns, on "
          f"{smi}: " + json.dumps(fp32), flush=True)
    del states, turns
    torch.cuda.empty_cache()

    # the bf16 K = 20 graph chunk, standard against fast, in turns
    bf16 = {}
    for variant, shape in (BF16_TRAIN[0], BF16_TRAIN[2]):
        runs = {}
        for name, over in (("standard", {}), ("fast", {"fast_ops": True})):
            cfg = get_config(variant, env_override=False,
                             compute_dtype="bfloat16", **over)
            hr = _cli_batches(cfg, K_STEPS, dev)
            st = init_train_state(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
            run = build_multi_step(cfg)
            _, m = run(st, hr)           # the warm-up chunk, then the capture
            runs[name] = (run, st, hr)
        times = {"standard": [], "fast": []}
        for name in ("standard", "fast", "fast", "standard"):
            run, st, hr = runs[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = run(st, hr)
            check(bool(torch.isfinite(m["errG"]).all()),
                  f"{variant} bf16 {name}: losses not finite")
            times[name].append((time.perf_counter() - t0) / K_STEPS * 1e3)
        check(all(r.replays == 2 and r.captures == 1
                  for r, _, _ in runs.values()), "bf16 chunks not replayed")
        imgs = get_config(variant, env_override=False).images_consumed_per_step
        r = {name: {"step_ms": round(sum(ts) / 2, 4),
                    "turns_ms": [round(t, 4) for t in ts],
                    "images_per_s": round(imgs / (sum(ts) / 2e3), 2)}
             for name, ts in times.items()}
        r["fast_over_standard"] = round(r["fast"]["step_ms"]
                                        / r["standard"]["step_ms"], 4)
        print(f"bf16 {variant} {shape}, K={K_STEPS} graph replays, standard "
              f"vs --fast-ops in turns, on {smi}: " + json.dumps(r),
              flush=True)
        bf16[variant] = r
        del runs
        torch.cuda.empty_cache()

    # --compact-params against standard over one replayed fp32 chunk
    cfg = cfgs["standard"]
    ccfg = get_config("gray-3", env_override=False, compact_params=True)
    g_spec, d_spec = generator_spec(cfg), discriminator_spec(cfg)
    chunks = (torch.stack(batches[:2]), torch.stack(batches[2:]))
    prev = _deterministic()
    try:
        out = {}
        for name, c in (("standard", cfg), ("compact", ccfg)):
            st = state_from_numpy(cfg, snap, device=dev)
            if name == "compact":
                st = pack_state(st, g_spec, d_spec)
            ptrs = [p.data_ptr() for p in params_of(st.g) + params_of(st.d)]
            run = build_multi_step(c)
            run(st, chunks[0])
            _, m = run(st, chunks[1])
            check(run.replays == 1 and [p.data_ptr() for p in params_of(st.g)
                                        + params_of(st.d)] == ptrs,
                  f"{name}: no replay, or a master moved")
            if name == "compact":
                check(all(p.dim() == 2 for p in params_of(st.g)
                          if p.numel() > p.shape[0]), "masters not 2-D")
                st = unpack_state(st, g_spec, d_spec)
            out[name] = (torch.stack([m[k] for k in sorted(m)]).cpu().numpy(),
                         state_to_numpy(st))
    finally:
        _deterministic(prev)

    def leaves(t):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k])
        elif isinstance(t, list):
            for v in t:
                yield from leaves(v)
        elif t is not None:
            yield np.asarray(t)

    la, lb = (list(leaves(out[n][1])) for n in ("standard", "compact"))
    n_diff = sum(not np.array_equal(a, b) for a, b in zip(la, lb))
    check(np.array_equal(out["standard"][0], out["compact"][0])
          and len(la) == len(lb) and n_diff == 0,
          f"compact replayed chunk differs from standard: {n_diff} of "
          f"{len(la)} leaves")
    print(f"fp32 gray-3 --compact-params vs standard, one replayed 2-step "
          f"chunk, deterministic cuDNN: losses and all {len(la)} state "
          f"leaves equal bit for bit, on {smi}", flush=True)
    del out
    torch.cuda.empty_cache()

    # the knob table as users start it (python -m
    # dcgan_sr_tpu_torch.profile_table, tools/profile_step.py's counterpart),
    # bf16 then --fp32, printed beside the standard and fast times above
    counts = dict.fromkeys(K.launches, 0)
    counts["preprocess"] = 0
    rows = ("baseline", "compact_params", "fast_ops", "pallas_preprocess",
            "compact+pallas")
    for in_fp32 in (False, True):
        ran = {}
        for k in K.impl_launches:
            K.impl_launches[k] = 0
        res, lines, secs, _ = _tool(
            functools.partial(profile_table.main, launches=ran),
            ["--steps", "5", "--reps", "2"] + ["--fp32"] * in_fp32)
        dtype = "float32" if in_fp32 else "bfloat16"
        fwd = {"bulge_stats": 15, "bulge_main": 15} if in_fp32 else {
            "bulge_stats_bf16": 15, "bulge_main_bf16": 15}
        impl = dict(K.impl_launches)
        check(res["dtype"] == dtype and res["batch"] == 100
              and list(res["ms_per_step"]) == list(rows) + ["g_forward_only"]
              and all(v > 0 for v in res["ms_per_step"].values())
              and len(lines) == 9 and lines[-1] == json.dumps(res)
              and lines[7] == profile_table.PALLAS_NOTE,
              f"profile_table {dtype}: {lines}")
        # K1 in the warm-up chunk and the two replays of 5 steps; the
        # trainer's G runs layers 3-4 unfused; G's forward alone runs the
        # fused pair, 5 calls a repetition, a warm one and two timed
        check(all(ran[r]["preprocess"] == 3 * 5
                  and not any(ran[r][k] for k in K.launches) for r in rows)
              and {k: n for k, n in ran["g_forward_only"].items() if n} == fwd
              and impl == {**dict.fromkeys(impl, 0),
                           ("wgmma" if in_fp32 else "wgmma_bf16"): 30},
              f"profile_table {dtype}: launches {ran}, by implementation "
              f"{impl}")
        counts["preprocess"] += sum(ran[r]["preprocess"] for r in rows)
        for k, n in fwd.items():
            counts[k] += n
        side = ({"standard": fp32["standard"]["step_ms"],
                 "fast": fp32["fast"]["step_ms"]} if in_fp32 else
                {"standard": bf16["gray-3"]["standard"]["step_ms"],
                 "fast": bf16["gray-3"]["fast"]["step_ms"]})
        print(f"profile_table {'--fp32' if in_fp32 else '(bf16)'} --steps 5 "
              f"--reps 2, {secs} s, ms a step: " + json.dumps(
                  res["ms_per_step"]) + "; beside phase 24's in-turns gray-3 "
              + ("fp32 step (eager)" if in_fp32 else "bf16 K = 20 graph replay")
              + " ms: " + json.dumps(side) + f"; K2 {fwd} by {impl}, on "
              f"{smi}", flush=True)

    # the trainer as users start it, with both flags, then --resume
    with tempfile.TemporaryDirectory() as ck:
        flags = ["--config", "gray-3", "--synthetic", "--seed", "1",
                 "--fast-ops", "--compact-params", "--checkpoint-dir", ck,
                 "--steps", "6", "--scan", "3"]
        for resume in (False, True):
            t0 = time.perf_counter()
            lines = _cli(flags + (["--epochs", "2", "--resume"] if resume
                                  else ["--epochs", "1"]))
            wall = time.perf_counter() - t0
            check("fast_ops=True" in lines[0]
                  and "compact_params=True" in lines[0], lines[0])
            if resume:
                check("resumed from epoch 1" in lines, "did not resume")
            steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
            check(len(steps) == 2 and all(steps), f"log lines: {lines}")
            vals = [float(m.group(i)) for m in steps for i in (4, 5)]
            check(all(math.isfinite(v) for v in vals), f"losses {vals}")
            run, graph = k1_run(lines)
            check(run == 6 and graph["captures"] == 1
                  and graph["replays"] == 1,
                  f"cli --fast-ops --compact-params: K1 ran {run}, {graph}")
            counts["preprocess"] += run
            ep = 2 if resume else 1
            with np.load(checkpoint_path(ck, cfg.name, ep, "G")) as data:
                check(data["_params_/_1_/_w_"].ndim == 2
                      and int(data["_opt_/_t_"]) == 6 * ep,
                      "checkpoint not in the compact layout, or t wrong")
            print(f"cli gray-3 --fast-ops --compact-params"
                  f"{' --resume' if resume else ''}, 6 steps --scan 3: "
                  f"{wall:.2f} s, K1 ran {run}, graphs {graph}, Err_G/Err_D "
                  f"{vals}, on {smi}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 25: data parallel on the card
# ---------------------------------------------------------------------------

# the DP step against the single-device step (tests/test_torch_dp.py): the
# metrics, and each network's gradient norm (Adam's first moment over the
# step's leaves; a DP gradient off by any factor fails); leaf by leaf where
# only the DP decomposition differs: in a world of one (the same kernels in
# the same order under deterministic cuDNN, only the collectives added) and
# in float64 (fp32 sums in another order through G's train-mode BNs move a
# gradient element by up to 1e-3 of its leaf's scale; tests/test_torch_dp.py)
DP_METRIC_TOL = dict(rtol=1e-3, atol=1e-4)
DP_M_TOL = dict(rtol=1e-4, atol=1e-6)
DP_NORM_TOL = 1e-3


def _moments(state):
    """Adam's first moments, {"g" | "d": [numpy leaf, ...]}."""
    return {n: [m.cpu().numpy() for m in opt["m"]]
            for n, opt in (("g", state.g_opt), ("d", state.d_opt))}


def _metric_err(ma, mb):
    """The largest |a - b| of two metric dicts, and whether every metric
    is within DP_METRIC_TOL."""
    import numpy as np
    a = np.array([float(ma[k]) for k in sorted(ma)])
    b = np.array([float(mb[k]) for k in sorted(mb)])
    ok = bool(np.all(np.abs(a - b) <= DP_METRIC_TOL["atol"]
                     + DP_METRIC_TOL["rtol"] * np.abs(b)))
    return float(np.abs(a - b).max()), ok


def _grad_check(m_dp, m_one, leafwise):
    """Adam's first moments of the DP step against the single step's: each
    network's norm to DP_NORM_TOL and, `leafwise`, every element at
    DP_M_TOL.  Returns (largest |diff| relative to its leaf's largest
    |m|, {net: norm ratio}, ok)."""
    import numpy as np
    worst, ratios, ok = 0.0, {}, True
    for net in ("g", "d"):
        num = den = 0.0
        for a, b in zip(m_dp[net], m_one[net]):
            a, b = a.astype(np.float64), b.astype(np.float64)
            d = np.abs(a - b)
            worst = max(worst, float(d.max() / np.abs(b).max()))
            if leafwise:
                ok &= bool(np.all(d <= DP_M_TOL["atol"]
                                  + DP_M_TOL["rtol"] * np.abs(b)))
            num += float(np.sum(a ** 2))
            den += float(np.sum(b ** 2))
        ratios[net] = float(np.sqrt(num / den))
        ok &= abs(ratios[net] - 1) < DP_NORM_TOL
    return worst, ratios, ok


def _double(state):
    """The state in float64, in place (Adam's step count stays int32)."""
    state.g.double(), state.d.double()
    for opt in (state.g_opt, state.d_opt):
        opt["m"] = [m.double() for m in opt["m"]]
        opt["v"] = [v.double() for v in opt["v"]]
    return state


def _nccl_ms(fn, steps):
    """(device ms a step of NCCL's kernels, of all kernels) over one call
    of fn (`steps` steps) under torch.profiler; (None, None) where it
    reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dcgan_sr_tpu_torch.profile_step import _device_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA]
    total = sum(_device_us(r) for r in rows)
    if total <= 0:
        return None, None
    nccl = sum(_device_us(r) for r in rows if "nccl" in r.key.lower())
    return round(nccl * 1e-3 / steps, 4), round(total * 1e-3 / steps, 4)


def gloo_rank(rank, world, store, out):
    """Phase 25 (d), one rank: over gloo with CUDA tensors on the one card,
    the gray-3 DP step on this rank's half of batch 100 against the
    single-device step on all of it, from one state, under cuDNN's
    deterministic algorithms; writes out/rank<r>.json and raises if they
    disagree."""
    import torch

    sys.path.insert(0, REPO)
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.ops import preprocess as P
    from dcgan_sr_tpu_torch.parallel import (build_dp_train_step, create_mesh,
                                             initialize_distributed,
                                             shard_batch)
    from dcgan_sr_tpu_torch.train.step import (build_train_step,
                                               init_train_state,
                                               state_from_numpy,
                                               state_to_numpy)

    dev = torch.device("cuda")
    initialize_distributed(f"file://{store}", world, rank, backend="gloo")
    try:
        mesh = create_mesh(device=dev)
        cfg = get_config("gray-3", env_override=False)
        batch = _batches(cfg, 1, dev)[0]
        snap = state_to_numpy(init_train_state(
            cfg, torch.Generator().manual_seed(0), device=dev))
        sd, ss = (state_from_numpy(cfg, snap, device=dev) for _ in range(2))
        # cuDNN's default backward sums with atomics: the single-device
        # reference alone moves G's gradient norm by ~1e-3 run to run
        prev = _deterministic()
        try:
            P.launches["preprocess"] = 0
            sd, md = build_dp_train_step(cfg, mesh)(sd,
                                                    shard_batch(batch, mesh))
            torch.cuda.synchronize()
            k1 = P.launches["preprocess"]
            ss, ms = build_train_step(cfg)(ss, batch)
            merr, mok = _metric_err(md, ms)
            gerr, ratios, gok = _grad_check(_moments(sd), _moments(ss),
                                            False)
            # float64 (the plain preprocess: K1 is fp32), leaf by leaf
            kw = dict(preprocess_fn=P.preprocess_plain)
            sd, ss = (_double(state_from_numpy(cfg, snap, device=dev))
                      for _ in range(2))
            sd, _ = build_dp_train_step(cfg, mesh, **kw)(
                sd, shard_batch(batch.double(), mesh))
            ss, _ = build_train_step(cfg, **kw)(ss, batch.double())
            err64, ratios64, ok64 = _grad_check(_moments(sd), _moments(ss),
                                                True)
        finally:
            _deterministic(prev)
        r = {"rank": rank, "backend": mesh.backend, "local_batch": 50,
             "k1_launches": k1, "metrics_max_abs_diff": merr,
             "fp32_m_max_diff_of_leaf_scale": gerr,
             "fp32_grad_norm_ratio": ratios,
             "f64_m_max_diff_of_leaf_scale": err64,
             "f64_grad_norm_ratio": ratios64}
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(r, f)
        check(mok and gok and ok64 and k1 == 1, f"gloo rank {rank}: {r}")
    finally:
        torch.distributed.destroy_process_group()


def gloo_pair(smi, env):
    """Phase 25 (d): two gloo_rank processes on the one card, started
    together (env: their environment).  Returns K1's launches on both."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke as c; "
             f"c.gloo_rank({r}, 2, {store!r}, {tmp!r})"], cwd=REPO, env=env,
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
        try:
            for proc in procs:
                proc.wait(timeout=600)
        finally:
            for proc in procs:
                proc.kill()
            for r, (proc, log) in enumerate(zip(procs, logs)):
                log.seek(0)
                text = log.read()
                log.close()
                if proc.returncode:
                    sys.stderr.write(text[-4000:])
                check(proc.returncode == 0, f"gloo rank {r} exited "
                      f"{proc.returncode}")
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                 for r in range(2)]
    print(f"DP step over gloo, two ranks on the one card (CUDA tensors), "
          f"gray-3 batch 100 (50 a rank) against one device, on {smi}: "
          + json.dumps(ranks), flush=True)
    return sum(r["k1_launches"] for r in ranks)


def dp_phase(smi, graph22=None):
    """Phase 25: data parallel on the card.  (a) in this process, a NCCL
    world of one: the DP step against the single-device step from one
    copied state, gray-3 batch 100, fp32 (TF32 off) and bf16 (losses and
    Adam's first moment under deterministic cuDNN, then ms a step in turns
    and NCCL's device ms a step); (b) the bf16 K = 20 chunk of both as CUDA
    graphs (the DP one with its NCCL collectives captured), in turns, then
    `python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    dcgan_sr_tpu_torch.cli --dp --bf16 --scan 20`; (c) `upscale --dp` as a
    launcher's rank of a world of one, gray-3 and gray-patch-batch-overlap,
    fp32 and bf16, byte-equal to the run without --dp under deterministic
    cuDNN, and under the launcher itself (phase 4's level); (d) two ranks on
    the one card over gloo with CUDA tensors (fp32, and float64 for Adam's
    first moment leaf by leaf).  `graph22`: phase 22's rows,
    printed beside (b)'s.  Returns {kernel: launches} of its paths."""
    import numpy as np
    import torch
    from PIL import Image

    from dcgan_sr_tpu_torch import upscale
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import preprocess as P
    from dcgan_sr_tpu_torch.parallel import (build_dp_multi_step,
                                             build_dp_train_step, create_mesh,
                                             initialize_distributed)
    from dcgan_sr_tpu_torch.train.multi_step import (build_multi_step,
                                                     launches_run)
    from dcgan_sr_tpu_torch.train.step import (build_train_step,
                                               init_train_state,
                                               state_from_numpy,
                                               state_to_numpy)

    dev = torch.device("cuda")
    launches = {"preprocess": 0, **dict.fromkeys(K.launches, 0)}

    def zero():
        for counts in (K.launches, P.launches):
            for k in counts:
                counts[k] = 0

    def add(counts):
        for k, v in counts.items():
            if k in launches:
                launches[k] += v

    initialize_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                           backend="nccl")
    try:
        mesh = create_mesh()
        check(mesh.backend == "nccl" and mesh.size == 1
              and mesh.device == torch.device("cuda", 0), f"mesh {mesh}")
        # (a) the step, a world of one against one device
        for dtype in ("float32", "bfloat16"):
            cfg = get_config("gray-3", env_override=False,
                             compute_dtype=dtype)
            batches = _batches(cfg, 2, dev)
            snap = state_to_numpy(init_train_state(
                cfg, torch.Generator().manual_seed(0), device=dev))
            sd, ss = (state_from_numpy(cfg, snap, device=dev)
                      for _ in range(2))
            dstep, step = build_dp_train_step(cfg, mesh), build_train_step(cfg)
            prev = _deterministic()
            try:
                zero()
                sd, md = dstep(sd, batches[0])
                torch.cuda.synchronize()
                add(P.launches)
                ss, ms = step(ss, batches[0])
                merr, mok = _metric_err(md, ms)
                gerr, ratios, gok = _grad_check(_moments(sd), _moments(ss),
                                                True)
            finally:
                _deterministic(prev)
            check(mok and gok, f"{dtype}: the DP step of a world of one "
                  f"differs from the single-device step: metrics "
                  f"{merr:.3e}, m {gerr:.3e}")
            turns = {"dp": [], "single": []}
            zero()
            for name in ("dp", "single", "single", "dp"):
                fn, st = (dstep, sd) if name == "dp" else (step, ss)
                turns[name].append(_step_ms(fn, st, batches[1], iters=5))
            add(P.launches)
            nccl, total = _nccl_ms(
                lambda: [dstep(sd, batches[1]) for _ in range(3)], 3)
            r = {"metrics_max_abs_diff": merr,
                 "m_max_diff_of_leaf_scale": gerr,
                 "grad_norm_ratio": ratios, "turns_ms": turns,
                 "dp_step_ms": round(sum(turns["dp"]) / 2, 4),
                 "single_step_ms": round(sum(turns["single"]) / 2, 4),
                 "nccl_device_ms_per_step": nccl,
                 "device_ms_per_step": total,
                 "nccl_share": None if not total else round(nccl / total, 4)}
            print(f"DP step, world of one (NCCL), gray-3 batch 100 {dtype}, "
                  f"on {smi}: " + json.dumps(r), flush=True)
            del sd, ss, dstep, step, batches
            torch.cuda.empty_cache()

        # (b) the bf16 K-step chunk: both as CUDA graphs, in turns
        cfg = get_config("gray-3", env_override=False,
                         compute_dtype="bfloat16")
        hr = _cli_batches(cfg, K_STEPS, dev)
        snap = state_to_numpy(init_train_state(
            cfg, torch.Generator().manual_seed(0), device=dev))
        sd, ss = (state_from_numpy(cfg, snap, device=dev) for _ in range(2))
        mdp, mone = build_dp_multi_step(cfg, mesh), build_multi_step(cfg)
        zero()
        mdp(sd, hr)                       # warm-up chunk, then the capture
        queued = P.launches["preprocess"]
        mone(ss, hr)

        def timed(runner, st):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = runner(st, hr)
            m["errG"][-1].item()
            return (time.perf_counter() - t0) / K_STEPS * 1e3

        turns = {"dp": [], "single": []}
        for name in ("single", "dp", "dp", "single"):
            turns[name].append(timed(mdp, sd) if name == "dp"
                               else timed(mone, ss))
        check(mdp.captures == 1 and mdp.replays == 2
              and int(sd.g_opt["t"]) == 3 * K_STEPS,
              f"DP chunk: {mdp.stats()}, t {int(sd.g_opt['t'])}")
        nccl, total = _nccl_ms(lambda: mdp(sd, hr), K_STEPS)
        # the DP runner's launches that ran: its warm-up's and its replays'
        ran = launches_run({"preprocess": queued}, mdp)["preprocess"]
        check(ran == 4 * K_STEPS, f"K1 ran {ran} times in the DP chunks")
        launches["preprocess"] += ran
        r = {"K": K_STEPS, "dp_graph": mdp.stats(), "k1_run": ran,
             "turns_ms": {k: [round(v, 4) for v in ts]
                          for k, ts in turns.items()},
             "dp_step_ms": round(sum(turns["dp"]) / 2, 4),
             "single_step_ms": round(sum(turns["single"]) / 2, 4),
             "dp_images_per_s": round(100 / (sum(turns["dp"]) / 2e3), 2),
             "single_images_per_s": round(100 / (sum(turns["single"]) / 2e3),
                                          2),
             "phase22_graph_step_ms": (graph22["gray-3"]["graph"]["step_ms"]
                                       if graph22 else None),
             "nccl_device_ms_per_step_in_replay": nccl,
             "device_ms_per_step_in_replay": total}
        print(f"DP K={K_STEPS} chunk as a CUDA graph, bf16 gray-3, world of "
              f"one (NCCL), on {smi}: " + json.dumps(r), flush=True)
        del sd, ss, mdp, mone, hr
        torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()

    # (b) the trainer under the launcher
    env = {k: v for k, v in os.environ.items() if k not in CONFIG_ENV
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT")}
    args = ["--config", "gray-3", "--synthetic", "--bf16", "--feed-bf16",
            "--steps", "40", "--scan", str(K_STEPS), "--epochs", "1",
            "--seed", "1"]
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "dcgan_sr_tpu_torch.cli", "--dp",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    if p.returncode:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
    check(p.returncode == 0, f"torchrun cli --dp exited {p.returncode}")
    lines = p.stdout.splitlines()
    steps = [LOG_LINE.match(l) for l in lines if l.startswith("Epoch:")]
    check("data-parallel over 1 ranks" in lines and len(steps) == 2
          and all(steps), f"torchrun cli --dp: {lines}")
    run, graph = k1_run(lines)
    check(run == 40 and graph["captures"] == 1 and graph["replays"] == 1,
          f"torchrun cli --dp --scan {K_STEPS}: K1 ran {run} times, graphs "
          f"{graph}")
    launches["preprocess"] += run
    times = [float(re.search(r"Time: ([\d.]+)", l).group(1))
             for l in lines if l.startswith("Epoch:")]
    r = {"wall_s": round(wall, 3), "chunk_time_s": times,
         "replayed_chunk_images_per_s": round(K_STEPS * 100 / times[1], 2),
         "graph": graph, "k1_run": run,
         "phase22_cli_replayed_chunk_images_per_s": (
             graph22["cli_stage_ahead_False"]["replayed_chunk_images_per_s"]
             if graph22 else None)}
    print(f"torchrun --nproc_per_node 1 cli --dp gray-3 --bf16 --feed-bf16 "
          f"--scan {K_STEPS} on {smi}: " + json.dumps(r), flush=True)

    # (c) upscale --dp, in this process as a launcher's rank (deterministic
    # cuDNN), then under the launcher itself
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "in")
        os.makedirs(src)
        rng = np.random.RandomState(25)
        for i in range(7):            # 7 images: padded to the ranks
            Image.fromarray((rng.rand(48 + 4 * i, 56) * 255).astype(
                np.uint8)).save(os.path.join(src, f"im{i}.png"))
        rank_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                    "MASTER_ADDR": "127.0.0.1"}
        for config, fixture in (("gray-3", FIXTURE),
                                ("gray-patch-batch-overlap",
                                 OVERLAP_FIXTURE)):
            for bf16 in (False, True):
                base = ["--config", config, "--ckpt", fixture, "--input",
                        src] + (["--bf16"] if bf16 else [])
                tag = f"{config}{'-bf16' if bf16 else ''}"
                outs = {k: os.path.join(tmp, f"{tag}-{k}")
                        for k in ("plain", "dp", "launcher")}
                prev = _deterministic()
                try:
                    _in_process(upscale.main, base + ["--output",
                                                      outs["plain"]])
                    os.environ.update(rank_env,
                                      MASTER_PORT=str(_free_port()))
                    try:
                        zero()
                        _, dp_lines = _in_process(upscale.main, base + [
                            "--output", outs["dp"], "--dp"])
                        counts = dict(K.launches)
                    finally:
                        for k in (*rank_env, "MASTER_PORT"):
                            os.environ.pop(k)
                finally:
                    _deterministic(prev)
                add(counts)
                kern = "bulge_main_bf16" if bf16 else "bulge_main"
                names = sorted(os.listdir(outs["plain"]))
                same = [open(os.path.join(outs["plain"], n), "rb").read()
                        == open(os.path.join(outs["dp"], n), "rb").read()
                        for n in names]
                check(len(names) == 7 and all(same) and counts[kern] > 0
                      and any("sharded over 1 ranks" in l for l in dp_lines),
                      f"upscale --dp {tag}: files equal {same}, K2 {counts}")
                r = {"files": len(names), "byte_equal": all(same),
                     "k2_launches": {k: v for k, v in counts.items() if v}}
                if not bf16:
                    p = subprocess.run(
                        [sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc_per_node", "1", "-m",
                         "dcgan_sr_tpu_torch.upscale", "--dp", *base,
                         "--output", outs["launcher"]], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=300)
                    if p.returncode:
                        sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
                    check(p.returncode == 0, f"torchrun upscale --dp {tag}")
                    # cuDNN's default algorithms there: phase 4's level,
                    # and the tiled one's seam flips
                    share = TILED_FLIP_SHARE if config != "gray-3" else 0.0
                    levels, moved, beyond, pixels = 0, 0, 0, 0
                    for n in names:
                        a, b = (np.asarray(Image.open(os.path.join(
                            outs[k], n))).astype(np.int16)
                            for k in ("plain", "launcher"))
                        d = np.abs(a - b)
                        levels = max(levels, int(d.max()))
                        moved += int((d > 0).sum())
                        beyond += int((d > TOL_U8).sum())
                        pixels += d.size
                    check(beyond <= share * pixels, f"torchrun upscale --dp "
                          f"{tag}: {beyond} pixels beyond {TOL_U8} level")
                    r.update(launcher_max_levels=levels,
                             launcher_pixels_differing=moved,
                             launcher_pixels_beyond_1_level=beyond)
                print(f"upscale --dp {tag}, 7 images, on {smi}: "
                      + json.dumps(r), flush=True)

    # (d) two ranks on the one card over gloo, CUDA tensors
    launches["preprocess"] += gloo_pair(smi, env)
    return launches


# ---------------------------------------------------------------------------
# phase 26: the user tools
# ---------------------------------------------------------------------------

# PARITY.md's overlap rows (tools/overlap_protocol.py on the committed
# fixture over the held-out sets 10000:10005): (PSNR, SSIM) of the bilinear
# control and, by BN mode (bn_eval), of each stitch
PARITY_OVERLAP = {"bilinear": (28.461, 0.97440),
                  (False, "naive"): (24.161, 0.97114),
                  (False, "seam"): (24.364, 0.97574),
                  (True, "naive"): (29.558, 0.97521),
                  (True, "seam"): (29.986, 0.97852)}
TOL_PARITY = (0.02, 3e-4)          # PARITY.md prints 3 / 5 decimals
TOOL_KERNELS = ("bulge_stats", "bulge_main", "preprocess")
VALIDATE_STEPS = 20        # each dtype's steps in phase 26's validate_bf16


def _tool(main, args):
    """A tool's main(args) in this process as `python -m` runs it, with
    every kernel's count set to 0 just before: (its return value, its output
    lines, seconds, {kernel: launches counted by the wrappers})."""
    import torch

    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import preprocess as P

    _zero_counts()
    t0 = time.perf_counter()
    ret, lines = _in_process(main, args)
    torch.cuda.synchronize()
    return (ret, lines, round(time.perf_counter() - t0, 2),
            {**K.launches, **P.launches})


def write_photo(path, hw=(384, 512), seed=26):
    """A photo-like RGB PNG from a seed: a smooth random field, oriented
    gratings under soft masks (texture), and sharp-edged rectangles."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = hw
    img = np.asarray(Image.fromarray(
        (rng.rand(h // 32, w // 32, 3) * 255).astype(np.uint8)).resize(
        (w, h), Image.BICUBIC), np.float32) / 255.0 * 0.6 + 0.2
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(8):
        cy, cx, r = rng.rand() * h, rng.rand() * w, 30 + rng.rand() * 90
        f, a = 0.15 + rng.rand() * 0.9, rng.rand() * np.pi
        mask = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        grating = np.sin(f * (xx * np.cos(a) + yy * np.sin(a)))
        img += (0.15 * mask * grating)[..., None] * rng.rand(3)
    for _ in range(10):
        y0, x0 = rng.randint(0, h - 20), rng.randint(0, w - 20)
        y1, x1 = y0 + rng.randint(10, 120), x0 + rng.randint(10, 160)
        img[y0:y1, x0:x1] = img[y0:y1, x0:x1] * 0.5 + rng.rand(3) * 0.5
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
    return path


def _torch_sequential(spec, params):
    """The spec as torch.nn modules in tools/torch_baseline.py's order (one
    module an upsample or flatten; a conv, then its BatchNorm2d, then its
    activation), carrying `params`; on the CPU, train mode."""
    import numpy as np
    import torch
    import torch.nn as nn

    acts = {"relu": nn.ReLU, "lrelu": lambda: nn.LeakyReLU(0.2),
            "sigmoid": nn.Sigmoid, "tanh": nn.Tanh}
    mods = []
    for layer, p in zip(spec, params):
        kind = layer["kind"]
        if kind in ("upsample", "flatten"):
            mods.append(nn.UpsamplingNearest2d(scale_factor=layer["factor"])
                        if kind == "upsample" else nn.Flatten(0))
            continue
        conv = (nn.Conv2d if kind == "conv" else nn.ConvTranspose2d)(
            layer["cin"], layer["cout"], layer["k"], layer["s"], layer["p"],
            bias=False)
        conv.weight.data = torch.as_tensor(np.asarray(p["w"])).float()
        mods.append(conv)
        if layer.get("bn"):
            bn = nn.BatchNorm2d(layer["cout"])
            bn.weight.data = torch.as_tensor(np.asarray(p["bn_scale"])).float()
            bn.bias.data = torch.as_tensor(np.asarray(p["bn_bias"])).float()
            mods.append(bn)
        if layer.get("act"):
            mods.append(acts[layer["act"]]())
    return nn.Sequential(*mods).train()


def write_torch_baseline(directory, cfg, g_params, epochs, ntrain, seed):
    """A --torch-dir in tools/torch_baseline.py's format from the port's own
    weights (G: `g_params`; D: a random init): torch_weights.npz holds each
    Conv2d/ConvTranspose2d weight and BatchNorm2d affine by module index,
    and result.json the scores of the torch.nn G itself, evaluated on the
    card with TF32 off over the protocol's slices (batch 20).  Returns that
    result."""
    import numpy as np
    import torch
    import torch.nn as nn

    from dcgan_sr_tpu_torch.data import TexturedImages
    from dcgan_sr_tpu_torch.evaluation import evaluate_slice
    from dcgan_sr_tpu_torch.models import (discriminator_spec, generator_spec,
                                           init_network)

    os.makedirs(directory, exist_ok=True)
    d_params, _ = init_network(discriminator_spec(cfg),
                               torch.Generator().manual_seed(seed))
    seqs = {"g": _torch_sequential(generator_spec(cfg), g_params),
            "d": _torch_sequential(discriminator_spec(cfg), d_params)}
    tensors = {}
    for tag, net in seqs.items():
        for i, m in enumerate(net):
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                tensors[f"{tag}_{i}_w"] = m.weight.detach().numpy()
            elif isinstance(m, nn.BatchNorm2d):
                tensors[f"{tag}_{i}_bn_w"] = m.weight.detach().numpy()
                tensors[f"{tag}_{i}_bn_b"] = m.bias.detach().numpy()
    np.savez(os.path.join(directory, "torch_weights.npz"), **tensors)

    g = seqs["g"].cuda()
    src = TexturedImages(cfg.fineSize, nc=1, seed=1234)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            scores = {tag: vars(evaluate_slice(cfg, lambda lr: g(lr), src,
                                               sets, batch_size=20,
                                               device="cuda"))
                      for tag, sets in (("train", range(5)),
                                        ("test", range(2000, 2005)))}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    result = {"config": cfg.variant, "epochs": epochs, "ntrain": ntrain,
              "seed": seed, **scores}
    with open(os.path.join(directory, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def tools_phase(smi):
    """Phase 26: the user tools on the card at full width, each started as a
    user starts it (in this process unless said otherwise; every kernel's
    count from 0 just before each): overlap_protocol, select_checkpoint,
    validate_bf16, zssr_photo, serve_load against a `serve --warmup
    --warmup-rect` server, loader_bench, quality_protocol.  Returns
    {tool: {kernel: launches run}}."""
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch import (loader_bench, overlap_protocol,
                                    quality_protocol, select_checkpoint,
                                    serve_load, validate_bf16, zssr_photo)
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.train.checkpoint import load_branch
    from dcgan_sr_tpu_torch.models import generator_spec, init_network

    launches = {}

    def done(name, entry):
        """Print one tool's results as soon as it has passed."""
        print(f"phase 26, {name}, on {smi}: "
              + json.dumps(entry, default=float), flush=True)

    def ran(name, counts, lines=None):
        """The tool's kernel launches that ran: the wrappers' counts, or
        its own last line (which takes a CUDA graph's replays into
        account)."""
        if lines is not None:
            counts = _launch_line(lines)
        launches[name] = {k: counts[k] for k in TOOL_KERNELS}
        return launches[name]

    # overlap_protocol on the committed fixture, both BN modes, against
    # PARITY.md (phase 19 holds the same overlap eval on the card to the CPU)
    rows = {}
    for bn_eval in (False, True):
        res, lines, secs, c = _tool(overlap_protocol.main, [
            "--ckpt", OVERLAP_FIXTURE] + ["--bn-eval"] * bn_eval)
        k = ran(f"overlap_protocol{' --bn-eval' * bn_eval}", c)
        check(res.n_images == 500 and k["bulge_main"] == 5
              and k["bulge_stats"] == (0 if bn_eval else 5),
              f"overlap_protocol bn_eval={bn_eval}: {res.n_images} images, "
              f"launches {k}")
        got = {"bilinear": (res.psnr_bilinear, res.ssim_bilinear),
               (bn_eval, "naive"): (res.psnr_naive, res.ssim_naive),
               (bn_eval, "seam"): (res.psnr_seam, res.ssim_seam)}
        for key, (p, s) in got.items():
            wp, ws = PARITY_OVERLAP[key]
            check(abs(p - wp) <= TOL_PARITY[0] and abs(s - ws) <= TOL_PARITY[1],
                  f"overlap_protocol {key}: {p:.5f} / {s:.6f} against "
                  f"PARITY.md {wp} / {ws}")
            rows[str(key)] = [round(p, 5), round(s, 6), wp, ws]
        done(f"overlap_protocol bn_eval={bn_eval}", {
            "s": secs, "images_per_s": round(500 / secs, 2), "lines": lines})
    done("overlap_protocol", {"parity_rows": rows})

    with tempfile.TemporaryDirectory() as tmp:
        # select_checkpoint --full on what the trainer wrote: 3 short gray-3
        # epochs on the textured set, and a torn 4th epoch (G cut short,
        # D intact)
        ck = os.path.join(tmp, "ck")
        lines = _cli(["--config", "gray-3", "--textured", "--steps", "10",
                      "--scan", "5", "--epochs", "3", "--seed", "1",
                      "--checkpoint-dir", ck])
        ran("cli (select_checkpoint's epochs)", None, lines)
        cfg = get_config("gray-3", env_override=False)
        with open(os.path.join(ck, f"{cfg.name}_4_net_G.npz"), "wb") as f:
            f.write(b"PK\x03\x04 cut short")
        with open(os.path.join(ck, f"{cfg.name}_3_net_D.npz"), "rb") as f:
            d3 = f.read()
        with open(os.path.join(ck, f"{cfg.name}_4_net_D.npz"), "wb") as f:
            f.write(d3)
        best, lines, secs, c = _tool(select_checkpoint.main,
                                     ["--dir", ck, "--full",
                                      "--select-sets", "1"])
        k = ran("select_checkpoint --full", c)
        check(any(l.startswith("epoch 4: SKIPPED unreadable checkpoint")
                  for l in lines), f"no SKIPPED line: {lines}")
        scored = [l for l in lines if "train-slice PSNR" in l
                  and l.startswith("epoch ")]
        ref = [l for l in lines if l.startswith("[")]
        check(len(scored) == 3 and len(ref) == 8
              and all(l.endswith("train-Size: 2100") for l in ref)
              and k["bulge_stats"] == k["bulge_main"] == 3 + 42,
              f"select_checkpoint: {lines}, launches {k}")
        done("select_checkpoint --full", {
            "s": secs, "images_per_s": round((300 + 4200) / secs, 2),
            "best": best, "lines": lines})
        sub = _module(["dcgan_sr_tpu_torch.select_checkpoint", "--dir", ck,
                       "--select-sets", "1"])
        check(sub[-1] == [l for l in lines if l.startswith("BEST")][0],
              f"python -m select_checkpoint: {sub[-1]}")

        # validate_bf16 at 20 steps of batch 100 (K = 20: the warm-up chunk
        # and the capture), twice: under cuDNN's deterministic algorithms
        # both runs must print the same PSNR/SSIM of each dtype and the same
        # verdict (its 100-step default runs from four seeds in PERF.md)
        runs = []
        for rep in (1, 2):
            ok, lines, secs, c = _tool(
                lambda _: validate_bf16.run(steps=VALIDATE_STEPS), None)
            k = ran(f"validate_bf16 #{rep}", c, lines)
            check(lines[-2].startswith("delta PSNR ")
                  and lines[-2].endswith("-> PASS" if ok else "-> FAIL"),
                  f"validate_bf16: {lines}")
            check(k["preprocess"] == 2 * VALIDATE_STEPS
                  and k["bulge_stats"] == 4
                  and k["bulge_main"] == 4, f"validate_bf16 launches {k}")
            runs.append({"s": secs, "pass": bool(ok), "lines": lines})
        fields = [[float(v) for v in re.findall(
            r"G-(?:PSNR|SSIM) ([\d.]+)", l)] for r in runs
            for l in r["lines"][:2]]
        check(fields[:2] == fields[2:] and runs[0]["pass"] == runs[1]["pass"]
              and runs[0]["lines"][-2] == runs[1]["lines"][-2],
              f"validate_bf16's two runs differ: {runs}")
        done("validate_bf16", {"runs": runs, "spread_of_two_runs": {
            d: [round(abs(fields[i][j] - fields[i + 2][j]), 4)
                for j in (0, 1)] for i, d in enumerate(("fp32", "bf16"))}})

        # the CLI's default as a user starts it: 100 steps of each dtype from
        # the JAX tool's own initial state (fixtures/gray3_jax_init_key5.npz);
        # PASS (exit 0) and FAIL (exit 1) are both findings
        t0 = time.perf_counter()
        rc, lines = _module_run(["dcgan_sr_tpu_torch.validate_bf16"],
                                codes=(0, 1))
        secs = round(time.perf_counter() - t0, 2)
        k = ran("validate_bf16 (the CLI, the JAX init)", None, lines)
        check(len(lines) >= 4 and lines[-4].startswith("float32  : G-PSNR ")
              and lines[-3].startswith("bfloat16 : G-PSNR ")
              and lines[-2].startswith("delta PSNR ")
              and lines[-2].endswith("-> FAIL" if rc else "-> PASS"),
              f"python -m dcgan_sr_tpu_torch.validate_bf16 (exit {rc}): "
              f"{lines}")
        check(k["preprocess"] == 200 and k["bulge_stats"] == 4
              and k["bulge_main"] == 4,
              f"python -m dcgan_sr_tpu_torch.validate_bf16 launches {k}")
        scores = {d: [float(v) for v in re.findall(
            r"G-(?:PSNR|SSIM) ([\d.]+)", l)]
            for d, l in zip(("fp32", "bf16"), lines[-4:-2])}
        delta = [float(v) for v in re.findall(
            r"delta (?:PSNR|SSIM) ([\d.]+)", lines[-2])]
        done("python -m dcgan_sr_tpu_torch.validate_bf16 (the JAX tool's "
             "init, 100 steps)", {
                 "s": secs, "G_psnr_ssim": scores, "delta_psnr_ssim": delta,
                 "verdict": "FAIL" if rc else "PASS", "lines": lines})

        # zssr_photo --bf16 on a seeded photo
        photo = write_photo(os.path.join(tmp, "photo.png"))
        res, lines, secs, c = _tool(zssr_photo.main, [
            "--input", photo, "--bf16", "--steps", "100",
            "--ckpt-out", os.path.join(tmp, "zssr"),
            "--sr-out", os.path.join(tmp, "zssr_sr.png")])
        k = ran("zssr_photo --bf16", c, lines)
        check(all(np.isfinite(v) for f, v in res.items()
                  if f.startswith(("psnr", "ssim")))
              and res["holdout_hw"] == [96, 512]
              and os.path.isfile(os.path.join(tmp, "zssr_sr.png"))
              and os.path.isfile(os.path.join(
                  tmp, "zssr", f"{cfg.name}_100_net_G.npz")),
              f"zssr_photo: {lines}")
        check(k["preprocess"] == 100 and k["bulge_stats"] == 1
              and k["bulge_main"] == 2, f"zssr_photo launches {k}")
        done("zssr_photo --bf16", {
            "s": secs, "steps_per_s": round(100 / res["train_time_s"], 2),
            "result": res})

        # serve_load against a gray-3 server warmed on every ladder pair;
        # the first request is non-square
        with tempfile.TemporaryFile() as log:
            server = start_server(cfg, False, log,
                                  extra=("--warmup", "--warmup-rect",
                                         "--max-size", "128"))
            try:
                before = wait_up(server, "serve --warmup-rect")
                _, lines, secs, _ = _tool(serve_load.main, [
                    "--port", str(server[1]), "--size", "100x72",
                    "--warm", "10"])
                after = _healthz(server[1])
            except Exception:
                log.seek(0)
                sys.stderr.write(log.read().decode(errors="replace")[-8000:])
                raise
            finally:
                stop_server(server[0])
            log.seek(0)
            warm_line = [l for l in log.read().decode(
                errors="replace").splitlines() if l.startswith("warmup:")]
        phases = {}
        for l in lines:
            rec = json.loads(l)
            phases.setdefault(rec["phase"], []).append(rec)
        cold_ms = phases["cold_first"][0]["s"] * 1e3
        p50 = phases["warm_single"][0]["median_ms"]
        errors = [e for r in phases["concurrent"] for e in r["errors"]]
        k = ran("serve_load", {n: after["kernel_launches"].get(n, 0)
                               - before["kernel_launches"].get(n, 0)
                               for n in TOOL_KERNELS})
        check(cold_ms <= 3 * p50, f"the first non-square request took "
              f"{cold_ms:.1f} ms against a p50 of {p50} ms after "
              f"--warmup-rect")
        check(not errors and after["requests"] - before["requests"] == 43
              and k["bulge_main"] > 0, f"serve_load: {lines}, launches {k}")
        done("serve_load", {"s": secs, "warmup": warm_line,
                            "lines": phases})

        # loader_bench (the host alone) over a quarter of its default batches
        res, lines, secs, c = _tool(loader_bench.main, ["--batches", "5"])
        ran("loader_bench", c)
        check(sorted(res) == sorted([
            "folder_sample_images_per_sec", "folder_prefetch4_images_per_sec",
            "folder_canvas_images_per_sec"]), f"loader_bench: {lines}")
        done("loader_bench", {"s": secs, "images_per_s": res})

        # quality_protocol on a baseline directory written here from the
        # committed gray-3 fixture's G
        qcfg = get_config("gray-3", env_override=False, batchSize=20)
        g_params, _ = init_network(generator_spec(qcfg),
                                   torch.Generator().manual_seed(0))
        with np.load(FIXTURE) as data:
            g_params = load_branch(data, "params", g_params)
        epochs, ntrain = 3, 1000
        base = write_torch_baseline(os.path.join(tmp, "tb"), qcfg, g_params,
                                    epochs, ntrain, seed=1)
        (qrows, qdiff), lines, secs, c = _tool(quality_protocol.main, [
            "--torch-dir", os.path.join(tmp, "tb")])
        k = ran("quality_protocol", c, lines)
        steps = epochs * ntrain // 20
        check(k["preprocess"] == steps and k["bulge_stats"] == 21
              and k["bulge_main"] == 21, f"quality_protocol launches {k}")
        imported = dict((r[0], r[1:]) for r in qrows)["torch-trained, OUR eval"]
        for tag, r in zip(("train", "test"), imported):
            for f in ("psnr_generator", "ssim_generator"):
                d = abs(getattr(r, f) - base[tag][f])
                check(d <= (1e-3 if f.startswith("psnr") else 1e-4),
                      f"quality_protocol: the imported G's {tag} {f} is "
                      f"{getattr(r, f)}, torch.nn's {base[tag][f]}")
        check(qdiff <= TOL_Y, f"quality_protocol fused vs unfused {qdiff}")
        done("quality_protocol", {"s": secs, "steps": steps,
                                  "lines": lines})

    print(f"phase 26, kernel launches of each tool, on {smi}: "
          + json.dumps(launches), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 27: the measurement entry points as users start them
# ---------------------------------------------------------------------------

BENCH_LINES = ("overlap_sr_upscaled_mp_per_sec",
               "overlap_sr_upscaled_mp_per_sec_bn_eval",
               "train_images_per_sec_rgb_full",
               "train_images_per_sec_gray_patch_batch",
               "train_images_per_sec")


def _bf16_k2_counts(name, launches, by_impl, stats, main):
    """Every bf16 K2 launch by the wgmma kernel, and the counts expected."""
    check(launches["bulge_stats_bf16"] == stats
          and launches["bulge_main_bf16"] == main
          and launches["bulge_stats"] == launches["bulge_main"] == 0
          and by_impl["wgmma_bf16"] == stats + main
          and sum(by_impl.values()) == stats + main,
          f"{name}: K2 launched {launches}, by implementation {by_impl} "
          f"(want {stats} stats and {main} main launches, all wgmma_bf16)")


def measure_phase(smi, fp32_gray3=None, bf16_profile=None):
    """Phase 27: `python -m dcgan_sr_tpu_torch.bench` as a subprocess at
    full geometry (its host stamps held to utils/host.machine_fingerprint),
    then `bench_infer --self-ensemble 8` (both forms), attr_variant,
    attr_overlap (both modes), feed_ab and probe_image_io in this process
    (every kernel's count from 0 just before each).  Prints bench's gray-3 bf16 step beside phase 8's fp32
    step (`fp32_gray3`) and phase 15's profile of the bf16 step, where
    given (the phase run alone has neither).  Returns {tool: {kernel:
    launches run}}."""
    import torch

    from dcgan_sr_tpu_torch import (attr_overlap, attr_variant, bench,
                                    bench_infer, feed_ab, probe_image_io)
    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.models import generator_spec
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.utils.host import machine_fingerprint

    t_phase = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    limit = float(smi.rsplit(",", 1)[1].split()[0])
    launches = {}

    def done(name, entry):
        print(f"phase 27, {name}, on {smi}: " + json.dumps(entry),
              flush=True)

    # bench: its five lines after the header and the launch line, gray-3
    # last; vs_baseline from the baseline file, which stays as it was
    with open(bench.BASELINE_FILE, "rb") as f:
        baseline_bytes = f.read()
    t0 = time.perf_counter()
    lines = _module(["dcgan_sr_tpu_torch.bench"])
    secs = round(time.perf_counter() - t0, 2)
    with open(bench.BASELINE_FILE, "rb") as f:
        check(f.read() == baseline_bytes, "bench wrote the baseline file")
    check(len(lines) == 7, f"bench printed {lines}")
    head = json.loads(lines[0])
    check(head["metric"] == "bench_selfcert" and head["device"] == kind
          and head["power_limit_w"] == limit, f"bench header {head}")
    check(lines[1].startswith("kernel launches: "), lines[1])
    counts = json.loads(lines[1][len("kernel launches: "):])
    recs = [json.loads(l) for l in lines[2:]]
    check([r["metric"] for r in recs] == list(BENCH_LINES),
          f"bench metric lines {[r['metric'] for r in recs]}")
    # the host's fingerprint, as bench.py stamps it: the tag on every line,
    # its description in the header
    tag, desc = machine_fingerprint()
    check(head["host"] == tag and head["host_desc"] == desc
          and all(r["host"] == tag for r in recs),
          f"bench host stamps {head['host']!r} {head['host_desc']!r}, want "
          f"{tag!r} {desc!r}")
    baselines = bench.read_baselines()
    for r in recs:
        lo, med, hi = r["rep_spread"]
        base = baselines[bench.BASELINE_KEYS[r["metric"]]]
        check(r["value"] > 0 and 0 < lo <= med <= hi
              and r["device"] == kind and r["power_limit_w"] == limit
              and r["vs_baseline"] == round(r["value"] / base, 2),
              f"bench line {r} (baseline {base})")
    # K1: a warm-up chunk, then three replays of it, 20 steps each
    check(counts["preprocess_run"] == {v: 4 * K_STEPS for v in
                                       ("rgb-full", "gray-patch-batch",
                                        "gray-3")},
          f"bench K1 launches run {counts['preprocess_run']}")
    # K2: 4 x 20 pipeline calls a BN mode; stats in the parity mode only
    _bf16_k2_counts("bench", counts["bulge"], counts["bulge_impl"],
                    4 * K_STEPS, 8 * K_STEPS)
    launches["bench"] = {**counts["bulge"],
                         "preprocess": sum(counts["preprocess_run"].values())}
    done("python -m dcgan_sr_tpu_torch.bench",
         {"s": secs, "header": head, "launches": counts, "lines": recs})
    ips = recs[-1]["value"]
    step_ms = bench.BATCH / ips * 1e3
    if fp32_gray3 is not None and bf16_profile is not None:
        print(f"bf16 gray-3 step {step_ms:.4f} ms ({ips} images/s, bench) "
              f"beside the fp32 step of phase 8, {fp32_gray3['step_ms']} ms "
              f"({fp32_gray3['images_per_s']} images/s), on {smi}; cuDNN's "
              f"dgrad_engine / wgrad_alg0_engine in the bf16 step: "
              f"{bf16_profile['cudnn_fp32_backward_ms']} ms a step (30.2 / "
              f"11.9 in the fp32 step, PERF.md section 5); device busy "
              f"{bf16_profile['device_busy_share']} of the wall time",
              flush=True)

    # bench_infer --self-ensemble 8, each form, both BN modes: 8 images a
    # call (bench_infer.py's max(8, 64 // 8)), 4 x 20 calls a mode; the
    # members run as 8 generator calls a pipeline call, or batched as one
    # of 8 x 8 x 225 = 14,400 tiles (the N = 1 line's call)
    n1 = {r["metric"]: r["value"] for r in recs[:2]}
    for batched in (False, True):
        for k in K.impl_launches:
            K.impl_launches[k] = 0
        _, lines, secs, c = _tool(bench_infer.main, [
            "--self-ensemble", "8"] + ["--ensemble-batched"] * batched)
        tta = [json.loads(l) for l in lines[:-1]]
        form = "_batched" if batched else ""
        check([r["metric"] for r in tta] == [
            f"overlap_sr_upscaled_mp_per_sec_tta8{form}",
            f"overlap_sr_upscaled_mp_per_sec_tta8{form}_bn_eval"]
            and all(0 < r["rep_spread"][0] <= r["value"]
                    <= r["rep_spread"][2] and r["device"] == kind
                    for r in tta), f"bench_infer --self-ensemble 8: {lines}")
        calls = 4 * K_STEPS * (1 if batched else 8)
        name = "bench_infer --self-ensemble 8" + " --ensemble-batched" * batched
        _bf16_k2_counts(name, c, dict(K.impl_launches), calls, 2 * calls)
        launches[name] = c
        done(name, {"s": secs, "lines": tta, "over_the_n1_line": [
            round(r["value"] / n1[r["metric"].replace(f"_tta8{form}", "")], 4)
            for r in tta], "n1_lines": n1})

    # attr_variant: the gray-3 bf16 step at batch 100 and its G prefixes
    ran = {}
    res, lines, secs, c = _tool(
        functools.partial(attr_variant.main, launches=ran), [
            "--config", "gray-3", "--batch", "100", "--steps", "5",
            "--reps", "2"])
    n_layers = len(generator_spec(get_config("gray-3", env_override=False)))
    check(list(res) == ["config", "dtype", "step_batch", "step_ms",
                        "g_fwd_ms", "g_fwd_bwd_ms", "d_fwd_ms",
                        "d_fwd_bwd_ms", "g_layers"]
          and (res["config"], res["dtype"], res["step_batch"])
          == ("gray-3", "bfloat16", 100)
          and all(res[k] > 0 for k in list(res)[3:8])
          and len(res["g_layers"]) == n_layers
          and all(r["prefix_ms"] > 0 for r in res["g_layers"]),
          f"attr_variant: {lines}")
    # K1 ran in the warm-up chunk and in the two timed replays (the tool's
    # count from the runner); the trainer's G runs layers 3-4 unfused: no K2
    check(ran["preprocess"] == 3 * 5 and c["bulge_main"] == 0
          and c["bulge_main_bf16"] == 0,
          f"attr_variant launches {c}, run {ran}")
    launches["attr_variant"] = {**c, "preprocess": ran["preprocess"]}
    done("attr_variant --config gray-3 --batch 100", {"s": secs,
                                                      "result": res})

    # attr_overlap, both modes, at 64 images: K2 on every generator call
    for sweep in (False, True):
        for k in K.impl_launches:
            K.impl_launches[k] = 0
        res, lines, secs, c = _tool(attr_overlap.main, [
            "--images", "64", "--steps", "5", "--reps", "2"]
            + ["--sweep-bn"] * sweep)
        name = "attr_overlap" + " --sweep-bn" * sweep
        calls = 3 * 5                        # a warm and two timed reps
        if sweep:
            check(all(res[f"{n}_ms"] > 0 for n in ("vmap_train", "vmap_eval",
                                                   "flat_eval",
                                                   "flat_pooled")),
                  f"{name}: {res}")
            # stats in vmap_train and flat_pooled; main in all four
            _bf16_k2_counts(name, c, dict(K.impl_launches), 2 * calls,
                            4 * calls)
        else:
            check(all(res[f"{n}_ms"] > 0 for n in attr_overlap.STAGES)
                  and res["flops_per_step_g"] > 0, f"{name}: {res}")
            # gen, naive and seam each run the generator
            _bf16_k2_counts(name, c, dict(K.impl_launches), 3 * calls,
                            3 * calls)
        launches[name] = c
        done(name, {"s": secs, "result": res,
                    "by_implementation": dict(K.impl_launches)})

    # feed_ab: 5 epochs of 8 steps in chunks of 4, one capture
    ran = {}
    res, lines, secs, c = _tool(
        functools.partial(feed_ab.main, launches=ran), [
            "--config", "rgb-full", "--steps", "8", "--scan", "4",
            "--rounds", "2"])
    own = [l for l in lines if not l.startswith(("Epoch:", "End of epoch"))]
    check(len(own) == 8 and own[0].startswith("warmup epoch: ")
          and [l.split(":")[0] for l in own[1:5]] == [
              "round 0 stage_ahead=False", "round 0 stage_ahead=True",
              "round 1 stage_ahead=True", "round 1 stage_ahead=False"]
          and re.fullmatch(r"stage_ahead=True won [0-2]/2 paired rounds",
                           own[-1]), f"feed_ab: {lines}")
    # K1 ran in every step of the five epochs (the tool's count from the
    # runner: the warm-up chunk, then replays)
    check(ran["preprocess"] == 5 * 8, f"feed_ab launches {c}, run {ran}")
    launches["feed_ab"] = {**c, "preprocess": ran["preprocess"]}
    done("feed_ab --config rgb-full (plumbing check at smoke depth)",
         {"s": secs, "lines": own})

    with tempfile.TemporaryDirectory() as tmp:
        _, lines, secs, _ = _tool(probe_image_io.main, [tmp])
        pngs = sorted(os.listdir(tmp))
    check(len(pngs) == 9 and sum("constant input -> black" in l
                                 for l in lines) == 5,
          f"probe_image_io: {pngs}, {lines}")
    done("probe_image_io", {"s": secs, "pngs": pngs})
    print(f"phase 27 took {time.perf_counter() - t_phase:.1f} s; kernel "
          f"launches of each tool, on {smi}: " + json.dumps(launches),
          flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 28: the ported options that had never run on the card
# ---------------------------------------------------------------------------

# score lines: the eval protocol's ([tag] PSNR|SSIM btwn a & b: value),
# select_checkpoint's (epoch N: train-slice PSNR x SSIM y) and
# overlap_protocol's (name  PSNR x  SSIM y); groups: the label, then the value
SCORE_LINES = (
    re.compile(r"^\[(.+?)\] (PSNR|SSIM) btwn (.+?): ([-\d.]+|nan|inf),"),
    re.compile(r"^(epoch \d+): train-slice (PSNR) ([-\d.]+|nan|inf) "),
    re.compile(r"^(epoch \d+): train-slice PSNR \S+ (SSIM) "
               r"([-\d.]+|nan|inf)$"),
    re.compile(r"^(\S+)\s+(PSNR) ([-\d.]+|nan|inf)\s+SSIM"),
    re.compile(r"^(\S+)\s+PSNR \S+\s+(SSIM) ([-\d.]+|nan|inf)$"),
)
TOL_SCORE = {"PSNR": 1e-3, "SSIM": 1e-4}     # PERF.md section 2
G_EMA = 0.999
EMA_K = 3


def _scores(lines):
    """{label: (value, decimals printed)} of the score lines in `lines`."""
    out = {}
    for line in lines:
        for pat in SCORE_LINES:
            m = pat.match(line)
            if m:
                *label, v = m.groups()
                out[" ".join(label)] = (float(v), len(v.partition(".")[2]))
    return out


def _hold_scores(name, card, cpu):
    """Card scores against the CPU's: PSNR within 1e-3 dB and SSIM within
    1e-4, plus the last printed digit; returns the largest differences."""
    check(card and set(card) == set(cpu), f"{name}: score lines "
          f"{sorted(card)} on the card, {sorted(cpu)} on the CPU")
    worst = {"PSNR": 0.0, "SSIM": 0.0}
    for label, (v, nd) in card.items():
        kind = "SSIM" if "SSIM" in label.split() else "PSNR"
        d = abs(v - cpu[label][0])
        worst[kind] = max(worst[kind], d)
        check(v == v and abs(v) != float("inf")
              and d <= TOL_SCORE[kind] + 10.0 ** -nd,
              f"{name}: {label} {v} on the card, {cpu[label][0]} on the CPU")
    return worst


def _counted_run(main, args, env=None):
    """main(args) in this process with every kernel's count from 0 just
    before it: (its lines, seconds, {kernel: launches}, {implementation:
    launches})."""
    import torch

    from dcgan_sr_tpu_torch.ops import bulge as K

    _zero_counts()
    for k in K.impl_launches:
        K.impl_launches[k] = 0
    t0 = time.perf_counter()
    _, lines = _in_process(main, args, env)
    torch.cuda.synchronize()
    return (lines, round(time.perf_counter() - t0, 2), dict(K.launches),
            dict(K.impl_launches))


def _card_and_cpu(main, card_args, cpu_args=None, env=None):
    """main(card_args) on the card, then main(cpu_args + --cpu) (cpu_args
    defaults to card_args), each a `_counted_run`.  Returns the card's
    (lines, seconds, {kernel: launches}, {implementation: launches}) and
    the CPU's (lines, seconds)."""
    card = _counted_run(main, card_args, env)
    cpu = _counted_run(main, list(cpu_args or card_args) + ["--cpu"], env)
    return card, cpu[:2]


def _fp32_k2(name, launches, impl, stats=None, main=None):
    """Every K2 launch of a path fp32 and by the wgmma kernel, at least one
    main launch (`main`: exactly that many), stats launches where `stats`
    says (None: either)."""
    n = launches["bulge_stats"] + launches["bulge_main"]
    check(launches["bulge_main"] > 0 and impl["wgmma"] == n
          and sum(impl.values()) == n
          and launches["bulge_stats_bf16"] == launches["bulge_main_bf16"] == 0
          and (stats is None or (launches["bulge_stats"] > 0) == stats)
          and (main is None or launches["bulge_main"] == main),
          f"{name}: K2 launched {launches}, by implementation {impl}")


def _pngs(path):
    """{file name: pixels} of a PNG file ("" its name) or of every file in
    a directory."""
    import numpy as np
    from PIL import Image

    names = sorted(os.listdir(path)) if os.path.isdir(path) else [""]
    return {n: np.asarray(Image.open(os.path.join(path, n) if n else path),
                          np.int16) for n in names}


def _hold_pixels(name, a, b, share):
    """Images `a` against `b` ({name: pixels}): the same files and shapes,
    within TOL_U8 levels of 255 on all but `share` of each image's pixels.
    Returns (the largest difference in levels, pixels beyond TOL_U8)."""
    import numpy as np

    check(a and list(a) == list(b), f"{name}: files {list(a)} vs {list(b)}")
    worst = beyond = 0
    for n in a:
        check(a[n].shape == b[n].shape,
              f"{name} {n}: {a[n].shape} vs {b[n].shape}")
        d = np.abs(a[n] - b[n])
        off = int((d > TOL_U8).sum())
        check(off <= share * d.size, f"{name} {n}: {off} of {d.size} pixels "
              f"beyond {TOL_U8} levels (max {int(d.max())})")
        worst, beyond = max(worst, int(d.max())), beyond + off
    return worst, beyond


def _differs(a, b):
    """Pixels that differ at all between two {name: pixels} sets."""
    return sum(int((a[n] != b[n]).sum()) for n in a)


def ema_graph_check(smi):
    """`--g-ema` inside the K-step CUDA graph: gray-3 fp32 at batch 100
    with g_ema 0.999, K = 3, under cuDNN's deterministic algorithms.  A
    runner warms up on one chunk and captures it; two eager twins start
    from copies of its state; the graph replays the next chunk and the
    twins run it eagerly.  The replayed EMA must move, and agree with the
    twins' as they agree with each other (a graph that updated a copy of
    the EMA buffers would leave the live ones where they were)."""
    import numpy as np
    import torch

    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.train.multi_step import build_multi_step
    from dcgan_sr_tpu_torch.train.step import (init_train_state,
                                               state_from_numpy,
                                               state_to_numpy)

    dev = torch.device("cuda")
    cfg = get_config("gray-3", env_override=False, g_ema=G_EMA)
    b = _batches(cfg, 2 * EMA_K, dev)
    chunks = (torch.stack(b[:EMA_K]), torch.stack(b[EMA_K:]))
    prev = _deterministic()
    try:
        sg = init_train_state(cfg, torch.Generator().manual_seed(0),
                              device=dev)
        mg, me = build_multi_step(cfg), build_multi_step(cfg)
        mg(sg, chunks[0])                 # eager warm-up, then the capture
        snap = state_to_numpy(sg)
        se, se2 = (state_from_numpy(cfg, snap, device=dev) for _ in range(2))
        ema0 = [t.clone() for t in sg.g_ema]
        mg(sg, chunks[1])
        me.eager(se, chunks[1])
        me.eager(se2, chunks[1])
        torch.cuda.synchronize()
    finally:
        _deterministic(prev)

    def flat(ts):
        return torch.cat([t.flatten() for t in ts]).double().cpu().numpy()

    e0, eg, e1, e2 = (flat(t) for t in (ema0, sg.g_ema, se.g_ema, se2.g_ema))
    diff, spread = float(np.abs(eg - e1).max()), float(np.abs(e1 - e2).max())
    moved, moved_eager = float(np.abs(eg - e0).max()), float(
        np.abs(e1 - e0).max())
    floor = 1e-6 * (1 + float(np.abs(e1).max()))
    r = {"K": EMA_K, "g_ema": G_EMA, "replays": mg.replays,
         "ema_moved_by_replay": moved, "ema_moved_eager": moved_eager,
         "max_abs_diff_graph_vs_eager": diff, "eager_twins_spread": spread}
    check(mg.captures == 1 and mg.replays == 1 and bool(np.isfinite(eg).all())
          and moved > 0 and diff <= 2 * spread + floor,
          f"the --g-ema graph's EMA against eager: {r}")
    print(f"--g-ema 0.999 in the K-step CUDA graph, gray-3 fp32 batch 100, "
          f"one replayed chunk against two eager twins, deterministic cuDNN, "
          f"on {smi}: " + json.dumps(r), flush=True)
    return r


def options_phase(smi):
    """Phase 28: the ported options that had never run on the card, at full
    width, each held to the same command (or service) run with --cpu:
    `--g-ema` in the CUDA graph (ema_graph_check) and through the CLI;
    `upscale --self-ensemble 8` with and without --ensemble-batched in both
    BN modes, full (gray-3) and overlap directories, the rectangular
    fallback to 4 members, `--true-2x` on LR directories, `--resize` and
    `--ema`; `serve --self-ensemble 8` and `serve --ema`; `cli --eval
    --self-ensemble 8 --ensemble-batched` on the gray-3 fixture;
    `select_checkpoint --ema` and `overlap_protocol --ema`.  Returns {path:
    {kernel: launches on the card}}."""
    import numpy as np

    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.train.checkpoint import (checkpoint_path,
                                                     npz_branches)

    t_phase = time.perf_counter()
    cfg = get_config("gray-3", env_override=False)
    launches = {}
    ema_graph_check(smi)

    with tempfile.TemporaryDirectory() as d:
        # the trainer with --g-ema, K = 3 a CUDA graph: its checkpoints
        # carry the EMA branch that --ema reads below
        ck = os.path.join(d, "ck")
        lines = _cli(["--config", "gray-3", "--synthetic", "--g-ema",
                      str(G_EMA), "--steps", "6", "--scan", "3", "--epochs",
                      "2", "--seed", "1", "--checkpoint-dir", ck])
        run, graph = k1_run(lines)
        check(run == 12 and graph["captures"] == 1 and graph["replays"] == 3,
              f"cli --g-ema: K1 ran {run}, graphs {graph}")
        ema_ckpt = checkpoint_path(ck, cfg.name, 2, "G")
        with np.load(ema_ckpt) as data:
            check("ema" in npz_branches(data)
                  and not np.array_equal(data["_ema_/_1_/_w_"],
                                         data["_params_/_1_/_w_"]),
                  "the --g-ema checkpoint has no moved EMA branch")
        launches["cli --g-ema"] = {"preprocess": run}
        print(f"cli gray-3 --g-ema {G_EMA} --scan 3, 2 epochs of 6 steps: K1 "
              f"ran {run}, graphs {graph}; both checkpoints carry the EMA "
              f"branch, on {smi}", flush=True)

        # the overlap fixture with an EMA branch: its params, perturbed
        ema_npz = os.path.join(d, "overlap_ema_net_G.npz")
        rng = np.random.RandomState(28)
        with np.load(OVERLAP_FIXTURE) as data:
            arrays = {k: data[k] for k in data.files}
        for k in sorted(arrays):
            if k.startswith("_params_/"):
                a = arrays[k]
                arrays["_ema_/" + k[len("_params_/"):]] = (a * (
                    1 + 0.05 * rng.standard_normal(a.shape))).astype(a.dtype)
        np.savez(ema_npz, **arrays)
        # overlap_protocol --ema on the CPU (100 images of 225 tiles on the
        # host, the phase's longest run) as a user starts it, in a process
        # of its own beside the rest of the phase
        op_args = ["--ckpt", ema_npz, "--sets", "10000:10001"]
        op_cpu = subprocess.Popen(
            [sys.executable, "-m", "dcgan_sr_tpu_torch.overlap_protocol",
             *op_args, "--ema", "--cpu"], cwd=REPO,
            env={k: v for k, v in os.environ.items() if k not in CONFIG_ENV},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        t_op = time.perf_counter()
        try:
            _option_paths(smi, d, cfg, ck, ema_ckpt, ema_npz, rng, launches)
            _tool_ema(smi, ck, op_args, op_cpu, t_op, launches)
        finally:
            if op_cpu.poll() is None:
                op_cpu.kill()
            op_cpu.wait()

    print(f"phase 28 took {time.perf_counter() - t_phase:.1f} s; K2 launches "
          f"of each path, on {smi}: " + json.dumps(launches), flush=True)
    return launches


def _option_paths(smi, d, cfg, ck, ema_ckpt, ema_npz, rng, launches):
    """Phase 28's upscale, serve and cli --eval runs (`options_phase`):
    `ck` holds the --g-ema trainer's checkpoints, `ema_ckpt` its second G,
    `ema_npz` the overlap fixture with an EMA branch; each path's launches
    go into `launches`."""
    import numpy as np
    import torch
    from PIL import Image

    from dcgan_sr_tpu_torch import cli, upscale
    from dcgan_sr_tpu_torch.image.io import load_image
    from dcgan_sr_tpu_torch.serve import SRService
    from dcgan_sr_tpu_torch.train.checkpoint import (load_branch,
                                                     load_generator,
                                                     save_checkpoint)
    from dcgan_sr_tpu_torch.train.step import (init_train_state,
                                               state_from_numpy,
                                               state_to_numpy)

    ocfg_name = "gray-patch-batch-overlap"

    # input images, from a seed
    def write(directory, shapes):
        os.makedirs(directory, exist_ok=True)
        for i, hw in enumerate(shapes):
            Image.fromarray((rng.rand(*hw) * 255).astype(np.uint8)).save(
                os.path.join(directory, f"{i}.png"))
        return directory

    sq = write(os.path.join(d, "sq"), [(64, 64)] * 2)
    sq32 = write(os.path.join(d, "sq32"), [(32, 32)] * 2)   # 49 tiles
    lr_full = write(os.path.join(d, "lr_full"), [(32, 32), (36, 28)])
    lr_tiled = write(os.path.join(d, "lr_tiled"), [(32, 32)] * 2)
    one = write(os.path.join(d, "one"), [(64, 64), (48, 64), (50, 70)])
    img64, rect, odd = (os.path.join(one, f"{i}.png") for i in range(3))
    n_out = itertools.count()

    def up(name, args, tiled, stats=None, main=None):
        """upscale on the card and with --cpu; the card's images held to
        the CPU's (tiled: all but TILED_FLIP_SHARE of the pixels)."""
        out = os.path.join(d, f"out{next(n_out)}")
        ext = "" if os.path.isdir(args[args.index("--input") + 1]) \
            else ".png"
        (lines, secs, c, impl), (_, cpu_secs) = _card_and_cpu(
            upscale.main, args + ["--output", out + ext],
            args + ["--output", out + "_cpu" + ext])
        _fp32_k2(f"upscale {name}", c, impl, stats, main)
        got = _pngs(out + ext)
        worst, beyond = _hold_pixels(f"upscale {name}", got,
                                     _pngs(out + "_cpu" + ext),
                                     TILED_FLIP_SHARE if tiled else 0.0)
        launches[f"upscale {name}"] = c
        print(f"upscale {name}: card {secs} s, CPU {cpu_secs} s, max "
              f"{worst} levels from the CPU, {beyond} pixels beyond "
              f"{TOL_U8}; K2 {c} by {impl}, on {smi}", flush=True)
        return got, c

    # --self-ensemble 8: full (gray-3) and overlap directories, both
    # forms, both BN modes; a form's generator calls: 8 members or 1
    for variant, fixture, src, tiled in (
            ("gray-3", FIXTURE, sq, False),
            (ocfg_name, OVERLAP_FIXTURE, sq32, True)):
        for bn in ([], ["--bn-eval"]):
            mains = {}
            for batched in ([], ["--ensemble-batched"]):
                _, c = up(" ".join([variant, "--self-ensemble 8", *batched,
                                    *bn]), [
                              "--config", variant, "--ckpt", fixture,
                              "--input", src, "--self-ensemble", "8",
                              *batched, *bn], tiled, stats=not bn)
                mains[bool(batched)] = c["bulge_main"]
            check(mains[False] == 8 * mains[True], f"{variant} "
                  f"--self-ensemble 8 {bn}: main launches {mains}")

    # a rectangle takes the four shape-keeping members of 8
    g3 = ["--config", "gray-3", "--ckpt", FIXTURE, "--input", rect]
    got8, _ = up("gray-3 --self-ensemble 8, 48x64", g3 + [
        "--self-ensemble", "8"], False, stats=True, main=4)
    got4, _ = up("gray-3 --self-ensemble 4, 48x64", g3 + [
        "--self-ensemble", "4"], False, stats=True, main=4)
    check(_differs(got8, got4) == 0, "--self-ensemble 8 on a rectangle "
          "is not its 4-member plan")

    # --true-2x on LR directories, --resize
    up("gray-3 --true-2x, LR directory", [
        "--config", "gray-3", "--ckpt", FIXTURE, "--input", lr_full,
        "--true-2x"], False, stats=True, main=1)
    up(f"{ocfg_name} --true-2x, LR directory", [
        "--config", ocfg_name, "--ckpt", OVERLAP_FIXTURE, "--input",
        lr_tiled, "--true-2x"], True, stats=True, main=1)
    got, _ = up("gray-3 --resize 64, 50x70", [
        "--config", "gray-3", "--ckpt", FIXTURE, "--input", odd,
        "--resize", "64"], False, stats=True, main=1)
    check(list(got.values())[0].shape == (64, 64), "--resize 64 wrote "
          f"{list(got.values())[0].shape}")

    # --ema: differs from the params branch, matches the CPU's EMA
    for variant, ckpt, src, tiled in (
            ("gray-3", ema_ckpt, img64, False),
            (ocfg_name, ema_npz, sq32, True)):
        args = ["--config", variant, "--ckpt", ckpt, "--input", src]
        ema, _ = up(f"{variant} --ema", args + ["--ema"], tiled,
                    stats=True)
        raw, _ = up(f"{variant} (params branch of the --ema file)", args,
                    tiled, stats=True)
        n = _differs(ema, raw)
        check(n > 0, f"upscale {variant} --ema gave the params branch")
        print(f"upscale {variant} --ema: {n} pixels differ from the "
              f"params branch", flush=True)

    # servers: --self-ensemble 8 (parity BN) and --ema (running BN),
    # started together.  Each has services on the CPU: the one every
    # response is held to, and (--ema) the params branch's, which the
    # responses must differ from
    runs = (("--self-ensemble 8", True, FIXTURE, ("--self-ensemble", "8"),
             ({"self_ensemble": 8},)),
            ("--ema", False, ema_ckpt, ("--ema",),
             ({"ema": True}, {"ema": False})))
    served = {}
    with tempfile.TemporaryFile() as log:
        servers = [start_server(cfg, parity, log, ckpt, extra)
                   for _, parity, ckpt, extra, _ in runs]
        try:
            for srv, (name, parity, ckpt, _, kws) in zip(servers, runs):
                h0 = wait_up(srv, f"serve {name}")
                refs = [SRService(
                    cfg, load_generator(cfg, ckpt, ema=kw.get("ema", False),
                                        need_state=not parity,
                                        device="cpu")[0],
                    max_batch=8, window_ms=0, bn_eval=not parity,
                    u8_io=True, self_ensemble=kw.get("self_ensemble", 1))
                    for kw in kws]
                try:
                    worst = beyond = moved = 0
                    for hw in ((32, 32), (48, 40), (64, 64)):
                        body = _png((rng.rand(*hw) * 255).astype(np.uint8))
                        status, resp = _request(srv[1], "POST",
                                                "/upscale", body)
                        check(status == 200, f"serve {name}: {status}")
                        got = {"": np.asarray(Image.open(
                            io.BytesIO(resp)), np.int16)}
                        img = load_image(io.BytesIO(body), nc=1)[0]
                        want = [{"": _u8(r.submit(img))} for r in refs]
                        w, b = _hold_pixels(f"serve {name} {hw}", got,
                                            want[0], 0.0)
                        worst, beyond = max(worst, w), beyond + b
                        moved += sum(_differs(got, x) for x in want[1:])
                finally:
                    for r in refs:
                        r.close()
                hz = _healthz(srv[1])
                c = {k: v - h0["kernel_launches"][k]
                     for k, v in hz["kernel_launches"].items()}
                _fp32_k2(f"serve {name}", c, {
                    k: v - h0["bulge_impl_launches"][k]
                    for k, v in hz["bulge_impl_launches"].items()},
                    stats=parity)
                check(hz["errors"] == 0 and (len(refs) == 1 or moved > 0),
                      f"serve {name}: {hz['errors']} errors, {moved} pixels "
                      f"other than the params branch's")
                launches[f"serve {name}"] = c
                served[name] = {"max_levels_from_cpu": worst,
                                "pixels_beyond": beyond,
                                "pixels_differing_from_params_branch":
                                moved if len(refs) > 1 else None,
                                "launches": c}
        except Exception:
            log.seek(0)
            sys.stderr.write(log.read().decode(errors="replace")[-8000:])
            raise
        finally:
            for proc, _ in servers:
                stop_server(proc)
    print(f"serve gray-3 --self-ensemble 8 (parity BN) and --ema "
          f"(running BN), LR 32x32, 48x40, 64x64 against the CPU, on "
          f"{smi}: " + json.dumps(served), flush=True)

    # cli --eval with the ensemble on the gray-3 fixture: a checkpoint
    # of it at epoch 1 (D from a seed), resumed with no step to take
    fx = os.path.join(d, "fixture_ck")
    tree = state_to_numpy(init_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    with np.load(FIXTURE) as data:
        tree["g_params"] = load_branch(data, "params", tree["g_params"])
        tree["g_state"] = load_branch(data, "state", tree["g_state"])
    save_checkpoint(fx, cfg.name, 1, state_from_numpy(cfg, tree, "cpu"))
    (lines, secs, c, impl), (cpu_lines, cpu_secs) = _card_and_cpu(
        cli.main, ["--config", "gray-3", "--textured", "--checkpoint-dir",
                   fx, "--resume", "--epochs", "1", "--steps", "1",
                   "--eval", "--eval-sets", "1", "--self-ensemble", "8",
                   "--ensemble-batched"], env={"batchSize": "5"})
    check("resumed from epoch 1" in lines and "batchSize=5" in lines[0],
          f"cli --eval on the fixture: {lines[:4]}")
    card = _scores(lines)
    check(len(card) == 8, f"cli --eval score lines: {lines}")
    worst = _hold_scores("cli --eval --self-ensemble 8 --ensemble-batched",
                         card, _scores(cpu_lines))
    _fp32_k2("cli --eval --self-ensemble 8 --ensemble-batched", c, impl,
             stats=True, main=2)
    launches["cli --eval --self-ensemble 8 --ensemble-batched"] = c
    print(f"cli --eval --eval-sets 1 --self-ensemble 8 --ensemble-batched "
          f"(batchSize=5) on the gray-3 fixture: card {secs} s, CPU "
          f"{cpu_secs} s, largest differences {worst}; card scores "
          + json.dumps({k: v for k, (v, _) in card.items()})
          + f"; K2 {c}, on {smi}", flush=True)


def _tool_ema(smi, ck, op_args, op_cpu, t_op, launches):
    """select_checkpoint --ema and overlap_protocol --ema: card == CPU (the
    latter's CPU run is `op_cpu`, started at `t_op`), and other scores than
    the params branch's on the card."""
    from dcgan_sr_tpu_torch import overlap_protocol, select_checkpoint

    for tool, args, name in (
            (select_checkpoint.main, ["--dir", ck, "--epochs", "2:3",
                                      "--select-sets", "1"],
             "select_checkpoint"),
            (overlap_protocol.main, op_args, "overlap_protocol")):
        if name == "select_checkpoint":
            (lines, secs, c, impl), (cpu_lines, cpu_secs) = _card_and_cpu(
                tool, args + ["--ema"])
        else:
            lines, secs, c, impl = _counted_run(tool, args + ["--ema"])
            out, _ = op_cpu.communicate(timeout=900)
            # from its start, beside the rest of the phase
            cpu_secs = round(time.perf_counter() - t_op, 2)
            check(op_cpu.returncode == 0, f"overlap_protocol --ema --cpu "
                  f"exited with {op_cpu.returncode}: {out[-4000:]}")
            cpu_lines = out.splitlines()
        card = _scores(lines)
        worst = _hold_scores(f"{name} --ema", card, _scores(cpu_lines))
        _fp32_k2(f"{name} --ema", c, impl, stats=True)
        _, raw = _in_process(tool, args)
        raw = _scores(raw)
        check(set(raw) == set(card) and any(
            abs(raw[k][0] - card[k][0]) > TOL_SCORE[
                "SSIM" if "SSIM" in k.split() else "PSNR"]
            for k in card if "bilinear" not in k),
            f"{name} --ema scored as the params branch: {card} {raw}")
        launches[f"{name} --ema"] = c
        print(f"{name} --ema: card {secs} s, CPU {cpu_secs} s, largest "
              f"differences {worst}; card " + json.dumps(
                  {k: v for k, (v, _) in card.items()})
              + "; params branch " + json.dumps(
                  {k: v for k, (v, _) in raw.items()})
              + f"; K2 {c}, on {smi}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from dcgan_sr_tpu_torch.core import get_config
    from dcgan_sr_tpu_torch.models import Network, generator_spec, init_network
    from dcgan_sr_tpu_torch.ops import bulge as K
    from dcgan_sr_tpu_torch.ops import fused_nhwc as F3
    from dcgan_sr_tpu_torch.ops import preprocess as P
    from dcgan_sr_tpu_torch.serve import SRService
    from dcgan_sr_tpu_torch.train.checkpoint import load_branch

    started = time.perf_counter()
    stamps = []

    def stamp():
        """The script's own clock at the end of a block of phases."""
        stamps.append(round(time.perf_counter() - started, 1))
        print(f"elapsed after {len(stamps)} blocks (s): {stamps}", flush=True)

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    took, failed = {}, []

    def build(fn, name):
        try:
            fn()
            took[name] = time.perf_counter() - t0
        except Exception as e:      # re-raised below, on the main thread
            failed.append(e)

    # (source stem, its build, its nvcc output)
    sources = (("bulge", K.build, lambda: K.build_log),
               ("bulge_wgmma", K.build_wgmma, lambda: K.wgmma_build_log),
               ("preprocess", P.build, lambda: P.build_log),
               ("fused_nhwc", F3.build, lambda: F3.build_log),
               ("fused_nhwc_wgmma", F3.build_wgmma,
                lambda: F3.wgmma_build_log))
    threads = [threading.Thread(target=build, args=(fn, name))
               for name, fn, _ in sources]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if failed:
        raise failed[0]
    for name, _, log in sources:
        print(f"build: csrc/{name}.cu done {took[name]:.1f}s after the "
              f"{len(sources)} nvcc runs started", flush=True)
        print(log().strip(), flush=True)

    cfg = get_config("gray-3", env_override=False)
    spec = generator_spec(cfg)
    params, state = init_network(spec, torch.Generator().manual_seed(0))
    with np.load(FIXTURE) as data:
        params = load_branch(data, "params", params)
        state = load_branch(data, "state", state)
    fixture_g = (params, state)     # `state` names the trainer's below

    stamp()
    # phase 2
    errs, rows = kernel_phase(params, state)

    stamp()
    # phase 3
    plain = Network(spec, params, state, device="cuda", fuse=False)
    fused = Network(spec, params, state, device="cuda")
    x = torch.rand((1, 1, 256, 256), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(1))
    for bn_stats in ("running", "per_image"):
        for label, net in (("fused", fused), ("unfused", plain)):
            print(f"forward LR 256x256 {bn_stats} {label} (ms): " + json.dumps(
                forward_breakdown(net, x, bn_stats)), flush=True)
    del fused, x
    torch.cuda.empty_cache()

    stamp()
    # phase 4: counts start at 0 in each fresh server process
    launches = dict.fromkeys(K.launches, 0)
    lat_all = {}
    with tempfile.TemporaryFile() as log:
        servers = {parity: start_server(cfg, parity, log)
                   for parity in (True, False)}
        try:
            for parity in (True, False):
                ref = SRService(cfg, plain, max_batch=8, window_ms=0,
                                bn_eval=not parity, u8_io=True)
                try:
                    counts, lats, _ = serve_phase(cfg, parity, ref,
                                                  servers[parity])
                finally:
                    ref.close()
                for k, v in counts.items():
                    launches[k] += v
                lat_all["parity-bn" if parity else "running"] = \
                    lats[256, 256][0]
        except Exception:
            log.seek(0)
            sys.stderr.write(log.read().decode(errors="replace")[-8000:])
            raise
        finally:
            for proc, _ in servers.values():
                stop_server(proc)
    for k in ("bulge_stats", "bulge_main"):
        check(launches[k] > 0, f"kernel {k} was not launched on the served "
              f"path")
    for name, lat in lat_all.items():
        p50 = lat[len(lat) // 2]
        print(f"latency ({name}) LR 256x256 -> 512x512: p50 {p50:.2f} ms, "
              f"{0.512 * 0.512 / (p50 / 1e3):.2f} MP/s out, on {smi}; before "
              f"the tensor-core kernel: {EARLIER['gray3_p50_ms'][name]} ms",
              flush=True)

    del plain
    torch.cuda.empty_cache()

    stamp()
    # phases 5-8: the training path
    pre_err, pre_rows = preprocess_phase()
    state = step_phase(cfg)
    trainer_counts = trainer_phase(cfg)
    check(trainer_counts["preprocess"] > 0,
          "the preprocess kernel was not launched on the trained path")
    breakdown = step_breakdown(cfg, state, smi, benchmarks=(False,))
    x = torch.rand((100, 1, 32, 32), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(2))
    print(f"training G forward, batch 100 LR 32x32, unfused (ms): "
          + json.dumps(forward_breakdown(state.g, x, "pooled")), flush=True)
    print(f"train step, gray-3 full width, batch 100: "
          f"{breakdown[False]['step_ms']} ms, "
          f"{breakdown[False]['images_per_s']} images/s, peak "
          f"{breakdown[False]['peak_memory_GB']} GB, on {smi}", flush=True)

    del state
    torch.cuda.empty_cache()

    stamp()
    # phase 9: K3 against its plain version
    nhwc_err, nhwc_row = nhwc_phase()

    stamp()
    # phase 10: K2 at the overlap shapes
    ocfg = get_config("gray-patch-batch-overlap", env_override=False)
    ospec = generator_spec(ocfg)
    oparams, ostate = init_network(ospec, torch.Generator().manual_seed(0))
    with np.load(OVERLAP_FIXTURE) as data:
        oparams = load_branch(data, "params", oparams)
        ostate = load_branch(data, "state", ostate)
    o_err, o_rows = overlap_kernel_phase(oparams, ostate)
    errs["bulge_main"] = max(errs["bulge_main"], o_err[0])
    errs["bulge_stats"] = max(errs["bulge_stats"], o_err[1])

    stamp()
    # phase 11: bench_fused, each kernel in a process of its own (counts from 0)
    benches = bench_fused_phase()
    for k in launches:
        launches[k] += benches["bulge"][1][k]
    nhwc_launches = benches["nhwc"][1]

    stamp()
    # phase 12: the overlap pipeline in this process
    ofused = Network(ospec, oparams, ostate, device="cuda")
    oplain = Network(ospec, oparams, ostate, device="cuda", fuse=False)
    pipe_counts = overlap_phase(
        ocfg, ofused, oplain, smi,
        Network(ospec, oparams, ostate, device="cuda", bulge_impl="fma"),
        Network(ospec, oparams, ostate, device="cuda", bulge_impl="mma"))
    for k in launches:
        launches[k] += pipe_counts[k]
    # where the patch generator's time goes at the bulk batch, layer by layer
    tiles = torch.rand((14400, 1, ocfg.patchSize // 2, ocfg.patchSize // 2),
                       device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(7))
    for bn_stats, groups in (("running", None), ("pooled", 64)):
        print(f"patch generator forward, 14,400 tiles, {bn_stats} groups "
              f"{groups}, fused (ms) on {smi}: " + json.dumps(forward_breakdown(
                  ofused, tiles, bn_stats, iters=3, groups=groups)),
              flush=True)
    del ofused, tiles
    torch.cuda.empty_cache()

    stamp()
    # phase 13: the tiled server, counts from 0 in each server process
    tiled_launches = dict.fromkeys(K.launches, 0)
    with tempfile.TemporaryFile() as log:
        servers = {parity: start_server(ocfg, parity, log, OVERLAP_FIXTURE)
                   for parity in (True, False)}
        try:
            for parity in (True, False):
                ref = SRService(ocfg, oplain, max_batch=8, window_ms=0,
                                bn_eval=not parity, u8_io=True)
                try:
                    counts, lats, _ = serve_phase(
                        ocfg, parity, ref, servers[parity],
                        timed=((64, 64), (256, 256)),
                        flip_share=TILED_FLIP_SHARE)
                finally:
                    ref.close()
                check(counts["bulge_main"] > 0 and
                      (counts["bulge_stats"] > 0) == parity,
                      f"tiled server launched {counts}")
                for k, v in counts.items():
                    tiled_launches[k] += v
                for (h, w), (lat, batch) in lats.items():
                    p50 = lat[len(lat) // 2]
                    print(f"latency (tiled, {'parity-bn' if parity else 'running'}"
                          f") LR {h}x{w} -> {2 * h}x{2 * w}: client p50 "
                          f"{p50:.2f} ms, server batch median "
                          f"{batch[len(batch) // 2]:.2f} ms, "
                          f"{4 * h * w / 1e6 / (p50 / 1e3):.2f} MP/s out, on "
                          f"{smi}; before the tensor-core kernel: p50 "
                          f"{EARLIER['tiled_p50_ms'][parity, h]} ms",
                          flush=True)
        except Exception:
            log.seek(0)
            sys.stderr.write(log.read().decode(errors="replace")[-8000:])
            raise
        finally:
            for proc, _ in servers.values():
                stop_server(proc)
    for k in launches:
        launches[k] += tiled_launches[k]
    del oplain
    torch.cuda.empty_cache()
    tiled_upscale_phase()

    stamp()
    # phase 14: K2 in bf16 against its plain version, and its times
    bf16_err, bf16_rows = bf16_kernel_phase(*fixture_g, oparams, ostate)

    stamp()
    # phase 15: the bf16 training step at bench.py's geometry
    bf16_steps = bf16_step_phase(smi)

    stamp()
    # phase 16: the bf16 paths as users start them; counts from 0 here and
    # in each server process (read after its warmup)
    for k in K.launches:
        K.launches[k] = 0
    bf16_launches = bf16_serve_phase(smi)
    for k, v in bf16_bench_phase(smi).items():
        bf16_launches[k] += v
    for k in ("bulge_stats_bf16", "bulge_main_bf16"):
        check(bf16_launches[k] > 0, f"kernel {k} was not launched on the "
              f"bf16 paths")
        launches[k] += bf16_launches[k]

    stamp()
    # phases 17-19: image files (generated here from a seed), the trainers
    # on them and the eval protocol; counts from 0 before each trainer run
    # and before the eval on the card
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "folder")
        write_jpegs(os.path.join(folder, "faces"),
                    [f"{i:06d}.jpg" for i in range(1, 201)], seed=17)
        route = os.path.join(tmp, "indexed")
        write_jpegs(route, [f"{n:06d}.jpg" for n in
                            list(range(1, 301)) + list(range(200001, 200201))],
                    seed=18)
        folder_counts, folder_row = folder_trainer_phase(smi, folder)
        stamp()
        idx_counts, idx_loader = indexed_eval_phase(
            smi, route, os.path.join(tmp, "samples"))
    for k in ("bulge_stats", "bulge_main"):
        launches[k] += idx_counts[k]
    stamp()
    evals = eval_phase(smi)
    for k in ("bulge_stats", "bulge_main"):
        launches[k] += evals["launches"][k]
    eval_launches = {k: idx_counts[k] + evals["launches"][k]
                     for k in ("bulge_stats", "bulge_main")}

    stamp()
    # phase 21: K3 in bf16 against its plain version, its times, and
    # bench_fused --kernel nhwc (bf16 by default) in a process of its own
    k3b_err, k3b_row, k3b_launches = k3_bf16_phase(smi)

    stamp()
    # phase 22: the trainer's K-step chunk as one CUDA graph
    graph22 = graph_step_phase(smi)

    stamp()
    # phase 23: .t7 checkpoints on the served paths (counts from 0 in each
    # server process after its warmup, and before each upscale run)
    t7_launches = t7_phase(smi)
    for k, v in t7_launches.items():
        launches[k] += v

    stamp()
    # phase 24: the opt-in rewrites and the knob table; counts from 0 in
    # each run
    opt_launches = opt_in_phase(smi)
    for k in K.launches:
        launches[k] += opt_launches[k]

    stamp()
    # phase 25: data parallel; counts from 0 before each of its paths
    dp_launches = dp_phase(smi, graph22)
    for k in K.launches:
        launches[k] += dp_launches[k]

    stamp()
    # phase 26: the user tools; counts from 0 before each
    tool_launches = tools_phase(smi)
    for k in ("bulge_stats", "bulge_main"):
        launches[k] += sum(c[k] for c in tool_launches.values())

    stamp()
    # phase 27: the measurement entry points; counts from 0 before each
    measure_launches = measure_phase(smi, breakdown[False],
                                     bf16_steps["gray-3"]["profile"])
    for k in ("bulge_stats_bf16", "bulge_main_bf16"):
        launches[k] += sum(c[k] for c in measure_launches.values())

    stamp()
    # phase 28: the options never run on the card before; counts from 0
    # before each path
    option_launches = options_phase(smi)
    for k in ("bulge_stats", "bulge_main"):
        launches[k] += sum(c.get(k, 0) for c in option_launches.values())

    stamp()
    # phase 20
    eval_row = dict(rows)[EVAL_SHAPE]
    shape, r = rows[-1]
    kernels = []
    # K2 in fp32: the paths run the wgmma kernel (phases 4, 11, 12, 13 and
    # 19 hold every fp32 launch of theirs to it); the mma.sync and FMA
    # kernels' times in turns beside it
    for name, line, key, plain_key, lib_key in (
            ("bulge_stats", 159, "stats", "plain_stats_ms", "lib_stats_ms"),
            ("bulge_main", 206, "main", "plain_main_ms", "lib_main_ms")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dcgan_sr_tpu_torch/csrc/bulge_wgmma.cu",
            "replaces": f"dcgan_sr_tpu/ops/pallas_bulge.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": r[f"{key}_ms"], "plain_ms": r[plain_key],
            "bound_ms": r[f"{key}_bound"][0],
            "bound_by": r[f"{key}_bound"][1],
            "library_ms": r[lib_key], "shape": list(shape),
            "impl": r["impl"], "mma_ms": r[f"{key}_mma_ms"],
            "mma_source": "dcgan_sr_tpu_torch/csrc/bulge.cu",
            "fma_ms": r[f"{key}_fma_ms"],
            "bound_fp32_fma_ms": r[f"{key}_bound_fp32_fma"][0],
            "eval_launches": eval_launches[name],
            "tools_launches": {t: c[name] for t, c in tool_launches.items()
                               if c[name]},
            "options_launches": {t: c[name] for t, c in
                                 option_launches.items() if c.get(name)},
            "at_eval_shape": {
                "shape": list(EVAL_SHAPE), "ms": eval_row[f"{key}_ms"],
                "mma_ms": eval_row[f"{key}_mma_ms"],
                "bound_ms": eval_row[f"{key}_bound"][0],
                "bound_by": eval_row[f"{key}_bound"][1],
                "plain_ms": eval_row[plain_key],
                "library_ms": eval_row[lib_key]},
            "at_overlap_shapes": [
                {"shape": list(sh), "ms": ro[f"{key}_ms"],
                 "mma_ms": ro[f"{key}_mma_ms"],
                 "fma_ms": ro[f"{key}_fma_ms"],
                 "bound_ms": ro[f"{key}_bound"][0],
                 "bound_by": ro[f"{key}_bound"][1],
                 "bound_fp32_fma_ms": ro[f"{key}_bound_fp32_fma"][0],
                 "plain_ms": ro[f"plain_{key}_ms"],
                 "library_ms": ro[f"lib_{key}_ms"]} for sh, ro in o_rows]})
    # K2 in bf16: the paths run the wgmma kernel (phase 16 holds every bf16
    # launch of bench_infer, bench_fused and the bf16 servers to it); the
    # mma.sync kernel's times in turns beside it
    bshape, br = bf16_rows[-1]    # 64 images' overlap tiles, bf16
    for name, line, key in (("bulge_stats_bf16", 159, "stats"),
                            ("bulge_main_bf16", 206, "main")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dcgan_sr_tpu_torch/csrc/bulge_wgmma.cu",
            "replaces": f"dcgan_sr_tpu/ops/pallas_bulge.py:{line}",
            "launches": launches[name],
            "max_abs_err": bf16_err["wgmma"][name],
            "ms": br[f"{key}_ms"], "plain_ms": br[f"plain_{key}_ms"],
            "bound_ms": br[f"{key}_bound"][0],
            "bound_by": br[f"{key}_bound"][1],
            "library_ms": br[f"lib_{key}_ms"], "shape": list(bshape),
            "dtype": "bf16", "impl": br["impl"],
            "mma_ms": br[f"{key}_mma_ms"],
            "mma_source": "dcgan_sr_tpu_torch/csrc/bulge.cu",
            "mma_max_abs_err": bf16_err["mma"][name],
            "host_us_main": br["host_us_main"], "encode_us": br["encode_us"],
            "at_other_shapes": [
                {"shape": list(sh), "impl": ro["impl"], "ms": ro[f"{key}_ms"],
                 "mma_ms": ro[f"{key}_mma_ms"],
                 "wgmma_ms": ro[f"{key}_wgmma_ms"],
                 "bound_ms": ro[f"{key}_bound"][0],
                 "bound_by": ro[f"{key}_bound"][1],
                 "plain_ms": ro[f"plain_{key}_ms"],
                 "library_ms": ro[f"lib_{key}_ms"],
                 "host_us_main": ro["host_us_main"],
                 "encode_us": ro["encode_us"]}
                for sh, ro in bf16_rows[:-1]]})
    r = pre_rows[0]       # the trainer's own call: (100, 1, 64, 64), flags off
    kernels.append({
        "name": "preprocess", "route": "cuda",
        "source": "dcgan_sr_tpu_torch/csrc/preprocess.cu",
        "replaces": "dcgan_sr_tpu/ops/pallas_kernels.py:64",
        "launches": trainer_counts["preprocess"] + opt_launches["preprocess"]
        + dp_launches["preprocess"]
        + sum(c["preprocess"] for c in tool_launches.values())
        + sum(c["preprocess"] for c in measure_launches.values())
        + option_launches["cli --g-ema"]["preprocess"],
        "tools_launches": {t: c["preprocess"] for t, c in
                           {**tool_launches, **measure_launches,
                            "phase 24 (its CLI runs, profile_table)":
                            opt_launches,
                            "cli --g-ema": option_launches["cli --g-ema"]
                            }.items() if c["preprocess"]},
        "max_abs_err": pre_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": r["shape"], "eager_ms": r["eager_ms"],
        "host_queue_us": r["host_queue_us"],
        "library_graph_ms": r["library_graph_ms"],
        "library_host_queue_us": r["library_host_queue_us"]})
    # K1's raw-RGB modes, launched once a step by the folder trainers
    for r, mode, trainer in ((pre_rows[1], "rgb_to_gray+to_pm1",
                              "gray --device-augment"),
                             (pre_rows[2], "to_pm1",
                              "rgb-full --device-preprocess")):
        kernels.append({
            "name": f"preprocess[{mode}]", "route": "cuda",
            "source": "dcgan_sr_tpu_torch/csrc/preprocess.cu",
            "replaces": "dcgan_sr_tpu/ops/pallas_kernels.py:64",
            "launches": folder_counts[mode], "max_abs_err": pre_err,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            "eager_ms": r["eager_ms"], "host_queue_us": r["host_queue_us"],
            "library_graph_ms": r["library_graph_ms"],
            "library_host_queue_us": r["library_host_queue_us"],
            "path": f"folder trainer {trainer}",
            "crop_then_k1_vs_host_hook": folder_row["crop_check"]})
    # K3: bench_fused --kernel nhwc runs the wgmma kernel in both dtypes
    # (phases 11 and 21 hold every launch to it); the mma.sync (and in fp32
    # the FMA) kernel's times beside it
    for name, line, key in (("fused_nhwc_stats", 98, "stats"),
                            ("fused_nhwc_main", 119, "main")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dcgan_sr_tpu_torch/csrc/fused_nhwc_wgmma.cu",
            "replaces": f"dcgan_sr_tpu/ops/pallas_fused.py:{line}",
            "launches": nhwc_launches[name], "max_abs_err": nhwc_err[name],
            "ms": nhwc_row[f"{key}_ms"],
            "plain_ms": nhwc_row[f"plain_{key}_ms"],
            "bound_ms": nhwc_row[f"{key}_bound"][0],
            "bound_by": nhwc_row[f"{key}_bound"][1],
            "library_ms": nhwc_row[f"lib_{key}_ms"],
            "shape": nhwc_row["shape"], "impl": nhwc_row["impl"],
            "mma_ms": nhwc_row[f"{key}_mma_ms"],
            "mma_source": "dcgan_sr_tpu_torch/csrc/fused_nhwc.cu",
            "fma_ms": nhwc_row[f"{key}_fma_ms"],
            "bound_fp32_fma_ms": nhwc_row[f"{key}_bound_fp32_fma"][0],
            "K2_wgmma_ms": nhwc_row[f"K2_{key}_ms"],
            "pair_ms": nhwc_row["pair_ms"],
            "pair_mma_ms": nhwc_row["pair_mma_ms"],
            "pair_fma_ms": nhwc_row["pair_fma_ms"]})
    for name, line, key in (("fused_nhwc_stats_bf16", 98, "stats"),
                            ("fused_nhwc_main_bf16", 119, "main")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dcgan_sr_tpu_torch/csrc/fused_nhwc_wgmma.cu",
            "replaces": f"dcgan_sr_tpu/ops/pallas_fused.py:{line}",
            "launches": k3b_launches[name], "max_abs_err": k3b_err[name],
            "ms": k3b_row[f"{key}_ms"],
            "plain_ms": k3b_row[f"plain_{key}_ms"],
            "bound_ms": k3b_row[f"{key}_bound"][0],
            "bound_by": k3b_row[f"{key}_bound"][1],
            "library_ms": k3b_row[f"lib_{key}_ms"],
            "shape": k3b_row["shape"], "dtype": "bf16",
            "impl": k3b_row["impl"],
            "mma_ms": k3b_row[f"{key}_mma_ms"],
            "mma_source": "dcgan_sr_tpu_torch/csrc/fused_nhwc.cu",
            "pair_ms": k3b_row["pair_ms"],
            "pair_mma_ms": k3b_row["pair_mma_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
