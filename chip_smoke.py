"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line per result (any failure exits
non-zero):

  1. device    -- a CUDA card must be present; TF32 is switched off so fp32
                  matmuls are full fp32.
  2. build     -- nvcc builds every kernel of the paths from ``csrc/``.
  3. kernel    -- ``adamw_store_update``'s flat epilogue against its plain
                  PyTorch version on the card at the fp32 train step's group
                  shapes (layers (4, 77865984), globals (589826304,)) and a
                  ragged length, fp32 and bf16 epilogues: integer-view
                  difference (expected 0, the kernel is bitwise), CUDA-event
                  times (median of 20 after warm-up) and the memory bound.
  4. kernel_q8 -- the block-wise INT8 kernels (quantize, dequantize_into,
                  encode_ef, the q8 epilogue of adamw_store_update) against
                  their plain versions at the q8 plan's shard shapes (layers
                  (77869056,) per layer, globals (589826048 + 1024,)) and a
                  block-64 case, fp32 and bf16 where a kernel takes both:
                  integer-view difference (expected 0), median times, bound.
                  ``quantize`` (fp32) and ``dequantize_into`` (bf16 out)
                  also at the shapes the main path (18) gives them:
                  qwen2.5-14b's q8_block shards, (2, 275268608) per rebuild
                  of the layers and (1557140480,) of ``globals``.
  5. kernel_adam8 -- the fused 8-bit Adam kernel (``adam8bit_store_update``:
                  fp32 and bf16 epilogues, and the q8_block epilogue)
                  against its plain version at qwen3-moe's ``layers`` shard
                  (1, 71835648), the first 536870912 elements of its
                  ``layers_experts`` shard, the reduced config's block-64
                  shard (2, 1572864), a misaligned view, and (q8_block) the
                  gemma2-2b adam8bit q8 plan's shards: integer-view
                  difference (expected 0), median times, bound; then the
                  kernel alone at the full ``layers_experts`` and
                  ``globals`` shards, where the plain version does not fit,
                  on the fp32 store and on the bf16 store (bf16 w and g).
  6. train     -- the fp32 path: gemma2-2b at published width cut to 4
                  layers (two local/global pairs), ZeRO-3 train step through
                  a one-rank NCCL group, bf16 compute, fp32 store, AdamW,
                  batch 2 x 2048 tokens; one warm-up step and three timed
                  steps.  The flat kernel must launch once per group per
                  step (8 times).
  6b. train_cli -- the training command: ``python -m
                  repro_torch.launch.train --arch gemma2-2b --full --steps 4
                  --batch 8 --seq 128 --log-every 1 --verify`` through
                  ``launch.train.main`` in this process (on its NCCL rank;
                  ``--verify`` proves the plan's invariants on a meta twin
                  in a child process that sees no card, so the launch
                  counts below also show that verifying launched nothing):
                  published width and all 26 layers, bf16 compute, AdamW
                  on the fp32 store.  Finite losses and grad norms, the
                  flat ``adamw_store_update`` once per group per step and
                  no other kernel, no plain version called (each of
                  ``kernels.ops``' plain versions counted); printed: step
                  ms (median of steps 1-3), tokens/s, set-up seconds,
                  ``max_memory_allocated`` and the verification's seconds
                  on a line of their own.
  7. train_q8  -- the q8 path: the same model and batch with the q8_block
                  store and the q8 gradient wire with error feedback on both
                  groups (``q8_both_wires``).  Every q8 kernel must launch as
                  often as the gathers, reduce-scatters and groups imply.
  8. train_moe -- the 8-bit Adam path: qwen3-moe-235b-a22b at published
                  width (d_model 4096, 64/4 heads, 128 experts top-8, d_ff
                  1536, vocab 151936) cut to 1 layer, ep=1, one NCCL rank,
                  bf16 compute, fp32 store, Adam8bit, batch 1 x 2048; one
                  warm-up and three timed steps.  The shards must be the
                  plan's, the 8-bit Adam kernel must launch once per group
                  per step and no other kernel at all.
  9. train_adam8_q8 -- gemma2-2b as in ``train`` with Adam8bit on the
                  q8_block store: the q8 epilogue once per group per step,
                  quantize at init, dequantize_into once per gather.
 10. parity    -- gemma2-2b.reduced() (fp32 store and ``q8_both_wires``) and
                  qwen3-moe-235b-a22b.reduced() (``parity_moe``: Adam8bit on
                  the fp32 and q8_block stores), fp32 compute, two steps
                  from the same init and batches of each of four seeds on
                  the CPU (plain versions) and on the card (kernels):
                  losses and grad norms must agree within PARITY_RTOL
                  (PARITY_Q8_RTOL on a q8_block store).  The fp32-store
                  case runs each device twice: both must repeat bitwise
                  (a CPU reference whose sum order varies from run to run
                  moves the readings past their limits).  The CPU runs are
                  pinned before torch loads (``launch.repeatability.
                  pin_cpu``: MKL's conditional numerical reproducibility
                  ``MKL_CBWR=AUTO,STRICT``, no dynamic threading, 8 MKL and
                  OpenMP threads); the ``device`` line prints the pins.
 11. kernel_q8mm -- the int8 x int8 ``q8_matmul`` against its plain version,
                  bf16 x and out and fp32 x and out, at decode M = 4 (the
                  one-launch regime; and M = 1, the ``long_500k`` decode's
                  batch, on gemma2-2b's three shapes) and prefill M = 2048
                  (row quantization + ``wgmma`` GEMM): gemma2-2b's case-A
                  weights (2304,
                  2048), (2304, 1024), (2304, 9216), qwen3-moe's case-B
                  (4096, 512) and (4096, 128), and a case-B shape with a
                  trailing partial block (1001, 512): integer-view
                  difference (expected 0), median device times of kernel
                  and plain version as replays of a CUDA graph of 20 calls
                  (and the eager call's time, host launch path included),
                  bound (int8 operations or bytes), the relative L2 against
                  the dense x @ dequantize(w) and, at prefill,
                  ``torch._int_mm`` on the same int8 operands; then the
                  crossover: both regimes forced at M = 8, 16 (decode's
                  limit), 17 and 32 on gemma2-2b's shapes, each bitwise.
 11b. kernel_q8mm_sliced -- ``q8_matmul`` on ``q8_slice_cols`` slices:
                  each of the four KV heads (256 columns) of a gemma2-2b
                  wk-shaped (2304, 1024) weight at block 1024 (case B: the
                  slice's scales per row), at M = 4 and 2048, bf16, bitwise
                  against the plain version; the slice copy's time, and
                  the kernel on an unsliced (2304, 256) weight, beside it.
 12. serve     -- the serve path: gemma2-2b at published width, 4 layers, one
                  NCCL rank, bf16 compute, q8_block store with
                  ``serve_quant_matmul``: prefill of 4 x 512 prompt tokens
                  into a 1024-slot cache (after one warm-up prefill), 32
                  greedy decode steps, then the
                  ``ServeEngine`` (pool 4, 8 requests of 8-64 prompt tokens,
                  16 new tokens each); then the same through the
                  dense-dequant q8 serve on the same parameters.  Launch
                  counts must match the plan (``q8_matmul`` once per eligible
                  weight per layer and call -- the two prefills in its
                  prefill regime, every decode and engine call in its
                  decode regime -- ``dequantize_into`` per ineligible one and
                  per ``globals`` gather).
 13. parity_serve -- gemma2-2b.reduced() and qwen3-moe-235b-a22b.reduced(),
                  fp32 compute, fp32 store and q8_block with
                  ``serve_quant_matmul``: prefill and 8 teacher-forced decode
                  steps for each of four seeds on the CPU and on the card;
                  the logits' relative L2 within PARITY_SERVE_RTOL.

The long_500k decode (slice 18; 12b and 12c after 12, 13b in a child of
its own beside the reference phases' child):

 12b. long500k_gemma2 -- gemma2-2b at published width and depth (26
                  layers) served int8 from the q8_block store
                  (``serve_quant_matmul``), bf16 compute, batch 1, its
                  host masters drawn beside the reference phases' child:
                  ``quantize`` once a group, an empty ``init_cache(1,
                  524_288)`` (every layer a 4,096-slot ring, the
                  sliding-window variant; its bytes against ``launch/
                  serve.py --cache-bytes``), then LONG_STEPS greedy decode
                  steps at indices 524,160 ... 524,287, no prefill: each
                  step's ms, the median of the last LONG_TIMED and its
                  tokens/s, set-up s; ``q8_matmul`` once per eligible
                  weight per layer and step, in its decode regime,
                  ``dequantize_into`` per other tensor and per ``globals``
                  gather, no plain version; finite logits; the ring's
                  positions the indices decoded; the decode's own peak
                  within LONG_PEAK_RTOL of its dry run's (a ``--dry-step``
                  child started after phase 2).
 12c. long500k_hymba -- hymba-1.5b at published width and depth (32
                  layers, a 1,024-slot ring on every layer beside the
                  Mamba state), the same steps and readings in the
                  q8_block store's dense-dequant serve (Hymba's block
                  multiplies its weights directly): ``dequantize_into``
                  once per layer and ``globals`` gather a step.
 13b. parity_long500k -- ``rope_freqs`` of every (rope_theta, hd) of the
                  configs on the card bitwise the CPU's; then 12b and 12c
                  cut to LONG_PARITY_LAYERS layers at published width,
                  fp32 compute, the same host masters on the CPU and the
                  card, LONG_PARITY_STEPS teacher-forced decode steps
                  ending at index 524,287 from an empty cache: each call's
                  logits within LONG_PARITY_RTOL relative L2.

The bf16 and fp8 stores and the standalone updates (14 runs after 5, 16
and 15 after 9, 17 with 10):

 14. kernel_fp8 -- the fp8 epilogues of both fused updates (both formats),
                  the standalone ``adamw_update`` and ``adam8bit_update``,
                  and the bf16 store's passes (bf16 w and g, the gradient
                  scale applied in the update) against their plain versions
                  at gemma2-2b's fp32-plan shards (layers (4, 77865984),
                  globals (589826304,)), the adam8bit plan's aligned shards
                  and a ragged / misaligned case: integer-view difference
                  (expected 0, fp8 codes as bytes), median times, bound;
                  then a boundary tensor (448, 463.99, 464.0, 464.0001, 480,
                  1e4, 57344, 61439, 61440, inf, NaN and fp8 subnormals in
                  both signs) through both fp8 epilogues, whose codes must
                  be the reference's rule's, NaN codes included.
 15. standalone -- the two standalone updates driven as a user of
                  ``ops.adamw_update`` / ``ops.adam8bit_update`` drives
                  them: four in-place steps on each gemma2-2b group's flat
                  shard; each launches once per group and step.
 16. train_fp8, train_fp8_adam8, train_bf16 -- gemma2-2b as in ``train``
                  on ``param_store="fp8_e4m3"`` with AdamW, on
                  ``"fp8_e5m2"`` with Adam8bit, and on ``"bf16"`` with
                  AdamW: the store's fused epilogue once per group and
                  step, no q8 kernel at all.
 17. parity_fp8 -- gemma2-2b.reduced(), fp32 compute, two steps of each of
                  four seeds on the CPU and on the card for fp8_e4m3 /
                  AdamW, fp8_e5m2 / Adam8bit and bf16 / AdamW: losses and
                  grad norms within PARITY_FP8_RTOL, and on each device the
                  fp8 codes bitwise the encode of the master.

The non-element-wise optimizers (18 and 19 run after 15, 20 after 17):

 18. train_muon_q8 -- the slice's main path: qwen2.5-14b at published
                  width (d_model 5120, 40/8 heads, head_dim 128, d_ff
                  13824, vocab 152064, untied head, qkv bias) cut to 2
                  layers, one NCCL rank, bf16 compute, q8_block store,
                  Muon, batch 1 x 2048; one warm-up and three timed steps,
                  each with the optimizer update's own ms (synchronised
                  around ``optimizer.update``).  ``quantize`` must launch
                  once per group at init and once per group and step (the
                  store's rebuild), ``dequantize_into`` once per gather,
                  nothing else.
 19. train_shampoo -- the same width at 1 layer, fp32 store, Shampoo, two
                  steps (the per-step eigendecompositions are the
                  reference's design; the masters are 18's host copies,
                  the first layer's row repacked for the fp32 store's
                  plan, not drawn again), then ``torch.linalg.eigh`` of the
                  largest factor (13824^2) and of a 5120^2 one timed with
                  CUDA events; no kernel of the port may launch.
 20. parity_optim -- qwen2.5-14b.reduced(), fp32 compute, learning rate
                  1e-2: three steps of SGD, Muon and Shampoo on the fp32
                  store and of Muon on the q8_block store (the main path's
                  update, rebuild and kernels together) on the CPU and on
                  the card, each device twice (it must repeat bitwise);
                  loss and grad-norm streams within PARITY_OPTIM_RTOL, the
                  final masters within PARITY_OPTIM_MASTER, and on each
                  device the q8 codes and scales bitwise the plain
                  quantization of the final master.

The plan and the schedule (21 and 22 run after 7, on ``train``'s host
init, repacked where a layout differs, so no variant draws the 901 M
numbers again):

 21. train_sched -- gemma2-2b as in ``train`` (AdamW) under ``prefetch``,
                  ``no_reshard``, ``keep_last``, ``overlap_all``,
                  ``ring_overlap`` and an unsharded ``globals``, then the
                  fsdp2 planner (its default and ``ring_overlap``), then
                  the q8_block store's default and ``q8_ring_prefetch``,
                  four steps each: each stream must equal its default's
                  bitwise (``train``'s, the fsdp2 default's, the q8_block
                  store's); the fsdp2 default's relative difference from
                  ``train`` is printed.  Per run: step ms, peak memory, the
                  measured gathered-buffer peak (``GatheredMeter``) against
                  ``gathered_peak_bytes`` (never above it), the layer
                  gathers against the schedule's, and the kernels against
                  the plan.  One rank: the ring hops number zero (the ring
                  routes across ranks run on gloo, in the CPU tests).
 22. train_ce_chunk -- ``train`` with ``ce_chunk=8192`` (32 chunks, the
                  last padded by 6144): loss and grad norm within
                  CE_CHUNK_RTOL of ``train``'s, peak memory below it, step
                  ms beside it.

The plan's life cycle (23 and 24 run after 22, on ``train``'s host init):

 23. auto_plan -- ``launch.bench_comm`` times the port's gathers and
                  reduce-scatters (xla, ring, ring_acc; fp32, bf16,
                  q8_block) at 2^20 and 2^24 elements on the one NCCL rank
                  into a temporary profile; ``CostModel.from_profile``
                  prices ``policies="auto"`` for gemma2-2b as in ``train``
                  (``prefetch`` and ``keep_last_gathered``: 4 layers).  Its
                  run must equal bitwise a run of the same decisions given
                  as explicit rules; the builtin roofline's auto plan (one
                  rank: fp32 and the cast wire everywhere) must equal
                  ``train``'s stream bitwise; each run launches the
                  kernels its plan implies.  Printed: the
                  profile's name, hash and fitted curves, ``describe()``
                  with its ``auto_ms``/``builtin_ms`` columns, and (host
                  only) the builtin roofline's decisions under
                  ``launch.mesh``'s H100 constants for every registered
                  config at 8 and 64 ranks.
 7b. train_micro -- ``train_q8`` with gradient accumulation: the same
                  model, batch and host init in 2 microbatches of 1 x 2048,
                  whose q8 gradient wire defers its error feedback to the
                  accumulation boundary.  The loss and grad norm streams
                  must follow ``train_q8``'s within TRAIN_MICRO_LOSS_RTOL
                  and TRAIN_MICRO_GNORM_RTOL, and the final masters lie
                  within TRAIN_MICRO_MASTER_RTOL of ``train_q8``'s, relative
                  to ``train_q8``'s whole update; ``encode_ef``
                  must launch once per group-layer per step (5, as in
                  ``train_q8``: never once per microbatch) and
                  ``dequantize_into`` once per gather of each microbatch.
                  Printed beside ``train_q8``'s: step ms, tokens/s, peak.
 10b. parity_micro -- the ``parity_q8`` case (gemma2-2b.reduced(),
                  ``q8_both_wires``, fp32 compute, two steps of 8 x 64 per
                  seed) at 2 microbatches, card against CPU within
                  PARITY_Q8_RTOL.
 24. ckpt      -- gemma2-2b at published width cut to 2 layers, fp32
                  store, AdamW, batch 2 x 2048: two steps, ``ckpt.save``
                  (8.95 GB of master and moments) into a temporary
                  directory, two more; a fresh runtime loads it and runs the
                  same two steps, whose losses, grad norms and final master
                  must be bitwise the uninterrupted run's.  The checkpoint
                  loads into a ``q8_both_wires`` runtime (the master exact
                  tensor by tensor, codes and scales bitwise
                  ``ops.quantize`` of it, the residual zero, ``quantize``
                  once per group, one finite step with the q8 path's
                  launches), and ``python -m repro_torch.tools.reshard
                  --planner fsdp2 --drop-opt`` rewrites it for the fsdp2
                  planner, which loads bitwise on the master.  Printed:
                  save and load seconds and GB/s beside one ``np.save`` of a
                  contiguous buffer of the same bytes to the same disk.
                  The free disk is checked first; the directory is removed
                  when the phase ends.
 24b. ckpt_tp  -- the checkpoint across TP degrees: ``python -m
                  repro_torch.tools.reshard`` rewrites phase 24's tp-1
                  checkpoint for ``--model 8 --tp 8`` (wk and wv move into
                  ``layers_rep``) and back to tp 1, whose master and moment
                  files must be the original's byte for byte (by leaf
                  path); the tp-8 checkpoint then loads straight onto the
                  one-rank tp-1 runtime (the cross-TP streaming path) and
                  two steps resume: the stream and the final master bitwise
                  phase 24's uninterrupted run, ``adamw_store_update`` 4
                  launches and no other kernel.  Printed: each tool run's,
                  the comparison's and the load's seconds.

The dry run, the roofline and the examples (slice 13; 6c, 6d and 25 after
8, 26 after 13):

 6c. dryrun_vs_card -- ``python -m repro_torch.launch.dryrun`` of
                  ``train``'s configuration (``--mesh 1x1 --layers 4
                  --batch 2 --seq 2048``) and of ``train_cli``'s
                  (``--mesh 1x1 --batch 8 --seq 128``): one step of rank 0
                  on meta tensors over a fake process group, each in a
                  child process (started with the others after phase 2,
                  beside the card's phases; none touches the card).  Printed: the
                  predicted peak (argument bytes + the step's own), the
                  matmul FLOPs, the bytes, the collectives and the kernel
                  calls; the predicted peak must lie within
                  DRYRUN_PEAK_RTOL of the ``max_memory_allocated`` that
                  ``train`` and ``train_cli`` measured, and each step call
                  ``adamw_store_update`` once a group.
 6d. mfu       -- model FLOPs (``launch.roofline.model_flops``: 6 N_active
                  tokens) over the step's median seconds times the card's
                  dense bf16 peak (``launch.mesh.PEAK_FLOPS_BF16``), for
                  ``train`` and ``train_cli``, beside the card's name and
                  power limit.
 25. dryrun_production -- the dry-run rows of gemma2-2b, xlstm-125m,
                  hymba-1.5b, seamless-m4t-medium and llama-3.2-vision-90b
                  ``train_4k`` at 16 x 16 = 256 ranks and
                  qwen3-moe-235b-a22b ``train_4k`` at 2 x 16 x 16 = 512
                  (``--multi-pod``; all the dry runs are children started
                  after phase 2, beside the card's phases), each with
                  ``--verify`` (the plan's invariants proved against the
                  same meta step): ``ok``, and their
                  ``model_gflops``, ``gather_wire_mb`` and
                  ``reduce_wire_mb`` equal to the roofline's model FLOPs
                  and the plan's wire bytes; ``--plan-only --all``: the
                  lowering parity line for each of the ten assigned
                  archs, no error line.
 26. examples  -- ``python -m repro_torch.examples.<name>`` for the five
                  examples (quickstart, train_8bit_adam, muon_demo,
                  serve_moe, continuous_batching) through ``main([])`` on
                  the card at their defaults (bf16 compute, the reference's
                  steps): their own checks, ``adamw_store_update`` and
                  ``adam8bit_store_update`` once a group and step of the
                  AdamW and 8-bit Adam runs and no other kernel, no plain
                  version called.  Then ``examples_parity``: each again
                  at fp32 compute over EXAMPLE_PARITY_STEPS on the card and
                  on the CPU: loss (and quickstart's grad-norm) streams
                  within PARITY_RTOL (the fp32 parity phases' limit; Muon
                  at the example's lr 3e-3 read 7.0e-7, above
                  ``parity_optim``'s own 6e-7 at lr 1e-2), the served
                  tokens equal.

The recurrent families (slice 14; 27-30 after 13):

 27. train_xlstm -- xlstm-125m at published width and depth (12 layers:
                  2 super-blocks of 5 mLSTM cells and an sLSTM cell,
                  d_model 768, 4 heads, vocab 50304), one NCCL rank, bf16
                  compute, fp32 store, AdamW, batch 2 x 2048: one warm-up,
                  three timed steps and one more whose CUDA ops are
                  counted (``count_cuda_ops``: the sLSTM's loop over the
                  2,048 positions launches most of them).  Step ms,
                  tokens/s, MFU, peak; ``adamw_store_update`` once a group
                  a step and no other kernel, no plain version; then row
                  8a against its plain version at this path's two shards
                  (``kernel_recurrent``).
 28. train_hymba -- hymba-1.5b at published width (d_model 1600, 25/5
                  heads, d_ff 5504, ssm_state 16, vocab 32001) cut to 4
                  layers (layers 0, 2, 3 global, layer 1 windowed at
                  1,024, which the 2,048-token rows reach past), the same
                  run and readings.
 29. serve_recurrent -- each of 27's and 28's trained models on its
                  runtime: a prefill of 2 x 2048 into a fresh cache
                  (after a warm-up prefill: a prefill continues from the
                  cache's recurrent state), 32 greedy decode steps (ms
                  each, tokens/s), then the ``ServeEngine`` on the serve
                  phase's 8 request lengths in a pool of 4 (16 new tokens
                  each; tokens/s), every admission audited: the row of a
                  reused slot differs from the empty cache before its
                  reset (4 of 8) and equals it after (8 of 8).  No
                  kernel of the port, no plain version (the fp32 store).
 30. parity_recurrent -- xlstm-125m.reduced() and hymba-1.5b.reduced() at
                  4 layers, fp32 compute: two train steps of 8 x 64 of
                  each seed of PARITY_REC_SEEDS on the CPU and on the
                  card (losses and grad norms within PARITY_REC_RTOL),
                  and a prefill of 4 x 16 with 8 teacher-forced decode
                  steps (each call's logits within PARITY_REC_SERVE_RTOL
                  relative L2).

The cross-attention families (slice 15; 31-33 after 29, 35 with 30):

 31. train_encdec -- seamless-m4t-medium at published width and depth (12
                  encoder and 12 decoder layers, d_model 1024, 16 heads x
                  64, d_ff 4096, vocab 256206; 978.8 M parameters), one
                  NCCL rank, bf16 compute, fp32 store, AdamW, 2 x 2048
                  tokens with 2,048 frames: a warm-up, three timed steps
                  and one whose CUDA ops are counted.  Step ms, tokens/s,
                  MFU, peak; ``adamw_store_update`` once a group a step
                  (three groups: the two stacks and ``globals``) and no
                  other kernel, no plain version; row 8a against its plain
                  version at its three shards (``kernel_crossattn``).
 32. serve_encdec -- the trained model: a prefill of 4 x 512 tokens over
                  the config's 4,096 frames (the encoder's output written
                  into the cache's bf16 memory), after a warm-up prefill,
                  then 32 greedy decode steps (each layer's cross K/V
                  recomputed from the memory).  No kernel of the port.
 33. serve_vision -- llama-3.2-vision-90b at published width (d_model
                  8192, 64/8 heads x 128, d_ff 28672, vocab 128256) cut
                  to one block (four self layers and a cross layer, 6.38
                  G parameters), its gates at VISION_GATE, on the q8_block
                  store (``quantize`` once a group at init): a prefill of
                  4 x 512 tokens with 1,024 patches and 32 decode steps,
                  each given the patches, in the int8 mode and the dense
                  q8 mode on the same parameters; launch counts against
                  the plan, ``q8_matmul`` by regime (a decode call's
                  x_wk and x_wv over the 4,096 patch rows in the prefill
                  regime), the int8-vs-dense prefill logits within
                  SERVE_INT8_VS_DENSE.  First rows 5a and 5b at the
                  vision shapes (``kernel_q8mm_vision``: decode M = 4 and
                  prefill M = 2048 on (8192, 8192), (8192, 1024), (8192,
                  28672), (28672, 8192), and M = 4096 on (8192, 1024)),
                  rows 1 and 2 at its two shards (``kernel_q8_vision``;
                  the plain version in chunks), each bitwise.
     (Training the same cut, Adam8bit on the bf16 store at 1 x 1024
     tokens, peaked at 79.0 GB of the card's 85.0: no phase trains it;
     PERF.md PR 25.)
 35. parity_crossattn -- seamless-m4t-medium.reduced() and
                  llama-3.2-vision-90b.reduced() (gates at VISION_GATE),
                  fp32: five train steps of 8 x 64 per seed of
                  PARITY_CROSS_SEEDS on the CPU and on the card (losses and
                  grad norms within PARITY_CROSS_RTOL) and a prefill of 4 x
                  16 with 8 teacher-forced decode steps (each call's logits
                  within PARITY_CROSS_SERVE_RTOL relative L2).

The configurations first run on the card (slice 17; 36-41 after 33, each
train phase's dry run a child started with the others after phase 2, the
host masters of 38-40 drawn beside the reference phases' child process
and awaited before phase 11, so that no timed phase shares the host with
the draw; ``--only PHASE[,PHASE...]`` runs the named ones of 36-41 and of
12b and 12c (with 13b) alone, after phases 1 and 2):

 36. train_granite -- granite-moe-1b-a400m at published width cut to 12
                  of its 24 layers (d_model 1024, 16/8 heads x 64, 32
                  experts top-8, d_ff 512, vocab 49155; 0.74 G of its
                  1.38 G parameters), AdamW
                  on the fp32 store, 2 x 2048.  Like each of 36-40: one
                  NCCL rank, tp 1, ep 1, bf16 compute, a warm-up and three
                  timed steps through ``train``; a ``_setup`` line whose
                  ``cut`` lists every departure from the published config
                  (depth, ep, store, optimizer, batch), a line a step,
                  a ``_summary`` line (shard sizes, set-up s, median step
                  ms, tokens/s, MFU, ``max_memory_allocated``, launches
                  against the expected, the first loss the init implies:
                  ``expected_first_loss``); finite losses and grad norms,
                  the update kernel once per group per step and nothing
                  else, no plain version, the first loss within 1.0, the
                  peak under PUBLISHED_PEAK_LIMIT; the dry run's predicted
                  peak within DRYRUN_PEAK_RTOL of the phase's own peak and
                  its kernel calls the phase's update kernel once a group
                  (a ``dryrun_vs_card`` row; a predicted peak above the
                  limit halves the batch first, said in ``cut``); then the
                  update kernel against its plain version at the phase's
                  shards (``kernel_published``; the plain version in
                  chunks of COMPARE_CHUNK).
 37. serve_granite -- the same model and depth, served from the
                  q8_block store with ``serve_quant_matmul`` on 36's
                  initial masters (host copies, repacked for the q8 plan):
                  ``quantize`` once a group at init, then as ``serve``: a
                  prefill of 4 x 512, 32 decode steps, the engine;
                  ``q8_matmul`` once per eligible weight (wq, wk, wv, wo,
                  the (1024, 32) router) per layer and call, by regime,
                  ``dequantize_into`` per other tensor of a layer and per
                  ``globals`` gather.
 38. train_qwen32b -- qwen1.5-32b (d_model 5120, 40/40 heads x 128 with
                  qkv bias, d_ff 27392, vocab 152064) cut to 1 layer, AdamW
                  on the fp32 store, 1 x 2048 (2.08 G parameters).
 39. train_llama70b -- llama3-70b (d_model 8192, 64/8 heads x 128, d_ff
                  28672, vocab 128256) cut to 1 layer, AdamW on the bf16
                  store (the fp32 store's state does not fit one card),
                  1 x 2048 (2.96 G parameters).
 40. train_gptoss -- gpt-oss-120b (d_model 2880, 64/8 heads x 64, 128
                  experts top-4, d_ff 2880, vocab 201088) cut to 1 layer,
                  ep 16 -> 1, Adam8bit on the bf16 store (AdamW's state
                  does not fit one card on any store), 1 x 2048 (4.37 G
                  parameters).
 41. kernel_q8mm_nemotron -- nemotron-4-340b, whose one layer with its
                  embedding and head (12.89 G parameters) trains on no
                  single card: ``q8_matmul`` at its layer's weights (wq and
                  wo (18432, 18432), up (18432, 73728), down (73728,
                  18432): K = 73,728) at decode M = 4 and prefill M = 2048,
                  bitwise against the plain version (in rows where its
                  temporaries would not fit); wk and wv (18432, 1536),
                  which no scale layout fits at block 1024, refused alike
                  by both, and ``dequantize_into`` held there instead.

The phases that hold the card against the CPU reference (10, 17, 20, 13,
30, 26's ``examples_parity`` and 35, in that order) run where phase 10 stands,
in a child process of their own: this script with ``--reference``, the
same pins and card and nothing else of the run before it (13b beside it,
in a second: ``--reference-long500k``).  Its lines join
the output as they come, its failure fails the script, and a ``reference``
line gives its seconds.  A CPU reference must not depend on what its
process did before; in this process, after the full-width phases, its
first run has been seen, rarely, to give a stream no fresh process gives.

Then the script's seconds so far, the ``kernels`` line, a ``verify`` line
(per verified run -- ``train_cli`` and each production dry run -- the
invariants checked, errors, warnings and seconds; any error, or a run
that checked nothing, fails the script), the card's name and power limit
as nvidia-smi reports them, and a last line ``{"ok":
true, "device": {...}}``.  The
script imports only the port (never JAX or the JAX package).
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA's H100 SXM data sheet: HBM3 at 3.35 TB/s; fp32 outside the
# tensor cores 67 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
LAYERS_SHAPE = (4, 77_865_984)
GLOBALS_SHAPE = (589_826_304,)
RAGGED_SHAPE = (1_000_003,)
# bytes per element: w, g, m, v, mask read (20 B); w' (4 or 2 B), m', v' out
BYTES_PER_ELEM = {"fp32": 32, "bf16": 30}
# fp32 operations per element of the AdamW chain (kernels/ref.py)
FLOPS_PER_ELEM = 16
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = 4, 2, 2048
# train_micro: microbatches of train_q8's batch, and the bounds on its
# streams and final masters against train_q8's, each between the readings
# of a sound accumulation and of planted faults (one microbatch trains; the
# state never changes) that tests/test_torch_micro_bounds.py takes on the
# CPU at gemma2-2b.reduced() and checks against these limits: loss 1.3e-4
# sound, 1.3e-3 still; grad norm 6.7e-4 sound, 0.38 half; masters
# ||W_micro - W_q8|| / ||W_q8 - W_init|| 0.018 sound, 0.70 half, 1.0 still
TRAIN_MICRO = 2
TRAIN_MICRO_LOSS_RTOL = 4e-4
TRAIN_MICRO_GNORM_RTOL = 3e-2
TRAIN_MICRO_MASTER_RTOL = 0.2
TIMED_STEPS = 3
# train_cli: ``python -m repro_torch.launch.train`` at published width and
# depth (26 layers), AdamW on the fp32 store
CLI_STEPS, CLI_BATCH, CLI_SEQ = 4, 8, 128
# card vs CPU, two fp32 steps of a reduced config from each of
# PARITY_SEEDS: limits about four times the largest relative difference of
# loss and grad norm measured over these seeds on the card (readings in
# PERF.md): 6.9e-7 on the fp32 store, 1.7e-6 on the q8_block store
PARITY_SEEDS = (0, 1, 2, 3)
PARITY_RTOL = 3e-6
PARITY_Q8_RTOL = 7e-6
Q8_SCHEDULE = {"param_store": "q8_block", "reduce_wire": "q8_block"}
Q8_ITERS = 10
# fp32 operations per element (beside the bytes they are far from binding)
Q8_FLOPS = {"quantize": 6, "dequantize_into": 1, "dequantize": 1,
            "encode_ef": 9, "adamw_q8": FLOPS_PER_ELEM + 6}
# 8-bit Adam: bytes per element (w, g, m8, v8 in; w', m8', v8' out, plus
# the q8 code of w'), per quant block (ms, vs in and out, plus the weight
# scale) and, once per call, the (S,) uint8 decay row every row shares;
# fp32 operations per element (the AdamW chain, two decodes, two
# requantizes, one expf and one logf)
ADAM8_BYTES = {"fp32": 16, "bf16": 12, "q8_block": 17}
ADAM8_BLOCK_BYTES = {"fp32": 16, "bf16": 16, "q8_block": 20}
ADAM8_FLOPS = {"fp32": 40, "bf16": 40, "q8_block": 46}
MOE = "qwen3-moe-235b-a22b"
MOE_LAYERS, MOE_BATCH, MOE_SEQ = 1, 1, 2048
MOE_SHARDS = {"layers": 71_835_648, "layers_experts": 2_415_919_104,
              "globals": 1_244_663_808}
MOE_SLICE = 536_870_912   # the part of the layers_experts shard compared
ADAM8_Q8_SCHEDULE = {"param_store": "q8_block"}
# NVIDIA's H100 SXM data sheet: dense int8 tensor cores at 1,979 TOP/s
INT8_OPS = 1979e12
Q8MM_M = (4, 2048)            # decode batch, prefill tokens (4 x 512)
# the long_500k decode's batch: q8_matmul at M = 1, through the decode
# kernel's MMAX = 4 instantiation with three rows masked; held on one
# gemma2-2b layer's shapes (GEMMA_LAYER_Q8MM)
Q8MM_LONG_M = 1
# M either side of the decode / prefill crossover (q8_matmul.DECODE_MAX_M
# = 16), both regimes timed where the decode kernel takes M
Q8MM_CROSSOVER_M = (8, 16, 17, 32)
# (K, N) of q8_matmul calls: gemma2-2b's wq, wk/wv, w1/w3 (case A at block
# 1024), qwen3-moe's wk/wv and router (case B), a trailing partial block
Q8MM_SHAPES = ((2304, 2048), (2304, 1024), (2304, 9216), (4096, 512),
               (4096, 128), (1001, 512))
# eligible weights of one gemma2-2b layer: shape -> calls per layer
GEMMA_LAYER_Q8MM = {(2304, 2048): 1, (2304, 1024): 2, (2304, 9216): 2}
# the sliced case: gemma2-2b's wk-shaped (2304, 1024) weight at block 1024,
# each of its four KV heads (256 columns) cut out by ``q8_slice_cols`` as a
# rank of a model axis past the KV head count does in the int8 serve
Q8MM_SLICED_SHAPE, Q8MM_SLICED_HD = (2304, 1024), 256
SERVE_SCHEDULE = {"param_store": "q8_block", "serve_quant_matmul": True}
SERVE_DENSE_SCHEDULE = {"param_store": "q8_block"}
SERVE_BATCH, SERVE_PROMPT, SERVE_LEN, SERVE_STEPS = 4, 512, 1024, 32
ENGINE_POOL, ENGINE_REQUESTS, ENGINE_NEW = 4, 8, 16
ENGINE_PROMPT = (8, 64)       # prompt lengths drawn in [8, 64]
# card vs CPU, prefill + PARITY_SERVE_STEPS decode steps of a reduced
# config per seed: relative L2 of the logits, limits about four times the
# largest reading over PARITY_SEEDS (readings in PERF.md): 6.8e-4 on the
# fp32 store (bf16 K/V rounding flips), 1.5e-2 in the int8 mode (the flips
# amplified by the activations' row quantization)
PARITY_SERVE_STEPS = 8
PARITY_SERVE_RTOL = {"fp32": 3e-3, "q8_matmul": 6e-2}
# int8 vs dense-dequant q8 serve, prefill logits at 4 full-width layers.
# The reference holds 0.15 on 2 reduced layers at fp32 (tests/
# test_torch_serve.py keeps that).  At full width the gap grows with depth
# (``python -m repro_torch.launch.serve_drift``): 0.042, 0.086, 0.207 at
# 1, 2, 4 layers in bf16, and 0.036, 0.085, 0.178 from the fp32 dense
# serve at fp32 compute, where the bf16 dense serve drifts 0.017, 0.039,
# 0.088 -- so the limit is set from the 4-layer reading (PERF.md Findings)
SERVE_INT8_VS_DENSE = 0.3
FP8_FMTS = ("fp8_e4m3", "fp8_e5m2")
# bytes per element of this slice's passes (each input read once, each
# output written once): AdamW with fp8 codes (w, g, m, v, mask 20 B in;
# code 1, w', m', v' 12 B out), the bf16 store's AdamW (bf16 w and g), the
# standalone AdamW; the 8-bit Adam passes per element (plus
# ADAM8_BLOCK_BYTES per quant block): fp8 (w, g 8 B, m8, v8 2 B in; code
# 1, w' 4, m8', v8' 2 B out), the bf16 store's (bf16 w, g, w'), the
# standalone update (its fp32 mask per element)
NEW_BYTES = {"adamw_fp8": 33, "adamw_bf16": 26, "adamw_update": 32,
             "adam8bit_fp8": 17, "adam8bit_bf16": 10, "adam8bit_update": 20}
# fp32 operations per element (the Adam chain, the gradient scale, the
# encode); far from binding beside the bytes
NEW_FLOPS = {"adamw_fp8": FLOPS_PER_ELEM + 6, "adamw_bf16": FLOPS_PER_ELEM + 1,
             "adamw_update": FLOPS_PER_ELEM, "adam8bit_fp8": 46,
             "adam8bit_bf16": 41, "adam8bit_update": 40}
FP8_SCHEDULES = {"train_fp8": ({"param_store": "fp8_e4m3"}, "adamw"),
                 "train_fp8_adam8": ({"param_store": "fp8_e5m2"},
                                     "adam8bit"),
                 "train_bf16": ({"param_store": "bf16"}, "adamw")}
# card vs CPU on the bf16 and fp8 stores, two fp32 steps of each of
# PARITY_SEEDS: about four times the largest reading on the card (PERF.md:
# 5.1e-7 fp8_e4m3 / AdamW, 2.7e-7 fp8_e5m2 / Adam8bit, 1.8e-6 bf16 / AdamW)
PARITY_FP8_RTOL = 7e-6
# the boundary tensor's values (both signs are added), and the codes the
# reference's rule gives them (e4m3, e5m2), positive sign
BOUNDARY = (448.0, 463.99, 464.0, 464.0001, 480.0, 1e4, 57344.0, 61439.0,
            61440.0, float("inf"), float("nan"), 2.0 ** -9, 2.0 ** -10,
            3 * 2.0 ** -11, 2.0 ** -16, 2.0 ** -17)
BOUNDARY_CODES = {
    "fp8_e4m3": (0x7E, 0x7E, 0x7E, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F, 0x7F,
                 0x7F, 0x01, 0x00, 0x01, 0x00, 0x00),
    "fp8_e5m2": (0x5F, 0x5F, 0x5F, 0x5F, 0x60, 0x71, 0x7B, 0x7B, 0x7C, 0x7C,
                 0x7E, 0x18, 0x14, 0x16, 0x01, 0x00)}

# the non-element-wise optimizers (Muon, Shampoo, SGD) on qwen2.5-14b at
# published width: depth cut 48 -> 2 (Muon, q8_block store) and -> 1
# (Shampoo, fp32 store), batch 1 x 2048, one rank
QWEN = "qwen2.5-14b"
MUON_LAYERS, SHAMPOO_LAYERS, QWEN_BATCH, QWEN_SEQ = 2, 1, 1, 2048
SHAMPOO_STEPS = 2
QWEN_SHARDS = {"layers": 275_268_608, "globals": 1_557_140_480}
MUON_SCHEDULE = {"param_store": "q8_block"}
# card vs CPU, three fp32 steps of qwen2.5-14b.reduced() per case
# (learning rate 1e-2, as the CPU tests run it): loss and grad-norm
# streams, and the final masters' relative L2.  Each device repeats
# bitwise, so a card and CPU of one kind give one reading (the same in two
# H100 runs of the fp32-store cases).  The limits are four to eight times
# those readings (PERF.md): streams 2.37e-7 (SGD, limit 8.4x), 1.19e-7
# (Muon, 5.0x), 4.79e-7 (Shampoo, cuSOLVER's eigh against LAPACK's, 4.2x);
# masters 6.6e-9 (7.6x), 2.73e-7 (7.3x), 7.95e-6 (5.0x).  Muon on the
# q8_block store ("muon_q8") reads 7.54e-6 / 3.46e-5 (limits 4.0x): the
# masters' last-bit differences flip a few weight codes, which the next
# steps carry (1e-6 noise on Newton-Schulz moves one CPU run as much:
# test_q8_store_turns_last_bit_noise_into_code_flips in
# tests/test_torch_train_optim.py)
PARITY_OPTIM_LR, PARITY_OPTIM_STEPS = 1e-2, 3
PARITY_OPTIM_CASES = (("sgd", "sgd", None), ("muon", "muon", None),
                      ("shampoo", "shampoo", None),
                      ("muon_q8", "muon", MUON_SCHEDULE))
PARITY_OPTIM_RTOL = {"sgd": 2e-6, "muon": 6e-7, "shampoo": 2e-6,
                     "muon_q8": 3e-5}
PARITY_OPTIM_MASTER = {"sgd": 5e-8, "muon": 2e-6, "shampoo": 4e-5,
                       "muon_q8": 1.4e-4}
# the vocab-chunked CE at gemma2-2b's vocab (256000): 32 chunks, the last
# padded by 6144.  Its streams against ``train``'s (bf16 compute: the
# unchunked loss softcaps bf16 logits, the chunked one fp32 logits): on
# the CPU, gemma2-2b.reduced() read loss 2.3e-4 and grad norm 1.9e-3 at
# most over chunks 96, 128 and 200 (PERF.md); limits about ten times those
CE_CHUNK = 8192
# phase 23: the comm sweep's buffer sizes (elements)
AUTO_BENCH_SIZES = (1 << 20, 1 << 24)
# phase 24: gemma2-2b cut to 2 layers, two steps before and after the save
CKPT_LAYERS, CKPT_STEPS = 2, 2
# phase 24b: the TP degree the offline tool writes the checkpoint for
# (past gemma2-2b's 4 KV heads: wk and wv move into ``layers_rep``)
CKPT_TP = 8
CE_CHUNK_RTOL = {"loss": 2e-3, "grad_norm": 2e-2}
# phases 6c and 25: the dry run's predicted peak against ``train``'s and
# ``train_cli``'s measured ``max_memory_allocated``; the production rows
DRYRUN_PEAK_RTOL = 0.10
DRYRUN_PRODUCTION = (("gemma2-2b", "train_4k", False),
                     ("seamless-m4t-medium", "train_4k", False),
                     ("llama-3.2-vision-90b", "train_4k", False),
                     (MOE, "train_4k", True),
                     ("xlstm-125m", "train_4k", False),
                     ("hymba-1.5b", "train_4k", False))
DRYRUN_TIMEOUT_S = 600
# the arguments that make this script a child of ``run_reference``, which
# runs only the phases that hold the card against the CPU reference (13b
# in a child of its own, beside the others)
REFERENCE_ARG = "--reference"
REFERENCE_LONG_ARG = "--reference-long500k"
# phases 27-30: the recurrent families.  xlstm-125m at published width and
# depth; hymba-1.5b at published width cut to 4 layers (layers 0, 2 and 3
# global, layer 1 windowed at 1,024: the 2,048-token rows reach past it);
# both AdamW on the fp32 store, batch 2 x 2048.  Served: a prefill of 2 x
# 2048, REC_SERVE_STEPS greedy decode steps, the engine on the gemma2
# serve phase's requests.  Parity: the reduced configs (hymba at 4
# layers), fp32, card against CPU: two train steps of 8 x 64 a seed
# (losses and grad norms) and a prefill of 4 x 16 with 8 teacher-forced
# decode steps (each call's logits), within the limits below: the CPU
# tests' classes against the reference (tests/test_torch_recurrent.py:
# Hymba's grad norm 3.9e-6 over five steps at lr 3e-4; its serve logits
# 4.0e-4, the bf16 KV cache's class), with room for a second device
XLSTM, HYMBA, HYMBA_LAYERS = "xlstm-125m", "hymba-1.5b", 4
REC_BATCH, REC_SEQ, REC_SERVE_STEPS = 2, 2048, 32
PARITY_REC_SEEDS = (0, 1)
PARITY_REC_RTOL = 2e-5
PARITY_REC_SERVE_RTOL = {XLSTM: 1e-4, HYMBA: 3e-3}
# phase 26: the examples at their defaults on the card, then card against
# CPU at fp32 compute over a few steps (the parity phases' limits)
EXAMPLE_STEPS = {"quickstart": 20, "train_8bit_adam": 120, "muon_demo": 120}
EXAMPLE_PARITY_STEPS = {"quickstart": 2, "train_8bit_adam": 2,
                        "muon_demo": PARITY_OPTIM_STEPS}


# phases 31-35: the cross-attention families (slice 15).
# seamless-m4t-medium at published width and depth (12 + 12 layers), AdamW
# on the fp32 store, ENC_BATCH x ENC_SEQ tokens with as many frames (the
# stream's min(n_frames, T)), 1 + TIMED_STEPS steps and one counted; then
# served on its trained weights: a prefill of SERVE_BATCH x SERVE_PROMPT
# tokens over the config's 4,096 frames and CROSS_SERVE_STEPS decode steps.
# llama-3.2-vision-90b at published width cut to VISION_BLOCKS block (four
# self layers and a cross layer, 6.38 G parameters) served from the
# q8_block store, int8 and dense, a prefill of SERVE_BATCH x SERVE_PROMPT
# tokens with its 1,024 patches, then CROSS_SERVE_STEPS decode steps, each
# given the patches again (the cross K/V recomputed, as the reference
# does).  Both packages' init starts the VLM's gates at 0; here they start
# at VISION_GATE, so the patches reach the logits.  Parity (in the
# reference child): both .reduced() at fp32, card against CPU, a
# PARITY_CROSS_STEPS-step train stream per seed and a prefill of 4 x 16
# with PARITY_SERVE_STEPS decode steps, within the limits below (the CPU
# tests' classes against the reference: tests/test_torch_encdec.py,
# tests/test_torch_vision.py; the serve logits the bf16 KV cache's)
SEAMLESS, VISION = "seamless-m4t-medium", "llama-3.2-vision-90b"
ENC_BATCH, ENC_SEQ = 2, 2048
VISION_BLOCKS, VISION_GATE = 1, 0.5
CROSS_SERVE_STEPS = 32
PARITY_CROSS_SEEDS = (0, 1)
PARITY_CROSS_STEPS = 5
PARITY_CROSS_RTOL = 2e-5
PARITY_CROSS_SERVE_RTOL = 3e-3
# q8_matmul calls of one vision block (four self layers and the cross
# layer) per serve call, (K, N) -> (at decode M = SERVE_BATCH, at prefill
# M = SERVE_BATCH x SERVE_PROMPT): wq, wo, x_wq, x_wo; wk, wv; w1, w3,
# c_w1, c_w3; w2, c_w2.  The cross layer's x_wk and x_wv multiply the
# SERVE_BATCH x 1,024 patch rows at every call, decode included: the
# prefill regime at M = VISION_MEMORY_ROWS
VISION_BLOCK_Q8MM = {(8192, 8192): (10, 10), (8192, 1024): (8, 8),
                     (8192, 28672): (10, 10), (28672, 8192): (5, 5)}
VISION_MEMORY_Q8MM, VISION_MEMORY_ROWS, VISION_MEMORY_CALLS = \
    (8192, 1024), 4096, 2
# the plain quantize / dequantize_into at vision's shards, chunk by chunk
VISION_PLAIN_CHUNK = 1 << 28

# phases 36-41: the configurations first run on the card (slice 17), at
# published width and tp 1 through ``train``'s loop (the quickstart's),
# cut in depth, ep and batch only, and in store and optimizer where one
# card cannot hold the published ones (PERF.md's reckoning: gpt-oss-120b's
# AdamW state alone is ~87 GB on the fp32 store, llama3-70b's ~85 GB).
# name -> (arch, layers (None: the published depth), batch, seq,
# param_store, optimizer (None: the config's own)).  Each trains one
# warm-up and TIMED_STEPS timed steps; its peak must stay under
# PUBLISHED_PEAK_LIMIT, and where its dry run predicts more the batch is
# halved before it runs (``halved``)
PUBLISHED = {
    # 12 of its 24 layers: the script's clock (slice 18 added the
    # long_500k phases; at 24 layers the whole script read 1,052 s)
    "train_granite": ("granite-moe-1b-a400m", 12, 2, 2048, "fp32", None),
    "train_qwen32b": ("qwen1.5-32b", 1, 1, 2048, "fp32", None),
    "train_llama70b": ("llama3-70b", 1, 1, 2048, "bf16", None),
    "train_gptoss": ("gpt-oss-120b", 1, 1, 2048, "bf16", "adam8bit"),
}
PUBLISHED_PEAK_LIMIT = 75e9
# the phases of slice 17 in the order they run (``--only`` takes any of
# them): granite's trained masters are served from the q8_block store
# (``serve_granite``), and nemotron-4-340b, whose one layer with its
# 256,000-word embedding and head (12.89 G parameters) trains on no single
# card, has its int8 GEMM shapes held (``kernel_q8mm_nemotron``)
PUBLISHED_PHASES = ("train_granite", "serve_granite", "train_qwen32b",
                    "train_llama70b", "train_gptoss", "kernel_q8mm_nemotron")
ONLY_ARG = "--only"
# the host masters of these phases (37.6 GB together; 16.5 GB more for
# LONG500K's) are drawn by this process while the reference phases' child
# runs (``HostPrefetch``)
PREFETCHED = ("train_qwen32b", "train_llama70b", "train_gptoss")
DRY_STEP_ARG = "--dry-step"
# q8_matmul calls of one nemotron-4-340b layer per serve call, (K, N) ->
# (calls at decode M = SERVE_BATCH, at prefill M = SERVE_BATCH x
# SERVE_PROMPT): wq and wo, the squared-ReLU MLP's up (w1) and down (w2)
# projections.  wk and wv, (18432, 1536), have no separable scale layout
# at quant block 1024 (1536 is neither a multiple nor a divisor of it):
# ``q8_matmul`` refuses them as the reference's kernel does, and a serve
# dequantizes them (``dequantize_into``), held there instead
NEMOTRON = "nemotron-4-340b"
NEMOTRON_LAYER_Q8MM = {(18432, 18432): (2, 2), (18432, 73728): (1, 1),
                       (73728, 18432): (1, 1)}
NEMOTRON_KV = (18432, 1536)
# slice 18: the long_500k decode (``SHAPES["long_500k"]``: 524,288
# positions, batch 1) of the two families ``supports_shape`` admits there
# whose cache depends on position -- gemma2-2b's sliding-window variant (a
# 4,096-slot ring on every layer past 65,536 positions) and hymba-1.5b (a
# 1,024-slot ring beside its Mamba state) -- at published width and depth
# from the q8_block store: name -> (arch, serve schedule).  gemma2-2b
# serves int8 (``q8_matmul``); Hymba's block multiplies its weights
# directly (``models/recurrent.py``, as the reference's), so it serves
# the dense-dequant q8 mode
LONG500K = {"long500k_gemma2": ("gemma2-2b", SERVE_SCHEDULE),
            "long500k_hymba": ("hymba-1.5b", SERVE_DENSE_SCHEDULE)}
# LONG_STEPS greedy decode steps at the shape's last indices (524,160 ...
# 524,287) from an empty cache, no prefill; the last LONG_TIMED give the
# median step and tokens/s; the decode's own peak (after set-up) within
# LONG_PEAK_RTOL of its dry run's
LONG_SEQ, LONG_STEPS, LONG_TIMED = 524_288, 128, 64
LONG_PEAK_RTOL = 0.01
# the depth cut held against the CPU in the reference child: published
# width at LONG_PARITY_LAYERS layers, fp32 compute, the last
# LONG_PARITY_STEPS of the same indices; each call's logits within the
# serve classes of the reduced phases (13's int8 limit for gemma2-2b,
# 30's for Hymba)
LONG_PARITY_LAYERS, LONG_PARITY_STEPS = 2, 16
LONG_PARITY_RTOL = {"long500k_gemma2": PARITY_SERVE_RTOL["q8_matmul"],
                    "long500k_hymba": PARITY_REC_SERVE_RTOL[HYMBA]}


def halved(batch: int, seq: int) -> tuple[int, int]:
    """Half a phase's tokens: half the rows, or half the sequence of one."""
    return (batch // 2, seq) if batch > 1 else (batch, seq // 2)


def published_config(name: str):
    """``(cfg, cut)``: the configuration phase ``name`` of PUBLISHED trains
    and every departure from the published one (``cut``, field ->
    [published, run]; the batch against ``train_4k``'s)."""
    from repro_torch.configs import SHAPES, get_config

    arch, layers, batch, seq, store, opt = PUBLISHED[name]
    full = get_config(arch)
    cfg = dataclasses.replace(
        full, n_layers=layers or full.n_layers,
        optimizer=opt or full.optimizer,
        parallel=dataclasses.replace(full.parallel, ep=1,
                                     param_store=store))
    cut = {k: [getattr(full, k), getattr(cfg, k)]
           for k in ("n_layers", "optimizer")
           if getattr(full, k) != getattr(cfg, k)}
    cut.update({k: [getattr(full.parallel, k), getattr(cfg.parallel, k)]
                for k in ("ep", "param_store")
                if getattr(full.parallel, k) != getattr(cfg.parallel, k)})
    shape = SHAPES["train_4k"]
    cut["batch"] = [[shape.global_batch, shape.seq_len], [batch, seq]]
    return cfg, cut


def expected_first_loss(cfg) -> float:
    """The first loss the port's init implies: the final norm (its weight
    as ``_init_tensor`` draws it, through ``rms_norm``) maps unit-RMS
    activations to RMS ``gain``; a head of fan-in ``f`` drawn N(0, 1/f)
    makes the logits ~ N(0, gain^2 d / f) -- f = d for an untied head,
    the vocab for a tied one (the embedding's rows) -- and the mean of
    log-sum-exp over V such logits is ln V + var / 2 (the target's logit
    has mean 0)."""
    import torch

    from repro_torch.core.fsdp import FSDPRuntime
    from repro_torch.core.ragged import TensorSpec
    from repro_torch.models.layers import rms_norm

    w = FSDPRuntime._init_tensor(TensorSpec("final_ln", (cfg.d_model,)), 0,
                                 None)
    gain2 = float(rms_norm(torch.ones(1, cfg.d_model), torch.from_numpy(w),
                           cfg.norm_eps).square().mean())
    fan_in = cfg.vocab if cfg.tie_embeddings else cfg.d_model
    return math.log(cfg.vocab) + gain2 * cfg.d_model / fan_in / 2


def dry_step_main(name: str) -> None:
    """``chip_smoke.py --dry-step NAME``: the dry run of phase ``name``'s
    step -- one rank of a 1 x 1 mesh on meta tensors
    (``launch.dryrun.dry_step``) -- one JSON row a batch.  A PUBLISHED
    phase's train step (its config, store, optimizer, depth and batch):
    the phase's row, and where that predicts more than
    PUBLISHED_PEAK_LIMIT the ``halved`` one the phase then runs.  A
    LONG500K phase's decode step: its plan (the serve schedule), a cache
    of LONG_SEQ positions, batch 1.  A child process of ``start_dryruns``
    that sees no card."""
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.configs import ShapeConfig, build_model
    from repro_torch.core.policy import plan
    from repro_torch.launch.dryrun import dry_step

    mesh = {"data": 1, "model": 1}

    def row(cfg, batch, rec):
        print(json.dumps({
            "arch": cfg.name, "run": name, "mesh": "1x1", "batch": batch,
            "ok": True, "peak_bytes_dev": rec.peak_bytes,
            "arg_bytes_dev": rec.arg_bytes,
            "hlo_gflops_dev": rec.flops / 1e9, "hbm_gb_dev": rec.bytes / 1e9,
            "colls": {k: sum(c[0] == k for c in rec.collectives)
                      for k in sorted({c[0] for c in rec.collectives})},
            "kernel_calls": rec.kernel_calls(),
            "dry_run_s": rec.seconds}), flush=True)

    if name in LONG500K:
        cfg, sched = long500k_runtime_args(name)
        model = build_model(cfg)
        rec, _ = dry_step(cfg, ShapeConfig(name, LONG_SEQ, 1, "decode"),
                          mesh, plan=plan(model, mesh, sched,
                                          compute_dtype=torch.bfloat16),
                          model=model)
        row(cfg, [1, LONG_SEQ], rec)
        return
    cfg, _ = published_config(name)
    batch, seq = PUBLISHED[name][2:4]
    for b, t in ((batch, seq), halved(batch, seq)):
        rec, _ = dry_step(cfg, ShapeConfig(f"{name}_b{b}_s{t}", t, b,
                                           "train"), mesh)
        row(cfg, [b, t], rec)
        if rec.peak_bytes <= PUBLISHED_PEAK_LIMIT:
            break


def long500k_runtime_args(name: str):
    """``(cfg, schedule)`` of a LONG500K phase: the published config and
    its serve schedule (a ``CommSchedule``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.schedule import CommSchedule

    arch, sched = LONG500K[name]
    return get_config(arch), CommSchedule(**sched)


class HostPrefetch:
    """The initial host masters of the runtimes ``runtimes`` (phase ->
    an ``FSDPRuntime`` on the meta device: its layouts only), each drawn
    by ``host_params(0)`` on a thread of this process of its own (numpy
    releases the GIL while it draws) at the lowest priority, all started
    at once.  ``wait()``
    joins them and returns the seconds it waited; ``init(name, timing)``
    is then that phase's ``init(rt)`` for ``train``: it places the arrays
    as ``init_params(0)`` does (``timing``'s ``host_draw_s``: their draw's
    own seconds), its plan checked against the prefetch's."""

    def __init__(self, runtimes: dict):
        self.rts, self.done, self.errors = runtimes, {}, {}
        self.threads = [threading.Thread(target=self._draw, args=(n,),
                                         daemon=True) for n in runtimes]
        for t in self.threads:
            t.start()

    def _draw(self, name: str) -> None:
        # the lowest priority for this thread and the pool it starts (a
        # new thread inherits its creator's): the draw takes the cores the
        # reference phases' child leaves idle
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
        t0 = time.perf_counter()
        try:
            self.done[name] = (self.rts[name].host_params(0),
                               time.perf_counter() - t0)
        except Exception as e:          # raised again by ``wait``
            self.errors[name] = e

    def wait(self) -> float:
        t0 = time.perf_counter()
        for t in self.threads:
            t.join()
        for name, e in self.errors.items():
            raise RuntimeError(f"the host prefetch of {name} failed") from e
        return time.perf_counter() - t0

    def init(self, name: str, timing: dict):
        def init(rt):
            import torch

            host, timing["host_draw_s"] = self.done.pop(name)
            src = self.rts[name].layouts
            if any(lo.plan != src[n].plan for n, lo in rt.layouts.items()):
                fail(f"{name}: the prefetched masters' plan differs")
            return {n: lo.store.create(torch.from_numpy(host.pop(n))
                                       .to(rt.device).requires_grad_(True))
                    for n, lo in rt.layouts.items()}
        return init


def dryrun_vs_card(name: str, dry_run: dict, measured: int,
                   calls_want: dict, rtol: float = DRYRUN_PEAK_RTOL,
                   **extra) -> None:
    """Phase 6c's row of run ``name``: its dry run's (``finish_dryruns``)
    predicted peak against the card's ``measured`` peak, within ``rtol``,
    and its kernel calls equal to ``calls_want``."""
    row = dry_run["row"]
    pred = row["peak_bytes_dev"]
    emit({"phase": "dryrun_vs_card", "run": name, "mesh": row["mesh"],
          **extra, "predicted_peak": pred,
          "argument_bytes": row["arg_bytes_dev"],
          "temp_bytes": pred - row["arg_bytes_dev"],
          "max_memory_allocated": measured,
          "rel_diff": pred / measured - 1.0, "rtol": rtol,
          "matmul_gflops": row["hlo_gflops_dev"], "hbm_gb": row["hbm_gb_dev"],
          "colls": row["colls"], "kernel_calls": row["kernel_calls"],
          "dry_run_s": dry_run["seconds"]})
    if abs(pred / measured - 1.0) > rtol:
        fail(f"dryrun_vs_card {name}: predicted peak {pred} is "
             f"{pred / measured - 1.0:+.3f} of the measured {measured}")
    if row["kernel_calls"] != calls_want:
        fail(f"dryrun_vs_card {name}: kernel calls {row['kernel_calls']}, "
             f"expected {calls_want}")


def host_mem_available() -> int:
    """The host's available memory in bytes (``MemAvailable``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return -1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


@functools.cache
def side_stream():
    """The one side stream of ``graph_ms``' warm-ups: cuBLAS keeps a
    workspace on every stream it has run on (32 MiB each on the H100)
    until the process ends, so a new stream a call would hold one a call
    past ``empty_cache``."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()``: the median over ``iters`` replays of a
    CUDA graph of ``reps`` back-to-back calls, over ``reps``.  A call small
    enough that the host's launch path (one graph launch included)
    outlasts its kernels is measured on the device alone."""
    import torch

    fn()                                   # build, load, allocate first
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = median_ms(graph.replay, iters) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


# elements a comparison reads at a time (its int64 / fp32 temporaries)
COMPARE_CHUNK = 1 << 28


def _chunks(a, b):
    """The flat views of two tensors of one shape, COMPARE_CHUNK elements
    at a time."""
    a, b = a.reshape(-1), b.reshape(-1)
    for lo in range(0, a.numel(), COMPARE_CHUNK):
        yield a[lo:lo + COMPARE_CHUNK], b[lo:lo + COMPARE_CHUNK]


def int_view_diff(a, b) -> int:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return 1 << 62
    if a.numel() == 0:
        return 0
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8, torch.float8_e4m3fn: torch.uint8,
            torch.float8_e5m2: torch.uint8}[a.dtype]
    return max(int((x.view(view).long() - y.view(view).long()).abs().max())
               for x, y in _chunks(a, b))


def abs_err(a, b) -> float:
    """Largest |a - b| in fp32, NaN where both are NaN counted as 0."""
    import torch

    if a.numel() == 0:
        return 0.0
    out = 0.0
    for x, y in _chunks(a, b):
        x, y = x.float(), y.float()
        both = torch.isnan(x) & torch.isnan(y)
        d = torch.where(both, torch.zeros_like(x), (x - y).abs())
        v = float(d.max())
        if v != v or v > out:      # a NaN, once read, stays the answer
            out = v
    return out


def flat_outputs(out) -> list:
    """The tensors of a kernel's result, in order (dicts by key)."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat_outputs(o)]
    return [out]


def hold(name: str, case: dict, run_kernel, run_plain, bytes_moved: float,
         flops: float, iters: int = Q8_ITERS, phase: str = "kernel_q8"
         ) -> dict:
    """One kernel against its plain version on the same inputs: integer-view
    difference (must be 0), max abs error, median times, bound."""
    import torch

    got, want = flat_outputs(run_kernel()), flat_outputs(run_plain())
    torch.cuda.synchronize()
    diff = max(int_view_diff(a, b) for a, b in zip(got, want))
    err = max(abs_err(a, b) for a, b in zip(got, want))
    del got, want
    ms = median_ms(run_kernel, iters)
    plain_ms = median_ms(run_plain, iters)
    return held_row(name, case, diff, err, ms, plain_ms, bytes_moved, flops,
                    phase)


def held_row(name: str, case: dict, diff: int, err: float, ms: float,
             plain_ms: float, bytes_moved: float, flops: float,
             phase: str) -> dict:
    """A kernel's row against its plain version (``hold``,
    ``hold_in_chunks``) with its bound; fails unless it is bitwise."""
    import torch

    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    row = {"phase": phase, "name": name, **case,
           "max_int_view_diff": diff, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_moved / HBM_BYTES_PER_S
           >= flops / FP32_FLOPS else "operations",
           "bytes": bytes_moved, "achieved_GBps": bytes_moved / ms / 1e6,
           "parity": "bitwise" if diff == 0 else "DIFFERS"}
    emit(row)
    if diff != 0:
        fail(f"{name} differs from its plain version at {case}: {diff} "
             f"integer-view steps")
    torch.cuda.empty_cache()
    return row


def phase_kernel(fused_update, ref) -> dict:
    """Kernel vs plain at the main path's shapes; returns the summary the
    kernels line carries (the train step's two group updates, fp32)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    scalars = ref.scalar_stack(3e-4, 0.9, 0.95, 1e-8, 0.1,
                               1 - 0.9 ** 3, 1 - 0.95 ** 3)
    worst_abs = 0.0
    step = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for shape in (LAYERS_SHAPE, GLOBALS_SHAPE, RAGGED_SHAPE):
        def rnd(scale):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        w, g, m = rnd(0.05), rnd(1e-3), rnd(1e-4)
        v = rnd(1e-4).square_()
        mask = (torch.rand(shape, generator=gen, device="cuda") < 0.8).float()
        n = w.numel()
        for fmt in ("fp32", "bf16"):
            out = fused_update.adamw_store_update(w, g, m, v, mask, scalars,
                                                  fmt=fmt)
            want = ref.adamw_store_update_ref(w, g, m, v, mask, scalars, fmt)
            torch.cuda.synchronize()
            diff = max(int_view_diff(a, b) for a, b in zip(out, want))
            err = max(abs_err(a, b) for a, b in zip(out, want))
            del want
            ms = median_ms(lambda: fused_update.adamw_store_update(
                w, g, m, v, mask, scalars, fmt=fmt, out=out))
            del out
            plain_ms = median_ms(lambda: ref.adamw_store_update_ref(
                w, g, m, v, mask, scalars, fmt))
            bytes_moved = BYTES_PER_ELEM[fmt] * n
            bound_ms = max(bytes_moved / HBM_BYTES_PER_S,
                           FLOPS_PER_ELEM * n / FP32_FLOPS) * 1e3
            row = {"phase": "kernel", "name": "adamw_store_update",
                   "shape": list(shape), "fmt": fmt,
                   "max_int_view_diff": diff, "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bytes": bytes_moved,
                   "achieved_GBps": bytes_moved / ms / 1e6,
                   "parity": "bitwise" if diff == 0 else "DIFFERS"}
            emit(row)
            if diff != 0:
                fail(f"kernel differs from the plain version at {shape} "
                     f"{fmt}: {diff} integer-view steps")
            worst_abs = max(worst_abs, err)
            if fmt == "fp32" and shape in (LAYERS_SHAPE, GLOBALS_SHAPE):
                step["ms"] += ms
                step["plain_ms"] += plain_ms
                step["bound_ms"] += bound_ms
        del w, g, m, v, mask
        torch.cuda.empty_cache()
    step["max_abs_err"] = worst_abs
    return step


def phase_kernel_q8(ops, ref, layer_shard: int, globals_shard: int,
                    muon_shards: dict) -> dict:
    """The q8 kernels at the q8 plan's shard shapes (one rank: a layer's
    gathered buffer is its shard), and ``quantize`` / ``dequantize_into``
    at the shapes ``train_muon_q8`` gives them (``muon_shards``: its
    plan's).  Returns per kernel the summary the kernels line carries: one
    call at each group's ``train_q8`` shape, summed (init quantize of both
    groups, a bf16 gather and a bf16-cotangent encode of each group, the
    update of each group), and under ``by_path`` the same for
    ``train_muon_q8`` (a rebuild and a bf16 gather of each group)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    scalars = ref.scalar_stack(3e-4, 0.9, 0.95, 1e-8, 0.1,
                               1 - 0.9 ** 3, 1 - 0.95 ** 3)
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=1 - 0.9 ** 3,
              c2=1 - 0.95 ** 3)
    L = TRAIN_LAYERS
    reduced_layer = (2, 64 * 10256)   # gemma2-2b.reduced()'s q8 layer shard
    summary = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0} for k in Q8_FLOPS}

    def rnd(shape, scale=1.0, dtype=torch.float32):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        x.view(-1)[:1024] = 0.0   # an all-zero quant block
        return x.to(dtype)

    def add(key, row, on_path):
        s = summary[key]
        s["max_abs_err"] = max(s["max_abs_err"], row["max_abs_err"])
        if on_path == "train_muon_q8":
            s = s.setdefault("by_path", {}).setdefault(on_path, {
                "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "max_abs_err": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], row["max_abs_err"])
        if on_path:
            for k in ("ms", "plain_ms", "bound_ms"):
                s[k] += row[k]

    muon_layers, muon_globals = muon_shards["layers"], muon_shards["globals"]
    # quantize: the store's init (fp32 masters), a bf16 input, block 64;
    # the main path's rebuild of each group
    for shape, dtype, block, on_path in (
            ((L, layer_shard), torch.float32, 1024, True),
            ((globals_shard,), torch.float32, 1024, True),
            ((layer_shard,), torch.bfloat16, 1024, False),
            (reduced_layer, torch.float32, 64, False),
            ((MUON_LAYERS, muon_layers), torch.float32, 1024,
             "train_muon_q8"),
            ((muon_globals,), torch.float32, 1024, "train_muon_q8")):
        x = rnd(shape, 0.05, dtype)
        n = x.numel()
        row = hold("quantize", {"shape": list(shape), "in": str(dtype)[6:],
                                "block": block},
                   lambda: ops.quantize(x, block),
                   lambda: ref.quantize_ref(x, block),
                   n * (x.element_size() + 1) + 4 * n / block,
                   Q8_FLOPS["quantize"] * n)
        add("quantize", row, on_path)
        del x
    # dequantize_into: the bf16 gathers (the main path's too); dequantize
    # (its fp32 case, counted apart): the reduce route
    for shape, dtype, block, on_path in (
            ((layer_shard,), torch.bfloat16, 1024, True),
            ((globals_shard,), torch.bfloat16, 1024, True),
            ((layer_shard,), torch.float32, 1024, True),
            ((globals_shard,), torch.float32, 1024, True),
            (reduced_layer, torch.float32, 64, False),
            ((muon_layers,), torch.bfloat16, 1024, "train_muon_q8"),
            ((muon_globals,), torch.bfloat16, 1024, "train_muon_q8")):
        codes, scales = ops.quantize(rnd(shape, 0.05), block)
        n = codes.numel()
        out_bytes = torch.empty((), dtype=dtype).element_size()
        key = "dequantize_into" if dtype == torch.bfloat16 else "dequantize"
        row = hold(key, {"shape": list(shape), "out": str(dtype)[6:],
                         "block": block},
                   (lambda: ops.dequantize_into(codes, scales, block,
                                                out_dtype=dtype))
                   if key == "dequantize_into"
                   else (lambda: ops.dequantize(codes, scales, block)),
                   lambda: ref.dequantize_into_ref(codes, scales, block,
                                                   dtype),
                   n * (1 + out_bytes) + 4 * n / block,
                   Q8_FLOPS[key] * n)
        add(key, row, on_path)
        del codes, scales
    # encode_ef: the reduce wire's encode of a bf16 (or fp32) cotangent
    for shape, dtype, block, on_path in (
            ((layer_shard,), torch.bfloat16, 1024, True),
            ((globals_shard,), torch.bfloat16, 1024, True),
            ((layer_shard,), torch.float32, 1024, False),
            (reduced_layer, torch.float32, 64, False)):
        ct, ef = rnd(shape, 1e-3, dtype), rnd(shape, 1e-5)
        n = ct.numel()
        row = hold("encode_ef", {"shape": list(shape), "ct": str(dtype)[6:],
                                 "block": block},
                   lambda: ops.encode_ef(ct, ef, block),
                   lambda: ref.encode_ef_ref(ct, ef, block),
                   n * (ct.element_size() + 4 + 1 + 4) + 4 * n / block,
                   Q8_FLOPS["encode_ef"] * n)
        add("encode_ef", row, on_path)
        del ct, ef
    # the q8 epilogue of the AdamW update: each group's step
    for shape, block, on_path in (((L, layer_shard), 1024, True),
                                  ((globals_shard,), 1024, True),
                                  (reduced_layer, 64, False)):
        w, g, m = rnd(shape, 0.05), rnd(shape, 1e-3), rnd(shape, 1e-4)
        v = rnd(shape, 1e-4).square_()
        mask = (torch.rand(shape, generator=gen, device="cuda") < 0.8).float()
        n = w.numel()
        row = hold("adamw_q8", {"shape": list(shape), "block": block},
                   lambda: ops.adamw_store_update(w, g, m, v, mask,
                                                  fmt="q8_block", block=block,
                                                  **kw),
                   lambda: ref.adamw_store_update_ref(w, g, m, v, mask,
                                                      scalars, "q8_block",
                                                      block),
                   n * (20 + 1 + 12) + 4 * n / block,
                   Q8_FLOPS["adamw_q8"] * n)
        add("adamw_q8", row, on_path)
        del w, g, m, v, mask
    torch.cuda.empty_cache()
    return summary


def phase_kernel_adam8(ops, ref, gemma_q8_shards) -> dict:
    """The 8-bit Adam kernel against its plain version.  Returns per
    epilogue the summary the kernels line carries: the flat epilogue (fp32,
    the qwen3-moe path's) summed over qwen3-moe's layers shard and the
    compared slice of its experts shard, the q8_block epilogue over the
    gemma2-2b adam8bit q8 plan's two groups (the train_adam8_q8 path's)."""
    import math

    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=1 - 0.9 ** 3,
              c2=1 - 0.95 ** 3)
    scalars = ref.scalar_stack(*kw.values())
    summary = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0} for k in ("flat", "q8")}

    def inputs(shape, block, offset, w_dtype, codec_moments=True,
               g_dtype=torch.float32):
        """Card tensors ``offset`` elements into their buffers (an odd
        offset takes the kernel's scalar path); moments from a previous
        step's codecs (or, for a timing alone, random codes and scales);
        one (S,) uint8 decay row."""
        n = math.prod(shape)

        def view(x, dtype):
            if offset == 0:
                return x.to(dtype)
            buf = torch.empty(n + offset, dtype=dtype, device="cuda")
            buf[offset:] = x.reshape(-1).to(dtype)
            return buf[offset:].view(shape)

        def rnd(scale):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        w, g = view(rnd(0.05), w_dtype), view(rnd(1e-3), g_dtype)
        if codec_moments:
            m8, ms = ops.quantize(rnd(1e-4), block)
            v8, vs = ops.quantize_log(rnd(3e-4).square_(), block)
        else:
            sshape = shape[:-1] + (shape[-1] // block,)
            m8 = torch.randint(-127, 128, shape, generator=gen,
                               device="cuda", dtype=torch.int8)
            v8 = torch.randint(0, 128, shape, generator=gen, device="cuda",
                               dtype=torch.int8)
            ms = torch.rand(sshape, generator=gen, device="cuda") * 1e-6
            vs = torch.rand(sshape, generator=gen, device="cuda") * 1e-7
        mask = (torch.rand(shape[-1], generator=gen, device="cuda") < 0.8)
        return (w, g, view(m8, torch.int8), view(v8, torch.int8), ms, vs,
                mask.to(torch.uint8))

    def cost(fmt, shape, block):
        n = math.prod(shape)
        return (n * ADAM8_BYTES[fmt] + shape[-1]
                + n // block * ADAM8_BLOCK_BYTES[fmt], n * ADAM8_FLOPS[fmt])

    L = TRAIN_LAYERS
    qwen_layers = (1, MOE_SHARDS["layers"])
    qwen_slice = (1, MOE_SLICE)
    cases = [(fmt, shape, block, offset, key)
             for fmt in ("fp32", "bf16", "q8_block")
             for shape, block, offset, key in (
                 (qwen_layers, 1024, 0, "flat" if fmt == "fp32" else None),
                 (qwen_slice, 1024, 0, "flat" if fmt == "fp32" else None),
                 ((2, 1_572_864), 64, 0, None),   # the reduced config
                 ((1, 1024 * 4096), 1024, 1, None))]  # misaligned view
    cases += [("q8_block", (L, gemma_q8_shards["layers"]), 1024, 0, "q8"),
              ("q8_block", (gemma_q8_shards["globals"],), 1024, 0, "q8")]
    for fmt, shape, block, offset, key in cases:
        t = inputs(shape, block, offset,
                   torch.bfloat16 if fmt == "bf16" else torch.float32)
        nbytes, flops = cost(fmt, shape, block)
        row = hold("adam8bit_store_update",
                   {"shape": list(shape), "fmt": fmt, "block": block,
                    "offset": offset},
                   lambda: ops.adam8bit_store_update(*t, fmt=fmt, block=block,
                                                     **kw),
                   lambda: ref.adam8bit_store_update_ref(*t, scalars, fmt,
                                                         block),
                   nbytes, flops, phase="kernel_adam8")
        if key is not None:
            st = summary[key]
            st["max_abs_err"] = max(st["max_abs_err"], row["max_abs_err"])
            for k in ("ms", "plain_ms", "bound_ms"):
                st[k] += row[k]
        del t
        torch.cuda.empty_cache()
    # the kernel alone at the full shards of the qwen3-moe step (in place,
    # as the optimizer runs it): no room for the plain version's
    # temporaries; the fp32 store (the train_moe path's) and the bf16 store
    # (bf16 w and g, 10 B an element)
    for fmt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for name in ("layers_experts", "globals"):
            shape = (1, MOE_SHARDS[name]) if name != "globals" \
                else (MOE_SHARDS[name],)
            t = inputs(shape, 1024, 0, dtype, codec_moments=False,
                       g_dtype=dtype)
            out = (t[0], t[2], t[3], t[4], t[5])
            ms = median_ms(lambda: ops.adam8bit_store_update(
                *t, fmt=fmt, block=1024, out=out, **kw), iters=5, warmup=1)
            n = math.prod(shape)
            nbytes = (n * (ADAM8_BYTES[fmt] if fmt == "fp32"
                           else NEW_BYTES["adam8bit_bf16"]) + shape[-1]
                      + n // 1024 * ADAM8_BLOCK_BYTES[fmt])
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           n * ADAM8_FLOPS[fmt] / FP32_FLOPS) * 1e3
            emit({"phase": "kernel_adam8", "name": "adam8bit_store_update",
                  "shape": list(shape), "fmt": fmt, "block": 1024,
                  "alone": True, "ms": ms, "bound_ms": bound_ms,
                  "bytes": nbytes, "achieved_GBps": nbytes / ms / 1e6,
                  "share_of_bound": bound_ms / ms})
            del t, out
            torch.cuda.empty_cache()
    return summary


def phase_kernel_fp8(ops, ref, fp32_shards: dict, adam8_shards: dict
                     ) -> dict:
    """This slice's passes against their plain versions.  Returns per kernel
    the summary the kernels line carries: one call at each group's
    main-path shape, summed (rows 8b and 6 at the fp32 plan's shards, 9b
    and 7 at the adam8bit plan's; the bf16 store's passes in PERF.md)."""
    import torch

    from repro_torch.quant.fp8 import FP8_DTYPES, fp8_encode

    gen = torch.Generator(device="cuda").manual_seed(5)
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=1 - 0.9 ** 3,
              c2=1 - 0.95 ** 3)
    scalars = ref.scalar_stack(*kw.values())
    summary = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0} for k in NEW_BYTES}
    L = TRAIN_LAYERS

    def rnd(shape, scale, offset=0, dtype=torch.float32):
        """Random values ``offset`` elements into their buffer (an odd
        offset takes the kernels' scalar path)."""
        n = math.prod(shape)
        buf = torch.empty(n + offset, dtype=dtype, device="cuda")
        buf[offset:] = (torch.randn(n, generator=gen, device="cuda")
                        * scale).to(dtype)
        return buf[offset:].view(shape)

    def add(key, row, on_path):
        st = summary[key]
        st["max_abs_err"] = max(st["max_abs_err"], row["max_abs_err"])
        if on_path:
            for k in ("ms", "plain_ms", "bound_ms"):
                st[k] += row[k]

    def adamw_in(shape, offset=0, w_dtype=torch.float32,
                 g_dtype=torch.float32, w_scale=0.05):
        w, g = rnd(shape, w_scale, offset, w_dtype), rnd(shape, 1e-3, offset,
                                                         g_dtype)
        m = rnd(shape, 1e-4, offset)
        v = rnd(shape, 1e-4, offset).square_()
        mask = (torch.rand(shape, generator=gen, device="cuda") < 0.8) \
            .float()
        return w, g, m, v, mask

    def adam8_in(shape, block, offset=0, w_dtype=torch.float32,
                 g_dtype=torch.float32, full_mask=False):
        w, g = rnd(shape, 0.05, offset, w_dtype), rnd(shape, 1e-3, offset,
                                                      g_dtype)
        m8, ms = ops.quantize(rnd(shape, 1e-4), block)
        v8, vs = ops.quantize_log(rnd(shape, 3e-4).square_(), block)
        if offset:
            m8, v8 = (rnd(shape, 0, offset, torch.int8).copy_(t)
                      for t in (m8, v8))
        if full_mask:
            mask = torch.rand(shape, generator=gen, device="cuda")
        else:
            mask = (torch.rand(shape[-1], generator=gen, device="cuda")
                    < 0.8).to(torch.uint8)
        return w, g, m8, v8, ms, vs, mask

    def cost(key, shape, block=None):
        n = math.prod(shape)
        nbytes = NEW_BYTES[key] * n
        if block:
            nbytes += n // block * ADAM8_BLOCK_BYTES["fp32"]
            if not key.endswith("update"):
                nbytes += shape[-1]           # the (S,) uint8 decay row
        return nbytes, NEW_FLOPS[key] * n

    fp32_layers = (L, fp32_shards["layers"])
    fp32_globals = (fp32_shards["globals"],)
    a8_layers = (L, adam8_shards["layers"])
    a8_globals = (adam8_shards["globals"],)
    scale = torch.tensor(1 / 4094, dtype=torch.float32, device="cuda")
    # row 8b, both formats: the path's shards, a ragged and a misaligned view
    for fmt in FP8_FMTS:
        for shape, offset, on_path in ((fp32_layers, 0, fmt == "fp8_e4m3"),
                                       (fp32_globals, 0, fmt == "fp8_e4m3"),
                                       (RAGGED_SHAPE, 0, False),
                                       ((4096 * 256,), 1, False)):
            t = adamw_in(shape, offset)
            row = hold("adamw_fp8", {"shape": list(shape), "fmt": fmt,
                                     "offset": offset},
                       lambda: ops.adamw_store_update(*t, fmt=fmt, **kw),
                       lambda: ref.adamw_store_update_ref(*t, scalars, fmt),
                       *cost("adamw_fp8", shape), phase="kernel_fp8")
            add("adamw_fp8", row, on_path)
            del t
            torch.cuda.empty_cache()
    # row 8a on the bf16 store: bf16 w and g, the gradient scale in the pass
    for shape in (fp32_layers, fp32_globals):
        t = adamw_in(shape, 0, torch.bfloat16, torch.bfloat16)
        row = hold("adamw_bf16", {"shape": list(shape), "fmt": "bf16",
                                  "w": "bf16", "g": "bf16"},
                   lambda: ops.adamw_store_update(*t, fmt="bf16",
                                                  g_scale=scale, **kw),
                   lambda: ref.adamw_store_update_ref(*t, scalars, "bf16",
                                                      g_scale=scale),
                   *cost("adamw_bf16", shape), phase="kernel_fp8")
        add("adamw_bf16", row, True)
        del t
        torch.cuda.empty_cache()
    # row 6: the standalone AdamW on each group's flat shard
    for shape, on_path in (((math.prod(fp32_layers),), True),
                           (fp32_globals, True), ((128 * 7813,), False)):
        t = adamw_in(shape)
        row = hold("adamw_update", {"shape": list(shape)},
                   lambda: ops.adamw_update(*t, **kw),
                   lambda: ref.adamw_update_ref(*t, scalars),
                   *cost("adamw_update", shape), phase="kernel_fp8")
        add("adamw_update", row, on_path)
        del t
        torch.cuda.empty_cache()
    # row 9b, both formats: the adam8bit plan's shards, block 64, misaligned
    for fmt in FP8_FMTS:
        for shape, block, offset, on_path in (
                (a8_layers, 1024, 0, fmt == "fp8_e5m2"),
                (a8_globals, 1024, 0, fmt == "fp8_e5m2"),
                ((2, 64 * 4096), 64, 0, False),
                ((1, 1024 * 1024), 1024, 1, False)):
            t = adam8_in(shape, block, offset)
            row = hold("adam8bit_fp8", {"shape": list(shape), "fmt": fmt,
                                        "block": block, "offset": offset},
                       lambda: ops.adam8bit_store_update(*t, fmt=fmt,
                                                         block=block, **kw),
                       lambda: ref.adam8bit_store_update_ref(*t, scalars, fmt,
                                                             block),
                       *cost("adam8bit_fp8", shape, block),
                       phase="kernel_fp8")
            add("adam8bit_fp8", row, on_path)
            del t
            torch.cuda.empty_cache()
    # row 9a on the bf16 store: bf16 w and g with the gradient scale
    for shape in (a8_layers, a8_globals):
        t = adam8_in(shape, 1024, 0, torch.bfloat16, torch.bfloat16)
        row = hold("adam8bit_bf16", {"shape": list(shape), "fmt": "bf16",
                                     "w": "bf16", "g": "bf16"},
                   lambda: ops.adam8bit_store_update(*t, fmt="bf16",
                                                     block=1024,
                                                     g_scale=scale, **kw),
                   lambda: ref.adam8bit_store_update_ref(
                       *t, scalars, "bf16", 1024, g_scale=scale),
                   *cost("adam8bit_bf16", shape, 1024), phase="kernel_fp8")
        add("adam8bit_bf16", row, True)
        del t
        torch.cuda.empty_cache()
    # row 7: the standalone 8-bit Adam, a full fp32 mask read per element
    for shape, block in (((math.prod(a8_layers),), 1024), (a8_globals, 1024),
                         ((64 * 5000,), 64)):
        t = adam8_in(shape, block, full_mask=True)
        row = hold("adam8bit_update", {"shape": list(shape), "block": block},
                   lambda: ops.adam8bit_update(*t, block=block, **kw),
                   lambda: ref.adam8bit_update_ref(*t, scalars, block),
                   *cost("adam8bit_update", shape, block),
                   phase="kernel_fp8")
        add("adam8bit_update", row, block == 1024)
        del t
        torch.cuda.empty_cache()
    # the boundary tensor through both fp8 epilogues: lr 0 keeps every
    # finite master (inf and NaN masters turn NaN through 0 * inf); a
    # second run at lr -2 overflows +-3e38 to +-inf
    vals = torch.tensor(BOUNDARY + (3e38,), device="cuda")
    w = torch.cat([vals, -vals] * 64)                  # 4,352 elements
    n = w.numel()
    z = torch.zeros_like(w)
    for lr in (0.0, -2.0):
        bkw = dict(kw, lr=lr)
        bsc = ref.scalar_stack(*bkw.values())
        for fmt in FP8_FMTS:
            for name, run, plain in (
                    ("adamw_fp8",
                     lambda: ops.adamw_store_update(w, z, z, z, z + 1,
                                                    fmt=fmt, **bkw),
                     lambda: ref.adamw_store_update_ref(w, z, z, z, z + 1,
                                                        bsc, fmt)),
                    ("adam8bit_fp8",
                     lambda: ops.adam8bit_store_update(
                         w.view(1, n), z.view(1, n),
                         *(torch.zeros(1, n, dtype=torch.int8,
                                       device="cuda"),) * 2,
                         *(torch.zeros(1, n // 64, device="cuda"),) * 2,
                         torch.ones(n, dtype=torch.uint8, device="cuda"),
                         fmt=fmt, block=64, **bkw),
                     lambda: ref.adam8bit_store_update_ref(
                         w.view(1, n), z.view(1, n),
                         *(torch.zeros(1, n, dtype=torch.int8,
                                       device="cuda"),) * 2,
                         *(torch.zeros(1, n // 64, device="cuda"),) * 2,
                         torch.ones(n, dtype=torch.uint8, device="cuda"),
                         bsc, fmt, 64))):
                got, want = run()[0], plain()[0]
                torch.cuda.synchronize()
                codes = got["codes"].reshape(-1).view(torch.uint8).cpu()
                diff = max(int_view_diff(got[k], want[k])
                           for k in ("codes", "master"))
                encoded = int_view_diff(got["codes"], fp8_encode(
                    got["master"], fmt))
                row = {"phase": "kernel_fp8", "name": name + "_boundary",
                       "fmt": fmt, "lr": lr, "n": n,
                       "max_int_view_diff": diff,
                       "codes_vs_encode_of_master": encoded,
                       "codes": [int(c) for c in codes[:2 * len(vals)]]}
                if lr == 0.0:
                    # inf turns NaN through 0 * inf, and a NaN master's
                    # sign is the arithmetic's: those entries must hold a
                    # NaN code of either sign, the others the rule's code
                    # with the value's sign
                    nan_code = BOUNDARY_CODES[fmt][
                        [math.isnan(v) for v in BOUNDARY].index(True)]
                    ok = True
                    for i, (v, c) in enumerate(zip(BOUNDARY,
                                                   BOUNDARY_CODES[fmt])):
                        for sign, got_c in ((0, int(codes[i])),
                                            (0x80, int(codes[len(vals) + i]))):
                            if math.isinf(v) or math.isnan(v):
                                ok &= (got_c & 0x7F) == nan_code
                            else:
                                ok &= got_c == c | sign
                    row["rule_ok"] = ok
                else:
                    inf = {"fp8_e4m3": (0x7F, 0xFF), "fp8_e5m2": (0x7C, 0xFC)}
                    row["rule_ok"] = (int(codes[len(vals) - 1]),
                                      int(codes[2 * len(vals) - 1])) \
                        == inf[fmt]
                emit(row)
                if diff or encoded or not row["rule_ok"]:
                    fail(f"{name} boundary tensor ({fmt}, lr {lr}): kernel "
                         f"vs plain {diff}, codes vs encode {encoded}, rule "
                         f"{row['rule_ok']}")
    del w, z
    torch.cuda.empty_cache()
    return summary


def phase_standalone(ops, fp32_shards: dict, adam8_shards: dict,
                     steps: int) -> dict:
    """The standalone updates as their user drives them: ``steps``
    in-place steps on each gemma2-2b group's flat shard through
    ``ops.adamw_update`` (the fp32 plan's shards) and
    ``ops.adam8bit_update`` (the adam8bit plan's).  Returns the step times
    (the caller reads the launch counts)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, shards in (("adamw_update", fp32_shards),
                         ("adam8bit_update", adam8_shards)):
        sizes = [TRAIN_LAYERS * shards["layers"], shards["globals"]]
        state = []
        for n in sizes:
            w = torch.randn(n, generator=gen, device="cuda") * 0.05
            mask = (torch.rand(n, generator=gen, device="cuda") < 0.8) \
                .float()
            if name == "adamw_update":
                state.append((w, torch.zeros_like(w), torch.zeros_like(w),
                              mask))
            else:
                state.append((w, torch.zeros(n, dtype=torch.int8,
                                             device="cuda"),
                              torch.zeros(n, dtype=torch.int8, device="cuda"),
                              torch.zeros(n // 1024, device="cuda"),
                              torch.zeros(n // 1024, device="cuda"), mask))
        times = []
        for step in range(steps):
            t = step + 1
            kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
                      c1=1 - 0.9 ** t, c2=1 - 0.95 ** t)
            grads = [torch.randn(n, generator=gen, device="cuda") * 1e-3
                     for n in sizes]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for st, g in zip(state, grads):
                if name == "adamw_update":
                    w, m, v, mask = st
                    ops.adamw_update(w, g, m, v, mask, out=(w, m, v), **kw)
                else:
                    w, m8, v8, ms, vs, mask = st
                    ops.adam8bit_update(w, g, m8, v8, ms, vs, mask,
                                        block=1024,
                                        out=(w, m8, v8, ms, vs), **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del grads
        finite = all(bool(torch.isfinite(st[0]).all()) for st in state)
        out[name] = {"step_ms": times, "finite": finite,
                     "elements": sizes}
        del state
        torch.cuda.empty_cache()
    return out


def counted(mods) -> dict:
    """Every kernel wrapper of the port, by the name its count goes by."""
    fu, bq = mods["fused_update"], mods["blockwise_quant"]
    return {"q8_matmul": mods["q8_matmul"].q8_matmul,
            "adamw_store_update": fu.adamw_store_update,
            "adamw_fp8": fu.adamw_fp8_update,
            "adamw_q8": fu.adamw_q8_update,
            "adamw_update": fu.adamw_update,
            "adam8bit_store_update": fu.adam8bit_store_update,
            "adam8bit_fp8": fu.adam8bit_fp8_update,
            "adam8bit_q8": fu.adam8bit_q8_update,
            "adam8bit_update": fu.adam8bit_update,
            "quantize": bq.quantize,
            "dequantize_into": bq.dequantize_into,
            "dequantize": bq.dequantize,
            "encode_ef": mods["encode_ef"].encode_ef}


def count_plain(ops) -> tuple[dict, object]:
    """Count every call of the plain versions ``kernels.ops`` dispatches
    to (its ``*_ref`` names): returns the counts and a function that puts
    the plain versions back."""
    counts, saved = {}, {}
    for name in dir(ops):
        fn = getattr(ops, name)
        if name.endswith("_ref") and callable(fn):
            saved[name], counts[name] = fn, 0

            def wrapped(*args, _name=name, _fn=fn, **kwargs):
                counts[_name] += 1
                return _fn(*args, **kwargs)

            setattr(ops, name, wrapped)

    def restore():
        for name, fn in saved.items():
            setattr(ops, name, fn)

    return counts, restore


def count_cuda_ops(fn):
    """Run ``fn()`` counting the aten ops it dispatches that write a CUDA
    tensor (views and metadata-only ops excluded), forward and backward
    (the autograd engine carries the mode to its threads), allocations
    without a fill excluded: an eager step's kernel launches, one an op
    (a GEMM or a reduction may launch more).  Returns (fn's result, the
    count, the count by op name)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    by_op: dict = {}

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and "empty" not in func.__name__ and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in (out if isinstance(out, (tuple, list))
                              else (out,))):
                name = func.__name__.split(".")[0]
                by_op[name] = by_op.get(name, 0) + 1
            return out

    with Counter():
        out = fn()
    return out, sum(by_op.values()), by_op


def launches_now(mods) -> dict:
    return {k: fn.launches for k, fn in counted(mods).items()}


def reset_launches(mods) -> None:
    for fn in counted(mods).values():
        fn.launches = 0
    q8mm = mods["q8_matmul"].q8_matmul
    q8mm.decode_launches = q8mm.prefill_launches = 0


def expected_q8_launches(rt, steps: int, keys, micro: int = 1) -> dict:
    """What the q8 path must launch: quantize once per group at init; per
    step a dequantize_into per gather of each of ``micro`` microbatches (a
    layer twice: forward and the backward's re-gather; globals once), an
    fp32 dequantize per reduce-scatter (the one-rank q8 route decodes the
    encoded cotangent), an encode_ef per reduce-scatter (a layer once,
    globals once: once a step, at the accumulation boundary, however many
    microbatches) and one update per group."""
    gathers = sum(2 * lo.n_layers if lo.n_layers else 1
                  for lo in rt.layouts.values())
    reduces = sum(lo.n_layers or 1 for lo in rt.layouts.values())
    groups = len(rt.layouts)
    want = {k: 0 for k in keys}
    want.update(adamw_q8=groups * steps, quantize=groups,
                dequantize_into=gathers * micro * steps,
                dequantize=reduces * steps, encode_ef=reduces * steps)
    return want


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def phase_kernel_q8mm(ops, ref, q8mm) -> dict:
    """``q8_matmul`` against its plain version.  Returns the summaries
    the kernels line carries, summed over one gemma2-2b layer's calls (wq,
    wk, wv, w1, w3; bf16): ``decode`` at M = 4 (one decode step),
    ``decode_m1`` at M = 1 (one ``long_500k`` decode step; fp32 held too)
    and ``prefill`` at M = 2048 (one prefill).  Then the crossover rows:
    both regimes forced at M around ``q8mm.DECODE_MAX_M`` on gemma2-2b's
    shapes, each bitwise against the plain version."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    block = 1024
    summary = {r: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0, "bound_by": b}
               for r, b in (("decode", "bytes"), ("decode_m1", "bytes"),
                            ("prefill", "operations"))}

    def check(got, want, what):
        torch.cuda.synchronize()
        diff = int_view_diff(got, want)
        if diff != 0:
            fail(f"q8_matmul differs from its plain version at {what}: "
                 f"{diff} integer-view steps")
        return diff

    def cost(m, k, n, n_scales, size):
        nbytes = m * k * size + k * n + 4 * n_scales + m * n * size
        nops = 2 * m * k * n
        return nbytes, nops, max(nbytes / HBM_BYTES_PER_S,
                                 nops / INT8_OPS) * 1e3

    for k, n in Q8MM_SHAPES:
        n_scales = -(-(k * n) // block)
        codes = torch.randint(-127, 128, (k, n), generator=gen,
                              device="cuda", dtype=torch.int8)
        scales = torch.rand(n_scales, generator=gen, device="cuda") * 0.02 \
            + 1e-3
        padded = torch.zeros(n_scales * block, device="cuda")
        padded[:k * n] = codes.reshape(-1).float()
        dense_w = (padded.reshape(n_scales, block) * scales[:, None]) \
            .reshape(-1)[:k * n].reshape(k, n)
        long_m = (Q8MM_LONG_M,) if (k, n) in GEMMA_LAYER_Q8MM else ()
        for m in long_m + Q8MM_M:
            for dtype in (torch.bfloat16, torch.float32):
                x = (torch.randn(m, k, generator=gen, device="cuda")
                     * 2.0).to(dtype)
                got = ops.q8_matmul(x, codes, scales, block)
                want = ref.q8_matmul_ref(x, codes, scales, block)
                diff = check(got, want, f"M={m} ({k}, {n}) {dtype}")
                abs_err = float((got.float() - want.float()).abs().max())
                dense_rel = rel_l2(got.float(), x.float() @ dense_w)
                del want
                eager_ms = median_ms(lambda: ops.q8_matmul(
                    x, codes, scales, block), Q8_ITERS)
                ms = graph_ms(lambda: ops.q8_matmul(x, codes, scales, block))
                plain_ms = graph_ms(lambda: ref.q8_matmul_ref(
                    x, codes, scales, block))
                nbytes, nops, bound_ms = cost(m, k, n, n_scales,
                                              x.element_size())
                regime = q8mm.regime_for(m)
                row = {"phase": "kernel_q8mm", "name": "q8_matmul",
                       "regime": regime, "M": m, "K": k, "N": n,
                       "block": block,
                       "case": "A" if n % block == 0 else "B",
                       "dtype": str(dtype)[6:],
                       "max_int_view_diff": diff, "max_abs_err": abs_err,
                       "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms,
                       "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                       >= nops / INT8_OPS else "operations",
                       "bytes": nbytes, "ops": nops,
                       "achieved_TOPs": nops / ms / 1e9,
                       "share_of_bound": bound_ms / ms,
                       "rel_l2_vs_dense": dense_rel,
                       "parity": "bitwise" if diff == 0 else "DIFFERS"}
                if regime == "prefill" and k % 8 == 0:
                    # the int8 GEMM alone, for information (the port never
                    # calls it): the same int8 operands
                    a8 = torch.randint(-127, 128, (m, k), generator=gen,
                                       device="cuda", dtype=torch.int8)
                    row["int_mm_ms"] = graph_ms(
                        lambda: torch._int_mm(a8, codes))
                    del a8
                emit(row)
                calls = GEMMA_LAYER_Q8MM.get((k, n), 0)
                if dtype == torch.bfloat16 and calls:
                    st = summary["decode_m1" if m == Q8MM_LONG_M
                                 else regime]
                    st["max_abs_err"] = max(st["max_abs_err"], abs_err)
                    for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                     ("bound_ms", bound_ms)):
                        st[key] += calls * val
                del x, got
        if (k, n) in GEMMA_LAYER_Q8MM:
            # the crossover: both regimes at the same M, bf16
            for m in Q8MM_CROSSOVER_M:
                x = (torch.randn(m, k, generator=gen, device="cuda")
                     * 2.0).to(torch.bfloat16)
                want = ref.q8_matmul_ref(x, codes, scales, block)
                row = {"phase": "kernel_q8mm_crossover", "M": m, "K": k,
                       "N": n, "dtype": "bfloat16",
                       "bound_ms": cost(m, k, n, n_scales, 2)[2]}
                for regime in ("decode", "prefill"):
                    if regime == "decode" and m > q8mm.DECODE_MAX_M:
                        continue
                    run = lambda: q8mm.q8_matmul(  # noqa: E731
                        x, codes, scales, block, torch.bfloat16,
                        regime=regime)
                    check(run(), want, f"M={m} ({k}, {n}) {regime}")
                    row[f"{regime}_ms"] = graph_ms(run)
                emit(row)
                del x, want
        del codes, scales, padded, dense_w
        torch.cuda.empty_cache()
    return summary


def phase_kernel_q8mm_sliced(ops, ref) -> dict:
    """``q8_matmul`` on ``q8_slice_cols`` slices: each KV head of a
    gemma2-2b wk-shaped ``QuantTensor`` (case B at block 1024: per-row
    scales, block = the slice's width), at decode M = 4 and prefill M =
    2048, bf16, bitwise against the plain version on the same slice.  The
    slice's codes are a contiguous copy (``q8_slice_cols``; the decode
    launch reads rows N codes apart): its time is printed beside the
    kernel's, and the kernel on an unsliced (2304, 256) weight of the same
    layout beside both.  Returns ``{"decode": ..., "prefill": ...}``
    summaries of one head (bf16)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    (k, n), hd, block = Q8MM_SLICED_SHAPE, Q8MM_SLICED_HD, 1024
    n_scales = -(-(k * n) // block)
    codes = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
    scales = torch.rand(n_scales, generator=gen, device="cuda") * 0.02 \
        + 1e-3
    qt = ops.QuantTensor(codes, scales, block)
    # the unsliced weight of the slice's layout (per-row scales)
    flat_codes = torch.randint(-127, 128, (k, hd), generator=gen,
                               device="cuda", dtype=torch.int8)
    flat_scales = torch.rand(k, generator=gen, device="cuda") * 0.02 + 1e-3
    out = {}
    for m in Q8MM_M:
        regime = "decode" if m <= 16 else "prefill"
        x = (torch.randn(m, k, generator=gen, device="cuda") * 2.0) \
            .to(torch.bfloat16)
        heads = []
        for head in range(n // hd):
            sl = ops.q8_slice_cols(qt, head * hd, hd)
            if sl is None or sl.block != hd:
                fail(f"q8_slice_cols gave {sl} for head {head}")
            got = ops.q8_matmul(x, sl.codes, sl.scales, sl.block)
            want = ref.q8_matmul_ref(x, sl.codes, sl.scales, sl.block)
            torch.cuda.synchronize()
            diff = int_view_diff(got, want)
            if diff != 0:
                fail(f"q8_matmul on the sliced head {head} differs from its "
                     f"plain version at M={m}: {diff} integer-view steps")
            heads.append(float((got.float() - want.float()).abs().max()))
            del got, want
        sl = ops.q8_slice_cols(qt, 0, hd)
        ms = graph_ms(lambda: ops.q8_matmul(x, sl.codes, sl.scales,
                                            sl.block))
        slice_ms = median_ms(lambda: ops.q8_slice_cols(qt, 0, hd),
                             Q8_ITERS)
        plain_ms = graph_ms(lambda: ref.q8_matmul_ref(x, sl.codes,
                                                      sl.scales, sl.block))
        unsliced_ms = graph_ms(lambda: ops.q8_matmul(x, flat_codes,
                                                     flat_scales, hd))
        nbytes = m * k * 2 + k * hd + 4 * k + m * hd * 2
        nops = 2 * m * k * hd
        bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / INT8_OPS) * 1e3
        row = {"phase": "kernel_q8mm_sliced", "name": "q8_matmul",
               "regime": regime, "M": m, "K": k, "N": n, "block": block,
               "slice": [hd, "case B -> per-row scales, block", hd],
               "heads": n // hd, "max_int_view_diff": 0,
               "max_abs_err": max(heads), "ms": ms,
               "slice_copy_ms": slice_ms,
               "slice_copy_bytes": 2 * k * hd + 8 * k,
               "plain_ms": plain_ms, "unsliced_ms": unsliced_ms,
               "bound_ms": bound_ms,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
               >= nops / INT8_OPS else "operations",
               "share_of_bound": bound_ms / ms, "parity": "bitwise"}
        emit(row)
        out[regime] = {k2: row[k2] for k2 in (
            "ms", "slice_copy_ms", "plain_ms", "unsliced_ms", "bound_ms",
            "bound_by", "max_abs_err")}
        del x
    del codes, scales, qt, flat_codes, flat_scales
    torch.cuda.empty_cache()
    return out


def hold_update_at(path, rt, fused_update, ref,
                   phase: str = "kernel_recurrent"):
    """Each group's update kernel against its plain version at its shard
    of ``path``'s runtime, in the store's epilogue, on random state: row
    8a (AdamW, the fp32 or bf16 store's flat epilogue) or 9a (8-bit Adam,
    the runtime's optimizer).  These launches compare, they are not the
    path's.  The plain version never sees more than COMPARE_CHUNK
    elements at once: a larger shard is held in pieces of a row
    (``hold_in_chunks``), since its whole fp32 temporaries would not fit
    beside it at the published shards."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)
    scalars = ref.scalar_stack(3e-4, 0.9, 0.95, 1e-8, 0.1,
                               1 - 0.9 ** 3, 1 - 0.95 ** 3)
    adam8 = rt.cfg.optimizer == "adam8bit"
    block = rt.cfg.quant_block
    rows = {}
    for n, lo in rt.layouts.items():
        shape, fmt = lo.local_shape(), lo.store.fmt
        dtype = torch.bfloat16 if fmt == "bf16" else torch.float32
        # the train step hands a bf16 store's gradient over unscaled
        g_scale = torch.tensor(1 / 4094, device="cuda") \
            if fmt == "bf16" else None

        def rnd(scale, shape=shape):
            return torch.randn(shape, generator=gen,
                               device="cuda") * scale

        w, g = rnd(0.05).to(dtype), rnd(1e-3).to(dtype)
        numel = w.numel()
        if adam8:
            m8, ms = ops.quantize(rnd(1e-4), block)
            # v's log-space codes (a plain function, no kernel) a chunk of
            # a row at a time: its temporaries at a whole shard would not
            # fit; a block's codes depend on that block alone
            v, S = rnd(3e-4).square_(), shape[-1]
            v8, vs = torch.empty_like(m8), torch.empty_like(ms)
            for r in range(numel // S):
                for c in range(0, S, COMPARE_CHUNK):
                    e = min(c + COMPARE_CHUNK, S)
                    v8.view(-1, S)[r, c:e], \
                        vs.view(-1, S // block)[r, c // block:e // block] = \
                        ops.quantize_log(v.view(-1, S)[r, c:e], block)
            del v
            mask = (torch.rand(shape[-1], generator=gen, device="cuda")
                    < 0.8).to(torch.uint8)
            ins = (w, g, m8, v8, ms, vs, mask)
            name = "adam8bit_store_update"
            key = "adam8bit_bf16" if fmt == "bf16" else None
            nbytes = (numel * (NEW_BYTES[key] if key else ADAM8_BYTES[fmt])
                      + shape[-1] + numel // block * ADAM8_BLOCK_BYTES[fmt])
            flops = numel * (NEW_FLOPS[key] if key else ADAM8_FLOPS[fmt])

            def run_kernel(ins=ins, fmt=fmt, g_scale=g_scale):
                return fused_update.adam8bit_store_update(
                    *ins, scalars, fmt=fmt, block=block, g_scale=g_scale)

            def plain(*x, fmt=fmt, g_scale=g_scale):
                return ref.adam8bit_store_update_ref(*x, scalars, fmt, block,
                                                     g_scale=g_scale)
        else:
            m, v = rnd(1e-4), rnd(1e-4).square_()
            mask = (torch.rand(shape, generator=gen, device="cuda")
                    < 0.8).float()
            ins = (w, g, m, v, mask)
            name = "adamw_store_update"
            key = "adamw_bf16" if fmt == "bf16" else None
            nbytes = numel * (NEW_BYTES[key] if key else BYTES_PER_ELEM[fmt])
            flops = numel * (NEW_FLOPS[key] if key else FLOPS_PER_ELEM)

            def run_kernel(ins=ins, fmt=fmt, g_scale=g_scale):
                return fused_update.adamw_store_update(
                    *ins, scalars, fmt=fmt, g_scale=g_scale)

            def plain(*x, fmt=fmt, g_scale=g_scale):
                return ref.adamw_store_update_ref(*x, scalars, fmt,
                                                  g_scale=g_scale)
        del w, g
        case = {"path": path, "group": n, "shape": list(shape), "fmt": fmt}
        if numel > COMPARE_CHUNK:
            rows[n] = hold_in_chunks(name, case, run_kernel, plain, ins,
                                     block, nbytes, flops, phase)
        else:
            rows[n] = hold(name, case, run_kernel, lambda: plain(*ins),
                           nbytes, flops, iters=20, phase=phase)
        del ins, run_kernel, plain
        torch.cuda.empty_cache()
    return rows


def hold_in_chunks(name: str, case: dict, run_kernel, plain, ins,
                   block: int, bytes_moved: float, flops: float, phase: str,
                   iters: int = 5) -> dict:
    """``hold`` for a fused update whose plain version runs on COMPARE_CHUNK
    elements of a row at a time: each chunk's result held against its part
    of the kernel's one whole result (integer-view difference, must be 0).
    A piece of each input: a tensor of w's shape by its elements, a
    per-block scale by its blocks, the (S,) decay row every row shares by
    its columns.  The kernel's time is a whole call's, the plain version's
    one pass over the chunks (medians of ``iters``)."""
    import torch

    w = ins[0]
    S = w.shape[-1]

    def piece(t, r, c0, c1):
        if t.shape == w.shape:
            return t.reshape(-1, S)[r, c0:c1]
        if t.dim() == 1 and t.numel() == S:
            return t[c0:c1]
        return t.reshape(-1, S // block)[r, c0 // block:c1 // block]

    spans = [(r, c, min(c + COMPARE_CHUNK, S))
             for r in range(w.numel() // S)
             for c in range(0, S, COMPARE_CHUNK)]
    got = flat_outputs(run_kernel())
    torch.cuda.synchronize()
    diff, err = 0, 0.0
    for r, c0, c1 in spans:
        want = flat_outputs(plain(*(piece(t, r, c0, c1) for t in ins)))
        for a, b in zip(got, want):
            a = piece(a, r, c0, c1)
            diff = max(diff, int_view_diff(a, b))
            err = max(err, abs_err(a, b))
        del want
    del got
    torch.cuda.empty_cache()
    ms = median_ms(run_kernel, iters, warmup=1)

    def plain_pass():
        for r, c0, c1 in spans:
            plain(*(piece(t, r, c0, c1) for t in ins))

    plain_ms = median_ms(plain_pass, iters, warmup=1)
    return held_row(name, {**case, "chunks": len(spans)}, diff, err, ms,
                    plain_ms, bytes_moved, flops, phase)


@contextlib.contextmanager
def vision_gates(runtime_cls):
    """``runtime_cls.init_params`` with the VLM's gates (``x_gate``,
    ``c_gate``) at VISION_GATE, every other tensor as drawn."""
    plain = runtime_cls.__dict__["_init_tensor"]

    def init(spec, seed, layer):
        if spec.name in ("x_gate", "c_gate"):
            return np.full(spec.shape, VISION_GATE, np.float32)
        return plain.__func__(spec, seed, layer)

    runtime_cls._init_tensor = staticmethod(init)
    try:
        yield
    finally:
        runtime_cls._init_tensor = plain


def hold_q8mm_shapes(ops, ref, q8mm, phase: str, calls: dict,
                     extra: dict, seed: int) -> dict:
    """``q8_matmul`` against its plain version at the weights of ``calls``
    ((K, N) -> its calls a decode call (M = 4) and a prefill call (M =
    2048) make) and at ``extra``'s rows ((K, N) -> (M, calls a call)),
    bf16, quant block 1024, each bitwise.  The kernel's device time is
    the replays of a CUDA graph of its calls; the plain version's (a whole
    fp32 dequantized weight a call) an eager call's, timed with CUDA
    events.  Returns the summaries the kernels line carries: a decode
    call's decode-regime launches and a prefill call's launches, summed
    over the calls."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    block = 1024
    summary = {r: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "max_abs_err": 0.0, "bound_by": b}
               for r, b in (("decode", "bytes"), ("prefill", "operations"))}
    for (k, n), n_by_m in calls.items():
        n_scales = -(-(k * n) // block)
        codes = torch.randint(-127, 128, (k, n), generator=gen,
                              device="cuda", dtype=torch.int8)
        scales = torch.rand(n_scales, generator=gen, device="cuda") * 0.02 \
            + 1e-3
        ms_by_m = [(m, c) for m, c in zip(Q8MM_M, n_by_m)]
        if (k, n) in extra:
            ms_by_m.append(extra[k, n])
        # the plain version's rows at a time: its (column groups, rows, K)
        # fp32 temporaries (and their float64 copy) at most 4 GB each; its
        # rows are independent (each quantized by itself)
        rows = max(1, (1 << 30) // (k * (n // block if n % block == 0
                                         else 1)))
        for m, n_calls in ms_by_m:
            x = (torch.randn(m, k, generator=gen, device="cuda") * 2.0) \
                .to(torch.bfloat16)

            def plain(x=x):
                return torch.cat([ref.q8_matmul_ref(x[r:r + rows], codes,
                                                    scales, block)
                                  for r in range(0, x.shape[0], rows)])

            got = ops.q8_matmul(x, codes, scales, block)
            want = plain()
            torch.cuda.synchronize()
            diff = int_view_diff(got, want)
            err = abs_err(got, want)
            del got, want
            if diff != 0:
                fail(f"q8_matmul differs from its plain version at M={m} "
                     f"({k}, {n}): {diff} integer-view steps")
            ms = graph_ms(lambda: ops.q8_matmul(x, codes, scales, block))
            plain_ms = median_ms(plain, iters=5, warmup=1)
            nbytes = m * k * 2 + k * n + 4 * n_scales + m * n * 2
            nops = 2 * m * k * n
            bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / INT8_OPS) * 1e3
            regime = q8mm.regime_for(m)
            emit({"phase": phase, "name": "q8_matmul",
                  "regime": regime, "M": m, "K": k, "N": n, "block": block,
                  "dtype": "bfloat16", "calls_a_call": n_calls,
                  "plain_row_chunk": min(rows, m),
                  "max_int_view_diff": diff, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                  >= nops / INT8_OPS else "operations",
                  "achieved_TOPs": nops / ms / 1e9,
                  "share_of_bound": bound_ms / ms, "parity": "bitwise"})
            st = summary[regime]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("bound_ms", bound_ms)):
                st[key] += n_calls * val
            del x
            torch.cuda.empty_cache()
        del codes, scales
        torch.cuda.empty_cache()
    return summary


def phase_kernel_q8mm_vision(ops, ref, q8mm) -> dict:
    """``q8_matmul`` at the shapes ``serve_vision`` gives it:
    llama-3.2-vision-90b's weights (K, N) at decode M = 4 and prefill M =
    2048 (one vision block's calls), and the cross layer's K and V
    products over 4 x 1,024 patch rows (M = 4096, K = 8192, N = 1024)."""
    return hold_q8mm_shapes(
        ops, ref, q8mm, "kernel_q8mm_vision", VISION_BLOCK_Q8MM,
        {VISION_MEMORY_Q8MM: (VISION_MEMORY_ROWS, VISION_MEMORY_CALLS)}, 5)


def phase_kernel_q8mm_nemotron(ops, ref, q8mm) -> dict:
    """``q8_matmul`` at nemotron-4-340b's layer weights: wq and wo (18432,
    18432), the up projection (18432, 73728) and the down projection
    (73728, 18432) -- K = 73,728, the deepest the int32 accumulator has
    taken, streamed by the decode kernel in chunks of its slab -- at
    decode M = 4 and prefill M = 2048, bf16, bitwise.  wk and wv (18432,
    1536) have no separable scale layout at block 1024: the kernel and the
    plain version must both refuse them with the same ValueError, and
    ``dequantize_into`` (the serve's route for them, bf16 out) is held
    there bitwise instead.  Returns the summaries of a layer's calls, and
    the refusal and the dequantization under ``"kv"``."""
    import torch

    out = hold_q8mm_shapes(ops, ref, q8mm, "kernel_q8mm_nemotron",
                           NEMOTRON_LAYER_Q8MM, {}, 7)
    gen = torch.Generator(device="cuda").manual_seed(8)
    k, n = NEMOTRON_KV
    x = (torch.randn(Q8MM_M[0], k, generator=gen, device="cuda") * 2.0) \
        .to(torch.bfloat16)
    codes = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
    scales = torch.rand(k * n // 1024, generator=gen, device="cuda") * 0.02 \
        + 1e-3
    refused = {}
    for who, fn in (("kernel", ops.q8_matmul), ("plain", ref.q8_matmul_ref)):
        try:
            fn(x, codes, scales, 1024)
        except ValueError as e:
            refused[who] = str(e)
    emit({"phase": "kernel_q8mm_nemotron", "name": "q8_matmul", "K": k,
          "N": n, "block": 1024, "refused": refused,
          "eligible": q8mm.quant_eligible((k, n), 1024)})
    if set(refused) != {"kernel", "plain"} \
            or refused["kernel"] != refused["plain"]:
        fail(f"q8_matmul at ({k}, {n}), block 1024: refusals {refused}")
    flat = codes.reshape(-1)
    numel = flat.numel()
    out["kv"] = hold(
        "dequantize_into", {"path": "kernel_q8mm_nemotron",
                            "shape": [k, n], "out": "bfloat16",
                            "block": 1024},
        lambda: ops.dequantize_into(flat, scales, 1024,
                                    out_dtype=torch.bfloat16),
        lambda: ref.dequantize_into_ref(flat, scales, 1024, torch.bfloat16),
        numel * 3 + 4 * numel / 1024, Q8_FLOPS["dequantize_into"] * numel,
        iters=10, phase="kernel_q8mm_nemotron")
    del x, codes, scales, flat
    torch.cuda.empty_cache()
    return out


def phase_kernel_q8_vision(ops, ref, shards: dict) -> dict:
    """``quantize`` (fp32 masters, the q8_block store's init) and
    ``dequantize_into`` (bf16 out: the ``globals`` gather of every serve
    call, the whole block's gather of the dense serve) at
    llama-3.2-vision-90b's q8_block shards (``shards``: the layers
    group's one block and ``globals``), each bitwise against its plain
    version.  The plain version (block by block, so the same function on
    any cut at block boundaries) runs in chunks of VISION_PLAIN_CHUNK
    elements: at 4.28 G elements its whole-tensor temporaries would not
    fit beside the input; its time is the chunks' total.  Returns the
    summaries the kernels line carries: init (both groups' quantize), and
    the gathers of one int8 and one dense serve call."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(6)
    block = 1024

    def chunked(fn, *xs):
        outs = [fn(*(x[lo:lo + VISION_PLAIN_CHUNK] for x in xs))
                for lo in range(0, xs[0].numel(), VISION_PLAIN_CHUNK)]
        return [torch.cat(parts) for parts in zip(*outs)] \
            if isinstance(outs[0], tuple) else torch.cat(outs)

    out = {}
    for name, n in shards.items():
        x = torch.randn(n, generator=gen, device="cuda") * 0.05
        x[:block] = 0.0                       # an all-zero quant block
        out[("quantize", name)] = hold(
            "quantize", {"path": "serve_vision", "group": name,
                         "shape": [n], "in": "float32", "block": block},
            lambda: ops.quantize(x, block),
            lambda: chunked(lambda c: ref.quantize_ref(c, block), x),
            n * 5 + 4 * n / block, Q8_FLOPS["quantize"] * n, iters=3,
            phase="kernel_q8_vision")
        codes, scales = ops.quantize(x, block)
        del x
        torch.cuda.empty_cache()
        out[("dequantize_into", name)] = hold(
            "dequantize_into", {"path": "serve_vision", "group": name,
                                "shape": [n], "out": "bfloat16",
                                "block": block},
            lambda: ops.dequantize_into(codes, scales, block,
                                        out_dtype=torch.bfloat16),
            lambda: torch.cat([ref.dequantize_into_ref(
                codes[lo:lo + VISION_PLAIN_CHUNK],
                scales[lo // block:(lo + VISION_PLAIN_CHUNK) // block],
                block, torch.bfloat16)
                for lo in range(0, n, VISION_PLAIN_CHUNK)]),
            n * 3 + 4 * n / block, Q8_FLOPS["dequantize_into"] * n, iters=3,
            phase="kernel_q8_vision")
        del codes, scales
        torch.cuda.empty_cache()

    def total(rows):
        return {"ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "max_abs_err": max(r["max_abs_err"] for r in rows)}

    return {"init": total([out["quantize", n] for n in shards]),
            "int8_call": total([out["dequantize_into", "globals"]]),
            "dense_call": total([out["dequantize_into", n] for n in shards])}


def same_bytes(a: Path, b: Path, chunk: int = 1 << 26) -> bool:
    """Whether two files hold the same bytes (read in 64 MiB chunks)."""
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x = fa.read(chunk)
            if x != fb.read(chunk):
                return False
            if not x:
                return True


def files_by_path(ckpt_dir: Path) -> dict:
    """A checkpoint's shard files keyed by what they hold: a parameter
    file by its name, an optimizer file by its leaf path and row (the
    reshard tool numbers optimizer files in its plan's group order, a save
    in the sorted key order)."""
    meta = json.loads((ckpt_dir / "meta.json").read_text())
    shards = ckpt_dir / "shards"
    out = {f.name: f for f in shards.glob("p__*.npy")}
    for e in meta["opt"]:
        for f in shards.glob(e["file"] + "*.npy"):
            out["/".join(e["path"]) + f.name[len(e["file"]):]] = f
    return out


def expected_serve_launches(rt, calls: int, keys) -> dict:
    """What a serve run of ``calls`` prefill/decode calls must launch, from
    the plan: in the int8 mode one ``q8_matmul`` per eligible weight of each
    q8 layer and one ``dequantize_into`` per other tensor (``unpack_quant``),
    else one ``dequantize_into`` per q8 layer gather; ``globals`` one
    dense gather (one ``dequantize_into``) per call."""
    from repro_torch.kernels import ops

    q8mm = deq = 0
    for lo in rt.layouts.values():
        if not lo.store.quantized:
            continue
        layers = lo.n_layers or 1
        if lo.n_layers and rt.schedule.serve_quant_matmul:
            elig = sum(ops.quant_eligible(p.spec.shape, lo.store.block)
                       for p in lo.plan.placements)
            q8mm += elig * layers
            deq += (len(lo.plan.placements) - elig) * layers
        else:
            deq += layers
    want = {k: 0 for k in keys}
    want.update(q8_matmul=q8mm * calls, dequantize_into=deq * calls)
    return want


def start_dryruns(out_dir: Path, only=None) -> dict:
    """The dry runs of phases 6c and 25 (``python -m
    repro_torch.launch.dryrun``) and of the PUBLISHED train phases and
    the LONG500K decodes (``--dry-step``), each in a child process of its
    own (a dry run makes its own fake process group; this process holds
    the NCCL one), all started at once at the lowest priority (the
    phases beside them keep the host's cores): host only, on meta
    tensors, no card visible.  With ``only`` (``--only``'s train and
    long500k phases), the dry steps of those alone."""
    dry = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    runs = {
        "train": dry + ["--arch", "gemma2-2b", "--mesh", "1x1", "--layers",
                        str(TRAIN_LAYERS), "--batch", str(TRAIN_BATCH),
                        "--seq", str(TRAIN_SEQ)],
        "train_cli": dry + ["--arch", "gemma2-2b", "--mesh", "1x1",
                            "--batch", str(CLI_BATCH), "--seq",
                            str(CLI_SEQ)],
        **{f"{arch}/{shape}" + ("/multi_pod" if mp else ""):
           dry + ["--arch", arch, "--shape", shape, "--verify"]
           + (["--multi-pod"] if mp else [])
           for arch, shape, mp in DRYRUN_PRODUCTION},
        "plan_only": dry + ["--plan-only", "--all"],
    } if only is None else {}
    runs.update({name: [sys.executable, str(Path(__file__).resolve()),
                        DRY_STEP_ARG, name]
                 for name in ([*PUBLISHED, *LONG500K] if only is None
                              else only)})
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = {}
    for i, (name, cmd) in enumerate(runs.items()):
        log = open(out_dir / f"{i}.log", "w")
        if cmd[:3] == dry:
            cmd = cmd + ["--out", str(out_dir / f"{i}.jsonl")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT, env=env,
                                        cwd=str(ROOT),
                                        preexec_fn=lambda: os.nice(19)),
                       log, out_dir / f"{i}.log", time.time())
    # a phase that fails before ``finish_dryruns`` still stops them
    atexit.register(stop_dryruns, procs)
    return procs


def run_reference() -> float:
    """Phases 10 (17 with it), 20, 13, 30, 26b and 35 in a child process
    (this script with ``REFERENCE_ARG``, the same pins, the same card) and,
    beside it, 13b in a second (``REFERENCE_LONG_ARG``: its CPU half at
    published width takes the cores the small reduced runs leave idle):
    the first's lines join this script's output as they come, the
    second's when it ends, and a failure of either is this script's.
    Returns their seconds."""
    t0 = time.perf_counter()
    script = str(Path(__file__).resolve())
    with tempfile.TemporaryFile("w+") as err, \
            tempfile.TemporaryFile("w+") as long_out, \
            tempfile.TemporaryFile("w+") as long_err:
        long = subprocess.Popen([sys.executable, script, REFERENCE_LONG_ARG],
                                stdout=long_out, stderr=long_err, text=True,
                                cwd=str(ROOT))
        proc = subprocess.Popen([sys.executable, script, REFERENCE_ARG],
                                stdout=subprocess.PIPE, stderr=err, text=True,
                                cwd=str(ROOT))
        try:
            for line in proc.stdout:
                print(line, end="", flush=True)
            rc, long_rc = proc.wait(), long.wait()
        finally:
            for p in (proc, long):
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in (long_out, err, long_err):
            f.seek(0)
            texts.append(f.read())
    print(texts[0], end="", flush=True)
    if rc != 0:
        fail(f"the reference phases exited {rc}: {texts[1][-3000:]}")
    if long_rc != 0:
        fail(f"phase 13b exited {long_rc}: {texts[2][-3000:]}")
    return time.perf_counter() - t0


def stop_dryruns(procs: dict) -> None:
    for proc, log, _, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def finish_dryruns(procs: dict) -> dict:
    """Wait for every dry run child (killing all of them on a failure):
    ``{name: {"row": the last JSON row or None, "rows": every row,
    "text": its output, "seconds": its wall time, start to its last
    output}}``."""
    out = {}
    try:
        for name, (proc, log, path, t0) in procs.items():
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
            log.close()
            text = path.read_text()
            if rc != 0:
                fail(f"dry run {name} exited {rc}: {text[-3000:]}")
            rows = [json.loads(l) for l in text.splitlines()
                    if l.startswith('{"arch"')]
            out[name] = {"row": rows[-1] if rows else None, "rows": rows,
                         "text": text,
                         "seconds": path.stat().st_mtime - t0}
    finally:
        stop_dryruns(procs)
    return out


def main() -> None:
    if DRY_STEP_ARG in sys.argv[1:]:
        dry_step_main(sys.argv[sys.argv.index(DRY_STEP_ARG) + 1])
        return
    only = None
    if ONLY_ARG in sys.argv[1:]:
        only = sys.argv[sys.argv.index(ONLY_ARG) + 1].split(",")
        if not set(only) <= {*PUBLISHED_PHASES, *LONG500K} or (
                "serve_granite" in only and "train_granite" not in only):
            fail(f"{ONLY_ARG} takes phases of {PUBLISHED_PHASES} "
                 f"(serve_granite with train_granite) and {tuple(LONG500K)}"
                 f", got {only}")
    t_script = time.perf_counter()
    # the CPU reference's pins (MKL's reproducible mode, a fixed thread
    # count), set before torch loads MKL: the parity phases repeat the CPU
    # runs bitwise
    pinned = None
    if (SRC / "repro_torch").is_dir():
        sys.path.insert(0, str(SRC))
        from repro_torch.launch.repeatability import pin_cpu

        pinned = pin_cpu()
    import torch

    # ---- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a card")
    if pinned is None:
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import build_model, get_config
    from repro_torch.core.fsdp import FSDPRuntime, GatheredMeter
    from repro_torch.core.policy import CostModel, plan
    from repro_torch.core.profile import load_profile
    from repro_torch.core.reshard import GroupIndex, buffer_reader
    from repro_torch.core.schedule import (APPROX_VARIANTS, VARIANTS,
                                           CommSchedule)
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import (blockwise_quant, build, encode_ef,
                                     fused_update, ops, q8_matmul, ref)
    from repro_torch.launch import auto_decisions, bench_comm, mesh
    from repro_torch.launch.mesh import init_local_group
    from repro_torch.optim import make_optimizer
    from repro_torch.serve.engine import Request, ServeEngine

    mods = {"fused_update": fused_update, "blockwise_quant": blockwise_quant,
            "encode_ef": encode_ef, "q8_matmul": q8_matmul}

    class TimedUpdate:
        """An optimizer whose ``update`` is timed on the host between two
        synchronisations (its own ms inside the train step)."""

        def __init__(self, opt, ms):
            self.opt, self.ms = opt, ms

        def update(self, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.opt.update(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

    def train(cfg, device, compute_dtype, stream, steps, schedule=None,
              timings=None, seed=0, check=None, keep=None,
              time_update=False, planner="ragged", group_schedules=None,
              init=None, keep_init=None, meter=False, policies=None,
              cost_model=None):
        """The quickstart loop through the public API; returns (metrics
        per step, step ms, runtime) and, into ``timings``, the set-up
        seconds (runtime, init, optimizer state) and, with
        ``time_update``, each step's ``update_ms``; ``check(rt, params)``
        sees the final state, and ``keep`` (a dict) receives it with the
        optimizer and its state.  ``init(rt)`` makes the parameters in place of
        ``rt.init_params(seed)``; ``keep_init`` (a dict) receives host
        copies of the initial masters with their layouts; ``meter``
        attaches a ``GatheredMeter`` (``rt.gathered_meter``).  Batches are
        made and placed outside the timed region."""
        t_setup = time.perf_counter()
        rt = FSDPRuntime(build_model(cfg), group,
                         compute_dtype=compute_dtype, device=device,
                         schedule=schedule, planner=planner,
                         group_schedules=group_schedules,
                         policies=policies, cost_model=cost_model)
        if meter:
            rt.gathered_meter = GatheredMeter()
        params = init(rt) if init is not None else rt.init_params(seed)
        if keep_init is not None:
            keep_init.update({
                n: ((p["master"] if isinstance(p, dict) else p).detach()
                    .cpu(), rt.layouts[n]) for n, p in params.items()})
        opt = make_optimizer(cfg)
        opt_state = opt.init(rt)
        if timings is not None:
            timings["setup_s"] = time.perf_counter() - t_setup
            if time_update:
                opt = TimedUpdate(opt, timings.setdefault("update_ms", []))
        step_fn = rt.make_train_step(opt)
        out, times, step = [], [], 0
        for i in range(steps):
            batch = stream.shard(stream.batch(i), rt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, step, m = step_fn(params, opt_state, step,
                                                 batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            out.append({k: float(v) for k, v in m.items()})
        if check is not None:
            check(rt, params)
        if keep is not None:
            keep.update(params=params, opt_state=opt_state, optimizer=opt)
        return out, times, rt

    def run_ckpt_phase(ck_cfg, ck_dir: Path, ck_bytes: int,
                       keep: dict) -> dict:
        """Phase 24: the save/resume, cross-format and offline-reshard
        checks of gemma2-2b at ``CKPT_LAYERS`` layers; returns the phase's
        kernel launches (those made only to compare are not counted) and
        keeps the uninterrupted run's last steps and final host masters in
        ``keep`` for phase 24b."""
        path = ck_dir / "ckpt"
        n_groups = 2

        def init(rt):
            # train's host masters, layer rows cut to this depth (a layer's
            # init does not depend on the model's depth)
            out = {}
            for n, lo in rt.layouts.items():
                t, src = host_init[n]
                if src.plan != lo.plan:
                    fail(f"ckpt: group {n}'s plan differs from train's")
                t = t[:lo.n_layers] if lo.n_layers else t
                out[n] = lo.store.create(
                    t.to(rt.device).requires_grad_(True))
            return out

        def run(rt, opt, params, opt_state, first, n):
            step_fn = rt.make_train_step(opt)
            out, step = [], first
            for i in range(first, first + n):
                batch = stream.shard(stream.batch(i), rt)
                params, opt_state, step, m = step_fn(params, opt_state,
                                                     step, batch)
                out.append((float(m["loss"]), float(m["grad_norm"])))
            return params, opt_state, out

        def masters(params):
            return {n: (p["master"] if isinstance(p, dict) else p).detach()
                    for n, p in params.items()}

        meta_groups = {}

        def master_matches(params, rt, src_path) -> bool:
            """Every tensor of every layer of ``params``' masters bitwise
            the one saved under ``src_path`` (read through both
            layouts' shard indices)."""
            if not meta_groups:
                meta = json.loads((src_path / "meta.json").read_text())
                meta_groups.update(meta["groups"])
            src_idx = {g: GroupIndex.from_meta(sg)
                       for g, sg in meta_groups.items()}
            owner = {t: g for g, sg in meta_groups.items()
                     for t in sg["index"]}
            for n, lo in rt.layouts.items():
                host = masters(params)[n].float().cpu().numpy()
                dst = GroupIndex.from_layout(lo)
                read_dst = buffer_reader(host, dst.num_rows)
                for name in lo.plan.names:
                    g = owner[name]
                    read_src = ckpt.group_master_reader(src_path / "shards", g)
                    for li in (range(lo.n_layers) if lo.n_layers
                               else [None]):
                        a = dst.read_tensor(name, read_dst, li)
                        b = src_idx[g].read_tensor(name, read_src, li)
                        if not np.array_equal(a.view(np.uint32),
                                              b.view(np.uint32)):
                            return False
            return True

        def since(before):
            now = launches_now(mods)
            return {k: now[k] - before[k] for k in now}

        reset_launches(mods)
        # the uninterrupted run: two steps, save, two more
        rt = FSDPRuntime(build_model(ck_cfg), group,
                         compute_dtype=torch.bfloat16, device="cuda")
        opt = make_optimizer(ck_cfg)
        params, opt_state, first = run(rt, opt, init(rt), opt.init(rt), 0,
                                       CKPT_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(path, rt, params, opt_state, step=CKPT_STEPS)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
        params, opt_state, second = run(rt, opt, params, opt_state,
                                        CKPT_STEPS, CKPT_STEPS)
        want_master = masters(params)
        keep.update(second=second, master={n: t.cpu() for n, t in
                                            want_master.items()},
                    run=run, masters=masters)
        del params, opt_state, rt
        torch.cuda.empty_cache()

        # the resumed run: a fresh runtime loads the checkpoint
        rt = FSDPRuntime(build_model(ck_cfg), group,
                         compute_dtype=torch.bfloat16, device="cuda")
        opt = make_optimizer(ck_cfg)
        like = opt.init(rt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, step, opt_state = ckpt.load(path, rt, like)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del like
        params, opt_state, resumed = run(rt, opt, params, opt_state, step,
                                         CKPT_STEPS)
        got = masters(params)
        resume_master = all(torch.equal(got[n], want_master[n])
                            for n in want_master)
        del params, opt_state, rt, got, want_master
        torch.cuda.empty_cache()

        # the format's floor: one np.save of a contiguous buffer of the
        # checkpoint's bytes to the same disk
        buf = np.ones(ck_bytes // 4, np.float32)
        t0 = time.perf_counter()
        np.save(ck_dir / "floor.npy", buf)
        floor_s = time.perf_counter() - t0
        (ck_dir / "floor.npy").unlink()
        del buf

        # the cross-format restore: the q8_block store, q8 gradient wire
        rt = FSDPRuntime(build_model(ck_cfg), group,
                         compute_dtype=torch.bfloat16, device="cuda",
                         schedule=CommSchedule(**Q8_SCHEDULE))
        before = launches_now(mods)
        t0 = time.perf_counter()
        params, step = ckpt.load(path, rt)
        torch.cuda.synchronize()
        q8_load_s = time.perf_counter() - t0
        q8_load_launches = since(before)
        q8_master = master_matches(params, rt, path)
        # compare the codes with ops.quantize(master) on the card; these
        # launches are the comparison's, not the path's
        snap = launches_now(mods)
        codes_ok, ef_zero = True, True
        for n, lo in rt.layouts.items():
            codes, scales = ops.quantize(params[n]["master"].detach(),
                                         lo.store.block)
            codes_ok &= (torch.equal(codes, params[n]["codes"])
                         and torch.equal(scales, params[n]["scales"]))
            ef_zero &= not bool(params[n]["reduce_ef"].count_nonzero())
        for k, fn in counted(mods).items():
            fn.launches = snap[k]
        opt = make_optimizer(ck_cfg)
        params, _, q8_step = run(rt, opt, params, opt.init(rt), step, 1)
        q8_launches_total = since(before)
        q8_want = expected_q8_launches(rt, 1, q8_launches_total)
        del params, rt
        torch.cuda.empty_cache()

        # the offline tool: ragged -> fsdp2, no optimizer state
        dst = ck_dir / "fsdp2"
        cmd = [sys.executable, "-m", "repro_torch.tools.reshard", str(path),
               str(dst), "--arch", ck_cfg.name, "--full", "--layers",
               str(CKPT_LAYERS), "--data", "1", "--planner", "fsdp2",
               "--drop-opt"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        tool = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=900)
        tool_s = time.perf_counter() - t0
        if tool.returncode:
            fail(f"ckpt: the reshard tool exited {tool.returncode}: "
                 f"{tool.stderr[-2000:]}")
        rt = FSDPRuntime(build_model(ck_cfg), group,
                         compute_dtype=torch.bfloat16, device="cuda",
                         planner="fsdp2")
        params, _ = ckpt.load(dst, rt)
        tool_plan = ckpt.load_plan(dst).dumps() == rt.plan.dumps()
        tool_master = master_matches(params, rt, path)
        del params, rt
        shutil.rmtree(dst)
        torch.cuda.empty_cache()
        total = launches_now(mods)
        res = {"phase": "ckpt", "steps": [CKPT_STEPS, CKPT_STEPS],
               "uninterrupted": first + second,
               "resumed": first + resumed,
               "bitwise_stream": resumed == second,
               "bitwise_master": resume_master,
               "checkpoint_bytes_on_disk": disk,
               "save_s": save_s, "save_gb_per_s": disk / save_s / 1e9,
               "load_s": load_s, "load_gb_per_s": disk / load_s / 1e9,
               "np_save_floor_s": floor_s,
               "np_save_floor_gb_per_s": ck_bytes / floor_s / 1e9,
               "q8_restore": {"load_s": q8_load_s, "master_exact": q8_master,
                              "codes_bitwise_quantize": codes_ok,
                              "ef_zero": ef_zero, "step": q8_step,
                              "load_launches": q8_load_launches,
                              "launches": q8_launches_total,
                              "expected_launches": q8_want},
               "tool": {"cmd": " ".join(cmd[1:]), "seconds": tool_s,
                        "plan_equal": tool_plan,
                        "master_bitwise": tool_master,
                        "stdout": tool.stdout.splitlines()[-4:]},
               "kernel_launches": total}
        emit(res)
        if resumed != second or not resume_master:
            fail("ckpt: the resumed run is not bitwise the uninterrupted one")
        if not (q8_master and codes_ok and ef_zero):
            fail(f"ckpt: cross-format restore master {q8_master}, codes "
                 f"{codes_ok}, residual zero {ef_zero}")
        if q8_load_launches["quantize"] != n_groups \
                or q8_launches_total != q8_want:
            fail(f"ckpt: the q8 restore and step launched "
                 f"{q8_launches_total}, expected {q8_want}")
        if not all(math.isfinite(v) for v in q8_step[0]):
            fail(f"ckpt: the step after the q8 restore gave {q8_step}")
        if not (tool_plan and tool_master):
            fail(f"ckpt: the resharded checkpoint's plan {tool_plan}, "
                 f"master {tool_master}")
        want_adamw = n_groups * (3 * CKPT_STEPS)
        if total["adamw_store_update"] != want_adamw:
            fail(f"ckpt: adamw_store_update launched "
                 f"{total['adamw_store_update']}, expected {want_adamw}")
        return total

    def run_ckpt_tp_phase(ck_cfg, ck_dir: Path, keep: dict) -> dict:
        """Phase 24b: the checkpoint across TP degrees.  The offline tool
        rewrites phase 24's tp-1 checkpoint for tp ``CKPT_TP`` on a model
        axis of as many ranks (wk and wv move into ``layers_rep``) and back
        to tp 1, whose master and moment files must be the original's byte
        for byte; the tp-``CKPT_TP`` checkpoint then loads straight onto
        the card's one-rank tp-1 runtime (the cross-TP streaming path) and
        resumes: the stream and the final master must be bitwise phase
        24's uninterrupted run.  Returns the resume's kernel launches."""
        path = ck_dir / "ckpt"
        tp_dir, back_dir = ck_dir / f"tp{CKPT_TP}", ck_dir / "tp1"
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))

        def tool(src, dst, *extra):
            cmd = [sys.executable, "-m", "repro_torch.tools.reshard",
                   str(src), str(dst), "--arch", ck_cfg.name, "--full",
                   "--layers", str(CKPT_LAYERS), "--data", "1", *extra]
            t0 = time.perf_counter()
            done = subprocess.run(cmd, env=env, capture_output=True,
                                  text=True, timeout=900)
            secs = time.perf_counter() - t0
            if done.returncode:
                fail(f"ckpt_tp: the reshard tool exited {done.returncode}: "
                     f"{done.stderr[-2000:]}")
            return {"cmd": " ".join(cmd[3:]), "seconds": secs,
                    "stdout": done.stdout.splitlines()[-2:]}

        to_tp = tool(path, tp_dir, "--model", str(CKPT_TP), "--tp",
                     str(CKPT_TP))
        meta = json.loads((tp_dir / "meta.json").read_text())["groups"]
        layout = {g: {"outer_size": m["outer_size"],
                      "tensors": sorted(m["index"])}
                  for g, m in meta.items()}
        moved = ("layers_rep" in meta
                 and {"wk", "wv"} <= set(meta["layers_rep"]["index"])
                 and meta["layers"]["outer_size"] == CKPT_TP)
        back = tool(tp_dir, back_dir, "--tp", "1")
        names, back_names = files_by_path(path), files_by_path(back_dir)
        t0 = time.perf_counter()
        same_files = sorted(names) == sorted(back_names) and all(
            same_bytes(f, back_names[k]) for k, f in names.items())
        compare_s = time.perf_counter() - t0
        shutil.rmtree(back_dir)

        reset_launches(mods)
        rt = FSDPRuntime(build_model(ck_cfg), group,
                         compute_dtype=torch.bfloat16, device="cuda")
        opt = make_optimizer(ck_cfg)
        like = opt.init(rt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, step, opt_state = ckpt.load(tp_dir, rt, like)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del like
        params, opt_state, resumed = keep["run"](rt, opt, params, opt_state,
                                                 step, CKPT_STEPS)
        got = keep["masters"](params)
        resume_master = all(torch.equal(got[n].cpu(), keep["master"][n])
                            for n in keep["master"])
        total = launches_now(mods)
        del params, opt_state, rt, got
        torch.cuda.empty_cache()
        want = {k: 0 for k in total}
        want["adamw_store_update"] = 2 * CKPT_STEPS
        res = {"phase": "ckpt_tp", "tp": CKPT_TP, "layout": layout,
               "kv_moved_to_layers_rep": moved, "to_tp": to_tp,
               "back_to_tp1": back, "files": len(names),
               "round_trip_byte_identical": same_files,
               "compare_s": compare_s, "load_s": load_s, "step": step,
               "uninterrupted": keep["second"], "resumed": resumed,
               "bitwise_stream": resumed == keep["second"],
               "bitwise_master": resume_master,
               "kernel_launches": total, "expected_launches": want}
        emit(res)
        if not moved:
            fail(f"ckpt_tp: the tp-{CKPT_TP} checkpoint's layout {layout}")
        if not same_files:
            fail("ckpt_tp: the tp-1 -> tp-8 -> tp-1 round trip's files are "
                 "not the original's byte for byte")
        if step != CKPT_STEPS or resumed != keep["second"] \
                or not resume_master:
            fail("ckpt_tp: the resume from the tp-8 checkpoint is not "
                 "bitwise the uninterrupted run")
        if total != want:
            fail(f"ckpt_tp: the resume launched {total}, expected {want}")
        return total

    def serve_cross(rt, params, batch, extra, max_len):
        """A warm-up prefill and a timed one of ``batch`` (each into a fresh
        cache), then CROSS_SERVE_STEPS greedy decode steps at a scalar
        index, each given ``extra`` (the VLM's patches) beside its token.
        Returns the readings and the timed prefill's logits."""
        prefill, decode = rt.make_prefill_step(), rt.make_decode_step()
        B, P = batch["tokens"].shape
        prefill(params, batch, rt.init_cache(B, max_len))      # warm-up
        cache = rt.init_cache(B, max_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, cache)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        if tuple(logits.shape) != (B, 1, rt.cfg.vocab):
            fail(f"{rt.cfg.name}: prefill logits {tuple(logits.shape)}")
        tok, gen, dec_ms = torch.argmax(logits, -1), [], []
        for i in range(CROSS_SERVE_STEPS):
            t0 = time.perf_counter()
            lg, cache = decode(params, {"tokens": tok, **extra}, cache,
                               P + i)
            tok = torch.argmax(lg, -1)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            gen.append(tok)
        if not bool(torch.isfinite(lg.float()).all()):
            fail(f"{rt.cfg.name}: non-finite decode logits")
        gen = torch.cat(gen, 1).cpu()
        if not (0 <= int(gen.min()) and int(gen.max()) < rt.cfg.vocab):
            fail(f"{rt.cfg.name}: decoded tokens out of the vocabulary")
        med = statistics.median(dec_ms[1:])
        return ({"prefill": [B, P], "cache_len": max_len,
                 "prefill_ms": pre_ms, "decode_step_ms": dec_ms,
                 "decode_step_ms_median": med,
                 "decode_tokens_per_s": B / (med / 1e3),
                 "greedy_row0": gen[0].tolist()}, logits)

    def parity_crossattn() -> None:
        """Phase 35: seamless-m4t-medium.reduced() and
        llama-3.2-vision-90b.reduced() (its gates at VISION_GATE), fp32,
        card against CPU: a PARITY_CROSS_STEPS-step train stream per seed
        (losses and grad norms) and a prefill of 4 x 16 with
        PARITY_SERVE_STEPS teacher-forced decode steps (each call's
        logits)."""
        for arch in (SEAMLESS, VISION):
            pc = get_config(arch).reduced()
            key = "frames" if pc.arch_type == "audio" else "patches"
            rows = pc.n_frames if key == "frames" else pc.n_patches
            train_read, serve_read = [], []
            with vision_gates(FSDPRuntime):
                for seed in PARITY_CROSS_SEEDS:
                    data = SyntheticStream(DataConfig(pc.vocab, 64, 8,
                                                      seed=seed), pc)
                    runs = {dev: train(pc, dev, torch.float32, data,
                                       PARITY_CROSS_STEPS, seed=seed)[0]
                            for dev in ("cpu", "cuda")}
                    train_read.append(max(
                        abs(a[k] - b[k]) / abs(b[k])
                        for a, b in zip(runs["cuda"], runs["cpu"])
                        for k in ("loss", "grad_norm")))
                    rng = np.random.default_rng(seed)
                    toks = torch.from_numpy(rng.integers(
                        0, pc.vocab, (4, 16 + PARITY_SERVE_STEPS)))
                    mem = torch.from_numpy(rng.normal(
                        size=(4, rows, pc.d_model))).to(torch.bfloat16)
                    outs = {}
                    for dev in ("cpu", "cuda"):
                        srt = FSDPRuntime(build_model(pc), group,
                                          compute_dtype=torch.float32,
                                          device=dev)
                        sp = srt.init_params(seed)
                        cache = srt.init_cache(4, 32)
                        t, m = toks.to(srt.device), mem.to(srt.device)
                        extra = {key: m} if key == "patches" else {}
                        lg, cache = srt.make_prefill_step()(
                            sp, {"tokens": t[:, :16], key: m}, cache)
                        out = [lg]
                        dec = srt.make_decode_step()
                        for i in range(16, 16 + PARITY_SERVE_STEPS):
                            lg, cache = dec(sp, {"tokens": t[:, i:i + 1],
                                                 **extra}, cache, i)
                            out.append(lg)
                        outs[dev] = torch.cat(out, 1).float().cpu()
                    serve_read.append(max(
                        rel_l2(outs["cuda"][:, i], outs["cpu"][:, i])
                        for i in range(outs["cpu"].shape[1])))
            emit({"phase": "parity_crossattn", "config": f"{arch}.reduced()",
                  "compute": "float32", "seeds": list(PARITY_CROSS_SEEDS),
                  "train_steps": PARITY_CROSS_STEPS,
                  "train_max_rel_diff": train_read,
                  "train_rtol": PARITY_CROSS_RTOL,
                  "serve_max_rel_l2": serve_read,
                  "serve_rtol": PARITY_CROSS_SERVE_RTOL})
            if not (max(train_read) <= PARITY_CROSS_RTOL
                    and max(serve_read) <= PARITY_CROSS_SERVE_RTOL):
                fail(f"parity_crossattn {arch}: CPU and card differ by "
                     f"{max(train_read)} (train) / {max(serve_read)} "
                     f"(serve)")

    def reference_phases() -> None:
        """Phases 10 (17 with it), 20, 13, 30, 26b and 35: the card held
        against the CPU reference (the plain versions), run by
        ``--reference`` in a process of its own (``run_reference``).  A
        reference must not depend on what its process did before: the
        first CPU run in this long-lived process has been seen, rarely,
        to give a stream that no fresh process gives (ROADMAP Queue
        3)."""
        # ---- 10. CPU (plain versions) vs card (kernels) --------------------
        small = get_config("gemma2-2b").reduced()
        moe_small = get_config(MOE).reduced()
        from repro_torch.quant.fp8 import fp8_encode

        def codes_of_master(rt, params):
            """On either device: every fp8 state's codes are bitwise the
            encode of its master."""
            for name, st in params.items():
                fmt = rt.layouts[name].store.fmt
                if fmt in FP8_FMTS and int_view_diff(
                        st["codes"], fp8_encode(st["master"], fmt)):
                    fail(f"{name}: fp8 codes differ from the encode of the "
                         f"master on {rt.device}")

        parity_cases = [
            ("parity", small, None, PARITY_RTOL),
            ("parity_q8", small, Q8_SCHEDULE, PARITY_Q8_RTOL),
            ("parity_moe", moe_small, None, PARITY_RTOL),
            ("parity_moe", moe_small, ADAM8_Q8_SCHEDULE, PARITY_Q8_RTOL),
            ("parity_micro", dataclasses.replace(small, parallel=dataclasses
                                                 .replace(small.parallel,
                                                          microbatches=2)),
             Q8_SCHEDULE, PARITY_Q8_RTOL)]
        parity_cases += [
            ("parity_fp8", dataclasses.replace(small, optimizer=opt_name),
             sched, PARITY_FP8_RTOL)
            for sched, opt_name in FP8_SCHEDULES.values()]
        for phase, model, sched, rtol in parity_cases:
            readings, streams = [], {}
            for seed in PARITY_SEEDS:
                data = SyntheticStream(
                    DataConfig(model.vocab, 64, 8, seed=seed), model)
                runs = {dev: train(model, dev, torch.float32, data, 2,
                                   sched and CommSchedule(**sched),
                                   seed=seed, check=codes_of_master)[0]
                        for dev in ("cpu", "cuda")}
                if phase == "parity":
                    for dev, first in runs.items():
                        again = train(model, dev, torch.float32, data, 2,
                                      seed=seed)[0]
                        if again != first:
                            fail(f"parity: seed {seed} is not bitwise "
                                 f"repeatable on {dev}: {first} then "
                                 f"{again}")
                    streams[seed] = {
                        dev: [[m["loss"], m["grad_norm"]] for m in run]
                        for dev, run in runs.items()}
                readings.append(max(
                    abs(a[k] - b[k]) / abs(b[k])
                    for a, b in zip(runs["cuda"], runs["cpu"])
                    for k in ("loss", "grad_norm")))
            emit({"phase": phase, "config": f"{model.name}.reduced()",
                  "optimizer": model.optimizer,
                  "schedule": sched or "default", "compute": "float32",
                  "seeds": list(PARITY_SEEDS), "max_rel_diff": readings,
                  "rtol": rtol, "repeated_bitwise": phase == "parity",
                  **({"streams": streams} if streams else {})})
            if not max(readings) <= rtol:
                fail(f"{phase}: CPU and card runs differ by "
                     f"{max(readings)} > {rtol}")

        # ---- 20. the optimizers: CPU vs card, each repeating bitwise -------
        qwen_small = get_config(QWEN).reduced()

        def codes_of_q8_master(rt, params):
            """On either device: every q8_block state's codes and scales are
            bitwise the plain quantization of its master."""
            for name, st in params.items():
                store = rt.layouts[name].store
                if store.quantized and any(
                        int_view_diff(a, b) for a, b in zip(
                            (st["codes"], st["scales"]),
                            ref.quantize_ref(st["master"], store.block))):
                    fail(f"{name}: q8 codes differ from the quantization of "
                         f"the master on {rt.device}")

        for case, opt_name, sched in PARITY_OPTIM_CASES:
            pcfg = dataclasses.replace(qwen_small, optimizer=opt_name,
                                       learning_rate=PARITY_OPTIM_LR)
            data = SyntheticStream(DataConfig(pcfg.vocab, 64, 8), pcfg)
            runs = {}
            for dev in ("cpu", "cuda"):
                for rep in range(2):
                    kept = {}
                    metrics = train(pcfg, dev, torch.float32, data,
                                    PARITY_OPTIM_STEPS,
                                    sched and CommSchedule(**sched), keep=kept,
                                    check=codes_of_q8_master)[0]
                    masters = {
                        n: (p["master"] if isinstance(p, dict) else p)
                        .detach().cpu() for n, p in kept["params"].items()}
                    if rep == 0:
                        runs[dev] = (metrics, masters)
                    elif metrics != runs[dev][0] or any(
                            int_view_diff(masters[n], runs[dev][1][n])
                            for n in masters):
                        fail(f"parity_optim {case}: not bitwise repeatable "
                             f"on {dev}")
            (cm, cmaster), (gm, gmaster) = runs["cpu"], runs["cuda"]
            stream_diff = max(abs(a[k] - b[k]) / abs(b[k])
                              for a, b in zip(gm, cm)
                              for k in ("loss", "grad_norm"))
            master_diff = max(rel_l2(gmaster[n], cmaster[n]) for n in cmaster)
            emit({"phase": "parity_optim", "config": f"{QWEN}.reduced()",
                  "case": case, "optimizer": opt_name,
                  "schedule": sched or "default", "compute": "float32",
                  "steps": PARITY_OPTIM_STEPS, "lr": PARITY_OPTIM_LR,
                  "max_rel_diff": stream_diff, "rtol": PARITY_OPTIM_RTOL[case],
                  "master_rel_l2": master_diff,
                  "master_limit": PARITY_OPTIM_MASTER[case],
                  "losses": {"cpu": [m["loss"] for m in cm],
                             "cuda": [m["loss"] for m in gm]},
                  "repeated_bitwise": True})
            if not (stream_diff <= PARITY_OPTIM_RTOL[case]
                    and master_diff <= PARITY_OPTIM_MASTER[case]):
                fail(f"parity_optim {case}: CPU and card differ by "
                     f"{stream_diff} (streams) / {master_diff} (masters)")
            if cm[-1]["loss"] == cm[0]["loss"]:
                fail(f"parity_optim {case}: the loss did not move")

        # ---- 13. serve: CPU (plain versions) vs card (kernels) -------------
        moe_dropless = dataclasses.replace(
            moe_small, capacity_factor=float(moe_small.n_experts))
        for model_cfg in (small, moe_dropless):
            for store, sched in (("fp32", None),
                                 ("q8_matmul", SERVE_SCHEDULE)):
                readings, greedy = [], []
                for seed in PARITY_SEEDS:
                    toks = torch.from_numpy(
                        np.random.default_rng(seed).integers(
                            0, model_cfg.vocab,
                            (4, 16 + PARITY_SERVE_STEPS)))
                    outs = {}
                    for dev in ("cpu", "cuda"):
                        model = build_model(model_cfg)
                        srt = FSDPRuntime(
                            model, group, compute_dtype=torch.float32,
                            device=dev,
                            schedule=sched and CommSchedule(**sched))
                        params = srt.init_params(seed)
                        cache = srt.init_cache(4, 32)
                        t = toks.to(srt.device)
                        lg, cache = srt.make_prefill_step()(
                            params, {"tokens": t[:, :16]}, cache)
                        out = [lg]
                        decode = srt.make_decode_step()
                        for i in range(16, 16 + PARITY_SERVE_STEPS):
                            lg, cache = decode(
                                params, {"tokens": t[:, i:i + 1]}, cache, i)
                            out.append(lg)
                        outs[dev] = torch.cat(out, 1).float().cpu()
                    readings.append(max(
                        rel_l2(outs["cuda"][:, i], outs["cpu"][:, i])
                        for i in range(outs["cpu"].shape[1])))
                    greedy.append({d: o.argmax(-1)[0].tolist()
                                   for d, o in outs.items()})
                rtol = PARITY_SERVE_RTOL[store]
                emit({"phase": "parity_serve", "config": f"{model_cfg.name}"
                      ".reduced()", "store": store, "compute": "float32",
                      "seeds": list(PARITY_SEEDS), "max_rel_l2": readings,
                      "rtol": rtol, "greedy_row0": greedy})
                if not max(readings) <= rtol:
                    fail(f"parity_serve {model_cfg.name} {store}: CPU and "
                         f"card logits differ by {max(readings)} > {rtol}")

        # ---- 30. parity_recurrent: CPU (plain) vs card, fp32 ----------------
        for arch, layers in ((XLSTM, None), (HYMBA, HYMBA_LAYERS)):
            pc = get_config(arch).reduced()
            if layers is not None:
                pc = dataclasses.replace(pc, n_layers=layers)
            train_read, serve_read = [], []
            for seed in PARITY_REC_SEEDS:
                data = SyntheticStream(DataConfig(pc.vocab, 64, 8, seed=seed),
                                       pc)
                runs = {dev: train(pc, dev, torch.float32, data, 2,
                                   seed=seed)[0] for dev in ("cpu", "cuda")}
                train_read.append(max(
                    abs(a[k] - b[k]) / abs(b[k])
                    for a, b in zip(runs["cuda"], runs["cpu"])
                    for k in ("loss", "grad_norm")))
                toks = torch.from_numpy(np.random.default_rng(seed).integers(
                    0, pc.vocab, (4, 16 + PARITY_SERVE_STEPS)))
                outs = {}
                for dev in ("cpu", "cuda"):
                    srt = FSDPRuntime(build_model(pc), group,
                                      compute_dtype=torch.float32, device=dev)
                    sp = srt.init_params(seed)
                    cache = srt.init_cache(4, 32)
                    t = toks.to(srt.device)
                    lg, cache = srt.make_prefill_step()(
                        sp, {"tokens": t[:, :16]}, cache)
                    out = [lg]
                    dec = srt.make_decode_step()
                    for i in range(16, 16 + PARITY_SERVE_STEPS):
                        lg, cache = dec(sp, {"tokens": t[:, i:i + 1]},
                                        cache, i)
                        out.append(lg)
                    outs[dev] = torch.cat(out, 1).float().cpu()
                serve_read.append(max(
                    rel_l2(outs["cuda"][:, i], outs["cpu"][:, i])
                    for i in range(outs["cpu"].shape[1])))
            emit({"phase": "parity_recurrent", "config": f"{arch}.reduced()",
                  "n_layers": pc.n_layers, "compute": "float32",
                  "seeds": list(PARITY_REC_SEEDS),
                  "train_max_rel_diff": train_read,
                  "train_rtol": PARITY_REC_RTOL,
                  "serve_max_rel_l2": serve_read,
                  "serve_rtol": PARITY_REC_SERVE_RTOL[arch]})
            if not (max(train_read) <= PARITY_REC_RTOL
                    and max(serve_read) <= PARITY_REC_SERVE_RTOL[arch]):
                fail(f"parity_recurrent {arch}: CPU and card differ by "
                     f"{max(train_read)} (train) / {max(serve_read)} (serve)")

        # ---- 26b. examples_parity: the examples, card against CPU ----
        from repro_torch.examples import (continuous_batching, muon_demo,
                                          quickstart, serve_moe,
                                          train_8bit_adam)

        def rel_stream(a, b) -> float:
            return max(abs(x - y) / abs(y) for x, y in zip(a, b))

        fp32 = ["--compute-dtype", "float32"]
        ex_par = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            qs = quickstart.main(["--device", dev, "--steps", str(
                EXAMPLE_PARITY_STEPS["quickstart"]), *fp32])
            a8 = {opt: train_8bit_adam.run(
                opt, EXAMPLE_PARITY_STEPS["train_8bit_adam"], dev, "float32")
                for opt in ("adamw", "adam8bit")}
            mu = {opt: muon_demo.run(
                opt, lr, EXAMPLE_PARITY_STEPS["muon_demo"], dev, "float32")
                for opt, lr in (("adamw", 1e-3), ("muon", 3e-3))}
            ex_par[dev] = {
                "quickstart": qs, "train_8bit_adam": a8, "muon_demo": mu,
                "serve_moe": serve_moe.main(["--device", dev, *fp32]),
                "continuous_batching": continuous_batching.main(
                    ["--device", dev, *fp32]),
                "seconds": time.perf_counter() - t0}
        card, cpu = ex_par["cuda"], ex_par["cpu"]
        ex_read = {
            "quickstart": (max(rel_stream(card["quickstart"][k],
                                          cpu["quickstart"][k])
                               for k in ("loss", "grad_norm")), PARITY_RTOL),
            "train_8bit_adam/adamw": (rel_stream(
                card["train_8bit_adam"]["adamw"],
                cpu["train_8bit_adam"]["adamw"]), PARITY_RTOL),
            "train_8bit_adam/adam8bit": (rel_stream(
                card["train_8bit_adam"]["adam8bit"],
                cpu["train_8bit_adam"]["adam8bit"]), PARITY_RTOL),
            "muon_demo/adamw": (rel_stream(card["muon_demo"]["adamw"],
                                           cpu["muon_demo"]["adamw"]),
                                PARITY_RTOL),
            "muon_demo/muon": (rel_stream(card["muon_demo"]["muon"],
                                          cpu["muon_demo"]["muon"]),
                               PARITY_RTOL)}
        tokens_equal = {k: card[k] == cpu[k]
                        for k in ("serve_moe", "continuous_batching")}
        emit({"phase": "examples_parity", "compute": "float32",
              "steps": EXAMPLE_PARITY_STEPS,
              "readings": {k: {"max_rel": v, "rtol": t}
                           for k, (v, t) in ex_read.items()},
              "tokens_equal": tokens_equal,
              "seconds": {d: ex_par[d]["seconds"] for d in ex_par}})
        for k, (v, t) in ex_read.items():
            if not v <= t:
                fail(f"examples_parity {k}: card and CPU differ by {v} > {t}")
        if not all(tokens_equal.values()):
            fail(f"examples_parity: served tokens differ {tokens_equal}")

        # ---- 35. parity_crossattn: CPU (plain) vs card, fp32 -------------
        parity_crossattn()

    def crossattn_phases() -> dict:
        """Phases 31-33, the cross-attention families at published width
        on the card; returns what the kernels line carries."""
        from repro_torch.configs import ShapeConfig
        from repro_torch.launch import roofline

        out = {}
        # ---- 31. train_encdec: seamless-m4t-medium, 12 + 12 layers ------
        ecfg = get_config(SEAMLESS)
        estream = SyntheticStream(DataConfig(ecfg.vocab, ENC_SEQ, ENC_BATCH),
                                  ecfg)
        etokens = ENC_BATCH * ENC_SEQ
        eloss0 = math.log(ecfg.vocab) + 2.0   # untied head, as qwen2.5
        emit({"phase": "train_encdec_setup", "model": SEAMLESS,
              "layers": [ecfg.encoder_layers, ecfg.n_layers],
              "d_model": ecfg.d_model, "heads": [ecfg.n_heads,
                                                 ecfg.n_kv_heads],
              "head_dim": ecfg.hd, "d_ff": ecfg.d_ff, "vocab": ecfg.vocab,
              "batch": [ENC_BATCH, ENC_SEQ],
              "frames": min(ecfg.n_frames, ENC_SEQ), "optimizer": "adamw",
              "store": "fp32", "compute": "bfloat16"})
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches(mods)
        plain_calls, restore_plain = count_plain(ops)
        timing, keep = {}, {}
        t0 = time.perf_counter()
        try:
            metrics, times, rt = train(ecfg, "cuda", torch.bfloat16,
                                       estream, 1 + TIMED_STEPS,
                                       timings=timing, keep=keep)
            step_fn = rt.make_train_step(keep["optimizer"])
            batch = estream.shard(estream.batch(1 + TIMED_STEPS), rt)
            torch.cuda.synchronize()
            (params, _, _, m_last), n_ops, by_op = count_cuda_ops(
                lambda: step_fn(keep["params"], keep["opt_state"],
                                1 + TIMED_STEPS, batch))
            torch.cuda.synchronize()
        finally:
            restore_plain()
        del keep, batch, step_fn
        e_launches = launches_now(mods)
        e_peak = torch.cuda.max_memory_allocated()
        metrics.append({k: float(v) for k, v in m_last.items()})
        for i, (m, ms) in enumerate(zip(metrics, times)):
            emit({"phase": "train_encdec", "step": i, "warmup": i == 0,
                  "loss": m["loss"], "grad_norm": m["grad_norm"],
                  "tokens": m["tokens"], "step_ms": ms,
                  "tokens_per_s": etokens / (ms / 1e3)})
        e_ms = statistics.median(times[1:])
        e_want = {k: 0 for k in e_launches}
        e_want["adamw_store_update"] = len(rt.layouts) * len(metrics)
        emit({"phase": "train_encdec_summary",
              "shard_sizes": {n: lo.plan.shard_size
                              for n, lo in rt.layouts.items()},
              "params": sum(math.prod(lo.local_shape())
                            for lo in rt.layouts.values()),
              "setup_s": timing["setup_s"],
              "setup_and_steps_s": time.perf_counter() - t0,
              "step_ms_median": e_ms,
              "tokens_per_s": etokens / (e_ms / 1e3),
              "mfu": roofline.mfu(ecfg, ShapeConfig(
                  "train_encdec", ENC_SEQ, ENC_BATCH, "train"), e_ms / 1e3),
              "max_memory_allocated": e_peak, "allocated_before": base,
              "own_peak": e_peak - base, "cuda_ops_per_step": n_ops,
              "cuda_ops_top": dict(sorted(by_op.items(),
                                          key=lambda kv: -kv[1])[:8]),
              "kernel_launches": e_launches, "expected_launches": e_want,
              "plain_calls": {k: v for k, v in plain_calls.items() if v},
              "expected_first_loss": eloss0})
        if e_launches != e_want:
            fail(f"train_encdec launched {e_launches}, expected {e_want}")
        if any(plain_calls.values()):
            fail(f"train_encdec ran plain versions {plain_calls}")
        for m in metrics:
            if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
                fail(f"non-finite train_encdec metrics {m}")
        if abs(metrics[0]["loss"] - eloss0) > 1.0:
            fail(f"first train_encdec loss {metrics[0]['loss']} far from "
                 f"{eloss0}")
        held = hold_update_at("train_encdec", rt, fused_update, ref,
                              phase="kernel_crossattn")
        out["train_encdec"] = {
            "launches": e_launches["adamw_store_update"],
            "held": {n: {k: h[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "max_abs_err")}
                     for n, h in held.items()}}

        # ---- 32. serve_encdec: the trained weights, 4,096 frames --------
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            0, ecfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).to("cuda")
        frames = torch.from_numpy(rng.normal(
            size=(SERVE_BATCH, ecfg.n_frames, ecfg.d_model))).to(
            torch.bfloat16).to("cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        plain_calls, restore_plain = count_plain(ops)
        try:
            readings, _ = serve_cross(
                rt, params, {"tokens": prompts, "frames": frames}, {},
                SERVE_PROMPT + CROSS_SERVE_STEPS)
        finally:
            restore_plain()
        s_launches = {k: v for k, v in launches_now(mods).items() if v}
        emit({"phase": "serve_encdec", "model": SEAMLESS,
              "frames": ecfg.n_frames, **readings,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "allocated_before": base, "kernel_launches": s_launches,
              "plain_calls": {k: v for k, v in plain_calls.items() if v}})
        if s_launches or any(plain_calls.values()):
            fail(f"serve_encdec launched {s_launches}, plain {plain_calls}: "
                 f"the fp32 store serves without the port's kernels")
        del rt, params, prompts, frames
        torch.cuda.empty_cache()

        # ---- 33. serve_vision: one block at published width, q8_block ---
        vfull = get_config(VISION)
        vcfg = dataclasses.replace(
            vfull, n_layers=VISION_BLOCKS * vfull.cross_attn_interval)
        shards = {n: e.plan.shard_size for n, e in plan(
            build_model(vcfg), {"data": 1, "model": 1},
            CommSchedule(**SERVE_SCHEDULE)).groups.items()}
        emit({"phase": "serve_vision_setup", "model": VISION,
              "cut": {"n_layers": [vfull.n_layers, vcfg.n_layers]},
              "d_model": vcfg.d_model, "heads": [vcfg.n_heads,
                                                 vcfg.n_kv_heads],
              "head_dim": vcfg.hd, "d_ff": vcfg.d_ff, "vocab": vcfg.vocab,
              "patches": vcfg.n_patches, "gates": VISION_GATE,
              "shard_sizes": shards,
              "prefill": [SERVE_BATCH, SERVE_PROMPT],
              "decode_steps": CROSS_SERVE_STEPS})
        t0 = time.perf_counter()
        out["q8mm"] = phase_kernel_q8mm_vision(ops, ref, q8_matmul)
        t1 = time.perf_counter()
        out["q8"] = phase_kernel_q8_vision(ops, ref, shards)
        emit({"phase": "kernel_vision_seconds", "q8mm": t1 - t0,
              "quantize_dequantize": time.perf_counter() - t1})
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches(mods)
        t0 = time.perf_counter()
        with vision_gates(FSDPRuntime):
            rt = FSDPRuntime(build_model(vcfg), group,
                             compute_dtype=torch.bfloat16,
                             schedule=CommSchedule(**SERVE_SCHEDULE))
            params = rt.init_params(0)
        torch.cuda.synchronize()
        v_setup = time.perf_counter() - t0
        v_init = launches_now(mods)
        v_init_want = {k: 0 for k in v_init}
        v_init_want["quantize"] = len(rt.layouts)
        emit({"phase": "serve_vision_init", "setup_s": v_setup,
              "state_bytes": torch.cuda.memory_allocated() - base,
              "kernel_launches": v_init, "expected_launches": v_init_want})
        if v_init != v_init_want:
            fail(f"serve_vision init launched {v_init}, expected "
                 f"{v_init_want}")
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            0, vcfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).to("cuda")
        patches = torch.from_numpy(rng.normal(
            size=(SERVE_BATCH, vcfg.n_patches, vcfg.d_model))).to(
            torch.bfloat16).to("cuda")
        calls = 2 + CROSS_SERVE_STEPS
        vision_logits, v_launches = {}, {"quantize": v_init["quantize"]}
        for mode, sched in (("q8_serve_matmul", SERVE_SCHEDULE),
                            ("q8_dense", SERVE_DENSE_SCHEDULE)):
            if mode != "q8_serve_matmul":
                rt2 = FSDPRuntime(rt.model, group,
                                  compute_dtype=torch.bfloat16,
                                  schedule=CommSchedule(**sched))
                if any(rt2.layouts[n].plan != lo.plan
                       for n, lo in rt.layouts.items()):
                    fail("the dense vision serve plans differently")
                rt = rt2
            torch.cuda.reset_peak_memory_stats()
            reset_launches(mods)
            plain_calls, restore_plain = count_plain(ops)
            try:
                readings, vision_logits[mode] = serve_cross(
                    rt, params, {"tokens": prompts, "patches": patches},
                    {"patches": patches}, SERVE_PROMPT + CROSS_SERVE_STEPS)
            finally:
                restore_plain()
            got = launches_now(mods)
            want = expected_serve_launches(rt, calls, got)
            row = {"phase": "serve_vision", "mode": mode, "schedule": sched,
                   "setup_s": v_setup, **readings,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "allocated_before": base, "calls": calls,
                   "kernel_launches": {k: v for k, v in got.items() if v},
                   "expected_launches": {k: v for k, v in want.items() if v},
                   "plain_calls": {k: v for k, v in plain_calls.items()
                                   if v}}
            if mode == "q8_serve_matmul":
                # the two prefills in the prefill regime; a decode call's
                # launches in the decode regime but the cross layers'
                # x_wk and x_wv over the patch rows
                per_call = want["q8_matmul"] // calls
                mem = VISION_MEMORY_CALLS * VISION_BLOCKS
                row["q8_matmul_launches_by_regime"] = regimes = {
                    "decode": q8_matmul.q8_matmul.decode_launches,
                    "prefill": q8_matmul.q8_matmul.prefill_launches}
                row["expected_by_regime"] = regimes_want = {
                    "decode": (per_call - mem) * CROSS_SERVE_STEPS,
                    "prefill": per_call * 2 + mem * CROSS_SERVE_STEPS}
                if regimes != regimes_want:
                    fail(f"serve_vision {mode}: q8_matmul regimes "
                         f"{regimes}, expected {regimes_want}")
                v_launches["regimes"] = regimes
            emit(row)
            if got != want:
                fail(f"serve_vision {mode} launched {got}, expected {want}")
            if any(plain_calls.values()):
                fail(f"serve_vision {mode} ran plain versions {plain_calls}")
            v_launches[mode] = got["dequantize_into"]
        gap = rel_l2(vision_logits["q8_serve_matmul"].float(),
                     vision_logits["q8_dense"].float())
        emit({"phase": "serve_vision_summary",
              "prefill_rel_l2_int8_vs_dense": gap,
              "limit": SERVE_INT8_VS_DENSE,
              "setup_and_serve_s": time.perf_counter() - t0})
        if not gap < SERVE_INT8_VS_DENSE:
            fail(f"serve_vision int8 prefill logits {gap} from the dense "
                 f"q8 serve's (limit {SERVE_INT8_VS_DENSE})")
        out["serve_vision"] = v_launches
        del rt, params, prompts, patches, vision_logits
        torch.cuda.empty_cache()
        return out

    def init_from(host):
        """``init(rt)`` from host masters ``{group: (tensor, layout)}``,
        cut to rt's layers (a layer's init does not depend on the depth)
        and repacked tensor by tensor where rt's layout differs (the
        fsdp2 and q8 plans): the values ``rt.init_params(0)`` gives,
        without drawing them again."""
        def init(rt):
            out = {}
            for n, lo in rt.layouts.items():
                t, src = host[n]
                t = t[:lo.n_layers] if lo.n_layers else t
                if src.plan != lo.plan:
                    rows = t.numpy().reshape(-1, src.plan.total)
                    t = torch.from_numpy(np.stack([
                        lo.buffer.pack(src.buffer.unpack_np(r))
                        for r in rows]).reshape(lo.local_shape()))
                out[n] = lo.store.create(
                    t.to(rt.device).requires_grad_(True))
            return out
        return init

    def serve_run(rt, model, params, prompts, requests):
        """A warm-up prefill and a timed one (the cache's slots are simply
        rewritten), SERVE_STEPS greedy decode steps at a scalar index, then
        the engine; returns (metrics, prefill logits, step calls)."""
        cache = rt.init_cache(SERVE_BATCH, SERVE_LEN)
        prefill, decode = rt.make_prefill_step(), rt.make_decode_step()
        prefill(params, {"tokens": prompts}, cache)        # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts}, cache)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok = torch.argmax(logits, -1)
        step_ms, gen = [], [tok]
        for i in range(SERVE_STEPS):
            t0 = time.perf_counter()
            lg, cache = decode(params, {"tokens": tok}, cache,
                               SERVE_PROMPT + i)
            tok = torch.argmax(lg, -1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            gen.append(tok)
        if not bool(torch.isfinite(lg.float()).all()):
            fail(f"non-finite decode logits on {rt.schedule}")
        gen = torch.cat(gen, 1).cpu()
        del cache
        eng = ServeEngine(rt, model, params, pool=ENGINE_POOL,
                          max_len=SERVE_LEN)
        reqs = [Request(uid=i, prompt=p, max_new=ENGINE_NEW)
                for i, p in enumerate(requests)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine_calls = 0
        while eng.queue or any(sl.req for sl in eng.slots):
            eng.step()
            engine_calls += 1
        engine_s = time.perf_counter() - t0
        new_tokens = sum(len(r.out) for r in reqs)
        if not all(r.done and len(r.out) == ENGINE_NEW for r in reqs):
            fail("the engine left requests unfinished")
        if not (0 <= int(gen.min()) and int(gen.max()) < model.cfg.vocab):
            fail("decoded tokens out of the vocabulary")
        decode_med = statistics.median(step_ms[1:])
        return ({"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
                 "decode_step_ms_median": decode_med,
                 "decode_tokens_per_s": SERVE_BATCH / (decode_med / 1e3),
                 "engine_calls": engine_calls, "engine_s": engine_s,
                 "engine_new_tokens": new_tokens,
                 "engine_tokens_per_s": new_tokens / engine_s,
                 "greedy_row0": gen[0].tolist()},
                logits, 2 + SERVE_STEPS + engine_calls)

    def train_published(name: str, dryrun: dict, keep_init=None,
                        prefetch=None) -> dict:
        """A phase of PUBLISHED (36, 38-40): its configuration at published
        width through ``train`` on the NCCL rank, bf16 compute; the batch
        its dry run settled on (halved where the phase's own was predicted
        above PUBLISHED_PEAK_LIMIT); then the dry run's predicted peak and
        kernel calls against the card's (``dryrun_vs_card``) and its update
        kernel against the plain version at its shards (the plain version
        in chunks).  ``keep_init`` receives the host masters; ``prefetch``
        (a ``HostPrefetch``, awaited) drew them already.  Returns what the
        kernels line carries."""
        from repro_torch.configs import ShapeConfig
        from repro_torch.launch import roofline

        cfg, cut = published_config(name)
        rows = dryrun["rows"]
        if not rows or not all(r["ok"] for r in rows):
            fail(f"{name}: no dry run row: {dryrun['text'][-2000:]}")
        dr = rows[-1]
        batch, seq = dr["batch"]
        pred = dr["peak_bytes_dev"]
        cut["batch"][1] = [batch, seq]
        if len(rows) > 1:
            cut["batch_halved"] = {"from": rows[0]["batch"],
                                   "predicted_peak": rows[0]
                                   ["peak_bytes_dev"]}
        if pred > PUBLISHED_PEAK_LIMIT:
            fail(f"{name}: the dry run predicts {pred} bytes at {batch} x "
                 f"{seq}, above {PUBLISHED_PEAK_LIMIT}")
        fmt = cfg.parallel.param_store
        kernel = "adam8bit_store_update" if cfg.optimizer == "adam8bit" \
            else "adamw_store_update"
        stream = SyntheticStream(DataConfig(cfg.vocab, seq, batch), cfg)
        loss0 = expected_first_loss(cfg)
        emit({"phase": name + "_setup", "model": cfg.name, "cut": cut,
              "d_model": cfg.d_model, "heads": [cfg.n_heads,
                                                cfg.n_kv_heads],
              "head_dim": cfg.hd, "d_ff": cfg.d_ff, "mlp": cfg.mlp,
              "experts": [cfg.n_experts, cfg.top_k], "vocab": cfg.vocab,
              "qkv_bias": cfg.qkv_bias, "rope_theta": cfg.rope_theta,
              "layers": cfg.n_layers, "batch": [batch, seq],
              "optimizer": cfg.optimizer, "store": fmt,
              "compute": "bfloat16", "predicted_peak": pred})
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()    # what earlier phases hold
        reset_launches(mods)
        plain_calls, restore_plain = count_plain(ops)
        timing = {}
        t0 = time.perf_counter()
        try:
            metrics, times, rt = train(
                cfg, "cuda", torch.bfloat16, stream, 1 + TIMED_STEPS,
                timings=timing, keep_init=keep_init,
                init=prefetch.init(name, timing) if prefetch else None)
        finally:
            restore_plain()
        launches = launches_now(mods)
        peak = torch.cuda.max_memory_allocated()
        want = {k: 0 for k in launches}
        want[kernel] = len(rt.layouts) * len(metrics)
        tokens = batch * seq
        for i, (m, ms) in enumerate(zip(metrics, times)):
            emit({"phase": name, "step": i, "warmup": i == 0,
                  "loss": m["loss"], "grad_norm": m["grad_norm"],
                  "tokens": m["tokens"], "step_ms": ms,
                  "tokens_per_s": tokens / (ms / 1e3)})
        step_ms = statistics.median(times[1:])
        emit({"phase": name + "_summary",
              "shard_sizes": {n: lo.plan.shard_size
                              for n, lo in rt.layouts.items()},
              "params": sum(math.prod(lo.local_shape())
                            for lo in rt.layouts.values()),
              "setup_s": timing["setup_s"],
              "host_draw_s": timing.get("host_draw_s"),
              "setup_and_steps_s": time.perf_counter() - t0,
              "step_ms_median": step_ms,
              "tokens_per_s": tokens / (step_ms / 1e3),
              "mfu": roofline.mfu(cfg, ShapeConfig(name, seq, batch,
                                                   "train"), step_ms / 1e3),
              "max_memory_allocated": peak, "allocated_before": base,
              "own_peak": peak - base, "kernel_launches": launches,
              "expected_launches": want,
              "plain_calls": {k: v for k, v in plain_calls.items() if v},
              "expected_first_loss": loss0})
        if launches != want:
            fail(f"{name} launched {launches}, expected {want}")
        if any(plain_calls.values()):
            fail(f"{name} ran plain versions {plain_calls}")
        for m in metrics:
            if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
                fail(f"non-finite {name} metrics {m}")
        if abs(metrics[0]["loss"] - loss0) > 1.0:
            fail(f"first {name} loss {metrics[0]['loss']} far from {loss0}")
        if peak >= PUBLISHED_PEAK_LIMIT:
            fail(f"{name} peaked at {peak} bytes, limit "
                 f"{PUBLISHED_PEAK_LIMIT}")
        # 6c's row of this phase: the dry run's step against its own peak
        dryrun_vs_card(name, dryrun, peak - base,
                       {f"{kernel}[{fmt}]": len(rt.layouts)},
                       batch=[batch, seq])
        held = hold_update_at(name, rt, fused_update, ref,
                              phase="kernel_published")
        del rt
        torch.cuda.empty_cache()
        return {"kernel": kernel, "fmt": fmt, "launches": launches[kernel],
                "held": {n: {k: h[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "max_abs_err")}
                         for n, h in held.items()}}

    def serve_granite(host: dict) -> dict:
        """Phase 37: granite-moe-1b-a400m as phase 36 trains it (published
        width, 12 layers) served from the q8_block store with
        ``serve_quant_matmul``, its masters ``train_granite``'s host
        copies repacked for the q8 plan (``quantize`` once a group), as
        ``serve`` runs gemma2-2b: a prefill
        of 4 x 512, 32 decode steps, the engine.  ``q8_matmul`` once per
        eligible weight per layer and call (wq, wk, wv, wo and the (1024,
        32) router), by regime; ``dequantize_into`` per other tensor of a
        layer (its norms and three expert weights) and per ``globals``
        gather.  Returns what the kernels line carries."""
        gcfg, cut = published_config("train_granite")
        del cut["batch"]
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            0, gcfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).to("cuda")
        requests = [rng.integers(0, gcfg.vocab, (int(n),))
                    for n in rng.integers(ENGINE_PROMPT[0],
                                          ENGINE_PROMPT[1] + 1,
                                          ENGINE_REQUESTS)]
        emit({"phase": "serve_granite_setup", "model": gcfg.name,
              "cut": cut, "layers": gcfg.n_layers,
              "schedule": SERVE_SCHEDULE,
              "prefill": [SERVE_BATCH, SERVE_PROMPT], "cache_len": SERVE_LEN,
              "decode_steps": SERVE_STEPS,
              "engine": {"pool": ENGINE_POOL, "requests": ENGINE_REQUESTS,
                         "prompt_lens": [len(r) for r in requests],
                         "max_new": ENGINE_NEW}})
        model = build_model(gcfg)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches(mods)
        plain_calls, restore_plain = count_plain(ops)
        try:
            t0 = time.perf_counter()
            rt = FSDPRuntime(model, group, compute_dtype=torch.bfloat16,
                             schedule=CommSchedule(**SERVE_SCHEDULE))
            params = init_from(host)(rt)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            init = launches_now(mods)
            reset_launches(mods)
            metrics, logits, calls = serve_run(rt, model, params, prompts,
                                               requests)
        finally:
            restore_plain()
        got = launches_now(mods)
        want = expected_serve_launches(rt, calls, got)
        init_want = {k: 0 for k in init}
        init_want["quantize"] = len(rt.layouts)
        per_call = want["q8_matmul"] // calls
        regimes = {"decode": q8_matmul.q8_matmul.decode_launches,
                   "prefill": q8_matmul.q8_matmul.prefill_launches}
        regimes_want = {"decode": per_call * (calls - 2),
                        "prefill": per_call * 2}
        emit({"phase": "serve_granite", "model": gcfg.name,
              "schedule": SERVE_SCHEDULE, "setup_s": setup_s, **metrics,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "allocated_before": base, "calls": calls,
              "init_launches": {k: v for k, v in init.items() if v},
              "kernel_launches": {k: v for k, v in got.items() if v},
              "expected_launches": {k: v for k, v in want.items() if v},
              "per_call": {k: v // calls for k, v in want.items() if v},
              "q8_matmul_launches_by_regime": regimes,
              "expected_by_regime": regimes_want,
              "plain_calls": {k: v for k, v in plain_calls.items() if v}})
        if init != init_want:
            fail(f"serve_granite init launched {init}, expected "
                 f"{init_want}")
        if got != want:
            fail(f"serve_granite launched {got}, expected {want}")
        if regimes != regimes_want:
            fail(f"serve_granite: q8_matmul regimes {regimes}, expected "
                 f"{regimes_want}")
        if any(plain_calls.values()):
            fail(f"serve_granite ran plain versions {plain_calls}")
        if tuple(logits.shape) != (SERVE_BATCH, 1, gcfg.vocab) \
                or not bool(torch.isfinite(logits.float()).all()):
            fail(f"serve_granite prefill logits {tuple(logits.shape)}, "
                 f"finite {bool(torch.isfinite(logits.float()).all())}")
        del rt, params, logits, prompts
        torch.cuda.empty_cache()
        return {"quantize": init["quantize"],
                "dequantize_into": got["dequantize_into"],
                "regimes": regimes}

    def long500k(name: str, dryrun: dict, prefetch=None) -> dict:
        """Phases 12b and 12c (slice 18): LONG500K ``name`` at published
        width and depth from the q8_block store on its serve schedule,
        bf16 compute, batch 1: ``quantize`` once a group at init, an empty
        ``rt.init_cache(1, LONG_SEQ)`` (its bytes against ``launch/serve.py
        --cache-bytes``), then LONG_STEPS greedy decode steps at the
        shape's last indices (each step's ms; the median of the last
        LONG_TIMED and its tokens/s); the kernels against the plan (by
        regime), no plain version, finite logits, the ring's positions
        the indices decoded, and the decode's own peak against its dry
        run's (``dryrun_vs_card`` within LONG_PEAK_RTOL).  ``prefetch``
        (a ``HostPrefetch``, awaited) drew the masters; without it the
        phase draws its own (``init_params``).  Returns what the kernels
        line carries."""
        from repro_torch.launch import serve as serve_cli
        from repro_torch.models.cache import leaves as leaves_of

        cfg, sched = long500k_runtime_args(name)
        first = LONG_SEQ - LONG_STEPS
        argv = ["--arch", cfg.name, "--full", "--batch", "1", "--prompt-len",
                str(first), "--gen", str(LONG_STEPS), "--cache-bytes"]
        cli = serve_cli.parse_args(argv)
        cli_bytes = serve_cli.cache_bytes(serve_cli.serve_config(cli),
                                          cli)["rank"]["total"]
        model = build_model(cfg)
        window = model.cache_window(LONG_SEQ)
        emit({"phase": name + "_setup", "model": cfg.name,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "schedule": LONG500K[name][1], "shape": "long_500k",
              "batch": 1,
              "cache_len": LONG_SEQ, "ring_slots": window,
              "sliding_window": cfg.sliding_window,
              "decode_indices": [first, LONG_SEQ - 1],
              "predicted_peak": dryrun["row"]["peak_bytes_dev"]})
        tok = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (1, 1))).to("cuda")
        base = torch.cuda.memory_allocated()    # what earlier phases hold
        reset_launches(mods)
        plain_calls, restore_plain = count_plain(ops)
        timing = {}
        try:
            t0 = time.perf_counter()
            rt = FSDPRuntime(model, group, compute_dtype=torch.bfloat16,
                             schedule=sched)
            params = (prefetch.init(name, timing)(rt) if prefetch
                      else rt.init_params(0))
            cache = rt.init_cache(1, LONG_SEQ)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            init = launches_now(mods)
            reset_launches(mods)
            cache_bytes = sum(leaf.nbytes for _, leaf in leaves_of(cache))
            torch.cuda.reset_peak_memory_stats()
            decode = rt.make_decode_step()
            step_ms = []
            for i in range(LONG_STEPS):
                t0 = time.perf_counter()
                lg, cache = decode(params, {"tokens": tok}, cache, first + i)
                tok = torch.argmax(lg, -1)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            restore_plain()
        peak = torch.cuda.max_memory_allocated()
        got = launches_now(mods)
        want = expected_serve_launches(rt, LONG_STEPS, got)
        regimes = {"decode": q8_matmul.q8_matmul.decode_launches,
                   "prefill": q8_matmul.q8_matmul.prefill_launches}
        regimes_want = {"decode": want["q8_matmul"], "prefill": 0}
        init_want = {k: 0 for k in init}
        init_want["quantize"] = len(rt.layouts)
        pos = next(leaf for path, leaf in leaves_of(cache)
                   if path[-1] == "pos").reshape(-1, window).cpu()
        idx = torch.arange(first, LONG_SEQ)
        ring_ok = bool((pos[:, idx % window] == idx).all()) and \
            int((pos >= 0).sum()) == pos.shape[0] * LONG_STEPS
        med = statistics.median(step_ms[-LONG_TIMED:])
        emit({"phase": name, "model": cfg.name, "setup_s": setup_s,
              "host_draw_s": timing.get("host_draw_s"),
              "decode_step_ms": step_ms, "decode_step_ms_median": med,
              "decode_tokens_per_s": 1 / (med / 1e3),
              "timed_steps": LONG_TIMED, "cache_bytes": cache_bytes,
              "cache_bytes_cli": cli_bytes,
              "cache_bytes_cli_argv": argv,
              "ring_positions_ok": ring_ok,
              "max_memory_allocated": peak, "allocated_before": base,
              "own_peak": peak - base,
              "init_launches": {k: v for k, v in init.items() if v},
              "kernel_launches": {k: v for k, v in got.items() if v},
              "expected_launches": {k: v for k, v in want.items() if v},
              "q8_matmul_launches_by_regime": regimes,
              "plain_calls": {k: v for k, v in plain_calls.items() if v},
              "greedy_last": int(tok)})
        if init != init_want:
            fail(f"{name} init launched {init}, expected {init_want}")
        if got != want:
            fail(f"{name} launched {got}, expected {want}")
        if regimes != regimes_want:
            fail(f"{name}: q8_matmul regimes {regimes}, expected "
                 f"{regimes_want}")
        if any(plain_calls.values()):
            fail(f"{name} ran plain versions {plain_calls}")
        if tuple(lg.shape) != (1, 1, cfg.vocab) \
                or not bool(torch.isfinite(lg.float()).all()):
            fail(f"{name} decode logits {tuple(lg.shape)}, finite "
                 f"{bool(torch.isfinite(lg.float()).all())}")
        if cache_bytes != cli_bytes:
            fail(f"{name}: the cache holds {cache_bytes} bytes, "
                 f"launch/serve.py --cache-bytes says {cli_bytes}")
        if not ring_ok:
            fail(f"{name}: the ring's positions are not the indices decoded")
        dryrun_vs_card(name, dryrun, peak - base,
                       {k: v // LONG_STEPS for k, v in want.items() if v},
                       rtol=LONG_PEAK_RTOL, batch=[1, LONG_SEQ])
        del rt, params, cache, lg, decode
        torch.cuda.empty_cache()
        return {"quantize": init["quantize"],
                "dequantize_into": got["dequantize_into"],
                "q8_matmul_decode": regimes["decode"]}

    def long500k_phases(names, dry: dict, prefetch=None) -> dict:
        """Phases 12b and 12c of ``names``, each after a collection (a
        phase's peak is its own): what the kernels line carries, by
        phase."""
        out = {}
        for name in (n for n in LONG500K if n in names):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out[name] = long500k(name, dry[name], prefetch)
            emit({"phase": name + "_seconds",
                  "seconds": time.perf_counter() - t0})
        return out

    def parity_long500k(names) -> None:
        """Phase 13b: each LONG500K phase of ``names`` cut to
        LONG_PARITY_LAYERS layers at published width, fp32 compute, its
        serve schedule: the same host masters on the CPU (the plain
        versions) and the card (the kernels), LONG_PARITY_STEPS
        teacher-forced decode steps at the shape's last indices from an
        empty ``init_cache(1, LONG_SEQ)``; each call's logits within
        LONG_PARITY_RTOL relative L2.  First ``rope_freqs`` of every
        ``(rope_theta, hd)`` of the configs, the card's bitwise the
        CPU's (the tests hold the CPU's bitwise the reference's)."""
        from repro_torch.configs import ARCH_IDS
        from repro_torch.models.layers import rope_freqs

        pairs = sorted({(c.rope_theta, c.hd) for c in map(get_config,
                                                          ARCH_IDS)})
        diffs = {f"{t:g}/{hd}": int_view_diff(
            rope_freqs(hd // 2, t, "cuda").cpu(), rope_freqs(hd // 2, t))
            for t, hd in pairs}
        emit({"phase": "parity_rope_freqs", "int_view_diff": diffs})
        if any(diffs.values()):
            fail(f"rope_freqs differ between the card and the CPU: {diffs}")
        for name in (n for n in LONG500K if n in names):
            lcfg, lsched = long500k_runtime_args(name)
            lcfg = dataclasses.replace(lcfg, n_layers=LONG_PARITY_LAYERS)
            host = FSDPRuntime(build_model(lcfg), group,
                               compute_dtype=torch.float32, device="meta",
                               schedule=lsched).host_params(0)
            first = LONG_SEQ - LONG_PARITY_STEPS
            toks = torch.from_numpy(np.random.default_rng(first).integers(
                0, lcfg.vocab, (1, LONG_PARITY_STEPS)))
            outs, secs = {}, {}
            for dev in ("cpu", "cuda"):
                t0 = time.perf_counter()
                lrt = FSDPRuntime(build_model(lcfg), group,
                                  compute_dtype=torch.float32, device=dev,
                                  schedule=lsched)
                lparams = {n: lo.store.create(torch.from_numpy(host[n])
                                              .to(lrt.device))
                           for n, lo in lrt.layouts.items()}
                cache = lrt.init_cache(1, LONG_SEQ)
                decode = lrt.make_decode_step()
                out = []
                for i in range(LONG_PARITY_STEPS):
                    lg, cache = decode(lparams, {"tokens": toks[:, i:i + 1]
                                                 .to(lrt.device)},
                                       cache, first + i)
                    out.append(lg.float().cpu())
                outs[dev] = torch.cat(out, 1)
                secs[dev] = time.perf_counter() - t0
                del lrt, lparams, cache, decode
            del host
            readings = [rel_l2(outs["cuda"][:, i], outs["cpu"][:, i])
                        for i in range(LONG_PARITY_STEPS)]
            rtol = LONG_PARITY_RTOL[name]
            emit({"phase": "parity_long500k", "run": name,
                  "config": lcfg.name, "layers": LONG_PARITY_LAYERS,
                  "schedule": LONG500K[name][1], "compute": "float32",
                  "decode_indices": [first, LONG_SEQ - 1],
                  "rel_l2": readings, "rtol": rtol, "seconds": secs,
                  "finite": bool(torch.isfinite(outs["cuda"]).all())})
            if not (max(readings) <= rtol
                    and bool(torch.isfinite(outs["cuda"]).all())):
                fail(f"parity_long500k {name}: card and CPU logits differ "
                     f"by {max(readings)} > {rtol}")
        torch.cuda.empty_cache()

    def published_phases(names, dry: dict, prefetch=None) -> dict:
        """Phases 36-41 (slice 17) of ``names``, in PUBLISHED_PHASES'
        order: the configurations the card had never run.  ``dry`` holds
        each train phase's dry-step rows (``finish_dryruns``), ``prefetch``
        (a ``HostPrefetch``, awaited) the PREFETCHED phases' host masters;
        without it each phase draws its own.  Returns what the kernels
        line carries, by phase."""
        out, host = {}, {}
        for name in (n for n in PUBLISHED_PHASES if n in names):
            # what earlier phases left in reference cycles goes first: a
            # phase's peak is the card's, whatever it finds held
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            if name in PUBLISHED:
                out[name] = train_published(
                    name, dry[name], host if name == "train_granite"
                    and "serve_granite" in names else None,
                    prefetch if prefetch and name in PREFETCHED else None)
            elif name == "serve_granite":
                out[name] = serve_granite(host)
                host.clear()
            else:
                out[name] = phase_kernel_q8mm_nemotron(ops, ref, q8_matmul)
            emit({"phase": name + "_seconds",
                  "seconds": time.perf_counter() - t0})
        return out

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    if {REFERENCE_ARG, REFERENCE_LONG_ARG} & set(sys.argv[1:]):
        # a child of ``run_reference``: the kernels are built already
        group = init_local_group("cpu:gloo,cuda:nccl")
        if REFERENCE_LONG_ARG in sys.argv[1:]:
            parity_long500k(LONG500K)
        else:
            reference_phases()
        torch.distributed.destroy_process_group()
        return
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "cpu_pin": pinned, "cpu_threads": torch.get_num_threads()})

    # ---- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build([fused_update.KERNEL, fused_update.ADAM8_KERNEL,
                         blockwise_quant.KERNEL, encode_ef.KERNEL,
                         q8_matmul.KERNEL])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"],
                          "ptxas": [l for l in v["log"].splitlines()
                                    if "registers" in l or "spill" in l]}
                      for k, v in built.items()}})

    if only is not None:
        # ``--only``: the named phases of slice 17 alone, their dry runs
        # first
        group = init_local_group("cpu:gloo,cuda:nccl")
        dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
        try:
            dry = finish_dryruns(start_dryruns(
                dry_dir, [n for n in only
                          if n in PUBLISHED or n in LONG500K]))
        finally:
            shutil.rmtree(dry_dir, ignore_errors=True)
        published_phases(only, dry)
        long500k_phases(only, dry)
        parity_long500k(only)
        emit({"phase": "script", "seconds": time.perf_counter() - t_script})
        torch.distributed.destroy_process_group()
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                     "count": torch.cuda.device_count()}})
        return

    # ---- 6c, 25. the dry runs: children on the host from here on, beside
    # the card's phases (they use a core each and no card; xlstm-125m's
    # train_4k row takes minutes: its sLSTM loops op by op on meta
    # tensors)
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dry_procs = start_dryruns(dry_dir)

    # ---- 3. kernel vs plain --------------------------------------------
    kstats = phase_kernel(fused_update, ref)

    # ---- 4. q8 kernels vs plain at the q8 plan's shard shapes ----------
    full = get_config("gemma2-2b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    q8_plan = plan(build_model(cfg), {"data": 1, "model": 1},
                   CommSchedule(**Q8_SCHEDULE))
    q8_shards = {n: e.plan.shard_size for n, e in q8_plan.groups.items()}
    qwen_full = get_config(QWEN)
    muon_cfg = dataclasses.replace(qwen_full, n_layers=MUON_LAYERS,
                                   optimizer="muon")
    muon_shards = {n: e.plan.shard_size for n, e in plan(
        build_model(muon_cfg), {"data": 1, "model": 1},
        CommSchedule(**MUON_SCHEDULE)).groups.items()}
    if muon_shards != QWEN_SHARDS:
        fail(f"qwen2.5-14b shard sizes {muon_shards}, expected {QWEN_SHARDS}")
    q8stats = phase_kernel_q8(ops, ref, q8_shards["layers"],
                              q8_shards["globals"], muon_shards)

    # ---- 5. the 8-bit Adam kernel vs plain -----------------------------
    adam8_cfg = dataclasses.replace(cfg, optimizer="adam8bit")
    adam8_q8_shards = {
        n: e.plan.shard_size for n, e in plan(
            build_model(adam8_cfg), {"data": 1, "model": 1},
            CommSchedule(**ADAM8_Q8_SCHEDULE)).groups.items()}
    a8stats = phase_kernel_adam8(ops, ref, adam8_q8_shards)

    # ---- 14. this slice's passes vs plain, the boundary tensor ----------
    fp32_shards = {n: e.plan.shard_size for n, e in plan(
        build_model(cfg), {"data": 1, "model": 1}).groups.items()}
    fp8_adam8_shards = {n: e.plan.shard_size for n, e in plan(
        build_model(adam8_cfg), {"data": 1, "model": 1},
        CommSchedule(param_store="fp8_e5m2")).groups.items()}
    fp8stats = phase_kernel_fp8(ops, ref, fp32_shards, fp8_adam8_shards)

    # ---- 6. fp32 path: gemma2-2b at full width, depth cut to 4 ---------
    group = init_local_group("cpu:gloo,cuda:nccl")
    stream = SyntheticStream(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH),
                             cfg)
    t0 = time.perf_counter()
    emit({"phase": "train_setup", "model": cfg.name,
          "cut": {"n_layers": [full.n_layers, TRAIN_LAYERS]},
          "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
          "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "batch": [TRAIN_BATCH, TRAIN_SEQ]})
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    host_init = {}
    metrics, times, rt = train(cfg, "cuda", torch.bfloat16, stream,
                               1 + TIMED_STEPS, keep_init=host_init)
    launches = fused_update.adamw_store_update.launches
    peak = torch.cuda.max_memory_allocated()
    train_step_ms = statistics.median(times[1:])
    shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
    n_params = sum(math.prod(lo.local_shape()) for lo in rt.layouts.values())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (m, ms) in enumerate(zip(metrics, times)):
        emit({"phase": "train", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "tokens_per_s": tokens / (ms / 1e3)})
    timed = times[1:]
    summary = {"phase": "train_summary", "shard_sizes": shards,
               "params": n_params,
               "setup_and_steps_s": time.perf_counter() - t0,
               "step_ms_median": statistics.median(timed),
               "tokens_per_s": tokens / (statistics.median(timed) / 1e3),
               "max_memory_allocated": peak, "kernel_launches": launches,
               "expected_launches": len(rt.layouts) * len(metrics)}
    emit(summary)
    train_peak = peak
    if shards != {"layers": 77_865_984, "globals": 589_826_304}:
        fail(f"unexpected shard sizes {shards}")
    if launches != len(rt.layouts) * len(metrics):
        fail(f"adamw_store_update launched {launches} times on the main "
             f"path, expected {len(rt.layouts) * len(metrics)}")
    for m in metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite train metrics {m}")
    # random init: the first loss is close to uniform over the vocab
    if abs(metrics[0]["loss"] - math.log(cfg.vocab)) > 1.0:
        fail(f"first loss {metrics[0]['loss']} far from ln(vocab) "
             f"{math.log(cfg.vocab)}")
    del rt
    torch.cuda.empty_cache()

    # ---- 6b. the training command at published depth ------------------
    from repro_torch.launch import train as train_cli

    cli_argv = ["--arch", "gemma2-2b", "--full", "--steps", str(CLI_STEPS),
                "--batch", str(CLI_BATCH), "--seq", str(CLI_SEQ),
                "--log-every", "1", "--verify"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    plain_calls, restore_plain = count_plain(ops)
    t0 = time.perf_counter()
    try:
        cli = train_cli.main(cli_argv)
    finally:
        restore_plain()
    cli_s = time.perf_counter() - t0
    cli_launches = launches_now(mods)
    cli_peak = torch.cuda.max_memory_allocated()
    cli_step_ms = statistics.median(cli["step_ms"][1:])
    cli_tokens = CLI_BATCH * CLI_SEQ
    emit({"phase": "train_cli", "argv": cli_argv,
          "layers": full.n_layers, "groups": cli["groups"],
          "loss": cli["loss"], "grad_norm": cli["grad_norm"],
          "step_ms": cli["step_ms"], "command_s": cli_s,
          "kernel_launches": {k: v for k, v in cli_launches.items() if v},
          "plain_calls": {k: v for k, v in plain_calls.items() if v}})
    emit({"phase": "train_cli_summary", "step_ms_median": cli_step_ms,
          "tokens_per_s": cli_tokens / (cli_step_ms / 1e3),
          "setup_s": cli["setup_s"], "max_memory_allocated": cli_peak,
          "verify_s": cli["verify"]["seconds"],
          "command_s_without_verify": cli_s - cli["verify"]["seconds"]})
    verify_runs = {"train_cli": cli["verify"]}
    want = {k: 0 for k in cli_launches}
    want["adamw_store_update"] = len(cli["groups"]) * CLI_STEPS
    if cli_launches != want:
        fail(f"train_cli launched {cli_launches}, expected {want}")
    if any(plain_calls.values()):
        fail(f"train_cli ran plain versions {plain_calls}")
    if len(cli["loss"]) != CLI_STEPS or not all(
            math.isfinite(x) for x in cli["loss"] + cli["grad_norm"]):
        fail(f"train_cli metrics {cli['loss']} {cli['grad_norm']}")
    if abs(cli["loss"][0] - math.log(cfg.vocab)) > 1.0:
        fail(f"first train_cli loss {cli['loss'][0]} far from ln(vocab)")
    torch.cuda.empty_cache()

    # ---- 7. q8 path: the same model and batch, q8_both_wires -----------
    q8_sched = CommSchedule(**Q8_SCHEDULE)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    q8_init, q8_keep = {}, {}
    q8_metrics, q8_times, rt = train(cfg, "cuda", torch.bfloat16, stream,
                                     1 + TIMED_STEPS, q8_sched,
                                     keep_init=q8_init, keep=q8_keep)
    q8_launches = launches_now(mods)
    q8_peak = torch.cuda.max_memory_allocated()
    q8_want = expected_q8_launches(rt, len(q8_metrics), q8_launches)
    shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
    for i, (m, ms) in enumerate(zip(q8_metrics, q8_times)):
        emit({"phase": "train_q8", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "tokens_per_s": tokens / (ms / 1e3)})
    timed = q8_times[1:]
    emit({"phase": "train_q8_summary", "schedule": Q8_SCHEDULE,
          "shard_sizes": shards, "planned_shard_sizes": q8_shards,
          "setup_and_steps_s": time.perf_counter() - t0,
          "step_ms_median": statistics.median(timed),
          "tokens_per_s": tokens / (statistics.median(timed) / 1e3),
          "max_memory_allocated": q8_peak, "kernel_launches": q8_launches,
          "expected_launches": q8_want})
    if shards != q8_shards:
        fail(f"q8 shard sizes {shards} differ from the plan's {q8_shards}")
    if q8_launches != q8_want:
        fail(f"q8 path launched {q8_launches}, expected {q8_want}")
    for m in q8_metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite q8 train metrics {m}")
    if abs(q8_metrics[0]["loss"] - math.log(cfg.vocab)) > 1.0:
        fail(f"first q8 loss {q8_metrics[0]['loss']} far from ln(vocab) "
             f"{math.log(cfg.vocab)}")
    # the final masters on the host, for train_micro's comparison
    q8_final = {n: rt.layouts[n].store.trainable(p).detach().cpu()
                for n, p in q8_keep.pop("params").items()}
    del rt, q8_keep
    torch.cuda.empty_cache()

    # ---- 21. the schedule variants: gemma2-2b as in 6 -------------------
    def group_gathers(rt, lo) -> int:
        """Gathers of group ``lo`` in one train step: a stacked group's
        layers in forward, and again in backward where the schedule
        reshards (not the split-out last layer); an unstacked group
        once."""
        if not lo.n_layers:
            return 1
        lp = rt.schedule.plan_layers(lo.n_layers)
        return lo.n_layers + (lp.main if rt.schedule.reshard_after_forward
                              else 0)

    def gathers_per_step(rt, layers_only=False) -> int:
        """Gathers of one train step over the groups (the stacked ones
        alone with ``layers_only``)."""
        return sum(group_gathers(rt, lo) for lo in rt.layouts.values()
                   if lo.n_layers or not layers_only)

    def stream_of(ms):
        return [(m["loss"], m["grad_norm"]) for m in ms]

    # ---- 7b. train_micro: train_q8 in microbatches, deferred EF --------
    micro_cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
        cfg.parallel, microbatches=TRAIN_MICRO))
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    mi_keep = {}
    mi_metrics, mi_times, rt = train(micro_cfg, "cuda", torch.bfloat16,
                                     stream, 1 + TIMED_STEPS, q8_sched,
                                     init=init_from(host_init), keep=mi_keep)
    micro_launches = launches_now(mods)
    mi_peak = torch.cuda.max_memory_allocated()
    # ||W_micro - W_q8|| / ||W_q8 - W_init|| over every group, on the card
    num = den = 0.0
    with torch.no_grad():
        for n, p in mi_keep.pop("params").items():
            lo = rt.layouts[n]
            if q8_init[n][1].plan != lo.plan:
                fail(f"train_micro's {n} plan differs from train_q8's")
            w = lo.store.trainable(p).detach()
            w1 = q8_final[n].to(w.device)
            num += float(torch.linalg.vector_norm(w - w1)) ** 2
            den += float(torch.linalg.vector_norm(
                w1 - q8_init[n][0].to(w.device))) ** 2
            del w1
    mi_master_rel = math.sqrt(num / den)
    # the loop's last group state and master go too: they are the
    # q8_both_wires globals group's (7.7 GB)
    del mi_keep, q8_init, q8_final, p, w
    mi_want = expected_q8_launches(rt, len(mi_metrics), micro_launches,
                                   TRAIN_MICRO)
    for i, (m, ms) in enumerate(zip(mi_metrics, mi_times)):
        emit({"phase": "train_micro", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "tokens_per_s": tokens / (ms / 1e3),
              "train_q8_loss": q8_metrics[i]["loss"]})
    mi_rel, mi_gn_rel = (max(abs(a[k] - b[k]) / abs(b[k])
                             for a, b in zip(mi_metrics, q8_metrics))
                         for k in ("loss", "grad_norm"))
    emit({"phase": "train_micro_summary", "schedule": Q8_SCHEDULE,
          "microbatches": TRAIN_MICRO,
          "microbatch": [TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ],
          "setup_and_steps_s": time.perf_counter() - t0,
          "step_ms_median": statistics.median(mi_times[1:]),
          "tokens_per_s": tokens / (statistics.median(mi_times[1:]) / 1e3),
          "max_memory_allocated": mi_peak,
          "train_q8_step_ms_median": statistics.median(q8_times[1:]),
          "train_q8_max_memory_allocated": q8_peak,
          "loss_max_rel_diff_vs_train_q8": mi_rel,
          "grad_norm_max_rel_diff_vs_train_q8": mi_gn_rel,
          "master_drift_vs_train_q8_update": mi_master_rel,
          "rtol": {"loss": TRAIN_MICRO_LOSS_RTOL,
                   "grad_norm": TRAIN_MICRO_GNORM_RTOL,
                   "masters": TRAIN_MICRO_MASTER_RTOL},
          "kernel_launches": micro_launches,
          "expected_launches": mi_want})
    if micro_launches != mi_want:
        fail(f"train_micro launched {micro_launches}, expected {mi_want}")
    for m in mi_metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite train_micro metrics {m}")
    if not mi_rel <= TRAIN_MICRO_LOSS_RTOL:
        fail(f"train_micro's losses differ from train_q8's by {mi_rel} > "
             f"{TRAIN_MICRO_LOSS_RTOL}")
    if not mi_gn_rel <= TRAIN_MICRO_GNORM_RTOL:
        fail(f"train_micro's grad norms differ from train_q8's by "
             f"{mi_gn_rel} > {TRAIN_MICRO_GNORM_RTOL}")
    if not mi_master_rel <= TRAIN_MICRO_MASTER_RTOL:
        fail(f"train_micro's final masters lie {mi_master_rel} of "
             f"train_q8's update from train_q8's > "
             f"{TRAIN_MICRO_MASTER_RTOL}")
    del rt
    torch.cuda.empty_cache()

    q8_store = APPROX_VARIANTS["q8_store"]
    sched_runs = [
        # (name, schedule, planner, group_schedules, default it must equal)
        ("prefetch", VARIANTS["prefetch"], "ragged", None, "train"),
        ("no_reshard", VARIANTS["no_reshard"], "ragged", None, "train"),
        ("keep_last", VARIANTS["keep_last"], "ragged", None, "train"),
        ("overlap_all", VARIANTS["overlap_all"], "ragged", None, "train"),
        ("ring_overlap", VARIANTS["ring_overlap"], "ragged", None, "train"),
        ("globals_unsharded", VARIANTS["default"], "ragged",
         {"globals": {"sharded": False}}, "train"),
        ("fsdp2", VARIANTS["default"], "fsdp2", None, "fsdp2"),
        ("fsdp2_ring_overlap", VARIANTS["ring_overlap"], "fsdp2", None,
         "fsdp2"),
        ("q8_store", q8_store, "ragged", None, "q8_store"),
        ("q8_ring_prefetch", APPROX_VARIANTS["q8_ring_prefetch"], "ragged",
         None, "q8_store")]
    emit({"phase": "train_sched_setup", "model": cfg.name,
          "cut": {"n_layers": [full.n_layers, TRAIN_LAYERS]},
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "store": "fp32 (q8_block for "
          "the q8 runs)", "optimizer": "adamw",
          "runs": [r[0] for r in sched_runs],
          "ring_hops": "zero: one rank has no peers; the ring and ring_acc "
                       "routes across ranks run on gloo only (CPU tests)"})
    sched_defaults = {"train": stream_of(metrics)}
    sched_launches, sched_summary = {}, {}
    t_sched = time.perf_counter()
    for name, sched, planner, gs, default in sched_runs:
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        s_metrics, s_times, rt = train(
            cfg, "cuda", torch.bfloat16, stream, 1 + TIMED_STEPS, sched,
            planner=planner, group_schedules=gs,
            init=init_from(host_init), meter=True)
        got = launches_now(mods)
        peak_s = torch.cuda.max_memory_allocated()
        steps_run = len(s_metrics)
        want = {k: 0 for k in got}
        groups = len(rt.layouts)
        if rt.layouts["layers"].store.quantized:
            want.update(adamw_q8=groups * steps_run, quantize=groups,
                        dequantize_into=gathers_per_step(rt) * steps_run)
        else:
            want["adamw_store_update"] = groups * steps_run
        sched_launches[name] = got
        stream_s = stream_of(s_metrics)
        if name == default:
            sched_defaults[name] = stream_s
        ref_stream = sched_defaults[default]
        meter = rt.gathered_meter
        row = {"phase": "train_sched", "run": name,
               "schedule": sched.describe(), "planner": planner,
               "group_schedules": gs, "default": default,
               "losses": [m[0] for m in stream_s],
               "grad_norms": [m[1] for m in stream_s],
               "bitwise_default": stream_s == ref_stream,
               "step_ms": s_times,
               "step_ms_median": statistics.median(s_times[1:]),
               "max_memory_allocated": peak_s,
               "gathered_peak_measured": meter.peak,
               "gathered_peak_bytes": rt.gathered_peak_bytes(),
               "layer_gathers": meter.gathers,
               "layer_gathers_planned": gathers_per_step(rt, True)
               * steps_run,
               "kernel_launches": got, "expected_launches": want}
        if planner == "fsdp2":
            row["rel_diff_vs_ragged_default"] = max(
                abs(a - b) / abs(b) for x, y in zip(stream_s,
                                                    sched_defaults["train"])
                for a, b in zip(x, y))
        emit(row)
        sched_summary[name] = {k: row[k] for k in (
            "step_ms_median", "max_memory_allocated",
            "gathered_peak_measured", "gathered_peak_bytes")}
        if got != want:
            fail(f"train_sched {name} launched {got}, expected {want}")
        if stream_s != ref_stream:
            fail(f"train_sched {name}: stream {stream_s} differs from its "
                 f"default {default}'s {ref_stream}")
        if meter.peak > rt.gathered_peak_bytes() or meter.live:
            fail(f"train_sched {name}: gathered buffers peaked at "
                 f"{meter.peak} B (bound {rt.gathered_peak_bytes()}), "
                 f"{meter.live} B still live")
        if meter.gathers != gathers_per_step(rt, True) * steps_run:
            fail(f"train_sched {name}: {meter.gathers} layer gathers, the "
                 f"schedule plans {gathers_per_step(rt, True) * steps_run}")
        del rt
        torch.cuda.empty_cache()
    emit({"phase": "train_sched_summary", "runs": sched_summary,
          "train": {"step_ms_median": train_step_ms,
                    "max_memory_allocated": peak},
          "seconds": time.perf_counter() - t_sched})

    # ---- 22. the vocab-chunked cross entropy: gemma2-2b as in 6 ---------
    ce_cfg = dataclasses.replace(cfg, ce_chunk=CE_CHUNK)
    n_chunks = -(-cfg.vocab // CE_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    ce_metrics, ce_times, rt = train(ce_cfg, "cuda", torch.bfloat16, stream,
                                     1 + TIMED_STEPS,
                                     init=init_from(host_init))
    ce_launches = launches_now(mods)
    ce_peak = torch.cuda.max_memory_allocated()
    ce_want = {k: 0 for k in ce_launches}
    ce_want["adamw_store_update"] = len(rt.layouts) * len(ce_metrics)
    ce_diff = {k: max(abs(a[k] - b[k]) / abs(b[k])
                      for a, b in zip(ce_metrics, metrics))
               for k in ("loss", "grad_norm")}
    emit({"phase": "train_ce_chunk", "ce_chunk": CE_CHUNK,
          "chunks": n_chunks, "last_chunk_pad": n_chunks * CE_CHUNK
          - cfg.vocab, "losses": [m["loss"] for m in ce_metrics],
          "grad_norms": [m["grad_norm"] for m in ce_metrics],
          "rel_diff_vs_train": ce_diff, "limits": CE_CHUNK_RTOL,
          "step_ms": ce_times,
          "step_ms_median": statistics.median(ce_times[1:]),
          "train_step_ms_median": train_step_ms,
          "max_memory_allocated": ce_peak,
          "train_max_memory_allocated": peak,
          "kernel_launches": ce_launches, "expected_launches": ce_want})
    if ce_launches != ce_want:
        fail(f"train_ce_chunk launched {ce_launches}, expected {ce_want}")
    for k, lim in CE_CHUNK_RTOL.items():
        if not ce_diff[k] <= lim:
            fail(f"train_ce_chunk: {k} {ce_diff[k]} from train's, limit "
                 f"{lim}")
    if not ce_peak < peak:
        fail(f"train_ce_chunk peaked at {ce_peak} B, train at {peak} B")
    del rt
    torch.cuda.empty_cache()
    # ---- 23. auto_plan: a measured profile prices policies="auto" ------
    t_auto = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        prof_path = Path(tmp) / "comm_profile.json"
        reset_launches(mods)
        prof = bench_comm.run(group, torch.device("cuda"),
                              sizes=AUTO_BENCH_SIZES, out=str(prof_path),
                              verbose=False)
        prof = load_profile(prof_path)
    cm = CostModel.from_profile(prof)
    auto_plan = plan(build_model(cfg), {"data": 1, "model": 1}, "auto",
                     cost_model=cm)
    emit({"phase": "auto_plan_profile", "name": prof.name,
          "hash": prof.content_hash(), "backend": prof.backend,
          "world": prof.world, "entries": len(prof.entries),
          "ici_bw_fit": cm.ici_bw,
          "curves": {f"{d}/{f}/{m}": [round(v, 12) for v in
                                      prof.linear(d, f, m)]
                     for d, f, m in sorted({s.key() for s in prof.entries})},
          "seconds": time.perf_counter() - t_auto})
    emit({"phase": "auto_plan_describe",
          "lines": auto_plan.describe().splitlines()})
    auto_pols = {n: e.policy.describe() for n, e in auto_plan.groups.items()}
    if auto_plan.profile_hash != prof.content_hash() or not (
            auto_plan.base.prefetch and auto_plan.base.keep_last_gathered):
        fail(f"auto_plan: the plan must record the profile and overlap its "
             f"4 layers; got {auto_plan.profile_name}@"
             f"{auto_plan.profile_hash}, base {auto_plan.base.describe()}")

    def auto_launches_want(rt, steps, keys):
        """The kernels an auto plan's run launches, group by group (the
        measured prices may choose a store and a wire for each): the fused
        update once per group and step, in its q8 epilogue on a q8 store,
        whose ``quantize`` runs once at init and ``dequantize_into`` once
        per gather (``group_gathers``: the plan's prefetch and keep_last);
        a q8 gradient wire (one rank, ring_acc: one encode and one decode
        per reduce) an encode_ef and a dequantize per reduce."""
        want = {k: 0 for k in keys}
        for lo in rt.layouts.values():
            if lo.store.quantized:
                want["adamw_q8"] += steps
                want["quantize"] += 1
                want["dequantize_into"] += group_gathers(rt, lo) * steps
            else:
                want["adamw_store_update"] += steps
            if lo.store.has_ef:
                want["encode_ef"] += (lo.n_layers or 1) * steps
                want["dequantize"] += (lo.n_layers or 1) * steps
        return want

    # three runs on train's host init: the measured model's plan, the same
    # decisions given as explicit rules, and the builtin roofline's plan
    auto_runs = {}
    for name, pols, cmodel in (
            ("measured", "auto", cm),
            ("measured_explicit", auto_plan.policy_set(), None),
            ("builtin", "auto", None)):
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        a_metrics, a_times, rt = train(cfg, "cuda", torch.bfloat16, stream,
                                       1 + TIMED_STEPS, policies=pols,
                                       cost_model=cmodel,
                                       init=init_from(host_init))
        got = launches_now(mods)
        want = auto_launches_want(rt, len(a_metrics), got)
        auto_runs[name] = {
            "plan": rt.plan, "stream": stream_of(a_metrics),
            "step_ms": a_times, "launches": got, "want": want,
            "peak": torch.cuda.max_memory_allocated()}
        del rt
        torch.cuda.empty_cache()
    builtin_plan = auto_runs["builtin"]["plan"]
    for name, r in auto_runs.items():
        emit({"phase": "auto_plan", "run": name,
              "profile": [r["plan"].profile_name, r["plan"].profile_hash],
              "policies": {n: e.policy.describe()
                           for n, e in r["plan"].groups.items()},
              "pricing": dict(r["plan"].pricing),
              "losses": [m[0] for m in r["stream"]],
              "grad_norms": [m[1] for m in r["stream"]],
              "bitwise_train": r["stream"] == sched_defaults["train"],
              "bitwise_measured": r["stream"]
              == auto_runs["measured"]["stream"],
              "step_ms": r["step_ms"],
              "step_ms_median": statistics.median(r["step_ms"][1:]),
              "train_step_ms_median": train_step_ms,
              "max_memory_allocated": r["peak"],
              "kernel_launches": r["launches"],
              "expected_launches": r["want"]})
        if r["launches"] != r["want"]:
            fail(f"auto_plan {name} launched {r['launches']}, expected "
                 f"{r['want']}")
    auto_launches = {k: sum(r["launches"][k] for r in auto_runs.values())
                     for k in auto_runs["measured"]["launches"]}
    if auto_runs["measured"]["plan"].dumps() != auto_plan.dumps():
        fail("auto_plan: the runtime's plan differs from plan(..., 'auto')")
    if auto_runs["measured_explicit"]["stream"] != \
            auto_runs["measured"]["stream"]:
        fail("auto_plan: the measured plan's stream differs from its "
             "decisions given as explicit rules")
    # one rank under the roofline: no wire is priced, so every group keeps
    # the exact fp32 store and cast gradient wire, with prefetch and
    # keep_last: the stream must be train's
    if any(e.policy.store != "fp32" or e.policy.reduce_wire is not None
           for e in builtin_plan.groups.values()) or \
            auto_runs["builtin"]["stream"] != sched_defaults["train"]:
        fail(f"auto_plan builtin: {builtin_plan.describe()} stream "
             f"{auto_runs['builtin']['stream']} is not train's")
    # host only: the builtin roofline's decisions under launch.mesh's H100
    # constants for every registered config (tp = ep = 1)
    emit({"phase": "auto_plan_decisions", "constants": {
        "ICI_BW": mesh.ICI_BW, "HBM_BW": mesh.HBM_BW,
        "PEAK_FLOPS_BF16": mesh.PEAK_FLOPS_BF16},
        "decisions": {f"{arch}@data={d}": groups for (arch, d), groups
                      in auto_decisions.decisions((8, 64)).items()}})

    # ---- 24. ckpt: save, resume, cross-format restore, offline reshard --
    ck_cfg = dataclasses.replace(full, n_layers=CKPT_LAYERS)
    ck_elems = sum(math.prod(lo_shape) for lo_shape in (
        (CKPT_LAYERS, LAYERS_SHAPE[1]), GLOBALS_SHAPE))
    ck_bytes = 12 * ck_elems           # master, m, v in fp32
    # the checkpoint, its tp-8 rewrite and the round trip back (the floor
    # file and the fsdp2 rewrite are gone by then)
    need = 3 * ck_bytes
    ck_dir = Path(tempfile.mkdtemp(prefix="repro_torch_ckpt_"))
    free = shutil.disk_usage(ck_dir).free
    emit({"phase": "ckpt_setup", "model": ck_cfg.name,
          "cut": {"n_layers": [full.n_layers, CKPT_LAYERS]},
          "batch": [TRAIN_BATCH, TRAIN_SEQ], "store": "fp32",
          "optimizer": ck_cfg.optimizer, "elements": ck_elems,
          "checkpoint_bytes": ck_bytes, "disk_free": free,
          "disk_needed": need, "dir": str(ck_dir)})
    try:
        if free < need:
            fail(f"ckpt: {need} bytes of free disk needed under {ck_dir}, "
                 f"{free} free")
        ck_keep: dict = {}
        ckpt_launches = run_ckpt_phase(ck_cfg, ck_dir, ck_bytes, ck_keep)
        ckpt_tp_launches = run_ckpt_tp_phase(ck_cfg, ck_dir, ck_keep)
        del ck_keep
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    del host_init
    torch.cuda.empty_cache()

    # ---- 8. 8-bit Adam path: qwen3-moe at full width, depth cut to 1 ---
    moe_full = get_config(MOE)
    moe_cfg = dataclasses.replace(
        moe_full, n_layers=MOE_LAYERS,
        parallel=dataclasses.replace(moe_full.parallel, ep=1))
    moe_stream = SyntheticStream(DataConfig(moe_cfg.vocab, MOE_SEQ,
                                            MOE_BATCH), moe_cfg)
    emit({"phase": "train_moe_setup", "model": moe_cfg.name,
          "cut": {"n_layers": [moe_full.n_layers, MOE_LAYERS],
                  "ep": [moe_full.parallel.ep, 1],
                  "batch": [[256, 4096], [MOE_BATCH, MOE_SEQ]]},
          "d_model": moe_cfg.d_model,
          "heads": [moe_cfg.n_heads, moe_cfg.n_kv_heads],
          "head_dim": moe_cfg.hd, "experts": [moe_cfg.n_experts,
                                              moe_cfg.top_k],
          "d_ff": moe_cfg.d_ff, "vocab": moe_cfg.vocab,
          "optimizer": moe_cfg.optimizer})
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    moe_timing = {}
    moe_metrics, moe_times, rt = train(moe_cfg, "cuda", torch.bfloat16,
                                       moe_stream, 1 + TIMED_STEPS,
                                       timings=moe_timing)
    moe_launches = launches_now(mods)
    moe_peak = torch.cuda.max_memory_allocated()
    moe_want = {k: 0 for k in moe_launches}
    moe_want["adam8bit_store_update"] = len(rt.layouts) * len(moe_metrics)
    shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
    moe_tokens = MOE_BATCH * MOE_SEQ
    for i, (m, ms) in enumerate(zip(moe_metrics, moe_times)):
        emit({"phase": "train_moe", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "tokens_per_s": moe_tokens / (ms / 1e3)})
    timed = moe_times[1:]
    # random init: logits ~ N(0, 4) (the final norm's gain 1 + 1 on unit-RMS
    # activations, an untied head of fan-in d_model), so the first loss is
    # near ln(vocab) + 4/2
    moe_loss0 = math.log(moe_cfg.vocab) + 2.0
    emit({"phase": "train_moe_summary", "shard_sizes": shards,
          "params": sum(math.prod(lo.local_shape())
                        for lo in rt.layouts.values()),
          "setup_s": moe_timing["setup_s"],
          "setup_and_steps_s": time.perf_counter() - t0,
          "step_ms_median": statistics.median(timed),
          "tokens_per_s": moe_tokens / (statistics.median(timed) / 1e3),
          "max_memory_allocated": moe_peak, "kernel_launches": moe_launches,
          "expected_launches": moe_want, "expected_first_loss": moe_loss0})
    if shards != MOE_SHARDS:
        fail(f"qwen3-moe shard sizes {shards}, expected {MOE_SHARDS}")
    if moe_launches != moe_want:
        fail(f"qwen3-moe path launched {moe_launches}, expected {moe_want}")
    for m in moe_metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite qwen3-moe train metrics {m}")
    if abs(moe_metrics[0]["loss"] - moe_loss0) > 1.0:
        fail(f"first qwen3-moe loss {moe_metrics[0]['loss']} far from "
             f"{moe_loss0}")
    del rt
    torch.cuda.empty_cache()

    # ---- 6c. dryrun_vs_card: the dry run's peak against train's --------
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.launch import roofline

    dry = finish_dryruns(dry_procs)
    shutil.rmtree(dry_dir, ignore_errors=True)
    for name, measured in (("train", train_peak),
                           ("train_cli", cli_peak)):
        row = dry[name]["row"]
        if row is None or not row["ok"]:
            fail(f"dryrun_vs_card {name}: no dry run row: "
                 f"{dry[name]['text'][-2000:]}")
        dryrun_vs_card(name, dry[name], measured,
                       {"adamw_store_update[fp32]": 2})

    # ---- 6d. mfu: model FLOPs over the card's peak for train, train_cli -
    mfu_rows = {}
    gemma_full = get_config("gemma2-2b")
    for name, run_cfg, shape, step_ms in (
            ("train", dataclasses.replace(gemma_full, n_layers=TRAIN_LAYERS),
             ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                       "train"), train_step_ms),
            ("train_cli", gemma_full, ShapeConfig(
                "train_cli", CLI_SEQ, CLI_BATCH, "train"), cli_step_ms)):
        mfu_rows[name] = {
            "active_params": roofline.active_params(run_cfg),
            "model_flops": roofline.model_flops(run_cfg, shape),
            "step_ms": step_ms,
            "mfu": roofline.mfu(run_cfg, shape, step_ms / 1e3)}
    emit({"phase": "mfu", "card": smi,
          "peak_flops_bf16": mesh.PEAK_FLOPS_BF16, **mfu_rows})
    for name, r in mfu_rows.items():
        if not 0.0 < r["mfu"] < 1.0:
            fail(f"mfu {name}: {r['mfu']} outside (0, 1)")

    # ---- 25. dryrun_production: rows at 16 x 16 and 2 x 16 x 16 --------
    prod_axes = {False: mesh.production_axis_sizes(multi_pod=False),
                 True: mesh.production_axis_sizes(multi_pod=True)}
    for arch, shape, mp in DRYRUN_PRODUCTION:
        name = f"{arch}/{shape}" + ("/multi_pod" if mp else "")
        row = dry[name]["row"]
        if row is None or not row["ok"]:
            fail(f"dryrun_production {name}: {dry[name]['text'][-2000:]}")
        arch_cfg = get_config(arch)
        arch_plan = plan(build_model(arch_cfg), prod_axes[mp])
        want = {"model_gflops": round(roofline.model_flops(
                    arch_cfg, SHAPES[shape]) / 1e9, 1),
                "gather_wire_mb": round(arch_plan.gather_wire_bytes() / 1e6,
                                        3),
                "reduce_wire_mb": round(arch_plan.reduce_wire_bytes() / 1e6,
                                        3)}
        emit({"phase": "dryrun_production", "run": name, "row": row,
              "dry_run_s": dry[name]["seconds"]})
        verify_runs[name] = row.get("verify")
        if {k: row[k] for k in want} != want:
            fail(f"dryrun_production {name}: {row} against the plan {want}")
        if not row["colls"].get("all-gather") or \
                not row["colls"].get("reduce-scatter"):
            fail(f"dryrun_production {name}: collectives {row['colls']}")
    text = dry["plan_only"]["text"]
    from repro_torch.configs import ARCH_IDS, ASSIGNED_ARCH_IDS

    ported = [a for a in ASSIGNED_ARCH_IDS if a in ARCH_IDS]
    parity_ok = text.count("plan lowering parity OK")
    errors = [l for l in text.splitlines() if l.startswith("ERROR ")]
    emit({"phase": "dryrun_production", "run": "plan_only --all",
          "parity_ok": parity_ok, "errors": errors,
          "dry_run_s": dry["plan_only"]["seconds"]})
    if parity_ok != len(ported) or len(errors) != len(ASSIGNED_ARCH_IDS) \
            - len(ported) or not all("14b" in l for l in errors):
        fail(f"dryrun_production plan_only --all: {parity_ok} parity lines, "
             f"errors {errors}")

    # ---- 9. 8-bit Adam on the q8_block store: gemma2-2b as in 6 --------
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    a8q_metrics, a8q_times, rt = train(
        adam8_cfg, "cuda", torch.bfloat16, stream, 1 + TIMED_STEPS,
        CommSchedule(**ADAM8_Q8_SCHEDULE))
    a8q_launches = launches_now(mods)
    a8q_peak = torch.cuda.max_memory_allocated()
    gathers = sum(2 * lo.n_layers if lo.n_layers else 1
                  for lo in rt.layouts.values())
    a8q_want = {k: 0 for k in a8q_launches}
    a8q_want.update(adam8bit_q8=len(rt.layouts) * len(a8q_metrics),
                    quantize=len(rt.layouts),
                    dequantize_into=gathers * len(a8q_metrics))
    shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
    for i, (m, ms) in enumerate(zip(a8q_metrics, a8q_times)):
        emit({"phase": "train_adam8_q8", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "tokens_per_s": tokens / (ms / 1e3)})
    timed = a8q_times[1:]
    emit({"phase": "train_adam8_q8_summary", "schedule": ADAM8_Q8_SCHEDULE,
          "optimizer": "adam8bit", "shard_sizes": shards,
          "planned_shard_sizes": adam8_q8_shards,
          "setup_and_steps_s": time.perf_counter() - t0,
          "step_ms_median": statistics.median(timed),
          "tokens_per_s": tokens / (statistics.median(timed) / 1e3),
          "max_memory_allocated": a8q_peak, "kernel_launches": a8q_launches,
          "expected_launches": a8q_want})
    if shards != adam8_q8_shards:
        fail(f"adam8bit q8 shard sizes {shards} differ from the plan's "
             f"{adam8_q8_shards}")
    if a8q_launches != a8q_want:
        fail(f"adam8bit q8 path launched {a8q_launches}, expected "
             f"{a8q_want}")
    for m in a8q_metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite adam8bit q8 train metrics {m}")
    if abs(a8q_metrics[0]["loss"] - math.log(cfg.vocab)) > 1.0:
        fail(f"first adam8bit q8 loss {a8q_metrics[0]['loss']} far from "
             f"ln(vocab) {math.log(cfg.vocab)}")
    del rt
    torch.cuda.empty_cache()

    # ---- 16. the bf16 and fp8 stores: gemma2-2b as in 6 ----------------
    fp8_launches = {}
    for phase, (sched, opt_name) in FP8_SCHEDULES.items():
        pcfg = dataclasses.replace(cfg, optimizer=opt_name)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        t0 = time.perf_counter()
        p_metrics, p_times, rt = train(pcfg, "cuda", torch.bfloat16, stream,
                                       1 + TIMED_STEPS, CommSchedule(**sched))
        got = launches_now(mods)
        fp8_launches[phase] = got
        peak = torch.cuda.max_memory_allocated()
        store = rt.layouts["layers"].store
        kernel = {"fp8_e4m3": "adamw_fp8", "fp8_e5m2": "adam8bit_fp8",
                  "bf16": "adamw_store_update"}[store.fmt]
        want = {k: 0 for k in got}
        want[kernel] = len(rt.layouts) * len(p_metrics)
        shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
        for i, (m, ms) in enumerate(zip(p_metrics, p_times)):
            emit({"phase": phase, "step": i, "warmup": i == 0,
                  "loss": m["loss"], "grad_norm": m["grad_norm"],
                  "tokens": m["tokens"], "step_ms": ms,
                  "tokens_per_s": tokens / (ms / 1e3)})
        timed = p_times[1:]
        emit({"phase": phase + "_summary", "schedule": sched,
              "optimizer": opt_name, "shard_sizes": shards,
              "setup_and_steps_s": time.perf_counter() - t0,
              "step_ms_median": statistics.median(timed),
              "tokens_per_s": tokens / (statistics.median(timed) / 1e3),
              "max_memory_allocated": peak, "kernel_launches": got,
              "expected_launches": want})
        if got != want:
            fail(f"{phase} launched {got}, expected {want}")
        for m in p_metrics:
            if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
                fail(f"non-finite {phase} metrics {m}")
        if abs(p_metrics[0]["loss"] - math.log(cfg.vocab)) > 1.0:
            fail(f"first {phase} loss {p_metrics[0]['loss']} far from "
                 f"ln(vocab) {math.log(cfg.vocab)}")
        del rt
        torch.cuda.empty_cache()

    # ---- 15. the standalone updates through ops ------------------------
    reset_launches(mods)
    sa = phase_standalone(ops, fp32_shards, fp8_adam8_shards,
                          1 + TIMED_STEPS)
    sa_launches = launches_now(mods)
    sa_want = {k: 0 for k in sa_launches}
    sa_want.update(adamw_update=2 * (1 + TIMED_STEPS),
                   adam8bit_update=2 * (1 + TIMED_STEPS))
    emit({"phase": "standalone", **sa, "kernel_launches": sa_launches,
          "expected_launches": sa_want})
    if sa_launches != sa_want or not all(v["finite"] for v in sa.values()):
        fail(f"standalone updates launched {sa_launches}, expected "
             f"{sa_want} (finite: {[v['finite'] for v in sa.values()]})")

    # ---- 18. Muon on qwen2.5-14b's q8_block store at published width --
    qwen_stream = SyntheticStream(DataConfig(muon_cfg.vocab, QWEN_SEQ,
                                             QWEN_BATCH), muon_cfg)
    qwen_tokens = QWEN_BATCH * QWEN_SEQ
    qwen_loss0 = math.log(muon_cfg.vocab) + 2.0   # untied head, as qwen3
    emit({"phase": "train_muon_q8_setup", "model": QWEN,
          "cut": {"n_layers": [qwen_full.n_layers, MUON_LAYERS],
                  "batch": [QWEN_BATCH, QWEN_SEQ]},
          "d_model": muon_cfg.d_model,
          "heads": [muon_cfg.n_heads, muon_cfg.n_kv_heads],
          "head_dim": muon_cfg.hd, "d_ff": muon_cfg.d_ff,
          "vocab": muon_cfg.vocab, "qkv_bias": muon_cfg.qkv_bias,
          "tie_embeddings": muon_cfg.tie_embeddings,
          "schedule": MUON_SCHEDULE, "optimizer": "muon"})
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    muon_timing, qwen_init = {}, {}
    muon_metrics, muon_times, rt = train(
        muon_cfg, "cuda", torch.bfloat16, qwen_stream, 1 + TIMED_STEPS,
        CommSchedule(**MUON_SCHEDULE), timings=muon_timing,
        time_update=True, keep_init=qwen_init)
    muon_launches = launches_now(mods)
    muon_peak = torch.cuda.max_memory_allocated()
    gathers = sum(2 * lo.n_layers if lo.n_layers else 1
                  for lo in rt.layouts.values())
    # quantize: once per group at init and once per group and step (the
    # store's rebuild); dequantize_into: once per gather; nothing else
    muon_want = {k: 0 for k in muon_launches}
    muon_want.update(quantize=len(rt.layouts) * (1 + len(muon_metrics)),
                     dequantize_into=gathers * len(muon_metrics))
    shards = {n: lo.plan.shard_size for n, lo in rt.layouts.items()}
    for i, (m, ms) in enumerate(zip(muon_metrics, muon_times)):
        emit({"phase": "train_muon_q8", "step": i, "warmup": i == 0,
              "loss": m["loss"], "grad_norm": m["grad_norm"],
              "tokens": m["tokens"], "step_ms": ms,
              "update_ms": muon_timing["update_ms"][i],
              "tokens_per_s": qwen_tokens / (ms / 1e3)})
    timed = muon_times[1:]
    emit({"phase": "train_muon_q8_summary", "shard_sizes": shards,
          "params": sum(math.prod(lo.local_shape())
                        for lo in rt.layouts.values()),
          "setup_s": muon_timing["setup_s"],
          "setup_and_steps_s": time.perf_counter() - t0,
          "step_ms_median": statistics.median(timed),
          "update_ms_median": statistics.median(
              muon_timing["update_ms"][1:]),
          "tokens_per_s": qwen_tokens / (statistics.median(timed) / 1e3),
          "max_memory_allocated": muon_peak,
          "kernel_launches": muon_launches,
          "expected_launches": muon_want,
          "expected_first_loss": qwen_loss0})
    if shards != QWEN_SHARDS:
        fail(f"qwen2.5-14b shard sizes {shards}, expected {QWEN_SHARDS}")
    if muon_launches != muon_want:
        fail(f"train_muon_q8 launched {muon_launches}, expected {muon_want}")
    for m in muon_metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite train_muon_q8 metrics {m}")
    if abs(muon_metrics[0]["loss"] - qwen_loss0) > 1.0:
        fail(f"first train_muon_q8 loss {muon_metrics[0]['loss']} far from "
             f"{qwen_loss0}")
    del rt
    torch.cuda.empty_cache()

    # ---- 19. Shampoo on qwen2.5-14b at published width, fp32 store -----
    sh_cfg = dataclasses.replace(qwen_full, n_layers=SHAMPOO_LAYERS,
                                 optimizer="shampoo")
    emit({"phase": "train_shampoo_setup", "model": QWEN,
          "cut": {"n_layers": [qwen_full.n_layers, SHAMPOO_LAYERS],
                  "batch": [QWEN_BATCH, QWEN_SEQ]},
          "schedule": "fp32 store", "optimizer": "shampoo",
          "steps": SHAMPOO_STEPS})
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    t0 = time.perf_counter()
    sh_timing, sh_keep = {}, {}
    # train_muon_q8's host masters, the first layer's row repacked for the
    # fp32 store's plan: the init_params(0) values without drawing the
    # 1.56 G numbers of globals again
    sh_metrics, sh_times, rt = train(
        sh_cfg, "cuda", torch.bfloat16, qwen_stream, SHAMPOO_STEPS,
        timings=sh_timing, keep=sh_keep, time_update=True,
        init=init_from(qwen_init))
    del qwen_init
    sh_launches = launches_now(mods)
    sh_peak = torch.cuda.max_memory_allocated()
    factors = sh_keep["opt_state"]["factors"]
    big = max(factors, key=lambda k: factors[k].shape[-1])
    eig_ms = {}
    for key in (big, "layers/wq/L"):
        M = factors[key][0]
        times_eig = []
        for _ in range(2):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            w, V = torch.linalg.eigh(M)
            b.record()
            b.synchronize()
            times_eig.append(a.elapsed_time(b))
            del w, V
        eig_ms[key] = {"n": M.shape[-1], "ms": times_eig}
    for i, (m, ms) in enumerate(zip(sh_metrics, sh_times)):
        emit({"phase": "train_shampoo", "step": i, "loss": m["loss"],
              "grad_norm": m["grad_norm"], "tokens": m["tokens"],
              "step_ms": ms, "update_ms": sh_timing["update_ms"][i]})
    emit({"phase": "train_shampoo_summary",
          "shard_sizes": {n: lo.plan.shard_size
                          for n, lo in rt.layouts.items()},
          "factors": {k: list(t.shape) for k, t in factors.items()},
          "setup_s": sh_timing["setup_s"],
          "setup_and_steps_s": time.perf_counter() - t0,
          "max_memory_allocated": sh_peak, "eigh_ms": eig_ms,
          "kernel_launches": sh_launches})
    if sh_launches != {k: 0 for k in sh_launches}:
        fail(f"train_shampoo launched {sh_launches}: the fp32 store and "
             f"Shampoo run no kernel of the port")
    if eig_ms[big]["n"] != qwen_full.d_ff:
        fail(f"the largest factor {big} is {eig_ms[big]['n']} wide")
    for m in sh_metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"non-finite train_shampoo metrics {m}")
    if abs(sh_metrics[0]["loss"] - qwen_loss0) > 1.0:
        fail(f"first train_shampoo loss {sh_metrics[0]['loss']} far from "
             f"{qwen_loss0}")
    del rt, sh_keep, factors, M
    torch.cuda.empty_cache()

    # ---- 10, 20, 13, 30, 26b, 35. the card against the CPU reference, in a
    # process of its own ---------------------------------------------
    # the host masters of phases 38-40, 12b and 12c are drawn beside it
    # (its checks hold values, not times) and awaited before phase 11, so
    # that no timed phase shares the host with the draw
    prefetch = HostPrefetch({
        **{n: FSDPRuntime(build_model(published_config(n)[0]), group,
                          compute_dtype=torch.bfloat16, device="meta")
           for n in PREFETCHED},
        **{n: FSDPRuntime(build_model(cfg), group,
                          compute_dtype=torch.bfloat16, device="meta",
                          schedule=sched)
           for n, (cfg, sched) in ((n, long500k_runtime_args(n))
                                   for n in LONG500K)}})
    emit({"phase": "reference", "process": "child",
          "seconds": run_reference()})
    emit({"phase": "prefetch", "runs": [*PREFETCHED, *LONG500K],
          "wait_s": prefetch.wait(),
          "draw_s": {n: d[1] for n, d in prefetch.done.items()},
          "host_mem_available_gb": host_mem_available() / 1e9})

    # ---- 11. q8_matmul vs plain ----------------------------------------
    q8mm_stats = phase_kernel_q8mm(ops, ref, q8_matmul)
    q8mm_sliced = phase_kernel_q8mm_sliced(ops, ref)

    # ---- 12. serve path: gemma2-2b at full width, int8 and dense q8 ----
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).to("cuda")
    requests = [rng.integers(0, cfg.vocab, (int(n),)) for n in rng.integers(
        ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1, ENGINE_REQUESTS)]
    emit({"phase": "serve_setup", "model": cfg.name,
          "cut": {"n_layers": [full.n_layers, TRAIN_LAYERS]},
          "prefill": [SERVE_BATCH, SERVE_PROMPT], "cache_len": SERVE_LEN,
          "decode_steps": SERVE_STEPS,
          "engine": {"pool": ENGINE_POOL, "requests": ENGINE_REQUESTS,
                     "prompt_lens": [len(r) for r in requests],
                     "max_new": ENGINE_NEW}})
    serve_model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = FSDPRuntime(serve_model, group, compute_dtype=torch.bfloat16,
                     schedule=CommSchedule(**SERVE_SCHEDULE))
    serve_params = rt.init_params(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    serve_logits = {}
    for mode, sched in (("q8_serve_matmul", SERVE_SCHEDULE),
                        ("q8_dense", SERVE_DENSE_SCHEDULE)):
        if mode != "q8_serve_matmul":
            rt2 = FSDPRuntime(serve_model, group,
                              compute_dtype=torch.bfloat16,
                              schedule=CommSchedule(**sched))
            if any(rt2.layouts[n].plan != lo.plan
                   for n, lo in rt.layouts.items()):
                fail("the dense q8 serve plans differently: cannot share "
                     "the parameter state")
            rt = rt2
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        metrics, serve_logits[mode], calls = serve_run(
            rt, serve_model, serve_params, prompts, requests)
        got = launches_now(mods)
        want = expected_serve_launches(rt, calls, got)
        emit({"phase": "serve", "mode": mode, "schedule": sched,
              "setup_s": setup_s, **metrics,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "calls": calls, "kernel_launches": got,
              "expected_launches": want,
              "per_call": {k: v // calls for k, v in want.items()}})
        if got != want:
            fail(f"serve {mode} launched {got}, expected {want}")
        if serve_logits[mode].shape != (SERVE_BATCH, 1, cfg.vocab):
            fail(f"serve {mode} prefill logits have shape "
                 f"{tuple(serve_logits[mode].shape)}")
        if mode == "q8_serve_matmul":
            # by regime: the two prefills (M = 4 x 512) and every decode
            # and engine call (M <= the pool of 4)
            per_call = want["q8_matmul"] // calls
            serve_launches = {
                "decode": q8_matmul.q8_matmul.decode_launches,
                "prefill": q8_matmul.q8_matmul.prefill_launches}
            serve_want = {"decode": per_call * (calls - 2),
                          "prefill": per_call * 2}
            emit({"phase": "serve", "mode": mode,
                  "q8_matmul_launches_by_regime": serve_launches,
                  "expected": serve_want})
            if serve_launches != serve_want:
                fail(f"serve {mode}: q8_matmul regimes {serve_launches}, "
                     f"expected {serve_want}")
    quant_vs_dense = rel_l2(serve_logits["q8_serve_matmul"].float(),
                            serve_logits["q8_dense"].float())
    emit({"phase": "serve_summary", "prefill_rel_l2_int8_vs_dense":
          quant_vs_dense, "limit": SERVE_INT8_VS_DENSE})
    if not quant_vs_dense < SERVE_INT8_VS_DENSE:
        fail(f"int8 serve prefill logits {quant_vs_dense} from the dense "
             f"q8 serve's (limit {SERVE_INT8_VS_DENSE})")
    del rt, serve_params, serve_logits
    torch.cuda.empty_cache()

    # ---- 12b, 12c. the long_500k decode at published width and depth ---
    long = long500k_phases(LONG500K, dry, prefetch)

    # ---- 27-29. the recurrent families: train and serve at published width
    from repro_torch.models.cache import leaves as cache_leaves
    from repro_torch.models.cache import tree_map as cache_map

    def at_fill(cache, row, model) -> bool:
        """Every leaf of ``cache``'s batch row ``row`` at the model's
        empty value."""
        same = cache_map(lambda leaf, bdim, fill: bool(
            (leaf.select(bdim, row) == fill).all()), cache,
            model.cache_batch_dims(), model.cache_fill())
        return all(v for _, v in cache_leaves(same))

    rec = {}
    for key, arch, layers in (("train_xlstm", XLSTM, None),
                              ("train_hymba", HYMBA, HYMBA_LAYERS)):
        # ---- 27, 28. train: AdamW on the fp32 store, 2 x 2048 ------------
        full_r = get_config(arch)
        rcfg = full_r if layers is None else dataclasses.replace(
            full_r, n_layers=layers)
        rstream = SyntheticStream(DataConfig(rcfg.vocab, REC_SEQ,
                                             REC_BATCH), rcfg)
        rtokens = REC_BATCH * REC_SEQ
        rloss0 = math.log(rcfg.vocab) + 2.0   # untied head, as qwen2.5
        emit({"phase": key + "_setup", "model": arch,
              "cut": {"n_layers": [full_r.n_layers, rcfg.n_layers]},
              "d_model": rcfg.d_model,
              "heads": [rcfg.n_heads, rcfg.n_kv_heads],
              "head_dim": rcfg.hd, "d_ff": rcfg.d_ff, "vocab": rcfg.vocab,
              "slstm_every": rcfg.slstm_every, "ssm_state": rcfg.ssm_state,
              "sliding_window": rcfg.sliding_window,
              "batch": [REC_BATCH, REC_SEQ], "optimizer": "adamw",
              "store": "fp32", "compute": "bfloat16"})
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()   # what earlier phases hold
        reset_launches(mods)
        plain_calls, restore_plain = count_plain(ops)
        timing, keep = {}, {}
        t0 = time.perf_counter()
        try:
            metrics, times, rt = train(rcfg, "cuda", torch.bfloat16,
                                       rstream, 1 + TIMED_STEPS,
                                       timings=timing, keep=keep)
            # one more step, untimed, its CUDA ops counted
            step_fn = rt.make_train_step(keep["optimizer"])
            batch = rstream.shard(rstream.batch(1 + TIMED_STEPS), rt)
            torch.cuda.synchronize()
            (params, _, _, m_last), n_ops, by_op = count_cuda_ops(
                lambda: step_fn(keep["params"], keep["opt_state"],
                                1 + TIMED_STEPS, batch))
            torch.cuda.synchronize()
        finally:
            restore_plain()
        r_launches = launches_now(mods)
        r_peak = torch.cuda.max_memory_allocated()
        steps_run = len(metrics) + 1
        metrics.append({k: float(v) for k, v in m_last.items()})
        for i, (m, ms) in enumerate(zip(metrics, times)):
            emit({"phase": key, "step": i, "warmup": i == 0,
                  "loss": m["loss"], "grad_norm": m["grad_norm"],
                  "tokens": m["tokens"], "step_ms": ms,
                  "tokens_per_s": rtokens / (ms / 1e3)})
        r_ms = statistics.median(times[1:])
        r_want = {k: 0 for k in r_launches}
        r_want["adamw_store_update"] = len(rt.layouts) * steps_run
        shape_r = ShapeConfig(key, REC_SEQ, REC_BATCH, "train")
        summary = {
            "phase": key + "_summary",
            "shard_sizes": {n: lo.plan.shard_size
                            for n, lo in rt.layouts.items()},
            "params": sum(math.prod(lo.local_shape())
                          for lo in rt.layouts.values()),
            "setup_s": timing["setup_s"],
            "setup_and_steps_s": time.perf_counter() - t0,
            "step_ms_median": r_ms,
            "tokens_per_s": rtokens / (r_ms / 1e3),
            "mfu": roofline.mfu(rcfg, shape_r, r_ms / 1e3),
            "max_memory_allocated": r_peak,
            "allocated_before": base, "own_peak": r_peak - base,
            "cuda_ops_per_step": n_ops,
            "cuda_ops_top": dict(sorted(by_op.items(),
                                        key=lambda kv: -kv[1])[:8]),
            "counted_step_loss": metrics[-1]["loss"],
            "kernel_launches": r_launches, "expected_launches": r_want,
            "plain_calls": {k: v for k, v in plain_calls.items() if v},
            "expected_first_loss": rloss0}
        emit(summary)
        if r_launches != r_want:
            fail(f"{key} launched {r_launches}, expected {r_want}")
        if any(plain_calls.values()):
            fail(f"{key} ran plain versions {plain_calls}")
        for m in metrics:
            if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
                fail(f"non-finite {key} metrics {m}")
        if abs(metrics[0]["loss"] - rloss0) > 1.0:
            fail(f"first {key} loss {metrics[0]['loss']} far from {rloss0}")
        held = hold_update_at(key, rt, fused_update, ref)

        # ---- 29. serve_recurrent: the trained weights, bf16 compute ------
        serve_key = "serve_" + key.split("_", 1)[1]
        reset_launches(mods)
        plain_calls, restore_plain = count_plain(ops)
        prefill, decode = rt.make_prefill_step(), rt.make_decode_step()
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, rcfg.vocab, (REC_BATCH, REC_SEQ))).to("cuda")
        max_len = REC_SEQ + REC_SERVE_STEPS
        try:
            prefill(params, {"tokens": prompts},
                    rt.init_cache(REC_BATCH, max_len))        # warm-up
            # a fresh cache: a prefill continues from the cache's state
            cache = rt.init_cache(REC_BATCH, max_len)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": prompts}, cache)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
            if tuple(logits.shape) != (REC_BATCH, 1, rcfg.vocab):
                fail(f"{serve_key}: prefill logits {tuple(logits.shape)}")
            tok = torch.argmax(logits, -1)
            dec_ms = []
            for i in range(REC_SERVE_STEPS):
                t0 = time.perf_counter()
                lg, cache = decode(params, {"tokens": tok}, cache,
                                   REC_SEQ + i)
                tok = torch.argmax(lg, -1)
                torch.cuda.synchronize()
                dec_ms.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(lg.float()).all()):
                fail(f"{serve_key}: non-finite decode logits")
            del cache
            # the engine on the serve phase's request lengths; every
            # admission resets the slot's row, audited: the row of a slot
            # an earlier request used differs from the empty cache before
            # the reset and equals it after
            eng = ServeEngine(rt, rt.model, params, pool=ENGINE_POOL,
                              max_len=SERVE_LEN)
            audit = {"resets": 0, "used_rows": 0, "not_reset": 0}
            plain_reset = eng._reset_row

            def audited(row, eng=eng, audit=audit, plain_reset=plain_reset):
                audit["used_rows"] += not at_fill(eng.cache, row, rt.model)
                plain_reset(row)
                audit["resets"] += 1
                audit["not_reset"] += not at_fill(eng.cache, row, rt.model)

            eng._reset_row = audited
            reqs = [Request(uid=i, prompt=r % rcfg.vocab, max_new=ENGINE_NEW)
                    for i, r in enumerate(requests)]
            for r in reqs:
                eng.submit(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls = 0
            while eng.queue or any(sl.req for sl in eng.slots):
                eng.step()
                calls += 1
            engine_s = time.perf_counter() - t0
            del eng._reset_row    # the audit's closure: eng -> it -> eng
        finally:
            restore_plain()
        s_launches = launches_now(mods)
        new_tokens = sum(len(r.out) for r in reqs)
        dec_med = statistics.median(dec_ms[1:])
        emit({"phase": "serve_recurrent", "model": arch, "run": serve_key,
              "prefill": [REC_BATCH, REC_SEQ], "cache_len": max_len,
              "prefill_ms": pre_ms, "decode_step_ms": dec_ms,
              "decode_step_ms_median": dec_med,
              "decode_tokens_per_s": REC_BATCH / (dec_med / 1e3),
              "engine": {"pool": ENGINE_POOL, "requests": len(reqs),
                         "max_new": ENGINE_NEW, "calls": calls,
                         "seconds": engine_s, "new_tokens": new_tokens,
                         "tokens_per_s": new_tokens / engine_s, **audit},
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "allocated_before": base,
              "kernel_launches": {k: v for k, v in s_launches.items() if v},
              "plain_calls": {k: v for k, v in plain_calls.items() if v}})
        if any(s_launches.values()) or any(plain_calls.values()):
            fail(f"{serve_key} launched {s_launches}, plain {plain_calls}: "
                 f"the fp32 store serves without the port's kernels")
        if not all(r.done and len(r.out) == ENGINE_NEW for r in reqs):
            fail(f"{serve_key}: the engine left requests unfinished")
        if audit["not_reset"] or audit["resets"] != len(reqs) \
                or audit["used_rows"] != len(reqs) - ENGINE_POOL:
            fail(f"{serve_key}: slot resets {audit}")
        rec[key] = {"launches": r_launches["adamw_store_update"],
                    "held": {n: {k: h[k] for k in ("ms", "plain_ms",
                                                   "bound_ms",
                                                   "max_abs_err")}
                             for n, h in held.items()}}
        del rt, keep, params, batch, step_fn, eng, audited, plain_reset
        del prompts, logits, lg
        torch.cuda.empty_cache()

    # ---- 31-33. the cross-attention families at published width -------
    cross = crossattn_phases()

    # ---- 36-41. the configurations first run here (slice 17) ------------
    pub = published_phases(PUBLISHED_PHASES, dry, prefetch)

    # ---- 26. the five examples on the card, then card vs CPU -----------
    from repro_torch.examples import (continuous_batching, muon_demo,
                                      quickstart, serve_moe, train_8bit_adam)

    def groups_of(arch: str) -> int:
        return len(build_model(get_config(arch).reduced()).groups())

    examples = {"quickstart": quickstart, "train_8bit_adam": train_8bit_adam,
                "muon_demo": muon_demo, "serve_moe": serve_moe,
                "continuous_batching": continuous_batching}
    ex_want = {
        "quickstart": {"adamw_store_update": groups_of("gemma2-2b")
                       * EXAMPLE_STEPS["quickstart"]},
        "train_8bit_adam": {
            k: groups_of("gpt-oss-120b") * EXAMPLE_STEPS["train_8bit_adam"]
            for k in ("adamw_store_update", "adam8bit_store_update")},
        "muon_demo": {"adamw_store_update": groups_of("qwen2.5-14b")
                      * EXAMPLE_STEPS["muon_demo"]},
        "serve_moe": {}, "continuous_batching": {}}
    ex_launches = {}
    for name, mod in examples.items():
        reset_launches(mods)
        plain_calls, restore_plain = count_plain(ops)
        t0 = time.perf_counter()
        try:
            mod.main([])
        finally:
            restore_plain()
        ex_s = time.perf_counter() - t0
        got = {k: v for k, v in launches_now(mods).items() if v}
        ex_launches[name] = got
        emit({"phase": "examples", "example": name, "device": "cuda",
              "argv": [], "seconds": ex_s, "kernel_launches": got,
              "expected_launches": ex_want[name],
              "plain_calls": {k: v for k, v in plain_calls.items() if v}})
        if got != ex_want[name]:
            fail(f"example {name} launched {got}, expected {ex_want[name]}")
        if any(plain_calls.values()):
            fail(f"example {name} ran plain versions {plain_calls}")

    # ---- the kernels line, the card, the last line ---------------------
    csrc = "src/repro_torch/kernels/csrc/"

    def entry(name, source, replaces, launches, st):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": st["max_abs_err"], "ms": st["ms"],
                "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                "bound_by": st.get("bound_by", "bytes"), "library_ms": None}

    emit({"phase": "script", "seconds": time.perf_counter() - t_script})
    sched_adamw = sum(v["adamw_store_update"] for v in
                      sched_launches.values())
    emit({"kernels": [
        {**entry("adamw_store_update", "adamw_store_update.cu",
                 "src/repro/kernels/fused_update.py:85", launches, kstats),
         "launches_by_path": {"train": launches, "train_sched": sched_adamw,
                              "train_cli": cli_launches["adamw_store_update"],
                              "train_ce_chunk":
                                  ce_launches["adamw_store_update"],
                              "auto_plan":
                                  auto_launches["adamw_store_update"],
                              "ckpt": ckpt_launches["adamw_store_update"],
                              "ckpt_tp":
                                  ckpt_tp_launches["adamw_store_update"],
                              "examples": sum(
                                  v.get("adamw_store_update", 0)
                                  for v in ex_launches.values()),
                              "train_xlstm": rec["train_xlstm"]["launches"],
                              "train_hymba": rec["train_hymba"]["launches"],
                              "train_encdec":
                                  cross["train_encdec"]["launches"],
                              **{k: v["launches"] for k, v in pub.items()
                                 if k in PUBLISHED
                                 and v["kernel"] == "adamw_store_update"}},
         "held_at": {**{k: v["held"] for k, v in rec.items()},
                     "train_encdec": cross["train_encdec"]["held"],
                     **{k: {"fmt": v["fmt"], **v["held"]}
                        for k, v in pub.items() if k in PUBLISHED
                        and v["kernel"] == "adamw_store_update"}}},
        {**entry("adamw_store_update_q8", "adamw_store_update.cu",
                 "src/repro/kernels/fused_update.py:102",
                 q8_launches["adamw_q8"], q8stats["adamw_q8"]),
         "launches_by_path": {
             "train_q8": q8_launches["adamw_q8"],
             "train_micro": micro_launches["adamw_q8"],
             "train_sched": sum(v["adamw_q8"]
                                for v in sched_launches.values()),
             "ckpt": ckpt_launches["adamw_q8"]}},
        {**entry("quantize", "blockwise_quant.cu",
                 "src/repro/kernels/blockwise_quant.py:56",
                 q8_launches["quantize"], q8stats["quantize"]),
         "launches_by_path": {"train_q8": q8_launches["quantize"],
                              "train_micro": micro_launches["quantize"],
                              "train_muon_q8": muon_launches["quantize"],
                              "train_sched": sum(
                                  v["quantize"]
                                  for v in sched_launches.values()),
                              "ckpt": ckpt_launches["quantize"],
                              "serve_vision":
                                  cross["serve_vision"]["quantize"],
                              "serve_granite":
                                  pub["serve_granite"]["quantize"],
                              **{k: v["quantize"] for k, v in long.items()}},
         "by_path": {**q8stats["quantize"]["by_path"],
                     "serve_vision": cross["q8"]["init"]}},
        {**entry("dequantize_into", "blockwise_quant.cu",
                 "src/repro/kernels/blockwise_quant.py:66",
                 q8_launches["dequantize_into"], q8stats["dequantize_into"]),
         "launches_by_path": {
             "train_q8": q8_launches["dequantize_into"],
             "train_micro": micro_launches["dequantize_into"],
             "train_muon_q8": muon_launches["dequantize_into"],
             "train_sched": sum(v["dequantize_into"]
                                for v in sched_launches.values()),
             "ckpt": ckpt_launches["dequantize_into"],
             "serve_vision": cross["serve_vision"]["q8_serve_matmul"]
             + cross["serve_vision"]["q8_dense"],
             "serve_granite": pub["serve_granite"]["dequantize_into"],
             **{k: v["dequantize_into"] for k, v in long.items()}},
         "by_path": {**q8stats["dequantize_into"]["by_path"],
                     "serve_vision_int8_call": cross["q8"]["int8_call"],
                     "serve_vision_dense_call": cross["q8"]["dense_call"],
                     "nemotron_wk_wv": {
                         k: pub["kernel_q8mm_nemotron"]["kv"][k]
                         for k in ("ms", "plain_ms", "bound_ms",
                                   "max_abs_err")}}},
        {**entry("dequantize", "blockwise_quant.cu",
                 "src/repro/kernels/blockwise_quant.py:144",
                 q8_launches["dequantize"], q8stats["dequantize"]),
         "launches_by_path": {"train_q8": q8_launches["dequantize"],
                              "train_micro": micro_launches["dequantize"],
                              "auto_plan": auto_launches["dequantize"],
                              "ckpt": ckpt_launches["dequantize"]}},
        {**entry("encode_ef", "encode_ef.cu",
                 "src/repro/kernels/encode_ef.py:30",
                 q8_launches["encode_ef"], q8stats["encode_ef"]),
         "launches_by_path": {"train_q8": q8_launches["encode_ef"],
                              "train_micro": micro_launches["encode_ef"],
                              "auto_plan": auto_launches["encode_ef"],
                              "ckpt": ckpt_launches["encode_ef"]}},
        {**entry("adam8bit_store_update", "adam8bit_store_update.cu",
                 "src/repro/kernels/fused_update.py:116",
                 moe_launches["adam8bit_store_update"], a8stats["flat"]),
         "launches_by_path": {
             "train_moe": moe_launches["adam8bit_store_update"],
             "examples": ex_launches["train_8bit_adam"][
                 "adam8bit_store_update"],
             "train_gptoss": pub["train_gptoss"]["launches"]},
         "held_at": {"train_gptoss": {"fmt": pub["train_gptoss"]["fmt"],
                                      **pub["train_gptoss"]["held"]}}},
        entry("adam8bit_store_update_q8", "adam8bit_store_update.cu",
              "src/repro/kernels/fused_update.py:145",
              a8q_launches["adam8bit_q8"], a8stats["q8"]),
        {**entry("q8_matmul_decode", "q8_matmul.cu",
                 "src/repro/kernels/q8_matmul.py:81",
                 serve_launches["decode"], q8mm_stats["decode"]),
         "launches_by_path": {
             "serve": serve_launches["decode"],
             "serve_vision": cross["serve_vision"]["regimes"]["decode"],
             "serve_granite": pub["serve_granite"]["regimes"]["decode"],
             **{k: v["q8_matmul_decode"] for k, v in long.items()
                if v["q8_matmul_decode"]}},
         "long_m1": q8mm_stats["decode_m1"],
         "sliced": q8mm_sliced["decode"],
         "vision": cross["q8mm"]["decode"],
         "nemotron": pub["kernel_q8mm_nemotron"]["decode"]},
        {**entry("q8_matmul_prefill", "q8_matmul.cu",
                 "src/repro/kernels/q8_matmul.py:81",
                 serve_launches["prefill"], q8mm_stats["prefill"]),
         "launches_by_path": {
             "serve": serve_launches["prefill"],
             "serve_vision": cross["serve_vision"]["regimes"]["prefill"],
             "serve_granite": pub["serve_granite"]["regimes"]["prefill"]},
         "sliced": q8mm_sliced["prefill"],
         "vision": cross["q8mm"]["prefill"],
         "nemotron": pub["kernel_q8mm_nemotron"]["prefill"]},
        entry("adamw_store_update_fp8", "adamw_store_update.cu",
              "src/repro/kernels/fused_update.py:93",
              fp8_launches["train_fp8"]["adamw_fp8"], fp8stats["adamw_fp8"]),
        entry("adam8bit_store_update_fp8", "adam8bit_store_update.cu",
              "src/repro/kernels/fused_update.py:130",
              fp8_launches["train_fp8_adam8"]["adam8bit_fp8"],
              fp8stats["adam8bit_fp8"]),
        entry("adamw_update", "adamw_store_update.cu",
              "src/repro/kernels/adam_update.py:23",
              sa_launches["adamw_update"], fp8stats["adamw_update"]),
        entry("adam8bit_update", "adam8bit_store_update.cu",
              "src/repro/kernels/adam8bit_update.py:50",
              sa_launches["adam8bit_update"], fp8stats["adam8bit_update"]),
    ]})
    # every plan verification of the run: train_cli's (a meta twin in a
    # child process, no card) and each production dry run's
    emit({"verify": verify_runs})
    bad = {k: v for k, v in verify_runs.items()
           if v is None or v["errors"] or not v["checked"]}
    if bad:
        fail(f"plan verification failed or did not run: {bad}")
    torch.distributed.destroy_process_group()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
