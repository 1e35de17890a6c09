"""Smoke run of the PyTorch port on one NVIDIA H100: build the hand-written
kernels, hold each against its plain version, drive the tiled serving path,
the training path (with quick-evals), the quantization comparison, training
and serving with the fused stem, training with the fused bottleneck blocks,
data-parallel training in a process group, the rest of the model zoo,
``int8_exec_xla`` serving on the int8 convs, quantization-aware training,
training with rematerialized activations and with bf16 parameters, the
spatial model axis (image rows split over ranks), scene-parallel serving and
the multi-device dry run, the fused stem and blocks in a process group, and
the serving fns as CUDA-graph engines and as exported artifacts.

    python3 chip_smoke.py
    python3 chip_smoke.py --block-stat-starts 16   # phase 13's statistics
                                                   # from 16 training starts
    python3 chip_smoke.py --block-f32-starts 8     # phase 13's float32 holds
                                                   # from 9 training starts

Phases (each prints its result; any failure raises and the exit code is
not 0):
  1. the card's name and power limit (nvidia-smi);
  2. the builds of ``iswm_tpu_torch/csrc/*.cu`` with nvcc, all started
     together, timed;
  3. ``int8_matmul`` against its plain version, bit for bit
     (``torch.equal``), at every routed shape of the serving slice
     (DeepLabV3+/ResNet-50, OS 16, tile 512, batch 8, bf16) plus a ragged
     M, a saturating x, exact .5 ties, a float32 x, and a shape for each
     branch of the kernel's plan (K splits at M = 8 and M = 200, M = 1000
     at more N, N groups at a ragged M, float32 x at both K splits); at each
     shape the plan
     (rows of a strip, stages, N groups, K splits, blocks, shared memory,
     which must stay within 227 KB), the kernel's device time with the
     inputs out of L2 (TOP/s, share of the bound) and by CUDA events, the
     plain version's, a bf16 1x1 ``F.conv2d``'s, ``torch._int_mm``'s (the
     int32 product alone, another function) where it takes the shape, and
     the f32 -> bf16 cast of the result that each serving site runs after
     the kernel; summed over a chunk's 30 sites;
  4. the serving slice: ``Predictor`` with ``serving_variant="int8_exec"``
     and seeded weights on two seeded uint8 scenes (1024x1536, 1100x1300)
     through ``predict_image``; the launch count must be 30 per chunk, the
     logits finite and equal to those of the same Predictor with its int8
     sites on the plain version (deterministic cuDNN); one chunk of 8 tiles
     through the serving fn of ``bf16`` and of ``int8_exec``: its time on the
     host's clock and, from a profiler trace, its device time, the int8
     kernel's share of it and the device's idle share; then tiles/s and
     scene latency of ``bf16`` and ``int8_exec``;
  5. the fused binary CE kernels (forward sums, backward d_logits) against
     their plain versions, each case through the body the wrapper must pick
     (``launches_by_layout``): the training slice's logits [8, 2, 512, 512]
     in bf16 and f32, NCHW (``nchw``) and channels last (``channels_last``),
     a ragged H*W [3, 2, 97, 131] (``strided``) and the same channels last
     (the vector body's tail), a slice of a larger tensor and channels-last
     strides at a misaligned offset (``strided``), uint8, int32 and int64
     labels, and all-ignored batches, after which the channels-last slice's
     forward must give its bits again (the ticket was reset); forward sums
     within 1e-5 relative of the plain version in float64 and bit-stable
     across launches, d_logits within 1e-6 * max|d_logits| in f32 and 1 bf16
     ulp in bf16; device times (profiler) with the inputs out of L2 and from
     L2, each with its share of the bound, and CUDA-event times of kernel and
     plain version at the slice's shape and layout;
  6. the training slice at full width: ``Trainer`` on ResNet-50, OS 16,
     bf16, crop 512, batch 8, ``ce_loss`` with ``fused_kernel="auto"``, from
     32 seeded synthetic 640x640 scenes (8 for validation), for
     ``TRAIN_STEPS`` steps, one validation and a best checkpoint; the fused
     CE launch counts must equal the step count in each direction, all of
     them through the ``channels_last`` body (``launches_by_layout``), every
     logged loss be finite, and the checkpoint load ``strict=True`` into a
     fresh model; one step through the kernel and one through
     ``fused="never"`` from the same state, with deterministic algorithms,
     agree: loss within 1e-5 relative, each parameter's gradient (a fresh
     SGD's update is a fixed function of it) within 1e-2 * max|grad| in
     f32; in bf16 the median tensor within 5e-2 and the worst within 2.5e-1
     (bf16 rounding of the backward: the same bf16 step run twice with the
     default, atomics-based algorithms differs by 3.7e-2 * max|update|, and
     the worst of 188 tensors is heavy-tailed); then the median train step
     and train tiles/s;
  7. the evaluation kernels: ``binary_confusion_matrix`` equal (tolerance 0)
     to its plain version and to ``confusion_matrix(n_classes=2)`` at the
     quick-eval shape [8, 512, 512], a ragged [3, 77, 91], one pixel, more
     than 2^24 pixels, all pixels ignored, and uint8 / int32 / int64 inputs;
     ``int8_matmul_prequant`` equal (tolerance 0) to its plain version and
     to ``int8_matmul`` on the same x at the 13 routed shapes, a ragged M,
     and K splits at M = 200 and M = 8; device times (profiler) of the
     confusion kernel, its plain version and ``torch.bincount``; the plan,
     and the device times (inputs out of L2) and CUDA-event times of the two
     int8 entries side by side;
  8. training with quick-eval (the same ``fit`` as phase 6, which runs with
     ``quick_eval_interval`` set): the ``quick_*`` series of
     ``metrics.jsonl`` stand at the steps asked for, the confusion kernel
     was launched once per validation batch of each quick-eval, and
     ``Trainer.quick_eval`` equals the metrics of the plain confusion matrix
     over the same predictions (1e-6, deterministic cuDNN);
  9. ``compare_variants`` at full width: ResNet-50, OS 16, bf16, seeded
     weights, eight seeded synthetic 512x512 scenes with masks from memory,
     variants f32 / bf16 / int8 / int8_act / int8_exec in 7-frame windows;
     every variant has a finite latency and the five metrics, f32 is the
     reference, bf16 and int8 agree with it in the top two verdict tiers,
     int8_act has one scale per activation site and differs from int8,
     int8_exec launches 30 kernels per image; the report table is printed;
 10. the four fused stem kernels (``stem_stats``, ``stem_norm_relu_pool``, the
     two of ``stem_tail_bwd``) against their plain versions: the slice's
     z [8, 64, 256, 256] in bf16 and f32, NHWC memory and NCHW, conv sides 32,
     20 and 44 (whole and ragged 4 x 16 tiles of the float32 body), 36 and 40
     (ragged against the bf16 body's 8 x 32 tiles in rows and columns, and
     in columns alone), batch 1, batch 3 at side 64 (16 tiles an image), an
     all-tie z (dbeta equals sum dp) and an all-negative pre-activation
     (every gradient 0).
     The pooled output equals the plain version bit for bit; the statistics,
     s1 (dbeta), s2 (dgamma) and dW are within 1e-5 * max|tensor| of the plain
     version summed in float64 (the kernels sum in float32, in another order)
     and equal bit for bit across two launches; dW is held against the plain
     contraction of the same rounded dz (the kernel's own s1 / N and s2 / N go
     into both).  Device times with z out of the L2 cache: each kernel, its
     plain version, and the unfused chain on the same tensors
     (``F.batch_norm`` + ReLU + ``F.max_pool2d``; their autograd backward plus
     the conv's cuDNN weight gradient);
 11. the fused stem at full width: phase 6's ``Trainer`` with
     ``fused_stem="always"`` for ``STEM_STEPS`` steps, a quick-eval and a
     validation; ``stem_stats`` and the two backward kernels are launched
     once per step, ``stem_norm_relu_pool`` once per step and per eval
     forward; every loss finite; the best ``.pth`` loads ``strict=True`` into
     an unfused model; one step fused and one unfused from the same state with
     deterministic algorithms: ``bn1``'s running statistics within 1e-5 (of
     max|var|, and of max sqrt(var) for the mean), the loss within 1e-3
     relative in f32 and 2e-2 in bf16 (the unfused BatchNorm rounds before
     the ReLU and the pool, the fused one after, and takes another variance
     formula); the stem's three gradients against the unfused chain's
     autograd on the fused step's own image, parameters and pooled cotangent:
     in f32 conv1 within 5e-3 * max|grad| (the library's weight gradient
     reads TF32) and bn1 within 1e-5 when no ReLU sign or pool winner differs
     between the two chains on that input (counted and printed), else within
     1e-2 (one element decided the other way moved it to 3e-3 once), in bf16 conv1
     within 1e-1 (many pool windows tie, and equal-split and first-index
     routing are two subgradients) and bn1 within 2e-2: limits of three to
     seven times the largest reading of the runs, whose readings spread by a
     factor of two to fifteen.  The whole step's gradients are not held to phase 6's bands: a step of this
     model is chaotic in its forward, so the median tensor's difference is
     printed beside that of an unfused step whose pooled values were moved by
     an ulp or two at one value in a million; the median train step of both,
     and the stem kernels' share of a step's device time from a profiler
     trace; then a
     bf16 ``Predictor`` with the fused stem on the 1024x1536 scene:
     ``stem_norm_relu_pool`` once per chunk, finite logits, mask agreement
     with the unfused Predictor >= 0.999, scene latency of both;
 12. the four fused bottleneck kernels (``matmul_bn_stats`` and
     ``conv3x3_bn_stats``, forward and backward) against their plain versions
     in bf16 and f32: every 1x1 (M, K, N) and every 3x3 shape of the slice's
     12 fused blocks, with and without the normalize + ReLU prologue as the
     model uses them, a ragged M (16 * 37), one tile, channel counts below a
     tile, ragged 3x3 images, an all-negative prologue (every output and
     gradient 0) and ds = dq = 0.  y and dx within one ulp of the compute
     dtype of the plain version summed in float64 and rounded once (bf16;
     the ulp taken at max(|y|, max|y| / 128)) or within 1e-5 * max (f32: a
     float32 sum thousands of terms long in another order); s and q within
     1e-5 * max of the float64 sums over the kernel's OWN y; dw, da, db
     within 1e-5 * max of the plain version summed in float64 at f32 and
     5e-5 * max at bf16; everything equal bit for bit across two launches.
     Device times with the inputs out of L2 of each kernel, its plain version
     and the unfused chain on the same tensors (conv + ``F.batch_norm`` train
     + ReLU through the libraries, and their autograd backward: another
     function), at each shape in bf16, summed over a train step's launches;
     the 1x1 backward also in its two halves, each through its C entry with
     its finishing sum (the data gradient, the weight gradient), beside the
     whole call's bound;
 13. the fused blocks at full width: phase 6's ``Trainer`` with
     ``fused_blocks="always"`` for ``BLOCK_STEPS`` steps, a quick-eval and a
     validation: 26 launches of the 1x1 and 12 of the 3x3 kernels per step in
     each direction and none in evaluation, every loss finite, the best
     ``.pth`` loads ``strict=True`` into an unfused model, the shapes the gate
     passes equal phase 12's tables.  For ``layer1.0`` (with downsample),
     ``layer2.1`` and ``layer4.0``, on the fused step's own input, parameters
     and output cotangent: the fused block's output within 2e-2 * max in bf16
     and 1e-4 in f32 of the block's arithmetic in float64; its running
     statistics equal, bit for bit, those of a replay of the fused block and
     lie within 1e-4 (bf16) and 1e-5 (f32) of the unfused BatchNorm modules'
     fed the fused convs' own outputs; in f32 within 1e-5 of the whole
     unfused modules', in bf16 no farther from the float64 block's than 5
     times the unfused modules' distance (the gap between the two, whose
     convs round differently, is printed).
     dx (by its mean) and every parameter gradient (by its largest element)
     are held against that float64 block: in f32 within 5e-2 (readings to
     1.3e-2: flipped ReLU decisions; a wrong term shows as 0.3 or more); in
     bf16 relative to the unfused library modules (deterministic, TF32 off),
     which four steps from random weights lie as far from float64 as the fused
     block does (0.03-0.6 * max): the fused block's worst tensor at most 5
     times as far as the unfused modules' worst, its median tensor at most 4
     times as far as their median.  The whole step's loss and gradients fused
     against unfused are printed, not held (chaotic, as in
     phase 11).  Then, with the card's name and power limit: the median train
     step both ways, ``max_memory_allocated``, and from one profiler trace
     each the device time per step, the kernel launches per step and the
     device time by class (convs / BN / elementwise / the new kernels);
 14. the sharded fused CE (``make_sharded_fused_ce``: kernel #4's forward on a
     rank's rows, an all-reduce of the two sums, kernel #4's backward with the
     global weight sum) in a 1-rank ``nccl`` group opened through a
     rendezvous file: at the slice's [8, 2, 512, 512] in bf16 (channels last)
     and f32 and with every pixel ignored, the reduced sums, the loss and
     d_logits equal the unsharded kernel bit for bit, and the loss within
     1e-5 relative and d_logits within 1 bf16 ulp / 1e-6 * max of the sharded
     plain version; device times (profiler) and CUDA-event times of one
     forward + backward, its plain version, kernel #4 unsharded and the
     all-reduce alone, and the sharded call's forward and backward kernels
     apart.  Then two spawned ranks in a ``gloo`` group, both on
     cuda:0 (NCCL takes one rank a card), four rows each: the same loss on
     both ranks within 1e-6 relative of kernel #4 on all eight rows, the
     concatenated d_logits within 1 bf16 ulp / 1e-6 * max;
 15. data-parallel training: phase 6's ``Trainer`` (ResNet-50, bf16, 512^2,
     global batch 8) in a 1-rank ``nccl`` group for ``DP_STEPS`` steps, a
     quick-eval and a validation: the model runs through
     ``DistributedDataParallel`` with the summing hook, the sharded CE and
     kernel #4 launch once per step each way, the cross-replica BatchNorm
     all-reduces twice per BatchNorm per step and never in evaluation, the
     best ``.pth`` loads ``strict=True``; the median step and the device time,
     launches and NCCL time of a step against the same step in one process
     without a group (timed before the group opens and after it closes).
     Then one f32 step from seeded weights (no augmentation, dropout off,
     deterministic), with TF32 off and again on, on two spawned ``gloo``
     ranks on cuda:0, four rows each, against one process on all eight in
     the group: parameters and statistics equal on both ranks; with TF32 off
     the loss within 1e-5 relative and every BatchNorm's running statistics
     within 1e-5 (TF32's rounding of the two reductions' last-bit
     differences moves both by 1e-4 or more, printed); both ways the median
     gradient tensor no farther from the one-process step than 5 times the
     one-process step whose pooled values were moved by an ulp of what the
     convs read at one in a million (the whole step is chaotic, as in
     phase 11).
 16. the rest of the zoo at full width (OS 16, bf16, seeded weights):
     ``int8_matmul`` bit for bit against its plain version at Xception's
     shapes that phase 3 does not take (M = 512,072 and 129,032 among them),
     timed out of L2 beside its bound and cuDNN's bf16 1x1;
     ``deeplabv3plus_xception`` and ``deeplabv3plus_mobilenet`` through
     ``Predictor`` on phase 4's two scenes in ``int8_exec`` (8 and 1 routed
     sites at the shapes of ``ZOO_SHAPES``, launches = sites x chunks, scene
     logits finite and equal bit for bit to the plain int8 path) and in bf16;
     one chunk of ``deeplabv3_resnet50`` and of ``deeplabv3plus_resnet50``
     with ``separable_conv`` in bf16 and ``int8_exec`` (30 and 34 routed
     sites, one launch each, finite logits); each model's and variant's chunk
     device time and scene latency beside the card's name and power limit;
     Xception's feature maps (``extract_feature_maps``: the three labels,
     finite, in [0, 1]); phase 6's training for ``ZOO_STEPS`` steps on
     Xception and MobileNetV2 (#4 once per step each way, #6 once per
     validation batch of the quick-eval, finite losses, a quick-eval equal to
     the plain confusion matrix's metrics, the median train step); a seeded
     torchvision-layout ``resnet50.pth`` in ``ISWM_PRETRAINED_DIR``: with
     ``pretrained_backbone`` the Trainer's backbone on the card equals the
     file's and its head is the seeded one.
     The kernel record's launches of #1, #4 and #6 add this phase's.
 17. ``int8_exec_xla`` (work the JAX package leaves to XLA; the kernels of
     ``csrc/int8_conv.cu``): ``quantize_s8`` over every bf16 value, in bf16
     and f32, contiguous and as a channel slice of wider rows, at four
     scales; ``conv_s8_igemm`` at each of the 19 dense shapes of a ResNet-50
     chunk (the 3x3s, the 64-input and strided 1x1s, the ASPP branches at
     d = 6 / 12 / 18, both parts of the decoder's concat conv, N = 48 and
     N = 2 with its bias), the stem (K = 147) and M = 8; ``conv_s8_direct`` at
     MobileNetV2's nine depthwise shapes: each bit for bit (``torch.equal``)
     against its plain version, timed with the inputs out of L2 beside its
     bound (only the taps inside the input count as work), the plain version,
     cuDNN's bf16 conv (another function) and, where it takes the shape,
     ``torch._int_mm`` over the unfolded codes; the sums over a chunk.  Then
     ``Predictor`` with ``int8_exec_xla`` on phase 4's two scenes for
     ResNet-50, ResNet-50 with ``int8_stem`` and MobileNetV2 with
     ``int8_grouped``: routed sites (62, 63, 51), launches counted from 0 (per
     chunk 30 of #1 and 33 quantizes and dense convs, 34 with the stem),
     the routed dense shapes equal to the table, scene logits equal
     (``torch.equal``, deterministic cuDNN) to the same Predictor's with
     every routed module on the plain versions, the mask agreement with bf16;
     a chunk's host time, device time, int8 kernels' share and idle share for
     bf16, int8_exec and int8_exec_xla, and their scene latencies; and
     ``compare_variants`` with the six variants (33 dense convs an image);
 18. quantization-aware training (``int8_training=256``, the gate route) of
     DeepLabV3+/ResNet-50, OS 16, batch 8 at 512^2, bf16: the device-scale
     entries of the quantize and the dense conv (the amax a device tensor)
     bit-equal (``torch.equal``) to the host-scale entries fed the scale they
     form and to the plain versions, on the real inputs of every routed site
     of a train and an eval forward (49 and 45 sites) and at a zero amax; a
     train step's 49 + 49 and an eval forward's 45 + 45 launches, all of the
     device-scale entries; one QAT forward and backward under
     ``torch.cuda.set_sync_debug_mode("error")``; their device time a step
     with the inputs out of L2 against their bound; 4-step fits with a
     quick-eval and a validation in dynamic mode, delayed mode and dynamic
     mode switching to bf16 at step 2 (no device-scale launch after it),
     finite losses; the QAT step's and the bf16 step's host and device ms;
     ``int8_exec_xla`` serving of a scene from the delayed run's checkpoint,
     its learned amaxes merged over the calibration.  The forward's amaxes
     come from the reducing quantize (``quantize_s8_reduce``): its dynamic,
     amax and delayed modes bit-equal to ``activation_amax`` +
     ``quantize_s8_plain`` at every site, timed per shape;
 19. QAT's int8 backward (``int8_training_bwd``): at the real tensors of
     every routed site of one step, the reducing quantize (the 49
     activations and the 49 cotangents), the data gradient's weight codes,
     ``conv_s8_dgrad`` (the three strided sites split by output parity) and
     ``conv_s8_wgrad`` bit-equal to their plain versions, also at a zero
     cotangent at a strided site and the pooled part, the quantize also
     across the ranks of a 1-rank nccl group (the amax mode, the all-reduce,
     the codes); both gradients per shape, every entry's device time over the
     step with the inputs out of L2 beside its bound, the plain version and
     cuDNN's bf16 half; 4-step fits in dynamic and delayed mode with every
     launch counted a step (no amax pass outside the quantize, no zero
     insertion); the step's host and device ms, launches and peak memory
     against the forward-only QAT and the bf16 step;
 20. activation rematerialization (``parallel.remat``, one recomputed
     segment a block) and bf16 parameters (``param_dtype``) on phase 6's
     configuration: a remat ``Trainer`` fit for ``REMAT_STEPS`` steps, a
     quick-eval and a validation (#4 once a step each way, #6 per validation
     batch, finite losses, the best ``.pth`` loads ``strict=True``); from one
     state, one batch and one dropout draw with deterministic algorithms, the
     plain step twice and the remat step: bit-equal loss and parameters, or
     where they are not, the remat step's parameters no farther from the
     plain step (worst and median tensor) than twice the plain step's own
     run-to-run spread; the running statistics updated once, bit-equal to the
     plain step's; each step's host ms, device ms and launches (profiler) and
     peak memory (``max_memory_allocated``), the remat step's peak at least
     25% below the plain step's; a remat step with ``fused_stem`` /
     ``fused_blocks="always"`` (#9, #10, #7a, #8a twice, the backward kernels
     once) and one with QAT (``int8_training=256``, delayed, int8 backward:
     the forward's quantize and dense conv twice), each kernel's recomputed
     outputs compared with the first forward's and the bitwise share printed;
     a ``param_dtype="bfloat16"`` fit (parameters and momentum bf16,
     statistics float32, finite losses), its step against this phase's
     float32-parameter step, and a ``Predictor`` with bf16 parameters from its
     checkpoint on one chunk.  The kernel record's launches add this phase's.
 21. the spatial model axis: two spawned ``gloo`` ranks on cuda:0 as one
     model group (data 1 x model 2), each on 256 of the 512 rows of all 8
     images, halos exchanged over the group (``parallel/spatial.py``): phase
     15's f32 step from its seeded state with TF32 off and on, held to phase
     15's limits of the one-process step (``_hold_two_rank_step``); a bf16
     step (dropout off) whose loss lies within 2e-2 relative of one process's,
     25 halo all-gathers, 24 halo all-reduces and 2 group sums a step, kernel
     #4 through the sharded CE once a step each way on each rank; each rank's
     peak memory, device time, launches and collective bytes a step beside
     the one-process step's, alone and in a 1-rank group (the ranks'
     cross-replica BatchNorm and DDP), with the card's name and power limit.  Then
     ``int8_exec_xla`` through the scene-parallel ``TileEngine(mesh=)`` on
     the two ranks (batch 4 each) on the 1024x1536 scene against the one-rank
     engine (batch 8) on the same calibration: mask agreement >= 0.999, the
     logit gap printed; then ``dryrun_multichip(4)`` as four ``gloo`` ranks
     on cuda:0 (data 2 x model 2).  The kernel record's launches add this
     phase's (both ranks').
 22. the fused stem and blocks in a process group (their BatchNorm sums
     all-reduced, ``parallel.distributed.group_batch_sums``): phase 15's bf16 Trainer step
     in a 1-rank ``nccl`` group with ``fused_stem`` / ``fused_blocks`` =
     "always": each of the eight fused entries (#9, #10, #11a, #11b once a
     step, #7a / #7b 26 and #8a / #8b 12 times each way) and 2 all-reduces a
     BatchNorm a step, a finite loss; its device time, launches, host ms,
     all-reduces and peak memory beside phase 15's unfused group step, with
     the card's name and power limit; then phase 15's f32 step from seeded
     weights with the fused stem and blocks on two ``gloo`` ranks on cuda:0
     (four rows each, TF32 off and on, every fused entry launched on each
     rank) held to phase 15's limits (``_hold_two_rank_step``) of the
     one-process fused step in the 1-rank group.  The kernel record's
     launches add this phase's (the group's and both ranks');
 23. the serving fns of ``bf16``, ``int8_exec`` (#1 inside),
     ``int8_exec_xla`` (the int8 convs) and a bf16 fn with ``fused_stem =
     "always"`` (#10 inside), after the host µs a call of each serving
     wrapper on small inputs through its ``iswm`` operator and directly, as
     CUDA-graph engines (``infer/engine.py``
     ``build_engine``) for a chunk of 8 x 512^2 tiles of phase 4's first
     scene: each replay bit-equal (``torch.equal``, deterministic cuDNN) to
     the eager fn on two chunks, the host ms of a chunk eager (through the
     ``iswm`` operators, and with each wrapper calling its CUDA
     implementation directly, as before they were operators) and replayed,
     the graph pool's MiB; then each through ``serialize`` (``torch.export``
     on the card) and ``deserialize``: the trace launches no kernel, the
     artifact gives the eager fn's logits bit for bit on both chunks and
     launches the kernels the eager fn launches a chunk (30 x #1 in
     ``int8_exec``, 1 x #10 in the fused-stem fn), its MiB and trace
     seconds.  The kernel record's launches add this phase's eager calls,
     captures and artifact calls.
Each kernel's record carries its bound: the larger of the bytes it must move
over 3.35 TB/s and its operations over the card's peak rate for their type
(1,979 TOP/s int8 and 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
float32 outside them), NVIDIA's data-sheet rates for an H100 SXM.  The stem's
weight gradient contracts bf16 operands, so its bound takes the bf16
tensor-core rate although the kernel uses float32 FMAs; its record says so
and gives the time of its operations at the FMA rate beside the bound.  The
line before the last is the kernel record; the last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA card it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

SEED = 0
SCENES = ((1024, 1536), (1100, 1300))
TRAIN_STEPS = 12
QUICK_EVAL_INTERVAL = 4  # quick-evals at steps 4 and 8, the validation at 12
VAL_SCENES = 8
EVAL_SCENES = 8
EVAL_VARIANTS = ("f32", "bf16", "int8", "int8_act", "int8_exec")
STEM_STEPS = 4  # with a quick-eval at step 2 and the validation at 4
STEM_SLICE = (8, 256)  # batch and conv-output side of the stem at crop 512
# NVIDIA's data sheet for the H100 SXM, dense rates
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12  # tensor cores
TF32_OPS_PER_S = 495e12  # tensor cores, from float32 operands
F32_OPS_PER_S = 67e12  # outside the tensor cores
TRAIN_OUT = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
# (M, K, N) of every int8 site of one chunk (8 tiles of 512^2, OS 16), and
# how many of the 30 routed sites run at it
SLICE_SHAPES = {
    (131072, 256, 128): 1,   # layer2.0.conv1
    (32768, 128, 512): 4,    # layer2.*.conv3
    (32768, 512, 128): 3,    # layer2.{1,2,3}.conv1
    (32768, 512, 256): 1,    # layer3.0.conv1
    (8192, 256, 1024): 6,    # layer3.*.conv3
    (8192, 1024, 256): 5,    # layer3.{1..5}.conv1
    (8192, 1024, 512): 1,    # layer4.0.conv1
    (8192, 512, 2048): 3,    # layer4.*.conv3
    (8192, 1024, 2048): 1,   # layer4.0.downsample.0
    (8192, 2048, 512): 2,    # layer4.{1,2}.conv1
    (8192, 2048, 256): 1,    # aspp.convs.0
    (8, 2048, 256): 1,       # aspp.convs.4 (pool)
    (8192, 1280, 256): 1,    # aspp.project
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


# the launch counters of the fused stem's four entries (#9, #10, #11a, #11b)
# and of the fused blocks' four (#7a, #8a, #7b, #8b)
STEM_COUNTERS = ("launches_stats", "launches_pool", "launches_bwd_sums", "launches_bwd_wgrad")
BLOCK_COUNTERS = ("launches_mm_fwd", "launches_c3_fwd", "launches_mm_bwd", "launches_c3_bwd")


def read_counters(module, names) -> tuple:
    return tuple(getattr(module, n) for n in names)


def zero_counters(module, names) -> None:
    for n in names:
        setattr(module, n, 0)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() on the card, by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class NoDeviceRecords(RuntimeError):
    pass


# Each traced call ends with a marker kernel, and one more leads the trace.
# A trace on the H100 often lacks records at its start (most often only the
# first; up to a few calls' worth after the training phases), so launches are
# counted only between the first and the last marker recorded, over the calls
# those markers close.
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
TRACES = {"whole": 0, "retaken": 0, "estimated": 0, "takes": 0, "short": 0}


def _count_between_markers(prof, reps: int) -> tuple:
    """(calls closed, {kernel: (mean device us, records between the first
    and the last marker)}) of one trace: every record of a kernel counts
    toward its mean, only those between the markers toward its launches."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events()
              if e.device_type == cuda and e.self_device_time_total > 0]
    marks = sorted(e.time_range.start for e in events if MARKER in e.name)
    TRACES["short"] += len(marks) < reps + 1
    if len(marks) < 2:
        return 0, {}
    total, count = {}, {}
    for e in events:
        if MARKER in e.name:
            continue
        total[e.name] = total.get(e.name, 0.0) + e.self_device_time_total
        count.setdefault(e.name, [0, 0])[0] += 1
        count[e.name][1] += marks[0] < e.time_range.start < marks[-1]
    return len(marks) - 1, {k: (total[k] / n, between) for k, (n, between) in count.items()}


def traced_records(fn, reps: int, warmup: int, exclude=frozenset()) -> dict:
    """{kernel name: (its mean device time in us, its launches in one fn())}
    from a ``torch.profiler`` trace of ``reps`` calls, counted between
    markers (:func:`_count_between_markers`).  A trace is whole when every
    kernel has a whole number of records a call closed; one that is not, or
    that holds no record outside ``exclude``, is taken again, five times at
    most.  Where none of the five is whole, the one that closed the most
    calls stands in, each kernel counted at its records over those calls (at
    least one launch), and a line on stderr says so."""
    for _ in range(warmup):
        fn()
    best = None
    for take in range(5):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1)
            for _ in range(reps):
                fn()
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        TRACES["takes"] += 1
        calls, records = _count_between_markers(prof, reps)
        if not any(k not in exclude for k in records):
            continue
        if calls and all(c % calls == 0 for _, c in records.values()):
            TRACES["retaken" if take else "whole"] += 1
            return {k: (us, c // calls) for k, (us, c) in records.items()}
        if calls and (best is None or calls > best[0]):
            best = (calls, records)
    if best is None:
        raise NoDeviceRecords(f"five traces of {reps} calls hold no device record"
                              + (f" outside {sorted(exclude)}" if exclude else ""))
    calls, records = best
    TRACES["estimated"] += 1
    odd = {k[:60]: c for k, (_, c) in records.items() if c % calls}
    print(f"[profiler] no whole trace of {reps} calls in five: the best closed {calls} calls, "
          f"records between its markers not whole a call: {odd}; launches a call estimated "
          "as records / calls", file=sys.stderr)
    return {k: (us, max(1, round(c / calls))) for k, (us, c) in records.items()}


def traced_kernels(fn, reps: int, warmup: int) -> dict:
    """{kernel name: its device time in one fn(), ms}: the mean of its records
    times its launches in a call (:func:`traced_records`)."""
    return {k: us * n / 1e3 for k, (us, n) in traced_records(fn, reps, warmup).items()}


def traced_ms(fn, reps: int, warmup: int) -> float:
    """Device time of one fn(): the sum of :func:`traced_kernels`."""
    return sum(traced_kernels(fn, reps, warmup).values())


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of fn() on the card: the kernels' own durations in a
    profiler trace, without the host's launch overhead (which bounds the
    CUDA-event time of a kernel this short).  Where the profiler records
    nothing, the CUDA-event time stands in and a line on stderr says so."""
    try:
        return traced_ms(fn, reps, warmup)
    except NoDeviceRecords as e:
        print(f"[profiler] {e}: CUDA-event time, launch overhead included, stands in",
              file=sys.stderr)
        return cuda_ms(fn, reps, warmup=0)


def least_time(nbytes: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at their
    peak rate, whichever is larger."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def matmul_bound(m: int, k: int, n: int, x_bytes: int) -> dict:
    """x [M, K] + w [K, N] int8 + w_scale [N] f32 in, out [M, N] f32;
    2 M K N int8 operations."""
    return least_time(m * k * x_bytes + k * n + 4 * n + 4 * m * n, 2 * m * k * n,
                 INT8_OPS_PER_S)


def sum_bounds(parts) -> dict:
    """Bounds of calls made one after another: the times add; the sum is
    bound by whatever bounds most of it."""
    total = sum(p["bound_ms"] for p in parts)
    by_bytes = sum(p["bound_ms"] for p in parts if p["bound_by"] == "bytes")
    return {"bound_ms": total,
            "bound_by": "bytes" if by_bytes >= total - by_bytes else "operations"}


def cold_device_ms(fn, reps: int = 20) -> float:
    """:func:`device_ms` of fn() with its inputs out of the 50 MB L2 cache:
    a 256 MB buffer is rewritten before every call, and the time of that
    rewrite alone is taken off."""
    return ColdTimer(reps)(fn)


class ColdTimer:
    """:func:`cold_device_ms` for many functions: one 256 MB flush buffer.
    The rewrite's own kernel is found once by name in a trace of the rewrite
    alone and left out of every function's sum, so no baseline is subtracted
    (a baseline taken at another moment was off by 0.06 ms a call)."""

    def __init__(self, reps: int = 20):
        self.reps = reps
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        try:
            self.flush_kernels = set(traced_records(self.flush.zero_, reps, 3))
        except NoDeviceRecords as e:
            print(f"[profiler] {e}: CUDA-event times, launch overhead included, stand in",
                  file=sys.stderr)
            self.flush_kernels = None
            self.flush_ms = cuda_ms(self.flush.zero_, reps)

    def kernels(self, fn, reps: int | None = None) -> dict:
        """{kernel name: its device ms in one fn()} with fn's inputs out of
        L2 (the flush's own kernel left out); where the profiler records
        nothing, {"all (CUDA events)": the CUDA-event time less the flush's}."""
        def flushed():
            self.flush.zero_()
            return fn()

        reps = reps or self.reps
        if self.flush_kernels is not None:
            try:
                # a trace can hold the rewrite's records and none of fn's:
                # it is taken again, as an empty one is
                records = traced_records(flushed, reps, 3, exclude=self.flush_kernels)
                return {k: us * n / 1e3 for k, (us, n) in records.items()
                        if k not in self.flush_kernels}
            except NoDeviceRecords as e:
                print(f"[profiler] {e}: CUDA-event times stand in", file=sys.stderr)
                self.flush_ms = cuda_ms(self.flush.zero_, reps)
        return {"all (CUDA events)": cuda_ms(flushed, reps) - self.flush_ms}

    def __call__(self, fn, reps: int | None = None) -> float:
        return sum(self.kernels(fn, reps).values())


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> None:
    line = _smi()
    print(line)
    print(f"[1] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {line}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")


def phase_build(modules) -> None:
    """Build every kernel library at once, one nvcc per source."""
    def build(module):
        t0 = time.perf_counter()
        _, log = module.load_library()
        return time.perf_counter() - t0, log

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        results = list(pool.map(build, modules.values()))
    for name, (secs, log) in zip(modules, results):
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[2] build {name}.cu: {secs:.2f} s; ptxas: {' | '.join(ptxas)}")
    print(f"[2] all builds: {time.perf_counter() - t0:.2f} s")


def _case(m, k, n, kind, gen):
    dev = "cuda"
    if kind == "ties":  # x / x_scale = integer + 0.5 exactly, representable in bf16
        ints = torch.randint(-64, 64, (m, k), generator=gen, device=dev)
        x, x_scale = ((ints.float() + 0.5) * 0.25).to(torch.bfloat16), 0.25
    else:
        x = torch.randn((m, k), generator=gen, device=dev)
        x = x.to(torch.float32 if kind == "f32" else torch.bfloat16)
        x_scale = float(x.float().abs().max()) / 127.0
        if kind == "saturate":
            x_scale /= 4.0  # |x / x_scale| up to ~4 x 127: clipped codes
    w_q = torch.randint(-127, 128, (k, n), generator=gen, device=dev).to(torch.int8)
    w_scale = torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-4
    # [K, N] over [N, K] memory, as a serving site holds its weights: the
    # wrapper's w^T is then a view, not a copy inside the timed call
    return x, w_q.t().contiguous().t(), w_scale, x_scale


def _int_mm(x_q, w_q):
    """A call of ``torch._int_mm`` on the codes (the int32 product alone:
    another function, a yardstick never on the path), with w [K, N] row- or
    column-major as it takes it; None where it refuses the shape."""
    for w in (w_q.contiguous(), w_q.t().contiguous().t()):
        try:
            torch._int_mm(x_q, w)
        except RuntimeError:
            continue
        return lambda: torch._int_mm(x_q, w)
    return None


def phase_kernel(k8) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(s, "bf16") for s in SLICE_SHAPES] + [
        ((1000, 256, 128), "ragged"), ((8192, 1024, 256), "saturate"),
        ((8192, 512, 256), "ties"), ((4000, 512, 256), "f32"),
        # further branches of the plan: K splits at M = 8 and M = 200 (a
        # multiple of no BM), M = 1000 at more N, N groups at a ragged M, f32
        # x at both K splits
        ((8, 512, 1024), "bf16"), ((200, 2048, 512), "ragged"), ((1000, 1024, 512), "ragged"),
        ((4001, 256, 1024), "ragged"), ((8, 2048, 256), "f32"), ((200, 2048, 512), "f32"),
    ]
    cold = ColdTimer(reps=10)
    max_err, bounds = 0.0, []
    total = dict.fromkeys(("ms", "event_ms", "plain_ms", "conv_ms", "conv_cold_ms", "int_mm_ms",
                           "glue_ms"), 0.0)
    for (m, k, n), kind in cases:
        x, w_q, w_scale, x_scale = _case(m, k, n, kind, gen)
        got = k8.int8_matmul(x, w_q, w_scale, x_scale)
        want = k8.int8_matmul_plain(x, w_q, w_scale, x_scale)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"kernel != plain at {(m, k, n)} {kind}: max abs err {err}")
        max_err = max(max_err, err)
        plan = k8.plan(m, k, n, x.element_size())
        check(plan["smem"] <= 227 * 1024, f"plan {plan} over 227 KB of shared memory")
        t = {"event_ms": cuda_ms(lambda: k8.int8_matmul(x, w_q, w_scale, x_scale)),
             "ms": cold(lambda: k8.int8_matmul(x, w_q, w_scale, x_scale)),
             "plain_ms": cuda_ms(lambda: k8.int8_matmul_plain(x, w_q, w_scale, x_scale), reps=5)}
        # the same 1x1 conv in bf16 through cuDNN, channels last [1, K, M, 1]
        xc = x.to(torch.bfloat16).reshape(1, m, 1, k).permute(0, 3, 1, 2)
        wc = w_q.t().to(torch.bfloat16).reshape(n, k, 1, 1).contiguous(
            memory_format=torch.channels_last)
        t["conv_ms"] = cuda_ms(lambda: torch.nn.functional.conv2d(xc, wc))
        t["conv_cold_ms"] = cold(lambda: torch.nn.functional.conv2d(xc, wc))
        # the int32 product alone on the codes, and the serving site's cast of
        # the float32 result back to x's type (Int8Conv1x1's .to(x.dtype))
        x_q = torch.clamp(torch.round(x.float() / x_scale), -127, 127).to(torch.int8)
        int_mm = _int_mm(x_q, w_q)
        t["int_mm_ms"] = cold(int_mm) if int_mm else float("nan")
        t["glue_ms"] = cold(lambda: got.to(torch.bfloat16))
        count = SLICE_SHAPES.get((m, k, n), 0) if kind == "bf16" else 0
        for key in total:
            total[key] += count * (t[key] if key != "int_mm_ms" or int_mm else 0.0)
        least = matmul_bound(m, k, n, x.element_size())
        bounds += [least] * count
        plan_s = " ".join(f"{key}={plan[key]}" for key in k8.PLAN_KEYS)
        print(f"[3] int8_matmul M={m} K={k} N={n} x={kind}: bit-exact (tolerance 0, torch.equal); "
              f"plan {plan_s}; kernel {t['ms']:.4f} ms with the inputs out of L2 "
              f"({2 * m * k * n / t['ms'] / 1e9:.1f} TOP/s, {least['bound_ms'] / t['ms']:.1%} of "
              f"the bound {least['bound_ms']:.4f} ms by {least['bound_by']}), "
              f"{t['event_ms']:.4f} ms by CUDA events; plain {t['plain_ms']:.4f} ms; bf16 conv2d "
              f"{t['conv_cold_ms']:.4f} ms out of L2 ({t['conv_ms']:.4f} by events); "
              + (f"torch._int_mm (another function: the int32 product alone) {t['int_mm_ms']:.4f} "
                 f"ms out of L2" if int_mm else "torch._int_mm refuses the shape")
              + f"; the f32 -> bf16 cast of the result {t['glue_ms']:.4f} ms")
    least = sum_bounds(bounds)
    print(f"[3] one chunk's 30 int8 sites: kernel {total['ms']:.4f} ms with the inputs out of L2 "
          f"({least['bound_ms'] / total['ms']:.1%} of the bound), {total['event_ms']:.4f} ms by "
          f"CUDA events; plain {total['plain_ms']:.4f} ms; bf16 conv2d (cuDNN, another function: "
          f"no quantization) {total['conv_cold_ms']:.4f} ms out of L2, {total['conv_ms']:.4f} ms "
          f"by events; torch._int_mm at the sites it takes {total['int_mm_ms']:.4f} ms; the "
          f"sites' f32 -> bf16 casts {total['glue_ms']:.4f} ms; bound {least['bound_ms']:.4f} ms "
          f"by {least['bound_by']}")
    # no single PyTorch call quantizes, multiplies in int8 and rescales
    return {"max_abs_err": max_err, "ms": total["ms"], "event_ms": total["event_ms"],
            "plain_ms": total["plain_ms"], **least, "library_ms": None,
            "int_mm_ms": total["int_mm_ms"]}


def _chunk_profile(name: str, fn, phase: int = 4) -> None:
    """One serving chunk: its time on the host's clock (synchronized, median
    of 10) and, from a profiler trace, its device time, that of the int8
    kernel (and its finishing pass) and of the rest, and the device's idle
    share of the chunk."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = float(np.median(times)) * 1e3
    kernels = traced_kernels(fn, reps=5, warmup=1)
    busy = sum(kernels.values())
    int8 = sum(v for k, v in kernels.items() if "int8_strip_kernel" in k or "finish_split" in k)
    print(f"[{phase}] {name} chunk of 8 x 512^2: {wall:.3f} ms on the host's clock (median of "
          f"10), {8 / wall * 1e3:.1f} tiles/s; device time {busy:.3f} ms (profiler): int8_matmul "
          f"{int8:.3f} ms, the rest {busy - int8:.3f} ms; device idle share "
          f"{max(0.0, 1 - busy / wall):.3f}")


def phase_slice(k8) -> int:
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import val_transform_batch
    from iswm_tpu_torch.infer import Predictor, tile_origins
    from iswm_tpu_torch.infer.quantization import Int8Conv1x1, logit_diff_verdict
    from iswm_tpu_torch.ops.kernels.int8_matmul import quantized_conv1x1_plain

    rng = np.random.default_rng(SEED)
    scenes = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SCENES]

    def config(variant):
        cfg = Config()  # deeplabv3plus_resnet50, OS 16, bf16, tile 512/64/8
        cfg.predict.serving_variant = variant
        return cfg

    cfg = config("int8_exec")
    p = cfg.predict
    tiles = [len(tile_origins(h, p.tile_size, p.tile_size - p.tile_overlap))
             * len(tile_origins(w, p.tile_size, p.tile_size - p.tile_overlap))
             for h, w in SCENES]
    chunks = sum(-(-n // p.tile_batch) for n in tiles)

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    pred = Predictor(cfg, device="cuda")
    k8.launches = 0
    products = [pred.predict_image(s) for s in scenes]
    torch.cuda.synchronize()
    launches = k8.launches
    sites = sum(SLICE_SHAPES.values())
    check(len(pred.engine.model_fn.routed_sites) == sites,
          f"{len(pred.engine.model_fn.routed_sites)} routed sites, expected {sites}")
    check(launches == sites * chunks,
          f"int8_matmul launched {launches} times, expected {sites} x {chunks} chunks")
    print(f"[4] int8_exec main path: {len(scenes)} scenes, {tiles} tiles, {chunks} chunks, "
          f"{len(pred.engine.model_fn.routed_sites)} routed sites, "
          f"int8_matmul launches {launches}")

    int8_sites = [m for m in pred.engine.model_fn.model.modules()
                  if isinstance(m, Int8Conv1x1)]
    seen = set()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.add((args[0].shape[0] * args[0].shape[2] * args[0].shape[3],
                                    mod.w_q.shape[1], mod.w_q.shape[0])))
        for m in int8_sites]
    xs = [val_transform_batch(torch.from_numpy(s).cuda()) for s in scenes]
    logits = [pred.engine.infer_scene(x) for x in xs]
    for h in hooks:
        h.remove()
    check(seen == set(SLICE_SHAPES), f"routed shapes {sorted(seen)} != phase 3's")
    for (h, w), lg, prod in zip(SCENES, logits, products):
        check(tuple(lg.shape) == (h, w, 2) and bool(torch.isfinite(lg).all()),
              f"logits of the {h}x{w} scene: shape {tuple(lg.shape)} or not finite")
        check(np.array_equal(torch.softmax(lg, -1)[..., 1].cpu().numpy(), prod["prob_fg"]),
              "the rerun's logits differ from the counted run's")
        for key, shape, dtype in (("mask", (h, w), np.uint8), ("prob_fg", (h, w), np.float32),
                                  ("confidence", (h, w), np.uint8), ("rgb", (h, w, 3), np.uint8)):
            check(prod[key].shape == shape and prod[key].dtype == dtype,
                  f"product {key}: {prod[key].shape} {prod[key].dtype}")
    for m in int8_sites:
        m.conv_fn = quantized_conv1x1_plain
    plain = [pred.engine.infer_scene(x) for x in xs]
    for m in int8_sites:
        del m.conv_fn
    diff = max(float((a - b).abs().max()) for a, b in zip(logits, plain))
    check(all(torch.equal(a, b) for a, b in zip(logits, plain)),
          f"scene logits differ from the plain int8 path: max abs diff {diff}")
    print(f"[4] scene logits finite, products typed; equal to the plain int8 path "
          f"(max abs diff {diff})")
    torch.backends.cudnn.deterministic = False

    bf16 = Predictor(config("bf16"), device="cuda")
    bf16.predict_image(scenes[0])
    agree, verdict = logit_diff_verdict(
        bf16.engine.infer_scene(xs[0]).cpu().numpy(), logits[0].cpu().numpy())
    print(f"[4] int8_exec vs bf16 mask agreement {agree:.6f} ({verdict})")
    # one chunk of 8 tiles of the first scene through each serving fn
    chunk = torch.stack([xs[0][oy:oy + p.tile_size, ox:ox + p.tile_size]
                         for oy in (0, 448) for ox in (0, 384, 768, 1024)])
    for name, predictor in (("bf16", bf16), ("int8_exec", pred)):
        fn = predictor.engine.model_fn
        _chunk_profile(name, lambda: fn(chunk))
    for name, predictor in (("bf16", bf16), ("int8_exec", pred)):
        for (h, w), scene, n in zip(SCENES, scenes, tiles):
            predictor.predict_image(scene)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                predictor.predict_image(scene)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            lat = float(np.median(times))
            print(f"[4] {name} {h}x{w} ({n} tiles): scene latency {lat * 1e3:.2f} ms "
                  f"(median of 5), {n / lat:.2f} tiles/s")
    return launches


def _ce_case(shape, dtype, gen, channels_last=False, all_ignored=False,
             label_dtype=torch.int32):
    """Logits [B, 2, H, W] ~ N(0, 3^2), labels ~10% foreground, ~5% 255."""
    b, h, w = shape
    logits = (torch.randn((b, 2, h, w), generator=gen, device="cuda") * 3).to(dtype)
    if channels_last:
        logits = logits.contiguous(memory_format=torch.channels_last)
    u = torch.rand((2, b, h, w), generator=gen, device="cuda")
    labels = (u[0] < 0.10).to(label_dtype)
    labels[(u[1] < 0.05) | all_ignored] = 255
    return logits, labels


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _ce_view(logits: torch.Tensor, kind: str) -> torch.Tensor:
    """The same values as ``logits`` through another layout: ``view``, a
    slice of a larger tensor (strides that no vector body takes); ``offset``,
    dense channels-last strides 2 bytes past a 16-byte boundary."""
    b, _, h, w = logits.shape
    if kind == "view":
        big = torch.zeros((b, 3, h + 2, w + 5), dtype=logits.dtype, device=logits.device)
        big[:, 1:, 1:h + 1, 2:w + 2] = logits
        return big[:, 1:, 1:h + 1, 2:w + 2]
    flat = torch.empty(logits.numel() + 8, dtype=logits.dtype, device=logits.device)
    out = flat[1:1 + logits.numel()].view(b, h, w, 2).permute(0, 3, 1, 2)
    out.copy_(logits)
    return out


def phase_fused_ce(ce) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cw = torch.tensor([1.0, 3.2], device="cuda")
    slice_shape = (8, 512, 512)
    # (name, shape, dtype, _ce_case options, the layout the wrapper must pick)
    cases = [
        ("slice bf16 NCHW", slice_shape, torch.bfloat16, {}, "nchw"),
        ("slice bf16 channels-last", slice_shape, torch.bfloat16, {"channels_last": True},
         "channels_last"),
        ("slice f32 NCHW", slice_shape, torch.float32, {}, "nchw"),
        ("slice f32 channels-last uint8-labels", slice_shape, torch.float32,
         {"channels_last": True, "label_dtype": torch.uint8}, "channels_last"),
        ("ragged H*W 3x97x131 bf16 uint8-labels", (3, 97, 131), torch.bfloat16,
         {"label_dtype": torch.uint8}, "strided"),
        ("ragged 3x97x131 f32 channels-last int64-labels", (3, 97, 131), torch.float32,
         {"channels_last": True, "label_dtype": torch.int64}, "channels_last"),
        ("strided view 4x256x256 bf16", (4, 256, 256), torch.bfloat16, {"view": "view"},
         "strided"),
        ("misaligned offset 4x256x256 bf16 channels-last int64-labels", (4, 256, 256),
         torch.bfloat16, {"view": "offset", "label_dtype": torch.int64}, "strided"),
        ("all ignored bf16 channels-last", slice_shape, torch.bfloat16,
         {"all_ignored": True, "channels_last": True}, "channels_last"),
        ("all ignored bf16", slice_shape, torch.bfloat16, {"all_ignored": True}, "nchw"),
    ]
    fwd_err, bwd_err = 0.0, 0.0
    grad = torch.tensor(1.0, device="cuda")
    kept = None  # the channels-last slice's inputs and sums, taken again after all-ignored
    for name, shape, dtype, kw, layout in cases:
        kw = dict(kw)
        view = kw.pop("view", None)
        logits, labels = _ce_case(shape, dtype, gen, **kw)
        if view:
            logits = _ce_view(logits, view)
        before = dict(ce.launches_by_layout)
        sums = ce.fused_binary_ce_fwd(logits, labels, cw)
        again = ce.fused_binary_ce_fwd(logits, labels, cw)
        want = ce.fused_binary_ce_fwd_plain(logits, labels, cw, dtype=torch.float64)
        torch.cuda.synchronize()
        check(torch.equal(sums, again), f"fused CE forward not bit-stable ({name}): "
              f"{sums.tolist()} vs {again.tolist()}")
        err = float((sums.double() - want).abs().max())
        rel = float(((sums.double() - want).abs() / want.abs().clamp_min(1e-30)).max())
        check(rel <= 1e-5 or err == 0.0,
              f"fused CE forward ({name}): {sums.tolist()} vs float64 {want.tolist()}")
        fwd_err = max(fwd_err, err)
        w_sum = torch.clamp_min(sums[1], 1e-12)
        d = ce.fused_binary_ce_bwd(logits, labels, cw, w_sum, grad)
        d_plain = ce.fused_binary_ce_bwd_plain(logits, labels, cw, w_sum, grad)
        torch.cuda.synchronize()
        # a slice of a larger tensor has no dense layout to keep: d_logits is then contiguous
        strides = torch.empty_like(logits).stride() if view == "view" else logits.stride()
        check(d.dtype == logits.dtype and d.stride() == strides,
              f"d_logits {d.dtype} {d.stride()} vs logits {logits.dtype} {logits.stride()}")
        diff = (d.float() - d_plain.float()).abs()
        if dtype == torch.bfloat16:
            ok, tol = bool((diff <= _bf16_ulp(d_plain)).all()), "1 bf16 ulp"
        else:
            bound = 1e-6 * float(d_plain.abs().max())
            ok, tol = float(diff.max()) <= bound, "1e-6 * max|d_logits|"
        if kw.get("all_ignored"):
            ok = ok and float(sums[0]) == float(sums[1]) == 0.0 and not d.float().any()
        check(ok, f"fused CE backward ({name}): max abs diff {float(diff.max())} ({tol})")
        bwd_err = max(bwd_err, float(diff.max()))
        took = {k: v - before[k] for k, v in ce.launches_by_layout.items() if v != before[k]}
        check(took == {layout: 3}, f"fused CE ({name}): launches by layout {took}, "
              f"expected 3 through {layout}")
        print(f"[5] fused_binary_ce {name}: {layout} body; sums "
              f"{[round(v, 3) for v in sums.tolist()]}, forward max abs err {err:.3e} vs "
              f"float64 (rel 1e-5), bit-stable; backward max abs err {float(diff.max()):.3e} "
              f"({tol})")
        if name == "slice bf16 channels-last":
            kept = (logits, labels, sums)
        elif kw.get("all_ignored"):  # the last block reset the ticket
            again = ce.fused_binary_ce_fwd(*kept[:2], cw)
            torch.cuda.synchronize()
            check(torch.equal(again, kept[2]), f"fused CE forward after {name}: "
                  f"{again.tolist()} vs {kept[2].tolist()} before it")
            print(f"[5] fused_binary_ce after {name}: the channels-last slice's sums again, "
                  f"bit for bit")

    # times at the training slice's shape and layout (channels-last bf16)
    logits, labels = _ce_case(slice_shape, torch.bfloat16, gen, channels_last=True)
    sums = ce.fused_binary_ce_fwd(logits, labels, cw)
    w_sum = torch.clamp_min(sums[1], 1e-12)
    calls = {
        "fwd": lambda: ce.fused_binary_ce_fwd(logits, labels, cw),
        "fwd_plain": lambda: ce.fused_binary_ce_fwd_plain(logits, labels, cw),
        "bwd": lambda: ce.fused_binary_ce_bwd(logits, labels, cw, w_sum, grad),
        "bwd_plain": lambda: ce.fused_binary_ce_bwd_plain(logits, labels, cw, w_sum, grad),
    }
    # the one PyTorch call for the same function: the weighted sum of CE
    # (and the sum of the weights) forward, its autograd backward
    target = labels.long()
    cw_lib = cw.to(logits.dtype)
    leaf = logits.detach().requires_grad_()
    lib_loss = torch.nn.functional.cross_entropy(leaf, target, weight=cw_lib, ignore_index=255)

    def library_fwd():
        ce_sum = torch.nn.functional.cross_entropy(
            logits, target, weight=cw_lib, ignore_index=255, reduction="sum")
        return ce_sum, cw[1] * (target == 1).sum() + cw[0] * (target == 0).sum()

    calls["fwd_library"] = library_fwd
    calls["bwd_library"] = lambda: torch.autograd.grad(lib_loss, leaf, retain_graph=True)
    lib_sums = torch.stack([v.double() for v in library_fwd()])
    rel = float(((lib_sums - sums.double()).abs() / sums.double().abs()).max())
    check(bool(torch.isfinite(lib_sums).all()), f"F.cross_entropy's sums {lib_sums.tolist()}")
    print(f"[5] F.cross_entropy(weight, ignore_index, 'sum') + weight sum, the library's call "
          f"for the forward: within {rel:.2e} relative of the kernel's sums (bf16 math)")
    before = dict(ce.launches_by_layout)
    dev = {k: device_ms(f) for k, f in calls.items()}
    host = {k: cuda_ms(f) for k, f in calls.items() if not k.endswith("library")}
    pixels = labels.numel()
    moved = {"fwd": logits.numel() * logits.element_size() + labels.numel() * labels.element_size()}
    moved["bwd"] = moved["fwd"] + logits.numel() * logits.element_size()
    # about a dozen float32 operations a pixel each way (max, exp, log1p,
    # sigmoid, selects, products): under the bytes
    least = {d: least_time(moved[d], 12 * pixels, F32_OPS_PER_S) for d in moved}
    cold = {d: cold_device_ms(calls[d]) for d in ("fwd", "bwd")}
    took = {k: v - before[k] for k, v in ce.launches_by_layout.items() if v != before[k]}
    check(set(took) == {"channels_last"}, f"the timed fused CE calls went through {took}")
    print(f"[5] the timed calls' launches by layout: {took}")
    for d in ("fwd", "bwd"):
        print(f"[5] fused_binary_ce {d} at [8, 2, 512, 512] bf16 channels-last, int32 labels: "
              f"device time kernel {cold[d]:.4f} ms with the inputs out of L2 "
              f"({100 * least[d]['bound_ms'] / cold[d]:.1f}% of the bound), {dev[d]:.4f} ms "
              f"from L2 ({100 * least[d]['bound_ms'] / dev[d]:.1f}%, "
              f"{moved[d] / dev[d] / 1e6:.0f} GB/s), plain {dev[d + '_plain']:.4f} ms, "
              f"F.cross_entropy {dev[d + '_library']:.4f} ms, bound "
              f"{least[d]['bound_ms']:.4f} ms by {least[d]['bound_by']} ({moved[d]} bytes); "
              f"CUDA events per call with the host's launch overhead: kernel "
              f"{host[d]:.4f} ms, plain {host[d + '_plain']:.4f} ms")
    return {d: {"max_abs_err": err, "ms": dev[d], "cold_ms": cold[d],
                "plain_ms": dev[d + "_plain"], **least[d], "library_ms": dev[d + "_library"]}
            for d, err in (("fwd", fwd_err), ("bwd", bwd_err))}


def phase_train(ce, cm) -> tuple:
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import ArrayDataset, augment_batch, batch_iterator, generate_scene
    from iswm_tpu_torch.models import build_model
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import Trainer, TrainState, make_optimizer, make_train_step

    rng = np.random.default_rng(SEED)

    def scenes(n):
        images, masks = zip(*(generate_scene(rng, size=(640, 640)) for _ in range(n)))
        return ArrayDataset(np.stack(images), np.stack(masks))

    train_ds, val_ds = scenes(32), scenes(VAL_SCENES)
    cfg = Config()  # deeplabv3plus_resnet50, OS 16, bf16, ce_loss, fused auto, SGD cosine
    cfg.data.crop_size, cfg.data.batch_size = 512, 8
    cfg.train.total_itrs = cfg.train.val_interval = TRAIN_STEPS
    cfg.train.quick_eval_interval = QUICK_EVAL_INTERVAL
    cfg.train.print_interval = 4
    cfg.train.save_val_results = False  # the PNG dump needs PIL
    shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    for name in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
        setattr(cfg.train, name, str(TRAIN_OUT / name))
    trainer = Trainer(cfg, device="cuda", train_ds=train_ds, val_ds=val_ds)

    ce.launches_fwd = ce.launches_bwd = cm.launches = 0
    ce.launches_by_layout = dict.fromkeys(ce.LAYOUTS, 0)
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = (ce.launches_fwd, ce.launches_bwd, cm.launches)
    by_layout = dict(ce.launches_by_layout)
    check(launches[:2] == (TRAIN_STEPS, TRAIN_STEPS),
          f"fused CE launches (fwd, bwd) {launches[:2]}, expected {TRAIN_STEPS} each")
    check(by_layout == {**dict.fromkeys(ce.LAYOUTS, 0), "channels_last": 2 * TRAIN_STEPS},
          f"fused CE launches by layout {by_layout}: every step's forward and backward "
          f"must take the channels_last body")
    losses = trainer.logger.history["train_loss"]
    check(len(losses) == TRAIN_STEPS // cfg.train.print_interval
          and all(np.isfinite(losses)), f"logged losses {losses}")
    check(trainer.state.step == TRAIN_STEPS, f"step {trainer.state.step}")
    check(trainer.best_path is not None, "no best checkpoint was written")
    payload = torch.load(trainer.best_path, map_location="cpu", weights_only=True)
    fresh = build_model(cfg.model)
    fresh.load_state_dict(payload["model_state"], strict=True)
    trained = trainer.state.model.state_dict()
    check(payload["cur_itrs"] == TRAIN_STEPS
          and all(torch.equal(v, trained[k].cpu()) for k, v in fresh.state_dict().items()),
          "the checkpoint does not hold the trained model")
    print(f"[6] training main path: {TRAIN_STEPS} steps + "
          f"{TRAIN_STEPS // QUICK_EVAL_INTERVAL - 1} quick-evals + 1 validation + best "
          f"checkpoint in {fit_s:.2f} s; fused CE launches fwd {launches[0]}, bwd {launches[1]}, "
          f"by layout {by_layout}; "
          f"losses {[round(v, 4) for v in losses]}; weighted score "
          f"{trainer.best_weighted:.4f}; {Path(trainer.best_path).name} loads strict=True")

    # one step through the kernel and one through the autograd loss, from one
    # state, on one augmented batch, with one dropout mask and deterministic
    # algorithms (cuDNN and the atomics-based backward ops), in bf16 as
    # trained and in f32.  A fresh SGD's update is -lr (1 + m) (g + wd p), so
    # the gradients are compared: (new - old) in f32 is quantized at ulp(p),
    # 2% of a step-12 update of BatchNorm scales near 1.
    images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
    x, y = augment_batch(torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda(),
                         trainer.augment, torch.Generator(device="cuda").manual_seed(SEED))
    model = trainer.state.model
    start, trained_dtype = copy.deepcopy(model.state_dict()), model.compute_dtype
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    factory, _ = make_optimizer(cfg.optim, cfg.train.total_itrs)
    # f32 holds every tensor to 1e-2.  In bf16 the two paths' d_logits differ
    # by one ulp at a few pixels, which draws another realisation of the
    # backward's rounding noise: the worst of 188 tensors is heavy-tailed
    # (2.8e-2 to 1.05e-1 over eight runs), so bf16 holds the median tensor to
    # 5e-2 and the worst to 2.5e-1.
    for dtype, grad_tol, worst_tol in ((torch.bfloat16, 5e-2, 2.5e-1),
                                       (torch.float32, 1e-2, 1e-2)):
        model.compute_dtype = dtype
        steps = {}
        for fused in ("auto", "never"):
            model.load_state_dict(start)
            state = TrainState(model, *factory(model.parameters()), 0)
            step = make_train_step(make_loss_fn(cfg.loss.loss_type, fused=fused, device="cuda"))
            torch.cuda.manual_seed(SEED)
            with warnings.catch_warnings():  # ops without a deterministic version
                warnings.simplefilter("ignore")
                loss = float(step(state, x, y))
            steps[fused] = (loss, {k: p.grad.float().clone() for k, p in model.named_parameters()})
        (loss_k, g_k), (loss_p, g_p) = steps["auto"], steps["never"]
        rel = abs(loss_k - loss_p) / abs(loss_p)
        ratios = sorted(
            (float((g_k[k] - g_p[k]).abs().max() / g_p[k].abs().max().clamp_min(1e-30)), k)
            for k in g_p)
        (worst, name), median = ratios[-1], ratios[len(ratios) // 2][0]
        check(rel <= 1e-5, f"{dtype}: kernel step loss {loss_k} vs plain step {loss_p}")
        check(worst <= worst_tol and median <= grad_tol,
              f"{dtype}: gradients of {name} differ by {worst:.2e} * max|grad| (limit "
              f"{worst_tol}), the median tensor's by {median:.2e} (limit {grad_tol})")
        print(f"[6] one step through the kernel vs fused='never', {dtype}: loss {loss_k:.6f} "
              f"vs {loss_p:.6f} (rel {rel:.2e}, limit 1e-5); worst parameter gradient "
              f"{worst:.2e} * max|grad| at {name} (limit {worst_tol}), median {median:.2e} "
              f"(limit {grad_tol}) over {len(g_p)} tensors")
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    model.compute_dtype = trained_dtype
    model.load_state_dict(start)

    xu8, yu8 = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    times = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, xu8, yu8)
        torch.cuda.synchronize()
        if i >= 3:  # after warm-up
            times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    print(f"[6] train step (augment + forward + fused CE + backward + SGD), batch 8 at "
          f"512^2: median {step_s * 1e3:.2f} ms of {len(times)} "
          f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}); "
          f"{cfg.data.batch_size / step_s:.2f} train tiles/s")
    return launches, trainer


def _cm_case(shape, gen, gt_dtype=torch.int64, pred_dtype=torch.int64, all_ignored=False):
    """Labels ~10% foreground and ~5% 255, predictions ~12% foreground."""
    u = torch.rand((3, *shape), generator=gen, device="cuda")
    gts = (u[0] < 0.10).to(gt_dtype)
    gts[(u[1] < 0.05) | all_ignored] = 255
    return gts, (u[2] < 0.12).to(pred_dtype)


def phase_eval_kernels(k8, cm) -> tuple:
    from iswm_tpu_torch.metrics.device import confusion_matrix

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    quick_shape = (8, 512, 512)
    cases = [
        ("quick-eval int64/int64", quick_shape, {}),
        ("quick-eval int32 labels / int32 preds", quick_shape,
         {"gt_dtype": torch.int32, "pred_dtype": torch.int32}),
        ("quick-eval uint8 labels / int64 preds", quick_shape, {"gt_dtype": torch.uint8}),
        ("ragged 3x77x91 int64 / uint8", (3, 77, 91), {"pred_dtype": torch.uint8}),
        ("one pixel", (1,), {}),
        ("all ignored", quick_shape, {"all_ignored": True}),
    ]
    inputs = [(name, *_cm_case(shape, gen, **kw)) for name, shape, kw in cases]
    # more than 2^24 pixels, nearly all true negatives: a count that float32
    # running sums could not hold, and exact here
    big = torch.zeros((17, 1024, 1024), dtype=torch.int64, device="cuda")
    big_pred = torch.zeros_like(big)
    big.view(-1)[:3] = 255
    big.view(-1)[5:10] = 1
    big_pred.view(-1)[7:13] = 1
    inputs.append((f"{big.numel()} pixels (> 2^24)", big, big_pred))
    cm_err = 0.0
    for name, gts, preds in inputs:
        got = cm.binary_confusion_matrix(gts, preds)
        plain = cm.binary_confusion_matrix_plain(gts, preds)
        onehot = confusion_matrix(gts, preds, n_classes=2)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain) and torch.equal(got, onehot),
              f"binary_confusion_matrix ({name}): {got.tolist()} vs plain {plain.tolist()} "
              f"vs confusion_matrix {onehot.tolist()}")
        if name == "all ignored":
            check(not got.any(), f"all pixels ignored, but counted {got.tolist()}")
        cm_err = max(cm_err, err)
        print(f"[7] binary_confusion_matrix {name}: {[int(v) for v in got.flatten().tolist()]} "
              f"(tn, fp, fn, tp), equal to plain and to confusion_matrix (tolerance 0)")
    # 3 ignored, 5 ones (2 missed, 3 hit), 3 false alarms; the float32 nearest
    # to the exact count of true negatives
    exact = [big.numel() - 3 - 5 - 3, 3, 2, 3]
    check(got.flatten().tolist() == [float(np.float32(v)) for v in exact] and exact[0] > 2**24,
          f"counts above 2^24: {got.flatten().tolist()} vs exactly {exact}")
    del big, big_pred, inputs[-1:]

    _, gts, preds = inputs[0]

    def bincount():
        valid = (gts >= 0) & (gts < 2)
        return torch.bincount(2 * gts[valid] + preds[valid], minlength=4)

    check(torch.equal(bincount().float().reshape(2, 2), cm.binary_confusion_matrix(gts, preds)),
          "torch.bincount disagrees with the kernel")
    moved = gts.numel() * (gts.element_size() + preds.element_size()) + 16
    # four compares and four adds a pixel, against the float32 rate
    # the 33.6 MB of inputs fit the 50 MB L2 cache, and repeated launches would
    # be served from it: the record's times are taken with the cache flushed,
    # as the bound counts bytes from device memory
    warm = device_ms(lambda: cm.binary_confusion_matrix(gts, preds))
    cm_record = {
        "max_abs_err": cm_err,
        "ms": cold_device_ms(lambda: cm.binary_confusion_matrix(gts, preds)),
        "plain_ms": cold_device_ms(lambda: cm.binary_confusion_matrix_plain(gts, preds)),
        **least_time(moved, 8 * gts.numel(), F32_OPS_PER_S),
        "library_ms": cold_device_ms(bincount),
    }
    print(f"[7] binary_confusion_matrix at [8, 512, 512] int64/int64, inputs out of L2: device "
          f"time kernel {cm_record['ms']:.4f} ms ({moved / cm_record['ms'] / 1e6:.0f} GB/s), "
          f"plain {cm_record['plain_ms']:.4f} ms, torch.bincount {cm_record['library_ms']:.4f} "
          f"ms, bound {cm_record['bound_ms']:.4f} ms by {cm_record['bound_by']} ({moved} "
          f"bytes); with the inputs in L2 the kernel takes {warm:.4f} ms")

    pq_err, bounds = 0.0, []
    total = dict.fromkeys(("ms", "event_ms", "quant_ms", "quant_event_ms", "plain_ms"), 0.0)
    cold = ColdTimer(reps=10)
    # the 13 routed shapes, a ragged M, and K splits at M = 200 and M = 8
    for (m, k, n) in list(SLICE_SHAPES) + [(1000, 256, 128), (200, 2048, 512), (8, 512, 1024)]:
        x, w_q, w_scale, x_scale = _case(m, k, n, "bf16", gen)
        xs = torch.tensor(x_scale, dtype=torch.float32, device="cuda")
        x_q = torch.clamp(torch.round(x.float() / xs), -127, 127).to(torch.int8)
        got = k8.int8_matmul_prequant(x_q, w_q, w_scale, x_scale)
        plain = k8.int8_matmul_prequant_plain(x_q, w_q, w_scale, x_scale)
        fused = k8.int8_matmul(x, w_q, w_scale, x_scale)
        torch.cuda.synchronize()
        err = float((got - plain).abs().max())
        check(torch.equal(got, plain), f"prequant kernel != plain at {(m, k, n)}: {err}")
        check(torch.equal(got, fused), f"prequant kernel != int8_matmul at {(m, k, n)}: "
              f"{float((got - fused).abs().max())}")
        pq_err = max(pq_err, err)
        t = {"event_ms": cuda_ms(lambda: k8.int8_matmul_prequant(x_q, w_q, w_scale, x_scale)),
             "ms": cold(lambda: k8.int8_matmul_prequant(x_q, w_q, w_scale, x_scale)),
             "quant_event_ms": cuda_ms(lambda: k8.int8_matmul(x, w_q, w_scale, x_scale)),
             "quant_ms": cold(lambda: k8.int8_matmul(x, w_q, w_scale, x_scale)),
             "plain_ms": cuda_ms(lambda: k8.int8_matmul_prequant_plain(x_q, w_q, w_scale,
                                                                       x_scale), reps=5)}
        count = SLICE_SHAPES.get((m, k, n), 0)
        for key in total:
            total[key] += count * t[key]
        least = matmul_bound(m, k, n, 1)
        bounds += [least] * count
        plan = k8.plan(m, k, n, 1)
        print(f"[7] int8_matmul_prequant M={m} K={k} N={n}: bit-exact against plain and against "
              f"int8_matmul (tolerance 0); plan "
              + " ".join(f"{key}={plan[key]}" for key in k8.PLAN_KEYS)
              + f"; kernel {t['ms']:.4f} ms with the inputs out of L2 ({t['event_ms']:.4f} by "
              f"CUDA events), int8_matmul (quantize inside) {t['quant_ms']:.4f} ms "
              f"({t['quant_event_ms']:.4f}), plain {t['plain_ms']:.4f} ms; "
              f"{2 * m * k * n / t['ms'] / 1e9:.1f} TOP/s, {least['bound_ms'] / t['ms']:.1%} of "
              f"the bound {least['bound_ms']:.4f} ms by {least['bound_by']}")
    least = sum_bounds(bounds)
    print(f"[7] the 30 sites of a chunk, x already int8: kernel {total['ms']:.4f} ms with the "
          f"inputs out of L2 ({total['event_ms']:.4f} by CUDA events), int8_matmul "
          f"{total['quant_ms']:.4f} ms ({total['quant_event_ms']:.4f}; the quantize costs "
          f"{total['quant_ms'] - total['ms']:.4f} ms out of L2), plain {total['plain_ms']:.4f} "
          f"ms, bound {least['bound_ms']:.4f} ms by {least['bound_by']}")
    # torch._int_mm gives the int32 product alone, not this function (phase 3)
    pq_record = {"max_abs_err": pq_err, "ms": total["ms"], "event_ms": total["event_ms"],
                 "plain_ms": total["plain_ms"], **least, "library_ms": None}
    return cm_record, pq_record


def phase_quick_eval(cm, trainer, launches: int) -> None:
    """Phase 6's fit ran with quick-evals: check what it logged and counted,
    then one more quick-eval against the plain confusion matrix."""
    from iswm_tpu_torch.data import batch_iterator
    from iswm_tpu_torch.metrics.device import foreground_metrics_from_cm

    cfg = trainer.cfg
    want_steps = [s for s in range(QUICK_EVAL_INTERVAL, TRAIN_STEPS + 1, QUICK_EVAL_INTERVAL)
                  if s % cfg.train.val_interval]
    names = ("miou", "fiou", "precision", "recall", "f1")
    quick = {}
    with open(Path(cfg.train.log_dir) / "metrics.jsonl") as f:
        for rec in map(json.loads, f):
            if "quick_miou" in rec:
                quick[rec["step"]] = [rec[f"quick_{k}"] for k in names]
    check(sorted(quick) == want_steps and len(want_steps) >= 2,
          f"quick-eval points at steps {sorted(quick)}, expected {want_steps}")
    check(all(np.isfinite(v).all() and min(v) >= 0.0 and max(v) <= 1.0 for v in quick.values()),
          f"quick-eval metrics {quick}")
    batches = -(-len(trainer.val_ds) // cfg.data.val_batch_size)
    check(launches == len(want_steps) * batches,
          f"confusion kernel launched {launches} times in fit, expected {len(want_steps)} "
          f"quick-evals x {batches} validation batches")
    print(f"[8] quick-eval in fit: points at steps {want_steps}, confusion kernel launches "
          f"{launches} = {len(want_steps)} quick-evals x {batches} batches; "
          + "; ".join(f"step {s}: " + " ".join(f"{k} {v:.4f}" for k, v in zip(names, quick[s]))
                      for s in want_steps))

    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True  # two passes, the same predictions
    t0 = time.perf_counter()
    got = trainer.quick_eval()
    torch.cuda.synchronize()
    quick_s = time.perf_counter() - t0
    total = torch.zeros((2, 2), device="cuda")
    for images, labels in batch_iterator(trainer.val_ds, cfg.data.val_batch_size, epochs=1):
        preds = trainer.eval_step(torch.from_numpy(images).cuda())["preds"]
        total += cm.binary_confusion_matrix_plain(torch.from_numpy(labels).cuda(), preds)
    want = {k: float(v) for k, v in foreground_metrics_from_cm(total).items()}
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    worst = max(abs(got[k] - want[k]) for k in names)
    check(sorted(got) == sorted(names) and worst <= 1e-6,
          f"quick_eval {got} vs the plain confusion matrix's {want}")
    print(f"[8] Trainer.quick_eval over {len(trainer.val_ds)} scenes of 640x640: "
          f"{quick_s * 1e3:.2f} ms on the host's clock; equal to the metrics of the plain "
          f"confusion matrix on the same predictions (max abs diff {worst:.1e}, limit 1e-6)")


def phase_compare_variants(k8) -> None:
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import ArrayDataset, generate_scene, val_transform_batch
    from iswm_tpu_torch.infer import quantization as q
    from iswm_tpu_torch.models import build_model

    rng = np.random.default_rng(SEED)
    images, masks = zip(*(generate_scene(rng, size=(512, 512)) for _ in range(EVAL_SCENES)))
    dataset = ArrayDataset(np.stack(images), np.stack(masks))
    cfg = Config()  # deeplabv3plus_resnet50, OS 16, bf16
    model = build_model(cfg.model, seed=SEED).to("cuda", memory_format=torch.channels_last)

    k8.launches = 0
    t0 = time.perf_counter()
    report = q.compare_variants(model, dataset, EVAL_VARIANTS, sequence_length=7)
    torch.cuda.synchronize()
    compare_s = time.perf_counter() - t0
    launches = k8.launches
    print(q.format_report(report))
    check(list(report) == list(EVAL_VARIANTS), f"variants reported: {list(report)}")
    for name, r in report.items():
        numbers = [r[k] for k in ("avg_latency_ms", "miou", "fiou", "ff1", "weighted",
                                  "size_mb", "mask_agreement")]
        check(bool(np.isfinite(numbers).all()) and r["avg_latency_ms"] > 0,
              f"{name}: latency or metrics not finite: {r}")
    check(report["f32"]["verdict"] == "reference variant", "f32 is not the reference variant")
    top = [verdict for _, verdict in q.AGREEMENT_TIERS[:2]]
    for name in ("bf16", "int8"):
        check(report[name]["verdict"] in top,
              f"{name} vs f32: agreement {report[name]['mask_agreement']} "
              f"({report[name]['verdict']})")
    sites = sum(SLICE_SHAPES.values())
    check(launches == sites * (EVAL_SCENES + 1),
          f"int8_exec launched {launches} kernels, expected {sites} for each of "
          f"{EVAL_SCENES} images and the probe")

    x = val_transform_batch(torch.from_numpy(dataset[0][0])[None].cuda())
    scales = q.calibrate_activations(model, [x.permute(0, 3, 1, 2)])
    check(set(scales) == set(q.activation_sites(model)) and len(scales) == 61
          and all(np.isfinite(v) and v > 0 for v in scales.values()),
          f"{len(scales)} activation scales for {len(q.activation_sites(model))} sites")
    act = q.make_variant_fn(model, "int8_act", act_scales=scales)(x)
    weight_only = q.make_variant_fn(model, "int8")(x)
    diff = float((act - weight_only).abs().max())
    check(bool(torch.isfinite(act).all()) and diff > 0,
          f"int8_act logits equal int8's (max abs diff {diff})")
    print(f"[9] compare_variants, ResNet-50 / OS 16 / bf16, {EVAL_SCENES} scenes of 512x512, "
          f"{len(EVAL_VARIANTS)} variants in {compare_s:.2f} s; int8_exec launches {launches} = "
          f"{sites} x ({EVAL_SCENES} images + 1 probe); {len(scales)} activation scales; "
          f"int8_act differs from int8 by up to {diff:.4f} in the logits")


STEM_KERNELS = ("stats_partial", "pool_fwd", "bwd_sums_partial", "bwd_wgrad_partial",
                "sum_partials")


def _stem_case(b, s, dtype, gen, channels_last=True, kind="random"):
    """(z, x, dp, gamma, beta) of one stem case: the conv output z
    [b, 64, s, s] with per-channel offsets, the image x [b, 3, 2s, 2s] and the
    pooled cotangent dp, in ``dtype``."""
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    z = (rand(b, 64, s, s) * 1.5 + rand(1, 64, 1, 1) * 0.5).to(dtype)
    gamma, beta = 1.0 + 0.5 * rand(64), 0.1 * rand(64)
    if kind == "ties":  # constant z: every window is a 9-way (4- or 6-way at the rim) tie
        z, gamma, beta = torch.ones_like(z), torch.ones(64, device="cuda"), beta + 5.0
    elif kind == "negative":  # relu(bn(z)) = 0 everywhere
        gamma, beta = gamma.abs(), beta - 100.0
    x, dp = rand(b, 3, 2 * s, 2 * s).to(dtype), rand(b, 64, s // 2, s // 2).to(dtype)
    if channels_last:
        z, x, dp = (t.contiguous(memory_format=torch.channels_last) for t in (z, x, dp))
    return z, x, dp, gamma, beta


def _close(got, want, tol=1e-5):
    """max |got - want| in float64, and whether it is within tol * max|want|."""
    err = float((got.double() - want.double()).abs().max())
    return err, err <= tol * float(want.double().abs().max())


def _unfused_stem_chain(z, x, dp, gamma, beta):
    """The unfused chain on the same tensors: (forward, backward) callables.
    Another function than the kernels': first-index pool routing, BatchNorm's
    output rounded to z's dtype, and the weight gradient through cuDNN."""
    F = torch.nn.functional
    weight, bias = gamma.to(z.dtype), beta.to(z.dtype)

    def forward(leaf=z):
        y = torch.relu(F.batch_norm(leaf, None, None, weight, bias, True, 0.0, 1e-5))
        return F.max_pool2d(y, 3, 2, 1)

    leaf = z.detach().requires_grad_()
    pooled = forward(leaf)

    def backward():
        (dz,) = torch.autograd.grad(pooled, leaf, dp, retain_graph=True)
        return torch.nn.grad.conv2d_weight(x, (64, 3, 7, 7), dz, stride=2, padding=3)

    return forward, backward


def stem_bounds(z, x, dp) -> tuple:
    """({kernel: least time} of the four stem kernels on these inputs, and the
    weight gradient's operations at the float32 FMA rate in ms)."""
    nbytes = {t: v.numel() * v.element_size() for t, v in (("z", z), ("x", x), ("dp", dp))}
    vec = 64 * 4
    taps = 7 * 7 * 3
    # operations on these inputs: sums of z and z^2; affine, relu and the 9-way
    # maximum (9 visits per pooled value); the same recomputed plus tie counts,
    # shares and the two sums; the same plus dz, all float32 outside the tensor
    # cores.  Then the contraction, 2 * 147 * 64 operations a conv pixel: its
    # operands are dz and the image in z's dtype (bf16 here), so its peak is
    # the tensor cores' for that type, whatever units the kernel uses.
    contraction, elementwise = 2 * taps * z.numel(), 16 * z.numel()
    tensor_ops_per_s = BF16_OPS_PER_S if z.dtype == torch.bfloat16 else TF32_OPS_PER_S
    least = {
        "stats": least_time(nbytes["z"] + 2 * vec, 3 * z.numel(), F32_OPS_PER_S),
        "pool": least_time(nbytes["z"] + nbytes["dp"] + 2 * vec, 6 * z.numel(), F32_OPS_PER_S),
        "sums": least_time(nbytes["z"] + nbytes["dp"] + 6 * vec, elementwise, F32_OPS_PER_S),
        # the two kinds of operation one after the other, as tensor-core operations
        "wgrad": least_time(nbytes["z"] + nbytes["dp"] + nbytes["x"] + 6 * vec + 64 * taps * 4,
                            contraction + elementwise * tensor_ops_per_s / F32_OPS_PER_S,
                            tensor_ops_per_s),
    }
    return least, (contraction + elementwise) / F32_OPS_PER_S * 1e3


def phase_stem_kernels(fs) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, s = STEM_SLICE
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("slice bf16 NHWC", b, s, bf16, True, "random"),
        ("slice bf16 NCHW", b, s, bf16, False, "random"),
        ("slice f32 NHWC", b, s, f32, True, "random"),
        ("slice f32 NCHW", b, s, f32, False, "random"),
        ("S=32 bf16 (whole tiles)", 2, 32, bf16, True, "random"),
        ("S=20 f32 (ragged tiles)", 2, 20, f32, True, "random"),
        ("S=44 bf16 (ragged tiles)", 2, 44, bf16, False, "random"),
        ("S=36 bf16 (ragged 8x32 tiles, rows and columns)", 2, 36, bf16, True, "random"),
        ("S=40 bf16 NCHW (ragged 8x32 tiles, columns)", 2, 40, bf16, False, "random"),
        ("batch 3 S=64 bf16 (16 tiles an image)", 3, 64, bf16, True, "random"),
        ("batch 1 S=32 f32", 1, 32, f32, True, "random"),
        ("all-tie z, S=32 bf16", 2, 32, bf16, True, "ties"),
        ("all-negative pre-activation, S=32 f32", 2, 32, f32, True, "negative"),
    ]
    errs = {"stats": 0.0, "pool": 0.0, "sums": 0.0, "wgrad": 0.0}
    for name, bb, ss, dtype, channels_last, kind in cases:
        z, x, dp, gamma, beta = _stem_case(bb, ss, dtype, gen, channels_last, kind)
        n = bb * ss * ss
        total, total_sq = fs.stem_stats(z)
        again = fs.stem_stats(z)
        want = fs.stem_stats_plain(z, dtype=torch.float64)
        torch.cuda.synchronize()
        check(torch.equal(total, again[0]) and torch.equal(total_sq, again[1]),
              f"stem_stats not bit-stable ({name})")
        e_stats = 0.0
        for got, ref, what in ((total, want[0], "sum z"), (total_sq, want[1], "sum z^2")):
            err, ok = _close(got, ref)
            check(ok, f"stem_stats {what} ({name}): max abs err {err} vs float64")
            e_stats = max(e_stats, err)
        if kind == "ties":  # the JAX package's engineered case: statistics given
            mean, sigma_inv = torch.zeros(64, device="cuda"), torch.ones(64, device="cuda")
        else:
            mean = total / n
            sigma_inv = torch.rsqrt(torch.clamp_min(total_sq / n - mean * mean, 0.0) + 1e-5)
        scale, bias = fs.fold_affine(gamma, beta, mean, sigma_inv)

        pooled = fs.stem_norm_relu_pool(z, scale, bias)
        pooled_plain = fs.stem_norm_relu_pool_plain(z, scale, bias)
        torch.cuda.synchronize()
        e_pool = float((pooled.float() - pooled_plain.float()).abs().max())
        check(pooled.dtype == dtype and torch.equal(pooled, pooled_plain),
              f"stem_norm_relu_pool != plain ({name}): max abs err {e_pool}")

        args = (z, dp, scale, bias, mean, sigma_inv)
        s1, s2 = fs.stem_bwd_sums(*args)
        again = fs.stem_bwd_sums(*args)
        want = fs.stem_bwd_sums_plain(*args, dtype=torch.float64)
        torch.cuda.synchronize()
        check(torch.equal(s1, again[0]) and torch.equal(s2, again[1]),
              f"stem_tail_bwd sums not bit-stable ({name})")
        e_sums = 0.0
        for got, ref, what in ((s1, want[0], "s1 (dbeta)"), (s2, want[1], "s2 (dgamma)")):
            err, ok = _close(got, ref)
            check(ok or (kind == "negative" and err == 0.0),
                  f"stem_tail_bwd {what} ({name}): max abs err {err} vs float64")
            e_sums = max(e_sums, err)

        wargs = (z, dp, x, scale, bias, mean, sigma_inv, s1 / n, s2 / n)
        dw = fs.stem_bwd_wgrad(*wargs)
        again = fs.stem_bwd_wgrad(*wargs)
        want = fs.stem_bwd_wgrad_plain(*wargs, dtype=torch.float64)
        torch.cuda.synchronize()
        check(torch.equal(dw, again), f"stem_tail_bwd wgrad not bit-stable ({name})")
        e_wgrad, ok = _close(dw, want)
        check(tuple(dw.shape) == (64, 3, 7, 7) and (ok or (kind == "negative" and e_wgrad == 0.0)),
              f"stem_tail_bwd dW ({name}): max abs err {e_wgrad} vs float64, "
              f"max |dW| {float(want.abs().max())}")
        note = ""
        if kind == "ties":  # equal-split keeps every window's mass: dbeta = sum dp
            mass = dp.double().sum(dim=(0, 2, 3))
            err, ok = _close(s1, mass)
            check(ok, f"all-tie z: dbeta differs from sum dp by {err}")
            note = f"; dbeta = sum dp within {err:.2e}"
        if kind == "negative":
            check(not pooled.float().any() and not s1.any() and not s2.any() and not dw.any(),
                  "all-negative pre-activation: a pooled value or a gradient is not 0")
            note = "; pooled, dbeta, dgamma and dW all 0"
        for key, err in (("stats", e_stats), ("pool", e_pool), ("sums", e_sums),
                         ("wgrad", e_wgrad)):
            errs[key] = max(errs[key], err)
        print(f"[10] fused stem {name}: statistics max abs err {e_stats:.3e}, pooled equal bit "
              f"for bit, s1/s2 {e_sums:.3e}, dW {e_wgrad:.3e} vs float64 (each within 1e-5 * "
              f"max|tensor|), all bit-stable{note}")
        del z, x, dp, pooled, pooled_plain, want, dw, again

    # times at the training slice's shape and layout, z out of the L2 cache
    z, x, dp, gamma, beta = _stem_case(b, s, bf16, gen)
    n = b * s * s
    total, total_sq = fs.stem_stats(z)
    mean = total / n
    sigma_inv = torch.rsqrt(torch.clamp_min(total_sq / n - mean * mean, 0.0) + 1e-5)
    scale, bias = fs.fold_affine(gamma, beta, mean, sigma_inv)
    args = (z, dp, scale, bias, mean, sigma_inv)
    s1, s2 = fs.stem_bwd_sums(*args)
    wargs = (z, dp, x, scale, bias, mean, sigma_inv, s1 / n, s2 / n)
    chain_fwd, chain_bwd = _unfused_stem_chain(z, x, dp, gamma, beta)
    calls = {
        "stats": (lambda: fs.stem_stats(z), lambda: fs.stem_stats_plain(z)),
        "pool": (lambda: fs.stem_norm_relu_pool(z, scale, bias),
                 lambda: fs.stem_norm_relu_pool_plain(z, scale, bias)),
        "sums": (lambda: fs.stem_bwd_sums(*args), lambda: fs.stem_bwd_sums_plain(*args)),
        "wgrad": (lambda: fs.stem_bwd_wgrad(*wargs), lambda: fs.stem_bwd_wgrad_plain(*wargs)),
    }
    least, fma_ms = stem_bounds(z, x, dp)
    chain = {"fwd": cold_device_ms(chain_fwd, reps=10), "bwd": cold_device_ms(chain_bwd, reps=10)}
    records = {}
    for key, (kernel, plain) in calls.items():
        records[key] = {"max_abs_err": errs[key], "ms": cold_device_ms(kernel, reps=10),
                        "plain_ms": cold_device_ms(plain, reps=5), **least[key],
                        "library_ms": None}  # no single PyTorch call computes it
        moved = least[key]["bound_ms"] if least[key]["bound_by"] == "bytes" else None
        print(f"[10] stem {key} at z [8, 64, 256, 256] bf16 NHWC, inputs out of L2: device time "
              f"kernel {records[key]['ms']:.4f} ms, plain {records[key]['plain_ms']:.4f} ms, "
              f"bound {least[key]['bound_ms']:.4f} ms by {least[key]['bound_by']}"
              + ("" if moved is None else
                 f" ({moved * HBM_BYTES_PER_S / 1e9:.1f} MB)")
              + (f"; the bf16 kernel contracts on the tensor cores (mma.sync), the float32 "
                 f"one on the FMA units, at whose peak rate these operations alone would take "
                 f"{fma_ms:.4f} ms" if key == "wgrad" else ""))
    records["wgrad"]["units"] = {  # what the contraction runs on, by z's dtype
        "bfloat16": "tensor cores (mma.sync.m16n8k16 bf16 -> f32, IEEE adds between 64-pixel "
                    "chains)",
        "float32": "f32 FMA units (no tensor cores)"}
    records["wgrad"]["f32_fma_ops_ms"] = fma_ms  # what the float32 body's units would need
    for pair, keys in (("fwd", ("stats", "pool")), ("bwd", ("sums", "wgrad"))):
        ours = sum(records[k]["ms"] for k in keys)
        for k in keys:
            records[k]["unfused_chain_ms"] = chain[pair]
            records[k]["unfused_chain_of"] = "+".join(keys)
        print(f"[10] stem {pair}: kernels {' + '.join(keys)} {ours:.4f} ms; the unfused chain on "
              f"the same tensors (another function: "
              + ("F.batch_norm train + ReLU + F.max_pool2d" if pair == "fwd" else
                 "their autograd backward + the conv's cuDNN weight gradient")
              + f") {chain[pair]:.4f} ms")
    return records


def _fused_trainer(setting: str, steps: int, seed: int | None = None) -> tuple:
    """:func:`_slice_trainer` with ``cfg.model.<setting> = "always"``."""
    return _slice_trainer(steps, f"chip_smoke_{setting}", seed, **{setting: "always"})


_SLICE_SCENES = []  # phase 6's seeded train and validation sets, made once


def _slice_trainer(steps: int, name: str, seed: int | None = None, train=None,
                   parallel=None, **model) -> tuple:
    """(Trainer, its Config, train set, validation set) of phase 6's
    configuration with the ``model`` settings given, for ``steps`` steps with
    a quick-eval halfway and a validation at the end, writing under
    ``build/<name>``; ``seed`` replaces the configuration's
    ``train.random_seed`` (the weights, augmentation and batch order),
    ``train`` sets ``cfg.train`` fields and ``parallel`` ``cfg.parallel``
    fields."""
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import ArrayDataset, generate_scene
    from iswm_tpu_torch.train import Trainer

    if not _SLICE_SCENES:
        rng = np.random.default_rng(SEED)

        def scenes(n):
            images, masks = zip(*(generate_scene(rng, size=(640, 640)) for _ in range(n)))
            return ArrayDataset(np.stack(images), np.stack(masks))

        _SLICE_SCENES.extend((scenes(32), scenes(VAL_SCENES)))
    train_ds, val_ds = _SLICE_SCENES
    cfg = Config()
    for key, value in model.items():
        setattr(cfg.model, key, value)
    for key, value in (train or {}).items():
        setattr(cfg.train, key, value)
    for key, value in (parallel or {}).items():
        setattr(cfg.parallel, key, value)
    cfg.data.crop_size, cfg.data.batch_size = 512, 8
    cfg.train.total_itrs = cfg.train.val_interval = steps
    cfg.train.quick_eval_interval = cfg.train.print_interval = steps // 2
    cfg.train.save_val_results = False  # the PNG dump needs PIL
    if seed is not None:
        cfg.train.random_seed = seed
    out = TRAIN_OUT.with_name(name)
    shutil.rmtree(out, ignore_errors=True)
    for name in ("checkpoints_dir", "val_results_dir", "metrics_plots_dir", "log_dir"):
        setattr(cfg.train, name, str(out / name))
    return Trainer(cfg, device="cuda", train_ds=train_ds, val_ds=val_ds), cfg, train_ds, val_ds


F32_BN1_LIMIT = 1e-5  # phase 11, float32 bn1 gradients, when no decision differs


def _nudge(module, args, out):
    """Forward hook: one pooled value in a million moved up by an ulp or two
    of what the convs after it read: bf16, TF32 from a float32 tensor, or
    float32 where TF32 is off."""
    gen = torch.Generator(device=out.device).manual_seed(SEED)
    where = torch.rand(out.shape, generator=gen, device=out.device) < 1e-6
    ulp = 2.0 ** (-7 if out.dtype == torch.bfloat16
                  else -10 if torch.backends.cudnn.allow_tf32 else -23)
    return torch.where(where, (out.double() * (1.0 + ulp)).to(out.dtype), out)


def _stem_decision_flips(fs, z, gamma, beta, eps) -> tuple:
    """(ReLU signs, pool windows) decided differently by the fused chain (the
    kernels' statistics, the folded affine in float32) and the unfused one
    (``F.batch_norm`` in z's dtype) on the conv output ``z``: a pixel whose
    y is above 0 in one and not in the other, and a window, with a maximum
    above 0, whose winner in one chain is not a maximum of the other.  A tie
    within a chain (flat scenes give equal z, hence equal y) is no
    difference: the fused backward splits the window's cotangent over the
    tied positions and the unfused one sends it to the first, but the tied
    positions share y and yhat, so bn1's two sums are the same either way."""
    F = torch.nn.functional
    n = z.numel() // z.shape[1]
    total, total_sq = fs.stem_stats(z)
    mean = total / n
    var = torch.clamp_min(total_sq / n - mean * mean, 0.0)
    scale, bias = fs.fold_affine(gamma, beta, mean, torch.rsqrt(var + eps))
    fused = z.float() * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)
    unfused = F.batch_norm(z, None, None, gamma, beta, True, 0.0, eps).float()
    signs = int(((fused > 0) != (unfused > 0)).sum())
    fused, unfused = torch.relu(fused), torch.relu(unfused)
    (p_f, i_f), (p_u, i_u) = (F.max_pool2d(y, 3, 2, 1, return_indices=True)
                              for y in (fused, unfused))

    def value_at(y, index):
        return y.flatten(2).gather(2, index.flatten(2)).reshape(index.shape)

    differ = (value_at(fused, i_u) != p_f) | (value_at(unfused, i_f) != p_u)
    return signs, int((differ & ((p_f > 0) | (p_u > 0))).sum())


def phase_stem_slice(fs, ce) -> tuple:
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import augment_batch, batch_iterator
    from iswm_tpu_torch.infer import Predictor, tile_origins
    from iswm_tpu_torch.infer.quantization import logit_diff_verdict
    from iswm_tpu_torch.models import build_model
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

    trainer, cfg, train_ds, val_ds = _fused_trainer("fused_stem", STEM_STEPS)

    def counts():
        return read_counters(fs, STEM_COUNTERS)

    zero_counters(fs, STEM_COUNTERS)
    ce.launches_fwd = ce.launches_bwd = 0
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches = counts()
    eval_forwards = 2 * -(-len(val_ds) // cfg.data.val_batch_size)  # a quick-eval, a validation
    want = (STEM_STEPS, STEM_STEPS + eval_forwards, STEM_STEPS, STEM_STEPS)
    check(train_launches == want,
          f"stem launches (stats, pool, bwd sums, bwd wgrad) {train_launches}, expected {want}: "
          f"{STEM_STEPS} steps and {eval_forwards} eval forwards")
    check((ce.launches_fwd, ce.launches_bwd) == (STEM_STEPS, STEM_STEPS),
          f"fused CE launches {(ce.launches_fwd, ce.launches_bwd)} in {STEM_STEPS} steps")
    losses = trainer.logger.history["train_loss"]
    check(len(losses) == 2 and all(np.isfinite(losses)), f"logged losses {losses}")
    check(trainer.best_path is not None, "no best checkpoint was written")
    payload = torch.load(trainer.best_path, map_location="cpu", weights_only=True)
    unfused_cfg = Config().model
    check(unfused_cfg.fused_stem == "never", "fused_stem does not default to 'never'")
    build_model(unfused_cfg).load_state_dict(payload["model_state"], strict=True)
    print(f"[11] training with fused_stem='always': {STEM_STEPS} steps + 1 quick-eval + 1 "
          f"validation in {fit_s:.2f} s; launches stats {train_launches[0]}, pool "
          f"{train_launches[1]} ({STEM_STEPS} steps + {eval_forwards} eval forwards), bwd sums "
          f"{train_launches[2]}, bwd wgrad {train_launches[3]}; losses "
          f"{[round(v, 4) for v in losses]}; {Path(trainer.best_path).name} loads strict=True "
          f"into an unfused model")

    # one step fused and one unfused from one state, on one augmented batch,
    # with one dropout mask and deterministic algorithms.  The two forwards
    # differ in the last bit of some pooled values (the unfused BatchNorm
    # rounds before the ReLU and the pool and takes another variance formula),
    # and a whole step of this model answers any such difference with
    # gradients that differ by a large part of their size: so the step's
    # gradients are printed beside those of an unfused step whose pooled
    # values were moved by an ulp or two (of bf16, or of the TF32 that float32
    # convs read) at one value in a million, and the
    # backward is held to the unfused chain where the two can agree: on the
    # fused step's own image, parameters and pooled cotangent.
    images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
    x, y = augment_batch(torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda(),
                         trainer.augment, torch.Generator(device="cuda").manual_seed(SEED))
    model = trainer.state.model
    backbone = model.backbone
    start, trained_dtype = copy.deepcopy(model.state_dict()), model.compute_dtype
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    factory, _ = make_optimizer(cfg.optim, cfg.train.total_itrs)
    step = make_train_step(make_loss_fn(cfg.loss.loss_type, fused="auto", device="cuda"))
    stem = ("backbone.conv1.weight", "backbone.bn1.weight", "backbone.bn1.bias")
    F = torch.nn.functional

    def one_step(mode, hooked, hook):
        """(loss, gradients, bn1's running mean and var) of one step from
        ``start`` with ``hook`` on the forward of the module ``hooked``."""
        backbone.fused_stem = mode
        model.load_state_dict(start)
        state = TrainState(model, *factory(model.parameters()), 0)
        torch.cuda.manual_seed(SEED)
        handle = hooked.register_forward_hook(hook)
        with warnings.catch_warnings():  # ops without a deterministic version
            warnings.simplefilter("ignore")
            loss = float(step(state, x, y))
        handle.remove()
        return (loss, {k: p.grad.float().clone() for k, p in model.named_parameters()},
                backbone.bn1.running_mean.clone(), backbone.bn1.running_var.clone())

    def ratios_of(got, want):
        return sorted((float((got[k] - want[k]).abs().max()
                             / want[k].abs().max().clamp_min(1e-30)), k) for k in want)

    # limits on (loss, conv1's gradient, bn1's two gradients), from the
    # readings of seven runs on an H100, which spread (the state after four
    # steps differs between runs), so each limit stands at three to seven
    # times the largest reading.  Loss: bf16 1.8e-4 to 2.8e-3, float32 3.3e-5
    # to 1.5e-4 (the pooled values differ by an ulp here and there); bf16
    # conv1 1.3e-2 to 3.1e-2 (tie routing) and bn1 1.3e-3 to 4.3e-3; float32
    # conv1 5.9e-4 to 1.3e-3 (the library's weight gradient reads TF32) and
    # bn1 up to 9e-7 in a dozen runs but 3.0e-3 in one: the folded affine and
    # F.batch_norm round y differently, and one element whose ReLU or pool
    # decision goes the other way moves these sums by a whole cotangent (phase
    # 10 holds the same sums to 1e-5 where both sides share the decisions).
    # So float32 bn1 is held at F32_BN1_LIMIT when no decision differs between
    # the two chains on the step's own input (_stem_decision_flips), and at
    # bn_tol only when one does
    for dtype, loss_tol, conv_tol, bn_tol in ((torch.bfloat16, 2e-2, 1e-1, 2e-2),
                                              (torch.float32, 1e-3, 5e-3, 1e-2)):
        model.compute_dtype = dtype
        seen = {}

        def grab(module, args, out):
            seen["x"] = args[0].detach()
            out.register_hook(lambda g: seen.__setitem__("dp", g.detach().clone()))

        loss_k, g_k, mean_k, var_k = one_step("always", backbone.fused_stem_pool, grab)
        loss_p, g_p, mean_p, var_p = one_step("never", backbone.maxpool, lambda *a: None)
        _, g_n, _, _ = one_step("never", backbone.maxpool, _nudge)
        var_err = float((var_k - var_p).abs().max() / var_p.abs().max())
        mean_err = float((mean_k - mean_p).abs().max() / var_p.sqrt().max())
        check(var_err <= 1e-5 and mean_err <= 1e-5,
              f"{dtype}: bn1 running statistics after one fused step differ from the unfused "
              f"step's: var {var_err:.2e} * max|var|, mean {mean_err:.2e} * max sqrt(var)")
        rel = abs(loss_k - loss_p) / abs(loss_p)
        check(rel <= loss_tol, f"{dtype}: fused step loss {loss_k} vs unfused {loss_p}")
        # the unfused chain's autograd on the fused step's inputs and cotangent
        leaves = [start[k].clone().requires_grad_() for k in stem]
        z = F.conv2d(seen["x"], leaves[0].to(dtype), None, 2, 3)
        bn = backbone.bn1
        pooled = F.max_pool2d(torch.relu(F.batch_norm(
            z, None, None, leaves[1], leaves[2], True, 0.0, bn.eps)), 3, 2, 1)
        chain = dict(zip(stem, torch.autograd.grad(pooled, leaves, seen["dp"])))
        own = ratios_of({k: g_k[k] for k in stem}, chain)
        flips = _stem_decision_flips(fs, z.detach(), start[stem[1]], start[stem[2]], bn.eps)
        if dtype == torch.float32 and not sum(flips):
            bn_tol = F32_BN1_LIMIT
        for ratio, key in own:
            limit = conv_tol if key == stem[0] else bn_tol
            check(ratio <= limit,
                  f"{dtype}: the fused stem's gradient of {key} differs from the unfused "
                  f"chain's on the same inputs by {ratio:.2e} * max|grad| (limit {limit}; "
                  f"decisions that differ between the two chains: {flips[0]} ReLU signs, "
                  f"{flips[1]} pool winners; the other stem gradients {own})")
        whole, floor = ratios_of(g_k, g_p), ratios_of(g_n, g_p)
        print(f"[11] one step fused vs fused_stem='never', {dtype}: loss {loss_k:.6f} vs "
              f"{loss_p:.6f} (rel {rel:.2e}, limit {loss_tol}); bn1 running var {var_err:.2e}, "
              f"mean {mean_err:.2e} (limit 1e-5); the stem's gradients against the unfused "
              f"chain's autograd on the same image, parameters and cotangent: "
              + ", ".join(f"{k.removeprefix('backbone.')} {r:.2e}" for r, k in own)
              + f" * max|grad| (limits: conv1 {conv_tol}, bn1 {bn_tol}; decisions that differ "
              f"between the two chains: {flips[0]} ReLU signs, {flips[1]} pool winners); whole-step "
              f"gradients, median tensor of "
              f"{len(whole)}: fused vs unfused {whole[len(whole) // 2][0]:.2e}, unfused vs "
              f"unfused with one pooled value in a million moved by an ulp or two "
              f"{floor[len(floor) // 2][0]:.2e} (not held: the step is chaotic)")
        del seen, chain, z, pooled
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    model.compute_dtype = trained_dtype
    model.load_state_dict(start)

    xu8, yu8 = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    step_ms, device_ms_of, stem_ms = {}, {}, 0.0
    for mode in ("never", "always", "always", "never"):
        model.backbone.fused_stem = mode
        times = []
        for i in range(11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, xu8, yu8)
            torch.cuda.synchronize()
            if i >= 3:  # after warm-up
                times.append(time.perf_counter() - t0)
        step_ms.setdefault(mode, []).extend(times)
    for mode in ("never", "always"):
        model.backbone.fused_stem = mode
        kernels = traced_kernels(lambda: trainer.train_step(trainer.state, xu8, yu8), 3, 1)
        device_ms_of[mode] = sum(kernels.values())
        if mode == "always":
            ours = {k: v for k, v in kernels.items() if any(n in k for n in STEM_KERNELS)}
            check(len(ours) >= 5, f"the trace of a fused step names {sorted(ours)}")
            stem_ms = sum(ours.values())
    never, always = (float(np.median(step_ms[m])) * 1e3 for m in ("never", "always"))
    rounds = {m: [round(float(np.median(step_ms[m][i:i + 8])) * 1e3, 2) for i in (0, 8)]
              for m in step_ms}
    print(f"[11] train step, batch 8 at 512^2, median of {len(step_ms['never'])} each (never, "
          f"always, always, never): fused_stem='never' {never:.2f} ms, 'always' {always:.2f} ms "
          f"(host-bound; by round of 8: never {rounds['never']}, always {rounds['always']}); "
          f"device time of a step (profiler, per-kernel means): 'never' "
          f"{device_ms_of['never']:.2f} ms, 'always' {device_ms_of['always']:.2f} ms, of which "
          f"the stem kernels {stem_ms:.3f} ms ({100 * stem_ms / device_ms_of['always']:.2f}%); "
          f"so the unfused stem tail is {device_ms_of['never'] - device_ms_of['always'] + stem_ms:.3f} "
          f"ms of the unfused step (the difference of the two totals, plus the stem kernels)")
    del trainer, model

    # serving: the 1024x1536 scene through the tile engine, bf16
    scene = np.random.default_rng(SEED).integers(0, 256, (*SCENES[0], 3), dtype=np.uint8)
    predictors = {}
    for mode in ("always", "never"):
        pcfg = Config()
        pcfg.model.fused_stem = mode
        predictors[mode] = Predictor(pcfg, device="cuda")
    p = pcfg.predict
    tiles = (len(tile_origins(SCENES[0][0], p.tile_size, p.tile_size - p.tile_overlap))
             * len(tile_origins(SCENES[0][1], p.tile_size, p.tile_size - p.tile_overlap)))
    chunks = -(-tiles // p.tile_batch)
    before = counts()
    product = predictors["always"].predict_image(scene)
    torch.cuda.synchronize()
    serve_launches = tuple(a - b for a, b in zip(counts(), before))
    check(serve_launches == (0, chunks, 0, 0),
          f"serving launched (stats, pool, bwd sums, bwd wgrad) {serve_launches}, expected "
          f"the pool kernel once for each of {chunks} chunks and no other")
    check(product["mask"].shape == SCENES[0] and bool(np.isfinite(product["prob_fg"]).all()),
          "the fused Predictor's products")
    from iswm_tpu_torch.data import val_transform_batch

    xs = val_transform_batch(torch.from_numpy(scene).cuda())
    logits = {m: pr.engine.infer_scene(xs) for m, pr in predictors.items()}
    check(bool(torch.isfinite(logits["always"]).all()), "fused scene logits not finite")
    agree, verdict = logit_diff_verdict(logits["never"].cpu().numpy(),
                                        logits["always"].cpu().numpy())
    check(agree >= 0.999, f"fused vs unfused Predictor: mask agreement {agree} ({verdict})")
    latency = {}
    for mode in ("never", "always", "always", "never"):
        predictors[mode].predict_image(scene)
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predictors[mode].predict_image(scene)
            torch.cuda.synchronize()
            latency.setdefault(mode, []).append(time.perf_counter() - t0)
    never, always = (float(np.median(latency[m])) * 1e3 for m in ("never", "always"))
    print(f"[11] bf16 Predictor on the {SCENES[0][0]}x{SCENES[0][1]} scene ({tiles} tiles, "
          f"{chunks} chunks): stem_norm_relu_pool launches {serve_launches[1]}, logits finite, "
          f"mask agreement with the unfused Predictor {agree:.6f} ({verdict}); scene latency "
          f"median of {len(latency['never'])}: fused_stem='never' {never:.2f} ms, 'always' "
          f"{always:.2f} ms")
    return tuple(a + b for a, b in zip(train_launches, serve_launches))


# (M, K, N, prologue) of the fused blocks' 1x1 convs in one train step of the
# slice (ResNet-50, OS 16, batch 8, crop 512), and how many of the 26 run at it
BLOCK_MM_SHAPES = {
    (131072, 64, 64, False): 1,     # layer1.0.conv1
    (131072, 64, 256, False): 1,    # layer1.0.downsample.0
    (131072, 64, 256, True): 3,     # layer1.*.conv3
    (131072, 256, 64, False): 2,    # layer1.{1,2}.conv1
    (32768, 512, 128, False): 3,    # layer2.{1,2,3}.conv1
    (32768, 128, 512, True): 3,     # layer2.{1,2,3}.conv3
    (8192, 1024, 256, False): 5,    # layer3.{1..5}.conv1
    (8192, 256, 1024, True): 5,     # layer3.{1..5}.conv3
    (8192, 1024, 512, False): 1,    # layer4.0.conv1
    (8192, 512, 2048, True): 1,     # layer4.0.conv3
    (8192, 1024, 2048, False): 1,   # layer4.0.downsample.0
}
# (B, H, W, C, N) of their 3x3 convs, and how many of the 12
BLOCK_C3_SHAPES = {
    (8, 128, 128, 64, 64): 3,       # layer1.*.conv2
    (8, 64, 64, 128, 128): 3,       # layer2.{1,2,3}.conv2
    (8, 32, 32, 256, 256): 5,       # layer3.{1..5}.conv2
    (8, 32, 32, 512, 512): 1,       # layer4.0.conv2
}
BLOCK_STEPS = 4  # with a quick-eval at step 2 and the validation at 4
# phase 13: how many times as far from the float64 block the fused block's
# gradients may lie as the unfused modules' (the worst tensor of each, and the
# median tensor of each), an unfused distance counting as at least the floor
BLOCK_SLACK_WORST, BLOCK_SLACK_MEDIAN = 5.0, 4.0
BLOCK_F32_LIMIT = 1e-3  # ... and, in float32, the fused block's own distance
BLOCK_FLOOR = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
BLOCK_KERNELS = ("::conv_fwd<", "::conv_dgrad<", "::conv_wgrad<", "::fwd_1x1_bf16<",
                 "::fwd_3x3_bf16<", "::dgrad_1x1_bf16<", "::wgrad_1x1_bf16<",
                 "::dgrad_3x3_bf16<", "::wgrad_3x3_bf16<", "::sum_partials(")
# the tiles (BM, BN) of the bf16 forward's planner, each reached by a phase-12 case
BLOCK_FWD_TILES = {"mm": {(128, 128), (64, 128), (128, 64), (64, 64)},
                   "c3": {(128, 128), (128, 64)}}


def _rounding_error(got, want, dtype):
    """(largest error in units of the tolerance, share of elements beyond it).
    bf16: one ulp at max(|want|, max|want| / 128), since the float32
    accumulator is far finer than a bf16 ulp and can cross one rounding
    boundary at most; the floor keeps an output near 0 (a cancelling sum) to
    the ulp of values 128 times smaller than the largest.  float32: 1e-5 *
    max|want|, the summation-order error of a float32 sum thousands of terms
    long against the float64 one (readings up to 1.1e-6)."""
    err = (got.double() - want.double()).abs()
    top = float(want.double().abs().max())
    if dtype == torch.bfloat16:
        tiny = torch.finfo(torch.bfloat16).tiny
        mag = want.double().abs().clamp_min(max(top / 128, tiny))
        unit = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    else:
        unit = torch.full_like(err, max(1e-5 * top, torch.finfo(torch.float64).tiny))
    ratio = err / unit
    return float(ratio.max()), float((ratio > 1).double().mean())


def _fb_inputs(kind, shape, dtype, gen):
    """One fused-block case: the activation with per-channel offsets, the
    weight, the folded affine (a, b) and the cotangents (dy, ds, dq)."""
    def rand(*s):
        return torch.randn(s, generator=gen, device="cuda")

    if kind == "mm":
        m, k, n = shape
        x = (rand(m, k) + 0.5 * rand(1, k)).to(dtype)
        w = (rand(k, n) / k ** 0.5).to(dtype)
        dy = rand(m, n).to(dtype)
    else:
        b, h, wd, k, n = shape
        x = (rand(b, h, wd, k) + 0.5 * rand(1, 1, 1, k)).to(dtype)
        w = rand(3, 3, k, n) / (9 * k) ** 0.5  # float32, cast inside
        dy = rand(b, h, wd, n).to(dtype)
    return x, w, 1.0 + 0.5 * rand(k), 0.1 * rand(k), dy, rand(n), 0.01 * rand(n)


def _fb_calls(fb, kind, prologue, x, w, a, b):
    """(forward, plain forward, backward, plain backward) of one case, the
    plain ones taking the dtype they sum in."""
    if kind == "mm":
        return (lambda: fb.matmul_bn_stats_fwd(x, w, a, b, prologue),
                lambda dt: fb.matmul_bn_stats_plain(x, w, a, b, prologue, dtype=dt),
                lambda y, g: fb.matmul_bn_stats_bwd(x, w, a, b, y, *g, prologue),
                lambda y, g, dt: fb.matmul_bn_stats_bwd_plain(x, w, a, b, y, *g, prologue,
                                                              dtype=dt))
    return (lambda: fb.conv3x3_bn_stats_fwd(x, a, b, w),
            lambda dt: fb.conv3x3_bn_stats_plain(x, a, b, w, dtype=dt),
            lambda y, g: fb.conv3x3_bn_stats_bwd(x, a, b, w, y, *g),
            lambda y, g, dt: fb.conv3x3_bn_stats_bwd_plain(x, a, b, w, y, *g, dtype=dt))


def _fb_bound(kind, shape, prologue, esize):
    """(forward, backward) least times of one call: every input read once and
    every output written once; the contraction at the bf16 tensor-core rate
    (TF32's for float32 operands), whatever units the kernel uses."""
    if kind == "mm":
        m, k, n = shape
        taps, w_in = 1, k * n * esize
    else:
        b, h, wd, k, n = shape
        m, taps, w_in = b * h * wd, 9, 9 * k * n * 4
    vec = 2 * k * 4 * bool(prologue)
    rate = BF16_OPS_PER_S if esize == 2 else TF32_OPS_PER_S
    flops = 2 * m * taps * k * n
    fwd = least_time(m * k * esize + w_in + vec + m * n * esize + 2 * n * 4, flops, rate)
    bwd = least_time(2 * m * k * esize + 2 * m * n * esize + w_in + taps * k * n * 4
                     + 2 * vec + 2 * n * 4, 2 * flops, rate)
    return fwd, bwd


def _bwd_halves(lib, kind, x, w, a, b, y, dy, ds, dq, prologue) -> tuple:
    """(data gradient, weight gradient): callables for the two C entries of
    one backward, ``matmul_bn_stats``'s ("mm") or ``conv3x3_bn_stats``'s
    ("c3"), each with its finishing sum, on outputs and scratch made here
    once (as ``fused_block._launch_bwd`` makes them); ``lib`` is a library
    built from ``csrc/fused_block.cu``."""
    if kind == "mm":
        (m, k), n = x.shape, w.shape[1]
        taps, h, wd = 1, 1, m
    else:
        bsz, h, wd, k = x.shape
        n, m, taps = w.shape[3], bsz * h * wd, 9
        w = w.to(x.dtype).permute(2, 0, 1, 3).reshape(k, taps * n).contiguous()  # w_ckn
    f32 = {"dtype": torch.float32, "device": x.device}
    dx, dab = torch.empty_like(x), torch.zeros(2 * k, **f32)
    sums = torch.empty(lib.iswm_fb_sums_scratch(m, k), **f32)
    parts = torch.empty(lib.iswm_fb_wgrad_splits(m, taps * k, n) * taps * k * n, **f32)
    dw = torch.empty(taps * k, n, **f32)
    ab = (a.data_ptr(), b.data_ptr()) if prologue else (None, None)
    shape = (int(x.dtype == torch.bfloat16), taps, int(prologue), m, h, wd, k, n)
    stream = torch.cuda.current_stream().cuda_stream

    def dgrad():
        rc = lib.iswm_fb_dgrad(dy.data_ptr(), y.data_ptr(), ds.data_ptr(), dq.data_ptr(),
                               w.data_ptr(), x.data_ptr(), *ab, dx.data_ptr(), sums.data_ptr(),
                               dab.data_ptr(), *shape, stream)
        check(rc == 0, f"iswm_fb_dgrad returned {rc}")

    def wgrad():
        rc = lib.iswm_fb_wgrad(x.data_ptr(), *ab, dy.data_ptr(), y.data_ptr(), ds.data_ptr(),
                               dq.data_ptr(), parts.data_ptr(), dw.data_ptr(), *shape, stream)
        check(rc == 0, f"iswm_fb_wgrad returned {rc}")

    return dgrad, wgrad


def _unfused_conv_chain(kind, shape, x, w, dy):
    """The unfused modules' work for the same conv, another function than the
    kernels' (BatchNorm after the conv, not before it; library kernels):
    (forward, backward) callables of conv + ``F.batch_norm`` (train) + ReLU."""
    F = torch.nn.functional
    if kind == "mm":
        m, k, n = shape
        xc = x.reshape(1, m, 1, k).permute(0, 3, 1, 2)
        wc = w.t().reshape(n, k, 1, 1).contiguous(memory_format=torch.channels_last)
        g, pad = dy.reshape(1, m, 1, n).permute(0, 3, 1, 2), 0
    else:
        n = shape[4]
        xc = x.permute(0, 3, 1, 2)
        wc = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        g, pad = dy.permute(0, 3, 1, 2), 1
    gamma = torch.ones(n, device="cuda", dtype=x.dtype)
    beta = torch.zeros(n, device="cuda", dtype=x.dtype)

    def forward(leaves=(xc, wc, gamma, beta)):
        xx, ww, ga, be = leaves
        return torch.relu(F.batch_norm(F.conv2d(xx, ww, None, 1, pad), None, None, ga, be,
                                       True, 0.0, 1e-5))

    leaves = [t.detach().requires_grad_() for t in (xc, wc, gamma, beta)]
    out = forward(leaves)
    return forward, lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def phase_block_kernels(fb) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("mm", s[:3], s[3], "random") for s in BLOCK_MM_SHAPES]
    cases += [("c3", s, True, "random") for s in BLOCK_C3_SHAPES]
    cases += [
        ("mm", (16 * 37, 64, 64), True, "random"),      # ragged M
        ("mm", (16 * 37, 64, 64), False, "random"),
        ("mm", (128, 64, 64), True, "random"),          # one tile
        ("mm", (256, 16, 32), True, "random"),          # channels below a tile
        ("mm", (2048, 128, 64), True, "negative"),      # relu(a x + b) = 0 everywhere
        ("mm", (2048, 128, 64), True, "no stats cotangent"),
        ("c3", (2, 16, 24, 8, 16), True, "random"),
        ("c3", (1, 5, 7, 16, 8), True, "random"),       # ragged in every direction
        ("c3", (2, 12, 12, 64, 64), True, "negative"),
        ("c3", (2, 12, 12, 64, 64), True, "no stats cotangent"),
        # C and N off the 64-deep stage, a 128-pixel block across two images,
        # ragged image edges; then C off the 128-wide dx tile
        ("c3", (3, 9, 11, 72, 40), True, "random"),
        ("c3", (2, 16, 16, 192, 128), True, "random"),
        # the bf16 forward's plans beyond the slice's: the 1x1 at 64 x 128 where
        # 128 x 128 would leave the card half idle, at N = 192 off the 128-wide
        # tile with C off the 64-deep stage, at 128 x 64 walking 2 column tiles
        # a block (the last block 1, M ragged), at 64 x 64 with M = 8192; the
        # 3x3 at 128 x 128 with N = 192 and C off the 32-deep stage, and at
        # 128 x 64 with C = 16
        ("mm", (4096, 128, 256), True, "random"),
        ("mm", (16384, 72, 192), True, "random"),
        ("mm", (65536 - 16 * 37, 64, 192), True, "random"),
        ("mm", (8192, 64, 64), False, "random"),
        ("c3", (4, 64, 64, 72, 192), True, "random"),
        ("c3", (2, 128, 128, 16, 64), True, "random"),
    ]
    names = ("mm_fwd", "mm_bwd", "c3_fwd", "c3_bwd")
    errs = dict.fromkeys(names, 0.0)
    tiles = {"mm": set(), "c3": set()}
    for kind, shape, prologue, what in cases:
        m, c, n = shape if kind == "mm" else (shape[0] * shape[1] * shape[2], *shape[3:])
        plan = fb.plan_fwd(m, c, n, 1 if kind == "mm" else 9, prologue)
        tiles[kind].add((plan["bm"], plan["bn"]))
        for dtype in (bf16, f32):
            x, w, a, b, dy, ds, dq = _fb_inputs(kind, shape, dtype, gen)
            if what == "negative":
                a, b = a.abs(), b - 100.0
            if what == "no stats cotangent":
                ds, dq = torch.zeros_like(ds), torch.zeros_like(dq)
            fwd, fwd_plain, bwd, bwd_plain = _fb_calls(fb, kind, prologue, x, w, a, b)
            label = f"{kind} {shape} prologue={prologue} {what} {str(dtype).split('.')[1]}"
            if dtype == bf16:
                label += f" (forward tile {plan['bm']}x{plan['bn']}, {plan['nt']} a block)"
            y, s, q = fwd()
            again = fwd()
            want_y = fwd_plain(torch.float64)[0]
            axes = tuple(range(y.ndim - 1))
            own = (y.double().sum(axes), (y.double() ** 2).sum(axes))
            torch.cuda.synchronize()
            check(all(torch.equal(u, v) for u, v in zip((y, s, q), again)),
                  f"fused block forward not bit-stable ({label})")
            worst, share = _rounding_error(y, want_y, dtype)
            check(y.dtype == dtype and worst <= 1.0,
                  f"fused block y ({label}): {worst:.3g} x the tolerance at its worst, "
                  f"{share:.2e} of the elements beyond it")
            e_fwd = float((y.double() - want_y.double()).abs().max())
            for got, ref, nm in ((s, own[0], "s"), (q, own[1], "q")):
                err, ok = _close(got, ref)
                check(ok, f"fused block {nm} ({label}): max abs err {err} vs the float64 sum "
                      f"over the kernel's own y")
                e_fwd = max(e_fwd, err)
            cot = (dy, ds, dq)
            got = bwd(y, cot)
            again = bwd(y, cot)
            want = bwd_plain(y, cot, torch.float64)
            torch.cuda.synchronize()
            check(all(torch.equal(u, v) for u, v in zip(got, again)),
                  f"fused block backward not bit-stable ({label})")
            worst_dx, share_dx = _rounding_error(got[0], want[0], dtype)
            check(got[0].dtype == dtype and worst_dx <= 1.0,
                  f"fused block dx ({label}): {worst_dx:.3g} x the tolerance at its worst, "
                  f"{share_dx:.2e} of the elements beyond it")
            # float32 sums of exact products in another order than float64's:
            # 1e-5 * max at float32; at bf16 the tensor cores' accumulation and
            # the float32 dz that da, db are summed from widen it (readings up
            # to 5.8e-6), so 5e-5 * max
            band = 5e-5 if dtype == bf16 else 1e-5
            e_bwd = float((got[0].double() - want[0].double()).abs().max())
            for g_, w_, nm in zip(got[1:], want[1:], ("dw", "da", "db")):
                err, ok = _close(g_, w_, band)
                check(g_.dtype == f32 and ok,
                      f"fused block {nm} ({label}): max abs err {err} vs float64 "
                      f"(limit {band} * max {float(w_.abs().max())})")
                e_bwd = max(e_bwd, err)
            if what == "negative":
                check(not any(bool(t.float().any()) for t in (y, s, q, *got)),
                      f"all-negative prologue ({label}): an output or a gradient is not 0")
            errs[f"{kind}_fwd"] = max(errs[f"{kind}_fwd"], e_fwd)
            errs[f"{kind}_bwd"] = max(errs[f"{kind}_bwd"], e_bwd)
            print(f"[12] fused block {label}: y {worst:.2f} and dx {worst_dx:.2f} x their "
                  f"tolerance (bf16: one ulp; f32: 1e-5 * max), none beyond; s, q within 1e-5 "
                  f"* max of float64 over the kernel's y; dw, da, db within {band} * max; "
                  f"max abs err fwd {e_fwd:.3e}, bwd {e_bwd:.3e}; all bit-stable"
                  + ("; every output and gradient 0" if what == "negative" else ""))
            del x, w, dy, y, again, want_y, got, want, own
    check(tiles == BLOCK_FWD_TILES,
          f"the bf16 forward's cases reached the tiles {tiles}, not all of {BLOCK_FWD_TILES}")

    # times at the slice's shapes in bf16, inputs out of L2, summed over a step
    cold = ColdTimer(reps=5)
    total = {k: {"ms": 0.0, "plain_ms": 0.0, "unfused_chain_ms": 0.0} for k in names}
    for key in ("mm_bwd", "c3_bwd"):
        total[key].update(dgrad_ms=0.0, wgrad_ms=0.0)
    bounds = {k: [] for k in names}
    lib, _ = fb.load_library()
    slice_cases = [("mm", s[:3], s[3], n) for s, n in BLOCK_MM_SHAPES.items()]
    slice_cases += [("c3", s, True, n) for s, n in BLOCK_C3_SHAPES.items()]
    for kind, shape, prologue, count in slice_cases:
        x, w, a, b, dy, ds, dq = _fb_inputs(kind, shape, bf16, gen)
        fwd, fwd_plain, bwd, bwd_plain = _fb_calls(fb, kind, prologue, x, w, a, b)
        y = fwd()[0]
        cot = (dy, ds, dq)
        chain_fwd, chain_bwd = _unfused_conv_chain(kind, shape, x, w, dy)
        times = {
            "fwd": (cold(fwd), cold(lambda: fwd_plain(f32)), cold(chain_fwd)),
            "bwd": (cold(lambda: bwd(y, cot)), cold(lambda: bwd_plain(y, cot, f32)),
                    cold(chain_bwd)),
        }
        least = dict(zip(("fwd", "bwd"), _fb_bound(kind, shape, prologue, 2)))
        flops = 2 * (shape[0] * shape[1] * shape[2] if kind == "mm"
                     else shape[0] * shape[1] * shape[2] * 9 * shape[3] * shape[4])
        # the backward's two C entries, each with its finish: each half does
        # the forward's operations and is printed beside the whole call's bound
        halves = [cold(f) for f in _bwd_halves(lib, kind, x, w, a, b, y, *cot, prologue)]
        for key, t in zip(("dgrad_ms", "wgrad_ms"), halves):
            total[f"{kind}_bwd"][key] += count * t
        print(f"[12] fused block {kind} bwd {shape} prologue={prologue} bf16 (x{count} a "
              f"step) halves, inputs out of L2: data gradient {halves[0]:.4f} ms "
              f"({flops / halves[0] / 1e9:.1f} TFLOP/s), weight gradient {halves[1]:.4f} "
              f"ms ({flops / halves[1] / 1e9:.1f} TFLOP/s), whole call {times['bwd'][0]:.4f} "
              f"ms; bound of the whole call {least['bwd']['bound_ms']:.4f} ms by "
              f"{least['bwd']['bound_by']}")
        for d in ("fwd", "bwd"):
            rec = total[f"{kind}_{d}"]
            for key, t in zip(("ms", "plain_ms", "unfused_chain_ms"), times[d]):
                rec[key] += count * t
            bounds[f"{kind}_{d}"] += [least[d]] * count
            mult = 1 if d == "fwd" else 2
            print(f"[12] fused block {kind} {d} {shape} prologue={prologue} bf16 (x{count} a "
                  f"step), inputs out of L2: device time kernel {times[d][0]:.4f} ms "
                  f"({mult * flops / times[d][0] / 1e9:.1f} TFLOP/s), plain {times[d][1]:.4f} "
                  f"ms, unfused chain (conv + F.batch_norm train + ReLU"
                  + ("" if d == "fwd" else ", autograd backward")
                  + f"; another function) {times[d][2]:.4f} ms; bound "
                  f"{least[d]['bound_ms']:.4f} ms by {least[d]['bound_by']}")
        del x, w, dy, y, chain_fwd, chain_bwd
    records = {}
    for key in names:
        least = sum_bounds(bounds[key])
        # no single PyTorch call computes conv + statistics + prologue
        records[key] = {"max_abs_err": errs[key], **total[key], **least, "library_ms": None,
                        "unfused_chain_of": "conv2d + batch_norm(train) + relu"
                        + ("" if key.endswith("fwd") else ", autograd backward")}
        halves = (f" (data gradient {total[key]['dgrad_ms']:.4f} ms, weight gradient "
                  f"{total[key]['wgrad_ms']:.4f} ms, each timed alone)" if key.endswith("bwd")
                  else "")
        print(f"[12] one train step's {len(bounds[key])} launches of {key}: kernel "
              f"{total[key]['ms']:.4f} ms{halves}, plain {total[key]['plain_ms']:.4f} ms, "
              f"unfused chain {total[key]['unfused_chain_ms']:.4f} ms, bound "
              f"{least['bound_ms']:.4f} ms by {least['bound_by']}")
    return records


def _bottleneck_f64(sd: dict, x: torch.Tensor, dout: torch.Tensor | None, eps: float,
                    momentum: float, masks=None, decisions=None) -> tuple:
    """A stride-1 Bottleneck's unfused arithmetic in float64 under autograd,
    from the block's state dict: conv -> batch statistics -> normalize ->
    ReLU, three times, the optional projection, add, ReLU.  Returns (output,
    dx, parameter gradients by key, running statistics by key after the
    update ``r = (1 - momentum) * r + momentum * batch``, biased variance);
    without ``dout``, no dx (None) and no gradients.  ``masks``: the three
    ReLUs' decisions to take (NCHW, 1 where a value passes) in the place of
    its own; ``decisions``, a list, gets its own."""
    F = torch.nn.functional
    p = {k: v.double().requires_grad_() for k, v in sd.items()
         if v.is_floating_point() and "running_" not in k}
    xin = x.double().requires_grad_()
    running = {}

    def conv_bn(t, conv, bn, pad):
        y = F.conv2d(t, p[conv + ".weight"], None, 1, pad)
        mean = y.mean((0, 2, 3), keepdim=True)
        var = y.var((0, 2, 3), unbiased=False, keepdim=True)
        for key, batch in (("running_mean", mean), ("running_var", var)):
            running[f"{bn}.{key}"] = ((1.0 - momentum) * sd[f"{bn}.{key}"].double()
                                      + momentum * batch.detach().reshape(-1))
        return ((y - mean) * torch.rsqrt(var + eps) * p[bn + ".weight"].view(1, -1, 1, 1)
                + p[bn + ".bias"].view(1, -1, 1, 1))

    def relu(t, i):
        if decisions is not None:
            decisions.append(t.detach() > 0)
        return torch.relu(t) if masks is None else t * masks[i].to(t.dtype)

    out = relu(conv_bn(xin, "conv1", "bn1", 0), 0)
    out = relu(conv_bn(out, "conv2", "bn2", 1), 1)
    out = conv_bn(out, "conv3", "bn3", 0)
    identity = (conv_bn(xin, "downsample.0", "downsample.1", 0)
                if "downsample.0.weight" in p else xin)
    out = relu(out + identity, 2)
    if dout is None:
        return out.detach(), None, {}, running
    grads = torch.autograd.grad(out, [xin, *p.values()], dout.double())
    return out.detach(), grads[0], dict(zip(p, grads[1:])), running


def _running(module) -> dict:
    return {k: v for k, v in module.state_dict().items() if "running_" in k}


def _block_stat_error(got: dict, want: dict) -> float:
    """Running statistics: the variance against max|var|, the mean against
    the largest spread sqrt(var) (a mean near 0 says nothing of scale)."""
    worst = 0.0
    for k, v in want.items():
        scale = v.abs().max() if "var" in k else want[k.replace("mean", "var")].sqrt().max()
        worst = max(worst, float((got[k] - v).abs().max() / scale))
    return worst


def _block_replay(block, state: dict, xin: torch.Tensor, dtype) -> tuple:
    """``block``'s fused forward replayed from ``state`` on ``xin``, and the
    block's unfused BatchNorm modules fed that replay's own conv outputs:
    (the replay's running statistics, the modules', the replay's ReLU
    decisions).  The decisions are NCHW booleans of the three ReLUs, as the
    fused kernels and the block's glue take them: ``a * y + b > 0`` in
    float32 in the two prologues, the output above 0."""
    from iswm_tpu_torch.models import fused_block as fbm

    fused, plain = copy.deepcopy(block), copy.deepcopy(block)
    for m in (fused, plain):
        m.load_state_dict(state)
        m.train()
    ys, inputs, kernels = [], [], (fbm.matmul_bn_stats, fbm.conv3x3_bn_stats)

    def recording(kernel):
        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            ys.append(out[0])
            inputs.append(args)
            return out
        return call

    fbm.matmul_bn_stats, fbm.conv3x3_bn_stats = map(recording, kernels)
    try:
        with torch.no_grad():
            result = fbm.fused_bottleneck_apply(fused, xin.to(dtype))
    finally:
        fbm.matmul_bn_stats, fbm.conv3x3_bn_stats = kernels
    # fused_bottleneck_apply's order: conv1, conv2, conv3, the projection
    bns = [plain.bn1, plain.bn2, plain.bn3]
    if plain.downsample is not None:
        bns.append(plain.downsample[1])
    check(len(ys) == len(bns), f"{len(ys)} fused convs for {len(bns)} BatchNorms")
    b, _, h, w = xin.shape
    with torch.no_grad():
        for bn, y_conv in zip(bns, ys):
            bn(y_conv.reshape(b, h, w, -1).permute(0, 3, 1, 2))
    # conv2's prologue takes (y1, a1, b1, w), conv3's (y2, w, a2, b2)
    (y1, a1, b1, _), (y2, _, a2, b2) = inputs[1], inputs[2]
    decisions = [(t.float() * a + c > 0).reshape(b, h, w, -1).permute(0, 3, 1, 2)
                 for t, a, c in ((y1, a1, b1), (y2, a2, b2))]
    return _running(fused), _running(plain), decisions + [result > 0]


def _hold_blocks(model, blocks: dict, cfg, x, y, start: dict, dtypes,
                 readings: list | None = None) -> list:
    """Phase 13's hold of one block of each kind against the unfused modules'
    autograd and the block in float64, in each of ``dtypes``, on the fused
    step's own input, parameters and output cotangent (a whole step fused
    against unfused is chaotic on this model: printed, not held).  ``blocks``
    maps names to the model's Bottlenecks, ``start`` is the state the steps
    start from, (x, y) the batch.  Prints a line a block and dtype; returns
    the lines of the blocks that failed.  ``readings``, where given, gets the
    float32 distances of each block."""
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

    def set_mode(mode):
        for m in blocks.values():
            m.fused_mode = mode

    # The reference runs without TF32, so that float32 can be held tightly.
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    factory, _ = make_optimizer(cfg.optim, cfg.train.total_itrs)
    step = make_train_step(make_loss_fn(cfg.loss.loss_type, fused="auto", device="cuda"))
    held = ("layer1.0", "layer2.1", "layer4.0")

    def one_step(mode, grab=()):
        set_mode(mode)
        model.load_state_dict(start)
        state = TrainState(model, *factory(model.parameters()), 0)
        torch.cuda.manual_seed(SEED)
        seen, handles = {}, []
        for name in grab:
            def pre(mod, args, name=name):
                seen[name + ".x"] = args[0].detach()
                if args[0].requires_grad:
                    args[0].register_hook(
                        lambda g, name=name: seen.__setitem__(name + ".dx", g.detach().clone()))

            def post(mod, args, out, name=name):
                seen[name + ".out"] = out.detach()
                out.register_hook(
                    lambda g, name=name: seen.__setitem__(name + ".dout", g.detach().clone()))
            handles += [blocks[name].register_forward_pre_hook(pre),
                        blocks[name].register_forward_hook(post)]
        with warnings.catch_warnings():  # ops without a deterministic version
            warnings.simplefilter("ignore")
            loss = float(step(state, x, y))
        for h in handles:
            h.remove()
        grads = {k: p.grad.float().clone() for k, p in model.named_parameters()}
        buffers = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
        return loss, grads, buffers, seen

    def ratio(got, want):
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max().clamp_min(1e-30))

    def mean_ratio(got, want):
        """mean |got - want| / mean |want|: for dx, whose largest difference is
        one element whose ReLU decision went the other way (as large as dx)."""
        return float((got.double() - want.double()).abs().mean()
                     / want.double().abs().mean().clamp_min(1e-30))

    def run_unfused(name, xin, dout, dtype):
        """The unfused modules of block ``name`` in ``dtype`` on the given
        input and cotangent, from the ``start`` parameters: (output, dx,
        parameter gradients, running statistics)."""
        prefix = f"backbone.{name}."
        ref = copy.deepcopy(blocks[name])
        ref.fused_mode = "never"
        ref.load_state_dict({k[len(prefix):]: v for k, v in start.items()
                             if k.startswith(prefix)})
        ref.train()
        xin = xin.to(dtype).clone().requires_grad_()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = ref(xin)
            out.backward(dout.to(dtype))
        return (out.detach(), xin.grad, {k: p.grad for k, p in ref.named_parameters()},
                _running(ref))

    # Limits.  The gradients of this model, four steps from random weights, are
    # residues of large cancelling sums (a BatchNorm follows every conv), so the
    # unfused library modules in the same dtype are no reference: in bf16 they
    # lie as far from the exact result as the fused block does (0.03 to 0.6 *
    # max|tensor|).  Both are therefore held against the block's arithmetic in
    # float64 on the same input and cotangent, over every parameter gradient
    # (max |difference| / max |gradient|) and dx (mean |difference| / mean |dx|:
    # its largest difference is one flipped ReLU decision, as large as dx
    # itself).  bf16: the fused block's worst tensor may be
    # ``BLOCK_SLACK_WORST`` times as far from float64 as the unfused modules'
    # worst (TF32 off), its median tensor ``BLOCK_SLACK_MEDIAN`` times as far as
    # their median (readings 0.9-1.8 and 1.0-1.3; a single tensor's distance
    # varies tenfold between two realisations of the rounding, and the fused
    # backward rounds twice per conv, dx and then dyt, where the unfused
    # BatchNorm rounds once, as in the JAX package).  float32: every tensor
    # within ``BLOCK_F32_LIMIT`` of the float64 block that takes the fused
    # block's own ReLU decisions (``_block_replay``'s masks; readings 3.5e-6 to
    # 3.4e-5 over 27 blocks from 9 training starts, ``--block-f32-starts 8``; a
    # wrong term shows as 0.3 or more).  Making its own decisions, float64 sends
    # 2 to 13 pre-activations a block within float32 rounding of 0 the other
    # way, and each such pixel moves a gradient by its share, whatever float32
    # arithmetic computed it: the fused block reads up to 2.0e-2 there and the
    # unfused modules 1.9e-2 (one run read 7.7e-2), so that distance is printed,
    # not held.  The output has a limit of its own.  Running statistics: the
    # fused block's are held in both dtypes at ``stat_tol`` against the unfused
    # BatchNorm modules fed the fused convs' own outputs (a replay of the block
    # from ``start``, which must give the step's statistics bit for bit): the
    # statistics arithmetic that the fused path owns.  Against the whole unfused
    # modules, whose convs round differently, they are held at ``stat_tol`` in
    # float32; in bf16 that gap is printed and the statistics are held against
    # float64 like a gradient: no farther than ``BLOCK_SLACK_WORST`` times the
    # unfused modules' distance.  (bf16 readings over 16 training starts and 7
    # blocks: the gap to the whole modules has median 2.1e-6 and a tail to
    # 1.4e-4, one run read 2.4e-4, while both sides lie 3e-4 to 1.6e-3 from
    # float64, equal there to three digits.) See PERF.md for the readings.
    failures = []
    for dtype, out_tol, stat_tol in ((torch.bfloat16, 2e-2, 1e-4), (torch.float32, 1e-4, 1e-5)):
        if dtype not in dtypes:
            continue
        model.compute_dtype = dtype
        loss_k, g_k, buf_k, seen = one_step("always", held)
        loss_p, g_p, _, _ = one_step("never")
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        for name in held:
            prefix = f"backbone.{name}."
            xin, dout = seen[name + ".x"], seen[name + ".dout"]
            fused = (seen[name + ".out"], seen[name + ".dx"],
                     {k[len(prefix):]: v for k, v in g_k.items() if k.startswith(prefix)},
                     {k[len(prefix):]: v for k, v in buf_k.items() if k.startswith(prefix)})
            unfused = run_unfused(name, xin, dout, dtype)
            sd = {k[len(prefix):]: v for k, v in start.items() if k.startswith(prefix)}
            eps, momentum = blocks[name].bn1.eps, blocks[name].bn1.momentum
            own_decisions = []
            truth = _bottleneck_f64(sd, xin, dout, eps, momentum, decisions=own_decisions)
            rows = {label: {"output": ratio(got[0], truth[0]), "dx": mean_ratio(got[1], truth[1]),
                            **{k: ratio(got[2][k], truth[2][k]) for k in truth[2]}}
                    for label, got in (("fused", fused), ("unfused", unfused))}
            replay, own, masks = _block_replay(blocks[name], sd, xin, dtype)
            replayed = all(torch.equal(fused[3][k], v) for k, v in replay.items())
            stats_own = _block_stat_error(fused[3], own)
            stats = _block_stat_error(fused[3], unfused[3])
            stats_far = {label: _block_stat_error(got[3], truth[3])
                         for label, got in (("fused", fused), ("unfused", unfused))}
            keys = [k for k in rows["fused"] if k != "output"]
            floor = BLOCK_FLOOR[dtype]
            far = {label: sorted(rows[label][k] for k in keys) for label in rows}
            worst = far["fused"][-1] / max(far["unfused"][-1], floor)
            median = far["fused"][len(keys) // 2] / max(far["unfused"][len(keys) // 2], floor)
            ok = (rows["fused"]["output"] <= out_tol and replayed and stats_own <= stat_tol)
            if dtype == torch.float32:
                decided = _bottleneck_f64(sd, xin, dout, eps, momentum, masks=masks)
                near = {"dx": mean_ratio(fused[1], decided[1]),
                        **{k: ratio(fused[2][k], decided[2][k]) for k in decided[2]}}
                nearest = sorted(near, key=near.get)
                flips = [int((m != d).sum()) for m, d in zip(masks, own_decisions)]
                ok = ok and stats <= stat_tol and near[nearest[-1]] <= BLOCK_F32_LIMIT
                if readings is not None:  # with the float64 batch statistics' mean / std
                    batch = {k: (v - (1.0 - momentum) * sd[k].double()) / momentum
                             for k, v in truth[3].items()}
                    spread = max(float((batch[k].abs() / (batch[k.replace("mean", "var")]
                                                          + eps).sqrt()).max())
                                 for k in batch if k.endswith("running_mean"))
                    readings.append({"block": name, "mean_over_std": spread,
                                     "decided_worst": near[nearest[-1]],
                                     "decided_median": near[nearest[len(near) // 2]],
                                     "worst": far["fused"][-1], "unfused_worst": far["unfused"][-1],
                                     "flips": flips})
            else:
                ok = (ok and stats_far["fused"] <= BLOCK_SLACK_WORST * stats_far["unfused"]
                      and worst <= BLOCK_SLACK_WORST and median <= BLOCK_SLACK_MEDIAN)
            text = (f"{dtype} {name}, on the fused step's own input, parameters and cotangent, "
                    f"against the block in float64: fused output {rows['fused']['output']:.2e} "
                    f"(limit {out_tol}; unfused {rows['unfused']['output']:.2e}), running "
                    f"statistics: a replay of the fused block from the start "
                    f"{'equals' if replayed else 'DIFFERS FROM'} the step's, fused vs the unfused "
                    f"BatchNorms on the fused convs' outputs {stats_own:.2e} (limit {stat_tol}), "
                    f"fused vs the unfused modules {stats:.2e}"
                    + (f" (limit {stat_tol})" if dtype == torch.float32 else
                       f" (printed), from float64 fused {stats_far['fused']:.2e}, unfused "
                       f"{stats_far['unfused']:.2e} (limit {BLOCK_SLACK_WORST} x)")
                    + ", dx (mean |difference| / mean |dx|) and gradients (max |difference| / "
                    f"max |gradient|), fused (unfused): "
                    + ", ".join(f"{k} {rows['fused'][k]:.2e} ({rows['unfused'][k]:.2e})"
                                for k in keys)
                    + f"; the fused block's worst tensor {far['fused'][-1]:.2e}"
                    + f", {worst:.3g} x as far as the unfused modules' worst, its median "
                    f"tensor {median:.3g} x as far as their median"
                    + (f" (printed); against the float64 block taking the fused block's "
                       f"ReLU decisions ({flips[0]}, {flips[1]} and {flips[2]} of relu1, relu2 "
                       f"and the output's differ from its own), dx {near['dx']:.2e}, its worst "
                       f"tensor {nearest[-1]} {near[nearest[-1]]:.2e} (limit {BLOCK_F32_LIMIT}),"
                       f" its median {near[nearest[len(near) // 2]]:.2e}"
                       if dtype == torch.float32 else
                       f" (limits {BLOCK_SLACK_WORST} and {BLOCK_SLACK_MEDIAN}; an unfused "
                       f"distance counts as at least {floor})"))
            print("[13] " + text)
            if not ok:
                failures.append(text)
            del fused, unfused, truth, replay, own, masks, own_decisions
        torch.backends.cudnn.allow_tf32 = tf32
        rel = abs(loss_k - loss_p) / abs(loss_p)
        ratios = sorted(ratio(g_k[k], g_p[k]) for k in g_p)
        print(f"[13] one whole step fused vs fused_blocks='never', {dtype} (not held: the "
              f"step is chaotic in its forward): loss {loss_k:.6f} vs {loss_p:.6f} (rel "
              f"{rel:.2e}); parameter gradients, median tensor of {len(ratios)} "
              f"{ratios[len(ratios) // 2]:.2e}, worst {ratios[-1]:.2e} * max|grad|")
        check(np.isfinite(loss_k), f"{dtype}: fused step loss {loss_k}")
        del seen, g_k, g_p, buf_k
    return failures


def _kernel_class(name: str) -> str:
    low = name.lower()
    if any(k in name for k in BLOCK_KERNELS):
        return "fused block kernels"
    if "batch_norm" in low or "bn_fw" in low or "bn_bw" in low or "batchnorm" in low:
        return "BN"
    if any(k in low for k in ("cudnn", "cutlass", "gemm", "xmma", "conv", "nchwtonhwc",
                              "nhwctonchw", "wgrad", "dgrad", "cublas")):
        return "convs"
    if "elementwise" in low or "vectorized" in low or "reduce_kernel" in low:
        return "elementwise"
    return "other"


def phase_block_slice(fb, ce) -> tuple:
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import augment_batch, batch_iterator
    from iswm_tpu_torch.models import build_model
    from iswm_tpu_torch.models.fused_block import fused_block_eligible
    from iswm_tpu_torch.models.resnet import Bottleneck

    trainer, cfg, train_ds, val_ds = _fused_trainer("fused_blocks", BLOCK_STEPS)
    model = trainer.state.model
    blocks = {name: m for name, m in model.backbone.named_modules()
              if isinstance(m, Bottleneck)}

    def set_mode(mode):
        for m in blocks.values():
            m.fused_mode = mode

    def counts():
        return read_counters(fb, BLOCK_COUNTERS)

    zero_counters(fb, BLOCK_COUNTERS)
    ce.launches_fwd = ce.launches_bwd = 0
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = counts()
    per_step = (sum(BLOCK_MM_SHAPES.values()), sum(BLOCK_C3_SHAPES.values())) * 2
    check(launches == tuple(BLOCK_STEPS * n for n in per_step),
          f"fused block launches (1x1 fwd, 3x3 fwd, 1x1 bwd, 3x3 bwd) {launches} in "
          f"{BLOCK_STEPS} steps, a quick-eval and a validation; expected {per_step} per train "
          f"step and none in evaluation")
    check((ce.launches_fwd, ce.launches_bwd) == (BLOCK_STEPS, BLOCK_STEPS),
          f"fused CE launches {(ce.launches_fwd, ce.launches_bwd)} in {BLOCK_STEPS} steps")
    losses = trainer.logger.history["train_loss"]
    check(len(losses) == 2 and all(np.isfinite(losses)), f"logged losses {losses}")
    check(trainer.best_path is not None, "no best checkpoint was written")
    payload = torch.load(trainer.best_path, map_location="cpu", weights_only=True)
    unfused_cfg = Config().model
    check(unfused_cfg.fused_blocks == "never", "fused_blocks does not default to 'never'")
    build_model(unfused_cfg).load_state_dict(payload["model_state"], strict=True)
    print(f"[13] training with fused_blocks='always': {BLOCK_STEPS} steps + 1 quick-eval + 1 "
          f"validation in {fit_s:.2f} s; launches 1x1 fwd {launches[0]}, 3x3 fwd {launches[1]}, "
          f"1x1 bwd {launches[2]}, 3x3 bwd {launches[3]} ({per_step} per step, 0 in "
          f"evaluation); losses {[round(v, 4) for v in losses]}; "
          f"{Path(trainer.best_path).name} loads strict=True into an unfused model")

    images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
    x, y = augment_batch(torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda(),
                         trainer.augment, torch.Generator(device="cuda").manual_seed(SEED))
    start, trained_dtype = copy.deepcopy(model.state_dict()), model.compute_dtype
    failures = _hold_blocks(model, blocks, cfg, x, y, start,
                            (torch.bfloat16, torch.float32))
    check(not failures, "; ".join(failures))
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    model.compute_dtype = trained_dtype
    model.load_state_dict(start)

    smi = _smi()
    xu8, yu8 = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    # the shapes the gate passes, against the tables phase 12 timed
    seen_mm, seen_c3, handles = {}, {}, []

    def note(mod, args):
        b, c, h, w = args[0].shape
        if not (mod.training and mod.fuses_on(args[0].device)
                and fused_block_eligible(args[0].shape)):
            return
        p, rows = mod.conv1.out_channels, b * h * w
        keys = [(rows, c, p, False), (rows, p, 4 * p, True)]
        if mod.downsample is not None:
            keys.append((rows, c, 4 * p, False))
        for key in keys:
            seen_mm[key] = seen_mm.get(key, 0) + 1
        seen_c3[(b, h, w, p, p)] = seen_c3.get((b, h, w, p, p), 0) + 1

    set_mode("always")
    handles = [m.register_forward_pre_hook(note) for m in blocks.values()]
    trainer.train_step(trainer.state, xu8, yu8)
    for h in handles:
        h.remove()
    check(seen_mm == BLOCK_MM_SHAPES and seen_c3 == BLOCK_C3_SHAPES,
          f"the gate passes {seen_mm} and {seen_c3}, phase 12 timed {BLOCK_MM_SHAPES} and "
          f"{BLOCK_C3_SHAPES}")
    step_ms, peak = {}, {}
    for mode in ("never", "always", "always", "never"):
        set_mode(mode)
        times = []
        for i in range(11):
            if i == 3:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, xu8, yu8)
            torch.cuda.synchronize()
            if i >= 3:  # after warm-up
                times.append(time.perf_counter() - t0)
        peak[mode] = torch.cuda.max_memory_allocated() / 2**20
        step_ms.setdefault(mode, []).extend(times)
    never, always = (float(np.median(step_ms[m])) * 1e3 for m in ("never", "always"))
    rounds = {m: [round(float(np.median(step_ms[m][i:i + 8])) * 1e3, 2) for i in (0, 8)]
              for m in step_ms}
    print(f"[13] {smi}: train step, batch 8 at 512^2, median of {len(step_ms['never'])} each "
          f"(never, always, always, never): fused_blocks='never' {never:.2f} ms, 'always' "
          f"{always:.2f} ms (by round of 8: never {rounds['never']}, always "
          f"{rounds['always']}); torch.cuda.max_memory_allocated over the steps: 'never' "
          f"{peak['never']:.0f} MiB, 'always' {peak['always']:.0f} MiB")
    for mode in ("never", "always"):
        set_mode(mode)
        records = traced_records(lambda: trainer.train_step(trainer.state, xu8, yu8), 3, 1)
        by_class, n_launches = {}, 0
        for name, (us, n) in records.items():
            cls = _kernel_class(name)
            by_class[cls] = by_class.get(cls, 0.0) + us * n / 1e3
            n_launches += n
        total_ms = sum(by_class.values())
        if mode == "always":
            ours = [k for k in records if any(n in k for n in BLOCK_KERNELS)]
            check(len(ours) >= 4, f"the trace of a fused step names {sorted(ours)}")
            # the bf16 forwards and the 3x3 backward run the pipelined kernels,
            # never the first body
            first = [k for k in ours if any(f"::{body}<__nv_bfloat16" in k
                                            for body in ("conv_fwd", "conv_dgrad", "conv_wgrad"))]
            piped = {label: sum(c for k, (_, c) in records.items() if any(n in k for n in names))
                     for label, names in (("1x1 forward", ("::fwd_1x1_bf16<",)),
                                          ("3x3 forward", ("::fwd_3x3_bf16<",)),
                                          ("3x3 data gradient", ("::dgrad_3x3_bf16<",)),
                                          ("3x3 weight gradient", ("::wgrad_3x3_bf16<",)))}
            check(not first and all(piped.values()),
                  f"a fused step's bf16 forwards and 3x3 backward: {piped} launches of the "
                  f"pipelined kernels, first-body kernels {first}")
            print(f"[13] the bf16 forwards and 3x3 backward in a fused step's trace: launches "
                  + ", ".join(f"{label} {c}" for label, c in piped.items())
                  + f" (the wrapper counts {sum(BLOCK_MM_SHAPES.values())} 1x1 and "
                  f"{sum(BLOCK_C3_SHAPES.values())} 3x3 calls a step); no first-body bf16 "
                  f"conv_fwd / conv_dgrad / conv_wgrad")
        print(f"[13] {smi}: one step with fused_blocks='{mode}' (profiler, per-kernel means): "
              f"device time {total_ms:.2f} ms in {n_launches:.0f} kernel launches; by class: "
              + ", ".join(f"{c} {t:.2f} ms ({100 * t / total_ms:.1f}%)"
                          for c, t in sorted(by_class.items(), key=lambda kv: -kv[1])))
    set_mode("always")
    return launches


# ------------------------------------------------------------ data parallel
DP_STEPS = 4  # phase 15's Trainer: a quick-eval at step 2 and the validation at 4
DP_RANKS = 2  # the 2-rank parts: gloo, both ranks on cuda:0 (NCCL takes one rank a card)
CE_SLICE = (8, 512, 512)
CE_WEIGHTS = (1.0, 3.2)
DP_SLACK = 5  # phase 15: the 2-rank step's gradients against the nudged step's
RENDEZVOUS = TRAIN_OUT.with_name("chip_smoke_rendezvous")  # the groups' rendezvous files


def _rendezvous(name: str) -> Path:
    RENDEZVOUS.mkdir(parents=True, exist_ok=True)
    path = RENDEZVOUS / name
    path.unlink(missing_ok=True)
    return path


def _open_group(name: str) -> None:
    """The 1-rank nccl group of phases 14 and 15 on cuda:0, through a
    rendezvous file (no port, no network)."""
    import torch.distributed as dist

    from iswm_tpu_torch.parallel import maybe_initialize_distributed

    rendezvous = _rendezvous(name)
    check(maybe_initialize_distributed(f"file://{rendezvous}", 0, 1, device="cuda:0"),
          "the 1-rank process group did not open")
    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, expected nccl")


def _spawn_ranks(fn, out: Path) -> list:
    """Run ``fn(rank, DP_RANKS, rendezvous, out)`` in DP_RANKS spawned
    processes and return what each saved (``out/<fn>.<rank>.pt``); a rank that
    raises or hangs fails the phase."""
    rendezvous = _rendezvous(f"{fn.__name__}.gloo")
    context = torch.multiprocessing.start_processes(
        fn, args=(DP_RANKS, str(rendezvous), str(out)), nprocs=DP_RANKS, join=False,
        start_method="spawn")
    deadline = time.monotonic() + 600
    while not context.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in context.processes:
                p.kill()
            raise SmokeFailure(f"the ranks of {fn.__name__} did not finish in 600 s")
    return [torch.load(out / f"{fn.__name__}.{r}.pt", weights_only=False)
            for r in range(DP_RANKS)]


def _join_gloo(rank: int, ranks: int, rendezvous: str) -> None:
    """In a spawned rank: a gloo group whose ranks share cuda:0."""
    from iswm_tpu_torch.parallel import maybe_initialize_distributed

    maybe_initialize_distributed(f"file://{rendezvous}", rank, ranks, device="cuda:0",
                                 backend="gloo")


def _ce_inputs(gen):
    """Phase 14's slice logits in bf16 (channels last) and f32, in that order."""
    return [(dtype, *_ce_case(CE_SLICE, dtype, gen, channels_last=dtype == torch.bfloat16))
            for dtype in (torch.bfloat16, torch.float32)]


def _loss_and_grad(fn, logits, labels, cw):
    leaf = logits.detach().requires_grad_()
    loss = fn(leaf, labels, cw)
    return loss.detach(), torch.autograd.grad(loss, leaf)[0]


def _rank_sharded_ce(rank: int, ranks: int, rendezvous: str, out: str) -> None:
    """Phase 14 in a spawned rank: the sharded CE on this rank's rows."""
    from iswm_tpu_torch.ops.kernels import fused_ce as ce
    from iswm_tpu_torch.parallel import destroy

    _join_gloo(rank, ranks, rendezvous)
    try:
        cw = torch.tensor(CE_WEIGHTS, device="cuda")
        rows = slice(rank * CE_SLICE[0] // ranks, (rank + 1) * CE_SLICE[0] // ranks)
        seen = {}
        for dtype, logits, labels in _ce_inputs(torch.Generator("cuda").manual_seed(SEED + 1)):
            loss, d = _loss_and_grad(ce.make_sharded_fused_ce(), logits[rows], labels[rows], cw)
            seen[str(dtype)] = (loss.item(), d.cpu())
        seen["launches"] = (ce.launches_fwd, ce.launches_bwd, ce.launches_sharded)
    finally:
        destroy()
    torch.save(seen, Path(out) / f"_rank_sharded_ce.{rank}.pt")


def _within_tolerance(got, want, dtype) -> tuple:
    """(max abs diff, ok, tolerance) of d_logits: 1 bf16 ulp, or 1e-6 * max."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        return float(diff.max()), bool((diff <= _bf16_ulp(want)).all()), "1 bf16 ulp"
    return (float(diff.max()), float(diff.max()) <= 1e-6 * float(want.float().abs().max()),
            "1e-6 * max|d_logits|")


def block_stat_readings(starts: int) -> None:
    """Phase 13's running-statistics comparisons in bf16 from ``starts``
    training starts (phase 13's fused Trainer with ``train.random_seed`` 1 to
    ``starts``, ``BLOCK_STEPS`` steps each), at every block that a step
    fuses: the fused block's statistics against the whole unfused modules'
    and against the unfused BatchNorms fed the fused convs' own outputs, and
    each side's distance from the block's float64 arithmetic.  One line a
    block and start, then a summary; holds nothing but the replay.
    ``python3 chip_smoke.py --block-stat-starts 16``."""
    from iswm_tpu_torch.data import augment_batch, batch_iterator
    from iswm_tpu_torch.models.fused_block import fused_block_eligible
    from iswm_tpu_torch.models.resnet import Bottleneck
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

    rows = []
    for seed in range(1, starts + 1):
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = True, False
        torch.use_deterministic_algorithms(False)
        trainer, cfg, train_ds, _ = _fused_trainer("fused_blocks", BLOCK_STEPS, seed)
        trainer.fit()
        model = trainer.state.model
        blocks = {n: m for n, m in model.backbone.named_modules() if isinstance(m, Bottleneck)}
        images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
        x, y = augment_batch(torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda(),
                             trainer.augment, torch.Generator(device="cuda").manual_seed(SEED))
        start = copy.deepcopy(model.state_dict())
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        factory, _ = make_optimizer(cfg.optim, cfg.train.total_itrs)
        step = make_train_step(make_loss_fn(cfg.loss.loss_type, fused="auto", device="cuda"))
        model.compute_dtype = torch.bfloat16
        state = TrainState(model, *factory(model.parameters()), 0)
        seen = {}
        handles = [m.register_forward_pre_hook(
            lambda mod, args, name=name: seen.__setitem__(name, args[0].detach())
            if mod.fuses_on(args[0].device) and fused_block_eligible(args[0].shape) else None)
            for name, m in blocks.items()]
        torch.cuda.manual_seed(SEED)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            step(state, x, y)
        for h in handles:
            h.remove()
        after = _running(model)
        for name, xin in seen.items():
            prefix = f"backbone.{name}."
            sd = {k[len(prefix):]: v for k, v in start.items() if k.startswith(prefix)}
            fused = {k[len(prefix):]: v for k, v in after.items() if k.startswith(prefix)}
            ref = copy.deepcopy(blocks[name])
            ref.fused_mode = "never"
            ref.load_state_dict(sd)
            with torch.no_grad(), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ref(xin)
            truth = _bottleneck_f64(sd, xin, None, ref.bn1.eps, ref.bn1.momentum)[3]
            replay, own, _ = _block_replay(blocks[name], sd, xin, torch.bfloat16)
            row = {"gap": _block_stat_error(fused, _running(ref)),
                   "own": _block_stat_error(fused, own),
                   "fused_far": _block_stat_error(fused, truth),
                   "unfused_far": _block_stat_error(_running(ref), truth),
                   "replayed": all(torch.equal(fused[k], v) for k, v in replay.items())}
            rows.append(row)
            print(f"[stats] start {seed} {name}: fused vs unfused modules {row['gap']:.3g}, "
                  f"vs the unfused BatchNorms on the fused convs' outputs {row['own']:.3g}; "
                  f"from float64 fused {row['fused_far']:.3g}, unfused {row['unfused_far']:.3g}; "
                  f"replay {'equal' if row['replayed'] else 'DIFFERS'}", flush=True)
        del trainer, model, blocks, start, seen, after
        torch.cuda.empty_cache()
    gaps = sorted(r["gap"] for r in rows)
    ratios = sorted(r["fused_far"] / r["unfused_far"] for r in rows)
    far = sorted(r["unfused_far"] for r in rows)
    print(f"[stats] {len(rows)} block readings from {starts} starts, bf16: fused vs the unfused "
          f"modules median {gaps[len(gaps) // 2]:.3g}, 90th percentile "
          f"{gaps[int(0.9 * (len(gaps) - 1))]:.3g}, max {gaps[-1]:.3g}; vs the unfused "
          f"BatchNorms on the fused convs' outputs max {max(r['own'] for r in rows):.3g}; the "
          f"unfused modules from float64 {far[0]:.3g} to {far[-1]:.3g}, the fused block "
          f"{ratios[0]:.4f} to {ratios[-1]:.4f} x as far; replays equal "
          f"{sum(r['replayed'] for r in rows)} of {len(rows)}")
    check(all(r["replayed"] for r in rows), "a replay of a fused block differs from its step")


def block_f32_readings(starts: int) -> None:
    """Phase 13's float32 holds (``_hold_blocks``) from phase 13's own training
    start and ``train.random_seed`` 1 to ``starts``, ``BLOCK_STEPS`` steps
    each: the phase's line a block and start, then a summary of the fused
    block's distance from float64 with float64's own ReLU decisions and with
    the fused block's, and of the decisions that differ.  Holds nothing.
    ``python3 chip_smoke.py --block-f32-starts 8``."""
    from iswm_tpu_torch.data import augment_batch, batch_iterator
    from iswm_tpu_torch.models.resnet import Bottleneck

    readings = []
    for seed in (None, *range(1, starts + 1)):
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = True, False
        torch.use_deterministic_algorithms(False)
        trainer, cfg, train_ds, _ = _fused_trainer("fused_blocks", BLOCK_STEPS, seed)
        trainer.fit()
        model = trainer.state.model
        blocks = {n: m for n, m in model.backbone.named_modules() if isinstance(m, Bottleneck)}
        images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
        x, y = augment_batch(torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda(),
                             trainer.augment, torch.Generator(device="cuda").manual_seed(SEED))
        start = copy.deepcopy(model.state_dict())
        failed = _hold_blocks(model, blocks, cfg, x, y, start, (torch.float32,), readings)
        print(f"[f32] start seed={seed}: {len(failed)} of the held blocks beyond phase 13's "
              f"limits")
        del trainer, model, blocks, start
        torch.cuda.empty_cache()
    worst = sorted(r["worst"] for r in readings)
    decided = sorted(r["decided_worst"] for r in readings)
    flips = [sum(r["flips"]) for r in readings]
    print(f"[f32] the BatchNorms' largest |batch mean| / std over the held blocks "
          f"{min(r['mean_over_std'] for r in readings):.3g} to "
          f"{max(r['mean_over_std'] for r in readings):.3g}")
    print(f"[f32] {len(readings)} block readings from {starts + 1} starts: the fused block's "
          f"worst tensor from float64 with its own ReLU decisions median "
          f"{worst[len(worst) // 2]:.3g}, max {worst[-1]:.3g} (the unfused modules' max "
          f"{max(r['unfused_worst'] for r in readings):.3g}); with the fused block's decisions "
          f"median {decided[len(decided) // 2]:.3g}, max {decided[-1]:.3g} (limit "
          f"{BLOCK_F32_LIMIT}); decisions that differ a block {min(flips)} to {max(flips)}")


def phase_sharded_ce(ce) -> dict:
    import torch.distributed as dist

    from iswm_tpu_torch.parallel import destroy

    out = TRAIN_OUT.with_name("chip_smoke_sharded_ce")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    _open_group("phase14.nccl")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cw = torch.tensor(CE_WEIGHTS, device="cuda")
    sharded = ce.make_sharded_fused_ce()
    err = 0.0
    for name, dtype, kw in (("bf16 channels-last", torch.bfloat16, {"channels_last": True}),
                            ("f32 NCHW", torch.float32, {}),
                            ("all ignored bf16", torch.bfloat16, {"all_ignored": True})):
        logits, labels = _ce_case(CE_SLICE, dtype, gen, **kw)
        loss_s, d_s = _loss_and_grad(sharded, logits, labels, cw)
        loss_u, d_u = _loss_and_grad(ce.fused_binary_ce, logits, labels, cw)
        loss_p, d_p = _loss_and_grad(ce.sharded_fused_binary_ce_plain, logits, labels, cw)
        sums = ce.fused_binary_ce_fwd(logits, labels, cw)
        reduced = sums.clone()
        dist.all_reduce(reduced)
        check(torch.equal(reduced, sums) and torch.equal(loss_s, loss_u)
              and torch.equal(d_s, d_u),
              f"1-rank sharded CE ({name}) not bit-equal to the unsharded kernel: sums "
              f"{reduced.tolist()} vs {sums.tolist()}, loss {loss_s.item()} vs {loss_u.item()}, "
              f"d_logits max diff {float((d_s.float() - d_u.float()).abs().max())}")
        rel = abs(loss_s.item() - loss_p.item()) / max(abs(loss_p.item()), 1e-30)
        diff, ok, tol = _within_tolerance(d_s, d_p, dtype)
        if kw.get("all_ignored"):
            ok = ok and loss_s.item() == 0.0 and not d_s.float().any()
        check((rel <= 1e-5 or loss_s.item() == loss_p.item()) and ok,
              f"sharded CE ({name}) vs its plain version: loss rel {rel:.2e} (limit 1e-5), "
              f"d_logits max abs diff {diff:.3e} ({tol})")
        err = max(err, diff)
        print(f"[14] sharded fused CE, 1-rank nccl group, [8, 2, 512, 512] {name}: sums, loss "
              f"and d_logits bit-equal to the unsharded kernel; against the sharded plain "
              f"version loss rel {rel:.2e} (limit 1e-5), d_logits max abs diff {diff:.3e} ({tol})")

    # times at the path's shape and layout: one forward and one backward each
    logits, labels = _ce_case(CE_SLICE, torch.bfloat16, gen, channels_last=True)
    pair = torch.zeros(2, device="cuda")
    calls = {name: (lambda fn=fn: _loss_and_grad(fn, logits, labels, cw))
             for name, fn in (("sharded", sharded), ("plain", ce.sharded_fused_binary_ce_plain),
                              ("unsharded", ce.fused_binary_ce))}

    def all_reduce():
        dist.all_reduce(pair)

    dev = {k: device_ms(f) for k, f in calls.items()}
    host = {k: cuda_ms(f) for k, f in calls.items()}
    host["all_reduce"] = cuda_ms(all_reduce)
    try:  # the sharded call's two kernels (#4's) apart
        parts = traced_kernels(calls["sharded"], 20, 3)
        split = {d: sum(ms for k, ms in parts.items() if f"ce_{d}" in k) for d in ("fwd", "bwd")}
    except NoDeviceRecords:
        split = {"fwd": None, "bwd": None}
    try:  # NCCL may reduce one rank's data on the host side, without a kernel
        dev["all_reduce"] = traced_ms(all_reduce, 20, 3)
    except NoDeviceRecords:
        dev["all_reduce"] = 0.0
    moved = logits.numel() * logits.element_size() + labels.numel() * labels.element_size()
    pixels = labels.numel()
    kernels = sum_bounds([least_time(moved, 12 * pixels, F32_OPS_PER_S),
                          least_time(moved + logits.numel() * logits.element_size(),
                                     12 * pixels, F32_OPS_PER_S)])
    bound = {"bound_ms": kernels["bound_ms"] + dev["all_reduce"], "bound_by": kernels["bound_by"]}
    print(f"[14] one forward + backward at [8, 2, 512, 512] bf16 channels-last (profiler device "
          f"time | CUDA events per call with the host's launch overhead): sharded "
          f"{dev['sharded']:.4f} | {host['sharded']:.4f} ms, its plain version "
          f"{dev['plain']:.4f} | {host['plain']:.4f} ms, unsharded kernel #4 {dev['unsharded']:.4f} "
          f"| {host['unsharded']:.4f} ms; the all-reduce of the two sums alone "
          f"{dev['all_reduce']:.4f} ms on the device"
          + (" (no kernel in five traces)" if not dev["all_reduce"] else "")
          + f" | {host['all_reduce']:.4f} ms; bound {bound['bound_ms']:.4f} ms (#4's two kernels "
          f"{kernels['bound_ms']:.4f} ms by {kernels['bound_by']} + the all-reduce's device time)")
    print(f"[14] the sharded call's kernels apart (profiler device time, from L2): forward "
          + (f"{split['fwd']:.4f} ms, backward {split['bwd']:.4f} ms" if split["fwd"] is not None
             else "not measured (no device record in five traces)"))
    destroy()

    # two ranks (gloo, both on cuda:0), four rows each, against kernel #4 on all eight
    ranks = _spawn_ranks(_rank_sharded_ce, out)
    two_rank_err = 0.0
    for dtype, logits, labels in _ce_inputs(torch.Generator("cuda").manual_seed(SEED + 1)):
        loss_u, d_u = _loss_and_grad(ce.fused_binary_ce, logits, labels, cw)
        losses = [r[str(dtype)][0] for r in ranks]
        d = torch.cat([r[str(dtype)][1] for r in ranks]).cuda()
        rel = abs(losses[0] - loss_u.item()) / abs(loss_u.item())
        diff, ok, tol = _within_tolerance(d, d_u, dtype)
        check(losses[0] == losses[1] and rel <= 1e-6 and ok,
              f"2-rank sharded CE {dtype}: losses {losses} vs {loss_u.item()} (rel {rel:.2e}, "
              f"limit 1e-6), d_logits max abs diff {diff:.3e} ({tol})")
        two_rank_err = max(two_rank_err, diff)
        print(f"[14] sharded fused CE on 2 gloo ranks on cuda:0, [4, 2, 512, 512] {dtype} each: "
              f"loss {losses[0]:.6f} on both, rel {rel:.2e} from kernel #4 on all 8 (limit "
              f"1e-6); concatenated d_logits max abs diff {diff:.3e} ({tol})")
    check(all(r["launches"] == (2, 2, 2) for r in ranks),
          f"launches (fwd, bwd, sharded) per rank {[r['launches'] for r in ranks]}")
    return {"max_abs_err": err, "ms": dev["sharded"], "plain_ms": dev["plain"], **bound,
            "library_ms": None, "all_reduce_ms": dev["all_reduce"],
            "all_reduce_host_ms": host["all_reduce"],
            "unsharded_ms": dev["unsharded"], "fwd_ms": split["fwd"], "bwd_ms": split["bwd"],
            "two_rank_max_abs_err": two_rank_err}


def _dp_batch():
    """Phase 15's whole-step check: 8 seeded synthetic 512^2 scenes,
    normalized, channels last, and their masks (no augmentation)."""
    from iswm_tpu_torch.data import generate_scene, normalize

    rng = np.random.default_rng(SEED + 2)
    images, masks = zip(*(generate_scene(rng, size=(512, 512)) for _ in range(8)))
    x = normalize(torch.from_numpy(np.stack(images)).float() / 255.0)
    return x.cuda(), torch.from_numpy(np.stack(masks).astype(np.int32)).cuda()


def _dp_model(compute_dtype: str = "float32", **settings):
    """Phase 15's float32 ResNet-50 (or in ``compute_dtype``, with the model
    ``settings`` given) from seeded weights, dropout off, on cuda:0,
    channels last, with its optimizer factory."""
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.models import build_model
    from iswm_tpu_torch.train import make_optimizer

    cfg = Config()
    cfg.model.compute_dtype = compute_dtype
    for key, value in settings.items():
        setattr(cfg.model, key, value)
    model = build_model(cfg.model, seed=SEED).to("cuda:0", memory_format=torch.channels_last)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model, make_optimizer(cfg.optim, DP_STEPS)[0]


def _deterministic(on: bool) -> None:
    torch.backends.cudnn.benchmark = not on
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)


def _tf32(on: bool) -> None:
    """Float32 convs and matmuls on the tensor cores' TF32 (PyTorch's default
    for convs) or in float32."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on


def _statistics(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _rank_step(rank: int, ranks: int, rendezvous: str, out: str) -> None:
    """Phase 15 in a spawned rank: one data-parallel step on this rank's rows."""
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.parallel import destroy
    from iswm_tpu_torch.train import make_train_step

    _join_gloo(rank, ranks, rendezvous)
    try:
        x, y = _dp_batch()
        rows = slice(rank * len(x) // ranks, (rank + 1) * len(x) // ranks)
        step = make_train_step(make_loss_fn("ce_loss", fused="auto", device="cuda"))
        seen = _f32_rank_steps(step, x[rows], y[rows], rank)
    finally:
        destroy()
    torch.save(seen, Path(out) / f"_rank_step.{rank}.pt")


def _f32_rank_steps(step, x, y, rank: int, **settings) -> dict:
    """In a spawned rank: phase 15's f32 step of ``step`` from the seeded
    state (of the model ``settings`` given), deterministic, with TF32 off
    and on; by TF32 the loss and whether the parameters and statistics equal
    rank 0's, on rank 0 the gradients, the statistics and QAT's running
    amaxes (what ``_hold_two_rank_step`` holds)."""
    import torch.distributed as dist

    from iswm_tpu_torch.models.layers import quant_state
    from iswm_tpu_torch.train import TrainState
    from iswm_tpu_torch.train.step import data_parallel

    _deterministic(True)
    model, factory = _dp_model(**settings)
    start = copy.deepcopy(model.state_dict())
    replicated = data_parallel(model)
    seen = {}
    for tf32 in (False, True):
        _tf32(tf32)
        model.load_state_dict(start)
        for amax in quant_state(model).values():  # QAT's running amaxes start at 0 too
            amax.zero_()
        state = TrainState(model, *factory(model.parameters()), 0, replicated)
        with warnings.catch_warnings():  # ops without a deterministic version
            warnings.simplefilter("ignore")
            loss = float(step(state, x, y))
        # parameters, statistics and running amaxes after the step, against rank 0's
        flat = torch.cat([v.detach().double().flatten() for v in (
            *model.state_dict().values(), *quant_state(model).values())])
        lead = flat.clone()
        dist.broadcast(lead, src=0)
        seen[tf32] = {"loss": loss, "equal_to_rank_0": torch.equal(lead, flat)}
        if rank == 0:
            seen[tf32]["grads"] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
            seen[tf32]["statistics"] = {k: v.cpu() for k, v in _statistics(model).items()}
            seen[tf32]["amaxes"] = {k: v.cpu() for k, v in quant_state(model).items()}
    _tf32(True)
    _deterministic(False)
    return seen


def _step_profile(trainer, xu8, yu8) -> tuple:
    """(device ms, kernel launches, device ms by class) of one train step,
    from a profiler trace; NCCL's kernels are a class of their own."""
    records = traced_records(lambda: trainer.train_step(trainer.state, xu8, yu8), 3, 1)
    by_class = {}
    for name, (us, n) in records.items():
        cls = "NCCL" if "nccl" in name.lower() else _kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + us * n / 1e3
    return sum(by_class.values()), sum(n for _, n in records.values()), by_class


def _median_step_ms(trainer, xu8, yu8, steps: int = 8) -> list:
    times = []
    for i in range(steps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, xu8, yu8)
        torch.cuda.synchronize()
        if i >= 3:  # after warm-up
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_dp_slice(ce, cm) -> tuple:
    from iswm_tpu_torch.data import batch_iterator
    from iswm_tpu_torch.models import build_model, layers
    from iswm_tpu_torch.parallel import destroy, distributed

    smi = _smi()
    # phase 6's step in one process, timed before the group opens and after it closes
    single, cfg, train_ds, _ = _slice_trainer(DP_STEPS, "chip_smoke_single")
    images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
    xu8, yu8 = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    step_ms = {"one process": _median_step_ms(single, xu8, yu8)}

    _open_group("phase15.nccl")
    out = TRAIN_OUT.with_name("chip_smoke_data_parallel")
    trainer, cfg, _, val_ds = _slice_trainer(DP_STEPS, out.name)
    out.mkdir(parents=True, exist_ok=True)
    model = trainer.state.model
    check(trainer.state.replicated is not None, "the Trainer did not wrap its model for the group")
    batchnorms = sum(isinstance(m, layers.BatchNorm2d) for m in model.modules())
    ce.launches_fwd = ce.launches_bwd = ce.launches_sharded = cm.launches = 0
    distributed.cross_replica_all_reduces = 0
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = (ce.launches_sharded, ce.launches_fwd, ce.launches_bwd)
    all_reduces, cm_launches = distributed.cross_replica_all_reduces, cm.launches
    check(launches == (DP_STEPS,) * 3,
          f"sharded CE, kernel #4 forward and backward launches {launches} in {DP_STEPS} steps")
    check(all_reduces == DP_STEPS * 2 * batchnorms,
          f"{all_reduces} BatchNorm all-reduces in {DP_STEPS} steps, expected 2 (forward, "
          f"backward) for each of {batchnorms} BatchNorms a step and none in evaluation")
    batches = -(-len(val_ds) // cfg.data.val_batch_size)
    check(cm_launches == batches, f"confusion kernel launches {cm_launches}, expected {batches}")
    losses = trainer.logger.history["train_loss"]
    check(len(losses) == 2 and all(np.isfinite(losses)), f"logged losses {losses}")
    check(trainer.best_path is not None, "no best checkpoint was written")
    payload = torch.load(trainer.best_path, map_location="cpu", weights_only=True)
    build_model(cfg.model).load_state_dict(payload["model_state"], strict=True)
    print(f"[15] data-parallel training on a 1-rank nccl group: {DP_STEPS} steps + 1 "
          f"quick-eval + 1 validation in {fit_s:.2f} s; launches: sharded CE {launches[0]}, "
          f"kernel #4 forward {launches[1]} and backward {launches[2]}, BatchNorm all-reduces "
          f"{all_reduces} (2 x {batchnorms} BatchNorms x {DP_STEPS} steps), confusion kernel "
          f"{cm_launches}; losses {[round(v, 4) for v in losses]}; "
          f"{Path(trainer.best_path).name} loads strict=True")

    step_ms["1-rank group"] = (_median_step_ms(trainer, xu8, yu8)
                               + _median_step_ms(trainer, xu8, yu8))
    profile = {"1-rank group": _step_profile(trainer, xu8, yu8)}
    group_peak = _peak_step_mib(trainer, xu8, yu8)

    reference = _dp_reference()
    del trainer
    destroy()
    step_ms["one process"] += _median_step_ms(single, xu8, yu8)
    profile["one process"] = _step_profile(single, xu8, yu8)
    del single
    med = {k: float(np.median(v)) for k, v in step_ms.items()}
    print(f"[15] {smi}: train step, batch 8 at 512^2, bf16 (one process, 1-rank group x 2, one "
          f"process; median of {len(step_ms['one process'])} each): one process "
          f"{med['one process']:.2f} ms, 1-rank group {med['1-rank group']:.2f} ms")
    for mode, (total, n, by_class) in profile.items():
        print(f"[15] {smi}: one step, {mode} (profiler, per-kernel means): device time "
              f"{total:.2f} ms in {n:.0f} kernel launches; by class: "
              + ", ".join(f"{c} {t:.2f} ms" for c, t in sorted(by_class.items(),
                                                                key=lambda kv: -kv[1]))
              + ("" if "NCCL" in by_class or mode == "one process"
                 else "; no NCCL kernel (one rank's all-reduce launches none)"))

    _hold_two_rank_step(reference, _spawn_ranks(_rank_step, out), "[15]", "4 rows each")
    group = {"host_ms": med["1-rank group"], "device_ms": profile["1-rank group"][0],
             "launches": profile["1-rank group"][1], "by_class": profile["1-rank group"][2],
             "peak_mib": group_peak[0], "base_mib": group_peak[1],
             "all_reduces": 2 * batchnorms}
    return launches[0], group


def _dp_reference(remat: bool = False, **settings) -> dict:
    """The whole-step reference of phases 15, 21 and 22's two-rank steps, by
    TF32 off and on: one process on all 8 rows (the model ``settings``
    given; with ``remat``, the step's), in the caller's 1-rank group (the
    same BatchNorm arithmetic), f32, deterministic; its loss, gradients,
    running statistics and QAT's running amaxes, and the gradients of the
    same step with one pooled value in a million moved by an ulp of what the
    convs read (:func:`_nudge_site`)."""
    from iswm_tpu_torch.models.layers import quant_state
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.train import TrainState, make_train_step

    _deterministic(True)
    ref, factory = _dp_model(**settings)
    start = copy.deepcopy(ref.state_dict())
    x, y = _dp_batch()
    step = make_train_step(make_loss_fn("ce_loss", fused="auto", device="cuda"), remat=remat)
    pool = _nudge_site(ref, settings)

    def one_step(hook=None):
        ref.load_state_dict(start)
        for amax in quant_state(ref).values():  # QAT's running amaxes start at 0 too
            amax.zero_()
        state = TrainState(ref, *factory(ref.parameters()), 0)
        handle = None if hook is None else pool.register_forward_hook(hook)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            loss = float(step(state, x, y))
        if handle is not None:
            handle.remove()
        return loss, {k: p.grad.detach().clone() for k, p in ref.named_parameters()}

    reference = {}
    for tf32 in (False, True):
        _tf32(tf32)
        loss, grads = one_step()
        reference[tf32] = {"loss": loss, "grads": grads, "statistics": _statistics(ref),
                           "amaxes": {k: v.clone() for k, v in quant_state(ref).items()},
                           "nudged": one_step(_nudge)[1]}
    _tf32(True)
    _deterministic(False)
    return reference


def _nudge_site(model, settings: dict):
    """The module whose output :func:`_nudge` moves: the stem's max-pool, its
    fused pool with the fused stem, MobileNetV2's stem, Xception's first
    BatchNorm."""
    backbone = settings.get("backbone", "resnet50")
    if backbone == "mobilenetv2":
        return model.backbone.features[0]
    if backbone == "xception":
        return model.backbone.bn1
    return (model.backbone.maxpool if settings.get("fused_stem", "never") == "never"
            else model.backbone.fused_stem_pool)


def _step_distances(got: dict, want: dict) -> dict:
    """How far a step's rank-0 record ``got`` (``_f32_rank_steps``) lies from
    the one-process ``want`` (``_dp_reference``): the loss (relative), the
    worst BatchNorm's running statistics (variance by max|var|, mean by max
    sqrt(var)), the gradients' median and worst tensor (by max|grad|), and
    QAT's running amaxes' worst site (relative)."""
    ratios = sorted(float((got["grads"][k].cuda() - w).abs().max()
                          / w.abs().max().clamp_min(1e-30)) for k, w in want["grads"].items())
    stat, name = 0.0, ""
    for k, var in want["statistics"].items():
        if k.endswith("running_var"):
            mk = k.replace("running_var", "running_mean")
            got_var, got_mean = (got["statistics"][n].cuda() for n in (k, mk))
            err = max(float((got_var - var).abs().max() / var.abs().max()),
                      float((got_mean - want["statistics"][mk]).abs().max() / var.sqrt().max()))
            stat, name = max((stat, name), (err, k[:-12]))
    amax = max((float((got["amaxes"][k].cuda() - v).abs() / v.abs()) for k, v in
                want["amaxes"].items()), default=0.0)
    return {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]), "statistics": stat,
            "at": name, "median": ratios[len(ratios) // 2], "worst": ratios[-1], "amax": amax}


def _hold_two_rank_step(reference: dict, ranks: list, tag: str, layout: str,
                        yardstick: list | None = None) -> None:
    """Phase 15's limits on a two-rank f32 step against ``_dp_reference``.

    Held: the loss and the statistics with TF32 off (float32 throughout, so
    that 1e-5 measures the reduction over two ranks and not TF32's rounding
    of its differences: with TF32 on they read 2.8e-4 and 5.0e-4), the
    gradients both ways against the nudged step (phase 11's yardstick).
    With a ``yardstick`` (the ranks' records of the same model's 2-rank
    data-parallel step, for a step whose forward is chaotic at this size:
    QAT's, where one rounding of a BatchNorm's sums flips int8 codes), each
    of those, and QAT's running amaxes, within DP_SLACK times that step's
    distance from one process where it is larger than the limit: the step
    lies no farther from one process than data parallelism does."""
    for tf32 in (False, True):
        want, seen = reference[tf32], [r[tf32] for r in ranks]
        check(all(r["equal_to_rank_0"] for r in seen),
              f"TF32 {tf32}: the ranks' parameters or statistics differ after the step")
        losses = [r["loss"] for r in seen]
        check(losses[0] == losses[1], f"TF32 {tf32}: the ranks' losses {losses} differ")
        got = _step_distances(seen[0], want)
        nudge = _step_distances({"loss": want["loss"], "grads": want["nudged"],
                                 "statistics": want["statistics"],
                                 "amaxes": want["amaxes"]}, want)
        dp = None if yardstick is None else _step_distances(yardstick[0][tf32], want)
        limits = {"loss": 1e-5, "statistics": 1e-5, "amax": SPATIAL_AMAX_LIMIT}
        if dp is not None:
            limits = {k: max(v, DP_SLACK * dp[k]) for k, v in limits.items()}
        for key in ("loss", "statistics", "amax") if not tf32 else ():
            check(got[key] <= limits[key],
                  f"2-rank step {key} {got[key]:.2e} from one process (limit "
                  f"{limits[key]:.2e}{'' if dp is None else f'; data-parallel {dp[key]:.2e}'})")
        limit = DP_SLACK * max(nudge["median"], 0.0 if dp is None else dp["median"])
        check(got["median"] <= limit,
              f"TF32 {tf32}: 2-rank step gradients: median tensor {got['median']:.2e} * "
              f"max|grad| from one process, more than {DP_SLACK} x the nudged step's "
              f"{nudge['median']:.2e}" + ("" if dp is None else
                                          f" or the data-parallel step's {dp['median']:.2e}"))
        print(f"{tag} one step on 2 gloo ranks on cuda:0 (f32, TF32 {'on' if tf32 else 'off'}, "
              f"{layout}, no augmentation, dropout off, deterministic) against one process on "
              f"all 8: loss {losses[0]:.6f} on both vs {want['loss']:.6f} (rel "
              f"{got['loss']:.2e}" + ("" if tf32 else f", limit {limits['loss']:.2e}")
              + f"); running statistics within {got['statistics']:.2e} at {got['at']}"
              + ("" if tf32 else f" (limit {limits['statistics']:.2e})")
              + ("" if not want["amaxes"] else f"; running amaxes within {got['amax']:.2e}"
                 + ("" if tf32 else f" (limit {limits['amax']:.2e})"))
              + f"; parameters and statistics equal on both ranks; gradients median tensor "
              f"{got['median']:.2e} * max|grad| (worst {got['worst']:.2e}) from one process, "
              f"where one process with one pooled value in a million moved by an ulp lies "
              f"{nudge['median']:.2e} (worst {nudge['worst']:.2e})"
              + ("" if dp is None else
                 f" and the 2-rank data-parallel step (4 images a rank) loss {dp['loss']:.2e}, "
                 f"statistics {dp['statistics']:.2e}, amaxes {dp['amax']:.2e}, gradients "
                 f"{dp['median']:.2e} (worst {dp['worst']:.2e})") + f" (limit {DP_SLACK}x)")


# ------------------------------------------------------------------ the zoo
# (M, K, N) of every int8 site of one chunk (8 tiles of 512^2, OS 16) of each
# new serving model, and how many of its routed sites run at it
ZOO_SHAPES = {
    "deeplabv3plus_xception": {
        (512072, 128, 128): 1,   # block1.rep.3.pointwise, 253^2 after the VALID stems
        (129032, 128, 256): 1,   # block2.rep.1.pointwise, 127^2
        (129032, 256, 256): 1,   # block2.rep.4.pointwise
        (8192, 1024, 1536): 1,   # conv3.pointwise
        (8192, 1536, 2048): 1,   # conv4.pointwise
        (8192, 2048, 256): 1,    # aspp.convs.0
        (8, 2048, 256): 1,       # aspp.convs.4 (pool)
        (8192, 1280, 256): 1,    # aspp.project
    },
    "deeplabv3plus_mobilenet": {(8192, 1280, 256): 1},  # aspp.project
}
# routed sites of one chunk of the V3 head and of the separable V3+ head on
# ResNet-50: the 30 of phase 4 (the V3+ low-level projection is no site), and
# the separable head's pointwise halves of aspp.convs.{1,2,3} and classifier.3
ZOO_HEADS = {"deeplabv3_resnet50": ({}, 30),
             "deeplabv3plus_resnet50": ({"separable_conv": True}, 34)}
ZOO_STEPS = 4  # a quick-eval at step 2 and the validation at 4


def _zoo_config(name: str, variant: str = "bf16"):
    from iswm_tpu_torch.config import Config

    cfg = Config()  # OS 16, bf16, tile 512 / overlap 64 / batch 8
    head, _, backbone = name.partition("_")
    cfg.model.name = head
    cfg.model.backbone = "mobilenetv2" if backbone == "mobilenet" else backbone
    cfg.predict.serving_variant = variant
    return cfg


def phase_zoo_kernel(k8) -> dict:
    """Kernel #1 at the Xception shapes phase 3 does not take: bit-exact, and
    timed with the inputs out of L2 beside its bound and cuDNN's bf16 1x1."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cold = ColdTimer(reps=10)
    shapes = [s for s in ZOO_SHAPES["deeplabv3plus_xception"] if s not in SLICE_SHAPES]
    rows = []
    for m, k, n in shapes:
        x, w_q, w_scale, x_scale = _case(m, k, n, "bf16", gen)
        got = k8.int8_matmul(x, w_q, w_scale, x_scale)
        want = k8.int8_matmul_plain(x, w_q, w_scale, x_scale)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"kernel != plain at Xception's {(m, k, n)}: max abs err "
                                      f"{float((got - want).abs().max())}")
        plan = k8.plan(m, k, n, x.element_size())
        ms = cold(lambda: k8.int8_matmul(x, w_q, w_scale, x_scale))
        plain_ms = cuda_ms(lambda: k8.int8_matmul_plain(x, w_q, w_scale, x_scale), reps=5)
        xc = x.reshape(1, m, 1, k).permute(0, 3, 1, 2)
        wc = w_q.t().to(torch.bfloat16).reshape(n, k, 1, 1).contiguous(
            memory_format=torch.channels_last)
        conv_ms = cold(lambda: torch.nn.functional.conv2d(xc, wc))
        least = matmul_bound(m, k, n, x.element_size())
        rows.append({"m": m, "k": k, "n": n, "ms": ms, "plain_ms": plain_ms, "conv_ms": conv_ms,
                     **least})
        print(f"[16] int8_matmul M={m} K={k} N={n} (Xception): bit-exact (torch.equal); plan "
              + " ".join(f"{key}={plan[key]}" for key in k8.PLAN_KEYS)
              + f"; kernel {ms:.4f} ms with the inputs out of L2 ({least['bound_ms'] / ms:.1%} of "
              f"the bound {least['bound_ms']:.4f} ms by {least['bound_by']}); plain "
              f"{plain_ms:.4f} ms; bf16 conv2d (cuDNN, no quantization) {conv_ms:.4f} ms")
    return {"xception_shapes": rows}


def _chunk(scene: np.ndarray, tile: int = 512) -> torch.Tensor:
    """8 tiles of a scene, normalized NHWC on the card, as phase 4 takes them."""
    from iswm_tpu_torch.data import val_transform_batch

    x = val_transform_batch(torch.from_numpy(scene).cuda())
    return torch.stack([x[oy:oy + tile, ox:ox + tile]
                        for oy in (0, 448) for ox in (0, 384, 768, 1024)])


def _scene_latency(predictor, scene, reps: int = 5) -> float:
    predictor.predict_image(scene)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict_image(scene)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_zoo_serving(k8, smi: str) -> int:
    """Xception and MobileNetV2 through ``Predictor`` in int8_exec (launches,
    routed shapes, bit-equal to the plain int8 path) and bf16; the V3 head and
    the separable head on ResNet-50 for one chunk each way; feature maps.
    Returns the int8 launches of the counted runs."""
    from iswm_tpu_torch.infer import Predictor, tile_origins
    from iswm_tpu_torch.infer.quantization import (
        Int8Conv1x1, calibrate_conv_inputs, logit_diff_verdict, make_variant_fn)
    from iswm_tpu_torch.models import build_model_by_name
    from iswm_tpu_torch.data import val_transform_batch
    from iswm_tpu_torch.ops.kernels.int8_matmul import quantized_conv1x1_plain

    rng = np.random.default_rng(SEED)
    scenes = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SCENES]
    xs = [val_transform_batch(torch.from_numpy(s).cuda()) for s in scenes]
    chunks = sum(-(-(len(tile_origins(h, 512, 448)) * len(tile_origins(w, 512, 448))) // 8)
                 for h, w in SCENES)
    total = 0
    for name, shapes in ZOO_SHAPES.items():
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        pred = Predictor(_zoo_config(name, "int8_exec"), device="cuda")
        k8.launches = 0
        products = [pred.predict_image(s) for s in scenes]
        torch.cuda.synchronize()
        launches, routed = k8.launches, pred.engine.model_fn.routed_sites
        total += launches
        sites = sum(shapes.values())
        print(f"[16] {name} int8_exec: {len(routed)} routed sites {sorted(routed)}; "
              f"int8_matmul launches {launches} over {chunks} chunks")
        check(len(routed) == sites, f"{name}: {len(routed)} routed sites, expected {sites}")
        check(launches == sites * chunks,
              f"{name}: int8_matmul launched {launches} times, expected {sites} x {chunks}")
        int8_sites = [m for m in pred.engine.model_fn.model.modules()
                      if isinstance(m, Int8Conv1x1)]
        seen = set()
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: seen.add((args[0].shape[0] * args[0].shape[2] * args[0].shape[3],
                                        mod.w_q.shape[1], mod.w_q.shape[0])))
            for m in int8_sites]
        logits = [pred.engine.infer_scene(x) for x in xs]
        for h in hooks:
            h.remove()
        check(seen == set(shapes), f"{name}: routed shapes {sorted(seen)} != {sorted(shapes)}")
        for (h, w), lg, prod in zip(SCENES, logits, products):
            check(tuple(lg.shape) == (h, w, 2) and bool(torch.isfinite(lg).all()),
                  f"{name}: logits of the {h}x{w} scene: {tuple(lg.shape)} or not finite")
            check(np.array_equal(torch.softmax(lg, -1)[..., 1].cpu().numpy(), prod["prob_fg"]),
                  f"{name}: the rerun's logits differ from the counted run's")
        for m in int8_sites:
            m.conv_fn = quantized_conv1x1_plain
        plain = [pred.engine.infer_scene(x) for x in xs]
        for m in int8_sites:
            del m.conv_fn
        diff = max(float((a - b).abs().max()) for a, b in zip(logits, plain))
        check(all(torch.equal(a, b) for a, b in zip(logits, plain)),
              f"{name}: scene logits differ from the plain int8 path: max abs diff {diff}")
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        bf16 = Predictor(_zoo_config(name), device="cuda")
        agree, verdict = logit_diff_verdict(bf16.engine.infer_scene(xs[0]).cpu().numpy(),
                                            logits[0].cpu().numpy())
        print(f"[16] {name}: int8_exec scene logits finite and equal to the plain int8 path "
              f"(max abs diff {diff}); mask agreement with bf16 {agree:.6f} ({verdict})")
        chunk = _chunk(scenes[0])
        for variant, predictor in (("bf16", bf16), ("int8_exec", pred)):
            fn = predictor.engine.model_fn
            _chunk_profile(f"{name} {variant} ({smi})", lambda: fn(chunk), phase=16)
            for (h, w), scene in zip(SCENES, scenes):
                print(f"[16] {name} {variant} {h}x{w} ({smi}): scene latency "
                      f"{_scene_latency(predictor, scene):.2f} ms (median of 5)")
        if name == "deeplabv3plus_xception":
            maps = bf16.extract_feature_maps(scenes[0])
            want = {"backbone_low_level": (127, 127), "backbone_out": (32, 32), "aspp": (32, 32)}
            check(list(maps) == list(want), f"feature map labels {list(maps)}")
            for label, fmap in maps.items():
                check(fmap.shape == want[label] and bool(np.isfinite(fmap).all())
                      and fmap.min() >= 0.0 and fmap.max() <= 1.0,
                      f"feature map {label}: {fmap.shape}, range [{fmap.min()}, {fmap.max()}]")
            print(f"[16] {name} feature maps on the card: "
                  + ", ".join(f"{k} {v.shape[0]}x{v.shape[1]}" for k, v in maps.items())
                  + ", finite, in [0, 1]")
        del pred, bf16

    chunk = _chunk(scenes[0])
    for name, (model_kw, sites) in ZOO_HEADS.items():
        model = build_model_by_name(name, **model_kw).to("cuda", memory_format=torch.channels_last)
        scales = calibrate_conv_inputs(model, [chunk.permute(0, 3, 1, 2)], wide=True)
        fns = {"bf16": make_variant_fn(model, "bf16"),
               "int8_exec": make_variant_fn(model, "int8_exec", conv_scales=scales)}
        k8.launches = 0
        out = {k: fn(chunk) for k, fn in fns.items()}
        torch.cuda.synchronize()
        launches = k8.launches
        total += launches
        routed = fns["int8_exec"].routed_sites
        check(len(routed) == sites and launches == sites,
              f"{name} {model_kw}: {len(routed)} routed sites and {launches} launches in one "
              f"chunk, expected {sites}")
        check(all(bool(torch.isfinite(v).all()) and tuple(v.shape) == (8, 512, 512, 2)
                  for v in out.values()), f"{name} {model_kw}: logits not finite")
        agree, verdict = logit_diff_verdict(out["bf16"].cpu().numpy(),
                                            out["int8_exec"].cpu().numpy())
        print(f"[16] {name} {model_kw}: one chunk in bf16 and int8_exec, finite logits; "
              f"{len(routed)} routed sites, int8_matmul launches {launches}; int8_exec vs bf16 "
              f"mask agreement {agree:.6f} ({verdict})")
        for variant, fn in fns.items():
            _chunk_profile(f"{name} {model_kw} {variant} ({smi})", lambda: fn(chunk), phase=16)
        del model, fns
    return total


def phase_zoo_train(ce, cm, smi: str) -> tuple:
    """Phase 6's training for ``ZOO_STEPS`` steps on Xception and
    MobileNetV2 (CE through #4, a quick-eval through #6, held against the
    plain confusion matrix), and a pretrained ResNet-50 backbone from a
    seeded cache file.  Returns the (#4 forward, #4 backward, #6) launches
    of the two fits."""
    from iswm_tpu_torch.data import batch_iterator
    from iswm_tpu_torch.metrics.device import foreground_metrics_from_cm
    from iswm_tpu_torch.models import build_model, build_model_by_name

    counts = [0, 0, 0]
    for backbone in ("xception", "mobilenetv2"):
        trainer, cfg, train_ds, val_ds = _slice_trainer(ZOO_STEPS, f"chip_smoke_{backbone}",
                                                        backbone=backbone)
        ce.launches_fwd = ce.launches_bwd = cm.launches = 0
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = (ce.launches_fwd, ce.launches_bwd, cm.launches)
        counts = [a + b for a, b in zip(counts, launches)]
        batches = -(-len(val_ds) // cfg.data.val_batch_size)
        losses = trainer.logger.history["train_loss"]
        check(launches == (ZOO_STEPS, ZOO_STEPS, batches),
              f"{backbone}: (#4 fwd, #4 bwd, #6) launches {launches}, expected "
              f"({ZOO_STEPS}, {ZOO_STEPS}, {batches}: one quick-eval)")
        check(len(losses) == 2 and all(np.isfinite(losses)), f"{backbone}: losses {losses}")
        check(trainer.best_path is not None, f"{backbone}: no best checkpoint")
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        got = trainer.quick_eval()
        total = torch.zeros((2, 2), device="cuda")
        for images, labels in batch_iterator(val_ds, cfg.data.val_batch_size, epochs=1):
            preds = trainer.eval_step(torch.from_numpy(images).cuda())["preds"]
            total += cm.binary_confusion_matrix_plain(torch.from_numpy(labels).cuda(), preds)
        want = {k: float(v) for k, v in foreground_metrics_from_cm(total).items()}
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        worst = max(abs(got[k] - want[k]) for k in want)
        check(sorted(got) == sorted(want) and worst <= 1e-6,
              f"{backbone}: quick_eval {got} vs the plain confusion matrix's {want}")
        images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
        step_ms = _median_step_ms(trainer, torch.from_numpy(images).cuda(),
                                  torch.from_numpy(labels).cuda(), steps=5)
        print(f"[16] training deeplabv3plus_{backbone}: {ZOO_STEPS} steps + 1 quick-eval + 1 "
              f"validation in {fit_s:.2f} s; #4 launches fwd {launches[0]}, bwd {launches[1]}; "
              f"#6 launches {launches[2]}; losses {[round(v, 4) for v in losses]}; quick_eval "
              f"equal to the plain confusion matrix's metrics (max abs diff {worst:.1e}, limit "
              f"1e-6); {smi}: train step batch 8 at 512^2 median {np.median(step_ms):.2f} ms "
              f"of {len(step_ms)}")
        del trainer

    # a seeded random torchvision-layout ResNet-50 file in the cache directory
    out = TRAIN_OUT.with_name("chip_smoke_pretrained")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    gen = torch.Generator().manual_seed(SEED)
    file_sd = {}
    for key, t in build_model_by_name("deeplabv3plus_resnet50").backbone.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            file_sd[key] = (torch.rand(t.shape, generator=gen) + 0.5 if key.endswith("running_var")
                            else torch.randn(t.shape, generator=gen))
    file_sd.update({"fc.weight": torch.randn(1000, 2048, generator=gen),
                    "fc.bias": torch.randn(1000, generator=gen)})
    torch.save(file_sd, out / "resnet50.pth")
    before = os.environ.get("ISWM_PRETRAINED_DIR")
    os.environ["ISWM_PRETRAINED_DIR"] = str(out)
    try:
        trainer, cfg, _, _ = _slice_trainer(ZOO_STEPS, "chip_smoke_pretrained_run",
                                            pretrained_backbone=True)
    finally:
        if before is None:
            del os.environ["ISWM_PRETRAINED_DIR"]
        else:
            os.environ["ISWM_PRETRAINED_DIR"] = before
    model = trainer.state.model
    loaded = {k: v for k, v in model.backbone.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    check(all(v.is_cuda for v in loaded.values())
          and all(torch.equal(v.cpu(), file_sd[k]) for k, v in loaded.items()),
          "pretrained_backbone: the backbone on the card is not the file's")
    seeded = build_model(cfg.model, seed=cfg.train.random_seed).classifier.state_dict()
    check(all(torch.equal(v.cpu(), seeded[k]) for k, v in model.classifier.state_dict().items()),
          "pretrained_backbone: the head is not the seeded one")
    print(f"[16] pretrained_backbone on cuda: {len(loaded)} backbone tensors equal to the cached "
          f"resnet50.pth, the head as seeded")
    return tuple(counts)


# ---------------------------------------------------------- int8_exec_xla
# (B, H, W, C, N, k, stride, pad, dilation): how many of the 33 dense int8
# conv launches of one int8_exec_xla chunk (8 tiles of 512^2, OS 16) of
# ResNet-50 run at it (the other 30 routed sites are phase 3's 1x1s on #1);
# the V3+ decoder's first classifier conv is two of them, one a part
XLA_IGEMM_SHAPES = {
    (8, 128, 128, 64, 64, 1, 1, 0, 1): 1,       # layer1.0.conv1
    (8, 128, 128, 64, 64, 3, 1, 1, 1): 3,       # layer1.*.conv2
    (8, 128, 128, 64, 256, 1, 1, 0, 1): 4,      # layer1.*.conv3, layer1.0.downsample
    (8, 128, 128, 256, 64, 1, 1, 0, 1): 2,      # layer1.{1,2}.conv1
    (8, 128, 128, 128, 128, 3, 2, 1, 1): 1,     # layer2.0.conv2
    (8, 128, 128, 256, 512, 1, 2, 0, 1): 1,     # layer2.0.downsample
    (8, 64, 64, 128, 128, 3, 1, 1, 1): 3,       # layer2.{1,2,3}.conv2
    (8, 64, 64, 256, 256, 3, 2, 1, 1): 1,       # layer3.0.conv2
    (8, 64, 64, 512, 1024, 1, 2, 0, 1): 1,      # layer3.0.downsample
    (8, 32, 32, 256, 256, 3, 1, 1, 1): 5,       # layer3.{1..5}.conv2
    (8, 32, 32, 512, 512, 3, 1, 1, 1): 1,       # layer4.0.conv2
    (8, 32, 32, 512, 512, 3, 1, 2, 2): 2,       # layer4.{1,2}.conv2
    (8, 32, 32, 2048, 256, 3, 1, 6, 6): 1,      # aspp.convs.1
    (8, 32, 32, 2048, 256, 3, 1, 12, 12): 1,    # aspp.convs.2
    (8, 32, 32, 2048, 256, 3, 1, 18, 18): 1,    # aspp.convs.3
    (8, 128, 128, 256, 48, 1, 1, 0, 1): 1,      # project (N = 48)
    (8, 128, 128, 48, 256, 3, 1, 1, 1): 1,      # classifier.0, part 0 (K = 432)
    (8, 128, 128, 256, 256, 3, 1, 1, 1): 2,     # classifier.0 part 1, classifier.3
    (8, 128, 128, 256, 2, 1, 1, 0, 1): 1,       # classifier.6 (N = 2, with its bias)
}
XLA_STEM_SHAPE = (8, 512, 512, 3, 64, 7, 2, 3, 1)  # with int8_stem (K = 147)
XLA_ODD_SHAPES = ((8, 1, 1, 2048, 256, 1, 1, 0, 1),   # M = 8 (MobileNetV2's pool: 320)
                  (8, 1, 1, 320, 256, 1, 1, 0, 1))
# (B, H, W, C, stride, pad, dilation) of MobileNetV2's depthwise 3x3s with
# int8_grouped (groups = C = N), and how many of one chunk's 16 run at it
XLA_DEPTHWISE_SHAPES = {
    (8, 256, 256, 96, 2, 1, 1): 1,
    (8, 128, 128, 144, 1, 1, 1): 1,
    (8, 128, 128, 144, 2, 1, 1): 1,
    (8, 64, 64, 192, 1, 1, 1): 2,
    (8, 64, 64, 192, 2, 1, 1): 1,
    (8, 32, 32, 384, 1, 1, 1): 4,
    (8, 32, 32, 576, 1, 1, 1): 2,
    (8, 32, 32, 576, 1, 2, 2): 1,
    (8, 32, 32, 960, 1, 2, 2): 3,
}
# of those dense launches, the ones whose site keeps float32 outputs: the
# V3+ decoder's concat conv's two parts, summed before its BatchNorm (the
# other 31 are Int8Conv sites, written in the input's bf16 by the epilogue)
XLA_F32_SITES = {(8, 128, 128, 48, 256, 3, 1, 1, 1): 1, (8, 128, 128, 256, 256, 3, 1, 1, 1): 1}
XLA_VARIANTS = EVAL_VARIANTS + ("int8_exec_xla",)
# the int8_conv.cu kernels by the entry that launches them (a trace's names
# hold these), and the finishing pass of a K split, part of an igemm launch
INT8_CONV_ENTRIES = {"quantize": ("quantize_kernel",),
                     "igemm": ("igemm_wgmma_kernel", "igemm_bytes_kernel"),
                     "direct": ("direct_tiled_kernel", "direct_kernel")}
INT8_CONV_KERNELS = (*(n for names in INT8_CONV_ENTRIES.values() for n in names),
                     "igemm_split_finish")


def _valid_taps(n: int, out: int, k: int, stride: int, pad: int, dil: int) -> int:
    """Taps of one axis, summed over its output positions, that land inside
    the input (the others multiply the zero padding: no work)."""
    return sum(sum(0 <= o * stride - pad + t * dil < n for t in range(k)) for o in range(out))


def conv_bound(b, h, w, c, n, k, stride, pad, dil, groups=1, bias=False,
               out_bytes=4) -> dict:
    """int8 codes x [B, H, W, C] + w [N, k, k, C / groups] + w_scale (+ bias)
    in, out [B, Ho, Wo, N] f32 (out_bytes 4) or bf16 (2); 2 N C / groups
    operations a valid tap of an output pixel, on the tensor cores (int8) for
    a dense conv and on the CUDA cores (int32 multiply-adds, counted at the
    float32 rate) for a grouped."""
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    taps = _valid_taps(h, ho, k, stride, pad, dil) * _valid_taps(w, wo, k, stride, pad, dil)
    nbytes = (b * h * w * c + n * k * k * c // groups + 4 * n * (1 + bias)
              + out_bytes * b * ho * wo * n)
    ops = 2 * b * taps * n * (c // groups)
    return {"bytes": nbytes, "ops": ops,
            **least_time(nbytes, ops, INT8_OPS_PER_S if groups == 1 else F32_OPS_PER_S)}


def _work(bounds) -> str:
    """The bytes and operations of calls made one after another."""
    return (f"{sum(b['bytes'] for b in bounds) / 1e9:.3f} GB, "
            f"{sum(b['ops'] for b in bounds) / 1e9:.2f} GOP")


def _conv_case(shape, gen, groups=1):
    b, h, w, c, n, k = shape[:6]
    x_q = torch.randint(-127, 128, (b, h, w, c), generator=gen, device="cuda").to(torch.int8)
    w_q = torch.randint(-127, 128, (n, k, k, c // groups), generator=gen,
                        device="cuda").to(torch.int8)
    w_scale = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
    bias = torch.randn((n,), generator=gen, device="cuda") if n == 2 else None
    return x_q, w_q, w_scale, bias


def _conv_row(kc, shape, gen, cold, groups=1, timed=(torch.bfloat16,)) -> dict:
    """One shape of a conv entry: bit-equal to its plain version in float32
    and in bf16; for each output dtype of ``timed`` its device time with the
    inputs out of L2 and its bound (``ms``, ``bound_ms``, ... of the first,
    ``f32`` / ``bf16`` of each); its plain version's time, cuDNN's bf16
    conv's (another function: no quantization) and, where it takes the shape,
    ``torch._int_mm``'s over the unfolded codes (the int32 product alone)."""
    b, h, w, c, n, k, stride, pad, dil = shape
    x_q, w_q, w_scale, bias = _conv_case(shape, gen, groups)
    geo = dict(stride=stride, padding=pad, dilation=dil)

    def run(dtype):
        if groups == 1:
            return kc.conv_s8_igemm(x_q, w_q, w_scale, 0.0123, bias, out_dtype=dtype, **geo)
        return kc.conv_s8_direct(x_q, w_q, w_scale, 0.0123, bias, groups=groups,
                                 out_dtype=dtype, **geo)

    def plain(dtype=torch.float32):
        return kc.conv_s8_plain(x_q, w_q, w_scale, 0.0123, bias, groups=groups,
                                out_dtype=dtype, **geo)

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        got, want = run(dtype), plain(dtype)
        torch.cuda.synchronize()
        diff = float((got.float() - want.float()).abs().max())
        err = max(err, diff)
        check(got.dtype == dtype and torch.equal(got, want),
              f"int8 conv != plain at {shape} groups {groups} in {dtype}: max abs err {diff}")
    pixels = got.numel() // n
    del got, want
    row = {"max_abs_err": err, "plain_ms": cuda_ms(plain, reps=2, warmup=1)}
    for dtype in timed:
        key = "bf16" if dtype == torch.bfloat16 else "f32"
        row[key] = {"ms": cold(lambda: run(dtype)),
                    **conv_bound(b, h, w, c, n, k, stride, pad, dil, groups, bias is not None,
                                 2 if dtype == torch.bfloat16 else 4)}
    row.update(row["bf16" if timed[0] == torch.bfloat16 else "f32"])
    xc = x_q.to(torch.bfloat16).permute(0, 3, 1, 2)  # channels-last NCHW view
    wc = w_q.to(torch.bfloat16).permute(0, 3, 1, 2)
    row["library_ms"] = cold(lambda: torch.nn.functional.conv2d(
        xc, wc, None if bias is None else bias.to(torch.bfloat16), stride, pad, dil, groups))
    row["int_mm_ms"] = None
    kk = k * k * c
    if groups == 1 and kk % 8 == 0 and n % 8 == 0 and pixels > 16:
        cols = torch.nn.functional.unfold(xc.contiguous(), k, dil, pad, stride)
        a = cols.transpose(1, 2).reshape(-1, kk).to(torch.int8).contiguous()
        wm = w_q.permute(0, 3, 1, 2).reshape(n, kk).t()  # [K, N], (c, kh, kw) as unfold's
        del cols
        int_mm = _int_mm(a, wm)
        row["int_mm_ms"] = cold(int_mm) if int_mm else None
    return row


def phase_int8_xla_kernels(kc, smi: str) -> dict:
    """The int8_conv kernels against their plain versions, bit for bit: the
    quantize over every bf16 value (contiguous and as a channel slice), the
    dense conv at every shape of the slice's chunk, the stem and M = 8, the
    grouped conv at MobileNetV2's depthwise shapes, both convs in float32 and
    in bf16 output; device times in each site's output dtype beside the
    bounds and cuDNN's bf16 conv, summed over a chunk."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cold = ColdTimer(reps=10)
    bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
    every = bits.view(torch.bfloat16).reshape(256, 256).cuda()
    every = torch.where(torch.isnan(every), torch.zeros_like(every), every)
    for x_scale in (0.25, 0.012345, 3e-39, 1e30):
        for xt in (every, every.float(), every[:, 16:64], every[:, 3:10]):
            check(torch.equal(kc.quantize_s8(xt, x_scale), kc.quantize_s8_plain(xt, x_scale)),
                  f"quantize_s8 != plain over the bf16 values at x_scale {x_scale}, "
                  f"{tuple(xt.shape)} {xt.dtype}")
    print("[17] quantize_s8: every bf16 value (NaN aside) in bf16 and f32, contiguous and as "
          "channel slices, at 4 scales: bit-exact (torch.equal)")
    records = {}
    # the quantize at each dense site's input (bf16 activations, NHWC)
    q = dict.fromkeys(("ms", "plain_ms", "bound_ms"), 0.0)
    bounds = []
    for shape, count in XLA_IGEMM_SHAPES.items():
        b, h, w, c = shape[:4]
        x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
        ms = cold(lambda: kc.quantize_s8(x, 0.05))
        plain_ms = cuda_ms(lambda: kc.quantize_s8_plain(x, 0.05), reps=3)
        least = {"bytes": 3 * x.numel(), "ops": x.numel(),
                 **least_time(3 * x.numel(), x.numel(), F32_OPS_PER_S)}
        q["ms"] += count * ms
        q["plain_ms"] += count * plain_ms
        bounds += [least] * count
    records["quantize"] = {"max_abs_err": 0.0, "ms": q["ms"], "plain_ms": q["plain_ms"],
                           **sum_bounds(bounds), "library_ms": None}
    print(f"[17] quantize_s8 over one chunk's 33 dense-site inputs ({smi}): {q['ms']:.4f} ms with "
          f"the inputs out of L2, plain {q['plain_ms']:.4f} ms, bound "
          f"{records['quantize']['bound_ms']:.4f} ms by bytes ({_work(bounds)})")

    for name, table, groups in (("igemm", XLA_IGEMM_SHAPES, None),
                                ("direct", XLA_DEPTHWISE_SHAPES, "C")):
        total = dict.fromkeys(("ms", "plain_ms", "library_ms", "int_mm_ms"), 0.0)
        bounds, err = [], 0.0
        extra = (XLA_STEM_SHAPE, *XLA_ODD_SHAPES) if name == "igemm" else ()
        for shape in (*table, *extra):
            if name == "direct":  # (B, H, W, C, stride, pad, dil), C = N = groups
                b, h, w, c, stride, pad, dil = shape
                shape, g = (b, h, w, c, c, 3, stride, pad, dil), c
            else:
                g = 1
            count = table.get(shape, 0) if name == "igemm" else table[(*shape[:4], *shape[6:])]
            # each launch timed in its site's output dtype (bits checked in both)
            f32 = XLA_F32_SITES.get(shape, 0) if name == "igemm" else 0
            counts = {"bf16": count - f32, "f32": f32}
            timed = tuple(d for d, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))
                          if counts[key] or (key == "bf16" and not count))
            row = _conv_row(kc, shape, gen, cold, g, timed)
            err = max(err, row["max_abs_err"])
            for key in ("plain_ms", "library_ms", "int_mm_ms"):
                total[key] += count * (row[key] or 0.0)
            for key, n_sites in counts.items():
                if n_sites:
                    total["ms"] += n_sites * row[key]["ms"]
                    bounds += [row[key]] * n_sites
            b, h, w, c, n, k, stride, pad, dil = shape
            geom = kc.conv_geometry((b, h, w, c), (n, k, k, c // g), stride, pad, dil, g)
            if name == "igemm":
                body = kc.igemm_body(geom)
                plan = (f" {kc.plan_igemm(kc.as_rows(geom), 2)}" if body == "wgmma" else "")
            else:
                body, plan = kc.direct_body(geom, g), ""
            times = "; ".join(
                f"{key} out {row[key]['ms']:.4f} ms ({row[key]['bound_ms'] / row[key]['ms']:.1%} "
                f"of the bound {row[key]['bound_ms']:.4f} ms by {row[key]['bound_by']})"
                for key in ("bf16", "f32") if key in row)
            print(f"[17] conv_s8_{name} B={b} H={h} W={w} C={c} N={n} k={k} s={stride} p={pad} "
                  f"d={dil} groups={g} ({smi}): body {body}{plan}; bit-exact (torch.equal) in "
                  f"float32 and bf16; kernel with the inputs out of L2: {times}; plain "
                  f"{row['plain_ms']:.4f} ms; bf16 conv2d (cuDNN, no quantization) "
                  f"{row['library_ms']:.4f} ms"
                  + (f"; torch._int_mm over the unfolded codes (the int32 product alone) "
                     f"{row['int_mm_ms']:.4f} ms" if row["int_mm_ms"] else "")
                  + (f"; {counts['bf16']} bf16 + {counts['f32']} float32 launches a chunk"
                     if count else " (not in the chunk's sum)"))
        least = sum_bounds(bounds)
        records[name] = {"max_abs_err": err, "ms": total["ms"], "plain_ms": total["plain_ms"],
                         **least, "library_ms": total["library_ms"],
                         "library_call": "F.conv2d in bf16 (cuDNN): another function, no "
                                         "quantization"}
        sites = sum(table.values())
        what = "ResNet-50's dense" if name == "igemm" else "MobileNetV2's depthwise"
        print(f"[17] conv_s8_{name}, one chunk's {sites} {what} int8 convs ({smi}): kernel "
              f"{total['ms']:.4f} ms with the inputs out of L2 ({least['bound_ms'] / total['ms']:.1%} "
              f"of the bound {least['bound_ms']:.4f} ms by {least['bound_by']}; "
              f"{_work(bounds)}); plain "
              f"{total['plain_ms']:.4f} ms; cuDNN bf16 {total['library_ms']:.4f} ms"
              + (f"; torch._int_mm at the shapes it takes {total['int_mm_ms']:.4f} ms"
                 if name == "igemm" else ""))
    return records


def _xla_profile(name: str, fn, k8, kc) -> None:
    """A chunk's device time (profiler), the int8 kernels' share and the
    device's idle share against the host's clock (median of 10).  The trace's
    launches of each int8 kernel a chunk are held to the wrappers' counters
    over one call; where the trace misses them, no device time is given."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall = float(np.median(times)) * 1e3
    k8.launches = kc.launches_quantize = kc.launches_igemm = kc.launches_direct = 0
    fn()
    counted = {"int8_strip_kernel": k8.launches, "quantize": kc.launches_quantize,
               "igemm": kc.launches_igemm, "direct": kc.launches_direct}
    names = {"int8_strip_kernel": ("int8_strip_kernel",), **INT8_CONV_ENTRIES}
    records = traced_records(fn, reps=5, warmup=1)
    traced = {n: sum(c for k, (_, c) in records.items() if any(p in k for p in names[n]))
              for n in counted}
    # float32 -> bf16: PyTorch's bf16 copy kernel on a float argument
    casts = sum(c for k, (_, c) in records.items()
                if "bfloat16_copy_kernel" in k and "(float)" in k)
    if traced != counted:
        print(f"[17] {name} chunk of 8 x 512^2: {wall:.3f} ms on the host's clock (median of "
              f"10); device time not measured: the trace counted int8 launches {traced} a "
              f"chunk, the counters {counted}")
        return
    kernels = {k: us * c / 1e3 for k, (us, c) in records.items()}
    busy = sum(kernels.values())
    matmul = sum(v for k, v in kernels.items() if "int8_strip_kernel" in k or "finish_split" in k)
    conv = sum(v for k, v in kernels.items() if any(n in k for n in INT8_CONV_KERNELS))
    print(f"[17] {name} chunk of 8 x 512^2: {wall:.3f} ms on the host's clock (median of 10), "
          f"{8 / wall * 1e3:.1f} tiles/s; device time {busy:.3f} ms (profiler; launches a "
          f"chunk equal to the counters: {counted}): int8_matmul {matmul:.3f} ms, int8_conv "
          f"{conv:.3f} ms, the rest {busy - matmul - conv:.3f} ms; device idle share "
          f"{max(0.0, 1 - busy / wall):.3f}; {casts} float32 -> bf16 casts a chunk")


def _plain_int8(model, on: bool) -> None:
    """Point the routed modules of ``model`` at the plain versions (on) or
    back at the kernels: the 1x1 modules' ``conv_fn`` and the kernels that
    ``ops/int8_xla.py``'s ``int8_conv``, which the other routed modules run,
    calls."""
    from iswm_tpu_torch.infer.quantization import Int8Conv1x1
    from iswm_tpu_torch.ops import int8_xla
    from iswm_tpu_torch.ops.kernels import int8_conv as kc
    from iswm_tpu_torch.ops.kernels.int8_matmul import quantized_conv1x1_plain

    for name, plain in (("quantize_s8", kc.quantize_s8_plain),
                        ("conv_s8_igemm", kc.conv_s8_plain), ("conv_s8_direct", kc.conv_s8_plain)):
        setattr(int8_xla, name, plain if on else getattr(kc, name))
    for m in model.modules():
        if isinstance(m, Int8Conv1x1):
            if on:
                m.conv_fn = quantized_conv1x1_plain
            else:
                del m.conv_fn


def phase_int8_xla_serving(k8, kc, smi: str) -> dict:
    """int8_exec_xla through ``Predictor`` on phase 4's two scenes: ResNet-50,
    ResNet-50 with int8_stem, MobileNetV2 with int8_grouped.  Each run's
    launches, counted from 0, and its scene logits equal (torch.equal) to the
    same Predictor's with every routed module on the plain versions
    (deterministic cuDNN for the rest); chunk profiles of bf16, int8_exec and
    int8_exec_xla; the mask agreement with bf16.  Returns the launches."""
    from iswm_tpu_torch.infer import Predictor, tile_origins
    from iswm_tpu_torch.infer.quantization import (
        Int8ConcatConvBN, Int8Conv, logit_diff_verdict)
    from iswm_tpu_torch.data import val_transform_batch

    rng = np.random.default_rng(SEED)
    scenes = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SCENES]
    xs = [val_transform_batch(torch.from_numpy(s).cuda()) for s in scenes]
    chunks = sum(-(-(len(tile_origins(h, 512, 448)) * len(tile_origins(w, 512, 448))) // 8)
                 for h, w in SCENES)
    dense = sum(XLA_IGEMM_SHAPES.values())
    runs = (  # name, model, flags, routed sites, per chunk: #1, quantize, dense, grouped
        ("deeplabv3plus_resnet50", {}, 62, (30, dense, dense, 0)),
        ("deeplabv3plus_resnet50", {"int8_stem": True}, 63, (30, dense + 1, dense + 1, 0)),
        ("deeplabv3plus_mobilenet", {"int8_grouped": True}, 51, None),
    )
    launches = dict.fromkeys(("matmul", "quantize", "igemm", "direct"), 0)
    bodies = dict.fromkeys(kc.launches_by_body, 0)  # which body of each conv ran
    preds = {}
    for name, flags, sites, per_chunk in runs:
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        cfg = _zoo_config(name, "int8_exec_xla")
        for key, value in flags.items():
            setattr(cfg.predict, key, value)
        pred = Predictor(cfg, device="cuda")
        k8.launches = kc.launches_quantize = kc.launches_igemm = kc.launches_direct = 0
        kc.launches_by_body.update(dict.fromkeys(kc.launches_by_body, 0))
        products = [pred.predict_image(s) for s in scenes]
        torch.cuda.synchronize()
        got = {"matmul": k8.launches, "quantize": kc.launches_quantize,
               "igemm": kc.launches_igemm, "direct": kc.launches_direct}
        for key, count in kc.launches_by_body.items():
            bodies[key] += count
        fn = pred.engine.model_fn
        label = f"{name} int8_exec_xla {flags or ''}".strip()
        print(f"[17] {label}: {len(scenes)} scenes, {chunks} chunks, {len(fn.routed_sites)} "
              f"routed sites; launches {got}, by body {kc.launches_by_body}")
        check(len(fn.routed_sites) == sites, f"{label}: {len(fn.routed_sites)} routed sites, "
                                             f"expected {sites}")
        if per_chunk:
            want = dict(zip(("matmul", "quantize", "igemm", "direct"),
                            (n * chunks for n in per_chunk)))
            check(got == want, f"{label}: launches {got}, expected {want}")
        else:
            check(got["direct"] > 0 and got["igemm"] > 0 and got["quantize"] > 0,
                  f"{label}: launches {got}")
        for key in launches:
            launches[key] += got[key]
        seen = set()
        if not flags:
            def record(mod, args):
                b, c, h, w = args[0].shape
                if isinstance(mod, Int8ConcatConvBN):
                    seen.update((b, h, w, p, 256, 3, 1, 1, 1) for p in mod.widths)
                else:
                    n, k = mod.w_q.shape[:2]
                    g = mod.geometry
                    seen.add((b, h, w, c, n, k, g["stride"][0], g["padding"][0],
                              g["dilation"][0]))

            hooks = [m.register_forward_pre_hook(record) for m in fn.model.modules()
                     if isinstance(m, (Int8Conv, Int8ConcatConvBN))]
        logits = [pred.engine.infer_scene(x) for x in xs]
        if not flags:
            for h in hooks:
                h.remove()
            check(seen == set(XLA_IGEMM_SHAPES),
                  f"routed dense shapes {sorted(seen)} != {sorted(XLA_IGEMM_SHAPES)}")
        for (h, w), lg, prod in zip(SCENES, logits, products):
            check(tuple(lg.shape) == (h, w, 2) and bool(torch.isfinite(lg).all()),
                  f"{label}: logits of the {h}x{w} scene: {tuple(lg.shape)} or not finite")
            check(np.array_equal(torch.softmax(lg, -1)[..., 1].cpu().numpy(), prod["prob_fg"]),
                  f"{label}: the rerun's logits differ from the counted run's")
        _plain_int8(fn.model, True)
        plain = [pred.engine.infer_scene(x) for x in xs]
        _plain_int8(fn.model, False)
        diff = max(float((a - b).abs().max()) for a, b in zip(logits, plain))
        check(all(torch.equal(a, b) for a, b in zip(logits, plain)),
              f"{label}: scene logits differ from the plain int8 path: max abs diff {diff}")
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        bf16 = Predictor(_zoo_config(name), device="cuda")
        agree, verdict = logit_diff_verdict(bf16.engine.infer_scene(xs[0]).cpu().numpy(),
                                            logits[0].cpu().numpy())
        print(f"[17] {label}: scene logits finite and equal to the plain int8 path (max abs "
              f"diff {diff}); mask agreement with bf16 {agree:.6f} ({verdict})")
        if not flags:
            preds = {"bf16": bf16, "int8_exec_xla": pred}
        else:
            del pred, bf16
    preds["int8_exec"] = Predictor(_zoo_config("deeplabv3plus_resnet50", "int8_exec"),
                                   device="cuda")
    preds["int8_exec"].predict_image(scenes[0])
    chunk = _chunk(scenes[0])
    for variant in ("bf16", "int8_exec", "int8_exec_xla"):
        fn = preds[variant].engine.model_fn
        _xla_profile(f"deeplabv3plus_resnet50 {variant} ({smi})", lambda: fn(chunk), k8, kc)
    for variant in ("bf16", "int8_exec", "int8_exec_xla"):
        for (h, w), scene in zip(SCENES, scenes):
            print(f"[17] deeplabv3plus_resnet50 {variant} {h}x{w} ({smi}): scene latency "
                  f"{_scene_latency(preds[variant], scene):.2f} ms (median of 5)")
    return {**launches, "bodies": bodies}


def phase_int8_xla_compare(kc) -> None:
    """``compare_variants`` with the six variants on phase 9's scenes."""
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import ArrayDataset, generate_scene
    from iswm_tpu_torch.infer import quantization as q
    from iswm_tpu_torch.models import build_model

    rng = np.random.default_rng(SEED)
    images, masks = zip(*(generate_scene(rng, size=(512, 512)) for _ in range(EVAL_SCENES)))
    dataset = ArrayDataset(np.stack(images), np.stack(masks))
    model = build_model(Config().model, seed=SEED).to("cuda", memory_format=torch.channels_last)
    kc.launches_igemm = 0
    t0 = time.perf_counter()
    report = q.compare_variants(model, dataset, XLA_VARIANTS, sequence_length=7)
    torch.cuda.synchronize()
    compare_s = time.perf_counter() - t0
    print(q.format_report(report))
    check(list(report) == list(XLA_VARIANTS), f"variants reported: {list(report)}")
    for name, r in report.items():
        numbers = [r[k] for k in ("avg_latency_ms", "miou", "fiou", "ff1", "weighted",
                                  "size_mb", "mask_agreement")]
        check(bool(np.isfinite(numbers).all()) and r["avg_latency_ms"] > 0,
              f"{name}: latency or metrics not finite: {r}")
    dense = sum(XLA_IGEMM_SHAPES.values())
    check(kc.launches_igemm == dense * (EVAL_SCENES + 1),
          f"int8_exec_xla launched {kc.launches_igemm} dense convs, expected {dense} for each "
          f"of {EVAL_SCENES} images and the probe")
    print(f"[17] compare_variants, ResNet-50 / OS 16 / bf16, {EVAL_SCENES} scenes of 512x512, "
          f"{len(XLA_VARIANTS)} variants in {compare_s:.2f} s; int8_exec_xla dense conv "
          f"launches {kc.launches_igemm} = {dense} x ({EVAL_SCENES} images + 1 probe); "
          f"int8_exec_xla vs f32 mask agreement {report['int8_exec_xla']['mask_agreement']:.6f}")

QAT_GATE = 256  # bench.py's int8_train row: int8_training=256, the gate route
QAT_SITES = {"train": 49, "eval": 45}  # routed sites of a forward (the JAX package's)
# the weight gradient's launches a step by body: the ASPP's two pooled-part
# sites (M = 8) keep the mma body, every other routed site runs wgmma
QAT_WGRAD_BODIES = {"wgmma": 47, "mma": 2}
# the data gradients of a step split by output parity (its three stride-2 sites)
QAT_DGRAD_PARITY = 3
QAT_STEPS = 4  # each fit: a quick-eval at step 2 and the validation at 4


def _qat_inputs(model, x, training: bool) -> list:
    """(x, w, amax, stride, padding, dilation) at every routed site of one
    forward of ``model`` on ``x`` in that mode, in order (the real inputs of
    the int8 forward: the site's input as the quantize got it, NCHW, and the
    amax its codes were made with)."""
    from iswm_tpu_torch.ops import int8_train

    seen, inputs = [], []
    forward, quantize = int8_train.int8_conv_forward, int8_train.quantize_activation

    def record_input(x, *a, **k):
        out = quantize(x, *a, **k)
        inputs.append((x, out[1].clone()))
        return out

    def record(x_q, w, amax, stride=1, padding=0, dilation=1, dtype=torch.float32):
        xs, a = inputs.pop()
        seen.append((xs, w, a, stride, padding, dilation))
        return forward(x_q, w, amax, stride, padding, dilation, dtype)

    int8_train.int8_conv_forward, int8_train.quantize_activation = record, record_input
    try:
        model.train(training)
        with torch.no_grad():
            model(x)
    finally:
        int8_train.int8_conv_forward, int8_train.quantize_activation = forward, quantize
    return seen


def _reduce_checks(kc, x: torch.Tensor) -> bool:
    """The reducing quantize at NCHW x's rows in its three modes against
    ``activation_amax`` + ``quantize_s8_plain``: the amax bit for bit, the
    codes with it, the delayed mode's codes of half of it beside ``max
    |x|``."""
    from iswm_tpu_torch.ops.int8_train import _rows_view, activation_amax

    rows = _rows_view(x.detach())
    amax = activation_amax(x)
    q, got = kc.quantize_s8_reduce(rows, "dynamic")
    same = torch.equal(got, amax) and torch.equal(q, kc.quantize_s8_plain(rows, amax))
    same = same and torch.equal(kc.quantize_s8_reduce(rows, "amax")[1], amax)
    half = amax * 0.5
    q, cur = kc.quantize_s8_reduce(rows, "delayed", half)
    return same and torch.equal(cur, amax) and torch.equal(q, kc.quantize_s8_plain(rows, half))


def _quantize_bound(x: torch.Tensor) -> dict:
    """The reducing quantize's least time: x read once, the codes written, the
    amax (4 bytes); one division a value."""
    n = x.numel()
    nbytes = n * (x.element_size() + 1) + 4
    return {"bytes": nbytes, "ops": n, **least_time(nbytes, n, F32_OPS_PER_S)}


def phase_qat_kernels(kc, smi: str) -> dict:
    """The device-scale entries against the host-scale entries and the plain
    versions, bit for bit, at every routed site's real input; their device
    time over a train step's sites with the inputs out of L2 and the bound."""
    from iswm_tpu_torch.models import build_model_by_name
    from iswm_tpu_torch.ops.int8_train import _rows_view, quantize_weight

    model = build_model_by_name("deeplabv3plus_resnet50", int8_training=QAT_GATE)
    model.to("cuda", memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((8, 3, 512, 512), generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    from iswm_tpu_torch.ops.int8_train import activation_amax

    sites = {mode: _qat_inputs(model, x, mode == "train") for mode in QAT_SITES}
    for mode, n in QAT_SITES.items():
        check(len(sites[mode]) == n, f"a {mode} forward routed {len(sites[mode])} sites, not {n}")
    shapes, checked = {}, {}
    for mode in ("train", "eval"):
        for xs, w, amax, stride, pad, dil in sites[mode]:
            key = (tuple(xs.shape), tuple(w.shape), stride, pad, dil)
            if mode == "train":
                shapes[key] = shapes.get(key, 0) + 1
            # the forward's amax came from the reducing quantize: the plain max's
            check(torch.equal(amax, activation_amax(xs)) and _reduce_checks(kc, xs),
                  f"the reducing quantize != activation_amax + quantize_s8_plain at {key}")
            if key in checked:
                continue
            rows = _rows_view(xs)  # as the int8 forward reads it
            w_q, w_s = quantize_weight(w)
            for a in (amax, torch.zeros_like(amax)) if not checked else (amax,):
                scale = float(kc.scale_of(a, "cuda"))
                q = kc.quantize_s8(rows, a)
                geo = dict(stride=stride, padding=pad, dilation=dil, out_dtype=xs.dtype)
                got = kc.conv_s8_igemm(q, w_q, w_s, a, **geo)
                same = (torch.equal(q, kc.quantize_s8(rows, scale))
                        and torch.equal(q, kc.quantize_s8_plain(rows, a))
                        and torch.equal(got, kc.conv_s8_igemm(q, w_q, w_s, scale, **geo))
                        and torch.equal(got, kc.conv_s8_plain(q, w_q, w_s, a, **geo)))
                torch.cuda.synchronize()
                check(same and got.dtype == xs.dtype,
                      f"device-scale entries != host-scale / plain at {key}, amax {float(a)}")
            checked[key] = True
    print(f"[18] device-scale quantize_s8 and conv_s8_igemm at the real inputs of all "
          f"{QAT_SITES['train']} train-forward and {QAT_SITES['eval']} eval-forward routed sites "
          f"({len(checked)} shapes, bf16 out) and at a zero amax: bit-equal (torch.equal) to the "
          "host-scale entries fed the scale they form and to the plain versions; the forward's "
          "amaxes (from the reducing quantize) and quantize_s8_reduce in its dynamic, amax and "
          "delayed modes at every site: bit-equal to activation_amax + quantize_s8_plain")
    cold = ColdTimer(reps=5)
    total = {"quantize": 0.0, "igemm": 0.0, "single_pass": 0.0}
    bounds = {"quantize": [], "igemm": []}
    for (xshape, wshape, stride, pad, dil), count in shapes.items():
        xs, w, amax = next((s[0], s[1], s[2]) for s in sites["train"]
                           if (tuple(s[0].shape), tuple(s[1].shape), *s[3:]) ==
                           (xshape, wshape, stride, pad, dil))
        rows = _rows_view(xs)
        w_q, w_s = quantize_weight(w)
        q = kc.quantize_s8(rows, amax)
        ms = cold(lambda: kc.quantize_s8_reduce(rows, "dynamic"))
        single = cold(lambda: kc.quantize_s8(rows, amax))
        total["quantize"] += count * ms
        total["single_pass"] += count * single
        total["igemm"] += count * cold(lambda: kc.conv_s8_igemm(
            q, w_q, w_s, amax, stride=stride, padding=pad, dilation=dil, out_dtype=xs.dtype))
        bound = _quantize_bound(xs)
        bounds["quantize"] += [bound] * count
        print(f"[18] quantize_s8_reduce (dynamic) at x {tuple(xs.shape)}"
              f"{' (a channel slice)' if rows.stride(2) != xs.shape[1] else ''}, {count} site(s) "
              f"({smi}): {ms:.4f} ms ({bound['bound_ms'] / ms:.1%} of its bound "
              f"{bound['bound_ms']:.4f} ms); the same body's one pass at a device amax "
              f"(quantize_s8) {single:.4f} ms", flush=True)
        b, c, h, wd = xs.shape
        one = [v if isinstance(v, int) else v[0] for v in (stride, pad, dil)]
        bounds["igemm"] += [conv_bound(b, h, wd, c, wshape[0], wshape[2], *one,
                                       out_bytes=2)] * count
    del sites, model
    records = {}
    for key in bounds:
        least = sum_bounds(bounds[key])
        records[key] = {"ms": total[key], **least}
        print(f"[18] device-scale "
              f"{'quantize_s8_reduce (dynamic)' if key == 'quantize' else 'conv_s8_igemm'} "
              f"over a train step's {QAT_SITES['train']} routed sites ({smi}): "
              f"{total[key]:.4f} ms with the inputs out of L2, "
              f"{least['bound_ms'] / total[key]:.1%} of the bound {least['bound_ms']:.4f} ms "
              f"by {least['bound_by']} ({_work(bounds[key])})"
              + (f"; the one-pass quantize_s8 at the device amax {total['single_pass']:.4f} ms"
                 if key == "quantize" else ""))
    return records


def _counting_steps(trainer, log: list):
    """Wrap ``trainer.train_step``: each step appends (step, device-scale
    quantize and dense-conv launches in it)."""
    from iswm_tpu_torch.ops.kernels import int8_conv as kc

    step = trainer.train_step

    def counted(state, images, labels):
        before = [kc.launches_by_scale[e]["device"] for e in ("quantize", "igemm")]
        out = step(state, images, labels)
        log.append((state.step - 1, *(kc.launches_by_scale[e]["device"] - b
                                      for e, b in zip(("quantize", "igemm"), before))))
        return out

    trainer.train_step = counted


def phase_qat_train(kc, smi: str) -> dict:
    """The QAT main path: fits in dynamic mode, delayed mode and dynamic mode
    switching to bf16 at step 2; launches a step and an eval forward; a
    forward and backward without a host sync; the QAT and the bf16 step's
    times; ``int8_exec_xla`` serving from the delayed run's checkpoint.
    Returns the main path's launches of the quantize and the dense conv by
    the scale's source."""
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.data import val_transform_batch
    from iswm_tpu_torch.infer import Predictor
    from iswm_tpu_torch.infer.quantization import conv_scales_from_quant
    from iswm_tpu_torch.models.layers import quant_state, routed_sites

    t0 = time.perf_counter()
    for entry in kc.launches_by_scale.values():
        entry.update(dict.fromkeys(entry, 0))
    runs = {"dynamic": ({}, {}), "delayed": ({"int8_scale_mode": "delayed"}, {}),
            "switch at 2": ({}, {"int8_switch_iter": 2})}
    trainers = {}
    for name, (model, train) in runs.items():
        trainer, cfg, train_ds, _ = _slice_trainer(
            QAT_STEPS, f"chip_smoke_qat_{name.split()[0]}", train=train,
            int8_training=QAT_GATE, **model)
        log = []
        _counting_steps(trainer, log)
        trainer.fit()
        losses = trainer.logger.history["train_loss"]
        check(len(losses) == 2 and bool(np.isfinite(losses).all()),
              f"QAT {name}: losses {losses}")
        sites = QAT_SITES["train"]
        want = [(i, sites, sites) if i < train.get("int8_switch_iter", QAT_STEPS) else (i, 0, 0)
                for i in range(QAT_STEPS)]
        check(log == want, f"QAT {name}: device-scale launches by step {log}, expected {want}")
        amaxes = quant_state(trainer.state.model)
        print(f"[18] QAT {name} fit ({smi}): {QAT_STEPS} steps, losses {losses}, quick-eval and "
              f"validation; device-scale (quantize, conv) launches by step {log}; "
              f"{len(amaxes)} running amaxes, best checkpoint {trainer.best_path is not None}")
        trainers[name] = trainer
    switched = trainers.pop("switch at 2")  # from step 2 on, the bf16 model
    check(not routed_sites(switched.state.model, True) and not quant_state(switched.state.model),
          "the switched model still routes or keeps amaxes")
    delayed = trainers["delayed"]
    check(len(quant_state(delayed.state.model)) > 0 and all(
        float(v) > 0 for v in quant_state(delayed.state.model).values()),
        "delayed mode's running amaxes are not all positive")

    # launches of a step and an eval forward; one forward and backward with no sync
    trainer = trainers["dynamic"]
    gen = torch.Generator().manual_seed(SEED)
    xu8 = torch.randint(0, 256, (8, 512, 512, 3), dtype=torch.uint8, generator=gen).cuda()
    yu8 = torch.randint(0, 2, (8, 512, 512), dtype=torch.uint8, generator=gen).cuda()
    model, loss_fn = trainer.state.model, trainer.loss_fn
    x = val_transform_batch(xu8).permute(0, 3, 1, 2)
    model.train()
    for _ in range(2):
        loss_fn(model(x), yu8).backward()
    torch.cuda.synchronize()
    kc.launches_quantize = kc.launches_igemm = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = loss_fn(model(x), yu8)
        fwd = (kc.launches_quantize, kc.launches_igemm)
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    loss = float(loss.detach())
    check(fwd == (QAT_SITES["train"],) * 2 and np.isfinite(loss),
          f"a QAT train forward launched {fwd}, loss {loss}")
    kc.launches_quantize = kc.launches_igemm = 0
    eval_logits = trainer.eval_step(xu8)["preds"]
    torch.cuda.synchronize()
    ev = (kc.launches_quantize, kc.launches_igemm)
    check(ev == (QAT_SITES["eval"],) * 2 and eval_logits.shape == (8, 512, 512),
          f"a QAT eval forward launched {ev}")
    print(f"[18] QAT train forward: {fwd[0]} quantize + {fwd[1]} dense conv launches, all "
          f"device-scale; forward and backward under set_sync_debug_mode('error') with no "
          f"synchronizing call; eval forward (dynamic scales): {ev[0]} + {ev[1]}")

    # the QAT step against the bf16 step (the switched run's model), in this run
    times = {}
    for name, t in (("QAT", trainer), ("bf16", switched)):
        host = _median_step_ms(t, xu8, yu8)
        dev, launches, by_class = _step_profile(t, xu8, yu8)
        times[name] = (float(np.median(host)), dev, launches)
        print(f"[18] {name} train step, ResNet-50 batch 8 at 512^2 ({smi}): host "
              f"{times[name][0]:.2f} ms (median of 8), device {dev:.2f} ms (profiler, "
              f"{launches} kernel launches), by class "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])))
    print(f"[18] QAT / bf16 step ({smi}): host {times['QAT'][0] / times['bf16'][0]:.3f}, device "
          f"{times['QAT'][1] / times['bf16'][1]:.3f}; {times['QAT'][2] - times['bf16'][2]} more "
          "launches a step")
    del switched, trainers, trainer, model

    # int8_exec_xla serving from the delayed run's checkpoint
    path = delayed.best_path
    cfg = Config()
    cfg.predict.serving_variant = "int8_exec_xla"
    pred = Predictor(cfg, ckpt_path=path, device="cuda")
    learned = conv_scales_from_quant(pred.quant)
    scene = np.random.default_rng(SEED).integers(0, 256, SCENES[0] + (3,), dtype=np.uint8)
    kc.launches_quantize = kc.launches_igemm = 0
    products = pred.predict_image(scene)
    torch.cuda.synchronize()
    routed = set(pred.engine.model_fn.routed_sites)
    check(bool(np.isfinite(products["prob_fg"]).all()) and kc.launches_igemm > 0,
          "int8_exec_xla serving from the QAT checkpoint")
    print(f"[18] int8_exec_xla serving of a {SCENES[0][0]}x{SCENES[0][1]} scene from the delayed "
          f"QAT checkpoint: {len(learned)} learned scales merged ({len(set(learned) & routed)} at "
          f"routed serving sites of {len(routed)}), {kc.launches_quantize} quantize + "
          f"{kc.launches_igemm} dense conv launches; the training part took "
          f"{time.perf_counter() - t0:.1f} s")
    return {e: dict(v) for e, v in kc.launches_by_scale.items()}


# ------------------------------------------------- QAT's int8 backward
def _qat_bwd_calls(model, x, yu8, mesh=None) -> list:
    """The int8 backward's kernel calls of one forward and backward of
    ``model`` on ``x`` (train mode, a cross-entropy on ``yu8``), in order:
    (kind, args, kwargs), the arguments as the entries got them (the real
    activations, cotangents, weights and codes): ``quantize_x`` /
    ``quantize_g`` (the forward's and the backward's ``quantize_activation``:
    NCHW x or g), ``rotated`` (the data gradient's weights), ``dgrad``,
    ``wgrad``.  With a ``mesh`` of a model axis, ``x`` and ``yu8`` are this
    rank's image rows of an image of twice their height, the forward runs
    under ``spatially_split`` and the forward's convs (``igemm``) are
    recorded too."""
    import contextlib

    from iswm_tpu_torch.ops import int8_train
    from iswm_tpu_torch.parallel import spatial

    calls, saved, part = [], {}, ["x"]
    kinds = {"conv_s8_dgrad": "dgrad", "conv_s8_wgrad": "wgrad",
             "rotated_weight_codes": "rotated", "quantize_activation": "quantize",
             **({} if mesh is None else {"conv_s8_igemm": "igemm"})}
    for name, kind in kinds.items():
        fn = saved[name] = getattr(int8_train, name)

        def record(*a, kind=kind, fn=fn, **k):
            calls.append((f"quantize_{part[0]}" if kind == "quantize" else kind, a, k))
            return fn(*a, **k)

        setattr(int8_train, name, record)
    split = (contextlib.nullcontext() if mesh is None
             else spatial.spatially_split(mesh, x.shape[2] * mesh.model))
    try:
        model.train()
        with split:
            logits = model(x)
        part[0] = "g"
        torch.nn.functional.cross_entropy(logits.float(), yu8.long()).backward()
    finally:
        for name, fn in saved.items():
            setattr(int8_train, name, fn)
    model.zero_grad(set_to_none=True)
    return calls


def _dgrad_kernel(a, k) -> tuple:
    """(KH, KW) of a recorded conv_s8_dgrad call (its weights as the rotated
    codes or their rows)."""
    if a[1].dim() == 4:
        return tuple(a[1].shape[1:3])
    ks = k["kernel_size"]
    return (ks, ks) if isinstance(ks, int) else tuple(ks)


def _bwd_bound(kind: str, a, k) -> dict:
    """The least time of one backward entry's call: its operands read once
    and its output written once, or its products (2 N C a valid tap of an
    output pixel of the forward, as the forward's) at the int8 rate."""
    if kind == "dgrad":
        g_q, w_q, _, _, x_hw = a[:5]
        b, ho, wo, n = g_q.shape
        c = w_q.shape[0]
        kh, kw = _dgrad_kernel(a, k)
        h, w = x_hw
        out = b * h * w * c
        nbytes = g_q.numel() + c * kh * kw * n + out * k["out_dtype"].itemsize
    else:
        x_q, g_q, _, _, kernel = a[:5]
        b, h, w, c = x_q.shape
        n = g_q.shape[3]
        kh = kw = kernel if isinstance(kernel, int) else kernel[0]
        nbytes = x_q.numel() + g_q.numel() + n * c * kh * kw * k["out_dtype"].itemsize
    stride, pad, dil = (v if isinstance(v, int) else v[0] for v in a[5:8])
    ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
    taps = _valid_taps(h, ho, kh, stride, pad, dil) * _valid_taps(w, wo, kw, stride, pad, dil)
    ops = 2 * b * taps * n * c
    return {"bytes": nbytes, "ops": ops, **least_time(nbytes, ops, INT8_OPS_PER_S)}


def _bwd_library(kc, kind: str, a, k):
    """cuDNN's bf16 backward of the same conv (another function: no
    quantization), the half the entry computes: a call of
    ``aten.convolution_backward`` on the codes as bf16, channels last."""
    if kind == "dgrad":
        g_q, w_q, _, _, x_hw = a[:5]
        w_q = kc._rotated_codes(w_q, _dgrad_kernel(a, k), g_q.shape[3], a[5])
        w = w_q.flip(1, 2).permute(3, 0, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        x = torch.empty((g_q.shape[0], w_q.shape[0], *x_hw), dtype=torch.bfloat16,
                        device="cuda").contiguous(memory_format=torch.channels_last)
        mask = [True, False, False]
    else:
        x_q, g_q = a[:2]
        kh, kw = (a[4], a[4]) if isinstance(a[4], int) else a[4]
        x = x_q.to(torch.bfloat16).permute(0, 3, 1, 2)
        w = torch.empty((g_q.shape[3], x_q.shape[3], kh, kw), dtype=torch.bfloat16,
                        device="cuda").contiguous(memory_format=torch.channels_last)
        mask = [False, True, False]
    g = g_q.to(torch.bfloat16).permute(0, 3, 1, 2)
    stride, pad, dil = ([v, v] if isinstance(v, int) else list(v) for v in a[5:8])
    return lambda: torch.ops.aten.convolution_backward(g, x, w, None, stride, pad, dil, False,
                                                       [0, 0], 1, mask)


WGRAD_BODIES = {
    "wgmma": "planar_kernel (x and g made pixel-major once a call, x in a copy for each column "
             "shift of the kernel with its padding written as zeros, so that every K stage is "
             "128 contiguous bytes a channel) + wgrad_tma_kernel (a 128-byte TMA box of each "
             "operand a stage in the 128-byte swizzle, wgmma m64nNk32 .s32.s8.s8, a producer "
             "warp and a 4-slot mbarrier ring, tile-level tap skip, planned work items) + "
             "wgrad_tma_finish (the items' int32 partials added through 32 x 32 shared-memory "
             "tiles, OIHW)",
    "mma": "wgrad_mma_kernel (PR 18: 4 x 4 byte transposes in registers, mma.sync m16n8k32) + "
           "wgrad_finish; the ASPP's pooled part (M = 8)"}


DGRAD_BODIES = {
    "wgmma": "igemm_wgmma_kernel over the int8 cotangent with the rotated per-tensor codes "
             "(the transpose padding, x's extent; its epilogue's scale g_s * w_s)",
    "parity": "at a stride above 1, igemm_wgmma_kernel's Parity template: every output parity "
              "class of dx in one launch (blockIdx.y), each a stride-1 conv of the undilated "
              "cotangent over its taps from a table, its rows of dx written strided; a class of "
              "no tap writes zeros",
    "weights": "rotated_codes_kernel: the float kernel's amax, a grid barrier, the rotated, "
               "I/O-swapped per-tensor codes as the dense body's rows (one cooperative launch)"}


def _reduce_in_group(kc, xs: list) -> None:
    """``quantize_activation`` across the ranks of a 1-rank nccl group at
    each NCHW tensor of ``xs``: the amax mode (one launch), the all-reduce,
    the device-amax quantize; the codes and the amax bit-equal to
    ``activation_amax`` + ``quantize_s8_plain``."""
    from iswm_tpu_torch.ops import int8_train
    from iswm_tpu_torch.parallel import destroy

    _open_group("phase19.nccl")
    try:
        before = (dict(kc.launches_reduce), int8_train.amax_all_reduces, kc.launches_quantize)
        for x in xs:
            x_q, amax, cur = int8_train.quantize_activation(x, across_ranks=True)
            want = int8_train.activation_amax(x)
            rows = int8_train._rows_view(x.detach())
            check(torch.equal(amax, want) and cur is amax
                  and torch.equal(x_q, kc.quantize_s8_plain(rows, want)),
                  f"the group's quantize at {tuple(x.shape)} != activation_amax + plain")
        torch.cuda.synchronize()
        n = len(xs)
        got = (kc.launches_reduce["amax"] - before[0]["amax"],
               kc.launches_reduce["dynamic"] - before[0]["dynamic"],
               int8_train.amax_all_reduces - before[1], kc.launches_quantize - before[2])
        check(got == (n, 0, n, n), f"in a group (amax, dynamic, all-reduces, quantizes) {got}, "
                                   f"expected {(n, 0, n, n)}")
    finally:
        destroy()
    print(f"[19] in a 1-rank nccl group: quantize_activation across the ranks at the step's {n} "
          f"activations and cotangents: {n} amax-mode launches, {n} all-reduces, {n} quantizes "
          "at the reduced amax; codes and amax bit-equal to activation_amax + quantize_s8_plain")


def phase_qat_bwd_kernels(kc, smi: str) -> dict:
    """The int8 backward's kernels at the real activations, cotangents,
    weights and codes of every routed site of one int8-backward QAT step
    (ResNet-50, batch 8 at 512^2, gate 256) and at a zero cotangent: the
    reducing quantize (the forward's 49 activations and the backward's 49
    cotangents, its three modes, and through a 1-rank nccl group), the data
    gradient's weight codes, conv_s8_dgrad and conv_s8_wgrad, bit-equal to
    their plain versions; their device time over the step's sites with the
    inputs out of L2 beside the bounds, the plain versions, cuDNN's bf16
    backward and, for the 1x1 weight gradients, torch._int_mm's int32
    product alone; both gradients per shape (the weight gradient by kernel:
    its planar copies apart), and their calls by body."""
    from iswm_tpu_torch.models import build_model_by_name
    from iswm_tpu_torch.ops.int8_train import _rows_view

    model = build_model_by_name("deeplabv3plus_resnet50", int8_training=QAT_GATE,
                                int8_training_bwd=True)
    model.to("cuda", memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((8, 3, 512, 512), generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    yu8 = torch.randint(0, 2, (8, 512, 512), generator=gen, device="cuda")
    calls = _qat_bwd_calls(model, x, yu8)
    del model, x
    sites = QAT_SITES["train"]
    kinds = [c[0] for c in calls]
    counted = {kind: kinds.count(kind) for kind in ("quantize_x", "quantize_g", "rotated",
                                                    "dgrad", "wgrad")}
    check(set(counted.values()) == {sites}, f"an int8-backward step made {counted} calls, "
                                            f"expected {sites} of each")
    check(sum(kc.dgrad_launch(a[0].shape, a[1].shape[0], _dgrad_kernel(a, k), *a[4:8])["parity"]
              for kind, a, k in calls if kind == "dgrad") == QAT_DGRAD_PARITY,
          f"the step's data gradients split by parity are not {QAT_DGRAD_PARITY}")
    plains = {"dgrad": kc.conv_s8_dgrad_plain, "wgrad": kc.conv_s8_wgrad_plain,
              "rotated": kc.rotated_weight_codes_plain}
    entries = {"dgrad": kc.conv_s8_dgrad, "wgrad": kc.conv_s8_wgrad,
               "rotated": kc.rotated_weight_codes}
    err = dict.fromkeys(entries, 0.0)
    strided = next(i for i, (kind, a, _) in enumerate(calls)
                   if kind == "dgrad" and a[5] not in (1, [1, 1]))
    pooled = next(i for i, (kind, a, _) in enumerate(calls)
                  if kind == "dgrad" and a[0].shape[1:3] == (1, 1))
    # a zero cotangent at a strided site and at the pooled part: each dgrad, then its wgrad
    zero_sites = {strided, pooled, strided + 1, pooled + 1}
    for i, (kind, a, k) in enumerate(calls):
        if kind.startswith("quantize"):
            check(_reduce_checks(kc, a[0]), f"the reducing quantize != plain at {kind} "
                                            f"{tuple(a[0].shape)}")
            if i + 2 in (strided, pooled):  # this site's cotangent, all zeros
                check(_reduce_checks(kc, torch.zeros_like(a[0])),
                      f"the reducing quantize of zeros != plain at {tuple(a[0].shape)}")
            continue
        args = [a]
        if i in zero_sites:  # a zero cotangent: amax 0, scale 1, codes 0
            g_at = 0 if kind == "dgrad" else 1
            zero = list(a)
            zero[g_at] = torch.zeros_like(a[g_at])
            zero[2 if kind == "dgrad" else 3] = torch.zeros_like(a[2 if kind == "dgrad" else 3])
            args.append(tuple(zero))
        for aa in args:
            got, want = entries[kind](*aa, **k), plains[kind](*aa, **k)
            torch.cuda.synchronize()
            got, want = (got, want) if kind != "rotated" else (got[0], want[0])
            diff = float((got.float() - want.float()).abs().max())
            err[kind] = max(err[kind], diff)
            same = got.dtype == want.dtype and torch.equal(got, want)
            if kind == "rotated":  # and the amax
                same = same and torch.equal(entries[kind](*aa)[1], plains[kind](*aa)[1])
            check(same,
                  f"{kind} != plain at call {i} {tuple(aa[0].shape)}: max abs err {diff}")
    print(f"[19] the reducing quantize at the step's {2 * sites} activations and cotangents "
          f"(dynamic, amax, delayed), the data gradient's weight codes, conv_s8_dgrad "
          f"({QAT_DGRAD_PARITY} split by parity) and conv_s8_wgrad at the real tensors of all "
          f"{sites} routed sites of an int8-backward QAT step ({len(calls)} calls; the pooled "
          f"part at M = 8) and at a zero cotangent at a strided site and the pooled part: "
          f"bit-equal (torch.equal) to the plain versions in the sites' dtypes "
          f"({next(k for kind, _, k in calls if kind == 'dgrad')['out_dtype']})")
    _reduce_in_group(kc, [a[0] for kind, a, _ in calls if kind.startswith("quantize")])
    bodies = {b: 0 for b in QAT_WGRAD_BODIES}
    for kind, a, _ in calls:
        if kind == "wgrad":
            bodies[kc.wgrad_body(_wgrad_geometry(kc, a))] += 1
    check(bodies == QAT_WGRAD_BODIES, f"the step's weight gradients by body {bodies}, expected "
                                      f"{QAT_WGRAD_BODIES}")

    # device time over the step's sites: each distinct shape once, times its count
    shapes = {}
    for kind, a, k in calls:
        key = (kind, *(tuple(t.shape) if isinstance(t, torch.Tensor) else str(t) for t in a),
               str(k))
        shapes.setdefault(key, [kind, a, k, 0])[3] += 1
    cold = ColdTimer(reps=5)
    records = {}
    for name in ("quantize_x", "quantize_g", "rotated", "dgrad", "wgrad"):
        total = dict.fromkeys(("ms", "plain_ms", "library_ms", "int_mm_ms", "planar_ms"), 0.0)
        bounds, per_shape = [], []
        for kind, a, k, count in shapes.values():
            if kind != name:
                continue
            if name.startswith("quantize"):
                rows = _rows_view(a[0].detach())
                ms = cold(lambda: kc.quantize_s8_reduce(rows, "dynamic"))
                total["ms"] += count * ms
                total["plain_ms"] += count * cuda_ms(
                    lambda: kc.quantize_s8_reduce_plain(rows, "dynamic"), reps=2, warmup=1)
                bounds += [_quantize_bound(rows)] * count
                continue
            if name == "rotated":
                ms = cold(lambda: kc.rotated_weight_codes(*a))
                total["ms"] += count * ms
                total["plain_ms"] += count * cuda_ms(
                    lambda: kc.rotated_weight_codes_plain(*a), reps=2, warmup=1)
                n = a[0].numel()
                nbytes = n * (a[0].element_size() + 1) + 4
                bounds += [{"bytes": nbytes, "ops": n,
                            **least_time(nbytes, n, F32_OPS_PER_S)}] * count
                continue
            by_kernel = cold.kernels(lambda: entries[kind](*a, **k))
            ms = sum(by_kernel.values())
            library_ms = cold(_bwd_library(kc, kind, a, k))
            total["ms"] += count * ms
            total["plain_ms"] += count * cuda_ms(lambda: plains[kind](*a, **k), reps=1, warmup=1)
            total["library_ms"] += count * library_ms
            bound = _bwd_bound(kind, a, k)
            bounds += [bound] * count
            if kind == "dgrad":
                lay = kc.dgrad_launch(a[0].shape, a[1].shape[0], _dgrad_kernel(a, k), *a[4:8],
                                      out_dtype=k["out_dtype"])
                row = {"g": list(a[0].shape), "x_hw": list(a[4]),
                       "kernel": list(_dgrad_kernel(a, k)),
                       "stride": str(a[5]), "padding": str(a[6]), "dilation": str(a[7]),
                       "count": count, "parity": lay["parity"],
                       "plan": [lay["plan"][key] for key in ("tw", "bn", "slots", "splits")],
                       "ms": ms, "bound_ms": bound["bound_ms"], "library_ms": library_ms}
                per_shape.append(row)
                print(f"[19] conv_s8_dgrad at g {tuple(a[0].shape)} -> x {tuple(a[4])} k "
                      f"{row['kernel']} s {a[5]} p {a[6]} d {a[7]}, {count} site(s), "
                      f"{'parity classes' if lay['parity'] else 'dense'} plan {row['plan']} "
                      f"({smi}): {ms:.4f} ms ({bound['bound_ms'] / ms:.1%} of its bound "
                      f"{bound['bound_ms']:.4f} ms); cuDNN bf16 dx {library_ms:.4f} ms", flush=True)
            if kind == "wgrad":
                planar = sum(v for key, v in by_kernel.items() if "planar_kernel" in key)
                main = sum(v for key, v in by_kernel.items()
                           if "wgrad_tma_kernel" in key or "wgrad_mma_kernel" in key)
                total["planar_ms"] += count * planar
                row = {"x": list(a[0].shape), "g": list(a[1].shape), "kernel": str(a[4]),
                       "stride": str(a[5]), "padding": str(a[6]), "dilation": str(a[7]),
                       "count": count, "body": kc.wgrad_body(_wgrad_geometry(kc, a)), "ms": ms,
                       "bound_ms": bound["bound_ms"], "library_ms": library_ms,
                       "planar_ms": planar, "main_ms": main, "finish_ms": ms - planar - main}
                per_shape.append(row)
                print(f"[19] conv_s8_wgrad at x {tuple(a[0].shape)} g {tuple(a[1].shape)} k "
                      f"{a[4]} s {a[5]} p {a[6]} d {a[7]}, {count} site(s), body {row['body']} "
                      f"({smi}): {ms:.4f} ms ({bound['bound_ms'] / ms:.1%} of its bound "
                      f"{bound['bound_ms']:.4f} ms): planar copies {planar:.4f}, main kernel "
                      f"{main:.4f}, finishing pass {ms - planar - main:.4f}; cuDNN bf16 dW "
                      f"{library_ms:.4f} ms", flush=True)
            if kind == "wgrad" and a[4] in (1, (1, 1)) and a[5] in (1, [1, 1]):
                p = a[1].shape[0] * a[1].shape[1] * a[1].shape[2]
                gt = a[1].reshape(p, -1).t().contiguous()  # [N, P]
                int_mm = _int_mm(gt, a[0].reshape(p, -1))
                total["int_mm_ms"] += count * (cold(int_mm) if int_mm else 0.0)
        least = sum_bounds(bounds)
        records[name] = {"max_abs_err": err.get(name, 0.0), "ms": total["ms"],
                         "plain_ms": total["plain_ms"], **least,
                         "library_ms": total["library_ms"] if name in ("dgrad", "wgrad") else None}
        label = {"quantize_x": "quantize_s8_reduce (dynamic) at the forward's activations",
                 "quantize_g": "quantize_s8_reduce (dynamic) at the backward's cotangents",
                 "rotated": "rotated_weight_codes", "dgrad": "conv_s8_dgrad",
                 "wgrad": "conv_s8_wgrad"}[name]
        if name in ("dgrad", "wgrad"):
            records[name]["library_call"] = (
                "aten.convolution_backward in bf16 (cuDNN), the "
                f"{'input' if name == 'dgrad' else 'weight'} half: another function, no "
                "quantization")
            records[name]["per_shape"] = per_shape
        if name == "wgrad":
            records[name]["int_mm_ms_1x1"] = total["int_mm_ms"]
            records[name]["planar_copies_ms"] = total["planar_ms"]
        print(f"[19] {label} over an int8-backward QAT step's {sites} routed sites ({smi}): "
              f"kernel {total['ms']:.4f} ms with the inputs out of L2 "
              f"({least['bound_ms'] / total['ms']:.1%} of the bound {least['bound_ms']:.4f} ms "
              f"by {least['bound_by']}; {_work(bounds)}); plain {total['plain_ms']:.4f} ms"
              + (f"; cuDNN bf16 backward {total['library_ms']:.4f} ms"
                 if name in ("dgrad", "wgrad") else "")
              + (f"; torch._int_mm at the 1x1 stride-1 sites (the int32 product alone) "
                 f"{total['int_mm_ms']:.4f} ms; the planar copies {total['planar_ms']:.4f} ms of "
                 f"the kernel's time; bodies a step {bodies}" if name == "wgrad" else ""),
              flush=True)
    quantize = {key: records.pop(f"quantize_{key}") for key in ("x", "g")}
    records["quantize"] = {
        "max_abs_err": 0.0, "library_ms": None,
        **{key: quantize["x"][key] + quantize["g"][key] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes", "x_ms": quantize["x"]["ms"], "g_ms": quantize["g"]["ms"],
        "x_bound_ms": quantize["x"]["bound_ms"], "g_bound_ms": quantize["g"]["bound_ms"]}
    return records


def _wgrad_geometry(kc, a) -> dict:
    """The conv geometry of a recorded conv_s8_wgrad call's arguments."""
    x_q, g_q, kernel = a[0], a[1], a[4]
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    return kc.conv_geometry(x_q.shape, (g_q.shape[3], kh, kw, x_q.shape[3]), *a[5:8])


BWD_COUNTS = ("quantize", "conv", "dgrad", "wgrad", *(f"wgrad {b}" for b in QAT_WGRAD_BODIES),
              "dgrad parity", "reduce dynamic", "reduce delayed", "reduce amax", "weight codes")


def _bwd_counting_steps(trainer, log: list):
    """Wrap ``trainer.train_step``: each step appends (step, the launches of
    ``BWD_COUNTS`` in it: device-scale quantize, dense conv, dgrad, wgrad,
    wgrad of each body of ``QAT_WGRAD_BODIES``, dgrad split by parity, the
    reducing quantize by mode, the data gradient's weight codes)."""
    from iswm_tpu_torch.ops.kernels import int8_conv as kc

    step = trainer.train_step

    def counts():
        return (kc.launches_by_scale["quantize"]["device"], kc.launches_by_scale["igemm"]["device"],
                kc.launches_dgrad, kc.launches_wgrad,
                *(kc.launches_wgrad_by_body[b] for b in QAT_WGRAD_BODIES),
                kc.launches_dgrad_by_body["parity"],
                *(kc.launches_reduce[m] for m in ("dynamic", "delayed", "amax")),
                kc.launches_rotated)

    def counted(state, images, labels):
        before = counts()
        out = step(state, images, labels)
        log.append((state.step - 1, *(a - b for a, b in zip(counts(), before))))
        return out

    trainer.train_step = counted


def phase_qat_bwd_train(kc, smi: str) -> dict:
    """The int8-backward QAT main path: 4-step fits in dynamic and delayed
    mode (a quick-eval and a validation each), launches counted a step; a
    forward and backward without a host sync; the step's device time, host
    time, launches and peak memory against the QAT-forward-only step and the
    bf16 step in the same run.  Returns the main path's launches."""
    from iswm_tpu_torch.data import val_transform_batch

    from iswm_tpu_torch.models.layers import quant_state

    t0 = time.perf_counter()
    sites = QAT_SITES["train"]
    kc.launches_dgrad = kc.launches_wgrad = kc.launches_rotated = 0
    for counter in (kc.launches_wgrad_by_body, kc.launches_dgrad_by_body, kc.launches_reduce):
        counter.update(dict.fromkeys(counter, 0))
    by_scale = {e: v["device"] for e, v in kc.launches_by_scale.items()}
    trainers = {}
    for name, model in (("dynamic", {}), ("delayed", {"int8_scale_mode": "delayed"})):
        trainer, _, _, _ = _slice_trainer(QAT_STEPS, f"chip_smoke_qat_bwd_{name}",
                                          int8_training=QAT_GATE, int8_training_bwd=True,
                                          **model)
        log = []
        _bwd_counting_steps(trainer, log)
        trainer.fit()
        losses = trainer.logger.history["train_loss"]
        check(len(losses) == 2 and bool(np.isfinite(losses).all()),
              f"int8-backward QAT {name}: losses {losses}")
        delayed = len(quant_state(trainer.state.model))  # the sites of a running amax
        want = [(i, 2 * sites, sites, sites, sites, *QAT_WGRAD_BODIES.values(), QAT_DGRAD_PARITY,
                 2 * sites - delayed, delayed, 0, sites) for i in range(QAT_STEPS)]
        check(log == want, f"int8-backward QAT {name}: ({', '.join(BWD_COUNTS)}) launches by "
                           f"step {log}, expected {want}")
        print(f"[19] int8-backward QAT {name} fit ({smi}): {QAT_STEPS} steps, losses {losses}, "
              f"quick-eval and validation; ({', '.join(BWD_COUNTS)}) launches by step {log}: one "
              f"reducing quantize an activation and a cotangent (no other amax pass), the "
              f"weight codes, a dgrad and a wgrad a routed site")
        trainers[name] = trainer
    launches = {"dgrad": kc.launches_dgrad, "wgrad": kc.launches_wgrad,
                "wgrad_by_body": dict(kc.launches_wgrad_by_body),
                "dgrad_by_body": dict(kc.launches_dgrad_by_body),
                "reduce": dict(kc.launches_reduce), "rotated": kc.launches_rotated,
                **{e: kc.launches_by_scale[e]["device"] - by_scale[e] for e in by_scale}}

    trainer = trainers.pop("dynamic")
    del trainers
    gen = torch.Generator().manual_seed(SEED)
    xu8 = torch.randint(0, 256, (8, 512, 512, 3), dtype=torch.uint8, generator=gen).cuda()
    yu8 = torch.randint(0, 2, (8, 512, 512), dtype=torch.uint8, generator=gen).cuda()
    model, loss_fn = trainer.state.model, trainer.loss_fn
    x = val_transform_batch(xu8).permute(0, 3, 1, 2)
    model.train()
    for _ in range(2):
        loss_fn(model(x), yu8).backward()
    torch.cuda.synchronize()
    before = (kc.launches_dgrad, kc.launches_wgrad)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = loss_fn(model(x), yu8)
        loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    model.zero_grad(set_to_none=True)
    bwd = (kc.launches_dgrad - before[0], kc.launches_wgrad - before[1])
    loss = float(loss.detach())
    check(bwd == (sites, sites) and np.isfinite(loss),
          f"an int8-backward forward and backward launched {bwd}, loss {loss}")
    print(f"[19] int8-backward QAT forward and backward under set_sync_debug_mode('error'): no "
          f"synchronizing call; {bwd[0]} dgrad + {bwd[1]} wgrad launches, loss {loss:.6f}")

    # the step against the QAT-forward-only step and the bf16 step, in this run
    times = {}
    for name, settings in (("int8-backward QAT", None), ("QAT forward only",
                                                        {"int8_training": QAT_GATE}),
                           ("bf16", {})):
        t = trainer if settings is None else _slice_trainer(
            QAT_STEPS, f"chip_smoke_qat_bwd_{len(times)}", **settings)[0]
        host = _median_step_ms(t, xu8, yu8)
        if settings is None:  # the dispatcher's cost: the int8 forward's operators
            with _direct_ops():
                direct = float(np.median(_median_step_ms(t, xu8, yu8)))
            again = float(np.median(_median_step_ms(t, xu8, yu8)))
            print(f"[19] {name} train step ({smi}): host {float(np.median(host)):.2f} ms "
                  f"through the iswm operators ({again:.2f} ms again), {direct:.2f} ms with the "
                  f"wrappers calling their CUDA implementations directly (median of 8 each)")
        dev, n, by_class = _step_profile(t, xu8, yu8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t.train_step(t.state, xu8, yu8)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        times[name] = (float(np.median(host)), dev, n, peak)
        classes = sorted(by_class.items(), key=lambda kv: -kv[1])
        print(f"[19] {name} train step, ResNet-50 batch 8 at 512^2 ({smi}): host "
              f"{times[name][0]:.2f} ms (median of 8), device {dev:.2f} ms (profiler, {n} kernel "
              f"launches), peak memory {peak:.0f} MiB, by class "
              + ", ".join(f"{k} {v:.2f}" for k, v in classes))
        del t
    q, f, b = (times[k] for k in ("int8-backward QAT", "QAT forward only", "bf16"))
    print(f"[19] int8-backward QAT step ({smi}) against the QAT-forward-only step: host "
          f"{q[0] / f[0]:.3f}, device {q[1] / f[1]:.3f}, {q[2] - f[2]:+d} launches, peak memory "
          f"{q[3] - f[3]:+.0f} MiB; against bf16: host {q[0] / b[0]:.3f}, device "
          f"{q[1] / b[1]:.3f}, {q[2] - b[2]:+d} launches; the phase took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


REMAT_STEPS = 2  # phase 20's fits: a quick-eval at step 1 and the validation at 2
# the forward kernels a rematerialized step launches twice: (module, entry,
# kernel); the wrapper's outputs of the recomputation are held against the
# first forward's
REMAT_FORWARD = (("kernels.fused_stem", "stem_stats", "#9 stem_stats"),
                 ("kernels.fused_stem", "stem_norm_relu_pool", "#10 stem_norm_relu_pool"),
                 ("kernels.fused_block", "matmul_bn_stats_fwd", "#7a matmul_bn_stats forward"),
                 ("kernels.fused_block", "conv3x3_bn_stats_fwd", "#8a conv3x3_bn_stats forward"),
                 ("int8_train", "quantize_s8_reduce", "int8 quantize_s8_reduce"),
                 ("int8_train", "conv_s8_igemm", "int8 conv_s8_igemm"))


class _RecomputeLog:
    """Within: every call of ``REMAT_FORWARD``'s entries logs (segment, whether
    it is a recomputation, kernel, its tensor outputs cloned); ``bitwise()``
    pairs each recomputed call with the first forward's call of the same
    segment, kernel and order and says how many gave the same bits."""

    def __init__(self):
        import importlib

        from iswm_tpu_torch.models import remat

        self.remat, self.log, self.segment, self.ids = remat, [], None, 0
        self.saved = [(remat, "checkpoint", remat.checkpoint)]
        for module, entry, _ in REMAT_FORWARD:
            mod = importlib.import_module(f"iswm_tpu_torch.ops.{module}")
            self.saved.append((mod, entry, getattr(mod, entry)))

    def _tagged(self, fn, *args, **kw):
        sid, self.ids = self.ids, self.ids + 1

        def run(*a):
            previous, self.segment = self.segment, sid
            try:
                return fn(*a)
            finally:
                self.segment = previous

        return self.saved[0][2](run, *args, **kw)

    def _wrap(self, fn, kernel):
        def call(*a, **k):
            out = fn(*a, **k)
            outs = out if isinstance(out, tuple) else (out,)
            self.log.append((self.segment, self.remat.recomputing(), kernel,
                             [t.detach().clone() for t in outs if isinstance(t, torch.Tensor)]))
            return out
        return call

    def __enter__(self):
        self.remat.checkpoint = self._tagged
        for (mod, entry, fn), (_, _, kernel) in zip(self.saved[1:], REMAT_FORWARD):
            setattr(mod, entry, self._wrap(fn, kernel))
        return self

    def __exit__(self, *exc):
        for mod, entry, fn in self.saved:
            setattr(mod, entry, fn)

    def bitwise(self) -> dict:
        """{kernel: (first-forward calls, recomputed calls, recomputed calls
        with the first forward's bits)}."""
        first, again = {}, {}
        for sid, recomputed, kernel, outs in self.log:
            if sid is None:  # outside every segment: the backward's own calls
                continue
            (again if recomputed else first).setdefault((sid, kernel), []).append(outs)
        out = {}
        for (sid, kernel), calls in first.items():
            n, m, same = out.get(kernel, (0, 0, 0))
            redo = again.get((sid, kernel), [])
            same += sum(all(torch.equal(a, b) for a, b in zip(r, f))
                        for r, f in zip(redo, calls))
            out[kernel] = (n + len(calls), m + len(redo), same)
        return out


def _recomputed(log, name: str) -> dict:
    """``log.bitwise()``, every kernel that ran in the first forward having
    run again in the recomputation."""
    bits = log.bitwise()
    for kernel, (n, m, _) in bits.items():
        check(m == n, f"{name}: {kernel} ran {n} times in the forward, {m} in the "
                      "recomputation")
    return bits


def _peak_step_mib(trainer, xu8, yu8) -> tuple:
    """(peak MiB allocated during one step, MiB allocated before it)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(trainer.state, xu8, yu8)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20, before / 2**20


def _step_numbers(trainer, xu8, yu8) -> dict:
    """Host ms (median of 8), device ms and kernel launches of a step (one
    profiler trace), its peak memory."""
    host = float(np.median(_median_step_ms(trainer, xu8, yu8)))
    dev, n, by_class = _step_profile(trainer, xu8, yu8)
    peak, base = _peak_step_mib(trainer, xu8, yu8)
    return {"host_ms": host, "device_ms": dev, "launches": n, "peak_mib": peak,
            "base_mib": base, "by_class": by_class}


def _fit_checks(trainer, cfg, name: str) -> None:
    """A fit's losses are finite and its best .pth loads strict=True into a
    fresh model of the run's configuration."""
    from iswm_tpu_torch.models import build_model

    losses = trainer.logger.history["train_loss"]
    check(len(losses) == REMAT_STEPS and bool(np.isfinite(losses).all()),
          f"{name}: losses {losses}")
    check(trainer.best_path is not None, f"{name}: no best checkpoint")
    payload = torch.load(trainer.best_path, map_location="cpu", weights_only=True)
    build_model(cfg.model).load_state_dict(payload["model_state"], strict=True)


def phase_remat(fs, fb, kc, ce, cm, smi: str) -> dict:
    """Activation rematerialization and bf16 parameters on phase 6's
    configuration; returns this phase's launches of each kernel it drives."""
    import types

    from iswm_tpu_torch.data import val_transform_batch
    from iswm_tpu_torch.models.layers import quant_state
    from iswm_tpu_torch.train import TrainState, make_optimizer, make_train_step

    t0 = time.perf_counter()
    counters = ((ce, ("launches_fwd", "launches_bwd")), (cm, ("launches",)),
                (fs, STEM_COUNTERS), (fb, BLOCK_COUNTERS),
                (kc, ("launches_dgrad", "launches_wgrad", "launches_rotated")))

    def zero():
        for mod, names in counters:
            zero_counters(mod, names)
        for counter in (*kc.launches_by_scale.values(), kc.launches_reduce,
                        kc.launches_dgrad_by_body, kc.launches_wgrad_by_body):
            counter.update(dict.fromkeys(counter, 0))

    def read() -> dict:
        got = {f"{mod.__name__.rsplit('.', 1)[1]}.{n}": getattr(mod, n)
               for mod, names in counters for n in names}
        got.update({f"int8_conv.{e} device": kc.launches_by_scale[e]["device"]
                    for e in kc.launches_by_scale})
        got.update({f"int8_conv.reduce {m}": v for m, v in kc.launches_reduce.items()})
        got.update({f"int8_conv.dgrad {b}": v for b, v in kc.launches_dgrad_by_body.items()})
        got.update({f"int8_conv.wgrad {b}": v for b, v in kc.launches_wgrad_by_body.items()})
        return got

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # (a) the main path: a Trainer with parallel.remat, fit with a quick-eval
    # and a validation; counts from 0 just before, read just after
    trainer, cfg, _, _ = _slice_trainer(REMAT_STEPS, "chip_smoke_remat",
                                        parallel={"remat": True})
    zero()
    trainer.fit()
    torch.cuda.synchronize()
    fit = read()
    add(fit)
    check((fit["fused_ce.launches_fwd"], fit["fused_ce.launches_bwd"])
          == (REMAT_STEPS, REMAT_STEPS) and fit["confusion.launches"] > 0,
          f"remat fit: launches {fit}")
    _fit_checks(trainer, cfg, "remat fit")
    print(f"[20] remat fit ({smi}): ResNet-50 OS 16 bf16 batch 8 at 512^2, parallel.remat, "
          f"{REMAT_STEPS} steps, a quick-eval and a validation, losses "
          f"{trainer.logger.history['train_loss']}; #4 fwd/bwd "
          f"{fit['fused_ce.launches_fwd']}/{fit['fused_ce.launches_bwd']}, #6 "
          f"{fit['confusion.launches']}; the best .pth loads strict=True")

    # (b) one plain step twice and one remat step from one state, one batch,
    # one dropout draw, deterministic algorithms
    gen = torch.Generator().manual_seed(SEED)
    xu8 = torch.randint(0, 256, (8, 512, 512, 3), dtype=torch.uint8, generator=gen).cuda()
    yu8 = torch.randint(0, 2, (8, 512, 512), dtype=torch.uint8, generator=gen).cuda()
    x = val_transform_batch(xu8)
    model, loss_fn = trainer.state.model, trainer.loss_fn
    start = copy.deepcopy(model.state_dict())
    factory, _ = make_optimizer(cfg.optim, cfg.train.total_itrs)

    def from_start(remat_on: bool) -> tuple:
        model.load_state_dict(start)
        state = TrainState(model, *factory(model.parameters()), 0)
        torch.cuda.manual_seed(SEED)
        with warnings.catch_warnings():  # ops without a deterministic version
            warnings.simplefilter("ignore")
            loss = float(make_train_step(loss_fn, remat=remat_on)(state, x, yu8))
        return loss, {k: v.clone() for k, v in model.state_dict().items()}

    _deterministic(True)
    try:
        plain, again, remat = from_start(False), from_start(False), from_start(True)
    finally:
        _deterministic(False)
    params = [k for k, _ in model.named_parameters()]
    stats = [k for k in start if k.endswith(("running_mean", "running_var"))]

    def rel(a, b, keys) -> list:
        return sorted(float((a[k].float() - b[k].float()).abs().max()
                            / b[k].float().abs().max().clamp_min(1e-30)) for k in keys)

    spread, off = rel(again[1], plain[1], params), rel(remat[1], plain[1], params)
    same = remat[0] == plain[0] and all(torch.equal(remat[1][k], plain[1][k]) for k in params)
    check(same or (off[-1] <= 2 * spread[-1] and off[len(off) // 2] <= 2 * spread[len(off) // 2]),
          f"remat step off the plain step: loss {remat[0]} vs {plain[0]}, parameters' "
          f"worst / median {off[-1]:.2e} / {off[len(off) // 2]:.2e} against the plain step's "
          f"own spread {spread[-1]:.2e} / {spread[len(spread) // 2]:.2e}")
    once = all(torch.equal(remat[1][k], plain[1][k]) for k in stats) and all(
        int(remat[1][k]) == int(start[k]) + 1 for k in start if k.endswith("num_batches_tracked"))
    check(once, "remat step: running statistics not those of one update")
    model.load_state_dict(start)
    print(f"[20] plain vs remat step from one state, deterministic ({smi}): loss "
          f"{plain[0]:.7f} / again {again[0]:.7f} / remat {remat[0]:.7f}; parameters "
          f"{'bit-equal to the plain step' if same else 'not bit-equal'} (remat vs plain worst "
          f"{off[-1]:.2e}, median {off[len(off) // 2]:.2e} * max|p|; plain vs plain worst "
          f"{spread[-1]:.2e}, median {spread[len(spread) // 2]:.2e}); running statistics "
          f"updated once, bit-equal to the plain step's")
    del start, plain, again, remat

    # (c) the two steps measured: host, device, launches, peak memory
    plain_step = types.SimpleNamespace(
        state=trainer.state, train_step=make_train_step(
            loss_fn, augment=trainer.augment, generator=trainer.generator))
    numbers = {"plain": _step_numbers(plain_step, xu8, yu8),
               "remat": _step_numbers(trainer, xu8, yu8)}
    p, r = numbers["plain"], numbers["remat"]
    for name, v in numbers.items():
        classes = sorted(v["by_class"].items(), key=lambda kv: -kv[1])
        print(f"[20] {name} train step, ResNet-50 OS 16 bf16 batch 8 at 512^2 ({smi}): host "
              f"{v['host_ms']:.2f} ms (median of 8), device {v['device_ms']:.2f} ms (profiler, "
              f"{v['launches']} kernel launches), peak memory {v['peak_mib']:.0f} MiB "
              f"(max_memory_allocated; {v['base_mib']:.0f} MiB allocated before the step), by "
              f"class " + ", ".join(f"{k} {t:.2f}" for k, t in classes))
    saved = 1 - r["peak_mib"] / p["peak_mib"]
    print(f"[20] remat against plain ({smi}): peak memory {saved:.1%} lower "
          f"({r['peak_mib'] - p['peak_mib']:+.0f} MiB; above the memory held before the step "
          f"{1 - (r['peak_mib'] - r['base_mib']) / (p['peak_mib'] - p['base_mib']):.1%} "
          f"lower), device time x{r['device_ms'] / p['device_ms']:.3f}, host time "
          f"x{r['host_ms'] / p['host_ms']:.3f}, {r['launches'] - p['launches']:+d} launches")
    check(saved >= 0.25, f"the remat step's peak memory is {saved:.1%} below the plain step's, "
                         "not 25%")
    del trainer, plain_step, model

    # (d) remat with the fused stem and blocks: one step, the forward kernels twice
    fused, _, _, _ = _slice_trainer(REMAT_STEPS, "chip_smoke_remat_fused",
                                    parallel={"remat": True}, fused_stem="always",
                                    fused_blocks="always")
    fused.train_step(fused.state, xu8, yu8)  # cuDNN's autotuning
    torch.cuda.synchronize()
    zero()
    with _RecomputeLog() as log:
        fused.train_step(fused.state, xu8, yu8)
        torch.cuda.synchronize()
    got = read()
    add(got)
    want = {"fused_stem.launches_stats": 2, "fused_stem.launches_pool": 2,
            "fused_stem.launches_bwd_sums": 1, "fused_stem.launches_bwd_wgrad": 1,
            "fused_block.launches_mm_fwd": 2 * 26, "fused_block.launches_c3_fwd": 2 * 12,
            "fused_block.launches_mm_bwd": 26, "fused_block.launches_c3_bwd": 12}
    check(all(got[k] == v for k, v in want.items()),
          f"remat fused step launches {[(k, got[k]) for k in want]}, expected {want}")
    bits = _recomputed(log, "remat fused step")
    print(f"[20] remat step with fused_stem / fused_blocks='always' ({smi}): launches "
          + ", ".join(f"{k.split('.')[1][9:]} {got[k]}" for k in want)
          + " (#9, #10, #7a, #8a twice: the forward and its recomputation); recomputed outputs "
          "bitwise the first forward's: "
          + ", ".join(f"{k} {eq}/{m}" for k, (n, m, eq) in bits.items() if n))
    fused_numbers = _step_numbers(fused, xu8, yu8)
    print(f"[20] remat fused step ({smi}): host {fused_numbers['host_ms']:.2f} ms, device "
          f"{fused_numbers['device_ms']:.2f} ms ({fused_numbers['launches']} launches), peak "
          f"{fused_numbers['peak_mib']:.0f} MiB")
    del fused, log

    # (e) remat with QAT (int8_training=256, delayed, int8 backward): one step
    qat, _, _, _ = _slice_trainer(REMAT_STEPS, "chip_smoke_remat_qat", parallel={"remat": True},
                                  int8_training=QAT_GATE, int8_training_bwd=True,
                                  int8_scale_mode="delayed")
    qat.train_step(qat.state, xu8, yu8)
    torch.cuda.synchronize()
    sites, delayed = QAT_SITES["train"], len(quant_state(qat.state.model))
    zero()
    with _RecomputeLog() as log:
        loss = float(qat.train_step(qat.state, xu8, yu8))
        torch.cuda.synchronize()
    got = read()
    add(got)
    want = {"int8_conv.quantize device": 3 * sites,
            "int8_conv.igemm device": 2 * sites, "int8_conv.launches_dgrad": sites,
            "int8_conv.launches_wgrad": sites, "int8_conv.launches_rotated": sites,
            "int8_conv.reduce delayed": 2 * delayed,
            "int8_conv.reduce dynamic": 2 * (sites - delayed) + sites}
    check(np.isfinite(loss) and all(got[k] == v for k, v in want.items()),
          f"remat QAT step: loss {loss}, launches {[(k, got[k]) for k in want]}, "
          f"expected {want}")
    bits = _recomputed(log, "remat QAT step")
    print(f"[20] remat QAT step (int8_training={QAT_GATE}, delayed, int8 backward; {smi}): loss "
          f"{loss:.6f}; launches " + ", ".join(f"{k} {got[k]}" for k in want)
          + f" ({sites} routed sites, {delayed} with a running amax: the forward's quantize and "
          "conv twice, the backward's once); recomputed outputs bitwise the first forward's: "
          + ", ".join(f"{k} {eq}/{m}" for k, (n, m, eq) in bits.items() if n))
    del qat, log

    # (f) bf16 parameters: a fit, the dtypes, one step measured, one chunk served
    low, low_cfg, _, _ = _slice_trainer(REMAT_STEPS, "chip_smoke_bf16_params",
                                        param_dtype="bfloat16")
    zero()
    low.fit()
    torch.cuda.synchronize()
    add(read())
    _fit_checks(low, low_cfg, "bf16-parameter fit")
    state = low.state
    dtypes = ({p.dtype for p in state.model.parameters()},
              {v.dtype for k, v in state.model.state_dict().items() if "running" in k},
              {state.optimizer.state[p]["momentum_buffer"].dtype
               for p in state.model.parameters()})
    check(dtypes == ({torch.bfloat16}, {torch.float32}, {torch.bfloat16}),
          f"bf16-parameter fit: (parameters, statistics, momentum) dtypes {dtypes}")
    b = _step_numbers(low, xu8, yu8)
    print(f"[20] bf16-parameter step ({smi}): host {b['host_ms']:.2f} ms, device "
          f"{b['device_ms']:.2f} ms ({b['launches']} launches), peak {b['peak_mib']:.0f} MiB "
          f"({b['base_mib']:.0f} MiB before the step); against float32 parameters: peak "
          f"{b['peak_mib'] - p['peak_mib']:+.0f} MiB, memory before the step "
          f"{b['base_mib'] - p['base_mib']:+.0f} MiB, device "
          f"x{b['device_ms'] / p['device_ms']:.3f}, "
          f"host x{b['host_ms'] / p['host_ms']:.3f}; parameters and momentum bf16, statistics "
          f"float32; losses {low.logger.history['train_loss']}")
    from iswm_tpu_torch.infer import Predictor

    low_cfg.predict.tile_size, low_cfg.predict.tile_batch = 512, 8
    predictor = Predictor(low_cfg, ckpt_path=low.best_path, device="cuda")
    check({q.dtype for q in predictor.model.parameters()} == {torch.bfloat16},
          "the bf16-parameter Predictor's parameters are not bf16")
    scene = np.random.default_rng(SEED).integers(0, 256, (512, 1536, 3), dtype=np.uint8)
    out = predictor.predict_image(scene)
    check(all(np.isfinite(np.asarray(v, np.float64)).all() for v in out.values()),
          "the bf16-parameter Predictor's products are not finite")
    print(f"[20] bf16-parameter Predictor on a 512x1536 scene (one chunk of 512^2 tiles): products "
          f"{sorted(out)}, finite; the phase took {time.perf_counter() - t0:.1f} s")
    del low, predictor
    return total


# ------------------------------------------------------- the spatial model axis
SPATIAL_SERVE_BATCH = 4  # phase 21's scene-parallel engine: tiles a rank, 8 a chunk
SPATIAL_BF16_LIMIT = 2e-2  # phase 21: the bf16 split step's loss against one process's
# phase 21's ResNet-50 step, OS 16, 512^2: row windows that fetch a halo (the
# stem, the pool, 16 backbone 3x3s, 3 ASPP branches, 2 decoder 3x3s, 2
# resizes), an all-reduce each in the backward but the stem's (the image takes
# no gradient), the pooling branch's group sum forward and backward
SPATIAL_COLLECTIVES = {"halo_gather": 25, "halo_reduce": 24, "group_sum": 2}
SPATIAL_OUT = TRAIN_OUT.with_name("chip_smoke_spatial")
# phase 21's options on the split: (model settings, remat) of each, a float32
# step held against its one-process step, a bf16 step measured beside the
# plain split step's.  Xception's VALID stems split the 512 rows unevenly:
# 255 (128 / 127), 253 (127 / 126), then 127 (64 / 63) from block1
SPATIAL_OPTIONS = {
    "remat": ({}, True),
    "QAT + int8 backward": ({"int8_training": QAT_GATE, "int8_training_bwd": True,
                             "int8_scale_mode": "delayed"}, False),
    "MobileNetV2": ({"backbone": "mobilenetv2"}, False),
    "Xception": ({"backbone": "xception"}, False),
}
SPATIAL_AMAX_LIMIT = 1e-5  # phase 21: a 2-rank QAT step's running amaxes against one process's


def _spatial_scene() -> torch.Tensor:
    """Phase 17's first scene (1024x1536), normalized NHWC on the card."""
    from iswm_tpu_torch.data import val_transform_batch

    h, w = SCENES[0]
    scene = np.random.default_rng(SEED).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return val_transform_batch(torch.from_numpy(scene).cuda())


def _spatial_model():
    """Phase 21's serving model: the configuration's (bf16) from seeded
    weights on cuda:0."""
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.models import build_model

    return build_model(Config().model, seed=SEED).to("cuda:0")


def _scene_ms(engine, x, reps: int = 3) -> float:
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.infer_scene(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def _saved_mib(loss: torch.Tensor, model) -> dict:
    """{autograd node class: MiB of the device tensors it saved for the
    backward} over ``loss``'s graph (a custom function's ``saved_tensors``
    too), ``model``'s parameters left out, each storage counted once, at the
    first node that holds it (a conv's input saved by the ReLU before it too
    counts at one of the two)."""
    seen = {p.untyped_storage().data_ptr() for p in model.parameters()}
    by_node, stack, visited = {}, [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in visited:
            continue
        visited.add(node)
        attrs = [a for a in dir(node) if a.startswith("_saved_")]
        if isinstance(node, torch.autograd.function.BackwardCFunction):
            attrs.append("saved_tensors")
        for attr in attrs:
            value = getattr(node, attr)
            for t in value if isinstance(value, (tuple, list)) else (value,):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    storage = t.untyped_storage()
                    if storage.data_ptr() not in seen:
                        seen.add(storage.data_ptr())
                        name = type(node).__name__
                        by_node[name] = by_node.get(name, 0.0) + storage.nbytes() / 2**20
        stack.extend(f for f, _ in node.next_functions)
    return dict(sorted(by_node.items(), key=lambda kv: -kv[1]))


def _spatial_numbers(step, state, x, y, mesh=None, reps: int = 3) -> dict:
    """The loss of a step from the seeded state; after a warm-up step, one
    step's collectives over the model group and their bytes, kernel #4's
    launches and the peak memory; what a train forward saves for its
    backward, by autograd node (:func:`_saved_mib`); the median of ``reps``
    steps on the host's clock; the device time, launches and device time by
    class of one step (one profiler trace of 2)."""
    import gc

    from iswm_tpu_torch.ops.kernels import fused_ce as ce
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.parallel import spatial, spatial_rows

    loss = float(step(state, x, y))
    step(state, x, y)
    net = state.model if state.replicated is None else state.replicated
    rows = (lambda t: t) if mesh is None else (lambda t: spatial_rows(mesh, t))
    with spatial.spatially_split(mesh):
        graph = make_loss_fn("ce_loss", fused="auto", device="cuda")(
            net(rows(x).permute(0, 3, 1, 2)), rows(y))
    saved = _saved_mib(graph, state.model)
    graph.backward()  # as a step's, so that DDP's reduction completes
    del graph
    state.optimizer.zero_grad(set_to_none=True)
    spatial.reset_counts()
    counts = (ce.launches_sharded, ce.launches_fwd, ce.launches_bwd)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    step(state, x, y)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    numbers = {"loss": loss, "peak_mib": peak, "base_mib": base, "saved": saved,
               "collectives": dict(spatial.collectives),
               "bytes": dict(spatial.collective_bytes),
               "recomputed": dict(spatial.recomputed), "row_exchanges": spatial.row_exchanges,
               "ce": tuple(b - a for a, b in zip(counts, (ce.launches_sharded, ce.launches_fwd,
                                                          ce.launches_bwd)))}
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    records = traced_records(lambda: step(state, x, y), 2, 1)
    by_class = {}
    for name, (us, n) in records.items():
        cls = "copies" if "memcpy" in name.lower() else _kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + us * n / 1e3
    numbers.update(host_ms=float(np.median(times)), device_ms=sum(by_class.values()),
                   launches=sum(n for _, n in records.values()), by_class=by_class)
    return numbers


def _qat_counts(kc) -> dict:
    """The counters of the int8 backward's entries and of the device-scale
    quantize and conv, under phase 20's names."""
    got = {f"int8_conv.launches_{k}": getattr(kc, f"launches_{k}")
           for k in ("dgrad", "wgrad", "rotated")}
    got.update({f"int8_conv.{e} device": v["device"] for e, v in kc.launches_by_scale.items()})
    got.update({f"int8_conv.reduce {m}": v for m, v in kc.launches_reduce.items()})
    got.update({f"int8_conv.dgrad {b}": v for b, v in kc.launches_dgrad_by_body.items()})
    got.update({f"int8_conv.wgrad {b}": v for b, v in kc.launches_wgrad_by_body.items()})
    return got


def _halo_entries(kc, mesh, x, y, settings: dict) -> dict:
    """In a spawned rank: one float32 forward and backward of the QAT model of
    ``settings`` under the split on this rank's rows, its int8 entries' calls
    recorded (:func:`_qat_bwd_calls`).  Every call at a halo geometry (H
    padding 0, W padding above 0: a window's rows with their halo, of odd or
    halo-extended height) of the dense conv, the data and the weight
    gradient, and the same site's reducing quantizes (their three modes: of
    the halo-extended x, of the cotangent) and weight codes, held bit-equal
    to their plain versions on the same inputs.  Returns the calls held by
    kind and the halo calls' shapes."""
    from iswm_tpu_torch.parallel import spatial_rows

    model, _ = _dp_model(**settings)
    calls = _qat_bwd_calls(model, spatial_rows(mesh, x).permute(0, 3, 1, 2),
                           spatial_rows(mesh, y), mesh)
    del model
    entries = {"igemm": kc.conv_s8_igemm, "dgrad": kc.conv_s8_dgrad, "wgrad": kc.conv_s8_wgrad,
               "rotated": kc.rotated_weight_codes}
    plains = {"igemm": lambda *a, out_dtype: kc.conv_s8_plain(*a, 1, out_dtype),
              "dgrad": kc.conv_s8_dgrad_plain, "wgrad": kc.conv_s8_wgrad_plain,
              "rotated": kc.rotated_weight_codes_plain}
    def halo(call) -> bool:
        (top, bottom), (left, _) = kc._pads(call[1][6])
        return not (top or bottom) and left > 0

    # a site's calls: its forward's quantize and conv, its backward's quantize,
    # weight codes, data and weight gradient
    halo_sites = {i for i, c in enumerate(calls) if c[0] in ("igemm", "dgrad") and halo(c)}
    halo_sites |= {i - 1 for i in halo_sites} | {i - 2 for i in halo_sites
                                                  if calls[i][0] == "dgrad"}
    held, shapes = {}, set()
    for i, (kind, a, k) in enumerate(calls):
        if i not in halo_sites and not (kind == "wgrad" and halo((kind, a, k))):
            continue
        if kind.startswith("quantize"):
            check(_reduce_checks(kc, a[0]),
                  f"the reducing quantize != plain at {kind} {tuple(a[0].shape)} on the split")
        else:
            if kind != "rotated":
                shapes.add((kind, tuple(a[0].shape), tuple(a[1].shape), str(a[5]), str(a[6]),
                            str(a[7])))
            got, want = entries[kind](*a, **k), plains[kind](*a, **k)
            pairs = list(zip(got, want)) if kind == "rotated" else [(got, want)]
            diff = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
            check(all(g.dtype == w.dtype and torch.equal(g, w) for g, w in pairs),
                  f"{kind} != plain at {tuple(a[0].shape)} on the split ({a[5:8]}): max abs "
                  f"err {diff}")
        held[kind] = held.get(kind, 0) + 1
    torch.cuda.synchronize()
    check(all(held.get(k, 0) for k in ("igemm", "dgrad", "wgrad")),
          f"the split QAT step made no int8 call at a halo geometry: {held}")
    return {"held": held, "shapes": sorted(shapes)}


def _rank_spatial(rank: int, ranks: int, rendezvous: str, out: str) -> None:
    """Phase 21 in a spawned rank, a model group of both (data 1 x model 2):
    phase 15's f32 step and a bf16 step on this rank's 256 of the 512 rows of
    all 8 images, the same for each of ``SPATIAL_OPTIONS`` (with QAT, its int8
    entries at the halo geometries against their plain versions), then the
    scene-parallel int8_exec_xla engine."""
    from iswm_tpu_torch.infer.quantization import make_variant_fn
    from iswm_tpu_torch.infer.tiling import TileEngine
    from iswm_tpu_torch.ops.kernels import fused_ce as ce
    from iswm_tpu_torch.ops.kernels import int8_conv as kc
    from iswm_tpu_torch.ops.kernels import int8_matmul as k8
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.parallel import destroy, make_mesh
    from iswm_tpu_torch.train import TrainState, make_train_step
    from iswm_tpu_torch.train.step import data_parallel

    _join_gloo(rank, ranks, rendezvous)
    try:
        mesh = make_mesh(1, ranks)
        x, y = _dp_batch()
        step = make_train_step(make_loss_fn("ce_loss", fused="auto", device="cuda"), mesh=mesh)
        ce.launches_fwd = ce.launches_bwd = ce.launches_sharded = 0
        seen = _f32_rank_steps(step, x, y, rank)
        torch.backends.cudnn.benchmark = True  # as the Trainer runs
        model, factory = _dp_model("bfloat16")
        state = TrainState(model, *factory(model.parameters()), 0, data_parallel(model))
        seen["bf16"] = _spatial_numbers(step, state, x, y, mesh)
        del model, state
        start, seen["options"] = _qat_counts(kc), {}
        for name, (settings, remat) in SPATIAL_OPTIONS.items():
            t0 = time.perf_counter()
            option = make_train_step(make_loss_fn("ce_loss", fused="auto", device="cuda"),
                                     mesh=mesh, remat=remat)
            got = {"f32": _f32_rank_steps(option, x, y, rank, **settings)}
            if settings.get("int8_training"):  # the yardstick of a chaotic forward
                rows = slice(rank * len(x) // ranks, (rank + 1) * len(x) // ranks)
                got["data-parallel f32"] = _f32_rank_steps(
                    make_train_step(make_loss_fn("ce_loss", fused="auto", device="cuda"),
                                    remat=remat), x[rows], y[rows], rank, **settings)
            if settings.get("int8_training_bwd"):  # its launches stay out of the counts
                before = _qat_counts(kc)
                got["halo entries"] = _halo_entries(kc, mesh, x, y, settings)
                start = {k: v + _qat_counts(kc)[k] - before[k] for k, v in start.items()}
            torch.backends.cudnn.benchmark = True
            model, factory = _dp_model("bfloat16", **settings)
            state = TrainState(model, *factory(model.parameters()), 0, data_parallel(model))
            got["bf16"] = _spatial_numbers(option, state, x, y, mesh, reps=1)
            got["s"] = time.perf_counter() - t0
            seen["options"][name] = got
            del model, state
        seen["qat launches"] = {k: v - start[k] for k, v in _qat_counts(kc).items()}
        seen["train launches"] = (ce.launches_sharded, ce.launches_fwd, ce.launches_bwd)

        fn = make_variant_fn(_spatial_model(), "int8_exec_xla",
                             conv_scales=torch.load(Path(out) / "scales.pt"))
        engine = TileEngine(fn, tile=512, overlap=64, batch=SPATIAL_SERVE_BATCH,
                            mesh=make_mesh())
        scene = _spatial_scene()
        k8.launches = kc.launches_quantize = kc.launches_igemm = 0
        logits = engine.infer_scene(scene)
        torch.cuda.synchronize()
        seen["serve launches"] = {"matmul": k8.launches, "quantize": kc.launches_quantize,
                                  "igemm": kc.launches_igemm}
        seen["scene_ms"] = _scene_ms(engine, scene)
        if rank == 0:
            seen["logits"] = logits.cpu()
    finally:
        destroy()
    torch.save(seen, Path(out) / f"_rank_spatial.{rank}.pt")


def phase_spatial(smi: str) -> dict:
    """The spatial model axis (data 1 x model 2 on two gloo ranks on cuda:0):
    the plain split step and each of ``SPATIAL_OPTIONS``'s, the scene-parallel
    engine and the multi-device dry run; returns this phase's launches of
    each kernel it drives."""
    from iswm_tpu_torch.infer.quantization import calibrate_conv_inputs, make_variant_fn
    from iswm_tpu_torch.infer.tiling import TileEngine
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.parallel import destroy
    from iswm_tpu_torch.parallel.dryrun import dryrun_multichip
    from iswm_tpu_torch.train import TrainState, make_train_step
    from iswm_tpu_torch.train.step import data_parallel

    t_phase = time.perf_counter()
    SPATIAL_OUT.mkdir(parents=True, exist_ok=True)
    # the one-process side: phase 15's reference in a 1-rank group, the bf16
    # step alone, and the one-rank engine on the scene (its scales for the ranks)
    _open_group("phase21.nccl")
    reference = _dp_reference()
    t_refs = time.perf_counter()
    references = {name: _dp_reference(remat, **settings)
                  for name, (settings, remat) in SPATIAL_OPTIONS.items()}
    t_refs = time.perf_counter() - t_refs
    x, y = _dp_batch()
    torch.backends.cudnn.benchmark = True
    step = make_train_step(make_loss_fn("ce_loss", fused="auto", device="cuda"))
    # the bf16 step in the 1-rank group: the ranks' BatchNorm arithmetic
    # (cross-replica, float32 passes) and DDP, on all the rows
    model, factory = _dp_model("bfloat16")
    grouped = _spatial_numbers(step, TrainState(model, *factory(model.parameters()), 0,
                                                data_parallel(model)), x, y)
    del model
    destroy()
    step = make_train_step(make_loss_fn("ce_loss", fused="auto", device="cuda"))
    model, factory = _dp_model("bfloat16")
    single = _spatial_numbers(step, TrainState(model, *factory(model.parameters()), 0), x, y)
    del model
    scene = _spatial_scene()
    model = _spatial_model()
    scales = calibrate_conv_inputs(model, [scene[:512, :512][None].permute(0, 3, 1, 2)],
                                   wide=True)
    torch.save(scales, SPATIAL_OUT / "scales.pt")
    fn = make_variant_fn(model, "int8_exec_xla", conv_scales=scales)
    del model
    engine = TileEngine(fn, tile=512, overlap=64, batch=2 * SPATIAL_SERVE_BATCH)
    want = engine.infer_scene(scene)
    scene_ms = _scene_ms(engine, scene)
    del fn, engine

    t_ranks = time.perf_counter()
    ranks = _spawn_ranks(_rank_spatial, SPATIAL_OUT)
    t_ranks = time.perf_counter() - t_ranks
    _hold_two_rank_step(reference, ranks, "[21]", "data 1 x model 2: 256 of the 512 rows "
                                                  "of all 8 images each")
    for r, seen in enumerate(ranks):
        bf16 = seen["bf16"]
        check(bf16["collectives"] == SPATIAL_COLLECTIVES,
              f"rank {r}: collectives a step {bf16['collectives']}, expected "
              f"{SPATIAL_COLLECTIVES}")
        check(bf16["ce"] == (1, 1, 1), f"rank {r}: sharded CE, kernel #4 forward and backward "
                                       f"launches a step {bf16['ce']}, expected one each")
    losses = [seen["bf16"]["loss"] for seen in ranks]
    rel = abs(losses[0] - single["loss"]) / abs(single["loss"])
    check(losses[0] == losses[1] and np.isfinite(losses[0]), f"bf16 split losses {losses}")
    check(rel <= SPATIAL_BF16_LIMIT, f"bf16 split step loss {losses[0]} against one process "
                                     f"{single['loss']} (rel {rel:.2e}, limit "
                                     f"{SPATIAL_BF16_LIMIT})")
    print(f"[21] bf16 step from seeded weights (dropout off), split over 2 ranks against one "
          f"process: loss {losses[0]:.6f} on both vs {single['loss']:.6f} (rel {rel:.2e}, "
          f"limit {SPATIAL_BF16_LIMIT})")
    for name, numbers in (("one process", single), ("one process in a 1-rank group", grouped),
                          *((f"rank {r} of 2", seen["bf16"]) for r, seen in enumerate(ranks))):
        print(f"[21] {smi}: bf16 step, batch 8 at 512^2, {name}: peak "
              f"{numbers['peak_mib']:.1f} MiB ({numbers['base_mib']:.1f} before the step), "
              f"device {numbers['device_ms']:.2f} ms in {numbers['launches']:.0f} launches ("
              + ", ".join(f"{c} {t:.2f}" for c, t in sorted(numbers["by_class"].items(),
                                                           key=lambda kv: -kv[1]))
              + f"), host {numbers['host_ms']:.2f} ms (median of 3); a train forward saves "
              f"{sum(numbers['saved'].values()):.1f} MiB ("
              + ", ".join(f"{k} {v:.1f}" for k, v in list(numbers["saved"].items())[:5])
              + "); collectives a step "
              f"{numbers['collectives']}, bytes {numbers['bytes']}; sharded CE / #4 forward / "
              f"#4 backward launches a step {numbers['ce']}")

    _hold_spatial_options(references, ranks, smi)
    del references

    got = ranks[0]["logits"].cuda()
    gap = float((got - want).abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    serve = {k: sum(seen["serve launches"][k] for seen in ranks)
             for k in ("matmul", "quantize", "igemm")}
    check(tuple(got.shape) == tuple(want.shape) and bool(torch.isfinite(got).all()),
          f"scene-parallel logits {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
    check(agree >= 0.999, f"scene-parallel mask agreement {agree:.6f} with the one-rank engine "
                          "(limit 0.999)")
    check(all(v > 0 for v in serve.values()), f"scene-parallel launches {serve}")
    print(f"[21] {smi}: int8_exec_xla TileEngine on the 1024x1536 scene, 2 ranks x batch "
          f"{SPATIAL_SERVE_BATCH} against one rank x batch {2 * SPATIAL_SERVE_BATCH}: mask "
          f"agreement {agree:.6f} (limit 0.999), logit gap {gap:.3e}; launches over both ranks "
          f"{serve}; scene ms (median of 3) one rank {scene_ms:.2f}, ranks "
          f"{[round(seen['scene_ms'], 2) for seen in ranks]} (two processes share the card)")

    t0 = time.perf_counter()
    dryrun_multichip(4, device="cuda", backend="gloo")
    t_dry = time.perf_counter() - t0
    print(f"[21] dryrun_multichip(4) as 4 gloo ranks on cuda:0 (data 2 x model 2, "
          f"resnet50 crop 32, then int8_exec_xla serving) in {t_dry:.1f} s; phase 21 in "
          f"{time.perf_counter() - t_phase:.1f} s: the two ranks' process {t_ranks:.1f} s ("
          + ", ".join(f"{name} {ranks[0]['options'][name]['s']:.1f} s" for name in SPATIAL_OPTIONS)
          + f" on rank 0), the options' one-process references {t_refs:.1f} s, the dry run "
          f"{t_dry:.1f} s, the one-process side the rest")
    train = [sum(seen["train launches"][i] for seen in ranks) for i in range(3)]
    qat = {k: sum(seen["qat launches"][k] for seen in ranks) for k in ranks[0]["qat launches"]}
    print(f"[21] launches over both ranks' steps: sharded CE {train[0]}, #4 forward "
          f"{train[1]}, backward {train[2]}; the QAT option's int8 entries "
          + ", ".join(f"{k.split('.', 1)[1]} {v}" for k, v in qat.items() if v))
    return {"sharded": train[0], "fwd": train[1], "bwd": train[2], **serve, "qat": qat}


def _hold_spatial_options(references: dict, ranks: list, smi: str) -> None:
    """Phase 21's options on the split: each float32 step against its
    one-process step within phase 15's limits (``_hold_two_rank_step``;
    QAT's forward is chaotic at this size, so its step, its running amaxes
    included, is held against the 2-rank data-parallel step's distance too);
    the remat step's gradients against the plain split step's; QAT's int8
    entries' halo calls (held bit-equal on the ranks); each bf16 step's
    numbers beside the plain split step's: the same loss and collectives on
    both ranks, no exchange of row counts, one sharded CE a step."""
    plain = ranks[0]["bf16"]
    for name, (settings, remat) in SPATIAL_OPTIONS.items():
        got = [seen["options"][name] for seen in ranks]
        layout = (f"{name}, data 1 x model 2: 256 of the 512 rows of all 8 images each"
                  + (", the maps uneven from the VALID stems on (255 rows: 128 / 127)"
                     if settings.get("backbone") == "xception" else ""))
        chaotic = bool(settings.get("int8_training"))
        yardstick = [g["data-parallel f32"] for g in got] if chaotic else None
        _hold_two_rank_step(references[name], [g["f32"] for g in got], "[21]", layout,
                            yardstick)
        if remat:  # the plain split step's gradients, rank 0's, by TF32
            same = {tf32: all(torch.equal(v, ranks[0][tf32]["grads"][k])
                              for k, v in got[0]["f32"][tf32]["grads"].items())
                    for tf32 in (False, True)}
            print(f"[21] remat split step's gradients bit-equal to the plain split step's "
                  f"(rank 0, deterministic): TF32 off {same[False]}, on {same[True]}")
        if chaotic:
            want = references[name][False]["amaxes"]
            check(set(got[0]["f32"][False]["amaxes"]) == set(want) and len(want) > 20,
                  f"{name}: the split step's amax sites are not one process's {len(want)}")
            for what, record in (("split", got[0]["f32"]), ("data-parallel",
                                                           got[0]["data-parallel f32"])):
                rels = [(k[:-7], float((record[False]["amaxes"][k].cuda() - v).abs() / v.abs()))
                        for k, v in want.items()]
                first = next(((k, r) for k, r in rels if r > 1e-6), ("none", 0.0))
                print(f"[21] {name}: the {what} step's running amaxes (TF32 off) against one "
                      f"process's, by site in forward order: the first beyond 1e-6 {first[0]} "
                      f"({first[1]:.2e}), the worst {max(r for _, r in rels):.2e}")
            for r, g in enumerate(got):
                entries = g["halo entries"]
                print(f"[21] {name}, rank {r}: int8 entries bit-equal to their plain versions on "
                      f"the split's tensors: {entries['held']} calls (the convs at the "
                      f"{len(entries['shapes'])} halo geometries "
                      + "; ".join(f"{k} x{s} w{t} stride {st} padding {p} dilation {d}"
                                  for k, s, t, st, p, d in entries["shapes"]) + ")")
        bf16 = [g["bf16"] for g in got]
        losses = [b["loss"] for b in bf16]
        check(losses[0] == losses[1] and np.isfinite(losses[0]),
              f"{name}: bf16 split losses {losses}")
        for r, b in enumerate(bf16):
            check(b["collectives"] == bf16[0]["collectives"] and b["row_exchanges"] == 0,
                  f"{name}, rank {r}: collectives a step {b['collectives']} (rank 0's "
                  f"{bf16[0]['collectives']}), row exchanges {b['row_exchanges']}, expected 0")
            check(b["ce"] == (1, 1, 1), f"{name}, rank {r}: sharded CE, kernel #4 forward and "
                                        f"backward launches a step {b['ce']}, expected one each")
        if remat:
            want_coll = {k: plain["collectives"][k] + bf16[0]["recomputed"][k]
                         for k in plain["collectives"]}
            check(bf16[0]["collectives"] == want_coll,
                  f"remat: collectives {bf16[0]['collectives']}, expected the plain step's and "
                  f"its recomputation's {want_coll}")
        b = bf16[0]
        print(f"[21] {smi}: {name} bf16 split step, batch 8 at 512^2, rank 0 of 2 (beside the "
              f"plain split step's): loss {b['loss']:.6f} on both ranks; device "
              f"{b['device_ms']:.2f} ms ({plain['device_ms']:.2f}) in {b['launches']:.0f} "
              f"launches ({plain['launches']:.0f}), host {b['host_ms']:.2f} ms "
              f"({plain['host_ms']:.2f}), peak {b['peak_mib']:.1f} MiB ({plain['peak_mib']:.1f}), "
              f"a train forward saves {sum(b['saved'].values()):.1f} MiB "
              f"({sum(plain['saved'].values()):.1f}); collectives a step {b['collectives']} "
              f"({plain['collectives']}), of them recomputed {b['recomputed']}, bytes "
              f"{b['bytes']} ({plain['bytes']}); no exchange of row counts")


# -------------------------------------------------- the sharded fused kernels
SHARDED_FUSED = {"fused_stem": "always", "fused_blocks": "always"}
# launches of the eight fused kernel entries in one train step at phase 6's
# shapes (the stem's four; 26 1x1 and 12 3x3 block convs each way)
FUSED_STEP_LAUNCHES = {"stats": 1, "pool": 1, "sums": 1, "wgrad": 1,
                       "mm_fwd": 26, "c3_fwd": 12, "mm_bwd": 26, "c3_bwd": 12}
SHARDED_OUT = TRAIN_OUT.with_name("chip_smoke_sharded_fused")


def _fused_launches(fs, fb) -> dict:
    """The fused stem's and blocks' eight counters under FUSED_STEP_LAUNCHES's
    keys."""
    return dict(zip(FUSED_STEP_LAUNCHES, read_counters(fs, STEM_COUNTERS)
                    + read_counters(fb, BLOCK_COUNTERS)))


def _rank_fused_step(rank: int, ranks: int, rendezvous: str, out: str) -> None:
    """Phase 22 in a spawned rank: phase 15's f32 step with the fused stem and
    blocks on this rank's rows (TF32 off and on), and the fused kernels'
    launches."""
    from iswm_tpu_torch.ops.kernels import fused_block as fb
    from iswm_tpu_torch.ops.kernels import fused_stem as fs
    from iswm_tpu_torch.ops.losses import make_loss_fn
    from iswm_tpu_torch.parallel import destroy
    from iswm_tpu_torch.train import make_train_step

    _join_gloo(rank, ranks, rendezvous)
    try:
        x, y = _dp_batch()
        rows = slice(rank * len(x) // ranks, (rank + 1) * len(x) // ranks)
        step = make_train_step(make_loss_fn("ce_loss", fused="auto", device="cuda"))
        zero_counters(fs, STEM_COUNTERS)
        zero_counters(fb, BLOCK_COUNTERS)
        seen = _f32_rank_steps(step, x[rows], y[rows], rank, **SHARDED_FUSED)
        seen["launches"] = _fused_launches(fs, fb)
    finally:
        destroy()
    torch.save(seen, Path(out) / f"_rank_fused_step.{rank}.pt")


def phase_sharded_fused(fs, fb, group_step: dict, smi: str) -> dict:
    """The fused stem and blocks in a process group (their BatchNorm sums
    all-reduced): phase 15's bf16 step in a 1-rank nccl group with
    ``fused_stem`` / ``fused_blocks`` = "always" beside phase 15's unfused
    group step (``group_step``), phase 15's f32 step on two gloo ranks held
    to phase 15's limits of the one-process fused step; returns the phase's
    launches of the eight fused entries (the group's and both ranks')."""
    from iswm_tpu_torch.data import batch_iterator
    from iswm_tpu_torch.models import layers
    from iswm_tpu_torch.parallel import destroy, distributed

    t_phase = time.perf_counter()
    SHARDED_OUT.mkdir(parents=True, exist_ok=True)
    _open_group("phase22.nccl")
    zero_counters(fs, STEM_COUNTERS)
    zero_counters(fb, BLOCK_COUNTERS)
    trainer, cfg, train_ds, _ = _slice_trainer(DP_STEPS, "chip_smoke_group_fused",
                                               **SHARDED_FUSED)
    check(trainer.state.replicated is not None, "the Trainer did not wrap its model for the group")
    batchnorms = sum(isinstance(m, layers.BatchNorm2d) for m in trainer.state.model.modules())
    images, labels = next(batch_iterator(train_ds, cfg.data.batch_size))
    xu8, yu8 = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    trainer.train_step(trainer.state, xu8, yu8)  # the first step's autotuning
    torch.cuda.synchronize()
    reduces, before = distributed.cross_replica_all_reduces, _fused_launches(fs, fb)
    loss = float(trainer.train_step(trainer.state, xu8, yu8))
    reduces = distributed.cross_replica_all_reduces - reduces
    per_step = {k: v - before[k] for k, v in _fused_launches(fs, fb).items()}
    check(per_step == FUSED_STEP_LAUNCHES,
          f"fused launches in one group step {per_step}, expected {FUSED_STEP_LAUNCHES}")
    check(reduces == 2 * batchnorms,
          f"{reduces} BatchNorm all-reduces in a fused group step, expected 2 for each of "
          f"{batchnorms} BatchNorms (a fused conv's sums or the cross-replica module's)")
    check(np.isfinite(loss), f"fused group step loss {loss}")
    fused = {**_step_numbers(trainer, xu8, yu8), "all_reduces": reduces}
    del trainer
    print(f"[22] fused stem and blocks in a 1-rank nccl group: bf16 step loss {loss:.4f}; a "
          f"step launches {per_step} and makes {reduces} all-reduces (2 x {batchnorms} "
          f"BatchNorms: the fused convs' and the stem's sums, the other BatchNorms')")
    for name, numbers in (("fused", fused), ("unfused (phase 15)", group_step)):
        print(f"[22] {smi}: 1-rank group bf16 step, batch 8 at 512^2, {name}: device "
              f"{numbers['device_ms']:.2f} ms in {numbers['launches']:.0f} launches ("
              + ", ".join(f"{c} {t:.2f}" for c, t in sorted(numbers["by_class"].items(),
                                                           key=lambda kv: -kv[1]))
              + f"), host {numbers['host_ms']:.2f} ms (median), {numbers['all_reduces']} "
              f"all-reduces, peak {numbers['peak_mib']:.1f} MiB ({numbers['base_mib']:.1f} "
              f"before the step)")
    reference = _dp_reference(**SHARDED_FUSED)
    destroy()
    group = _fused_launches(fs, fb)
    t_ranks = time.perf_counter()
    ranks = _spawn_ranks(_rank_fused_step, SHARDED_OUT)
    t_ranks = time.perf_counter() - t_ranks
    _hold_two_rank_step(reference, ranks, "[22]", "4 rows each, fused stem and blocks")
    for r, seen in enumerate(ranks):  # two steps a rank: TF32 off and on
        want = {k: 2 * v for k, v in FUSED_STEP_LAUNCHES.items()}
        check(seen["launches"] == want,
              f"rank {r}: fused launches {seen['launches']} in two f32 steps, expected {want}")
    totals = {k: group[k] + sum(seen["launches"][k] for seen in ranks) for k in group}
    print(f"[22] fused launches in the phase (1-rank group and both ranks) {totals}; phase 22 "
          f"in {time.perf_counter() - t_phase:.1f} s (the ranks' processes {t_ranks:.1f} s)")
    return totals


# ------------------------------------------------------------- the engines
ENGINE_VARIANTS = ("bf16", "int8_exec", "int8_exec_xla")
FUSED_STEM_FN = "bf16 fused stem"  # phase 23's fn beside the variants
# the serving operators' launch counters: (name, module key, counter)
SERVING_COUNTERS = (("int8_matmul", "k8", "launches"), ("quantize_s8", "kc", "launches_quantize"),
                    ("conv_s8_igemm", "kc", "launches_igemm"),
                    ("conv_s8_direct", "kc", "launches_direct"),
                    ("stem_norm_relu_pool", "fs", "launches_pool"))


def _serving_modules() -> dict:
    from iswm_tpu_torch.ops.kernels import fused_stem as fs
    from iswm_tpu_torch.ops.kernels import int8_conv as kc
    from iswm_tpu_torch.ops.kernels import int8_matmul as k8

    return {"k8": k8, "kc": kc, "fs": fs}


def _serving_launches() -> dict:
    """{serving operator: its launch counter}."""
    mods = _serving_modules()
    return {name: getattr(mods[m], c) for name, m, c in SERVING_COUNTERS}


def _launches_since(before: dict) -> dict:
    """The serving operators' launches since ``before`` (``_serving_launches()``),
    where there were any."""
    return {k: v - before[k] for k, v in _serving_launches().items() if v != before[k]}


@contextlib.contextmanager
def _direct_ops():
    """Within: each serving wrapper calls its operator's CUDA implementation
    directly, not through the dispatcher, as the wrappers did before they
    were operators (the same checks, launches and counters)."""
    mods = _serving_modules()
    k8, kc, fs = mods["k8"], mods["kc"], mods["fs"]
    swaps = ((k8, "_int8_matmul", k8._cuda(False)), (kc, "_quantize", kc._quantize_cuda),
             (kc, "_conv_igemm", kc._conv_cuda("igemm")),
             (kc, "_conv_direct", kc._conv_cuda("direct")), (fs, "_pool", fs._pool_cuda))
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _host_ms(fn, reps: int = 10) -> float:
    """Median host-clock ms of ``fn()``, synchronized, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _dispatch_us(calls: int = 1000) -> dict:
    """{operator: (host µs a call through it, directly)}: each serving
    wrapper on small inputs on the card, enqueue time (before the sync),
    through its operator and calling its CUDA implementation directly, in
    turns (operator, direct, direct, operator), the median of each pair."""
    mods = _serving_modules()
    k8, kc, fs = mods["k8"], mods["kc"], mods["fs"]
    gen = torch.Generator().manual_seed(SEED)

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, generator=gen).cuda()

    x, w, ws = torch.randn(128, 256, generator=gen).cuda().bfloat16(), codes(256, 128), \
        torch.rand(128, generator=gen).cuda()
    xq, wq, ws64 = codes(2, 8, 8, 64), codes(64, 3, 3, 64), torch.rand(64, generator=gen).cuda()
    xf = torch.randn(2, 8, 8, 64, generator=gen).cuda().bfloat16()
    z = torch.randn(2, 64, 8, 8, generator=gen).cuda().bfloat16().contiguous(
        memory_format=torch.channels_last)
    geometry = (None, None, [1, 1], [1, 1, 1, 1], [1, 1], torch.bfloat16)
    cases = {"int8_matmul": (k8._int8_matmul, k8._cuda(False), (x, w, ws, 0.05)),
             "quantize_s8": (kc._quantize, kc._quantize_cuda, (xf, 0.05, None)),
             "conv_s8_igemm": (kc._conv_igemm, kc._conv_cuda("igemm"),
                               (xq, wq, ws64, 0.05, *geometry)),
             "stem_norm_relu_pool": (fs._pool, fs._pool_cuda, (z, ws64, ws64))}
    out = {}
    with torch.inference_mode():
        for name, (operator, direct, args) in cases.items():
            times = {operator: [], direct: []}
            for fn in (operator, direct, direct, operator):
                for _ in range(100):
                    fn(*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn(*args)
                times[fn].append((time.perf_counter() - t0) / calls * 1e6)
                torch.cuda.synchronize()
            out[name] = (float(np.median(times[operator])), float(np.median(times[direct])))
    return out


def _engine_fn(variant: str, scene: np.ndarray):
    """Phase 23's serving fn of ``variant`` (or the fused-stem fn), its
    Predictor having served ``scene`` (the int8 variants calibrate on it)."""
    from iswm_tpu_torch.config import Config
    from iswm_tpu_torch.infer import Predictor

    cfg = Config()  # deeplabv3plus_resnet50, OS 16, bf16, tile 512/64/8
    if variant == FUSED_STEM_FN:
        cfg.model.fused_stem = "always"
    else:
        cfg.predict.serving_variant = variant
    predictor = Predictor(cfg, device="cuda")
    predictor.predict_image(scene)
    return predictor.engine.model_fn


def phase_engine(smi: str) -> dict:
    """Phase 4's serving fns and the fused-stem fn as CUDA-graph engines
    (``infer/engine.py``): a chunk of 8 tiles of phase 4's first scene
    replayed bit-equal to the eager fn (two chunks); the host ms of a chunk
    eager, through the operators and directly, and replayed.  Each fn
    through ``serialize`` / ``deserialize`` on the card: no launch in the
    trace, bit-equal to the eager fn on both chunks, the eager fn's launches
    a chunk.  Returns the phase's launches of #1, the int8 convs and #10
    (eager calls, captures and artifact calls: a graph's replay calls no
    wrapper)."""
    from iswm_tpu_torch.data import val_transform_batch
    from iswm_tpu_torch.infer.engine import build_engine, deserialize, serialize

    scene = np.random.default_rng(SEED).integers(0, 256, SCENES[0] + (3,), dtype=np.uint8)
    x = val_transform_batch(torch.from_numpy(scene).cuda())
    chunks = [torch.stack([x[oy:oy + 512, ox:ox + 512] for oy in rows
                           for ox in (0, 384, 768, 1024)]) for rows in ((0, 448), (256, 512))]
    shape, dtype = tuple(chunks[0].shape), chunks[0].dtype
    flags = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    per_call = _dispatch_us()
    print(f"[23] {smi}: host µs a call of each serving wrapper on small inputs (enqueue, "
          f"1000 calls, median of two turns), through its iswm operator / its CUDA "
          f"implementation called directly: "
          + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in per_call.items()))
    mods = _serving_modules()
    for _, m, counter in SERVING_COUNTERS:
        setattr(mods[m], counter, 0)
    for variant in ENGINE_VARIANTS + (FUSED_STEM_FN,):
        fn = _engine_fn(variant, scene)
        engine = build_engine(fn, shape, dtype)
        for i, chunk in enumerate(chunks):
            replayed, eager = engine(chunk), fn(chunk)
            check(torch.equal(replayed, eager),
                  f"{variant}: the replay of chunk {i} differs from the eager fn by "
                  f"{float((replayed - eager).abs().max())}")
        eager_ms = _host_ms(lambda: fn(chunks[0]))
        with _direct_ops():
            direct_ms = _host_ms(lambda: fn(chunks[0]))
        eager_again_ms = _host_ms(lambda: fn(chunks[0]))
        graph_ms = _host_ms(lambda: engine(chunks[0]))
        pool = engine.memory_analysis["graph_pool_bytes"] / 2**20
        flops = "not counted" if engine.flops is None else f"{engine.flops / 1e9:.1f} GFLOP"
        print(f"[23] {smi}: {variant} engine, a chunk of 8 x 512^2: replays bit-equal to the "
              f"eager fn on two chunks; host clock (synchronized, median of 10, deterministic "
              f"cuDNN) eager {eager_ms:.3f} ms through the iswm operators ({eager_again_ms:.3f} "
              f"ms again), {direct_ms:.3f} ms with the wrappers calling their CUDA "
              f"implementations directly, replayed {graph_ms:.3f} ms; graph pool {pool:.1f} MiB; "
              f"library flops counted at build {flops} (the hand kernels' not seen)")
        del engine
        before = _serving_launches()
        fn(chunks[0])
        eager_launches = _launches_since(before)
        before = _serving_launches()
        t0 = time.perf_counter()
        blob = serialize(fn, shape, dtype)
        t_blob = time.perf_counter() - t0
        check(not _launches_since(before), f"{variant}: the trace launched "
                                           f"{_launches_since(before)}")
        served = deserialize(blob)
        nodes = sorted({str(n.target) for n in served.graph.nodes
                        if str(n.target).startswith("iswm.")})
        for i, chunk in enumerate(chunks):
            with torch.inference_mode():
                before = _serving_launches()
                got = served(chunk)
                launched = _launches_since(before)
                eager = fn(chunk)
            check(torch.equal(got, eager),
                  f"{variant}: the deserialized artifact differs from the eager fn on chunk {i} "
                  f"by {float((got.float() - eager.float()).abs().max())}")
            check(launched == eager_launches,
                  f"{variant}: the artifact launched {launched} on chunk {i}, the eager fn "
                  f"{eager_launches}")
        want = {"int8_exec": {"int8_matmul": 30}, FUSED_STEM_FN: {"stem_norm_relu_pool": 1},
                "bf16": {}}.get(variant)
        check(want is None or eager_launches == want,
              f"{variant}: the eager fn launched {eager_launches} a chunk, expected {want}")
        check(variant != "int8_exec_xla" or {"int8_matmul", "quantize_s8", "conv_s8_igemm"}
              <= set(eager_launches), f"int8_exec_xla launched {eager_launches} a chunk")
        with torch.inference_mode():
            served_ms = _host_ms(lambda: served(chunks[0]))
        print(f"[23] {smi}: {variant} serving fn through serialize (torch.export on the card, "
              f"{t_blob:.1f} s, {len(blob) / 2**20:.1f} MiB, no launch in the trace; graph calls "
              f"{nodes or 'no iswm operator'}) and deserialize: bit-equal to the eager fn on two "
              f"chunks, launching {launched or 'no hand kernel'} a chunk as the eager fn; the "
              f"artifact's host clock {served_ms:.3f} ms a chunk (median of 10)")
        del served, blob, fn
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = flags
    counts = _serving_launches()
    return {"matmul": counts["int8_matmul"], "quantize": counts["quantize_s8"],
            "igemm": counts["conv_s8_igemm"], "pool": counts["stem_norm_relu_pool"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an H100",
              file=sys.stderr)
        return 1
    from iswm_tpu_torch.ops.kernels import confusion as cm
    from iswm_tpu_torch.ops.kernels import fused_block as fb
    from iswm_tpu_torch.ops.kernels import fused_ce as ce
    from iswm_tpu_torch.ops.kernels import fused_stem as fs
    from iswm_tpu_torch.ops.kernels import int8_conv as kc
    from iswm_tpu_torch.ops.kernels import int8_matmul as k8

    if sys.argv[1:2] in (["--block-stat-starts"], ["--block-f32-starts"]):
        phase_device()
        phase_build({"fused_ce": ce, "fused_block": fb})
        readings = {"--block-stat-starts": block_stat_readings,
                    "--block-f32-starts": block_f32_readings}[sys.argv[1]]
        readings(int(sys.argv[2]))
        return 0
    phase_device()
    phase_build({"int8_matmul": k8, "fused_ce": ce, "confusion": cm, "fused_stem": fs,
                 "fused_block": fb, "int8_conv": kc})
    record = phase_kernel(k8)
    # int8_matmul_prequant is on no main path (in the JAX package only tests
    # and benchmarks call it, and so here): its count over the three main
    # paths stays 0; phase 7's launches hold it against its plain version
    k8.launches_prequant = 0
    launches = phase_slice(k8)
    ce_record = phase_fused_ce(ce)
    (ce_fwd, ce_bwd, cm_launches), trainer = phase_train(ce, cm)
    prequant_launches = k8.launches_prequant
    cm_record, prequant_record = phase_eval_kernels(k8, cm)
    phase_quick_eval(cm, trainer, cm_launches)
    del trainer
    k8.launches_prequant = 0
    phase_compare_variants(k8)
    prequant_launches += k8.launches_prequant
    stem_records = phase_stem_kernels(fs)
    stem_launches = dict(zip(("stats", "pool", "sums", "wgrad"), phase_stem_slice(fs, ce)))
    block_records = phase_block_kernels(fb)
    block_launches = dict(zip(("mm_fwd", "c3_fwd", "mm_bwd", "c3_bwd"),
                              phase_block_slice(fb, ce)))
    sharded_record = phase_sharded_ce(ce)
    sharded_launches, group_step = phase_dp_slice(ce, cm)
    # the zoo's main paths: serving (#1) and training with a quick-eval (#4, #6)
    smi = _smi()
    record.update(phase_zoo_kernel(k8))
    launches += phase_zoo_serving(k8, smi)
    zoo_fwd, zoo_bwd, zoo_cm = phase_zoo_train(ce, cm, smi)
    ce_fwd, ce_bwd, cm_launches = ce_fwd + zoo_fwd, ce_bwd + zoo_bwd, cm_launches + zoo_cm
    # int8_exec_xla: the int8 convs (#1 serves its 1x1 sites there too)
    xla_records = phase_int8_xla_kernels(kc, smi)
    xla_launches = phase_int8_xla_serving(k8, kc, smi)
    launches += xla_launches["matmul"]
    phase_int8_xla_compare(kc)
    # quantization-aware training: the device-scale entries (the main path's
    # launches of the quantize and the dense conv counted by scale source)
    qat_records = phase_qat_kernels(kc, smi)
    qat_launches = phase_qat_train(kc, smi)
    # QAT's int8 backward: the data and weight gradients' entries
    bwd_records = phase_qat_bwd_kernels(kc, smi)
    bwd_launches = phase_qat_bwd_train(kc, smi)
    # remat and bf16 parameters: the fits' and steps' launches join the totals
    remat = phase_remat(fs, fb, kc, ce, cm, smi)
    ce_fwd += remat["fused_ce.launches_fwd"]
    ce_bwd += remat["fused_ce.launches_bwd"]
    cm_launches += remat["confusion.launches"]
    for key, name in (("stats", "stats"), ("pool", "pool"), ("sums", "bwd_sums"),
                      ("wgrad", "bwd_wgrad")):
        stem_launches[key] += remat[f"fused_stem.launches_{name}"]
    for key in block_launches:
        block_launches[key] += remat[f"fused_block.launches_{key}"]
    for key in ("dgrad", "wgrad", "rotated"):
        bwd_launches[key] += remat[f"int8_conv.launches_{key}"]
    for mode in bwd_launches["reduce"]:
        bwd_launches["reduce"][mode] += remat[f"int8_conv.reduce {mode}"]
    for kind in ("dgrad", "wgrad"):
        for body in bwd_launches[f"{kind}_by_body"]:
            bwd_launches[f"{kind}_by_body"][body] += remat[f"int8_conv.{kind} {body}"]
    for e in ("quantize", "igemm"):
        bwd_launches[e] += remat[f"int8_conv.{e} device"]
    # the spatial model axis: the split steps' #4 / #5 and the scene-parallel
    # serving's #1 and int8 convs, summed over the phase's two ranks
    spatial = phase_spatial(smi)
    sharded_launches += spatial["sharded"]
    ce_fwd += spatial["fwd"]
    ce_bwd += spatial["bwd"]
    launches += spatial["matmul"]
    for e in ("quantize", "igemm"):
        xla_launches[e] += spatial[e]
    # ... and its QAT option's int8 backward and device-scale entries
    for key in ("dgrad", "wgrad", "rotated"):
        bwd_launches[key] += spatial["qat"][f"int8_conv.launches_{key}"]
    for mode in bwd_launches["reduce"]:
        bwd_launches["reduce"][mode] += spatial["qat"][f"int8_conv.reduce {mode}"]
    for kind in ("dgrad", "wgrad"):
        for body in bwd_launches[f"{kind}_by_body"]:
            bwd_launches[f"{kind}_by_body"][body] += spatial["qat"][f"int8_conv.{kind} {body}"]
    for e in ("quantize", "igemm"):
        bwd_launches[e] += spatial["qat"][f"int8_conv.{e} device"]
    # the fused stem and blocks in a process group: their eight entries
    fused_group = phase_sharded_fused(fs, fb, group_step, smi)
    for key in stem_launches:
        stem_launches[key] += fused_group[key]
    for key in block_launches:
        block_launches[key] += fused_group[key]
    # the serving fns as CUDA-graph engines and exported artifacts: #1, the
    # int8 convs and #10
    engine = phase_engine(smi)
    launches += engine["matmul"]
    stem_launches["pool"] += engine["pool"]
    for e in ("quantize", "igemm"):
        xla_launches[e] += engine[e]
    by_scale = {e: {"host": xla_launches[e] + qat_launches[e]["host"],
                    "device": qat_launches[e]["device"] + bwd_launches[e]}
                for e in ("quantize", "igemm")}
    for name, count in (("int8_matmul", launches), ("fused_binary_ce_fwd", ce_fwd),
                        ("sharded_fused_binary_ce", sharded_launches),
                        ("fused_binary_ce_bwd", ce_bwd), ("binary_confusion_matrix", cm_launches),
                        *((f"stem {k}", v) for k, v in stem_launches.items()),
                        *((f"fused block {k}", v) for k, v in block_launches.items()),
                        *((f"int8_conv {k}", xla_launches[k])
                          for k in ("quantize", "igemm", "direct")),
                        *((f"int8_conv's {b} body", xla_launches["bodies"][b])
                          for b in ("wgmma", "bytes", "tiled")),
                        *((f"int8_conv {e} with a device scale", by_scale[e]["device"])
                          for e in by_scale),
                        ("int8_conv_s8_dgrad", bwd_launches["dgrad"]),
                        ("int8_conv_s8_dgrad's parity split",
                         bwd_launches["dgrad_by_body"]["parity"]),
                        ("int8_conv_s8_wgrad", bwd_launches["wgrad"]),
                        ("int8_quantize_s8_reduce", sum(bwd_launches["reduce"].values())),
                        ("int8_rotated_weight_codes", bwd_launches["rotated"])):
        check(count > 0, f"the main paths never launched {name}")
    print(f"[profiler] traces of the run: {TRACES['whole']} whole at the first take, "
          f"{TRACES['retaken']} whole after a retake, {TRACES['estimated']} never whole "
          f"(launches estimated; each said so on stderr); {TRACES['short']} of "
          f"{TRACES['takes']} takes lacked one marker or more")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("iswm_tpu", "jax", "flax"))
    check(not loaded, f"the port imported {loaded}")
    fused = "iswm_tpu/ops/pallas/fused_ce.py"
    matmul = "iswm_tpu/ops/pallas/int8_matmul.py"
    stem = "iswm_tpu/ops/pallas/fused_stem.py"
    stem_rows = (
        ("stem_stats", "stats", f"{stem}:106 (stem_stats {stem}:98)"),
        ("stem_norm_relu_pool", "pool", f"{stem}:168 (stem_norm_relu_pool {stem}:154)"),
        ("stem_tail_bwd_sums", "sums",
         f"{stem}:420 (_bwd_sums_kernel, first call of stem_tail_bwd {stem}:368)"),
        ("stem_tail_bwd_wgrad", "wgrad",
         f"{stem}:450 (_bwd_wgrad_kernel, second call of stem_tail_bwd {stem}:368)"),
    )
    block = "iswm_tpu/ops/pallas/fused_block.py"
    block_rows = (
        ("matmul_bn_stats_fwd", "mm_fwd",
         f"{block}:130 (_mm_fwd_kernel {block}:60, reached from matmul_bn_stats {block}:192)"),
        ("matmul_bn_stats_bwd", "mm_bwd",
         f"{block}:161 (_mm_bwd_kernel {block}:82, the VJP of matmul_bn_stats {block}:192)"),
        ("conv3x3_bn_stats_fwd", "c3_fwd",
         f"{block}:396 (_c3_fwd_kernel {block}:224, reached from conv3x3_bn_stats {block}:470)"),
        ("conv3x3_bn_stats_bwd", "c3_bwd",
         f"{block}:431 (_c3_bwd_kernel {block}:277, the VJP of conv3x3_bn_stats {block}:470)"),
    )
    xla = "iswm_tpu/ops/int8_xla.py"
    xla_rows = (  # work the JAX package leaves to XLA (no pallas_call)
        ("int8_quantize_s8", "quantize",
         f"{xla}:66 (quantized_conv_xla's quantize_activations {xla}:23)", ()),
        ("int8_conv_s8_igemm", "igemm",
         f"{xla}:66 (quantized_conv_xla, dense; int8_packed_stem_conv {xla}:107, "
         f"int8_shifted_dilated_conv {xla}:158)", ("wgmma", "bytes")),
        ("int8_conv_s8_direct", "direct", f"{xla}:66 (quantized_conv_xla, feature_group_count > 1)",
         ("tiled", "generic")),
    )
    print(json.dumps({"kernels": [
        {"name": "int8_matmul", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/int8_matmul.cu",
         "replaces": f"{matmul}:43", "launches": launches, **record},
        {"name": "int8_matmul_prequant", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/int8_matmul.cu",
         "replaces": f"{matmul}:96", "launches": prequant_launches,
         "on_a_main_path": False, **prequant_record},
        {"name": "fused_binary_ce_fwd", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/fused_ce.cu",
         "replaces": f"{fused}:76 (_fwd_kernel, reached from fused_binary_ce {fused}:134)",
         "launches": ce_fwd, **ce_record["fwd"]},
        {"name": "fused_binary_ce_bwd", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/fused_ce.cu",
         "replaces": f"{fused}:117 (_bwd_kernel, reached from fused_binary_ce {fused}:134)",
         "launches": ce_bwd, **ce_record["bwd"]},
        {"name": "sharded_fused_binary_ce", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/fused_ce.cu",
         "wrapper": "iswm_tpu_torch/ops/kernels/fused_ce.py (ShardedFusedBinaryCE)",
         "collective": "torch.distributed.all_reduce of the two sums (NCCL)",
         "replaces": f"{fused}:206 (_sharded_local_ce, forward {fused}:213, backward "
                     f"{fused}:221, reached from make_sharded_fused_ce {fused}:234)",
         "launches": sharded_launches, **sharded_record},
        {"name": "binary_confusion_matrix", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/confusion.cu",
         "replaces": "iswm_tpu/ops/pallas/confusion.py:54",
         "launches": cm_launches, **cm_record},
        *({"name": name, "route": "cuda", "source": "iswm_tpu_torch/csrc/fused_stem.cu",
           "replaces": replaces, "launches": stem_launches[key], **stem_records[key]}
          for name, key, replaces in stem_rows),
        *({"name": name, "route": "cuda", "source": "iswm_tpu_torch/csrc/fused_block.cu",
           "replaces": replaces, "launches": block_launches[key], **block_records[key]}
          for name, key, replaces in block_rows),
        *({"name": name, "route": "cuda", "source": "iswm_tpu_torch/csrc/int8_conv.cu",
           "replaces": replaces, "pallas_call": False,
           "launches": sum(by_scale[key].values()) if key in by_scale else xla_launches[key],
           **({"launches_by_body": {b: xla_launches["bodies"][b] for b in bodies}}
              if bodies else {}),
           **({"launches_by_scale": by_scale[key],
               "device_scale": {"ms": qat_records[key]["ms"],
                                "bound_ms": qat_records[key]["bound_ms"],
                                "bound_by": qat_records[key]["bound_by"],
                                "replaces": "iswm_tpu/ops/int8_train.py:31 (_dyn_quant_x) and "
                                            ":57 / :112 / :434 (the QAT convs' int8 forward)"}}
              if key in by_scale else {}),
           **xla_records[key]}
          for name, key, replaces, bodies in xla_rows),
        *({"name": f"int8_conv_s8_{key}", "route": "cuda",
           "source": "iswm_tpu_torch/csrc/int8_conv.cu", "replaces": replaces,
           "pallas_call": False, "launches": bwd_launches[key],
           **({"launches_by_body": bwd_launches["wgrad_by_body"], "bodies": WGRAD_BODIES}
              if key == "wgrad" else {"launches_by_body": bwd_launches["dgrad_by_body"],
                                      "bodies": DGRAD_BODIES}),
           **bwd_records[key]}
          for key, replaces in (
              ("dgrad", "iswm_tpu/ops/int8_train.py:202 (_int8_dgrad) / :458 (_dil_bwd)"),
              ("wgrad", "iswm_tpu/ops/int8_train.py:232 (_int8_wgrad) / :458 (_dil_bwd)"))),
        {"name": "int8_quantize_s8_reduce", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/int8_conv.cu",
         "replaces": "iswm_tpu/ops/int8_train.py:31 (_dyn_quant_x: the amax and the codes) and "
                     ":273 (_quant_g); the delayed amax's max |x| (:130)",
         "pallas_call": False, "launches": sum(bwd_launches["reduce"].values()),
         "launches_by_mode": bwd_launches["reduce"],
         "body": "quantize_kernel's reducing modes (dynamic: one cooperative launch, the max, "
                 "a grid barrier, the codes walked backwards; amax; delayed)",
         **bwd_records["quantize"]},
        {"name": "int8_rotated_weight_codes", "route": "cuda",
         "source": "iswm_tpu_torch/csrc/int8_conv.cu",
         "replaces": "iswm_tpu/ops/int8_train.py:209 (_int8_dgrad's per-tensor weight quantize "
                     "and rotation, :209-217) / :471 (_dil_bwd's)",
         "pallas_call": False, "launches": bwd_launches["rotated"],
         "body": DGRAD_BODIES["weights"], **bwd_records["rotated"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
