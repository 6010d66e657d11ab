#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout:  python3 chip_smoke.py

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles divergen_tpu_torch/csrc/*.cu with nvcc (timed).
3. Kernel phases: each hand-written kernel (flash_attention_packed,
   fused_ln_matmul, flash_attention, flash_attention_relpos,
   fused_window_attention_packed, fused_window_attention, and the backward
   kernels of the last two) against its
   plain torch version on the same bf16 inputs (plain version in float32),
   at the shapes of the SDXL, SAM and Swin-L slices plus ragged cases
   (flash_attention_packed also on float32 qkv at the float32 bound below, and at SDXL's two
   self-attention shapes of a UNet call, (4, 4096, 640, 10) and
   (4, 1024, 1280, 20), with its device time, SDPA's, the bound and their
   sums over the call's 70 launches; it and flash_attention give the same
   bits twice and write nothing past their output, which they are given as
   the first rows of a buffer whose next row is NaN; flash_attention at
   d = 512 at the VAE's (1, 16384, 16384), with its device time beside
   SDPA's, ragged with a bias, in float32 (the float32 bound), and as a
   packed (1, 4096, 3 x 512) projection of one head); fused_ln_matmul at the
   UNet's two GEGLU shapes of a call (4096, 1280, 10240) and (16384, 640,
   5120), SAM ViT-H's qkv (16384, 1280, 3840, bias) and mlp_fc1 (GELU, bias),
   ragged (1000, 640, 3840) without and with GEGLU, (200, 2560, 336) GEGLU
   (K past the apply pass's registers), and float32 x and w at
   the float32 bound, each the same bits twice and nothing written past its
   output (a NaN guard row), the bf16 ones at M >= 4096 with their device
   time beside the PyTorch call's and the bound, summed over a UNet call's
   70 launches;
   flash_attention_relpos first on heads-first views of a fused qkv
   projection, as the ViT's attention calls it, then on (BH, N, D), each the
   same bits twice and nothing written past its output (a NaN guard row), its
   q rows a work item and shared memory equal to ``RELPOS_TILE`` and
   ``relpos_smem()``, and at (4, 16 heads, 64 x 64, d 80) its device time
   beside SDPA's (the dense bias as a bf16 mask) and the bound; the
   packed window attention at the four Swin-L stage shapes of B = 2 at 896²
   with and without the shift mask and on shrunk windows, each the same bits
   twice and nothing written past its output (a NaN guard row), the bf16
   forward body's shared memory equal to ``forward_smem(n)`` for n = 1..144
   and the blocks the card holds of each instance equal to
   ``forward_resident(n)`` (both size its grid), at the four stages its
   device time beside SDPA's (the dense bias + mask built outside the
   timing) and the bound, summed over a Swin-L forward's 24 launches, and
   the wrapper's float32 copy of a bf16 bias timed apart; the split window
   attention at the stage-0 shape on contiguous tensors and on heads-first
   views of the fused projection, and on ragged windows, where it must equal
   the packed one. Bound per
   phase: relative L2 error <= 1e-2 and max |error| <= 3e-2 * max
   |reference|. Prints both errors, the median times of kernel and plain
   version (CUDA events) and, at each kernel's main shape, the time of the
   one PyTorch call that computes the same function in bf16
   (``scaled_dot_product_attention``; ``F.linear(F.layer_norm(x))`` + GELU or
   GEGLU) and the card's bound: the larger of operations / 989 TFLOP/s and
   bytes / 3.35 TB/s. The PyTorch call is a yardstick only; the port never
   calls it. Then the backward kernels of the two window-attention wrappers
   (their ``torch.autograd.Function``s) at the same four stage shapes with
   and without the mask and on ragged windows: dq, dk, dv and the float32
   dbias against ``reference_window_attention_packed_backward`` on the same
   bf16 inputs (the same bounds), the split wrapper's gradients equal to the
   packed one's bit for bit on the same projection, the same call twice equal
   bit for bit, the C entry point into dqkv and dbias buffers whose next row
   is NaN (the same bits, that row still NaN), the bf16 body's shared memory
   equal to ``backward_smem(n)`` (which sizes its grid) for n = 1..144, and
   beside the kernel's time that of the backward of
   ``scaled_dot_product_attention`` alone (its forward graph built outside
   the timing, as the kernel's is), with its forward + backward printed too;
   at the four stage shapes the device time of the backward kernels alone
   beside SDPA's backward and the bound, and their sums over a train step's
   24 launches.
   Then kernels 1, 3, 4, 5 and 6 on float32 inputs (the float32 body,
   ``csrc/attention_f32.cu``): packed (2, 256, 3 x 128, 2 heads), d = 512
   with a bias (1, 1024, 1024), relpos (2, 16 heads, 16 x 16, d 80) on views
   of a fused projection, and both window wrappers forward and backward at
   bn 8, n 144, 6 heads with a mask, against their float32 twins at the
   float32 bound, relative L2 <= 1e-5 and max |error| <= 1e-4 * max
   |reference| (bf16 operands give 2-4e-3), each the same bits twice, with
   its time beside the twin's, after the body's tile plan
   (``dg_attention_f32_plan``) is held against ``TC_PLANS``; then the same at full width (kernel 3 at
   (1, 16384, 512) and (1, 4096, 512), kernel 4 at (4, 16, 64 x 64, 80),
   kernel 1 at (4, 4096, 640, 10), the window forward at Swin-L stage 1,
   (722, 6) with the mask), with the device time beside the twin's, the
   PyTorch float32 call's and the name of its longest kernel, and the
   bounds at 3xTF32 and at FMA (``PEAK_F32_TC_FLOPS``, ``PEAK_F32_FLOPS``);
   fused_ln_matmul in float32 at the UNet's and SAM's four shapes the same
   way. Then the kernels of SDXL's int8 + fused-norm serving path
   (``serving_kernel_phases``): int8_matmul_fused_quant at every GEMM shape
   of an int8 UNet call that it takes (level-2 ff_geglu first),
   int8_matmul_pallas at level-2 ff_out and the attn2_kv shapes (M = 4 x
   77), each with a ragged case, equal to their plain versions' results in
   every element (0 differing), each UNet shape with its device time,
   torch._int_mm's, the bound and its launches per UNet call, summed per
   kernel, and nothing written past the output (float32 cases with N % 8 ==
   4 among them); the row-quantize pass of int8_matmul_fused_quant equal to
   quantize_rows_fq_reference in every element, on rows built to hit its
   ties and edges; fused_group_norm and fused_layer_norm at the UNet's
   shapes and ragged ones (the usual bounds), fused_layer_norm with its
   device time at both UNet shapes beside ``F.layer_norm``'s and the bound,
   summed over an int8 UNet call's 210 launches; each of the four also with float32 x and
   output (GroupNorm at C = 7680); fused_group_norm also nothing written past
   its output (a NaN after it) and its block size equal to
   ``NORM_THREADS``, and at each of the 14 shapes of an int8 UNet call's 46
   launches (``UNET_GROUP_NORMS``), bf16 and float32, held as above with its
   device time beside ``F.group_norm`` (+ ``F.silu``) and the bound, summed
   over the call; then fused_gn_silu_conv3x3 at the fused
   ResBlock's level-0 (4, 128, 128, 320) -> 320 and level-2 (4, 32, 32, 2560)
   -> 1280, ragged (C = 48, and C = 36 to Co = 21) and float32 x against its
   twin in float32 (the usual bounds), its apply pass's y within one bf16
   ulp of the twin's bf16(silu(x a + s)), nothing written past its output
   (a NaN guard row), and at each of the 12 shapes of a fused UNet call its
   device time, the PyTorch call's and the bound, summed per call; every one
   the same bits twice;
   yardsticks ``torch._int_mm`` (and the bf16 matmul it replaces),
   ``F.group_norm``, ``F.layer_norm`` and ``F.group_norm`` + ``F.silu`` +
   ``F.conv2d``; bounds at 1979 TOPS int8, 67 TFLOP/s f32 or 989 TFLOP/s
   bf16.
   Then the float32 window backward body (3xTF32 on mma.sync, one block per
   head and chunk of windows) at Swin-L's four stage shapes and the smoke
   shape (bn 8, 6 heads, nW 4), with and without the mask: dq, dk, dv and
   dbias against the float32 twin at the float32 bound, the same bits twice,
   device time beside the twin's, SDPA's float32 backward and the bound at
   3xTF32, its shared memory and resident blocks held against
   ``f32_backward_smem`` / ``_resident`` (n = 1..144, d 32 and 64). Then the
   head dims padded to a body's width, each against its twin at the true
   head dim with its time beside the twin's, SDPA's and the bound: kernel 3
   at d = 16 and 96 with a bias (bf16 and float32), kernel 1 at d = 16
   through kernel 3's path, kernel 4 at d = 64 on a 32 x 32 grid, the window
   kernels forward and backward at d = 16 in bf16 and d = 64 in float32.
   Then the six forward-only wrappers (and kernel 8) under
   ``torch.enable_grad()`` on CUDA inputs that require grad: each must raise.
   Then kernels 1, 2 and 3 at the x4 upscaler's shapes
   (``upscaler_kernel_phases``): kernel 1 at (4, 16384, 512, 8), (4, 4096,
   512, 8) and (4, 1024, 1024, 16), kernel 2's GEGLU at (65536, 512, 4096),
   (16384, 512, 4096) and (4096, 1024, 8192), kernel 3 at the x4 VAE's (2,
   65536, 512), each against its float32 twin computed a block of queries at
   a time (the usual bounds), the same bits twice, with its device time
   beside the PyTorch call's (SDPA, memory-efficient at d = 512; the LayerNorm
   + linear + GEGLU call) and the bound, kernels 1 and 2 summed over an
   upscaler UNet call's 16 launches.
4. Small models: a narrow UNet (d = 64 self-attention, GEGLU), a VAE decoder
   with a d = 512 mid attention, and a narrow SAM whose global layer runs the
   relative-position kernel at d = 80, bf16 on the card through the kernels,
   against the same weights in float32 on the CPU; the same narrow UNet
   (``UNetSDXL()``, its default ``ln_gemm="geglu"``) and SAM (``ln_gemm``,
   global attention) in float32 on the card through kernels 1, 2 and 4, against
   their float32 CPU copies at relative L2 <= 1e-4 and max |error| <= 1e-3 *
   max |reference|; and a narrow detector
   (Swin with d = 32 heads, window 7, FPN, CenterNet2 proposals, cascade and
   mask heads): pyramid features by relative L2, and its top detections; and
   one train step of that narrow detector (bf16 compute over float32
   parameters, SGD with clipping, EMA) against its float32 CPU copy on the
   same weights, batch and random draws: every loss, ``grad_norm`` and the
   updates of eight named parameters. The narrow UNet also with ``quant``,
   ``fused_ln`` and ``fused_gn`` against its float32 CPU copy with the same
   flags (mean |diff| / mean |ref| < 0.1), and with the fused norms alone
   against the plain norms on the card (relative L2 <= 3e-2); with
   ``conv_matmul="fused"`` in bf16 against the float32 CPU default path
   (relative L2 <= 3e-2); and a float32 ``UNetSDXL(quant, fused_ln, fused_gn,
   conv_matmul="fused")`` on the card, kernels 7 to 11 in float32, against its
   float32 CPU copy (mean |diff| / mean |ref| < 0.1). ``UNetSDXL.tiny()``
   (head dim 16: kernel 1 through kernel 3's path) one call in bf16 and in
   float32 against its float32 CPU copy (relative L2 <= 3e-2; <= 1e-4).
5. Slice at full SDXL width, launch counters reset just before it:
   (a) the port's ``txt2img.main`` writing two 1024² PNGs;
   (b) ``SDXLTextEncoder.random(tiny=False)`` → ``SDXLPipeline.generate``,
       B = 2 at 1024², DPM-Solver++ 2M, 4 steps; images finite in [0, 255].
   Every kernel's launch counter must have risen during the slice. Then it
   times a CFG denoise step and the VAE decode (medians of 3 runs) and the
   text encode.
6. Slice of the instance chain at full width (SAM ViT-H, CLIP ViT-L/14),
   launch counters reset just before it:
   (a) the port's ``corner_masks.main`` on the two PNGs of 5(a), batch 4:
       two 1024² mask PNGs with values in {0, 255};
   (b) one round of ``InstanceProducer`` over two categories: the pipeline
       of 5(b) generates, SAM ViT-H masks from corner prompts, ``ClipEncoder``
       scores image x text; then ``LivePool.make_paste_sample`` →
       ``paste_instances_boxframe`` at B 8, P 4, N 8, S 28, patch 128, 896².
   Every SAM forward must launch flash_attention_relpos 4 times and
   fused_ln_matmul 36 times. Then it times SAM per image at B = 4, CLIP per
   image at B = 16 and the compositor per pasted instance (medians of 3).
6b. Slice of SDXL's int8 + fused-norm serving path at full width, launch
   counters reset just before it: (a) ``txt2img.main --int8`` (a ``quant``
   UNet) writing two 1024² PNGs: exactly 382 int8_matmul_fused_quant and 130
   int8_matmul_pallas launches per UNet call, no norm kernel, no
   fused_ln_matmul; (b) ``SDXLPipeline(int8=True)`` over
   ``UNetSDXL(quant, fused_ln, fused_gn)`` with the weights, VAE,
   conditioning and initial noise of 5(b): images finite in [0, 255], their
   mean |diff| from 5(b)'s printed, and exactly 382 / 130 / 210
   fused_layer_norm / 46 fused_group_norm / 70 flash_attention_packed
   launches per UNet call, fused_ln_matmul 0, flash_attention once per
   decoded image. Then a CFG step of the bf16 and of this pipeline in turns
   (medians of 3) and ``quantize_unet_`` alone.
6c. Slice of SDXL with fused ResBlocks at full width, launch counters reset
   just before it: ``SDXLPipeline`` over ``UNetSDXL(conv_matmul="fused")``
   with the weights, VAE, conditioning and initial noise of 5(b): images
   finite in [0, 255], their mean |diff| from 5(b)'s printed, exactly 34
   fused_gn_silu_conv3x3 / 0 fused_group_norm / 70 flash_attention_packed /
   70 fused_ln_matmul launches per UNet call, flash_attention once per
   decoded image. Then one UNet call, batch 4, of ``UNetSDXL(quant,
   fused_ln, fused_gn, conv_matmul="fused")`` after ``quantize_unet_``:
   exactly 382 / 130 / 210 / 12 / 34 launches of kernels 11 / 10 / 9 / 7 / 8.
   Then a CFG step of the bf16 and of the fused-ResBlock pipeline in turns
   (medians of 3).
6d. Slice of the IF cascade and the x4 upscaler at full width, bf16, seeded
   random weights, launch counters reset just before it
   (``slice_if_cascade``): (a) ``IFStageIPipeline(IFUNet.if_i_xl())``, B = 2,
   4 steps at 64², then ``IFStageIIPipeline(IFUNet.if_ii_l())`` on its output,
   4 steps to 256² (images finite in [-1, 1], no kernel launch: the IF
   attentions are plain in both packages); (b) ``UpscalePipeline(
   upscaler_unet())`` with its three-level VAE on the 256² images, 2 steps
   and the x4 decode to 1024² (exactly 16 + 16 launches of kernels 1 and 2 a
   UNet call, one of kernel 3: the batch decodes at once); (c)
   ``txt2img.main`` with ``--stages I II``, ``--stages XL x4`` at 256² and
   ``--encoder_reuse`` at 512², each file read back at its size, exact
   launches; (d) ``SDXLPipeline(encoder_reuse=True)`` with 5(b)'s weights,
   conditioning and noise: exactly 70 and 46 launches of kernels 1 and 2 on
   full and reuse UNet calls in turn, the images' mean |diff| from 5(b)'s
   printed; (e) ``txt2img --tiny``'s stage-I UNet in float32, three steps on
   the card against the CPU with the same per-step noise (within 1e-4 of the
   [-1, 1] range). Then the timings: a CFG step of stage I and of stage II,
   an upscaler UNet call and the x4 decode (medians of 3), and SDXL's CFG step
   with and without encoder reuse in turns (medians of 3).
7. Slice of the detector's train step, launch counters reset just before it:
   ``graft_entry.flagship_train_entry()``: Swin-L, 1453 classes, 896²,
   B = 2, bf16 compute over float32 parameters, AdamW with clipping, EMA, the
   federated loss, the compositor. Five steps of ``make_paste_train_step``
   and one of ``make_train_step`` with rematerialized Swin blocks (48 forward
   and 24 backward launches of fused_window_attention_packed per step), then
   five steps without (24 and 24): finite losses, the step counter, changed
   parameters and EMA, ms per step and peak memory for both.
8. Slice of the detector's inference forward, launch counters reset just before it:
   (a) ``graft_entry.entry()`` (Swin-T detector, 128², float32 as the JAX
       ``entry()``): 12 fused_window_attention_packed launches (the float32
       body), its pyramid features within relative L2 1e-4 of the same
       seeded model on the CPU, and the same detections and classes, scores
       within 1e-3 and boxes within 1e-2 px;
   (b) ``graft_entry.flagship_entry()``: Swin-L + FPN + CenterNet2 + Detic
       cascade (1453 classes) + mask head, seeded weights, B = 2, 896², bf16;
       padded outputs of the expected shapes, finite under ``valid``, at least
       one detection, exactly 24 fused_window_attention_packed launches per
       forward, ``paste_masks`` on the result. Then it times the forward and
       its three parts (medians of 3) and counts the host syncs of NMS.
   fused_window_attention is on no slice's path (the packed kernels take any
   head count): phase 3 holds its forward and backward, and its counts stay 0.
9. Slice of the detector's serving and evaluation path, launch counters reset
   just before it:
   (a) ``Predictor`` on the small Swin-T detector in float32 at a 128² canvas,
       on the card and on the CPU, the same seeded ``state_dict`` and PNG:
       the same valid slots, boxes and scores within 1e-4 of max |ref|, the
       pasted masks equal but at pixels within 1e-4 of 0.5;
   (b) the flagship ``Predictor`` (Swin-L, 1453 classes, 896², bf16, seeded
       weights) on four PNG images of 640 x 480, 480 x 640, 500 x 333 and
       1024 x 683 (cropped by the canvas): 24 fused_window_attention_packed
       launches per image on the bf16 body, masks (n, h, w), boxes inside
       the image; wall ms per image and NMS host syncs per image;
   (c) ``BatchPredictor`` at batch 8, depth 2 over 16 images, each image
       against (b)'s result to bf16 tolerance (``same_detections``): as many
       detections, at least 98 % of them paired with one of their class
       whose box is within 1e-2 of max |ref|, the pairs' scores within
       1e-2 (the batch of 8 rounds some of the heads' bf16 GEMMs otherwise,
       and on random weights the 300 scores span 0.05, so near-ties at the
       proposals' top-k, NMS and the top-300 cut trade places); images per
       second;
   (e) ``do_test`` on a synthetic LVIS-format set (16 PNG images, 1453
       categories with r / c / f frequencies, polygon and RLE masks,
       ``not_exhaustive_category_ids`` and ``neg_category_ids``), registered
       with ``register_lvis_instances``, the weights through
       ``Checkpointer.save`` and ``do_test(resume=True)``: bbox and segm AP,
       APr, APc, APf finite; seconds per image (data, compute, total); the
       ground truth fed to ``LVISEvaluator`` as predictions scores AP 1;
   (f) ``VisualizationDemo`` writes a PNG that reads back at the image's
       size.
   The counts are read here; then (d) ``AsyncPredictor`` with two worker
   threads on the card: results in request order, equal to (b)'s by
   (c)'s comparison (its launches, counted by threads, are read by no slice).
10. Slice of the training loop, launch counters reset just before it: one
   float32 BSGAL step (``active/bsgal.py:make_active_train_step``) of the
   small Swin-T detector at 64² on the card against the same step on the
   CPU, the same weights, batch, probe and draws (``small_active_step``: the
   same decision, ``grad_sim`` within 1e-4, every metric within 2e-4
   relative; its window attention on the float32 bodies, forward and
   backward, the float32 main path since ``dryrun_train`` builds ResNet-18:
   every launch on the float32 bodies, 36 forward and 36 backward, at the
   shapes the float32 backward phase checks), then
   (``slice_do_train``) the port's ``train_net.main`` on synthetic
   LVIS-format sets (24 PNG train images of 640 x 480, 480 x 640, 500 x 333
   and 1024 x 683, 8 val images, a category-info json, an RGBA pool of 64
   instances over 32 categories), IMS_PER_BATCH 2, CHECKPOINT_PERIOD 3:
   (a) ``configs/BSGAL_SwinL.yaml`` at full width for 6 steps (grad bank
       every 3, decision log every step, ``do_test`` at step 6), then
       ``--resume`` for 2: exactly 72 forward and 72 backward launches of
       fused_window_attention_packed a step outside ``do_test``, paste +
       discard counts equal to the steps, one decision-log iteration per
       step, ``grad_bank/`` holding steps 3 and 6, the resumed run starting
       at 6 from the saved bank and counts, finite ``metrics.json``, an AP
       dict from the in-training ``do_test``, the step-6 checkpoint's EMA
       weights in ``Predictor`` giving detections;
   (b) ``configs/DiverGen_swinL.yaml`` (remat) for 4 steps: exactly 48 and
       24 launches a step, a checkpoint at step 3, finite metrics.
   It prints seconds per step (CUDA events between iteration ends, median
   after the first), ``data_time`` per step, the decisions and ``grad_sim``
   per step and peak memory, with the card's name and power limit.
11. Slice of the detector's other architectures, launch counters reset just
   before it (``slice_architectures``):
   (a) ``configs/BSGAL_R50.yaml`` (ResNet-50 + FPN, 1203 classes, 640², bf16
       over float32 parameters) through ``train_net.main`` as 10(a), with
       ``ACTIVE.PROBE_BATCH 2``: the same checks (``bsgal_run``), no launch
       of any kernel wrapper;
   (b) each other architecture of ``build_model`` at full width, B = 2, bf16
       over float32 parameters, from ``get_cfg()`` with its name set
       (``ARCHITECTURES``; ``CenterNetDetector`` also with ``NOT_NORM_REG
       false`` at B = 1, the one batch size its JAX loss takes): two train steps (``make_train_step``, AdamW, EMA;
       the second timed), finite losses, then two inference forwards (the
       second timed), detections of the expected shapes, finite under
       ``valid``; Swin-L + BiFPN exactly 24 forward + 24 backward launches
       of fused_window_attention_packed a step and 24 a forward, every other
       architecture none;
   (c) ``dryrun_train()`` (ResNet-18 + FPN, float32, as the JAX dryrun):
       no kernel launch, every loss within 2e-6 relative and ``grad_norm``
       within 2e-4 of the CPU step (``dryrun_resnet18``).
   It prints seconds per step, ``data_time``, ms per step and per forward,
   and peak memory, with the card's name and power limit.
12. Slice of the real-image data layer, launch counters reset just before
   it (``slice_real_images``):
   (a) the committed JPEG fixtures (``tests/data/jpeg``, one per mode and six
       640 x 480 4:2:0 images) decode (``utils/image_io.py``, the native
       ``jpeg.cpp``) to the SHA-256 their manifest records of OpenCV's
       pixels, and the progressive one is refused; prints the decoder's ms
       per 640 x 480 4:2:0 image and the host CPU's name;
   (b) ``configs/DiverGen_swinL.yaml`` through ``train_net.main`` at full
       width for 4 steps over a root whose train images are the six JPEG
       fixtures (their polygons as annotations), with ``INPUT.USE_COLOR_JITTER``,
       ``USE_INSTABOOST`` and ``USE_INP_ROTATE`` on: finite metrics, exactly
       10(b)'s launches a step, and each augmentation changed samples in
       the loader; prints seconds per step against 10(b)'s PNG-root run and
       the train loader's images per second with the augmentations on and
       off;
   (c) filtration on real crops: ``lvis_crop`` on that JPEG root (padded,
       blurred background as the real set; tight, white as the other), then
       ``extract_features`` (CLIP ViT-L/14, random weights) on the card and
       ``compute_similarity``: one crop per annotation, finite similarities
       in [-1, 1].
13. Slice of weak supervision and the rest of the detector's modules, launch
   counters reset just before it (``slice_weak_supervision``):
   (a) the flagship (``flagship_cfg``: Swin-L, 1453 classes, 896², B = 2,
       bf16 over float32 parameters, remat) on an image-labelled batch, one
       step each (``CustomRCNN.forward(ann_type=…)``, backward, AdamW, EMA)
       of ``max_size``, ``max_score``, ``min_loss``, ``image`` and ``wsddn``
       with ``WITH_SOFTMAX_PROP`` on the linear classifier, then on the
       zero-shot classifier with ``WITH_CAPTION`` a ``captiontag`` step on a
       random (2, 512) ``cap_emb`` and a step with the dynamic classifier
       over the image labels: every loss finite, the CenterNet, box and mask
       losses exactly 0, the backbone's gradients non-zero, exactly 48
       forward and 24 backward launches of fused_window_attention_packed a
       step; ms per step;
   (b) the float32 weak step of ResNet-18 + FPN at 64², ``max_size`` and
       ``wsddn``, on the card against the CPU: losses within 2e-6 relative,
       the gradient norm within 2e-4 (``DRYRUN_BOUNDS``);
   (c) ``Res5ROIHeads.image_label_losses`` on ``configs/BSGAL_R50.yaml``'s
       model with the Res5 heads, ``wsddn`` on its proposal-score branch,
       one step, no kernel launch;
   (d) ``extract_features --method dinov2 --dino_model vitg14`` on 64 crops
       of the JPEG fixtures, then ``DinoEncoder("vitg14")`` in bf16 at 224²,
       B = 64: finite unit-norm embeddings, images/s, peak memory; vits14 on
       the card against the CPU within 1e-4 of max |ref|;
   (e) ``inference_on_dataset_exp`` and ``LVISToCityscapesInstanceEvaluator``
       with the flagship on the serving slice's synthetic LVIS set: the
       ``det_<id>.npz`` files, finite AP, the native scorer's AP 1 against a
       16-bit ground truth the port writes from the predictions, exactly 24
       launches a forward; s per image;
   (f) ``pairwise_iou_rotated`` and ``nms_rotated`` on 2000 boxes on the card
       against the CPU (IoU within 1e-5, equal keep masks), ms of each.
   It prints the smoke's wall clock before and after the slice.
14. Slice of deployment and DLA's deformable aggregation, launch counters
   reset just before it (``slice_deployment``):
   (a) the flagship (``flagship_entry``: Swin-L, 1453 classes, 896², B = 2,
       bf16) exported by ``export.export_inference`` weights-separate and
       baked (24 ``divergen::window_attention_packed`` ops in each program,
       no launch while tracing, the plain twin absent), each artifact saved
       and then both loaded and served on the card by one fresh ``python -c``
       interpreter that imports only ``divergen_tpu_torch.export`` and
       ``.ops`` (``SERVE_EXPORTED``; no model code in its ``sys.modules``):
       exactly 24 kernel-5 launches every forward, the eager forward's
       detections (``same_detections``), a 448² canvas refused; the export's
       seconds, the artifact's bytes and ms a forward against eager's (CUDA
       events, median of 10 after 2). That interpreter's launches are added
       to the slice's counts;
   (b) a synthetic detectron2 checkpoint at the flagship's shapes
       (``synthetic_flagship_checkpoint``) through
       ``tools.import_reference_checkpoint`` (every entry but the stride-4
       norm filled), ``tools.convert_imgnet_model_to_lvis`` (1453 -> 1203:
       the cut leaves' shapes and values, everything else unchanged) and
       ``tools.export_model --ema --run-sample`` on the card at 1203
       classes: finite outputs, 24 launches;
   (c) DLA-34 -> ``DLAUp(node_type="dcn")`` at 640², B = 2, float32, a
       forward and backward on the card against the CPU within
       ``DRYRUN_BOUNDS`` (loss, gradient norm), no kernel launch, ms and
       peak memory; ``deform_conv2d`` at dla2's shape against the CPU within
       1e-5 of max |ref|, ms and peak memory.
15. Slice of ranks (``torch.distributed``), launch counters reset just
   before it (``slice_ranks``); each rank is this script in its
   ``--rank-child SPEC`` mode, started by ``torch.distributed.run``, and
   reports its own launches, which are added to the slice's counts:
   (a) ``train_net --multi-host`` under ``torchrun
       --nproc_per_node=1`` (NCCL, a live group of one rank) on
       ``configs/BSGAL_SwinL.yaml`` at full width (B = 2, 896², bf16 over
       float32 parameters) for ``RANK_STEPS`` steps, against the same run as
       one plain process without a group: the parameters after every step (a float64 checksum) and at the end (SHA-256 of their bytes) and
       the decisions equal bit for bit; s/step of both, peak memory, the
       bytes ``torch.distributed.all_reduce`` moved a step (counted by a
       wrapper in the child) beside the parameter count x 4 B;
   (b) two gloo ranks sharing the card (NCCL refuses two ranks on one
       device): (1) the float32 flagship step (``float32_flagship_step``),
       one image a rank, against this process's step on both images from
       the same weights and draws, within ``RANK_BOUNDS`` (every metric 2e-4
       relative; every update within twice the learning rate, sized ones
       within 1e-2 of it), both ranks' parameters equal; (2) BSGAL through
       ``train_net --multi-host --dist-backend gloo --device cuda:0`` for
       ``RANK_STEPS`` steps: the ranks' parameters equal after every step,
       one decision a step on both (their logs), one checkpoint and one
       ``metrics.json`` row; (3) ``inference_on_dataset`` over the two ranks
       on ``RANK_EVAL_IMAGES`` synthetic images in one batch, against this
       process's loop in batches of half as many (the same forwards): the
       detections of every image and the results equal bit for bit. Prints
       each rank's peak memory and step time.
16. Prints the kernels' JSON line (the 13 wrappers' entries; the float32
   window backward body with its launches in 10; and each padded head-dim
   case of 3 with its checked call's launch), the card line, and as the
   last line {"ok": true, "device": {...}}. Any failed phase raises: exit
   code != 0. ``python3 chip_smoke.py`` needs one card.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

STEPS = 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
PEAK_INT8_OPS = 1979e12  # the same, int8 tensor cores
PEAK_F32_FLOPS = 67e12  # the same, float32 outside the tensor cores
# float32-accurate products on the TF32 tensor cores in three passes (3xTF32,
# divergen_tpu_torch/ops/tf32x3.py): 494.7 TFLOP/s dense TF32 over three
PEAK_F32_TC_FLOPS = 494.7e12 / 3
PEAK_BYTES_PER_S = 3.35e12
REL_L2_BOUND = 1e-2
MAX_ABS_BOUND = 3e-2  # times max |reference|
# a float32 kernel against its float32 twin: sums in another order only (a
# bf16 operand anywhere gives 2-4e-3)
F32_BOUNDS = dict(rel_l2_bound=1e-5, max_abs_bound=1e-4)
WINDOW_REPS = 10  # 20 timed calls of a window-attention kernel after the warm-up


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_pair(kernel_fn, plain_fn, reps: int = 5):
    """Median ms of each, timed in turns (plain, kernel, kernel, plain), and
    the (min, max) of the kernel's timed calls."""
    def once(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    kernel_fn(), plain_fn()  # warm-up
    k_ms, p_ms = [], []
    for _ in range(reps):
        p_ms.append(once(plain_fn))
        k_ms.append(once(kernel_fn))
        k_ms.append(once(kernel_fn))
        p_ms.append(once(plain_fn))
    return statistics.median(k_ms), statistics.median(p_ms), (min(k_ms), max(k_ms))


def time_one(fn, reps: int = 10) -> float:
    """Median ms of ``fn`` (CUDA events), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(ms, "operations" | "bytes"): the least time the card could take for
    ``ops`` operations at ``peak`` per second (default: bf16 on the tensor
    cores) moving ``nbytes`` bytes."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, rel_l2_bound=REL_L2_BOUND,
            max_abs_bound=MAX_ABS_BOUND):
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    ok = rel <= rel_l2_bound and err <= max_abs_bound * scale
    log(f"  {name}: max_abs_err {err:.6g} (max|ref| {scale:.6g}), rel_l2 {rel:.6g} "
        f"[{'ok' if ok else 'FAIL'}]")
    if not ok:
        raise AssertionError(f"{name}: error above bound (rel_l2 <= {rel_l2_bound}, "
                             f"max_abs <= {max_abs_bound} * max|ref|)")
    return err


def same_bits(name: str, got: torch.Tensor, fn) -> None:
    """``fn()``, the kernel's call again, must give ``got``'s bits."""
    if not torch.equal(got, fn()):
        raise AssertionError(f"{name}: two runs of the kernel give different bits")
    log("    two runs give the same bits: True")


# flash_attention_packed's launches per SDXL UNet call (batch 4: CFG over two
# images) at each self-attention shape (B, N, C, heads): levels 1 and 2
UNET_ATTN_LAUNCHES = {(4, 4096, 640, 10): 10, (4, 1024, 1280, 20): 60}


def kernel_phases(gen: torch.Generator, card: str):
    import divergen_tpu_torch.ops.flash_attention as fa_mod
    import divergen_tpu_torch.ops.ln_matmul as ln_mod
    from divergen_tpu_torch.ops import _build

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = {}

    def record(kernel, err, ms, plain_ms, span, library_fn, ops, nbytes):
        """The first case of a kernel is its main-path shape: its times, the
        PyTorch call's time and the bound are the kernel's numbers."""
        log(f"    kernel {ms:.4f} ms (min {span[0]:.4f}, max {span[1]:.4f} of its timed calls), "
            f"plain f32 {plain_ms:.4f} ms")
        if kernel not in results:
            b_ms, by = bound(ops, nbytes)
            lib_ms = time_one(library_fn)
            log(f"    PyTorch call (bf16) {lib_ms:.4f} ms; bound {b_ms:.4f} ms by {by} "
                f"({ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
            results[kernel] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                               "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    def guarded(name, got, fn, rows):
        """The kernel into the first ``rows`` rows of a buffer whose row
        ``rows`` is NaN (per batch): the same bits, and that row untouched."""
        buf = torch.full((got.shape[0], rows + 1, got.shape[2]), float("nan"), device=dev,
                         dtype=got.dtype)
        fn(buf[:, :rows])
        if not (torch.equal(buf[:, :rows], got) and bool(buf[:, rows].isnan().all())):
            raise AssertionError(f"{name}: the kernel wrote outside its output")
        log("    writes nothing past its output: True")

    log("kernel phase: flash_attention_packed")
    if sum(UNET_ATTN_LAUNCHES.values()) != FUSED_RESBLOCK_LAUNCHES["flash_attention_packed"]:
        raise AssertionError("UNET_ATTN_LAUNCHES does not add up to a UNet call's launches")
    lib_rows = _build.lib().dg_flash_attention_sm90_rows()
    if lib_rows != fa_mod.SM90_TILE:
        raise AssertionError(f"the d = 64 kernel takes {lib_rows} q rows a work item, "
                             f"ops/flash_attention.py plans {fa_mod.SM90_TILE}")
    # the main shape; SDXL's two self-attention shapes at B = 4 (one CFG UNet
    # call of two images: 10 and 60 launches), each with its device time, SDPA's
    # and their sums a UNet call; (2, 1024); ragged N; the last in float32 (a
    # float32 UNet's self-attention: the float32 body, at the float32 bound)
    unet_sum = {"kernel": 0.0, "SDPA": 0.0, "bound": 0.0}
    for b, n, c, h, dtype in ((2, 4096, 640, 10, torch.bfloat16),
                              (4, 4096, 640, 10, torch.bfloat16),
                              (4, 1024, 1280, 20, torch.bfloat16),
                              (2, 1024, 1280, 20, torch.bfloat16),
                              (1, 1000, 640, 10, torch.bfloat16),
                              (1, 1000, 640, 10, torch.float32)):
        qkv = randn(b, n, 3 * c, dtype=dtype)
        run = lambda: fa_mod.flash_attention_packed(qkv, h, softmax_mode="rawmax")
        got = run()
        if got.dtype != dtype:
            raise AssertionError(f"packed attention wrote {got.dtype} for {dtype} qkv")
        ref = fa_mod.reference_attention_packed(qkv.float(), h)
        name = f"packed B={b} N={n} C={c} H={h} {str(dtype)[6:]}"
        err = compare(name, got, ref, **(F32_BOUNDS if dtype == torch.float32 else {}))
        del ref
        same_bits(name, got, run)
        guarded(name, got, lambda out: fa_mod._packed_into(qkv, h, out), n)
        ms, pms, span = time_pair(run, lambda: fa_mod.reference_attention_packed(qkv.float(), h))
        q4, k4, v4 = (t.reshape(b, n, h, c // h).transpose(1, 2).contiguous()
                      for t in qkv.chunk(3, dim=-1))
        sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4)
        ops, nbytes = 4.0 * b * h * n * n * (c // h), 2.0 * b * n * 4 * c
        record("flash_attention_packed", err, ms, pms, span, sdpa, ops, nbytes)
        launches = UNET_ATTN_LAUNCHES.get((b, n, c, h)) if dtype == torch.bfloat16 else None
        if launches:
            dev_ms, sdpa_ms = device_ms(run), device_ms(sdpa)
            b_ms, by = bound(ops, nbytes)
            for key, t in (("kernel", dev_ms), ("SDPA", sdpa_ms), ("bound", b_ms)):
                unet_sum[key] += t * launches
            log(f"    UNet shape: device {dev_ms:.4f} ms ({ops / dev_ms / 1e9:.0f} TFLOP/s), SDPA "
                f"{sdpa_ms:.4f} ms, bound {b_ms:.4f} ms by {by}, {launches} launches per UNet "
                f"call")
        del qkv, q4, k4, v4, got
        torch.cuda.empty_cache()
    log("  flash_attention_packed: device time x launches per UNet call, summed over its "
        f"{sum(UNET_ATTN_LAUNCHES.values())} launches: kernel {unet_sum['kernel']:.3f} ms, SDPA "
        f"{unet_sum['SDPA']:.3f} ms, bound {unet_sum['bound']:.3f} ms")

    log("kernel phase: fused_ln_matmul")
    # The UNet's two GEGLU shapes of a call at 1024² (UNet batch 4; eps 1e-5;
    # 60 and 10 launches), SAM ViT-H's qkv (bias) and mlp_fc1 (GELU, bias) at
    # B = 4 (eps 1e-6), ragged M and N, K past the 2048 the apply pass holds
    # in registers, and float32 x and w against the twin
    # at the float32 bound. Each: the same bits twice, nothing written past
    # its output (a NaN guard row), and for bf16 the device time beside the
    # PyTorch call's and the bound, summed over a UNet call's 70 launches.
    ln_unet = {"kernel": 0.0, "PyTorch call": 0.0, "bound": 0.0}
    cases = ((4096, 1280, 10240, True, "none", False, 1e-5, torch.bfloat16, 60),
             (16384, 640, 5120, True, "none", False, 1e-5, torch.bfloat16, 10),
             (16384, 1280, 3840, False, "none", True, 1e-6, torch.bfloat16, 0),
             (16384, 1280, 5120, False, "gelu", True, 1e-6, torch.bfloat16, 0),
             (1000, 640, 3840, False, "none", True, 1e-5, torch.bfloat16, 0),
             (1000, 640, 3840, True, "none", True, 1e-5, torch.bfloat16, 0),
             (200, 2560, 336, True, "none", True, 1e-5, torch.bfloat16, 0),
             (1000, 640, 3840, False, "none", True, 1e-5, torch.float32, 0),
             (1000, 640, 3840, True, "none", True, 1e-5, torch.float32, 0),
             (1000, 1280, 5120, False, "gelu", True, 1e-6, torch.float32, 0),
             (200, 2560, 336, True, "none", True, 1e-5, torch.float32, 0))
    for m, k, n, geglu, act, with_bias, eps, dtype, launches in cases:
        x = randn(m, k, scale=2.0, dtype=dtype)
        w = randn(n, k, scale=k ** -0.5, dtype=dtype).t()  # (K, N) view of an nn.Linear weight
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        beta = 0.1 * torch.randn(k, generator=gen, device=dev)
        bias = 0.1 * torch.randn(n, generator=gen, device=dev) if with_bias else None
        run = lambda: ln_mod.fused_ln_matmul(x, w, gamma, beta, eps, bias, geglu, act)
        plain = lambda: ln_mod.ln_matmul_reference(x.float(), w.float(), gamma, beta, eps,
                                                   bias, geglu, act)
        got = run()
        if got.dtype != dtype:
            raise AssertionError(f"fused_ln_matmul wrote {got.dtype} for {dtype} x")
        epi = "geglu" if geglu else act
        name = f"ln_matmul {epi} M={m} K={k} N={n} bias={with_bias} eps={eps} {str(dtype)[6:]}"
        bounds = F32_BOUNDS if dtype == torch.float32 else {}
        err = compare(name, got, plain(), **bounds)
        same_bits(name, got, run)
        cols = n // 2 if geglu else n
        buf = torch.full((m + 1, cols), float("nan"), device=dev, dtype=dtype)
        ln_mod._into(x, w.t(), gamma, beta, eps, bias, ln_mod._GEGLU if geglu
                     else ln_mod._EPILOGUES[act], buf[:m])
        if not (torch.equal(buf[:m], got) and bool(buf[m].isnan().all())):
            raise AssertionError(f"{name}: the kernel wrote outside its output")
        log("    writes nothing past its output: True")
        ms, pms, span = time_pair(run, plain)
        # the PyTorch call in x's dtype (float32 with TF32 off: the float32 bound)
        gl, bl, wt = gamma.to(dtype), beta.to(dtype), w.t()
        bias_l = None if bias is None else bias.to(dtype)

        def library():
            y = F.linear(F.layer_norm(x, (k,), gl, bl, eps), wt, bias_l)
            if geglu:
                hidden, gate = y.chunk(2, dim=-1)
                return hidden * F.gelu(gate)
            return F.gelu(y) if act == "gelu" else y

        ops = 2.0 * m * k * n
        nbytes = (x.element_size() * (m * k + k * n + m * cols) + 8.0 * k
                  + (4.0 * n if with_bias else 0.0))
        if dtype == torch.float32:
            b_ms, by = bound(ops, nbytes, PEAK_F32_TC_FLOPS)
            fma_ms, _ = bound(ops, nbytes, PEAK_F32_FLOPS)
            log(f"    float32: kernel {ms:.4f} ms (min {span[0]:.4f}, max {span[1]:.4f}), plain "
                f"{pms:.4f} ms, PyTorch call (float32) {time_one(library):.4f} ms, bound "
                f"{b_ms:.4f} ms by {by} at 3xTF32, {fma_ms:.4f} at FMA [{card}]")
            results["fused_ln_matmul"]["max_abs_err"] = max(
                results["fused_ln_matmul"]["max_abs_err"], err)
            continue
        record("fused_ln_matmul", err, ms, pms, span, library, ops, nbytes)
        if m >= 4096:
            dev_ms, lib_ms = device_ms(run), device_ms(library)
            b_ms, by = bound(ops, nbytes)
            for key, t in (("kernel", dev_ms), ("PyTorch call", lib_ms), ("bound", b_ms)):
                ln_unet[key] += t * launches
            log(f"    device {dev_ms:.4f} ms ({ops / dev_ms / 1e9:.0f} TFLOP/s), PyTorch call "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms by {by}; {launches} launches per UNet "
                f"call [{card}]")
        del x, w, got, buf
        torch.cuda.empty_cache()
    log("  fused_ln_matmul: device time x launches per UNet call, summed over its 70 "
        f"launches: kernel {ln_unet['kernel']:.3f} ms, PyTorch call "
        f"{ln_unet['PyTorch call']:.3f} ms, bound {ln_unet['bound']:.3f} ms")

    log("kernel phase: flash_attention")
    lib_rows = _build.lib().dg_flash_attention_d512_rows()
    if lib_rows != fa_mod.D512_TILE:
        raise AssertionError(f"the d = 512 kernel takes {lib_rows} q rows a work item, "
                             f"ops/flash_attention.py plans {fa_mod.D512_TILE}")
    # the main shape (the VAE's mid attention at 1024²), with its device time
    # beside SDPA's; then ragged with a bias, float32 in and out, and a packed
    # (B, N, 3C) projection at d = 512 (kernel 3's body behind
    # flash_attention_packed); and d = 64 ragged with a bias (kernel 1's body)
    for bh, sq, sk, d, with_bias, dtype, packed in (
            (1, 16384, 16384, 512, False, torch.bfloat16, False),
            (2, 1000, 777, 512, True, torch.bfloat16, False),
            (2, 1000, 777, 512, False, torch.float32, False),
            (1, 4096, 4096, 512, False, torch.bfloat16, True),
            (4, 1000, 777, 64, True, torch.bfloat16, False)):
        name = f"flash BH={bh} Sq={sq} Sk={sk} D={d} bias={with_bias} {str(dtype)[6:]}"
        if packed:
            qkv = randn(1, sq, 3 * bh * d, dtype=dtype)
            run = lambda: fa_mod.flash_attention_packed(qkv, bh)
            plain = lambda: fa_mod.reference_attention_packed(qkv.float(), bh)
            into = lambda out: fa_mod._packed_into(qkv, bh, out)
            name = f"packed B=1 N={sq} C={bh * d} H={bh} {str(dtype)[6:]}"
        else:
            q, k, v = randn(bh, sq, d, dtype=dtype), randn(bh, sk, d, dtype=dtype), randn(
                bh, sk, d, dtype=dtype)
            bias = torch.randn((bh, sq, sk), generator=gen, device=dev) if with_bias else None
            run = lambda: fa_mod.flash_attention(q, k, v, bias)
            plain = lambda: fa_mod.reference_attention(q.float(), k.float(), v.float(), bias)
            into = lambda out: fa_mod._flash_into(q, k, v, bias, out)
        got = run()
        if got.dtype != dtype:
            raise AssertionError(f"{name}: wrote {got.dtype} for {dtype} inputs")
        err = compare(name, got, plain(), **(F32_BOUNDS if dtype == torch.float32 else {}))
        same_bits(name, got, run)
        guarded(name, got, into, sq)
        if packed:  # the body's error; its timing is the main shape's
            results["flash_attention"]["max_abs_err"] = max(
                results["flash_attention"]["max_abs_err"], err)
            del qkv, got
            continue
        ms, pms, span = time_pair(run, plain)
        mask = None if bias is None else bias.bfloat16()[None]
        q16, k16, v16 = (t[None].bfloat16() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(q16, k16, v16, attn_mask=mask)
        ops = 4.0 * bh * sq * sk * d
        record("flash_attention", err, ms, pms, span, sdpa, ops,
               2.0 * bh * d * 2 * (sq + sk) + (4.0 * bh * sq * sk if with_bias else 0.0))
        if sq == 16384:
            dev_ms, sdpa_ms = device_ms(run, reps=3), device_ms(sdpa, reps=3)
            log(f"    main shape: device {dev_ms:.4f} ms ({ops / dev_ms / 1e9:.0f} TFLOP/s), "
                f"SDPA {sdpa_ms:.4f} ms, bound {results['flash_attention']['bound_ms']:.4f} ms")
        del q, k, v, q16, k16, v16, got
        torch.cuda.empty_cache()

    log("kernel phase: flash_attention_relpos")
    lib_rows = _build.lib().dg_flash_attention_relpos_rows()
    lib_smem = _build.lib().dg_flash_attention_relpos_smem()
    if (lib_rows, lib_smem) != (fa_mod.RELPOS_TILE, fa_mod.relpos_smem()):
        raise AssertionError(f"the d = 80 kernel takes {lib_rows} q rows a work item and "
                             f"{lib_smem} bytes of shared memory, ops/flash_attention.py plans "
                             f"{fa_mod.RELPOS_TILE} and {fa_mod.relpos_smem()}")
    # First as ViTAttention calls it in SAM ViT-H's global layers, at B = 4 and
    # B = 1: q, k and v are heads-first views of the fused (B, N, 3, heads, d)
    # projection (row stride 3·heads·d), the result is a view of a (B, N, C)
    # buffer. Then the (BH, N, D) layout at the same sizes, a ragged and a
    # non-square grid (W = 7 and 16: K tiles of whole grid rows of 8 and 16
    # slots, empty slots past W), W = 32, W = 8 with an odd H (a K tile half
    # past the grid), and W = 80 (the general path: W > 64). Factors of scale
    # 0.7 so that the bias matters. Each: the same bits twice, and nothing
    # written past its output (a NaN guard row: the ragged tails and the
    # 16-channel part of the output are written from registers). At the main
    # shape the device time beside SDPA's (the dense bias as a bf16 mask, built
    # outside the timing) and the bound.
    for fused, b, heads, (h, w), d in ((True, 4, 16, (64, 64), 80), (True, 1, 16, (64, 64), 80),
                                       (False, 1, 16, (64, 64), 80), (False, 1, 64, (64, 64), 80),
                                       (True, 2, 3, (5, 7), 80), (False, 1, 2, (5, 7), 80),
                                       (False, 1, 2, (8, 16), 80), (False, 1, 2, (16, 32), 80),
                                       (True, 1, 3, (9, 8), 80), (True, 2, 2, (3, 80), 80)):
        n, bh = h * w, b * heads
        if fused:
            qkv = randn(b, n, 3, heads, d)
            q, k, v = (qkv[:, :, s].permute(0, 2, 1, 3) for s in range(3))  # (B, heads, N, d)
        else:
            q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        bh_t = randn(bh, h, n, scale=0.7, dtype=torch.float32)
        bw_t = randn(bh, w, n, scale=0.7, dtype=torch.float32)

        def plain():
            flat = (t.reshape(bh, n, d).float() for t in (q, k, v))
            return fa_mod.reference_attention_relpos(*flat, bh_t, bw_t, (h, w))

        got = fa_mod.flash_attention_relpos(q, k, v, bh_t, bw_t, (h, w))
        ref = plain()
        if fused:  # as the module reads it: (B, N, C), and that without a copy
            merged = got.permute(0, 2, 1, 3).reshape(b, n, heads * d)
            if merged.data_ptr() != got.data_ptr() or not merged.is_contiguous():
                raise AssertionError("relpos: the result is not a view of a (B, N, C) buffer")
            got = merged
            ref = ref.reshape(b, heads, n, d).permute(0, 2, 1, 3).reshape(b, n, heads * d)
        layout = "views of fused qkv" if fused else "(BH, N, D)"
        name = f"relpos B={b} heads={heads} grid={h}x{w} D={d} {layout}"
        err = compare(name, got, ref)
        del ref
        run = lambda: fa_mod.flash_attention_relpos(q, k, v, bh_t, bw_t, (h, w))
        if fused:
            same_bits(name, got, lambda: run().permute(0, 2, 1, 3).reshape(b, n, heads * d))
            into = lambda out: fa_mod._relpos_into(q, k, v, bh_t, bw_t, (h, w),
                                                   out.unflatten(2, (heads, d)).permute(0, 2, 1, 3))
        else:
            same_bits(name, got, run)
            into = lambda out: fa_mod._relpos_into(q, k, v, bh_t, bw_t, (h, w), out)
        guarded(name, got, into, n)
        ms, pms, span = time_pair(run, plain, reps=3)
        mask = None
        main_shape = "flash_attention_relpos" not in results
        if main_shape:  # the dense bias, built outside the timing
            mask = fa_mod.relpos_dense_bias(bh_t, bw_t).bfloat16().contiguous().reshape(
                b, heads, n, n)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        ops = 4.0 * bh * n * n * d
        record("flash_attention_relpos", err, ms, pms, span, sdpa, ops,
               2.0 * 4 * bh * n * d + 4.0 * bh * (h + w) * n)
        if main_shape:
            dev_ms, sdpa_ms = device_ms(run), device_ms(sdpa)
            log(f"    main shape: device {dev_ms:.4f} ms ({ops / dev_ms / 1e9:.0f} TFLOP/s), "
                f"SDPA {sdpa_ms:.4f} ms, bound "
                f"{results['flash_attention_relpos']['bound_ms']:.4f} ms [{card}]")
        del mask
        torch.cuda.empty_cache()

    log("kernel phase: fused_window_attention_packed")
    import divergen_tpu_torch.ops.window_attention as wa_mod

    def window_case(bn, c, heads, nw, n, with_mask):
        """qkv, bias, shift-like mask (about a third of the pairs at -100, the
        diagonal open) and the work of one call."""
        qkv = randn(bn, n, 3 * c)
        bias = randn(heads, n, n, scale=0.5, dtype=torch.float32)
        mask = None
        if with_mask:
            mask = torch.where(torch.rand((nw, n, n), generator=gen, device=dev) < 0.3, -100.0, 0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
        d = c // heads
        ops = 4.0 * bn * heads * n * n * d
        nbytes = 2.0 * bn * n * 4 * c + 4.0 * heads * n * n + (4.0 * nw * n * n if with_mask else 0.0)
        return qkv, bias, mask, ops, nbytes

    def dense_mask(bias, mask, bn):
        """(bn, heads, n, n) bf16 bias + mask for the PyTorch call."""
        full = bias[None].expand(bn, -1, -1, -1)
        if mask is not None:
            full = full + mask.repeat(bn // mask.shape[0], 1, 1)[:, None]
        return full.bfloat16().contiguous()

    def heads_first(qkv, heads):
        bn, n, c3 = qkv.shape
        return qkv.reshape(bn, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4)  # views

    # The forward body's plan: its shared memory per block equals
    # forward_smem(n) for every n, and the card holds as many blocks of each
    # instance at once as forward_resident(n) assumes (the occupancy
    # calculator, registers included).
    lib = _build.lib()
    wrong = [n for n in range(1, 145)
             if lib.dg_window_attention_fwd_smem(n) != wa_mod.forward_smem(n)]
    if wrong:
        raise AssertionError(f"the forward body's shared memory differs from forward_smem at n = "
                             f"{wrong}")
    resident = {n: (lib.dg_window_attention_fwd_resident(n), wa_mod.forward_resident(n))
                for n in (16, 32, 64, 112, 144)}
    log(f"    the bf16 forward body's shared memory per block equals forward_smem(n), n = 1..144 "
        f"({wa_mod.forward_smem(144)} bytes at n = 144); blocks a multiprocessor holds "
        f"(card, plan) by n: {resident}")
    if any(card_blocks != plan_blocks for card_blocks, plan_blocks in resident.values()):
        raise AssertionError("the card holds another number of forward blocks than "
                             "forward_resident assumes")

    def guarded_forward(qkv, bias, mask, heads, got, what):
        """The packed C entry point into a buffer whose row after the output is
        NaN: the wrapper's bits, and that row untouched."""
        bn, n, c3 = qkv.shape
        plan = wa_mod.forward_plan(bn, heads, n, dev)
        buf = torch.full((bn * n + 1, c3 // 3), float("nan"), device=dev, dtype=torch.bfloat16)
        _build.check(lib.dg_window_attention_packed_bf16(
            qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
            buf.data_ptr(), bn, n, heads, 1 if mask is None else mask.shape[0], *plan,
            (c3 // 3 // heads) ** -0.5, torch.cuda.current_stream().cuda_stream),
            "packed window attention kernel launch")
        if not (torch.equal(buf[:-1].view(got.shape), got) and bool(buf[-1].isnan().all())):
            raise AssertionError(f"window attention forward wrote outside its output ({what})")
        log(f"    writes nothing past its output (chunks {plan.chunks} x {plan.per_chunk} "
            f"windows): True")

    # the four Swin-L stages of B = 2 at 896² (window 12), then shrunk windows;
    # at the stages, the device time of the kernel beside SDPA's (its dense
    # bias + mask built outside the timing) and the bound, summed over a
    # Swin-L forward's 24 launches (2, 2, 18 and 2 at the four stages, the
    # shift mask on every second block)
    fwd_step = {"kernel": 0.0, "SDPA": 0.0, "bound": 0.0}
    for bn, c, heads, nw, n in ((722, 192, 6, 361, 144), (200, 384, 12, 100, 144),
                                (50, 768, 24, 25, 144), (18, 1536, 48, 9, 144),
                                (8, 96, 3, 4, 49), (8, 96, 3, 4, 16), (8, 96, 3, 2, 4)):
        for with_mask in (True, False):
            qkv, bias, mask, ops, nbytes = window_case(bn, c, heads, nw, n, with_mask)
            what = f"bn={bn} C={c} H={heads} n={n} mask={'nW ' + str(nw) if with_mask else 'none'}"
            run = lambda: wa_mod.fused_window_attention_packed(qkv, bias, mask, heads)
            got = run()
            ref = wa_mod.reference_window_attention_packed(qkv.float(), bias, mask, heads)
            err = compare(f"window packed {what}", got, ref)
            del ref
            same_bits(f"window packed {what}", got, run)
            guarded_forward(qkv, bias, mask, heads, got, what)
            ms, pms, span = time_pair(
                run, lambda: wa_mod.reference_window_attention_packed(qkv.float(), bias, mask, heads),
                reps=WINDOW_REPS)
            attn_mask = q4 = None
            if n == 144:  # built outside the timing
                attn_mask = dense_mask(bias, mask, bn)
                q4, k4, v4 = (t.contiguous() for t in heads_first(qkv, heads))
            sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask)
            first = "fused_window_attention_packed" not in results
            record("fused_window_attention_packed", err, ms, pms, span, sdpa, ops, nbytes)
            if n == 144:
                dev_ms, sdpa_ms = device_ms(run), device_ms(sdpa)
                b_ms, by = bound(ops, nbytes)
                share = SWIN_L_STAGE_LAUNCHES[bn] / 2  # half the stage's blocks take the mask
                for key, t in (("kernel", dev_ms), ("SDPA", sdpa_ms), ("bound", b_ms)):
                    fwd_step[key] += share * t
                log(f"    device: kernel {dev_ms:.4f} ms, SDPA {sdpa_ms:.4f} ms, bound {b_ms:.4f} "
                    f"ms by {by} ({nbytes / 1e6:.1f} MB); {share:g} launches a Swin-L forward "
                    f"[{card}]")
                if first:
                    results["fused_window_attention_packed"].update(
                        device_ms=dev_ms, library_device_ms=sdpa_ms)
                    # the wrapper's float32 copy of a bf16 bias: glue outside the kernel
                    b16 = bias.bfloat16()
                    log(f"    the wrapper's float32 copy of a bf16 bias ({heads}, {n}, {n}): "
                        f"device {device_ms(lambda: wa_mod._f32_on(b16, dev)):.4f} ms (not in "
                        "the kernel's time)")
            del attn_mask, q4, sdpa
            torch.cuda.empty_cache()
    log("  window attention forward, a Swin-L forward's 24 launches (device ms): "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in fwd_step.items()) + f" [{card}]")
    results["fused_window_attention_packed"]["step_device_ms"] = fwd_step["kernel"]

    log("kernel phase: fused_window_attention")
    # Swin-L stage 0 (six heads, where the TPU path takes the split kernel):
    # contiguous (B, H, N, D) tensors, then heads-first views of the fused
    # projection that the packed kernel reads, where both must agree exactly
    for layout in ("contiguous (B, H, N, D)", "views of fused qkv"):
        bn, c, heads, nw, n = 722, 192, 6, 361, 144
        qkv, bias, mask, ops, nbytes = window_case(bn, c, heads, nw, n, True)
        q, k, v = heads_first(qkv, heads)
        if layout.startswith("contiguous"):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        got = wa_mod.fused_window_attention(q, k, v, bias, mask)
        ref = wa_mod.reference_window_attention(q.float(), k.float(), v.float(), bias, mask)
        err = compare(f"window split bn={bn} H={heads} n={n} d={c // heads} mask=nW {nw} {layout}",
                      got, ref)
        del ref
        same_bits(f"window split {layout}", got,
                  lambda: wa_mod.fused_window_attention(q, k, v, bias, mask))
        packed = wa_mod.fused_window_attention_packed(qkv, bias, mask, heads)
        if not torch.equal(got.permute(0, 2, 1, 3).reshape(bn, n, c), packed):
            raise AssertionError(f"window attention: split and packed kernels disagree ({layout})")
        log("    equals fused_window_attention_packed on the same projection")
        ms, pms, span = time_pair(
            lambda: wa_mod.fused_window_attention(q, k, v, bias, mask),
            lambda: wa_mod.reference_window_attention(q.float(), k.float(), v.float(), bias, mask),
            reps=WINDOW_REPS)
        attn_mask = dense_mask(bias, mask, bn) if "fused_window_attention" not in results else None
        record("fused_window_attention", err, ms, pms, span,
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask), ops, nbytes)
        del attn_mask
        torch.cuda.empty_cache()
    for bn, heads, nw, n in ((6, 3, 3, 49), (4, 1, 2, 4)):  # ragged, odd and tiny windows
        qkv, bias, mask, ops, nbytes = window_case(bn, 32 * heads, heads, nw, n, True)
        q, k, v = heads_first(qkv, heads)
        got = wa_mod.fused_window_attention(q, k, v, bias, mask)
        ref = wa_mod.reference_window_attention(q.float(), k.float(), v.float(), bias, mask)
        err = compare(f"window split bn={bn} H={heads} n={n} views of fused qkv", got, ref)
        packed = wa_mod.fused_window_attention_packed(qkv, bias, mask, heads)
        if not torch.equal(got.permute(0, 2, 1, 3).reshape(bn, n, 32 * heads), packed):
            raise AssertionError(f"window attention: split and packed kernels disagree (n = {n})")
        log("    equals fused_window_attention_packed on the same projection")
        results["fused_window_attention"]["max_abs_err"] = max(
            results["fused_window_attention"]["max_abs_err"], err)

    log("kernel phase: window attention backward (packed and split)")
    # dqkv and dbias of the packed wrapper's autograd.Function against the plain
    # backward on the same bf16 inputs (bound: relative L2 <= 1e-2 and max |error|
    # <= 3e-2 * max |reference| for the bf16 dqkv parts and the float32 dbias);
    # the split wrapper on heads-first views of the same projection, whose dq,
    # dk, dv and dbias must equal the packed wrapper's bit for bit; the same
    # call twice, which must give the same bits (the partial bias gradients of
    # the window chunks are added in a fixed order); the C entry point into
    # dqkv and dbias buffers whose next row is NaN, which must give the same
    # bits and leave that row NaN. At the four stage shapes, the device time of
    # the backward kernels alone beside that of SDPA's backward and the bound,
    # and their sums over a train step's 24 launches (2, 2, 18 and 2 at the four
    # stages, the shift mask on every second block).
    lib = _build.lib()
    wrong = [n for n in range(1, 145)
             if lib.dg_window_attention_bwd_smem(n) != wa_mod.backward_smem(n)]
    if wrong:
        raise AssertionError(f"the backward body's shared memory differs from backward_smem "
                             f"at n = {wrong}")
    log("    the bf16 backward body's shared memory per block equals backward_smem(n), "
        f"n = 1..144 ({wa_mod.backward_smem(144)} bytes at n = 144)")

    def backward_case(bn, c, heads, nw, n, with_mask):
        qkv, bias, mask, _, _ = window_case(bn, c, heads, nw, n, with_mask)
        do = randn(bn, n, c)
        d = c // heads
        ops = 5 * 2.0 * bn * heads * n * n * d
        nbytes = (2.0 * bn * n * (3 * c + c + 3 * c) + 2 * 4.0 * heads * n * n
                  + (4.0 * nw * n * n if with_mask else 0.0))
        return qkv.requires_grad_(True), bias.requires_grad_(True), mask, do, ops, nbytes

    def packed_backward(qkv, bias, mask, heads, do):
        out = wa_mod.fused_window_attention_packed(qkv, bias, mask, heads)
        return out, lambda: torch.autograd.grad(out, (qkv, bias), do, retain_graph=True)

    def guarded_backward(qkv, bias, mask, heads, do, dqkv, dbias, what):
        """The packed C entry point into dqkv and dbias buffers whose next row
        is NaN: the wrapper's bits, and that row untouched."""
        bn, n, c3 = qkv.shape
        plan = wa_mod.backward_plan(bn, heads, n, dev)
        gq = torch.full((bn * n + 1, c3), float("nan"), device=dev, dtype=torch.bfloat16)
        gb = torch.full((heads * n * n + n,), float("nan"), device=dev)
        part = torch.empty(plan.scratch, device=dev)
        _build.check(lib.dg_window_attention_packed_bwd_bf16(
            qkv.data_ptr(), do.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), gq.data_ptr(), gb.data_ptr(),
            part.data_ptr(), bn, n, heads, 1 if mask is None else mask.shape[0], plan.chunks,
            plan.per_chunk, (c3 // 3 // heads) ** -0.5, torch.cuda.current_stream().cuda_stream),
            "packed window attention backward kernel launch")
        if not (torch.equal(gq[:-1].view(bn, n, c3), dqkv) and bool(gq[-1].isnan().all())
                and torch.equal(gb[:-n].view(heads, n, n), dbias) and bool(gb[-n:].isnan().all())):
            raise AssertionError(f"window attention backward wrote outside dqkv or dbias ({what})")
        log(f"    writes nothing past dqkv and dbias (chunks {plan.chunks} x {plan.per_chunk} "
            f"windows): True")

    if sum(SWIN_L_STAGE_LAUNCHES.values()) != SWIN_L_BLOCKS:
        raise AssertionError("SWIN_L_STAGE_LAUNCHES does not add up to a Swin-L forward's launches")
    step = {"kernel": 0.0, "SDPA backward": 0.0, "bound": 0.0}
    for bn, c, heads, nw, n in ((722, 192, 6, 361, 144), (200, 384, 12, 100, 144),
                                (50, 768, 24, 25, 144), (18, 1536, 48, 9, 144),
                                (8, 96, 3, 4, 49), (8, 96, 3, 4, 16), (8, 96, 3, 2, 4)):
        for with_mask in (True, False):
            qkv, bias, mask, do, ops, nbytes = backward_case(bn, c, heads, nw, n, with_mask)
            what = (f"bn={bn} C={c} H={heads} n={n} "
                    f"mask={'nW ' + str(nw) if with_mask else 'none'}")
            _, run = packed_backward(qkv, bias, mask, heads, do)
            dqkv, dbias = run()
            ref_dqkv, ref_dbias = wa_mod.reference_window_attention_packed_backward(
                qkv.detach(), bias.detach(), mask, heads, do)
            err = max(compare(f"window packed backward {part} {what}",
                              dqkv[..., i * c:(i + 1) * c], ref_dqkv[..., i * c:(i + 1) * c])
                      for i, part in enumerate(("dq", "dk", "dv")))
            err_b = compare(f"window packed backward dbias {what}", dbias, ref_dbias)
            del ref_dqkv, ref_dbias
            again = run()
            same = torch.equal(again[0], dqkv) and torch.equal(again[1], dbias)
            log(f"    two runs give the same bits: {same}")
            if not same:
                raise AssertionError(f"window attention backward is not deterministic ({what})")
            guarded_backward(qkv.detach(), bias.detach(), mask, heads, do, dqkv, dbias, what)
            # the split wrapper on views of the same projection
            q, k, v = (t.detach().requires_grad_(True) for t in heads_first(qkv.detach(), heads))
            bias2 = bias.detach().clone().requires_grad_(True)
            out2 = wa_mod.fused_window_attention(q, k, v, bias2, mask)
            do4 = do.reshape(bn, n, heads, c // heads).permute(0, 2, 1, 3)
            run_split = lambda: torch.autograd.grad(out2, (q, k, v, bias2), do4, retain_graph=True)
            dq, dk, dv, dbias2 = run_split()
            merged = torch.cat([t.permute(0, 2, 1, 3).reshape(bn, n, c) for t in (dq, dk, dv)], -1)
            if not (torch.equal(merged, dqkv) and torch.equal(dbias2, dbias)):
                raise AssertionError(f"window attention backward: split and packed disagree ({what})")
            log("    fused_window_attention's backward equals the packed one on the same projection")
            if n != 144:  # ragged windows: held, not timed
                for key in ("fused_window_attention_packed_backward",
                            "fused_window_attention_backward"):
                    results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
                continue

            plain = lambda: wa_mod.reference_window_attention_packed_backward(
                qkv.detach(), bias.detach(), mask, heads, do)
            ms, pms, span = time_pair(run, plain, reps=WINDOW_REPS)
            first = "fused_window_attention_packed_backward" not in results
            # the PyTorch call's inputs and its forward graph, built outside the
            # timing: its backward alone is timed, as the kernel's is
            attn_mask = dense_mask(bias.detach(), mask, bn)
            q4, k4, v4 = (t.detach().contiguous().requires_grad_(True)
                          for t in heads_first(qkv.detach(), heads))
            do_c = do4.contiguous()
            lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask)
            library = lambda: torch.autograd.grad(lib_out, (q4, k4, v4), do_c, retain_graph=True)
            # device time of the backward kernels alone (the body and the reduce of
            # the chunks' partial bias gradients) and of SDPA's backward
            dev_ms, lib_dev = device_ms(run), device_ms(library)
            b_ms, _ = bound(ops, nbytes)
            share = SWIN_L_STAGE_LAUNCHES[bn] / 2  # half the stage's blocks take the mask
            step["kernel"] += share * dev_ms
            step["SDPA backward"] += share * lib_dev
            step["bound"] += share * b_ms
            log(f"    device: kernels {dev_ms:.4f} ms, SDPA backward {lib_dev:.4f} ms, bound "
                f"{b_ms:.4f} ms; {share:g} launches a train step")

            log(f"    dbias max_abs_err {err_b:.6g}; bound: {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.1f} GFLOP in five products")
            record("fused_window_attention_packed_backward", err, ms, pms, span, library, ops, nbytes)
            if first:
                library_both = lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(q4, k4, v4, attn_mask=attn_mask),
                    (q4, k4, v4), do_c)
                log(f"    (the PyTorch call is the backward of scaled_dot_product_attention alone, "
                    f"without a gradient for its dense bias; its forward + backward takes "
                    f"{time_one(library_both):.4f} ms)")
                results["fused_window_attention_packed_backward"].update(
                    device_ms=dev_ms, library_device_ms=lib_dev)
                del library_both
            del attn_mask, q4, k4, v4, lib_out, library
            ms2, pms2, span2 = time_pair(
                run_split, lambda: wa_mod.reference_window_attention_backward(
                    q.detach(), k.detach(), v.detach(), bias2.detach(), mask, do4), reps=WINDOW_REPS)
            if "fused_window_attention_backward" not in results:
                packed_entry = results["fused_window_attention_packed_backward"]
                dev2 = device_ms(run_split)
                log(f"    split backward on views: kernel {ms2:.4f} ms (min {span2[0]:.4f}, max "
                    f"{span2[1]:.4f}), plain {pms2:.4f} ms; device {dev2:.4f} ms")
                results["fused_window_attention_backward"] = dict(
                    packed_entry, ms=ms2, plain_ms=pms2, max_abs_err=err, device_ms=dev2)
            results["fused_window_attention_backward"]["max_abs_err"] = max(
                results["fused_window_attention_backward"]["max_abs_err"], err)
            torch.cuda.empty_cache()
    log("  window attention backward, a train step's 24 launches (device ms): "
        + ", ".join(f"{name} {ms:.4f}" for name, ms in step.items()))
    results["fused_window_attention_packed_backward"]["step_device_ms"] = step["kernel"]
    float32_attention_phases(gen, card, results)
    float32_full_width_phases(gen, card, results)
    return results


def f32_row(results: dict, kernel: str) -> dict:
    """The kernels line's row of the float32 body (``csrc/attention_f32.cu``)
    of an attention kernel, ``"<kernel> (float32)"``; kernels 5 and 6 share
    the packed wrapper's rows (one body)."""
    kernel = kernel.replace("fused_window_attention_backward",
                            "fused_window_attention_packed_backward")
    if kernel == "fused_window_attention":
        kernel = "fused_window_attention_packed"
    return results.setdefault(f"{kernel} (float32)", {"max_abs_err": 0.0})


def float32_attention_phases(gen: torch.Generator, card: str, results: dict) -> None:
    """Kernels 1, 3, 4, 5 and 6 on float32 q, k and v (the float32 body,
    ``csrc/attention_f32.cu``) against their float32 twins at the float32
    bound, each the same bits twice, with its event time beside the twin's,
    the PyTorch call's in float32 (SDPA, with the dense bias as a float32
    mask; for a backward, SDPA's backward alone) and the float32 bound
    (operations at 67 TFLOP/s, bytes at 3.35 TB/s)."""
    import divergen_tpu_torch.ops.flash_attention as fa_mod
    import divergen_tpu_torch.ops.window_attention as wa_mod

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def case(kernel, name, run, plain, library=None, ops=0.0, nbytes=0.0):
        got = run()
        if got.dtype != torch.float32:
            raise AssertionError(f"{name}: wrote {got.dtype} for float32 inputs")
        err = compare(name, got, plain(), **F32_BOUNDS)
        same_bits(name, got, run)
        ms, pms, span = time_pair(run, plain)
        line = (f"    float32: kernel {ms:.4f} ms (min {span[0]:.4f}, max {span[1]:.4f}), plain "
                f"{pms:.4f} ms")
        if library is not None:
            b_ms, by = bound(ops, nbytes, PEAK_F32_TC_FLOPS)
            fma_ms, _ = bound(ops, nbytes, PEAK_F32_FLOPS)
            line += (f", PyTorch call (float32) {time_one(library):.4f} ms, bound {b_ms:.4f} ms "
                     f"by {by} at 3xTF32, {fma_ms:.4f} at FMA ({ops / 1e9:.2f} GFLOP, "
                     f"{nbytes / 1e6:.1f} MB)")
        log(f"{line} [{card}]")
        row = f32_row(results, kernel)
        row["max_abs_err"] = max(row["max_abs_err"], err)

    def heads_first(t, heads):
        """(B, N, heads · d) -> contiguous (B, heads, N, d)."""
        return t.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()

    log("kernel phase: float32 attention (kernels 1, 3, 4, 5, 6)")
    from divergen_tpu_torch.ops import _build
    from divergen_tpu_torch.ops import attention_f32 as af_mod

    for d, plan in af_mod.TC_PLANS.items():  # the body's tiles against their mirror
        got = tuple(_build.lib().dg_attention_f32_plan(d, f) for f in range(6))
        want = (plan.rows, plan.keys, plan.warps_r, plan.warps_c, plan.stages, plan.smem(d))
        if got != want:
            raise AssertionError(f"float32 attention plan at d = {d}: library {got}, "
                                 f"ops/attention_f32.py {want}")
    log(f"  float32 attention plans (rows, keys, warps by rows and channels, stages, "
        f"shared bytes) match TC_PLANS: {dict((d, p.rows) for d, p in af_mod.TC_PLANS.items())}")
    b, n, c, heads = 2, 256, 128, 2
    qkv = randn(b, n, 3 * c)
    q4, k4, v4 = (heads_first(t, heads) for t in qkv.chunk(3, dim=-1))
    case("flash_attention_packed", f"packed B={b} N={n} C={c} H={heads} float32",
         lambda: fa_mod.flash_attention_packed(qkv, heads),
         lambda: fa_mod.reference_attention_packed(qkv, heads),
         lambda: F.scaled_dot_product_attention(q4, k4, v4),
         4.0 * b * n * n * c, 4.0 * b * n * 4 * c)
    bh, s, d = 1, 1024, 512
    q, k, v = (randn(bh, s, d) for _ in range(3))
    bias = randn(bh, s, s)
    case("flash_attention", f"flash BH={bh} S={s} D={d} bias float32",
         lambda: fa_mod.flash_attention(q, k, v, bias),
         lambda: fa_mod.reference_attention(q, k, v, bias),
         lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias),
         4.0 * bh * s * s * d, 4.0 * bh * 4 * s * d + 4.0 * bh * s * s)
    b, heads, (h, w), d = 2, 16, (16, 16), 80
    n = h * w
    fused = randn(b, n, 3, heads, d)
    q, k, v = (fused[:, :, s].permute(0, 2, 1, 3) for s in range(3))  # views, as the ViT's
    bh_t, bw_t = randn(b * heads, h, n, scale=0.7), randn(b * heads, w, n, scale=0.7)
    dense = fa_mod.relpos_dense_bias(bh_t, bw_t).contiguous().reshape(b, heads, n, n)
    case("flash_attention_relpos", f"relpos B={b} heads={heads} grid={h}x{w} D={d} float32",
         lambda: fa_mod.flash_attention_relpos(q, k, v, bh_t, bw_t, (h, w)).reshape(
             b * heads, n, d),
         lambda: fa_mod.reference_attention_relpos(*(t.reshape(b * heads, n, d) for t in (q, k, v)),
                                                   bh_t, bw_t, (h, w)),
         lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=dense),
         4.0 * b * heads * n * n * d, 4.0 * 4 * b * heads * n * d + 4.0 * b * heads * (h + w) * n)
    bn, heads, nw, n = 8, 6, 4, 144
    c = 32 * heads
    qkv = randn(bn, n, 3 * c).requires_grad_(True)
    bias = randn(heads, n, n, scale=0.5).requires_grad_(True)
    mask = torch.where(torch.rand((nw, n, n), generator=gen, device=dev) < 0.3, -100.0, 0.0)
    mask.diagonal(dim1=1, dim2=2).zero_()
    do = randn(bn, n, c)
    what = f"bn={bn} C={c} H={heads} n={n} mask=nW {nw} float32"
    # the PyTorch call: SDPA on contiguous heads-first q, k, v with bias + mask
    # as one dense float32 mask; for the backward its forward graph is built
    # outside the timing, and only dq, dk and dv are asked of it
    win_mask = (bias.detach()[None] + mask.repeat(bn // nw, 1, 1)[:, None]).contiguous()
    q4, k4, v4 = (heads_first(t, heads).requires_grad_(True)
                  for t in qkv.detach().chunk(3, dim=-1))
    do4c = heads_first(do, heads)
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=win_mask)
    fwd_ops, fwd_bytes = 4.0 * bn * n * n * c, 4.0 * bn * n * 4 * c + 4.0 * (heads + nw) * n * n
    bwd_ops = 5 * 2.0 * bn * n * n * c
    bwd_bytes = 4.0 * bn * n * 7 * c + 4.0 * (2 * heads + nw) * n * n
    case("fused_window_attention_packed", f"window packed {what}",
         lambda: wa_mod.fused_window_attention_packed(qkv, bias, mask, heads).detach(),
         lambda: wa_mod.reference_window_attention_packed(qkv.detach(), bias.detach(), mask,
                                                          heads),
         lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=win_mask), fwd_ops,
         fwd_bytes)
    split = lambda t: t.detach().reshape(bn, n, 3, heads, 32).permute(2, 0, 3, 1, 4)
    q, k, v = (t.requires_grad_(True) for t in split(qkv))
    bias2 = bias.detach().clone().requires_grad_(True)
    case("fused_window_attention", f"window split {what} (views)",
         lambda: wa_mod.fused_window_attention(q, k, v, bias2, mask).detach(),
         lambda: wa_mod.reference_window_attention(q.detach(), k.detach(), v.detach(),
                                                   bias2.detach(), mask),
         lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=win_mask), fwd_ops,
         fwd_bytes)
    sdpa_backward = lambda: torch.autograd.grad(lib_out, (q4, k4, v4), do4c, retain_graph=True)
    out = wa_mod.fused_window_attention_packed(qkv, bias, mask, heads)
    packed_grads = lambda: torch.autograd.grad(out, (qkv, bias), do, retain_graph=True)
    ref = lambda: wa_mod.reference_window_attention_packed_backward(
        qkv.detach(), bias.detach(), mask, heads, do)
    for i, part in enumerate(("dq", "dk", "dv", "dbias")):
        sl = (lambda g: g[1]) if part == "dbias" else (lambda g, i=i: g[0][..., i * c:(i + 1) * c])
        case("fused_window_attention_packed_backward", f"window packed backward {part} {what}",
             lambda sl=sl: sl(packed_grads()), lambda sl=sl: sl(ref()),
             *((sdpa_backward, bwd_ops, bwd_bytes) if part == "dq" else ()))
    out2 = wa_mod.fused_window_attention(q, k, v, bias2, mask)
    do4 = do.reshape(bn, n, heads, 32).permute(0, 2, 1, 3)
    split_grads = lambda: torch.autograd.grad(out2, (q, k, v, bias2), do4, retain_graph=True)
    ref4 = lambda: wa_mod.reference_window_attention_backward(
        q.detach(), k.detach(), v.detach(), bias2.detach(), mask, do4)
    for i, part in enumerate(("dq", "dk", "dv", "dbias")):
        case("fused_window_attention_backward", f"window split backward {part} {what}",
             lambda i=i: split_grads()[i], lambda i=i: ref4()[i],
             *((sdpa_backward, bwd_ops, bwd_bytes) if part == "dq" else ()))


# float32 cases at the shapes of full-width models: (kernel, what, shape)
F32_FULL_WIDTH = (
    ("flash_attention", "a float32 VAEDecoder's mid attention at 1024²", (1, 16384, 512)),
    ("flash_attention", "the same at 512²", (1, 4096, 512)),
    ("flash_attention_relpos", "a float32 SAM.vit_h() global layer, B = 4", (4, 16, 64, 64, 80)),
    ("flash_attention_packed", "a float32 UNetSDXL() level-1 self-attention",
     (4, 4096, 640, 10)),
    ("fused_window_attention_packed", "Swin-L stage 1 with the mask", (722, 6, 361, 144)),
    ("fused_ln_matmul", "the UNet's GEGLU, 60 a call", (4096, 1280, 10240, "geglu")),
    ("fused_ln_matmul", "the UNet's GEGLU, 10 a call", (16384, 640, 5120, "geglu")),
    ("fused_ln_matmul", "SAM ViT-H's qkv, bias", (16384, 1280, 3840, "none")),
    ("fused_ln_matmul", "SAM ViT-H's mlp_fc1, GELU, bias", (16384, 1280, 5120, "gelu")),
)


def device_kernels(fn, reps: int = 3, top: int = 2):
    """[(name, ms per call)] of the ``top`` kernels with the most device time
    in ``reps`` calls of ``fn`` under ``torch.profiler``, after one warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    return [(e.key, e.self_device_time_total / 1e3 / reps) for e in events[:top]]


def float32_full_width_phases(gen: torch.Generator, card: str, results: dict) -> None:
    """The float32 bodies at the shapes of full-width models
    (``F32_FULL_WIDTH``): each against its float32 twin at the float32 bound,
    the same bits twice, then device times (``device_ms``) of the kernel, the
    twin and the PyTorch float32 call (TF32 off: SDPA with the bias as a
    float32 mask; ``F.linear(F.layer_norm(x))`` + the epilogue), the names of
    that call's longest kernels, and the bounds: operations at 3xTF32
    (``PEAK_F32_TC_FLOPS``, which applies to these bodies) and at FMA, bytes
    at 3.35 TB/s."""
    import divergen_tpu_torch.ops.flash_attention as fa_mod
    import divergen_tpu_torch.ops.ln_matmul as ln_mod
    import divergen_tpu_torch.ops.window_attention as wa_mod

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def heads_first(t, heads):
        return t.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()

    log("kernel phase: float32 bodies at full width")
    for kernel, what, shape in F32_FULL_WIDTH:
        if kernel == "flash_attention":
            bh, s, d = shape
            q, k, v = (randn(bh, s, d) for _ in range(3))
            run = lambda: fa_mod.flash_attention(q, k, v)
            plain = lambda: fa_mod.reference_attention(q, k, v)
            library = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None])
            ops, nbytes = 4.0 * bh * s * s * d, 4.0 * 4 * bh * s * d
        elif kernel == "flash_attention_relpos":
            b, heads, h, w, d = shape
            n = h * w
            fused = randn(b, n, 3, heads, d)
            q, k, v = (fused[:, :, i].permute(0, 2, 1, 3) for i in range(3))
            bh_t, bw_t = randn(b * heads, h, n, scale=0.7), randn(b * heads, w, n, scale=0.7)
            dense = fa_mod.relpos_dense_bias(bh_t, bw_t).contiguous().reshape(b, heads, n, n)
            run = lambda: fa_mod.flash_attention_relpos(q, k, v, bh_t, bw_t, (h, w))
            plain = lambda: fa_mod.reference_attention_relpos(
                *(t.reshape(b * heads, n, d) for t in (q, k, v)), bh_t, bw_t,
                (h, w)).reshape(b, heads, n, d)
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=dense)
            ops = 4.0 * b * heads * n * n * d
            nbytes = 4.0 * 4 * b * heads * n * d + 4.0 * b * heads * (h + w) * n
        elif kernel == "flash_attention_packed":
            b, n, c, heads = shape
            qkv = randn(b, n, 3 * c)
            q4, k4, v4 = (heads_first(t, heads) for t in qkv.chunk(3, dim=-1))
            run = lambda: fa_mod.flash_attention_packed(qkv, heads)
            plain = lambda: fa_mod.reference_attention_packed(qkv, heads)
            library = lambda: F.scaled_dot_product_attention(q4, k4, v4)
            ops, nbytes = 4.0 * b * n * n * c, 4.0 * b * n * 4 * c
        elif kernel == "fused_window_attention_packed":
            bn, heads, nw, n = shape
            c = 32 * heads
            qkv = randn(bn, n, 3 * c)
            bias = randn(heads, n, n, scale=0.5)
            mask = torch.where(torch.rand((nw, n, n), generator=gen, device=dev) < 0.3, -100.0,
                               0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
            win_mask = (bias[None] + mask.repeat(bn // nw, 1, 1)[:, None]).contiguous()
            q4, k4, v4 = (heads_first(t, heads) for t in qkv.chunk(3, dim=-1))
            run = lambda: wa_mod.fused_window_attention_packed(qkv, bias, mask, heads)
            plain = lambda: wa_mod.reference_window_attention_packed(qkv, bias, mask, heads)
            library = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=win_mask)
            ops = 4.0 * bn * n * n * c
            nbytes = 4.0 * bn * n * 4 * c + 4.0 * (heads + nw) * n * n
        else:
            m, kk, n, epi = shape
            geglu, act = epi == "geglu", "gelu" if epi == "gelu" else "none"
            x = randn(m, kk, scale=2.0)
            w = randn(n, kk, scale=kk ** -0.5).t()
            gamma = 1.0 + 0.1 * randn(kk)
            beta = 0.1 * randn(kk)
            bias = 0.1 * randn(n) if epi != "geglu" else None
            run = lambda: ln_mod.fused_ln_matmul(x, w, gamma, beta, 1e-5, bias, geglu, act)
            plain = lambda: ln_mod.ln_matmul_reference(x, w, gamma, beta, 1e-5, bias, geglu, act)

            def library():
                y = F.linear(F.layer_norm(x, (kk,), gamma, beta, 1e-5), w.t(), bias)
                if geglu:
                    hidden, gate = y.chunk(2, dim=-1)
                    return hidden * F.gelu(gate)
                return F.gelu(y) if act == "gelu" else y

            cols = n // 2 if geglu else n
            ops = 2.0 * m * kk * n
            nbytes = 4.0 * (m * kk + kk * n + m * cols + 2 * kk + (n if bias is not None else 0))
        name = f"{kernel} float32 {shape} ({what})"
        got = run()
        err = compare(name, got, plain(), **F32_BOUNDS)
        same_bits(name, got, run)
        del got
        k_ms, p_ms, l_ms = device_ms(run, reps=3), device_ms(plain, reps=3), device_ms(library,
                                                                                        reps=3)
        names = "; ".join(f"{kname[:90]} {kms:.4f} ms" for kname, kms in device_kernels(library))
        b_ms, by = bound(ops, nbytes, PEAK_F32_TC_FLOPS)
        fma_ms, _ = bound(ops, nbytes, PEAK_F32_FLOPS)
        log(f"    device: kernel {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.4f} "
            f"ms, PyTorch call (float32) {l_ms:.4f} ms [its kernels: {names}]; bound "
            f"{b_ms:.4f} ms by {by} at 3xTF32, {fma_ms:.4f} at FMA ({ops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB) [{card}]")
        # kernel 2's float32 GEMM is in its bf16 body's source; the attention
        # kernels' float32 body is a source of its own: its first shape's row
        row = results[kernel] if kernel == "fused_ln_matmul" else f32_row(results, kernel)
        if "ms" not in row:
            row.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by, library_ms=l_ms)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        torch.cuda.empty_cache()


# the float32 window backward body at Swin-L's four stage shapes of B = 2 at
# 896² (windows, heads, windows of the shift mask) and the smoke shape, n =
# 144, d = 32: checked and timed, with and without the mask
F32_WINDOW_BWD_SHAPES = ((722, 6, 361), (200, 12, 100), (50, 24, 25), (18, 48, 9), (8, 6, 4))
# the launches of small_active_step, the float32 main path (the small Swin-T
# detector at 64², B = 2, d = 32): (windows, heads, n, windows of the shift
# mask or None), held by small_active_step to be all of its launches; then n
# at each count of 16-row tiles the body is built for (1, 2, 4, 7, 9; n % 4 !=
# 0 takes the scalar staging), at d = 32 and 64, with and without a mask:
# checked, not timed
F32_WINDOW_BWD_SWIN_T = ((18, 3, 49, 9), (18, 3, 49, None), (8, 6, 49, 4), (8, 6, 49, None),
                         (2, 12, 16, None), (2, 24, 4, None))
F32_WINDOW_BWD_TILES = (7, 25, 49, 64, 100, 144)


def check_f32_window_backward(gen: torch.Generator, bn: int, heads: int, n: int, d: int,
                              nw) -> tuple:
    """The float32 window backward through the packed wrapper on random
    inputs (``nw`` windows of a mask of -100 at 30 %, or no mask): dq, dk, dv
    and dbias against the twin at ``F32_BOUNDS``, the same bits twice.
    Returns (max error, inputs: qkv, bias, mask, do, out)."""
    import divergen_tpu_torch.ops.window_attention as wa_mod

    dev = torch.device("cuda")
    c = heads * d
    qkv = torch.randn((bn, n, 3 * c), generator=gen, device=dev).requires_grad_(True)
    bias = (0.5 * torch.randn((heads, n, n), generator=gen, device=dev)).requires_grad_(True)
    mask = None
    if nw is not None:
        mask = torch.where(torch.rand((nw, n, n), generator=gen, device=dev) < 0.3, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
    do = torch.randn((bn, n, c), generator=gen, device=dev)
    what = f"bn={bn} H={heads} n={n} d={d} mask={'none' if nw is None else f'nW {nw}'}"
    out = wa_mod.fused_window_attention_packed(qkv, bias, mask, heads)
    got = torch.autograd.grad(out, (qkv, bias), do, retain_graph=True)
    ref = wa_mod.reference_window_attention_packed_backward(qkv.detach(), bias.detach(), mask,
                                                            heads, do)
    err = max(compare(f"float32 window backward {part} {what}", got[0][..., i * c:(i + 1) * c],
                      ref[0][..., i * c:(i + 1) * c], **F32_BOUNDS)
              for i, part in enumerate(("dq", "dk", "dv")))
    err = max(err, compare(f"float32 window backward dbias {what}", got[1], ref[1], **F32_BOUNDS))
    again = torch.autograd.grad(out, (qkv, bias), do, retain_graph=True)
    if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
        raise AssertionError(f"float32 window backward is not deterministic ({what})")
    return err, (qkv, bias, mask, do, out)


def float32_window_backward_phase(gen: torch.Generator, card: str, results: dict) -> None:
    """The float32 window backward body (``csrc/attention_f32.cu:
    window_bwd_tc_kernel``, kernels 5 and 6, 3xTF32 on mma.sync) through the
    packed wrapper's backward (``check_f32_window_backward``): at the shapes
    of a float32 Swin-T step's launches and at every tile count of the body
    (``F32_WINDOW_BWD_SWIN_T``, ``F32_WINDOW_BWD_TILES``), checked; at
    Swin-L's four stage shapes and the smoke shape (``F32_WINDOW_BWD_SHAPES``,
    n = 144, d = 32), with and without the mask, checked and then timed: the
    backward alone (the body and the reduce of the chunks' partial bias
    gradients; its forward graph built outside the timing), the twin, and
    SDPA's float32 backward (TF32 off, the bias + mask as one dense float32
    mask, dq, dk and dv only) beside the bound: bytes (q, k, v, do read, dq,
    dk, dv written, bias and mask read once, dbias written) at 3.35 TB/s,
    five products at 3xTF32. Its shared memory and resident blocks are held
    against ``f32_backward_smem`` / ``f32_backward_resident`` for n =
    1..144, d = 32 and 64 (both size its grid)."""
    import divergen_tpu_torch.ops.window_attention as wa_mod
    from divergen_tpu_torch.ops import _build

    lib = _build.lib()
    log("kernel phase: float32 window attention backward (3xTF32 body)")
    for d in wa_mod.F32_BWD_HEAD_DIMS:
        wrong = [n for n in range(1, 145)
                 if lib.dg_window_attention_bwd_f32_smem(n, d) != wa_mod.f32_backward_smem(n, d)
                 or lib.dg_window_attention_bwd_f32_resident(n, d)
                 != wa_mod.f32_backward_resident(n, d)]
        if wrong:
            raise AssertionError(f"float32 window backward at d = {d}: the library's shared "
                                 f"memory or resident blocks differ from the plan's at n = {wrong}")
    log(f"    shared memory and resident blocks equal f32_backward_smem / _resident, n = 1..144, "
        f"d = 32 and 64 ({wa_mod.f32_backward_smem(144, 32)} bytes and "
        f"{wa_mod.f32_backward_resident(144, 32)} block at n = 144, d = 32)")
    cases = [(bn, heads, n, 32, nw) for bn, heads, n, nw in F32_WINDOW_BWD_SWIN_T]
    cases += [(4, 2, n, d, nw) for d in wa_mod.F32_BWD_HEAD_DIMS for n in F32_WINDOW_BWD_TILES
              for nw in (2, None)]
    errs = [check_f32_window_backward(gen, *case)[0] for case in cases]
    log(f"    {len(cases)} shapes of a float32 Swin-T step's launches and of every tile count at d = 32 and "
        f"64 agree with the twin (max |error| {max(errs):.3g})")
    n, d = 144, 32
    for bn, heads, nw in F32_WINDOW_BWD_SHAPES:
        c = heads * d
        for with_mask in (True, False):
            err, (qkv, bias, mask, do, out) = check_f32_window_backward(
                gen, bn, heads, n, d, nw if with_mask else None)
            run = lambda: torch.autograd.grad(out, (qkv, bias), do, retain_graph=True)
            plain = lambda: wa_mod.reference_window_attention_packed_backward(
                qkv.detach(), bias.detach(), mask, heads, do)
            win_mask = bias.detach()[None].expand(bn, heads, n, n)
            if mask is not None:
                win_mask = win_mask + mask.repeat(bn // nw, 1, 1)[:, None]
            win_mask = win_mask.contiguous()
            q4, k4, v4 = (t.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()
                          .requires_grad_(True) for t in qkv.detach().chunk(3, dim=-1))
            do4 = do.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()
            lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=win_mask)
            library = lambda: torch.autograd.grad(lib_out, (q4, k4, v4), do4, retain_graph=True)
            k_ms, p_ms, l_ms = device_ms(run, reps=5), device_ms(plain, reps=3), device_ms(
                library, reps=5)
            ops = 5 * 2.0 * bn * heads * n * n * d
            nbytes = 4.0 * bn * n * 7 * c + 4.0 * (2 * heads + (nw if with_mask else 0)) * n * n
            b_ms, by = bound(ops, nbytes, PEAK_F32_TC_FLOPS)
            log(f"    device: kernels {k_ms:.4f} ms ({b_ms / k_ms:.3f} of the bound), plain "
                f"{p_ms:.4f} ms, SDPA float32 backward {l_ms:.4f} ms; bound {b_ms:.4f} ms by {by} "
                f"({ops / 1e9:.2f} GFLOP at 3xTF32, {nbytes / 1e6:.1f} MB) [{card}]")
            row = f32_row(results, "fused_window_attention_packed_backward")
            if with_mask and "ms" not in row:  # stage 1 (the first shape) gives the row
                row.update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by, library_ms=l_ms)
            row["max_abs_err"] = max(row["max_abs_err"], err, *errs)
            del out, lib_out, q4, k4, v4, win_mask, qkv, bias, mask, do
            torch.cuda.empty_cache()


def head_dim_phases(gen: torch.Generator, card: str) -> list:
    """Head dims between the bodies' widths (``attention_f32.kernel_body``):
    the wrappers pad q, k and v to a body's width and slice the output. Each
    case against its twin at the true head dim (bf16: relative L2 <= 1e-2,
    max |error| <= 3e-2 max |ref|; float32: ``F32_BOUNDS``), with its CUDA-event
    time beside the twin's, the PyTorch call's (SDPA; for a backward, SDPA's
    backward) and the bound of the true head dim's work: kernel 3 at d = 16
    (bf16 width 64, float32 32) and d = 96 (bf16 512, float32 128) with a
    dense bias; kernel 1 at d = 16 through kernel 3's path at a tiny UNet's
    level-1 shape; kernel 4 at d = 64 (bf16 onto the d = 80 body) on a
    32 x 32 grid; the window kernels, forward and backward, at d = 16 in bf16
    (width 32, n = 49) and at d = 64 in float32 (the new body's d = 64, n =
    144, with the mask); kernel 1 in float32 at d = 128 (the body's own
    width, read by stride) and d = 96 (kernel 3's path), and in bf16 at d =
    96 (kernel 3's path onto the d = 512 body); kernel 4 in bf16 at d = 96
    (the float32 body on a float32 copy, width 128). Returns the kernels
    line's entries of the cases, each with ``phase_launches``, the wrapper's
    launches in the case's checked call, and the key under which the main
    paths' launches of that body at that head dim are counted (wrapper,
    backward, body entry, d; ``attention_f32.count``), from which ``main``
    fills in ``launches``."""
    import divergen_tpu_torch.ops.flash_attention as fa_mod
    import divergen_tpu_torch.ops.window_attention as wa_mod
    from divergen_tpu_torch.ops import attention_f32

    dev = torch.device("cuda")
    log("kernel phase: head dims padded to a body's width")

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    entries = []
    sources = {"dg_attention_f32": "attention_f32.cu",
               "dg_flash_attention_sm90": "flash_attention_sm90.cu",
               "dg_flash_attention_d512": "flash_attention_d512.cu",
               "dg_flash_attention_relpos_bf16": "flash_attention_relpos_sm90.cu",
               "dg_window_attention_bf16": "window_attention.cu"}
    replaces = {"flash_attention": 146, "flash_attention_packed": 337,
                "flash_attention_relpos": 531}

    def case(key, wrapper, run, plain, library, ops, nbytes, dtype, backward=False):
        counter = "backward_launches" if backward else "launches"
        before = getattr(wrapper, counter)
        got = run()
        launched = getattr(wrapper, counter) - before
        got = got if isinstance(got, (tuple, list)) else (got,)
        ref = plain()
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        bounds = F32_BOUNDS if dtype == torch.float32 else {}
        err = max(compare(f"{key} [{i}]", g, r, **bounds) for i, (g, r) in enumerate(zip(got, ref)))
        ms, pms, span = time_pair(run, plain)
        b_ms, by = bound(ops, nbytes, PEAK_F32_TC_FLOPS if dtype == torch.float32
                         else PEAK_BF16_FLOPS)
        l_ms = time_one(library)
        log(f"    kernel {ms:.4f} ms (min {span[0]:.4f}, max {span[1]:.4f}), plain {pms:.4f} ms, "
            f"PyTorch call {l_ms:.4f} ms, bound {b_ms:.4f} ms by {by}; {launched} launch [{card}]")
        name = wrapper.__name__ + ("_backward" if backward else "")
        mode = ("window" if "window" in name else "relpos" if "relpos" in name
                else "dense" if "bias" in key else "none")
        d = int(key.split(" d")[1].split()[0])
        body = attention_f32.kernel_body(dtype, d, mode)
        entries.append(({"name": f"{key} (head-dim phase)", "route": "cuda",
                         "source": f"divergen_tpu_torch/csrc/{sources[body.entry]}",
                         "replaces": (f"divergen_tpu/ops/pallas/window_attention.py:"
                                      f"{408 if backward else 470}" if "window" in name else
                                      f"divergen_tpu/ops/pallas/flash_attention.py:"
                                      f"{replaces[wrapper.__name__]}"),
                         "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                         "bound_by": by, "library_ms": l_ms, "phase_launches": launched},
                        (wrapper, backward, body.entry, d)))
        torch.cuda.empty_cache()

    size = {torch.bfloat16: 2, torch.float32: 4}
    with torch.no_grad():
        for d in (16, 96):
            for dtype in (torch.bfloat16, torch.float32):
                bh, s = 8, 1024
                q, k, v = (randn(bh, s, d, dtype=dtype) for _ in range(3))
                bias = randn(bh, s, s)
                mask = bias.to(dtype)
                case(f"flash_attention d{d} {str(dtype)[6:]} bias", fa_mod.flash_attention,
                     lambda: fa_mod.flash_attention(q, k, v, bias),
                     lambda: fa_mod.reference_attention(q, k, v, bias),
                     lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                     4.0 * bh * s * s * d, size[dtype] * 4.0 * bh * s * d + 4.0 * bh * s * s, dtype)
        for dtype, d in ((torch.bfloat16, 16), (torch.float32, 16), (torch.bfloat16, 96),
                         (torch.float32, 96), (torch.float32, 128)):
            b, n, heads = 2, 1024, 4
            qkv = randn(b, n, 3 * heads * d, dtype=dtype)
            q4, k4, v4 = (t.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()
                          for t in qkv.chunk(3, dim=-1))
            case(f"flash_attention_packed d{d} {str(dtype)[6:]}", fa_mod.flash_attention_packed,
                 lambda: fa_mod.flash_attention_packed(qkv, heads),
                 lambda: fa_mod.reference_attention_packed(qkv, heads),
                 lambda: F.scaled_dot_product_attention(q4, k4, v4),
                 4.0 * b * n * n * heads * d, size[dtype] * 4.0 * b * n * heads * d, dtype)
        for dtype, d in ((torch.bfloat16, 64), (torch.float32, 64), (torch.bfloat16, 96)):
            b, heads, (h, w) = 2, 4, (32, 32)
            n = h * w
            fused = randn(b, n, 3, heads, d, dtype=dtype)
            q, k, v = (fused[:, :, i].permute(0, 2, 1, 3) for i in range(3))
            bh_t, bw_t = randn(b * heads, h, n, scale=0.7), randn(b * heads, w, n, scale=0.7)
            dense = fa_mod.relpos_dense_bias(bh_t, bw_t).reshape(b, heads, n, n).to(dtype)
            case(f"flash_attention_relpos d{d} {str(dtype)[6:]}", fa_mod.flash_attention_relpos,
                 lambda: fa_mod.flash_attention_relpos(q, k, v, bh_t, bw_t, (h, w)).reshape(
                     b * heads, n, d),
                 lambda: fa_mod.reference_attention_relpos(
                     *(t.reshape(b * heads, n, d) for t in (q, k, v)), bh_t, bw_t, (h, w)),
                 lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=dense),
                 4.0 * b * heads * n * n * d,
                 size[dtype] * 4.0 * b * heads * n * d + 4.0 * b * heads * (h + w) * n, dtype)
    for dtype, d, bn, heads, n, nw in ((torch.bfloat16, 16, 64, 3, 49, 16),
                                       (torch.float32, 64, 32, 2, 144, 8)):
        c = heads * d
        qkv = randn(bn, n, 3 * c, dtype=dtype).requires_grad_(True)
        bias = randn(heads, n, n, scale=0.5).requires_grad_(True)
        mask = torch.where(torch.rand((nw, n, n), generator=gen, device=dev) < 0.3, -100.0, 0.0)
        mask.diagonal(dim1=1, dim2=2).zero_()
        do = randn(bn, n, c, dtype=dtype)
        win_mask = (bias.detach()[None] + mask.repeat(bn // nw, 1, 1)[:, None]).to(dtype)
        q4, k4, v4 = (t.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous().requires_grad_(True)
                      for t in qkv.detach().chunk(3, dim=-1))
        do4 = do.unflatten(-1, (heads, -1)).transpose(1, 2).contiguous()
        tag = f"d{d} {str(dtype)[6:]}"
        fwd_bytes = size[dtype] * 4.0 * bn * n * c + 4.0 * (heads + nw) * n * n
        bwd_bytes = size[dtype] * 7.0 * bn * n * c + 4.0 * (2 * heads + nw) * n * n
        with torch.no_grad():
            case(f"fused_window_attention_packed {tag}", wa_mod.fused_window_attention_packed,
                 lambda: wa_mod.fused_window_attention_packed(qkv, bias, mask, heads),
                 lambda: wa_mod.reference_window_attention_packed(qkv, bias, mask, heads),
                 lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=win_mask),
                 4.0 * bn * n * n * c, fwd_bytes, dtype)
        out = wa_mod.fused_window_attention_packed(qkv, bias, mask, heads)
        lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=win_mask)
        # the twin of the bf16 body rounds p and ds to bf16; for the padded
        # bf16 case the plain twin runs at the true d, so the bf16 bound holds
        case(f"fused_window_attention_packed_backward {tag}", wa_mod.fused_window_attention_packed,
             lambda: torch.autograd.grad(out, (qkv, bias), do, retain_graph=True),
             lambda: wa_mod.reference_window_attention_packed_backward(
                 qkv.detach(), bias.detach(), mask, heads, do),
             lambda: torch.autograd.grad(lib_out, (q4, k4, v4), do4, retain_graph=True),
             5 * 2.0 * bn * n * n * c, bwd_bytes, dtype, backward=True)
        del out, lib_out
    return entries


def body_route_sweep(gen: torch.Generator) -> int:
    """Every route ``attention_f32.kernel_body`` takes for a head dim 1..128
    or 512, on the card, each against its twin (bf16: the default bounds;
    float32: ``F32_BOUNDS``), not timed: for each dtype and bias mode (none
    and dense through kernel 3, relpos through kernel 4 on an 8 x 8 grid)
    and each body width, the least head dim that takes it and the body's own
    width where it takes that; kernel 1 by stride at each body's own width;
    the window kernels' forward and backward at the least head dim of each
    width. Returns the number of cases."""
    import divergen_tpu_torch.ops.flash_attention as fa_mod
    import divergen_tpu_torch.ops.window_attention as wa_mod
    from divergen_tpu_torch.ops import attention_f32

    dev = torch.device("cuda")

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    dims = list(range(1, attention_f32.PADDED_HEAD_DIMS + 1)) + [512]
    n_cases = 0
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            bounds = F32_BOUNDS if dtype == torch.float32 else {}
            tag = str(dtype)[6:]
            for mode in ("none", "dense", "relpos"):
                routes = {}
                for d in dims:
                    routes.setdefault(attention_f32.kernel_body(dtype, d, mode), []).append(d)
                for body, ds in routes.items():
                    for d in sorted({ds[0]} | ({body.width} & set(ds))):
                        if mode == "relpos":
                            h = w = 8
                            q, k, v = (randn(4, h * w, d, dtype=dtype) for _ in range(3))
                            bh_t, bw_t = (randn(4, h, h * w, scale=0.7),
                                          randn(4, w, h * w, scale=0.7))
                            got = fa_mod.flash_attention_relpos(q, k, v, bh_t, bw_t, (h, w))
                            ref = fa_mod.reference_attention_relpos(q, k, v, bh_t, bw_t, (h, w))
                        else:
                            q, k, v = (randn(2, 256, d, dtype=dtype) for _ in range(3))
                            bias = randn(2, 256, 256) if mode == "dense" else None
                            got = fa_mod.flash_attention(q, k, v, bias)
                            ref = fa_mod.reference_attention(q, k, v, bias)
                        compare(f"{mode} d{d} {tag} ({body.entry}, width {body.width})", got, ref,
                                **bounds)
                        n_cases += 1
            for width in sorted({attention_f32.kernel_body(dtype, d, "none").width for d in dims}):
                if attention_f32.kernel_body(dtype, width, "none").dtype != dtype:
                    continue
                b, n, heads = 2, 256, 2
                qkv = randn(b, n, 3 * heads * width, dtype=dtype)
                compare(f"packed by stride d{width} {tag}", fa_mod.flash_attention_packed(qkv, heads),
                        fa_mod.reference_attention_packed(qkv, heads), **bounds)
                n_cases += 1
    for dtype in (torch.bfloat16, torch.float32):
        bounds = F32_BOUNDS if dtype == torch.float32 else {}
        widths = attention_f32.WINDOW_WIDTHS[dtype]
        for d in [1] + [w + 1 for w in widths[:-1]]:
            bn, heads, n, nw = 4, 2, 49, 2
            c = heads * d
            qkv = randn(bn, n, 3 * c, dtype=dtype).requires_grad_(True)
            bias = randn(heads, n, n, scale=0.5).requires_grad_(True)
            mask = torch.where(torch.rand((nw, n, n), generator=gen, device=dev) < 0.3, -100.0,
                               0.0)
            mask.diagonal(dim1=1, dim2=2).zero_()
            do = randn(bn, n, c, dtype=dtype)
            width = attention_f32.kernel_body(dtype, d, "window").width
            what = f"window d{d} {str(dtype)[6:]} (width {width})"
            out = wa_mod.fused_window_attention_packed(qkv, bias, mask, heads)
            compare(f"{what} forward", out, wa_mod.reference_window_attention_packed(
                qkv.detach(), bias.detach(), mask, heads), **bounds)
            got = torch.autograd.grad(out, (qkv, bias), do)
            ref = wa_mod.reference_window_attention_packed_backward(qkv.detach(), bias.detach(),
                                                                    mask, heads, do)
            for part, g, r in (("dqkv", got[0], ref[0]), ("dbias", got[1], ref[1])):
                compare(f"{what} backward {part}", g, r, **bounds)
            n_cases += 1
    return n_cases


def head_dim_models() -> None:
    """``UNetSDXL.tiny()`` (head dim 16: kernel 1 through kernel 3's path,
    kernel 2) one call on the card in bf16 and in float32, each against the
    same module in float32 on the CPU (bf16: relative L2 <= 3e-2; float32:
    ``F32_MODEL_BOUNDS``), kernels 1 and 2 launched."""
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.ops.flash_attention import flash_attention_packed
    from divergen_tpu_torch.ops.ln_matmul import fused_ln_matmul
    from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(29)
    ref = flax_init_(UNetSDXL.tiny(), g).eval()
    lat = torch.randn((2, 32, 32, 4), generator=g)
    t = torch.tensor([500.0, 20.0])
    ctx = torch.randn((2, 77, 64), generator=g)
    with torch.inference_mode():
        want = ref(lat, t, ctx)
    for dtype, bounds in ((torch.bfloat16, dict(rel_l2_bound=3e-2)),
                          (torch.float32, F32_MODEL_BOUNDS)):
        unet = UNetSDXL.tiny(dtype=dtype, device=dev).eval()
        unet.load_state_dict(ref.state_dict())
        before = (flash_attention_packed.launches, fused_ln_matmul.launches)
        with torch.inference_mode():
            got = unet(lat.to(dev), t.to(dev), ctx.to(dev))
        ran = (flash_attention_packed.launches - before[0], fused_ln_matmul.launches - before[1])
        log(f"    UNetSDXL.tiny() {dtype}: {ran[0]} flash_attention_packed (head dim 16) and "
            f"{ran[1]} fused_ln_matmul launches")
        if not all(ran):
            raise AssertionError(f"UNetSDXL.tiny() {dtype}: launches {ran}")
        compare(f"UNetSDXL.tiny() {dtype} (card) vs f32 CPU", got.float().cpu(), want, **bounds)


def autograd_guard_phase() -> None:
    """The forward-only wrappers under ``torch.enable_grad()`` on CUDA inputs
    that require grad: each must raise (``_build.require_no_grad``) before it
    launches, as kernel 8 does."""
    from divergen_tpu_torch.ops import flash_attention as fa_mod
    from divergen_tpu_torch.ops import int8_matmul as i8_mod
    from divergen_tpu_torch.ops import ln_matmul as ln_mod
    from divergen_tpu_torch.ops.gn_conv import fused_gn_silu_conv3x3

    dev = torch.device("cuda")
    bf = dict(device=dev, dtype=torch.bfloat16)
    leaf = lambda *shape, **kw: torch.randn(*shape, **(kw or bf)).requires_grad_(True)
    i8 = lambda *shape: torch.randint(-127, 128, shape, device=dev, dtype=torch.int8)
    f32 = dict(device=dev, dtype=torch.float32)
    calls = {
        "flash_attention": lambda: fa_mod.flash_attention(*(leaf(2, 128, 64) for _ in range(3))),
        "flash_attention_packed": lambda: fa_mod.flash_attention_packed(leaf(2, 128, 384), 2),
        "flash_attention_relpos": lambda: fa_mod.flash_attention_relpos(
            *(leaf(2, 64, 80) for _ in range(3)), leaf(2, 8, 64, **f32), leaf(2, 8, 64, **f32),
            (8, 8)),
        "fused_ln_matmul": lambda: ln_mod.fused_ln_matmul(leaf(64, 128), leaf(128, 256),
                                                          leaf(128, **f32), leaf(128, **f32)),
        "int8_matmul_pallas": lambda: i8_mod.int8_matmul_pallas(
            i8(64, 128), leaf(64, 1, **f32), i8(128, 256), leaf(256, **f32)),
        "int8_matmul_fused_quant": lambda: i8_mod.int8_matmul_fused_quant(
            leaf(64, 128), i8(128, 256), leaf(256, **f32)),
        "fused_gn_silu_conv3x3": lambda: fused_gn_silu_conv3x3(
            leaf(1, 8, 8, 64), leaf(64, **f32), leaf(64, **f32), leaf(64, 64, 3, 3),
            leaf(64, **f32)),
    }
    with torch.enable_grad():
        for name, call in calls.items():
            try:
                call()
            except RuntimeError as e:
                if "forward only" not in str(e):
                    raise
                continue
            raise AssertionError(f"{name} ran under enable_grad on inputs that require grad")
    log(f"    under enable_grad each raises before it launches: {', '.join(calls)}")


def device_ms(fn, reps: int = 10) -> float:
    """Device time of ``fn`` in ms: its kernels' summed time under
    ``torch.profiler`` over ``reps`` calls after one warm-up, per call. A
    trace that caught no kernel is taken again; after six such traces the
    CUDA-event time of ``reps`` calls is returned instead, and said so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.self_device_time_total > 0 and "Memset" not in e.key)
        if total > 0:
            return total / 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    log("    (the profiler caught no kernel in six traces: this time is CUDA events')")
    return start.elapsed_time(end) / reps


def serving_kernel_phases(gen: torch.Generator):
    """The kernels of SDXL's int8 + fused-norm serving path against their plain
    versions on the same bf16 inputs, at the UNet's shapes plus ragged ones.

    int8 GEMMs (int8_matmul_fused_quant, int8_matmul_pallas): the int8
    operands and the int32 sums are exact, so the kernel must equal the plain
    version's result in every element (0 differing, or the phase fails); the
    relative L2 to the plain version's unrounded float32 result is printed too
    (bf16 rounding, about 1.6e-3). Every distinct GEMM shape of an int8 UNet
    call (``ops/int8_matmul.py:UNET_INT8_GEMMS``) runs on the kernel that takes it, with its
    device time, ``torch._int_mm``'s, the bound, the launches per UNet call and
    the plan's wave efficiency, and the sum of device time x launches per
    kernel is printed. The row-quantize pass of int8_matmul_fused_quant
    alone equals ``quantize_rows_fq_reference`` in every element (x_q and
    scale), bf16 and f32, on rows built to hit its edge cases. Norms
    (fused_group_norm, fused_layer_norm): the usual bounds against the float32
    plain version; at the main shape also the device times (profiler) of the
    kernel and of the PyTorch call, whose event times are the host's. Each of these four also
    with float32 x and output, the float32 UNet's path. The fused GroupNorm
    + SiLU + 3x3 conv (fused_gn_silu_conv3x3) at the fused ResBlock's level-0
    and level-2 shapes, ragged ones and float32 x, the usual bounds against
    its twin in float32; its apply pass (the fold within 1e-4 of the twin's,
    y to one bf16 ulp) and a NaN guard row past its output; then every
    kernel-8 shape of a fused UNet call (``ops/gn_conv.py:UNET_CONVS``)
    against the twin, with its device time, the PyTorch call's and the
    bound, summed per call. Every kernel: the same call twice gives the same
    bits. Yardsticks, never called by the port: ``torch._int_mm`` on the int8
    operands (int32 product only) beside the bf16 ``torch.matmul`` the int8
    path replaces; ``F.group_norm`` (+ ``F.silu``) on the NCHW view,
    ``F.layer_norm``, and ``F.group_norm`` + ``F.silu`` + ``F.conv2d``, in
    bf16."""
    import divergen_tpu_torch.ops.gn_conv as gc_mod
    import divergen_tpu_torch.ops.group_norm as gn_mod
    import divergen_tpu_torch.ops.int8_matmul as i8_mod
    import divergen_tpu_torch.ops.layer_norm as ln_mod
    from divergen_tpu_torch.ops import _build
    from divergen_tpu_torch.ops.quant import quantize_act, quantize_weight

    dev = torch.device("cuda")
    results = {}

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(kernel, err, kernel_fn, plain_fn, library_fn, ops, nbytes, peak, extra=None):
        """The first case of a kernel is its main-path shape: its times, the
        yardstick's time and the bound are the kernel's numbers."""
        ms, plain_ms, span = time_pair(kernel_fn, plain_fn)
        log(f"    kernel {ms:.4f} ms (min {span[0]:.4f}, max {span[1]:.4f} of its timed calls), "
            f"plain f32 {plain_ms:.4f} ms")
        if kernel not in results:
            b_ms, by = bound(ops, nbytes, peak)
            lib_ms = time_one(library_fn)
            log(f"    PyTorch call {lib_ms:.4f} ms; bound {b_ms:.4f} ms by {by} "
                f"({ops / 1e9:.2f} G operations, {nbytes / 1e6:.1f} MB)")
            if kernel == "fused_group_norm":  # host-bound event times
                log(f"    device time: kernel {device_ms(kernel_fn):.4f} ms, PyTorch call "
                    f"{device_ms(library_fn):.4f} ms")
            if extra is not None:
                log(f"    bf16 torch.matmul of the same shape {time_one(extra):.4f} ms")
            results[kernel] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                               "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    unet_gemms = i8_mod.UNET_INT8_GEMMS
    unet_ms = {kernel: 0.0 for kernel in unet_gemms}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def int8_case(kernel, m, k, n, dtype=torch.bfloat16):
        """``dtype``: x's (fused quant) and the output's; float32 is the
        float32 UNet's path."""
        x = randn(m, k, dtype=dtype)
        w = randn(n, k, scale=k ** -0.5, dtype=torch.float32)  # an nn.Linear weight
        w_q, w_s = quantize_weight(w.t())
        w_q = w_q.t().contiguous().t()  # (K, N) view of an (N, K) buffer, as the UNet holds it
        x_q, x_s = quantize_act(x)
        size = x.element_size()
        if kernel == "int8_matmul_fused_quant":
            run = lambda: i8_mod.int8_matmul_fused_quant(x, w_q, w_s, out_dtype=dtype)
            plain = lambda dt: i8_mod.int8_matmul_fused_quant_reference(x, w_q, w_s, dt)
            nbytes = size * m * k + k * n + 4.0 * n + size * m * n
        else:
            run = lambda: i8_mod.int8_matmul_pallas(x_q, x_s, w_q, w_s, out_dtype=dtype)
            plain = lambda dt: i8_mod.int8_matmul_pallas_reference(x_q, x_s, w_q, w_s, dt)
            nbytes = 1.0 * m * k + 4.0 * m + k * n + 4.0 * n + size * m * n
        got = run()
        ref = plain(dtype)
        name = f"{kernel} M={m} K={k} N={n} {str(dtype)[6:]}"
        err = compare(name, got, ref, rel_l2_bound=1e-3)
        ref32 = plain(torch.float32)
        rel32 = ((got.float() - ref32).norm() / ref32.norm()).item()
        differ = int((got != ref).sum())
        log(f"    elements that differ from the plain version's {str(dtype)[6:]} result: "
            f"{differ} of {got.numel()}; rel_l2 to its float32 result {rel32:.3g}")
        if differ:
            raise AssertionError(f"{name}: {differ} elements differ from the plain version")
        del ref, ref32
        same_bits(name, got, run)
        # nothing written past the output: the GEMM into the first M rows of a
        # buffer whose row M is NaN gives the same bits and leaves that row NaN
        # (a store past a row's end lands in the next row, the last one's here)
        a_q, a_s = (i8_mod._quantize_rows_fq(x) if kernel == "int8_matmul_fused_quant"
                    else (x_q, x_s.reshape(m)))
        guarded = torch.full((m + 1, n), float("nan"), device=dev, dtype=dtype)
        i8_mod._gemm(a_q, a_s, w_q.t(), w_s, guarded[:m])
        if not (torch.equal(guarded[:m], got) and bool(guarded[m].isnan().all())):
            raise AssertionError(f"{name}: the GEMM wrote outside its (M, N) output")
        log("    writes nothing past its output: True")
        del a_q, a_s, guarded
        w16 = w.bfloat16()
        record(kernel, err, run, lambda: plain(torch.float32), lambda: torch._int_mm(x_q, w_q),
               2.0 * m * k * n, nbytes, PEAK_INT8_OPS, extra=lambda: torch.matmul(x, w16.t()))
        launches = unet_gemms[kernel].get((m, k, n)) if dtype == torch.bfloat16 else None
        if launches:
            bn, ctas = i8_mod.gemm_plan(m, n, sms)
            tiles = -(-m // i8_mod.GEMM_BM) * -(-n // bn)
            waves = -(-tiles // ctas)
            dev_ms, lib_ms = device_ms(run), device_ms(lambda: torch._int_mm(x_q, w_q))
            b_ms, by = bound(2.0 * m * k * n, nbytes, PEAK_INT8_OPS)
            unet_ms[kernel] += dev_ms * launches
            log(f"    UNet shape: device {dev_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms by {by}, {launches} launches per UNet call; tiles {bn} wide, "
                f"{tiles} on {ctas} blocks, wave efficiency "
                f"{m * n / (sms * waves * i8_mod.GEMM_BM * bn):.3f}")
        torch.cuda.empty_cache()

    log("kernel phase: int8_matmul_fused_quant")
    # level-2 ff_geglu (the main shape), then the UNet's other shapes for this
    # kernel, then a ragged case: M, N and K off every tile, N odd
    fused_shapes = [shape for shape in unet_gemms["int8_matmul_fused_quant"]
                    if shape != (4096, 1280, 10240)]
    for m, k, n in ((4096, 1280, 10240), *fused_shapes, (1000, 656, 1001)):
        int8_case("int8_matmul_fused_quant", m, k, n)
    # float32 x and output (the float32 UNet): level-1 attn1_qkv at B = 1,
    # ragged, and N % 8 == 4 (a row's last block of 8 columns half outside it)
    for m, k, n in ((4096, 640, 1920), (1000, 656, 1001), (1000, 656, 1004)):
        int8_case("int8_matmul_fused_quant", m, k, n, torch.float32)
    log("kernel phase: int8_matmul_pallas")
    # level-2 ff_out (K 5120, over the fused kernel's limit) and the
    # cross-attention attn2_kv over the 77 text tokens (M = 4 x 77) at both
    # levels, which the JAX package leaves to XLA; then a tiny ragged case
    for m, k, n in ((4096, 5120, 1280), (308, 2048, 2560), (308, 2048, 1280), (77, 48, 3)):
        int8_case("int8_matmul_pallas", m, k, n)
    for m, k, n in ((308, 2048, 2560), (77, 48, 3), (77, 48, 12)):  # float32 output
        int8_case("int8_matmul_pallas", m, k, n, torch.float32)
    for kernel, ms in unet_ms.items():
        calls = sum(unet_gemms[kernel].values())
        if calls != SERVING_LAUNCHES[kernel]:
            raise AssertionError(f"{kernel}: UNET_INT8_GEMMS counts {calls} launches a UNet "
                                 f"call, SERVING_LAUNCHES {SERVING_LAUNCHES[kernel]}")
        log(f"  {kernel}: device time x launches per int8 UNet call, summed over its {calls} "
            f"launches: {ms:.3f} ms")

    log("kernel phase: the row-quantize pass of int8_matmul_fused_quant")
    # rows: random, all zero, absmax below 1.27e-10 and below 1e-12 (the two
    # scale formulas part there), absmax 127 with exact .5 ties (scale 1),
    # values a random scale puts within an ulp of .5 ties, and +-absmax (the
    # clip's edge); the main shape, the K 2560 shape and a ragged one
    for (m, k), dtype in (((4096, 1280), torch.bfloat16), ((4096, 1280), torch.float32),
                          ((16384, 2560), torch.bfloat16), ((1000, 656), torch.float32)):
        x = torch.randn((m, k), generator=gen, device=dev)
        x[1] = 0.0
        x[2] *= 1e-11
        x[3] *= 1e-13
        x[4] = (torch.arange(k, device=dev) % 254 - 127).float() + 0.5
        x[4, 0] = 127.0
        half_ties = (torch.randint(-126, 127, (m - 8, k), generator=gen, device=dev) + 0.5)
        x[8:] = torch.where(torch.rand((m - 8, k), generator=gen, device=dev) < 0.25,
                            half_ties * x[8:].abs().amax(dim=1, keepdim=True) / 127, x[8:])
        x[5, 7] = -x[5].abs().max() * 2
        x = x.to(dtype)
        got_q, got_s = i8_mod._quantize_rows_fq(x)
        ref_q, ref_s = i8_mod.quantize_rows_fq_reference(x)
        bad_q = int((got_q != ref_q).sum())
        bad_s = int((got_s != ref_s.reshape(-1)).sum())
        ms = device_ms(lambda: i8_mod._quantize_rows_fq(x))
        log(f"  quantize rows M={m} K={k} {str(dtype)[6:]}: x_q elements that differ {bad_q} "
            f"of {got_q.numel()}, scales that differ {bad_s} of {m}; device {ms:.4f} ms "
            f"(bound {1e3 * (x.numel() * (x.element_size() + 1) + 4 * m) / PEAK_BYTES_PER_S:.4f} "
            "ms by bytes)")
        if bad_q or bad_s:
            raise AssertionError("the row-quantize pass differs from quantize_rows_fq_reference")
        del x, got_q, got_s, ref_q, ref_s
        torch.cuda.empty_cache()

    log("kernel phase: fused_group_norm")
    # ResBlock norm at level 0 (with SiLU), a level-2 transformer norm
    # (without), then ragged: W = 7, and C = 36 (not a multiple of 8; 4 groups);
    # float32 x: C = 7680 (two channel tiles) and C = 36. Each: the usual
    # bounds against the float32 twin, the same bits twice, and the C entry
    # point into a buffer whose element after the output is NaN.
    lib = _build.lib()
    if lib.dg_group_norm_threads() != gn_mod.NORM_THREADS:
        raise AssertionError(f"the group norm kernel's blocks take {lib.dg_group_norm_threads()} "
                             f"threads at most, norm_plan assumes {gn_mod.NORM_THREADS}")

    def gn_inputs(b, h, w, c, dtype):
        x = randn(b, h, w, c, scale=2.0, dtype=dtype) + 0.5
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        bias = 0.1 * torch.randn(c, generator=gen, device=dev)
        return x, scale, bias

    def gn_library(x, scale, bias, groups, silu):
        nchw = x.permute(0, 3, 1, 2)  # a view: channels-last memory
        s16, b16 = scale.to(x.dtype), bias.to(x.dtype)

        def library():
            y = F.group_norm(nchw, groups, s16, b16, 1e-6)
            return F.silu(y) if silu else y
        return library

    def gn_guarded(x, scale, bias, groups, silu, got, name):
        b, h, w, c = x.shape
        plan = gn_mod.norm_plan(b, h * w, c)
        part = torch.empty((b, plan.splits, plan.ctiles, 2, groups), device=dev)
        buf = torch.full((x.numel() + 1,), float("nan"), device=dev, dtype=x.dtype)
        _build.check(lib.dg_group_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(), buf.data_ptr(), b,
            h * w, c, groups, plan.tile_vecs, plan.rows, plan.ctiles, plan.splits, 1e-6, int(silu),
            int(x.dtype == torch.float32), torch.cuda.current_stream().cuda_stream),
            "group norm kernel launch")
        if not (torch.equal(buf[:-1].view(x.shape), got) and bool(buf[-1].isnan())):
            raise AssertionError(f"{name}: the kernel wrote outside its output")
        log(f"    writes nothing past its output (plan {tuple(plan)}): True")

    def gn_checked(b, h, w, c, silu, dtype):
        x, scale, bias = gn_inputs(b, h, w, c, dtype)
        groups = math.gcd(32, c)
        run = lambda: gn_mod.fused_group_norm(x, scale, bias, 32, 1e-6, silu)
        plain = lambda: gn_mod.group_norm_reference(x.float(), scale, bias, groups, 1e-6, silu)
        name = f"group_norm B={b} H={h} W={w} C={c} silu={silu} {str(dtype)[6:]}"
        got = run()
        err = compare(name, got, plain())
        same_bits(name, got, run)
        gn_guarded(x, scale, bias, groups, silu, got, name)
        return x, run, plain, gn_library(x, scale, bias, groups, silu), err

    for (b, h, w, c), silu, dtype in (((4, 128, 128, 320), True, torch.bfloat16),
                                      ((4, 32, 32, 1280), False, torch.bfloat16),
                                      ((2, 5, 7, 96), True, torch.bfloat16),
                                      ((2, 9, 11, 36), True, torch.bfloat16),
                                      ((2, 16, 16, 7680), True, torch.float32),
                                      ((2, 9, 11, 36), False, torch.float32)):
        x, run, plain, library, err = gn_checked(b, h, w, c, silu, dtype)
        record("fused_group_norm", err, run, plain, library,
               x.numel() * (9.0 if silu else 5.0), x.element_size() * 2.0 * x.numel() + 8.0 * c,
               PEAK_F32_FLOPS)
        del x, run, plain, library
    # every shape of an int8 UNet call's 46 launches (ops/group_norm.py:
    # UNET_GROUP_NORMS), bf16 as that call runs them and float32 as the float32
    # UNet would: held as above, then the device time of the kernel beside
    # F.group_norm (+ F.silu) in x's dtype and the bound, and the sums over the
    # call's launches
    for dtype in (torch.bfloat16, torch.float32):
        unet = {"kernel": 0.0, "F.group_norm": 0.0, "bound": 0.0}
        for (b, h, w, c, silu), launches in gn_mod.UNET_GROUP_NORMS.items():
            x, run, plain, library, err = gn_checked(b, h, w, c, silu, dtype)
            results["fused_group_norm"]["max_abs_err"] = max(
                results["fused_group_norm"]["max_abs_err"], err)
            dev_ms, lib_ms = device_ms(run), device_ms(library)
            nbytes = x.element_size() * 2.0 * x.numel() + 8.0 * c
            b_ms, by = bound(x.numel() * (9.0 if silu else 5.0), nbytes, PEAK_F32_FLOPS)
            for key, t in (("kernel", dev_ms), ("F.group_norm", lib_ms), ("bound", b_ms)):
                unet[key] += t * launches
            log(f"    device {dev_ms:.4f} ms, F.group_norm{' + F.silu' if silu else ''} "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms by {by} ({nbytes / 1e6:.1f} MB, "
                f"{nbytes / dev_ms / 1e9:.0f} GB/s); {launches} launches a UNet call")
            del x, run, plain, library
            torch.cuda.empty_cache()
        log(f"  fused_group_norm {str(dtype)[6:]}: device time x launches per UNet call, summed "
            f"over its {sum(gn_mod.UNET_GROUP_NORMS.values())} launches: "
            + ", ".join(f"{key} {ms:.4f} ms" for key, ms in unet.items()))
        if dtype == torch.bfloat16:
            results["fused_group_norm"]["unet_device_ms"] = unet["kernel"]

    log("kernel phase: fused_layer_norm")
    # the UNet's transformer LayerNorms (rows of 4096 x 1280 and 16384 x 640:
    # 180 and 30 launches an int8 UNet call, each with its device time beside
    # F.layer_norm's and the bound, summed over the call, since their event
    # times are the host's), then C not a multiple of 128 (1000) and C not a
    # multiple of 8 (333); float32 x: the vector path (1280) and the any-C
    # path (333)
    ln_launches = {(4096, 1280): 180, (16384, 640): 30}
    ln_unet = {"kernel": 0.0, "F.layer_norm": 0.0, "bound": 0.0}
    for rows, c, dtype in ((4096, 1280, torch.bfloat16), (16384, 640, torch.bfloat16),
                           (4096, 1000, torch.bfloat16), (777, 333, torch.bfloat16),
                           (4096, 1280, torch.float32), (777, 333, torch.float32)):
        x = randn(rows, c, scale=3.0, dtype=dtype) + 1.0
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        beta = 0.1 * torch.randn(c, generator=gen, device=dev)
        run = lambda: ln_mod.fused_layer_norm(x, gamma, beta, 1e-5)
        plain = lambda: ln_mod.layer_norm_reference(x.float(), gamma, beta, 1e-5)
        name = f"layer_norm rows={rows} C={c} {str(dtype)[6:]}"
        got = run()
        err = compare(name, got, plain())
        same_bits(name, got, run)
        g16, b16 = gamma.bfloat16(), beta.bfloat16()
        library = lambda: F.layer_norm(x, (c,), g16, b16, 1e-5)
        record("fused_layer_norm", err, run, plain, library, 8.0 * x.numel(),
               4.0 * x.numel() + 8.0 * c, PEAK_F32_FLOPS)
        launches = ln_launches.get((rows, c)) if dtype == torch.bfloat16 else None
        if launches:
            dev_ms, lib_ms = device_ms(run), device_ms(library)
            b_ms, by = bound(8.0 * x.numel(), 4.0 * x.numel() + 8.0 * c, PEAK_F32_FLOPS)
            for key, t in (("kernel", dev_ms), ("F.layer_norm", lib_ms), ("bound", b_ms)):
                ln_unet[key] += t * launches
            log(f"    device {dev_ms:.4f} ms, F.layer_norm {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"by {by}; {launches} launches per int8 UNet call")
    log("  fused_layer_norm: device time x launches per int8 UNet call, summed over its 210 "
        f"launches: kernel {ln_unet['kernel']:.4f} ms, F.layer_norm "
        f"{ln_unet['F.layer_norm']:.4f} ms, bound {ln_unet['bound']:.4f} ms")

    log("kernel phase: fused_gn_silu_conv3x3")
    # the fused ResBlock's norm -> SiLU -> conv at level 0 (C 320) and at
    # level 2's widest input (the up path's concatenation, C 2560 -> 1280);
    # ragged: C = 48 (24 groups, not gcd's 16) on a 12 x 20 map, C = 36 (not a
    # multiple of 8: the masked element path, 18 groups) to an odd Co; float32
    # x. Plain: the twin on the same inputs in float32 (bf16 y and weight, an
    # f32 conv, TF32 off). Yardstick: F.group_norm + F.silu + F.conv2d in bf16
    # on channels-last views, what the port's default ResBlock runs.
    def gn_conv_case(b, h, w, c, co, dtype):
        x = randn(b, h, w, c, scale=2.0, dtype=dtype) + 0.5
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        gbias = 0.1 * torch.randn(c, generator=gen, device=dev)
        weight = randn(co, c, 3, 3, scale=(9 * c) ** -0.5)  # a bf16 UNet's Conv weight
        cbias = randn(co, scale=0.1)
        run = lambda: gc_mod.fused_gn_silu_conv3x3(x, scale, gbias, weight, cbias)
        plain = lambda: gc_mod.fused_gn_silu_conv3x3_reference(x.float(), scale, gbias, weight,
                                                               cbias)
        groups = gc_mod.group_count(c)
        nchw = x.permute(0, 3, 1, 2).bfloat16()  # channels-last memory
        s16, b16 = scale.bfloat16(), gbias.bfloat16()
        w16 = weight.contiguous(memory_format=torch.channels_last)

        def library():
            y = F.silu(F.group_norm(nchw, groups, s16, b16, 1e-6))
            return F.conv2d(y, w16, cbias, padding=1)

        name = f"gn_silu_conv3x3 B={b} H={h} W={w} C={c} -> {co} {str(dtype)[6:]}"
        return x, scale, gbias, weight, cbias, run, plain, library, name

    def bf16_ulps(a, b):
        """|a - b| in units in the last place of bf16 (signs and zeros ordered)."""
        def ordered(t):
            i = t.contiguous().view(torch.int16).int()
            return torch.where(i < 0, -(i & 0x7FFF), i)
        return (ordered(a) - ordered(b)).abs()

    for (b, h, w, c), co, dtype in (((4, 128, 128, 320), 320, torch.bfloat16),
                                    ((4, 32, 32, 2560), 1280, torch.bfloat16),
                                    ((1, 12, 20, 48), 16, torch.bfloat16),
                                    ((2, 9, 11, 36), 21, torch.bfloat16),
                                    ((2, 32, 32, 640), 320, torch.float32)):
        x, scale, gbias, weight, cbias, run, plain, library, name = gn_conv_case(
            b, h, w, c, co, dtype)
        got = run()
        err = compare(name, got, plain())
        same_bits(name, got, run)
        # the apply pass alone: its fold against the twin's (f32 moments in
        # another order: within 1e-4 of the largest), and y against the twin's
        # formula bf16(silu(x a + s)) on the pass's own a and s, in float64, to
        # one bf16 ulp (on the twin's a and s, y near 0 would differ by more:
        # a last-place change of a or s is many ulps of a tiny x a + s)
        groups = gc_mod.group_count(c)
        y, fa, fs = gc_mod._apply(x, scale, gbias, groups, 1e-6)
        ref_a, ref_s = gc_mod.gn_silu_fold_reference(x, scale, gbias, groups, 1e-6)
        fold_err = max(((fa - ref_a).abs().max() / ref_a.abs().max()).item(),
                       ((fs - ref_s).abs().max() / ref_s.abs().max()).item())
        t = x.double() * fa.double()[:, None, None, :] + fs.double()[:, None, None, :]
        ulps = bf16_ulps(y[..., :c], (t * torch.sigmoid(t)).bfloat16()).max().item()
        pad_zero = bool((y[..., c:] == 0).all())
        log(f"    apply pass: fold within {fold_err:.3g} of the twin's, y within {ulps} bf16 "
            f"ulp of bf16(silu(x a + s)), channels past C zero: {pad_zero}")
        if fold_err > 1e-4 or ulps > 1 or not pad_zero:
            raise AssertionError(f"{name}: the apply pass disagrees with the twin")
        # nothing written past the output: the GEMM into the first B H W rows
        # of a buffer whose next row is NaN gives the same bits, that row NaN
        m_pix = b * h * w
        guard = torch.full((m_pix + 1, co), float("nan"), device=dev, dtype=dtype)
        gc_mod._conv_gemm(y, gc_mod.weight_operand(weight), cbias.float(),
                          guard[:m_pix].view(b, h, w, co))
        if not (torch.equal(guard[:m_pix].view(b, h, w, co), got)
                and bool(guard[m_pix].isnan().all())):
            raise AssertionError(f"{name}: the GEMM wrote outside its output")
        log("    writes nothing past its output: True")
        del t, y, fa, fs, ref_a, ref_s, guard
        record("fused_gn_silu_conv3x3", err, run, plain, library, 2.0 * m_pix * 9 * c * co,
               x.element_size() * m_pix * (c + co) + 2.0 * co * 9 * c + 4.0 * (2 * c + co),
               PEAK_BF16_FLOPS)
        torch.cuda.empty_cache()

    # every kernel-8 shape of a fused UNet call (gn_conv.UNET_CONVS), bf16:
    # held against the twin, then device times of the kernel (its four
    # launches and the weight copy) and of the PyTorch call, and the bound
    unet_sum = {"kernel": 0.0, "PyTorch call": 0.0, "bound": 0.0}
    for (b, h, w, c, co), launches in gc_mod.UNET_CONVS.items():
        x, scale, gbias, weight, cbias, run, plain, library, name = gn_conv_case(
            b, h, w, c, co, torch.bfloat16)
        compare(name, run(), plain())
        dev_ms, lib_ms = device_ms(run), device_ms(library)
        flop = 2.0 * b * h * w * 9 * c * co
        b_ms = 1e3 * flop / PEAK_BF16_FLOPS
        for key, t in (("kernel", dev_ms), ("PyTorch call", lib_ms), ("bound", b_ms)):
            unet_sum[key] += t * launches
        log(f"    UNet shape: device {dev_ms:.4f} ms ({flop / dev_ms / 1e9:.0f} TFLOP/s), "
            f"PyTorch call {lib_ms:.4f} ms, bound {b_ms:.4f} ms, {launches} launches per UNet "
            f"call")
        del x, weight
        torch.cuda.empty_cache()
    log("  fused_gn_silu_conv3x3: device time x launches per fused UNet call, summed over its "
        f"{sum(gc_mod.UNET_CONVS.values())} launches: "
        + ", ".join(f"{key} {ms:.3f} ms" for key, ms in unet_sum.items()))
    return results


def small_models():
    """Narrow UNet and VAE, bf16 through the kernels vs float32 plain on the CPU.

    Bound: relative L2 <= 3e-2. The whole network runs in bf16 on the card
    (every dense and conv rounds its output), so the error is larger than
    one kernel's; 3e-2 still fails any kernel that is wrong."""
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL
    from divergen_tpu_torch.pipeline.generation.vae import VAEDecoder

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    kw = dict(block_channels=(64, 128), transformer_depths=(0, 1), head_dim=64,
              context_dim=64, layers_per_block=1, text_time=False)
    ref_unet = flax_init_(UNetSDXL(**kw), g).eval()
    unet = UNetSDXL(dtype=torch.bfloat16, device=dev, **kw).eval()
    unet.load_state_dict(ref_unet.state_dict())
    lat = torch.randn((2, 32, 32, 4), generator=g)
    t = torch.tensor([500.0, 20.0])
    ctx = torch.randn((2, 77, 64), generator=g)
    with torch.inference_mode():
        got = unet(lat.to(dev), t.to(dev), ctx.to(dev))
        ref = ref_unet(lat, t, ctx)
    compare("small UNet (d=64 packed attention, GEGLU) vs f32 CPU", got.cpu(), ref,
            rel_l2_bound=3e-2)

    ref_vae = flax_init_(VAEDecoder(channels=(32, 512)), g).eval()
    vae = VAEDecoder(channels=(32, 512), dtype=torch.bfloat16, device=dev).eval()
    vae.load_state_dict(ref_vae.state_dict())
    z = torch.randn((1, 16, 16, 4), generator=g)
    with torch.inference_mode():
        got = vae(z.to(dev))
        ref = ref_vae(z)
    compare("small VAE (d=512 mid attention) vs f32 CPU", got.cpu(), ref, rel_l2_bound=3e-2)

    # a narrow SAM: 8x8 tokens, d = 80, layer 0 windowed, layer 1 global through
    # flash_attention_relpos; both layers through fused_ln_matmul. The plain
    # float32 twin on the CPU uses neither. The relative-position tables are
    # zero-initialised, so they are drawn here, or the bias would not matter.
    from divergen_tpu_torch.pipeline.segmentation.sam import SAM, SAMImageEncoder

    kw = dict(img_size=128, dim=160, layers=2, heads=2, window=4, global_layers=(1,))
    ref_sam = flax_init_(SAM(SAMImageEncoder(**kw)), g).eval()
    with torch.no_grad():
        for name, prm in ref_sam.named_parameters():
            if "rel_pos" in name:
                prm.normal_(0.0, 0.3, generator=g)
    sam = SAM(SAMImageEncoder(dtype=torch.bfloat16, ln_gemm=True, flash_attn=True, device=dev,
                              **kw), device=dev).eval()
    sam.load_state_dict(ref_sam.state_dict())
    imgs = torch.rand((2, 128, 128, 3), generator=g) * 255
    pts = torch.tensor([[10.0, 10], [118, 10], [10, 118], [118, 118]]).expand(2, 4, 2)
    lbl = torch.ones((2, 4), dtype=torch.int32)
    with torch.inference_mode():
        masks, iou = sam(imgs.to(dev), pts.to(dev), lbl.to(dev))
        ref_masks, ref_iou = ref_sam(imgs, pts, lbl)
    compare("small SAM (d=80 relpos attention, fused LN GEMMs) mask logits vs f32 CPU",
            masks.cpu(), ref_masks, rel_l2_bound=3e-2, max_abs_bound=1e-1)
    compare("small SAM IoU vs f32 CPU", iou.cpu(), ref_iou, rel_l2_bound=3e-2,
            max_abs_bound=1e-1)


F32_MODEL_BOUNDS = dict(rel_l2_bound=1e-4, max_abs_bound=1e-3)


def small_float32_models():
    """A narrow float32 ``UNetSDXL()`` (its default ``ln_gemm="geglu"``:
    kernels 1 and 2 on float32) and a narrow float32 SAM with ``ln_gemm``
    and its global layer through the relative-position kernel, on the card,
    each against the same weights in float32 on the CPU. Bound: relative L2
    <= 1e-4 and max |error| <= 1e-3 * max |reference| (float32 sums in
    another order through a whole network; a bf16 operand anywhere gives
    ~1e-2). Each kernel on the path must have launched."""
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.ops.flash_attention import (
        flash_attention_packed,
        flash_attention_relpos,
    )
    from divergen_tpu_torch.ops.ln_matmul import fused_ln_matmul
    from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL
    from divergen_tpu_torch.pipeline.segmentation.sam import SAM, SAMImageEncoder

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(23)
    kw = dict(block_channels=(64, 128), transformer_depths=(0, 1), head_dim=64,
              context_dim=64, layers_per_block=1, text_time=False)
    ref_unet = flax_init_(UNetSDXL(**kw), g).eval()
    unet = UNetSDXL(dtype=torch.float32, device=dev, **kw).eval()
    unet.load_state_dict(ref_unet.state_dict())
    lat = torch.randn((2, 32, 32, 4), generator=g)
    t = torch.tensor([500.0, 20.0])
    ctx = torch.randn((2, 77, 64), generator=g)
    wrappers = (fused_ln_matmul, flash_attention_packed)  # cross-attention: plain (77 keys)
    before = [w.launches for w in wrappers]
    with torch.inference_mode():
        got = unet(lat.to(dev), t.to(dev), ctx.to(dev))
        ran = {w.__name__: w.launches - b0 for w, b0 in zip(wrappers, before)}
        ref = ref_unet(lat, t, ctx)
    log(f"    float32 UNet's kernel launches: {ran}")
    if got.dtype != torch.float32 or not all(ran.values()):
        raise AssertionError(f"float32 UNet: dtype {got.dtype}, launches {ran}")
    compare('small float32 UNetSDXL() (ln_gemm="geglu", card) vs f32 CPU', got.cpu(), ref,
            **F32_MODEL_BOUNDS)

    kw = dict(img_size=128, dim=160, layers=2, heads=2, window=4, global_layers=(1,))
    ref_sam = flax_init_(SAM(SAMImageEncoder(**kw)), g).eval()
    with torch.no_grad():
        for name, prm in ref_sam.named_parameters():
            if "rel_pos" in name:
                prm.normal_(0.0, 0.3, generator=g)
    sam = SAM(SAMImageEncoder(dtype=torch.float32, ln_gemm=True, flash_attn=True, device=dev,
                              **kw), device=dev).eval()
    sam.load_state_dict(ref_sam.state_dict())
    imgs = torch.rand((2, 128, 128, 3), generator=g) * 255
    pts = torch.tensor([[10.0, 10], [118, 10], [10, 118], [118, 118]]).expand(2, 4, 2)
    lbl = torch.ones((2, 4), dtype=torch.int32)
    wrappers = (fused_ln_matmul, flash_attention_relpos)
    before = [w.launches for w in wrappers]
    with torch.inference_mode():
        masks, iou = sam(imgs.to(dev), pts.to(dev), lbl.to(dev))
        ran = {w.__name__: w.launches - b0 for w, b0 in zip(wrappers, before)}
        ref_masks, ref_iou = ref_sam(imgs, pts, lbl)
    log(f"    float32 SAM's kernel launches: {ran}")
    if masks.dtype != torch.float32 or not all(ran.values()):
        raise AssertionError(f"float32 SAM: dtype {masks.dtype}, launches {ran}")
    compare("small float32 SAM (ln_gemm, relpos global attention, card) mask logits vs f32 CPU",
            masks.cpu(), ref_masks, **F32_MODEL_BOUNDS)
    compare("small float32 SAM IoU vs f32 CPU", iou.cpu(), ref_iou, **F32_MODEL_BOUNDS)


def small_serving_unets():
    """The narrow UNet of ``small_models`` with SDXL's serving options.

    (1) ``quant``, ``fused_ln`` and ``fused_gn``, bf16 on the card through the
    int8 GEMM and norm kernels, against the same weights with the same flags
    in float32 on the CPU: mean |diff| / mean |ref| < 0.1, the serving bound
    of ``tests/test_quant.py`` (every int8 rounding tie can fall either way
    after bf16 arithmetic). (2) ``fused_ln`` and ``fused_gn`` only, against
    the plain ``GroupNorm32`` / ``LayerNorm`` UNet on the card, both bf16:
    relative L2 <= 3e-2, the whole-network bound of ``small_models`` (each
    norm rounds to bf16 a rounding apart from its plain twin, and every later
    layer rounds again: 1.3e-2 measured on an H100). (3) ``conv_matmul=
    "fused"`` in bf16 on the card, every ResBlock through
    fused_gn_silu_conv3x3, against the same weights in float32 on the CPU on
    the default path: relative L2 <= 3e-2, as in ``small_models``. (4) A
    float32 ``UNetSDXL(quant, fused_ln, fused_gn, conv_matmul="fused")`` on
    the card, so kernels 7 to 11 and the packed attention read and write
    float32, against its float32 CPU copy with the same flags under the bound
    of (1); each of the six kernels must have launched."""
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.ops.flash_attention import flash_attention_packed
    from divergen_tpu_torch.ops.gn_conv import fused_gn_silu_conv3x3
    from divergen_tpu_torch.ops.group_norm import fused_group_norm
    from divergen_tpu_torch.ops.int8_matmul import int8_matmul_fused_quant, int8_matmul_pallas
    from divergen_tpu_torch.ops.layer_norm import fused_layer_norm
    from divergen_tpu_torch.pipeline.generation.unet import ResBlock, UNetSDXL, quantize_unet_

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(17)
    kw = dict(block_channels=(64, 128), transformer_depths=(0, 1), head_dim=64,
              context_dim=64, layers_per_block=1, text_time=False)
    serving = dict(quant=True, fused_ln=True, fused_gn=True)
    ref_unet = flax_init_(UNetSDXL(**kw, **serving), g).eval()
    unet = UNetSDXL(dtype=torch.bfloat16, device=dev, **kw, **serving).eval()
    unet.load_state_dict(ref_unet.state_dict())
    quantize_unet_(ref_unet)
    quantize_unet_(unet)
    lat = torch.randn((2, 32, 32, 4), generator=g)
    t = torch.tensor([500.0, 20.0])
    ctx = torch.randn((2, 77, 64), generator=g)
    with torch.inference_mode():
        got = unet(lat.to(dev), t.to(dev), ctx.to(dev)).cpu()
        ref = ref_unet(lat, t, ctx)

    def int8_bound(what, got, ref):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: non-finite output")
        rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
        ok = rel < 0.1
        log(f"  {what} vs f32 CPU with the same flags: mean |diff| / mean |ref| {rel:.5f} "
            f"[{'ok' if ok else 'FAIL'}]")
        if not ok:
            raise AssertionError(f"{what}: disagrees with its f32 CPU copy")

    int8_bound("small UNet (quant + fused_ln + fused_gn)", got, ref)

    fused = UNetSDXL(dtype=torch.bfloat16, device=dev, fused_ln=True, fused_gn=True, **kw).eval()
    plain = UNetSDXL(dtype=torch.bfloat16, device=dev, **kw).eval()
    fused.load_state_dict(ref_unet.state_dict())
    plain.load_state_dict(ref_unet.state_dict())
    with torch.inference_mode():
        x, tt, cc = lat.to(dev), t.to(dev), ctx.to(dev)
        compare("small UNet fused_ln + fused_gn vs plain GroupNorm32 / LayerNorm (bf16, card)",
                fused(x, tt, cc), plain(x, tt, cc), rel_l2_bound=3e-2)
    del fused, plain

    state = ref_unet.state_dict()
    float_cpu = UNetSDXL(**kw).eval()
    float_cpu.load_state_dict(state)
    fused_rb = UNetSDXL(dtype=torch.bfloat16, device=dev, conv_matmul="fused", **kw).eval()
    fused_rb.load_state_dict(state)
    before = fused_gn_silu_conv3x3.launches
    with torch.inference_mode():
        got = fused_rb(x, tt, cc).cpu()
        ref = float_cpu(lat, t, ctx)
    want = 2 * sum(isinstance(m, ResBlock) for m in fused_rb.modules())  # two convs each
    if fused_gn_silu_conv3x3.launches - before != want:
        raise AssertionError(f"small fused-ResBlock UNet: expected {want} fused_gn_silu_conv3x3 "
                             f"launches, got {fused_gn_silu_conv3x3.launches - before}")
    compare('small UNet conv_matmul="fused" (bf16, card) vs f32 CPU default path', got, ref,
            rel_l2_bound=3e-2)

    every = dict(serving, conv_matmul="fused")
    ref_all = UNetSDXL(**kw, **every).eval()
    unet32 = UNetSDXL(dtype=torch.float32, device=dev, **kw, **every).eval()
    ref_all.load_state_dict(state)
    unet32.load_state_dict(state)
    quantize_unet_(ref_all)
    quantize_unet_(unet32)
    wrappers = (int8_matmul_fused_quant, int8_matmul_pallas, fused_layer_norm, fused_group_norm,
                fused_gn_silu_conv3x3, flash_attention_packed)
    before = [w.launches for w in wrappers]
    with torch.inference_mode():
        got = unet32(x, tt, cc)
        ran = {w.__name__: w.launches - b0 for w, b0 in zip(wrappers, before)}
        if got.dtype != torch.float32:
            raise AssertionError(f"float32 UNet wrote {got.dtype}")
        ref = ref_all(lat, t, ctx)
    log(f"    float32 UNet's kernel launches: {ran}")
    if not all(ran.values()):
        raise AssertionError(f"float32 UNet: a kernel did not launch: {ran}")
    int8_bound('small float32 UNet (quant + fused_ln + fused_gn + conv_matmul="fused", card)',
               got.cpu(), ref)


NARROW_SWIN = (32, (2, 2, 2, 1), (1, 2, 4, 8), 7, 0.0)  # embed, depths, heads (d = 32), window


def small_detector():
    """A narrow detector, bf16 on the card through the window-attention kernel
    (windows of 49 tokens, shifted and padded; 16 in the last stage) against
    the same weights in float32 on the CPU. Bounds: the pyramid features agree
    to relative L2 <= 3e-2 (a whole bf16 network, as for the other small
    models); the five best detections have scores within 0.05 of the CPU's
    five best, and at least three of their boxes meet a CPU detection with
    IoU >= 0.7 (NMS and top-k decide on scores a bf16 rounding apart, so not
    every detection need survive on both sides)."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.modeling.backbone import swin
    from divergen_tpu_torch.modeling.meta_arch.rcnn import build_model
    from divergen_tpu_torch.ops.window_attention import fused_window_attention_packed
    from divergen_tpu_torch.structures.boxes import pairwise_iou

    dev = torch.device("cuda")
    swin.SIZE2CONFIG["narrow"] = NARROW_SWIN
    cfg = graft_entry._small_cfg(backbone="swin", swin_size="narrow")
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
    canvas = (128, 160)
    g = torch.Generator().manual_seed(11)
    ref_model = graft_entry.fast_init_(build_model(cfg, input_size=canvas), g).eval()
    cfg.FP16 = True
    model = build_model(cfg, input_size=canvas, device=dev).eval()
    model.load_state_dict(ref_model.state_dict())
    images = torch.rand((2, *canvas, 3), generator=g) * 255
    sizes = torch.tensor([[128, 160], [100, 120]])
    before = fused_window_attention_packed.launches
    with torch.no_grad():
        feats = model.backbone_features(images.to(dev))
        ref_feats = ref_model.backbone_features(images)
    if fused_window_attention_packed.launches - before != 7:
        raise AssertionError("small detector: expected 7 window-attention launches")
    for name in ref_feats:
        compare(f"small detector {name} vs f32 CPU", feats[name].cpu(), ref_feats[name],
                rel_l2_bound=3e-2, max_abs_bound=1e-1)
    dets = model(images.to(dev), sizes.to(dev))
    ref = ref_model(images, sizes)
    for i in range(2):
        nv, nr = int(dets["valid"][i].sum()), int(ref["valid"][i].sum())
        if min(nv, nr) < 5:
            raise AssertionError(f"small detector image {i}: {nv} / {nr} detections")
        top = dets["scores"][i, :5].cpu()
        gap = (top - ref["scores"][i, :5]).abs().max().item()
        iou = pairwise_iou(dets["boxes"][i, :5].cpu(), ref["boxes"][i][ref["valid"][i]])
        matched = int((iou.max(dim=1).values >= 0.7).sum())
        ok = gap <= 0.05 and matched >= 3
        log(f"  small detector image {i}: {nv} detections (CPU {nr}); top-5 scores within "
            f"{gap:.4f}; {matched} of 5 boxes meet a CPU detection at IoU >= 0.7 "
            f"[{'ok' if ok else 'FAIL'}]")
        if not ok:
            raise AssertionError("small detector: detections disagree with the f32 CPU copy")


def slice_txt2img(tmp: str):
    from divergen_tpu_torch.pipeline.generation import txt2img
    from divergen_tpu_torch.utils.png import read_png

    prompts = os.path.join(tmp, "prompts")
    os.makedirs(prompts)
    with open(os.path.join(prompts, "7.txt"), "w") as f:
        f.write("a photo of a single red apple\n")
    out = os.path.join(tmp, "out")
    t0 = time.perf_counter()
    rc = txt2img.main(["--from_file", prompts, "--outdir", out, "--n_samples", "2",
                       "--max_batch_size", "2", "--height", "1024", "--width", "1024",
                       "--sampler", "dpmpp_2m", "--steps", str(STEPS)])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"txt2img.main returned {rc}")
    for name in ("7_0000000.png", "7_0000001.png"):
        img = read_png(os.path.join(out, "samples", "XL", name))
        if img.shape != (1024, 1024, 3):
            raise AssertionError(f"{name}: {img.shape}")
    log(f"  txt2img.main wrote 7_0000000.png, 7_0000001.png (1024x1024) in "
        f"{time.perf_counter() - t0:.1f} s (model build included)")


def slice_pipeline():
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.pipeline.generation.pipeline import SDXLPipeline
    from divergen_tpu_torch.pipeline.generation.text import SDXLTextEncoder
    from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL
    from divergen_tpu_torch.pipeline.generation.vae import VAEDecoder

    dev = torch.device("cuda")
    encoder = SDXLTextEncoder.random(seed=0, tiny=False, device=dev)
    prompts = ["a photo of a single red apple", "a photo of a single wooden chair"]
    ctx, pooled = encoder.encode(prompts)
    unc, unc_pooled = encoder.encode([""] * 2)
    gen = torch.Generator(device=dev)
    unet = flax_init_(UNetSDXL(dtype=torch.bfloat16, device=dev), gen.manual_seed(0))
    vae = flax_init_(VAEDecoder(dtype=torch.bfloat16, device=dev), gen.manual_seed(1))
    pipe = SDXLPipeline(unet, vae, steps=STEPS, sampler="dpmpp_2m")
    imgs = pipe.generate(gen.manual_seed(42), ctx, unc, pooled, unc_pooled, 1024, 1024)
    torch.cuda.synchronize()
    if tuple(imgs.shape) != (2, 1024, 1024, 3):
        raise AssertionError(f"images {tuple(imgs.shape)}")
    if not torch.isfinite(imgs).all() or imgs.min() < 0 or imgs.max() > 255:
        raise AssertionError("images not finite in [0, 255]")
    log(f"  SDXLPipeline.generate: images (2, 1024, 1024, 3), finite, "
        f"range [{imgs.min().item():.1f}, {imgs.max().item():.1f}], "
        f"std {imgs.float().std().item():.2f}")
    return encoder, pipe, (ctx, unc, pooled, unc_pooled), imgs


def timings(encoder, pipe, cond, card: str):
    ctx, unc, pooled, unc_pooled = cond

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    encoder.encode(["warm-up"])
    enc_s, _ = wall(lambda: encoder.encode(["a photo of a single red apple"]))
    gen = torch.Generator(device="cuda").manual_seed(1)
    lat0 = torch.randn((2, 128, 128, 4), generator=gen, device="cuda") * pipe._init_scale
    time_ids = torch.tensor([1024.0, 1024, 0, 0, 1024, 1024], device="cuda").expand(2, 6)
    runs = [wall(lambda: pipe.denoise(lat0, ctx, unc, pooled, unc_pooled, time_ids))
            for _ in range(3)]
    den_s = statistics.median(r[0] for r in runs)
    dec_s = statistics.median(wall(lambda: pipe.decode(runs[0][1]))[0] for _ in range(3))
    log(f"  CFG denoise step (B=2 images, UNet batch 4, 1024²): "
        f"{1000 * den_s / STEPS:.1f} ms/step, median of 3 {STEPS}-step runs [{card}]")
    log(f"  VAE decode (2 images, 1024², one at a time): {dec_s:.3f} s, median of 3 [{card}]")
    log(f"  text encode (CLIP-L + bigG, 1 prompt): {1000 * enc_s:.1f} ms [{card}]")


# Launches per UNet call of the serving kernels in UNetSDXL(quant, fused_ln,
# fused_gn) at SDXL-base widths. Transformer blocks: 10 at level 1 (C 640,
# 4096 tokens an image), 60 at level 2 (C 1280, 1024 tokens); 5 and 6 spatial
# transformers; 17 ResBlocks. At UNet batch 4:
# - int8_matmul_fused_quant: every GEMM with K <= 4096 and tileable M and N;
#   level 1: qkv, attn1_out, attn2_q, attn2_out, ff_geglu, ff_out (K 2560) per
#   block, 6 x 10, + proj_in/out 2 x 5; level 2: the same but ff_out, 5 x 60,
#   + 2 x 6: 60 + 10 + 300 + 12 = 382;
# - int8_matmul_pallas: level-2 ff_out (K 5120) 60 + attn2_kv (M = 4 x 77) 70;
# - fused_layer_norm: norm1, norm2, norm3 of 70 blocks (quant turns ln_gemm off);
# - fused_group_norm: 2 x 17 ResBlock norms + 11 transformer norms + norm_out.
SERVING_LAUNCHES = {"int8_matmul_fused_quant": 382, "int8_matmul_pallas": 130,
                    "fused_layer_norm": 210, "fused_group_norm": 46}
INT8_ONLY_LAUNCHES = {"int8_matmul_fused_quant": 382, "int8_matmul_pallas": 130,
                      "fused_layer_norm": 0, "fused_group_norm": 0}


def slice_txt2img_int8(tmp: str):
    """``txt2img.main --int8``: a ``quant`` UNet (no fused norms), two 1024² PNGs."""
    from divergen_tpu_torch.pipeline.generation import txt2img
    from divergen_tpu_torch.utils.png import read_png

    out = os.path.join(tmp, "out_int8")
    t0 = time.perf_counter()
    rc = txt2img.main(["--prompt", "a photo of a single red apple", "--outdir", out,
                       "--n_samples", "2", "--max_batch_size", "2", "--height", "1024",
                       "--width", "1024", "--sampler", "dpmpp_2m", "--steps", str(STEPS),
                       "--int8"])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"txt2img.main --int8 returned {rc}")
    for name in ("prompt_0000000.png", "prompt_0000001.png"):
        img = read_png(os.path.join(out, "samples", "XL", name))
        if img.shape != (1024, 1024, 3):
            raise AssertionError(f"{name}: {img.shape}")
    log(f"  txt2img.main --int8 wrote prompt_0000000.png, prompt_0000001.png (1024x1024) in "
        f"{time.perf_counter() - t0:.1f} s (model build included)")


def slice_serving_pipeline(pipe, cond, bf16_images):
    """``SDXLPipeline(int8=True)`` over ``UNetSDXL(quant, fused_ln, fused_gn)``
    with the bf16 pipeline's weights, VAE, conditioning and initial noise
    (seed 42), B = 2, 1024², DPM-Solver++ 2M. Returns the pipeline."""
    from divergen_tpu_torch.pipeline.generation.pipeline import SDXLPipeline
    from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL

    dev = torch.device("cuda")
    ctx, unc, pooled, unc_pooled = cond
    unet = UNetSDXL(dtype=torch.bfloat16, device=dev, quant=True, fused_ln=True, fused_gn=True)
    unet.load_state_dict(pipe.unet.state_dict())
    pipe8 = SDXLPipeline(unet, pipe.vae, steps=STEPS, sampler="dpmpp_2m", int8=True)
    gen = torch.Generator(device=dev).manual_seed(42)
    imgs = pipe8.generate(gen, ctx, unc, pooled, unc_pooled, 1024, 1024)
    torch.cuda.synchronize()
    if tuple(imgs.shape) != (2, 1024, 1024, 3):
        raise AssertionError(f"int8 images {tuple(imgs.shape)}")
    if not torch.isfinite(imgs).all() or imgs.min() < 0 or imgs.max() > 255:
        raise AssertionError("int8 images not finite in [0, 255]")
    diff = (imgs - bf16_images).abs().mean().item()
    log(f"  SDXLPipeline(int8=True) over UNetSDXL(quant, fused_ln, fused_gn): images "
        f"(2, 1024, 1024, 3), finite, range [{imgs.min().item():.1f}, {imgs.max().item():.1f}]; "
        f"mean |diff| from the bf16 pipeline's images on the same weights and noise "
        f"{diff:.3f} of 255 (a smoke number)")
    return pipe8


def wall_s(fn) -> float:
    """Seconds of ``fn`` on the host's clock, between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def denoise_in_turns(pipe, other, cond):
    """Three denoise runs of STEPS steps of each pipeline from the same
    latents, in turns (pipe, other, other, pipe, pipe, other): two lists of
    seconds."""
    ctx, unc, pooled, unc_pooled = cond
    gen = torch.Generator(device="cuda").manual_seed(1)
    lat0 = torch.randn((2, 128, 128, 4), generator=gen, device="cuda") * pipe._init_scale
    time_ids = torch.tensor([1024.0, 1024, 0, 0, 1024, 1024], device="cuda").expand(2, 6)
    times = {pipe: [], other: []}
    for order in ((pipe, other), (other, pipe), (pipe, other)):
        for p in order:
            times[p].append(wall_s(lambda: p.denoise(lat0, ctx, unc, pooled, unc_pooled,
                                                     time_ids)))
    return times[pipe], times[other]


def serving_timings(pipe, pipe8, cond, card: str):
    """One CFG step of the bf16 and of the int8 + fused-norm pipeline, in turns
    (bf16, int8, int8, bf16, ...), medians of 3 denoise runs of STEPS steps;
    the int8 run includes its once-per-call ``quantize_unet_``, timed alone
    too."""
    from divergen_tpu_torch.pipeline.generation.unet import quantize_unet_

    times = dict(zip((pipe, pipe8), denoise_in_turns(pipe, pipe8, cond)))
    quant_s = statistics.median(wall_s(lambda: quantize_unet_(pipe8.unet)) for _ in range(3))
    bf16_ms = 1000 * statistics.median(times[pipe]) / STEPS
    int8_ms = 1000 * statistics.median(times[pipe8]) / STEPS
    log(f"  CFG denoise step (B=2 images, UNet batch 4, 1024²): bf16 {bf16_ms:.1f} ms/step; "
        f"int8 + fused norms {int8_ms:.1f} ms/step, of which quantize_unet_ "
        f"{1000 * quant_s:.1f} ms once per {STEPS}-step call; median of 3 runs each, in turns "
        f"[{card}]")
    log("    every run, ms/step: bf16 "
        + ", ".join(f"{1000 * s / STEPS:.1f}" for s in times[pipe]) + "; int8 "
        + ", ".join(f"{1000 * s / STEPS:.1f}" for s in times[pipe8])
        + f"; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")


# Launches per UNet call of UNetSDXL(conv_matmul="fused") at SDXL-base widths:
# two fused_gn_silu_conv3x3 in each of the 17 ResBlocks; no fused_group_norm
# (fused_gn is off, and the fused ResBlocks would ignore it); the 70
# transformer blocks' packed self-attention and norm3 -> GEGLU as on the
# default path.
FUSED_RESBLOCK_LAUNCHES = {"fused_gn_silu_conv3x3": 34, "fused_group_norm": 0,
                           "flash_attention_packed": 70, "fused_ln_matmul": 70}
# ... of UNetSDXL(quant, fused_ln, fused_gn, conv_matmul="fused"): the
# SERVING_LAUNCHES with the 34 ResBlock norms moved into kernel 8
EVERY_OPTION_LAUNCHES = {"int8_matmul_fused_quant": 382, "int8_matmul_pallas": 130,
                         "fused_layer_norm": 210, "fused_group_norm": 12,
                         "fused_gn_silu_conv3x3": 34}


def slice_fused_resblocks(pipe, cond, bf16_images):
    """``SDXLPipeline`` over ``UNetSDXL(conv_matmul="fused")`` with the bf16
    pipeline's weights, VAE, conditioning and initial noise (seed 42), B = 2,
    1024², DPM-Solver++ 2M. Returns the pipeline."""
    from divergen_tpu_torch.pipeline.generation.pipeline import SDXLPipeline
    from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL

    dev = torch.device("cuda")
    ctx, unc, pooled, unc_pooled = cond
    unet = UNetSDXL(dtype=torch.bfloat16, device=dev, conv_matmul="fused")
    unet.load_state_dict(pipe.unet.state_dict())
    pipe_f = SDXLPipeline(unet, pipe.vae, steps=STEPS, sampler="dpmpp_2m")
    gen = torch.Generator(device=dev).manual_seed(42)
    imgs = pipe_f.generate(gen, ctx, unc, pooled, unc_pooled, 1024, 1024)
    torch.cuda.synchronize()
    if tuple(imgs.shape) != (2, 1024, 1024, 3):
        raise AssertionError(f"fused-ResBlock images {tuple(imgs.shape)}")
    if not torch.isfinite(imgs).all() or imgs.min() < 0 or imgs.max() > 255:
        raise AssertionError("fused-ResBlock images not finite in [0, 255]")
    diff = (imgs - bf16_images).abs().mean().item()
    log(f'  SDXLPipeline over UNetSDXL(conv_matmul="fused"): images (2, 1024, 1024, 3), finite, '
        f"range [{imgs.min().item():.1f}, {imgs.max().item():.1f}]; mean |diff| from the bf16 "
        f"pipeline's images on the same weights and noise {diff:.3f} of 255 (a smoke number)")
    return pipe_f


def every_option_unet_call(pipe, cond, snapshot):
    """One UNet call, batch 4 (the CFG batch of B = 2 at 1024²), of
    ``UNetSDXL(quant, fused_ln, fused_gn, conv_matmul="fused")`` on the bf16
    pipeline's weights after ``quantize_unet_``; the output finite, and the
    launches of every kernel of ``EVERY_OPTION_LAUNCHES`` exact. Returns the
    call's launches, by the keys of ``snapshot()`` (``main``'s counts)."""
    from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL, quantize_unet_

    dev = torch.device("cuda")
    ctx, unc, pooled, unc_pooled = cond
    unet = UNetSDXL(dtype=torch.bfloat16, device=dev, quant=True, fused_ln=True, fused_gn=True,
                    conv_matmul="fused")
    unet.load_state_dict(pipe.unet.state_dict())
    quantize_unet_(unet)
    gen = torch.Generator(device=dev).manual_seed(5)
    args = (torch.randn((4, 128, 128, 4), generator=gen, device=dev),
            torch.full((4,), 500.0, device=dev), torch.cat([unc, ctx]),
            torch.cat([unc_pooled, pooled]),
            torch.tensor([1024.0, 1024, 0, 0, 1024, 1024], device=dev).expand(4, 6))
    before = snapshot()
    with torch.inference_mode():
        out = unet(*args)
    torch.cuda.synchronize()
    counts = {k: n - before.get(k, 0) for k, n in snapshot().items()}
    if tuple(out.shape) != (4, 128, 128, 4) or not torch.isfinite(out).all():
        raise AssertionError("every-option UNet: output not finite (4, 128, 128, 4)")
    wrong = {k: (counts[k], n) for k, n in EVERY_OPTION_LAUNCHES.items() if counts[k] != n}
    if wrong:
        raise AssertionError(f"every-option UNet call: launches (got, expected) {wrong}")
    log(f'  one UNet call of UNetSDXL(quant, fused_ln, fused_gn, conv_matmul="fused"), batch 4: '
        f"output finite, launches as expected: { {k: counts[k] for k in EVERY_OPTION_LAUNCHES} }")
    return counts


def fused_timings(pipe, pipe_f, cond, card: str):
    """One CFG step of the bf16 and of the fused-ResBlock pipeline in turns,
    medians of 3 denoise runs of STEPS steps each."""
    t_bf16, t_fused = denoise_in_turns(pipe, pipe_f, cond)
    bf16_ms = 1000 * statistics.median(t_bf16) / STEPS
    fused_ms = 1000 * statistics.median(t_fused) / STEPS
    log(f"  CFG denoise step (B=2 images, UNet batch 4, 1024²): bf16 {bf16_ms:.1f} ms/step; "
        f'conv_matmul="fused" {fused_ms:.1f} ms/step; median of 3 runs each, in turns [{card}]')
    log("    every run, ms/step: bf16 " + ", ".join(f"{1000 * s / STEPS:.1f}" for s in t_bf16)
        + '; fused ' + ", ".join(f"{1000 * s / STEPS:.1f}" for s in t_fused))


SAM_KERNEL_LAUNCHES = {"flash_attention_relpos": 4, "fused_ln_matmul": 36}  # per forward
CATEGORIES = {7: "apple", 11: "chair"}


def count_sam_launches(fn, forwards: int, what: str):
    """Run ``fn`` and require the launches of ``forwards`` SAM ViT-H forwards:
    4 global layers through flash_attention_relpos, 32 fc1 + 4 qkv GEMMs
    through fused_ln_matmul."""
    from divergen_tpu_torch.ops.flash_attention import flash_attention_relpos
    from divergen_tpu_torch.ops.ln_matmul import fused_ln_matmul

    wrappers = (flash_attention_relpos, fused_ln_matmul)
    before = [w.launches for w in wrappers]
    out = fn()
    for w, b0 in zip(wrappers, before):
        want = forwards * SAM_KERNEL_LAUNCHES[w.__name__]
        if w.launches - b0 != want:
            raise AssertionError(f"{what}: {w.__name__} launched {w.launches - b0} times, "
                                 f"expected {want}")
    return out


def slice_corner_masks(tmp: str):
    from divergen_tpu_torch.pipeline.segmentation import corner_masks
    from divergen_tpu_torch.utils.png import read_png

    in_dir = os.path.join(tmp, "out", "samples")  # one category, "XL", two PNGs
    out_dir = os.path.join(tmp, "masks")
    t0 = time.perf_counter()
    rc = count_sam_launches(
        lambda: corner_masks.main(["--in_dir", in_dir, "--out_dir", out_dir, "--model_type",
                                   "vit_h", "--batch", "4", "--img_size", "1024"]),
        1, "corner_masks.main")
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"corner_masks.main returned {rc}")
    fracs = []
    for name in ("7_0000000.png", "7_0000001.png"):
        m = read_png(os.path.join(out_dir, "XL", name))
        if m.shape != (1024, 1024) or not np.isin(m, (0, 255)).all():
            raise AssertionError(f"mask {name}: shape {m.shape}, values {np.unique(m)[:4]}")
        fracs.append(float((m == 255).mean()))
    log(f"  corner_masks.main wrote 2 masks (1024x1024, values in {{0, 255}}, instance "
        f"fractions {fracs[0]:.3f}, {fracs[1]:.3f}) in {time.perf_counter() - t0:.1f} s "
        f"(model build included)")


def slice_chain(encoder, pipe, card: str):
    """One producer round gen → SAM → CLIP into the pool, then the compositor.
    Returns the function that takes the smoke timings of SAM, CLIP and the
    compositor, to be called once the launch counts have been read."""
    from divergen_tpu_torch.modeling.text.clip import preprocess_images
    from divergen_tpu_torch.modeling.text.tokenizer import SimpleTokenizer
    from divergen_tpu_torch.ops.copy_paste import paste_instances_boxframe
    from divergen_tpu_torch.pipeline.filteration.core import ClipEncoder, clip_preprocess_np
    from divergen_tpu_torch.pipeline.generation.pipeline import images_to_uint8
    from divergen_tpu_torch.pipeline.orchestrator import InstanceProducer, LivePool
    from divergen_tpu_torch.pipeline.segmentation import corner_masks

    dev = torch.device("cuda")
    args = corner_masks.build_argparser().parse_args(["--in_dir", "-", "--out_dir", "-"])
    sam = corner_masks.build_sam(args, dev)  # SAM.vit_h(bf16, ln_gemm, flash_attn)
    batch, size = args.batch, args.img_size
    pts = torch.from_numpy(np.tile(corner_masks.corner_points(size, args.corner_margin),
                                   (batch, 1, 1))).to(dev)
    lbl = torch.ones((batch, 4), dtype=torch.int32, device=dev)
    clip = ClipEncoder("ViT-L/14", batch=16, device=dev)
    tokenizer = SimpleTokenizer(merges=[])
    unc, unc_pooled = encoder.encode([""] * 2)
    gen = torch.Generator(device=dev)
    errors = []

    def guarded(fn):
        def run(*a):
            try:
                return fn(*a)
            except BaseException as e:  # the producer is a thread: keep the error
                errors.append(e)
                raise
        return run

    def generate_fn(cat, rng):
        ctx, pooled = encoder.encode([f"a photo of a single {CATEGORIES[cat]}"] * 2)
        imgs = pipe.generate(gen.manual_seed(int(rng.integers(2**31))), ctx, unc, pooled,
                             unc_pooled, size, size)
        return np.stack(images_to_uint8(imgs))

    def mask_fn(images):
        x = torch.zeros((batch, size, size, 3), device=dev)
        x[: len(images)] = torch.from_numpy(images).to(dev)
        inst = count_sam_launches(
            lambda: corner_masks.predict_instance_masks(sam, x, pts, lbl), 1, "mask_fn")
        return inst[: len(images)].cpu().numpy()

    def score_fn(images, masks, cat):
        white = np.where(masks[..., None], images, 255).astype(np.uint8)
        feats = clip.encode_images(np.stack([clip_preprocess_np(im) for im in white]))
        text = clip.encode_texts(tokenizer.tokenize([f"a photo of a single {CATEGORIES[cat]}"]))
        return (feats @ text.T)[:, 0]

    pool = LivePool(patch_size=128, train_size=(896, 896), max_samples=20)
    # random weights: any score and any non-empty mask is accepted
    prod = InstanceProducer(pool, list(CATEGORIES), guarded(generate_fn), guarded(mask_fn),
                            guarded(score_fn), clip_threshold=-1.0, area_range=(0.0, 1.01),
                            max_rounds=1)
    t0 = time.perf_counter()
    prod.start()
    prod.join(timeout=600)
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    if prod.is_alive() or prod.produced + prod.rejected != 2 * len(CATEGORIES):
        raise AssertionError(f"producer: alive {prod.is_alive()}, produced {prod.produced}, "
                             f"rejected {prod.rejected}")
    if prod.produced == 0:
        raise AssertionError("producer: every instance mask was empty")
    log(f"  InstanceProducer round: produced {prod.produced}, rejected {prod.rejected} "
        f"(empty masks), pool {pool.counts()} in {time.perf_counter() - t0:.1f} s")

    b, p, n, s, hw = 8, 4, 8, 28, 896
    rng = np.random.default_rng(0)
    samples = [pool.make_paste_sample(rng, max_pastes=p) for _ in range(b)]
    n_pastes = int(sum(smp["patch_valid"].sum() for smp in samples))
    stack = lambda key: torch.from_numpy(np.stack([smp[key] for smp in samples])).to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    paste_args = (
        torch.rand((b, hw, hw, 3), generator=g, device=dev) * 255,
        torch.ones((b, n, s, s), device=dev),
        torch.tensor([100.0, 100.0, 300.0, 300.0], device=dev).expand(b, n, 4),
        torch.zeros((b, n), dtype=torch.int32, device=dev),
        torch.ones((b, n), dtype=torch.bool, device=dev),
        torch.zeros((b, n), dtype=torch.int32, device=dev),
        stack("patches"), stack("patch_boxes"), stack("patch_classes"), stack("patch_valid"),
        stack("patch_flip"),
    )
    out = paste_instances_boxframe(*paste_args)
    torch.cuda.synchronize()
    shapes = {"image": (b, hw, hw, 3), "masks": (b, n + p, s, s), "boxes": (b, n + p, 4),
              "classes": (b, n + p), "valid": (b, n + p), "instance_source": (b, n + p)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"paste {key}: {tuple(out[key].shape)} != {shape}")
        if out[key].is_floating_point() and not torch.isfinite(out[key]).all():
            raise AssertionError(f"paste {key}: non-finite")
    pasted = int(out["valid"][:, n:].sum())
    if n_pastes == 0 or pasted == 0:
        raise AssertionError(f"paste: {n_pastes} patches sampled, {pasted} valid after pasting")
    log(f"  paste_instances_boxframe: B={b} P={p} N={n} S={s} at {hw}²; {n_pastes} patches "
        f"sampled from the pool, {pasted} valid after pasting")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def chain_timings():
        imgs = torch.rand((batch, size, size, 3), generator=g, device=dev) * 255
        with torch.inference_mode():
            sam_s = statistics.median(wall(lambda: sam(imgs, pts, lbl)) for _ in range(3))
            x16 = preprocess_images(torch.rand((16, 224, 224, 3), generator=g, device=dev) * 255)
            clip.vision(x16)  # warm-up at this batch
            clip_s = statistics.median(wall(lambda: clip.vision(x16)) for _ in range(3))
        paste_s = statistics.median(wall(lambda: paste_instances_boxframe(*paste_args))
                                    for _ in range(3))
        log(f"  SAM ViT-H forward (B={batch}, 1024², bf16, fused encoder): "
            f"{sam_s / batch:.4f} s/image, median of 3 [{card}]")
        log(f"  CLIP ViT-L/14 vision (B=16, 224², float32): {1000 * clip_s / 16:.3f} "
            f"ms/image, median of 3 [{card}]")
        log(f"  compositor (B={b} x P={p} at {hw}²): {1000 * paste_s / (b * p):.3f} ms per "
            f"pasted instance, median of 3 [{card}]")

    return chain_timings


SWIN_L_BLOCKS = 24  # depths 2 / 2 / 18 / 2: one window attention per block
# window-attention launches a Swin-L forward (and backward) makes at each stage,
# by its windows at B = 2, 896², window 12
SWIN_L_STAGE_LAUNCHES = {722: 2, 200: 2, 50: 18, 18: 2}


def slice_detector(card: str):
    """The detector's inference forward through ``graft_entry``: the small
    Swin-T detector, then the flagship model at full width. Returns the function that takes the smoke timings."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.ops.mask_paste import paste_masks
    from divergen_tpu_torch.ops.nms import nms_mask
    from divergen_tpu_torch.ops.window_attention import fused_window_attention_packed

    def check(dets, batch, k, what):
        shapes = {"prop_idx": (batch, k), "boxes": (batch, k, 4), "scores": (batch, k),
                  "classes": (batch, k), "valid": (batch, k), "mask_logits": (batch, k, 28, 28)}
        for key, shape in shapes.items():
            if tuple(dets[key].shape) != shape:
                raise AssertionError(f"{what} {key}: {tuple(dets[key].shape)} != {shape}")
        valid = dets["valid"]
        for key in ("boxes", "scores", "mask_logits"):
            if not torch.isfinite(dets[key].float()[valid]).all():
                raise AssertionError(f"{what} {key}: non-finite under valid")
        if not valid.any(dim=1).all():
            raise AssertionError(f"{what}: an image without a detection")
        return [int(n) for n in valid.sum(dim=1)]

    model, (images, sizes) = graft_entry.entry()
    if next(model.parameters()).dtype != torch.float32:
        raise AssertionError("entry(): the model does not compute in float32")
    before = fused_window_attention_packed.launches
    dets = model(images, sizes)
    torch.cuda.synchronize()
    launched = fused_window_attention_packed.launches - before
    if launched != 12:
        raise AssertionError(f"entry(): {launched} window-attention launches, not 12")
    n_det = check(dets, 1, 16, "entry()")
    # the same seeded model and image on the CPU, float32 as the JAX entry():
    # the same detections, scores within 1e-3, boxes within 1e-2 pixels
    cpu_model, (cpu_images, cpu_sizes) = graft_entry.entry(device="cpu")
    with torch.no_grad():
        feats = model.backbone_features(images)
        ref_feats = cpu_model.backbone_features(cpu_images)
        ref = cpu_model(cpu_images, cpu_sizes)
    for name in ref_feats:
        compare(f"entry() float32 {name} vs CPU", feats[name].cpu(), ref_feats[name],
                **F32_MODEL_BOUNDS)
    valid, ref_valid = dets["valid"].cpu(), ref["valid"]
    score_gap = (dets["scores"].cpu() - ref["scores"])[valid].abs().max().item()
    box_gap = (dets["boxes"].cpu() - ref["boxes"])[valid].abs().max().item()
    same = torch.equal(valid, ref_valid) and torch.equal(dets["classes"].cpu()[valid],
                                                         ref["classes"][ref_valid])
    ok = same and score_gap <= 1e-3 and box_gap <= 1e-2
    log(f"  entry() float32 vs CPU: the same {int(valid.sum())} detections and classes: {same}, "
        f"max |score diff| {score_gap:.3g}, max |box diff| {box_gap:.3g} px "
        f"[{'ok' if ok else 'FAIL'}]")
    if not ok:
        raise AssertionError("entry(): detections disagree with the CPU's")
    log(f"  graft_entry.entry(): Swin-T detector, 128², float32: {n_det[0]} detections, "
        f"{launched} fused_window_attention_packed launches")
    del model, dets, cpu_model, feats

    t0 = time.perf_counter()
    model, (images, sizes) = graft_entry.flagship_entry()
    torch.cuda.synchronize()
    log(f"  flagship detector built with seeded weights in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    before, syncs = fused_window_attention_packed.launches, nms_mask.host_syncs
    dets = model(images, sizes)
    torch.cuda.synchronize()
    launched = fused_window_attention_packed.launches - before
    syncs = nms_mask.host_syncs - syncs
    if launched != SWIN_L_BLOCKS:
        raise AssertionError(f"flagship forward: {launched} window-attention launches, "
                             f"expected {SWIN_L_BLOCKS}")
    n_det = check(dets, 2, 300, "flagship forward")
    size = tuple(int(v) for v in sizes[0])
    keep = dets["valid"][0]
    pasted = paste_masks(torch.sigmoid(dets["mask_logits"][0][keep].float()),
                         dets["boxes"][0][keep], size)
    if (tuple(pasted.shape) != (n_det[0], *size) or not ((pasted == 0) | (pasted == 1)).all()
            or not pasted.any()):
        raise AssertionError(f"paste_masks: shape {tuple(pasted.shape)}, or not a binary mask")
    log(f"  flagship forward (Swin-L 896², B=2, bf16, 1453 classes): detections {n_det} of 300, "
        f"score range [{dets['scores'][dets['valid']].min().item():.3f}, "
        f"{dets['scores'].max().item():.3f}], {launched} fused_window_attention_packed launches, "
        f"{syncs} host syncs in NMS; paste_masks {tuple(pasted.shape)}, "
        f"{pasted.mean().item():.2e} of the pixels set")
    del pasted, dets

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), out

    def detector_timings():
        with torch.no_grad():
            model(images, sizes)  # warm-up
            fwd = statistics.median(wall(lambda: model(images, sizes))[0] for _ in range(3))
            runs = [wall(lambda: model.backbone_features(images)) for _ in range(3)]
            feats = runs[0][1]
            bb = statistics.median(r[0] for r in runs)
            runs = [wall(lambda: model.proposals(feats, sizes)) for _ in range(3)]
            props = runs[0][1]
            pr = statistics.median(r[0] for r in runs)
            roi = statistics.median(wall(lambda: model.roi_heads.inference(feats, props, sizes))[0]
                                    for _ in range(3))
        log(f"  detector forward (B=2, 896², bf16): {fwd:.1f} ms; backbone + FPN {bb:.1f} ms, "
            f"proposals + NMS {pr:.1f} ms, ROI heads {roi:.1f} ms (host clock, medians of 3) "
            f"[{card}]")

    return detector_timings


# (h, w) of the serving slice's images: LVIS-like 640 x 480, 480 x 640 and
# 500 x 333, and 1024 x 683, which the 896 canvas crops (889 x 1333 resized)
SERVING_SIZES = ((480, 640), (640, 480), (333, 500), (683, 1024))
SERVING_BATCH, SERVING_DEPTH, SERVING_IMAGES = 8, 2, 16
SYNTH_LVIS = "synthetic_lvis_flagship"


def synthetic_image(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """Noise with a few flat-coloured rectangles, uint8 RGB."""
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    for _ in range(4):
        y0, x0 = rng.randint(0, h - h // 4), rng.randint(0, w - w // 4)
        img[y0:y0 + rng.randint(h // 8, h // 4), x0:x0 + rng.randint(w // 8, w // 4)] = \
            rng.randint(0, 256, 3)
    return img


def serving_float32_card_vs_cpu(tmp: str) -> None:
    """(a) ``Predictor`` on the small Swin-T detector in float32, on the card
    and on the CPU, the same seeded ``state_dict`` and PNG file."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.data.dataset_mapper import read_image
    from divergen_tpu_torch.evaluation.lvis_evaluator import paste_mask_prob
    from divergen_tpu_torch.modeling.meta_arch.rcnn import build_model
    from divergen_tpu_torch.predictor import Predictor
    from divergen_tpu_torch.utils.png import write_png
    from divergen_tpu_torch.utils.transfer import to_host

    cfg = graft_entry._small_cfg(backbone="swin")
    cfg.INPUT.TEST_SIZE, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 128, 96, 128
    ref = build_model(cfg, input_size=(128, 128), device="cpu")
    graft_entry.fast_init_(ref, torch.Generator().manual_seed(graft_entry.SEED))
    params = ref.state_dict()
    path = os.path.join(tmp, "small.png")
    write_png(path, synthetic_image(np.random.RandomState(5), 96, 128))
    image = read_image(path)
    card, cpu = (Predictor(cfg, params, score_thresh=0.0, device=d) for d in ("cuda", "cpu"))
    raw = []
    for p in (card, cpu):
        x, size, _ = p.preprocess(image)
        raw.append(to_host(p._infer(x[None], size[None])))
    got, want = raw
    valid = want["valid"]
    same = bool(np.array_equal(got["valid"], valid))
    gaps = {k: float(np.abs(got[k][valid] - want[k][valid]).max() / np.abs(want[k][valid]).max())
            for k in ("boxes", "scores")}
    ok = same and valid.any() and max(gaps.values()) <= 1e-4
    log(f"  (a) Predictor, Swin-T float32, 128² canvas, card vs CPU: the same {int(valid.sum())} "
        f"valid slots: {same}; max |diff| / max |ref|: boxes {gaps['boxes']:.3g}, scores "
        f"{gaps['scores']:.3g} (bound 1e-4) [{'ok' if ok else 'FAIL'}]")
    if not ok:
        raise AssertionError("the float32 Predictor's raw outputs disagree card vs CPU")
    res_card, res_cpu = card(image), cpu(image)
    keep = valid[0] & (want["scores"][0] >= 0.0)
    probs = 1 / (1 + np.exp(-want["mask_logits"][0][keep]))
    differ = close = 0
    for m_card, m_cpu, prob, box in zip(res_card["masks"], res_cpu["masks"], probs,
                                        res_cpu["boxes"]):
        diff = m_card != m_cpu
        differ += int(diff.sum())
        close += int((np.abs(paste_mask_prob(prob, box, 96, 128)[diff] - 0.5) <= 1e-4).sum())
    ok = res_card["masks"].shape == res_cpu["masks"].shape and differ == close
    log(f"  (a) post-processed masks {res_cpu['masks'].shape}: {differ} pixels differ, {close} of "
        f"them within 1e-4 of 0.5 [{'ok' if ok else 'FAIL'}]")
    if not ok:
        raise AssertionError("the float32 Predictor's masks disagree card vs CPU")


PAIRED_SHARE = 0.98  # of an image's detections, batch 8 against batch 1 (bf16)


def same_detections(got: dict, want: dict, tol: float = 1e-2,
                    share: float = PAIRED_SHARE) -> dict:
    """Two results of one image, compared to bf16 tolerance. Each of
    ``want``'s detections (highest score first) is paired with an unpaired
    one of ``got`` of its class whose box is within ``tol`` of max |ref|
    (the nearest). ``ok``: as many detections, at least ``share`` of them
    paired, and the pairs' scores within ``tol`` of max |ref|.

    Why not every detection: a batch of 8 rounds some bf16 GEMMs of the
    heads otherwise than a batch of 1 (the pyramid features are equal bit
    for bit), and on random weights the 300 kept scores span 0.84-0.89, so
    detections that tie within that rounding trade places at the proposals'
    top-k and NMS and at the cut of the top 300: 297-300 of 300 paired per
    image on the H100, the pairs' scores within 8.3e-4 of max |ref|."""
    n_got, n_want = len(got["scores"]), len(want["scores"])
    out = dict(ok=n_got == n_want, pairs=0, box_gap=0.0, score_gap=0.0)
    if not n_want or not n_got:
        return out
    box_scale = max(float(np.abs(want["boxes"]).max()), 1e-12)
    score_scale = max(float(np.abs(want["scores"]).max()), 1e-12)
    dist = np.abs(want["boxes"][:, None] - got["boxes"][None]).max(-1) / box_scale
    dist[want["classes"][:, None] != got["classes"][None]] = np.inf
    used = np.zeros(n_got, bool)
    for i in np.argsort(-want["scores"], kind="stable"):
        d = np.where(used, np.inf, dist[i])
        j = int(np.argmin(d))
        if d[j] <= tol:
            used[j] = True
            out["pairs"] += 1
            out["box_gap"] = max(out["box_gap"], float(d[j]))
            out["score_gap"] = max(out["score_gap"], abs(float(got["scores"][j])
                                                         - float(want["scores"][i])) / score_scale)
    out["ok"] = out["ok"] and out["pairs"] >= share * n_want and out["score_gap"] <= tol
    return out


def clipped(res: dict, hw) -> dict:
    boxes = res["boxes"].copy()
    boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, hw[1])
    boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, hw[0])
    return dict(res, boxes=boxes)


def slice_serving(card: str, tmp: str):
    """The detector's serving and evaluation path (``predictor.py``,
    ``engine/eval_loop.py``), parts (a)-(c), (e) and (f); returns the function
    that runs (d), ``AsyncPredictor``, after the launch counts were read."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from divergen_tpu_torch.data.dataset_mapper import read_image
    from divergen_tpu_torch.data.datasets.lvis import lvis_meta_from_json, register_lvis_instances
    from divergen_tpu_torch.data.datasets.synthetic_lvis import write_synthetic_lvis
    from divergen_tpu_torch.engine import eval_loop
    from divergen_tpu_torch.engine.checkpoint import Checkpointer
    from divergen_tpu_torch.engine.train_loop import TrainState
    from divergen_tpu_torch.evaluation.lvis_evaluator import LVISEvaluator, print_csv_format
    from divergen_tpu_torch.ops.nms import nms_mask
    from divergen_tpu_torch.ops.window_attention import fused_window_attention_packed as wa
    from divergen_tpu_torch.predictor import (AsyncPredictor, BatchPredictor, Predictor,
                                              VisualizationDemo)
    from divergen_tpu_torch.utils.png import read_png, write_png
    from divergen_tpu_torch.utils.visualizer import save_visualization

    serving_float32_card_vs_cpu(tmp)

    # (b) the flagship Predictor at full width on four PNG images
    model, _ = graft_entry.flagship_entry()
    cfg = graft_entry.flagship_cfg()
    pred = Predictor(cfg, model.state_dict())
    del model
    torch.cuda.empty_cache()
    rng = np.random.RandomState(graft_entry.SEED)
    images = []
    for k, (h, w) in enumerate(SERVING_SIZES):
        path = os.path.join(tmp, f"serve_{k}.png")
        write_png(path, synthetic_image(rng, h, w))
        images.append(read_image(path))
    pred(images[0])  # warm-up
    results, walls, syncs, parts = [], [], [], []
    for img in images:
        h, w = img.shape[:2]
        bf16 = lambda: sum(n for (entry, _), n in wa.bodies.items() if entry != "dg_attention_f32")
        before, body_before, sync_before = wa.launches, bf16(), nms_mask.host_syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pred(img)
        walls.append(1e3 * (time.perf_counter() - t0))
        parts.append({k: 1e3 * v for k, v in pred.last_timing.items()})
        launched, on_bf16 = wa.launches - before, bf16() - body_before
        syncs.append(nms_mask.host_syncs - sync_before)
        boxes = res["boxes"]
        inside = bool(((boxes[:, [0, 2]] >= 0) & (boxes[:, [0, 2]] <= w)).all()
                      and ((boxes[:, [1, 3]] >= 0) & (boxes[:, [1, 3]] <= h)).all())
        ok = (launched == on_bf16 == SWIN_L_BLOCKS and res["masks"].shape == (len(boxes), h, w)
              and inside and np.isfinite(res["scores"]).all())
        log(f"  (b) flagship Predictor, {w}x{h}: {len(boxes)} detections, masks "
            f"{res['masks'].shape}, boxes inside the image: {inside}, {launched} window-attention "
            f"launches ({on_bf16} on the bf16 body), {syncs[-1]} NMS host syncs, "
            f"{walls[-1]:.1f} ms [{'ok' if ok else 'FAIL'}]")
        if not ok:
            raise AssertionError("flagship Predictor: launches, mask shape or boxes wrong")
        results.append(res)
    split = {k: statistics.mean(p[k] for p in parts) for k in parts[0]}
    log(f"  (b) flagship Predictor: {statistics.mean(walls):.1f} ms per image (wall; "
        f"preprocess {split['preprocess_s']:.1f}, forward with the copies "
        f"{split['forward_s']:.1f}, postprocess with the mask paste {split['postprocess_s']:.1f}), "
        f"{1e3 / statistics.mean(walls):.2f} images/s, {statistics.mean(syncs):.1f} NMS host "
        f"syncs per image [{card}]")

    # (c) BatchPredictor: batch 8, depth 2, 16 images, against Predictor's results
    stream = [images[k % len(images)] for k in range(SERVING_IMAGES)]
    bp = BatchPredictor(pred, batch_size=SERVING_BATCH, depth=SERVING_DEPTH)
    list(bp(stream[:SERVING_BATCH]))  # warm-up at batch 8
    bp.host_syncs.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_out = list(bp(stream))
    wall = time.perf_counter() - t0
    checks = []
    for k, res in enumerate(batch_out):
        ref = results[k % len(images)]
        checks.append(same_detections(clipped(res, stream[k].shape[:2]), ref))
        if not checks[-1]["ok"]:
            raise AssertionError(f"BatchPredictor image {k}: {len(res['scores'])} detections "
                                 f"against Predictor's {len(ref['scores'])}: {checks[-1]}")
    log(f"  (c) BatchPredictor (batch {SERVING_BATCH}, depth {SERVING_DEPTH}, "
        f"{SERVING_IMAGES} images) against Predictor: {sum(c['pairs'] for c in checks)} of "
        f"{sum(len(r['scores']) for r in batch_out)} detections paired (same class, box within "
        f"1e-2 of max |ref|), the least per image {min(c['pairs'] for c in checks)} (bound "
        f"{PAIRED_SHARE:.0%}); max |diff| / max |ref| of the pairs: boxes "
        f"{max(c['box_gap'] for c in checks):.3g}, scores "
        f"{max(c['score_gap'] for c in checks):.3g}; {SERVING_IMAGES / wall:.2f} images/s (no "
        f"masks), NMS host syncs per batch {bp.host_syncs} [{card}]")

    # (e) do_test on a synthetic LVIS-format set of 16 PNG images, the
    # flagship's 1453 categories, through Checkpointer.save -> do_test(resume)
    files = write_synthetic_lvis(os.path.join(tmp, "lvis"),
                                 [SERVING_SIZES[k % 4] for k in range(SERVING_IMAGES)],
                                 cfg.MODEL.ROI_HEADS.NUM_CLASSES, seed=graft_entry.SEED,
                                 category_ids=range(1, 61))
    for reg in (DatasetCatalog, MetadataCatalog):
        reg.remove(SYNTH_LVIS)
    register_lvis_instances(SYNTH_LVIS, lvis_meta_from_json(files["json_file"]),
                            files["json_file"], files["image_root"])
    test_cfg = cfg.clone()
    test_cfg.DATASETS.TEST = (SYNTH_LVIS,)
    test_cfg.OUTPUT_DIR = os.path.join(tmp, "output")
    t0 = time.perf_counter()
    Checkpointer(test_cfg.OUTPUT_DIR).save(1, TrainState(step=1, model=pred.model, optimizer=None))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = eval_loop.do_test(test_cfg, resume=True)[SYNTH_LVIS]
    test_s = time.perf_counter() - t0
    timing = eval_loop.inference_on_dataset.last_timing
    keys = ("AP", "APr", "APc", "APf")
    finite = all(math.isfinite(metrics[t][k]) for t in ("bbox", "segm") for k in keys)
    log(f"  (e) do_test on {SERVING_IMAGES} synthetic LVIS images "
        f"({cfg.MODEL.ROI_HEADS.NUM_CLASSES} categories, checkpoint "
        f"saved in {save_s:.1f} s, do_test {test_s:.1f} s): "
        + "; ".join(f"{t} " + ", ".join(f"{k} {metrics[t][k]:.4f}" for k in keys)
                    for t in ("bbox", "segm"))
        + f" [{'ok' if finite else 'FAIL'}]")
    log(f"  (e) s per image: total {timing['total_s_per_image']:.4f}, data "
        f"{timing['data_s_per_image']:.4f}, compute {timing['compute_s_per_image']:.4f} "
        f"(after {min(5, timing['images'])} warm-up images) [{card}]")
    if not finite:
        raise AssertionError("do_test: a non-finite AP")
    with open(files["json_file"]) as f:
        gt = json.load(f)
    control = LVISEvaluator(SYNTH_LVIS)
    for a in gt["annotations"]:
        control._predictions.append({"image_id": a["image_id"], "category_id": a["category_id"],
                                     "bbox": a["bbox"], "score": 1.0,
                                     "segmentation": control._ann_rle(a, gt)})
    ctrl = control.evaluate()
    ok = all(ctrl[t]["AP"] == 1.0 for t in ("bbox", "segm"))
    log(f"  (e) control, the ground truth as predictions: bbox AP {ctrl['bbox']['AP']}, segm AP "
        f"{ctrl['segm']['AP']} [{'ok' if ok else 'FAIL'}]")
    log("\n".join("    " + line for line in print_csv_format(ctrl).splitlines()[:3]))
    if not ok:
        raise AssertionError("the ground-truth control does not score AP 1")

    # (f) VisualizationDemo writes a PNG at the image's size
    names = lvis_meta_from_json(files["json_file"])["thing_classes"]
    _, vis = VisualizationDemo(pred, names).run_on_image(images[2])
    vis_path = os.path.join(tmp, "vis.png")
    save_visualization(vis_path, vis)
    back = read_png(vis_path)
    ok = back.shape == images[2].shape and np.array_equal(back, vis) and (vis != images[2]).any()
    log(f"  (f) VisualizationDemo: {vis_path.rsplit('/', 1)[-1]} {back.shape} read back "
        f"[{'ok' if ok else 'FAIL'}]")
    if not ok:
        raise AssertionError("VisualizationDemo: the PNG does not read back")

    def async_part():
        """(d) AsyncPredictor, two workers on the card, each its own model and
        stream: results in request order, equal to Predictor's."""
        params = pred.model.state_dict()
        torch.cuda.synchronize()
        ap = AsyncPredictor(cfg, params, num_workers=2)
        try:
            for img in stream[:2]:  # a warm-up call on each worker
                ap.put(img)
            [ap.get() for _ in range(2)]
            t0 = time.perf_counter()
            for img in stream[:8]:
                ap.put(img)
            got = [ap.get() for _ in range(8)]
            wall = time.perf_counter() - t0
        finally:
            ap.shutdown()
        checks = [same_detections(res, results[k % len(images)]) for k, res in enumerate(got)]
        for k, (res, check) in enumerate(zip(got, checks)):
            ref = results[k % len(images)]
            if not check["ok"] or res["masks"].shape != ref["masks"].shape:
                raise AssertionError(f"AsyncPredictor result {k} is not Predictor's for that "
                                     f"image (order or values): {check}")
        log(f"  (d) AsyncPredictor (2 workers, one card): 8 results in request order, equal to "
            f"Predictor's: {sum(c['pairs'] for c in checks)} of "
            f"{sum(len(r['scores']) for r in got)} detections paired; max |diff| / max |ref| boxes "
            f"{max(c['box_gap'] for c in checks):.3g}, scores "
            f"{max(c['score_gap'] for c in checks):.3g}; {8 / wall:.2f} images/s with masks "
            f"[{card}]")

    return async_part


PASTE_STEPS = 5  # per setting of remat; the first one is left out of the median
TRAIN_DRAWS = {"match": (2, 40), "mask": (2, 40), "fed0": (9,), "fed1": (9,), "fed2": (9,)}


def small_train_step():
    """One train step of a narrow detector (Swin embed 32, d = 32 heads, window
    7), bf16 compute over float32 parameters on the card through the forward
    and backward window-attention kernels, against the same model in float32
    on the CPU: same seeded weights, batch and uniform draws (made once on the
    CPU and handed to both, since the two devices' generators differ). Bounds:
    every loss within 5e-2 relative (+ 5e-3); ``grad_norm`` within 1e-1
    relative; for a handful of named parameters the update ``after - before``
    points the same way: cosine >= 0.9. The optimizer here is SGD with
    momentum and clipping, whose update is linear in the gradient (AdamW's
    first step moves every weight by the learning rate times its gradient's
    sign, which bf16 noise flips wherever the gradient is small; the
    full-width slice runs AdamW)."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.engine.train_loop import create_train_state, make_train_step
    from divergen_tpu_torch.modeling.backbone import swin
    from divergen_tpu_torch.modeling.meta_arch.rcnn import build_model
    from divergen_tpu_torch.ops.window_attention import fused_window_attention_packed
    from divergen_tpu_torch.solver.build import build_optimizer

    swin.SIZE2CONFIG["narrow"] = NARROW_SWIN
    names = ("bottom_up.stage0_block1.attn.qkv.weight", "bottom_up.stage2_block0.mlp_fc1.weight",
             "bottom_up.stage1_block0.attn.relative_position_bias_table",
             "fpn.output_s3.conv.weight", "centernet_head.agn_hm.conv.weight",
             "roi_heads.box_head0.fc1.weight", "roi_heads.box_predictor2.cls_score.weight",
             "roi_heads.mask_head.deconv.weight")
    rng = np.random.RandomState(5)
    canvas = (128, 160)
    images = (rng.rand(2, *canvas, 3) * 255).astype(np.float32)
    gt = graft_entry._synth_gt(rng, 2, 8, 8, img=128)
    g = torch.Generator().manual_seed(13)
    draws = {k: torch.rand(shape, generator=g) for k, shape in TRAIN_DRAWS.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = graft_entry._small_cfg(backbone="swin", swin_size="narrow")
        cfg.MODEL.FPN.OUT_CHANNELS = 64
        cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 128
        cfg.MODEL.ROI_BOX_HEAD.FED_LOSS_NUM_CAT = 4
        cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
        cfg.SOLVER.OPTIMIZER = "SGD"
        cfg.SOLVER.BASE_LR = 1e-3
        cfg.SOLVER.WARMUP_ITERS = 0
        cfg.FP16 = dev == "cuda"
        model = build_model(cfg, input_size=canvas, device=dev, param_dtype=torch.float32)
        graft_entry.fast_init_(model, torch.Generator().manual_seed(11))
        if {p.dtype for p in model.parameters()} != {torch.float32}:
            raise AssertionError("small train step: parameters are not float32")
        optimizer = build_optimizer(cfg, model)
        state = create_train_state(model, optimizer, ema=True)
        before = {n: dict(model.named_parameters())[n].detach().cpu().clone() for n in names}
        batch = {"images": torch.from_numpy(images).to(dev),
                 "image_sizes": torch.tensor([[128, 160], [100, 120]], device=dev),
                 "gt": {k: v.to(dev) for k, v in gt.items()},
                 "fed_weight": torch.linspace(1.0, 3.0, 8, device=dev)}
        launches = (fused_window_attention_packed.launches,
                    fused_window_attention_packed.backward_launches)
        state, metrics = make_train_step(model, optimizer, ema_decay=0.999)(state, batch, draws)
        if dev == "cuda":
            torch.cuda.synchronize()
            fwd = fused_window_attention_packed.launches - launches[0]
            bwd = fused_window_attention_packed.backward_launches - launches[1]
            if (fwd, bwd) != (7, 7):
                raise AssertionError(f"small train step: {fwd} forward and {bwd} backward "
                                     "window-attention launches, expected 7 and 7")
        after = {n: dict(model.named_parameters())[n].detach().cpu() - before[n] for n in names}
        out[dev] = ({k: float(v) for k, v in metrics.items()}, after)
    (ref, ref_upd), (got, got_upd) = out["cpu"], out["cuda"]
    for k, want in ref.items():
        tol = 1e-1 * abs(want) if k == "grad_norm" else 5e-2 * abs(want) + 5e-3
        ok = abs(got[k] - want) <= tol
        log(f"  small train step {k}: card {got[k]:.5f}, f32 CPU {want:.5f} [{'ok' if ok else 'FAIL'}]")
        if not ok:
            raise AssertionError(f"small train step: {k} disagrees with the f32 CPU copy")
    for n in names:
        cos = F.cosine_similarity(got_upd[n].flatten(), ref_upd[n].flatten(), dim=0).item()
        ok = cos >= 0.9
        log(f"  small train step update of {n}: cosine {cos:.4f} [{'ok' if ok else 'FAIL'}]")
        if not ok:
            raise AssertionError(f"small train step: the update of {n} disagrees with the CPU copy")


# dryrun_train on the card against its CPU copy: the same weights, batch and
# draws, float32 on both (TF32 off); sums in another order (cuDNN's
# convolutions) through a whole step: every loss, and the gradient norm (the
# CPU's float32 norm sums otherwise)
DRYRUN_BOUNDS = dict(loss=2e-6, grad_norm=2e-4)  # relative


def dryrun_resnet18(snapshot) -> dict:
    """``graft_entry.dryrun_train()`` on the card: the JAX dryrun's model
    (``_small_cfg()``: ResNet-18 + FPN), its parameters and compute float32,
    no launch of any kernel wrapper, and every loss within
    ``DRYRUN_BOUNDS["loss"]`` relative of ``dryrun_train(device="cpu")`` (the
    same weights, batch and draws), ``grad_norm`` within
    ``DRYRUN_BOUNDS["grad_norm"]``. Returns the card's metrics."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.modeling.backbone.resnet import ResNet

    seen, build = {}, graft_entry.build_model

    def recording_build(cfg, **kw):
        seen["model"] = build(cfg, **kw)
        return seen["model"]

    before = snapshot()
    graft_entry.build_model = recording_build
    try:
        got = graft_entry.dryrun_train()
        torch.cuda.synchronize()
    finally:
        graft_entry.build_model = build
    model = seen["model"]
    dtypes = {p.dtype for p in model.parameters()}
    launched = launched_since(before, snapshot)
    log(f"  dryrun_train on the card: {model.backbone_name}, parameters {dtypes}, compute "
        f"{model.compute_dtype}; kernel launches {launched}")
    if (dtypes != {torch.float32} or model.compute_dtype != torch.float32
            or not isinstance(model.bottom_up, ResNet) or model.backbone_name != "resnet18"):
        raise AssertionError("dryrun_train: not the float32 ResNet-18 detector on the card")
    if launched:
        raise AssertionError(f"dryrun_train launched kernels: {launched}")
    ref = graft_entry.dryrun_train(device="cpu")
    for k, want in ref.items():
        rel = DRYRUN_BOUNDS["grad_norm" if k == "grad_norm" else "loss"]
        ok = abs(got[k] - want) <= rel * abs(want)
        log(f"    {k}: card {got[k]:.8f}, CPU {want:.8f} [{'ok' if ok else 'FAIL'}]")
        if not ok:
            raise AssertionError(f"dryrun_train: {k} on the card disagrees with the CPU step")
    return got


def slice_train(card: str):
    """The flagship train step at full width through ``graft_entry``: Swin-L,
    1453 classes, 896², B = 2, bf16 compute over float32 parameters, AdamW with
    clipping, EMA, the federated loss and the compositor. Five steps of
    ``make_paste_train_step`` and one of ``make_train_step`` with the config's
    rematerialization (48 forward launches of fused_window_attention_packed per
    step, 24 backward), then five steps without it (24 and 24). (The float32
    ``dryrun_train`` runs in the architectures slice: it is ResNet-18, as the
    JAX dryrun.)"""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.engine.train_loop import make_train_step
    from divergen_tpu_torch.ops.nms import nms_mask
    from divergen_tpu_torch.ops.window_attention import (fused_window_attention,
                                                         fused_window_attention_packed)

    packed, split = fused_window_attention_packed, fused_window_attention
    probe = ("bottom_up.stage2_block17.attn.qkv.weight", "roi_heads.box_predictor0.cls_score.bias",
             "centernet_head.agn_hm.conv.weight")
    def run(remat):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step, (state, batch, rng) = graft_entry.flagship_train_entry(remat=remat)
        torch.cuda.synchronize()
        params = dict(state.model.named_parameters())
        if ({p.dtype for p in params.values()} | {e.dtype for e in state.ema_params.values()}
                != {torch.float32}):
            raise AssertionError("flagship train state: parameters or EMA are not float32")
        if state.model.compute_dtype != torch.bfloat16 or state.model.bottom_up.remat != remat:
            raise AssertionError("flagship train state: compute dtype or remat not as asked")
        log(f"  flagship train state (remat {remat}) built in {time.perf_counter() - t0:.1f} s: "
            f"{sum(p.numel() for p in params.values()) / 1e6:.1f} M float32 parameters, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB with the batch")
        before = {n: params[n].detach().clone() for n in probe}
        ema_before = {n: state.ema_params[n].clone() for n in probe}
        steps = [("paste", step)] * PASTE_STEPS
        if remat:
            plain_batch = {"images": batch["image"], "image_sizes": batch["image_size"],
                           "gt": batch["gt"], "fed_weight": batch["fed_weight"]}
            steps.append(("plain", make_train_step(state.model, state.optimizer,
                                                   ema_decay=0.999)))
        times = []
        for i, (kind, fn) in enumerate(steps):
            fwd, bwd, syncs = packed.launches, packed.backward_launches, nms_mask.host_syncs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = fn(state, plain_batch if kind == "plain" else batch, rng)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            fwd, bwd = packed.launches - fwd, packed.backward_launches - bwd
            want = (2 * SWIN_L_BLOCKS if remat else SWIN_L_BLOCKS, SWIN_L_BLOCKS)
            if (fwd, bwd) != want or split.launches or split.backward_launches:
                raise AssertionError(f"train step {i} (remat {remat}): {fwd} forward and {bwd} "
                                     f"backward launches of the packed kernel, expected {want}; "
                                     f"split {split.launches}, {split.backward_launches}")
            values = {k: float(v) for k, v in metrics.items()}
            if state.step != i + 1 or not all(np.isfinite(v) for v in values.values()):
                raise AssertionError(f"train step {i}: step counter {state.step}, metrics {values}")
            if len(values) != (12 if kind == "plain" else 11):
                raise AssertionError(f"train step {i}: {sorted(values)}")
            log(f"  {kind} step {state.step} (remat {remat}): total_loss {values['total_loss']:.4f}, "
                f"{ms:.1f} ms, {fwd} forward + {bwd} backward window-attention launches, "
                f"{nms_mask.host_syncs - syncs} host syncs in NMS")
            if kind == "paste":
                times.append(ms)
        log("    losses of the last step: " + ", ".join(
            f"{k} {v:.4f}" for k, v in values.items() if k != "total_loss"))
        for n in probe:
            if torch.equal(params[n], before[n]) or torch.equal(state.ema_params[n], ema_before[n]):
                raise AssertionError(f"train steps left {n} or its EMA copy unchanged")
        return statistics.median(times[1:]), torch.cuda.max_memory_allocated() / 2**30

    # one call each, so that nothing of the first state outlives it
    stats = {remat: run(remat) for remat in (True, False)}
    for remat, (ms, peak) in stats.items():
        log(f"  flagship train step (B=2, 896², bf16 over f32, compositor on, remat {remat}): "
            f"{ms:.1f} ms/step (host clock, median of the steps after the first), peak memory "
            f"{peak:.2f} GiB [{card}]")
    torch.cuda.empty_cache()


# the float32 active step on the card against the CPU: decision equal,
# grad_sim within 1e-4 absolute, every metric within 2e-4 relative
ACTIVE_BOUNDS = dict(sim=1e-4, rel=2e-4, abs=1e-6)
ACTIVE_P = 4  # patch slots per image of the card-vs-CPU active step


def active_draws(gen: torch.Generator, rows: int, probe_rows: int, classes: int) -> dict:
    """The draws of one BSGAL step on a batch of two images, made on the CPU:
    the probe's forward (the ground truth as its proposals), the pasted and
    the final forward, and the compare uniform."""
    def forward(r):
        out = {k: torch.rand((2, r), generator=gen) for k in ("match", "mask")}
        out.update({f"fed{s}": torch.rand((classes + 1,), generator=gen) for s in range(3)})
        return out

    return {"probe": forward(probe_rows), "paste": forward(rows), "final": forward(rows),
            "compare": torch.rand((), generator=gen)}


# the float32 active step's window launches (forward, backward): the probe,
# pasted and final forwards of Swin-T (depths 2 / 2 / 6 / 2), each with its
# backward
SWIN_T_BLOCKS = 12
ACTIVE_F32_LAUNCHES = (3 * SWIN_T_BLOCKS, 3 * SWIN_T_BLOCKS)


def small_active_step() -> None:
    """One float32 BSGAL step (``make_active_train_step``: gradient compare
    from one forward, ``paste_or_ori``) of ``graft_entry._small_cfg(backbone="swin")``'s
    Swin-T detector at 64² on the card and on the CPU: the same
    ``detector_init_`` weights, batch, probe and draws (made on the CPU).
    Bounds ``ACTIVE_BOUNDS``. The float32 main path of the window attention:
    on the card every launch runs the float32 bodies (counted under
    ``dg_attention_f32`` in the packed wrapper's ``bodies`` and
    ``backward_bodies``), ``ACTIVE_F32_LAUNCHES`` of them, at the shapes
    ``float32_window_backward_phase`` checks (``F32_WINDOW_BWD_SWIN_T``)."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.active.bsgal import init_active_state, make_active_train_step
    from divergen_tpu_torch.engine.train_loop import create_train_state
    from divergen_tpu_torch.modeling.meta_arch.rcnn import build_model, detector_init_
    from divergen_tpu_torch.ops import attention_f32
    from divergen_tpu_torch.ops import window_attention as wa_mod
    from divergen_tpu_torch.solver.build import build_optimizer

    cfg = graft_entry._small_cfg(backbone="swin")
    cfg.merge_from_list(["MODEL.ACTIVE.ENABLED", True, "INPUT.USE_COPY_PASTE", True,
                         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 32,
                         "MODEL.CENTERNET.PRE_NMS_TOPK_TRAIN", 32,
                         "MODEL.CENTERNET.POST_NMS_TOPK_TRAIN", 16,
                         "MODEL.ROI_BOX_HEAD.FED_LOSS_NUM_CAT", 4, "DATALOADER.MAX_INSTANCES", 8,
                         "DATALOADER.MAX_PASTES", ACTIVE_P, "DATALOADER.PATCH_SIZE", 32,
                         "SOLVER.CLIP_GRADIENTS.ENABLED", True, "MODEL.MODEL_EMA", 0.999])
    rng = np.random.RandomState(21)

    def real_batch():
        return {"image": torch.from_numpy((rng.rand(2, 64, 64, 3) * 255).astype(np.float32)),
                "image_size": torch.tensor([[64, 64], [56, 48]]),
                "gt": graft_entry._synth_gt(rng, 2, 8, 8, img=64)}

    batch = real_batch()
    xy = rng.rand(2, ACTIVE_P, 2) * 30
    batch.update({
        "patches": torch.from_numpy(np.concatenate(
            [rng.rand(2, ACTIVE_P, 32, 32, 3) * 255, rng.rand(2, ACTIVE_P, 32, 32, 1) > 0.3],
            -1).astype(np.float32)),
        "patch_boxes": torch.from_numpy(np.concatenate(
            [xy, xy + rng.rand(2, ACTIVE_P, 2) * 20 + 8], -1).astype(np.float32)),
        "patch_classes": torch.from_numpy(rng.randint(0, 8, (2, ACTIVE_P))).long(),
        "patch_valid": torch.arange(ACTIVE_P)[None].expand(2, ACTIVE_P) < 2,
        "patch_flip": torch.from_numpy(rng.rand(2, ACTIVE_P) > 0.5),
        "probe": real_batch()})
    draws = active_draws(torch.Generator().manual_seed(22), 16 + 8 + ACTIVE_P, 16, 8)
    weights = detector_init_(build_model(cfg, input_size=(64, 64), device="cpu",
                                         param_dtype=torch.float32),
                             torch.Generator().manual_seed(23)).state_dict()
    to = lambda v, dev: ({k: to(x, dev) for k, x in v.items()} if isinstance(v, dict)
                         else v.to(dev))
    packed = wa_mod.fused_window_attention_packed
    fwd, bwd = [], []
    launch, plan = attention_f32.launch, wa_mod._plan

    def recording_launch(*args, **kw):
        fwd.append((kw["batch"], kw["heads"], kw["sq"], kw["d"],
                    None if kw.get("bias2") is None else kw["nw"]))
        return launch(*args, **kw)

    def recording_plan(dtype, *args):
        bwd.append((dtype, *args[:4]))
        return plan(dtype, *args)

    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, input_size=(64, 64), device=dev, param_dtype=torch.float32)
        model.load_state_dict(weights)
        optimizer = build_optimizer(cfg, model)
        state = create_train_state(model, optimizer, ema=True)
        astate = init_active_state(dict(model.named_parameters()), queue_size=8)
        step = make_active_train_step(model, optimizer, cfg)
        if dev == "cuda":
            counts = (packed.launches, packed.backward_launches)
            bodies = (dict(packed.bodies), dict(packed.backward_bodies))
            attention_f32.launch, wa_mod._plan = recording_launch, recording_plan
        try:
            _, _, metrics = step(state, astate, to(batch, dev), to(draws, dev))
            out[dev] = {k: float(v) for k, v in metrics.items()}
        finally:
            attention_f32.launch, wa_mod._plan = launch, plan
    counts = (packed.launches - counts[0], packed.backward_launches - counts[1])
    key = ("dg_attention_f32", 32)
    f32 = (packed.bodies[key] - bodies[0].get(key, 0),
           packed.backward_bodies[key] - bodies[1].get(key, 0))
    log(f"  float32 active step on the card: {counts[0]} forward and {counts[1]} backward "
        f"window-attention launches, of them {f32[0]} and {f32[1]} on the float32 bodies at "
        f"d = 32 (expected {ACTIVE_F32_LAUNCHES})")
    if not (counts == f32 == ACTIVE_F32_LAUNCHES and len(fwd) == counts[0]
            and len(bwd) == counts[1]):
        raise AssertionError(f"float32 active step: window launches {counts}, on the float32 "
                             f"bodies {f32}, expected {ACTIVE_F32_LAUNCHES}; float32 forward "
                             f"launches {len(fwd)}, backward plans {len(bwd)}")
    checked = {(bn, h, n, 32, nw) for bn, h, n, nw in F32_WINDOW_BWD_SWIN_T}
    if set(fwd) != checked or {(torch.float32, bn, h, n, 32) for bn, h, n, _, _ in fwd} != set(bwd):
        raise AssertionError(f"float32 active step: launch shapes {sorted(set(fwd), key=str)} "
                             f"(backward {sorted(set(bwd), key=str)}), not those checked: "
                             f"{sorted(checked, key=str)}")
    ref, got = out["cpu"], out["cuda"]
    ok = got["paste_used"] == ref["paste_used"]
    log(f"  float32 active step: decision card {got['paste_used']:.0f}, CPU "
        f"{ref['paste_used']:.0f} [{'ok' if ok else 'FAIL'}]")
    if not ok:
        raise AssertionError("the float32 active step decides otherwise on the card")
    for k, want in ref.items():
        tol = (ACTIVE_BOUNDS["sim"] if k in ("grad_sim", "threshold")
               else ACTIVE_BOUNDS["rel"] * abs(want) + ACTIVE_BOUNDS["abs"])
        ok = abs(got[k] - want) <= tol
        log(f"    {k}: card {got[k]:.6f}, CPU {want:.6f} [{'ok' if ok else 'FAIL'}]")
        if not ok:
            raise AssertionError(f"float32 active step: {k} disagrees with the CPU step")


TRAIN_SET = 24  # synthetic train images of the do_train slice, SERVING_SIZES in turn
VAL_SET = 8
BSGAL_STEPS, BSGAL_RESUME_STEPS, DIVERGEN_STEPS = 6, 2, 4
# per step: BSGAL's probe, pasted and final forward each with its backward;
# DiverGen's forward, its rematerialized replay in the backward, the backward
BSGAL_LAUNCHES = (3 * SWIN_L_BLOCKS, 3 * SWIN_L_BLOCKS)
DIVERGEN_LAUNCHES = (2 * SWIN_L_BLOCKS, SWIN_L_BLOCKS)


def train_net_run(card: str, config: str, root: str, out: str, classes: int, *extra,
                  files=None):
    """``train_net.main`` with ``config`` on a synthetic LVIS-format root
    written to ``root`` (``write_training_root``: ``TRAIN_SET`` PNG train
    images of the four ``SERVING_SIZES``, ``VAL_SET`` val images, ``classes``
    categories, an RGBA pool of 64 instances over 32 categories), or the
    root ``files`` describes if given, with the cuts ``SOLVER.IMS_PER_BATCH
    2``, ``CHECKPOINT_PERIOD 3`` and ``extra`` (arguments, then config keys);
    prints seconds per step (median after the first), ``data_time`` and
    peak memory beside the card. Returns (the final state,
    ``do_train.last_run``, the steps taken)."""
    from divergen_tpu_torch import train_net
    from divergen_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from divergen_tpu_torch.data.datasets.synthetic_lvis import write_training_root
    from divergen_tpu_torch.engine.trainer import do_train

    t0 = time.perf_counter()
    if files is None:
        files = write_training_root(root, classes, SERVING_SIZES * (TRAIN_SET // 4),
                                    SERVING_SIZES * (VAL_SET // 4), 64, 32, seed=0)
    written = time.perf_counter() - t0
    for name in ("lvis_v1_train", "lvis_v1_val", "lvis_v1_train_norare"):
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    os.environ["DETECTRON2_DATASETS"] = root
    args = ["--config-file", config, *extra, *files["overrides"],
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CHECKPOINT_PERIOD", "3", "OUTPUT_DIR", out]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_net.main(train_net.default_argument_parser().parse_args(args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_info = dict(do_train.last_run)
    steps = state.step - run_info["start_iter"]
    step_s, data_s = run_info["step_s"], run_info["data_time"]
    log(f"  {os.path.basename(config)} {' '.join(extra)}: {steps} steps in {wall:.1f} s "
        f"(data written in {written:.1f} s); s/step "
        f"{statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]:.3f} "
        f"(median after the first; every step {[round(x, 3) for x in step_s]}); data_time "
        f"{[round(x, 4) for x in data_s]} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return state, run_info, steps


def launched_since(before: dict, snapshot) -> dict:
    """The kernel wrappers' launches, by name, since ``before`` (an earlier
    ``snapshot()``); wrappers that launched nothing are left out."""
    return {k: n - before.get(k, 0) for k, n in snapshot().items()
            if isinstance(k, str) and n != before.get(k, 0)}


def path_launches(per_step, steps: int) -> dict:
    """The packed window-attention launches of ``steps`` steps at ``per_step``
    (forward, backward) a step, as ``launched_since`` gives them."""
    want = {"fused_window_attention_packed": per_step[0] * steps,
            "fused_window_attention_packed_backward": per_step[1] * steps}
    return {k: n for k, n in want.items() if n}


def counted_train_net_run(card: str, snapshot, config: str, root: str, out: str,
                          classes: int, *extra, files=None):
    """``train_net_run`` with the kernel launches of the in-training
    ``do_test`` counted apart from the training's. Returns (the final state,
    ``do_train.last_run``, the steps taken, the launches outside ``do_test``,
    the launches in it)."""
    from divergen_tpu_torch.engine import eval_loop

    in_eval, do_test = {}, eval_loop.do_test

    def counted_do_test(*args, **kw):
        before = snapshot()
        try:
            return do_test(*args, **kw)
        finally:
            for k, n in launched_since(before, snapshot).items():
                in_eval[k] = in_eval.get(k, 0) + n

    before = snapshot()
    eval_loop.do_test = counted_do_test
    try:
        state, info, steps = train_net_run(card, config, root, out, classes, *extra,
                                           files=files)
    finally:
        eval_loop.do_test = do_test
    launched = {k: n - in_eval.get(k, 0) for k, n in launched_since(before, snapshot).items()
                if n != in_eval.get(k, 0)}
    return state, info, steps, launched, in_eval


def bsgal_run(card: str, config: str, root: str, out: str, per_step, snapshot,
              *extra_keys) -> None:
    """BSGAL through ``counted_train_net_run`` for ``BSGAL_STEPS`` with the
    grad bank every 3 steps, a decision-log line a step and ``do_test`` at
    step 6, then ``--resume`` for ``BSGAL_RESUME_STEPS``: outside ``do_test``
    exactly the packed window-attention launches of ``per_step`` (forward,
    backward) a step and no other kernel's, paste + discard counts equal to
    the steps, ``grad_bank/`` holding steps 3 and 6, the resumed run starting
    at 6 from the saved bank and counts, one decision a step in the log,
    finite ``metrics.json``, an AP dict from the in-training ``do_test``, and
    the step-6 checkpoint's EMA weights in ``Predictor`` giving detections
    with masks."""
    import shutil

    from divergen_tpu_torch import train_net
    from divergen_tpu_torch.data.dataset_mapper import read_image
    from divergen_tpu_torch.engine.checkpoint import Checkpointer
    from divergen_tpu_torch.predictor import Predictor

    keys = ("MODEL.ACTIVE.BANK_CKPT_PERIOD", "3", "MODEL.ACTIVE.LOG_PERIOD", "1",
            "TEST.EVAL_PERIOD", "6", *extra_keys)
    state, info, steps, launches, in_eval = counted_train_net_run(
        card, snapshot, config, root, out, 1203, "--max-steps", str(BSGAL_STEPS), *keys)
    want = path_launches(per_step, BSGAL_STEPS)
    if steps != BSGAL_STEPS or launches != want:
        raise AssertionError(f"BSGAL: {steps} steps, kernel launches {launches} outside "
                             f"do_test, expected {want}")
    astate = info["active_state"]
    n_paste, n_discard = int(astate.n_paste), int(astate.n_discard)
    bank = Checkpointer(os.path.join(out, "grad_bank"))
    if n_paste + n_discard != BSGAL_STEPS or bank.all_steps() != [3, 6]:
        raise AssertionError(f"BSGAL: paste {n_paste} + discard {n_discard}, grad bank "
                             f"saves {bank.all_steps()}")
    ap = info["eval"]["lvis_v1_val"]
    if not all(math.isfinite(ap[t]["AP"]) for t in ("bbox", "segm")):
        raise AssertionError(f"BSGAL: the in-training do_test gave {ap}")
    log(f"    in-training do_test on {VAL_SET} val images: bbox AP {ap['bbox']['AP']:.4f}, "
        f"segm AP {ap['segm']['AP']:.4f}; kernel launches in it {in_eval}")
    saved = bank.load(6)["active_state"]
    del state, astate, info
    torch.cuda.empty_cache()
    state, info, steps, launches, _ = counted_train_net_run(
        card, snapshot, config, root, out, 1203, "--max-steps", str(BSGAL_RESUME_STEPS),
        "--resume", *keys)
    want = path_launches(per_step, BSGAL_RESUME_STEPS)
    restored = info["restored_counts"]
    if (info["start_iter"], info["bank_step"], state.step) != (6, 6, 8) or launches != want:
        raise AssertionError(f"BSGAL --resume: start {info['start_iter']}, bank step "
                             f"{info['bank_step']}, final step {state.step}, launches "
                             f"{launches} (expected {want})")
    if restored != (int(saved["n_paste"]), int(saved["n_discard"])) or abs(
            info["restored_bank_norm"] - math.sqrt(sum(
                float((v.double() ** 2).sum()) for v in saved["grad_bank"].values()))) > \
            1e-6 * max(info["restored_bank_norm"], 1e-12):
        raise AssertionError("BSGAL --resume: the bank or its counters are not the saved ones")
    astate = info["active_state"]
    if int(astate.n_paste) + int(astate.n_discard) != BSGAL_STEPS + BSGAL_RESUME_STEPS:
        raise AssertionError("BSGAL --resume: decision counts do not sum to the steps")
    lines = open(os.path.join(out, "paste_source", "rank_0", "10000.txt")).read().splitlines()
    decisions = {}
    for line in lines:
        it = int(line.split(" iter: ")[1].split()[0])
        decisions[it] = (int(line.split(" paste: ")[1].split()[0]),
                         float(line.split(" sim_paste_init: ")[1].split()[0]))
    if sorted(decisions) != list(range(BSGAL_STEPS + BSGAL_RESUME_STEPS)) or sum(
            p for p, _ in decisions.values()) != int(astate.n_paste):
        raise AssertionError(f"BSGAL: decision log covers {sorted(decisions)}")
    log(f"    decisions (paste, grad_sim) per step: {[decisions[i] for i in sorted(decisions)]}; "
        f"{len(lines)} log lines; grad bank saves {bank.all_steps()}")
    for row in map(json.loads, open(os.path.join(out, "metrics.json")).read().splitlines()):
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"BSGAL metrics.json: {row}")
    cfg = train_net.setup(train_net.default_argument_parser().parse_args(
        ["--config-file", config, "OUTPUT_DIR", out]))
    del state, astate, info
    torch.cuda.empty_cache()
    raw = Checkpointer(out).load()
    params = dict(raw["model"], **raw["ema_params"])
    pred = Predictor(cfg, params, score_thresh=0.0)
    res = pred(read_image(os.path.join(root, "coco", "val2017", "000000000001.png")))
    if not (raw["step"] == BSGAL_STEPS and len(res["boxes"])
            and np.isfinite(res["boxes"]).all() and np.isfinite(res["scores"]).all()
            and res["masks"].shape[0] == len(res["boxes"])):
        raise AssertionError("the trained BSGAL checkpoint gave no detections in Predictor")
    log(f"    Predictor on the step-{raw['step']} checkpoint (EMA weights): "
        f"{len(res['boxes'])} detections, masks {res['masks'].shape}")
    del pred, raw, params
    shutil.rmtree(out)
    torch.cuda.empty_cache()


def slice_do_train(card: str, tmp: str, snapshot) -> float:
    """Both training configs through the port's ``train_net.main`` at full
    width on synthetic LVIS-format sets (``write_training_root``: 24 PNG
    train images of the four ``SERVING_SIZES``, 8 val images, a category-info
    json, an RGBA pool of 64 instances over 32 categories), with the cuts
    ``SOLVER.IMS_PER_BATCH 2``, ``CHECKPOINT_PERIOD 3`` and the paths:
    (a) ``configs/BSGAL_SwinL.yaml`` (Swin-L, 1203 classes, 896², bf16 over
    float32 parameters, AdamW, EMA, ``syn_copy`` with ``cas_random``, RFS)
    for 6 steps with ``ACTIVE.BANK_CKPT_PERIOD 3``, ``LOG_PERIOD 1`` and
    ``TEST.EVAL_PERIOD 6``, then ``--resume`` for 2 more (``bsgal_run``); (b)
    ``configs/DiverGen_swinL.yaml`` (1453 classes, remat, ``both``) for 4
    steps. Checks the kernel launches per step outside ``do_test`` (the
    packed window-attention wrapper only), the decision counts and logs, the
    grad bank's saves and its restore, the metrics, the in-training
    ``do_test`` and the trained checkpoint in ``Predictor``; prints seconds
    per step, ``data_time`` and peak memory. Returns (b)'s seconds per step
    (median after the first), which the real-image slice compares with."""
    import shutil

    from divergen_tpu_torch.engine.checkpoint import Checkpointer

    # (a) BSGAL, then --resume
    bsgal_run(card, "configs/BSGAL_SwinL.yaml", os.path.join(tmp, "bsgal_data"),
              os.path.join(tmp, "bsgal"), BSGAL_LAUNCHES, snapshot)

    # (b) DiverGen
    root, out = os.path.join(tmp, "divergen_data"), os.path.join(tmp, "divergen")
    state, info, steps, launches, _ = counted_train_net_run(
        card, snapshot, "configs/DiverGen_swinL.yaml", root, out, 1453,
        "--max-steps", str(DIVERGEN_STEPS), "TEST.EVAL_PERIOD", "6")
    want = path_launches(DIVERGEN_LAUNCHES, DIVERGEN_STEPS)
    if steps != DIVERGEN_STEPS or launches != want or not state.model.bottom_up.remat:
        raise AssertionError(f"DiverGen: {steps} steps, launches {launches}, expected {want}")
    if Checkpointer(out).all_steps() != [3]:
        raise AssertionError(f"DiverGen: checkpoints {Checkpointer(out).all_steps()}")
    for row in map(json.loads, open(os.path.join(out, "metrics.json")).read().splitlines()):
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"DiverGen metrics.json: {row}")
    png_step_s = statistics.median(info["step_s"][1:])
    del state, info
    shutil.rmtree(out)
    torch.cuda.empty_cache()
    return png_step_s


# (label, config keys over get_cfg(), canvas, images) of slice_architectures
# (b): every architecture of build_model but Swin + FPN (the earlier slices)
# and ResNet-50 + FPN with the cascade (its (a)); CenterNetDetector also with
# NOT_NORM_REG false, which the JAX package computes at one image only
ARCHITECTURES = (
    ("Res2Net-50 + FPN", ["MODEL.BACKBONE.NAME", "build_res2net_fpn_backbone"], 640, 2),
    ("ConvNeXt-T + FPN", ["MODEL.BACKBONE.NAME", "build_convnext_fpn_backbone"], 640, 2),
    ("ViTDet-B", ["MODEL.BACKBONE.NAME", "build_vit_fpn_backbone"], 1024, 2),
    ("DLA-34 + BiFPN", ["MODEL.BACKBONE.NAME", "build_dla_bifpn_backbone",
                        "MODEL.BIFPN.NUM_BIFPN", 4], 640, 2),
    ("Swin-L + BiFPN", ["MODEL.BACKBONE.NAME", "build_p37_swin_bifpn_backbone",
                        "MODEL.SWIN.SIZE", "L-22k-384"], 896, 2),
    ("R50 + CustomRes5ROIHeads", ["MODEL.ROI_HEADS.NAME", "CustomRes5ROIHeads",
                                  "MODEL.ROI_HEADS.IN_FEATURES", "['p4']"], 640, 2),
    ("R50 + RefineMaskHead", ["MODEL.ROI_MASK_HEAD.NAME", "RefineMaskHead",
                              "MODEL.ROI_MASK_HEAD.SEM_SEG_ON", True], 640, 2),
    ("CenterNetDetector (R50)", ["MODEL.META_ARCHITECTURE", "CenterNetDetector"], 640, 2),
    ("CenterNetDetector (R50), NOT_NORM_REG false",
     ["MODEL.META_ARCHITECTURE", "CenterNetDetector", "MODEL.CENTERNET.NOT_NORM_REG", False],
     640, 1),
)


def architecture_step(card: str, label: str, keys, size: int, b: int, snapshot) -> None:
    """One architecture of ``ARCHITECTURES``: ``graft_entry._train_parts``'s
    float32-parameter model, AdamW, EMA and batch (``b`` images of ``size``,
    100 ground-truth slots of which 20 valid, a class-frequency vector; with
    ``SEM_SEG_ON`` a stride-8 semantic target), two steps of
    ``make_train_step`` and two inference forwards, each timed on the host
    clock after a synchronize; the kernel launches of each."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.config import get_cfg
    from divergen_tpu_torch.engine.train_loop import make_train_step
    from divergen_tpu_torch.modeling.meta_arch.rcnn import CenterNetDetector

    cfg = get_cfg()
    cfg.merge_from_list(["FP16", True, "MODEL.MODEL_EMA", 0.999, *keys])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, (state, batch, _) = graft_entry._train_parts(cfg, torch.device("cuda"), size, b, 20,
                                                   (size, size))
    model = state.model
    if cfg.MODEL.ROI_MASK_HEAD.SEM_SEG_ON:
        s8 = size // 8
        batch["gt"]["sem_seg"] = (torch.rand(b, s8, s8, device="cuda") > 0.7).float()
    plain = {"images": batch["image"], "image_sizes": batch["image_size"], "gt": batch["gt"],
             "fed_weight": batch["fed_weight"]}
    step = make_train_step(model, state.optimizer, ema_decay=0.999)
    rng = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    step_ms, launches = [], []
    for _ in range(2):
        before = snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, plain, rng)
        values = {k: float(v) for k, v in metrics.items()}  # synchronizes
        step_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(launched_since(before, snapshot))
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"{label}: train step metrics {values}")
    model.eval()
    fwd_ms, fwd_launches = [], []
    for _ in range(2):
        before = snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = model(batch["image"], batch["image_size"])
        torch.cuda.synchronize()
        fwd_ms.append(1e3 * (time.perf_counter() - t0))
        fwd_launches.append(launched_since(before, snapshot))
    if isinstance(model, CenterNetDetector):
        k = cfg.MODEL.CENTERNET.POST_NMS_TOPK_TEST
        shapes = {"boxes": (b, k, 4), "scores": (b, k), "classes": (b, k), "valid": (b, k)}
    else:
        k = cfg.TEST.DETECTIONS_PER_IMAGE
        side = {"CustomRes5ROIHeads": 14}.get(cfg.MODEL.ROI_HEADS.NAME, 28)
        if cfg.MODEL.ROI_MASK_HEAD.NAME == "RefineMaskHead":
            side = cfg.MODEL.ROI_MASK_HEAD.STAGE_SUP_SIZE[-1]
        shapes = {"boxes": (b, k, 4), "scores": (b, k), "classes": (b, k), "valid": (b, k),
                  "mask_logits": (b, k, side, side)}
    got = {name: tuple(dets[name].shape) for name in shapes}
    valid = dets["valid"]
    if got != shapes or not bool(valid.any()) or not all(
            bool(torch.isfinite(dets[n][valid]).all()) for n in shapes if n != "valid"):
        raise AssertionError(f"{label}: detections {got} (expected {shapes}), "
                             f"{int(valid.sum())} valid")
    want = ({"fused_window_attention_packed": 24, "fused_window_attention_packed_backward": 24}
            if "Swin" in label else {})
    want_fwd = {"fused_window_attention_packed": 24} if "Swin" in label else {}
    if launches != [want, want] or fwd_launches != [want_fwd, want_fwd]:
        raise AssertionError(f"{label}: kernel launches per step {launches} (expected {want}), "
                             f"per forward {fwd_launches} (expected {want_fwd})")
    log(f"  {label} at {size}², B = {b}: built in {built:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters; train step "
        f"{step_ms[1]:.1f} ms (first {step_ms[0]:.1f}), total_loss {values['total_loss']:.4f} "
        f"({len(values) - 2} losses); forward {fwd_ms[1]:.1f} ms (first {fwd_ms[0]:.1f}), "
        f"{int(valid.sum())} valid detections; kernel launches a step {launches[1]}, a forward "
        f"{fwd_launches[1]}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{card}]")


def slice_architectures(card: str, tmp: str, snapshot) -> None:
    """(a) ``configs/BSGAL_R50.yaml`` through ``train_net.main`` (``bsgal_run``
    with ``ACTIVE.PROBE_BATCH 2``), no kernel launch; (b) each of
    ``ARCHITECTURES`` (``architecture_step``); (c) ``dryrun_resnet18``."""
    before = snapshot()
    bsgal_run(card, "configs/BSGAL_R50.yaml", os.path.join(tmp, "r50_data"),
              os.path.join(tmp, "r50"), (0, 0), snapshot, "MODEL.ACTIVE.PROBE_BATCH", "2")
    launched = launched_since(before, snapshot)
    if launched:
        raise AssertionError(f"configs/BSGAL_R50.yaml launched kernels: {launched}")
    log("    configs/BSGAL_R50.yaml: no kernel launch in training, do_test or Predictor")
    torch.cuda.empty_cache()
    for label, keys, size, b in ARCHITECTURES:
        architecture_step(card, label, keys, size, b, snapshot)
        torch.cuda.empty_cache()
    metrics = dryrun_resnet18(snapshot)
    print(json.dumps(metrics), flush=True)


# ---- the IF cascade and the x4 upscaler --------------------------------------
IF_STEPS = 4  # of stage I and of stage II, B = 2 images (UNet batch 4: CFG)
UPSCALE_STEPS = 2  # of the x4 upscaler on the 256² stage-II images
# kernels 1 and 2 per x4-upscaler UNet call (UNet batch 4 at a 256² latent
# grid): (B, N, C, heads) of each self-attention and (M, K, N) of each GEGLU,
# levels 1, 2 and 3 (2 down + 3 up, 2 + 3, 2 + 3 + mid)
UPSCALER_ATTN_LAUNCHES = {(4, 16384, 512, 8): 5, (4, 4096, 512, 8): 5, (4, 1024, 1024, 16): 6}
UPSCALER_GEGLU_LAUNCHES = {(65536, 512, 4096): 5, (16384, 512, 4096): 5, (4096, 1024, 8192): 6}
UPSCALER_CALL = {"flash_attention_packed": 16, "fused_ln_matmul": 16}
# kernels 1 and 2 per SDXL UNet call under encoder reuse: a full step, a
# reuse step (the 24 transformer blocks of the down path skipped)
REUSE_LAUNCHES = (70, 46)
IF_RANGE_BOUND = 1e-4 * 2  # of the [-1, 1] range: the float32 tiny stage I, card vs CPU


# -- the real-image data layer (slice 12) ---------------------------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jpeg")
REAL_IMAGE_STEPS = 4
AUGMENTATIONS = ("INPUT.USE_COLOR_JITTER", "True", "INPUT.USE_INSTABOOST", "True",
                 "INPUT.USE_INP_ROTATE", "True")


def host_cpu() -> str:
    """The host CPU's model name as /proc/cpuinfo gives it, else its
    architecture; with the CPUs this process may use."""
    import platform

    name = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip().lower()
                if key in ("model name", "cpu model", "hardware") and ":" in line:
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    name = name or platform.processor() or f"a {platform.machine()} CPU (no model name)"
    return f"{name}, {len(os.sched_getaffinity(0))} CPUs"


def jpeg_fixture_phase(card: str) -> dict:
    """(a): every fixture of ``tests/data/jpeg/manifest.json`` decodes to
    the recorded SHA-256 of OpenCV's RGB pixels (the refused one raises the
    recorded mode); the decoder's time per 640 x 480 4:2:0 image. Returns
    the manifest."""
    import hashlib

    from divergen_tpu_torch import native
    from divergen_tpu_torch.utils.image_io import read_rgb

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    for entry in manifest["files"]:
        path = os.path.join(FIXTURES, entry["file"])
        if "raises" in entry:
            try:
                read_rgb(path)
            except ValueError as e:
                if entry["raises"] not in str(e):
                    raise AssertionError(f"{path}: refused as {e}, expected {entry['raises']}")
                continue
            raise AssertionError(f"{path}: decoded, expected a refusal ({entry['raises']})")
        rgb = read_rgb(path)
        if rgb.shape != (entry["height"], entry["width"], 3) or hashlib.sha256(
                rgb.tobytes()).hexdigest() != entry["sha256_rgb"]:
            raise AssertionError(f"{path} ({entry['mode']}): pixels differ from OpenCV's")
    with open(os.path.join(FIXTURES, manifest["lvis_images"][0]), "rb") as f:
        data = f.read()
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        native.jpeg_decode(data)
        times.append(time.perf_counter() - t0)
    log(f"  {len(manifest['files'])} JPEG fixtures decode to OpenCV's pixels (manifest "
        f"SHA-256), the progressive one refused; decode of a 640 x 480 4:2:0 q90 image "
        f"(native/jpeg.cpp, one thread): {statistics.median(times) * 1e3:.3f} ms median of 30 "
        f"(min {min(times) * 1e3:.3f}) on {host_cpu()} [{card}]")
    return manifest


def jpeg_training_root(root: str, manifest: dict, classes: int) -> dict:
    """``write_training_root``'s val set, pool and category info, with the
    train set replaced by the six LVIS-sized JPEG fixtures, each of their
    polygons an annotation. Returns ``write_training_root``'s dict."""
    import shutil

    from divergen_tpu_torch.data.datasets.synthetic_lvis import (
        write_cat_info,
        write_training_root,
    )

    files = write_training_root(root, classes, [(48, 64)] * 2, [(480, 640)] * 2, 64, 32, seed=0)
    train_json, image_root = files["train"]["json_file"], files["train"]["image_root"]
    with open(train_json) as f:
        data = json.load(f)
    for name in os.listdir(image_root):
        os.remove(os.path.join(image_root, name))
    images, anns = [], []
    for entry in manifest["files"]:
        if "objects" not in entry:
            continue
        shutil.copy(os.path.join(FIXTURES, entry["file"]), os.path.join(image_root, entry["file"]))
        image_id = len(images) + 1
        images.append({"id": image_id, "file_name": "train2017/" + entry["file"],
                       "height": entry["height"], "width": entry["width"],
                       "not_exhaustive_category_ids": [], "neg_category_ids": []})
        for obj in entry["objects"]:
            pts = np.asarray(obj["polygon"], np.float64).reshape(-1, 2)
            (x0, y0), (x1, y1) = pts.min(0), pts.max(0)
            anns.append({"id": len(anns) + 1, "image_id": image_id,
                         "category_id": obj["category_id"], "iscrowd": 0,
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "area": float((x1 - x0) * (y1 - y0)), "segmentation": [obj["polygon"]]})
    data["images"], data["annotations"] = images, anns
    with open(train_json, "w") as f:
        json.dump(data, f)
    write_cat_info(files["cat_info"], train_json)
    return files


def counting_augmentations():
    """Wrap the three augmentations so that each counts the samples it
    changed (the loader maps in threads of this process). Returns (the
    counts, a function that unwraps them)."""
    from divergen_tpu_torch.data import color_jitter, inp_rotate, instaboost

    counts = {"color_jitter": 0, "instaboost": 0, "inp_rotate": 0}
    lock = threading.Lock()
    jitter, boost, rotate = (color_jitter.PhotoMetricDistortion.__call__,
                             instaboost.InstaBoost.__call__, inp_rotate.inp_rotate_sample)

    def bump(key):
        with lock:
            counts[key] += 1

    def counted_jitter(self, sample, rng):
        before = sample["image"].copy()
        out = jitter(self, sample, rng)
        if not np.array_equal(out["image"], before):
            bump("color_jitter")
        return out

    def counted_boost(self, record, rng=None):
        out = boost(self, record, rng)
        if out is not record and "image_new" in out:
            bump("instaboost")
        return out

    def counted_rotate(sample, rng, **kw):
        out = rotate(sample, rng, **kw)
        if "patch_valid" in out and out["patch_valid"].any():
            bump("inp_rotate")
        return out

    color_jitter.PhotoMetricDistortion.__call__ = counted_jitter
    instaboost.InstaBoost.__call__ = counted_boost
    inp_rotate.inp_rotate_sample = counted_rotate

    def restore():
        color_jitter.PhotoMetricDistortion.__call__ = jitter
        instaboost.InstaBoost.__call__ = boost
        inp_rotate.inp_rotate_sample = rotate

    return counts, restore


def loader_images_per_s(config: str, out: str, files: dict, extra, batches: int = 12) -> float:
    """Images per second of ``build_train_loader`` for ``config`` on the
    root of ``files`` with the config keys ``extra`` (the first batch, which
    starts the threads, is not timed)."""
    from divergen_tpu_torch import train_net
    from divergen_tpu_torch.engine.trainer import build_train_loader

    cfg = train_net.setup(train_net.default_argument_parser().parse_args(
        ["--config-file", config, *files["overrides"], "SOLVER.IMS_PER_BATCH", "2",
         "OUTPUT_DIR", out, *extra]))
    loader = build_train_loader(cfg)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    wall = time.perf_counter() - t0
    loader.stop()
    return batches * cfg.SOLVER.IMS_PER_BATCH / wall


def slice_real_images(card: str, tmp: str, snapshot, png_step_s: float) -> None:
    """Slice 12: (a) the JPEG fixtures against their manifest; (b)
    ``configs/DiverGen_swinL.yaml`` through ``train_net`` on the JPEG root
    with the three augmentations on, launches and augmented samples
    checked, step and loader times printed; (c) ``lvis_crop`` ->
    ``extract_features`` -> ``compute_similarity`` on the card."""
    import shutil

    from divergen_tpu_torch.pipeline.filteration import cli as fcli

    manifest = jpeg_fixture_phase(card)

    # (b) DiverGen on the JPEG root, the augmentations on
    root, out = os.path.join(tmp, "jpeg_data"), os.path.join(tmp, "jpeg_divergen")
    config = "configs/DiverGen_swinL.yaml"
    files = jpeg_training_root(root, manifest, 1453)
    counts, restore = counting_augmentations()
    try:
        state, info, steps, launches, _ = counted_train_net_run(
            card, snapshot, config, root, out, 1453, "--max-steps", str(REAL_IMAGE_STEPS),
            "TEST.EVAL_PERIOD", "100", *AUGMENTATIONS, files=files)
    finally:
        restore()
    want = path_launches(DIVERGEN_LAUNCHES, REAL_IMAGE_STEPS)
    if steps != REAL_IMAGE_STEPS or launches != want:
        raise AssertionError(f"DiverGen on JPEGs: {steps} steps, launches {launches}, "
                             f"expected {want}")
    rows = [json.loads(r) for r in open(os.path.join(out, "metrics.json")).read().splitlines()]
    if not rows or not all(math.isfinite(v) for row in rows for v in row.values()):
        raise AssertionError(f"DiverGen on JPEGs: metrics.json {rows}")
    if not all(counts.values()):
        raise AssertionError(f"DiverGen on JPEGs: samples each augmentation changed {counts}")
    jpeg_step_s = statistics.median(info["step_s"][1:])
    log(f"    samples the augmentations changed in the loader: {counts}; s/step on the JPEG "
        f"root with them {jpeg_step_s:.3f} against {png_step_s:.3f} on 10(b)'s PNG root "
        f"(medians after the first step) [{card}]")
    del state, info
    torch.cuda.empty_cache()
    rates = {}
    for label, extra in (("on", AUGMENTATIONS), ("off", ())):
        rates[label] = loader_images_per_s(config, os.path.join(tmp, f"loader_{label}"), files,
                                           extra)
    log(f"    train loader on the JPEG root (IMS_PER_BATCH 2, NUM_WORKERS of the config, 896 "
        f"canvas): {rates['on']:.2f} images/s with the three augmentations, {rates['off']:.2f} "
        f"without, on {host_cpu()} [{card}]")
    shutil.rmtree(out)

    # (c) filtration on the real crops
    crops, gen = os.path.join(tmp, "crops_real"), os.path.join(tmp, "crops_other")
    train_json = files["train"]["json_file"]
    image_root = os.path.dirname(files["train"]["image_root"])
    t0 = time.perf_counter()
    for out_dir, mode, background in ((crops, "padding", "blur"), (gen, "tight", "white")):
        if fcli.lvis_crop(["--lvis_json", train_json, "--image_root", image_root, "--out_dir",
                           out_dir, "--crop_mode", mode, "--background", background]) != 0:
            raise AssertionError("lvis_crop failed")
    crop_s = time.perf_counter() - t0
    n_anns = sum(len(e["objects"]) for e in manifest["files"] if "objects" in e)
    n_crops = sum(len(fs) for _, _, fs in os.walk(crops))
    if n_crops != n_anns or sum(len(fs) for _, _, fs in os.walk(gen)) != n_anns:
        raise AssertionError(f"lvis_crop wrote {n_crops} crops for {n_anns} annotations")
    t0 = time.perf_counter()
    for in_dir, feat_dir in ((crops, crops + "_feat"), (gen, gen + "_feat")):
        if fcli.extract_features(["--in_dir", in_dir, "--out_dir", feat_dir, "--batch", "16",
                                  "--device", "cuda"]) != 0:
            raise AssertionError("extract_features failed")
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    sims = os.path.join(tmp, "sims")
    if fcli.compute_similarity(["--lvis_feature_dir", crops + "_feat", "--gen_feature_dir",
                                gen + "_feat", "--out_dir", sims]) != 0:
        raise AssertionError("compute_similarity failed")
    values = []
    for cat in os.listdir(sims):
        with open(os.path.join(sims, cat, "total.json")) as f:
            values += [v for row in json.load(f).values() for v in row.values()]
    if len(values) < n_anns or not all(math.isfinite(v) and -1.0001 <= v <= 1.0001
                                       for v in values):
        raise AssertionError(f"compute_similarity: {len(values)} similarities, "
                             f"range {min(values, default=0)}..{max(values, default=0)}")
    log(f"    lvis_crop on the JPEG root: {n_crops} crops x 2 modes in {crop_s:.2f} s; "
        f"extract_features (CLIP ViT-L/14, random weights) on {2 * n_crops} crops in "
        f"{feat_s:.2f} s; compute_similarity: {len(values)} similarities in "
        f"[{min(values):.4f}, {max(values):.4f}] [{card}]")


# ---- weak supervision, DINOv2, Cityscapes, inference_on_dataset_exp, rotated boxes ----
WEAK_LABELS = 4  # image labels per image of a weak batch, the last one padding
# (strategy, ROIHeadsConfig changes, ann_type) of the flagship's weak steps (a):
# the linear classifier's, then the zero-shot classifier's
WEAK_STEPS = (("max_size", {}, "image"), ("max_score", {}, "image"),
              ("min_loss", {}, "image"), ("image", {}, "image"),
              ("wsddn", {"with_softmax_prop": True}, "image"))
ZEROSHOT_WEAK_STEPS = (("captiontag", {}, "captiontag"), ("dynamic classifier", {}, "image"))
# the flagship's remat (USE_CHECKPOINT): two forward launches a block a step, one backward
WEAK_LAUNCHES = (2 * SWIN_L_BLOCKS, SWIN_L_BLOCKS)
DINO_CROPS = 64
DINO_VITS_BOUND = 1e-4  # of max |CPU embedding|: vits14 float32, card against CPU
ROTATED_BOXES = 2000
# the card's float32 IoU against float64 on the CPU: within twice the CPU's own
# float32 error, or 1e-5. Coordinates up to 2000 px carry float32 steps of
# 1.2e-4 px, so either device's float32 IoU of a sliver overlap moves by ~1e-3
ROTATED_IOU_BOUND = 1e-5


def weak_labels(b: int, classes: int, gen: torch.Generator, device) -> dict:
    """``image_labels`` (b, WEAK_LABELS) of random classes, the last one
    padding (``image_labels_valid`` False)."""
    labels = torch.randint(0, classes, (b, WEAK_LABELS), generator=gen).to(device)
    valid = (torch.arange(WEAK_LABELS) < WEAK_LABELS - 1)[None].expand(b, -1).to(device)
    return {"image_labels": labels, "image_labels_valid": valid}


def check_weak_losses(what: str, losses: dict, image_keys) -> None:
    """Every loss finite; the image losses positive; every other loss
    (CenterNet, box, mask) exactly 0."""
    values = {k: float(v.detach()) for k, v in losses.items()}
    bad = {k: v for k, v in values.items() if not math.isfinite(v)
           or (k in image_keys) != (v != 0.0) or (k in image_keys and v <= 0)}
    if bad or not set(image_keys) <= set(values):
        raise AssertionError(f"{what}: losses {values}")


def backbone_grad_moved(model) -> bool:
    return any(p.grad is not None and bool(p.grad.abs().max() > 0)
               for p in model.bottom_up.parameters())


def flagship_weak_steps(card: str, snapshot, zeroshot: bool) -> list:
    """(a) Weak steps of the flagship (``flagship_cfg``: Swin-L, 1453
    classes, 896², B = 2, bf16 over float32 parameters, AdamW, clipping, EMA,
    remat) on an image-labelled batch: the forward through
    ``CustomRCNN.forward(ann_type=…)``, the backward, AdamW and EMA
    (``train_loop.apply_losses``). ``zeroshot`` builds the zero-shot
    classifier with ``WITH_CAPTION`` (a captiontag step on a random (2, 512)
    ``cap_emb``, then a step with the dynamic classifier over the image
    labels); otherwise the linear classifier takes a step of each of
    ``WEAK_STEPS``, the strategy set on the heads' config between steps (the
    cascade builds no WSDDN branch, as in JAX: its ``wsddn`` step with
    ``with_softmax_prop`` takes the class scores as proposal scores).
    Each step: finite losses, the CenterNet, box and mask losses exactly 0,
    the image losses positive, the backbone's gradients non-zero, exactly
    ``WEAK_LAUNCHES`` of kernel 5. Returns the (label, ms) of each step."""
    import dataclasses

    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.engine.train_loop import apply_losses

    cfg = graft_entry.flagship_cfg()
    cfg.merge_from_list(["WITH_IMAGE_LABELS", True, "MODEL.ROI_BOX_HEAD.ADD_IMAGE_BOX", True])
    if zeroshot:
        cfg.merge_from_list(["MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS", True,
                             "MODEL.WITH_CAPTION", True])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, (state, batch, rng) = graft_entry._train_parts(cfg, torch.device("cuda"),
                                                     cfg.INPUT.TRAIN_SIZE, 2, 20, None)
    model, heads = state.model, state.model.roi_heads
    classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    gen = torch.Generator().manual_seed(graft_entry.SEED)
    gt = dict(batch["gt"], **weak_labels(2, classes, gen, "cuda"))
    cap = torch.randn(2, cfg.MODEL.ROI_BOX_HEAD.ZEROSHOT_WEIGHT_DIM, generator=gen).cuda()
    torch.cuda.synchronize()
    log(f"  flagship weak state ({'zero-shot, captions' if zeroshot else 'linear'} classifier)"
        f" built in {time.perf_counter() - t0:.1f} s")
    image_keys = [f"image_loss_stage{s}" for s in range(heads.num_stages)]
    base = heads.cfg
    out = []
    for label, changes, ann_type in (ZEROSHOT_WEAK_STEPS if zeroshot else WEAK_STEPS):
        heads.cfg = dataclasses.replace(base, image_label_loss="max_size" if zeroshot else label,
                                        **changes)
        model.dynamic_classifier = label == "dynamic classifier"
        before = snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = model(batch["image"], batch["image_size"], gt=gt, rng=rng,
                       fed_weight=batch["fed_weight"], training=True, ann_type=ann_type,
                       cap_emb=cap if ann_type == "captiontag" else None)
        metrics = apply_losses(state, losses, 0.999)
        values = {k: float(v) for k, v in metrics.items()}  # synchronizes
        ms = 1e3 * (time.perf_counter() - t0)
        launched = launched_since(before, snapshot)
        check_weak_losses(f"weak step {label}", losses, image_keys)
        want = path_launches(WEAK_LAUNCHES, 1)
        if launched != want or not backbone_grad_moved(model) or not math.isfinite(
                values["grad_norm"]):
            raise AssertionError(f"weak step {label}: launches {launched} (expected {want}), "
                                 f"backbone gradients moved {backbone_grad_moved(model)}, "
                                 f"grad_norm {values['grad_norm']}")
        log(f"    weak step {label} (ann_type {ann_type}): "
            + ", ".join(f"{k} {values[k]:.4f}" for k in image_keys)
            + f", grad_norm {values['grad_norm']:.4f}; {ms:.1f} ms; launches {launched} [{card}]")
        out.append((label, ms))
    model.dynamic_classifier = False
    log(f"    peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del state, model, heads, batch
    torch.cuda.empty_cache()
    return out


def small_weak_losses(device: str, kind: str):
    """(b) One float32 weak forward and backward of the JAX dryrun's model
    (``_small_cfg()``: ResNet-18 + FPN, 64²) on ``device``: weights drawn on
    the CPU (``fast_init_``), a seeded batch. Returns (losses, {name: grad})."""
    from divergen_tpu_torch import graft_entry

    cfg = graft_entry._small_cfg()
    cfg.merge_from_list(["WITH_IMAGE_LABELS", True, "MODEL.ROI_BOX_HEAD.ADD_IMAGE_BOX", True,
                         "MODEL.ROI_BOX_HEAD.WS_NUM_PROPS", 16,
                         "MODEL.ROI_BOX_HEAD.IMAGE_LABEL_LOSS", kind,
                         "MODEL.ROI_BOX_HEAD.WITH_SOFTMAX_PROP", kind == "wsddn",
                         "MODEL.CENTERNET.POST_NMS_TOPK_TRAIN", 16])
    model = graft_entry.build_model(cfg, input_size=(64, 64), device="cpu",
                                    param_dtype=torch.float32)
    graft_entry.fast_init_(model, torch.Generator().manual_seed(graft_entry.SEED))
    model = model.to(device).train()
    rng = np.random.RandomState(graft_entry.SEED)
    images = torch.from_numpy(rng.rand(2, 64, 64, 3).astype(np.float32) * 255).to(device)
    gt = graft_entry._synth_gt(rng, 2, 8, 8, img=64, device=device)
    gt.update(weak_labels(2, 8, torch.Generator().manual_seed(1), device))
    losses = model(images, torch.tensor([[64, 64], [56, 48]], device=device), gt=gt,
                   rng=torch.Generator().manual_seed(2), training=True, ann_type="image")
    sum(losses.values()).backward()
    grads = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def small_weak_card_vs_cpu(card: str) -> None:
    """(b) ``small_weak_losses`` of ``max_size`` and ``wsddn`` on the card
    against the CPU: every loss within ``DRYRUN_BOUNDS["loss"]`` relative, the
    gradients' global norm within ``DRYRUN_BOUNDS["grad_norm"]``; the largest
    per-parameter gap (of that parameter's max |CPU gradient|) printed."""
    for kind in ("max_size", "wsddn"):
        got, got_g = small_weak_losses("cuda", kind)
        want, want_g = small_weak_losses("cpu", kind)
        norm = lambda g: math.sqrt(sum(float((v.double() ** 2).sum()) for v in g.values()))
        worst = max(float((got_g[n] - w).abs().max() / w.abs().max().clamp(min=1e-30))
                    for n, w in want_g.items())
        bad = [k for k, w in want.items()
               if abs(got[k] - w) > DRYRUN_BOUNDS["loss"] * abs(w)]
        gn, gn_ref = norm(got_g), norm(want_g)
        log(f"    (b) float32 {kind} step, ResNet-18 at 64², card against CPU: image losses "
            + ", ".join(f"{got[k]:.8f} / {want[k]:.8f}" for k in sorted(want)
                        if k.startswith("image_loss"))
            + f"; gradient norm {gn:.8f} / {gn_ref:.8f}; largest per-parameter gap "
            f"{worst:.3g} of its max |gradient| [{card}]")
        if (bad or set(got_g) != set(want_g) or abs(gn - gn_ref) > DRYRUN_BOUNDS["grad_norm"] * gn_ref
                or not any(k.startswith("image_loss") and want[k] > 0 for k in want)):
            raise AssertionError(f"small weak step {kind}: losses {bad} outside "
                                 f"{DRYRUN_BOUNDS}, gradient norm {gn} against {gn_ref}")


def res5_weak_step(card: str, snapshot) -> None:
    """(c) ``Res5ROIHeads.image_label_losses`` on ``configs/BSGAL_R50.yaml``'s
    model (ResNet-50 + FPN, 640², B = 2, bf16 over float32 parameters) with
    the Res5 heads on p4, ``wsddn`` on its proposal-score branch: one step
    (forward, backward, AdamW, EMA), finite losses, ``image_loss`` positive,
    the rest 0, the backbone's gradients non-zero, no kernel launch."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.config import get_cfg
    from divergen_tpu_torch.engine.train_loop import apply_losses

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                     "BSGAL_R50.yaml"))
    cfg.merge_from_list(["FP16", True, "MODEL.ROI_HEADS.NAME", "CustomRes5ROIHeads",
                         "MODEL.ROI_HEADS.IN_FEATURES", "['p4']", "WITH_IMAGE_LABELS", True,
                         "MODEL.ROI_BOX_HEAD.IMAGE_LABEL_LOSS", "wsddn",
                         "MODEL.ROI_BOX_HEAD.WITH_SOFTMAX_PROP", True,
                         "MODEL.ROI_BOX_HEAD.ADD_IMAGE_BOX", True])
    size = cfg.INPUT.TRAIN_SIZE
    torch.cuda.empty_cache()
    _, (state, batch, rng) = graft_entry._train_parts(cfg, torch.device("cuda"), size, 2, 20,
                                                     (size, size))
    gen = torch.Generator().manual_seed(graft_entry.SEED)
    gt = dict(batch["gt"], **weak_labels(2, cfg.MODEL.ROI_HEADS.NUM_CLASSES, gen, "cuda"))
    before = snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = state.model(batch["image"], batch["image_size"], gt=gt, rng=rng, training=True,
                         ann_type="image")
    metrics = apply_losses(state, losses, 0.999)
    values = {k: float(v) for k, v in metrics.items()}
    ms = 1e3 * (time.perf_counter() - t0)
    check_weak_losses("Res5 weak step", losses, ["image_loss"])
    launched = launched_since(before, snapshot)
    if launched or not backbone_grad_moved(state.model) or not hasattr(
            state.model.roi_heads.box_predictor, "prop_score_out"):
        raise AssertionError(f"Res5 weak step: launches {launched}, backbone gradients moved "
                             f"{backbone_grad_moved(state.model)}")
    log(f"    (c) configs/BSGAL_R50.yaml with CustomRes5ROIHeads, wsddn on the proposal-score "
        f"branch, {size}², B = 2: image_loss {values['image_loss']:.4f}, grad_norm "
        f"{values['grad_norm']:.4f}, {ms:.1f} ms (first step), no kernel launch [{card}]")
    del state, batch
    torch.cuda.empty_cache()


def dino_phase(card: str, tmp: str) -> None:
    """(d) DINOv2 on crops of the six 640 x 480 JPEG fixtures (64, in four
    category folders): ``extract_features --method dinov2 --dino_model
    vitg14`` on the card (float32, as the JAX CLI), then
    ``DinoEncoder("vitg14")`` in bf16 at 224², B = 64 (images/s after a
    warm-up batch, peak memory); finite, unit-norm embeddings; then vits14 on
    the card against the same weights on the CPU (``DINO_VITS_BOUND``)."""
    from divergen_tpu_torch.pipeline.filteration import cli as fcli
    from divergen_tpu_torch.pipeline.filteration.core import DinoEncoder, load_masked_image
    from divergen_tpu_torch.utils.image_io import read_rgb
    from divergen_tpu_torch.utils.png import write_png

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        names = json.load(f)["lvis_images"]
    rng = np.random.RandomState(0)
    crops_dir, paths = os.path.join(tmp, "dino_crops"), []
    for k in range(DINO_CROPS):
        img = read_rgb(os.path.join(FIXTURES, names[k % len(names)]))
        h, w = rng.randint(64, 320), rng.randint(64, 320)
        y, x = rng.randint(0, img.shape[0] - h), rng.randint(0, img.shape[1] - w)
        cat = os.path.join(crops_dir, f"cat{k % 4}")
        os.makedirs(cat, exist_ok=True)
        paths.append(os.path.join(cat, f"{k:03d}.png"))
        write_png(paths[-1], img[y:y + h, x:x + w])
    t0 = time.perf_counter()
    if fcli.extract_features(["--in_dir", crops_dir, "--out_dir", crops_dir + "_feat",
                              "--method", "dinov2", "--dino_model", "vitg14", "--batch",
                              str(DINO_CROPS), "--device", "cuda"]) != 0:
        raise AssertionError("extract_features --method dinov2 failed")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    feats = np.stack([np.load(p.replace(crops_dir, crops_dir + "_feat")[:-4] + ".npy")
                      for p in paths])
    norms = np.linalg.norm(feats, axis=1)
    if feats.shape != (DINO_CROPS, 1536) or not np.isfinite(feats).all() or np.abs(
            norms - 1).max() > 1e-4:
        raise AssertionError(f"extract_features --method dinov2: {feats.shape}, norms "
                             f"{norms.min()}..{norms.max()}")
    images = np.stack([load_masked_image(p)[0] for p in paths])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    enc = DinoEncoder("vitg14", batch=DINO_CROPS, device="cuda", dtype=torch.bfloat16)
    emb = enc.encode_images(images)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        emb = enc.encode_images(images)
    rate = reps * DINO_CROPS / (time.perf_counter() - t0)
    norms = np.linalg.norm(emb, axis=1)
    if not np.isfinite(emb).all() or np.abs(norms - 1).max() > 1e-4:
        raise AssertionError(f"DinoEncoder bf16: norms {norms.min()}..{norms.max()}")
    log(f"    (d) extract_features --method dinov2 (vitg14, float32, built and run) on "
        f"{DINO_CROPS} fixture crops in {cli_s:.2f} s; DinoEncoder(vitg14) bf16 at 224², "
        f"B = {DINO_CROPS}: {rate:.1f} images/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del enc
    torch.cuda.empty_cache()
    cpu = DinoEncoder("vits14", batch=8, device="cpu")
    gpu = DinoEncoder("vits14", batch=8, device="cuda")
    gpu.model.load_state_dict(cpu.model.state_dict())
    want, got = cpu.encode_images(images[:8]), gpu.encode_images(images[:8])
    err = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"    (d) vits14 float32, card against CPU on 8 crops: max |diff| / max |ref| "
        f"{err:.3g} (bound {DINO_VITS_BOUND}) [{'ok' if err <= DINO_VITS_BOUND else 'FAIL'}]")
    if err > DINO_VITS_BOUND:
        raise AssertionError("DinoEncoder vits14: the card disagrees with the CPU")


def cityscapes_ground_truth(pred_dir: str, gt_dir: str, height: int, width: int,
                            stem: str) -> int:
    """The predictions of one image as its Cityscapes ground truth: pixels go
    to the dump's masks in order (a mask keeps what earlier ones left), each
    kept region of at least ``MIN_REGION_SIZE`` pixels becomes an instance
    (label · 1000 + its number) and the mask file is rewritten to exactly
    that region; smaller ones leave the dump. Writes
    ``<stem>_gtFine_instanceIds.png`` (16-bit, road elsewhere) with the port's
    writer. Returns (the instances kept, the masks dumped)."""
    from divergen_tpu_torch.evaluation.cityscapes_instance_scoring import MIN_REGION_SIZE
    from divergen_tpu_torch.utils.png import read_png, write_png

    txt = os.path.join(pred_dir, f"{stem}_pred.txt")
    ids = np.full((height, width), 7, np.uint16)  # road
    kept, count = [], {}
    lines = open(txt).read().splitlines()
    for line in lines:
        png, label, _ = line.split()
        own = (read_png(os.path.join(pred_dir, png)) > 0) & (ids == 7)
        if own.sum() < MIN_REGION_SIZE:
            continue
        count[label] = count.get(label, 0) + 1
        ids[own] = int(label) * 1000 + count[label]
        write_png(os.path.join(pred_dir, png), own.astype(np.uint8) * 255)
        kept.append(line + "\n")
    with open(txt, "w") as f:
        f.writelines(kept)
    os.makedirs(os.path.join(gt_dir, "synth"), exist_ok=True)
    write_png(os.path.join(gt_dir, "synth", f"{stem}_gtFine_instanceIds.png"), ids)
    return len(kept), len(lines)


def evaluation_phase(card: str, tmp: str, snapshot) -> None:
    """(e) The flagship (bf16, seeded weights) on the serving slice's
    synthetic LVIS set (16 PNG images, 1453 categories): first
    ``inference_on_dataset_exp`` (a ``det_<id>.npz`` per image with its
    boxes, scores, classes and (n, 1453) logits, and the evaluator's logits
    files; AP finite), then ``LVISToCityscapesInstanceEvaluator`` over the
    same images (every 5th LVIS class mapped to a Cityscapes thing label):
    the ``*_pred.txt`` dump scored by the native scorer against a 16-bit
    ground truth the port writes from the predictions (``cityscapes_ground_
    truth``): AP 1. Exactly 24 kernel-5 launches a forward of B = 8. Prints
    s per image of each."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from divergen_tpu_torch.data.dataset_mapper import DatasetMapper
    from divergen_tpu_torch.data.datasets.lvis import lvis_meta_from_json, register_lvis_instances
    from divergen_tpu_torch.data.datasets.synthetic_lvis import write_synthetic_lvis
    from divergen_tpu_torch.engine import eval_loop
    from divergen_tpu_torch.evaluation.cityscapes_eval import (
        CITYSCAPES_THING_LABELS, LVISToCityscapesInstanceEvaluator)
    from divergen_tpu_torch.utils.transfer import to_device, to_host

    model, _ = graft_entry.flagship_entry()
    cfg = graft_entry.flagship_cfg()
    classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    files = write_synthetic_lvis(os.path.join(tmp, "lvis_weak"),
                                 [SERVING_SIZES[k % 4] for k in range(SERVING_IMAGES)], classes,
                                 seed=graft_entry.SEED, category_ids=range(1, 61))
    name = SYNTH_LVIS + "_exp"
    for reg in (DatasetCatalog, MetadataCatalog):
        reg.remove(name)
    register_lvis_instances(name, lvis_meta_from_json(files["json_file"]), files["json_file"],
                            files["image_root"])
    out_dir = os.path.join(tmp, "exp")
    before = snapshot()
    t0 = time.perf_counter()
    metrics = eval_loop.inference_on_dataset_exp(model, None, cfg, name, out_dir)
    exp_s = (time.perf_counter() - t0) / SERVING_IMAGES
    launched = launched_since(before, snapshot)
    forwards = -(-SERVING_IMAGES // 8)
    dets = sorted(f for f in os.listdir(out_dir) if f.startswith("det_"))
    n_dets = 0
    for f in dets:
        with np.load(os.path.join(out_dir, f)) as z:
            n = len(z["scores"])
            n_dets += n
            if (z["boxes"].shape != (n, 4) or z["logits"].shape != (n, classes)
                    or z["classes"].shape != (n,) or not all(
                        np.isfinite(z[k]).all() for k in ("boxes", "scores", "logits"))):
                raise AssertionError(f"inference_on_dataset_exp: {f} holds "
                                     f"{ {k: z[k].shape for k in z.files} }")
    finite = all(math.isfinite(metrics[t]["AP"]) for t in ("bbox", "segm"))
    if (len(dets) != SERVING_IMAGES or not n_dets or not finite
            or launched != {"fused_window_attention_packed": 24 * forwards}):
        raise AssertionError(f"inference_on_dataset_exp: {len(dets)} det files, {n_dets} "
                             f"detections, AP {metrics}, launches {launched}")
    log(f"    (e) inference_on_dataset_exp on {SERVING_IMAGES} synthetic LVIS images: "
        f"{n_dets} detections with (n, {classes}) logits in {len(dets)} det_*.npz, bbox AP "
        f"{metrics['bbox']['AP']:.4f}, segm AP {metrics['segm']['AP']:.4f}; {exp_s:.4f} s per "
        f"image; launches {launched} [{card}]")

    mapper_json = os.path.join(tmp, "lvis_to_cityscapes.json")
    with open(mapper_json, "w") as f:
        json.dump({str(c): CITYSCAPES_THING_LABELS[(c // 5) % 8][1]
                   for c in range(0, classes, 5)}, f)
    pred_dir, gt_dir = os.path.join(tmp, "cs_pred"), os.path.join(tmp, "cs_gt")
    ev = LVISToCityscapesInstanceEvaluator(mapper_json, pred_dir, gt_dir=gt_dir)
    ev.reset()
    dataset = DatasetCatalog.get(name)
    before = snapshot()
    t0 = time.perf_counter()
    for samples, images, sizes in eval_loop._batches(dataset, DatasetMapper(cfg, is_train=False), 8):
        dev = to_device({"images": images, "sizes": sizes.astype(np.int64)}, torch.device("cuda"))
        with torch.no_grad():
            ev.process(samples, to_host(model(dev["images"], dev["sizes"])))
    cs_s = (time.perf_counter() - t0) / SERVING_IMAGES
    launched = launched_since(before, snapshot)
    instances = dumped = 0
    for rec in dataset:  # the mapper keeps no file name: the dump is named by image id
        kept, masks = cityscapes_ground_truth(pred_dir, gt_dir, rec["height"], rec["width"],
                                              str(rec["image_id"]))
        instances, dumped = instances + kept, dumped + masks
    res = ev.evaluate()["segm"]
    log(f"    (e) LVISToCityscapesInstanceEvaluator: {dumped} mapped masks in "
        f"{SERVING_IMAGES} *_pred.txt, {cs_s:.4f} s per image (forward, paste, PNG writes); "
        f"{instances} of them of at least 100 own pixels as the 16-bit ground truth, the "
        f"native scorer against it: AP {res['AP']:.2f}, "
        f"AP50 {res['AP50']:.2f} ({res.get('scorer', 'cityscapesscripts')}) [{card}]")
    if (not instances or res["AP"] != 100.0 or res["AP50"] != 100.0
            or launched != {"fused_window_attention_packed": 24 * forwards}):
        raise AssertionError(f"Cityscapes: {instances} instances, {res}, launches {launched}")
    for reg in (DatasetCatalog, MetadataCatalog):
        reg.remove(name)
    del model
    torch.cuda.empty_cache()


def rotated_phase(card: str) -> None:
    """(f) ``pairwise_iou_rotated`` and ``nms_rotated`` on ``ROTATED_BOXES``
    boxes (200 clusters of 10 around random centres over 2000 px, angles
    anywhere) on the card against the CPU: the card's float32 IoU as close
    to the float64 IoU as the CPU's float32 (``ROTATED_IOU_BOUND``), the
    same keep mask at thresholds 0.3 and 0.7; ms of each on the card."""
    from divergen_tpu_torch.ops.rotated import nms_rotated, pairwise_iou_rotated

    rng = np.random.RandomState(0)
    centres = np.concatenate([rng.rand(200, 2) * 2000, rng.rand(200, 2) * 60 + 10,
                              rng.rand(200, 1) * 360 - 180], 1)
    boxes = np.repeat(centres, ROTATED_BOXES // 200, 0) + np.concatenate(
        [rng.randn(ROTATED_BOXES, 2) * 6, rng.randn(ROTATED_BOXES, 2) * 3,
         rng.randn(ROTATED_BOXES, 1) * 10], 1)
    boxes[:, 2:4] = np.abs(boxes[:, 2:4]) + 1
    boxes = torch.from_numpy(boxes.astype(np.float32))
    scores = torch.from_numpy(rng.rand(ROTATED_BOXES).astype(np.float32))
    gb, gs = boxes.cuda(), scores.cuda()
    iou_ms = time_one(lambda: pairwise_iou_rotated(gb, gb), reps=3)
    got = pairwise_iou_rotated(gb, gb).cpu()
    want = pairwise_iou_rotated(boxes, boxes)
    exact = pairwise_iou_rotated(boxes.double(), boxes.double())
    err, cpu_err = (float((x.double() - exact).abs().max()) for x in (got, want))
    overlapping = int((want > 0).sum()) - ROTATED_BOXES
    keeps = []
    for thresh in (0.3, 0.7):
        nms_ms = time_one(lambda: nms_rotated(gb, gs, thresh), reps=3)
        k_got, k_want = nms_rotated(gb, gs, thresh).cpu(), nms_rotated(boxes, scores, thresh)
        keeps.append((thresh, int(k_want.sum()), int((k_got != k_want).sum()), nms_ms))
    log(f"    (f) {ROTATED_BOXES} rotated boxes ({overlapping} overlapping ordered pairs): IoU "
        f"max |card - float64| {err:.3g}, |CPU - float64| {cpu_err:.3g}, |card - CPU| "
        f"{float((got - want).abs().max()):.3g} (bound max(2 x the CPU's, "
        f"{ROTATED_IOU_BOUND})), {iou_ms:.2f} ms on the card; "
        + "; ".join(f"NMS at {t}: {k} kept, {d} differ, {ms:.2f} ms" for t, k, d, ms in keeps)
        + f" [{card}]")
    if (err > max(2 * cpu_err, ROTATED_IOU_BOUND) or any(d for _, _, d, _ in keeps)
            or overlapping < ROTATED_BOXES):
        raise AssertionError("rotated boxes: the card disagrees with the CPU")


def slice_weak_supervision(card: str, tmp: str, snapshot) -> None:
    """Slice 13: (a) the flagship's weak steps (``flagship_weak_steps``,
    linear then zero-shot classifier), (b) the float32 weak step card
    against CPU, (c) the Res5 heads' weak step, (d) DINOv2, (e)
    ``inference_on_dataset_exp`` and the Cityscapes evaluator, (f) rotated
    IoU and NMS."""
    steps = flagship_weak_steps(card, snapshot, zeroshot=False)
    steps += flagship_weak_steps(card, snapshot, zeroshot=True)
    log("    (a) ms per weak step (host clock, one step each, the first includes warm-up): "
        + ", ".join(f"{label} {ms:.1f}" for label, ms in steps) + f" [{card}]")
    small_weak_card_vs_cpu(card)
    res5_weak_step(card, snapshot)
    dino_phase(card, tmp)
    evaluation_phase(card, tmp, snapshot)
    rotated_phase(card)


def packed_twin(qkv: torch.Tensor, heads: int, rows: int = 4096) -> torch.Tensor:
    """``reference_attention_packed`` in float32, one batch element and
    ``rows`` queries at a time: a whole call's scores do not fit the card at
    the upscaler's 16384 tokens."""
    from divergen_tpu_torch.ops.flash_attention import reference_attention

    b, n, c3 = qkv.shape
    c = c3 // 3
    out = torch.empty((b, n, c), device=qkv.device)
    for i in range(b):
        q, k, v = (qkv[i, :, s * c:(s + 1) * c].float().reshape(n, heads, -1).transpose(0, 1)
                   for s in range(3))
        for r in range(0, n, rows):
            out[i, r:r + rows] = reference_attention(q[:, r:r + rows], k, v).transpose(
                0, 1).reshape(-1, c)
    return out


def bhsd_twin(q, k, v, rows: int = 4096) -> torch.Tensor:
    """``reference_attention`` in float32, ``rows`` queries at a time (65536²
    float32 scores are 17 GB a head)."""
    from divergen_tpu_torch.ops.flash_attention import reference_attention

    out = torch.empty(q.shape, device=q.device)
    for r in range(0, q.shape[1], rows):
        out[:, r:r + rows] = reference_attention(q[:, r:r + rows].float(), k.float(), v.float())
    return out


def upscaler_kernel_phases(gen: torch.Generator, card: str, results: dict) -> None:
    """Kernels 1, 2 and 3 at the x4 upscaler's shapes (256² → 1024², B = 2):
    each against its float32 twin (computed a block of queries at a time),
    the same bits twice, its device time beside the PyTorch call's and the
    bound, and kernels 1 and 2 summed over an upscaler UNet call's 16
    launches each."""
    import divergen_tpu_torch.ops.flash_attention as fa_mod
    import divergen_tpu_torch.ops.ln_matmul as ln_mod

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).bfloat16()

    def fold(kernel, err):
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    def report(what, run, library, ops, nbytes, launches, sums):
        dev_ms = device_ms(run, reps=5)
        lib_ms = device_ms(library, reps=5) if library is not None else float("nan")
        b_ms, by = bound(ops, nbytes)
        for key, t in (("kernel", dev_ms), ("PyTorch call", lib_ms), ("bound", b_ms)):
            sums[key] = sums.get(key, 0.0) + t * launches
        log(f"    {what}: device {dev_ms:.4f} ms ({ops / dev_ms / 1e9:.0f} TFLOP/s), PyTorch "
            f"call {lib_ms:.4f} ms, bound {b_ms:.4f} ms by {by}; {launches} launches per "
            f"upscaler UNet call [{card}]")

    log("kernel phase: flash_attention_packed at the x4 upscaler's shapes")
    sums = {}
    for (b, n, c, h), launches in UPSCALER_ATTN_LAUNCHES.items():
        qkv = randn(b, n, 3 * c)
        run = lambda: fa_mod.flash_attention_packed(qkv, h, softmax_mode="rawmax")
        got = run()
        name = f"packed B={b} N={n} C={c} H={h} bf16 (x4 upscaler)"
        fold("flash_attention_packed", compare(name, got, packed_twin(qkv, h)))
        same_bits(name, got, run)
        q4, k4, v4 = (t.reshape(b, n, h, c // h).transpose(1, 2).contiguous()
                      for t in qkv.chunk(3, dim=-1))
        report("upscaler shape", run, lambda: F.scaled_dot_product_attention(q4, k4, v4),
               4.0 * b * h * n * n * (c // h), 2.0 * b * n * 4 * c, launches, sums)
        del qkv, q4, k4, v4, got
        torch.cuda.empty_cache()
    log(f"  flash_attention_packed over an upscaler UNet call's {UPSCALER_CALL['flash_attention_packed']} "
        f"launches: kernel {sums['kernel']:.3f} ms, SDPA {sums['PyTorch call']:.3f} ms, bound "
        f"{sums['bound']:.3f} ms [{card}]")

    log("kernel phase: fused_ln_matmul (GEGLU) at the x4 upscaler's shapes")
    sums = {}
    for (m, k, n), launches in UPSCALER_GEGLU_LAUNCHES.items():
        x, w = randn(m, k, scale=2.0), randn(n, k, scale=k ** -0.5).t()
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        beta = 0.1 * torch.randn(k, generator=gen, device=dev)
        bias = 0.1 * torch.randn(n, generator=gen, device=dev)
        run = lambda: ln_mod.fused_ln_matmul(x, w, gamma, beta, 1e-5, bias, True)
        got = run()
        name = f"ln_matmul geglu M={m} K={k} N={n} bf16 (x4 upscaler)"
        ref = ln_mod.ln_matmul_reference(x.float(), w.float(), gamma, beta, 1e-5, bias, True)
        fold("fused_ln_matmul", compare(name, got, ref))
        del ref
        same_bits(name, got, run)
        gl, bl, wt, bias_l = gamma.bfloat16(), beta.bfloat16(), w.t(), bias.bfloat16()

        def library():
            hidden, gate = F.linear(F.layer_norm(x, (k,), gl, bl, 1e-5), wt, bias_l).chunk(2, -1)
            return hidden * F.gelu(gate)

        report("upscaler shape", run, library, 2.0 * m * k * n,
               2.0 * (m * k + k * n + m * n // 2) + 8.0 * k + 4.0 * n, launches, sums)
        del x, w, got
        torch.cuda.empty_cache()
    log(f"  fused_ln_matmul over an upscaler UNet call's {UPSCALER_CALL['fused_ln_matmul']} "
        f"launches: kernel {sums['kernel']:.3f} ms, PyTorch call {sums['PyTorch call']:.3f} ms, "
        f"bound {sums['bound']:.3f} ms [{card}]")

    log("kernel phase: flash_attention at the x4 VAE's mid attention, (2, 65536, 512)")
    bh, s, d = 2, 65536, 512
    q, k, v = randn(bh, s, d), randn(bh, s, d), randn(bh, s, d)
    run = lambda: fa_mod.flash_attention(q, k, v)
    got = run()
    name = f"flash BH={bh} Sq={s} Sk={s} D={d} bf16 (x4 VAE)"
    fold("flash_attention", compare(name, got, bhsd_twin(q, k, v)))
    same_bits(name, got, run)
    library = None
    try:  # the memory-efficient SDPA takes d = 512; the math one would not fit
        from torch.nn.attention import SDPBackend, sdpa_kernel

        q4, k4, v4 = q[None], k[None], v[None]

        def library():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(q4, k4, v4)

        library()
    except RuntimeError as err:
        log(f"    PyTorch call: SDPA has no kernel for this shape here ({str(err)[:120]})")
        library = None
    report("x4 VAE shape", run, library, 4.0 * bh * s * s * d, 2.0 * bh * d * 2 * (s + s), 1, {})
    del q, k, v, got
    torch.cuda.empty_cache()


def hash_states(prompts, width: int) -> torch.Tensor:
    """The CLI's hash-seeded text states (no text checkpoint), on the card."""
    from divergen_tpu_torch.pipeline.generation.txt2img import encode_prompts_random

    return encode_prompts_random(prompts, width).cuda()


def expect_launches(what: str, before: dict, snapshot, want: dict) -> None:
    got = launched_since(before, snapshot)
    want = {k: n for k, n in want.items() if n}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    log(f"  {what}: launches as expected, {want or 'none'}")


def check_images(what: str, imgs: torch.Tensor, shape, lo: float, hi: float) -> None:
    if tuple(imgs.shape) != shape:
        raise AssertionError(f"{what}: images {tuple(imgs.shape)}, expected {shape}")
    if not torch.isfinite(imgs).all() or imgs.min() < lo or imgs.max() > hi:
        raise AssertionError(f"{what}: images not finite in [{lo}, {hi}]")
    log(f"  {what}: images {shape}, finite, range [{imgs.min().item():.3f}, "
        f"{imgs.max().item():.3f}], std {imgs.float().std().item():.4f}")


def tiny_if_card_vs_cpu() -> None:
    """``txt2img --tiny``'s stage-I UNet in float32, three steps of
    ``IFStageIPipeline.denoise`` on the card and on the CPU from the same
    weights, latents, contexts and per-step noise."""
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.pipeline.generation.if_unet import IFStageIPipeline, IFUNet

    tiny = dict(channels=(8, 16), layers_per_block=1, encoder_dim=16, head_dim=4, pool_heads=2)
    cpu = flax_init_(IFUNet(**tiny), torch.Generator().manual_seed(5))
    card = IFUNet(**tiny, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    lat = rng.randn(2, 16, 16, 3).astype(np.float32)
    ctx2 = rng.randn(4, 5, 16).astype(np.float32)
    noises = [rng.randn(2, 16, 16, 3).astype(np.float32) for _ in range(3)]
    outs = []
    for unet in (cpu, card):
        dev = unet.conv_out.weight.device
        pipe = IFStageIPipeline(unet, steps=3)
        pipe.step_noise = lambda g, shape, i, dev=dev: torch.from_numpy(noises[i]).to(dev)
        outs.append(pipe.denoise(torch.from_numpy(lat).to(dev), torch.from_numpy(ctx2).to(dev),
                                 None).cpu())
    err = (outs[1] - outs[0]).abs().max().item()
    log(f"  float32 tiny stage I, 3 steps, card vs CPU: max |diff| {err:.3g} "
        f"(bound {IF_RANGE_BOUND:g}, 1e-4 of the [-1, 1] range)")
    if not err <= IF_RANGE_BOUND:
        raise AssertionError(f"tiny stage I on the card differs from the CPU by {err}")


def slice_if_cascade(card: str, tmp: str, pipe, cond, bf16_images, snapshot):
    """The IF cascade and the x4 upscaler at full width, bf16, seeded random
    weights, B = 2, then the CLI's IF, x4 and encoder-reuse paths and SDXL
    with encoder reuse. Exact launches per part. Returns the timings, to be
    run after the slice's counts are read."""
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.pipeline.generation import txt2img
    from divergen_tpu_torch.pipeline.generation.if_unet import (IFStageIIPipeline,
                                                                 IFStageIPipeline, IFUNet)
    from divergen_tpu_torch.pipeline.generation.pipeline import SDXLPipeline
    from divergen_tpu_torch.pipeline.generation.upscale import UpscalePipeline, upscaler_unet
    from divergen_tpu_torch.pipeline.generation.vae import VAEDecoder
    from divergen_tpu_torch.utils.png import read_png

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    prompts = ["a photo of a single red apple", "a photo of a single wooden chair"]
    ctx, unc = hash_states(prompts, 4096), hash_states([""] * 2, 4096)
    stage_ms = {}
    img = None
    for stage, build, seed in (("I", IFUNet.if_i_xl, 10), ("II", IFUNet.if_ii_l, 11)):
        t0 = time.perf_counter()
        unet = flax_init_(build(device=dev), gen.manual_seed(seed))
        n_params = sum(p.numel() for p in unet.parameters())
        torch.cuda.reset_peak_memory_stats()
        before = snapshot()
        if stage == "I":
            p = IFStageIPipeline(unet, steps=IF_STEPS)
            run = lambda: p.generate(gen.manual_seed(20), ctx, unc)
            shape = (2, 64, 64, 3)
        else:
            p = IFStageIIPipeline(unet, steps=IF_STEPS)
            low = img
            run = lambda: p.generate(gen.manual_seed(21), low, ctx, unc)
            shape = (2, 256, 256, 3)
        img = run()
        torch.cuda.synchronize()
        check_images(f"IF stage {stage} ({n_params / 1e9:.3f} B parameters, {IF_STEPS} steps, "
                     f"built and run in {time.perf_counter() - t0:.1f} s)", img, shape, -1, 1)
        expect_launches(f"IF stage {stage}", before, snapshot, {})
        stage_ms[stage] = 1e3 * wall_s(run) / IF_STEPS
        log(f"  IF stage {stage}: {stage_ms[stage]:.1f} ms a CFG step (B = 2, UNet batch 4, "
            f"{shape[1]}²), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        del p, unet, run
        torch.cuda.empty_cache()

    unet = flax_init_(upscaler_unet(dtype=torch.bfloat16, device=dev), gen.manual_seed(12))
    vae = flax_init_(VAEDecoder(channels=(128, 256, 512), dtype=torch.bfloat16, device=dev),
                     gen.manual_seed(13))
    up = UpscalePipeline(unet, vae, steps=UPSCALE_STEPS)
    uctx, uunc = hash_states(prompts, 1024), hash_states([""] * 2, 1024)
    low = (img + 1.0) * 127.5
    before = snapshot()
    out = up.upscale(gen.manual_seed(22), low, uctx, uunc)
    torch.cuda.synchronize()
    check_images(f"UpscalePipeline(upscaler_unet()), {UPSCALE_STEPS} steps + x4 decode", out,
                 (2, 1024, 1024, 3), 0, 255)
    expect_launches("UpscalePipeline", before, snapshot,
                    {**{k: n * UPSCALE_STEPS for k, n in UPSCALER_CALL.items()},
                     "flash_attention": 1})
    del out, img
    torch.cuda.empty_cache()

    log("  the CLI: txt2img.main --stages I II; --stages XL x4 at 256²; --encoder_reuse at 512²")
    call = {k: n for k, n in UPSCALER_CALL.items()}
    full, reuse = REUSE_LAUNCHES
    cases = (
        (["--stages", "I", "II", "--steps", str(IF_STEPS)], {"I": 64, "II": 256}, {}),
        (["--stages", "XL", "x4", "--height", "256", "--width", "256", "--steps", str(STEPS),
          "--sampler", "dpmpp_2m"], {"XL": 256, "x4": 1024},
         {k: full * STEPS + n * max(STEPS // 2, 2) for k, n in call.items()}
         | {"flash_attention": 2 + 1}),
        (["--encoder_reuse", "--height", "512", "--width", "512", "--steps", str(STEPS),
          "--sampler", "dpmpp_2m"], {"XL": 512},
         {k: (full + reuse) * STEPS // 2 for k in call} | {"flash_attention": 2}),
    )
    for i, (extra, sizes, want) in enumerate(cases):
        out_dir = os.path.join(tmp, f"if_cli{i}")
        before = snapshot()
        t0 = time.perf_counter()
        rc = txt2img.main(["--prompt", "a photo of a single red apple", "--outdir", out_dir,
                           "--n_samples", "2", "--max_batch_size", "2", *extra])
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"txt2img.main {extra} returned {rc}")
        for stage, size in sizes.items():
            for name in ("prompt_0000000.png", "prompt_0000001.png"):
                got = read_png(os.path.join(out_dir, "samples", stage, name))
                if got.shape != (size, size, 3):
                    raise AssertionError(f"samples/{stage}/{name}: {got.shape}")
        log(f"  txt2img.main {' '.join(extra)}: wrote {sizes} in "
            f"{time.perf_counter() - t0:.1f} s (model builds included)")
        expect_launches(f"txt2img.main {' '.join(extra)}", before, snapshot, want)
        torch.cuda.empty_cache()

    ctx_x, unc_x, pooled, unc_pooled = cond
    pipe_r = SDXLPipeline(pipe.unet, pipe.vae, steps=STEPS, sampler="dpmpp_2m",
                          encoder_reuse=True)
    per_call = []
    forward = pipe.unet.forward

    def counted(*args, **kw):
        b = snapshot()
        res = forward(*args, **kw)
        got = launched_since(b, snapshot)
        per_call.append((got.get("flash_attention_packed", 0), got.get("fused_ln_matmul", 0)))
        return res

    pipe.unet.forward = counted
    try:
        before = snapshot()
        imgs = pipe_r.generate(torch.Generator(device=dev).manual_seed(42), ctx_x, unc_x, pooled,
                               unc_pooled, 1024, 1024)
        torch.cuda.synchronize()
    finally:
        del pipe.unet.forward
    check_images("SDXLPipeline(encoder_reuse=True), 1024²", imgs, (2, 1024, 1024, 3), 0, 255)
    want_calls = [(full, full) if i % 2 == 0 else (reuse, reuse) for i in range(STEPS)]
    if per_call != want_calls:
        raise AssertionError(f"encoder reuse: kernel 1 and 2 launches per UNet call {per_call}, "
                             f"expected {want_calls}")
    expect_launches("SDXLPipeline(encoder_reuse=True)", before, snapshot,
                    {k: (full + reuse) * STEPS // 2 for k in call} | {"flash_attention": 2})
    log(f"    per UNet call (kernel 1, kernel 2): {per_call}; mean |diff| from the exact "
        f"pipeline's images on the same weights and noise "
        f"{(imgs - bf16_images).abs().mean().item():.3f} of 255 (a smoke number)")
    tiny_if_card_vs_cpu()

    def timings():
        lat0 = torch.randn((2, 256, 256, 4), generator=gen.manual_seed(23),
                           device=dev) * up._init_scale
        low_n = low / 127.5 - 1.0
        call_s = statistics.median(wall_s(lambda: up.denoise(lat0, low_n, uctx, uunc))
                                   for _ in range(3)) / UPSCALE_STEPS
        lat = up.denoise(lat0, low_n, uctx, uunc)
        dec_s = statistics.median(wall_s(lambda: up.decode(lat)) for _ in range(3))
        log(f"  x4 upscaler: {1e3 * call_s:.1f} ms a CFG UNet call (UNet batch 4, 256² latents), "
            f"decode {dec_s:.3f} s for 2 images 256² → 1024², medians of 3 [{card}]")
        plain, reused = denoise_in_turns(pipe, pipe_r, cond)
        log(f"  SDXL CFG step (B = 2, 1024², {STEPS} steps, in turns): exact "
            f"{1e3 * statistics.median(plain) / STEPS:.1f} ms, encoder reuse "
            f"{1e3 * statistics.median(reused) / STEPS:.1f} ms (runs {[round(t, 4) for t in plain]}"
            f" / {[round(t, 4) for t in reused]} s) [{card}]")
        log(f"  IF: stage I {stage_ms['I']:.1f} ms a step, stage II {stage_ms['II']:.1f} ms a "
            f"step [{card}]")

    return timings


# ---- slice 14: deployment and DLA's deformable aggregation --------------------
ROOT = os.path.dirname(os.path.abspath(__file__))
EXPORT_WARMUPS, EXPORT_REPS = 2, 10  # forwards of each program before and in its timing
DEPLOY_SHAPES = {"prop_idx": (2, 300), "boxes": (2, 300, 4), "scores": (2, 300),
                 "classes": (2, 300), "valid": (2, 300), "mask_logits": (2, 300, 28, 28)}
# run in a fresh interpreter: load each artifact with no model code, serve it on
# the card, print one JSON line per artifact
SERVE_EXPORTED = r"""
import json, statistics, sys, torch
from divergen_tpu_torch.export import load_exported
from divergen_tpu_torch.ops import window_attention as wa
inputs_path, warmups, reps, *jobs = sys.argv[1:]
inputs = torch.load(inputs_path, map_location="cuda", weights_only=True)
images, sizes = inputs["images"], inputs["sizes"]
packed = wa.fused_window_attention_packed
for art_path, out_path in zip(jobs[::2], jobs[1::2]):
    art = load_exported(art_path)
    args = (images, sizes) if art.baked else (inputs["params"], images, sizes)
    start_launches, start_bodies = packed.launches, dict(packed.bodies)

    def forward():
        before = packed.launches
        out = art(*args)
        torch.cuda.synchronize()
        return out, packed.launches - before

    out, first = forward()
    per_forward = [first] + [forward()[1] for _ in range(int(warmups))]
    times = []
    for _ in range(int(reps)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = packed.launches
        start.record()
        art(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        per_forward.append(packed.launches - before)
    try:
        art(*args[:-2], torch.zeros((2, 448, 448, 3), device="cuda"), sizes)
        wrong_shape = "no error"
    except Exception as e:
        wrong_shape = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    torch.save({k: v.cpu() for k, v in out.items()}, out_path)
    bodies = {f"{k[0]}|{k[1]}": n - start_bodies.get(k, 0) for k, n in packed.bodies.items()
              if n != start_bodies.get(k, 0)}
    model_code = sorted(m for m in sys.modules if m.startswith((
        "divergen_tpu_torch.modeling", "divergen_tpu_torch.config",
        "divergen_tpu_torch.graft_entry", "divergen_tpu_torch.engine", "divergen_tpu.", "jax",
        "flax")))
    print(json.dumps({"artifact": art_path, "platforms": list(art.platforms), "baked": art.baked,
                      "launches": packed.launches - start_launches, "bodies": bodies,
                      "per_forward": per_forward, "ms": statistics.median(times),
                      "wrong_shape": wrong_shape, "model_code": model_code}), flush=True)
    del art, args, out
"""


def events_ms(fn, warmups: int = EXPORT_WARMUPS, reps: int = EXPORT_REPS) -> float:
    """Median ms of ``fn`` (CUDA events) after ``warmups`` calls."""
    for _ in range(warmups):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def per_image(dets: dict, i: int) -> dict:
    keep = dets["valid"][i].cpu().numpy()
    return {k: dets[k][i].float().cpu().numpy()[keep] if k != "classes"
            else dets[k][i].cpu().numpy()[keep] for k in ("boxes", "scores", "classes")}


def deployment_export(card: str, tmp: str, snapshot) -> dict:
    """(a) The flagship exported weights-separate and baked, both artifacts
    loaded and served on the card by one fresh interpreter that imports only
    ``divergen_tpu_torch.export`` and ``.ops`` (``SERVE_EXPORTED``): 24 kernel-5
    launches per forward as the eager forward, the eager detections
    (``same_detections``), a canvas of another shape refused, ms per forward
    against eager's (CUDA events, median of ``EXPORT_REPS`` after
    ``EXPORT_WARMUPS``). Returns the launches that interpreter counted,
    keyed as ``snapshot()`` keys them."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.export import export_inference, save_exported

    model, (images, sizes) = graft_entry.flagship_entry()
    sizes = sizes.to(torch.int32)
    before = snapshot()
    with torch.no_grad():
        eager = model(images, sizes)
    torch.cuda.synchronize()
    launched = launched_since(before, snapshot)
    if launched != {"fused_window_attention_packed": SWIN_L_BLOCKS}:
        raise AssertionError(f"flagship eager forward: launches {launched}")
    for key, shape in DEPLOY_SHAPES.items():
        if tuple(eager[key].shape) != shape:
            raise AssertionError(f"eager {key}: {tuple(eager[key].shape)} != {shape}")
    with torch.no_grad():
        eager_ms = events_ms(lambda: model(images, sizes))
    inputs = os.path.join(tmp, "inputs.pt")
    torch.save({"images": images.cpu(), "sizes": sizes.cpu(),
                "params": {k: v.cpu() for k, v in model.state_dict().items()}}, inputs)
    exported = {}
    for bake in (False, True):
        layout = "baked" if bake else "weights-separate"
        before = snapshot()
        t0 = time.perf_counter()
        exp = export_inference(model, model.state_dict(), batch=2, height=images.shape[1],
                               width=images.shape[2], bake_params=bake)
        export_s = time.perf_counter() - t0
        if launched_since(before, snapshot):
            raise AssertionError(f"{layout} export launched kernels while tracing")
        ops = [str(n.target) for n in exp.programs["cuda"].graph.nodes
               if n.op == "call_function"]
        n_op = ops.count("divergen.window_attention_packed.default")
        n_loops = sum(op.startswith("while_loop") for op in ops)
        if n_op != SWIN_L_BLOCKS or "aten.softmax.int" in ops or "aten._softmax.default" in ops:
            raise AssertionError(f"{layout} program: {n_op} kernel-5 ops, or the plain twin")
        path = save_exported(exp, os.path.join(tmp, f"flagship_{layout}.pt2z"))
        exported[layout] = (path, os.path.join(tmp, f"dets_{layout}.pt"), export_s, n_op, n_loops)
        del exp
    jobs = [p for path, out, *_ in exported.values() for p in (path, out)]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", SERVE_EXPORTED, inputs, str(EXPORT_WARMUPS),
                          str(EXPORT_REPS), *jobs], cwd=ROOT, capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, PYTHONPATH=ROOT))
    serve_s = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"serving the artifacts on the card (rc {res.returncode}):\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-6000:]}")
    served = [json.loads(line) for line in res.stdout.strip().splitlines()[-2:]]
    log(f"    (a) one fresh interpreter loaded and served both artifacts in {serve_s:.1f} s")
    extra = {}
    forwards = 1 + EXPORT_WARMUPS + EXPORT_REPS
    for (layout, (path, out_path, export_s, n_op, n_loops)), got in zip(exported.items(),
                                                                       served):
        if got["artifact"] != path:
            raise AssertionError(f"served {got['artifact']}, expected {path}")
        if (got["per_forward"] != [SWIN_L_BLOCKS] * forwards
                or got["launches"] != SWIN_L_BLOCKS * forwards):
            raise AssertionError(f"{layout} artifact: kernel-5 launches per forward "
                                 f"{got['per_forward']}, expected {SWIN_L_BLOCKS} each")
        if got["model_code"]:
            raise AssertionError(f"{layout} artifact: the loading process imported model code "
                                 f"{got['model_code']}")
        if got["wrong_shape"] == "no error":
            raise AssertionError(f"{layout} artifact took a 448² canvas")
        dets = torch.load(out_path, weights_only=True)
        for key, shape in DEPLOY_SHAPES.items():
            if tuple(dets[key].shape) != shape:
                raise AssertionError(f"{layout} {key}: {tuple(dets[key].shape)} != {shape}")
        pairs = [same_detections(per_image(dets, i), per_image(eager, i)) for i in range(2)]
        equal = all(torch.equal(dets[k], eager[k].cpu()) for k in dets)
        log(f"    (a) {layout}: export {export_s:.1f} s ({n_op} divergen::window_attention_packed "
            f"ops, {n_loops} while_loop ops), artifact {os.path.getsize(path)} bytes; served on "
            f"the card (platforms {got['platforms']}, no model code imported): "
            f"{got['per_forward'][0]} kernel-5 launches a forward, {got['ms']:.2f} ms a forward "
            f"against eager {eager_ms:.2f} ms (CUDA events, median of {EXPORT_REPS} after "
            f"{EXPORT_WARMUPS}); detections against eager: bit-equal {equal}, "
            + "; ".join(f"image {i}: {p['pairs']} of {int(eager['valid'][i].sum())} paired, "
                        f"box gap {p['box_gap']:.3g}, score gap {p['score_gap']:.3g}"
                        for i, p in enumerate(pairs))
            + f"; a 448² canvas: {got['wrong_shape']} [{card}]")
        if not all(p["ok"] for p in pairs):
            raise AssertionError(f"{layout} artifact: detections differ from eager: {pairs}")
        extra["fused_window_attention_packed"] = (extra.get("fused_window_attention_packed", 0)
                                                  + got["launches"])
        for key, n in got["bodies"].items():
            entry, d = key.split("|")
            k = ("fused_window_attention_packed", False, entry, int(d))
            extra[k] = extra.get(k, 0) + n
        os.remove(path)
    del model, eager
    torch.cuda.empty_cache()
    return extra


def synthetic_flagship_checkpoint(seed: int) -> dict:
    """A detectron2-format checkpoint of the flagship (Swin-L-22k-384 + FPN +
    CenterNet2 + the three-stage cascade over 1453 classes + the mask head),
    named and shaped as ``tests/test_torch_port_weights.py``'s
    ``synthetic_swin_state_dict`` and ``synthetic_detector_state_dict`` make
    their state dicts, at full width; random float32 values."""
    rng = np.random.default_rng(seed)
    sd = {}
    f = lambda *s, scale=1.0: rng.standard_normal(s, dtype=np.float32) * np.float32(scale)

    def lin(name, out_f, in_f):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = f(out_f, in_f, scale=in_f ** -0.5), f(out_f,
                                                                                         scale=0.1)

    def ln(name, c):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = 1 + f(c, scale=0.1), f(c, scale=0.1)

    def conv(name, out_c, in_c, k):
        sd[f"{name}.weight"] = f(out_c, in_c, k, k, scale=(in_c * k * k) ** -0.5)
        sd[f"{name}.bias"] = f(out_c, scale=0.1)

    embed, depths, heads, window = 192, (2, 2, 18, 2), (6, 12, 24, 48), 12
    bu = "backbone.bottom_up."
    sd[bu + "patch_embed.proj.weight"] = f(embed, 3, 4, 4, scale=0.1)
    sd[bu + "patch_embed.proj.bias"] = f(embed, scale=0.1)
    ln(bu + "patch_embed.norm", embed)
    dim = embed
    for stage, depth in enumerate(depths):
        for blk in range(depth):
            b = f"{bu}layers.{stage}.blocks.{blk}"
            ln(f"{b}.norm1", dim)
            ln(f"{b}.norm2", dim)
            lin(f"{b}.attn.qkv", 3 * dim, dim)
            lin(f"{b}.attn.proj", dim, dim)
            sd[f"{b}.attn.relative_position_bias_table"] = f((2 * window - 1) ** 2, heads[stage],
                                                             scale=0.5)
            sd[f"{b}.attn.relative_position_index"] = np.zeros((window ** 2,) * 2, np.int64)
            lin(f"{b}.mlp.fc1", 4 * dim, dim)
            lin(f"{b}.mlp.fc2", dim, 4 * dim)
        if stage:
            ln(f"{bu}norm{stage}", dim)
        if stage < len(depths) - 1:
            ln(f"{bu}layers.{stage}.downsample.norm", 4 * dim)
            sd[f"{bu}layers.{stage}.downsample.reduction.weight"] = f(2 * dim, 4 * dim, scale=0.1)
            dim *= 2
    fpn, fc, mask_dim, classes = 256, 1024, 256, 1453
    for s, c in zip((3, 4, 5), (2 * embed, 4 * embed, 8 * embed)):
        conv(f"backbone.fpn_lateral{s}", fpn, c, 1)
        conv(f"backbone.fpn_output{s}", fpn, fpn, 3)
    for p in ("p6", "p7"):
        conv(f"backbone.top_block.{p}", fpn, fpn, 3)
    head = "proposal_generator.centernet_head"
    for j in range(4):
        conv(f"{head}.bbox_tower.{3 * j}", fpn, fpn, 3)
        ln(f"{head}.bbox_tower.{3 * j + 1}", fpn)
    conv(f"{head}.agn_hm", 1, fpn, 3)
    conv(f"{head}.bbox_pred", 4, fpn, 3)
    for level in range(5):
        sd[f"{head}.scales.{level}.scale"] = f(1) + 1.0
    for k in range(3):
        lin(f"roi_heads.box_head.{k}.fc1", fc, fpn * 49)
        lin(f"roi_heads.box_head.{k}.fc2", fc, fc)
        lin(f"roi_heads.box_predictor.{k}.cls_score", classes + 1, fc)
        lin(f"roi_heads.box_predictor.{k}.bbox_pred", 4, fc)
        sd[f"roi_heads.box_predictor.{k}.freq_weight"] = f(classes)
    for i in range(4):
        conv(f"roi_heads.mask_head.mask_fcn{i + 1}", mask_dim, fpn if i == 0 else mask_dim, 3)
    sd["roi_heads.mask_head.deconv.weight"] = f(mask_dim, mask_dim, 2, 2, scale=0.2)
    sd["roi_heads.mask_head.deconv.bias"] = f(mask_dim, scale=0.1)
    conv("roi_heads.mask_head.predictor", 1, mask_dim, 1)
    sd["pixel_mean"] = f(3, 1, 1)
    return sd


def checkpoint_round_trip(card: str, tmp: str, snapshot) -> None:
    """(b) A synthetic detectron2 checkpoint at the flagship's shapes through
    ``tools.import_reference_checkpoint`` (every entry of the model but the
    stride-4 norm a detectron2 Swin lacks filled, nothing skipped), then
    ``tools.convert_imgnet_model_to_lvis`` (1453 -> 1203 classes: each
    ``cls_score`` weight and bias cut to the first 1203 rows and the
    background row, in the model and the EMA copy, nothing else changed), then
    ``tools.export_model --ema --run-sample`` on the card at 1203 classes
    (finite outputs, 24 kernel-5 launches in the sample run)."""
    from divergen_tpu_torch.engine.checkpoint import Checkpointer
    from divergen_tpu_torch.tools import convert_imgnet_model_to_lvis as tconv
    from divergen_tpu_torch.tools import export_model as texp
    from divergen_tpu_torch.tools import import_reference_checkpoint as timport

    config = os.path.join(ROOT, "configs", "DiverGen_swinL.yaml")
    t0 = time.perf_counter()
    sd = synthetic_flagship_checkpoint(24)
    ref = os.path.join(tmp, "reference.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, ref)
    made = time.perf_counter() - t0
    imported, cut = os.path.join(tmp, "imported"), os.path.join(tmp, "lvis")
    t0 = time.perf_counter()
    summary = timport.main(["--config-file", config, "--checkpoint", ref, "--output", imported,
                            "--ema"])
    import_s = time.perf_counter() - t0
    unfilled = set(summary["entries"]) - set(summary["loaded"])
    if summary["skipped"] or unfilled != {"bottom_up.s2_norm.weight", "bottom_up.s2_norm.bias"}:
        raise AssertionError(f"import: skipped {summary['skipped'][:8]}, not filled "
                             f"{sorted(unfilled)[:8]}")
    t0 = time.perf_counter()
    tconv.main(["--input_dir", imported, "--output_dir", cut])
    convert_s = time.perf_counter() - t0
    src, dst = Checkpointer(imported).load(), Checkpointer(cut).load()
    if src["ema_params"] is None or dst["ema_params"] is None:
        raise AssertionError("the imported checkpoint has no EMA slot")
    for part in ("model", "ema_params"):
        for name, t in src[part].items():
            want = t
            if ".cls_score." in name:
                want = torch.cat([t[:1203], t[-1:]])
                if tuple(want.shape) not in ((1204, 1024), (1204,)):
                    raise AssertionError(f"{part} {name}: cut to {tuple(want.shape)}")
            if not torch.equal(dst[part][name], want):
                raise AssertionError(f"convert: {part} {name} is not the cut of the import")
    w = src["model"]["roi_heads.box_predictor2.cls_score.weight"]
    if not torch.equal(w, torch.from_numpy(sd["roi_heads.box_predictor.2.cls_score.weight"])):
        raise AssertionError("import: cls_score of stage 2 is not the checkpoint's")
    del sd, src, dst
    torch.cuda.empty_cache()
    before = snapshot()
    t0 = time.perf_counter()
    out = texp.main(["--config-file", config, "--output", os.path.join(tmp, "lvis.pt2z"),
                     "--checkpoint-dir", cut, "--ema", "--run-sample",
                     "MODEL.ROI_HEADS.NUM_CLASSES", "1203"])
    export_s = time.perf_counter() - t0
    launched = launched_since(before, snapshot)
    if launched != {"fused_window_attention_packed": SWIN_L_BLOCKS}:
        raise AssertionError(f"export_model --run-sample: launches {launched}")
    bad = [k for k, v in out.items() if v.is_floating_point() and not torch.isfinite(v).all()]
    if bad or tuple(out["boxes"].shape) != (1, 300, 4):
        raise AssertionError(f"export_model sample run: non-finite {bad}, boxes "
                             f"{tuple(out['boxes'].shape)}")
    log(f"    (b) synthetic 1453-class checkpoint {os.path.getsize(ref)} bytes made in "
        f"{made:.1f} s; import_reference_checkpoint {import_s:.1f} s ({len(summary['loaded'])} "
        f"of {len(summary['entries'])} entries filled, model + EMA + optimizer); "
        f"convert_imgnet_model_to_lvis {convert_s:.1f} s (cls_score 1454 -> 1204 rows in 3 "
        f"stages x model and EMA); export_model --ema --run-sample {export_s:.1f} s: "
        f"{out['valid'].sum().item()} valid of 300, finite, {launched} [{card}]")


def dla_aggregation_phase(card: str, snapshot) -> None:
    """(c) DLA-34 -> ``DLAUp(node_type="dcn")`` over dla2..dla5 at 640², B = 2,
    float32 (the architectures slice's DLA size): one forward and backward on
    the card and on the CPU from the same weights and images (the offset convs
    drawn away from zero, so the deformable taps move), the loss (mean square
    of the fused map) and the gradient norm within ``DRYRUN_BOUNDS``; no
    kernel launch. Then ``deform_conv2d`` at ``dla2``'s shape (2, 160, 160, 64)
    -> 64 with offsets of several pixels and a mask, card against CPU within
    1e-5 of max |CPU|, its ms (CUDA events) and peak memory."""
    import copy

    from divergen_tpu_torch.modeling.backbone.dla import DLA34, OUT_CHANNELS, DeformNode, DLAUp
    from divergen_tpu_torch.ops.deform_conv import deform_conv2d

    levels = ("dla2", "dla3", "dla4", "dla5")

    class Aggregation(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dla = DLA34(out_features=levels)
            self.up = DLAUp({n: OUT_CHANNELS[n] for n in levels}, 64, "dcn")

        def forward(self, x):
            return self.up(self.dla(x))["dlaup"]

    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    cpu_net = Aggregation()
    with torch.no_grad():
        for m in cpu_net.modules():
            if isinstance(m, DeformNode):
                cin = m.offset.weight.shape[1]
                m.offset.weight.copy_(torch.randn(m.offset.weight.shape, generator=gen)
                                      / math.sqrt(9 * cin))
    card_net = copy.deepcopy(cpu_net).cuda()
    x = torch.rand(2, 640, 640, 3, generator=gen) * 2 - 1

    def step(net, images):
        out = net(images)
        loss = out.square().mean()
        grads = torch.autograd.grad(loss, list(net.parameters()))
        norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
        return out.detach(), float(loss.detach()), norm

    x_dev = x.cuda()
    before = snapshot()
    out, loss, norm = step(card_net, x_dev)
    torch.cuda.synchronize()
    launched = launched_since(before, snapshot)
    if launched:
        raise AssertionError(f"DLAUp launched kernels: {launched}")
    ref_out, ref_loss, ref_norm = step(cpu_net, x)
    out_err = (out.cpu() - ref_out).abs().max().item()
    out_ref = ref_out.abs().max().item()
    ok = (abs(loss - ref_loss) <= DRYRUN_BOUNDS["loss"] * abs(ref_loss)
          and abs(norm - ref_norm) <= DRYRUN_BOUNDS["grad_norm"] * abs(ref_norm))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step_ms = events_ms(lambda: step(card_net, x_dev), warmups=1, reps=5)
    peak = torch.cuda.max_memory_allocated() - base
    log(f"    (c) DLA-34 -> DLAUp(dcn) at 640², B = 2, float32: fused {tuple(out.shape)}; loss "
        f"card {loss:.9g} CPU {ref_loss:.9g}, grad norm card {norm:.9g} CPU {ref_norm:.9g} "
        f"(bounds {DRYRUN_BOUNDS}) [{'ok' if ok else 'FAIL'}]; max |fused diff| {out_err:.3g} "
        f"of max |CPU| {out_ref:.3g}; step (forward + backward) {step_ms:.2f} ms (CUDA events, "
        f"median of 5), peak memory {peak / 2**30:.2f} GiB above the weights; no kernel launch "
        f"[{card}]")
    if not ok:
        raise AssertionError("DLAUp: the card's loss or gradient norm disagrees with the CPU's")
    del card_net, cpu_net, out, ref_out
    torch.cuda.empty_cache()

    b, h, w, cin, cout = 2, 160, 160, 64, 64
    args = (torch.rand(b, h, w, cin, generator=gen) * 2 - 1,
            3 * torch.randn(b, h, w, 18, generator=gen),
            torch.randn(3, 3, cin, cout, generator=gen) / math.sqrt(9 * cin),
            torch.rand(b, h, w, 9, generator=gen))
    ref = deform_conv2d(*args[:3], mask=args[3])
    dev_args = [a.cuda() for a in args]
    got = deform_conv2d(*dev_args[:3], mask=dev_args[3])
    err = (got.cpu() - ref).abs().max().item()
    scale = ref.abs().max().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = events_ms(lambda: deform_conv2d(*dev_args[:3], mask=dev_args[3]))
    peak = torch.cuda.max_memory_allocated() - base
    log(f"    (c) deform_conv2d at dla2's shape {(b, h, w, cin)} -> {cout}, offsets of "
        f"{args[1].abs().max().item():.1f} px at most, with a mask: max |card - CPU| {err:.3g} "
        f"of max |CPU| {scale:.3g} (bound 1e-5 of it); {ms:.3f} ms (CUDA events, median of "
        f"{EXPORT_REPS}), peak memory {peak / 2**20:.1f} MiB above its inputs [{card}]")
    if err > 1e-5 * scale:
        raise AssertionError("deform_conv2d: the card disagrees with the CPU")


def slice_deployment(card: str, tmp: str, snapshot) -> dict:
    """Slice 14: (a) ``deployment_export``, (b) ``checkpoint_round_trip``, (c)
    ``dla_aggregation_phase``. Returns (a)'s launches in its serving
    interpreter."""
    extra = deployment_export(card, tmp, snapshot)
    checkpoint_round_trip(card, tmp, snapshot)
    dla_aggregation_phase(card, snapshot)
    return extra


# slice 15: ranks. RANK_STEPS BSGAL steps in each train_net run ((b)2 saves
# at the last); RANK_EVAL_IMAGES synthetic images in one batch split over two
# ranks
RANK_STEPS = 4
RANK_EVAL_IMAGES = 8
# (b)1's bounds, those of tests/test_torch_train_step.py: every metric within
# RANK_BOUNDS["rel"] relative; an element's update within twice the learning
# rate, and where its first moment is sized within RANK_BOUNDS["sized"] of it
RANK_BOUNDS = {"rel": 2e-4, "abs": 1e-6, "sized": 1e-2}


def rank_command(spec: dict, tmp: str, nproc: int = 0) -> dict:
    """This script in its ``--rank-child`` mode on ``spec``: under ``torchrun
    --standalone --nproc_per_node=nproc`` or, with ``nproc`` 0, as one plain
    process. Every child runs one intra-op thread (torchrun's default): the
    host's bilinear resize rounds a few pixels one level apart at other
    thread counts (3-5 of an 896-side image between 1 and 8 threads), and on
    random weights that reorders near-tied detections. Returns what rank 0
    wrote (every rank's result under ``ranks``) and the wall clock of the
    command; a failing child raises with the end of its output."""
    name = spec["name"]
    spec = dict(spec, result=os.path.join(tmp, f"{name}.result.json"))
    path = os.path.join(tmp, f"{name}.spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    script = os.path.abspath(__file__)
    cmd = [sys.executable, script, "--rank-child", path]
    if nproc:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={nproc}", script, "--rank-child", path]
    out = os.path.join(tmp, f"{name}.log")
    t0 = time.perf_counter()
    with open(out, "w") as f:
        proc = subprocess.run(cmd, cwd=os.path.dirname(script), stdout=f,
                              stderr=subprocess.STDOUT, timeout=900,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
    wall = time.perf_counter() - t0
    text = open(out, errors="replace").read()
    if proc.returncode:
        raise AssertionError(f"{name}: exit {proc.returncode}; its output ends\n{text[-8000:]}")
    with open(spec["result"]) as f:
        res = json.load(f)
    res.update(wall_s=wall)
    return res


def child_launches() -> dict:
    from divergen_tpu_torch.ops.window_attention import fused_window_attention_packed as wa

    return {"forward": wa.launches, "backward": wa.backward_launches,
            "bodies": [[list(k), n] for k, n in wa.bodies.items()],
            "backward_bodies": [[list(k), n] for k, n in wa.backward_bodies.items()]}


def params_sha256(model) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def float32_flagship_step(dev):
    """``graft_entry``'s flagship train parts in float32 (``FP16`` off,
    rematerialized Swin blocks): (cfg, state, batch of two 896² images, the
    seeded generator of the step's draws)."""
    from divergen_tpu_torch import graft_entry

    cfg = graft_entry.flagship_cfg()
    cfg.FP16 = False
    _, (state, batch, gen) = graft_entry._train_parts(cfg, dev, cfg.INPUT.TRAIN_SIZE, 2, 20, None)
    return cfg, state, batch, gen


class RecordingEvaluator:
    """Keeps the detections ``process`` is given, around an evaluator."""

    def __init__(self, inner):
        self.inner, self.outputs = inner, []

    def reset(self):
        self.inner.reset()
        self.outputs = []

    def process(self, inputs, outputs):
        self.outputs.append(({k: np.asarray(v) for k, v in outputs.items()},
                             [int(x["image_id"]) for x in inputs]))
        self.inner.process(inputs, outputs)

    def evaluate(self):
        return self.inner.evaluate()


def eval_split(files: dict, batch_size: int, group):
    """The flagship (bf16, seeded weights) through ``inference_on_dataset`` on
    the synthetic set ``files``: (results, recorded detections)."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from divergen_tpu_torch.data.datasets.lvis import lvis_meta_from_json, register_lvis_instances
    from divergen_tpu_torch.engine.eval_loop import build_evaluator, inference_on_dataset
    from divergen_tpu_torch.parallel.mesh import create_mesh, shard_pytree

    name = "smoke_ranks_synth_lvis"
    for reg in (DatasetCatalog, MetadataCatalog):
        reg.remove(name)
    register_lvis_instances(name, lvis_meta_from_json(files["json_file"]), files["json_file"],
                            files["image_root"])
    model, _ = graft_entry.flagship_entry()
    if group is not None:
        shard_pytree(model, create_mesh())
    cfg = graft_entry.flagship_cfg()
    evaluator = RecordingEvaluator(build_evaluator(cfg, name))
    results = inference_on_dataset(model, None, cfg, name, evaluator, batch_size=batch_size,
                                   group=group)
    return results, evaluator.outputs


def rank_child(spec_path: str) -> int:
    """``--rank-child SPEC``: one rank (or one plain process) of slice 15.
    ``kind`` ``train_net``: ``train_net.main(args)`` with a parameter
    checksum after every step; ``step``: (b)1's float32 step on this rank's
    image; ``evaluate``: (b)3's split evaluation. Rank 0 writes every rank's
    result to ``result``."""
    import torch.distributed as dist

    from divergen_tpu_torch.utils import comm

    with open(spec_path) as f:
        spec = json.load(f)
    # float32 products as main() takes them (a float32 step, a bit-equal split)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"kind": spec["kind"]}
    if spec["kind"] == "train_net":
        from divergen_tpu_torch import train_net
        from divergen_tpu_torch.active import bsgal
        from divergen_tpu_torch.engine.trainer import do_train

        os.environ["DETECTRON2_DATASETS"] = spec["root"]
        sums, make = [], bsgal.make_active_train_step

        def recording(model, optimizer, cfg, group=None):
            step = make(model, optimizer, cfg, group=group)
            params = list(model.parameters())

            def step_fn(*args):
                out = step(*args)
                sums.append(float(torch.stack([p.detach().double().sum() for p in params]).sum()))
                return out

            return step_fn

        bsgal.make_active_train_step = recording
        reduced, all_reduce = {"calls": 0, "bytes": 0}, dist.all_reduce

        def counting(tensor, *args, **kwargs):
            reduced["calls"] += 1
            reduced["bytes"] += tensor.numel() * tensor.element_size()
            return all_reduce(tensor, *args, **kwargs)

        dist.all_reduce = counting
        state = train_net.main(train_net.default_argument_parser().parse_args(spec["args"]))
        dist.all_reduce = all_reduce
        run, astate = do_train.last_run, do_train.last_run["active_state"]
        res.update(step_s=run["step_s"], data_time=run["data_time"], sums=sums,
                   sha256=params_sha256(state.model), world=run["world"],
                   counts=[int(astate.n_paste), int(astate.n_discard)],
                   steps=state.step - run["start_iter"],
                   params=sum(p.numel() for p in state.model.parameters()), reduced=reduced)
    elif spec["kind"] == "step":
        from divergen_tpu_torch.engine.trainer import make_paste_train_step
        from divergen_tpu_torch.ops.losses import RankDraws
        from divergen_tpu_torch.parallel.mesh import create_mesh, shard_pytree
        from divergen_tpu_torch.utils.dist import init_distributed

        dev = init_distributed(spec["backend"], device="cuda:0")
        rank, world = dist.get_rank(), dist.get_world_size()
        cfg, state, batch, gen = float32_flagship_step(dev)
        mesh = create_mesh()
        shard_pytree(state.model, mesh)
        step = make_paste_train_step(state.model, state.optimizer, cfg, group=mesh.group)
        b = batch["image"].shape[0]
        rows = slice(rank * b // world, (rank + 1) * b // world)
        cut = lambda v: {k: cut(x) for k, x in v.items()} if isinstance(v, dict) else v[rows]
        local = {k: (v if k == "fed_weight" else cut(v)) for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, local, RankDraws(gen, rank, world))
        torch.cuda.synchronize()
        res.update(step_s=time.perf_counter() - t0,
                   metrics=comm.reduce_dict({k: float(v) for k, v in metrics.items()}),
                   sha256=params_sha256(state.model))
        if rank == 0:
            torch.save({n: p.detach().cpu() for n, p in state.model.named_parameters()},
                       spec["params_out"])
    elif spec["kind"] == "evaluate":
        from divergen_tpu_torch.utils.dist import init_distributed

        if spec["backend"]:
            init_distributed(spec["backend"], device="cuda:0")
        t0 = time.perf_counter()
        results, outputs = eval_split(spec["files"], spec["batch_size"],
                                      dist.group.WORLD if spec["backend"] else None)
        res["eval_s"] = time.perf_counter() - t0
        if comm.get_rank() == 0:
            torch.save({"results": results, "outputs": outputs}, spec["eval_out"])
    res.update(launches=child_launches(), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               rank=comm.get_rank(),
               backend=dist.get_backend() if dist.is_initialized() else None)
    every = comm.all_gather(res)
    if comm.get_rank() == 0:
        with open(spec["result"], "w") as f:
            json.dump({"ranks": every}, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def ranks_training_root(tmp: str) -> dict:
    from divergen_tpu_torch.data.datasets.synthetic_lvis import write_training_root

    return write_training_root(os.path.join(tmp, "ranks_data"), 1203,
                               SERVING_SIZES * (TRAIN_SET // 4), SERVING_SIZES * (VAL_SET // 4),
                               64, 32, seed=0)


def train_net_args(files: dict, out: str, save: bool, *extra) -> list:
    """``configs/BSGAL_SwinL.yaml`` for ``RANK_STEPS`` steps of two images
    on ``files``' root; with ``save`` a checkpoint at the last step."""
    return ["--config-file", "configs/BSGAL_SwinL.yaml", "--max-steps", str(RANK_STEPS), *extra,
            *files["overrides"], "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CHECKPOINT_PERIOD",
            str(RANK_STEPS if save else 10 * RANK_STEPS), "TEST.EVAL_PERIOD", "0",
            "OUTPUT_DIR", out]


def step_summary(res: dict, saved: bool = False) -> str:
    """s/step: the median after the first (and before a saving last step)."""
    s = res["step_s"]
    steady = s[1:-1] if saved else s[1:]
    return (f"s/step {statistics.median(steady) if steady else s[0]:.3f} (median after the "
            f"first{', before the saving last' if saved else ''}; every step "
            f"{[round(x, 3) for x in s]})")


def nccl_world_one(card: str, tmp: str, files: dict) -> list:
    """(a) ``train_net --multi-host`` under ``torchrun --nproc_per_node=1``
    (NCCL, a live group of one rank) against the same run without a group:
    the parameters after every step (a float64 checksum) and at the end
    (SHA-256 of their bytes) equal bit for bit. Returns both runs' results."""
    group = rank_command({"name": "nccl_world_1", "kind": "train_net", "root": files["root"],
                          "args": train_net_args(files, os.path.join(tmp, "nccl"), False,
                                                 "--multi-host")}, tmp, nproc=1)
    alone = rank_command({"name": "no_group", "kind": "train_net", "root": files["root"],
                          "args": train_net_args(files, os.path.join(tmp, "alone"), False)}, tmp)
    (g,), (a,) = group["ranks"], alone["ranks"]
    if g["backend"] != "nccl" or a["backend"] is not None or g["world"] != 1:
        raise AssertionError(f"(a): backends {g['backend']} / {a['backend']}, world {g['world']}")
    if g["sums"] != a["sums"] or g["sha256"] != a["sha256"] or g["counts"] != a["counts"]:
        raise AssertionError(f"(a): NCCL at world size 1 differs from the run without a group: "
                             f"checksums {g['sums']} / {a['sums']}, SHA-256 {g['sha256'][:16]} / "
                             f"{a['sha256'][:16]}, decisions {g['counts']} / {a['counts']}")
    if a["reduced"]["calls"]:
        raise AssertionError(f"(a): the run without a group all-reduced {a['reduced']}")
    per_step = g["reduced"]["bytes"] / g["steps"]
    log(f"  (a) NCCL at world size 1: {g['steps']} BSGAL steps bit equal to the run without a "
        f"group (checksums {g['sums']}, SHA-256 {g['sha256'][:16]}); with the group {step_summary(g)}, peak "
        f"{g['peak_gib']:.2f} GiB, command {group['wall_s']:.1f} s; without {step_summary(a)}, "
        f"peak {a['peak_gib']:.2f} GiB, command {alone['wall_s']:.1f} s; all_reduce moved "
        f"{per_step / 1e6:.1f} MB a step in {g['reduced']['calls'] / g['steps']:.1f} calls "
        f"({g['params']} parameters x 4 B = {g['params'] * 4 / 1e6:.1f} MB a gradient "
        f"reduction) [{card}]")
    return [g, a]


def gloo_step(card: str, tmp: str) -> list:
    """(b)1: the float32 flagship step on two gloo ranks sharing the card, one
    image each, against this process's step on both images from the same
    weights and draws, within ``RANK_BOUNDS``."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, state, batch, gen = float32_flagship_step(torch.device("cuda"))
    from divergen_tpu_torch.engine.trainer import make_paste_train_step

    step = make_paste_train_step(state.model, state.optimizer, cfg)
    before = {n: p.detach().cpu().clone() for n, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, want = step(state, batch, gen)
    torch.cuda.synchronize()
    one_s, one_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    want = {k: float(v) for k, v in want.items()}
    lr = state.optimizer.schedule(0)
    after = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    moments = {n: state.optimizer.optim.state[p]["exp_avg"].abs().cpu()
               for n, p in state.model.named_parameters()}
    del state, batch, step
    torch.cuda.empty_cache()
    params_out = os.path.join(tmp, "gloo_step_params.pt")
    res = rank_command({"name": "gloo_step", "kind": "step", "backend": "gloo",
                        "params_out": params_out}, tmp, nproc=2)
    r0, r1 = res["ranks"]
    if r0["sha256"] != r1["sha256"] or r0["metrics"] != r1["metrics"]:
        raise AssertionError("(b)1: the two ranks' parameters or metrics differ")
    got = torch.load(params_out)
    bad = [k for k, w in want.items() if abs(r0["metrics"][k] - w)
           > RANK_BOUNDS["rel"] * abs(w) + RANK_BOUNDS["abs"]]
    largest = max(float(m.max()) for m in moments.values())
    worst = {"all": 0.0, "sized": 0.0}
    for n, w in after.items():
        diff = ((got[n] - before[n]) - (w - before[n])).abs()
        ulps = 2e-7 * max(1.0, float(w.abs().max()))
        worst["all"] = max(worst["all"], (float(diff.max()) - ulps) / lr)
        sized = moments[n] > max(1e-3 * float(moments[n].max()), 1e-5 * largest)
        if sized.any():
            worst["sized"] = max(worst["sized"], (float(diff[sized].max()) - ulps) / lr)
    log(f"  (b)1 float32 step, two gloo ranks of one image each against one process of both: "
        f"metrics {'within' if not bad else 'OUTSIDE'} {RANK_BOUNDS['rel']} relative "
        f"(largest gap {max(abs(r0['metrics'][k] - w) / max(abs(w), 1e-12) for k, w in want.items()):.3g}), "
        f"updates off by at most {worst['all']:.3g} x lr (bound 2), sized ones "
        f"{worst['sized']:.3g} x lr (bound {RANK_BOUNDS['sized']}); the ranks' step "
        f"{max(r['step_s'] for r in res['ranks']):.3f} s against one process's {one_s:.3f} s "
        f"(first steps), peak {r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB a rank against "
        f"{one_peak:.2f} GiB [{card}]")
    if bad or worst["all"] > 2.0 or worst["sized"] > RANK_BOUNDS["sized"]:
        raise AssertionError(f"(b)1: metrics {bad}, updates {worst}")
    return res["ranks"]


def gloo_do_train(card: str, tmp: str, files: dict) -> list:
    """(b)2: BSGAL through ``train_net --multi-host --dist-backend gloo`` on
    two ranks sharing the card (one image each): the parameters equal on
    both ranks after every step, one decision a step on both, one checkpoint
    and one ``metrics.json``."""
    from divergen_tpu_torch.engine.checkpoint import Checkpointer

    out = os.path.join(tmp, "gloo_bsgal")
    res = rank_command({"name": "gloo_bsgal", "kind": "train_net", "root": files["root"],
                        "args": train_net_args(files, out, True, "--multi-host",
                                               "--dist-backend", "gloo", "--device", "cuda:0",
                                               "MODEL.ACTIVE.LOG_PERIOD", "1")}, tmp, nproc=2)
    r0, r1 = res["ranks"]
    decisions = []
    for r in range(2):
        lines = open(os.path.join(out, "paste_source", f"rank_{r}", "10000.txt")).read().splitlines()
        decisions.append(sorted({(int(x.split(" iter: ")[1].split()[0]),
                                  int(x.split(" paste: ")[1].split()[0]),
                                  x.split(" sim_paste_init: ")[1].split()[0]) for x in lines}))
    rows = open(os.path.join(out, "metrics.json")).read().splitlines()
    ckpts = Checkpointer(out).all_steps()
    if (r0["sums"] != r1["sums"] or len(r0["sums"]) != RANK_STEPS or r0["sha256"] != r1["sha256"]
            or r0["counts"] != r1["counts"] or decisions[0] != decisions[1]
            or len(decisions[0]) != RANK_STEPS or ckpts != [RANK_STEPS] or len(rows) != 1
            or r0["world"] != 2 or r0["backend"] != "gloo"):
        raise AssertionError(f"(b)2: checksums {r0['sums']} / {r1['sums']}, decisions "
                             f"{decisions}, checkpoints {ckpts}, metrics.json rows {len(rows)}")
    log(f"  (b)2 BSGAL over two gloo ranks on one card: {RANK_STEPS} steps, the ranks' "
        f"parameters equal after every step (checksums {r0['sums']}), decisions (iter, paste, "
        f"sim) {decisions[0]} on both, checkpoints {ckpts}, {len(rows)} metrics.json row; "
        f"{step_summary(r0, saved=True)}, peak {r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB a rank, "
        f"command {res['wall_s']:.1f} s [{card}]")
    return res["ranks"]


def gloo_eval(card: str, tmp: str) -> list:
    """(b)3: ``inference_on_dataset`` over two gloo ranks, one batch of
    ``RANK_EVAL_IMAGES`` split in halves, against one process's loop (a
    plain child, as fresh as the ranks) in batches of half as many, so the
    same forwards: detections and results equal bit for bit."""
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.data.datasets.synthetic_lvis import write_synthetic_lvis

    files = write_synthetic_lvis(os.path.join(tmp, "ranks_lvis"),
                                 [SERVING_SIZES[k % 4] for k in range(RANK_EVAL_IMAGES)],
                                 graft_entry.flagship_cfg().MODEL.ROI_HEADS.NUM_CLASSES,
                                 seed=graft_entry.SEED, category_ids=range(1, 61))
    runs = {}
    for name, backend, nproc, batch in (("one_card_eval", None, 0, RANK_EVAL_IMAGES // 2),
                                        ("gloo_eval", "gloo", 2, RANK_EVAL_IMAGES)):
        out = os.path.join(tmp, f"{name}.pt")
        res = rank_command({"name": name, "kind": "evaluate", "backend": backend,
                            "files": files, "batch_size": batch, "eval_out": out}, tmp, nproc)
        runs[name] = (res["ranks"], torch.load(out, weights_only=False))
    (one_rank,), want = runs["one_card_eval"]
    split, got = runs["gloo_eval"]
    ids = [i for _, batch in got["outputs"] for i in batch]
    want_ids = [i for _, batch in want["outputs"] for i in batch]
    merged = {k: np.concatenate([o[k] for o, _ in want["outputs"]]) for k in want["outputs"][0][0]}
    differ = {k: float(np.abs(got["outputs"][0][0][k].astype(np.float64) - v).max())
              for k, v in merged.items() if not np.array_equal(got["outputs"][0][0][k], v)}
    same_results = all(
        got["results"][t][k] == v or (math.isnan(v) and math.isnan(got["results"][t][k]))
        for t in want["results"] for k, v in want["results"][t].items())
    if ids != want_ids or differ or not same_results:
        raise AssertionError(f"(b)3: the split evaluation differs: images {ids} / {want_ids}, "
                             f"outputs (largest gap) {differ}, results {got['results']} / "
                             f"{want['results']}")
    log(f"  (b)3 inference_on_dataset over two gloo ranks ({RANK_EVAL_IMAGES} images, 4 a rank): "
        f"detections and results equal to one card's bit for bit (bbox AP "
        f"{want['results']['bbox']['AP']:.4f}); {max(r['eval_s'] for r in split):.1f} s against "
        f"{one_rank['eval_s']:.1f} s on one card, peak {[round(r['peak_gib'], 2) for r in split]} "
        f"GiB a rank against {one_rank['peak_gib']:.2f} [{card}]")
    return split + [one_rank]


def slice_ranks(card: str, tmp: str) -> dict:
    """Slice 15: (a) ``nccl_world_one``, (b) ``gloo_step``, ``gloo_do_train``,
    ``gloo_eval``. Returns the children's launches of the packed window
    attention, by the keys of ``snapshot()``."""
    files = ranks_training_root(tmp)
    files["root"] = os.path.join(tmp, "ranks_data")
    children = nccl_world_one(card, tmp, files)
    children += gloo_step(card, tmp)
    children += gloo_do_train(card, tmp, files)
    children += gloo_eval(card, tmp)
    launched = {}
    for r in children:
        c = r["launches"]
        for key, n in (("fused_window_attention_packed", c["forward"]),
                       ("fused_window_attention_packed_backward", c["backward"])):
            launched[key] = launched.get(key, 0) + n
        for back, pairs in ((False, c["bodies"]), (True, c["backward_bodies"])):
            for k, n in pairs:
                key = ("fused_window_attention_packed", back, *k)
                launched[key] = launched.get(key, 0) + n
    log(f"  the children's launches: { {k: n for k, n in launched.items() if isinstance(k, str)} }")
    return launched


def main() -> int:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from divergen_tpu_torch.ops import _build
    from divergen_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_packed,
        flash_attention_relpos,
    )
    from divergen_tpu_torch.ops.gn_conv import fused_gn_silu_conv3x3
    from divergen_tpu_torch.ops.group_norm import fused_group_norm
    from divergen_tpu_torch.ops.int8_matmul import int8_matmul_fused_quant, int8_matmul_pallas
    from divergen_tpu_torch.ops.layer_norm import fused_layer_norm
    from divergen_tpu_torch.ops.ln_matmul import fused_ln_matmul
    from divergen_tpu_torch.ops.window_attention import (
        fused_window_attention,
        fused_window_attention_packed,
    )

    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    log(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    log_path = so.with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if any(key in line for key in ("registers", "spill", "Compiling entry", "C7520")):
                log(f"  ptxas: {line.strip()}")

    results = kernel_phases(torch.Generator(device="cuda").manual_seed(0), card)
    float32_window_backward_phase(torch.Generator(device="cuda").manual_seed(2), card, results)
    head_dim_entries = head_dim_phases(torch.Generator(device="cuda").manual_seed(3), card)
    log("kernel phase: every body route of the head dims 1..128 and 512")
    routes = body_route_sweep(torch.Generator(device="cuda").manual_seed(4))
    log(f"    {routes} routes agree with their twins")
    log("kernel phase: the forward-only kernels under autograd")
    autograd_guard_phase()
    results.update(serving_kernel_phases(torch.Generator(device="cuda").manual_seed(1)))
    upscaler_kernel_phases(torch.Generator(device="cuda").manual_seed(5), card, results)
    log("small models")
    small_models()
    small_float32_models()
    head_dim_models()
    small_serving_unets()
    small_detector()
    small_train_step()

    wrappers = (flash_attention_packed, fused_ln_matmul, flash_attention,
                flash_attention_relpos, fused_window_attention_packed, fused_window_attention,
                int8_matmul_fused_quant, int8_matmul_pallas, fused_layer_norm, fused_group_norm,
                fused_gn_silu_conv3x3)
    chain_kernels = [w.__name__ for w in wrappers[:4]]

    backward = {"fused_window_attention_packed_backward": fused_window_attention_packed,
                "fused_window_attention_backward": fused_window_attention}

    # the attention wrappers also count by body and head dim
    # (attention_f32.count): (name, backward, body entry, d) -> launches
    attention = [w for w in wrappers if hasattr(w, "bodies")]

    def reset():
        for w in wrappers:
            w.launches = 0
        for w in backward.values():
            w.backward_launches = 0
        for w in attention:
            w.bodies.clear()
            if hasattr(w, "backward_bodies"):
                w.backward_bodies.clear()

    def snapshot():
        counts = {w.__name__: w.launches for w in wrappers}
        counts.update({name: w.backward_launches for name, w in backward.items()})
        for w in attention:
            counts.update({(w.__name__, False, *key): n for key, n in w.bodies.items()})
            counts.update({(w.__name__, True, *key): n
                           for key, n in getattr(w, "backward_bodies", {}).items()})
        return counts

    def read(path_kernels, what):
        counts = snapshot()
        log(f"  kernel launches in {what}: "
            f"{ {k: n for k, n in counts.items() if isinstance(k, str)} }")
        log(f"    by body and head dim: "
            f"{ {k: n for k, n in counts.items() if not isinstance(k, str)} }")
        missing = [name for name in path_kernels if counts[name] == 0]
        if missing:
            raise AssertionError(f"kernels not launched in {what}: {missing}")
        return counts

    with tempfile.TemporaryDirectory() as tmp:
        log("slice: full-width SDXL")
        reset()
        slice_txt2img(tmp)
        torch.cuda.empty_cache()
        encoder, pipe, cond, bf16_images = slice_pipeline()
        sdxl = read(("flash_attention_packed", "fused_ln_matmul", "flash_attention"),
                    "the SDXL slice")
        timings(encoder, pipe, cond, card)

        log("slice: instance chain at full width (SAM ViT-H, CLIP ViT-L/14, compositor)")
        reset()
        slice_corner_masks(tmp)
    torch.cuda.empty_cache()
    chain_timings = slice_chain(encoder, pipe, card)
    chain = read(chain_kernels, "the instance-chain slice")
    chain_timings()
    del chain_timings
    torch.cuda.empty_cache()

    log("slice: SDXL int8 + fused norms at full width (txt2img --int8, then "
        "SDXLPipeline(int8=True) over UNetSDXL(quant, fused_ln, fused_gn))")
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        slice_txt2img_int8(tmp)
    torch.cuda.empty_cache()
    after_a = read(("int8_matmul_fused_quant", "int8_matmul_pallas", "flash_attention_packed",
                    "flash_attention"), "txt2img --int8")
    pipe8 = slice_serving_pipeline(pipe, cond, bf16_images)
    serving = read(("flash_attention_packed", "flash_attention", *SERVING_LAUNCHES),
                   "the int8 + fused-norm slice")
    unet_calls = STEPS  # one generate call of B = 2: one UNet call (batch 4) per step
    want_a = {k: v * unet_calls for k, v in INT8_ONLY_LAUNCHES.items()}
    want_a["fused_ln_matmul"] = 0
    want_b = {k: v * unet_calls for k, v in SERVING_LAUNCHES.items()}
    want_b.update(fused_ln_matmul=0, flash_attention_packed=70 * unet_calls, flash_attention=2)
    for what, counts, want in (("txt2img --int8", after_a, want_a),
                               ("SDXLPipeline(int8=True)",
                                {k: serving[k] - after_a.get(k, 0) for k in serving}, want_b)):
        wrong = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
        if wrong:
            raise AssertionError(f"{what}: launches (got, expected) {wrong}")
        log(f"  {what}: launches as expected per UNet call x {unet_calls} calls: "
            f"{ {k: counts[k] for k in want} }")
    serving_timings(pipe, pipe8, cond, card)
    del pipe8
    torch.cuda.empty_cache()

    log('slice: SDXL with fused ResBlocks at full width (SDXLPipeline over '
        'UNetSDXL(conv_matmul="fused"), then one UNet call with every serving option)')
    reset()
    pipe_f = slice_fused_resblocks(pipe, cond, bf16_images)
    fused = read(("flash_attention_packed", "fused_ln_matmul", "flash_attention",
                  "fused_gn_silu_conv3x3"), "the fused-ResBlock slice")
    want = {k: v * unet_calls for k, v in FUSED_RESBLOCK_LAUNCHES.items()}
    want["flash_attention"] = 2
    wrong = {k: (fused[k], n) for k, n in want.items() if fused[k] != n}
    if wrong:
        raise AssertionError(f'SDXLPipeline over UNetSDXL(conv_matmul="fused"): launches (got, '
                             f"expected) {wrong}")
    log(f"  launches as expected per UNet call x {unet_calls} calls: "
        f"{ {k: fused[k] for k in want} }")
    every = every_option_unet_call(pipe, cond, snapshot)
    fused = {k: fused.get(k, 0) + every.get(k, 0) for k in {**fused, **every}}
    fused_timings(pipe, pipe_f, cond, card)
    del pipe_f
    torch.cuda.empty_cache()

    log("slice: the IF cascade and the x4 upscaler at full width (IF-I-XL, IF-II-L, "
        "UpscalePipeline(upscaler_unet()) and its x4 VAE; txt2img --stages I II, --stages XL x4, "
        "--encoder_reuse; SDXLPipeline(encoder_reuse=True))")
    reset()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if_timings = slice_if_cascade(card, tmp, pipe, cond, bf16_images, snapshot)
    cascade = read(("flash_attention_packed", "fused_ln_matmul", "flash_attention"),
                   "the IF cascade and upscaler slice")
    log(f"  the slice took {time.perf_counter() - t0:.1f} s before its timings")
    if_timings()
    del encoder, pipe, cond, bf16_images, if_timings
    torch.cuda.empty_cache()

    log("slice: detector train step (the Swin-L flagship at full width)")
    reset()
    slice_train(card)
    train = read(("fused_window_attention_packed", "fused_window_attention_packed_backward"),
                 "the train slice")

    log("slice: detector inference forward (Swin-T entry, then Swin-L flagship at full width)")
    reset()
    detector_timings = slice_detector(card)
    detector = read(("fused_window_attention_packed",), "the detector slice")
    detector_timings()
    del detector_timings
    torch.cuda.empty_cache()

    log("slice: detector serving and evaluation (Predictor, BatchPredictor, do_test, "
        "VisualizationDemo; then AsyncPredictor)")
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        async_part = slice_serving(card, tmp)
        detector_serving = read(("fused_window_attention_packed",), "the serving slice")
        # worker threads bump the plain-int counters concurrently: AsyncPredictor
        # runs after the read, and its launches are counted in no slice
        async_part()
    del async_part
    torch.cuda.empty_cache()

    log("slice: training (a float32 BSGAL step of Swin-T against the CPU; do_train through "
        "train_net at full width: configs/BSGAL_SwinL.yaml, then --resume; "
        "configs/DiverGen_swinL.yaml)")
    reset()
    small_active_step()  # the float32 main path of the window backward body
    with tempfile.TemporaryDirectory() as tmp:
        png_step_s = slice_do_train(card, tmp, snapshot)
    do_train_counts = read(("fused_window_attention_packed",
                            "fused_window_attention_packed_backward"), "the do_train slice")

    log("slice: the detector's other architectures (configs/BSGAL_R50.yaml through train_net, "
        "then a step and a forward of each other architecture at full width, then "
        "dryrun_train on ResNet-18)")
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        slice_architectures(card, tmp, snapshot)
    architectures = read(("fused_window_attention_packed",
                          "fused_window_attention_packed_backward"), "the architectures slice")

    log("slice: real-image data (the JPEG fixtures against their manifest; "
        "configs/DiverGen_swinL.yaml through train_net on a JPEG root with USE_COLOR_JITTER, "
        "USE_INSTABOOST and USE_INP_ROTATE; lvis_crop -> extract_features -> "
        "compute_similarity)")
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        slice_real_images(card, tmp, snapshot, png_step_s)
    real_images = read(("fused_window_attention_packed",
                        "fused_window_attention_packed_backward"), "the real-image slice")

    log("slice: weak supervision (the flagship's weak steps, a float32 weak step against the "
        "CPU, the Res5 heads' weak step), DINOv2, inference_on_dataset_exp and the Cityscapes "
        "evaluator, rotated IoU and NMS")
    log(f"  the smoke's wall clock before the slice: {time.perf_counter() - started:.1f} s "
        f"[{card}]")
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        slice_weak_supervision(card, tmp, snapshot)
    weak = read(("fused_window_attention_packed", "fused_window_attention_packed_backward"),
                "the weak-supervision slice")
    log(f"  the smoke's wall clock after the slice: {time.perf_counter() - started:.1f} s "
        f"[{card}]")

    log("slice: deployment and DLA's deformable aggregation (the flagship exported "
        "weights-separate and baked, each served on the card by a process without the model "
        "code; import_reference_checkpoint -> convert_imgnet_model_to_lvis -> export_model; "
        "DLA-34 -> DLAUp(dcn) and deform_conv2d against the CPU)")
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        served = slice_deployment(card, tmp, snapshot)
    deployment = read(("fused_window_attention_packed",), "the deployment slice")
    # the exported programs' launches, counted in the interpreter that served them
    for k, n in served.items():
        deployment[k] = deployment.get(k, 0) + n
    log(f"  with the served artifacts' launches: "
        f"{ {k: n for k, n in deployment.items() if n} }")
    log(f"  the smoke's wall clock after the slice: {time.perf_counter() - started:.1f} s "
        f"[{card}]")

    log("slice 15: ranks ((a) train_net --multi-host under torchrun at NCCL world size 1, bit "
        "equal to the run without a group; (b) two gloo ranks sharing the card: the float32 "
        "step against one process, BSGAL through train_net, the split inference_on_dataset)")
    reset()
    with tempfile.TemporaryDirectory() as tmp:
        children = slice_ranks(card, tmp)
    ranks = read(("fused_window_attention_packed",
                  "fused_window_attention_packed_backward"), "the ranks slice")
    for k, n in children.items():  # the ranks' own launches, counted in their processes
        ranks[k] = ranks.get(k, 0) + n
    log(f"  with the ranks' launches: { {k: n for k, n in ranks.items() if n and isinstance(k, str)} }")
    log(f"  the smoke's wall clock after the slice: {time.perf_counter() - started:.1f} s "
        f"[{card}]")
    launches = {}
    for counts in (sdxl, chain, serving, fused, cascade, train, detector, detector_serving,
                   do_train_counts, architectures, real_images, weak, deployment, ranks):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    # the split wrapper is on no slice's path (the packed kernels take any head
    # count): the kernel phases hold its forward and backward, its counts stay 0
    for name in ("fused_window_attention", "fused_window_attention_backward"):
        if launches[name]:
            raise AssertionError(f"{name} is on no slice's path, yet its count is {launches[name]}")

    sources = {
        "flash_attention_packed": ("divergen_tpu_torch/csrc/flash_attention_sm90.cu",
                                   "divergen_tpu/ops/pallas/flash_attention.py:337"),
        "fused_ln_matmul": ("divergen_tpu_torch/csrc/ln_matmul.cu",
                            "divergen_tpu/ops/pallas/ln_matmul.py:127"),
        "flash_attention": ("divergen_tpu_torch/csrc/flash_attention_d512.cu",
                            "divergen_tpu/ops/pallas/flash_attention.py:146"),
        "flash_attention_relpos": ("divergen_tpu_torch/csrc/flash_attention_relpos_sm90.cu",
                                   "divergen_tpu/ops/pallas/flash_attention.py:531"),
        "fused_window_attention_packed": ("divergen_tpu_torch/csrc/window_attention.cu",
                                          "divergen_tpu/ops/pallas/window_attention.py:470"),
        "fused_window_attention": ("divergen_tpu_torch/csrc/window_attention.cu",
                                   "divergen_tpu/ops/pallas/window_attention.py:245"),
        "fused_window_attention_packed_backward": (
            "divergen_tpu_torch/csrc/window_attention.cu",
            "divergen_tpu/ops/pallas/window_attention.py:408"),
        "fused_window_attention_backward": ("divergen_tpu_torch/csrc/window_attention.cu",
                                            "divergen_tpu/ops/pallas/window_attention.py:203"),
        "fused_group_norm": ("divergen_tpu_torch/csrc/group_norm.cu",
                             "divergen_tpu/ops/pallas/group_norm.py:111"),
        "fused_layer_norm": ("divergen_tpu_torch/csrc/layer_norm.cu",
                             "divergen_tpu/ops/pallas/layer_norm.py:59"),
        "int8_matmul_pallas": ("divergen_tpu_torch/csrc/int8_matmul.cu",
                               "divergen_tpu/ops/pallas/int8_matmul.py:63"),
        "int8_matmul_fused_quant": ("divergen_tpu_torch/csrc/int8_matmul.cu",
                                    "divergen_tpu/ops/pallas/int8_matmul.py:130"),
        "fused_gn_silu_conv3x3": ("divergen_tpu_torch/csrc/gn_conv.cu",
                                  "divergen_tpu/ops/pallas/fused_gn_conv.py:84"),
    }
    # each main-path launch of an attention kernel goes to one row, by the
    # body that ran it and the caller's head dim: a head-dim case's row takes
    # its own (body, d); the float32 body's row every other float32-body
    # launch of its wrapper; the kernel's own row the rest
    head_dim_keys = {(w.__name__, back, entry, d) for _, (w, back, entry, d) in head_dim_entries}
    if len(head_dim_keys) != len(head_dim_entries):
        raise AssertionError("two head-dim cases share a (wrapper, body, head dim)")

    def body_launches(name, f32):
        wrapper, back = name.removesuffix("_backward"), name.endswith("_backward")
        if not any(isinstance(k, tuple) and k[:2] == (wrapper, back) for k in launches):
            return launches[name]  # not an attention kernel: one body
        return sum(n for k, n in launches.items() if isinstance(k, tuple)
                   and k[:2] == (wrapper, back) and (k[2] == "dg_attention_f32") == f32
                   and k not in head_dim_keys)

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": body_launches(name, False), **results[name]}
               for name, (src, rep) in sources.items()]
    # the float32 body of kernels 1, 3, 4, 5 and 6 (the split wrapper's
    # float32 launches, none on a path, would be the packed rows')
    for name in ("flash_attention_packed", "flash_attention", "flash_attention_relpos",
                 "fused_window_attention_packed", "fused_window_attention_packed_backward"):
        kernels.append({"name": f"{name} (float32)", "route": "cuda",
                        "source": "divergen_tpu_torch/csrc/attention_f32.cu",
                        "replaces": sources[name][1], "launches": body_launches(name, True),
                        **results[f"{name} (float32)"]})
    for entry, key in head_dim_entries:  # the head-dim phase's cases, each its own row
        entry["launches"] = launches.get((key[0].__name__, *key[1:]), 0)
        kernels.append(entry)
    counted = sum(k["launches"] for k in kernels)
    if counted != sum(n for name, n in launches.items() if isinstance(name, str)):
        raise AssertionError(f"the kernels line counts {counted} main-path launches, the "
                             f"wrappers {launches}")
    f32_train = [n for k, n in train.items() if isinstance(k, tuple) and k[2] == "dg_attention_f32"]
    if any(f32_train):
        raise AssertionError(f"the bf16 train slice launched the float32 bodies: {f32_train}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-child"]:
        sys.exit(rank_child(sys.argv[2]))
    sys.exit(main())
