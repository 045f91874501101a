#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one CUDA card, end to end.

    python3 chip_smoke.py [--out record.json]

Phases, in order; any failure is an uncaught exception and a non-zero exit:

1. build   -- nvcc builds each source of ``csrc/`` (sm_90a), one process per
   source, all started together; prints seconds.
2. kernels -- each elementwise kernel against its plain PyTorch version at
   the main path's [128,224,224,3] float32: pgd_step and quantize
   bit-exact, the Philox noise held to its distribution; kernel, plain,
   bound and (where one exists) library times.
2b. conv   -- the 3x3 conv kernel against its plain version at the probe's
   [128,56,56,64] x [3,3,64,64] bfloat16: every element in the bf16
   rounding interval of a float32 sum (one bf16 ulp but where the products
   cancel), fewer than 0.1% more than one ulp apart; the float32
   instantiation at batch 8 and 128 within 1e-5 of the largest output (and
   the fraction of its elements bit-equal to the plain version's), and
   its times at batch 128 beside cuDNN's (TF32 off), each also replayed
   from a CUDA graph (graph_ms, which leaves out the host's time per call)
   outside the counted run, and the wrapper's host time per call on a
   one-pixel image; cuDNN's
   F.conv2d within the probe's 3e-2; each launch's grid (blocks, threads,
   dynamic shared memory, band rows R); then the probe's entry point, in this
   process (its launches count) and as a subprocess at its defaults.
3. classify -- ResNet-50 at full width, 224x224, bfloat16, random weights
   from a seed, on a batch of 128; float32 logits of the card held against
   the CPU on two images within 1e-5 relative, a limit that the same logits
   with TF32 allowed must exceed.
4. pgd     -- PGD-10 (eps 8/255, alpha 2/255, random start) through
   ``run_attack("pgd", ...)``: 10 pgd_step and 1 noise launch, inside the
   eps-ball and [0,1]; examples per second after a warm-up; one attack
   under torch.profiler, its device time by layer and the card's busy share.
5. cell    -- one pgd attack -> defend -> detect cell through
   ``evaluate_defenses_batch`` with the threshold from
   ``calibrate_feature_threshold``; quantize launched; its summary line.
5b. cw    -- CW-L2 (100 Adam steps, c = 10) on the same batch: x_adv in
   [0,1], some samples successful, and every one of them misclassified at
   the returned image.
5c. cells  -- pgd cells with the JPEG arm (DCT codec on the card, PIL codec
   on the host) and with the TV arm; quantize launched in each.
6. cli     -- the classify CLI in a subprocess on a PNG, ``--attack pgd
   --save_adv``, and ``--attack cw --cw_steps 100 --save_adv``; the saved
   pgd image within eps of the clean one.
7. detectors -- four pgd cells on the phase-3 batch through
   ``evaluate_defenses_batch``, each inside the eps-ball with its counters
   in range and its launches counted exactly: (a) ``adaptive`` with the
   feature detector (10 pgd_step, 1 noise, 11 quantize: one per step
   inside the attack, one for the defended prediction); (b)
   ``detector_aware`` (lam 1, margin 0.9) against the feature threshold
   (10, 1, 1), its mean feature score beside the oblivious cell's; (c) the
   squeezing detector, calibrated by ``calibrate_squeezing_threshold``
   (10, 1, 3: one for the defense, two for the two scores); (d) the
   Mahalanobis detector fitted by ``calibrate_mahalanobis`` on the 128
   clean images (K = 1000, C = 1024; 10, 1, 1), with the fit's and the
   score's times and finite params.
8. experiments -- the defense_experiments CLI in a subprocess on 128
   generated PNGs (256x300): the default grid (fgsm, pgd, cw x eps {4, 8,
   16}/255, cw_steps 100, auto-calibrated feature detector, 5 samples
   drawn): nine summary lines in the exact format, cw computed once and
   reused twice, nine cells in ``results_partial.json``, the three PNGs
   and ``timings.json``, the wall time and each cell's seconds; the same
   command with ``--resume`` (nine cells resumed); pgd ``--adaptive
   --detector mahalanobis``; fgsm and pgd ``--detector_aware --detector
   squeezing`` (these three started together, printed).
9. stream -- 600 generated PNGs (256x300): (a) the defense_experiments CLI
   in a subprocess with ``--max_batch 128 --attacks fgsm pgd`` (5 chunks, the
   last with 88 valid): the "Streaming evaluation" line, six summary lines,
   ``count == 600`` in every cell, each cell's seconds and img/s beside
   phase 8's resident img/s; (b) on the first 300, fgsm in float32 at
   ``--max_batch 128`` and at ``--max_batch 0``: the six counters of the
   streamed and the resident cell, every difference printed (at most 3, an
   image whose top-1 tie flips between the batch shapes); (c) the uint8
   placer on one chunk, bit-equal to the host's ``round(x*255) /
   float32(255)``; in process, a pgd cell through ``stream_defense_cell`` on
   300 images in chunks of 128 with exactly 30 pgd_step, 3 noise and 3
   quantize launches, and an fgsm cell run twice with equal counters.
10. visualize -- the visualize CLI in a subprocess on one PNG at its
   defaults (PGD-20, CW-100): the three PNGs and ``attack_report.json``
   with the JAX CLI's keys, L-inf within eps for fgsm and pgd, SSIM in
   [0, 1], PSNR finite; in process, PGD-20 and its trajectory at batch 1
   (40 pgd_step, 2 noise launches, 21 trajectory rows), both kernels held
   against their plain versions at [1,224,224,3], and ``attack_metrics`` on
   the card against float64 on the CPU (SSIM within 1e-5, norms within 1e-5
   relative).
11. weights -- the random float32 ResNet-50 written as a Flax msgpack file
   (``to_jax_variables``, ``save_variables``) and loaded back through
   ``load_model(weights=...)`` with ``source == "cache"``: bf16 and float32
   logits on the phase-3 batch bit-equal to the random-init models'.
12. families -- VGG19, DenseNet-121, ViT-B/16 and Swin-T at full width,
   224x224, random weights from the seed: float32 logits of the card against
   the CPU on phase 3's two images within 1e-5 relative (TF32 off; the TF32
   reading printed beside it), the bf16 forward's ms at batch 128, bf16 vs
   float32 top-1 agreement on the batch (printed, not gated), the bytes of
   the parameters, and a profile of DenseNet's bf16 forward (its channel
   concatenations).
13. transfer -- (a) ``transfer_attack_batch`` with pgd-20 from the bf16
   ResNet-50 to the four families at batch 128: exactly 20 pgd_step and 1
   noise launches, x_adv in the eps-ball and [0,1], success vectors in {0,1},
   its seconds, the seconds by model and a profile; (b) the same from the
   ResNet-50 + DenseNet-121 logit ensemble to VGG19, ViT and Swin; (c) the
   blackbox_transfer CLI in a subprocess at its defaults (fgsm, pgd, cw-200;
   started together with (d) and (f), printed)
   on phase 8's 128 PNGs: the table's header and three rows, nine panels;
   (d) the transferability CLI at its defaults (pgd-20, 3 eps): its JSON,
   summary table and heatmap; (e) on 300 PNGs, fgsm in float32 streamed in
   chunks of 128 (``stream_transfer_cell``) and resident: equal source and
   target success vectors, every difference printed; (f) the dataset_check
   CLI on 128 generated JPEGs.
14. native loader -- the port's build of the C++ loader: one chunk of 128
   PNGs and one of 128 JPEGs decoded natively and with PIL, both rates and
   the largest difference (at most 1/255); then phase 9(a)'s streamed grid
   command again with ``ADV_TPU_NATIVE_LOADER=1``, img/s per cell beside
   phase 9's.  On a host whose compiler finds no libjpeg the loader cannot
   be built: the phase then checks that the toggle raises instead of
   decoding with PIL, says so, and measures nothing.
15. visualize, complete -- the visualize CLI in a subprocess with
   ``--gradcam --landscape`` on one PNG: ``gradcam_attack.png``,
   ``loss_landscape.png`` and a ``gradcam_iou`` in [0,1] per attack; in
   process, Grad-CAM at batch 128 in bf16 and float32 (7x7 CAMs in [0,1],
   their attention IoU, ms); one 441-point landscape in one batch in bf16
   and float32 (seconds, peak memory), its centre against the clean CE at
   batch 1 (float32 within 1e-5); ``make_gradcam_fn`` on VGG19 raises
   ValueError.
16. int8 -- each int8 op on the card (``torch._int_mm`` behind an im2col)
   bit-equal to the plain int64 route on the CPU, float32 and bf16, at
   ResNet-50's stem (K = 147), a 3x3 and a 1x1 stage conv, a strided 1x1
   downsample and the fc head at M = 1 and 128, its input gradient against
   the float op's, its ms beside the float op's; the five families and the
   tiny CNN in int8, bf16 and float32 at batch 128: forward ms beside the
   float model's (and phases 3 and 12), top-1 agreement with the float
   model, quantized calls per forward against the JAX families' hooked
   layers; PGD-10 on the int8 ResNet-50 through ``load_model(int8=True)``
   (exactly 10 pgd_step and 1 noise launches, ex/s); the classify CLI with
   ``--int8``.
17. transfer attacks -- mifgsm, dim and tim (10 steps) on ResNet-50 at
   batch 128: exactly 10 pgd_step and no noise launches each, the eps-ball,
   seconds; dim at diversity_prob 0 bit-equal to mifgsm; a mifgsm-20
   transfer cell to the four families (20 / 0 launches); then, in this
   process, the transferability CLI and the grid CLI with ``--attacks
   mifgsm dim tim`` on phase 8's 128 PNGs: the summary lines and exactly
   the launches of their nine cells (20 pgd_step a transfer cell; 10
   pgd_step and 1 quantize a grid cell).
18. white-box zoo -- ResNet-50 bf16, random weights, pseudo-labels: (a) at
   batch 128, apgd, apgd_dlr and apgd_t (10 steps, 9 targets), fab (10
   steps, 9 targets), pgd_l2 (eps 3), pgd_l1 (eps 12), pgd_multi_restart
   (5 restarts of PGD-10) and spatial (10 draws; then the 5 x 3 x 3 grid):
   each output in its threat model's ball, in [0,1] and finite, ex/s, the
   share of labels flipped, exactly its launches (noise: 1, 1, 9, 9, 0,
   1, 5 and 0; pgd_step 50 for the restarts, else 0); (b) at batch 32,
   deepfool (50 steps, 10 classes), ead (100 steps), jsma (100 steps; at
   most 100 pixels changed) and stadv (200 steps); (c) each attack of (a)
   and (b) run twice from the same generator, bit-equal; the float32 input
   gradient at batch 32 three times with cuDNN's default and deterministic
   algorithms (equal with the latter, the suite CLI's setting); (d) the
   attack_suite CLI in a subprocess (started with the phase) on 32 of
   phase 8's PNGs with the eleven new names and fgsm, budgets cut to
   ``--steps 5 --n_target_classes 3 --deepfool_steps 5 --cw_steps 10
   --jsma_steps 10 --stadv_steps 20``
   (printed; the JAX CLI's header, rows and JSON keys); the same command
   in this process with and without deterministic cuDNN (reruns still
   bit-equal, each attack's steady seconds beside the subprocess's); in
   this process in float32 with fgsm, apgd and pgd_l1, one batch and
   streamed in chunks of 16 (the fgsm rows' ASR equal), and fab, deepfool,
   ead, jsma, stadv and spatial at smaller budgets (their reruns
   bit-equal); (e) the grid CLI in this process on phase 8's 128 PNGs with ``--attacks
   apgd fab deepfool pgd_l1 --eps_list 0.0157 0.0314`` (budgets cut to
   ``--steps 5 --deepfool_steps 10``, printed): eight summary lines
   (deepfool's cell computed once), one quantize launch a computed cell,
   and the noise of apgd, fab and pgd_l1.
19. black-box -- ResNet-50 bf16, random weights, pseudo-labels: (a) at
   batch 128, square (250 steps), square_l2 (250 steps, eps 3), simba in the
   dct and the pixel basis (150 steps) and bandits (50 steps); (b) at batch
   32, nes and spsa (10 steps of 32 probe pairs), hsja at its defaults and
   boundary (100 steps) (the steps of (a) and boundary's halved to make room
   for phase 23, printed): each in its threat model (the L∞ or L2 ball, or
   [0,1] alone for simba, hsja and boundary), ex/s and queries/s, exactly
   ``steps`` pgd_step launches for nes, spsa and bandits and none else,
   rerun from the same generator bit-equal; the EOT wrapper's host read
   (wrapped calls against the same calls with no read); (c) the robust_eval
   CLI in three subprocesses started together with the phase, ``--protocol lite``,
   ``standard`` and ``rand`` at two eps on 32 PNGs, budgets cut to
   ``--apgd_steps 10 --square_steps 100 --fab_steps 10 --n_target_classes 3
   --deepfool_steps 10 --eot_samples 4`` (printed): the console lines, the
   JSON and the ``--plot`` figure; then in this process
   ``stream_robust_cell`` over 64 PNGs in chunks of 32 (the standard
   protocol) equal to one resident run a chunk under its generator, with
   exactly 1 + 2 x 3 noise launches a chunk; (d) the query_curves CLI in
   this process with the six curve attacks at ``--max_queries 125`` on 32
   PNGs (cut from 500 to keep the script's time; printed), one batch then
   streamed in chunks of 16 (64 pgd_step launches a pass over the images),
   the streamed curves equal to the curves assembled
   from resident runs of each chunk; (e) the grid CLI on 128 PNGs and the
   attack_suite CLI on 32, in this process, with ``--attacks square simba
   hsja`` at cut budgets (printed): six summary lines, simba's cell
   computed once, one quantize launch a computed cell, no other launch;
   and the group's 14 cuda tests (``tests/test_torch_cuda.py``) in a
   subprocess started with the phase, every one passed.
20. certified -- universal threat models and certification at full width:
   (a) ``uap_attack`` on ResNet-50 bf16, 128 images in batches of 32, 4
   epochs, eps 10/255: |delta|inf <= eps, the fooling rate in [0,1], s per
   epoch, no kernel launched (the update is plain torch); (b)
   ``patch_attack``, 32 images, a 50-px patch, 50 steps, targeted: the
   patch in [0,1], the pasted pixels equal to the rotated patch, s per
   step; (c) ``make_eot_logits_fn`` over ``resize_pad_transform`` and over
   ``tv_transform``, n_samples 1 and 8, driving PGD-10 at batch 32 (10
   pgd_step and 1 noise launches each), and ``resize_pad`` on the card
   against the CPU on two images within 1e-5; (d)
   ``SmoothedClassifier.certify`` on ResNet-50 bf16 at its defaults (32 x 4
   = one 128-image forward a chunk) over 32 images, the votes summing to
   n_chunks x chunk, the device and host seconds, then a 3-sigma sweep
   through one counts function; (e) ``ibp_cnn7`` in float32 at 32x32,
   batch 128, IBP and CROWN-IBP at eps 2/255 and 8/255: CROWN >= IBP,
   PGD-20 on the margin never below the certified bound, four images'
   margins within 1e-6 (of the margins' scale) of the CPU's float64 while
   the same margins with TF32 allowed (the guard bypassed) differ by more,
   and the guard refusing TF32; (f) the uap CLI in both modes, the certify
   CLI with ``--method smoothing --plot`` and ``--method crown-ibp --model
   ibp_cnn7``, four subprocesses started together on 32 PNGs, then the grid
   CLI in this process, ``--model ibp_cnn7 --model-dtype float32 --attacks
   fgsm pgd --certified crown-ibp`` on 128 PNGs resident and streamed in
   chunks of 48: equal certified rows, exact launches.
21. detector / corruption -- ResNet-50 bf16 at 224x224, random weights: (a)
   all 17 corruptions of the bank at severities 1-5 through
   ``make_corruption_run`` on the batch of 128 (ms per cell, synchronised,
   after one warm-up per corruption; each output finite and in [0,1]), the
   card against the CPU on 4 of the images with the draws made once on the
   CPU (within 1e-5; pixelate and the exact corruptions, and glass_blur's
   gathers, equal), ``map_coordinates`` in float64 card vs CPU within
   1e-12; (b) fgsm, pgd-10 and cw-100 at batch 128 scored by the feature,
   squeezing and Mahalanobis detectors in stacked [256] calls, with exactly
   10 pgd_step, 4 quantize and 1 noise launches; each detector's stacked
   call timed; quantize at [256,224,224,3] bit-exact; (c) the detector_eval
   CLI at its defaults and the corruption_eval CLI (``--corruptions all
   --severities 1 3 5 --plot``) in two subprocesses started together on 32
   PNGs, and in this process corruption_eval streamed in chunks of 16 (its
   deterministic cells equal the resident run's) and detector_eval
   ``--model-dtype float32 --attacks fgsm`` resident and streamed, the
   feature and squeezing clean scores equal within 1e-5 relative.
22. cifar  -- the CIFAR family and the lightweight ImageNet families,
   random weights: (a) each of wrn28_10, wrn34_10, wrn_tiny,
   preact_resnet18, wrn28_10_robust (32x32), mobilenet_v2, efficientnet_b0
   and convnext_tiny (224x224) in float32 on 4 images, the card against
   the CPU within 1e-5 of the largest logit; (b) the bf16 and int8 forward
   ms at batch 128 of the six full-width families (the quantized calls
   counted), and ConvNeXt-T's 7x7 depthwise convs timed alone per stage
   against their bound and the forward; (c) WRN-28-10 at full width, bf16,
   batch 128, 32x32, eps 8/255: PGD-10 ex/s (10 pgd_step and 1 noise), the
   stage-3 detector threshold calibrated on the clean batch and the pgd ->
   smoothing + quantization -> detector cell (10, 1, 1); (d) the grid CLI
   ``--cifar10_dir`` on a seeded 256-image archive, ``--model wrn28_10
   --attacks fgsm pgd --model-dtype bfloat16``, in a subprocess that
   prints its launches, with (e) ``robust_eval --cifar10_dir`` on 32 of the
   images at cut budgets in this process meanwhile.
23. train -- adversarial and certified training, random weights: (a)
   PGD-AT on ResNet-50 bf16 at the training CLI's defaults (batch 32, PGD-7,
   lr 1e-4, AdamW, frozen BatchNorm), float32 master weights: ms a step and
   ex/s over 10 steps after a warm-up, peak memory, exactly 7 pgd_step and
   1 noise launches a step, one step profiled by layer; pgd_step bit-exact
   (both signs, sign(0) entries) and the noise in distribution at
   [32,224,224,3], outside the counted run; one float32 step
   (attack_steps 0) at batch 2 on the card against the CPU, TF32 off: the
   gradient within 1e-4 of its largest entry, at most 0.1% of the AdamW
   update's entries beyond 1e-3 lr; (b) the adversarial_train CLI at
   ResNet-50's defaults on 128 PNGs in 4 class folders, 2 epochs,
   ``--eval_attack_steps 10 --ema_decay 0.999``: in RAM, ``--streaming``
   and a 1-epoch run in three subprocesses started together, then
   ``--resume`` of the last to 2 epochs: the streamed loss per epoch within
   1e-3 of the in-RAM run's, the streamed and resumed parameters within
   1e-3 of the distance the straight run moved them (planted faults read
   6.8e-2 and more, ``scripts/train_fault_readings.py``), the exported
   msgpack reloaded by
   ``load_model`` to the logits of the checkpoint's EMA parameters; (c) the
   CLI in this process, ``--model wrn28_10 --train_bn --augment crop-flip
   --objective trades`` at batch 128 on a 512-image CIFAR-10 archive: 7
   pgd_step launches a step, precise-BN moving all 25 running statistics,
   the export loading; (d) MART and free-AT on WRN-28-10 bf16 (train_bn),
   IBP and CROWN-IBP on ibp_cnn7 float32, batch 128, 3 steps each, losses,
   launches and the verified accuracy at the ramp's eps.  The 15 training
   cuda tests of ``tests/test_torch_cuda.py`` run in a subprocess beside
   (b) (every objective's float32 step on the card against the CPU's
   float64 one, with the card's draws and PGD iterates replayed; the
   sharded remat step with train_bn over two slots against two CPU slots).
24. serve -- serving and weight import on ResNet-50 bf16 at 224x224, random
   weights, phase 8's PNGs; six subprocesses start together and each waits
   until driven: (a) the serve CLI in file mode (``--input`` a FIFO, so the
   requests come after the ready line) over 256 PNGs and a missing path
   with ``--defend --detector squeezing --detector_threshold 0.5`` at
   ``--batch 8``, ``--batch 128`` and ``--batch 128 --overlap``: 256 ok
   lines and one error line, requests/s after the ready line, latency_ms
   p50/p99, decode_ms, exactly 2 x (chunks + 1) quantize launches, the
   overlap run's top-1s equal to the sequential run's and its scores within
   1e-6; (b) ``--http 0`` under 8 client threads x 16 POSTs (paths and
   image_b64, one bad body: 400): no error response, ``/metrics`` with fewer
   batches than requests, requests/s and the clients' p50/p99, SIGTERM:
   the shutdown line, exit 0, 2 x (batches + 1) quantize launches; (c)
   SIGTERM while streaming on stdin: the shutdown line last, exit 0; (d) the
   service function in float32 card vs CPU on 8 PNGs (probabilities and
   scores within 1e-5, the defended top-1 equal but at printed near-ties),
   quantize bit-exact at [8,224,224,3] and [128,224,224,3], and the CLI's
   main in process on 64 PNGs at batch 8 with exactly 18 quantize launches;
   (e) import_weights on a float32 ResNet-50 ``.pth`` with ``--verify``, the
   file reloaded bit-equal, and a weights dir holding only the ``.pth``
   getting its ``.msgpack`` (the import's bytes), the second load
   ``source="cache"``.
25. scale-out -- on the one card, (a)-(b) in subprocesses started with
   (c)-(d) in this process, then (e)-(f): (a) a process joined through the env contract
   (``maybe_initialize_distributed``: NCCL at world size 1) runs the pgd ->
   smoothing + quantization -> feature detector cell on ResNet-50 bf16 at
   [128,224,224,3] over a data mesh of two slots of the card (20 pgd_step, 2
   noise, 2 quantize launches), each 64-row shard bit-equal (cuDNN
   deterministic) to a one-device run on its rows with its rows of the
   whole batch's draws, the summed counters equal to theirs and all-reduced
   through NCCL; pgd_step and quantize bit-exact and the noise's offset
   draws bit-equal to the whole draw at [64,224,224,3]; PGD-10 ex/s over two
   slots beside one slot's (the sharded path's overhead on one card); (b)
   two ranks on the card over gloo: one PGD-AT step of ResNet-50 bf16 at
   batch 32 (16 rows a rank, 7 pgd_step and 1 noise launches each) against
   the one-process step on the 32 rows (the summed gradient within 0.1 of
   its norm, the parameters within 0.6 of the step's move: limits between
   the sound and the planted faults' readings,
   ``scripts/scaleout_fault_readings.py``), the ranks' and the one-process
   step's ms, FGSM counters summed over the ranks equal to the one-process
   ones; (c) ViT-B/16 and ResNet-50 float32 (TF32 off) at
   [32,224,224,3] over a 1x2 mesh of the card: the cut layers' shards half
   their weights, logits within 1e-4 (abs + rel) of the replicated
   model's, ViT's PGD-3 within 2e-5 but at pixels whose gradient sign
   flipped (at most 1e-4 of them), TP forward ms beside replicated; (d)
   ``entry.dryrun_multichip(4)`` and its JSON line, its launches counted;
   (e) PGD-AT (PGD-7) on WRN-28-10 float32 (TF32 off, cuDNN deterministic)
   with ``train_bn`` and remat at [128,32,32,3] over two slots (ResNet-50
   has no ``train_bn`` in either package): the summed gradient bit-equal to
   the two-slot step without remat's (limit 1e-6) and within 0.05 of the
   one-slot remat step's on the same x_adv, the trap planted (the recompute
   normalizing by the shard's own statistics) and rejected by both
   (``scripts/remat_smoothadv_readings.py``), ms and peak GiB with and
   without remat, 14 pgd_step and 2 noise launches; (f) SmoothAdv PGD-AT
   (sigma 0.25, 4 EOT samples, PGD-7) on ResNet-50 bf16 at [32,224,224,3]
   over two slots: the PGD start, Cohen's noise and the first EOT call's
   noise bit-equal to the one-slot run's, each EOT call's noise bit-equal to
   the one-slot wrapper's draw for the whole batch's input, x_adv bit-equal
   to each shard's rows run alone on one slot with the same draws, 14
   pgd_step and 2 noise launches.  Room for it: phase 18's attack_suite
   subprocess, phase 19's cuda tests and its three robust_eval
   subprocesses now start with their phases (printed).

Then the kernels line (JSON), the card's name and power limit, and last the
line ``{"ok": true, "device": {...}}``.  Without CUDA, or without the port's
package beside it, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "image_recognition_adversarial_example_attack_tpu_torch"
JAX_OPS = "image_recognition_adversarial_example_attack_tpu/ops/pallas_ops.py"
JAX_PROBE = "benchmarks/pallas_conv_probe.py"
SHAPE = (128, 224, 224, 3)
EPS, ALPHA, STEPS, LEVELS = 8 / 255, 2 / 255, 10, 16
# float32 logits, card vs CPU, relative to the largest logit: above a sound
# float32 reading (~1e-6) and below what TF32 convolutions give (~1e-3)
F32_REL_TOL = 1e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
F32_FLOPS = 67e12          # H100 SXM float32 rate outside the tensor cores
CW_STEPS = 100
# The random-weight ResNet-50 puts a top-1 margin of about 1.3 logits on
# every image; at CW's default c = 1 no sample flips in 100 steps, at c = 10
# a few do.  So the cw phase takes c = 10: the check of the successful
# samples has samples to check, and the output takes both branches (best
# successful iterate, final iterate).
CW_C = 10.0
N_STREAM, STREAM_CHUNK, N_F32 = 600, 128, 300
FAMILIES = ("vgg19", "densenet121", "vit_b_16", "swin_t")
TRANSFER_STEPS = 20  # the transferability CLI's default --steps
# phase 8's --resume, adaptive and detector-aware grids (after the default
# grid, whose cell seconds phase 9 compares with), started together to make
# room for phase 24 (printed)
EXPERIMENTS_TRIM = ("the --resume, --adaptive and --detector_aware grids start together after "
                    "the default grid (one after another until PR 13: 11.3 + 11.0 + 14.0 s in "
                    "its final run); their wall and cell s now include each other's load, "
                    "and each wall s runs until this script collects it (an upper bound)")
# phase 13's three CLI subprocesses, started together to make room for phase
# 24 (printed); each keeps its arguments and checks
TRANSFER_TRIM = ("the blackbox_transfer, transferability and dataset_check CLIs start "
                 "together (one after another until PR 13: 28.1 + 20.9 + 10.6 s in its final "
                 "run); each CLI's wall s now includes the other two's load on the card, "
                 "and runs until this script collects it (an upper bound)")
# the key layout of the JAX visualize CLI's attack_report.json (without
# --gradcam); the metric keys are the reference's, in its order
REPORT_KEYS = {"image", "model", "clean_prediction", "params", "attacks"}
CLEAN_KEYS = {"class_id", "class_name", "confidence"}
PARAM_KEYS = {"eps", "alpha", "steps", "cw_c", "cw_steps"}
ATTACK_KEYS = {"predicted_class", "predicted_name", "confidence", "success", "metrics"}
METRIC_KEYS = ["L∞ (pixel)", "L2", "L1", "SSIM", "PSNR", "Perturbed Pixels %",
               "High Freq Ratio %"]
# name -> (TPU kernel it replaces, bytes moved per element: reads + writes)
KERNELS = {
    "pgd_step": (f"{JAX_OPS}:105", 4 * 4),
    "quantize": (f"{JAX_OPS}:132", 2 * 4),
    "uniform_noise": (f"{JAX_OPS}:169", 1 * 4),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph, timed by CUDA events around a replay, so that host
    time between launches (Python, ctypes) does not count."""
    import torch

    fn()  # build, load and allocate outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


# about 25 ms of a 2 GHz clock: longer than the host takes to queue
# QUEUED_LAUNCHES calls of a wrapper
QUEUE_SLEEP_CYCLES, QUEUED_LAUNCHES = 50_000_000, 200


def queued_ms(fn, n: int = QUEUED_LAUNCHES) -> float:
    """Mean device milliseconds per call of ``fn``, its launches back to
    back: a sleep kernel holds the card while the host queues ``n`` calls
    between two CUDA events, so the host's time per call (Python, the
    wrapper, ctypes) does not count, as it does in ``time_ms``.  Raises if
    the card reached the first timed launch before the last was queued."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    if start.query():
        raise AssertionError("queued_ms: the sleep ended before the launches were queued")
    end.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(name: str, numel: int) -> float:
    return KERNELS[name][1] * numel / HBM_BYTES_PER_S * 1e3


def phase_build() -> dict:
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    for name in built:
        build.load_library(name)
    seconds = time.perf_counter() - t0
    log(f"[build] {', '.join(p.name for p, _ in built.values())} in {seconds:.2f} s")
    for _, nvcc_log in built.values():
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] ptxas: {line.strip()}")
    return {"seconds": seconds, "libraries": [str(p) for p, _ in built.values()]}


def _sorted_quantiles(t, n_q: int = 101):
    import torch

    flat = torch.sort(t.reshape(-1)).values
    idx = torch.linspace(0, flat.numel() - 1, n_q, dtype=torch.float64,
                         device=t.device).round().long()
    return flat[idx]


def phase_kernels() -> dict:
    """Each kernel against its plain version on the card."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import build
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    dev, shape = torch.device("cuda"), SHAPE
    lib = build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    g = generator_from_seed(0, dev)
    x = torch.rand(shape, generator=g, device=dev)
    x0 = torch.rand(shape, generator=g, device=dev)
    grad = torch.randn(shape, generator=g, device=dev)
    grad.view(-1)[::7] = 0.0  # sign(0) = 0 must hold
    numel = x.numel()
    out = torch.empty_like(x)
    res = {}

    # pgd_step: bit-exact, untargeted and targeted (-alpha == sign(-g))
    k = ew.pgd_step(x, grad, x0, EPS, ALPHA)
    p = ew.pgd_step_plain(x, grad, x0, EPS, ALPHA)
    kt = ew.pgd_step(x, grad, x0, EPS, -ALPHA)
    pt = ew.pgd_step_plain(x, -grad, x0, EPS, ALPHA)
    torch.cuda.synchronize()
    err = max(float((k - p).abs().max()), float((kt - pt).abs().max()))
    if not (torch.equal(k, p) and torch.equal(kt, pt)):
        raise AssertionError(f"pgd_step kernel differs from its plain version: {err}")
    res["pgd_step"] = {
        "max_abs_err": err, "tolerance": "bit-exact",
        "ms": time_ms(lambda: lib.pgd_step_launch(
            x.data_ptr(), grad.data_ptr(), x0.data_ptr(), out.data_ptr(),
            numel, ALPHA, EPS, stream)),
        "plain_ms": time_ms(lambda: ew.pgd_step_plain(x, grad, x0, EPS, ALPHA)),
        "library_ms": None,
    }

    # quantize: bit-exact, with values outside [0,1] and exact .5 ties
    xq = x * 1.2 - 0.1
    ties = (torch.arange(numel // 11, device=dev) % (LEVELS - 1)).float()
    xq.view(-1)[::11][:ties.numel()] = (ties + 0.5) / (LEVELS - 1)
    n_ties = int(((xq.clamp(0, 1) * (LEVELS - 1)) % 1 == 0.5).sum())
    k = ew.quantize(xq, LEVELS)
    p = ew.quantize_plain(xq, LEVELS)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    if not torch.equal(k, p) or n_ties == 0:
        raise AssertionError(f"quantize kernel differs from its plain version: "
                             f"{err} ({n_ties} ties)")
    lib_q = torch.fake_quantize_per_tensor_affine(xq, 1.0 / (LEVELS - 1), 0, 0, LEVELS - 1)
    res["quantize"] = {
        "max_abs_err": err, "tolerance": "bit-exact", "ties": n_ties,
        "ms": time_ms(lambda: lib.quantize_launch(
            xq.data_ptr(), out.data_ptr(), numel, float(LEVELS - 1), stream)),
        "plain_ms": time_ms(lambda: ew.quantize_plain(xq, LEVELS)),
        # no PyTorch call gives these bits: fake-quantize multiplies by a
        # rounded 1/scale and breaks some ties the other way; timed as a
        # yardstick only
        "library_ms": None,
        "fake_quantize_ms": time_ms(lambda: torch.fake_quantize_per_tensor_affine(
            xq, 1.0 / (LEVELS - 1), 0, 0, LEVELS - 1)),
        "fake_quantize_max_abs_diff": float((lib_q - k).abs().max()),
    }

    # uniform noise: the distribution, and the quantiles of the plain version
    n1 = ew.uniform_noise(shape, EPS, generator_from_seed(1), dev)
    n2 = ew.uniform_noise(shape, EPS, generator_from_seed(2), dev)
    plain = ew.uniform_noise_plain(shape, EPS, generator_from_seed(3, dev))
    eps32 = torch.tensor(EPS, dtype=torch.float32, device=dev)  # the kernel's eps
    d = n1.double()
    mean, var = float(d.mean()), float(d.var())
    corr = float(torch.corrcoef(torch.stack([d.reshape(-1), n2.double().reshape(-1)]))[0, 1])
    err = float((_sorted_quantiles(n1) - _sorted_quantiles(plain)).abs().max())
    checks = {
        "in_range": bool(n1.min() >= -eps32 and n1.max() <= eps32),
        "mean": abs(mean) < 1e-3 * EPS,
        "var": abs(var / (EPS ** 2 / 3) - 1) < 2e-3,
        "corr": abs(corr) < 1e-3,
        "quantiles": err < 5e-3 * EPS,
    }
    if not all(checks.values()):
        raise AssertionError(f"noise kernel fails its distribution checks: {checks} "
                             f"mean={mean} var={var} corr={corr} qerr={err}")
    g3 = generator_from_seed(4, dev)
    res["uniform_noise"] = {
        "max_abs_err": err,
        "tolerance": "distribution: range, |mean| < 1e-3 eps, var within 0.2% "
                     "of eps^2/3, |corr| < 1e-3, 101 quantiles within 5e-3 eps",
        "mean": mean, "var": var, "corr": corr,
        "ms": time_ms(lambda: lib.uniform_noise_launch(
            out.data_ptr(), numel, 12345, EPS, 0, stream)),
        "plain_ms": time_ms(lambda: ew.uniform_noise_plain(shape, EPS, g3)),
        "library_ms": time_ms(lambda: torch.empty(shape, device=dev).uniform_(-EPS, EPS)),
        "library_call": "torch.Tensor.uniform_",
    }
    for name, r in res.items():
        r["bound_ms"] = bound_ms(name, numel)
        line = {"kernel": name, "shape": list(shape), "kernel_ms": r["ms"],
                **{k: v for k, v in r.items() if k != "ms"}}
        log(f"[kernels] {json.dumps(line)}")
    return res


def conv_bound_ms(x, w, out) -> tuple[float, str, float, float]:
    """(bound, what bounds it, bytes ms, flops ms) of one 3x3 conv: each
    input read once and the output written once, against the card's memory
    rate; 2*B*H*W*9*Cin*Cout operations against its peak for the dtype."""
    import torch

    b, h, wd, c = x.shape
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, out))
    flops = 2 * b * h * wd * 9 * c * out.shape[-1]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / (BF16_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS) * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations"), \
        bytes_ms, flops_ms


def phase_conv() -> dict:
    """The 3x3 conv kernel against its plain version and cuDNN, then the
    probe's entry point (the conv's main path) with its launches counted."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.benchmarks import conv_probe
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import conv3x3 as cv

    dev = torch.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are allowed: the float32 plain version "
                             "would not be float32")
    x, w = conv_probe.make_inputs(128, torch.bfloat16, dev)
    k = cv.conv3x3(x, w)
    launch_bf16 = dict(cv.LAST_LAUNCH)
    p = cv.conv3x3_plain(x, w)
    lo, hi = cv.bf16_rounding_interval(x, w)
    torch.cuda.synchronize()
    diff = (k.float() - p.float()).abs()
    ulp = torch.maximum(cv.bf16_ulp(k), cv.bf16_ulp(p))
    beyond = diff > ulp
    inside = bool(((lo <= k) & (k <= hi)).all())
    frac_beyond = float(beyond.float().mean())
    worst = float(p.float().abs()[beyond].max()) if bool(beyond.any()) else 0.0
    if not inside or frac_beyond >= 1e-3:
        raise AssertionError(f"conv3x3 bf16 kernel vs plain: in the rounding interval "
                             f"{inside}, {frac_beyond:.2e} of elements beyond one ulp")
    ref = conv_probe.cudnn_conv3x3(x, w)
    rel_cudnn = float((k.float() - ref.float()).abs().max()) / float(ref.float().abs().max())
    if not rel_cudnn < conv_probe.GATE:
        raise AssertionError(f"conv3x3 vs F.conv2d: rel {rel_cudnn}")

    f32 = {}
    for batch in (8, 128):
        x32, w32 = conv_probe.make_inputs(batch, torch.float32, dev)
        k32, p32 = cv.conv3x3(x32, w32), cv.conv3x3_plain(x32, w32)
        torch.cuda.synchronize()
        rel32 = float((k32 - p32).abs().max()) / float(p32.abs().max())
        if not rel32 <= 1e-5:
            raise AssertionError(f"conv3x3 float32 kernel vs plain at batch {batch}: "
                                 f"{rel32} of max |out|")
        f32[f"rel_err_b{batch}"] = rel32
        f32[f"frac_bit_equal_b{batch}"] = float((k32 == p32).float().mean())
    f32["launch"] = dict(cv.LAST_LAUNCH)
    # the float32 instantiation's times at the probe's batch; cuDNN with TF32
    # off, so that it computes the same float32 function
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        f32["ms"] = time_ms(lambda: cv.conv3x3(x32, w32))
        f32["graph_ms"] = graph_ms(lambda: cv.conv3x3(x32, w32))
        f32["plain_ms"] = time_ms(lambda: cv.conv3x3_plain(x32, w32), iters=5, warmup=1)
        f32["library_ms"] = time_ms(lambda: conv_probe.cudnn_conv3x3(x32, w32))
        f32["library_graph_ms"] = graph_ms(lambda: conv_probe.cudnn_conv3x3(x32, w32))
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    f32["bound_ms"], f32["bound_by"], _, _ = conv_bound_ms(x32, w32, k32)
    del k32, p32

    out = torch.empty_like(x)
    bound, bound_by, bytes_ms, flops_ms = conv_bound_ms(x, w, out)
    res = {
        "max_abs_err": float(diff.max()), "tolerance": (
            "every element in the bf16 rounding interval of a float32 sum of its "
            "576 exact products; fewer than 0.1% more than one bf16 ulp apart"),
        "frac_equal": float((diff == 0).float().mean()), "frac_beyond_one_ulp": frac_beyond,
        "largest_value_beyond_one_ulp": worst, "rel_err_vs_cudnn": rel_cudnn,
        "float32": f32, "launch": launch_bf16,
        # ms: calls issued from Python one by one, as every kernel's ms;
        # graph_ms: the same calls replayed from a CUDA graph, without the
        # host's time per call (checks, ctypes, tensor-map encoding)
        "ms": time_ms(lambda: cv.conv3x3(x, w)),
        "graph_ms": graph_ms(lambda: cv.conv3x3(x, w)),
        "plain_ms": time_ms(lambda: cv.conv3x3_plain(x, w), iters=5, warmup=1),
        "library_ms": time_ms(lambda: conv_probe.cudnn_conv3x3(x, w)),
        "library_graph_ms": graph_ms(lambda: conv_probe.cudnn_conv3x3(x, w)),
        "library_call": "F.conv2d, channels_last bf16 (cuDNN)",
        "bound_ms": bound, "bound_by": bound_by, "bytes_ms": bytes_ms, "flops_ms": flops_ms,
    }
    del p, lo, hi, diff, ulp, beyond
    # the wrapper's host time per call where the device's is negligible: a
    # one-pixel image, host clock around 200 calls issued back to back
    x1 = x[:1, :1, :1].contiguous()
    cv.conv3x3(x1, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        cv.conv3x3(x1, w)
    res["wrapper_host_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    log(f"[conv] {json.dumps({'kernel': 'conv3x3', 'shape': list(x.shape), **res})}")

    # the probe's entry point: its launches are the conv's main path
    cv.reset_launches()
    probe = conv_probe.run()
    torch.cuda.synchronize()
    res["launches"] = cv.launch_counts()["conv3x3"]
    res["probe"] = probe
    log(f"[conv] probe (in process): {json.dumps(probe)}; launches {res['launches']}")
    if res["launches"] < 1:
        raise AssertionError("the conv probe launched no conv3x3 kernel")

    proc = subprocess.run([sys.executable, "-m", f"{PKG}.benchmarks.conv_probe"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"conv probe exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if line["device"] != torch.cuda.get_device_name(0) or not line["rel_err_vs_cudnn"] < 3e-2:
        raise AssertionError(f"conv probe printed {line}")
    res["probe_subprocess"] = line
    log(f"[conv] probe (subprocess): {json.dumps(line)}")
    return res


def phase_classify() -> dict:
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    dev, batch = torch.device("cuda"), SHAPE[0]
    # float32 on the card (TF32 off) against the CPU, same seeded weights;
    # the same logits with TF32 allowed show that the limit would catch a leak
    ref = {}
    x_small = torch.rand((2, 224, 224, 3), generator=generator_from_seed(5))
    for d in ("cpu", "cuda"):
        b = load_model("resnet50", dtype=torch.float32, device=d)
        lf = make_logits_fn(b.model, b.mean, b.std)
        with torch.no_grad():
            ref[d] = lf(x_small.to(b.device)).cpu()
            if d == "cuda":
                torch.backends.cudnn.allow_tf32 = True
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    ref["tf32"] = lf(x_small.to(b.device)).cpu()
                finally:
                    torch.backends.cudnn.allow_tf32 = False
                    torch.backends.cuda.matmul.allow_tf32 = False
        del b
    scale = float(ref["cpu"].abs().max())
    f32_err = float((ref["cuda"] - ref["cpu"]).abs().max()) / scale
    tf32_err = float((ref["tf32"] - ref["cpu"]).abs().max()) / scale
    if not f32_err <= F32_REL_TOL < tf32_err:
        raise AssertionError(f"float32 logits on the card vs the CPU: {f32_err:.3e} "
                             f"relative, with TF32 {tf32_err:.3e}; the limit "
                             f"{F32_REL_TOL:.0e} must lie between them")
    log(f"[classify] float32 card vs CPU, 2 images: max|diff| {f32_err:.3e} of "
        f"max |logit| {scale:.3e} (limit {F32_REL_TOL:.0e}); with TF32 allowed "
        f"{tf32_err:.3e}")

    bundle = load_model("resnet50", dtype=torch.bfloat16, device=dev)
    lf = make_logits_fn(bundle.model, bundle.mean, bundle.std, input_dtype=torch.bfloat16)
    x = torch.rand((batch, 224, 224, 3), generator=generator_from_seed(6, dev), device=dev)
    with torch.no_grad():
        logits = lf(x)
        ms = time_ms(lambda: lf(x), iters=5, warmup=1)
    if logits.shape != (batch, 1000) or logits.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    y = logits.argmax(-1)
    with torch.no_grad():
        small = lf(x_small.to(dev)).cpu()
    bf16_vs_f32 = float((small - ref["cuda"]).abs().max())
    log(f"[classify] bf16 vs float32 logits, same 2 images: max|diff| {bf16_vs_f32:.3e}, "
        f"top-1 {'agrees' if torch.equal(small.argmax(-1), ref['cuda'].argmax(-1)) else 'differs'}")
    log(f"[classify] resnet50 bf16 batch {batch}: logits {tuple(logits.shape)} finite, "
        f"{len(set(y.tolist()))} distinct top-1 classes, forward {ms:.2f} ms "
        f"({batch / ms * 1e3:.1f} img/s)")
    return {"bundle": bundle, "x": x, "y": y, "forward_ms": ms,
            "f32_card_vs_cpu_rel": f32_err, "tf32_card_vs_cpu_rel": tf32_err,
            "bf16_vs_f32": bf16_vs_f32}


def _check_ball(x_adv, x, eps: float, where: str) -> float:
    linf = float((x_adv - x).abs().max())
    if not linf <= eps + 1e-6:
        raise AssertionError(f"{where}: |x_adv - x|_inf = {linf} > eps {eps}")
    if not (float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0):
        raise AssertionError(f"{where}: x_adv leaves [0,1]")
    return linf


# kernel-name fragments -> the layer of a PGD step each kernel belongs to;
# the first match wins (a BatchNorm kernel may say "transform", a cuDNN
# conv "implicit_gemm")
_LAYERS = (
    ("port kernels", ("pgd_step_kernel", "quantize_kernel", "uniform_noise_kernel")),
    ("batchnorm", ("batch_norm", "bn_")),
    ("conv input-gradient", ("dgrad",)),
    ("conv forward", ("fprop", "implicit_gemm", "xmma", "conv")),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "cublas", "cutlass")),
    ("copies and layout transforms", ("copy", "memset", "memcpy", "transform", "padding")),
)

def profile_breakdown(fn) -> dict:
    """Device time of one call of ``fn`` by layer, from torch.profiler's
    kernel events, and the share of the wall time the card was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_layer: dict[str, float] = {}
    by_kernel: dict[str, list] = {}
    spans = []
    for e in events:
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.lower()
        layer = next((lay for lay, keys in _LAYERS if any(k in name for k in keys)),
                     "other elementwise")
        by_layer[layer] = by_layer.get(layer, 0.0) + us / 1e3
        k = by_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += us / 1e3
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(spans):  # union of the kernel intervals
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:30]
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / wall_us, "kernels": len(events),
            "by_layer_ms": dict(sorted(by_layer.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:400], "count": c, "ms": ms} for n, (c, ms) in top]}


def phase_pgd(state: dict) -> dict:
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, make_logits_fn, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    b, x, y = state["bundle"], state["x"], state["y"]
    lf = make_logits_fn(b.model, b.mean, b.std, input_dtype=torch.bfloat16)
    params = AttackParams(eps=EPS, alpha=ALPHA, steps=STEPS, random_start=True)

    torch.cuda.reset_peak_memory_stats()
    ew.reset_launches()
    x_adv = run_attack("pgd", lf, x, y, params, generator_from_seed(0))
    torch.cuda.synchronize()
    counts = ew.launch_counts()
    want = {"pgd_step": STEPS, "quantize": 0, "uniform_noise": 1}
    if counts != want:
        raise AssertionError(f"PGD-10 launches {counts}, want {want}")
    linf = _check_ball(x_adv, x, EPS, "pgd")
    with torch.no_grad():
        success = float((lf(x_adv).argmax(-1) != y).float().mean())

    runs = 3
    t0 = time.perf_counter()
    for i in range(runs):
        run_attack("pgd", lf, x, y, params, generator_from_seed(10 + i))
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / runs
    ex_s = x.shape[0] / seconds
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"[pgd] launches {counts}; |x_adv - x|_inf {linf:.6f} <= eps {EPS:.6f}; "
        f"attack success {success:.3f}")
    log(f"[pgd] PGD-10 resnet50@224 batch {x.shape[0]} bf16: {seconds * 1e3:.1f} ms "
        f"per attack, {ex_s:.1f} ex/s (mean of {runs} after a warm-up); "
        f"peak memory {peak_gib:.2f} GiB")
    prof = profile_breakdown(
        lambda: run_attack("pgd", lf, x, y, params, generator_from_seed(20)))
    log(f"[pgd] profile of one attack: wall {prof['wall_ms']:.1f} ms, card busy "
        f"{prof['busy_ms']:.1f} ms ({prof['busy_share']:.3f}), {prof['kernels']} kernels; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in prof["by_layer_ms"].items()))
    for k in prof["top_kernels"][:10]:
        log(f"[pgd]   {k['ms']:8.2f} ms  x{k['count']:<4d} {k['name'][:220]}")
    return {"launches": counts, "linf": linf, "attack_success": success,
            "seconds_per_attack": seconds, "ex_per_s": ex_s, "peak_gib": peak_gib,
            "profile": prof}


def phase_cell(state: dict) -> dict:
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        calibrate_feature_threshold)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch, summary_line)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    b, x, y = state["bundle"], state["x"], state["y"]
    lf, ff = make_fns(b)
    thr = calibrate_feature_threshold(ff, x, n=x.shape[0])
    cfg = DefenseEvalConfig(attack_name="pgd", eps=EPS, alpha=ALPHA, steps=STEPS)

    ew.reset_launches()
    t0 = time.perf_counter()
    out = evaluate_defenses_batch(lf, ff, x, y, thr, cfg, generator_from_seed(1))
    stats = aggregate_stats(out)
    seconds = time.perf_counter() - t0
    counts = ew.launch_counts()
    if counts["quantize"] < 1 or counts["pgd_step"] != STEPS or counts["uniform_noise"] != 1:
        raise AssertionError(f"defense cell launches {counts}")
    _check_ball(out["x_adv"], x, EPS, "cell")
    if stats["count"] != x.shape[0] or any(
            not 0 <= stats[k] <= stats["count"] for k in stats):
        raise AssertionError(f"counters out of range: {stats}")
    line = summary_line("pgd", EPS, stats)
    log(f"[cell] launches {counts}; threshold {thr:.4f}; {seconds:.2f} s")
    log(line)
    return {"launches": counts, "threshold": thr, "stats": stats,
            "summary_line": line, "seconds": seconds}


def phase_cw(state: dict) -> dict:
    """CW-L2 through the function ``run_attack("cw", ...)`` dispatches to,
    which also returns the per-sample success the check needs."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, cw_l2_attack, make_logits_fn)

    b, x, y = state["bundle"], state["x"], state["y"]
    lf = make_logits_fn(b.model, b.mean, b.std, input_dtype=torch.bfloat16)
    p = AttackParams(cw_steps=CW_STEPS, cw_c=CW_C)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cw_l2_attack(lf, x, y, c=p.cw_c, kappa=p.cw_kappa, steps=p.cw_steps, lr=p.cw_lr)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    x_adv, success = res.x_adv, res.success
    if not (float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0):
        raise AssertionError("cw: x_adv leaves [0,1]")
    with torch.no_grad():
        pred = lf(x_adv).argmax(-1)
    fooled = pred != y
    if not bool(success.any()):
        raise AssertionError("cw: no sample succeeded; the check below would be empty")
    if not bool(fooled[success].all()):
        raise AssertionError(f"cw: {int((success & ~fooled).sum())} samples marked "
                             f"successful are classified correctly at the returned image")
    l2 = (x_adv - x).reshape(x.shape[0], -1).norm(dim=-1)
    n_succ = int(success.sum())
    mean_l2 = float(l2[success].mean()) if n_succ else float("nan")
    log(f"[cw] CW-L2 {CW_STEPS} steps c={CW_C} resnet50@224 batch {x.shape[0]} bf16: "
        f"{seconds * 1e3:.1f} ms per attack, {x.shape[0] / seconds:.2f} ex/s; "
        f"success {n_succ}/{x.shape[0]}, all misclassified at the returned image; "
        f"mean L2 of the successful {mean_l2:.4f}")
    return {"seconds_per_attack": seconds, "ex_per_s": x.shape[0] / seconds,
            "success": n_succ, "mean_l2_success": mean_l2}


def phase_cells(state: dict) -> dict:
    """pgd cells with the JPEG arm (DCT codec, host codec) and the TV arm."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import DefenseConfig
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch, summary_line)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    b, x, y = state["bundle"], state["x"], state["y"]
    lf, ff = make_fns(b)
    thr = state["threshold"]
    arms = {"jpeg_dct": DefenseConfig(use_jpeg=True, jpeg_mode="dct"),
            "jpeg_host": DefenseConfig(use_jpeg=True, jpeg_mode="host"),
            "tv": DefenseConfig(use_tv=True)}
    out = {}
    for name, defense in arms.items():
        cfg = DefenseEvalConfig(attack_name="pgd", eps=EPS, alpha=ALPHA, steps=STEPS,
                                defense=defense)
        ew.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = evaluate_defenses_batch(lf, ff, x, y, thr, cfg, generator_from_seed(2))
        stats = aggregate_stats(res)
        seconds = time.perf_counter() - t0
        counts = ew.launch_counts()
        if counts != {"pgd_step": STEPS, "quantize": 1, "uniform_noise": 1}:
            raise AssertionError(f"{name} cell launches {counts}")
        _check_ball(res["x_adv"], x, EPS, name)
        if stats["count"] != x.shape[0] or any(
                not 0 <= stats[k] <= stats["count"] for k in stats):
            raise AssertionError(f"{name}: counters out of range: {stats}")
        line = summary_line("pgd", EPS, stats)
        log(f"[cells] {name}: launches {counts}; {seconds:.3f} s")
        log(f"[cells] {name}: {line}")
        out[name] = {"launches": counts, "stats": stats, "summary_line": line,
                     "seconds": seconds}
    return out


def _check_cell(name: str, out: dict, x, stats: dict, counts: dict, want: dict) -> None:
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want}")
    _check_ball(out["x_adv"], x, EPS, name)
    if stats["count"] != x.shape[0] or any(
            not 0 <= stats[k] <= stats["count"] for k in stats):
        raise AssertionError(f"{name}: counters out of range: {stats}")


def phase_detectors(state: dict) -> dict:
    """pgd cells under --adaptive, --detector_aware, and with the squeezing
    and Mahalanobis detectors, each with its launches counted."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        calibrate_mahalanobis, calibrate_squeezing_threshold, feature_score, fit_mahalanobis,
        mahalanobis_score_from_features, pool_features)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch, summary_line)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    b, x, y = state["bundle"], state["x"], state["y"]
    lf, ff = make_fns(b)
    res: dict = {}

    t0 = time.perf_counter()
    sq_thr = calibrate_squeezing_threshold(lf, x, n=x.shape[0])
    res["squeezing_threshold"] = sq_thr
    res["squeezing_calibration_s"] = time.perf_counter() - t0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, mh_thr = calibrate_mahalanobis(ff, x, y, 1000, n=x.shape[0])
    torch.cuda.synchronize()
    res["mahalanobis_calibration_s"] = time.perf_counter() - t0
    if tuple(params.mean.shape) != (1000, 1024) or tuple(params.precision.shape) != (1024, 1024):
        raise AssertionError(f"mahalanobis params {params.mean.shape} {params.precision.shape}")
    finite = bool(torch.isfinite(params.mean).all() and torch.isfinite(params.precision).all())
    if not finite or not mh_thr == mh_thr:
        raise AssertionError("mahalanobis: non-finite params or threshold")
    with torch.no_grad():
        z = pool_features(ff(x))
    fit = res["mahalanobis_fit"] = {
        "threshold": mh_thr, "params_finite": finite,
        "fit_ms": time_ms(lambda: fit_mahalanobis(z, y, 1000), iters=3, warmup=1),
        "score_ms": time_ms(lambda: mahalanobis_score_from_features(z, params),
                            iters=5, warmup=1),
    }
    log(f"[detectors] mahalanobis fit on {x.shape[0]} clean images (K=1000, C=1024): "
        f"{fit['fit_ms']:.2f} ms, score of {x.shape[0]} images "
        f"{fit['score_ms']:.2f} ms, params finite {finite}, threshold "
        f"{mh_thr:.4f}; calibration (features + fit + scores) "
        f"{res['mahalanobis_calibration_s']:.3f} s")
    log(f"[detectors] squeezing threshold {sq_thr:.6f} "
        f"({res['squeezing_calibration_s']:.3f} s, 1 quantize launch)")

    base = {"attack_name": "pgd", "eps": EPS, "alpha": ALPHA, "steps": STEPS}
    cells = {
        "adaptive": (DefenseEvalConfig(**base, adaptive=True), state["threshold"],
                     {"pgd_step": STEPS, "quantize": STEPS + 1, "uniform_noise": 1}),
        "detector_aware": (DefenseEvalConfig(**base, detector_aware=True, detector_lam=1.0,
                                             detector_margin=0.9), state["threshold"],
                           {"pgd_step": STEPS, "quantize": 1, "uniform_noise": 1}),
        "squeezing": (DefenseEvalConfig(**base, detector="squeezing"), sq_thr,
                      {"pgd_step": STEPS, "quantize": 3, "uniform_noise": 1}),
        "mahalanobis": (DefenseEvalConfig(**base, detector="mahalanobis",
                                          detector_params=params), mh_thr,
                        {"pgd_step": STEPS, "quantize": 1, "uniform_noise": 1}),
    }
    x_adv = {}
    for name, (cfg, thr, want) in cells.items():
        ew.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate_defenses_batch(lf, ff, x, y, thr, cfg, generator_from_seed(1))
        stats = aggregate_stats(out)
        seconds = time.perf_counter() - t0
        counts = ew.launch_counts()
        _check_cell(name, out, x, stats, counts, want)
        x_adv[name] = out["x_adv"]
        line = summary_line("pgd", EPS, stats)
        log(f"[detectors] {name}: launches {counts}; {seconds:.3f} s")
        log(f"[detectors] {name}: {line}")
        res[name] = {"launches": counts, "stats": stats, "summary_line": line,
                     "seconds": seconds, "threshold": thr}
    # the oblivious cells (c, d) ran plain PGD from the same generator
    with torch.no_grad():
        aware = float(feature_score(ff, x_adv["detector_aware"]).mean())
        oblivious = float(feature_score(ff, x_adv["squeezing"]).mean())
    res["detector_aware"]["mean_feature_score"] = aware
    res["detector_aware"]["oblivious_mean_feature_score"] = oblivious
    log(f"[detectors] mean feature score of x_adv: detector-aware {aware:.4f}, oblivious "
        f"{oblivious:.4f} (threshold {state['threshold']:.4f}, margin 0.9)")
    return res


SUMMARY_RE = (r"^attack=(fgsm|pgd|cw), eps=(\d\.\d{5}), attack_success=\d\.\d{3}, "
              r"preproc_defense_acc=\d\.\d{3}, detector_clean_pass_rate=\d\.\d{3}, "
              r"detector_adv_flag_rate=\d\.\d{3}, detector_attack_success=\d\.\d{3}$")


def _start_experiments(image_dir: Path, out_dir: Path, *args: str,
                       env: dict | None = None) -> tuple:
    return _start_cli_module("defense_experiments", "--image_dir", str(image_dir),
                             "--output_dir", str(out_dir), *args, env=env)


def _run_experiments(image_dir: Path, out_dir: Path, *args: str,
                     env: dict | None = None) -> tuple[str, float]:
    return _finish_experiments(_start_experiments(image_dir, out_dir, *args, env=env))


def _finish_experiments(started: tuple) -> tuple[str, float]:
    import re

    out, seconds = _finish_cli_module(started)
    lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
    if not lines or not all(re.match(SUMMARY_RE, ln) for ln in lines):
        raise AssertionError(f"defense_experiments summary lines malformed: {lines}")
    return out, seconds


def _write_pngs(image_dir: Path, n: int, seed: int = 0, suffix: str = ".png") -> list[Path]:
    """``n`` random 256x300 images (a 224 crop after the resize); the first
    k of a seed's n are its k."""
    import numpy as np
    from PIL import Image

    image_dir.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    paths = [image_dir / f"img_{i:03d}{suffix}" for i in range(n)]
    for p in paths:
        Image.fromarray((rng.rand(256, 300, 3) * 255).astype(np.uint8)).save(p)
    return paths


def _linked(paths: list[Path], image_dir: Path) -> Path:
    """A directory of symbolic links to ``paths``."""
    image_dir.mkdir(parents=True)
    for p in paths:
        (image_dir / p.name).symlink_to(p)
    return image_dir


def phase_experiments() -> dict:
    res: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        image_dir = Path(tmp) / "images"
        _write_pngs(image_dir, SHAPE[0])
        grid_dir = Path(tmp) / "grid"
        grid = ["--cw_steps", str(CW_STEPS)]

        out, seconds = _run_experiments(image_dir, grid_dir, *grid)
        lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
        if len(lines) != 9:
            raise AssertionError(f"default grid printed {len(lines)} summary lines")
        reused = out.count("(cw is eps-independent: reusing the computed cell)")
        if reused != 2:
            raise AssertionError(f"cw reused {reused} times, want 2")
        partial = json.loads((grid_dir / "results_partial.json").read_text())
        if len(partial) != 9 or any(c["count"] != SHAPE[0] for c in partial.values()):
            raise AssertionError(f"results_partial.json holds {sorted(partial)}")
        for name in ("defense_results_attack_trend.png", "defense_results_defense_matrix.png",
                     "attack_samples.png", "timings.json"):
            if not (grid_dir / name).is_file():
                raise AssertionError(f"the default grid wrote no {name}")
        timings = json.loads((grid_dir / "timings.json").read_text())
        cells = {k: v["seconds"] for k, v in timings.items()}
        res["grid"] = {"wall_s": seconds, "cell_s": cells, "cells_s_total": sum(cells.values()),
                       "summary": lines}
        log(f"[experiments] default grid, {SHAPE[0]} images, cw_steps {CW_STEPS}: exit 0 in "
            f"{seconds:.1f} s; cells {sum(cells.values()):.2f} s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in cells.items()))
        for ln in lines:
            log(f"[experiments] {ln}")

        runs = {
            "adaptive_mahalanobis": ["--attacks", "pgd", "--eps_list", "0.03137", "--adaptive",
                                     "--detector", "mahalanobis", "--viz_samples", "0"],
            "aware_squeezing": ["--attacks", "fgsm", "pgd", "--eps_list", "0.03137",
                                "--detector_aware", "--detector", "squeezing",
                                "--viz_samples", "0"],
        }
        log(f"[experiments] cut (room for phase 24): {EXPERIMENTS_TRIM}")
        started = {"resume": _start_experiments(image_dir, grid_dir, *grid, "--resume"),
                   **{name: _start_experiments(image_dir, Path(tmp) / name, *args)
                      for name, args in runs.items()}}
        out, seconds = _finish_experiments(started["resume"])
        resumed = out.count("(resumed from partial results)")
        if resumed != 9:
            raise AssertionError(f"--resume resumed {resumed} cells, want 9")
        res["resume"] = {"wall_s": seconds, "resumed": resumed}
        log(f"[experiments] --resume: {resumed} cells resumed, exit 0 in {seconds:.1f} s")

        for name, args in runs.items():
            out_dir = Path(tmp) / name
            out, seconds = _finish_experiments(started[name])
            lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
            timings = json.loads((out_dir / "timings.json").read_text())
            if len(lines) != len(args[args.index("--attacks") + 1:args.index("--eps_list")]):
                raise AssertionError(f"{name}: {len(lines)} summary lines")
            res[name] = {"wall_s": seconds, "summary": lines,
                         "cell_s": {k: v["seconds"] for k, v in timings.items()}}
            log(f"[experiments] {' '.join(args)}: exit 0 in {seconds:.1f} s; cells "
                + ", ".join(f"{k} {v['seconds']:.3f} s" for k, v in timings.items()))
            for ln in lines:
                log(f"[experiments] {ln}")
    return res


def _run_cli(img: Path, adv: Path, *attack_args: str):
    cmd = [sys.executable, "-m", f"{PKG}.cli.classify", str(img), *attack_args,
           "--save_adv", str(adv)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"classify CLI exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    title = f"Adversarial ({attack_args[1]}):"
    for want in ("Clean:", title, "Top 5: "):
        if want not in proc.stdout:
            raise AssertionError(f"classify CLI printed no '{want}':\n{proc.stdout}")
    if not adv.is_file():
        raise AssertionError(f"classify CLI saved no {adv.name}")
    return proc, seconds


def phase_cli() -> dict:
    import numpy as np
    from PIL import Image

    from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image

    with tempfile.TemporaryDirectory() as tmp:
        img = Path(tmp) / "input.png"
        adv = Path(tmp) / "adv.png"
        rng = np.random.RandomState(0)
        Image.fromarray((rng.rand(256, 300, 3) * 255).astype(np.uint8)).save(img)
        proc, seconds = _run_cli(img, adv, "--attack", "pgd")
        saved = np.asarray(Image.open(adv), np.float32) / 255.0
        linf = float(np.abs(saved - load_image(img)[0]).max())
        if not linf <= EPS + 0.5 / 255 + 1e-6:
            raise AssertionError(f"saved adversarial image is {linf} from the clean one")
        log(f"[cli] classify --attack pgd --save_adv: exit 0 in {seconds:.1f} s; "
            f"saved image within {linf:.5f} of the clean one (eps + 0.5/255 allowed)")
        log("[cli] " + " | ".join(proc.stdout.strip().splitlines()[:4]))
        adv_cw = Path(tmp) / "adv_cw.png"
        proc_cw, seconds_cw = _run_cli(img, adv_cw, "--attack", "cw",
                                       "--cw_steps", str(CW_STEPS))
        saved = np.asarray(Image.open(adv_cw), np.float32) / 255.0
        l2_cw = float(np.linalg.norm(saved - load_image(img)[0]))
        log(f"[cli] classify --attack cw --cw_steps {CW_STEPS} --save_adv: exit 0 in "
            f"{seconds_cw:.1f} s; saved image at L2 {l2_cw:.4f} from the clean one")
        log("[cli] " + " | ".join(proc_cw.stdout.strip().splitlines()[7:10]))
    return {"seconds": seconds, "linf_png": linf, "cw_seconds": seconds_cw, "cw_l2_png": l2_cw}


def _cells_s(out_dir: Path) -> dict[str, float]:
    timings = json.loads((out_dir / "timings.json").read_text())
    return {k: v["seconds"] for k, v in timings.items()}


def phase_stream(state: dict, resident_cell_s: dict, paths: list[Path]) -> dict:
    """The grid streamed past --max_batch on ``paths`` (N_STREAM PNGs): the
    CLI, float32 streamed against resident, the uint8 placer, and streamed
    cells in this process."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import (
        load_image_batch_tolerant)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        STAT_KEYS, DefenseEvalConfig)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
        make_placer, stream_defense_cell)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    torch.cuda.empty_cache()  # room for the subprocesses' batches
    res: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the CLI streams 600 images in chunks of 128
        out_dir = Path(tmp) / "a"
        out, seconds = _run_experiments(paths[0].parent, out_dir, "--attacks", "fgsm", "pgd",
                                        "--max_batch", str(STREAM_CHUNK))
        want_line = (f"Streaming evaluation: {N_STREAM} images in fixed chunks of "
                     f"{STREAM_CHUNK} (constant memory; decode overlaps the device step)")
        lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
        partial = json.loads((out_dir / "results_partial.json").read_text())
        if want_line not in out or len(lines) != 6 or len(partial) != 6 or any(
                c["count"] != N_STREAM for c in partial.values()):
            raise AssertionError(f"streamed grid: {len(lines)} summary lines, cells "
                                 f"{ {k: c['count'] for k, c in partial.items()} }\n{out[-3000:]}")
        cells = {}
        for cell_id, sec in _cells_s(out_dir).items():
            resident = resident_cell_s.get(cell_id)
            cells[cell_id] = {"seconds": sec, "img_s": N_STREAM / sec,
                              "resident_img_s": SHAPE[0] / resident if resident else None}
        res["cli"] = {"wall_s": seconds, "cells": cells, "summary": lines}
        log(f"[stream] CLI, {N_STREAM} PNGs in chunks of {STREAM_CHUNK}, fgsm + pgd x 3 eps: "
            f"exit 0 in {seconds:.1f} s")
        for cell_id, c in cells.items():
            resident = c["resident_img_s"]
            log(f"[stream]   {cell_id}: {c['seconds']:.3f} s, {c['img_s']:.1f} img/s streamed; "
                f"resident (phase 8, {SHAPE[0]} images) "
                + (f"{resident:.1f} img/s" if resident else "no such cell"))
        for ln in lines:
            log(f"[stream] {ln}")

        # (b) float32 fgsm on 300 images: streamed in 3 chunks against one
        # resident batch
        sub = Path(tmp) / "f32"
        sub.mkdir()
        for p in paths[:N_F32]:
            (sub / p.name).symlink_to(p)
        counters, f32 = {}, {}
        for max_batch in (str(STREAM_CHUNK), "0"):
            o_dir = Path(tmp) / f"f32_{max_batch}"
            _, seconds = _run_experiments(sub, o_dir, "--model-dtype", "float32", "--attacks",
                                          "fgsm", "--eps_list", "0.0313725490",
                                          "--viz_samples", "0", "--max_batch", max_batch)
            (cell,) = json.loads((o_dir / "results_partial.json").read_text()).values()
            counters[max_batch] = {k: cell[k] for k in (*STAT_KEYS, "count")}
            f32[max_batch] = {"wall_s": seconds, "cell_s": _cells_s(o_dir),
                              "counters": counters[max_batch]}
        diff = {k: counters[str(STREAM_CHUNK)][k] - counters["0"][k] for k in counters["0"]}
        res["float32"] = {"runs": f32, "difference": diff}
        log(f"[stream] float32 fgsm on {N_F32} PNGs: streamed {f32[str(STREAM_CHUNK)]['cell_s']} "
            f"s, resident {f32['0']['cell_s']} s; counters streamed "
            f"{counters[str(STREAM_CHUNK)]}, resident {counters['0']}")
        if any(diff.values()):
            log(f"[stream] float32 streamed - resident counters: {diff} (a top-1 tie that "
                "flips between the batch shapes' convolution algorithms)")
        if diff["count"] != 0 or any(abs(v) > 3 for v in diff.values()):
            raise AssertionError(f"float32 streamed and resident counters differ: {diff}")

        # (c) the uint8 placer on one chunk, decoded on one host thread as
        # the pipeline decodes it
        t0 = time.perf_counter()
        x_np, _ = load_image_batch_tolerant(paths[:STREAM_CHUNK])
        res["decode_chunk_s"] = time.perf_counter() - t0
        log(f"[stream] host decode of one chunk of {STREAM_CHUNK} PNGs: "
            f"{res['decode_chunk_s']:.3f} s ({STREAM_CHUNK / res['decode_chunk_s']:.1f} img/s)")
        got = make_placer("cuda", transfer_uint8=True)(x_np).cpu().numpy()
        host = np.round(x_np * 255).astype(np.uint8).astype(np.float32) / np.float32(255)
        if not (np.array_equal(got, host) and np.array_equal(got, x_np)):
            raise AssertionError("the uint8 placer differs from the host's quotient")
        res["uint8_placer"] = {"bit_equal_to_host": True, "equal_to_decoded_chunk": True}
        log(f"[stream] uint8 placer on [{STREAM_CHUNK},224,224,3]: bit-equal to the host's "
            "round(x*255)/float32(255), and to the decoded chunk")

        # in process: streamed cells on 300 images in chunks of 128
        b = state["bundle"]
        lf, ff = make_fns(b)

        def pseudo(xx):
            return torch.argmax(lf(xx), dim=-1)

        place = make_placer("cuda")

        def cell(attack: str) -> dict:
            cfg = DefenseEvalConfig(attack_name=attack, eps=EPS, alpha=ALPHA, steps=STEPS)
            return stream_defense_cell(lf, ff, cfg, paths[:N_F32], state["threshold"], seed=0,
                                       cell_id=f"{attack}:{EPS:.6f}", eps=EPS,
                                       chunk_size=STREAM_CHUNK, place=place,
                                       pseudo_label_fn=pseudo)

        chunks = -(-N_F32 // STREAM_CHUNK)
        ew.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = cell("pgd")
        seconds = time.perf_counter() - t0
        counts = ew.launch_counts()
        want = {"pgd_step": chunks * STEPS, "quantize": chunks, "uniform_noise": chunks}
        if counts != want:
            raise AssertionError(f"streamed pgd cell launches {counts}, want {want}")
        if stats["count"] != N_F32 or any(not 0 <= v <= N_F32 for v in stats.values()):
            raise AssertionError(f"streamed pgd cell counters out of range: {stats}")
        res["pgd_cell"] = {"launches": counts, "stats": stats, "seconds": seconds}
        log(f"[stream] in process, pgd on {N_F32} images in {chunks} chunks: launches {counts}; "
            f"{seconds:.3f} s ({N_F32 / seconds:.1f} img/s); {stats}")
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append(cell("fgsm"))
            runs[-1]["seconds"] = time.perf_counter() - t0
        if {k: v for k, v in runs[0].items() if k != "seconds"} != {
                k: v for k, v in runs[1].items() if k != "seconds"}:
            raise AssertionError(f"the same fgsm cell streamed twice gave {runs}")
        res["fgsm_twice"] = runs
        log(f"[stream] in process, fgsm streamed twice: equal counters, "
            f"{runs[0]['seconds']:.3f} / {runs[1]['seconds']:.3f} s")
    return res


def phase_visualize(state: dict) -> dict:
    """The visualize CLI in a subprocess, then PGD-20 and its trajectory at
    batch 1 in this process, and the metrics on the card against float64."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.eval.metrics import (
        attack_metrics, metrics_to_python)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.trajectory import (
        pgd_trajectory)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    res: dict = {}
    viz_steps = 20
    with tempfile.TemporaryDirectory() as tmp:
        (img,) = _write_pngs(Path(tmp) / "img", 1, seed=3)
        out_dir = Path(tmp) / "viz"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PKG}.cli.visualize", "--image", str(img),
                               "--output_dir", str(out_dir)], cwd=REPO, capture_output=True,
                              text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or "Using device: cuda" not in proc.stdout:
            raise AssertionError(f"visualize CLI exit {proc.returncode}:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        for name in ("attack_comparison.png", "attack_trajectory.png",
                     "perturbation_analysis.png", "attack_report.json"):
            if not (out_dir / name).is_file():
                raise AssertionError(f"the visualize CLI wrote no {name}")
        report = json.loads((out_dir / "attack_report.json").read_text())
        attacks = report["attacks"]
        layout_ok = (set(report) == REPORT_KEYS and set(report["clean_prediction"]) == CLEAN_KEYS
                     and set(report["params"]) == PARAM_KEYS
                     and list(attacks) == ["fgsm", "pgd", "cw"]
                     and all(set(a) == ATTACK_KEYS and list(a["metrics"]) == METRIC_KEYS
                             for a in attacks.values()))
        if not layout_ok:
            raise AssertionError(f"attack_report.json has another layout: {report}")
        eps = report["params"]["eps"]
        for name, a in attacks.items():
            m = a["metrics"]
            if name in ("fgsm", "pgd") and not m["L∞ (pixel)"] <= eps + 1e-6:
                raise AssertionError(f"visualize {name}: L-inf {m['L∞ (pixel)']} > eps {eps}")
            if not (0.0 <= m["SSIM"] <= 1.0 and np.isfinite(m["PSNR"])):
                raise AssertionError(f"visualize {name}: SSIM {m['SSIM']}, PSNR {m['PSNR']}")
        res["cli"] = {"wall_s": seconds, "report": report}
        log(f"[visualize] CLI at its defaults (PGD-{report['params']['steps']}, "
            f"CW-{report['params']['cw_steps']}): exit 0 in {seconds:.1f} s; "
            + "; ".join(f"{n} class {a['predicted_class']} "
                        f"({'success' if a['success'] else 'failed'}), "
                        f"L-inf {a['metrics']['L∞ (pixel)']:.5f}, SSIM {a['metrics']['SSIM']:.4f},"
                        f" PSNR {a['metrics']['PSNR']:.2f}" for n, a in attacks.items()))

        # in process: PGD-20 and its trajectory at batch 1
        lf, _ = make_fns(state["bundle"])
        x = torch.from_numpy(load_image(img)).to("cuda")
    with torch.no_grad():
        y = lf(x).argmax(-1)
    g = generator_from_seed(0)
    ew.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_adv = run_attack("pgd", lf, x, y, AttackParams(eps=EPS, alpha=ALPHA, steps=viz_steps), g)
    traj = pgd_trajectory(lf, x, y, eps=EPS, alpha=ALPHA, steps=viz_steps, generator=g)
    probs, l2 = traj.probs.cpu(), traj.l2.cpu()
    seconds = time.perf_counter() - t0
    counts = ew.launch_counts()
    want = {"pgd_step": 2 * viz_steps, "quantize": 0, "uniform_noise": 2}
    if counts != want:
        raise AssertionError(f"PGD-{viz_steps} + trajectory launches {counts}, want {want}")
    if tuple(probs.shape) != (viz_steps + 1, 2) or tuple(l2.shape) != (viz_steps + 1,) or not (
            bool(torch.isfinite(probs).all()) and bool(torch.isfinite(l2).all())):
        raise AssertionError(f"trajectory {tuple(probs.shape)} {tuple(l2.shape)}")
    linf = _check_ball(x_adv, x, EPS, "visualize pgd")
    _check_ball(traj.x_adv, x, EPS, "trajectory")
    res["in_process"] = {"launches": counts, "seconds": seconds, "linf": linf,
                         "trajectory_rows": int(probs.shape[0]),
                         "l2_first_last": [float(l2[0]), float(l2[-1])]}
    log(f"[visualize] in process, PGD-{viz_steps} + trajectory at batch 1: launches {counts}; "
        f"{seconds:.3f} s; {probs.shape[0]} trajectory rows, L2 {float(l2[0]):.3f} -> "
        f"{float(l2[-1]):.3f}")

    # both kernels against their plain versions at the batch-1 shape
    shape = tuple(x.shape)
    gen = generator_from_seed(7, "cuda")
    xs, x0 = torch.rand(shape, generator=gen, device="cuda"), torch.rand(shape, generator=gen,
                                                                         device="cuda")
    grad = torch.randn(shape, generator=gen, device="cuda")
    grad.view(-1)[::7] = 0.0
    k, p = ew.pgd_step(xs, grad, x0, EPS, ALPHA), ew.pgd_step_plain(xs, grad, x0, EPS, ALPHA)
    noise = ew.uniform_noise(shape, EPS, generator_from_seed(8), "cuda").double()
    eps32 = float(np.float32(EPS))
    noise_ok = (float(noise.min()) >= -eps32 and float(noise.max()) <= eps32
                and abs(float(noise.mean())) < 1e-2 * EPS
                and abs(float(noise.var()) / (EPS ** 2 / 3) - 1) < 2e-2)
    if not torch.equal(k, p) or not noise_ok:
        raise AssertionError(f"batch-1 kernels: pgd_step equal {torch.equal(k, p)}, noise "
                             f"mean {float(noise.mean())} var {float(noise.var())}")
    numel = xs.numel()
    noise_gen = generator_from_seed(9)  # on the host, as the attacks' generators are
    res["batch1_kernels"] = {
        "pgd_step_max_abs_err": float((k - p).abs().max()),
        "noise_mean": float(noise.mean()), "noise_var": float(noise.var()),
        # calls issued one by one, as phase 2 times them (outside the counted run)
        "pgd_step_ms": time_ms(lambda: ew.pgd_step(xs, grad, x0, EPS, ALPHA)),
        "pgd_step_bound_ms": bound_ms("pgd_step", numel),
        "uniform_noise_ms": time_ms(lambda: ew.uniform_noise(shape, EPS, noise_gen, "cuda")),
        "uniform_noise_bound_ms": bound_ms("uniform_noise", numel)}
    b1 = res["batch1_kernels"]
    log(f"[visualize] kernels at {list(shape)}: pgd_step bit-exact, {b1['pgd_step_ms']:.4f} ms "
        f"(bound {b1['pgd_step_bound_ms']:.5f}); noise in range, mean {float(noise.mean()):.2e}, "
        f"var/(eps^2/3) {float(noise.var()) / (EPS ** 2 / 3):.4f}, {b1['uniform_noise_ms']:.4f} "
        f"ms (bound {b1['uniform_noise_bound_ms']:.5f})")

    # the metrics on the card against float64 on the CPU, the same pair
    card = metrics_to_python(attack_metrics(x, x_adv))
    cpu = metrics_to_python(attack_metrics(x.cpu().double(), x_adv.cpu().double()))
    ssim_err = abs(card["SSIM"] - cpu["SSIM"])
    norm_err = max(abs(card[k] - cpu[k]) / abs(cpu[k]) for k in METRIC_KEYS[:3])
    if not (ssim_err <= 1e-5 and norm_err <= 1e-5):
        raise AssertionError(f"metrics on the card vs float64: SSIM {ssim_err}, norms {norm_err}")
    res["metrics"] = {"card": card, "cpu_float64": cpu, "ssim_abs_err": ssim_err,
                      "norm_rel_err": norm_err}
    log(f"[visualize] attack_metrics on the card vs float64 CPU: SSIM {card['SSIM']:.6f} "
        f"(|diff| {ssim_err:.2e}), norms max rel diff {norm_err:.2e}, PSNR {card['PSNR']:.3f} "
        f"vs {cpu['PSNR']:.3f}")
    return res


def phase_weights(state: dict) -> dict:
    """The random ResNet-50 through a Flax msgpack file and back."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.models.convert import (
        to_jax_variables)
    from image_recognition_adversarial_example_attack_tpu_torch.models.flax_msgpack import (
        save_variables)

    x, res = state["x"], {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "resnet50.msgpack"
        ref32 = load_model("resnet50", dtype=torch.float32, device="cuda")
        t0 = time.perf_counter()
        save_variables(to_jax_variables(ref32.model, "resnet"), path)
        res["write_s"], res["bytes"] = time.perf_counter() - t0, path.stat().st_size
        for name, dtype, ref in (("bfloat16", torch.bfloat16, state["bundle"]),
                                 ("float32", torch.float32, ref32)):
            t0 = time.perf_counter()
            loaded = load_model("resnet50", dtype=dtype, weights=path, device="cuda")
            load_s = time.perf_counter() - t0
            if loaded.source != "cache":
                raise AssertionError(f"{path.name} loaded with source {loaded.source}")
            in_dtype = dtype if dtype != torch.float32 else None
            with torch.no_grad():
                want = make_logits_fn(ref.model, ref.mean, ref.std, input_dtype=in_dtype)(x)
                got = make_logits_fn(loaded.model, loaded.mean, loaded.std,
                                     input_dtype=in_dtype)(x)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} logits through the msgpack file differ: "
                                     f"{float((got - want).abs().max())}")
            res[name] = {"load_s": load_s, "bit_equal": True}
            del loaded
        del ref32
    log(f"[weights] resnet50 written as msgpack ({res['bytes'] / 1e6:.1f} MB) in "
        f"{res['write_s']:.2f} s; loaded back with source 'cache' in "
        f"{res['bfloat16']['load_s']:.2f} s (bf16) and {res['float32']['load_s']:.2f} s "
        f"(float32); logits on the batch of {x.shape[0]} bit-equal in both dtypes")
    return res


def _param_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.parameters())


def phase_families(state: dict) -> dict:
    """The four transfer families at full width: float32 card vs CPU, the
    bf16 forward at batch 128, bf16 vs float32 top-1, parameter bytes."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    x, batch = state["x"], state["x"].shape[0]
    x_small = torch.rand((2, 224, 224, 3), generator=generator_from_seed(5))  # phase 3's
    res: dict = {}
    state["bf16"], state["f32"] = {}, {}
    for name in FAMILIES:
        t0 = time.perf_counter()
        cpu = load_model(name, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            ref = make_fns(cpu)[0](x_small)
        cpu_s = time.perf_counter() - t0
        del cpu
        card32 = load_model(name, dtype=torch.float32, device="cuda")
        lf32 = make_fns(card32)[0]
        with torch.no_grad():
            got = lf32(x_small.cuda()).cpu()
            top1_32 = lf32(x).argmax(-1)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = lf32(x_small.cuda()).cpu()
            finally:
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
        scale = float(ref.abs().max())
        f32_err = float((got - ref).abs().max()) / scale
        tf32_err = float((tf32 - ref).abs().max()) / scale
        if not f32_err <= F32_REL_TOL:
            raise AssertionError(f"{name}: float32 logits on the card vs the CPU {f32_err:.3e} "
                                 f"relative > {F32_REL_TOL:.0e}")
        b = load_model(name, dtype=torch.bfloat16, device="cuda")
        lf = make_fns(b)[0]
        with torch.no_grad():
            logits = lf(x)
            ms = time_ms(lambda: lf(x), iters=5, warmup=1)
        if logits.shape != (batch, 1000) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: bf16 logits {tuple(logits.shape)}, not all finite")
        agree = float((logits.argmax(-1) == top1_32).float().mean())
        res[name] = {"f32_card_vs_cpu_rel": f32_err, "tf32_card_vs_cpu_rel": tf32_err,
                     "bf16_forward_ms": ms, "bf16_img_s": batch / ms * 1e3,
                     "bf16_vs_f32_top1_agreement": agree,
                     "param_bytes_f32": _param_bytes(card32.model),
                     "param_bytes_bf16": _param_bytes(b.model), "cpu_load_and_forward_s": cpu_s}
        state["bf16"][name], state["f32"][name] = b, card32
        r = res[name]
        log(f"[families] {name}: float32 card vs CPU {f32_err:.3e} of max |logit| {scale:.3e} "
            f"(limit {F32_REL_TOL:.0e}; TF32 allowed {tf32_err:.3e}); bf16 forward batch "
            f"{batch} {ms:.2f} ms ({r['bf16_img_s']:.1f} img/s); bf16 vs float32 top-1 "
            f"agreement {agree:.3f}; parameters {r['param_bytes_f32'] / 1e6:.1f} MB float32, "
            f"{r['param_bytes_bf16'] / 1e6:.1f} MB bf16")
    # DenseNet's concatenations on channels_last tensors: which kernels they take
    lf = make_fns(state["bf16"]["densenet121"])[0]
    with torch.no_grad():
        prof = profile_breakdown(lambda: lf(x))
    res["densenet121"]["profile"] = prof
    log(f"[families] densenet121 bf16 forward profiled: busy {prof['busy_ms']:.1f} ms, "
        f"{prof['kernels']} kernels; " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in prof["by_layer_ms"].items()))
    for k in prof["top_kernels"][:8]:
        log(f"[families]   {k['ms']:8.2f} ms  x{k['count']:<4d} {k['name'][:200]}")
    return res


def _timed(fn, name: str, acc: dict):
    """``fn`` with its calls' synchronised seconds added to ``acc[name]``."""
    import torch

    def wrapped(x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(x)
        torch.cuda.synchronize()
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
        return out
    return wrapped


def _transfer_cell(name: str, src, targets: dict, x) -> dict:
    """One pgd-20 transfer cell with its launches counted, then the same
    cell timed by model and profiled (outside the count)."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import AttackParams
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.eval.transfer import (
        asr, transfer_attack_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    params = AttackParams(eps=EPS, alpha=ALPHA, steps=TRANSFER_STEPS)
    ew.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cell = transfer_attack_batch(src, targets, x, "pgd", params, generator_from_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ew.launch_counts()
    want = {"pgd_step": TRANSFER_STEPS, "quantize": 0, "uniform_noise": 1}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want}")
    linf = _check_ball(cell.x_adv, x, EPS, name)
    vecs = {"source": cell.source_success, **cell.target_success}
    for k, v in vecs.items():
        if v.shape != (x.shape[0],) or not set(v.unique().tolist()) <= {0, 1}:
            raise AssertionError(f"{name}: {k} success vector {v.shape} {v.unique().tolist()}")
    rates = {k: asr(v) for k, v in vecs.items()}
    # the same cell, each model's calls synchronised and timed (the source's
    # backward passes run outside its calls: they are the remainder)
    acc: dict = {}
    timed = {n: _timed(f, n, acc) for n, f in targets.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    transfer_attack_batch(_timed(src, "source forwards", acc), timed, x, "pgd", params,
                          generator_from_seed(0))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    by_model = {**acc, "source backward and the rest": total - sum(acc.values())}
    prof = profile_breakdown(lambda: transfer_attack_batch(src, targets, x, "pgd", params,
                                                           generator_from_seed(0)))
    log(f"[transfer] {name}: launches {counts}; {seconds:.3f} s for batch {x.shape[0]}; "
        f"|x_adv - x|_inf {linf:.6f}; ASR " + ", ".join(f"{k} {v:.3f}" for k, v in rates.items()))
    log(f"[transfer] {name}: timed by model ({total:.3f} s): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in by_model.items()))
    log(f"[transfer] {name}: profile: wall {prof['wall_ms']:.1f} ms, busy {prof['busy_ms']:.1f} "
        f"ms ({prof['busy_share']:.3f}), {prof['kernels']} kernels; " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in prof["by_layer_ms"].items()))
    return {"launches": counts, "seconds": seconds, "linf": linf, "asr": rates,
            "by_model_s": by_model, "timed_total_s": total, "profile": prof}


def _start_cli_module(module: str, *args: str, env: dict | None = None) -> tuple:
    """``python -m <package>.cli.<module> args`` from the repo, started:
    (the process, its start time, its label)."""
    cmd = [sys.executable, "-m", f"{PKG}.cli.{module}", *args]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=None if env is None else {**os.environ, **env})
    return proc, time.perf_counter(), f"{module} {' '.join(args)}"


def _finish_cli_module(started: tuple) -> tuple[str, float]:
    """Wait for ``_start_cli_module``'s process: its stdout and wall seconds;
    fails unless it exits 0 having run on the card."""
    proc, t0, label = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or "Using device: cuda" not in out:
        raise AssertionError(f"{label} exit {proc.returncode}:\n{out[-3000:]}\n{err[-4000:]}")
    return out, seconds


def _run_cli_module(module: str, *args: str, env: dict | None = None) -> tuple[str, float]:
    return _finish_cli_module(_start_cli_module(module, *args, env=env))


def phase_transfer(state: dict, pngs: list[Path], jpegs: list[Path]) -> dict:
    """Transfer cells in process, the two transfer CLIs and dataset_check in
    subprocesses, and float32 fgsm streamed against resident."""
    import re

    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, make_ensemble_logits_fn)
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image_batch
    from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
        make_placer, stream_transfer_cell)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.transfer import (
        transfer_attack_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    x = state["x"]
    src = make_fns(state["bundle"])[0]
    targets = {n: make_fns(state["bf16"][n])[0] for n in FAMILIES}
    res: dict = {}
    # (a) ResNet-50 -> the four families; (b) the ResNet-50 + DenseNet ensemble
    res["cell"] = _transfer_cell("pgd-20 resnet50 -> 4 families", src, targets, x)
    ensemble = make_ensemble_logits_fn([src, targets["densenet121"]])
    res["ensemble"] = _transfer_cell(
        "pgd-20 resnet50+densenet121 ensemble -> vgg19, vit_b_16, swin_t", ensemble,
        {n: f for n, f in targets.items() if n != "densenet121"}, x)

    with tempfile.TemporaryDirectory() as tmp:
        img128 = _linked(pngs[:SHAPE[0]], Path(tmp) / "png128")
        out_dir = Path(tmp) / "transfer"
        log(f"[transfer] cut (room for phase 24): {TRANSFER_TRIM}")
        started = {
            "blackbox": _start_cli_module("blackbox_transfer", "--image_dir", str(img128)),
            "transferability": _start_cli_module("transferability", "--image_dir", str(img128),
                                                 "--output_dir", str(out_dir)),
            "dataset_check": _start_cli_module("dataset_check", "--test_dir",
                                               str(jpegs[0].parent))}
        # (c) the blackbox CLI at its defaults
        out, seconds = _finish_cli_module(started["blackbox"])
        lines = out.strip().splitlines()[-4:]
        rows_ok = all(re.fullmatch(rf"{a}(\t\d+\.\d%){{3}}", ln)
                      for a, ln in zip(("FGSM", "PGD", "CW"), lines[1:]))
        panels = sorted(p.name for p in (img128 / "blackbox_vis").iterdir())
        if lines[0] != "Attack/Model\tVGG19\tViT\tSwin" or not rows_ok or len(panels) != 9:
            raise AssertionError(f"blackbox_transfer printed {lines}, panels {panels}")
        res["blackbox_cli"] = {"wall_s": seconds, "table": lines, "panels": len(panels)}
        log(f"[transfer] blackbox_transfer CLI at its defaults (fgsm, pgd, cw-200; resnet50 -> "
            f"vgg19, vit_b_16, swin_t) on {SHAPE[0]} PNGs: exit 0 in {seconds:.1f} s; "
            f"{len(panels)} panels; " + " | ".join(ln.replace("\t", " ") for ln in lines))

        # (d) the transferability CLI at its defaults
        out, seconds = _finish_cli_module(started["transferability"])
        data = json.loads((out_dir / "transfer_results.json").read_text())
        cells = data.get("pgd", {})
        want_targets = ["vgg19", "densenet121", "vit_b_16"]
        ok = len(cells) == 3 and all(
            len(c["source_success"]) == SHAPE[0] and list(c["transfer_success"]) == want_targets
            and all(len(v) == SHAPE[0] for v in c["transfer_success"].values())
            for c in cells.values())
        summary = out[out.index("TRANSFERABILITY SUMMARY"):].splitlines()
        rows = [ln for ln in summary if ln.startswith("pgd ")]
        if not ok or len(rows) != 3 or not (out_dir / "transfer_heatmap_pgd.png").is_file():
            raise AssertionError(f"transferability: cells {list(cells)}, rows {rows}\n{out[-2000:]}")
        res["transferability_cli"] = {"wall_s": seconds, "rows": rows}
        log(f"[transfer] transferability CLI at its defaults (pgd-20, 3 eps; resnet50 -> "
            f"vgg19, densenet121, vit_b_16) on {SHAPE[0]} PNGs: exit 0 in {seconds:.1f} s")
        for ln in summary[3:4] + rows:
            log(f"[transfer]   {ln}")

        # (f) dataset_check on 128 JPEGs
        out, seconds = _finish_cli_module(started["dataset_check"])
        if f"Total images: {len(jpegs)}" not in out or "Low-confidence ratio:" not in out:
            raise AssertionError(f"dataset_check printed:\n{out[-2000:]}")
        res["dataset_check"] = {"wall_s": seconds}
        log(f"[transfer] dataset_check CLI on {len(jpegs)} JPEGs: exit 0 in {seconds:.1f} s; "
            + "; ".join(ln for ln in out.splitlines() if ln.startswith(("Total", "Low-conf"))))

    # (e) float32 fgsm on 300 images, streamed in chunks of 128 and resident
    src32 = make_fns(load_model("resnet50", dtype=torch.float32, device="cuda"))[0]
    tg32 = {n: make_fns(state["f32"][n])[0] for n in ("vgg19", "densenet121", "vit_b_16")}
    params = AttackParams(eps=EPS)

    def cell_fn(xx, generator, eps):
        return transfer_attack_batch(src32, tg32, xx, "fgsm", params, generator)

    paths = pngs[:N_F32]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = stream_transfer_cell(cell_fn, paths, seed=0, cell_id="fgsm", eps=EPS,
                                    target_names=list(tg32), chunk_size=STREAM_CHUNK,
                                    place=make_placer("cuda"))
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cell = cell_fn(torch.from_numpy(load_image_batch(paths)).cuda(), None, EPS)
    resident = {"source_success": cell.source_success.tolist(),
                "transfer_success": {n: v.tolist() for n, v in cell.target_success.items()}}
    resident_s = time.perf_counter() - t0
    diffs = {}
    for k, a, b in [("source", streamed["source_success"], resident["source_success"]),
                    *((n, streamed["transfer_success"][n], resident["transfer_success"][n])
                      for n in tg32)]:
        idx = np.nonzero(np.asarray(a) != np.asarray(b))[0].tolist()
        if len(a) != N_F32 or idx:
            diffs[k] = idx
    res["float32_stream"] = {"streamed_s": stream_s, "resident_s": resident_s,
                             "differences": diffs,
                             "asr": {k: float(np.mean(v)) for k, v in
                                     [("source", resident["source_success"]),
                                      *resident["transfer_success"].items()]}}
    log(f"[transfer] float32 fgsm on {N_F32} PNGs, resnet50 -> vgg19, densenet121, vit_b_16: "
        f"streamed in chunks of {STREAM_CHUNK} {stream_s:.2f} s, resident {resident_s:.2f} s "
        f"(decode included in both); ASR {res['float32_stream']['asr']}; differences "
        f"{diffs if diffs else 'none'}")
    if diffs:
        raise AssertionError(f"float32 streamed and resident success vectors differ: {diffs}")
    del state["f32"]
    return res


# the compiler's words where the host has no libjpeg to build the loader with
MISSING_LIBRARY = ("jpeglib.h: No such file", "cannot find -ljpeg")


def _native_unavailable(error: str) -> dict:
    """A host whose compiler finds no libjpeg: the loader cannot be built,
    and the toggle must then raise, never decode with PIL in its place.
    Nothing is measured."""
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import (
        load_image_batch_tolerant)

    first = next(ln for ln in error.splitlines() if any(m in ln for m in MISSING_LIBRARY))
    os.environ["ADV_TPU_NATIVE_LOADER"] = "1"
    try:
        load_image_batch_tolerant([REPO / "README.md"])
    except RuntimeError as e:
        raised = str(e).splitlines()[0]
    else:
        raise AssertionError("ADV_TPU_NATIVE_LOADER=1 without a loader decoded all the same")
    finally:
        del os.environ["ADV_TPU_NATIVE_LOADER"]
    log(f"[native] not measured: this host cannot build the loader ({first.strip()}); with "
        f"ADV_TPU_NATIVE_LOADER=1 the batch loader raises: {raised[:160]}")
    return {"available": False, "compiler": first.strip(), "toggle_raises": raised}


def _decode_rates(fmt: str) -> dict:
    """One chunk of seeded random 256x300 images in ``fmt``, decoded once by
    the native loader (one thread per host core) and once by the batch
    loader with the toggle off (PIL on one thread, as the streaming
    pipeline's decode thread): the host's seconds and img/s of each, and the
    largest difference."""
    import numpy as np
    from PIL import Image

    from image_recognition_adversarial_example_attack_tpu_torch.core.images import (
        load_image_batch_tolerant)
    from image_recognition_adversarial_example_attack_tpu_torch.utils import native_loader

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.RandomState(0)
        paths = [Path(tmp) / f"img_{i:03d}.{'png' if fmt == 'png' else 'jpg'}"
                 for i in range(STREAM_CHUNK)]
        for p in paths:
            Image.fromarray((rng.rand(256, 300, 3) * 255).astype(np.uint8)).save(p)
        t0 = time.perf_counter()
        native, ok = native_loader.load_batch_native_with_status(paths)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pil, _ = load_image_batch_tolerant(paths)
        pil_s = time.perf_counter() - t0
    return {"native_s": native_s, "pil_s": pil_s, "native_img_s": STREAM_CHUNK / native_s,
            "pil_img_s": STREAM_CHUNK / pil_s, "threads": os.cpu_count(),
            "rows_decoded_natively": int(ok.sum()),
            "max_abs_diff": float(np.abs(native - pil).max())}


def phase_native(pngs: list[Path], stream_cells: dict) -> dict:
    """The port's native loader against PIL on a chunk of each format, then
    phase 9(a)'s streamed grid on ``pngs`` under ADV_TPU_NATIVE_LOADER=1."""
    from image_recognition_adversarial_example_attack_tpu_torch.utils import native_loader

    res: dict = {}
    t0 = time.perf_counter()
    try:
        native_loader.load_library()
    except RuntimeError as e:
        if not any(m in str(e) for m in MISSING_LIBRARY):
            raise
        return _native_unavailable(str(e))
    res["build_s"] = time.perf_counter() - t0
    log(f"[native] the port's image loader built and loaded in {res['build_s']:.2f} s "
        f"({os.cpu_count()} host cores)")
    for fmt in ("png", "jpeg"):
        r = res[fmt] = _decode_rates(fmt)
        if r["rows_decoded_natively"] != STREAM_CHUNK or not r["max_abs_diff"] <= 1 / 255 + 1e-6:
            raise AssertionError(f"native {fmt} decode: {r}")
        log(f"[native] {STREAM_CHUNK} {fmt.upper()}s (256x300): native "
            f"{r['native_img_s']:.1f} img/s on {r['threads']} threads, PIL {r['pil_img_s']:.1f} "
            f"img/s on one; max |native - PIL| {r['max_abs_diff'] * 255:.3f}/255")

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp) / "grid"
        out, seconds = _run_experiments(pngs[0].parent, out_dir, "--attacks", "fgsm", "pgd",
                                        "--max_batch", str(STREAM_CHUNK),
                                        env={"ADV_TPU_NATIVE_LOADER": "1"})
        partial = json.loads((out_dir / "results_partial.json").read_text())
        if len(partial) != 6 or any(c["count"] != N_STREAM for c in partial.values()):
            raise AssertionError(f"native streamed grid: {out[-3000:]}")
        cells = {}
        for cell_id, sec in _cells_s(out_dir).items():
            cells[cell_id] = {"seconds": sec, "img_s": N_STREAM / sec,
                              "pil_img_s": stream_cells[cell_id]["img_s"]}
        res["grid"] = {"wall_s": seconds, "cells": cells,
                       "summary": [ln for ln in out.splitlines() if ln.startswith("attack=")]}
    log(f"[native] phase 9(a)'s command with ADV_TPU_NATIVE_LOADER=1: exit 0 in {seconds:.1f} s")
    for cell_id, c in cells.items():
        log(f"[native]   {cell_id}: {c['img_s']:.1f} img/s native, {c['pil_img_s']:.1f} img/s "
            "with PIL (phase 9)")
    return res


# the visualize CLI's report with --gradcam: one more key per attack
GRADCAM_ATTACK_KEYS = ATTACK_KEYS | {"gradcam_iou"}
LANDSCAPE_GRID = 21  # the visualize CLI's default: 441 points in one batch


def _gradcam_iou(cams_a, cams_b, size: int):
    from image_recognition_adversarial_example_attack_tpu_torch.eval.explain import (
        cam_shift_iou, upsample_cam)

    return cam_shift_iou(upsample_cam(cams_a, size, size), upsample_cam(cams_b, size, size))


def phase_visualize_full(state: dict) -> dict:
    """Phase 15: the visualize CLI with --gradcam --landscape; Grad-CAM at
    batch 128 (bf16 against float32); one 441-point landscape in one batch,
    its seconds and peak memory, its centre against the clean CE; the
    Grad-CAM refusal of a model without the conv tap."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.eval.explain import (
        make_gradcam_fn)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.landscape import (
        adversarial_plane, loss_landscape)
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    res: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        (img,) = _write_pngs(Path(tmp) / "img", 1, seed=3)
        out_dir = Path(tmp) / "viz"
        out, seconds = _run_cli_module("visualize", "--image", str(img), "--gradcam",
                                       "--landscape", "--output_dir", str(out_dir))
        for name in ("gradcam_attack.png", "loss_landscape.png", "attack_report.json"):
            if not (out_dir / name).is_file():
                raise AssertionError(f"visualize --gradcam --landscape wrote no {name}")
        report = json.loads((out_dir / "attack_report.json").read_text())
        ious = {n: a.get("gradcam_iou") for n, a in report["attacks"].items()}
        if (list(ious) != ["fgsm", "pgd", "cw"]
                or any(set(a) != GRADCAM_ATTACK_KEYS for a in report["attacks"].values())
                or not all(0.0 <= v <= 1.0 for v in ious.values())):
            raise AssertionError(f"visualize --gradcam report: {report['attacks']}")
    res["cli"] = {"wall_s": seconds, "gradcam_iou": ious}
    log(f"[visualize+] CLI --gradcam --landscape (grid {LANDSCAPE_GRID}, PGD-20, CW-100): exit "
        f"0 in {seconds:.1f} s; gradcam_attack.png, loss_landscape.png; gradcam_iou "
        + ", ".join(f"{n} {v:.3f}" for n, v in ious.items()))

    # Grad-CAM at batch 128: bf16 (the bundle) against float32, same weights
    b16, x, y = state["bundle"], state["x"], state["y"]
    b32 = load_model("resnet50", dtype=torch.float32, device="cuda")
    cams = {}
    for name, b, in_dtype in (("bfloat16", b16, torch.bfloat16), ("float32", b32, None)):
        fn = make_gradcam_fn(b.model, b.mean, b.std, input_dtype=in_dtype)
        cam = fn(x, y)
        if (tuple(cam.shape) != (x.shape[0], 7, 7) or not bool(torch.isfinite(cam).all())
                or float(cam.min()) < 0.0 or float(cam.max()) > 1.0):
            raise AssertionError(f"Grad-CAM {name}: {tuple(cam.shape)}, range "
                                 f"[{float(cam.min())}, {float(cam.max())}]")
        cams[name] = cam
        res[f"gradcam_{name}_ms"] = time_ms(lambda: fn(x, y), iters=5, warmup=1)
    iou = _gradcam_iou(cams["bfloat16"], cams["float32"], x.shape[1])
    diff = float((cams["bfloat16"] - cams["float32"]).abs().max())
    res["gradcam_bf16_vs_f32"] = {"iou_mean": float(iou.mean()), "iou_min": float(iou.min()),
                                  "cam_max_abs_diff": diff}
    log(f"[visualize+] Grad-CAM batch {x.shape[0]}: bf16 {res['gradcam_bfloat16_ms']:.2f} ms, "
        f"float32 {res['gradcam_float32_ms']:.2f} ms; CAMs 7x7 in [0,1]; bf16 vs float32 "
        f"attention IoU mean {float(iou.mean()):.3f} (min {float(iou.min()):.3f}), max |CAM "
        f"diff| {diff:.3f}")

    # one landscape: 441 points in one batched forward, bf16 (the CLI's) and float32
    x0 = x[0]
    x_adv = torch.clamp(x0 + EPS * torch.sign(torch.randn(x0.shape, generator=generator_from_seed(
        4), device="cpu").to(x0.device)), 0.0, 1.0)
    plane = adversarial_plane(x0, x_adv, generator_from_seed(5))
    for name, b in (("bfloat16", b16), ("float32", b32)):
        lf = make_fns(b)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        grid = loss_landscape(lf, x0, int(y[0]), plane, grid=LANDSCAPE_GRID)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss_landscape(lf, x0, int(y[0]), plane, grid=LANDSCAPE_GRID)
        torch.cuda.synchronize()
        again = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        if tuple(grid.shape) != (LANDSCAPE_GRID, LANDSCAPE_GRID) or not bool(
                torch.isfinite(grid).all()):
            raise AssertionError(f"landscape {name}: {tuple(grid.shape)}")
        with torch.no_grad():
            clean = float(-torch.log_softmax(lf(x0[None]), -1)[0, int(y[0])])
        centre = float(grid[LANDSCAPE_GRID // 2, LANDSCAPE_GRID // 2])
        rel = abs(centre - clean) / abs(clean)
        res[f"landscape_{name}"] = {"seconds_first": seconds, "seconds": again,
                                    "peak_gib_above_resident": peak, "centre": centre,
                                    "clean_ce": clean, "centre_rel_err": rel,
                                    "min": float(grid.min()), "max": float(grid.max())}
        log(f"[visualize+] landscape {name}: {LANDSCAPE_GRID ** 2} points in one batch, "
            f"{seconds:.3f} s first, {again:.3f} s again; peak {peak:.2f} GiB above the "
            f"resident; loss {float(grid.min()):.4f}..{float(grid.max()):.4f}; centre "
            f"{centre:.6f} vs the clean CE at batch 1 {clean:.6f} (rel {rel:.2e})")
        # float32 (TF32 off): the batch of 441 and the batch of 1 agree to
        # float32 rounding; bf16 rounds in other places at other batch shapes
        if name == "float32" and not rel <= 1e-5:
            raise AssertionError(f"landscape centre {centre} vs clean CE {clean}: {rel:.2e}")
    del b32

    try:
        vgg = state["bf16"]["vgg19"]
        make_gradcam_fn(vgg.model, vgg.mean, vgg.std, input_dtype=torch.bfloat16)
    except ValueError as exc:
        res["vgg19_refusal"] = str(exc)
        log(f"[visualize+] make_gradcam_fn(vgg19) raises ValueError: {exc}")
    else:
        raise AssertionError("make_gradcam_fn accepted VGG19, which has no conv tap split")
    return res


# quantized-op calls per forward, one per layer the JAX family hooks
INT8_HOOKS = {"resnet50": (53, 1), "vgg19": (16, 3), "densenet121": (120, 1),
              "vit_b_16": (1, 49), "swin_t": (1, 52), "tiny": (2, 1)}


def _int8_twin(bundle):
    """The bundle's model rebuilt with int8=True, the same weights and dtype."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

    model = zoo.build_model(bundle.name, int8=True)
    model.load_state_dict(bundle.model.state_dict(), strict=True)
    model.requires_grad_(False).eval()
    zoo.set_compute_dtype(model, bundle.dtype)
    return model.to(device=bundle.device, memory_format=torch.channels_last)


def phase_int8(state: dict, classify_ms: float, family_ms: dict) -> dict:
    """Phase 16: the int8 ops on the card against the exact plain route;
    the six families in int8 (bf16 and float32); PGD-10 on the int8
    ResNet-50; the classify CLI with --int8."""
    import torch
    import torch.nn.functional as F

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, make_logits_fn, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.ops import int8

    res: dict = {"ops": {}, "families": {}}
    g = generator_from_seed(11)
    # (a) per op: the _int_mm route on the card against the plain int64
    # route on the CPU (bit-equal), the gradient against the float op's
    ops = {  # name -> (input NCHW or [M,K], weight, stride, padding)
        "stem 7x7/2, K=147": ((4, 3, 224, 224), (64, 3, 7, 7), 2, 3),
        "layer1 3x3, K=576": ((4, 64, 56, 56), (64, 64, 3, 3), 1, 1),
        "layer1 1x1, K=256": ((4, 256, 56, 56), (64, 256, 1, 1), 1, 0),
        "layer3 downsample 1x1/2, K=512": ((4, 512, 28, 28), (1024, 512, 1, 1), 2, 0),
        "fc M=1": ((1, 2048), (1000, 2048), None, None),
        "fc M=128": ((128, 2048), (1000, 2048), None, None),
    }
    for name, (xs, ws, stride, pad) in ops.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(xs, generator=g).to(dtype)
            w = (torch.randn(ws, generator=g) * ws[1] ** -0.5).to(dtype)
            conv = stride is not None

            def op(a, b):
                return int8.int8_conv2d(a, b, stride, pad) if conv else int8.int8_linear(a, b)

            def float_op(a, b):
                return F.conv2d(a, b, stride=stride, padding=pad) if conv else F.linear(a, b)

            want = op(x, w)  # the CPU: the plain int64 route
            xc = x.to("cuda")
            if conv:
                xc = xc.contiguous(memory_format=torch.channels_last)
            xc.requires_grad_(True)
            wc = w.to("cuda")
            got = op(xc, wc)
            equal = torch.equal(got.detach().cpu(), want)
            gout = torch.randn(got.shape, generator=g).to(dtype).to("cuda")
            (gx,) = torch.autograd.grad(got, xc, gout)
            (fx,) = torch.autograd.grad(float_op(xc, wc), xc, gout)
            # the same float op's backward: equal but for the algorithm cuDNN
            # or cuBLAS picks, within float32 rounding (bf16: one ulp)
            grad_err = float((gx.float() - fx.float()).abs().max()) / float(fx.float().abs().max())
            with torch.no_grad():
                ms = time_ms(lambda: op(xc, wc), iters=10, warmup=2)
                float_ms = time_ms(lambda: float_op(xc, wc), iters=10, warmup=2)
            key = f"{name} {str(dtype)[6:]}"
            res["ops"][key] = {"bit_equal": equal, "grad_rel_diff": grad_err, "ms": ms,
                               "float_op_ms": float_ms}
            log(f"[int8] {key}: card vs plain route bit-equal {equal}; input gradient vs the "
                f"float op's max |diff| {grad_err:.2e} of its largest; {ms:.3f} ms (float op "
                f"{float_ms:.3f} ms)")
            if not equal or grad_err > (1e-6 if dtype == torch.float32 else 8e-3):
                raise AssertionError(f"int8 op {key}: bit-equal {equal}, grad diff {grad_err}")

    # (b) per family, bf16 and float32 at batch 128
    x, batch = state["x"], state["x"].shape[0]
    fams = {"resnet50": state["bundle"], **{n: state["bf16"][n] for n in FAMILIES}}
    for name in ("resnet50", *FAMILIES, "tiny"):
        for dtype in (torch.bfloat16, torch.float32):
            base = fams.get(name) if dtype == torch.bfloat16 else None
            base = base or load_model(name, dtype=dtype, device="cuda")
            in_dtype = None if dtype == torch.float32 else dtype
            lf = make_logits_fn(base.model, base.mean, base.std, input_dtype=in_dtype)
            lf8 = make_logits_fn(_int8_twin(base), base.mean, base.std, input_dtype=in_dtype)
            with torch.no_grad():
                ref = lf(x)
                int8.reset_calls()
                out = lf8(x)
                calls = int8.call_counts()
                ms = time_ms(lambda: lf8(x), iters=3, warmup=1)
                float_ms = time_ms(lambda: lf(x), iters=3, warmup=1)
            agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
            want = dict(zip(("conv", "linear"), INT8_HOOKS[name]))
            if calls != want or not bool(torch.isfinite(out).all()) or out.shape != ref.shape:
                raise AssertionError(f"int8 {name} {dtype}: calls {calls} (want {want}), "
                                     f"{tuple(out.shape)}")
            phase_ms = classify_ms if name == "resnet50" else family_ms.get(name)
            key = f"{name} {str(dtype)[6:]}"
            res["families"][key] = {"int8_forward_ms": ms, "float_forward_ms": float_ms,
                                    "bf16_forward_ms_phases_3_12": phase_ms,
                                    "top1_agreement": agree, "calls": calls}
            log(f"[int8] {key} batch {batch}: int8 forward {ms:.2f} ms, the float model "
                f"{float_ms:.2f} ms (phases 3/12 bf16: "
                f"{'-' if phase_ms is None else f'{phase_ms:.2f}'} ms); top-1 agreement "
                f"with the float model {agree:.3f}; quantized calls {calls}")
            if base is not fams.get(name):
                del base
            torch.cuda.empty_cache()

    # (c) PGD-10 on the int8 ResNet-50 (bf16), through load_model(int8=True)
    b8 = load_model("resnet50", dtype=torch.bfloat16, device="cuda", int8=True)
    lf8 = make_logits_fn(b8.model, b8.mean, b8.std, input_dtype=torch.bfloat16)
    y = state["y"]
    params = AttackParams(eps=EPS, alpha=ALPHA, steps=STEPS)
    ew.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_adv = run_attack("pgd", lf8, x, y, params, generator_from_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ew.launch_counts()
    want = {"pgd_step": STEPS, "quantize": 0, "uniform_noise": 1}
    if counts != want:
        raise AssertionError(f"int8 PGD-10 launches {counts}, want {want}")
    linf = _check_ball(x_adv, x, EPS, "int8 pgd")
    t0 = time.perf_counter()
    run_attack("pgd", lf8, x, y, params, generator_from_seed(1))
    torch.cuda.synchronize()
    again = time.perf_counter() - t0
    res["pgd"] = {"launches": counts, "seconds_first": seconds, "seconds": again,
                  "ex_per_s": batch / again, "linf": linf}
    log(f"[int8] PGD-10 on the int8 resnet50 (bf16) batch {batch}: launches {counts}; "
        f"{seconds:.3f} s first, {again:.3f} s again ({batch / again:.1f} ex/s); |x_adv - x|_inf "
        f"{linf:.6f}")
    del b8

    # (d) the classify CLI with --int8
    with tempfile.TemporaryDirectory() as tmp:
        (img,) = _write_pngs(Path(tmp) / "img", 1, seed=9)
        proc, cli_s = _run_cli(img, Path(tmp) / "adv.png", "--attack", "pgd", "--int8")
    res["classify_cli_s"] = cli_s
    log(f"[int8] classify --int8 --attack pgd: exit 0 in {cli_s:.1f} s; "
        + " | ".join(proc.stdout.strip().splitlines()[:2]))
    return res


TRANSFER_ATTACKS = ("mifgsm", "dim", "tim")


def _in_process_cli(main, argv: list[str]) -> tuple[str, float, dict]:
    """A CLI's ``main(argv)`` in this process: its stdout, seconds and the
    kernel launches of the run (reset before, read after)."""
    import contextlib
    import io

    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    buf = io.StringIO()
    ew.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    if code != 0 or "Using device: cuda" not in out:
        raise AssertionError(f"{main.__module__} {' '.join(argv)} exit {code}:\n{out[-3000:]}")
    return out, seconds, ew.launch_counts()


def phase_transfer_attacks(state: dict, pngs: list[Path]) -> dict:
    """Phase 17: mifgsm, dim and tim at batch 128 on ResNet-50 with exact
    launch counts, DIM at p=0 against MI-FGSM, a pgd-20-shaped transfer
    cell with mifgsm, then the transferability and grid CLIs with the three
    attacks on phase 8's 128 PNGs."""
    import re

    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, mifgsm_attack, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.dim import dim_attack
    from image_recognition_adversarial_example_attack_tpu_torch.cli import (
        defense_experiments, transferability)
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.eval.transfer import (
        transfer_attack_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    x, y, batch = state["x"], state["y"], state["x"].shape[0]
    lf = make_fns(state["bundle"])[0]
    params = AttackParams(eps=EPS, alpha=ALPHA, steps=STEPS)
    res: dict = {"attacks": {}}
    want = {"pgd_step": STEPS, "quantize": 0, "uniform_noise": 0}
    for name in TRANSFER_ATTACKS:
        ew.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_adv = run_attack(name, lf, x, y, params, generator_from_seed(0))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ew.launch_counts()
        if counts != want:
            raise AssertionError(f"{name}-10 launches {counts}, want {want}")
        linf = _check_ball(x_adv, x, EPS, name)
        with torch.no_grad():
            success = float((lf(x_adv).argmax(-1) != y).float().mean())
        res["attacks"][name] = {"launches": counts, "seconds": seconds,
                                "ex_per_s": batch / seconds, "linf": linf, "success": success}
        log(f"[transfer attacks] {name}-10 resnet50 bf16 batch {batch}: launches {counts}; "
            f"{seconds:.3f} s ({batch / seconds:.1f} ex/s); |x_adv - x|_inf {linf:.6f}; "
            f"attack success {success:.3f}")
    mi = mifgsm_attack(lf, x, y, eps=EPS, alpha=ALPHA, steps=STEPS)
    mi2 = mifgsm_attack(lf, x, y, eps=EPS, alpha=ALPHA, steps=STEPS)
    di0 = dim_attack(lf, x, y, eps=EPS, alpha=ALPHA, steps=STEPS,
                     generator=generator_from_seed(0), diversity_prob=0.0)
    res["dim_p0_equals_mifgsm"] = bool(torch.equal(di0, mi))
    res["mifgsm_repeat_equal"] = bool(torch.equal(mi2, mi))
    log(f"[transfer attacks] dim at diversity_prob 0 bit-equal to mifgsm: "
        f"{res['dim_p0_equals_mifgsm']} (mifgsm run twice bit-equal: "
        f"{res['mifgsm_repeat_equal']})")
    if not res["dim_p0_equals_mifgsm"]:
        raise AssertionError("dim at diversity_prob 0 differs from mifgsm: max |diff| "
                             f"{float((di0 - mi).abs().max())}")

    # a pgd-20-shaped transfer cell with mifgsm: resnet50 -> the four families
    targets = {n: make_fns(state["bf16"][n])[0] for n in FAMILIES}
    cell_params = AttackParams(eps=EPS, alpha=ALPHA, steps=TRANSFER_STEPS)
    ew.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cell = transfer_attack_batch(lf, targets, x, "mifgsm", cell_params, generator_from_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ew.launch_counts()
    if counts != {"pgd_step": TRANSFER_STEPS, "quantize": 0, "uniform_noise": 0}:
        raise AssertionError(f"mifgsm-20 transfer cell launches {counts}")
    linf = _check_ball(cell.x_adv, x, EPS, "mifgsm transfer cell")
    rates = {k: float(v.float().mean()) for k, v in
             {"source": cell.source_success, **cell.target_success}.items()}
    res["cell"] = {"launches": counts, "seconds": seconds, "linf": linf, "asr": rates}
    log(f"[transfer attacks] mifgsm-{TRANSFER_STEPS} transfer cell resnet50 -> 4 families: "
        f"launches {counts}; {seconds:.3f} s; ASR " + ", ".join(
            f"{k} {v:.3f}" for k, v in rates.items()))

    with tempfile.TemporaryDirectory() as tmp:
        img128 = _linked(pngs[:SHAPE[0]], Path(tmp) / "png128")
        n_eps = 3
        out_dir = Path(tmp) / "tr"
        out, seconds, counts = _in_process_cli(transferability.main, [
            "--image_dir", str(img128), "--attacks", *TRANSFER_ATTACKS,
            "--output_dir", str(out_dir)])
        data = json.loads((out_dir / "transfer_results.json").read_text())
        summary = out[out.index("TRANSFERABILITY SUMMARY"):].splitlines()
        rows = [ln for ln in summary if ln.split(" ")[0] in TRANSFER_ATTACKS]
        want_tr = {"pgd_step": len(TRANSFER_ATTACKS) * n_eps * TRANSFER_STEPS, "quantize": 0,
                   "uniform_noise": 0}
        if (sorted(data) != sorted(TRANSFER_ATTACKS) or any(len(v) != n_eps for v in data.values())
                or len(rows) != len(TRANSFER_ATTACKS) * n_eps or counts != want_tr):
            raise AssertionError(f"transferability --attacks mifgsm dim tim: {sorted(data)}, "
                                 f"rows {rows}, launches {counts} (want {want_tr})")
        res["transferability_cli"] = {"seconds": seconds, "launches": counts, "rows": rows}
        log(f"[transfer attacks] transferability CLI --attacks mifgsm dim tim (20 steps, "
            f"{n_eps} eps; resnet50 -> vgg19, densenet121, vit_b_16) on {SHAPE[0]} PNGs: "
            f"{seconds:.1f} s in process; launches {counts} "
            f"({TRANSFER_STEPS} pgd_step in each of {len(rows)} cells)")
        for ln in rows:
            log(f"[transfer attacks]   {ln}")

        out_dir = Path(tmp) / "grid"
        out, seconds, counts = _in_process_cli(defense_experiments.main, [
            "--image_dir", str(img128), "--attacks", *TRANSFER_ATTACKS, "--viz_samples", "0",
            "--output_dir", str(out_dir)])
        summary = re.compile(
            r"^attack=(mifgsm|dim|tim), eps=(\d\.\d{5}), attack_success=\d\.\d{3}, "
            r"preproc_defense_acc=\d\.\d{3}, detector_clean_pass_rate=\d\.\d{3}, "
            r"detector_adv_flag_rate=\d\.\d{3}, detector_attack_success=\d\.\d{3}$")
        lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
        cells = len(TRANSFER_ATTACKS) * n_eps
        want_grid = {"pgd_step": cells * STEPS, "quantize": cells, "uniform_noise": 0}
        if len(lines) != cells or not all(summary.match(ln) for ln in lines) \
                or counts != want_grid:
            raise AssertionError(f"grid --attacks mifgsm dim tim: lines {lines}, launches "
                                 f"{counts} (want {want_grid})")
        cell_s = _cells_s(out_dir)
        res["grid_cli"] = {"seconds": seconds, "launches": counts, "lines": lines,
                           "cell_s": cell_s}
        log(f"[transfer attacks] grid CLI --attacks mifgsm dim tim (10 steps, {n_eps} eps) on "
            f"{SHAPE[0]} PNGs: {seconds:.1f} s in process; launches {counts} ({STEPS} pgd_step "
            f"and 1 quantize per cell); cells " + ", ".join(
                f"{k} {v:.2f} s" for k, v in cell_s.items()))
        for ln in lines:
            log(f"[transfer attacks]   {ln}")
    return res


# phase 18: the white-box zoo.  name -> (eps, alpha, expected noise launches);
# pgd_l2 and pgd_l1 take budgets of their own norms (ImageNet's L2 eps 3;
# SLIDE's L1 eps 12 at 224x224), alpha 2.5 * eps / steps
ZOO_A = {"apgd": (EPS, ALPHA, 1), "apgd_dlr": (EPS, ALPHA, 1), "apgd_t": (EPS, ALPHA, 9),
         "fab": (EPS, ALPHA, 9), "pgd_l2": (3.0, 0.75, 0), "pgd_l1": (12.0, 3.0, 1),
         "spatial": (EPS, ALPHA, 0)}
ZOO_B = ("deepfool", "ead", "jsma", "stadv")
ZOO_B_BATCH, SUITE_N, SUITE_CHUNK = 32, 32, 16
RESTARTS = 5
SUITE_ATTACKS = ("fgsm", "apgd", "apgd_dlr", "apgd_t", "fab", "deepfool", "ead", "jsma",
                 "stadv", "spatial", "pgd_l2", "pgd_l1")
SUITE_KEYS = {"count", "eps", "model", "labels", "ece_clean", "results"}
SUITE_STREAM_KEYS = SUITE_KEYS | {"requested", "streamed", "max_batch"}
SUITE_ROW_KEYS = {"attack", "asr", "linf", "l2_mean", "changed_pct", "ssim", "psnr", "ece",
                  "compile_run_s", "steady_s"}
# the suite's budgets, cut (printed) to keep phase 18 near two minutes: the
# twelve attacks in bf16, with cuDNN's deterministic algorithms (the CLI as
# shipped, a subprocess) and without (in process); the six attacks whose
# float32 reruns no other run checks, smaller still
SUITE_CUT = ("--steps", "5", "--n_target_classes", "3", "--deepfool_steps", "5",
             "--cw_steps", "10", "--jsma_steps", "10", "--stadv_steps", "20")
SUITE_F32_REST = ("fab", "deepfool", "ead", "jsma", "stadv", "spatial")
SUITE_F32_CUT = ("--steps", "2", "--n_target_classes", "2", "--deepfool_steps", "3",
                 "--cw_steps", "5", "--jsma_steps", "5", "--stadv_steps", "10")
GRID_ATTACKS, GRID_EPS = ("apgd", "fab", "deepfool", "pgd_l1"), ("0.0157", "0.0314")
GRID_STEPS, GRID_DEEPFOOL_STEPS = 5, 10  # the grid's cut budgets (phase 18(e))


def _check_threat(name: str, threat: str, x_adv, x, eps: float, jsma_steps: int) -> float:
    """``x_adv`` finite, in [0,1] and inside its threat model: the L∞, L2
    or L1 ball (the largest per-sample norm is returned), at most one
    changed pixel a jsma step (it moves one feature a step), or nothing
    more for 'none'."""
    import torch

    if not bool(torch.isfinite(x_adv).all()):
        raise AssertionError(f"{name}: non-finite output")
    if not (float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0):
        raise AssertionError(f"{name}: x_adv leaves [0,1]")
    d = (x_adv - x).reshape(x.shape[0], -1).double()
    size = {"linf": d.abs().amax(dim=1), "l2": d.norm(dim=1), "l1": d.abs().sum(dim=1),
            "l0": (d.reshape(x.shape[0], -1, 3) != 0).any(-1).sum(-1).double(),
            "none": d.abs().amax(dim=1)}[threat]
    bound = {"linf": eps + 1e-6, "l2": eps * (1 + 1e-5), "l1": eps * (1 + 1e-5),
             "l0": jsma_steps, "none": 1.0}[threat]
    if not float(size.max()) <= bound:
        raise AssertionError(f"{name}: {threat} size {float(size.max())} > {bound}")
    return float(size.max())


def _zoo_run(name: str, fn, x, y, lf, want: dict, threat: str, eps: float,
             jsma_steps: int = 100, tag: str = "zoo") -> tuple[dict, object]:
    """One counted run of an attack (launches reset before, read after,
    host clock ending in a synchronisation), its threat model, then the
    same call again from a fresh generator of the same seed: bit-equal."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    ew.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_adv = fn(generator_from_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ew.launch_counts()
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want}")
    size = _check_threat(name, threat, x_adv, x, eps, jsma_steps)
    with torch.no_grad():
        flipped = float((lf(x_adv).argmax(-1) != y).float().mean())
    again = fn(generator_from_seed(0))
    if not torch.equal(again, x_adv):
        raise AssertionError(f"{name}: two runs from the same generator differ, max |diff| "
                             f"{float((again - x_adv).abs().max()):.3e}")
    batch = x.shape[0]
    rec = {"launches": counts, "seconds": seconds, "ex_per_s": batch / seconds,
           "threat": threat, "size": size, "flipped": flipped, "rerun_bit_equal": True}
    log(f"[{tag}] {name} batch {batch}: {seconds:.3f} s ({batch / seconds:.1f} ex/s); launches "
        f"{counts}; {threat} size {size:.6g}; flipped {flipped:.3f}; rerun bit-equal")
    return rec, x_adv


def _suite_rows(out: str, names) -> dict[str, list[str]]:
    """The suite table's rows by attack, after checking its header."""
    from image_recognition_adversarial_example_attack_tpu_torch.cli.attack_suite import HEADER

    lines = out.splitlines()
    if HEADER not in lines:
        raise AssertionError(f"attack_suite printed no header:\n{out[-2000:]}")
    head = lines.index(HEADER)
    rows = {ln.split()[0]: ln for ln in lines[head + 2:head + 2 + len(names)]}
    if list(rows) != list(names) or any(len(r.split()) != 10 for r in rows.values()):
        raise AssertionError(f"attack_suite rows {list(rows.values())}")
    return rows


def _f32_grad_reruns(state: dict, x, y) -> dict:
    """The float32 ResNet-50's input gradient at ``x``, three calls each with
    ``torch.backends.cudnn.deterministic`` off and on: whether the reruns
    are bit-equal (required with it on) and their largest difference."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        input_grad, make_logits_fn)
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    b = load_model("resnet50", dtype=torch.float32, device="cuda")
    lf = make_logits_fn(b.model, b.mean, b.std)
    out = {}
    prev = torch.backends.cudnn.deterministic
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            g = [input_grad(lf, x, y) for _ in range(3)]
            diff = max(float((g[0] - gi).abs().max()) for gi in g[1:])
            out[f"deterministic_{det}"] = {"equal": diff == 0.0, "max_diff": diff}
            log(f"[zoo] float32 input gradient at batch {x.shape[0]}, three calls, "
                f"cudnn.deterministic={det}: largest difference {diff:.3e}")
    finally:
        torch.backends.cudnn.deterministic = prev
    if not out["deterministic_True"]["equal"]:
        raise AssertionError("float32 input gradients differ under cudnn.deterministic")
    return out


def phase_white_box_zoo(state: dict, pngs: list[Path]) -> dict:
    """Phase 18: the white-box attacks at batch 128 and 32 with their
    threat models, launches and bit-equal reruns, then the attack_suite CLI
    (with and without deterministic cuDNN; float32) and the grid CLI with
    four of them."""
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns

    x, y = state["x"], state["y"]
    lf = make_fns(state["bundle"])[0]
    res: dict = {"a": {}, "b": {}}
    zero = {"pgd_step": 0, "quantize": 0, "uniform_noise": 0}
    # (d)'s subprocess starts first and runs beside (a)-(c) (phase 25's trim)
    with tempfile.TemporaryDirectory() as tmp:
        img32 = _linked(pngs[:SUITE_N], Path(tmp) / "png32")
        out_json = Path(tmp) / "suite.json"
        suite = _start_cli_module("attack_suite", "--image_dir", str(img32), "--attacks",
                                  *SUITE_ATTACKS, *SUITE_CUT, "--output", str(out_json))
        try:
            _zoo_rest(state, pngs, res, lf, zero, x, y, tmp, img32, out_json, suite)
        finally:
            suite[0].kill()
            suite[0].wait()
    return res


def _zoo_rest(state: dict, pngs: list[Path], res: dict, lf, zero: dict, x, y, tmp: str,
              img32: Path, out_json: Path, suite: tuple) -> None:
    """Phase 18 beside its attack_suite subprocess ``suite``: (a)-(e)."""
    import contextlib
    import re
    from unittest import mock

    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        ATTACK_THREAT, AttackParams, pgd_multi_restart, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.cli import (
        attack_suite, defense_experiments)

    # (a) batch 128
    for name, (eps, alpha, noise) in ZOO_A.items():
        params = AttackParams(eps=eps, alpha=alpha, steps=STEPS, n_target_classes=9)
        res["a"][name], _ = _zoo_run(
            name, lambda g, n=name, p=params: run_attack(n, lf, x, y, p, g), x, y, lf,
            {**zero, "uniform_noise": noise}, ATTACK_THREAT[name], eps)
    grid = AttackParams(spatial_candidates=0, spatial_grid_rot=5, spatial_grid_trans=3)
    res["a"]["spatial_grid"], _ = _zoo_run(
        "spatial grid 5x3x3", lambda g: run_attack("spatial", lf, x, y, grid, g), x, y, lf,
        zero, "none", EPS)
    res["a"]["pgd_multi_restart"], _ = _zoo_run(
        f"pgd_multi_restart R={RESTARTS} PGD-{STEPS}",
        lambda g: pgd_multi_restart(lf, x, y, eps=EPS, alpha=ALPHA, steps=STEPS, generator=g,
                                    restarts=RESTARTS),
        x, y, lf, {"pgd_step": RESTARTS * STEPS, "quantize": 0, "uniform_noise": RESTARTS},
        "linf", EPS)

    # (b) batch 32: the expensive ones
    xb, yb = x[:ZOO_B_BATCH].contiguous(), y[:ZOO_B_BATCH]
    params = AttackParams()  # deepfool 50 x 10 classes, ead 100, jsma 100, stadv 200
    for name in ZOO_B:
        res["b"][name], _ = _zoo_run(
            name, lambda g, n=name: run_attack(n, lf, xb, yb, params, g), xb, yb, lf, zero,
            ATTACK_THREAT[name], EPS, jsma_steps=params.jsma_steps)

    # why the suite CLI asks cuDNN for deterministic algorithms: a float32
    # input gradient computed three times, with and without
    res["f32_grad_reruns"] = _f32_grad_reruns(state, xb, yb)

    # (d) the suite CLI: bf16 in a subprocess, then without deterministic
    # cuDNN and in float32 in process
    log(f"[zoo] cut: the suite CLI runs {' '.join(SUITE_CUT)} (defaults {STEPS}, 9, 50, "
        f"100, 100, 200); trim: it started with the phase")
    out, seconds = _finish_cli_module(suite)
    rows = _suite_rows(out, SUITE_ATTACKS)
    data = json.loads(out_json.read_text())
    if (set(data) != SUITE_KEYS or data["count"] != SUITE_N
            or any(set(r) != SUITE_ROW_KEYS for r in data["results"])):
        raise AssertionError(f"attack_suite JSON keys {sorted(data)}")
    res["suite_cli"] = {"seconds": seconds, "rows": list(rows.values()),
                        "results": data["results"]}
    log(f"[zoo] attack_suite CLI (subprocess), {SUITE_N} PNGs, 12 attacks, "
        f"cudnn.deterministic: exit 0 in {seconds:.1f} s")
    for ln in rows.values():
        log(f"[zoo]   {ln}")

    # the same command twice in process, as shipped and with cuDNN's
    # default algorithms: the setting's cost row by row (steady_s, each
    # attack's second call), both runs in one process state
    if torch.backends.cudnn.deterministic:
        raise AssertionError("cudnn.deterministic left on before the suite's comparison")
    inproc = {}
    for mode, ctx in (("deterministic", attack_suite._deterministic_cudnn),
                      ("default", contextlib.nullcontext)):
        path = Path(tmp) / f"suite_{mode}.json"
        with mock.patch.object(attack_suite, "_deterministic_cudnn", ctx):
            out, seconds, counts = _in_process_cli(attack_suite.main, [
                "--image_dir", str(img32), "--attacks", *SUITE_ATTACKS, *SUITE_CUT,
                "--output", str(path)])
        # two calls each of apgd, apgd_dlr and pgd_l1 (1 start) and of
        # apgd_t and fab (3 targets)
        want = {**zero, "uniform_noise": 2 * (3 + 2 * 3)}
        if counts != want:
            raise AssertionError(f"attack_suite in process, cuDNN {mode}: launches {counts} "
                                 f"(want {want})")
        inproc[mode] = {"seconds": seconds, "launches": counts,
                        "rows": list(_suite_rows(out, SUITE_ATTACKS).values()),
                        "results": json.loads(path.read_text())["results"]}
    steady = {r["attack"]: (r["steady_s"], d["steady_s"], n["steady_s"]) for r, d, n in zip(
        data["results"], inproc["deterministic"]["results"], inproc["default"]["results"])}
    res["suite_inproc"] = inproc
    res["suite_steady_s"] = steady
    log(f"[zoo] attack_suite CLI in process: {inproc['deterministic']['seconds']:.1f} s "
        f"with cudnn.deterministic, {inproc['default']['seconds']:.1f} s without (reruns "
        f"bit-equal); steady s subprocess / in process with / without: " + ", ".join(
            f"{k} {a:.3f}/{d:.3f}/{n:.3f}" for k, (a, d, n) in steady.items())
        + "; sums " + "/".join(f"{sum(v[i] for v in steady.values()):.3f}" for i in range(3)))

    three = ("fgsm", "apgd", "pgd_l1")
    f32 = {}
    for mode, extra, want_noise in (("one batch", [], 4),
                                    ("streamed", ["--max_batch", str(SUITE_CHUNK)], 4)):
        path = Path(tmp) / f"suite_{mode[0]}.json"
        out, seconds, counts = _in_process_cli(attack_suite.main, [
            "--image_dir", str(img32), "--attacks", *three, "--model-dtype", "float32",
            "--output", str(path), *extra])
        data = json.loads(path.read_text())
        want_keys = SUITE_STREAM_KEYS if extra else SUITE_KEYS
        # apgd's and pgd_l1's starts: two calls one batch, two chunks streamed
        want = {**zero, "uniform_noise": want_noise}
        if set(data) != want_keys or counts != want:
            raise AssertionError(f"attack_suite {mode}: keys {sorted(data)}, launches "
                                 f"{counts} (want {want})")
        f32[mode] = {"seconds": seconds, "launches": counts,
                     "rows": list(_suite_rows(out, three).values()),
                     "results": data["results"]}
        log(f"[zoo] attack_suite CLI float32 {mode} (fgsm apgd pgd_l1, {SUITE_N} PNGs"
            + (f", chunks of {SUITE_CHUNK}" if extra else "") + f"): {seconds:.1f} s in "
            f"process; launches {counts}")
        for ln in f32[mode]["rows"]:
            log(f"[zoo]   {ln}")
    asr = {m: f32[m]["results"][0]["asr"] for m in f32}
    # float32 reruns of the six attacks no run above checks there: the
    # CLI raises unless each attack's two calls are bit-equal
    log(f"[zoo] cut: float32 {' '.join(SUITE_F32_REST)} run {' '.join(SUITE_F32_CUT)}")
    path = Path(tmp) / "suite_f32_rest.json"
    out, seconds, counts = _in_process_cli(attack_suite.main, [
        "--image_dir", str(img32), "--attacks", *SUITE_F32_REST, *SUITE_F32_CUT,
        "--model-dtype", "float32", "--output", str(path)])
    want = {**zero, "uniform_noise": 2 * 2}  # fab's 2 targets, two calls
    if counts != want:
        raise AssertionError(f"attack_suite float32 {' '.join(SUITE_F32_REST)}: launches "
                             f"{counts} (want {want})")
    f32["rest"] = {"seconds": seconds, "launches": counts,
                   "rows": list(_suite_rows(out, SUITE_F32_REST).values()),
                   "results": json.loads(path.read_text())["results"]}
    log(f"[zoo] attack_suite CLI float32 {' '.join(SUITE_F32_REST)}: {seconds:.1f} s in "
        f"process, every rerun bit-equal; launches {counts}")
    for ln in f32["rest"]["rows"]:
        log(f"[zoo]   {ln}")
    if asr["one batch"] != asr["streamed"]:
        raise AssertionError(f"float32 fgsm ASR streamed {asr['streamed']} != one batch "
                             f"{asr['one batch']}")
    res["suite_f32"] = f32
    log(f"[zoo] float32 fgsm ASR streamed = one batch: {asr['streamed']:.6f}")

    # (e) the grid CLI with four of them, its budgets cut (printed) to
    # keep the phase near two minutes; (a) and (b) ran the defaults
    img128 = _linked(pngs[:SHAPE[0]], Path(tmp) / "png128")
    out_dir = Path(tmp) / "grid"
    log(f"[zoo] cut: the grid CLI runs --steps {GRID_STEPS} (default {STEPS}) and "
        f"--deepfool_steps {GRID_DEEPFOOL_STEPS} (default 50)")
    out, seconds, counts = _in_process_cli(defense_experiments.main, [
        "--image_dir", str(img128), "--attacks", *GRID_ATTACKS, "--eps_list", *GRID_EPS,
        "--steps", str(GRID_STEPS), "--deepfool_steps", str(GRID_DEEPFOOL_STEPS),
        "--viz_samples", "0", "--output_dir", str(out_dir)])
    summary = re.compile(
        r"^attack=(apgd|fab|deepfool|pgd_l1), eps=(\d\.\d{5}), attack_success=\d\.\d{3}, "
        r"preproc_defense_acc=\d\.\d{3}, detector_clean_pass_rate=\d\.\d{3}, "
        r"detector_adv_flag_rate=\d\.\d{3}, detector_attack_success=\d\.\d{3}$")
    lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
    computed = 3 * len(GRID_EPS) + 1  # deepfool: one cell for both eps
    want = {"pgd_step": 0, "quantize": computed,
            "uniform_noise": len(GRID_EPS) * (1 + 9 + 1)}
    reused = out.count("(deepfool is eps-independent: reusing the computed cell)")
    if (len(lines) != len(GRID_ATTACKS) * len(GRID_EPS)
            or not all(summary.match(ln) for ln in lines) or counts != want or reused != 1):
        raise AssertionError(f"grid --attacks {' '.join(GRID_ATTACKS)}: lines {lines}, "
                             f"launches {counts} (want {want}), deepfool reused {reused}")
    cell_s = _cells_s(out_dir)
    res["grid_cli"] = {"seconds": seconds, "launches": counts, "lines": lines,
                       "cell_s": cell_s}
    log(f"[zoo] grid CLI --attacks {' '.join(GRID_ATTACKS)} --eps_list "
        f"{' '.join(GRID_EPS)} --steps {GRID_STEPS} --deepfool_steps {GRID_DEEPFOOL_STEPS} "
        f"on {SHAPE[0]} PNGs: {seconds:.1f} s in process; launches "
        f"{counts} (1 quantize a computed cell); cells " + ", ".join(
            f"{k} {v:.2f} s" for k, v in cell_s.items()))
    for ln in lines:
        log(f"[zoo]   {ln}")

# phase 19: the black-box group.  (a) at batch 128: name -> (AttackParams
# fields, eps, pgd_step launches, queries a sample); (b) at batch 32, the
# decision-based and gradient-estimating ones
BB_A = {
    "square": ({"square_steps": 250}, EPS, 0, 252),
    "square_l2": ({"square_steps": 250, "eps": 3.0}, 3.0, 0, 252),
    "simba": ({"simba_steps": 150}, EPS, 0, 301),
    "simba_pixel": ({"simba_steps": 150, "simba_mode": "pixel"}, EPS, 0, 301),
    "bandits": ({"bandits_steps": 50}, EPS, 50, 100),
}
BB_B = {
    "nes": ({"steps": 10, "est_samples": 32}, 10, 640),
    "spsa": ({"steps": 10, "est_samples": 32}, 10, 640),
    "hsja": ({}, 0, 12 + 10 * (10 + 32 + 10 + 1)),  # its defaults: 10 steps, 32 probes
    "boundary": ({"boundary_steps": 100}, 0, 12 + 2 * 100),
}
BB_B_BATCH, RE_N, RE_STREAM_N, RE_CHUNK, QC_N, QC_CHUNK = 32, 32, 64, 32, 32, 16
RE_EPS = ("0.0157", "0.0314")
# robust_eval's budgets, cut (printed) to keep the phase near two minutes;
# AutoAttack's defaults are 100 / 5000 / 100 / 9 (30 deepfool steps, 20 EOT
# draws)
RE_CUT = ("--apgd_steps", "10", "--square_steps", "100", "--fab_steps", "10",
          "--n_target_classes", "3", "--deepfool_steps", "10", "--eot_samples", "4")
RE_ARMS = {"lite": ("apgd", "square", "deepfool"),
           "standard": ("apgd_ce", "apgd_t", "fab", "square"),
           "rand": ("apgd_ce_eot", "apgd_dlr_eot", "square")}
RE_KEYS = {"protocol", "norm", "eot_samples", "eot_sigma", "apgd_steps", "square_steps",
           "deepfool_steps", "fab_steps", "n_target_classes", "results"}
RE_LINE = r"^eps=\d\.\d{5}: robust_acc=\d\.\d{3} \((\w+ \d+/\d+ ?)+\)  \[\d+\.\ds\]$"
# the curves' query budget, cut from 500 to 250 to keep the script well
# inside its time limit once phase 20 was added, and to 125 for phase 23
QC_QUERIES = 125
# phase 19's budgets, halved to make room for phase 23 (printed): (a)'s
# square, square_l2, simba and bandits steps, boundary's, robust_eval's
# --square_steps and the curves' queries; every check and rerun stays
BB_TRIM = ("square 500 -> 250, square_l2 500 -> 250, simba and simba_pixel 300 -> 150, "
           "bandits 100 -> 50, boundary 200 -> 100, robust_eval --square_steps 200 -> 100, "
           "query_curves --max_queries 250 -> 125")
# the cuda tests of the black-box group (tests/test_torch_cuda.py), run by
# phase 19 in a subprocess; tests/conftest.py configures jax, so it is left out
BB_CUDA_TESTS = ("test_black_box_attacks_on_the_card or test_black_box_draws_are_made_on_the_card"
                 " or test_eot_mix_on_the_card or test_robust_eval_protocols_on_the_card"
                 " or test_query_curve_on_the_card")
BB_CUDA_TEST_COUNT = 14
BB_GRID_CUT = ("--square_steps", "50", "--simba_steps", "50", "--hsja_steps", "2")
BB_SUITE_CUT = ("--square_steps", "100", "--simba_steps", "100", "--hsja_steps", "2")


def _eot_read_cost(lf, x) -> dict:
    """The EOT wrapper's one host read a call (the input's mix seeds its
    generator): ten wrapped calls, then the same ten with the generator
    fixed and no read, one synchronisation at the end of each series; and
    the read alone on an idle queue."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import eot
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

    n, calls = 4, 10
    wrapped = eot.make_eot_logits_fn(lf, generator_from_seed(0), n_samples=n)
    transform = eot.gaussian_noise_transform(0.25)
    g = eot.call_generator(1, 0, x.device)

    def unread(x01):
        stacked = torch.cat([transform(g, x01) for _ in range(n)], dim=0)
        probs = torch.softmax(lf(stacked), dim=-1).reshape(n, x01.shape[0], -1).mean(dim=0)
        return torch.log(torch.clamp_min(probs, 1e-12))

    out = {}
    with torch.no_grad():
        for name, fn in (("wrapped", wrapped), ("no_read", unread)):
            fn(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(calls):
                fn(x + i * 1e-3)
            torch.cuda.synchronize()
            out[f"{name}_ms"] = (time.perf_counter() - t0) / calls * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            int(eot.input_mix(x))
        out["read_idle_ms"] = (time.perf_counter() - t0) / calls * 1e3
    out["read_cost_ms"] = out["wrapped_ms"] - out["no_read_ms"]
    log(f"[black-box] EOT wrapper at batch {x.shape[0]} x {n} draws: {out['wrapped_ms']:.2f} ms a "
        f"call with its host read, {out['no_read_ms']:.2f} ms with a fixed generator and no "
        f"read ({out['read_cost_ms']:+.2f} ms); the mix and its read alone on an idle queue "
        f"{out['read_idle_ms']:.3f} ms")
    return out


def _start_robust_eval_clis(img32: Path, tmp: Path) -> dict:
    """The robust_eval CLI in three subprocesses started together, one per
    protocol, at two eps: protocol -> (the process, its start time)."""
    procs = {}
    for protocol in RE_ARMS:
        cmd = [sys.executable, "-m", f"{PKG}.cli.robust_eval", "--image_dir", str(img32),
               "--protocol", protocol, "--eps_list", *RE_EPS, *RE_CUT,
               "--output", str(tmp / f"re_{protocol}.json"),
               "--plot", str(tmp / f"re_{protocol}.png")]
        procs[protocol] = (subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           time.perf_counter())
    return procs


def _finish_robust_eval_clis(procs: dict, tmp: Path) -> dict:
    """Wait for ``_start_robust_eval_clis``'s processes: the console lines,
    the JSON and the figure of each protocol."""
    import re

    from PIL import Image

    res = {}
    for protocol, (proc, t0) in procs.items():
        out, err = proc.communicate(timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or "Using device: cuda" not in out:
            raise AssertionError(f"robust_eval --protocol {protocol} exit {proc.returncode}:\n"
                                 f"{out[-3000:]}\n{err[-4000:]}")
        lines = [ln for ln in out.splitlines() if ln.startswith("eps=")]
        data = json.loads((tmp / f"re_{protocol}.json").read_text())
        row_keys = {"eps", "robust_accuracy", "count",
                    *(f"success_{a}" for a in RE_ARMS[protocol])}
        if (len(lines) != len(RE_EPS) or not all(re.match(RE_LINE, ln) for ln in lines)
                or set(data) != RE_KEYS or data["protocol"] != protocol
                or any(set(r) != row_keys or r["count"] != RE_N for r in data["results"])):
            raise AssertionError(f"robust_eval --protocol {protocol}: lines {lines}, JSON {data}")
        with Image.open(tmp / f"re_{protocol}.png") as im:
            size = im.size
        res[protocol] = {"seconds": seconds, "lines": lines, "results": data["results"],
                         "plot_size": size}
        log(f"[black-box] robust_eval --protocol {protocol} (subprocess, {RE_N} PNGs, eps "
            f"{' '.join(RE_EPS)}): exit 0 in {seconds:.1f} s, the three started with the phase; "
            f"--plot {size[0]}x{size[1]}")
        for ln in lines:
            log(f"[black-box]   {ln}")
    return res


def _robust_stream_vs_resident(lf, pngs: list[Path], dev) -> dict:
    """stream_robust_cell over 64 PNGs in chunks of 32 (the standard
    protocol, cut budgets) against one resident run a chunk under that
    chunk's generator: equal vectors; the noise launches of the streamed
    run exactly those of the APGD-CE, APGD-T and FAB-T starts."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import predict_labels
    from image_recognition_adversarial_example_attack_tpu_torch.cli import attack_suite, robust_eval
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image_batch
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
    from image_recognition_adversarial_example_attack_tpu_torch.eval.streaming import (
        make_placer, stream_robust_cell)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    args = robust_eval.build_parser().parse_args(["--protocol", "standard", *RE_CUT])
    _, _, run = robust_eval._protocol(args, lf, False)
    paths, cell_id, eps = pngs[:RE_STREAM_N], "standard:0.031373", EPS
    targets = int(args.n_target_classes)
    with attack_suite._deterministic_cudnn():
        ew.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = stream_robust_cell(run, paths, seed=0, cell_id=cell_id, eps=eps,
                                 chunk_size=RE_CHUNK, place=make_placer(dev),
                                 pseudo_label_fn=lambda xx: predict_labels(lf, xx))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ew.launch_counts()
        chunks = RE_STREAM_N // RE_CHUNK
        want = {"pgd_step": 0, "quantize": 0, "uniform_noise": chunks * (1 + 2 * targets)}
        if counts != want:
            raise AssertionError(f"stream_robust_cell standard: launches {counts}, want {want}")
        for step in range(chunks):
            x = torch.from_numpy(load_image_batch(paths[step * RE_CHUNK:(step + 1) * RE_CHUNK])
                                 ).to(dev)
            outs = run(x, predict_labels(lf, x), chunk_generator(0, cell_id, step), eps)
            for i, v in enumerate(outs):
                part = got[f"arm{i}"][step * RE_CHUNK:(step + 1) * RE_CHUNK]
                if not np.array_equal(part, v.cpu().numpy()):
                    raise AssertionError(f"stream_robust_cell arm{i} chunk {step} differs from "
                                         "the resident run")
    rec = {"seconds": seconds, "launches": counts,
           "success": int(got["arm0"].sum()), "arms": {
               a: int(got[f"arm{i + 1}"].sum()) for i, a in enumerate(RE_ARMS["standard"])}}
    log(f"[black-box] stream_robust_cell standard, {RE_STREAM_N} PNGs in chunks of {RE_CHUNK}: "
        f"{seconds:.1f} s; launches {counts} (1 + 2 x {targets} noise a chunk); every arm's "
        f"vector equal to the resident runs'; success {rec['success']}/{RE_STREAM_N}, arms "
        f"{rec['arms']}")
    return rec


def _query_curves(lf, img32: Path, pngs: list[Path], tmp: Path, dev) -> dict:
    """The query_curves CLI in this process with the six curve attacks,
    one batch then streamed in chunks of 16; the streamed curves against
    the ones assembled from resident runs of each chunk."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import predict_labels
    from image_recognition_adversarial_example_attack_tpu_torch.cli import query_curves
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image_batch
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
    from image_recognition_adversarial_example_attack_tpu_torch.eval import query_curves as qc
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    steps = {a: qc.budget_to_steps(a, QC_QUERIES) for a in qc.CURVE_ATTACKS}
    per_run = steps["nes"] + steps["spsa"] + steps["bandits"]  # one pgd_step a step
    res = {}
    for mode, extra, runs in (("one batch", [], 1), ("streamed", ["--max_batch", str(QC_CHUNK)],
                                                       QC_N // QC_CHUNK)):
        path = tmp / f"qc_{mode[0]}.json"
        out, seconds, counts = _in_process_cli(query_curves.main, [
            "--image_dir", str(img32), "--attacks", *qc.CURVE_ATTACKS, "--max_queries",
            str(QC_QUERIES), "--output", str(path), *extra])
        want = {"pgd_step": runs * per_run, "quantize": 0, "uniform_noise": 0}
        data = json.loads(path.read_text())
        header = query_curves.table_header([100, 500, 1000, 2000])
        keys = {"count", "eps", "max_queries", "labels", "curves"} | (
            {"streamed", "max_batch"} if extra else set())
        if counts != want or header not in out or set(data) != keys or data["count"] != QC_N:
            raise AssertionError(f"query_curves {mode}: launches {counts} (want {want}), "
                                 f"keys {sorted(data)}:\n{out[-2000:]}")
        rows = out.splitlines()[out.splitlines().index(header) + 2:][:len(qc.CURVE_ATTACKS)]
        res[mode] = {"seconds": seconds, "launches": counts, "rows": rows,
                     "curves": data["curves"]}
        log(f"[black-box] query_curves CLI {mode} (six attacks, {QC_N} PNGs, "
            f"{QC_QUERIES} queries, cut from 500): {seconds:.1f} s in process; launches {counts}")
        for ln in rows:
            log(f"[black-box]   {ln}")

    # the streamed curves from resident runs of each chunk, same generators
    paths = pngs[:QC_N]
    ew.reset_launches()
    for curve in res["streamed"]["curves"]:
        name = curve["attack"]
        fn, per_step, init_q = qc._runner(name, lf, eps=EPS, steps=steps[name], est_samples=32,
                                          nes_sigma=1e-3, spsa_delta=1e-2, alpha=ALPHA,
                                          simba_eps=0.2, simba_mode="dct")
        ever, firsts = np.zeros(steps[name], np.int64), []
        for step in range(QC_N // QC_CHUNK):
            x = torch.from_numpy(load_image_batch(paths[step * QC_CHUNK:(step + 1) * QC_CHUNK])
                                 ).to(dev)
            _, hist = fn(x, predict_labels(lf, x), chunk_generator(0, name, step))
            count, first = qc.history_stats(hist.cpu().numpy())
            ever += count
            firsts.append(first)
        want = qc.assemble_curve(name, ever, QC_N, np.concatenate(firsts), per_step=per_step,
                                 init_q=init_q, steps=steps[name])
        if want != curve:
            raise AssertionError(f"query_curves streamed {name}: the curve differs from the "
                                 "per-chunk resident runs'")
    torch.cuda.synchronize()
    res["resident_chunks"] = {"launches": ew.launch_counts()}
    log(f"[black-box] query_curves streamed = per-chunk resident runs for all six; launches of "
        f"the resident runs {res['resident_chunks']['launches']}")
    return res


def _start_cuda_tests(expr: str) -> tuple:
    """The cuda tests of ``tests/test_torch_cuda.py`` that ``expr`` selects,
    started in a subprocess: (the process, its start time)."""
    cmd = [sys.executable, "-m", "pytest", "tests/test_torch_cuda.py", "-m", "cuda",
           "--noconftest", "-q", "-p", "no:cacheprovider", "-k", expr]
    return (subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True), time.perf_counter())


def _finish_cuda_tests(tag: str, started: tuple, count: int) -> dict:
    """Wait for ``_start_cuda_tests``'s process: all ``count`` tests pass."""
    import re

    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    seconds = time.perf_counter() - t0
    tail = out.strip().splitlines()[-1] if out.strip() else ""
    passed = re.search(r"(\d+) passed", tail)
    if (proc.returncode != 0 or passed is None or int(passed[1]) != count
            or re.search(r"failed|skipped|error", tail)):
        raise AssertionError(f"the {tag} cuda tests: exit {proc.returncode}, {tail}\n"
                             f"{out[-3000:]}\n{err[-2000:]}")
    log(f"[{tag}] cuda tests (subprocess): {tail} in {seconds:.1f} s")
    return {"seconds": seconds, "summary": tail}


def phase_black_box(state: dict, pngs: list[Path]) -> dict:
    """Phase 19: the black-box attacks at batch 128 and 32 with their
    threat models, queries/s, pgd_step launches and bit-equal reruns; the
    EOT wrapper's host read; the robust_eval CLI (three protocols, a
    subprocess each; streamed against resident in process); the
    query_curves CLI one batch and streamed; the grid and attack_suite
    CLIs with square, simba and hsja.  The group's cuda tests and (c)'s
    robust_eval subprocesses start with the phase and run beside (a)-(b)
    (phase 25's trim)."""
    log("[black-box] trim (room for phase 25): the group's cuda tests and robust_eval's three "
        "subprocesses start with the phase, beside (a) and (b) (the tests ran after the "
        "phase, the three subprocesses after (b), before this trim)")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        img32 = _linked(pngs[:RE_N], tmp / "png32")
        tests = _start_cuda_tests(BB_CUDA_TESTS)
        robust = _start_robust_eval_clis(img32, tmp)
        try:
            res = _black_box_body(state, pngs, tmp, img32, robust)
        except BaseException:
            for proc in [tests[0], *(p for p, _ in robust.values())]:
                proc.kill()
                proc.wait()
            raise
    res["cuda_tests"] = _finish_cuda_tests("black-box", tests, BB_CUDA_TEST_COUNT)
    return res


def _black_box_body(state: dict, pngs: list[Path], tmp: Path, img32: Path,
                    robust_procs: dict) -> dict:
    import re

    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        ATTACK_THREAT, AttackParams, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.cli import (
        attack_suite, defense_experiments)
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns

    x, y, dev = state["x"], state["y"], state["x"].device
    lf = make_fns(state["bundle"])[0]
    res: dict = {"a": {}, "b": {}}
    zero = {"pgd_step": 0, "quantize": 0, "uniform_noise": 0}

    def run_one(group, name, fields, eps, pgd, queries, xx, yy):
        attack = name.split("_pixel")[0]
        params = AttackParams(**{"eps": eps, **fields})
        rec, _ = _zoo_run(name, lambda g: run_attack(attack, lf, xx, yy, params, g), xx, yy, lf,
                          {**zero, "pgd_step": pgd}, ATTACK_THREAT[attack], eps,
                          tag="black-box")
        rec["queries_per_sample"] = queries
        rec["queries_per_s"] = xx.shape[0] * queries / rec["seconds"]
        log(f"[black-box]   {name}: {queries} queries a sample, "
            f"{rec['queries_per_s']:.0f} queries/s")
        res[group][name] = rec

    log(f"[black-box] cut (room for phase 23): {BB_TRIM}")
    # (a) batch 128
    for name, (fields, eps, pgd, queries) in BB_A.items():
        run_one("a", name, fields, eps, pgd, queries, x, y)
    # (b) batch 32
    xb, yb = x[:BB_B_BATCH].contiguous(), y[:BB_B_BATCH]
    for name, (fields, pgd, queries) in BB_B.items():
        run_one("b", name, fields, EPS, pgd, queries, xb, yb)
    res["eot"] = _eot_read_cost(lf, xb)

    # (c) the robust_eval CLI (started with the phase), then streamed
    # against resident in process
    log(f"[black-box] cut: robust_eval runs {' '.join(RE_CUT)} (defaults 100, 1000, 100, 9, "
        "30, 20)")
    res["robust_eval_cli"] = _finish_robust_eval_clis(robust_procs, tmp)
    res["robust_stream"] = _robust_stream_vs_resident(lf, pngs, dev)
    # (d) the query_curves CLI
    res["query_curves"] = _query_curves(lf, img32, pngs, tmp, dev)

    # (e) the grid and suite CLIs with three of them, budgets cut
    img128 = _linked(pngs[:SHAPE[0]], tmp / "png128")
    log(f"[black-box] cut: the grid runs {' '.join(BB_GRID_CUT)}, the suite "
        f"{' '.join(BB_SUITE_CUT)} (defaults 1000, 1000, 10)")
    out, seconds, counts = _in_process_cli(defense_experiments.main, [
        "--image_dir", str(img128), "--attacks", "square", "simba", "hsja",
        "--eps_list", *GRID_EPS, *BB_GRID_CUT, "--viz_samples", "0",
        "--output_dir", str(tmp / "grid")])
    summary = re.compile(
        r"^attack=(square|simba|hsja), eps=(\d\.\d{5}), attack_success=\d\.\d{3}, "
        r"preproc_defense_acc=\d\.\d{3}, detector_clean_pass_rate=\d\.\d{3}, "
        r"detector_adv_flag_rate=\d\.\d{3}, detector_attack_success=\d\.\d{3}$")
    lines = [ln for ln in out.splitlines() if ln.startswith("attack=")]
    computed = 2 * len(GRID_EPS) + 1  # simba: one cell for both eps
    want = {**zero, "quantize": computed}
    reused = out.count("(simba is eps-independent: reusing the computed cell)")
    if (len(lines) != 3 * len(GRID_EPS) or not all(summary.match(ln) for ln in lines)
            or counts != want or reused != 1):
        raise AssertionError(f"grid --attacks square simba hsja: lines {lines}, launches "
                             f"{counts} (want {want}), simba reused {reused}")
    res["grid_cli"] = {"seconds": seconds, "launches": counts, "lines": lines,
                       "cell_s": _cells_s(tmp / "grid")}
    log(f"[black-box] grid CLI --attacks square simba hsja on {SHAPE[0]} PNGs: "
        f"{seconds:.1f} s in process; launches {counts} (simba's cell computed once); "
        "cells " + ", ".join(f"{k} {v:.2f} s" for k, v in res["grid_cli"]["cell_s"].items()))
    for ln in lines:
        log(f"[black-box]   {ln}")
    three = ("square", "simba", "hsja")
    out, seconds, counts = _in_process_cli(attack_suite.main, [
        "--image_dir", str(img32), "--attacks", *three, *BB_SUITE_CUT,
        "--output", str(tmp / "suite.json")])
    if counts != zero:
        raise AssertionError(f"attack_suite square simba hsja: launches {counts}")
    rows = list(_suite_rows(out, three).values())
    res["suite_cli"] = {"seconds": seconds, "launches": counts, "rows": rows,
                        "results": json.loads((tmp / "suite.json").read_text())["results"]}
    log(f"[black-box] attack_suite CLI square simba hsja ({RE_N} PNGs): {seconds:.1f} s in "
        f"process, every rerun bit-equal; launches {counts}")
    for ln in rows:
        log(f"[black-box]   {ln}")
    return res


# phase 20: (a) UAP, (b) patch, (c) EOT-PGD, (d) smoothing, (e) IBP nets
UAP_N, UAP_BATCH, UAP_EPOCHS, UAP_EPS = 128, 32, 4, 10 / 255
PATCH_N, PATCH_SIZE, PATCH_STEPS, PATCH_TARGET = 32, 50, 50, 859
EOT_BATCH, CERT_N, SIGMAS = 32, 32, (0.12, 0.25, 0.5)
# The card's float32 CROWN margins against the CPU's float64, relative to the
# margins' scale: a sound float32 reading is ~1e-7, TF32 convolutions and
# products move them by ~5e-5 of it (so a limit of 1e-4 would not tell them
# apart); the limit lies between
IBP_BATCH, IBP_EPS, IBP_REL_TOL = 128, (2 / 255, 8 / 255), 1e-6
# PGD-20 can only catch a bound that is too tight where the bound is close to
# the margin's true minimum.  On the random nets that takes balls so small
# that no IBP-propagated box straddles a ReLU (up to ~1e-11 here); a float32
# pixel cannot move by that much, so this check runs the same bound code in
# float64.  Soundness allows 64 float64 ulps of the logit scale for the
# rounding of two forwards; "tight" is a gap of at most 1e-3 of the drop the
# bound allows, on at least half the images
IBP_TIGHT_EPS, IBP_TIGHT_GAP, IBP_TIGHT_SHARE = (1e-12, 1e-11), 1e-3, 0.5
CERT_GRID_EPS = ("0.000000001", "0.00784", "0.03137")
CERT_GRID_CHUNK = 48


def _counted(fn):
    """``fn()`` with the launches reset before and read after, its seconds
    on the host clock ending in a synchronisation."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    ew.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, ew.launch_counts()


def _uap_and_patch(lf, x, y) -> dict:
    """Phase 20 (a) and (b)."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import patch, uap
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed

    zero = {"pgd_step": 0, "quantize": 0, "uniform_noise": 0}
    res = {}
    xa, ya = x[:UAP_N], y[:UAP_N]
    out, seconds, counts = _counted(lambda: uap.uap_attack(
        lf, xa, ya, eps=UAP_EPS, epochs=UAP_EPOCHS, batch_size=UAP_BATCH,
        generator=generator_from_seed(0)))
    linf = float(out.delta.abs().max())
    rate = float(uap.uap_fooling_rate(lf, xa, out.delta))
    if (linf > UAP_EPS + 1e-6 or not 0.0 <= rate <= 1.0 or counts != zero
            or out.delta.shape != x.shape[1:] or not torch.isfinite(out.loss_per_epoch).all()):
        raise AssertionError(f"uap: |delta| {linf}, fooling rate {rate}, launches {counts}")
    res["uap"] = {"seconds": seconds, "s_per_epoch": seconds / UAP_EPOCHS, "linf": linf,
                  "fooling_rate": rate, "loss_per_epoch": out.loss_per_epoch.tolist(),
                  "launches": counts}
    log(f"[certified] uap_attack ResNet-50 bf16, {UAP_N} images in batches of {UAP_BATCH}, "
        f"{UAP_EPOCHS} epochs, eps 10/255: {seconds:.2f} s ({seconds / UAP_EPOCHS:.3f} s an "
        f"epoch); |delta|inf {linf:.6f}; fooling rate {rate:.3f}; launches {counts}")

    xb, yb = x[:PATCH_N].contiguous(), y[:PATCH_N]
    out, seconds, counts = _counted(lambda: patch.patch_attack(
        lf, xb, yb, patch_size=PATCH_SIZE, steps=PATCH_STEPS, generator=generator_from_seed(0),
        y_target=PATCH_TARGET))
    p = out.patch
    rows = torch.arange(PATCH_N, device=x.device) * 5 % (224 - PATCH_SIZE + 1)
    cols = torch.arange(PATCH_N, device=x.device) * 7 % (224 - PATCH_SIZE + 1)
    rots = torch.arange(PATCH_N, device=x.device) % 4
    pasted = patch.apply_patch(xb, p, rows=rows, cols=cols, rots=rots)
    for i in range(PATCH_N):
        r, c, k = int(rows[i]), int(cols[i]), int(rots[i])
        if not torch.equal(pasted[i, r:r + PATCH_SIZE, c:c + PATCH_SIZE],
                           torch.rot90(p, k, dims=(0, 1))):
            raise AssertionError(f"patch: image {i}'s pasted pixels are not the rotated patch")
    rate = float(patch.patch_success_rate(lf, xb, p, generator=generator_from_seed(1),
                                          y_target=PATCH_TARGET))
    if float(p.min()) < 0.0 or float(p.max()) > 1.0 or counts != zero:
        raise AssertionError(f"patch: range [{float(p.min())}, {float(p.max())}], "
                             f"launches {counts}")
    res["patch"] = {"seconds": seconds, "s_per_step": seconds / PATCH_STEPS,
                    "targeted_success_rate": rate, "launches": counts,
                    "loss_first_last": [float(out.loss_per_step[0]), float(out.loss_per_step[-1])]}
    log(f"[certified] patch_attack ResNet-50 bf16, {PATCH_N} images, {PATCH_SIZE}-px patch, "
        f"{PATCH_STEPS} steps, target {PATCH_TARGET}: {seconds:.2f} s "
        f"({seconds / PATCH_STEPS * 1e3:.1f} ms a step); patch in [0,1]; pasted pixels equal "
        f"the rotated patch in all {PATCH_N}; targeted success {rate:.3f}; loss "
        f"{res['patch']['loss_first_last'][0]:.4f} -> {res['patch']['loss_first_last'][1]:.4f}")
    return res


def _eot_pgd(lf, x, y) -> dict:
    """Phase 20 (c)."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        make_eot_logits_fn, pgd_linf_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        randomization, tv)

    xb, yb = x[:EOT_BATCH].contiguous(), y[:EOT_BATCH]
    res = {}
    want = {"pgd_step": STEPS, "quantize": 0, "uniform_noise": 1}
    for name, transform in (("resize_pad", randomization.resize_pad_transform()),
                            ("tv", tv.tv_transform())):
        for n in (1, 8):
            fn = make_eot_logits_fn(lf, generator_from_seed(0), n_samples=n, transform=transform)
            x_adv, seconds, counts = _counted(lambda: pgd_linf_attack(
                fn, xb, yb, eps=EPS, alpha=ALPHA, steps=STEPS, generator=generator_from_seed(0)))
            size = _check_ball(x_adv, xb, EPS, f"EOT-PGD {name} n={n}")
            if counts != want:
                raise AssertionError(f"EOT-PGD {name} n={n}: launches {counts}, want {want}")
            res[f"{name}_n{n}"] = {"seconds": seconds, "ex_per_s": EOT_BATCH / seconds,
                                   "launches": counts, "linf": size}
            log(f"[certified] PGD-10 on EOT({name}, n_samples {n}) at batch {EOT_BATCH}: "
                f"{seconds:.2f} s ({EOT_BATCH / seconds:.1f} ex/s, {n * EOT_BATCH}-image "
                f"forwards); launches {counts}")
    g = torch.Generator().manual_seed(3)
    x2 = torch.rand((2, 224, 224, 3), generator=g)
    s = torch.tensor([0.72, 0.91])
    oy, ox = torch.tensor([10.37, 3.5]), torch.tensor([0.25, 17.81])
    cpu = randomization.resize_pad(x2, s, oy, ox)
    card = randomization.resize_pad(x2.cuda(), s.cuda(), oy.cuda(), ox.cuda()).cpu()
    err = float((card - cpu).abs().max())
    if err > 1e-5:
        raise AssertionError(f"resize_pad card vs CPU: {err:.3e}")
    res["resize_pad_card_vs_cpu"] = err
    log(f"[certified] resize_pad card vs CPU, 2 images at 224x224: max|diff| {err:.3e} "
        "(limit 1e-5)")
    return res


def _smoothing(lf, x) -> dict:
    """Phase 20 (d)."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        generator_from_seed, split_generators)
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import smoothing

    xc = x[:CERT_N].contiguous()
    cfg = smoothing.SmoothingConfig()
    clf = smoothing.SmoothedClassifier(lf, cfg)
    g = generator_from_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts0 = clf._sample(xc, g, cfg.n0)
    counts = clf._sample(xc, g, cfg.n)
    device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clf.certify_counts(counts0, counts)  # the first call imports scipy.stats
    first_host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    classes, radii = clf.certify_counts(counts0, counts)
    host_s = time.perf_counter() - t0
    n_total = smoothing._n_chunks(cfg.n, cfg.chunk) * cfg.chunk
    if (counts.shape[0] != CERT_N or not (counts.sum(axis=1) == n_total).all()
            or not (counts0.sum(axis=1) == cfg.n0).all()):
        raise AssertionError(f"smoothing votes: {counts.sum(axis=1)}, want {n_total}")
    forwards = (smoothing._n_chunks(cfg.n0, cfg.chunk) + smoothing._n_chunks(cfg.n, cfg.chunk)) \
        * -(-CERT_N // cfg.max_batch)
    res = {"device_s": device_s, "host_s": host_s, "first_host_s": first_host_s,
           "forwards": forwards,
           "images_per_forward": cfg.chunk * cfg.max_batch,
           "abstained": int((classes == smoothing.ABSTAIN).sum()),
           "mean_radius": float(np.mean(radii))}
    log(f"[certified] certify ResNet-50 bf16 at its defaults (sigma {cfg.sigma}, n0 {cfg.n0}, "
        f"n {cfg.n}, chunk {cfg.chunk} x max_batch {cfg.max_batch}) over {CERT_N} images: "
        f"{forwards} forwards of {cfg.chunk * cfg.max_batch} images in {device_s:.2f} s, host "
        f"statistics {host_s * 1e3:.1f} ms ({first_host_s * 1e3:.1f} ms the first time, "
        f"importing scipy.stats); votes sum to {n_total}; {res['abstained']} "
        f"abstained, mean radius {res['mean_radius']:.4f}")
    counts_fn = smoothing.make_counts_fn(lf, cfg.chunk)
    sweep = {}
    t0 = time.perf_counter()
    for sigma, gen in zip(SIGMAS, split_generators(generator_from_seed(1), len(SIGMAS))):
        c = smoothing.SmoothedClassifier(lf, smoothing.SmoothingConfig(sigma=sigma),
                                         counts_fn=counts_fn)
        cls, rad = c.certify(xc, gen)
        sweep[str(sigma)] = {"abstained": int((cls == smoothing.ABSTAIN).sum()),
                             "mean_radius": float(np.mean(rad))}
    res["sweep_s"] = time.perf_counter() - t0
    res["sweep"] = sweep
    log(f"[certified] 3-sigma sweep through one counts function: {res['sweep_s']:.2f} s; "
        + ", ".join(f"sigma {k}: {v['abstained']} abstained, mean radius "
                    f"{v['mean_radius']:.4f}" for k, v in sweep.items()))
    return res


def _ibp_nets() -> dict:
    """Phase 20 (e)."""
    from unittest import mock

    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import crown_ibp, ibp
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.models.ibp import ibp_params

    b = load_model("ibp_cnn7", dtype=torch.float32, device="cuda")
    p, spec, mean, std = ibp_params(b.model), b.model.spec, b.mean, b.std
    lf = make_logits_fn(b.model, mean, std)
    x = torch.rand((IBP_BATCH, 32, 32, 3), generator=generator_from_seed(7, "cuda"),
                   device="cuda")
    with torch.no_grad():
        y = lf(x).argmax(-1)
    cpu = load_model("ibp_cnn7", dtype=torch.float32, device="cpu").model.double()
    p_cpu = ibp_params(cpu)
    onehot = torch.nn.functional.one_hot(y, 10).bool()

    def margin_of(z):
        logits = lf(z)
        return logits[onehot] - logits.masked_fill(onehot, -torch.inf).max(-1).values

    res = {}
    for eps in IBP_EPS:
        def run_ibp():
            lo, hi = ibp.logit_bounds(p, spec, x, eps, mean, std)
            return ibp.verified_margin(lo, hi, y)

        def run_crown():
            return crown_ibp.crown_ibp_margin(p, spec, x, y, eps, mean, std)

        with torch.no_grad():
            m_ibp, ibp_s, _ = _counted(run_ibp)
            m_crown, crown_s, _ = _counted(run_crown)
            ibp_ms = time_ms(run_ibp, iters=5, warmup=1)
            crown_ms = time_ms(run_crown, iters=5, warmup=1)
            crown_raw = _spec_min(crown_ibp.margin_spec_bounds(p, spec, x, y, eps, mean, std)[0],
                                  onehot)
        # the CROWN bound alone (crown_ibp_margin takes the larger of the two)
        if not bool((crown_raw >= m_ibp).all()):
            raise AssertionError(f"eps {eps}: a CROWN margin below the IBP margin")
        # soundness: PGD-20 on the margin stays above the certified bound
        z, lowest = x.clone(), None
        for _ in range(20):
            z.requires_grad_(True)
            with torch.enable_grad():
                m = margin_of(z)
                (g,) = torch.autograd.grad(m.sum(), z)
            m = m.detach()
            lowest = m if lowest is None else torch.minimum(lowest, m)
            z = torch.clamp(torch.clamp(z.detach() - eps / 4 * g.sign(), x - eps, x + eps), 0, 1)
        with torch.no_grad():
            lowest = torch.minimum(lowest, margin_of(z))
        if not bool((lowest >= m_crown).all()):
            raise AssertionError(f"eps {eps}: PGD found a margin below the certified bound")
        # four images: the card's float32 against the CPU's float64, then TF32
        want = crown_ibp.crown_ibp_margin(p_cpu, spec, x[:4].cpu().double(), y[:4].cpu(), eps,
                                          mean, std)
        scale = float(want.abs().max())
        err = float((m_crown[:4].cpu().double() - want).abs().max()) / scale
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            try:
                crown_ibp.crown_ibp_margin(p, spec, x[:4], y[:4], eps, mean, std)
                raise AssertionError("the TF32 guard let a bound run with TF32 allowed")
            except RuntimeError as e:
                if "full float32" not in str(e):
                    raise
            with mock.patch.object(ibp, "require_full_float32", lambda *a: None), \
                    torch.no_grad():
                tf32 = crown_ibp.crown_ibp_margin(p, spec, x[:4], y[:4], eps, mean, std)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        tf32_err = float((tf32.cpu().double() - want).abs().max()) / scale
        if not err <= IBP_REL_TOL < tf32_err:
            raise AssertionError(f"eps {eps}: CROWN margins card vs CPU float64 {err:.3e} "
                                 f"relative, with TF32 {tf32_err:.3e}; the limit "
                                 f"{IBP_REL_TOL:.0e} must lie between them")
        res[f"{eps:.5f}"] = {
            "ibp_ms": ibp_ms, "crown_ms": crown_ms, "ibp_first_s": ibp_s, "crown_first_s": crown_s,
            "verified_ibp": float((m_ibp > 0).float().mean()),
            "verified_crown": float((m_crown > 0).float().mean()),
            "crown_raw_minus_ibp_min": float((crown_raw - m_ibp).min()),
            "crown_minus_ibp_mean": float((m_crown - m_ibp).mean()),
            "pgd_lowest_minus_bound_min": float((lowest - m_crown).min()),
            "card_vs_cpu_f64_rel": err, "tf32_vs_cpu_f64_rel": tf32_err, "margin_scale": scale}
        log(f"[certified] ibp_cnn7 float32 batch {IBP_BATCH}, eps {eps:.5f}: IBP {ibp_ms:.2f} ms, "
            f"CROWN-IBP {crown_ms:.2f} ms (CUDA events); the CROWN bound alone >= IBP "
            f"everywhere (least gain {res[f'{eps:.5f}']['crown_raw_minus_ibp_min']:.4g}, mean "
            f"gain {res[f'{eps:.5f}']['crown_minus_ibp_mean']:.4g}); PGD-20 on the margin stays "
            f">= the bound (least gap {res[f'{eps:.5f}']['pgd_lowest_minus_bound_min']:.4g}); "
            f"4 images card vs CPU float64 {err:.3e} of {scale:.4g}, with TF32 {tf32_err:.3e} "
            f"(limit {IBP_REL_TOL:.0e}); the guard refuses TF32")
    res["tight"] = _ibp_tight_soundness(b.model, mean, std, x)
    return res


def _spec_min(bounds, onehot):
    """[B] least per-spec bound over the classes j != y."""
    import torch

    return bounds.masked_fill(onehot, torch.inf).min(-1).values


def _ibp_tight_soundness(model, mean, std, x) -> dict:
    """Phase 20 (e), float64: PGD-20 on the margin against the CROWN-IBP
    bound at balls where the bound is close to the true minimum, so that a
    bound too tight by more than the gap would be caught."""
    import copy

    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.normalize import (
        normalize_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import crown_ibp, ibp
    from image_recognition_adversarial_example_attack_tpu_torch.models.ibp import ibp_params

    p = ibp_params(copy.deepcopy(model).double())
    spec = model.spec
    x = x.double()

    def logits_of(z):
        return ibp.spec_forward(p, spec, normalize_batch(z, mean, std))

    with torch.no_grad():
        clean_logits = logits_of(x)
    y = clean_logits.argmax(-1)
    onehot = torch.nn.functional.one_hot(y, clean_logits.shape[-1]).bool()
    tol = 64 * torch.finfo(torch.float64).eps * float(clean_logits.abs().max())

    def margin_of(z):
        logits = logits_of(z)
        return logits[onehot] - logits.masked_fill(onehot, -torch.inf).max(-1).values

    clean = margin_of(x).detach()
    res = {"rounding_allowance": tol}
    for eps in IBP_TIGHT_EPS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            bound = crown_ibp.crown_ibp_margin(p, spec, x, y, eps, mean, std)
        z, lowest = x.clone(), clean
        for _ in range(20):
            z.requires_grad_(True)
            with torch.enable_grad():
                (g,) = torch.autograd.grad(margin_of(z).sum(), z)
            z = torch.clamp(torch.clamp(z.detach() - eps / 4 * g.sign(), x - eps, x + eps), 0, 1)
            with torch.no_grad():
                lowest = torch.minimum(lowest, margin_of(z))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        drop, gap = clean - bound, lowest - bound
        tight = gap <= IBP_TIGHT_GAP * drop
        share = float(tight.float().mean())
        if not bool((gap >= -tol).all()) or not bool((drop > 0).all()):
            raise AssertionError(f"eps {eps:.0e}: PGD-20 in float64 found a margin "
                                 f"{float(gap.min()):.3e} below the certified bound "
                                 f"(allowance {tol:.3e})")
        if share < IBP_TIGHT_SHARE:
            raise AssertionError(f"eps {eps:.0e}: the bound is within {IBP_TIGHT_GAP:.0e} of the "
                                 f"drop of PGD's margin on {share:.3f} of the images, want "
                                 f">= {IBP_TIGHT_SHARE}")
        rel = (gap / drop)[tight]
        res[f"{eps:.0e}"] = {"seconds": seconds, "tight_share": share,
                             "gap_over_drop_max_tight": float(rel.max()),
                             "gap_min": float(gap.min()), "drop_median": float(drop.median())}
        log(f"[certified] ibp_cnn7 float64 batch {x.shape[0]}, eps {eps:.0e}: CROWN-IBP bound "
            f"and PGD-20 on the margin in {seconds:.2f} s; PGD stays >= the bound on every "
            f"image (least gap {float(gap.min()):.3e}, allowance {tol:.3e}); on {share:.3f} of "
            f"the images the gap is <= {IBP_TIGHT_GAP:.0e} of the bound's drop "
            f"(median drop {float(drop.median()):.3e}; largest gap/drop there "
            f"{float(rel.max()):.3e})")
    return res


def _grid_kernels() -> dict:
    """The three kernels against their plain versions at the shapes the
    --certified grid on ibp_cnn7 gives them: 128 images resident, chunks of
    CERT_GRID_CHUNK and their tail streamed."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    n = SHAPE[0]
    res = {}
    for b in (n, CERT_GRID_CHUNK, n % CERT_GRID_CHUNK):
        shape = (b, 32, 32, 3)
        gen = generator_from_seed(11 + b, "cuda")
        x = torch.rand(shape, generator=gen, device="cuda")
        x0 = torch.rand(shape, generator=gen, device="cuda")
        grad = torch.randn(shape, generator=gen, device="cuda")
        grad.view(-1)[::7] = 0.0  # sign(0) = 0 must hold
        # pgd_step at each of the grid's eps, untargeted and targeted: bit-exact
        for eps in map(float, CERT_GRID_EPS):
            for a in (ALPHA, -ALPHA):
                k = ew.pgd_step(x, grad, x0, eps, a)
                p = ew.pgd_step_plain(x, grad if a > 0 else -grad, x0, eps, abs(a))
                if not torch.equal(k, p):
                    raise AssertionError(f"pgd_step at {list(shape)}, eps {eps}, alpha {a}: "
                                         f"max|diff| {float((k - p).abs().max())}")
        # quantize: bit-exact, with values outside [0,1] and exact .5 ties
        xq = x * 1.2 - 0.1
        ties = (torch.arange(xq.numel() // 11, device="cuda") % (LEVELS - 1)).float()
        xq.view(-1)[::11][:ties.numel()] = (ties + 0.5) / (LEVELS - 1)
        kq, pq = ew.quantize(xq, LEVELS), ew.quantize_plain(xq, LEVELS)
        if not torch.equal(kq, pq):
            raise AssertionError(f"quantize at {list(shape)}: max|diff| "
                                 f"{float((kq - pq).abs().max())}")
        # noise: the range, mean and variance checks of the batch-1 shape
        noise = ew.uniform_noise(shape, EPS, generator_from_seed(12 + b), "cuda").double()
        eps32 = float(np.float32(EPS))
        mean, var = float(noise.mean()), float(noise.var())
        if not (float(noise.min()) >= -eps32 and float(noise.max()) <= eps32
                and abs(mean) < 1e-2 * EPS and abs(var / (EPS ** 2 / 3) - 1) < 2e-2):
            raise AssertionError(f"noise at {list(shape)}: range [{float(noise.min())}, "
                                 f"{float(noise.max())}], mean {mean}, var {var}")
        rec = {"pgd_step": "bit-exact", "quantize": "bit-exact",
               "noise_mean": mean, "noise_var_ratio": var / (EPS ** 2 / 3)}
        if b == n:
            # calls issued one by one, as phase 2 times them (outside the counted runs)
            numel, g3 = x.numel(), generator_from_seed(13)
            rec.update({
                "pgd_step_ms": time_ms(lambda: ew.pgd_step(x, grad, x0, EPS, ALPHA)),
                "pgd_step_bound_ms": bound_ms("pgd_step", numel),
                "quantize_ms": time_ms(lambda: ew.quantize(xq, LEVELS)),
                "quantize_bound_ms": bound_ms("quantize", numel),
                "uniform_noise_ms": time_ms(lambda: ew.uniform_noise(shape, EPS, g3, "cuda")),
                "uniform_noise_bound_ms": bound_ms("uniform_noise", numel),
                # the same launches back to back: the kernels' device time
                "pgd_step_queued_ms": queued_ms(lambda: ew.pgd_step(x, grad, x0, EPS, ALPHA)),
                "quantize_queued_ms": queued_ms(lambda: ew.quantize(xq, LEVELS)),
                "uniform_noise_queued_ms": queued_ms(
                    lambda: ew.uniform_noise(shape, EPS, g3, "cuda"))})
        res[str(list(shape))] = rec
        log(f"[certified] kernels at {list(shape)}: pgd_step bit-exact at eps "
            f"{', '.join(CERT_GRID_EPS)} (alpha +-2/255), quantize bit-exact with ties, noise in "
            f"range, mean {mean:.2e}, var/(eps^2/3) {var / (EPS ** 2 / 3):.4f}"
            + ("" if b != n else
               f"; pgd_step {rec['pgd_step_ms']:.4f} ms (bound {rec['pgd_step_bound_ms']:.5f}), "
               f"quantize {rec['quantize_ms']:.4f} ms (bound {rec['quantize_bound_ms']:.5f}), "
               f"noise {rec['uniform_noise_ms']:.4f} ms (bound "
               f"{rec['uniform_noise_bound_ms']:.5f}), one call at a time; "
               f"{QUEUED_LAUNCHES} launches back to back: pgd_step "
               f"{rec['pgd_step_queued_ms']:.5f} ms, quantize {rec['quantize_queued_ms']:.5f} ms, "
               f"noise {rec['uniform_noise_queued_ms']:.5f} ms a launch"))
    return res


def _certified_clis(pngs: list[Path], tmp: Path) -> dict:
    """Phase 20 (f): four CLI subprocesses started together, then the grid
    CLI with --certified in this process, resident and streamed."""
    import re

    from PIL import Image

    from image_recognition_adversarial_example_attack_tpu_torch.cli import defense_experiments

    img32 = _linked(pngs[:CERT_N], tmp / "cert32")
    runs = {
        "uap": ("uap", "--epochs", "4", "--batch_size", "16", "--output", str(tmp / "uap")),
        "patch": ("uap", "--mode", "patch", "--steps", "20", "--patch_size", "50",
                  "--target", str(PATCH_TARGET), "--output", str(tmp / "patch"),
                  "--save_adv_dir", str(tmp / "patch_adv")),
        "smoothing": ("certify", "--plot", str(tmp / "cert.png"), "--sigmas", "0.25", "0.5",
                      "--output", str(tmp / "cert.json")),
        "crown-ibp": ("certify", "--method", "crown-ibp", "--model", "ibp_cnn7",
                      "--output", str(tmp / "crown.json")),
    }
    procs = {}
    for name, (module, *args) in runs.items():
        cmd = [sys.executable, "-m", f"{PKG}.cli.{module}", "--image_dir", str(img32), *args]
        procs[name] = (subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), time.perf_counter())
    res = {}
    for name, (proc, t0) in procs.items():
        out, err = proc.communicate(timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or "Using device: cuda" not in out:
            raise AssertionError(f"{name} CLI exit {proc.returncode}:\n{out[-3000:]}\n"
                                 f"{err[-4000:]}")
        res[name] = {"seconds": seconds}
    uap_json = json.loads((tmp / "uap.json").read_text())
    patch_json = json.loads((tmp / "patch.json").read_text())
    cert = json.loads((tmp / "cert.json").read_text())
    crown = json.loads((tmp / "crown.json").read_text())
    if (uap_json["linf"] > 10 / 255 + 1e-6 or len(uap_json["per_image"]) != CERT_N
            or "targeted_success_rate" not in patch_json
            or len(list((tmp / "patch_adv").iterdir())) != CERT_N
            or set(cert) != {"n0", "n", "alpha", "sweeps"} or len(cert["sweeps"]) != 2
            or any(len(s["results"]) != CERT_N for s in cert["sweeps"])
            or crown["method"] != "crown-ibp" or len(crown["sweeps"]) != 2
            or any(len(s["results"]) != CERT_N for s in crown["sweeps"])):
        raise AssertionError(f"the uap/certify CLIs' JSON: {uap_json.keys()} {patch_json.keys()} "
                             f"{cert.keys()} {crown.keys()}")
    with Image.open(tmp / "cert.png") as im:
        res["smoothing"]["plot_size"] = im.size
    res["uap"]["fooling_rate"] = uap_json["fooling_rate"]
    res["patch"]["targeted_success_rate"] = patch_json["targeted_success_rate"]
    res["crown-ibp"]["verified_accuracy"] = [s["verified_accuracy"] for s in crown["sweeps"]]
    log("[certified] CLIs in four subprocesses started together, 32 PNGs: "
        + "; ".join(f"{k} exit 0 in {v['seconds']:.1f} s" for k, v in res.items())
        + f"; uap fooling rate {uap_json['fooling_rate']:.3f}, patch targeted success "
        f"{patch_json['targeted_success_rate']:.3f}, crown-ibp verified "
        f"{res['crown-ibp']['verified_accuracy']}")

    img128 = _linked(pngs[:SHAPE[0]], tmp / "cert128")
    grid = ["--image_dir", str(img128), "--model", "ibp_cnn7", "--model-dtype", "float32",
            "--attacks", "fgsm", "pgd", "--eps_list", *CERT_GRID_EPS, "--steps", str(STEPS),
            "--certified", "crown-ibp", "--viz_samples", "0"]
    line = re.compile(r"^certified\(crown-ibp\), eps=\d\.\d{5}: verified_acc=\d\.\d{4}, "
                      r"clean_acc=\d\.\d{4} \(128 images\)$")
    n_eps, chunks = len(CERT_GRID_EPS), -(-SHAPE[0] // CERT_GRID_CHUNK)
    rows = {}
    for name, extra, k in (("resident", [], 1),
                           ("streamed", ["--max_batch", str(CERT_GRID_CHUNK)], chunks)):
        out_dir = tmp / f"grid_{name}"
        out, seconds, counts = _in_process_cli(defense_experiments.main,
                                               [*grid, *extra, "--output_dir", str(out_dir)])
        want = {"pgd_step": k * n_eps * STEPS, "quantize": k * 2 * n_eps,
                "uniform_noise": k * n_eps}
        lines = [ln for ln in out.splitlines() if ln.startswith("certified(")]
        data = json.loads((out_dir / "certified_accuracy.json").read_text())
        if counts != want or len(lines) != n_eps or not all(line.match(ln) for ln in lines):
            raise AssertionError(f"grid --certified ({name}): launches {counts} (want {want}), "
                                 f"lines {lines}")
        rows[name] = data["rows"]
        res[f"grid_{name}"] = {"seconds": seconds, "launches": counts, "lines": lines,
                               "rows": data["rows"], "cell_s": _cells_s(out_dir)}
        log(f"[certified] grid CLI --model ibp_cnn7 --attacks fgsm pgd --certified crown-ibp, "
            f"{SHAPE[0]} PNGs {name}: {seconds:.1f} s in process; launches {counts}")
        for ln in lines:
            log(f"[certified]   {ln}")
    if rows["resident"] != rows["streamed"]:
        raise AssertionError(f"certified rows differ: {rows}")
    log(f"[certified] the streamed grid's certified rows (chunks of {CERT_GRID_CHUNK}) equal "
        "the resident grid's")
    return res


def phase_certified(state: dict, pngs: list[Path]) -> dict:
    """Phase 20: universal perturbations and patches, the EOT transforms of
    the randomized defenses, randomized smoothing, the IBP nets' bounds, and
    the uap, certify and grid --certified CLIs."""
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns

    x, y = state["x"], state["y"]
    lf = make_fns(state["bundle"])[0]
    res = _uap_and_patch(lf, x, y)
    res["eot"] = _eot_pgd(lf, x, y)
    res["smoothing"] = _smoothing(lf, x)
    res["ibp"] = _ibp_nets()
    res["grid_kernels"] = _grid_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        res["cli"] = _certified_clis(pngs, Path(tmp))
    return res


# phase 21: (a) the corruption bank, (b) the detector comparison, (c) the
# detector_eval and corruption_eval CLIs
CORR_SUBSET, CORR_TOL = 4, 1e-5
# the corruptions whose card output must equal the CPU's: an order-0 gather
# (pixelate) or exact elementwise arithmetic
CORR_EXACT = ("pixelate", "brightness", "impulse_noise", "shot_noise")
# elastic_transform is not clipped (in either package): its order-1 weights
# (1 - f, f) may sum to one ulp above 1
ELASTIC_SLACK = 1e-6
DET_ATTACKS, DET_CW_STEPS = ("fgsm", "pgd", "cw"), 100
# the counted detector comparison: one quantize calibrating squeezing on the
# clean batch, one per attack scoring the stacked batch; PGD-10's 10 pgd_step
# and 1 noise; fgsm and cw launch none
DET_LAUNCHES = {"pgd_step": STEPS, "quantize": 1 + len(DET_ATTACKS), "uniform_noise": 1}
CLI_N, CLI_CHUNK = 32, 16


def _corruption_bank(lf, x, y) -> dict:
    """Phase 21 (a)."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        cell_generator, generator_from_seed)
    from image_recognition_adversarial_example_attack_tpu_torch.eval import corruptions as c

    res = {"cell_ms": {}, "accuracy": {}, "card_vs_cpu": {}}
    n = x.shape[0]
    for name in c.CORRUPTION_NAMES:
        run = c.make_corruption_run(lf, name)
        run(x, y, 1, generator_from_seed(0))  # warm-up
        ms, accs = [], []
        for sev in range(1, 6):
            cell = f"{name}:s{sev}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            correct = run(x, y, sev, cell_generator(0, cell))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            accs.append(float(correct.float().mean()))
            out = c.apply_corruption(name, x, sev, cell_generator(0, cell))
            hi = 1.0 + (ELASTIC_SLACK if name == "elastic_transform" else 0.0)
            if (out.shape != x.shape or not bool(torch.isfinite(out).all())
                    or float(out.min()) < 0.0 or float(out.max()) > hi):
                raise AssertionError(f"{name} s{sev}: shape {tuple(out.shape)}, range "
                                     f"[{float(out.min())}, {float(out.max())}]")
        res["cell_ms"][name], res["accuracy"][name] = ms, accs
        log(f"[corruption] {name:>17s} at batch {n}: ms per cell (corruption + forward) "
            + " ".join(f"{v:.2f}" for v in ms) + "; accuracy " + " ".join(f"{a:.3f}" for a in accs))
    flat = [v for ms in res["cell_ms"].values() for v in ms]
    res["cell_ms_mean"] = sum(flat) / len(flat)
    log(f"[corruption] 85 cells at batch {n}: mean {res['cell_ms_mean']:.2f} ms a cell, "
        f"every output finite and in [0,1] (elastic_transform within {ELASTIC_SLACK:.0e}); the "
        "accuracies of random weights measure cost, not robustness")

    # the card against the CPU on the same draws, made once on the CPU
    xs = x[:CORR_SUBSET].cpu().contiguous()
    worst = 0.0
    for name in c.CORRUPTION_NAMES:
        errs = []
        for sev in range(1, 6):
            draws = c.draw_corruption(name, xs, sev, generator_from_seed(sev))
            want = c.apply_corruption(name, xs, sev, draws=draws)
            got = c.apply_corruption(name, xs.cuda(), sev,
                                     draws=tuple(d.cuda() for d in draws)).cpu()
            err = float((got - want).abs().max())
            if err > CORR_TOL or (name in CORR_EXACT and not torch.equal(got, want)):
                raise AssertionError(f"{name} s{sev} card vs CPU: max|diff| {err:.3e}")
            if name == "glass_blur":
                # its order-0 gathers, on the same rounded coordinates: equal
                rr, cc = c._grid(224, 224, "cpu")
                for dr, dc in (draws[:2], draws[2:]):
                    r, q = rr[None] + torch.round(dr), cc[None] + torch.round(dc)
                    g_cpu = c.map_coordinates(want, r, q, order=0)
                    g_card = c.map_coordinates(want.cuda(), r.cuda(), q.cuda(), order=0).cpu()
                    if not torch.equal(g_cpu, g_card):
                        raise AssertionError(f"glass_blur s{sev}: the card's gather differs")
            errs.append(err)
        res["card_vs_cpu"][name] = max(errs)
        worst = max(worst, max(errs))
    log(f"[corruption] card vs CPU on {CORR_SUBSET} images at 224x224, every corruption and "
        f"severity on the same CPU draws: max|diff| {worst:.3e} (limit {CORR_TOL:.0e}); "
        f"{', '.join(CORR_EXACT)} and glass_blur's gathers equal")

    g = generator_from_seed(9)
    x64 = xs.double()
    rr = torch.rand((CORR_SUBSET, 224, 224), generator=g, dtype=torch.float64) * 240 - 8
    cc = torch.rand((CORR_SUBSET, 224, 224), generator=g, dtype=torch.float64) * 240 - 8
    rr.view(-1)[:4] = torch.tensor([-0.5, 0.5, 2.5, 222.5], dtype=torch.float64)
    mc = {}
    for order in (0, 1):
        want = c.map_coordinates(x64, rr, cc, order)
        got = c.map_coordinates(x64.cuda(), rr.cuda(), cc.cuda(), order).cpu()
        mc[order] = float((got - want).abs().max())
        if mc[order] > 1e-12:
            raise AssertionError(f"map_coordinates order {order} card vs CPU: {mc[order]:.3e}")
    res["map_coordinates_card_vs_cpu"] = mc
    log(f"[corruption] map_coordinates float64 card vs CPU, [{CORR_SUBSET},224,224,3]: order 0 "
        f"{mc[0]:.3e}, order 1 {mc[1]:.3e} (limit 1e-12)")
    return res


def _detector_comparison(bundle, x, y) -> dict:
    """Phase 21 (b)."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, predict_labels, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import (
        cell_rng_id, make_fns, n_classes_of)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import cell_generator
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        calibrate_mahalanobis, feature_score, mahalanobis_score, squeezing_score,
        threshold_from_scores)
    from image_recognition_adversarial_example_attack_tpu_torch.eval import detector_eval
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    lf, ff = make_fns(bundle)
    params = AttackParams(eps=EPS, alpha=ALPHA, steps=STEPS, cw_steps=DET_CW_STEPS)
    state = {}

    def comparison():
        with torch.no_grad():
            thr = {"feature": threshold_from_scores(feature_score(ff, x)),
                   "squeezing": float(torch.quantile(squeezing_score(lf, x), 0.95))}
        maha, thr["mahalanobis"] = calibrate_mahalanobis(ff, x, y, n_classes_of(bundle.model),
                                                         n=x.shape[0])
        fns = {"feature": lambda xx: feature_score(ff, xx),
               "squeezing": lambda xx: squeezing_score(lf, xx),
               "mahalanobis": lambda xx: mahalanobis_score(ff, xx, maha)}
        cells, adv = [], {}
        for attack in DET_ATTACKS:
            x_adv = run_attack(attack, lf, x, y, params,
                               generator=cell_generator(0, cell_rng_id(attack, EPS)))
            asr = float((predict_labels(lf, x_adv) != y).float().mean())
            adv[attack] = (x_adv, asr)
            for det, fn in fns.items():
                cells.append(detector_eval.evaluate_detector_cell(fn, x, x_adv, thr[det],
                                                                  detector=det, attack=attack))
        state.update(fns=fns, adv=adv, thr=thr)
        return cells

    cells, seconds, counts = _counted(comparison)
    if counts != DET_LAUNCHES:
        raise AssertionError(f"detector comparison launches {counts}, want {DET_LAUNCHES}")
    _check_ball(state["adv"]["pgd"][0], x, EPS, "detector comparison pgd")
    for r in cells:
        if not all(0.0 <= v <= 1.0 for v in (r.auc, r.tpr_at_threshold, r.fpr_at_threshold,
                                              r.tpr_at_fpr05)):
            raise AssertionError(f"detector cell out of range: {r}")
    res = {"seconds": seconds, "launches": counts, "thresholds": state["thr"],
           "asr": {a: v[1] for a, v in state["adv"].items()},
           "cells": [vars(r) for r in cells], "score_ms": {}}
    log(f"[detector] fgsm, pgd-10, cw-{DET_CW_STEPS} at batch {x.shape[0]} scored by feature, "
        f"squeezing and Mahalanobis (stacked [{2 * x.shape[0]}] calls): {seconds:.2f} s; "
        f"launches {counts} (predicted {DET_LAUNCHES}); ASR "
        + ", ".join(f"{a} {v:.3f}" for a, v in res["asr"].items()))
    for line in detector_eval.summary_table(cells).splitlines():
        log(f"[detector]   {line}")
    log("[detector] random weights: the AUCs and TPRs measure cost and agreement, not "
        "detection")

    # each detector's stacked [2B] call, timed outside the counted run
    stacked = torch.cat([x, state["adv"]["pgd"][0]]).contiguous()
    with torch.no_grad():
        for det, fn in state["fns"].items():
            res["score_ms"][det] = time_ms(lambda: fn(stacked), iters=3, warmup=1)
    # quantize at the stacked shape: bit-exact, with values outside [0,1] and ties
    xq = stacked * 1.2 - 0.1
    ties = (torch.arange(xq.numel() // 11, device=xq.device) % (LEVELS - 1)).float()
    xq.view(-1)[::11][:ties.numel()] = (ties + 0.5) / (LEVELS - 1)
    kq, pq = ew.quantize(xq, LEVELS), ew.quantize_plain(xq, LEVELS)
    if not torch.equal(kq, pq):
        raise AssertionError(f"quantize at {list(xq.shape)}: max|diff| "
                             f"{float((kq - pq).abs().max())}")
    res["quantize_stacked"] = {
        "shape": list(xq.shape), "bit_exact": True,
        "ms": time_ms(lambda: ew.quantize(xq, LEVELS)),
        "plain_ms": time_ms(lambda: ew.quantize_plain(xq, LEVELS)),
        "bound_ms": bound_ms("quantize", xq.numel())}
    q = res["quantize_stacked"]
    log(f"[detector] stacked [{2 * x.shape[0]}] scoring ms (CUDA events): "
        + ", ".join(f"{d} {v:.2f}" for d, v in res["score_ms"].items())
        + f"; quantize at {q['shape']} bit-exact with ties, {q['ms']:.4f} ms (plain "
        f"{q['plain_ms']:.4f}, bound {q['bound_ms']:.4f})")
    return res


def _capture_clean_scores():
    """Record every clean score vector the detector CLI hands to
    ``cell_from_scores`` (both paths reach it), by (detector, attack)."""
    from image_recognition_adversarial_example_attack_tpu_torch.cli import detector_eval as cli
    from image_recognition_adversarial_example_attack_tpu_torch.eval import detector_eval

    seen: dict = {}
    original = detector_eval.cell_from_scores

    def recording(s_clean, s_adv, threshold, *, detector, attack):
        seen[(detector, attack)] = s_clean
        return original(s_clean, s_adv, threshold, detector=detector, attack=attack)

    detector_eval.cell_from_scores = cli.cell_from_scores = recording

    def restore():
        detector_eval.cell_from_scores = cli.cell_from_scores = original

    return seen, restore


def _phase21_clis(pngs: list[Path], tmp: Path) -> dict:
    """Phase 21 (c): the default detector_eval and the resident
    corruption_eval in two subprocesses started together; meanwhile, in
    this process, detector_eval in float32 resident and streamed and
    corruption_eval streamed."""
    import numpy as np

    from PIL import Image

    from image_recognition_adversarial_example_attack_tpu_torch.cli import corruption_eval
    from image_recognition_adversarial_example_attack_tpu_torch.cli import detector_eval
    from image_recognition_adversarial_example_attack_tpu_torch.eval.corruptions import (
        CORRUPTION_NAMES, DETERMINISTIC)

    imgs = _linked(pngs[:CLI_N], tmp / "p21")
    sev = ["--severities", "1", "3", "5"]
    runs = {
        "detector_eval": ("detector_eval", "--output_json", str(tmp / "det.json")),
        "corruption_eval": ("corruption_eval", "--corruptions", "all", *sev, "--plot",
                            str(tmp / "heat.png"), "--output", str(tmp / "corr.json")),
    }
    procs = {}
    for name, (module, *args) in runs.items():
        cmd = [sys.executable, "-m", f"{PKG}.cli.{module}", "--image_dir", str(imgs), *args]
        procs[name] = (subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), time.perf_counter())
    res = {}
    # in process meanwhile: corruption_eval streamed, detector_eval float32 both ways
    out, seconds, counts = _in_process_cli(corruption_eval.main, [
        "--image_dir", str(imgs), "--corruptions", "all", *sev, "--max_batch", str(CLI_CHUNK),
        "--output", str(tmp / "corr_s.json")])
    if "Streaming evaluation" not in out:
        raise AssertionError("corruption_eval --max_batch 16 did not stream")
    res["corruption_streamed"] = {"seconds": seconds, "launches": counts}
    clean = {}
    for mode, extra in (("resident", []), ("streamed", ["--max_batch", str(CLI_CHUNK)])):
        seen, restore = _capture_clean_scores()
        try:
            out, seconds, counts = _in_process_cli(detector_eval.main, [
                "--image_dir", str(imgs), "--attacks", "fgsm", "--model-dtype", "float32",
                "--output_json", str(tmp / f"det_f32_{mode}.json"), *extra])
        finally:
            restore()
        rows = json.loads((tmp / f"det_f32_{mode}.json").read_text())
        if len(rows) != 3 or "DETECTOR COMPARISON" not in out:
            raise AssertionError(f"detector_eval float32 {mode}: {rows}")
        clean[mode] = seen
        res[f"detector_f32_{mode}"] = {"seconds": seconds, "launches": counts, "rows": rows}
    rel = {}
    for det in ("feature", "squeezing"):
        a, b = clean["resident"][(det, "fgsm")], clean["streamed"][(det, "fgsm")]
        rel[det] = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
        if a.shape != (CLI_N,) or b.shape != (CLI_N,) or rel[det] > 1e-5:
            raise AssertionError(f"detector_eval float32 clean {det} scores resident vs "
                                 f"streamed: {rel[det]:.3e} relative")
    res["clean_scores_rel"] = rel
    log(f"[cli21] detector_eval --model-dtype float32 --attacks fgsm on {CLI_N} PNGs in process: "
        f"resident {res['detector_f32_resident']['seconds']:.1f} s, launches "
        f"{res['detector_f32_resident']['launches']}; streamed in chunks of {CLI_CHUNK} "
        f"{res['detector_f32_streamed']['seconds']:.1f} s, launches "
        f"{res['detector_f32_streamed']['launches']}; clean scores resident vs streamed "
        + ", ".join(f"{d} {v:.3e}" for d, v in rel.items()) + " relative (limit 1e-5; "
        "Mahalanobis fits on the first chunk when streamed, so its scores differ by design)")

    for name, (proc, t0) in procs.items():
        out, err = proc.communicate(timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or "Using device: cuda" not in out:
            raise AssertionError(f"{name} CLI exit {proc.returncode}:\n{out[-3000:]}\n"
                                 f"{err[-4000:]}")
        res[name] = {"seconds": seconds, "stdout_tail": out[-2500:]}
    rows = json.loads((tmp / "det.json").read_text())
    if (len(rows) != 9 or "DETECTOR COMPARISON" not in res["detector_eval"]["stdout_tail"]
            or {r["attack"] for r in rows} != set(DET_ATTACKS)):
        raise AssertionError(f"detector_eval CLI rows: {rows}")
    resident = json.loads((tmp / "corr.json").read_text())
    streamed = json.loads((tmp / "corr_s.json").read_text())
    if set(resident["cells"]) != set(CORRUPTION_NAMES) or resident["n_images"] != CLI_N:
        raise AssertionError(f"corruption_eval JSON: {resident.keys()}")
    det = {n: resident["cells"][n] for n in DETERMINISTIC}
    if det != {n: streamed["cells"][n] for n in DETERMINISTIC}:
        raise AssertionError("corruption_eval: deterministic cells differ resident vs streamed")
    with Image.open(tmp / "heat.png") as im:
        res["heatmap_size"] = im.size
    res["corruption_eval"]["mean_corruption_accuracy"] = resident["mean_corruption_accuracy"]
    log(f"[cli21] subprocesses started together: detector_eval at its defaults (fgsm pgd cw, "
        f"bf16) exit 0 in {res['detector_eval']['seconds']:.1f} s, 9 rows; corruption_eval "
        f"--corruptions all --severities 1 3 5 --plot exit 0 in "
        f"{res['corruption_eval']['seconds']:.1f} s, heatmap {res['heatmap_size']}; "
        f"in process streamed in chunks of {CLI_CHUNK}: "
        f"{res['corruption_streamed']['seconds']:.1f} s, its {len(DETERMINISTIC)} "
        "deterministic corruptions' cells equal the resident run's")
    return res


def phase_detector_corruption(state: dict, pngs: list[Path]) -> dict:
    """Phase 21: the corruption bank and the detector comparison at full
    width, then the detector_eval and corruption_eval CLIs."""
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns

    x, y, bundle = state["x"], state["y"], state["bundle"]
    res = {"corruption": _corruption_bank(make_fns(bundle)[0], x, y)}
    res["detector"] = _detector_comparison(bundle, x, y)
    with tempfile.TemporaryDirectory() as tmp:
        res["cli"] = _phase21_clis(pngs, Path(tmp))
    return res


# Phase 22: the CIFAR family and the lightweight ImageNet families
CIFAR_NAMES = ("wrn28_10", "wrn34_10", "wrn_tiny", "preact_resnet18", "wrn28_10_robust",
               "mobilenet_v2", "efficientnet_b0", "convnext_tiny")
CIFAR_TIMED = ("wrn28_10", "wrn34_10", "preact_resnet18", "mobilenet_v2", "efficientnet_b0",
               "convnext_tiny")
CIFAR_ARCHIVE_N, CIFAR_RE_N, CIFAR_EPS = 256, 32, "0.03137"
# PGD-10 with its random start; the cell adds the quantization arm's one quantize
CIFAR_PGD_LAUNCHES = {"pgd_step": STEPS, "quantize": 0, "uniform_noise": 1}
CIFAR_CELL_LAUNCHES = {"pgd_step": STEPS, "quantize": 1, "uniform_noise": 1}
# ConvNeXt-T's stages: (channels, side at 224x224, blocks)
CONVNEXT_STAGES = ((96, 56, 3), (192, 28, 3), (384, 14, 9), (768, 7, 3))
# runs a CLI's main in a subprocess and prints its kernel launches last
LAUNCH_WRAPPER = ("import json, sys, importlib\n"
                  f"from {PKG}.kernels import elementwise as ew\n"
                  "main = importlib.import_module(sys.argv[1]).main\n"
                  "code = main(sys.argv[2:])\n"
                  "print('LAUNCHES ' + json.dumps(ew.launch_counts()))\n"
                  "sys.exit(code)\n")


def _write_cifar_archive(root: Path, n: int, seed: int = 22) -> Path:
    """A CIFAR-10 test batch of ``n`` seeded images and labels, in the
    archive's pickle layout."""
    import pickle

    import numpy as np

    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, 256, (n, 3072)).astype(np.uint8)
    with open(d / "test_batch", "wb") as f:
        pickle.dump({b"data": rows, b"labels": rng.randint(0, 10, n).tolist()}, f)
    return root


def _cifar_card_vs_cpu() -> dict:
    """Phase 22 (a): each of the eight names in float32, 4 images at its
    input size, the card against the CPU on the same seeded weights."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import (
        make_fns, n_classes_of)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model, model_meta

    res = {}
    for name in CIFAR_NAMES:
        size = int(model_meta(name)["input_size"])
        x = torch.rand((4, size, size, 3), generator=generator_from_seed(22))
        out = {}
        for d in ("cpu", "cuda"):
            b = load_model(name, dtype=torch.float32, device=d)
            with torch.no_grad():
                out[d] = make_fns(b)[0](x.to(d)).cpu()
            classes = n_classes_of(b.model)
            del b
        scale = float(out["cpu"].abs().max())
        rel = float((out["cuda"] - out["cpu"]).abs().max()) / scale
        if out["cuda"].shape != (4, classes) or not rel <= F32_REL_TOL:
            raise AssertionError(f"{name}: float32 logits {tuple(out['cuda'].shape)} on the "
                                 f"card vs the CPU {rel:.3e} relative (limit {F32_REL_TOL:.0e})")
        res[name] = {"input_size": size, "classes": classes, "max_abs_logit": scale,
                     "max_abs_diff": float((out["cuda"] - out["cpu"]).abs().max()), "rel": rel}
    log("[cifar] float32 card vs CPU, 4 images, same seeded weights (TF32 off): " + "; ".join(
        f"{n} {r['input_size']}x{r['input_size']} max|diff| {r['max_abs_diff']:.3e} of "
        f"{r['max_abs_logit']:.3e}" for n, r in res.items()) + f" (limit {F32_REL_TOL:.0e} "
        "relative)")
    return res


def _convnext_dwconv(model, forward_ms: float) -> dict:
    """The 7x7 depthwise convs of ConvNeXt-T alone, bf16 channels_last at
    batch 128: one block's conv per stage timed, the sum over the 18 blocks
    against the forward."""
    import torch

    res = {"stages": []}
    total = 0.0
    for k, (dim, side, depth) in enumerate(CONVNEXT_STAGES):
        conv = model.features[2 * k + 1][0].block[0]
        xa = torch.randn((SHAPE[0], dim, side, side), device="cuda", dtype=torch.bfloat16)
        xa = xa.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            ms = time_ms(lambda: conv(xa), iters=10, warmup=2)
        bytes_ = 2 * 2 * xa.numel() + 2 * conv.weight.numel()
        flops = 2 * 49 * xa.numel()
        bound = max(bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
        res["stages"].append({"channels": dim, "side": side, "blocks": depth, "ms": ms,
                              "bound_ms": bound, "bound_share": bound / ms})
        total += ms * depth
    res["total_ms"], res["forward_share"] = total, total / forward_ms
    log("[cifar] convnext_tiny's 7x7 depthwise convs alone, bf16 batch 128 (CUDA events; "
        "bound: the bytes at 3.35 TB/s or 2*49 FLOP an output at the 67 TFLOP/s non-tensor "
        "rate): " + "; ".join(
            f"{s['channels']}x{s['side']}^2 {s['ms']:.3f} ms (bound {s['bound_ms']:.3f}, "
            f"{s['bound_share']:.2f})" for s in res["stages"])
        + f"; x depths {total:.2f} ms, {res['forward_share']:.3f} of the {forward_ms:.2f} ms "
        "forward")
    return res


def _cifar_forward_ms() -> dict:
    """Phase 22 (b): bf16 and int8 forward ms at batch 128 of the six
    full-width families, at 32x32 (the CIFAR nets) or 224x224."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model, model_meta
    from image_recognition_adversarial_example_attack_tpu_torch.ops import int8

    res, bundles = {}, {}
    for name in CIFAR_TIMED:
        size = int(model_meta(name)["input_size"])
        x = torch.rand((SHAPE[0], size, size, 3), generator=generator_from_seed(23, "cuda"),
                       device="cuda")
        b = load_model(name, dtype=torch.bfloat16, device="cuda")
        lf = make_fns(b)[0]
        qlf = make_logits_fn(_int8_twin(b), b.mean, b.std, input_dtype=torch.bfloat16)
        with torch.no_grad():
            logits = lf(x)
            ms = time_ms(lambda: lf(x), iters=5, warmup=2)
            int8.reset_calls()
            qlogits = qlf(x)
            calls = int8.call_counts()
            ms8 = time_ms(lambda: qlf(x), iters=3, warmup=1)
        for what, t in (("bf16", logits), ("int8", qlogits)):
            if t.shape[0] != SHAPE[0] or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name} {what}: logits {tuple(t.shape)}, not all finite")
        agree = float((logits.argmax(-1) == qlogits.argmax(-1)).float().mean())
        res[name] = {"input_size": size, "bf16_ms": ms, "bf16_img_s": SHAPE[0] / ms * 1e3,
                     "int8_ms": ms8, "int8_over_bf16": ms8 / ms, "int8_calls": calls,
                     "int8_vs_bf16_top1": agree, "params": sum(
                         p.numel() for p in b.model.parameters())}
        log(f"[cifar] {name} at {size}x{size} batch {SHAPE[0]}: bf16 forward {ms:.2f} ms "
            f"({res[name]['bf16_img_s']:.1f} img/s); int8 {ms8:.2f} ms ({ms8 / ms:.2f}x), "
            f"quantized calls {calls}, top-1 agreement with bf16 {agree:.3f}; "
            f"{res[name]['params'] / 1e6:.2f}M parameters")
        if name == "convnext_tiny":
            res[name]["dwconv"] = _convnext_dwconv(b.model, ms)
        if name == "wrn28_10":
            bundles[name] = b
        del b, qlf
    return res, bundles


def _cifar_wrn_path(bundle) -> dict:
    """Phase 22 (c): PGD-10 on WRN-28-10 at full width, bf16, batch 128,
    32x32; the pgd -> smoothing + quantization -> stage-3 detector cell with
    the threshold calibrated on the clean batch."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import (
        AttackParams, predict_labels, run_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        calibrate_feature_threshold)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch, summary_line)

    lf, ff = make_fns(bundle)
    x = torch.rand((SHAPE[0], 32, 32, 3), generator=generator_from_seed(24, "cuda"),
                   device="cuda")
    y = predict_labels(lf, x)
    params = AttackParams(eps=EPS, alpha=ALPHA, steps=STEPS, random_start=True)
    x_adv, _, counts = _counted(lambda: run_attack("pgd", lf, x, y, params,
                                                   generator_from_seed(0)))
    if counts != CIFAR_PGD_LAUNCHES:
        raise AssertionError(f"WRN-28-10 PGD-10 launches {counts}, want {CIFAR_PGD_LAUNCHES}")
    linf = _check_ball(x_adv, x, EPS, "wrn28_10 pgd")
    success = float((predict_labels(lf, x_adv) != y).float().mean())
    runs = 3
    _, seconds, _ = _counted(lambda: [run_attack("pgd", lf, x, y, params,
                                                 generator_from_seed(10 + i))
                                      for i in range(runs)])
    ex_s = SHAPE[0] * runs / seconds
    res = {"pgd": {"launches": counts, "linf": linf, "attack_success": success,
                   "ms_per_attack": seconds / runs * 1e3, "ex_per_s": ex_s}}
    log(f"[cifar] wrn28_10 PGD-10 bf16 batch {SHAPE[0]} at 32x32, eps 8/255: "
        f"{seconds / runs * 1e3:.1f} ms an attack, {ex_s:.1f} ex/s (mean of {runs} after a "
        f"counted warm-up); launches {counts}; |x_adv - x|_inf {linf:.6f}; attack success "
        f"{success:.3f}")

    thr, cal_s, _ = _counted(lambda: calibrate_feature_threshold(ff, x, n=SHAPE[0]))
    cfg = DefenseEvalConfig(attack_name="pgd", eps=EPS, alpha=ALPHA, steps=STEPS)
    out, cell_s, counts = _counted(lambda: evaluate_defenses_batch(
        lf, ff, x, y, thr, cfg, generator_from_seed(1)))
    stats = aggregate_stats(out)
    if counts != CIFAR_CELL_LAUNCHES:
        raise AssertionError(f"WRN-28-10 cell launches {counts}, want {CIFAR_CELL_LAUNCHES}")
    _check_ball(out["x_adv"], x, EPS, "wrn28_10 cell")
    if stats["count"] != SHAPE[0] or any(not 0 <= stats[k] <= stats["count"] for k in stats):
        raise AssertionError(f"WRN-28-10 cell counters out of range: {stats}")
    with torch.no_grad():
        feats = ff(x)
    line = summary_line("pgd", EPS, stats)
    res["cell"] = {"launches": counts, "seconds": cell_s, "threshold": thr,
                   "calibrate_s": cal_s, "stats": stats, "summary_line": line,
                   "stage3_shape": list(feats.shape)}
    log(f"[cifar] wrn28_10 stage-3 detector ({list(feats.shape)} NHWC) calibrated on the "
        f"{SHAPE[0]} clean images: threshold {thr:.4f} in {cal_s * 1e3:.1f} ms; pgd -> "
        f"smoothing + quantization -> detector cell {cell_s * 1e3:.1f} ms, launches {counts}")
    log(line)
    return res


def _cifar_clis(tmp: Path) -> dict:
    """Phase 22 (d) and (e): the grid CLI with --cifar10_dir on WRN-28-10 in
    a subprocess (its launches printed by the wrapper); meanwhile, in this
    process, robust_eval --cifar10_dir on 32 of the images at cut budgets."""
    import re

    from image_recognition_adversarial_example_attack_tpu_torch.cli import robust_eval

    archive = _write_cifar_archive(tmp / "c10", CIFAR_ARCHIVE_N)
    grid_args = ["--cifar10_dir", str(archive), "--cifar10_n", str(CIFAR_ARCHIVE_N),
                 "--model", "wrn28_10", "--attacks", "fgsm", "pgd", "--eps_list", CIFAR_EPS,
                 "--model-dtype", "bfloat16", "--output_dir", str(tmp / "grid")]
    cmd = [sys.executable, "-c", LAUNCH_WRAPPER, f"{PKG}.cli.defense_experiments", *grid_args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    res = {}
    try:
        re_args = ["--cifar10_dir", str(archive), "--cifar10_n", str(CIFAR_RE_N), "--model",
                   "wrn28_10", "--eps_list", CIFAR_EPS, "--apgd_steps", "10", "--square_steps",
                   "100", "--deepfool_steps", "5", "--output", str(tmp / "re.json")]
        out, seconds, counts = _in_process_cli(robust_eval.main, re_args)
        rows = json.loads((tmp / "re.json").read_text())["results"]
        if ("clean accuracy vs CIFAR-10 test labels: " not in out or len(rows) != 1
                or rows[0]["count"] != CIFAR_RE_N or counts["uniform_noise"] != 1):
            raise AssertionError(f"robust_eval --cifar10_dir: launches {counts}, rows {rows}:\n"
                                 f"{out[-2000:]}")
        res["robust_eval"] = {"seconds": seconds, "launches": counts, "row": rows[0],
                              "lines": [ln for ln in out.splitlines()
                                        if ln.startswith(("clean accuracy", "eps="))]}
    finally:
        grid_out, grid_err = proc.communicate(timeout=600)
    grid_s = time.perf_counter() - t0
    if proc.returncode != 0 or "Using device: cuda" not in grid_out:
        raise AssertionError(f"grid CLI --cifar10_dir exit {proc.returncode}:\n"
                             f"{grid_out[-3000:]}\n{grid_err[-4000:]}")
    lines = [ln for ln in grid_out.splitlines() if ln.startswith("attack=")]
    clean = [ln for ln in grid_out.splitlines() if ln.startswith("clean accuracy vs CIFAR-10")]
    launch_line = [ln for ln in grid_out.splitlines() if ln.startswith("LAUNCHES ")]
    if (len(lines) != 2 or not all(re.match(SUMMARY_RE, ln) for ln in lines) or len(clean) != 1
            or f"Loaded CIFAR-10 test split: {CIFAR_ARCHIVE_N} images" not in grid_out
            or len(launch_line) != 1):
        raise AssertionError(f"grid CLI --cifar10_dir output:\n{grid_out[-3000:]}")
    grid_counts = json.loads(launch_line[0].split(" ", 1)[1])
    if grid_counts["pgd_step"] < STEPS or grid_counts["uniform_noise"] < 1:
        raise AssertionError(f"grid CLI --cifar10_dir launches {grid_counts}")
    res["grid_cli"] = {"seconds": grid_s, "launches": grid_counts,
                       "summary_lines": lines, "clean_line": clean[0]}
    log(f"[cifar] grid CLI --cifar10_dir ({CIFAR_ARCHIVE_N} seeded images) --model wrn28_10 "
        f"--attacks fgsm pgd --eps_list {CIFAR_EPS} --model-dtype bfloat16 in a subprocess: "
        f"exit 0 in {grid_s:.1f} s wall (process start and model init included), launches "
        f"{grid_counts}; {clean[0]}")
    for ln in lines:
        log(f"[cifar]   {ln}")
    r = res["robust_eval"]
    log(f"[cifar] robust_eval --cifar10_dir --cifar10_n {CIFAR_RE_N} (lite: apgd-10 square-100 "
        f"deepfool-5) in process beside it: {r['seconds']:.1f} s, launches {r['launches']}; "
        + " | ".join(r["lines"]))
    log("[cifar] random weights and random labels: the accuracies measure cost, not "
        "robustness")
    return res


def phase_cifar(card: str) -> dict:
    """Phase 22: the CIFAR family (WRN-28-10/34-10, PreActResNet-18, the
    robust arm) and MobileNetV2, EfficientNet-B0, ConvNeXt-T."""
    log(f"[cifar] on {card}")
    res = {"card_vs_cpu": _cifar_card_vs_cpu()}
    res["forward"], bundles = _cifar_forward_ms()
    res["wrn"] = _cifar_wrn_path(bundles["wrn28_10"])
    del bundles
    with tempfile.TemporaryDirectory() as tmp:
        res["cli"] = _cifar_clis(Path(tmp))
    return res


# phase 23: (a) PGD-AT on ResNet-50 in process, (b) the adversarial_train CLI
# on ResNet-50's defaults, (c) WRN-28-10 from scratch (TRADES, train_bn,
# crop-flip) through the CLI in process, (d) MART, free-AT, IBP and CROWN-IBP
TRAIN_B, TRAIN_PGD, TRAIN_TIMED, TRAIN_LR = 32, 7, 10, 1e-4  # the CLI's defaults
TRAIN_PNGS, TRAIN_CLASSES = 128, 4
WRN_TRAIN_B, WRN_TRAIN_N, OBJ_STEPS, FREE_REPLAYS = 128, 512, 3, 4
# card vs CPU, one float32 step of ResNet-50 at batch 2 (attack_steps 0): the
# gradient (AdamW's first moment is 0.1 x the gradient) within GRAD_REL_TOL of
# its largest entry; AdamW's first update is +-lr wherever |g| >> its eps, so
# an entry whose gradient is within float32 noise of zero may take the other
# sign: at most UPDATE_FLIP_FRAC of the entries differ by more than 1e-3 lr
GRAD_REL_TOL, UPDATE_FLIP_FRAC = 1e-4, 1e-3
# the CLI on the card: the streamed run's loss per epoch is held to the
# in-RAM run's within CLI_LOSS_REL (relative), and the streamed and resumed
# runs' parameters to the straight run's within RESUME_REL of the distance
# the straight run moved them.  scripts/train_fault_readings.py read, on an
# H100 with these data and flags: 0 for the sound runs (bit-equal), and for
# planted faults a resume replaying epoch 1's generators 6.8e-2, a resume
# without AdamW's moments 3.6e-1, a stream shuffled with another seed 1.8e-1
# (loss) and 6.2e-1 (parameters); each limit sits well below the smallest
# fault and leaves room for a last-bit difference of cuDNN's algorithms
CLI_LOSS_REL, RESUME_REL = 1e-3, 1e-3
# the training cuda tests (tests/test_torch_cuda.py), run by phase 23 in a
# subprocess: launches, the float32 CE step and calibration, augmentation,
# and every objective card vs CPU with the card's draws and iterates replayed
TRAIN_CUDA_TESTS = ("test_training_steps_on_the_card_launch_the_kernels or "
                    "test_float32_training_step_on_the_card_matches_the_cpu or "
                    "test_sharded_remat_train_bn_step_on_the_card_matches_the_cpu or "
                    "test_augmentation_on_the_card_equals_the_cpu or "
                    "test_every_objective_on_the_card_matches_the_cpu")
TRAIN_CUDA_TEST_COUNT = 15
EPOCH_LINE = (r"^epoch (\d+)/(\d+): loss=(\S+) adv_acc=(\S+) clean_acc=(\S+)"
              r"( ema_clean_acc=\S+)?( robust_acc@pgd\d+=\S+)?( verified_acc@\S+=\S+)?"
              r" \((\S+) ex/s\)$")


def _train_card_vs_cpu() -> dict:
    """One float32 PGD-AT step (attack_steps 0: the CE step alone) of
    ResNet-50 at batch 2 on the card and on the CPU from the same weights."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.train.adversarial import (
        AdvTrainConfig, make_train_step, train_state_from_bundle)

    cfg = AdvTrainConfig(attack_steps=0, learning_rate=TRAIN_LR, weight_decay=1e-4)
    rng = np.random.RandomState(5)
    x, y = rng.rand(2, 224, 224, 3).astype(np.float32), np.array([3, 7])
    out = {}
    for dev in ("cuda", "cpu"):
        bundle = load_model("resnet50", dtype=torch.float32, device=dev)
        state = train_state_from_bundle(bundle, cfg)
        new, m = make_train_step(cfg, bundle.mean, bundle.std)(
            state, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
            chunk_generator(0, "train:0", 0))
        out[dev] = ({k: v.cpu() for k, v in new.opt_state.mu.items()},
                    {k: (new.params[k] - state.params[k]).cpu() for k in new.params},
                    float(m["loss"]))
        del bundle, state, new
    (mu_g, up_g, loss_g), (mu_c, up_c, loss_c) = out["cuda"], out["cpu"]
    scale = max(float(v.abs().max()) for v in mu_c.values())
    grad_err = max(float((mu_g[k] - mu_c[k]).abs().max()) for k in mu_c) / scale
    diff = torch.cat([(up_g[k] - up_c[k]).abs().flatten() for k in up_c])
    flips = float((diff > 1e-3 * TRAIN_LR).float().mean())
    rec = {"grad_rel_err": grad_err, "update_flip_frac": flips, "loss_card": loss_g,
           "loss_cpu": loss_c, "update_max_diff": float(diff.max())}
    if grad_err > GRAD_REL_TOL or flips > UPDATE_FLIP_FRAC or abs(loss_g - loss_c) > 1e-5 * abs(
            loss_c):
        raise AssertionError(f"float32 training step, card vs CPU: {rec}")
    log(f"[train] float32 step card vs CPU (ResNet-50, batch 2, TF32 off): gradient within "
        f"{grad_err:.2e} of its largest entry (limit {GRAD_REL_TOL:g}), AdamW update: "
        f"{flips:.2e} of the entries beyond 1e-3 lr (limit {UPDATE_FLIP_FRAC:g}), loss "
        f"{loss_g:.6f} / {loss_c:.6f}")
    return rec


def _train_kernels(x) -> dict:
    """pgd_step and the noise kernel against their plain versions at the
    shape PGD-AT gives them ([TRAIN_B,224,224,3]), outside the counted run:
    pgd_step bit-exact untargeted and targeted, with sign(0) entries; the
    noise's range, mean and variance."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    shape = tuple(x.shape)
    gen = generator_from_seed(25, "cuda")
    x0 = x.contiguous()
    xa = torch.clamp(x0 + (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * EPS, 0, 1)
    grad = torch.randn(shape, generator=gen, device="cuda")
    grad.view(-1)[::7] = 0.0  # sign(0) = 0 must hold
    for a in (ALPHA, -ALPHA):
        k = ew.pgd_step(xa, grad, x0, EPS, a)
        p = ew.pgd_step_plain(xa, grad if a > 0 else -grad, x0, EPS, abs(a))
        if not torch.equal(k, p):
            raise AssertionError(f"pgd_step at {list(shape)}, alpha {a}: max|diff| "
                                 f"{float((k - p).abs().max())}")
    noise = ew.uniform_noise(shape, EPS, generator_from_seed(26), "cuda").double()
    eps32 = float(np.float32(EPS))
    mean, var = float(noise.mean()), float(noise.var())
    if not (float(noise.min()) >= -eps32 and float(noise.max()) <= eps32
            and abs(mean) < 1e-2 * EPS and abs(var / (EPS ** 2 / 3) - 1) < 2e-2):
        raise AssertionError(f"noise at {list(shape)}: range [{float(noise.min())}, "
                             f"{float(noise.max())}], mean {mean}, var {var}")
    log(f"[train] kernels at {list(shape)}: pgd_step bit-exact (alpha +-2/255, sign(0) "
        f"entries), noise in range, mean {mean:.2e}, var/(eps^2/3) "
        f"{var / (EPS ** 2 / 3):.4f}")
    return {"pgd_step": "bit-exact", "noise_mean": mean, "noise_var_ratio": var / (EPS ** 2 / 3)}


def _train_pgd_at() -> dict:
    """(a) PGD-AT on ResNet-50 bf16 at the CLI's defaults (batch 32, PGD-7,
    lr 1e-4, AdamW, frozen BatchNorm): ms a step and ex/s over 10 steps after
    one warm-up, peak memory, exactly 7 pgd_step and 1 noise launches a
    step, a profile of one step by layer; then card vs CPU."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.train.adversarial import (
        AdvTrainConfig, make_train_step, train_state_from_bundle)

    bundle = load_model("resnet50", dtype=torch.float32)
    cfg = AdvTrainConfig(eps=EPS, alpha=ALPHA, attack_steps=TRAIN_PGD, learning_rate=TRAIN_LR,
                         weight_decay=1e-4)
    state = train_state_from_bundle(bundle, cfg, torch.bfloat16)
    step = make_train_step(cfg, bundle.mean, bundle.std)
    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.rand((TRAIN_B, 224, 224, 3), generator=g, device="cuda")
    y = torch.randint(0, 1000, (TRAIN_B,), generator=g, device="cuda")
    state, _ = step(state, x, y, chunk_generator(0, "train:0", 0))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ew.reset_launches()
    losses = []
    t0 = time.perf_counter()
    for s in range(1, TRAIN_TIMED + 1):
        state, m = step(state, x, y, chunk_generator(0, "train:0", s))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ew.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"pgd_step": TRAIN_PGD * TRAIN_TIMED, "quantize": 0, "uniform_noise": TRAIN_TIMED}
    losses = [float(v) for v in losses]
    finite = all(bool(torch.isfinite(p).all()) for p in state.params.values())
    if counts != want or not finite or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"PGD-AT ResNet-50: launches {counts} (want {want}), losses "
                             f"{losses}, parameters finite {finite}")
    rec = {"ms_per_step": 1e3 * seconds / TRAIN_TIMED, "ex_per_s": TRAIN_B * TRAIN_TIMED / seconds,
           "peak_gib": peak, "launches": counts, "losses": losses,
           "grad_norm": float(m["grad_norm"]), "steps": state.step,
           "kernels": _train_kernels(x)}
    prof = profile_breakdown(lambda: step(state, x, y, chunk_generator(0, "train:0", 99)))
    rec["profile"] = prof
    log(f"[train] (a) PGD-AT ResNet-50 bf16, batch {TRAIN_B}, PGD-{TRAIN_PGD}, lr {TRAIN_LR:g}: "
        f"{rec['ms_per_step']:.1f} ms a step, {rec['ex_per_s']:.1f} ex/s over {TRAIN_TIMED} "
        f"steps after a warm-up, peak {peak:.2f} GiB; launches {counts}; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    log(f"[train]   one step profiled: wall {prof['wall_ms']:.1f} ms, card busy "
        f"{prof['busy_ms']:.1f} ms ({100 * prof['busy_share']:.1f}%), {prof['kernels']} "
        "kernels; by layer " + ", ".join(f"{k} {v:.1f}" for k, v in
                                         list(prof["by_layer_ms"].items())[:8]))
    del state, step, bundle, x
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = _train_card_vs_cpu()
    return rec


def _epoch_lines(out: str) -> list[tuple]:
    import re

    lines = [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    parsed = [re.match(EPOCH_LINE, ln) for ln in lines]
    if not lines or not all(parsed):
        raise AssertionError(f"adversarial_train epoch lines: {lines}\n{out[-2000:]}")
    return [(int(p[1]), float(p[3]), float(p[9]), ln) for p, ln in zip(parsed, lines)]


def _train_clis(tmp: Path) -> dict:
    """(b) The adversarial_train CLI on ResNet-50's defaults over 128 PNGs in
    4 class folders, 2 epochs, --eval_attack_steps 10 --ema_decay 0.999:
    in RAM, --streaming and a 1-epoch run, three subprocesses started
    together, then --resume of the 1-epoch run to 2 epochs."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import (
        build_model, load_model)

    data = tmp / "classes"
    for k in range(TRAIN_CLASSES):
        _write_pngs(data / f"class_{k}", TRAIN_PNGS // TRAIN_CLASSES, seed=30 + k)
    common = ["--data_dir", str(data), "--eval_attack_steps", "10", "--ema_decay", "0.999"]
    runs = {"in_ram": ["--epochs", "2", "--out", str(tmp / "ram.msgpack")],
            "streaming": ["--epochs", "2", "--streaming", "--out", str(tmp / "stream.msgpack")],
            "one_epoch": ["--epochs", "1", "--out", str(tmp / "resumed.msgpack")]}

    def start(args):
        cmd = [sys.executable, "-m", f"{PKG}.cli.adversarial_train", *common, *args]
        return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True), time.perf_counter()

    def finish(name, proc, t0):
        out, err = proc.communicate(timeout=900)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or "Using device: cuda" not in out:
            raise AssertionError(f"adversarial_train {name}: exit {proc.returncode}\n"
                                 f"{out[-3000:]}\n{err[-4000:]}")
        return out, seconds

    procs = {name: start(args) for name, args in runs.items()}
    res = {}
    for name, (proc, t0) in procs.items():
        out, seconds = finish(name, proc, t0)
        epochs = _epoch_lines(out)
        res[name] = {"seconds": seconds, "epochs": epochs, "lines": [e[3] for e in epochs]}
    out, seconds = finish("resume", *start(["--epochs", "2", "--resume", "--out",
                                            str(tmp / "resumed.msgpack")]))
    if "Resumed from" not in out or "continuing at epoch 2" not in out:
        raise AssertionError(f"adversarial_train --resume:\n{out[-2000:]}")
    res["resume"] = {"seconds": seconds, "epochs": _epoch_lines(out)}
    res["resume"]["lines"] = [e[3] for e in res["resume"]["epochs"]]
    ram, stream = res["in_ram"]["epochs"], res["streaming"]["epochs"]
    loss_rel = max(abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(ram, stream))
    if ([e[0] for e in ram] != [1, 2] or [e[0] for e in stream] != [1, 2]
            or loss_rel > CLI_LOSS_REL or [e[0] for e in res["resume"]["epochs"]] != [2]):
        raise AssertionError(f"adversarial_train: in RAM {ram}, streamed {stream}, resumed "
                             f"{res['resume']['epochs']}")
    # the resumed run's state against the straight run's, from the .ckpt files
    init = load_model("resnet50", dtype=torch.float32, device="cpu").model.state_dict()
    # and the streamed run's, from the .ckpt files
    a = torch.load(tmp / "ram.msgpack.ckpt", weights_only=True)
    b = torch.load(tmp / "resumed.msgpack.ckpt", weights_only=True)
    st = torch.load(tmp / "stream.msgpack.ckpt", weights_only=True)
    moved = math.sqrt(sum(float(((a["params"][k] - init[k]) ** 2).sum()) for k in a["params"]))
    apart, stream_apart = (math.sqrt(sum(float(((a["params"][k] - c["params"][k]) ** 2).sum())
                                         for k in a["params"])) for c in (b, st))
    if (a["step"] != 8 or b["step"] != 8 or st["step"] != 8 or apart > RESUME_REL * moved
            or stream_apart > RESUME_REL * moved):
        raise AssertionError(f"--resume: steps {a['step']} / {b['step']} / {st['step']}, "
                             f"parameters apart {apart:.3e} (resumed), {stream_apart:.3e} "
                             f"(streamed) of a move of {moved:.3e}")
    # the export (EMA) reloads through load_model to the logits of the
    # .ckpt's EMA parameters in memory
    model = build_model("resnet50")
    model.load_state_dict({**a["ema_params"], **a["extra_variables"]}, strict=True)
    model = model.cuda().to(memory_format=torch.channels_last).eval()
    loaded = load_model("resnet50", dtype=torch.float32, weights=tmp / "ram.msgpack")
    xs = torch.from_numpy(np.random.RandomState(3).rand(4, 3, 224, 224).astype(np.float32)
                          ).cuda().to(memory_format=torch.channels_last)
    with torch.no_grad():
        want, got = model(xs), loaded.model(xs)
    logit_err = float((got - want).abs().max() / want.abs().max())
    if loaded.source != "cache" or logit_err > F32_REL_TOL:
        raise AssertionError(f"the exported msgpack: source {loaded.source}, logits "
                             f"{logit_err:.2e} from the EMA parameters'")
    res.update({"stream_loss_rel": loss_rel, "resume_apart": apart, "resume_moved": moved,
                "stream_apart": stream_apart, "export_logit_rel": logit_err})
    for k in ("in_ram", "streaming", "one_epoch", "resume"):
        res[k]["epochs"] = [list(e) for e in res[k]["epochs"]]
    log(f"[train] (b) adversarial_train CLI, ResNet-50 defaults (batch {TRAIN_B}, PGD-"
        f"{TRAIN_PGD}, bf16), {TRAIN_PNGS} PNGs in {TRAIN_CLASSES} classes, 2 epochs, "
        "--eval_attack_steps 10 --ema_decay 0.999, three subprocesses started together: "
        + ", ".join(f"{k} {res[k]['seconds']:.1f} s" for k in ("in_ram", "streaming",
                                                                "one_epoch", "resume")))
    for k in ("in_ram", "streaming", "resume"):
        for ln in res[k]["lines"]:
            log(f"[train]   {k}: {ln}")
    log(f"[train]   streamed loss within {loss_rel:.2e} of the in-RAM run's (limit "
        f"{CLI_LOSS_REL:g}); resumed parameters {apart:.3e} from the straight run's, "
        f"{apart / moved:.2e} of their move {moved:.3e}, streamed "
        f"{stream_apart / moved:.2e} (limit {RESUME_REL:g}); the export "
        f"reloads to logits within {logit_err:.1e} of the EMA parameters'")
    return res


def _train_wrn_cli(tmp: Path) -> dict:
    """(c) WRN-28-10 from scratch: TRADES, --train_bn, --augment crop-flip,
    batch 128 on a 512-image archive, 1 epoch, through the CLI in this
    process (7 pgd_step launches a step, no noise); precise-BN calibration
    moves the running statistics; the export loads and runs."""
    import pickle

    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli import adversarial_train
    from image_recognition_adversarial_example_attack_tpu_torch.models.flax_msgpack import (
        read_variables)
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model

    root = tmp / "c10"
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    rng = np.random.RandomState(23)
    with open(d / "data_batch_1", "wb") as f:
        pickle.dump({b"data": rng.randint(0, 256, (WRN_TRAIN_N, 3072)).astype(np.uint8),
                     b"labels": rng.randint(0, 10, WRN_TRAIN_N).tolist()}, f)
    out_path = tmp / "wrn.msgpack"
    out, seconds, counts = _in_process_cli(adversarial_train.main, [
        "--cifar10_dir", str(root), "--model", "wrn28_10", "--train_bn", "--augment",
        "crop-flip", "--objective", "trades", "--batch_size", str(WRN_TRAIN_B), "--epochs", "1",
        "--out", str(out_path)])
    steps = WRN_TRAIN_N // WRN_TRAIN_B
    want = {"pgd_step": TRAIN_PGD * steps, "quantize": 0, "uniform_noise": 0}
    stats = read_variables(out_path)["batch_stats"]
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else None
        if "mean" in t:
            leaves.append((float(np.abs(np.asarray(t["mean"])).max()),
                           float(np.abs(np.asarray(t["var"]) - 1.0).max())))

    walk(stats)
    moved = min(max(m, v) for m, v in leaves)
    bundle = load_model("wrn28_10", dtype=torch.bfloat16, weights=out_path)
    xs = torch.rand((8, 3, 32, 32), device="cuda").to(memory_format=torch.channels_last)
    with torch.no_grad():
        logits = bundle.model(xs.to(torch.bfloat16)).float()
    lines = _epoch_lines(out)
    if (counts != want or "precise-BN sweep" not in out or len(leaves) != 25 or moved < 1e-3
            or not bool(torch.isfinite(logits).all()) or len(lines) != 1):
        raise AssertionError(f"WRN-28-10 TRADES --train_bn: launches {counts} (want {want}), "
                             f"{len(leaves)} BatchNorms, least move {moved}:\n{out[-2000:]}")
    rec = {"seconds": seconds, "launches": counts, "line": lines[0][3],
           "ex_per_s": lines[0][2], "bn_layers": len(leaves), "least_stat_move": moved}
    log(f"[train] (c) adversarial_train --model wrn28_10 --train_bn --augment crop-flip "
        f"--objective trades, batch {WRN_TRAIN_B}, {WRN_TRAIN_N} images, 1 epoch (in process): "
        f"{seconds:.1f} s; launches {counts} ({TRAIN_PGD} pgd_step a step); precise-BN moved "
        f"all {len(leaves)} layers' running statistics (least {moved:.3f}); the export loads")
    log(f"[train]   {lines[0][3]}")
    return rec


def _train_objectives() -> dict:
    """(d) MART and free-AT on WRN-28-10 bf16 (train_bn, from scratch), IBP
    and CROWN-IBP on ibp_cnn7 float32, batch 128, lr 1e-4, 3 steps each in
    process, their losses and launches
    (MART 7 pgd_step and 1 noise a step; free none; the bounds none); the
    certified objectives ramp eps over 2 steps, so their third step reports
    the verified accuracy at the full eps."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.train.adversarial import (
        AdvTrainConfig, make_free_step, make_ibp_step, make_mart_step, train_state_from_bundle)

    g = torch.Generator(device="cuda").manual_seed(24)
    x = torch.rand((WRN_TRAIN_B, 32, 32, 3), generator=g, device="cuda")
    y = torch.randint(0, 10, (WRN_TRAIN_B,), generator=g, device="cuda")
    res = {}
    for name in ("mart", "free", "ibp", "crown-ibp"):
        certified = name in ("ibp", "crown-ibp")
        cfg = AdvTrainConfig(eps=EPS, alpha=ALPHA, attack_steps=TRAIN_PGD,
                             learning_rate=TRAIN_LR, free_replays=FREE_REPLAYS,
                             train_bn=not certified, ibp_ramp_steps=2 if certified else 0,
                             ibp_bound="crown" if name == "crown-ibp" else "ibp")
        bundle = load_model("ibp_cnn7" if certified else "wrn28_10", dtype=torch.float32)
        state = train_state_from_bundle(bundle, cfg,
                                        torch.float32 if certified else torch.bfloat16)
        if name == "mart":
            step = make_mart_step(cfg, bundle.mean, bundle.std)
        elif name == "free":
            free = make_free_step(cfg, bundle.mean, bundle.std)
            delta = torch.zeros_like(x)

            def step(st, xx, yy, gen):
                nonlocal delta
                st, m, delta = free(st, xx, yy, gen, delta)
                return st, m
        else:
            step = make_ibp_step(cfg, bundle.model.spec, bundle.mean, bundle.std)
        torch.cuda.synchronize()
        ew.reset_launches()
        t0 = time.perf_counter()
        metrics = []
        for s in range(OBJ_STEPS):
            state, m = step(state, x, y, chunk_generator(0, f"{name}:0", s))
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ew.launch_counts()
        want = {"pgd_step": TRAIN_PGD * OBJ_STEPS if name == "mart" else 0, "quantize": 0,
                "uniform_noise": OBJ_STEPS if name == "mart" else 0}
        if counts != want or not all(math.isfinite(m["loss"]) for m in metrics):
            raise AssertionError(f"{name}: launches {counts} (want {want}), metrics {metrics}")
        rec = {"seconds": seconds, "ms_per_step": 1e3 * seconds / OBJ_STEPS,
               "launches": counts, "metrics": metrics, "steps": state.step}
        note = ""
        if certified:
            last = metrics[-1]
            note = (f"; verified accuracy {last['adv_accuracy']:.3f} at the ramp's eps "
                    f"{last['ibp_eps']:.5f}, clean {last['clean_accuracy']:.3f}")
        log(f"[train] (d) {name} ({'ibp_cnn7 float32' if certified else 'WRN-28-10 bf16 train_bn'}, "
            f"batch {WRN_TRAIN_B}): {rec['ms_per_step']:.1f} ms a step"
            f"{f' ({FREE_REPLAYS} updates each)' if name == 'free' else ''}; losses "
            + " ".join(f"{m['loss']:.4f}" for m in metrics) + f"; launches {counts}{note}")
        res[name] = rec
        del state, bundle
        torch.cuda.empty_cache()
    return res


def phase_train() -> dict:
    """Phase 23: adversarial and certified training."""
    res = {"a": _train_pgd_at()}
    # the training cuda tests run beside (b), whose host-bound subprocesses
    # leave the card idle most of the time
    tests = _start_cuda_tests(TRAIN_CUDA_TESTS)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        try:
            res["b"] = _train_clis(tmp)
        finally:
            res["cuda_tests"] = _finish_cuda_tests("train", tests, TRAIN_CUDA_TEST_COUNT)
        res["c"] = _train_wrn_cli(tmp)
    res["d"] = _train_objectives()
    return res


# phase 24: serving.  (a) the serve CLI in file mode at batch 8 and 128
# (and 128 with --overlap), (b) its HTTP front end under 8 client threads,
# (c) SIGTERM while streaming on stdin, (d) the service function card vs CPU,
# quantize at the serving shapes and the counted run in process, (e)
# import_weights and the zoo's msgpack cache
SERVE_N, SERVE_F32_N, SERVE_COUNTED_N = 256, 8, 64
SERVE_FLAGS = ("--defend", "--detector", "squeezing", "--detector_threshold", "0.5")
SERVE_RUNS = {"batch 8": ("--batch", "8"), "batch 128": ("--batch", "128"),
              "batch 128 --overlap": ("--batch", "128", "--overlap")}
HTTP_CLIENTS, HTTP_POSTS = 8, 16
# the model and device the subprocesses and the in-process runs serve: the
# CLI's defaults on the card (ResNet-50, bf16)
SERVE_MODEL, SERVE_DEV, SERVE_CLI_EXTRA = "resnet50", "cuda", ()
# the service card vs CPU in float32: probabilities and scores, relative to
# max(1, |value|) (F32_REL_TOL's reading), and the defended logits' top-2
# margin below which the defended top-1 may differ (printed)
SERVE_TOL = 1e-5
# the overlap run against the sequential one at batch 128: equal top-1s,
# scores within this
OVERLAP_SCORE_TOL = 1e-6


def _serve_launches(chunks: int) -> dict:
    """--defend and --detector squeezing launch one quantize each a service
    call: every chunk served and the warm-up."""
    return {"pgd_step": 0, "quantize": 2 * (chunks + 1), "uniform_noise": 0}


def _start_serve(tmp: Path, tag: str, *args: str, stdin: bool = False):
    """The serve CLI under LAUNCH_WRAPPER (its launches print last), its
    stderr to a file."""
    cmd = [sys.executable, "-c", LAUNCH_WRAPPER, f"{PKG}.cli.serve", *SERVE_CLI_EXTRA, *args]
    err = open(tmp / f"{tag}.err", "w")
    proc = subprocess.Popen(cmd, cwd=REPO, stdin=subprocess.PIPE if stdin else subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    return proc, time.perf_counter(), tag


def _read_ready(started, tmp: Path) -> dict:
    proc, t0, tag = started
    line = proc.stdout.readline()
    if not line.startswith("{"):
        proc.kill()
        raise AssertionError(f"serve {tag}: no ready line ({line!r}):\n"
                             f"{(tmp / f'{tag}.err').read_text()[-4000:]}")
    ready = json.loads(line)
    want_dev = "cpu" if SERVE_DEV == "cpu" else "cuda:0"
    if not (ready.get("ready") is True and ready["sharded"] is False
            and ready["device"] == want_dev):
        proc.kill()
        raise AssertionError(f"serve {tag}: ready line {ready}")
    ready["startup_s"] = time.perf_counter() - t0
    return ready


def _finish_serve(started, tmp: Path) -> tuple[list[dict], dict]:
    """Read the rest of the protocol with arrival times; wait for exit 0;
    -> (the JSON lines, each with its arrival "t"), the launches."""
    proc, _, tag = started
    rows, launches = [], None
    for line in proc.stdout:
        t = time.perf_counter()
        if line.startswith("LAUNCHES "):
            launches = json.loads(line[len("LAUNCHES "):])
        elif line.strip():
            rows.append({**json.loads(line), "t": t})
    code = proc.wait(timeout=600)
    if code != 0 or launches is None:
        raise AssertionError(f"serve {tag}: exit {code}, launches {launches}:\n"
                             f"{(tmp / f'{tag}.err').read_text()[-4000:]}")
    return rows, launches


def _write_fifo(path: Path, text: str, timeout: float = 120.0) -> None:
    """Write ``text`` to a FIFO once its reader has opened it (a reader that
    never comes raises instead of blocking forever)."""
    import errno

    deadline = time.monotonic() + timeout
    while True:
        try:
            fd = os.open(path, os.O_WRONLY | os.O_NONBLOCK)
            break
        except OSError as e:
            if e.errno != errno.ENXIO or time.monotonic() > deadline:
                raise
            time.sleep(0.01)
    os.set_blocking(fd, True)
    with os.fdopen(fd, "w") as f:
        f.write(text)


def _pct(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def _serve_file_runs(started: dict, fifos: dict, lines: list[str], tmp: Path) -> dict:
    """(a) Each file-mode process in turn: its request file is a FIFO, so the
    process has warmed up and printed its ready line before the parent writes
    the requests; requests/s from that write to the last response."""
    res = {}
    for name, st in started.items():
        ready = _read_ready(st, tmp)
        t_write = time.perf_counter()
        _write_fifo(fifos[name], "".join(f"{ln}\n" for ln in lines))
        rows, launches = _finish_serve(st, tmp)
        ok = [r for r in rows if "error" not in r]
        bad = [r for r in rows if "error" in r]
        batch = int(SERVE_RUNS[name][1])
        want = _serve_launches(-(-len(ok) // batch))
        if (len(ok) != SERVE_N or len(bad) != 1 or not bad[0]["path"].endswith("missing.png")
                or [r["path"] for r in rows] != lines or launches != want
                or ready["batch"] != batch):
            raise AssertionError(f"serve {name}: {len(ok)} ok, errors {bad}, launches "
                                 f"{launches} (want {want}), ready {ready}")
        for r in ok:
            if not (len(r["topk"]) == 5 and 0.0 <= r["prob"] <= 1.0 and r["latency_ms"] > 0
                    and "defended_top1" in r and "detector_flag" in r
                    and math.isfinite(r["detector_score"]) and r["batch_size"] == batch):
                raise AssertionError(f"serve {name}: response {r}")
        span = max(r["t"] for r in rows) - t_write
        lat = [r["latency_ms"] for r in ok]
        res[name] = {"startup_s": ready["startup_s"], "seconds": span,
                     "requests_per_s": len(ok) / span, "latency_ms_p50": _pct(lat, 50),
                     "latency_ms_p99": _pct(lat, 99), "decode_ms": ok[0]["decode_ms"],
                     "launches": launches,
                     "top1": [r["top1"] for r in ok], "score": [r["detector_score"] for r in ok]}
        log(f"[serve] file mode {name} ({SERVE_N} PNGs + 1 missing, {' '.join(SERVE_FLAGS)}): "
            f"ready after {ready['startup_s']:.1f} s; {res[name]['requests_per_s']:.1f} "
            f"requests/s after the ready line ({span:.2f} s); latency_ms p50 "
            f"{res[name]['latency_ms_p50']:.2f}, p99 {res[name]['latency_ms_p99']:.2f}; "
            f"decode_ms {res[name]['decode_ms']:.1f} (the drain); launches {launches}")
    seq, ovl = res["batch 128"], res["batch 128 --overlap"]
    score_diff = max(abs(a - b) for a, b in zip(seq["score"], ovl["score"]))
    if seq["top1"] != ovl["top1"] or score_diff > OVERLAP_SCORE_TOL:
        raise AssertionError(f"serve --overlap vs sequential at batch 128: top-1s equal "
                             f"{seq['top1'] == ovl['top1']}, scores {score_diff:.3e} apart")
    log(f"[serve] --overlap at batch 128: top-1s equal to the sequential run's, scores "
        f"{score_diff:.3e} apart (limit {OVERLAP_SCORE_TOL:g})")
    return res


def _serve_drain(started, paths: list[Path], tmp: Path) -> dict:
    """(c) The line protocol on stdin: 8 requests answered in lockstep, then 8
    more and SIGTERM at once: the drained requests answered, the shutdown
    line last, exit 0."""
    import signal

    proc, _, tag = started
    _read_ready(started, tmp)
    for p in paths[:8]:
        proc.stdin.write(f"{p}\n")
        proc.stdin.flush()
        r = json.loads(proc.stdout.readline())
        if "error" in r or r["request_count"] != 1:
            raise AssertionError(f"serve {tag}: lockstep response {r}")
    proc.stdin.write("".join(f"{p}\n" for p in paths[8:16]))
    proc.stdin.flush()
    proc.send_signal(signal.SIGTERM)
    rows, launches = _finish_serve(started, tmp)
    served = [r for r in rows if "top1" in r]
    drains, i = 0, 0  # each drain of at most 8 requests is one chunk
    while i < len(served):
        i, drains = i + served[i]["request_count"], drains + 1
    last = {k: v for k, v in rows[-1].items() if k != "t"}
    want = _serve_launches(8 + drains)
    if (last != {"shutdown": True, "signal": int(signal.SIGTERM)}
            or len(served) + 1 != len(rows) or len(served) > 8 or launches != want):
        raise AssertionError(f"serve {tag}: after SIGTERM {rows}, launches {launches} "
                             f"(want {want})")
    log(f"[serve] SIGTERM while streaming on stdin: {len(served)} of the 8 requests in flight "
        f"answered, then the shutdown line; exit 0")
    return {"answered_after_signal": len(served), "launches": launches}


def _serve_http_load(started, pngs: list[Path], tmp: Path) -> dict:
    """(b) 8 client threads x 16 POSTs, paths and image_b64 in turn, one bad
    body; /metrics; SIGTERM drains."""
    import base64
    import signal
    import threading
    import urllib.error
    import urllib.request

    proc, _, tag = started
    ready = _read_ready(started, tmp)
    url = f"http://{ready['http']['host']}:{ready['http']['port']}"
    n_req = HTTP_CLIENTS * HTTP_POSTS
    bodies = []
    for i, p in enumerate(pngs[:n_req]):
        body = ({"path": str(p)} if i % 2 == 0
                else {"image_b64": base64.b64encode(p.read_bytes()).decode()})
        bodies.append(json.dumps(body).encode())
    bodies[HTTP_POSTS - 1] = b"{not json"  # client 0's last post
    results: dict = {}

    def client(c: int) -> None:
        for i in range(c * HTTP_POSTS, (c + 1) * HTTP_POSTS):
            req = urllib.request.Request(url + "/classify", data=bodies[i], method="POST",
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    results[i] = (r.status, json.loads(r.read()), time.perf_counter() - t)
            except urllib.error.HTTPError as e:
                results[i] = (e.code, None, time.perf_counter() - t)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(HTTP_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    span = time.perf_counter() - t0
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        metrics = {ln.split()[0]: float(ln.split()[1])
                   for ln in r.read().decode().splitlines() if ln and not ln.startswith("#")}
    good = [i for i in range(n_req) if i != HTTP_POSTS - 1]
    bad_ok = results.get(HTTP_POSTS - 1, (None,))[0] == 400
    errors = [results.get(i) for i in good
              if i not in results or results[i][0] != 200
              or "error" in results[i][1]["results"][0]]
    if any(t.is_alive() for t in threads) or errors or not bad_ok:
        proc.kill()
        raise AssertionError(f"serve {tag}: bad body 400 {bad_ok}; failed {errors[:3]}")
    if not (metrics["serve_images_total"] == len(good)
            and metrics["serve_batches_total"] < len(good)
            and metrics["serve_errors_total"] == 0
            and metrics["serve_decode_errors_total"] == 0
            and metrics["serve_batch_capacity"] == ready["batch"]):
        proc.kill()
        raise AssertionError(f"serve {tag}: /metrics {metrics}")
    proc.send_signal(signal.SIGTERM)
    rows, launches = _finish_serve(started, tmp)
    want = _serve_launches(int(metrics["serve_batches_total"]))
    if rows[-1]["shutdown"] is not True or launches != want:
        raise AssertionError(f"serve {tag}: last line {rows[-1]}, launches {launches} "
                             f"(want {want})")
    lat_ms = [results[i][2] * 1e3 for i in good]
    per = [results[i][1]["results"][0]["request_count"] for i in good]
    res = {"startup_s": ready["startup_s"], "seconds": span, "requests": len(good),
           "requests_per_s": len(good) / span, "client_ms_p50": _pct(lat_ms, 50),
           "client_ms_p99": _pct(lat_ms, 99), "metrics": metrics, "launches": launches,
           "requests_per_batch": len(good) / metrics["serve_batches_total"],
           "request_count_max": max(per)}
    log(f"[serve] HTTP --http 0, {HTTP_CLIENTS} clients x {HTTP_POSTS} POSTs (paths and "
        f"image_b64, one bad body -> 400): {res['requests_per_s']:.1f} requests/s; client ms "
        f"p50 {res['client_ms_p50']:.1f}, p99 {res['client_ms_p99']:.1f}; /metrics "
        f"serve_batches_total {metrics['serve_batches_total']:.0f} for "
        f"{metrics['serve_images_total']:.0f} images ({res['requests_per_batch']:.2f} a batch, "
        f"device ms {metrics['serve_device_ms_sum']:.1f}); SIGTERM: shutdown line, exit 0; "
        f"launches {launches}")
    return res


def _serve_card_vs_cpu(pngs: list[Path]) -> dict:
    """(d) The service function in float32 on the card against the CPU on
    SERVE_F32_N PNGs (--defend --detector squeezing, and --detector
    feature); quantize bit-exact at the serving shapes."""
    import argparse
    import copy
    import dataclasses

    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli import serve
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.images import load_image_batch
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import generator_from_seed
    from image_recognition_adversarial_example_attack_tpu_torch.defenses.preprocess import (
        defend_input, defense_smoothing)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    cpu = load_model(SERVE_MODEL, dtype=torch.float32, device="cpu")
    card = dataclasses.replace(cpu, model=copy.deepcopy(cpu.model).to(SERVE_DEV),
                               device=torch.device(SERVE_DEV))
    x = torch.from_numpy(load_image_batch(pngs[:SERVE_F32_N]))
    res: dict = {}
    for mode, (defend, detector) in {"defend+squeezing": (True, "squeezing"),
                                     "feature": (False, "feature")}.items():
        args = argparse.Namespace(defend=defend, detector=detector, transfer_uint8=False)
        on_card = serve._device_get(serve._make_service_fn(*make_fns(card), args)(
            x.to(SERVE_DEV)))
        on_cpu = serve._device_get(serve._make_service_fn(*make_fns(cpu), args)(x))
        diffs = {k: float(max(abs(a - b) / max(1.0, abs(b)) for a, b in
                              zip(on_card[k].ravel().tolist(), on_cpu[k].ravel().tolist())))
                 for k in ("probs", "score")}
        if max(diffs.values()) > SERVE_TOL:
            raise AssertionError(f"serve card vs CPU {mode}: {diffs} (limit {SERVE_TOL:g})")
        rec = {"max_rel_diff": diffs}
        if defend:
            with torch.no_grad():
                lg = make_fns(cpu)[0](defend_input(x)).sort(dim=-1).values
            margin = (lg[:, -1] - lg[:, -2]).tolist()
            differ = [i for i in range(SERVE_F32_N)
                      if on_card["defended_pred"][i] != on_cpu["defended_pred"][i]]
            near = [i for i in differ if margin[i] <= SERVE_TOL * max(1.0, abs(float(lg[i, -1])))]
            if differ != near:
                raise AssertionError(f"serve card vs CPU: defended top-1 differs at {differ}, "
                                     f"margins {margin}")
            rec.update({"defended_differ": differ, "defended_margin_min": min(margin)})
        res[mode] = rec
        log(f"[serve] service card vs CPU, float32, {SERVE_F32_N} PNGs, {mode}: probabilities "
            f"{diffs['probs']:.2e}, scores {diffs['score']:.2e} apart (limit {SERVE_TOL:g})"
            + ("" if not defend else f"; defended top-1 equal but at near-ties "
               f"{rec['defended_differ']} (smallest margin {rec['defended_margin_min']:.3e})"))

    if SERVE_DEV == "cuda":  # the kernel against its plain version, outside the counted run
        for b in (8, SHAPE[0]):
            shape = (b, 224, 224, 3)
            xq = torch.rand(shape, generator=generator_from_seed(24 + b, "cuda"), device="cuda")
            xq = defense_smoothing(xq * 1.2 - 0.1)  # what --defend quantizes, out of range too
            ties = (torch.arange(xq.numel() // 13, device="cuda") % (LEVELS - 1)).float()
            xq.view(-1)[::13][:ties.numel()] = (ties + 0.5) / (LEVELS - 1)
            if not torch.equal(ew.quantize(xq, LEVELS), ew.quantize_plain(xq, LEVELS)):
                raise AssertionError(f"quantize at {list(shape)} differs from its plain version")
            res[f"quantize {list(shape)}"] = "bit-exact"
        log("[serve] quantize at [8,224,224,3] and [128,224,224,3]: bit-exact with ties and "
            "values outside [0,1]")
    return res


def _serve_counted(pngs: list[Path], tmp: Path) -> dict:
    """(d) The serve CLI's main in this process, file mode at --batch 8 on
    SERVE_COUNTED_N PNGs and a missing path: exactly 2 x (chunks + 1)
    quantize launches (the counted run of the kernels line)."""
    import contextlib
    import io
    import signal

    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli import serve
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    req = tmp / "counted.txt"
    req.write_text("".join(f"{p}\n" for p in pngs[:SERVE_COUNTED_N]) + f"{tmp}/missing.png\n")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    buf = io.StringIO()
    ew.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            code = serve.main([*SERVE_CLI_EXTRA, "--batch", "8", *SERVE_FLAGS,
                               "--input", str(req)])
        if SERVE_DEV == "cuda":
            torch.cuda.synchronize()
    finally:
        for s, h in handlers.items():  # main() installs its own
            signal.signal(s, h)
    seconds = time.perf_counter() - t0
    launches = ew.launch_counts()
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    ok = [r for r in rows[1:] if "error" not in r]
    want = _serve_launches(SERVE_COUNTED_N // 8)
    if (code != 0 or len(ok) != SERVE_COUNTED_N or len(rows) != SERVE_COUNTED_N + 2
            or launches != want):
        raise AssertionError(f"serve main in process: exit {code}, {len(ok)} ok of "
                             f"{len(rows) - 1}, launches {launches} (want {want})")
    log(f"[serve] the CLI's main in process, file mode, --batch 8 {' '.join(SERVE_FLAGS)} on "
        f"{SERVE_COUNTED_N} PNGs + 1 missing: {seconds:.1f} s with its warm-up; launches "
        f"{launches} = 2 x ({SERVE_COUNTED_N // 8} chunks + 1 warm-up) quantize")
    return {"seconds": seconds, "launches": launches}


def _import_weights_start(tmp: Path):
    """(e) A float32 ResNet-50 .pth from the seeded random init, and the
    import_weights CLI on it with --verify, started."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.models import zoo

    sd = zoo.random_init_(zoo.build_model(SERVE_MODEL)).state_dict()
    pth = tmp / f"{SERVE_MODEL}.pth"
    torch.save(sd, pth)
    out = tmp / "imported.msgpack"
    cmd = [sys.executable, "-m", f"{PKG}.cli.import_weights", SERVE_MODEL, str(pth), "--out",
           str(out), "--verify", *(["--device", "cpu"] if SERVE_DEV == "cpu" else [])]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return {"proc": proc, "t0": time.perf_counter(), "sd": sd, "pth": pth, "out": out}


def _import_weights_finish(st: dict, tmp: Path) -> dict:
    """(e) The CLI's lines; the file reloaded through the zoo bit-equal to
    the .pth; a weights dir holding only the .pth gets its .msgpack (the
    import's bytes) and the second load says source="cache"."""
    import re

    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import make_logits_fn
    from image_recognition_adversarial_example_attack_tpu_torch.models import load_model

    out, err = st["proc"].communicate(timeout=600)
    seconds = time.perf_counter() - st["t0"]
    lines = out.strip().splitlines()
    verify = [(int(i), float(q)) for i, q in re.findall(r"\((\d+), ([0-9.e-]+)\)", lines[-1])]
    if (st["proc"].returncode != 0 or lines[0] != f"converted {st['pth']} -> {st['out']}"
            or not lines[-1].startswith("verify: top-5 on a white image: ") or len(verify) != 5):
        raise AssertionError(f"import_weights exit {st['proc'].returncode}:\n{out}\n{err[-3000:]}")

    def same(bundle) -> bool:
        got = bundle.model.state_dict()
        return set(got) == set(st["sd"]) and all(torch.equal(got[k].cpu(), st["sd"][k])
                                                 for k in got)

    t0 = time.perf_counter()
    b = load_model(SERVE_MODEL, dtype=torch.float32, weights=st["out"], device=SERVE_DEV)
    load_s = time.perf_counter() - t0
    if b.source != "cache" or not same(b):
        raise AssertionError(f"the imported msgpack: source {b.source}, tensors bit-equal "
                             f"{same(b)}")
    with torch.no_grad():
        x = torch.ones((1, 224, 224, 3), device=SERVE_DEV)
        probs = torch.softmax(make_logits_fn(b.model, b.mean, b.std)(x), -1)[0].cpu().numpy()
    top5 = np.argsort(-probs)[:5]
    if any(abs(q - float(probs[i])) > 1e-4 for i, q in verify):
        raise AssertionError(f"--verify printed {verify}; this process reads "
                             f"{[(int(i), float(probs[i])) for i in top5]}")
    wdir = tmp / "weights"
    wdir.mkdir()
    (wdir / f"{SERVE_MODEL}.pth").symlink_to(st["pth"])
    saved = os.environ.get("ADV_TPU_WEIGHTS_DIR")
    os.environ["ADV_TPU_WEIGHTS_DIR"] = str(wdir)
    try:
        t0 = time.perf_counter()
        first = load_model(SERVE_MODEL, dtype=torch.float32, device=SERVE_DEV)
        convert_s = time.perf_counter() - t0
        cache = wdir / f"{SERVE_MODEL}.msgpack"
        written = cache.is_file() and cache.read_bytes() == st["out"].read_bytes()
        t0 = time.perf_counter()
        second = load_model(SERVE_MODEL, dtype=torch.float32, device=SERVE_DEV)
        cache_s = time.perf_counter() - t0
    finally:
        if saved is None:
            del os.environ["ADV_TPU_WEIGHTS_DIR"]
        else:
            os.environ["ADV_TPU_WEIGHTS_DIR"] = saved
    if not (first.source == "converted" and written and second.source == "cache"
            and same(first) and same(second)):
        raise AssertionError(f"the zoo's cache: sources {first.source} / {second.source}, the "
                             f"import's bytes written {written}")
    res = {"cli_s": seconds, "reload_s": load_s, "convert_and_cache_s": convert_s,
           "cache_load_s": cache_s, "verify": verify}
    log(f"[serve] import_weights {SERVE_MODEL} float32 .pth -> msgpack --verify (subprocess): "
        f"exit 0 in {seconds:.1f} s; {lines[-1]}; reloaded through the zoo in {load_s:.2f} s, "
        f"every tensor bit-equal to the .pth; a weights dir with only the .pth: 'converted' in "
        f"{convert_s:.2f} s writing the import's bytes, then 'cache' in {cache_s:.2f} s")
    return res


def phase_serve(pngs: list[Path]) -> dict:
    """Phase 24: serving and weight import."""
    res: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lines = [str(p) for p in pngs[:SERVE_N // 2]] + [str(tmp / "missing.png")] + [
            str(p) for p in pngs[SERVE_N // 2:SERVE_N]]
        # every process starts at once; each then waits (on its FIFO, stdin or
        # socket) until the parent drives it, one at a time
        fifos, started = {}, {}
        for i, (name, args) in enumerate(SERVE_RUNS.items()):
            fifos[name] = tmp / f"requests{i}"
            os.mkfifo(fifos[name])
            started[name] = _start_serve(tmp, f"file{i}", *args, *SERVE_FLAGS, "--input",
                                         str(fifos[name]))
        http = _start_serve(tmp, "http", "--http", "0", *SERVE_FLAGS)
        drain = _start_serve(tmp, "drain", "--batch", "8", *SERVE_FLAGS, stdin=True)
        imported = _import_weights_start(tmp)
        try:
            res["d"] = _serve_card_vs_cpu(pngs)
            res["d"]["counted"] = _serve_counted(pngs, tmp)
            res["e"] = _import_weights_finish(imported, tmp)
            res["a"] = _serve_file_runs(started, fifos, lines, tmp)
            res["c"] = _serve_drain(drain, pngs, tmp)
            res["b"] = _serve_http_load(http, pngs, tmp)
        finally:
            for proc in [st[0] for st in started.values()] + [http[0], drain[0],
                                                             imported["proc"]]:
                proc.kill()
                proc.wait()
    return res


# phase 25: scale-out.  (a) in a subprocess joined through the env contract
# (NCCL, world size 1): the grid's pgd cell on ResNet-50 bf16 at
# [128,224,224,3] over a data mesh of two slots on the one card, each 64-row
# shard bit-equal to a one-device run on its rows; (b) two ranks on the one
# card over gloo: one PGD-AT step and FGSM counters against one process; (c)
# tensor parallelism over a 1x2 mesh on the card: ViT-B/16 and ResNet-50 in
# float32; (d) entry.dryrun_multichip(4)
SO_B, SO_SLOTS, SO_TRAIN_B, SO_RANKS, SO_VIT_B, SO_TIMED = 128, 2, 32, 2, 32, 3
# TP against the replicated model, float32 with TF32 off: numpy's
# assert_allclose(atol, rtol), as JAX's tests/test_sharding.py holds them
TP_LOGITS_TOL, TP_PGD_ATOL, TP_PGD_RTOL, TP_PGD_STEPS = 1e-4, 2e-5, 1e-5, 3
# PGD's sign(): a gradient entry within float32 reassociation of zero can take
# the other sign under TP, and its pixel then moves by 2 alpha.  At 4.8 M
# pixels some do (66 on an NVIDIA H100 80GB HBM3 at 700 W): every other pixel stays
# within 2e-5, and at most this share of the pixels may flip, each by no more
# than one alpha a step
TP_PGD_FLIP_SHARE = 1e-4
# the two-rank PGD-AT step against the one-process step
# (scripts/scaleout_fault_readings.py, NVIDIA H100 80GB HBM3 at 700 W): the parameters
# |two - one| / |one - init| (Euclidean) read 0.384 on sound runs, because
# AdamW's first update is +-lr on every entry and bf16 forwards at batch 16
# and 32 flip the sign of the near-zero gradient entries; planted faults
# read 0.425 (each rank's start from the first rows), 0.829 (no sum over the
# ranks) and 0.831 (both ranks on the same rows).  The summed gradient (the
# first moment, |two - one| / |one|) reads 2.79e-2 sound, 0.542 and 0.618
# for the last two faults: the limits sit between the sound and the faulted
# readings of each.  The first fault reads 3.00e-2 there, at the sound
# level, so each rank's PGD start is also held bit-equal to its rows of the
# one-process step's start
RANKS_APART_TOL, RANKS_MU_TOL = 0.6, 0.1
# what phase 25's room was taken from (printed)
SCALEOUT_TRIM = ("phase 18's attack_suite CLI subprocess starts with the phase and runs beside "
                 "(a)-(c), collected at (d); phase 19's 14 cuda tests and its three robust_eval "
                 "subprocesses start with the phase, beside (a)-(b), collected at its end and at "
                 "(c) (all ran one after another before); their seconds and the rates of the "
                 "attacks beside them now include each other's load")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_child(code: str, world: int, rank: int, port: int) -> subprocess.Popen:
    """``python -c code`` from the repo, joined to a process group through
    the env contract (``parallel/distributed.py``)."""
    env = {**os.environ, "ADV_TPU_COORDINATOR": f"127.0.0.1:{port}",
           "ADV_TPU_NUM_PROCESSES": str(world), "ADV_TPU_PROCESS_ID": str(rank)}
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish_child(proc: subprocess.Popen, what: str, timeout: float = 300.0) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
        proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}\n{out[-3000:]}\n{err[-3000:]}")
    return out


def scaleout_nccl_child(out_path: str) -> None:
    """25(a), in a process joined through the env contract at world size 1:
    NCCL on cuda:0, the pgd -> smoothing + quantization -> feature detector
    cell sharded over two slots of the card, each shard bit-equal (cuDNN
    deterministic) to a one-device run on its 64 rows, the counters summed
    and all-reduced; pgd_step, quantize and the noise at [64,224,224,3]
    against their plain versions; two-slot and one-slot PGD-10 ex/s."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from image_recognition_adversarial_example_attack_tpu_torch.attacks.pgd import (
        pgd_linf_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        cell_generator, generator_from_seed, seed_draw, shard_generators)
    from image_recognition_adversarial_example_attack_tpu_torch.defenses import (
        calibrate_feature_threshold)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        STAT_KEYS, DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.parallel import (
        maybe_initialize_distributed)
    from image_recognition_adversarial_example_attack_tpu_torch.parallel.data_parallel import (
        evaluate_defenses_sharded, sharded_counts, sharded_pgd_linf_attack, sharded_predict)
    from image_recognition_adversarial_example_attack_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch)

    t_start = time.perf_counter()
    if not maybe_initialize_distributed():
        raise AssertionError("the env contract did not start a process group")
    backend, world = dist.get_backend(), dist.get_world_size()
    if backend != "nccl" or world != 1:
        raise AssertionError(f"process group {backend} of {world}, want nccl of 1")
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    bundle = load_model("resnet50", dtype=torch.bfloat16)
    lf, ff = make_fns(bundle)
    x_np = np.random.RandomState(25).rand(SO_B, 224, 224, 3).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    mesh = make_mesh(n_data=SO_SLOTS, n_model=1, devices=[dev] * SO_SLOTS)
    xs = shard_batch(x_np, mesh)
    ys = sharded_predict(lf, xs)
    thr = calibrate_feature_threshold(ff, x, n=SO_B, verbose=False)
    cfg = DefenseEvalConfig(attack_name="pgd", eps=EPS, alpha=ALPHA, steps=STEPS)

    ew.reset_launches()
    out = evaluate_defenses_sharded(lf, ff, xs, ys, thr, cfg, cell_generator(0, "scaleout"))
    counts = sharded_counts(out)
    torch.cuda.synchronize()
    launches = ew.launch_counts()
    want = {"pgd_step": SO_SLOTS * STEPS, "quantize": SO_SLOTS, "uniform_noise": SO_SLOTS}
    if launches != want:
        raise AssertionError(f"sharded cell: launches {launches} (want {want})")
    summed = torch.tensor([counts[k] for k in STAT_KEYS], device=dev)
    dist.all_reduce(summed)  # NCCL at world size 1
    if summed.tolist() != [counts[k] for k in STAT_KEYS]:
        raise AssertionError(f"NCCL all_reduce at world 1 changed the counters: {summed}")

    # each shard against a one-device run on its rows, its draws the rows of
    # the whole batch's
    per_shard = []
    views = shard_generators(cell_generator(0, "scaleout"), xs.row_ranges(), SO_B)
    for i, ((lo, hi), g) in enumerate(zip(xs.row_ranges(), views)):
        one = evaluate_defenses_batch(lf, ff, x[lo:hi].contiguous(), ys.data_shards()[i], thr,
                                      cfg, g)
        for k, v in one.items():
            if not torch.equal(v, out[k].data_shards()[i]):
                raise AssertionError(f"shard {i}: {k} differs from a one-device run on rows "
                                     f"[{lo}, {hi})")
        per_shard.append(aggregate_stats(one))
    want_counts = {k: sum(s[k] for s in per_shard) for k in STAT_KEYS}
    if {k: counts[k] for k in STAT_KEYS} != want_counts or counts["count"] != SO_B:
        raise AssertionError(f"sharded counters {counts} != the shards' sum {want_counts}")

    # the three kernels at the shard shape, against their plain versions
    shape = (SO_B // SO_SLOTS, 224, 224, 3)
    gen = generator_from_seed(250, "cuda")
    x0 = x[:shape[0]].contiguous()
    xa = torch.clamp(x0 + (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * EPS, 0, 1)
    grad = torch.randn(shape, generator=gen, device=dev)
    grad.view(-1)[::7] = 0.0
    for a in (ALPHA, -ALPHA):
        if not torch.equal(ew.pgd_step(xa, grad, x0, EPS, a),
                           ew.pgd_step_plain(xa, grad if a > 0 else -grad, x0, EPS, abs(a))):
            raise AssertionError(f"pgd_step at {list(shape)}, alpha {a}")
    xq = (torch.rand(shape, generator=gen, device=dev) * 1.2 - 0.1)
    if not torch.equal(ew.quantize(xq, LEVELS), ew.quantize_plain(xq, LEVELS)):
        raise AssertionError(f"quantize at {list(shape)}")
    seed = seed_draw(generator_from_seed(251))
    whole = ew.uniform_noise_at((SO_B, 224, 224, 3), EPS, seed, dev)
    row = 224 * 224 * 3
    parts = [ew.uniform_noise_at(shape, EPS, seed, dev, offset=i * shape[0] * row)
             for i in range(SO_SLOTS)]
    odd = ew.uniform_noise_at((3, 5, 7, 3), EPS, seed, dev, offset=1)
    if not (torch.equal(torch.cat(parts), whole)
            and torch.equal(odd.flatten(), whole.flatten()[1:1 + odd.numel()])):
        raise AssertionError("the noise kernel's offset draws differ from the whole draw")
    noise = parts[1].double()
    eps32 = float(np.float32(EPS))
    mean, var = float(noise.mean()), float(noise.var())
    if not (float(noise.min()) >= -eps32 and float(noise.max()) <= eps32
            and abs(mean) < 1e-2 * EPS and abs(var / (EPS ** 2 / 3) - 1) < 2e-2):
        raise AssertionError(f"noise shard at {list(shape)}: mean {mean}, var {var}")

    # two-slot PGD-10 against one slot (the sharded path's overhead on one card)
    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SO_TIMED):
            fn()
        torch.cuda.synchronize()
        return SO_B * SO_TIMED / (time.perf_counter() - t0)

    y_one = torch.cat(ys.data_shards())
    one_slot = timed(lambda: pgd_linf_attack(lf, x, y_one, eps=EPS, alpha=ALPHA, steps=STEPS,
                                             generator=generator_from_seed(3)))
    two_slot = timed(lambda: sharded_pgd_linf_attack(lf, xs, ys, eps=EPS, alpha=ALPHA,
                                                     steps=STEPS,
                                                     generator=generator_from_seed(3)))
    res = {"backend": backend, "world": world, "launches": launches, "counts": counts,
           "per_shard": per_shard, "threshold": thr, "pgd10_ex_s_two_slots": two_slot,
           "pgd10_ex_s_one_slot": one_slot, "noise_mean": mean,
           "noise_var_ratio": var / (EPS ** 2 / 3), "seconds": time.perf_counter() - t_start}
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(res))


def scaleout_rank_child(out_dir: str) -> None:
    """25(b), one of two ranks on the one card over gloo: one PGD-AT step
    of ResNet-50 bf16 on this rank's 16 of 32 rows (the gradients summed
    over the ranks), then the step timed; FGSM counters summed over the
    ranks.  Rank 0 writes the new parameters."""
    import torch
    import torch.distributed as dist

    from image_recognition_adversarial_example_attack_tpu_torch.parallel.distributed import (
        make_dcn_mesh, maybe_initialize_distributed, process_local_batch)

    # gloo, joined before cli.common's import joins with the default (NCCL,
    # which refuses two ranks on one card)
    if not maybe_initialize_distributed(backend="gloo"):
        raise AssertionError("the env contract did not start a process group")
    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        cell_generator, chunk_generator)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.parallel.data_parallel import (
        evaluate_defenses_sharded, sharded_counts)
    from image_recognition_adversarial_example_attack_tpu_torch.train.adversarial import (
        AdvTrainConfig, make_train_step, train_state_from_bundle)

    rank, world = dist.get_rank(), dist.get_world_size()
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    mesh = make_dcn_mesh(n_model=1, devices=[dev])
    x_np, y_np = _scaleout_train_batch()
    x, y = process_local_batch(x_np, mesh), process_local_batch(y_np, mesh)
    cfg = AdvTrainConfig(eps=EPS, alpha=ALPHA, attack_steps=TRAIN_PGD, learning_rate=TRAIN_LR,
                         weight_decay=1e-4)
    bundle = load_model("resnet50", dtype=torch.float32)
    state = train_state_from_bundle(bundle, cfg, torch.bfloat16)
    step = make_train_step(cfg, bundle.mean, bundle.std)
    ew.reset_launches()
    with _recorded_pgd_starts() as starts:
        new, m = step(state, x, y, chunk_generator(0, "scaleout:train", 0))
    torch.cuda.synchronize()
    launches = ew.launch_counts()
    torch.save(starts, Path(out_dir) / f"start{rank}.pt")
    dist.barrier()
    t0 = time.perf_counter()
    for s in range(1, SO_TIMED + 1):
        step(state, x, y, chunk_generator(0, "scaleout:train", s))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / SO_TIMED
    lf, ff = make_fns(load_model("resnet50", dtype=torch.bfloat16))
    fgsm = DefenseEvalConfig(attack_name="fgsm", eps=EPS, alpha=ALPHA, steps=STEPS)
    counts = sharded_counts(evaluate_defenses_sharded(lf, ff, x, y, 1.0, fgsm,
                                                      cell_generator(0, "scaleout:fgsm")))
    res = {"rank": rank, "world": world, "backend": dist.get_backend(), "launches": launches,
           "loss": float(m["loss"]), "step_ms": ms, "fgsm": counts,
           "rows": x.row_ranges()}
    if rank == 0:
        torch.save({"params": {k: v.detach().cpu() for k, v in new.params.items()},
                    "mu": {k: v.detach().cpu() for k, v in new.opt_state.mu.items()}},
                   Path(out_dir) / "params.pt")
    dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))


@contextlib.contextmanager
def _recorded_pgd_starts():
    """While open, every PGD start ``attacks.pgd.draw_start`` returns is
    also kept (on the host) in the list this yields."""
    from image_recognition_adversarial_example_attack_tpu_torch.attacks import pgd

    real, starts = pgd.draw_start, []

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        starts.append(out.detach().cpu())
        return out

    pgd.draw_start = record
    try:
        yield starts
    finally:
        pgd.draw_start = real


def _scaleout_train_batch():
    import numpy as np

    rng = np.random.RandomState(26)
    return (rng.rand(SO_TRAIN_B, 224, 224, 3).astype(np.float32),
            rng.randint(0, 1000, SO_TRAIN_B).astype(np.int64))


def _scaleout_one_process(ranks: list[dict], out_dir: Path) -> dict:
    """25(b)'s reference in this process: the same step on the 32 rows
    unsharded, and the FGSM counters unsharded and over two slots of the
    card; the two-rank parameters' distance from the one-process ones."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.cli.common import make_fns
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        cell_generator, chunk_generator)
    from image_recognition_adversarial_example_attack_tpu_torch.eval.defense_eval import (
        DefenseEvalConfig, aggregate_stats, evaluate_defenses_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.parallel.data_parallel import (
        evaluate_defenses_sharded, shard_labels, sharded_counts)
    from image_recognition_adversarial_example_attack_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.train.adversarial import (
        AdvTrainConfig, make_train_step, train_state_from_bundle)

    prior = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        dev = torch.device("cuda", 0)
        x_np, y_np = _scaleout_train_batch()
        x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
        cfg = AdvTrainConfig(eps=EPS, alpha=ALPHA, attack_steps=TRAIN_PGD,
                             learning_rate=TRAIN_LR, weight_decay=1e-4)
        bundle = load_model("resnet50", dtype=torch.float32)
        init = {k: v.detach().cpu() for k, v in bundle.model.state_dict().items()}
        state = train_state_from_bundle(bundle, cfg, torch.bfloat16)
        step = make_train_step(cfg, bundle.mean, bundle.std)
        with _recorded_pgd_starts() as starts:
            new, m = step(state, x, y, chunk_generator(0, "scaleout:train", 0))
        torch.cuda.synchronize()
        # each rank's PGD start: its rows of the one-process start, bit for bit
        own_start = []
        for r in ranks:
            got = torch.load(out_dir / f"start{r['rank']}.pt", weights_only=True)
            (lo, hi), = r["rows"]
            own_start.append(len(got) == len(starts) == 1
                             and torch.equal(got[0], starts[0][lo:hi]))
        t0 = time.perf_counter()
        for s in range(1, SO_TIMED + 1):
            step(state, x, y, chunk_generator(0, "scaleout:train", s))
        torch.cuda.synchronize()
        one_ms = 1e3 * (time.perf_counter() - t0) / SO_TIMED
        one = {k: v.detach().cpu() for k, v in new.params.items()}
        mu = {k: v.detach().cpu() for k, v in new.opt_state.mu.items()}
        two = torch.load(out_dir / "params.pt", weights_only=True)

        def norm(tree):
            return math.sqrt(sum(float((v.double() ** 2).sum()) for v in tree.values()))

        apart = norm({k: two["params"][k] - one[k] for k in one}) / norm(
            {k: one[k] - init[k] for k in one})
        mu_rel = norm({k: two["mu"][k] - mu[k] for k in mu}) / norm(mu)
        del state, new, step, bundle
        lf, ff = make_fns(load_model("resnet50", dtype=torch.bfloat16))
        fgsm = DefenseEvalConfig(attack_name="fgsm", eps=EPS, alpha=ALPHA, steps=STEPS)
        flat = aggregate_stats(evaluate_defenses_batch(lf, ff, x, y, 1.0, fgsm,
                                                       cell_generator(0, "scaleout:fgsm")))
        mesh = make_mesh(n_data=SO_RANKS, n_model=1, devices=[dev] * SO_RANKS)
        slots = sharded_counts(evaluate_defenses_sharded(
            lf, ff, shard_batch(x_np, mesh), shard_labels(y_np, mesh), 1.0, fgsm,
            cell_generator(0, "scaleout:fgsm")))
    finally:
        torch.backends.cudnn.deterministic = prior
    return {"apart": apart, "mu_rel": mu_rel, "start_equal": own_start,
            "loss": float(m["loss"]), "step_ms": one_ms,
            "fgsm": flat, "fgsm_two_slots": slots}


def _scaleout_tp() -> dict:
    """25(c): ViT-B/16 and ResNet-50 in float32 (TF32 off) over a 1x2 mesh
    of the card: the cut layers' shards half their weights, the logits
    within 1e-4 of the replicated model's, and ViT's PGD-3 within 2e-5;
    each forward's ms beside the replicated one's."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks.api import (
        make_logits_fn)
    from image_recognition_adversarial_example_attack_tpu_torch.attacks.pgd import (
        pgd_linf_attack)
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        generator_from_seed)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import (
        load_model, model_family)
    from image_recognition_adversarial_example_attack_tpu_torch.parallel.mesh import make_mesh
    from image_recognition_adversarial_example_attack_tpu_torch.parallel.tensor_parallel import (
        shard_fractions, tensor_parallel_model)

    dev = torch.device("cuda", 0)
    mesh = make_mesh(n_data=1, n_model=2, devices=[dev, dev])
    x = torch.from_numpy(np.random.RandomState(27).rand(SO_VIT_B, 224, 224, 3)
                         .astype(np.float32)).to(dev)
    res: dict = {"runs": []}
    for name in ("vit_b_16", "resnet50"):
        bundle = load_model(name, dtype=torch.float32)  # turns TF32 off
        tp = tensor_parallel_model(bundle.model, mesh, model_family(name))
        fracs = shard_fractions(tp, bundle.model)
        lf = make_logits_fn(bundle.model, bundle.mean, bundle.std)
        lf_tp = make_logits_fn(tp, bundle.mean, bundle.std)
        with torch.no_grad():
            want, got = lf(x), lf_tp(x)
        err = float((got - want).abs().max())
        if (not bool(((got - want).abs() <= TP_LOGITS_TOL * (1 + want.abs())).all())
                or not fracs or max(fracs.values()) > 0.5):
            raise AssertionError(f"{name} TP: logits {err} apart, shard fractions {fracs}")
        rec = {"logits_err": err, "cut": len(fracs), "shard_frac": max(fracs.values()),
               "forward_ms": time_ms(lambda: lf(x), iters=5, warmup=1),
               "tp_forward_ms": time_ms(lambda: lf_tp(x), iters=5, warmup=1)}
        if name == "vit_b_16":
            for key in ("encoder.layers.encoder_layer_0.self_attention.in_proj_weight",
                        "encoder.layers.encoder_layer_0.mlp.0.weight",
                        "encoder.layers.encoder_layer_0.mlp.3.weight", "heads.head.weight"):
                if fracs.get(key) != 0.5:
                    raise AssertionError(f"ViT TP: {key} shard fraction {fracs.get(key)}")
            y = torch.argmax(want, -1)
            adv = {}
            for tag, fn in (("replicated", lf), ("tp", lf_tp)):
                ew.reset_launches()
                adv[tag] = pgd_linf_attack(fn, x, y, eps=EPS, alpha=ALPHA, steps=TP_PGD_STEPS,
                                           generator=generator_from_seed(28))
                torch.cuda.synchronize()
                counts = ew.launch_counts()
                if counts != {"pgd_step": TP_PGD_STEPS, "quantize": 0, "uniform_noise": 1}:
                    raise AssertionError(f"ViT PGD-{TP_PGD_STEPS} ({tag}): launches {counts}")
                res["runs"].append({"launches": counts})
            diff = (adv["tp"] - adv["replicated"]).abs()
            beyond = int((diff > TP_PGD_ATOL + TP_PGD_RTOL * adv["replicated"].abs()).sum())
            rec.update(pgd_max_diff=float(diff.max()), pgd_beyond=beyond,
                       pgd_pixels=diff.numel())
            if (beyond > TP_PGD_FLIP_SHARE * diff.numel()
                    or float(diff.max()) > 2 * TP_PGD_STEPS * ALPHA + TP_PGD_ATOL):
                raise AssertionError(f"ViT TP PGD-{TP_PGD_STEPS}: {beyond} of {diff.numel()} "
                                     f"pixels beyond {TP_PGD_ATOL} (max {float(diff.max())})")
        res[name] = rec
        del bundle, tp
        torch.cuda.empty_cache()
    return res


def _scaleout_dryrun() -> dict:
    """25(d): ``entry.dryrun_multichip(4)`` on the card, its JSON line read
    back from what it prints; its counted launches."""
    import contextlib
    import io

    from image_recognition_adversarial_example_attack_tpu_torch.entry import dryrun_multichip
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    buf = io.StringIO()
    ew.reset_launches()
    with contextlib.redirect_stdout(buf):
        line = dryrun_multichip(4)
    counts = ew.launch_counts()
    printed = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if printed != [line] or line["platform"] != "gpu" or line["mesh"] != {"data": 2, "model": 2}:
        raise AssertionError(f"dryrun_multichip(4) printed {buf.getvalue()!r}")
    # PGD-2 on two data shards (2 x (2 pgd_step + 1 noise), 2 quantize) and
    # one PGD-AT step with grad_accum 2 (2 micro-batches x 2 shards x (2 + 1))
    want = {"pgd_step": 12, "quantize": 2, "uniform_noise": 6}
    if counts != want:
        raise AssertionError(f"dryrun_multichip(4): launches {counts} (want {want})")
    for ln in buf.getvalue().splitlines():
        log(f"[scale-out]   {ln}")
    return {"line": line, "launches": counts}


# 25(e): remat with train_bn over two slots of the card.  ResNet-50 has no
# batch-statistics mode in either package (train_bn is the CIFAR families'),
# so the step is PGD-AT (PGD-7) on WRN-28-10 from scratch at the CIFAR
# batch, float32 (TF32 off) with cuDNN deterministic
SO_REMAT_MODEL, SO_REMAT_B = "wrn28_10", 128
# its limits (scripts/remat_smoothadv_readings.py; NVIDIA H100 80GB HBM3 at
# 700 W): the summed gradient (the first moment, |a - b| / |b|) of the
# two-slot remat step against the two-slot step without remat ("same": 0.0,
# bit-equal, on sound runs), and against the one-slot remat step whose
# attack returns the two-slot step's x_adv ("slots": 3.75e-3; the PGD
# iterates of 64 and 128 rows part, 55% of the pixels, and the plain
# one-slot step reads 0.83, so the parameter step is held on the same
# x_adv).  The planted trap (the recompute on the shard's own statistics)
# reads 0.880 on both
REMAT_SAME_MU_TOL, REMAT_SLOTS_MU_TOL = 1e-6, 0.05
# 25(f): SmoothAdv PGD-AT (noise_sigma 0.25, 4 EOT samples) on ResNet-50 bf16
# at batch 32 over two slots
SMOOTHADV_SIGMA, SMOOTHADV_SAMPLES = 0.25, 4


@contextlib.contextmanager
def _own_statistics():
    """A planted fault, the trap of remat under train_bn: the recompute in
    the backward normalizes by the shard's own statistics (its sums scaled
    to the whole batch's count) instead of the sums its first forward
    read."""
    from image_recognition_adversarial_example_attack_tpu_torch.models import resnet
    from image_recognition_adversarial_example_attack_tpu_torch.parallel import collective

    real = resnet.sum_over_shards
    # the recompute is the thread that reads the recorded sums back
    resnet.sum_over_shards = lambda t: (
        t * SO_SLOTS if getattr(collective._local, "replay", None) is not None else real(t))
    try:
        yield
    finally:
        resnet.sum_over_shards = real


class _DrawTap:
    """While open, the draws of a training step (the PGD start, the EOT and
    Cohen noise, each returned on the host by the shard's first row, in
    call order), each EOT call's (seed, whole mix), each thread's input
    mixes and each shard's x_adv.  ``feed``: {draw name: tensors}, handed
    out in call order in place of the draws ("adv": the attack returns it
    and runs nothing)."""

    DRAWS = {"start": ("attacks.pgd", "draw_start"), "eot": ("attacks.eot", "draw_noise"),
             "cohen": ("train.adversarial", "draw_cohen_noise")}

    def __init__(self, feed: dict | None = None):
        import threading

        self.lock = threading.Lock()
        self.draws, self.calls, self.mixes, self.adv = {}, [], {}, {}
        self.feed = {k: iter(v) for k, v in (feed or {}).items()}

    def __enter__(self):
        import importlib
        import threading

        mod = lambda name: importlib.import_module(f"{PKG}.{name}")  # noqa: E731
        eot, pgd = mod("attacks.eot"), mod("attacks.pgd")
        patched = {name: (mod(m), attr) for name, (m, attr) in self.DRAWS.items()}
        patched.update(call=(eot, "call_generator"), mix=(eot, "input_mix"),
                       adv=(pgd, "pgd_linf_attack"))
        self.saved = [(m, attr, getattr(m, attr)) for m, attr in patched.values()]
        real = {name: getattr(m, attr) for name, (m, attr) in patched.items()}

        def draw(name):
            def fn(*args):
                device = args[-1]
                out = (next(self.feed[name]).to(device) if name in self.feed
                       else real[name](*args))
                with self.lock:
                    self.draws.setdefault((name, getattr(args[-2], "lo", 0)), []).append(
                        out.detach().cpu())
                return out
            return fn

        def call_generator(seed, mix, device):
            with self.lock:
                self.calls.append((seed, mix))
            return real["call"](seed, mix, device)

        def input_mix(x01):
            out = real["mix"](x01)
            with self.lock:
                self.mixes.setdefault(threading.get_ident(), []).append(int(out))
            return out

        def attack(fn, x01, *args, **kw):
            out = (next(self.feed["adv"]).to(x01.device) if "adv" in self.feed
                   else real["adv"](fn, x01, *args, **kw))
            with self.lock:
                self.adv[getattr(kw["generator"], "lo", 0)] = out.detach().cpu()
            return out

        for name, (m, attr) in patched.items():
            setattr(m, attr, {"call": call_generator, "mix": input_mix,
                              "adv": attack}.get(name) or draw(name))
        return self

    def __exit__(self, *exc):
        for m, attr, fn in self.saved:
            setattr(m, attr, fn)

    def whole(self, name: str) -> list:
        """Each draw, the shards' rows put together."""
        import torch

        los = sorted(lo for n, lo in self.draws if n == name)
        return [torch.cat(parts) for parts in zip(*(self.draws[(name, lo)] for lo in los))]

    def x_adv(self):
        import torch

        return torch.cat([self.adv[lo] for lo in sorted(self.adv)])


def _tree_norm(tree) -> float:
    return math.sqrt(sum(float((v.double() ** 2).sum()) for v in tree.values()))


def _pixel_share(a, b) -> float:
    return float(((a.float() - b.float()).abs() > 1e-6).float().mean())


def _remat_runs() -> dict:
    """25(e)'s steps on the card: two-slot remat (two steps timed: ms and
    peak GiB), two-slot without remat (timed), one-slot remat, one-slot
    remat whose attack returns the two-slot x_adv, and the two-slot remat
    step with the trap planted; their first moments' distances."""
    import numpy as np
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import chunk_generator
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.train.adversarial import (
        AdvTrainConfig, make_train_step, train_state_from_bundle)

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(29)
    x = rng.rand(SO_REMAT_B, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, SO_REMAT_B).astype(np.int64)
    mesh = make_mesh(n_data=SO_SLOTS, n_model=1, devices=[dev] * SO_SLOTS)
    bundle = load_model(SO_REMAT_MODEL, dtype=torch.float32, device=dev)  # turns TF32 off

    def run(remat: bool, sharded: bool, fault: bool = False, timed: bool = False,
            adv=None) -> dict:
        cfg = AdvTrainConfig(eps=EPS, alpha=ALPHA, attack_steps=TRAIN_PGD,
                             learning_rate=TRAIN_LR, weight_decay=1e-4, train_bn=True,
                             remat=remat)
        state = train_state_from_bundle(bundle, cfg)
        step = make_train_step(cfg, bundle.mean, bundle.std)
        batch_x = shard_batch(x, mesh) if sharded else torch.from_numpy(x).to(dev)
        labels = y if sharded else torch.from_numpy(y).to(dev)
        with _own_statistics() if fault else contextlib.nullcontext():
            ew.reset_launches()
            with _DrawTap(None if adv is None else {"adv": [adv]}) as tap:
                new, m = step(state, batch_x, labels, chunk_generator(0, "scaleout:remat", 0))
            torch.cuda.synchronize()
            out = {"launches": ew.launch_counts(), "loss": float(m["loss"]),
                   "x_adv": tap.x_adv(),
                   "mu": {k: v.detach().cpu() for k, v in new.opt_state.mu.items()}}
            del new
            if timed:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                for s in (1, 2):
                    step(state, batch_x, labels, chunk_generator(0, "scaleout:remat", s))
                torch.cuda.synchronize()
                out["ms"] = 1e3 * (time.perf_counter() - t0) / 2
                out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        return out

    def mu_rel(a: dict, b: dict) -> float:
        return (_tree_norm({k: a["mu"][k] - v for k, v in b["mu"].items()})
                / _tree_norm(b["mu"]))

    prior = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        two = run(True, True, timed=True)
        plain = run(False, True, timed=True)
        one = run(True, False)
        fed = run(True, False, adv=two["x_adv"])
        trap = run(True, True, fault=True)
    finally:
        torch.backends.cudnn.deterministic = prior
    res = {"same": mu_rel(two, plain), "slots": mu_rel(two, fed),
           "one_slot": mu_rel(two, one), "adv_share": _pixel_share(two["x_adv"], one["x_adv"]),
           "launches": two["launches"], "one_slot_launches": one["launches"],
           "remat_ms": two["ms"], "plain_ms": plain["ms"],
           "remat_peak_gib": two["peak_gib"], "plain_peak_gib": plain["peak_gib"],
           "loss": (two["loss"], plain["loss"], one["loss"]),
           "trap": {"same": mu_rel(trap, plain), "slots": mu_rel(trap, fed)}}
    return res


def _remat_rejects(d: dict) -> list[str]:
    """What 25(e)'s check finds wrong in readings ``d`` ("same", "slots")."""
    bad = []
    if d["same"] > REMAT_SAME_MU_TOL:
        bad.append(f"first moment {d['same']:.3e} from the two-slot step without remat "
                   f"(limit {REMAT_SAME_MU_TOL:g})")
    if d["slots"] > REMAT_SLOTS_MU_TOL:
        bad.append(f"first moment {d['slots']:.3e} from the one-slot step on the same x_adv "
                   f"(limit {REMAT_SLOTS_MU_TOL:g})")
    return bad


def _scaleout_remat(card: str) -> dict:
    """25(e): remat with train_bn over two slots, its check, and the trap
    planted to show that the check rejects it."""
    res = _remat_runs()
    want = {"pgd_step": SO_SLOTS * TRAIN_PGD, "quantize": 0, "uniform_noise": SO_SLOTS}
    bad = _remat_rejects(res)
    if res["launches"] != want:
        bad.append(f"launches {res['launches']} (want {want})")
    if bad:
        raise AssertionError("25(e) remat with train_bn over two slots: " + "; ".join(bad))
    caught = _remat_rejects(res["trap"])
    if len(caught) < 2:
        raise AssertionError(f"25(e) the planted trap passed a check: {res['trap']}")
    t = res["trap"]
    log(f"[scale-out] (e) {card}; PGD-AT PGD-{TRAIN_PGD} on {SO_REMAT_MODEL} float32 "
        f"(TF32 off, cuDNN deterministic) with train_bn and remat at "
        f"[{SO_REMAT_B},32,32,3] over {SO_SLOTS} slots (ResNet-50 has no train_bn in either "
        f"package): first moment {res['same']:.3e} from the two-slot step without remat "
        f"(limit {REMAT_SAME_MU_TOL:g}), {res['slots']:.3e} from the one-slot remat step on the "
        f"same x_adv (limit {REMAT_SLOTS_MU_TOL:g}; {res['one_slot']:.3e} from the plain one-slot "
        f"step, whose x_adv differs in {res['adv_share']:.2e} of the pixels); the planted trap "
        f"(the recompute on the shard's own statistics) reads {t['same']:.3e} / "
        f"{t['slots']:.3e}: rejected")
    log(f"[scale-out]   step {res['remat_ms']:.1f} ms and {res['remat_peak_gib']:.2f} GiB peak "
        f"with remat, {res['plain_ms']:.1f} ms and {res['plain_peak_gib']:.2f} GiB without; "
        f"launches {res['launches']} a step ({TRAIN_PGD} pgd_step and 1 uniform_noise a slot)")
    res["runs"] = [{"launches": res["launches"]}]
    return res


def _smoothadv_runs(own_mix: bool = False) -> dict:
    """25(f)'s steps on the card: SmoothAdv PGD-AT on ResNet-50 bf16 at
    batch 32 over two slots (its launches), on one slot, and on each shard's
    rows alone on one slot fed that shard's draws; ``own_mix`` plants a
    fault (each shard's EOT call seeded from its own rows' mix, as an
    unsharded wrapper would)."""
    import torch

    from image_recognition_adversarial_example_attack_tpu_torch.attacks import eot
    from image_recognition_adversarial_example_attack_tpu_torch.core.rng import (
        chunk_generator, shard_generators, standard_normal)
    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew
    from image_recognition_adversarial_example_attack_tpu_torch.models.zoo import load_model
    from image_recognition_adversarial_example_attack_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch)
    from image_recognition_adversarial_example_attack_tpu_torch.train.adversarial import (
        AdvTrainConfig, make_train_step, train_state_from_bundle)

    dev = torch.device("cuda", 0)
    x_np, y_np = _scaleout_train_batch()
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    mesh = make_mesh(n_data=SO_SLOTS, n_model=1, devices=[dev] * SO_SLOTS)
    cfg = AdvTrainConfig(eps=EPS, alpha=ALPHA, attack_steps=TRAIN_PGD, learning_rate=TRAIN_LR,
                         weight_decay=1e-4, noise_sigma=SMOOTHADV_SIGMA,
                         noise_samples=SMOOTHADV_SAMPLES)
    bundle = load_model("resnet50", dtype=torch.float32, device=dev)
    state = train_state_from_bundle(bundle, cfg, torch.bfloat16)
    step = make_train_step(cfg, bundle.mean, bundle.std)
    gen = lambda: chunk_generator(0, "scaleout:smoothadv", 0)  # noqa: E731
    prior = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    real_view = eot._shard_call_generator
    ranges = shard_batch(x_np, mesh).row_ranges()
    try:
        with _DrawTap() as one:
            _, m1 = step(state, x, y, gen())
        if own_mix:
            def own(seed, x01, mix):
                view = real_view(seed, x01, mix)  # this shard's rows, of its own mix's draw
                return shard_generators(eot.call_generator(seed, mix, x01.device),
                                        [(view.lo, view.hi)], view.shared.rows)[0]

            eot._shard_call_generator = own
        ew.reset_launches()
        t0 = time.perf_counter()
        with _DrawTap() as two:
            _, m2 = step(state, shard_batch(x_np, mesh), y_np, gen())
        torch.cuda.synchronize()
        two_s = time.perf_counter() - t0
        launches = ew.launch_counts()
        eot._shard_call_generator = real_view
        alone = []  # each shard's rows on one slot, fed the shard's draws
        for lo, hi in ranges:
            feed = {k: two.draws[(k, lo)] for k in ("start", "eot", "cohen")}
            with _DrawTap(feed) as tap:
                step(state, x[lo:hi], y[lo:hi], gen())
            alone.append(tap.adv[0])
    finally:
        eot._shard_call_generator = real_view
        torch.backends.cudnn.deterministic = prior
    n = SMOOTHADV_SAMPLES
    noise, calls = two.whole("eot"), list(two.calls)
    mixes = list(two.mixes.values())
    calls_ok = (len(calls) == TRAIN_PGD and len(mixes) == SO_SLOTS
                and all(len(m) == TRAIN_PGD for m in mixes))
    for k, (seed, mix) in enumerate(calls if calls_ok else ()):
        whole_mix = (sum(m[k] for m in mixes) + 2**31) % 2**32 - 2**31
        g = eot.call_generator(seed, mix, dev)
        want = [standard_normal(x.shape, g, dev).cpu() for _ in range(n)]
        calls_ok = (calls_ok and mix == whole_mix
                    and all(torch.equal(a, b) for a, b in zip(want, noise[k * n:(k + 1) * n])))
    a_two, a_one = two.x_adv(), one.x_adv()
    return {"start_equal": torch.equal(two.whole("start")[0], one.whole("start")[0]),
            "cohen_equal": torch.equal(two.whole("cohen")[0], one.whole("cohen")[0]),
            "first_call_equal": all(torch.equal(a, b) for a, b in
                                    zip(noise[:n], one.whole("eot")[:n])),
            "calls_equal": calls_ok, "calls": len(calls),
            "alone_equal": torch.equal(a_two, torch.cat(alone)),
            "alone_share": _pixel_share(a_two, torch.cat(alone)),
            "one_slot_share": _pixel_share(a_two, a_one),
            "launches": launches, "loss": (float(m1["loss"]), float(m2["loss"])),
            "two_slot_s": two_s}


def _scaleout_smoothadv(card: str) -> dict:
    """25(f): SmoothAdv PGD-AT over two slots and its check."""
    r = _smoothadv_runs()
    want = {"pgd_step": SO_SLOTS * TRAIN_PGD, "quantize": 0, "uniform_noise": SO_SLOTS}
    if not (r["start_equal"] and r["cohen_equal"] and r["first_call_equal"]
            and r["calls_equal"] and r["alone_equal"] and r["launches"] == want):
        raise AssertionError(f"25(f) SmoothAdv over two slots: {r} (launches want {want})")
    log(f"[scale-out] (f) {card}; SmoothAdv PGD-AT (sigma {SMOOTHADV_SIGMA}, "
        f"{SMOOTHADV_SAMPLES} EOT samples, PGD-{TRAIN_PGD}) on ResNet-50 bf16 at "
        f"[{SO_TRAIN_B},224,224,3] over {SO_SLOTS} slots (cuDNN deterministic): the PGD start, "
        f"Cohen's noise and the first EOT call's noise bit-equal to the one-slot run's; each "
        f"of the {r['calls']} EOT calls' noise bit-equal to the one-slot wrapper's draw for the "
        f"whole batch's input (its mix the wrapping sum of the shards'); x_adv bit-equal to "
        f"each shard's rows run alone on one slot with the same draws (against the whole "
        f"one-slot run {r['one_slot_share']:.2e} of the pixels differ: bf16 at 64 and 128 "
        f"stacked rows flips signs, and the mixes part); loss {r['loss'][1]:.5f} / "
        f"{r['loss'][0]:.5f}; launches {r['launches']}; {r['two_slot_s']:.2f} s")
    r["runs"] = [{"launches": r["launches"]}]
    return r


def phase_scaleout(card: str) -> dict:
    """Phase 25: scale-out on the one card (see the module docstring)."""
    out_a = Path(tempfile.mkdtemp(prefix="p25a_")) / "a.json"
    out_b = Path(tempfile.mkdtemp(prefix="p25b_"))
    log(f"[scale-out] trim: {SCALEOUT_TRIM}")
    a = _start_child(f"import chip_smoke as cs; cs.scaleout_nccl_child({str(out_a)!r})", 1, 0,
                     _free_port())
    port = _free_port()
    ranks = [_start_child(f"import chip_smoke as cs; cs.scaleout_rank_child({str(out_b)!r})",
                          SO_RANKS, r, port) for r in range(SO_RANKS)]
    res: dict = {}
    try:
        res["c"] = _scaleout_tp()
        res["d"] = _scaleout_dryrun()
        _finish_child(a, "25(a) the NCCL process")
        for r, p in enumerate(ranks):
            _finish_child(p, f"25(b) rank {r}")
        # after (a) and (b): their rates and (e)'s step times share no card
        res["e"] = _scaleout_remat(card)
        res["f"] = _scaleout_smoothadv(card)
    finally:
        for p in (a, *ranks):
            p.kill()
            p.wait()
    res["a"] = json.loads(out_a.read_text())
    rank = [json.loads((out_b / f"rank{r}.json").read_text()) for r in range(SO_RANKS)]
    ref = _scaleout_one_process(rank, out_b)
    res["b"] = {"ranks": rank, "one_process": ref}
    a_, c = res["a"], res["c"]
    log(f"[scale-out] (a) {card}; NCCL at world size 1 in a subprocess; pgd cell on ResNet-50 "
        f"bf16 {SO_B}x224x224x3 over {SO_SLOTS} slots of the card: launches {a_['launches']}, "
        f"each 64-row shard bit-equal to a one-device run on its rows (cuDNN deterministic), "
        f"counters {a_['counts']} = the shards' sum, all-reduced; kernels at "
        f"[{SO_B // SO_SLOTS},224,224,3]: pgd_step and quantize bit-exact, noise offset draws "
        f"bit-equal to the whole draw (mean {a_['noise_mean']:.2e}, var/(eps^2/3) "
        f"{a_['noise_var_ratio']:.4f}); {a_['seconds']:.1f} s")
    log(f"[scale-out]   PGD-10 {a_['pgd10_ex_s_two_slots']:.1f} ex/s over two slots of the card "
        f"against {a_['pgd10_ex_s_one_slot']:.1f} on one: the sharded path's overhead on one "
        "card, not a speed-up across cards (not measured: one card)")
    fgsm = {r["rank"]: r["fgsm"] for r in rank}
    if not (fgsm[0] == fgsm[1] == ref["fgsm"] == ref["fgsm_two_slots"]):
        raise AssertionError(f"25(b) FGSM counters: ranks {fgsm}, one process {ref['fgsm']}, "
                             f"two slots {ref['fgsm_two_slots']}")
    want = {"pgd_step": TRAIN_PGD, "quantize": 0, "uniform_noise": 1}
    if any(r["launches"] != want or r["backend"] != "gloo" for r in rank):
        raise AssertionError(f"25(b) ranks: {rank}")
    if (not all(ref["start_equal"]) or ref["apart"] > RANKS_APART_TOL
            or ref["mu_rel"] > RANKS_MU_TOL
            or abs(rank[0]["loss"] - ref["loss"]) > 1e-2 * abs(ref["loss"])):
        raise AssertionError(f"25(b) two-rank PGD-AT step: PGD starts equal to the "
                             f"one-process start's rows {ref['start_equal']}, "
                             f"parameters {ref['apart']:.3e} apart "
                             f"(limit {RANKS_APART_TOL}), first moment {ref['mu_rel']:.3e} "
                             f"(limit {RANKS_MU_TOL}), loss {rank[0]['loss']} / {ref['loss']}")
    log(f"[scale-out] (b) {card}; two ranks on the one card over gloo, PGD-AT ResNet-50 "
        f"bf16 batch {SO_TRAIN_B} ({SO_TRAIN_B // SO_RANKS} rows a rank), PGD-{TRAIN_PGD}: "
        f"each rank's PGD start bit-equal to its rows of the one-process start; "
        f"the summed gradient (first moment) {ref['mu_rel']:.3e} of its norm from the "
        f"one-process step's (limit {RANKS_MU_TOL}), parameters {ref['apart']:.3e} of the "
        f"one-process step's move apart (limit {RANKS_APART_TOL}), "
        f"loss {rank[0]['loss']:.5f} / {ref['loss']:.5f}; step {rank[0]['step_ms']:.1f} / "
        f"{rank[1]['step_ms']:.1f} ms a rank against {ref['step_ms']:.1f} ms in one process "
        f"(two ranks share one card: not a speed-up); FGSM counters equal: {ref['fgsm']}")
    for name in ("vit_b_16", "resnet50"):
        r = c[name]
        log(f"[scale-out] (c) {card}; {name} float32 TP over 1x2 slots of the card: "
            f"{r['cut']} layers cut, shards {r['shard_frac']:.2f} of their weights, logits "
            f"{r['logits_err']:.2e} from the replicated model's (limit {TP_LOGITS_TOL} + rel); "
            "forward at "
            f"{SO_VIT_B}x224x224x3 {r['tp_forward_ms']:.2f} ms TP against "
            f"{r['forward_ms']:.2f} ms replicated"
            + (f"; PGD-{TP_PGD_STEPS} x_adv within {TP_PGD_ATOL} but {r['pgd_beyond']} of "
               f"{r['pgd_pixels']} pixels (a sign flip, at most {r['pgd_max_diff']:.4f}; "
               f"limit {TP_PGD_FLIP_SHARE:g} of the pixels)" if "pgd_max_diff" in r else ""))
    log(f"[scale-out] (d) dryrun_multichip(4): {json.dumps(res['d']['line'])}, launches "
        f"{res['d']['launches']}")
    res["runs"] = [{"launches": a_["launches"]}, *({"launches": r["launches"]} for r in rank),
                   *c["runs"], {"launches": res["d"]["launches"]}, *res["e"]["runs"],
                   *res["f"]["runs"]]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, default=None,
                    help="also write every number of the run to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (REPO / PKG).is_dir():
        print(f"chip_smoke: the port's package {PKG}/ is not beside this script",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {smi}")

    from image_recognition_adversarial_example_attack_tpu_torch.kernels import elementwise as ew

    record = {"card": smi, "torch": torch.__version__, "phase_s": {}}

    def run(key: str, fn, *args):
        """One phase, its wall seconds logged and kept under ``phase_s``."""
        t0 = time.perf_counter()
        out = fn(*args)
        record["phase_s"][key] = time.perf_counter() - t0
        log(f"[time] {key}: {record['phase_s'][key]:.1f} s")
        return out

    record["build"] = run("build", phase_build)
    record["kernels"] = run("kernels", phase_kernels)
    record["conv"] = run("conv", phase_conv)
    state = run("classify", phase_classify)
    record["classify"] = {k: v for k, v in state.items() if k not in ("bundle", "x", "y")}
    record["pgd"] = run("pgd", phase_pgd, state)
    record["cell"] = run("cell", phase_cell, state)
    state["threshold"] = record["cell"]["threshold"]
    record["cw"] = run("cw", phase_cw, state)
    record["cells"] = run("cells", phase_cells, state)
    record["cli"] = run("cli", phase_cli)
    record["detectors"] = run("detectors", phase_detectors, state)
    record["experiments"] = run("experiments", phase_experiments)
    with tempfile.TemporaryDirectory() as shared:
        # phase 8's 128 PNGs are the first 128 of these (the same seed)
        t0 = time.perf_counter()
        pngs = _write_pngs(Path(shared) / "png", N_STREAM)
        png_write_s = time.perf_counter() - t0
        jpegs = _write_pngs(Path(shared) / "jpeg", SHAPE[0], seed=1, suffix=".jpg")
        record["stream"] = run("stream", phase_stream, state,
                               record["experiments"]["grid"]["cell_s"], pngs)
        record["stream"]["png_write_s"] = png_write_s
        record["visualize"] = run("visualize", phase_visualize, state)
        record["weights"] = run("weights", phase_weights, state)
        record["families"] = run("families", phase_families, state)
        record["transfer"] = run("transfer", phase_transfer, state, pngs, jpegs)
        record["native"] = run("native", phase_native, pngs, record["stream"]["cli"]["cells"])
        record["visualize_full"] = run("visualize_full", phase_visualize_full, state)
        record["int8"] = run("int8", phase_int8, state, record["classify"]["forward_ms"],
                             {n: record["families"][n]["bf16_forward_ms"] for n in FAMILIES})
        record["transfer_attacks"] = run("transfer_attacks", phase_transfer_attacks, state, pngs)
        record["zoo"] = run("zoo", phase_white_box_zoo, state, pngs)
        record["black_box"] = run("black_box", phase_black_box, state, pngs)
        record["certified"] = run("certified", phase_certified, state, pngs)
        record["detector_corruption"] = run("detector_corruption", phase_detector_corruption,
                                            state, pngs)
        record["cifar"] = run("cifar", phase_cifar, smi)
        record["train"] = run("train", phase_train)
        record["serve"] = run("serve", phase_serve, pngs)
    record["scaleout"] = run("scaleout", phase_scaleout, smi)

    # the elementwise kernels' main path: PGD-10, the eight cells, the
    # streamed pgd cell, the visualize path's PGD-20 and trajectory, the
    # two pgd-20 transfer cells, PGD-10 on the int8 ResNet-50, the three
    # transfer attacks, the mifgsm transfer cell and the two CLIs run with
    # them, the white-box zoo's counted runs and its in-process suite and
    # grid CLIs, the black-box group's counted runs, its streamed robust
    # cell, query_curves CLIs (and their per-chunk resident runs) and grid
    # and suite CLIs, phase 20's EOT-PGD runs and its two grid CLIs with
    # --certified, phase 21's detector comparison and its in-process CLIs,
    # phase 22's WRN-28-10 PGD-10 and cell, its grid CLI (launches printed by
    # the subprocess) and its in-process robust_eval, phase 23's PGD-AT steps,
    # its in-process WRN-28-10 TRADES CLI and the MART, free, IBP and
    # CROWN-IBP steps, phase 24's serve CLIs (file mode, HTTP and the drain
    # in subprocesses that print their launches, and main in process); the
    # conv's: the probe's entry point
    detector_cells = ("adaptive", "detector_aware", "squeezing", "mahalanobis")
    ta, zoo, bb = record["transfer_attacks"], record["zoo"], record["black_box"]
    cert, p21, p22 = record["certified"], record["detector_corruption"], record["cifar"]
    runs = [record["pgd"], record["cell"], *record["cells"].values(),
            *(record["detectors"][c] for c in detector_cells),
            record["stream"]["pgd_cell"], record["visualize"]["in_process"],
            record["transfer"]["cell"], record["transfer"]["ensemble"], record["int8"]["pgd"],
            *ta["attacks"].values(), ta["cell"], ta["transferability_cli"], ta["grid_cli"],
            *zoo["a"].values(), *zoo["b"].values(), *zoo["suite_inproc"].values(),
            *zoo["suite_f32"].values(), zoo["grid_cli"],
            *bb["a"].values(), *bb["b"].values(), bb["robust_stream"],
            bb["query_curves"]["one batch"], bb["query_curves"]["streamed"],
            bb["query_curves"]["resident_chunks"], bb["grid_cli"], bb["suite_cli"],
            cert["uap"], cert["patch"],
            *(v for v in cert["eot"].values() if isinstance(v, dict)),
            cert["cli"]["grid_resident"], cert["cli"]["grid_streamed"],
            p21["detector"], p21["cli"]["corruption_streamed"],
            p21["cli"]["detector_f32_resident"], p21["cli"]["detector_f32_streamed"],
            p22["wrn"]["pgd"], p22["wrn"]["cell"], p22["cli"]["grid_cli"],
            p22["cli"]["robust_eval"],
            record["train"]["a"], record["train"]["c"], *record["train"]["d"].values(),
            *record["serve"]["a"].values(), record["serve"]["b"], record["serve"]["c"],
            record["serve"]["d"]["counted"], *record["scaleout"]["runs"]]
    main_path = {k: sum(r["launches"][k] for r in runs) for k in ew.LAUNCHES}
    kernels = []
    for name, (replaces, _) in KERNELS.items():
        r = record["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/elementwise.cu", "replaces": replaces,
            "launches": main_path[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": r["library_ms"],
        })
    c = record["conv"]
    kernels.append({
        "name": "conv3x3", "route": "cuda", "source": f"{PKG}/csrc/conv3x3.cu",
        "replaces": f"{JAX_PROBE}:78", "launches": c["launches"],
        "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
    })
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"kernel {k['name']} was not launched on the main path")
    record["kernels_line"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
