#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lama_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nothing falls back to the CPU or to a plain
version):
  1. card: nvidia-smi name and power limit, torch's device name;
  2. build: nvcc builds every CUDA source of the port (lama_tpu_torch/csrc),
     one process each, all started together;
  3. kernels: each hand-written kernel at its big-lama shapes (batch 4;
     the bottleneck at 64^2, the downsamples at 512^2 to 128^2, the head
     and the stem at 512^2), at the refine phase's (batch 1; the 1024^2
     image's 128x128 bottleneck, the 1000x760 image's odd 125x95 and 63x48
     bottlenecks, its 1000x760 and 504x384 inputs; the stem at 1024^2 and
     1000x760), at the train phase's (the stem at batch 10, 256^2, and
     cols and taps at its b10 32^2 bottleneck), for
     the tiled halo conv at each kernel size and stride, and for the 3x3
     halo conv (kernel 6) at big-lama-regular's block convs (512 -> 512 at
     b4 64^2 and b10 32^2) and a tiny odd shape, and kernels 6, 3, 2 and
     4 at the served batch 16 (64^2: 512 -> 512, 128 -> 384, 384 -> 128,
     128 -> 128; the four downsamples, 512^2 to 128^2), and the
     FourierUnit (kernel 1), the stem (kernel 7, 4 -> 64 at 512^2) and
     the head (kernel 5, 64 -> 3 at 512^2) at the served batch 16 too,
     and the head also at training's b10 256^2 and the refiner's 1024^2;
     kernel 3 at ablv2_work_md's dilation-1 branch (16, 128, 64, 64) ->
     512 and kernel 1 at an ffc_positions LFU unit's (16, 192, 32, 32),
     and kernel 1 at the served (16, 192, 64, 64) with norm='backward'
     and norm='forward' (each against the plain unit of its norm);
     fp32
     (TF32 off; each fp32 3x3 stride-1 row prints the K split its grid
     ran with) and bf16, against its plain PyTorch version on the same
     inputs, with the median time of each wrapper call and plain version
     (CUDA events; a call includes the channels-last copy of the NCHW
     input), the kernel's own device time per call (torch.profiler), the
     median time of the library call (nn.Conv2d with
     padding_mode='reflect', for every reflect conv; none for the
     FourierUnit) on the NCHW input and on its channels-last copy (the
     layout the generator gives every reflect conv) beside the wrapper's
     time on that copy, and its bound (the least time for its bytes or its FLOP
     on an H100); then, in fp32, each kernel's gradients through its
     autograd wrapper against plain autograd; then the device ms of each
     of the FourierUnit's five GEMM stages in one unit at batch 16 (CUDA
     events around each launch), fp32 and bf16;
  4. serve: big-lama (ngf 64, 18 blocks, random weights from a seed) served
     by `python -m lama_tpu_torch.predict` (run in this process, as `-m`
     runs it) on synthetic PNGs: bf16 and fp32, wire fp32 and uint8. Checks
     sizes, known pixels, bit-equal wires, and that every forward launched
     each kernel its expected number of times (cols 36, taps 72, FU 36,
     head 1, down 4, stem 1);
  5. refine: `python -m lama_tpu_torch.predict refine=true precision=bf16`
     on 1024^2 and 1000x760 images (two pyramid scales each, n_iters 15;
     each size twice, the first a warm-up). Checks sizes, known pixels, the
     hole, finite outputs, the launches (down 4 and stem 1 per front pass;
     the others per rear forward: 1 at the first scale, n_iters at the
     second) and that the loss falls at each refined scale; prints seconds
     per image (refine_predict's call, timed);
  6. train: `python -m lama_tpu_torch.train -cn big-lama` (in this process)
     on synthetic JPEGs at batch 10, 256^2, bf16 and fp32, ResNetPL with
     random weights, 6 steps each (2 warm up). Checks that every loss term
     is finite at every step, that each step launched stem 2, cols 72, taps
     144, down 8, head 2 and FourierUnit 0, that the G and D weights and BN
     statistics moved, and that the run dir's last.ckpt serves; prints ms
     per step, the phase split and device profile of a step and the peak
     memory; then one fp32 G step, kernels vs kernels='plain' (losses within
     1e-4; the gradient within the plain path's own spread, which a dropped
     stem gradient must fall outside). The bf16 run validates after its
     epoch on 8 val images at 256^2 with the shipped evaluator (SSIM,
     LPIPS-vgg16, FID, random score-net weights from a seed): its val_*
     metrics logged and finite, each eval forward launching the served
     counts, and the best-k checkpoint written beside last.ckpt, which
     serves;
  7. generator: kernels vs plain path at 512^2, batch 2, fp32;
  8. refine checks: one front and one rear pass of the kernels generator,
     fp32 and bf16, vs the fp32 plain one on the padded 1024^2, 1000x760
     and 504x384 inputs; fp32 at 512^2, the gradient of one scale's loss
     w.r.t. z through the kernels vs through the plain path, against the
     plain path's own spread, with planted faults as controls; the
     forward/backward split and device profile of one Adam step;
  9. throughput: img/s at 512^2, batch 16, bf16 and fp32, kernels vs plain,
     one profiled forward of each (idle share, top device kernels), and
     the device ms of each reflect-conv wrapper in one kernels forward;
 10. regular serve: big-lama-regular (the pix2pixHD GlobalGenerator, ngf 64,
     18 ResnetBlocks, random weights from a seed) served by the predict
     CLI as in phase 4, each forward launching kernel 6 36 times, the stem
     and the head once and no other kernel; refine=true on its model dir
     refused;
 11. regular generator: phases 7 and 9 for big-lama-regular;
 12. regular train: `python -m lama_tpu_torch.train -cn big-lama-regular`
     as in phase 6 (bf16 and fp32, 4 steps each, 2 warm up; per step
     kernel 6 72, stem 2, head 2, the others 0), its checkpoint served, and
     the fp32 G-step check with the stem's gradient dropped as the control;
 13. evaluate (run after phase 9, before phase 10): 32 synthetic 512^2
     image + mask pairs in the eval2 layout, masks in 1 of the 10 area
     bins (EVAL_MAX_AREA: each non-empty bin costs one host sqrtm),
     served by `python -m lama_tpu_torch.predict` (big-lama bf16,
     launches counted), then `python -m lama_tpu_torch.evaluate_predicts
     configs/eval2.yaml` on the card (SSIM, LPIPS-vgg16 at 512^2, FID on
     the whole InceptionV3 at 299^2, batch 8, seeded random score-net
     weights): the table's ssim, lpips and fid for the total and each
     non-empty bin and lpips_fid100_f1, all finite and in range; its
     seconds and the host's share (sqrtm, PNG reads); each score's
     images/s at batch 8; per-image SSIM and LPIPS and the Inception
     activations on the card against the port's own CPU run on the first
     batch of the same files (EVAL_CPU_BATCHES); the identity control
     (ground truth as the prediction: SSIM 1
     and LPIPS 0 within 1e-6 per image, FID within 1e-5 of the
     activations' total variance); `python -m lama_tpu_torch.fid_score`
     between the ground truth and the predictions against the table's FID;
 14. segmentation (right after phase 13, on its 32 pairs and their big-lama
     bf16 predictions; no kernel of the port is on this path): the ADE20k
     segmenters at full width (resnet50dilated + PPM-deepsup and
     mobilenetv2dilated + C1-deepsup, 150 classes, seeded He-scaled random
     weights with BatchNorm statistics from one train-mode forward on the
     first 8 images, fp32, TF32 off) on the 32 ground-truth images at
     batch 8:
     class scores finite and summing to 1 per pixel within 1e-5, the
     classes the labels hold, images/s of each net beside its FLOP bound,
     and the card against the port's own CPU run on 2 images (scores within
     SEG_ATOL, labels equal wherever the top-2 margin exceeds it, near-ties
     counted); `python -m lama_tpu_torch.evaluate_predicts
     configs/eval2_segm.yaml --metrics segm_stats,segm_ssim,segm_lpips` on
     the card: every value finite, the per-class columns there, each bin's
     total_freq/* summing to 1 within 1e-4, segm_ssim and segm_lpips means
     equal to phase 13's per-image SSIM and LPIPS means within 1e-6, total
     and per bin; segm_fid on 2 of the pairs without groups (N + 1 host
     sqrtm) equal to `python -m lama_tpu_torch.fid_score` on the same pairs
     within 1e-4 relative; object-shaped masks (SegmentationMask with the
     ADE20k panoptic predictor on the card, seeded rng) on 2 images, each
     binary, image-sized and above min_mask_area; the card's and the CPU's
     maps differ only at the CPU's near-ties (top-2 margin within
     SEG_ATOL), and the masks equal those the same host code makes from
     the CPU's map with its near-ties given the card's labels; at least
     one mask is so compared.
 15. the rest of training, `python -m lama_tpu_torch.train` in this
     process at b10 256^2, 4 steps a run (2 warm up), each step's losses
     finite, its launches exact and every G and D weight and BN statistic
     moved, one step profiled: run A `-cn ablv2_work_no_segmpl_vgg` as
     shipped, bf16 (the GlobalGenerator of 9 blocks, the NLayer D, the
     VGG19 perceptual loss at 0.03: gen_pl finite and non-zero; kernel 6
     36, stem 2, head 2 per step); run B `-cn big-lama` in bf16 and fp32
     with the FFC discriminator, fake fakes (0.5), pps distance weighting
     also for the adversarial G loss, 4 scales of input noise (the stem's
     C 8, on stem_conv.cu), lazy R1 (r1_every 2), a ladder rescale ramp
     and the constant-area crop, the uint8 wire (per step big-lama's counts
     plus the FFC D's kernel 6 2 and kernel 4 3 per D forward, 4 forwards,
     5 when that step's fake-fakes draw is 1); run C `-cn big-lama` bf16
     on web shards with bce, steps_per_dispatch 2 and an online val set of
     8 images (validated with SSIM and LPIPS, no FID, best-k on SSIM; the
     served counts per eval forward). Then, on
     run B's fp32 trainer, the gradient of the D loss with R1 w.r.t. the
     FFC D's weights, kernels vs kernels='plain', on 5 batches
     (D_REPEATS), each within TRAIN_FLOOR_FACTOR x the plain path's
     spread, the detached-R1 control rejected each time. Kernel rows at
     the FFC D's shapes (kernel 6 at L0 (10,3,256^2)->64 and L4
     (10,512,32^2)->512, kernel 4 at L1-L3) join phase 3's, with run B's
     launches per step.
 16. int8 serving: the int8 conv (csrc/conv_int8.cu) at big-lama's
     and big-lama-regular's int8 shapes at batch 16 (the four downsamples,
     l2l, l2g and g2l at 64^2, the SpectralTransform's 1x1 384 -> 192 and
     192 -> 384, the three ConvTranspose layers; the 512 -> 512 block conv
     and the three zero-padded downsamples), bf16 in: its int32 sums
     bit-equal to the plain version's (float64 on the codes), its outputs
     within INT8_OUT_RTOL; the wrapper's ms with the amax and quantize
     passes, with a calibrated scale, and the GEMM alone, the device ms,
     the plain ms, torch._int_mm on the im2col GEMM's shape and the bf16
     cuDNN conv as yardsticks, the bound (int8 at 1,979 TOP/s or bytes at
     3.35 TB/s) of the conv and of the GEMM alone; kernel 1 with
     store_bf16 against its plain version (FU_STORE_RTOL, and a mean |d|
     under FU_STORE_MEAN_SHARE of the unstored unit's) with its stages'
     device ms at b16; big-lama and
     big-lama-regular served by the predict CLI at batch 16 with the
     headline flags of bench.py:7-9 (quant_calibration=2, quant_zero_pad,
     spectral_bf16_store, s2d_out_head) and with dynamic scales: sizes,
     known pixels, launches per forward (INT8_PER_FORWARD,
     INT8_REGULAR_PER_FORWARD: kernels 2, 3, 4 and 6 never), the hole's
     difference from the bf16 serve; the int8 generator kernels vs plain at
     512^2 b2 (fp32 compute within GEN_INT8_ATOL, bf16 logged); img/s at
     512^2 b16, int8 (headline, calibrated) vs bf16 in turns, one profiled
     forward of each. The int8 rows include ablv2_work_md's branch convs
     (16, 128, 64, 64) -> 512 at dilations 1, 2, 4, 8 (reflect) and 2, 4,
     8 under quant_zero_pad, and a dilated (d 2) 512 -> 512 GlobalGenerator
     block conv: their int32 sums bit-equal to the plain version's too.
 17. the multidilated family (last): `python -m lama_tpu_torch.train -cn
     ablv2_work_md` as shipped (ngf 64, 9 MultidilatedResnetBlocks at 512
     channels, cat_in, dilations 1, 2, 4, 8; random ResNetPL weights) in
     this process at b10 256^2, bf16, 4 steps (2 warm up): losses finite,
     launches exact (per step kernel 3 36, the stem 2, the head 2, the
     others 0), every G and D weight and BN statistic moved, one step
     profiled; its last.ckpt served by the predict CLI at batch 16 in bf16
     and fp32 (wires fp32 and uint8; per forward kernel 3 18, stem 1, head
     1) and in int8 with the headline flags and with dynamic scales (per
     forward 78 int8 convs, stem 1, head 1), sizes, known pixels and the
     hole's difference from bf16; the generator with kernels vs plain at
     512^2 b2, fp32 within GEN_ATOL; img/s at 512^2 b16 in bf16 and fp32
     (kernels vs plain) and int8 vs bf16 in turns, a profiled forward of
     each; then big-lama-regular cut to 6 blocks with an inline FFC block
     (LFU) before block 4 (ffc_positions), 512^2 b2 fp32, kernels vs plain
     within GEN_ATOL, its launches exact (kernel 6 12, kernel 2 2, kernel
     3 4, kernel 1 4, stem 1, head 1).
 18. the device CLIs (ROADMAP queue 1 item 12), each on an earlier phase's
     files: `python -m lama_tpu_torch.export` of big-lama at 512^2 in fp32,
     bf16 and int8 (static scales calibrated on phase 4's PNGs) after phase
     6, and of big-lama-regular in bf16 after phase 12: each program
     reloaded within the CLI's bound of the direct call (1e-4 fp32, 2e-2
     bf16 and int8), its launches per forward counted at the registered
     ops (PER_FORWARD, INT8_PER_FORWARD, REGULAR_PER_FORWARD) and equal to
     the eager module's, both timed at b1 (median of 10); make_checkpoint
     on phase 6's bf16 run dir (the best epoch, generator only, the EMA
     weights that run kept from its first step; every tensor finite), its
     best.ckpt served by the predict CLI; analyze_errors on
     phase 13's 32 pairs (and --only-report); then precompile (shapes
     512x512,1000x760 at b16, then refine=true), predict_inner_features on
     one 512^2 PNG (one heat map a level) and evaluator_example. Prints the
     phase's seconds by part.
 19. the item-4 options (last; ROADMAP queue 1 item 4): big-lama at full
     width and depth (ngf 64, 3 downsamplings, 18 blocks, ratio 0.75, no
     LFU, sigmoid; seeded random weights, spatial transform angles
     uniform in [0, 80)) with fft_norm='backward' (opt_norm), spatial
     scale 0.5 by 'area' (opt_scaled_area: kernel 1 at 32^2, the area
     resize both ways), blocks 4 and 12 in a learnable spatial transform
     and out_ffc (opt_st_outffc: kernels 1-3 at 128^2, the out_ffc block
     at 512^2 with its two units on cuFFT and its LFU units on kernel 1),
     positional encoding, SE and ffc3d (opt_plain_units: every unit off
     kernel 1), each at 512^2 b4, and plain big-lama at 2560^2 b1
     (big_image: its 320^2 units past kernel 1's envelope, on cuFFT):
     fp32 kernels vs the fp32 plain generator within GEN_ATOL, bf16
     kernels within GEN_BF16_ATOL, each kernel's launches and the cuFFT
     units a forward exact (OPT_PER_FORWARD), one profiled bf16 forward
     at b16 (big_image b1): device ms and the top 5 kernels.
 20. data parallel (last; ROADMAP queue 1 item 11): (a) two ranks of
     `python3 chip_smoke.py --dp-worker` on the one card, gloo (NCCL refuses
     two ranks on one device), each an InpaintingTrainer of `-cn big-lama`
     at full width (ResNetPL on seeded random weights) on its b5 rows of
     the same global b10 256^2 batches: fp32 with SGD for 2 steps against
     one process at b10 on the same batches (every metric within rtol 1e-3
     / atol 1e-5; the G and D BN running statistics as the G optimizer
     first steps, all from the starting weights, within 1e-5; those after
     step 1, which hold a forward on updated weights, within 2x the one
     process's own spread when its images move by 1e-6), then bf16 with
     Adam as configured for 3 steps (the last profiled, device activity
     only); every step's metrics finite, its launches on each rank
     big-lama's per step (PER_TRAIN_STEP), the ranks' weights and buffers
     bit-equal after it; ms per step and the host ms in collectives
     logged; (b) one rank of `python -m torch.distributed.run --standalone
     --nproc_per_node 1 chip_smoke.py --dp-train` (which runs `python -m
     lama_tpu_torch.train -cn big-lama` in its process) on NCCL, b10
     256^2 bf16, 4 steps (2 warm up) and one validation of 4 images (SSIM
     and LPIPS): losses finite, launches exact (the validation's per eval
     forward), its last.ckpt served by the predict CLI; ms per step and
     its collectives' host ms beside phase 6's.
Prints the `kernels` JSON line, then, as its last line,
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device, and
when run outside a checkout of the repository.
"""
import contextlib
import functools
import io
import json
import math
import os
import runpy
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4
PER_FORWARD = {'reflect_conv3x3_cols': 36, 'reflect_conv3x3_taps': 72,
               'fused_fourier_unit': 36, 'reflect_out_conv7x7': 1,
               'reflect_down_conv3x3': 4, 'halo_conv_reflect_tiled': 1,
               'halo_conv3x3_reflect': 0, 'quantized_conv2d': 0}
# the rest run in the rear stage
FRONT_KERNELS = ('reflect_down_conv3x3', 'halo_conv_reflect_tiled')
# per train step: two generator forwards in train mode (the G step and the
# D step's re-forward), where the FourierUnit takes its plain path
PER_TRAIN_STEP = dict({k: 2 * v for k, v in PER_FORWARD.items()},
                      fused_fourier_unit=0)
# big-lama-regular (configs/training/big-lama-regular.yaml): two 3x3 reflect
# 512 -> 512 convs in each of its 18 ResnetBlocks on kernel 6, the stem and
# the head; its stride-2 downsamples are zero-padded (stock cuDNN)
REGULAR_PER_FORWARD = dict({k: 0 for k in PER_FORWARD},
                           halo_conv3x3_reflect=36, halo_conv_reflect_tiled=1,
                           reflect_out_conv7x7=1)
REGULAR_PER_TRAIN_STEP = {k: 2 * v for k, v in REGULAR_PER_FORWARD.items()}
# bounds: fp32 kernel vs fp32 plain (summation order only); bf16 kernel on
# bf16-rounded operands vs the fp32 plain output on the fp32 operands
TOL = {'fp32': (1e-4, 1e-4), 'bf16': (2e-2, 2e-2)}
# gradients through a kernel's autograd wrapper (backward: the plain VJP) vs
# plain autograd, fp32, linear loss so both see the same output gradient:
# cuDNN's algorithm choice only; atol relative to the largest gradient
GRAD_TOL = (1e-4, 1e-5)
GEN_ATOL = 1e-3   # whole generator, kernels vs plain, fp32, sigmoid output
# one scale's refiner loss gradient w.r.t. z, kernels vs plain, fp32: this
# gradient is not smooth at rounding scale (ReLU gates), so it is held to
# the plain path's own spread when z moves by REFINE_Z_EPS (the front's
# kernels-vs-plain difference, ~1e-6 relative), the largest over
# REFINE_DRAWS draws of the noise: max and norm differences within
# REFINE_FLOOR_FACTOR times that spread, cosine >= 1 - REFINE_COS_TOL
REFINE_Z_EPS, REFINE_DRAWS = 1e-6, 8
REFINE_FLOOR_FACTOR, REFINE_COS_TOL = 2.0, 1e-5
# controls of that check, planted in the first rear FourierUnit: its output
# (forward and backward) scaled by 1 + eps * (random signs) for each eps,
# logged to show the check's resolution; and its gradient dropped (the
# output detached), a wiring fault, which the check must reject
REFINE_CONTROL_EPS = (1e-3, 1e-2, 1e-1)
# the refine path's padded inputs (a 1024^2 image's second scale, a
# 1000x760 image's second and first): one front and one rear pass of the
# kernels generator vs kernels='plain' fp32, at the TOL bounds
REFINE_PASS_SIZES = ((1024, 1024), (1000, 760), (504, 384))
N_ITERS = 15      # the refiner's default (configs/prediction/default.yaml)
# kernel 7: the stem (7x7 stride 1, C <= 8; every stem row) runs
# stem_conv.cu, its other shapes (the k3s1, k3s2 and k7s2 rows) halo_conv.cu
SOURCES = {'fused_fourier_unit': 'lama_tpu_torch/csrc/fourier_unit.cu',
           'halo_conv_reflect_tiled': 'lama_tpu_torch/csrc/stem_conv.cu'}
TILED_OTHER_SOURCE = 'lama_tpu_torch/csrc/halo_conv.cu'
SOURCES['reflect_out_conv7x7'] = 'lama_tpu_torch/csrc/reflect_conv.cu'
# the fp32 paths of kernels 2, 3, 4 and 6: one register-tiled SIMT implicit
# GEMM (kernel 4 its stride-2 form)
SOURCES.update({k: 'lama_tpu_torch/csrc/conv3x3_simt.cu' for k in (
    'reflect_conv3x3_cols', 'reflect_conv3x3_taps', 'reflect_down_conv3x3',
    'halo_conv3x3_reflect')})
# the fp32 kernels whose stride-1 grid may split K (conv3x3_simt.py)
SPLIT_KERNELS = ('reflect_conv3x3_cols', 'reflect_conv3x3_taps',
                 'halo_conv3x3_reflect')
# the bf16 paths of kernels 2, 3, 4 and 6: one wgmma implicit GEMM (kernel
# 4 its stride-2 form)
BF16_SOURCES = {k: 'lama_tpu_torch/csrc/conv3x3_wgmma.cu' for k in (
    'reflect_conv3x3_cols', 'reflect_conv3x3_taps', 'reflect_down_conv3x3',
    'halo_conv3x3_reflect')}
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, fp32 FMA FLOP/s outside the tensor cores
HBM_BPS, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*args):
    print(*args, flush=True)


T_START = time.perf_counter()


def mark(what):
    """Logs the script's seconds so far as each part starts: where its
    1200 s go."""
    log(f'[{time.perf_counter() - T_START:.1f} s] {what}')


def card():
    import torch
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr}')
    line = smi.stdout.strip().splitlines()[0]
    log(line)   # as nvidia-smi prints it: name, power limit
    log(f'torch {torch.__version__} cuda {torch.version.cuda} device '
        f'{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}')
    return line


def build():
    from lama_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build()
    log(f'build: {time.perf_counter() - t0:.1f} s '
        + ', '.join(f'{k} {v:.1f} s' for k, v in secs.items()))
    for name in _build.SOURCES:
        with open(_build.library_path(name) + '.log') as f:
            for ln in f:
                if 'registers' in ln or 'spill' in ln or 'Compiling' in ln:
                    log(f'  ptxas {name}: {ln.strip()}')


def median_ms(fn, iters=10, warmup=3):
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
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


OWN_KERNEL_NS = '(anonymous namespace)::'   # csrc/*.cu's kernels live there


def own_device_ms(fn, calls=5, tries=3):
    """Device ms per call of fn spent in the port's own kernels (csrc/*.cu,
    whose kernels live in anonymous namespaces; PyTorch's are under at::),
    under torch.profiler: the kernel alone, without a wrapper's layout
    copies, weight relayout or host time. A trace with no device event at
    all (late in a run, most of phase 16's first traces were) is taken
    again, up to `tries` times. None, with the kernel names logged, when
    the profiler shows none of the port's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    own = [e.self_device_time_total for e in events
           if OWN_KERNEL_NS in e.key and 'at::' not in e.key]
    if not own:
        log('  own_device_ms: no port kernel among '
            + '; '.join(e.key[:80] for e in events))
        return None
    return sum(own) / calls / 1e3


def kernel_cases(gen):
    """(name, TPU kernel, role, kernel fn, plain fn, fp32 inputs) at the
    big-lama 512^2 shapes, batch BATCH, and at the refine phase's."""
    import torch
    from lama_tpu_torch.ops.kernels import fourier_unit as fu
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    from lama_tpu_torch.ops.kernels import reflect_conv as rc

    # drawn on the card from a seed that `gen` gives: on the host they took
    # ~18 s a call
    dev = torch.Generator('cuda').manual_seed(
        int(torch.randint(0, 2 ** 62, (), generator=gen)))

    def u(*shape, scale=1.0, shift=0.0):
        t = torch.rand(*shape, generator=dev, device='cuda') * 2 - 1
        return t * scale + shift

    def conv_case(c, co, h, k, bias, x=None, b=BATCH, w=None):
        x = (u(b, c, h, w or h) + 1) / 2 if x is None else x
        wt = u(co, c, k, k, scale=(c * k * k) ** -0.5)
        bias = u(co, scale=0.1) if bias else None
        return x, wt, bias

    def stem_case(h, b, w=None):
        # the generator's stem: masked image + mask, 7x7 4 -> 64, bias
        return conv_case(4, 64, h, 7, True, b=b, w=w)

    def fu_case(b, h, w):
        return ((u(b, 192, h, w) + 1) / 2, u(384, 384, 1, 1, scale=0.05),
                u(384, scale=0.2, shift=1.0), u(384, scale=0.1),
                u(384, scale=0.1), u(384, scale=0.3, shift=1.0))

    l2l3 = conv_case(256, 128, 128, 3, False)
    l2l3_b16 = conv_case(256, 128, 128, 3, False, b=16)
    cases = [
        ('reflect_conv3x3_cols', 'l2l', conv_case(128, 128, 64, 3, False)),
        ('reflect_conv3x3_taps', 'l2g', conv_case(128, 384, 64, 3, False)),
        ('reflect_conv3x3_taps', 'g2l', conv_case(384, 128, 64, 3, False)),
        ('reflect_out_conv7x7', 'head', conv_case(64, 3, 512, 7, True)),
        ('fused_fourier_unit', 'fu', fu_case(BATCH, 64, 64)),
        ('fused_fourier_unit', 'fu_b16', fu_case(16, 64, 64)),
        ('reflect_down_conv3x3', 'down1', conv_case(64, 128, 512, 3, False)),
        ('reflect_down_conv3x3', 'down2', conv_case(128, 256, 256, 3, False)),
        # the third downsample's two convs, on one input
        ('reflect_down_conv3x3', 'down3_l2l', l2l3),
        ('reflect_down_conv3x3', 'down3_l2g',
         conv_case(256, 384, 128, 3, False, x=l2l3[0])),
        # the refine phase's own shapes, batch 1: the 1024^2 image's
        # bottleneck (128x128), the 1000x760 image's second scale
        # (bottleneck 125x95, odd on both sides) and first scale (500x380
        # padded to 504x384: bottleneck 63x48); partial tiles everywhere
        ('reflect_conv3x3_cols', 'refine_l2l',
         conv_case(128, 128, 125, 3, False, b=1, w=95)),
        ('reflect_conv3x3_taps', 'refine_l2g',
         conv_case(128, 384, 125, 3, False, b=1, w=95)),
        ('reflect_conv3x3_taps', 'refine_g2l',
         conv_case(384, 128, 125, 3, False, b=1, w=95)),
        ('reflect_conv3x3_cols', 'refine_s1_l2l',
         conv_case(128, 128, 63, 3, False, b=1, w=48)),
        ('reflect_conv3x3_taps', 'refine_s1_l2g',
         conv_case(128, 384, 63, 3, False, b=1, w=48)),
        ('reflect_conv3x3_taps', 'refine_s1_g2l',
         conv_case(384, 128, 63, 3, False, b=1, w=48)),
        # the train phase's bottleneck, b10 32^2
        ('reflect_conv3x3_cols', 'train_l2l',
         conv_case(128, 128, 32, 3, False, b=10)),
        ('reflect_conv3x3_taps', 'train_l2g',
         conv_case(128, 384, 32, 3, False, b=10)),
        ('reflect_conv3x3_taps', 'train_g2l',
         conv_case(384, 128, 32, 3, False, b=10)),
        ('reflect_out_conv7x7', 'refine_head',
         conv_case(64, 3, 1000, 7, True, b=1, w=760)),
        ('fused_fourier_unit', 'refine_fu_1024', fu_case(1, 128, 128)),
        ('fused_fourier_unit', 'refine_fu', fu_case(1, 125, 95)),
        ('fused_fourier_unit', 'refine_fu_s1', fu_case(1, 63, 48)),
        ('reflect_down_conv3x3', 'refine_down1',
         conv_case(64, 128, 1000, 3, False, b=1, w=760)),
        ('reflect_down_conv3x3', 'refine_down1_s1',
         conv_case(64, 128, 504, 3, False, b=1, w=384)),
        ('reflect_down_conv3x3', 'refine_down3_l2g',
         conv_case(256, 384, 250, 3, False, b=1, w=190)),
        # kernel 7: the stem at serving (b4 512^2), training (b10 256^2)
        # and the refiner's inputs (1024^2, 1000x760), then each (k, s)
        ('halo_conv_reflect_tiled', 'stem', stem_case(512, BATCH)),
        ('halo_conv_reflect_tiled', 'train_stem', stem_case(256, 10)),
        ('halo_conv_reflect_tiled', 'refine_stem_1024', stem_case(1024, 1)),
        ('halo_conv_reflect_tiled', 'refine_stem', stem_case(1000, 1, 760)),
        ('halo_conv_reflect_tiled', 'k3s1', conv_case(16, 32, 96, 3, True)),
        ('halo_conv_reflect_tiled', 'k3s2',
         conv_case(32, 64, 255, 3, True, b=2, w=129)),
        ('halo_conv_reflect_tiled', 'k7s2', conv_case(8, 24, 128, 7, True)),
        # kernel 6: big-lama-regular's ResnetBlock convs at serving (b4
        # 64^2, with bias) and training (b10 32^2), then tiny odd widths
        # and sides (channel tails, partial tiles)
        ('halo_conv3x3_reflect', 'block', conv_case(512, 512, 64, 3, True)),
        ('halo_conv3x3_reflect', 'train_block',
         conv_case(512, 512, 32, 3, False, b=10)),
        ('halo_conv3x3_reflect', 'tiny_odd',
         conv_case(24, 40, 37, 3, True, b=2, w=29)),
        # the served batch 16 of both families: big-lama-regular's block
        # conv and big-lama's l2g and g2l convs
        ('halo_conv3x3_reflect', 'block_b16',
         conv_case(512, 512, 64, 3, True, b=16)),
        ('reflect_conv3x3_taps', 'l2g_b16',
         conv_case(128, 384, 64, 3, False, b=16)),
        ('reflect_conv3x3_taps', 'g2l_b16',
         conv_case(384, 128, 64, 3, False, b=16)),
        # and its l2l convs and four downsamples
        ('reflect_conv3x3_cols', 'l2l_b16',
         conv_case(128, 128, 64, 3, False, b=16)),
        ('reflect_down_conv3x3', 'down1_b16',
         conv_case(64, 128, 512, 3, False, b=16)),
        ('reflect_down_conv3x3', 'down2_b16',
         conv_case(128, 256, 256, 3, False, b=16)),
        ('reflect_down_conv3x3', 'down3_l2l_b16', l2l3_b16),
        ('reflect_down_conv3x3', 'down3_l2g_b16',
         conv_case(256, 384, 128, 3, False, x=l2l3_b16[0], b=16)),
        # and its stem (big-lama-regular's has a bias too)
        ('halo_conv_reflect_tiled', 'stem_b16', stem_case(512, 16)),
        # kernel 5, the head (64 -> 3, bias), at the served batch 16,
        # training's b10 256^2 and the refiner's 1024^2 (its b4 and
        # 1000x760 rows are above)
        ('reflect_out_conv7x7', 'head_b16', conv_case(64, 3, 512, 7, True,
                                                       b=16)),
        ('reflect_out_conv7x7', 'train_head', conv_case(64, 3, 256, 7, True,
                                                         b=10)),
        ('reflect_out_conv7x7', 'refine_head_1024',
         conv_case(64, 3, 1024, 7, True, b=1)),
        # the FFC discriminator's layers at training's b10 256^2 (ndf 64,
        # n_layers 4, no bias: phase 15): kernel 6 at L0 and L4, kernel 4
        # at L1-L3
        ('halo_conv3x3_reflect', 'd_l0', conv_case(3, 64, 256, 3, False, b=10)),
        ('reflect_down_conv3x3', 'd_l1',
         conv_case(64, 128, 256, 3, False, b=10)),
        ('reflect_down_conv3x3', 'd_l2',
         conv_case(128, 256, 128, 3, False, b=10)),
        ('reflect_down_conv3x3', 'd_l3',
         conv_case(256, 512, 64, 3, False, b=10)),
        ('halo_conv3x3_reflect', 'd_l4',
         conv_case(512, 512, 32, 3, False, b=10)),
        # ablv2_work_md's multidilated generator: each block conv's
        # dilation-1 branch (cat_in, 128 of 512 channels -> 512, bias) at
        # the served b16 64^2; the LFU unit of an ffc_positions block
        # (its 48 channels' 2x2 tiles: 192 at 32^2) at b16
        ('reflect_conv3x3_taps', 'md_branch_b16',
         conv_case(128, 512, 64, 3, True, b=16)),
        ('fused_fourier_unit', 'lfu_b16', fu_case(16, 32, 32)),
        # kernel 1 with the other norms' twiddle tables at the served b16
        # (phase 19's opt_norm generator runs 'backward')
        ('fused_fourier_unit', 'fu_b16_norm_backward', fu_case(16, 64, 64)),
        ('fused_fourier_unit', 'fu_b16_norm_forward', fu_case(16, 64, 64)),
    ]
    src = 'lama_tpu/ops/pallas/'

    def halo(x, w, b=None, s=1):
        return hc.halo_conv_reflect_tiled(x, w, b, stride=s)

    fns = {'reflect_conv3x3_cols': ('reflect_conv.py:130',
                                    rc.reflect_conv3x3_cols,
                                    rc.reflect_conv_plain),
           'reflect_conv3x3_taps': ('reflect_conv.py:465',
                                    rc.reflect_conv3x3_taps,
                                    rc.reflect_conv_plain),
           'reflect_out_conv7x7': ('reflect_conv.py:327',
                                   rc.reflect_out_conv7x7,
                                   rc.reflect_conv_plain),
           'fused_fourier_unit': ('fourier_unit.py:130',
                                  fu.fused_fourier_unit,
                                  fu.fourier_unit_plain),
           'reflect_down_conv3x3': ('reflect_conv.py:230',
                                    rc.reflect_down_conv3x3,
                                    rc.reflect_down_conv3x3_plain),
           'halo_conv_reflect_tiled': ('halo_conv.py:158', halo,
                                       rc.reflect_conv_plain),
           'halo_conv3x3_reflect': ('halo_conv.py:53', hc.halo_conv3x3_reflect,
                                    hc.halo_conv3x3_reflect_plain)}
    out = []
    for name, role, args in cases:
        tpu, kfn, pfn = fns[name]
        s = case_stride(name, role)
        if s != 1 and name == 'halo_conv_reflect_tiled':
            kfn = functools.partial(halo, s=s)
            pfn = functools.partial(rc.reflect_conv_plain, stride=s)
        if '_norm_' in role:
            norm = role.rsplit('_', 1)[1]
            kfn = functools.partial(kfn, norm=norm)
            pfn = functools.partial(pfn, norm=norm)
        out.append((name, src + tpu, role, kfn, pfn, args))
    return out


def case_stride(name, role):
    return 2 if 'down' in name or role.endswith('s2') else 1


def fu_flop(b, c, h, w, co):
    """FLOP of one FourierUnit, the TPU kernel's cost estimate
    (lama_tpu/ops/pallas/fourier_unit.py:160-164): the real W-DFT (2 Wf
    rows), the complex H-DFT, the 1x1 conv over 2C -> 2C', the H-iDFT and
    the inverse real W-DFT."""
    wf = w // 2 + 1
    return 2 * b * (2 * h * w * wf * c + 4 * h * wf * h * c
                    + h * wf * 4 * c * co + 4 * wf * h * h * co
                    + 2 * wf * h * w * co)


def bound(name, role, args, dtype):
    """(least ms for the work on an H100, 'bytes' or 'operations'): each
    input read once, each output written once, over HBM_BPS; the FLOP the
    kernel does over the peak of its arithmetic (bf16 tensor cores for the
    bf16 convs; fp32 FMA for the fp32 convs and for the FourierUnit, which
    computes in fp32 for either input)."""
    x = args[0]
    b, c, h, w = x.shape
    xsize = 2 if dtype == 'bf16' else 4
    if name == 'fused_fourier_unit':
        co = args[1].shape[0] // 2
        nbytes = b * c * h * w * xsize + b * co * h * w * 4 + sum(
            a.numel() * 4 for a in args[1:])
        flop = fu_flop(b, c, h, w, co)
        peak = FP32_FLOPS
    else:
        wt, bias = args[1], args[2]
        co, k = wt.shape[0], wt.shape[-1]
        s = case_stride(name, role)
        out_px = b * ((h - 1) // s + 1) * ((w - 1) // s + 1)
        nbytes = (b * c * h * w + out_px * co + wt.numel()
                  + (0 if bias is None else bias.numel())) * xsize
        flop = 2 * out_px * co * c * k * k
        peak = BF16_FLOPS if dtype == 'bf16' else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flop / peak * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


def row_source(name, role, args, dtype):
    """The CUDA source that a kernel row's call runs."""
    if name == 'halo_conv_reflect_tiled':
        from lama_tpu_torch.ops.kernels import halo_conv as hc
        x, wt = args[0], args[1]
        route = hc.tiled_route(x.shape[2], x.shape[3], x.shape[1],
                               wt.shape[0], wt.shape[-1],
                               case_stride(name, role))
        return SOURCES[name] if route is not None else TILED_OTHER_SOURCE
    return (BF16_SOURCES.get(name, SOURCES[name]) if dtype == 'bf16'
            else SOURCES[name])


def planned_splits(args):
    """The K split (conv3x3_simt.py's plan) of an fp32 3x3 stride-1 conv of
    args' shapes on this card: 1 for a grid of at least one wave."""
    from lama_tpu_torch.ops.kernels import conv3x3_simt as sm
    x, wt = args[0], args[1]
    b, c, h, w = x.shape
    return sm.plan_splits(b, h, w, c, wt.shape[0], sm.sm_count(x.device.index))


def library_call(name, role, args, tdt):
    """One PyTorch call that computes the same function as a reflect-conv
    kernel, for its time only (the port never calls it): nn.Conv2d with
    padding_mode='reflect' at the kernel's k and stride, the same weight and
    bias, in the input's dtype; None for the FourierUnit, which no single
    call computes."""
    import torch
    if name == 'fused_fourier_unit':
        return None
    wt, bias = args[1], args[2]
    co, c, k = wt.shape[0], wt.shape[1], wt.shape[-1]
    conv = torch.nn.Conv2d(c, co, k, stride=case_stride(name, role),
                           padding=k // 2, padding_mode='reflect',
                           bias=bias is not None)
    with torch.no_grad():
        conv.weight.copy_(wt)
        if bias is not None:
            conv.bias.copy_(bias)
    conv = conv.to(device=wt.device, dtype=tdt).requires_grad_(False)
    return conv


def kernels_vs_plain(gen):
    import torch
    rows = []
    for name, tpu, role, kfn, pfn, args in kernel_cases(gen):
        ref = pfn(*args).float()
        for dtype, tdt in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
            kargs = (args[0].to(tdt),) + args[1:]
            out = kfn(*kargs)
            torch.cuda.synchronize()
            check(out.shape == ref.shape, f'{name}/{role}: shape {out.shape}')
            err = (out.float() - ref).abs()
            rtol, atol = TOL[dtype]
            ok = bool(torch.all(err <= atol + rtol * ref.abs()))
            splits = (planned_splits(args) if dtype == 'fp32'
                      and name in SPLIT_KERNELS else None)
            if splits and splits > 1:   # a fixed summation order
                check(torch.equal(kfn(*kargs), out),
                      f'{name}/{role}: split s={splits} not bit-equal twice')
            k_ms = median_ms(lambda: kfn(*kargs))
            d_ms = own_device_ms(lambda: kfn(*kargs))
            p_ms = median_ms(lambda: pfn(*kargs))
            lib = library_call(name, role, args, tdt)
            # the generator hands every reflect conv a channels-last input:
            # the wrapper and the library call on that copy too
            xcl = kargs[0].contiguous(memory_format=torch.channels_last)
            clargs = (xcl,) + kargs[1:]
            k_cl_ms = median_ms(lambda: kfn(*clargs))
            with torch.no_grad():
                l_ms = None if lib is None else median_ms(lambda: lib(kargs[0]))
                l_cl_ms = None if lib is None else median_ms(lambda: lib(xcl))
            b_ms, b_by = bound(name, role, args, dtype)
            source = row_source(name, role, args, dtype)
            row = dict(name=name, role=role, route='cuda', source=source,
                       replaces=tpu, tpu_kernel=tpu,
                       shape=list(args[0].shape), dtype=dtype,
                       max_abs_err=float(err.max()),
                       tol=dict(rtol=rtol, atol=atol), within_tol=ok,
                       ms=k_ms, kernel_ms=k_ms, kernel_device_ms=d_ms,
                       plain_ms=p_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                       channels_last_ms=k_cl_ms,
                       library_channels_last_ms=l_cl_ms, splits=splits)
            lib_text = ('' if l_ms is None else
                        f' library {l_ms:.3f} ms ({k_ms / l_ms:.2f}x); '
                        f'channels-last input: kernel {k_cl_ms:.3f} ms, '
                        f'library {l_cl_ms:.3f} ms ({k_cl_ms / l_cl_ms:.2f}x)')
            log(f'kernel {name}/{role} {dtype} {list(args[0].shape)}'
                f'{"" if splits is None else f" split s={splits}"}: '
                f'max|d| {row["max_abs_err"]:.3e} (rtol {rtol} atol {atol}) '
                f'kernel {k_ms:.3f} ms (device '
                f'{"not measured" if d_ms is None else f"{d_ms:.4f}"}) plain '
                f'{p_ms:.3f} ms{lib_text} bound {b_ms:.3f} ms ({b_by})')
            check(ok, f'{name}/{role} {dtype}: outside tolerance')
            rows.append(row)
    return rows


def kernel_gradients(gen, rows):
    """fp32 gradients of a linear loss through each kernel's wrapper vs
    plain autograd, on the first case of each kernel (of each kernel size
    and stride, for the tiled halo conv; every case of the 3x3 halo
    conv and of the head)."""
    import torch
    seen = set()
    for name, _, role, kfn, pfn, args in kernel_cases(gen):
        key = (name, args[1].shape[-1], case_stride(name, role),
               role if name in ('halo_conv3x3_reflect', 'reflect_out_conv7x7')
               else '')
        if key in seen:   # the first case of each kernel (and k, stride)
            continue
        seen.add(key)
        # x, then the weight and bias (conv) or the conv/BN affine
        # parameters (FourierUnit; the BN statistics are buffers)
        n_diff = 4 if name == 'fused_fourier_unit' else 3
        leaves = [a.clone().requires_grad_() if i < n_diff and a is not None
                  else a for i, a in enumerate(args)]
        wrt = [a for a in leaves[:n_diff] if a is not None]
        counter = kernel_wrappers()[name]
        before = counter.launches
        out = kfn(*leaves)
        check(counter.launches == before + 1,
              f'{name}: no launch with gradients')
        r = torch.rand(out.shape, generator=gen).to(out.device)
        ours = torch.autograd.grad((out * r).sum(), wrt)
        ref = torch.autograd.grad((pfn(*leaves) * r).sum(), wrt)
        worst = 0.0
        for a, b in zip(ours, ref):
            scale = float(b.abs().max())
            err = (a - b).abs()
            check(bool(torch.all(err <= GRAD_TOL[1] * scale
                                 + GRAD_TOL[0] * b.abs())),
                  f'{name}: gradient outside tolerance')
            worst = max(worst, float(err.max()) / max(scale, 1e-30))
        log(f'gradient {name}/{role} fp32: {len(wrt)} inputs, max|d| / '
            f'max|grad| {worst:.3e} (rtol {GRAD_TOL[0]}, atol {GRAD_TOL[1]} '
            'x max|grad|)')
        for row in rows:
            if row['name'] == name and row['role'] == role \
                    and row['dtype'] == 'fp32':
                row['grad_max_rel_err'] = worst


def fourier_unit_stages(gen, rows, b=16, iters=10, store_bf16=False):
    """Device ms of each of the five GEMM stages of one FourierUnit at the
    served batch (b, 192, 64, 64), fp32 and bf16 input (store_bf16: bf16
    input with its stages stored in bf16): CUDA events around each launch
    (fourier_unit._gemm), the median over `iters` units after one warm-up;
    kept on the fu_b16 rows (fu_b16_store_bf16) as `stage_ms`."""
    import torch
    from lama_tpu_torch.ops.kernels import fourier_unit as fu
    x = torch.rand(b, 192, 64, 64, generator=gen).cuda()
    params = [(torch.rand(384, 384, 1, 1, generator=gen) * 2 - 1) * 0.05,
              1 + 0.2 * torch.rand(384, generator=gen),
              0.1 * torch.rand(384, generator=gen),
              0.1 * torch.rand(384, generator=gen),
              1 + 0.3 * torch.rand(384, generator=gen)]
    params = [p.cuda() for p in params]
    events, launch = [], fu._gemm

    def timed(stage, *args):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        launch(stage, *args)
        e.record()
        events.append((stage, a, e))

    fu._gemm = timed
    role = 'fu_b16_store_bf16' if store_bf16 else 'fu_b16'
    dtypes = ((('bf16', torch.bfloat16),) if store_bf16 else
              (('fp32', torch.float32), ('bf16', torch.bfloat16)))
    try:
        for dtype, tdt in dtypes:
            xt = x.to(tdt)
            with torch.no_grad():
                fu.fused_fourier_unit(xt, *params, store_bf16=store_bf16)
                torch.cuda.synchronize()
                events.clear()
                for _ in range(iters):
                    fu.fused_fourier_unit(xt, *params, store_bf16=store_bf16)
                torch.cuda.synchronize()
            per = {}
            for stage, a, e in events:
                per.setdefault(stage, []).append(a.elapsed_time(e))
            ms = {k: float(np.median(v)) for k, v in per.items()}
            check(list(ms) == list(fu.STAGE_NAMES),
                  f'fourier_unit stages {list(ms)}')
            log(f'fourier unit stages b{b} {dtype}'
                f'{" store_bf16" if store_bf16 else ""} (device ms, CUDA '
                'events): ' + ', '.join(f'{k} {v:.4f}' for k, v in ms.items())
                + f'; sum {sum(ms.values()):.4f}')
            for row in rows:
                if row['role'] == role and row['dtype'] == dtype:
                    row['stage_ms'] = ms
    finally:
        fu._gemm = launch


def big_lama_kwargs(name='big-lama'):
    """The generator section of configs/training/<name>.yaml (big-lama,
    big-lama-regular), read by the port's own config code."""
    from lama_tpu_torch.serving import generator_config
    return generator_config(os.path.join(REPO, 'configs', 'training',
                                         name + '.yaml'))


def random_state_dict(model, seed):
    """Reference-format weights from a seeded torch.Generator: convs
    uniform(+-1/sqrt(fan_in)), BN near identity."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        r = torch.rand(v.shape, generator=gen) * 2 - 1 if v.is_floating_point() \
            else None
        if k.endswith('num_batches_tracked'):
            sd[k] = torch.zeros_like(v)
        elif v.dim() == 4:
            sd[k] = r * (v.shape[1] * v.shape[2] * v.shape[3]) ** -0.5
        elif k.endswith('running_var'):
            sd[k] = 1.0 + 0.3 * r
        elif k.endswith('running_mean'):
            sd[k] = 0.1 * r
        elif k.endswith('.weight'):   # BatchNorm scale
            sd[k] = 1.0 + 0.1 * r
        else:                         # biases
            sd[k] = 0.05 * r
    return sd


def write_model_dir(root, gen_kwargs, sd):
    import torch
    import yaml
    os.makedirs(os.path.join(root, 'models'))
    with open(os.path.join(root, 'config.yaml'), 'w') as f:
        yaml.safe_dump({'generator': gen_kwargs}, f)
    torch.save({'state_dict': {'generator.' + k: v for k, v in sd.items()}},
               os.path.join(root, 'models', 'best.ckpt'))


def write_png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(path)


def read_png(path, mode='RGB'):
    from PIL import Image
    return np.array(Image.open(path).convert(mode))


def write_images(root, rng):
    """Synthetic 8-bit image + mask PNG pairs: six at 512^2 and one at
    500x380, which the modulo and bucket padding must crop back."""
    os.makedirs(root)
    sizes = [(512, 512)] * 6 + [(500, 380)]
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w] / 64.0
        img = np.stack([np.sin(yy + i), np.cos(xx - i), np.sin(xx + yy)], -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(h, w, 3), 0, 1)
        mask = np.zeros((h, w), np.uint8)
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        mask[y0:y0 + h // 3, x0:x0 + w // 3] = 255
        write_png(os.path.join(root, f'img{i}.png'),
                  np.rint(img * 255).astype(np.uint8))
        write_png(os.path.join(root, f'img{i}_mask.png'), mask)
    return sizes


def run_predict(args):
    """`python -m lama_tpu_torch.predict <args>`, in this process."""
    run_module('lama_tpu_torch.predict', args)


def reset_counts():
    """Set every kernel wrapper's launch count to 0; returns them by name."""
    fns = kernel_wrappers()
    for fn in fns.values():
        fn.launches = 0
    return fns


def kernel_wrappers():
    """The wrapper of each kernel, by name; its `launches` counts it."""
    from lama_tpu_torch.ops.kernels import conv_int8 as ci
    from lama_tpu_torch.ops.kernels import fourier_unit as fu
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    from lama_tpu_torch.ops.kernels import reflect_conv as rc
    return dict(quantized_conv2d=ci.quantized_conv2d,
                reflect_conv3x3_cols=rc.reflect_conv3x3_cols,
                reflect_conv3x3_taps=rc.reflect_conv3x3_taps,
                reflect_out_conv7x7=rc.reflect_out_conv7x7,
                fused_fourier_unit=fu.fused_fourier_unit,
                reflect_down_conv3x3=rc.reflect_down_conv3x3,
                halo_conv_reflect_tiled=hc.halo_conv_reflect_tiled,
                halo_conv3x3_reflect=hc.halo_conv3x3_reflect)


GENERATOR_CLASSES = ('FFCResNetGenerator', 'GlobalGenerator',
                     'MultiDilatedGlobalGenerator')


@contextlib.contextmanager
def counting_forwards():
    """Counts the generator forwards run inside the block: yields a
    one-item list holding the count, which the caller may reset."""
    import torch
    forwards = [0]

    def count_forward(module, inputs, output):
        if type(module).__name__ in GENERATOR_CLASSES:
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(count_forward)
    try:
        yield forwards
    finally:
        hook.remove()


def serve(work, model_dir, per_forward=PER_FORWARD, label='big-lama',
          batch=BATCH, ckpt='best.ckpt'):
    """The predict CLI on synthetic PNGs (the model dir's checkpoint
    `ckpt`, `batch` images a forward), bf16 and fp32, wire fp32 and uint8:
    sizes, known pixels, bit-equal wires, and `per_forward` launches of
    each kernel per generator forward. Returns the launch counts by
    precision."""
    indir = os.path.join(work, 'in')
    sizes = write_images(indir, np.random.RandomState(0))
    launches = {}
    with counting_forwards() as forwards:
        for precision, wire in (('bf16', 'fp32'), ('fp32', 'fp32'),
                                ('bf16', 'uint8')):
            outdir = os.path.join(work, f'out_{label}_{precision}_{wire}')
            fns = reset_counts()
            forwards[0] = 0
            t0 = time.perf_counter()
            run_predict([f'model.path={model_dir}', f'model.checkpoint={ckpt}',
                         f'indir={indir}', f'outdir={outdir}', 'device=cuda',
                         f'batch_size={batch}', f'precision={precision}',
                         f'wire={wire}'])
            secs = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in fns.items()}
            n = forwards[0]
            log(f'serve {label} precision={precision} wire={wire}: {len(sizes)} '
                f'images in {secs:.1f} s, {n} forwards, launches {counts}')
            check(n > 0, 'no generator forward ran')
            for k, per in per_forward.items():
                check(counts[k] == per * n,
                      f'{k}: {counts[k]} launches in {n} forwards, expected '
                      f'{per} per forward')
            launches.setdefault(precision, counts)
            for i, (h, w) in enumerate(sizes):
                out = read_png(os.path.join(outdir, f'img{i}_mask.png'))
                img = read_png(os.path.join(indir, f'img{i}.png'))
                mask = read_png(os.path.join(indir, f'img{i}_mask.png'), 'L')
                check(out.shape == (h, w, 3), f'img{i}: shape {out.shape}')
                check(np.array_equal(out[mask == 0], img[mask == 0]),
                      f'img{i}: known pixels changed')
                check((out[mask > 0] != img[mask > 0]).any(),
                      f'img{i}: hole left as input')
    for i in range(len(sizes)):
        a, b = (read_png(os.path.join(work, f'out_{label}_bf16_{wire}',
                                      f'img{i}_mask.png'))
                for wire in ('fp32', 'uint8'))
        check(np.array_equal(a, b), f'img{i}: uint8 and fp32 wires differ')
    log(f'serve {label}: outputs at original size, known pixels kept, wires '
        'bit-equal')
    return launches


def refine_refused(work, model_dir):
    """refine=true on a generator without front and rear stages raises
    before any image is read (the CLI's main, called directly to see the
    exception its `-m` entry logs)."""
    from lama_tpu_torch import predict
    outdir = os.path.join(work, 'refine_refused')
    try:
        predict.main([f'model.path={model_dir}', f'indir={work}/in',
                      f'outdir={outdir}', 'device=cuda', 'refine=true'])
    except ValueError as e:
        check('front and rear' in str(e), f'refine refused with {e}')
        check(not os.path.exists(outdir), 'refine wrote outputs')
        log(f'refine=true on big-lama-regular refused: {e}')
        return
    raise RuntimeError('refine=true on big-lama-regular was not refused')


def write_refine_images(root, rng):
    """Image + mask (two rectangles) PNGs, sorted by name in this order:
    1024^2 twice, 1000x760 twice. The first of each size is its warm-up
    (the process's first passes at those shapes); the second is timed."""
    os.makedirs(root)
    sizes = [(1024, 1024), (1024, 1024), (1000, 760), (1000, 760)]
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w] / 96.0
        img = np.stack([np.sin(yy + i), np.cos(xx - i), np.sin(xx - yy)], -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(h, w, 3), 0, 1)
        mask = np.zeros((h, w), np.uint8)
        mask[h // 5:h // 5 + h // 4, w // 6:w // 6 + w // 3] = 255
        mask[h // 2:h // 2 + h // 6, w // 2:w // 2 + w // 4] = 255
        write_png(os.path.join(root, f'r{i}.png'),
                  np.rint(img * 255).astype(np.uint8))
        write_png(os.path.join(root, f'r{i}_mask.png'), mask)
    return sizes


def refine(work, model_dir):
    """`python -m lama_tpu_torch.predict refine=true precision=bf16` on the
    refine images; returns the launch counts. The CLI's call of
    `refinement.refine_predict` is wrapped for the run, to time each image
    (synchronised before and after) and to take its per-scale Adam-step
    losses (return_losses=True)."""
    import torch
    from lama_tpu_torch.evaluation import refinement
    from lama_tpu_torch.models.ffc import FFCResNetGenerator

    indir = os.path.join(work, 'refine_in')
    outdir = os.path.join(work, 'refine_out')
    sizes = write_refine_images(indir, np.random.RandomState(1))
    passes = {'front': 0, 'rear': 0, 'full': 0}
    finite = []
    seconds, losses = [], []
    refine_predict = refinement.refine_predict

    def timed_refine_predict(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, scale_losses = refine_predict(*args, return_losses=True,
                                           **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(scale_losses)
        return out

    def count_pass(module, inputs, output):
        if not isinstance(module, FFCResNetGenerator):
            return
        stage = ('rear' if isinstance(inputs[0], tuple) else
                 'front' if isinstance(output, tuple) else 'full')
        passes[stage] += 1
        outs = output if isinstance(output, tuple) else (output,)
        finite.extend(torch.isfinite(t).all() for t in outs if t is not None)

    hook = torch.nn.modules.module.register_module_forward_hook(count_pass)
    refinement.refine_predict = timed_refine_predict
    try:
        fns = reset_counts()
        t0 = time.perf_counter()
        run_predict([f'model.path={model_dir}', f'indir={indir}',
                     f'outdir={outdir}', 'device=cuda', 'precision=bf16',
                     'refine=true', f'refiner.n_iters={N_ITERS}'])
        secs = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in fns.items()}
    finally:
        refinement.refine_predict = refine_predict
        hook.remove()
    n = len(sizes)
    log(f'refine bf16: {n} images in {secs:.1f} s, passes {passes}, '
        f'launches {counts}')
    check(passes == {'front': 2 * n, 'rear': (1 + N_ITERS) * n, 'full': 0},
          f'refine passes {passes}: expected 2 front and {1 + N_ITERS} rear '
          'per image (two scales)')
    check(all(bool(f) for f in finite), 'refine: non-finite generator output')
    for k, per in PER_FORWARD.items():
        expected = per * passes['front' if k in FRONT_KERNELS else 'rear']
        check(counts[k] == expected,
              f'refine {k}: {counts[k]} launches, expected {expected}')
    check(len(seconds) == n, f'refine: {len(seconds)} refine_predict calls')
    for i, (h, w) in enumerate(sizes):
        check([len(v) for v in losses[i]] == [0, N_ITERS - 1],
              f'refine r{i}: Adam steps per scale {[len(v) for v in losses[i]]}')
        first, last = float(losses[i][-1][0]), float(losses[i][-1][-1])
        log(f'refine image {i}: {N_ITERS - 1} Adam steps at the second '
            f'scale, loss {first:.6f} -> {last:.6f}')
        check(last < first, f'refine r{i}: the loss did not fall')
        out = read_png(os.path.join(outdir, f'r{i}_mask.png'))
        img = read_png(os.path.join(indir, f'r{i}.png'))
        mask = read_png(os.path.join(indir, f'r{i}_mask.png'), 'L')
        check(out.shape == (h, w, 3), f'refine r{i}: shape {out.shape}')
        check(np.array_equal(out[mask == 0], img[mask == 0]),
              f'refine r{i}: known pixels changed')
        check((out[mask > 0] != img[mask > 0]).any(),
              f'refine r{i}: hole left as input')
        log(f'refine {h}x{w} bf16: {seconds[i]:.3f} s per image '
            f'(n_iters {N_ITERS}{"" if i % 2 else ", warm-up"})')
    return counts


def _refine_inputs(size, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    image = torch.rand(1, 3, size, size, generator=g)
    mask = torch.zeros(1, 1, size, size)
    mask[:, :, size // 4:size // 2, size // 3:2 * size // 3] = 1
    ref = torch.rand(1, 3, size // 2, size // 2, generator=g)
    return image.cuda(), mask.cuda(), ref.cuda()


def _signs(shape, gen):
    import torch
    return (torch.randint(0, 2, shape, generator=gen) * 2 - 1).float().cuda()


def _grad_diff(a, b):
    """(max |a - b| / max |b|, ||a - b|| / ||b||, cosine) over a list of
    gradient tensors, in float64 (so the cosine of tens of millions of
    elements is not lost to float32 rounding)."""
    import torch
    a = torch.cat([t.flatten() for t in a]).double()
    b = torch.cat([t.flatten() for t in b]).double()
    return (float((a - b).abs().max() / b.abs().max()),
            float((a - b).norm() / b.norm()),
            float((a * b).sum() / (a.norm() * b.norm())))


def _within(out, ref, precision):
    """(max |out - ref|, whether every element is within TOL[precision])."""
    import torch
    rtol, atol = TOL[precision]
    err = (out.float() - ref).abs()
    return float(err.max()), bool(torch.all(err <= atol + rtol * ref.abs()))


def refine_passes_vs_plain(gens):
    """At each REFINE_PASS_SIZES input (masked image + mask, batch 1): the
    front of the kernels generator (fp32 and bf16) vs the fp32 plain front,
    and the rear of each on the plain front's features vs the fp32 plain
    rear, at the kernels' TOL bounds."""
    import torch
    res = {}
    for h, w in REFINE_PASS_SIZES:
        g = torch.Generator().manual_seed(h + w)
        image = torch.rand(1, 3, h, w, generator=g)
        mask = torch.zeros(1, 1, h, w)
        mask[:, :, h // 5:h // 5 + h // 4, w // 6:w // 6 + w // 3] = 1
        x = torch.cat([image * (1 - mask), mask], 1).cuda()
        with torch.no_grad():
            z = gens['fp32', 'plain'](x, stage='front')
            ref = gens['fp32', 'plain'](z, stage='rear').float()
            for precision in ('fp32', 'bf16'):
                gen = gens[precision, 'cuda']
                front = gen(x, stage='front')
                rear = gen(z, stage='rear')
                errs = [_within(a, b.float(), precision)
                        for a, b in zip(front, z)] + [
                    _within(rear, ref, precision)]
                res[h, w, precision] = errs
                log(f'refine passes {h}x{w} {precision} kernels vs fp32 '
                    f'plain: front local max|d| {errs[0][0]:.3e}, global '
                    f'{errs[1][0]:.3e} (max|ref| {float(z[0].abs().max()):.3f}'
                    f', {float(z[1].abs().max()):.3f}); rear max|d| '
                    f'{errs[2][0]:.3e} (rtol, atol {TOL[precision]})')
    for key, errs in res.items():
        check(all(ok for _, ok in errs),
              f'refine passes {key}: kernels vs plain outside tolerance')
    return res


def refine_gradient_vs_plain(gens, size=512):
    """fp32: one scale's loss gradient w.r.t. z, kernels vs plain path, on
    the same z (the plain front's), against the plain path's own spread
    when z moves by REFINE_Z_EPS (relative, gaussian; the largest spread of
    REFINE_DRAWS draws, since one draw may or may not flip a given gate,
    and single draws on the same z differ severalfold). The targets
    (the image, and the previous scale's result) are the plain prediction
    offset by +-0.05 per element, away from the L1's kink."""
    import torch
    from lama_tpu_torch.evaluation import refinement as R
    from lama_tpu_torch.models.ffc import FourierUnit
    image, mask, _ = _refine_inputs(size, 4)
    x = torch.cat([image * (1 - mask), mask], 1)
    ek = R._ellipse_kernel(15)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        z0 = gens['fp32', 'plain'](x, stage='front')
        pred = gens['fp32', 'plain'](z0, stage='rear').float()
        image = pred - 0.05 * _signs(pred.shape, g)
        ref = R._pyrdown(pred)
        ref = ref - 0.05 * _signs(ref.shape, g)

    def grad(kernels, eps=0.0):
        z = [(t * (1 + eps * torch.randn(t.shape, generator=g).cuda()))
             .detach().requires_grad_() for t in z0]
        pred = gens['fp32', kernels](tuple(z), stage='rear').float()
        loss = R._scale_loss(pred, image, mask.expand(-1, 3, -1, -1), ref,
                             (size, size), ek)
        return torch.autograd.grad(loss, z)

    def faulty_grad(eps):
        """grad('cuda') with the first rear FourierUnit's output scaled by
        1 + eps * (random signs), in its forward and so in its backward;
        eps None: the output detached, so no gradient flows through it."""
        gen = gens['fp32', 'cuda']
        unit = next(m for m in gen.model[2 + gen.n_downsampling:].modules()
                    if isinstance(m, FourierUnit))
        signs = {}

        def fault(module, inputs, out):
            if eps is None:
                return out.detach()
            if 's' not in signs:
                signs['s'] = _signs(out.shape, g)
            return out * (1 + eps * signs['s'])

        handle = unit.register_forward_hook(fault)
        try:
            return grad('cuda')
        finally:
            handle.remove()

    plain = grad('plain')
    ours = _grad_diff(grad('cuda'), plain)
    draws = [_grad_diff(grad('plain', REFINE_Z_EPS), plain)
             for _ in range(REFINE_DRAWS)]
    floor = (max(d[0] for d in draws), max(d[1] for d in draws),
             min(d[2] for d in draws))

    def passes(d):
        return (d[0] <= REFINE_FLOOR_FACTOR * floor[0]
                and d[1] <= REFINE_FLOOR_FACTOR * floor[1]
                and d[2] >= 1 - REFINE_COS_TOL)

    controls = {eps: _grad_diff(faulty_grad(eps), plain)
                for eps in REFINE_CONTROL_EPS + (None,)}
    log(f'refine gradient fp32 {size}^2, kernels vs plain: max|d|/max|g| '
        f'{ours[0]:.3e}, ||d||/||g|| {ours[1]:.3e}, cosine {ours[2]:.8f}; '
        f'plain vs plain with z x (1 + {REFINE_Z_EPS} noise), largest of '
        f'{REFINE_DRAWS} draws: {floor[0]:.3e}, {floor[1]:.3e}, '
        f'{floor[2]:.8f} (single draws: max '
        + ', '.join(f'{d[0]:.2e}' for d in draws) + ')')
    for eps, d in controls.items():
        fault = ('gradient dropped' if eps is None else
                 f'output x (1 + {eps} signs)')
        log(f'refine gradient control, one FourierUnit {fault}: {d[0]:.3e}, '
            f'{d[1]:.3e}, {d[2]:.8f}: '
            + ('passes the check' if passes(d) else 'rejected'))
    check(passes(ours),
          'refine gradient: kernels vs plain beyond the plain path\'s spread')
    check(not passes(controls[None]),
          'refine gradient: the check let a dropped gradient pass')
    return ours, floor, controls


def device_profile(fn, label, top=10, tries=3):
    """One call of fn under torch.profiler, after one call in the
    profiler's warm-up step (a window's first kernels can go unrecorded:
    without it a served forward's stem and first BN were missing): wall
    ms, device-kernel ms, idle share, the kernels with the most device
    time, then the port's own kernels (csrc/) below those. A trace with no
    device event (seen in 1 of 8 profiled forwards) is taken again, up to
    `tries` times, then reported as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, tries + 1):
        traces = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traces.append(p.key_averages())
                     ) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            prof.step()
        # the step's own range (ProfilerStep*) spans the whole call on the
        # device
        kernels = [e for e in (traces[0] if len(traces) == 1 else [])
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith('ProfilerStep')]
        if kernels:
            break
        log(f'{label} profiled: no device event in the trace (try {attempt} '
            f'of {tries})')
    if not kernels:
        log(f'{label} profiled: wall {wall:.1f} ms, device kernels not '
            'measured')
        return dict(wall_ms=wall, device_ms=None, idle=None)
    dev = {e.key: e.self_device_time_total for e in kernels}
    counts = {e.key: e.count for e in kernels}
    busy = sum(dev.values()) / 1e3
    log(f'{label} profiled: wall {wall:.1f} ms, device kernels {busy:.1f} '
        f'ms, idle share {1 - busy / wall:.3f}')
    ranked = sorted(dev.items(), key=lambda kv: -kv[1])
    for i, (name, us) in enumerate(ranked):
        if i < top or (OWN_KERNEL_NS in name and 'at::' not in name):
            log(f'  {us / 1e3:8.2f} ms {counts[name]:5d}x {name[:100]}')
    return dict(wall_ms=wall, device_ms=busy, idle=1 - busy / wall)


def wrapper_device_ms(fn, label):
    """Device ms of each reflect-conv and halo-conv wrapper in one call of
    fn, by kernel symbol: CUDA events recorded on the current stream around
    each wrapper's launch (its weight relayout and its kernel), read after
    one synchronize. The profiler cannot split them: the bf16 cols and taps
    convs are one kernel (conv3x3_wgmma.cu at stride 1)."""
    import torch
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    from lama_tpu_torch.ops.kernels import reflect_conv as rc
    events = []

    def timed(launch):
        def run(symbol, *args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = launch(symbol, *args, **kwargs)
            b.record()
            events.append((symbol, a, b))
            return out
        return run

    saved = rc._launch, hc._launch
    rc._launch, hc._launch = timed(rc._launch), timed(hc._launch)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        rc._launch, hc._launch = saved
    totals = {}
    for symbol, a, b in events:
        ms, n = totals.get(symbol, (0.0, 0))
        totals[symbol] = (ms + a.elapsed_time(b), n + 1)
    for symbol, (ms, n) in sorted(totals.items()):
        log(f'{label} device ms by wrapper: {symbol} {ms:.3f} ms over {n} '
            f'launches ({ms / n:.4f} per launch)')
    return totals


def refine_step_split(gen, size=1024, iters=3, top=10):
    """Host time of one Adam step's rear forward + loss and of its backward,
    bf16 kernels, at the second scale of a size^2 image; then one more step
    under torch.profiler: device-busy share and the kernels with the most
    device time."""
    import torch
    from lama_tpu_torch.evaluation import refinement as R
    image, mask, ref = _refine_inputs(size, 5)
    x = torch.cat([image * (1 - mask), mask], 1)
    ek = R._ellipse_kernel(15)
    mask3 = mask.expand(-1, 3, -1, -1)
    with torch.no_grad():
        z = [t.detach().requires_grad_() for t in gen(x, stage='front')]

    def forward():
        return R._scale_loss(gen(tuple(z), stage='rear').float(), image,
                             mask3, ref, (size, size), ek)

    fwd, bwd = [], []
    for i in range(iters + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        if i:   # the first step warms up
            fwd.append(t1 - t0)
            bwd.append(time.perf_counter() - t1)
    f, b = float(np.mean(fwd)) * 1e3, float(np.mean(bwd)) * 1e3
    log(f'refine Adam step bf16 {size}^2: rear forward + loss {f:.1f} ms, '
        f'backward {b:.1f} ms, backward share {b / (f + b):.3f}')

    device_profile(lambda: forward().backward(),
                   f'refine Adam step bf16 {size}^2', top)
    return dict(forward_ms=f, backward_ms=b, backward_share=b / (f + b))


def make_generators(gen_kwargs, sd, kind='ffc_resnet'):
    import torch
    from lama_tpu_torch.models import make_generator
    gens = {}
    for precision, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        for kernels in ('cuda', 'plain'):
            g = make_generator(kind, dtype=dtype, kernels=kernels,
                               **gen_kwargs)
            g.load_state_dict(sd, strict=True)
            gens[precision, kernels] = g.cuda().eval().requires_grad_(False)
    return gens


def random_batch(b, size, seed):
    import torch
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand(b, 3, size, size, generator=gen)
    mask = (torch.rand(b, 1, size // 32, size // 32, generator=gen) > 0.6)
    mask = mask.float().repeat_interleave(32, 2).repeat_interleave(32, 3)
    return torch.cat([img * (1 - mask), mask], 1).cuda()


def generator_vs_plain(gens, label='big-lama'):
    import torch
    x = random_batch(2, 512, 1)
    with torch.inference_mode():
        out = gens['fp32', 'cuda'](x)
        ref = gens['fp32', 'plain'](x)
        bf = gens['bf16', 'cuda'](x)
    check(out.shape == (2, 3, 512, 512), f'generator output {out.shape}')
    check(bool(torch.isfinite(out).all()), 'non-finite generator output')
    err = float((out - ref).abs().max())
    err_bf16 = float((bf.float() - ref).abs().max())
    log(f'generator {label} 512^2 b2 fp32: kernels vs plain max|d| {err:.3e} '
        f'(atol {GEN_ATOL}); bf16 kernels vs fp32 plain max|d| {err_bf16:.3e}')
    check(err <= GEN_ATOL, f'generator {label} kernels vs plain outside '
          'tolerance')
    return err


def throughput(gens, card_line, iters=3, label='big-lama'):
    import torch
    x = random_batch(16, 512, 2)
    res = {}
    with torch.inference_mode():
        for precision in ('bf16', 'fp32'):
            times = {'cuda': [], 'plain': []}
            for kernels in ('plain', 'cuda', 'cuda', 'plain'):
                g = gens[precision, kernels]
                g(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    g(x)
                torch.cuda.synchronize()
                times[kernels].append(16 * iters / (time.perf_counter() - t0))
            res[precision] = {k: float(np.mean(v)) for k, v in times.items()}
            log(f'throughput {label} 512^2 b16 {precision}: kernels '
                f'{res[precision]["cuda"]:.2f} img/s, plain '
                f'{res[precision]["plain"]:.2f} img/s ({card_line})')
            for kernels in ('cuda', 'plain'):
                device_profile(lambda: gens[precision, kernels](x),
                               f'{label} 512^2 b16 {precision} {kernels}')
            wrapper_device_ms(lambda: gens[precision, 'cuda'](x),
                              f'{label} 512^2 b16 {precision}')
    return res


# ---------------------------------------------------------------- training
TRAIN_BATCH, TRAIN_SIZE = 10, 256   # configs/training/data/abl-04-256-mh-dist
TRAIN_STEPS, TRAIN_WARMUP = 6, 2    # steps per run; the first ones warm up
# phase 6's bf16 big-lama run keeps an EMA of the generator from its first
# step, so phase 18's make_checkpoint deploys trained EMA weights
TRAIN_EMA = ('training_model.average_generator=true',
             'training_model.average_generator_start_step=0',
             'training_model.average_generator_period=1')
REGULAR_TRAIN_STEPS = 4             # big-lama-regular: 2 timed after warm-up
# one fp32 G step, kernels vs kernels='plain': the losses within
# TRAIN_LOSS_RTOL; the G gradient within TRAIN_FLOOR_FACTOR times the plain
# path's own spread when the images move by TRAIN_X_EPS (relative, gaussian;
# the largest of TRAIN_DRAWS draws), by three measures: max |d| / max |g|,
# the norm of d with each tensor divided by its own gradient norm (so a
# small tensor's fault weighs as much as a large one's), and 1 - cosine
TRAIN_LOSS_RTOL, TRAIN_X_EPS, TRAIN_DRAWS, TRAIN_FLOOR_FACTOR = 1e-4, 1e-6, 8, 2.0


def write_train_images(root, n, rng):
    """n synthetic 8-bit JPEGs of 288x320 under root/train (the train
    dataset reads **/*.jpg, as the reference's does)."""
    import cv2
    os.makedirs(os.path.join(root, 'train'))
    h, w = 288, 320
    yy, xx = np.mgrid[0:h, 0:w] / 40.0
    for i in range(n):
        img = np.stack([np.sin(yy + i), np.cos(xx - i), np.sin(xx + yy)], -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(h, w, 3), 0, 1)
        cv2.imwrite(os.path.join(root, 'train', f'{i:03d}.jpg'),
                    np.rint(img[..., ::-1] * 255).astype(np.uint8))


def _params_and_stats(trainer):
    out = {}
    for prefix, mod in (('G.', trainer.state.generator),
                        ('D.', trainer.state.discriminator)):
        out.update({prefix + k: v.detach().clone()
                    for k, v in mod.state_dict().items()})
    return out


def train_run(work, precision, config_name='big-lama', steps=TRAIN_STEPS,
              per_step=PER_TRAIN_STEP, val_dir=None, extra=(), tag=''):
    """`python -m lama_tpu_torch.train -cn <config_name> <extra>` (in this
    process, as `-m` runs it) at batch TRAIN_BATCH, TRAIN_SIZE^2, for
    `steps` steps of one epoch. The trainer's step is wrapped for the run:
    each step is synchronised before and after and timed (its draws,
    `InpaintingTrainStep.draw`, included), its metrics read, its
    fake-fakes draw kept, and its launches counted (each must equal
    `per_step`, or `per_step(use_ff)` when that is a function of the
    step's fake-fakes draw). With `val_dir` the epoch ends with validation
    on it, whose launches and generator forwards are counted apart
    (`val_counts`, `val_forwards`) and left out of the run's `launches`.
    Returns the run's record and the trainer."""
    import torch
    from lama_tpu_torch.training import step as step_mod
    from lama_tpu_torch.training import trainer as trainer_mod
    rec = dict(step_ms=[], metrics=[], counts=[], use_ff=[])
    call, fit = step_mod.InpaintingTrainStep.__call__, trainer_mod.InpaintingTrainer.fit
    validate = trainer_mod.InpaintingTrainer.validate

    def timed_call(self, state, image, mask, draws=None):
        fns = kernel_wrappers()
        before = {k: f.launches for k, f in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        draws = self.draw(state.step, image) if draws is None else draws
        metrics = {k: float(v) for k, v in
                   call(self, state, image, mask, draws).items()}
        torch.cuda.synchronize()
        rec['step_ms'].append((time.perf_counter() - t0) * 1e3)
        rec['counts'].append({k: f.launches - before[k] for k, f in fns.items()})
        rec['metrics'].append(metrics)
        rec['use_ff'].append(draws.use_ff)
        rec['batch'] = (image, mask)
        return metrics

    def recording_fit(self, resume_from=None):
        rec['trainer'], rec['before'] = self, _params_and_stats(self)
        torch.cuda.reset_peak_memory_stats()
        return fit(self, resume_from)

    def counted_validate(self, epoch):
        fns = kernel_wrappers()
        before = {k: f.launches for k, f in fns.items()}
        t0 = time.perf_counter()
        with counting_forwards() as forwards:
            out = validate(self, epoch)
        rec['val_seconds'] = time.perf_counter() - t0
        rec['val_counts'] = {k: f.launches - before[k] for k, f in fns.items()}
        rec['val_forwards'] = forwards[0]
        rec['val_metrics'] = out
        return out

    data = os.path.join(work, 'train_data')
    run_dir = os.path.join(work, f'train_{config_name}_{precision}{tag}')
    argv = ['-cn', config_name, f'location.data_root_dir={data}',
            f'location.out_root_dir={work}', f'location.tb_dir={work}',
            f'location.pretrained_models={work}', f'run_dir={run_dir}',
            f'data.batch_size={TRAIN_BATCH}', f'data.train.out_size={TRAIN_SIZE}',
            'data.num_workers=4', 'trainer.kwargs.max_epochs=1',
            f'trainer.kwargs.limit_train_batches={steps}',
            'trainer.kwargs.log_every_n_steps=1',
            f'trainer.kwargs.precision={"bf16" if precision == "bf16" else 32}',
            'losses.resnet_pl.allow_random_weights=true', 'device=cuda']
    if val_dir:
        argv += [f'data.val.indir={val_dir}', 'data.val.img_suffix=.png']
    argv += list(extra)
    step_mod.InpaintingTrainStep.__call__ = timed_call
    trainer_mod.InpaintingTrainer.fit = recording_fit
    trainer_mod.InpaintingTrainer.validate = counted_validate
    fns = reset_counts()
    t0 = time.perf_counter()
    try:
        run_module('lama_tpu_torch.train', argv)
    finally:
        step_mod.InpaintingTrainStep.__call__ = call
        trainer_mod.InpaintingTrainer.fit = fit
        trainer_mod.InpaintingTrainer.validate = validate
    rec['seconds'] = time.perf_counter() - t0
    rec['launches'] = {k: fn.launches - rec['val_counts'][k]
                       for k, fn in fns.items()}
    rec['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec['run_dir'] = run_dir
    trainer = rec.pop('trainer')
    n = len(rec['step_ms'])
    label = f'{config_name}{tag} {precision}'
    check(n == steps, f'train {label}: {n} steps, expected {steps}')
    for i, (m, c, ff) in enumerate(zip(rec['metrics'], rec['counts'],
                                      rec['use_ff'])):
        check(all(math.isfinite(v) for v in m.values()),
              f'train {label} step {i}: non-finite loss {m}')
        expected = per_step(ff) if callable(per_step) else per_step
        check(c == expected,
              f'train {label} step {i}: launches {c}, expected {expected}')
    after = _params_and_stats(trainer)
    for group in ('G.', 'D.'):
        for kind in ('weight', 'running_mean', 'running_var'):
            keys = [k for k in after if k.startswith(group) and k.endswith(kind)]
            moved = sum(not torch.equal(after[k], rec['before'][k]) for k in keys)
            check(keys and moved == len(keys),
                  f'train {label}: {len(keys) - moved} of {len(keys)} '
                  f'{group}*{kind} unchanged')
    timed = rec['step_ms'][TRAIN_WARMUP:]
    rec['ms_per_step'] = float(np.mean(timed))
    log(f'train {label} b{TRAIN_BATCH} {TRAIN_SIZE}^2: '
        f'{n} steps in {rec["seconds"]:.1f} s (run incl. setup), '
        f'{rec["ms_per_step"]:.1f} ms per step (mean of {len(timed)} after '
        f'{TRAIN_WARMUP} warm-up; all: '
        + ', '.join(f'{t:.1f}' for t in rec['step_ms'])
        + f'), peak memory {rec["peak_gib"]:.2f} GiB, launches per step '
        f'{rec["counts"][-1]}')
    first, last = rec['metrics'][0], rec['metrics'][-1]
    log(f'train {label} losses, step 0 -> {n - 1}: ' + ', '.join(
        f'{k} {first[k]:.4f} -> {last[k]:.4f}' for k in sorted(first)))
    log(f'train {label}: G and D weights and BN statistics all moved')
    del rec['before']
    if val_dir:
        check_validation(rec, run_dir, label)
    return rec, trainer


VAL_N, VAL_SIZE = 8, 256   # the bf16 big-lama train run's val set


def write_val_images(root, rng, n=VAL_N, size=VAL_SIZE):
    """n image + mask PNG pairs (eval layout, .png images), the masks'
    areas one in each of n mask-area bins."""
    os.makedirs(root)
    yy, xx = np.mgrid[0:size, 0:size] / 24.0
    for i in range(n):
        img = np.stack([np.sin(yy + i), np.cos(xx - i), np.sin(xx + yy)], -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(size, size, 3), 0, 1)
        mask = np.zeros((size, size), np.uint8)
        rows = int(round((0.05 + 0.1 * i) * size))
        y0 = rng.randint(0, size - rows + 1)
        mask[y0:y0 + rows] = 255
        write_png(os.path.join(root, f'v{i}.png'),
                  np.rint(img * 255).astype(np.uint8))
        write_png(os.path.join(root, f'v{i}_mask.png'), mask)


def check_validation(rec, run_dir, label):
    """The run's validation: val_* metrics finite and logged, each eval
    forward launching the served counts, the best-k checkpoint written
    beside last.ckpt."""
    val = rec['val_metrics']
    n, counts = rec['val_forwards'], rec['val_counts']
    check(n > 0 and val, f'train {label}: no validation ran')
    for k, per in PER_FORWARD.items():
        check(counts[k] == per * n, f'train {label} validation: {k} '
              f'{counts[k]} launches in {n} forwards, expected {per} each')
    totals = {k: v for k, v in val.items() if '_total_' in k}
    for key in ('val_ssim_total_mean', 'val_lpips_total_mean',
                'val_fid_total_mean', 'val_ssim_fid100_f1_total_mean'):
        check(key in totals and math.isfinite(totals[key]),
              f'train {label} validation: {key} {totals.get(key)}')
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        logged = [json.loads(ln) for ln in f]
    check(any(ln.get('val_ssim_total_mean') == val['val_ssim_total_mean']
              for ln in logged), f'train {label}: val metrics not logged')
    models = os.path.join(run_dir, 'models')
    with open(os.path.join(models, 'index.json')) as f:
        records = json.load(f)
    check(len(records) == 1 and records[0]['value'] ==
          val['val_ssim_fid100_f1_total_mean'] and
          os.path.isfile(os.path.join(models, records[0]['name'])) and
          os.path.isfile(os.path.join(models, 'last.ckpt')),
          f'train {label}: best-k checkpoints {records}')
    rec['best_checkpoint'] = records[0]['name']
    log(f'train {label} validation: {len(val)} metrics from {n} forwards in '
        f'{rec["val_seconds"]:.1f} s, launches {counts}; '
        + ', '.join(f'{k} {v:.4f}' for k, v in totals.items())
        + f'; best-k {records[0]["name"]} beside last.ckpt')


def run_module(name, argv):
    """`python -m <name> <argv>`, in this process."""
    saved = sys.argv
    sys.argv = [name] + list(argv)
    try:
        runpy.run_module(name, run_name='__main__', alter_sys=True)
    except SystemExit as e:
        check(e.code in (0, None), f'{name} exited with {e.code}')
    finally:
        sys.argv = saved


def train_step_split(trainer, image, mask, precision, iters=3, label='big-lama'):
    """Host ms of each phase of a train step (synchronised between phases),
    the mean over `iters` after one warm-up; then one whole step under
    torch.profiler."""
    import torch
    from lama_tpu_torch.ops.precision import widen
    st, step = trainer.state, trainer.step_fn
    gen, disc = st.generator, st.discriminator
    names = ('G forward + losses', 'G backward', 'G optimizer',
             'G re-forward', 'D forward + R1 + losses', 'D backward',
             'D optimizer')
    times = {k: [] for k in names}

    def tick():
        torch.cuda.synchronize()
        return time.perf_counter()

    for i in range(iters + 1):
        t = [tick()]
        disc.requires_grad_(False)
        total, _ = step.generator_loss(gen, disc, image, mask)
        t.append(tick())
        total.backward()
        disc.requires_grad_(True)
        t.append(tick())
        st.g_opt.step()
        st.g_opt.zero_grad(set_to_none=True)
        t.append(tick())
        with torch.no_grad():
            pred = widen(gen(step.generator_input(image, mask)))
        t.append(tick())
        d_total, _ = step.discriminator_loss(disc, image, pred, mask)
        t.append(tick())
        d_total.backward()
        t.append(tick())
        st.d_opt.step()
        st.d_opt.zero_grad(set_to_none=True)
        t.append(tick())
        if i:
            for k, a, b in zip(names, t, t[1:]):
                times[k].append((b - a) * 1e3)
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    fwd = ms['G forward + losses'] + ms['G re-forward'] + ms['D forward + R1 + losses']
    bwd = ms['G backward'] + ms['D backward']
    log(f'train step split {label} {precision}: ' + ', '.join(
        f'{k} {v:.1f} ms' for k, v in ms.items())
        + f'; forward {fwd:.1f} ms, backward {bwd:.1f} ms, backward share '
        f'{bwd / (fwd + bwd):.3f}')
    device_profile(lambda: step(st, image, mask),
                   f'train step {label} {precision} b{TRAIN_BATCH} '
                   f'{TRAIN_SIZE}^2', top=12)
    return dict(ms, forward_ms=fwd, backward_ms=bwd)


def _normed_diff(a, b):
    """|| (a_t - b_t) / ||b_t|| || over the tensors t whose gradient norm is
    at least 1e-4 of the largest: the biases of the convs a train-mode BN
    follows have a zero gradient but for rounding, which this leaves out."""
    norms = [float(y.norm()) for y in b]
    keep = 1e-4 * max(norms)
    return math.sqrt(sum(float((x - y).norm()) ** 2 / n ** 2
                         for x, y, n in zip(a, b, norms) if n >= keep))


def train_gradient_vs_plain(trainer, image, mask):
    """fp32, one G step's objective and its gradient w.r.t. the generator,
    kernels vs kernels='plain' (the same weights, discriminator and batch),
    against the plain path's own spread; the stem's gradient dropped (its
    conv's output detached: the FFC stem's l2l conv, the GlobalGenerator's
    `model.1`) is the planted control that must be rejected."""
    import torch
    from lama_tpu_torch.models import make_generator
    st, step = trainer.state, trainer.step_fn
    gen, disc = st.generator, st.discriminator
    kw = dict(trainer.config.generator)
    plain = make_generator(kw.pop('kind'), dtype=torch.float32, kernels='plain', **kw)
    plain.load_state_dict(gen.state_dict())
    plain = plain.cuda().train()
    g = torch.Generator().manual_seed(9)

    def grads(model, eps=0.0, drop_stem=False):
        img = image * (1 + eps * torch.randn(image.shape, generator=g).cuda()) \
            if eps else image
        stem = model.model[1]
        stem = stem.ffc.convl2l if hasattr(stem, 'ffc') else stem
        handle = (stem.register_forward_hook(lambda m, i, o: o.detach())
                  if drop_stem else None)
        disc.requires_grad_(False)
        try:
            total, metrics = step.generator_loss(model, disc, img, mask)
            params = list(model.parameters())
            out = torch.autograd.grad(total, params, allow_unused=True)
        finally:
            disc.requires_grad_(True)
            if handle is not None:
                handle.remove()
        metrics = dict({k: float(v) for k, v in metrics.items()},
                       total=float(total.detach()))
        return metrics, [torch.zeros_like(p) if o is None else o
                         for p, o in zip(params, out)]

    ref_m, ref = grads(plain)
    ours_m, ours = grads(gen)
    for k, v in ref_m.items():
        check(abs(ours_m[k] - v) <= TRAIN_LOSS_RTOL * abs(v),
              f'train G step {k}: kernels {ours_m[k]} vs plain {v}')

    def diff(a):
        d = _grad_diff(a, ref)
        return (d[0], _normed_diff(a, ref), 1 - d[2])

    draws = [diff(grads(plain, TRAIN_X_EPS)[1]) for _ in range(TRAIN_DRAWS)]
    floor = [max(d[i] for d in draws) for i in range(3)]

    def passes(d):   # the slack covers a floor of exactly 0 (1 - cos)
        return all(x <= TRAIN_FLOOR_FACTOR * f + 1e-9 for x, f in zip(d, floor))

    ours_d = diff(ours)
    control = diff(grads(gen, drop_stem=True)[1])
    log(f'train G step {trainer.config.generator.kind} fp32 kernels vs '
        'plain: losses ' + ', '.join(
        f'{k} {ours_m[k]:.6f}/{ref_m[k]:.6f}' for k in sorted(ref_m))
        + f'; gradient max|d|/max|g| {ours_d[0]:.3e}, per-tensor-normed '
        f'||d|| {ours_d[1]:.3e}, 1-cos {ours_d[2]:.3e}; plain vs plain with '
        f'images x (1 + {TRAIN_X_EPS} noise), largest of {TRAIN_DRAWS}: '
        + ', '.join(f'{f:.3e}' for f in floor)
        + f'; ours / ({TRAIN_FLOOR_FACTOR} x largest), pass <= 1: '
        + ', '.join(f'{x / (TRAIN_FLOOR_FACTOR * f):.3f}' if f else 'inf'
                    for x, f in zip(ours_d, floor))
        + f'; control (stem gradient dropped): '
        + ', '.join(f'{c:.3e}' for c in control)
        + (': passes the check' if passes(control) else ': rejected'))
    check(passes(ours_d), 'train G step: kernels vs plain beyond the plain '
          "path's spread")
    check(not passes(control), 'train G step: the check let a dropped stem '
          'gradient pass')
    return dict(ours=ours_d, floor=floor, control=control)


def serve_checkpoint(work, run_dir, ckpt='last.ckpt'):
    """The trained run dir served by `python -m lama_tpu_torch.predict`
    (its checkpoint `ckpt`) on the serve phase's images."""
    indir = os.path.join(work, 'in')
    outdir = f'{run_dir}_served_{ckpt}'
    run_predict([f'model.path={run_dir}', f'model.checkpoint={ckpt}',
                 f'indir={indir}', f'outdir={outdir}', 'device=cuda',
                 f'batch_size={BATCH}', 'precision=bf16'])
    n = 0
    for name in sorted(os.listdir(indir)):
        if name.endswith('_mask.png'):
            img = read_png(os.path.join(indir, name.replace('_mask', '')))
            mask = read_png(os.path.join(indir, name), 'L')
            out = read_png(os.path.join(outdir, name))
            check(out.shape == img.shape, f'trained serve {name}: {out.shape}')
            check(np.array_equal(out[mask == 0], img[mask == 0]),
                  f'trained serve {name}: known pixels changed')
            n += 1
    check(n > 0, 'trained serve: no images')
    log(f'train: {run_dir}/models/{ckpt} served {n} images')


def train(work, config_name='big-lama', steps=TRAIN_STEPS,
          per_step=PER_TRAIN_STEP):
    """The train phase: bf16 and fp32 runs, each step's losses finite and
    its launches counted, the weights moved; the phase split and a profiled
    step; the fp32 G step against the plain path; the checkpoint served."""
    write_train_images(os.path.join(work, 'train_data'), TRAIN_BATCH * steps,
                       np.random.RandomState(3))
    val_dir = None
    if config_name == 'big-lama':
        val_dir = os.path.join(work, 'val_data')
        write_val_images(val_dir, np.random.RandomState(4))
    out = {}
    for precision in ('bf16', 'fp32'):
        bf16_val = precision == 'bf16' and val_dir is not None
        rec, trainer = train_run(work, precision, config_name, steps, per_step,
                                 val_dir if bf16_val else None,
                                 extra=TRAIN_EMA if bf16_val else ())
        image, mask = rec.pop('batch')
        rec['split'] = train_step_split(trainer, image, mask, precision,
                                        label=config_name)
        if precision == 'fp32':
            rec['gradient'] = train_gradient_vs_plain(trainer, image, mask)
        out[precision] = rec
        del trainer
    serve_checkpoint(work, out['bf16']['run_dir'])
    if val_dir:
        serve_checkpoint(work, out['bf16']['run_dir'],
                         out['bf16']['best_checkpoint'])
    return out


# -------------------------------------------------- the rest of training
REST_STEPS = 4   # each phase-15 run: 2 timed after 2 warm-up
# -cn ablv2_work_no_segmpl_vgg: the GlobalGenerator of 9 ResnetBlocks (two
# kernel-6 convs each), the stem and the head per forward, two forwards a
# step; the pix2pixHD discriminator and the VGG19 trunk are zero-padded
ABLV2_PER_TRAIN_STEP = dict(REGULAR_PER_TRAIN_STEP, halo_conv3x3_reflect=36)
# run B: big-lama's G step counts, and the FFC discriminator (ndf 64,
# n_layers 4) per forward: kernel 6 at L0 and L4, kernel 4 at L1-L3; four
# forwards a step (G step: reals, fakes; D step: reals with R1, fakes),
# a fifth when the step's fake-fakes draw is 1
FFC_D_PER_FORWARD = dict(halo_conv3x3_reflect=2, reflect_down_conv3x3=3)
REST_B = [
    'discriminator.kind=ffc_nlayer', '+training_model.fake_fakes_proba=0.5',
    '+training_model.distance_weighter_kwargs.kind=pps',
    '+training_model.distance_weighted_mask_for_discr=true',
    '+training_model.add_noise_kwargs.scales=4', 'generator.input_nc=8',
    'losses.adversarial.r1_every=2',
    '+training_model.rescale_scheduler_kwargs.kind=ladder',
    '+training_model.rescale_scheduler_kwargs.start_iters=[2]',
    '+training_model.rescale_scheduler_kwargs.values=[224,256]',
    '+training_model.const_area_crop_kwargs.min_size=192',
    '+training_model.const_area_crop_kwargs.max_size=256',
    '+training_model.const_area_crop_kwargs.area=50176',
    'trainer.kwargs.input_transfer_dtype=uint8']
# the D-step check (fp32, run B's trainer): the gradient of the D loss with
# R1 w.r.t. the FFC discriminator's weights, kernels vs kernels='plain',
# within TRAIN_FLOOR_FACTOR times the plain path's own spread, as for G
# (the largest of TRAIN_DRAWS draws of TRAIN_X_EPS noise on the images), by
# the G check's three measures; the control (R1's gradient detached: the
# penalty's second-order term dropped) must fall outside. D_REPEATS batches.
D_REPEATS = 5


def rest_b_per_step(use_ff):
    forwards = 4 + int(use_ff)
    out = dict(PER_TRAIN_STEP)
    for k, v in FFC_D_PER_FORWARD.items():
        out[k] += v * forwards
    return out


def write_shards(root, images, n_shards=4):
    """The JPEGs of `images` (a directory) as tar shards
    root/part{00000..n-1}.tar, the web dataset's layout."""
    import tarfile
    os.makedirs(root)
    names = sorted(os.listdir(images))
    for s in range(n_shards):
        with tarfile.open(os.path.join(root, f'part{s:05d}.tar'), 'w') as tf:
            for name in names[s::n_shards]:
                tf.add(os.path.join(images, name), arcname=name)
    return os.path.join(root, f'part{{00000..{n_shards - 1:05d}}}.tar')


def write_online_val_images(root, rng, n=VAL_N, size=VAL_SIZE):
    """n PNG images (no masks: the online val set draws them on load)."""
    os.makedirs(root)
    yy, xx = np.mgrid[0:size, 0:size] / 20.0
    for i in range(n):
        img = np.stack([np.cos(yy - i), np.sin(xx + i), np.cos(xx - yy)], -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(size, size, 3), 0, 1)
        write_png(os.path.join(root, f'o{i}.png'),
                  np.rint(img * 255).astype(np.uint8))


def one_image_fid(val_metrics, key):
    """Whether `key` is the FID of a mask-area group that holds one image,
    which the evaluator defines as NaN (evaluation/scores.py, as lama_tpu's):
    its SSIM and LPIPS spreads are 0. The online val set draws its masks
    from an unseeded generator, as lama_tpu's and the reference's do, so a
    group of one image comes and goes between runs."""
    if not (key.startswith('val_fid_') and key.endswith('_mean')):
        return False
    group = key[len('val_fid_'):-len('_mean')]
    return group != 'total' and all(
        val_metrics.get(f'val_{m}_{group}_std') == 0 for m in ('ssim', 'lpips'))


def d_step_gradient_vs_plain(trainer):
    """fp32: the gradient of the D objective with R1 (run B's step: fake
    fakes aside) w.r.t. the FFC discriminator's weights, with kernels and
    with kernels='plain' (the same weights), on D_REPEATS batches (reals
    and fakes drawn from seeds, run B's masks); each against the plain
    path's own spread, and the detached-R1 control, which must fall
    outside it. Returns the largest ratio of each measure over the
    repeats, the control's smallest and the seconds."""
    import torch
    from lama_tpu_torch.models import make_discriminator
    from lama_tpu_torch.ops.precision import widen
    t_start = time.perf_counter()
    step, disc = trainer.step_fn, trainer.state.discriminator
    kw = dict(trainer.config.discriminator)
    plain = make_discriminator(kw.pop('kind'), dtype=torch.float32,
                               kernels='plain', **kw)
    plain.load_state_dict(disc.state_dict())
    plain = plain.cuda().train()
    adv = step.adversarial
    g = torch.Generator().manual_seed(19)

    def detached_r1(score, real):   # the planted fault
        grad, = torch.autograd.grad(score.sum(), real, retain_graph=True)
        return widen(grad).reshape(grad.shape[0], -1).square().sum(1).mean()

    def grads(model, img, pred, mask, eps=0.0, fault=False):
        if eps:
            img = img * (1 + eps * torch.randn(img.shape, generator=g).cuda())
            pred = pred * (1 + eps * torch.randn(pred.shape, generator=g).cuda())
        if fault:
            adv.r1_penalty = detached_r1
        try:
            loss, metrics = step.discriminator_loss(model, img, pred, mask,
                                                    take_r1=True)
        finally:
            adv.__dict__.pop('r1_penalty', None)
        params = list(model.parameters())
        out = torch.autograd.grad(loss, params)
        return float(loss.detach()), float(metrics['discr_real_gp']), out

    worst, control_min = [0.0, 0.0, 0.0], [math.inf] * 3
    shape = (TRAIN_BATCH, 3, TRAIN_SIZE, TRAIN_SIZE)
    for r in range(D_REPEATS):
        mask = random_batch(TRAIN_BATCH, TRAIN_SIZE, 41 + r)[:, 3:]
        img, pred = (torch.rand(shape, generator=g).cuda() for _ in range(2))
        ref_l, ref_gp, ref = grads(plain, img, pred, mask)
        ours_l, ours_gp, ours = grads(disc, img, pred, mask)
        check(abs(ours_l - ref_l) <= TRAIN_LOSS_RTOL * abs(ref_l)
              and abs(ours_gp - ref_gp) <= 1e-3 * abs(ref_gp) and ref_gp > 0,
              f'D step {r}: loss {ours_l}/{ref_l}, R1 {ours_gp}/{ref_gp}')

        def diff(a):
            d = _grad_diff(a, ref)
            return (d[0], _normed_diff(a, ref), 1 - d[2])

        draws = [diff(grads(plain, img, pred, mask, TRAIN_X_EPS)[2])
                 for _ in range(TRAIN_DRAWS)]
        floor = [max(d[i] for d in draws) for i in range(3)]
        ratios = [x / (TRAIN_FLOOR_FACTOR * f) if f else (0.0 if x == 0 else
                                                       math.inf)
                  for x, f in zip(diff(ours), floor)]
        control = diff(grads(disc, img, pred, mask, fault=True)[2])
        c_ratios = [x / (TRAIN_FLOOR_FACTOR * f) if f else math.inf
                    for x, f in zip(control, floor)]
        log(f'D step {r} fp32 kernels vs plain (R1 {ours_gp:.4e}): ours / '
            f'({TRAIN_FLOOR_FACTOR} x plain spread), pass <= 1: '
            + ', '.join(f'{x:.3f}' for x in ratios) + '; control (R1 '
            'gradient detached): ' + ', '.join(f'{x:.3g}' for x in c_ratios))
        check(all(x <= 1 + 1e-9 for x in ratios),
              f"D step {r}: kernels vs plain beyond the plain path's spread")
        check(any(x > 1 for x in c_ratios),
              f'D step {r}: the check let a detached R1 gradient pass')
        worst = [max(a, b) for a, b in zip(worst, ratios)]
        control_min = [min(a, b) for a, b in zip(control_min, c_ratios)]
    seconds = time.perf_counter() - t_start
    log(f'D step check, {D_REPEATS} batches: largest ratio per measure '
        + ', '.join(f'{x:.3f}' for x in worst) + '; the control\'s smallest '
        + ', '.join(f'{x:.3g}' for x in control_min) + f' ({seconds:.1f} s)')
    return dict(worst=worst, control_min=control_min, seconds=seconds)


def rest_of_training(work):
    """Phase 15: `python -m lama_tpu_torch.train` with the rest of
    lama_tpu's training options at b10 256^2 (runs A, B, C; see the
    module docstring), each run's step profiled once, the D-step check on
    run B's fp32 trainer. Returns the records by run."""
    import torch
    from lama_tpu_torch.ops.kernels import halo_conv as hc
    t0 = time.perf_counter()
    write_train_images(os.path.join(work, 'train_data'),
                       TRAIN_BATCH * REST_STEPS, np.random.RandomState(5))
    shards = write_shards(os.path.join(work, 'shards'),
                          os.path.join(work, 'train_data', 'train'))
    val_dir = os.path.join(work, 'online_val')
    write_online_val_images(val_dir, np.random.RandomState(6))
    route = hc.tiled_route(TRAIN_SIZE, TRAIN_SIZE, 8, 64, 7, 1)
    log('phase 15: the 8-channel stem of run B (4 noise scales) runs '
        + (SOURCES['halo_conv_reflect_tiled'] if route is not None
           else TILED_OTHER_SOURCE))
    runs = [('A', 'bf16', 'ablv2_work_no_segmpl_vgg', ABLV2_PER_TRAIN_STEP, []),
            ('B', 'bf16', 'big-lama', rest_b_per_step, REST_B),
            ('B', 'fp32', 'big-lama', rest_b_per_step, REST_B),
            ('C', 'bf16', 'big-lama', PER_TRAIN_STEP, [
                'data.train.kind=default_web', f'data.train.indir={shards}',
                'losses.adversarial.kind=bce', '~losses.adversarial.gp_coef',
                '~losses.adversarial.mask_as_fake_target',
                'trainer.kwargs.steps_per_dispatch=2',
                f'data.val.indir={val_dir}', 'data.val.kind=online',
                'data.val.img_suffix=.png',
                '+data.val.mask_gen_kwargs.segm_proba=0',
                # SSIM and LPIPS only: the FID costs one host sqrtm of
                # 2048^2 per non-empty mask-area group (13-26 s each),
                # and phase 6's validation holds the trainer's FID and
                # its ssim_fid100_f1 monitor
                '+evaluator.fid=false', '~evaluator.integral_kind',
                'trainer.checkpoint_kwargs.monitor=val_ssim_total_mean'])]
    out = {}
    for name, precision, config_name, per_step, extra in runs:
        rec, trainer = train_run(work, precision, config_name, REST_STEPS,
                                 per_step, extra=extra, tag=f'_{name}')
        label = f'run {name} ({config_name}) {precision}'
        image, mask = rec.pop('batch')
        if name == 'A':
            pl = [m['gen_pl'] for m in rec['metrics']]
            check(all(math.isfinite(v) and v != 0 for v in pl),
                  f'{label}: gen_pl {pl}')
        if name == 'B':
            check(any(m['discr_real_gp'] > 0 for m in rec['metrics']),
                  f'{label}: no R1 step')
        if name == 'C':
            val = rec['val_metrics']
            check('val_ssim_total_mean' in val and all(
                math.isfinite(v) or one_image_fid(val, k)
                for k, v in val.items()),
                f'{label}: online validation {val}')
            check(rec['val_forwards'] > 0 and all(
                rec['val_counts'][k] == per * rec['val_forwards']
                for k, per in PER_FORWARD.items()),
                f'{label}: validation launches {rec["val_counts"]}')
        log(f'{label}: fake-fakes draws {rec["use_ff"]}, launches per step '
            f'{rec["counts"]}')
        st = trainer.state
        rec['profile'] = device_profile(
            lambda: trainer.step_fn(st, image, mask),
            f'phase 15 {label} b{TRAIN_BATCH} step', top=12)
        if name == 'B' and precision == 'fp32':
            rec['d_gradient'] = d_step_gradient_vs_plain(trainer)
        out[name, precision] = rec
        del trainer, st
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f'phase 15: {seconds:.1f} s; ' + '; '.join(
        f'run {n} {p} {r["ms_per_step"]:.1f} ms/step, peak {r["peak_gib"]:.2f}'
        f' GiB, idle {r["profile"]["idle"]}' for (n, p), r in out.items()))
    out['seconds'] = seconds
    return out


# ---------------------------------------------------------------- evaluate
EVAL_N, EVAL_SIZE, EVAL_BATCH = 32, 512, 8   # configs/eval2.yaml: batch 8
EVAL_CPU_BATCHES = 1   # the card-vs-CPU scores: the first batch of pairs
# the masks' largest area: all in bin 0-10%. Each non-empty bin adds one
# host sqrtm of 2048^2 (13-26 s on the card's host) to the FID
EVAL_MAX_AREA = 0.09
EVAL2 = os.path.join(REPO, 'configs', 'eval2.yaml')


def write_eval_images(root, rng, n=EVAL_N, size=EVAL_SIZE):
    """The eval2 layout: <root>/data/imgNN.png + imgNN_mask.png (a band of
    rows covering 2% to EVAL_MAX_AREA of the image: mask-area bin 0), and
    <root>/gt/imgNN_mask.png, the ground truth under the prediction's
    name. Returns the two dirs and the masks' bins."""
    data, gt = os.path.join(root, 'data'), os.path.join(root, 'gt')
    os.makedirs(data)
    os.makedirs(gt)
    yy, xx = np.mgrid[0:size, 0:size] / 64.0
    bins = []
    for i in range(n):
        img = np.stack([np.sin(yy + i), np.cos(xx - 2 * i), np.sin(xx + yy)],
                       -1)
        img = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(size, size, 3), 0, 1)
        img = np.rint(img * 255).astype(np.uint8)
        # y0 is drawn as for a band of 2% to 48% of the rows, whatever
        # EVAL_MAX_AREA is: the rng's stream, and so every image (and the
        # segmenters' BatchNorm statistics in phase 14), stays the same
        span = int(round((0.02 + 0.46 * i / (n - 1)) * size))
        y0 = rng.randint(0, size - span + 1)
        rows = int(round((0.02 + (EVAL_MAX_AREA - 0.02) * i / (n - 1)) * size))
        mask = np.zeros((size, size), np.uint8)
        mask[y0:y0 + rows] = 255
        bins.append(min(int(rows / size * 10), 9))
        write_png(os.path.join(data, f'img{i:02d}.png'), img)
        write_png(os.path.join(data, f'img{i:02d}_mask.png'), mask)
        write_png(os.path.join(gt, f'img{i:02d}_mask.png'), img)
    return data, gt, bins


def per_image_scores(data, pred, device, batches=None):
    """Per-image SSIM and LPIPS and the Inception activations of every
    (prediction, image) pair, in the evaluator's order and batches, on
    `device`; the first `batches` batches only, when given."""
    from lama_tpu_torch.data.datasets import (BatchLoader,
                                              PrecomputedInpaintingResultsDataset)
    from lama_tpu_torch.evaluation.fid import InceptionActivations
    from lama_tpu_torch.evaluation.scores import LPIPSScore, SSIMScore
    ds = PrecomputedInpaintingResultsDataset(data, pred, img_suffix='.png',
                                             inpainted_suffix='.png')
    ssim, lpips = SSIMScore(device=device), LPIPSScore(device=device)
    inception = InceptionActivations.get(device=device)
    out = dict(ssim=[], lpips=[], act_pred=[], act_target=[])
    for i, batch in enumerate(BatchLoader(ds, batch_size=EVAL_BATCH,
                                          drop_last=False)):
        if batches is not None and i == batches:
            break
        out['ssim'].append(ssim(batch['inpainted'], batch['image']))
        out['lpips'].append(lpips(batch['inpainted'], batch['image']))
        out['act_pred'].append(inception(batch['inpainted']))
        out['act_target'].append(inception(batch['image']))
    return {k: np.concatenate(v) for k, v in out.items()}


def score_rates(data, pred):
    """images/s of each score's device work on one batch of EVAL_BATCH
    pairs at EVAL_SIZE^2 (CUDA events, median of 10; FID: the InceptionV3
    forward of the batch's predictions)."""
    import torch
    from lama_tpu_torch.data.io import load_image
    from lama_tpu_torch.evaluation.fid import InceptionActivations
    from lama_tpu_torch.evaluation.scores import (LPIPSScore, SSIMScore,
                                                  to_device_nchw)
    names = sorted(f for f in os.listdir(pred))[:EVAL_BATCH]
    p = to_device_nchw(np.stack([load_image(os.path.join(pred, f))
                                 for f in names]), 'cuda')
    t = to_device_nchw(np.stack([load_image(os.path.join(
        data, f.replace('_mask', ''))) for f in names]), 'cuda')
    ssim, lpips = SSIMScore(device='cuda'), LPIPSScore(device='cuda')
    inception = InceptionActivations.get(device='cuda')
    rates = {}
    with torch.no_grad():
        for name, fn in (('ssim', lambda: ssim.values(p, t)),
                         ('lpips', lambda: lpips.values(p, t)),
                         ('fid', lambda: inception.activations(p))):
            rates[name] = EVAL_BATCH / median_ms(fn) * 1e3
    return rates


def read_table(path):
    """The evaluate_predicts TSV: {(metric, stat): {group: value or None}}."""
    import csv
    with open(path) as f:
        rows = list(csv.reader(f, delimiter='\t'))
    metrics, stats = rows[0][1:], rows[1][1:]
    table = {}
    for row in rows[2:]:
        for m, st, v in zip(metrics, stats, row[1:]):
            table.setdefault((m, st), {})[row[0]] = float(v) if v else None
    return table


def evaluate(work, model_dir, card_line):
    """Phase 13: predict, evaluate_predicts and fid_score on the card, with
    the identity control and the card-vs-CPU check."""
    import io
    from lama_tpu_torch.data import datasets as datasets_mod
    from lama_tpu_torch.evaluation import scores as scores_mod
    from lama_tpu_torch.evaluation.evaluator import _interval_names
    from lama_tpu_torch.evaluation.fid import fid_from_activations

    root = os.path.join(work, 'eval')
    data, gt, bins = write_eval_images(root, np.random.RandomState(5))
    pred = os.path.join(root, 'pred')
    fns = reset_counts()
    t0 = time.perf_counter()
    with counting_forwards() as forwards:
        run_predict([f'model.path={model_dir}', f'indir={data}',
                     f'outdir={pred}', 'device=cuda', f'batch_size={BATCH}',
                     'precision=bf16', 'dataset.img_suffix=.png'])
    n = forwards[0]
    counts = {k: fn.launches for k, fn in fns.items()}
    check(n > 0 and all(counts[k] == per * n for k, per in PER_FORWARD.items()),
          f'evaluate: predict launches {counts} in {n} forwards')
    check(len(os.listdir(pred)) == EVAL_N, f'evaluate: {os.listdir(pred)}')
    log(f'evaluate: predict served {EVAL_N} images at {EVAL_SIZE}^2 in '
        f'{time.perf_counter() - t0:.1f} s, {n} forwards, launches {counts}')

    # the CLI, with the host's sqrtm and PNG reads timed
    host = dict(sqrtm=0.0, png=0.0, n_sqrtm=0, n_png=0)
    frechet, load = scores_mod.calculate_frechet_distance, datasets_mod.load_image

    def timed_frechet(*args, **kwargs):
        t = time.perf_counter()
        try:
            return frechet(*args, **kwargs)
        finally:
            host['sqrtm'] += time.perf_counter() - t
            host['n_sqrtm'] += 1

    def timed_load(*args, **kwargs):
        t = time.perf_counter()
        try:
            return load(*args, **kwargs)
        finally:
            host['png'] += time.perf_counter() - t
            host['n_png'] += 1

    table_path = os.path.join(root, 'metrics.tsv')
    scores_mod.calculate_frechet_distance = timed_frechet
    datasets_mod.load_image = timed_load
    t0 = time.perf_counter()
    try:
        run_module('lama_tpu_torch.evaluate_predicts',
                   [EVAL2, data, pred, table_path, '--device', 'cuda'])
    finally:
        scores_mod.calculate_frechet_distance = frechet
        datasets_mod.load_image = load
    secs = time.perf_counter() - t0
    table = read_table(table_path)
    _, names = _interval_names(10)
    groups = ['total'] + [names[b] for b in sorted(set(bins))]
    check(sorted(set(bins)) == [0],
          f'evaluate: masks in bins {sorted(set(bins))}')
    for metric in ('ssim', 'lpips', 'fid'):
        for g in groups:
            v = table.get((metric, 'mean'), {}).get(g)
            check(v is not None and math.isfinite(v),
                  f'evaluate: {metric} {g} = {v}')
            check({'ssim': -1 < v <= 1, 'lpips': v >= 0, 'fid': v >= 0}[metric],
                  f'evaluate: {metric} {g} = {v} out of range')
    f1 = table.get(('lpips_fid100_f1', 'mean'), {}).get('total')
    check(f1 is not None and math.isfinite(f1), f'evaluate: f1 {f1}')
    log(f'evaluate: evaluate_predicts ({EVAL_N} pairs at {EVAL_SIZE}^2, batch '
        f'{EVAL_BATCH}, on the card) {secs:.1f} s; host: {host["n_sqrtm"]} '
        f'sqrtm {host["sqrtm"]:.1f} s ({host["sqrtm"] / secs:.3f} of the '
        f'call), {host["n_png"]} PNG reads {host["png"]:.1f} thread-s '
        f'({host["png"] / secs:.3f}); total ssim '
        f'{table["ssim", "mean"]["total"]:.4f} lpips '
        f'{table["lpips", "mean"]["total"]:.4f} fid '
        f'{table["fid", "mean"]["total"]:.4f} lpips_fid100_f1 {f1:.4f}; '
        f'groups {groups}')

    rates = score_rates(data, pred)
    log(f'evaluate: images/s at {EVAL_SIZE}^2 batch {EVAL_BATCH} (device '
        'work, CUDA events): ' + ', '.join(f'{k} {v:.1f}' for k, v in rates.items())
        + f' ({card_line})')

    # the card against the port's own CPU run on the same files: the first
    # EVAL_CPU_BATCHES batches (the CPU's LPIPS and InceptionV3 over all
    # 32 pairs took about a minute of a slow host's time)
    card = per_image_scores(data, pred, 'cuda')
    cpu = per_image_scores(data, pred, 'cpu', EVAL_CPU_BATCHES)
    n_cpu = len(cpu['ssim'])
    d_ssim = float(np.abs(card['ssim'][:n_cpu] - cpu['ssim']).max())
    check(d_ssim <= 1e-6, f'evaluate: SSIM card vs CPU {d_ssim}')
    for key in ('lpips', 'act_pred', 'act_target'):
        a, b = card[key][:n_cpu], cpu[key]
        bad = np.abs(a - b) > 2e-4 + 1e-3 * np.abs(b)
        check(not bad.any(), f'evaluate: {key} card vs CPU: {int(bad.sum())} '
              f'beyond rtol 1e-3 / atol 2e-4, max |d| {np.abs(a - b).max()}')
    check(abs(card['ssim'].mean() - table['ssim', 'mean']['total']) <= 1e-4
          and abs(card['lpips'].mean() - table['lpips', 'mean']['total'])
          <= 1e-4, 'evaluate: per-image means differ from the table')
    log(f'evaluate: card vs CPU on the first {n_cpu} files: max |d| ssim '
        f'{d_ssim:.2e}, lpips '
        f'{np.abs(card["lpips"][:n_cpu] - cpu["lpips"]).max():.2e}, '
        'activations '
        f'{np.abs(card["act_pred"][:n_cpu] - cpu["act_pred"]).max():.2e} '
        f'(largest {np.abs(cpu["act_pred"]).max():.3f})')

    # the identity control: the ground truth as the prediction
    ident = per_image_scores(data, gt, 'cuda')
    fid_id = fid_from_activations(ident['act_pred'], ident['act_target'])
    var = float(np.trace(np.cov(ident['act_target'], rowvar=False)))
    check(np.abs(ident['ssim'] - 1).max() <= 1e-6 and
          np.abs(ident['lpips']).max() <= 1e-6,
          f'evaluate: identity ssim {ident["ssim"]}, lpips {ident["lpips"]}')
    check(abs(fid_id) <= 1e-5 * var, f'evaluate: identity FID {fid_id} '
          f'(total variance {var})')
    log(f'evaluate: identity control: max |ssim - 1| '
        f'{np.abs(ident["ssim"] - 1).max():.2e}, max lpips '
        f'{np.abs(ident["lpips"]).max():.2e}, FID {fid_id:.3e} (total '
        f'variance of the activations {var:.3f})')

    # fid_score between the folders against the table's FID
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_module('lama_tpu_torch.fid_score',
                   [gt, pred, '--batch-size', str(EVAL_BATCH), '--device', 'cuda'])
    line = buf.getvalue().strip().splitlines()[-1]
    fid_cli, fid_table = float(line.split()[1]), table['fid', 'mean']['total']
    check(abs(fid_cli - fid_table) <= 1e-4 + 1e-3 * abs(fid_table),
          f'evaluate: fid_score {line} vs the table {fid_table}')
    log(f'evaluate: fid_score "{line}" vs evaluate_predicts total '
        f'{fid_table:.4f}')
    return dict(seconds=secs, host=host, rates=rates, counts=counts,
                data=data, gt=gt, pred=pred, bins=bins, per_image=card)


# ------------------------------------------------------------ segmentation
SEG_ARCHS = ('resnet50dilated', 'mobilenetv2dilated')
EVAL2_SEGM = os.path.join(REPO, 'configs', 'eval2_segm.yaml')
# card vs the port's CPU run, fp32 with TF32 off: class scores (probabilities)
# within SEG_ATOL; a label may differ only where the top-2 margin is below it.
# The seeded weights' BatchNorm statistics come from the phase's own images
# (calibrate_batchnorm_): under identity statistics the resnet50dilated's
# logits reach ~1e3 and one class covers most of every image. Calibrated,
# the resnet50dilated read 1.0e-4 on an H100 at 512^2 (PERF.md §6)
SEG_ATOL = 5e-4
# SEG_MASK_N: the object-mask search is host time (~10 s an image on a
# slow host); image 0 gives the compared masks. SEG_FID_N: each pair adds
# one host sqrtm of 2048^2 (13-26 s on the card's host) to segm_fid's N + 1
SEG_CPU_N, SEG_FID_N, SEG_MASK_N = 2, 2, 1
SEG_DEVICE = 'cuda'   # main() stops without a card


def segmenter_flop(seg, x):
    """FLOP of one forward of `seg` on `x` (torch's FlopCounterMode:
    convs and matmuls, 2 per multiply-add)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        seg.net(x, seg_size=tuple(x.shape[2:]))
    return counter.get_total_flops()


def segmenters(images, card_line):
    """Phase 14, part 1: both segmenters on the card at batch 8, the
    card against the CPU on SEG_CPU_N images. Returns the resnet50dilated
    modules (card, CPU) and the CPU's label maps."""
    import torch
    from lama_tpu_torch.evaluation.utils import no_tf32
    from lama_tpu_torch.models.aux.random_init import calibrate_batchnorm_
    from lama_tpu_torch.models.aux.segmentation import SegmentationModule
    out = {}
    for arch in SEG_ARCHS:
        seg = SegmentationModule(arch_encoder=arch, device=SEG_DEVICE)
        with torch.no_grad(), no_tf32():
            calibrate_batchnorm_(seg.net, seg._input(images[:EVAL_BATCH]))
        labels = []
        for start in range(0, len(images), EVAL_BATCH):
            lab, scores = seg.predict(images[start:start + EVAL_BATCH])
            check(bool(torch.isfinite(scores).all()), f'segm {arch}: scores')
            dsum = float((scores.sum(1) - 1).abs().max())
            check(dsum <= 1e-5, f'segm {arch}: scores sum to 1 within {dsum}')
            labels.append(lab)
        labels = np.concatenate(labels)
        classes = np.unique(labels)
        check(len(classes) > 5, f'segm {arch}: classes {classes}')
        x = seg._input(images[:EVAL_BATCH])
        with torch.no_grad(), no_tf32():
            ms = median_ms(lambda: seg.net(x, seg_size=(EVAL_SIZE, EVAL_SIZE)),
                           iters=5, warmup=2)
        flop = segmenter_flop(seg, x) / EVAL_BATCH
        bound = flop / FP32_FLOPS * 1e3
        rate = EVAL_BATCH / ms * 1e3
        cpu = SegmentationModule(arch_encoder=arch, device='cpu',
                                 state_dict=seg.net.state_dict())
        t0 = time.perf_counter()
        cpu_labels, cpu_scores = cpu.predict(images[:SEG_CPU_N])
        cpu_secs = time.perf_counter() - t0
        card_labels, card_scores = seg.predict(images[:SEG_CPU_N])
        card_scores, cpu_scores = card_scores.cpu().numpy(), cpu_scores.numpy()
        d = float(np.abs(card_scores - cpu_scores).max())
        check(d <= SEG_ATOL, f'segm {arch}: card vs CPU scores {d}')
        top2 = np.sort(cpu_scores, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > SEG_ATOL
        check(np.array_equal(card_labels[clear], cpu_labels[clear]),
              f'segm {arch}: labels differ outside the near-ties')
        d_clear = float(np.abs(card_scores - cpu_scores).max(axis=1)[clear].max())
        log(f'segm {arch}: {len(images)} images at {EVAL_SIZE}^2, {len(classes)} '
            f'classes in the labels; {rate:.1f} images/s at batch {EVAL_BATCH} '
            f'({ms / EVAL_BATCH:.2f} ms an image, CUDA events; bound '
            f'{bound:.2f} ms: {flop / 1e9:.1f} GFLOP an image at 67 TFLOP/s '
            f'fp32, {bound / (ms / EVAL_BATCH):.3f} of it) ({card_line}); card '
            f'vs CPU on {SEG_CPU_N} images: max |d| scores {d:.2e} (atol '
            f'{SEG_ATOL}; {d_clear:.2e} outside the near-ties), near-tie '
            f'pixels {int((~clear).sum())} of '
            f'{clear.size}, labels differing {int((card_labels != cpu_labels).sum())}'
            f'; CPU forward {cpu_secs:.1f} s')
        out[arch] = dict(seg=seg, cpu=cpu, rate=rate, ms=ms, bound_ms=bound)
    return out


def segm_table(ev, root):
    """Phase 14, part 2: the segm table of evaluate_predicts on the card."""
    from lama_tpu_torch import evaluate_predicts
    from lama_tpu_torch.evaluation.evaluator import _interval_names
    out = os.path.join(root, 'segm.tsv')
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # the wide table: in `out`
        results = evaluate_predicts.main(evaluate_predicts.parse_args(
            [EVAL2_SEGM, ev['data'], ev['pred'], out, '--metrics',
             'segm_stats,segm_ssim,segm_lpips', '--device', SEG_DEVICE]))
    secs = time.perf_counter() - t0
    _, names = _interval_names(10)
    bins = np.array(ev['bins'])
    groups = {'total': np.arange(len(bins))}
    groups.update({names[b]: np.flatnonzero(bins == b) for b in sorted(set(bins))})
    for metric in ('segm_stats', 'segm_ssim', 'segm_lpips'):
        for g in groups:
            vals = results[(metric, g)]
            bad = {k: v for k, v in vals.items() if not math.isfinite(v)}
            check(not bad, f'segm table: {metric} {g} not finite: {bad}')
            classes = [k for k in vals if k not in ('mean', 'std')]
            check(len(classes) > 0, f'segm table: no class column in {metric} {g}')
    worst_tf = 0.0
    for g in groups:
        tf = sum(v for k, v in results[('segm_stats', g)].items()
                 if k.startswith('total_freq/'))
        worst_tf = max(worst_tf, abs(tf - 1))
        check(abs(tf - 1) <= 1e-4, f'segm table: total_freq of {g} sums to {tf}')
    worst = 0.0
    for metric, key in (('segm_ssim', 'ssim'), ('segm_lpips', 'lpips')):
        for g, idx in groups.items():
            d = abs(float(results[(metric, g)]['mean'])
                    - float(ev['per_image'][key][idx].mean()))
            worst = max(worst, d)
            check(d <= 1e-6, f'segm table: {metric} {g} mean vs phase 13: {d}')
    with open(out) as f:
        header = f.readline().rstrip('\n').split('\t')
    log(f'segm: evaluate_predicts eval2_segm.yaml --metrics segm_stats,'
        f'segm_ssim,segm_lpips ({len(bins)} pairs at {EVAL_SIZE}^2, batch '
        f'{EVAL_BATCH}, on the card) {secs:.1f} s; {len(header) - 1} columns, '
        f'groups {list(groups)}; classes in the total: '
        f'{len(results[("segm_ssim", "total")]) - 2}; total_freq sums vs 1 '
        f'max |d| {worst_tf:.2e} over the {len(groups)} groups; segm_ssim / '
        f'segm_lpips means vs phase 13 max |d| {worst:.2e}; segm_ssim total '
        f'{float(results[("segm_ssim", "total")]["mean"]):.4f}')
    return secs


def segm_fid(ev, root):
    """Phase 14, part 3: segm_fid on SEG_FID_N pairs without groups against
    fid_score on the same pairs."""
    import shutil
    from lama_tpu_torch import fid_score
    from lama_tpu_torch.evaluate_predicts import run_evaluation
    dirs = {k: os.path.join(root, f'fid_{k}') for k in ('data', 'pred', 'gt')}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(SEG_FID_N):
        for k, names in (('data', [f'img{i:02d}.png', f'img{i:02d}_mask.png']),
                         ('pred', [f'img{i:02d}_mask.png']),
                         ('gt', [f'img{i:02d}_mask.png'])):
            for name in names:
                shutil.copy(os.path.join(ev[k], name), dirs[k])
    config = dict(evaluator_kwargs=dict(batch_size=EVAL_BATCH,
                                        area_grouping=False),
                  dataset_kwargs=dict(img_suffix='.png', inpainted_suffix='.png'))
    t0 = time.perf_counter()
    res = run_evaluation(config, dirs['data'], dirs['pred'], metrics='segm_fid',
                         device=SEG_DEVICE)
    secs = time.perf_counter() - t0
    total = res[('segm_fid', 'total')]
    check(list(res) == [('segm_fid', 'total')], f'segm_fid groups: {list(res)}')
    check(all(math.isfinite(v) for v in total.values()),
          f'segm_fid: not finite: {total}')
    # the value `python -m lama_tpu_torch.fid_score` prints to 4 decimals
    with contextlib.redirect_stdout(io.StringIO()):
        fid_cli = fid_score.main(fid_score.parse_args(
            [dirs['pred'], dirs['gt'], '--batch-size', str(EVAL_BATCH),
             '--device', SEG_DEVICE]))
    rel = abs(total['mean'] - fid_cli) / abs(fid_cli)
    check(rel <= 1e-4, f'segm_fid {total["mean"]} vs fid_score {fid_cli}')
    log(f'segm: segm_fid on {SEG_FID_N} pairs, no groups: mean '
        f'{total["mean"]:.6f} vs fid_score {fid_cli:.6f} (rel {rel:.2e}); '
        f'{len(total) - 2} class attributions; {secs:.1f} s ({SEG_FID_N + 1} '
        'host sqrtm of 2048^2)')
    return secs


def object_masks(images, segs):
    """Phase 14, part 4: object-shaped masks from the card's panoptic map,
    and the masks the same host code makes from the CPU's map, whose
    near-ties take the card's labels."""
    import torch
    from lama_tpu_torch.evaluation.masks import SegmentationMask
    from lama_tpu_torch.evaluation.segm_backend import ADE20kPanopticPredictor
    r50 = segs['resnet50dilated']
    pred = ADE20kPanopticPredictor(segmentation_module=r50['seg'],
                                   allow_random_weights=True)
    sm = SegmentationMask(predictor=pred)
    t0 = time.perf_counter()
    per_image, n_things, ties, differing, compared = [], 0, 0, 0, 0
    for i, img in enumerate(images[:SEG_MASK_N]):
        got, panoptic = sm.get_masks(img, return_panoptic=True,
                                     rng=np.random.RandomState(i))
        labels = pred.module.predict(img[None])[0][0]
        _, info = pred.panoptic(labels)
        things = sum(s['isthing'] for s in info)
        n_things += things
        candidates = len(sm.identify_candidates(panoptic, info))
        largest = max([float((panoptic == s['id']).mean()) for s in info
                       if s['isthing']], default=0.0)
        for m in got:
            check(m.shape == img.shape[:2] and set(np.unique(m)) <= {0, 1}
                  and m.mean() > sm.min_mask_area,
                  f'masks: image {i}: shape {m.shape}, values '
                  f'{np.unique(m)}, area {m.mean()}')
        per_image.append((things, candidates, len(got), round(largest, 3)))
        # the CPU's map, its near-ties (top-2 margin within SEG_ATOL) given
        # the card's label: every pixel where the maps differ must be one
        cpu_labels, cpu_scores = r50['cpu'].predict(img[None])
        top2 = torch.topk(cpu_scores[0], 2, dim=0).values.numpy()
        tie = top2[0] - top2[1] <= SEG_ATOL
        differ = cpu_labels[0] != labels
        check(not (differ & ~tie).any(), f'masks: image {i}: card and CPU '
              f'maps differ outside the near-ties')
        ties += int(tie.sum())
        differing += int(differ.sum())
        merged = np.where(tie, labels, cpu_labels[0])
        cpu_sm = SegmentationMask(
            predictor=lambda _, lab=merged: pred.panoptic(lab))
        want = cpu_sm.get_masks(img, rng=np.random.RandomState(i))
        check(len(want) == len(got) and all(
            np.array_equal(a, b) for a, b in zip(got, want)),
            f'masks: image {i}: card and CPU masks differ')
        compared += len(got)
    secs = time.perf_counter() - t0
    if n_things == 0:
        log('masks: the seeded weights gave no thing-class component on '
            f'any of the {SEG_MASK_N} images: no candidates, no masks')
    elif not any(n for _, _, n, _ in per_image):
        log('masks: no mask on any image: each candidate is under '
            f'min_mask_area {sm.min_mask_area} or finds no placement clear '
            'of the scene\'s thing components (the largest one\'s share of '
            'the image is last in each tuple below)')
    log(f'masks: {SEG_MASK_N} images at {EVAL_SIZE}^2, (thing components, '
        f'candidates, masks, largest thing share) per image {per_image}; '
        f'{secs:.1f} s with the CPU maps; card and CPU maps differ at '
        f'{differing} pixels, all among the CPU\'s {ties} near-ties; '
        f'{compared} masks equal to those of the CPU\'s maps')
    check(compared > 0, 'masks: no mask was compared with the CPU map\'s')
    return secs


def segmentation(work, ev, card_line):
    """Phase 14 on phase 13's pairs and predictions."""
    from lama_tpu_torch.data.io import load_image
    root = os.path.join(work, 'segm')
    os.makedirs(root)
    t0 = time.perf_counter()
    images = np.stack([load_image(os.path.join(ev['data'], f'img{i:02d}.png'))
                       for i in range(len(ev['bins']))])
    segs = segmenters(images, card_line)
    secs = dict(nets=time.perf_counter() - t0)
    secs['table'] = segm_table(ev, root)
    secs['fid'] = segm_fid(ev, root)
    secs['masks'] = object_masks(images, segs)
    total = time.perf_counter() - t0
    log(f'segm: phase 14 {total:.1f} s (' + ', '.join(
        f'{k} {v:.1f}' for k, v in secs.items()) + ')')
    return segs


# ------------------------------------------------------------ int8 serving
# phase 16: big-lama and big-lama-regular in precision=int8 (queue 1 items 7
# and 3). Per int8 forward: the int8 conv (csrc/conv_int8.cu) on every
# eligible conv (big-lama: the 4 downsamples, 108 3x3 FFC convs, 72
# SpectralTransform 1x1 convs, 3 ConvTranspose; big-lama-regular: 3
# downsamples, 36 block convs, 3 ConvTranspose), the FourierUnit, the stem
# and the head; kernels 2, 3, 4 and 6 not at all
INT8_PER_FORWARD = dict({k: 0 for k in PER_FORWARD}, quantized_conv2d=187,
                        fused_fourier_unit=36, reflect_out_conv7x7=1,
                        halo_conv_reflect_tiled=1)
INT8_REGULAR_PER_FORWARD = dict({k: 0 for k in PER_FORWARD},
                                quantized_conv2d=42, reflect_out_conv7x7=1,
                                halo_conv_reflect_tiled=1)
# bench.py:7-9's headline flags (its quant_calibration=K: the first 2 images)
INT8_HEADLINE = ['precision=int8', 'quant_calibration=2',
                 'quant_zero_pad=true', 'spectral_bf16_store=true',
                 's2d_out_head=true']
INT8_SOURCE = 'lama_tpu_torch/csrc/conv_int8.cu'
# lama_tpu's quantized convs are XLA convs, no TPU kernel: the XLA call
INT8_REPLACES = 'lama_tpu/ops/quant.py:108'
# an int8 row's outputs vs the plain version's, relative to the largest
# |output| (the fp32 epilogue rounds once an operation in both); its int32
# sums must be bit-equal
INT8_OUT_RTOL = 1e-6
# kernel 1 with store_bf16 vs its plain version (the same four roundings,
# summed in other orders): max |d| within this share of the largest output
FU_STORE_RTOL = 1e-2
# and its mean |d| below this share of the unit without store_bf16 (its
# output rounded to bf16) against the same plain version: both max |d| are
# one bf16 step of the output, so the max alone would pass a kernel that
# ignored store_bf16
FU_STORE_MEAN_SHARE = 0.5
# whole int8 generator, kernels vs kernels='plain', fp32 compute, 512^2 b2,
# sigmoid output: a code may round the other way where a non-int8 kernel's
# fp32 sum differs from the plain one in the last bit
GEN_INT8_ATOL = 1e-2
INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core OP/s


def int8_cases(gen):
    """(role, conv kind, x (bf16, channels-last, on the card), weight,
    stride, padding mode, dilation) at the served batch 16: big-lama's,
    big-lama-regular's and ablv2_work_md's int8 convs
    (tools/conv_int8_time.py's CASES)."""
    import torch
    from lama_tpu_torch.tools.conv_int8_time import BATCH, CASES
    # drawn on the card from a seed that `gen` gives, as kernel_cases' are
    dev = torch.Generator('cuda').manual_seed(
        int(torch.randint(0, 2 ** 62, (), generator=gen)))
    out = []
    for role, c, co, h, k, stride, mode, kind, d in CASES:
        x = torch.rand(BATCH, c, h, h, generator=dev, device='cuda') * 2 - 1
        shape = (c, co, k, k) if kind == 'transposed' else (co, c, k, k)
        wt = ((torch.rand(*shape, generator=dev, device='cuda') * 2 - 1)
              * (c * k * k) ** -0.5)
        out.append((role, kind, x.bfloat16().contiguous(
            memory_format=torch.channels_last), wt, stride, mode, d))
    return out


def int8_plan(kind, x, wt, stride, mode, d=1):
    from lama_tpu_torch.ops.kernels import conv_int8 as ci
    if kind == 'transposed':
        return ci.conv_transpose_plan(x.shape, wt.shape)
    return ci.conv_plan(x.shape, wt.shape, stride, d * (wt.shape[-1] // 2),
                        d, 1, mode)


def int8_bound(x, wt, plan, co):
    """(least ms, 'bytes' or 'operations') of an int8 conv: the int8
    products of its taps (a ConvTranspose phase's own taps, no inserted
    zeros) at the int8 tensor-core peak, or bf16 x in, its int8 packed
    weight and scales in, bf16 out, at the HBM rate."""
    b, c = x.shape[:2]
    macs = sum(b * ph.hg * ph.wg * len(ph.taps) for ph in plan.phases) * c * co
    nbytes = (x.numel() * 2 + wt.numel() + co * 4
              + b * co * plan.ho * plan.wo * 2)
    t_ops, t_bytes = 2 * macs / INT8_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return max(t_ops, t_bytes), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def int8_rows(gen, card_line):
    """Each int8 conv case on the card: its int32 sums bit-equal to the
    plain version's (float64 on the codes), its bf16 outputs within
    INT8_OUT_RTOL; the wrapper's median ms with the amax and quantize
    passes (dynamic), with the quantize pass only (a calibrated scale) and
    the GEMM launch alone; the port's own device ms of the whole wrapper
    and of the GEMM alone; the plain version's ms; as yardsticks, timed
    only, torch._int_mm on random int8 matrices of the im2col GEMM's
    shape (M x 9C x C_out; a ConvTranspose over its zero-dilated input) and
    the bf16 cuDNN conv of the same shape; the bound of the whole conv
    and that of the GEMM launch alone (tools/conv_int8_time.py)."""
    import torch
    import torch.nn.functional as F
    from lama_tpu_torch.ops import quant
    from lama_tpu_torch.ops.kernels import conv_int8 as ci
    from lama_tpu_torch.tools.conv_int8_time import gemm_bound
    rows = []
    for role, kind, x, wt, stride, mode, d in int8_cases(gen):
        tr = kind == 'transposed'
        co = wt.shape[1] if tr else wt.shape[0]
        pad = d * (wt.shape[-1] // 2)
        plan = int8_plan(kind, x, wt, stride, mode, d)
        packed, s_w = ci.pack_weight(wt, tr)
        amax = x.float().abs().amax()
        with torch.no_grad():
            xq, amax_t = ci.quantize_activation(x)
            acc = ci.conv_codes(xq, amax_t, packed, s_w, None, plan, co,
                                'acc')
            wq, _ = quant.quantize_weight(wt, tr)
            codes = quant.quantize(x, quant.act_scale(x))
            ref_acc = (quant.conv_transpose2d_acc(codes, wq) if tr else
                       quant.conv2d_acc(codes, wq, stride, pad, d, 1, mode))
            torch.cuda.synchronize()
            check(torch.equal(acc, ref_acc),
                  f'int8 {role}: int32 sums differ from the plain version')
            del ref_acc, codes

            if tr:
                def full(a=None):
                    return ci.quantized_conv_transpose2d(
                        x, wt, None, act_amax=a, packed=(packed, s_w))

                def plain():
                    return quant.quantized_conv_transpose2d(x, wt)
            else:
                def full(a=None):
                    return ci.quantized_conv2d(
                        x, wt, None, stride, pad, d, 1, mode, act_amax=a,
                        packed=(packed, s_w))

                def plain():
                    return quant.quantized_conv2d(
                        x, wt, None, stride, pad, d, 1, mode)
            out, ref = full(), plain()
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            equal = bool(torch.equal(out, ref))
            check(out.shape == ref.shape and err <= INT8_OUT_RTOL * scale,
                  f'int8 {role}: outputs differ by {err:.3e}')
            del out, ref
            ms = median_ms(full)
            static_ms = median_ms(lambda: full(amax))
            conv_ms = median_ms(lambda: ci.conv_codes(
                xq, amax_t, packed, s_w, None, plan, co, torch.bfloat16))
            dev_ms = own_device_ms(full)
            dev_conv_ms = own_device_ms(lambda: ci.conv_codes(
                xq, amax_t, packed, s_w, None, plan, co, torch.bfloat16))
            plain_ms = median_ms(plain, iters=3, warmup=1)
            # yardsticks, timed only
            k = wt.shape[-1]
            m = x.shape[0] * plan.ho * plan.wo
            a = torch.randint(-127, 128, (m, k * k * x.shape[1]),
                              dtype=torch.int8, device='cuda')
            bmat = torch.randint(-127, 128, (k * k * x.shape[1], co),
                                 dtype=torch.int8, device='cuda')
            int_mm_ms = median_ms(lambda: torch._int_mm(a, bmat))
            del a, bmat
            wb = wt.bfloat16()
            if tr:
                cudnn_ms = median_ms(lambda: F.conv_transpose2d(
                    x, wb, None, 2, 1, 1))
            else:
                xpad = (F.pad(x, (pad,) * 4, mode=mode) if mode != 'zeros'
                        else x)
                cudnn_ms = median_ms(lambda: F.conv2d(
                    xpad, wb, None, stride, 0 if mode != 'zeros' else pad,
                    d))
        g_ms, g_by = gemm_bound(xq, packed, plan, x.shape[1], co)
        del xq
        b_ms, b_by = int8_bound(x, wt, plan, co)
        row = dict(name='quantized_conv2d', role=role, route='cuda',
                   source=INT8_SOURCE, replaces=INT8_REPLACES,
                   tpu_kernel=None, shape=list(x.shape), dtype='int8',
                   c_out=co, kind=kind, dilation=d, max_abs_err=err,
                   acc_bit_equal=True,
                   out_bit_equal=equal, tol=dict(rtol=INT8_OUT_RTOL),
                   within_tol=True, ms=ms, kernel_ms=ms, static_ms=static_ms,
                   conv_ms=conv_ms, kernel_device_ms=dev_ms,
                   conv_device_ms=dev_conv_ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, gemm_bound_ms=g_ms,
                   gemm_bound_by=g_by, library_ms=int_mm_ms,
                   int_mm_ms=int_mm_ms, cudnn_bf16_ms=cudnn_ms,
                   phases=len(plan.phases))
        log(f'kernel int8/{role} {list(x.shape)} -> {co}'
            f'{" (transposed)" if tr else ""}'
            f'{f" dilation {d} {mode}" if d > 1 else ""}: int32 sums '
            f'bit-equal, '
            f'outputs max|d| {err:.3e} (bit-equal {equal}); ms {ms:.3f} '
            f'(calibrated {static_ms:.3f}, GEMM alone {conv_ms:.3f}), device '
            f'{"not measured" if dev_ms is None else f"{dev_ms:.4f}"} (GEMM '
            f'{"not measured" if dev_conv_ms is None else f"{dev_conv_ms:.4f}"}'
            f'), plain {plain_ms:.3f}; _int_mm {int_mm_ms:.3f}, cuDNN bf16 '
            f'{cudnn_ms:.3f}; bound {b_ms:.4f} ms ({b_by}), GEMM alone '
            f'{g_ms:.4f} ms ({g_by}) ({card_line})')
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def fu_store_rows(gen, card_line):
    """Kernel 1 with store_bf16 at the served (16, 192, 64, 64) and one
    refine shape: the kernel's bf16 output against the plain unit with the
    same four roundings (FU_STORE_RTOL, and its mean |d| under
    FU_STORE_MEAN_SHARE of the unstored unit's), its times, and the device
    ms of each of its five launches at b16."""
    import torch
    from lama_tpu_torch.ops.kernels import fourier_unit as fu
    rows = []
    for role, b, h, w in (('fu_b16_store_bf16', 16, 64, 64),
                          ('refine_fu_store_bf16', 1, 125, 95)):
        x = torch.rand(b, 192, h, w, generator=gen).cuda().bfloat16()
        params = [(torch.rand(384, 384, 1, 1, generator=gen) * 2 - 1) * 0.05,
                  1 + 0.2 * torch.rand(384, generator=gen),
                  0.1 * torch.rand(384, generator=gen),
                  0.1 * torch.rand(384, generator=gen),
                  1 + 0.3 * torch.rand(384, generator=gen)]
        params = [p.cuda() for p in params]
        with torch.no_grad():
            ref = fu.fourier_unit_plain(x, *params, store_bf16=True).float()
            out = fu.fused_fourier_unit(x, *params, store_bf16=True)
            off = fu.fused_fourier_unit(x, *params).bfloat16()
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            mean_err = float((out.float() - ref).abs().mean())
            off_mean_err = float((off.float() - ref).abs().mean())
            scale = float(ref.abs().max())
            log(f'fu store_bf16 {role}: vs its plain version max|d| '
                f'{err:.3e} of {scale:.3e}, mean|d| {mean_err:.3e}; the '
                f'unstored unit mean|d| {off_mean_err:.3e}')
            check(out.dtype == torch.bfloat16 and err <= FU_STORE_RTOL * scale,
                  f'fu store_bf16 {role}: max|d| {err:.3e} of {scale:.3e}')
            check(not torch.equal(out, off)
                  and mean_err < FU_STORE_MEAN_SHARE * off_mean_err,
                  f'fu store_bf16 {role}: mean|d| {mean_err:.3e} not under '
                  f'{FU_STORE_MEAN_SHARE} of the unstored unit\'s '
                  f'{off_mean_err:.3e}')
            del off
            ms = median_ms(lambda: fu.fused_fourier_unit(
                x, *params, store_bf16=True))
            off_ms = median_ms(lambda: fu.fused_fourier_unit(x, *params))
            dev = own_device_ms(lambda: fu.fused_fourier_unit(
                x, *params, store_bf16=True))
            plain_ms = median_ms(lambda: fu.fourier_unit_plain(
                x, *params, store_bf16=True))
        nbytes = x.numel() * 2 * 2 + sum(p.numel() * 4 for p in params)
        t_bytes = nbytes / HBM_BPS * 1e3
        t_ops = fu_flop(b, 192, h, w, 192) / FP32_FLOPS * 1e3
        row = dict(name='fused_fourier_unit', role=role, route='cuda',
                   source=SOURCES['fused_fourier_unit'],
                   replaces='lama_tpu/ops/pallas/fourier_unit.py:130',
                   tpu_kernel='lama_tpu/ops/pallas/fourier_unit.py:130',
                   shape=list(x.shape), dtype='bf16', store_bf16=True,
                   max_abs_err=err, mean_abs_err=mean_err,
                   unstored_mean_abs_err=off_mean_err,
                   tol=dict(rel_max=FU_STORE_RTOL,
                            mean_share=FU_STORE_MEAN_SHARE),
                   within_tol=True, ms=ms, kernel_ms=ms, unstored_ms=off_ms,
                   kernel_device_ms=dev, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by='bytes' if t_bytes >= t_ops else 'operations',
                   library_ms=None)
        log(f'kernel fused_fourier_unit/{role} bf16 store_bf16 '
            f'{list(x.shape)}: max|d| {err:.3e} of {scale:.3e}; kernel '
            f'{ms:.3f} ms (without store_bf16 {off_ms:.3f}), device '
            f'{"not measured" if dev is None else f"{dev:.4f}"}, plain '
            f'{plain_ms:.3f}; bound {row["bound_ms"]:.3f} ms '
            f'({row["bound_by"]}) ({card_line})')
        rows.append(row)
    fourier_unit_stages(gen, rows, store_bf16=True)
    return rows


def serve_int8(work, model_dir, per_forward, label, ckpt='best.ckpt'):
    """The predict CLI in int8 on phase 4's synthetic PNGs (the model dir's
    checkpoint `ckpt`), batch 16: the
    headline flags (calibrated on the first 2 images) and dynamic scales;
    sizes, known pixels bit-equal, the holes changed, and per_forward
    launches a generator forward (the calibration forwards included). The
    bf16 serve of the same files, uncounted, for the int8-vs-bf16 hole
    difference. Returns the headline run's launch counts."""
    indir = os.path.join(work, 'in')
    sizes = write_images(indir, np.random.RandomState(0))
    common = [f'model.path={model_dir}', f'model.checkpoint={ckpt}',
              f'indir={indir}', 'device=cuda', 'batch_size=16']
    run_predict(common + [f'outdir={work}/out_bf16', 'precision=bf16'])
    launches = None
    with counting_forwards() as forwards:
        for name, flags in (('headline', INT8_HEADLINE),
                            ('dynamic', ['precision=int8'])):
            outdir = os.path.join(work, f'out_{name}')
            fns = reset_counts()
            forwards[0] = 0
            t0 = time.perf_counter()
            run_predict(common + flags + [f'outdir={outdir}'])
            secs = time.perf_counter() - t0
            counts = {k: fn.launches for k, fn in fns.items()}
            n = forwards[0]
            log(f'serve int8 {label} {name} ({" ".join(flags)}): '
                f'{len(sizes)} images in {secs:.1f} s, {n} forwards, '
                f'launches {counts}')
            check(n > 0, 'no generator forward ran')
            for k, per in per_forward.items():
                check(counts[k] == per * n,
                      f'int8 {name} {k}: {counts[k]} launches in {n} '
                      f'forwards, expected {per} per forward')
            launches = launches or counts
            diffs = []
            for i, (h, w) in enumerate(sizes):
                out = read_png(os.path.join(outdir, f'img{i}_mask.png'))
                img = read_png(os.path.join(indir, f'img{i}.png'))
                mask = read_png(os.path.join(indir, f'img{i}_mask.png'), 'L')
                bf = read_png(os.path.join(work, 'out_bf16',
                                           f'img{i}_mask.png'))
                check(out.shape == (h, w, 3), f'img{i}: shape {out.shape}')
                check(np.array_equal(out[mask == 0], img[mask == 0]),
                      f'int8 img{i}: known pixels changed')
                check((out[mask > 0] != img[mask > 0]).any(),
                      f'int8 img{i}: hole left as input')
                diffs.append(np.abs(out.astype(int) - bf.astype(int))[
                    mask > 0])
            d = np.concatenate(diffs)
            log(f'serve int8 {label} {name}: hole vs the bf16 serve, mean '
                f'{d.mean():.3f} levels, max {d.max()}')
    return launches


def int8_generators(kind, gen_kwargs, sd, dtype, headline=False):
    """(kernels, plain) int8 generators on the card in `dtype` compute;
    headline: zero_pad, spectral_bf16_store and s2d_out_head on too."""
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.ops.serving_mode import ServingMode
    mode = ServingMode(int8=True, zero_pad=headline,
                       spectral_bf16_store=headline,
                       s2d='out_head' if headline else 'off')
    out = []
    for kernels in ('cuda', 'plain'):
        g = make_generator(kind, serving_mode=mode, dtype=dtype,
                           kernels=kernels, **gen_kwargs)
        g.load_state_dict(sd, strict=True)
        out.append(g.cuda().eval().requires_grad_(False))
    return out


def int8_generator_vs_plain(kind, gen_kwargs, sd, label):
    """The int8 generator, kernels vs kernels='plain', at 512^2 batch 2:
    fp32 compute within GEN_INT8_ATOL; bf16 compute logged."""
    import torch
    x = random_batch(2, 512, 1)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        ours, plain = int8_generators(kind, gen_kwargs, sd, dtype)
        with torch.inference_mode():
            out, ref = ours(x), plain(x)
        check(out.shape == (2, 3, 512, 512) and bool(
            torch.isfinite(out).all()), f'int8 generator {label}: output')
        res[dtype] = float((out.float() - ref.float()).abs().max())
        del ours, plain
    log(f'int8 generator {label} 512^2 b2, kernels vs plain: fp32 compute '
        f'max|d| {res[torch.float32]:.3e} (atol {GEN_INT8_ATOL}), bf16 '
        f'compute max|d| {res[torch.bfloat16]:.3e}')
    check(res[torch.float32] <= GEN_INT8_ATOL,
          f'int8 generator {label}: kernels vs plain outside tolerance')
    return res


def int8_throughput(kind, gen_kwargs, sd, card_line, label, iters=3):
    """img/s at 512^2 b16: bf16 and int8 (the headline mode, static scales
    calibrated on the batch) in turns bf16, int8, int8, bf16; one profiled
    forward of each."""
    import torch
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.serving import calibrate_int8
    x = random_batch(16, 512, 2)
    bf16 = make_generator(kind, dtype=torch.bfloat16, **gen_kwargs)
    bf16.load_state_dict(sd, strict=True)
    bf16 = bf16.cuda().eval().requires_grad_(False)
    int8, _ = int8_generators(kind, gen_kwargs, sd, torch.bfloat16, True)
    # the batch's masked image and mask, as the serving forward takes them
    calibrate_int8(int8, [(x[:, :3].permute(0, 2, 3, 1),
                           x[:, 3:].permute(0, 2, 3, 1))])
    gens = dict(bf16=bf16, int8=int8)
    times = {'bf16': [], 'int8': []}
    with torch.inference_mode():
        for name in ('bf16', 'int8', 'int8', 'bf16'):
            g = gens[name]
            g(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                g(x)
            torch.cuda.synchronize()
            times[name].append(16 * iters / (time.perf_counter() - t0))
        res = {k: float(np.mean(v)) for k, v in times.items()}
        log(f'throughput {label} 512^2 b16: int8 (headline, calibrated) '
            f'{res["int8"]:.2f} img/s, bf16 {res["bf16"]:.2f} img/s, runs '
            f'{times} ({card_line})')
        for name, g in gens.items():
            res[name + '_profile'] = device_profile(
                lambda: g(x), f'{label} 512^2 b16 {name} (int8 phase)')
    return res


def int8_serving(work, gen_kwargs, sd, reg_kind, reg_kwargs, reg_sd,
                 card_line):
    """Phase 16; returns its kernel rows, launches filled in."""
    import torch
    gen = torch.Generator().manual_seed(16)
    t0 = time.perf_counter()
    rows = int8_rows(gen, card_line) + fu_store_rows(gen, card_line)
    secs = dict(kernels=time.perf_counter() - t0)
    model_dir = os.path.join(work, 'model_int8')
    write_model_dir(model_dir, dict(kind='ffc_resnet', **gen_kwargs), sd)
    launches = serve_int8(os.path.join(work, 'big'), model_dir,
                          INT8_PER_FORWARD, 'big-lama')
    reg_dir = os.path.join(work, 'model_int8_regular')
    write_model_dir(reg_dir, dict(kind=reg_kind, **reg_kwargs), reg_sd)
    reg_launches = serve_int8(os.path.join(work, 'regular'), reg_dir,
                              INT8_REGULAR_PER_FORWARD, 'big-lama-regular')
    secs['serve'] = time.perf_counter() - t0 - secs['kernels']
    int8_generator_vs_plain('ffc_resnet', gen_kwargs, sd, 'big-lama')
    int8_generator_vs_plain(reg_kind, reg_kwargs, reg_sd, 'big-lama-regular')
    torch.cuda.empty_cache()
    int8_throughput('ffc_resnet', gen_kwargs, sd, card_line, 'big-lama')
    int8_throughput(reg_kind, reg_kwargs, reg_sd, card_line,
                    'big-lama-regular')
    torch.cuda.empty_cache()
    for row in rows:
        row['launches'] = launches[row['name']]
        row['regular_launches'] = reg_launches[row['name']]
    log(f'phase 16: {time.perf_counter() - t0:.1f} s (' + ', '.join(
        f'{k} {v:.1f}' for k, v in secs.items()) + ')')
    return rows


# ------------------------------------------------- the multidilated family
MD_CONFIG = 'ablv2_work_md'
MD_KIND = 'pix2pixhd_multidilated'
MD_STEPS = 4   # 2 timed after 2 warm-up
# ablv2_work_md's generator (pix2pixhd_multidilated_catin_4dil_9b): per
# forward the dilation-1 branch of each of its 18 MultidilatedConvs (cat_in:
# 128 of the block's 512 channels -> 512) on kernel 3, its dilated branches
# (2, 4, 8), the zero-padded downsamples and the ConvTranspose layers on
# cuDNN, the stem on kernel 7 and the head on kernel 5; two generator
# forwards a train step, and its pix2pixhd_nlayer D is zero-padded (cuDNN)
MD_PER_FORWARD = dict({k: 0 for k in PER_FORWARD}, reflect_conv3x3_taps=18,
                      halo_conv_reflect_tiled=1, reflect_out_conv7x7=1)
MD_PER_TRAIN_STEP = {k: 2 * v for k, v in MD_PER_FORWARD.items()}
# in int8 every branch (72), downsample (3) and ConvTranspose (3) quantizes
MD_INT8_PER_FORWARD = dict({k: 0 for k in PER_FORWARD}, quantized_conv2d=78,
                           halo_conv_reflect_tiled=1, reflect_out_conv7x7=1)
# ffc_positions at reduced depth: big-lama-regular's GlobalGenerator with 6
# ResnetBlocks (kernel 6, two convs each) and an inline FFCResnetBlock with
# LFU before block 4: per FFC layer l2l on kernel 2, l2g and g2l on kernel
# 3, the g2g FourierUnit and the LFU's on kernel 1
FFC_POS_BLOCKS, FFC_POS = 6, [4]
FFC_POS_PER_FORWARD = dict({k: 0 for k in PER_FORWARD},
                           halo_conv3x3_reflect=2 * FFC_POS_BLOCKS,
                           reflect_conv3x3_cols=2, reflect_conv3x3_taps=4,
                           fused_fourier_unit=4, halo_conv_reflect_tiled=1,
                           reflect_out_conv7x7=1)


def ffc_positions_vs_plain(reg_kwargs):
    """The reduced big-lama-regular with ffc_positions at 512^2 b2, fp32:
    the kernels forward's launches (FFC_POS_PER_FORWARD) and its output
    against kernels='plain' within GEN_ATOL. Returns the launches."""
    import torch
    from lama_tpu_torch.models import make_generator
    kw = dict(reg_kwargs, n_blocks=FFC_POS_BLOCKS, ffc_positions=FFC_POS)
    sd = random_state_dict(make_generator('pix2pixhd_global', **kw), seed=7)
    gens = {}
    for kernels in ('cuda', 'plain'):
        g = make_generator('pix2pixhd_global', kernels=kernels, **kw)
        g.load_state_dict(sd, strict=True)
        gens[kernels] = g.cuda().eval().requires_grad_(False)
    x = random_batch(2, 512, 5)
    with torch.inference_mode():
        fns = reset_counts()
        out = gens['cuda'](x)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in fns.items()}
        ref = gens['plain'](x)
    err = float((out - ref).abs().max())
    log(f'generator big-lama-regular ffc_positions={FFC_POS} '
        f'({FFC_POS_BLOCKS} blocks) 512^2 b2 fp32: kernels vs plain max|d| '
        f'{err:.3e} (atol {GEN_ATOL}); launches {counts}')
    check(counts == FFC_POS_PER_FORWARD,
          f'ffc_positions launches {counts}, expected {FFC_POS_PER_FORWARD}')
    check(out.shape == (2, 3, 512, 512) and bool(torch.isfinite(out).all())
          and err <= GEN_ATOL, 'ffc_positions generator vs plain')
    return counts


def multidilated(work, reg_kwargs, card_line):
    """Phase 17: `-cn ablv2_work_md` trained, its checkpoint served, the
    generator against the plain path and timed; ffc_positions at reduced
    depth. Returns the launch counts: the bf16 serve's and the train step's
    by kernel, the int8 headline serve's, and the ffc_positions forward's."""
    import torch
    from lama_tpu_torch.convert import load_checkpoint
    from lama_tpu_torch.serving import generator_config
    t0 = time.perf_counter()
    write_train_images(os.path.join(work, 'train_data'),
                       TRAIN_BATCH * MD_STEPS, np.random.RandomState(7))
    rec, trainer = train_run(work, 'bf16', MD_CONFIG, MD_STEPS,
                             MD_PER_TRAIN_STEP, tag='_md')
    image, mask = rec.pop('batch')
    st = trainer.state
    rec['profile'] = device_profile(
        lambda: trainer.step_fn(st, image, mask),
        f'phase 17 {MD_CONFIG} bf16 b{TRAIN_BATCH} step', top=12)
    del trainer, st
    torch.cuda.empty_cache()
    secs = dict(train=time.perf_counter() - t0)
    run_dir = rec['run_dir']
    md_kwargs = generator_config(os.path.join(run_dir, 'config.yaml'))
    check(md_kwargs.pop('kind') == MD_KIND, f'{MD_CONFIG}: generator kind')
    launches = serve(os.path.join(work, 'serve'), run_dir, MD_PER_FORWARD,
                     MD_CONFIG, batch=16, ckpt='last.ckpt')
    int8_launches = serve_int8(os.path.join(work, 'int8'), run_dir,
                               MD_INT8_PER_FORWARD, MD_CONFIG,
                               ckpt='last.ckpt')
    secs['serve'] = time.perf_counter() - t0 - sum(secs.values())
    sd = load_checkpoint(os.path.join(run_dir, 'models', 'last.ckpt'))
    gens = make_generators(md_kwargs, sd, MD_KIND)
    generator_vs_plain(gens, MD_CONFIG)
    throughput(gens, card_line, label=MD_CONFIG)
    del gens
    torch.cuda.empty_cache()
    int8_throughput(MD_KIND, md_kwargs, sd, card_line, MD_CONFIG)
    torch.cuda.empty_cache()
    secs['generator'] = time.perf_counter() - t0 - sum(secs.values())
    ffc_launches = ffc_positions_vs_plain(reg_kwargs)
    torch.cuda.empty_cache()
    log(f'phase 17: {time.perf_counter() - t0:.1f} s (' + ', '.join(
        f'{k} {v:.1f}' for k, v in secs.items()) + f'); train '
        f'{rec["ms_per_step"]:.1f} ms/step, peak {rec["peak_gib"]:.2f} GiB, '
        f'idle {rec["profile"]["idle"]}')
    return dict(serve=launches, train=rec['launches'], int8=int8_launches,
                ffc_positions=ffc_launches)


# ------------------------------------------------------ item-4 options
# phase 19: big-lama at full width and depth (configs/training/big-lama.yaml,
# seeded random weights) with the FFC options of ROADMAP queue 1 item 4, and
# plain big-lama at 2560^2, whose 320^2 bottleneck is past kernel 1's
# envelope. (name, generator options, side, batch of the checked forward)
OPT_GENERATORS = (
    ('opt_norm', dict(spectral_kwargs=dict(fft_norm='backward')), 512, 4),
    ('opt_scaled_area', dict(spectral_kwargs=dict(
        spatial_scale_factor=0.5, spatial_scale_mode='area')), 512, 4),
    ('opt_st_outffc', dict(spatial_transform_layers=[4, 12], out_ffc=True),
     512, 4),
    ('opt_plain_units', dict(spectral_kwargs=dict(
        spectral_pos_encoding=True, use_se=True, ffc3d=True)), 512, 4),
    ('big_image', {}, 2560, 1),
)
# launches per forward, and fourier_unit_fft's calls: opt_norm and
# opt_scaled_area as big-lama (kernel 1 at 64^2 and at 32^2); the wrapped
# blocks of opt_st_outffc run kernels 1-3 at 128^2, one launch each as
# before, and its out_ffc block at ngf 64 (16 local, 48 global channels)
# adds six 3x3 reflect convs on kernel 6 (512^2, 16 and 48 channels), its
# two LFU units on kernel 1 (24 channels at 256^2) and its two 512^2
# units on cuFFT; opt_plain_units keeps every unit off kernel 1 by option,
# big_image by shape (36 cuFFT units)
OPT_PER_FORWARD = {
    'opt_norm': (PER_FORWARD, 0),
    'opt_scaled_area': (PER_FORWARD, 0),
    'opt_st_outffc': (dict(PER_FORWARD, fused_fourier_unit=38,
                           halo_conv3x3_reflect=6), 2),
    'opt_plain_units': (dict(PER_FORWARD, fused_fourier_unit=0), 0),
    'big_image': (dict(PER_FORWARD, fused_fourier_unit=0), 36),
}
# bf16 kernels vs the fp32 plain generator (sigmoid output in [0, 1]): the
# kernels' bf16 bound (TOL); big-lama's runs ~1.1e-3 at 512^2 b2
GEN_BF16_ATOL = TOL['bf16'][1]
OPT_PROFILE_BATCH = 16   # the served batch; big_image profiles its b1


def opt_generator(name, opts, size, batch, base_kwargs, card_line, seed):
    """One phase-19 generator: fp32 and bf16 kernels forwards on a batch
    with each kernel's launches and fourier_unit_fft's calls counted
    (OPT_PER_FORWARD), the fp32 plain generator's output as the reference
    (fp32 within GEN_ATOL, bf16 within GEN_BF16_ATOL), then one profiled
    bf16 forward at the served batch (big_image at its b1): device ms and
    the top 5 kernels. Returns the counts by precision."""
    import torch
    from lama_tpu_torch.models import make_generator
    from lama_tpu_torch.ops.kernels import fourier_unit as fu
    t0 = time.perf_counter()
    kw = dict(base_kwargs, **{k: v for k, v in opts.items()
                              if k != 'spectral_kwargs'})
    if 'spectral_kwargs' in opts:
        kw['spectral_kwargs'] = dict(base_kwargs.get('spectral_kwargs') or {},
                                     **opts['spectral_kwargs'])
    sd = random_state_dict(make_generator('ffc_resnet', **kw), seed)
    # the spatial transform angles: uniform in [0, angle_init_range) (80,
    # lama_tpu's default), as the reference's init draws them
    gen = torch.Generator().manual_seed(seed)
    for k in sd:
        if k.endswith('.angle'):
            sd[k] = torch.rand(1, generator=gen) * 80.0
    gens = {}
    for precision, kernels in (('fp32', 'cuda'), ('fp32', 'plain'),
                               ('bf16', 'cuda')):
        g = make_generator('ffc_resnet', kernels=kernels, dtype=dict(
            fp32=torch.float32, bf16=torch.bfloat16)[precision], **kw)
        g.load_state_dict(sd, strict=True)
        gens[precision, kernels] = g.cuda().eval().requires_grad_(False)
    want, want_fft = OPT_PER_FORWARD[name]
    x = random_batch(batch, size, seed)
    counts = {}
    with torch.inference_mode():
        ref = gens['fp32', 'plain'](x)
        outs = {}
        for precision in ('fp32', 'bf16'):
            fns = reset_counts()
            fu.fourier_unit_fft.calls = 0
            outs[precision] = gens[precision, 'cuda'](x)
            torch.cuda.synchronize()
            counts[precision] = {k: fn.launches for k, fn in fns.items()}
            counts[precision]['fourier_unit_fft'] = fu.fourier_unit_fft.calls
    errs = {p: float((o.float() - ref).abs().max()) for p, o in outs.items()}
    log(f'phase 19 {name} {size}^2 b{batch}: kernels vs fp32 plain max|d| '
        f'fp32 {errs["fp32"]:.3e} (atol {GEN_ATOL}), bf16 '
        f'{errs["bf16"]:.3e} (atol {GEN_BF16_ATOL}); launches a forward '
        f'{counts["fp32"]}')
    for precision in ('fp32', 'bf16'):
        got = dict(counts[precision])
        fft_calls = got.pop('fourier_unit_fft')
        check(got == want and fft_calls == want_fft,
              f'phase 19 {name} {precision}: launches {got}, cuFFT units '
              f'{fft_calls}; expected {want}, {want_fft}')
    check(ref.shape == (batch, 3, size, size)
          and bool(torch.isfinite(outs['fp32']).all())
          and bool(torch.isfinite(outs['bf16']).all()),
          f'phase 19 {name}: output {tuple(outs["fp32"].shape)} not finite '
          'or of the wrong shape')
    check(errs['fp32'] <= GEN_ATOL, f'phase 19 {name}: fp32 kernels vs plain')
    check(errs['bf16'] <= GEN_BF16_ATOL,
          f'phase 19 {name}: bf16 kernels vs fp32 plain')
    del outs, ref, gens['fp32', 'plain'], gens['fp32', 'cuda']
    torch.cuda.empty_cache()
    pb = 1 if size > 512 else OPT_PROFILE_BATCH
    xp = random_batch(pb, size, seed + 1)
    with torch.inference_mode():
        prof = device_profile(lambda: gens['bf16', 'cuda'](xp),
                              f'phase 19 {name} {size}^2 b{pb} bf16', top=5)
    del gens
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    log(f'phase 19 {name}: {secs:.1f} s; bf16 b{pb} device '
        f'{prof["device_ms"]} ms, wall {prof["wall_ms"]:.1f} ms, idle '
        f'{prof["idle"]} ({card_line})')
    return dict(counts=counts, errs=errs, profile=prof, seconds=secs)


def item4_options(card_line):
    """Phase 19: each OPT_GENERATORS generator through `opt_generator`.
    Returns their records by name."""
    import torch
    t0 = time.perf_counter()
    base = big_lama_kwargs()
    base.pop('kind')
    out = {}
    for i, (name, opts, size, batch) in enumerate(OPT_GENERATORS):
        out[name] = opt_generator(name, opts, size, batch, base, card_line,
                                  seed=40 + i)
        torch.cuda.empty_cache()
    log(f'phase 19: {time.perf_counter() - t0:.1f} s (' + ', '.join(
        f'{k} {v["seconds"]:.1f}' for k, v in out.items()) + ')')
    return out


# ------------------------------------------------------- the device CLIs
# phase 18 (ROADMAP queue 1 item 12): the CLIs beside predict and train,
# each on an earlier phase's files where it needs them. The exported
# programs call the kernels as registered ops (ops/kernels/library.py),
# whose CUDA implementations count the launches.
EXPORT_SIZE = 512
EXPORT_TOL = {'fp32': 1e-4, 'bf16': 2e-2, 'int8': 2e-2}   # the CLI's bounds
INNER_LEVELS = {1: 512, 2: 256, 3: 128, 4: 64}   # level: its side at 512^2
PRECOMPILE_SHAPES = '512x512,1000x760'
ANALYZE_CONFIG = os.path.join(REPO, 'configs', 'analyze_mask_errors.yaml')


def export_cli(work, model_dir, label, precision, per_forward, card_line,
               extra=()):
    """`python -m lama_tpu_torch.export` (its main, in this process) at
    EXPORT_SIZE^2 on the card: the reloaded program within the CLI's bound
    of the direct call, its launches per forward counted at the ops equal
    to `per_forward` and to the eager module's, and both timed at batch 1
    (CUDA events, median of 10)."""
    import torch
    from lama_tpu_torch import export as export_mod
    t0 = time.perf_counter()
    res = export_mod.main([
        f'model.path={model_dir}', f'outdir={os.path.join(work, "export")}',
        f'height={EXPORT_SIZE}', f'width={EXPORT_SIZE}', 'device=cuda',
        f'precision={precision}', *extra])
    secs = time.perf_counter() - t0
    check(res['max_abs_diff'] < EXPORT_TOL[precision],
          f'export {label} {precision}: max |d| {res["max_abs_diff"]}')
    program, module = res.pop('program'), res.pop('module')
    image, mask = export_mod.seeded_input(EXPORT_SIZE, EXPORT_SIZE, 'cuda')

    def launches(fn):
        fns = reset_counts()
        with torch.no_grad():
            fn(image, mask)
        torch.cuda.synchronize()
        return {k: f.launches for k, f in fns.items()}

    ours, eager = launches(program), launches(module)
    for k, per in per_forward.items():
        check(ours[k] == per, f'export {label} {precision}: {k} {ours[k]} '
              f'launches a forward, expected {per}')
    check(ours == eager, f'export {label} {precision}: program {ours}, '
          f'eager {eager}')
    with torch.no_grad():
        ms = median_ms(lambda: program(image, mask))
        eager_ms = median_ms(lambda: module(image, mask))
    res.update(seconds=secs, launches=ours, ms=ms, eager_ms=eager_ms)
    log(f'export {label} {precision}: {res["bytes"]} bytes, max |d| '
        f'{res["max_abs_diff"]:.3e}, CLI {secs:.1f} s; launches a forward '
        f'{ours} (= eager); b1 {EXPORT_SIZE}^2 ms program {ms:.3f} vs eager '
        f'{eager_ms:.3f} ({card_line})')
    return res


def export_big_lama(work, model_dir, card_line):
    """Phase 18's big-lama exports: fp32, bf16, and int8 with static
    scales calibrated on phase 4's PNGs."""
    import torch
    out = {}
    for precision, per, extra in (
            ('fp32', PER_FORWARD, ()), ('bf16', PER_FORWARD, ()),
            ('int8', INT8_PER_FORWARD,
             (f'calibration_indir={os.path.join(work, "in")}',))):
        out[precision] = export_cli(os.path.join(work, f'x_{precision}'),
                                    model_dir, 'big-lama', precision, per,
                                    card_line, extra)
        torch.cuda.empty_cache()
    return out


def make_checkpoint_cli(work, run_dir):
    """`python -m lama_tpu_torch.make_checkpoint` on phase 6's bf16 run
    dir: the best epoch by the monitor, generator only, its EMA weights in
    place of the parameters (that run keeps an EMA, TRAIN_EMA, so some must
    differ from the raw weights), every tensor finite; then its best.ckpt
    served by the predict CLI (strict load)."""
    import torch
    t0 = time.perf_counter()
    out = os.path.join(work, 'deploy')
    run_module('lama_tpu_torch.make_checkpoint', [run_dir, out])
    with open(os.path.join(run_dir, 'models', 'index.json')) as f:
        best = max(json.load(f), key=lambda r: r['value'])['name']
    src = torch.load(os.path.join(run_dir, 'models', best),
                     map_location='cpu', weights_only=True)['state_dict']
    sd = torch.load(os.path.join(out, 'models', 'best.ckpt'),
                    map_location='cpu', weights_only=True)['state_dict']
    check(sd and all(k.startswith('generator.') for k in sd),
          f'make_checkpoint: keys {sorted(sd)[:4]}')
    ema = {'generator.' + k[len('generator_average.'):]: v
           for k, v in src.items() if k.startswith('generator_average.')}
    want = dict({k: v for k, v in src.items() if k.startswith('generator.')},
                **ema)
    check(sorted(sd) == sorted(want) and all(
        torch.equal(sd[k], want[k]) for k in sd),
          'make_checkpoint: best.ckpt is not the best epoch\'s generator '
          'with its EMA weights')
    check(any(not torch.equal(v, src[k]) for k, v in ema.items()),
          f'make_checkpoint: {best} holds no EMA weights that differ from '
          f'the raw ones ({len(ema)} EMA tensors)')
    bad = [k for k, v in sd.items()
           if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    check(not bad, f'make_checkpoint: non-finite tensors {bad[:4]}')
    serve_checkpoint(work, out, 'best.ckpt')
    secs = time.perf_counter() - t0
    log(f'make_checkpoint: {best} of {run_dir} -> {out}/models/best.ckpt '
        f'({len(sd)} tensors, {len(ema)} from the EMA), served; {secs:.1f} s')
    return secs


def inner_features_cli(work, model_dir):
    """`python -m lama_tpu_torch.predict_inner_features` on one of phase
    4's 512^2 PNGs: one heat map a level, at that level's side."""
    import shutil
    t0 = time.perf_counter()
    indir, outdir = (os.path.join(work, d) for d in ('inner_in', 'inner'))
    os.makedirs(indir)
    for name in ('img0.png', 'img0_mask.png'):
        shutil.copy(os.path.join(work, 'in', name), indir)
    run_module('lama_tpu_torch.predict_inner_features',
               [f'model.path={model_dir}', f'indir={indir}',
                f'outdir={outdir}', 'device=cuda'])
    for level, side in INNER_LEVELS.items():
        heat = read_png(os.path.join(outdir, f'img0_mask_lev{level:02d}_norm'
                                     '.png'), 'L')
        check(heat.shape == (side, side) and heat.max() > heat.min(),
              f'inner features: level {level} {heat.shape}, range '
              f'{heat.min()}-{heat.max()}')
    secs = time.perf_counter() - t0
    log(f'inner features: levels {list(INNER_LEVELS)} at 512^2, {secs:.1f} s')
    return secs


def analyze_errors_cli(work, ev):
    """`python -m lama_tpu_torch.analyze_errors` on phase 13's 32 pairs
    (InceptionV3 on the card, the port's linear SVM), then --only-report
    on its pickles."""
    import pickle
    t0 = time.perf_counter()
    out = os.path.join(work, 'analyze')
    argv = [ANALYZE_CONFIG, ev['data'], ev['pred'], out, '--device', 'cuda']
    run_module('lama_tpu_torch.analyze_errors', argv)
    run_module('lama_tpu_torch.analyze_errors', argv + ['--only-report'])
    with open(os.path.join(out, 'latents', 'join_scores_table.csv')) as f:
        rows = f.read().strip().splitlines()
    scores = {}
    for name in ('real_scores', 'fake_scores'):
        with open(os.path.join(out, 'latents', f'{name}.pkl'), 'rb') as f:
            scores[name] = np.asarray(pickle.load(f))
    n = len(ev['bins'])
    check(len(rows) == n + 1, f'analyze_errors: {len(rows)} table lines')
    check(all(np.isfinite(v).all() and len(v) == n for v in scores.values()),
          f'analyze_errors: scores {scores}')
    for d in ('global_best', 'global_worst'):
        files = os.listdir(os.path.join(out, d))
        check(len(files) == min(30, n), f'analyze_errors: {d} {len(files)}')
    real, fake = scores['real_scores'], scores['fake_scores']
    check(real.mean() > fake.mean(), f'analyze_errors: real scores '
          f'{real.mean()} vs fake {fake.mean()}')
    secs = time.perf_counter() - t0
    log(f'analyze_errors: {n} pairs, real score mean {real.mean():.3f}, fake '
        f'{fake.mean():.3f}, {secs:.1f} s (with --only-report)')
    return secs


def precompile_cli(work, model_dir):
    """`python -m lama_tpu_torch.precompile` (its main, in this process):
    the build (already warm here: 0.0 s a source), then shapes
    PRECOMPILE_SHAPES at b16 bf16, then the same with refine=true."""
    from lama_tpu_torch import precompile
    from lama_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    common = [f'model.path={model_dir}', f'shapes={PRECOMPILE_SHAPES}',
              'batch_size=16', 'precision=bf16', 'device=cuda']
    serve_rep = precompile.main(common)
    refine_rep = precompile.main(common + ['refine=true'])
    shapes = precompile.parse_shapes(PRECOMPILE_SHAPES)
    check(sorted(serve_rep['build']) == sorted(_build.SOURCES),
          f'precompile: build {serve_rep["build"]}')
    check(sorted(serve_rep['predict']) == sorted(shapes)
          and sorted(refine_rep['refine']) == sorted(shapes),
          f'precompile: {serve_rep}, {refine_rep}')
    secs = time.perf_counter() - t0
    log(f'precompile: build (warm) {serve_rep["build"]}; b16 forwards '
        + ', '.join(f'{h}x{w} {v:.2f} s' for (h, w), v in
                    serve_rep['predict'].items())
        + '; refine ' + ', '.join(f'{h}x{w} {v:.2f} s' for (h, w), v in
                                  refine_rep['refine'].items())
        + f'; {secs:.1f} s')
    return secs


def device_clis(work, gen_kwargs, sd):
    """The rest of phase 18 in its own dir: precompile, inner features on
    a copy of phase 4's first PNG pair, evaluator_example."""
    from lama_tpu_torch import evaluator_example
    model_dir = os.path.join(work, 'model')
    write_model_dir(model_dir, dict(kind='ffc_resnet', **gen_kwargs), sd)
    write_images(os.path.join(work, 'in'), np.random.RandomState(0))
    secs = dict(precompile=precompile_cli(work, model_dir),
                inner_features=inner_features_cli(work, model_dir))
    t0 = time.perf_counter()
    res = evaluator_example.main([])
    ssim = res['ssim', 'total']['mean']
    check(math.isfinite(ssim) and 0 < ssim <= 1,
          f'evaluator_example: {res}')
    secs['evaluator_example'] = time.perf_counter() - t0
    log(f'evaluator_example: ssim total {ssim:.4f}, '
        f'{secs["evaluator_example"]:.1f} s')
    return secs


# ------------------------------------------------------- data parallel
# Phase 20 (a): DP_RANKS gloo ranks on the one card (NCCL refuses two ranks
# on one device), DP_BATCH images each, so the global batch is phase 6's
# TRAIN_BATCH. An fp32 run with SGD (which keeps the update linear in the
# gradient; Adam amplifies fp32 summation order) is held to one process on
# the global batch: every metric within rtol DP_RTOL / atol DP_ATOL, the BN
# statistics after the first step within DP_STATS_TOL. Then a bf16 run as
# configured (Adam). Two ranks that share one card measure what the
# collectives cost, not scaling.
DP_RANKS = 2
DP_BATCH = TRAIN_BATCH // DP_RANKS
DP_FP32_STEPS, DP_BF16_STEPS = 2, 3
DP_RTOL, DP_ATOL, DP_STATS_TOL = 1e-3, 1e-5, 1e-5
# the BN statistics after a step also hold the second G forward's, on
# weights the update moved: held to DP_FLOOR_FACTOR times the one
# process's own spread when its images move by DP_X_EPS (relative,
# gaussian), as the G-step check does (TRAIN_X_EPS, TRAIN_FLOOR_FACTOR)
DP_X_EPS, DP_FLOOR_FACTOR = 1e-6, 2.0
DP_TIMEOUT = 300   # s: each collective's in a worker, and each world's
DP_SGD = ('optimizers.generator.kind=sgd', 'optimizers.generator.lr=0.01',
          'optimizers.discriminator.kind=sgd',
          'optimizers.discriminator.lr=0.001')
DP_NCCL_STEPS, DP_VAL_N = 4, 4   # phase 20 (b); its first 2 steps warm up


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def dp_config(work, precision, batch, extra=()):
    """big-lama's train config at full width, ResNetPL on random weights
    from the seed, `batch` images a rank."""
    from lama_tpu_torch.config import compose
    return compose(os.path.join(REPO, 'configs', 'training'), 'big-lama', [
        f'location.data_root_dir={work}', f'location.out_root_dir={work}',
        f'location.tb_dir={work}', f'location.pretrained_models={work}',
        f'data.batch_size={batch}', f'data.train.out_size={TRAIN_SIZE}',
        f'trainer.kwargs.precision={"bf16" if precision == "bf16" else 32}',
        'losses.resnet_pl.allow_random_weights=true', 'device=cuda', *extra])


def dp_batches(steps, seed=20):
    """`steps` global batches of TRAIN_BATCH at TRAIN_SIZE^2: smooth
    images with noise and a box hole each, NHWC float32."""
    rng = np.random.RandomState(seed)
    s = TRAIN_SIZE
    yy, xx = np.mgrid[0:s, 0:s] / 30.0
    out = []
    for _ in range(steps):
        imgs = np.zeros((TRAIN_BATCH, s, s, 3), np.float32)
        masks = np.zeros((TRAIN_BATCH, s, s, 1), np.float32)
        for i in range(TRAIN_BATCH):
            p = rng.rand(3) * 6
            img = np.stack([np.sin(yy + p[0]), np.cos(xx - p[1]),
                            np.sin(xx + yy + p[2])], -1)
            imgs[i] = np.clip(0.5 + 0.4 * img + 0.05 * rng.randn(s, s, 3), 0, 1)
            y0, x0 = rng.randint(0, s // 2, size=2)
            masks[i, y0:y0 + s // 3, x0:x0 + s // 2] = 1
        out.append((imgs, masks))
    return out


def bn_stats(trainer):
    """Every BatchNorm running statistic of G and D, on the host."""
    out = {}
    for prefix, mod in (('G.', trainer.state.generator),
                        ('D.', trainer.state.discriminator)):
        out.update({prefix + k: v.detach().cpu().clone()
                    for k, v in mod.state_dict().items()
                    if k.endswith(('running_mean', 'running_var'))})
    return out


@contextlib.contextmanager
def timed_collectives(calls):
    """Appends (kind, bytes, host ms) of each all_reduce and broadcast call
    in the block to `calls`. gloo stages a CUDA tensor through the host, so
    a call also waits for the work queued before it."""
    import torch.distributed as dist
    saved = dist.all_reduce, dist.broadcast

    def timed(kind, fn):
        def run(tensor, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(tensor, *args, **kwargs)
            calls.append((kind, tensor.numel() * tensor.element_size(),
                          (time.perf_counter() - t0) * 1e3))
            return out
        return run

    dist.all_reduce = timed('all_reduce', saved[0])
    dist.broadcast = timed('broadcast', saved[1])
    try:
        yield calls
    finally:
        dist.all_reduce, dist.broadcast = saved


def step_profile(fn):
    """One call of fn under torch.profiler (device activity only): wall ms
    and the device's busy ms; no retry, so every rank runs fn once."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return dict(wall_ms=wall, device_ms=device or None)


def ranks_bit_equal(trainer):
    """Whether this rank's G and D weights and buffers are bit-equal to
    rank 0's (rank 0 broadcasts them, one flat tensor per dtype)."""
    import torch
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors
    tensors = [t.detach() for m in (trainer.state.generator,
                                    trainer.state.discriminator)
               for t in (*m.parameters(), *m.buffers())]
    same = True
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        flat = _flatten_dense_tensors([t for t in tensors if t.dtype == dtype])
        ref = flat.clone()
        dist.broadcast(ref, src=0, group=trainer.group)
        same = same and torch.equal(flat.view(torch.uint8),
                                    ref.view(torch.uint8))
    return bool(same)


def dp_steps(trainer, batches, rank=0, world=1, profile_last=False):
    """The trainer's step on this rank's rows of each global batch (the
    trainer's own wire and device copy): per step the metrics averaged over
    the ranks, host ms (synchronised before and after), launches, the
    collectives inside the step (with a group) and whether the ranks'
    weights are bit-equal after it; with `profile_last`, the last step
    runs under the profiler. The BN statistics are kept after the first
    step (`bn_stats`) and as the G optimizer first steps (`bn_stats_first`:
    G's from the G step's forward, D's from the G step's D forwards, all
    on the starting weights)."""
    import torch
    from lama_tpu_torch.parallel.data_parallel import global_rows
    rec = dict(metrics=[], ms=[], counts=[], collectives=[], equal=[])

    def first_update(opt, args, kwargs):
        if 'bn_stats_first' not in rec:
            rec['bn_stats_first'] = bn_stats(trainer)
    handle = trainer.state.g_opt.register_step_pre_hook(first_update)
    for i, (img, mask) in enumerate(batches):
        image, hole = trainer.to_device(trainer.to_wire(dict(
            image=global_rows(img, rank, world),
            mask=global_rows(mask, rank, world))))
        fns = kernel_wrappers()
        before = {k: f.launches for k, f in fns.items()}
        calls, out = [], {}

        def step():
            out['metrics'] = trainer.step_fn(trainer.state, image, hole)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (timed_collectives(calls) if trainer.group is not None
              else contextlib.nullcontext()):
            if profile_last and i == len(batches) - 1:
                rec['profile'] = step_profile(step)
            else:
                step()
            torch.cuda.synchronize()
        rec['ms'].append((time.perf_counter() - t0) * 1e3)
        rec['counts'].append({k: f.launches - before[k] for k, f in fns.items()})
        rec['collectives'].append(calls)
        rec['metrics'].append(trainer.global_metrics(out['metrics']))
        if trainer.group is not None:
            rec['equal'].append(ranks_bit_equal(trainer))
        if i == 0:
            rec['bn_stats'] = bn_stats(trainer)
            handle.remove()
    return rec


def wait_for(path, timeout):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        check(time.monotonic() < deadline, f'no {path} after {timeout} s')
        time.sleep(0.1)


def dp_worker(argv):
    """One rank of phase 20 (a): `python3 chip_smoke.py --dp-worker RANK
    WORLD INIT WORKDIR`. The fp32 SGD steps, then, once the parent's
    one-process run has ended (WORKDIR/dp_one.done), the bf16 steps (the
    last profiled), on its rows of the global batches; writes
    WORKDIR/dp<RANK>.pt."""
    import torch
    sys.path.insert(0, REPO)
    rank, world, init, work = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lama_tpu_torch.parallel import multihost
    from lama_tpu_torch.training.trainer import InpaintingTrainer
    multihost.maybe_initialize_distributed(
        init_method=init, world_size=world, rank=rank, local_rank=0,
        backend='gloo', device='cuda', timeout=DP_TIMEOUT)
    out = dict(backend=torch.distributed.get_backend())
    batches = dp_batches(max(DP_FP32_STEPS, DP_BF16_STEPS))
    mark(f'rank {rank}: in the group')
    try:
        for precision, steps, extra in (('fp32', DP_FP32_STEPS, DP_SGD),
                                        ('bf16', DP_BF16_STEPS, ())):
            trainer = InpaintingTrainer(
                dp_config(work, precision, DP_BATCH, extra),
                os.path.join(work, f'dp_{precision}'), device='cuda')
            check(trainer.world == world and trainer.group is not None,
                  f'rank {rank}: the trainer is not in the world')
            mark(f'rank {rank}: {precision} trainer built')
            if precision == 'bf16':   # time the steps on a card of their own
                wait_for(os.path.join(work, 'dp_one.done'), DP_TIMEOUT)
                multihost.barrier()
                mark(f'rank {rank}: the one-process run has ended')
            torch.cuda.reset_peak_memory_stats()
            out[precision] = dp_steps(trainer, batches[:steps], rank, world,
                                      profile_last=precision == 'bf16')
            mark(f'rank {rank}: {precision} steps done')
            out[precision]['peak_gib'] = (torch.cuda.max_memory_allocated()
                                          / 2 ** 30)
            del trainer
            torch.cuda.empty_cache()
    finally:
        multihost.shutdown()
    torch.save(out, os.path.join(work, f'dp{rank}.pt'))
    return 0


def dp_train(argv):
    """Phase 20 (b)'s rank under torchrun: `python -m torch.distributed.run
    ... chip_smoke.py --dp-train OUT.json <train argv>` runs
    lama_tpu_torch.train as `-m` runs it (runpy, in this process) with
    each step's metrics, ms, launches and collectives and the validation's
    launches recorded, and the process group's backend and world; writes
    OUT.json. Its fit, the trainer built, writes OUT.json.ready and waits
    for OUT.json.go."""
    import torch
    sys.path.insert(0, REPO)
    from lama_tpu_torch.training import step as step_mod
    from lama_tpu_torch.training import trainer as trainer_mod
    out_path, train_argv = argv[0], argv[1:]
    rec = dict(metrics=[], ms=[], counts=[], collectives=[])
    call = step_mod.InpaintingTrainStep.__call__
    validate = trainer_mod.InpaintingTrainer.validate

    def counted_call(self, state, image, mask, draws=None):
        fns = kernel_wrappers()
        before = {k: f.launches for k, f in fns.items()}
        mark(f'(b) step {len(rec["ms"])}')
        calls = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timed_collectives(calls):
            metrics = call(self, state, image, mask, draws)
            torch.cuda.synchronize()
        rec['ms'].append((time.perf_counter() - t0) * 1e3)
        rec['collectives'].append((len(calls), sum(c[2] for c in calls)))
        rec['counts'].append({k: f.launches - before[k] for k, f in fns.items()})
        rec['metrics'].append({k: float(v) for k, v in metrics.items()})
        return metrics

    def counted_validate(self, epoch):
        import torch.distributed as dist
        rec.update(backend=dist.get_backend(), world=self.world,
                   card=torch.cuda.current_device(), run_dir=self.run_dir)
        fns = kernel_wrappers()
        before = {k: f.launches for k, f in fns.items()}
        mark('(b) validation')
        t0 = time.perf_counter()
        with counting_forwards() as forwards:
            val = validate(self, epoch)
        mark('(b) validation done')
        rec.update(val_seconds=time.perf_counter() - t0, val_metrics=val,
                   val_forwards=forwards[0],
                   val_counts={k: f.launches - before[k]
                               for k, f in fns.items()})
        return val

    def gated_fit(self, resume_from=None):
        open(out_path + '.ready', 'w').close()
        wait_for(out_path + '.go', DP_TIMEOUT)
        mark('(b) released')
        return fit(self, resume_from)

    fit = trainer_mod.InpaintingTrainer.fit
    step_mod.InpaintingTrainStep.__call__ = counted_call
    trainer_mod.InpaintingTrainer.validate = counted_validate
    trainer_mod.InpaintingTrainer.fit = gated_fit
    reset_counts()
    run_module('lama_tpu_torch.train', train_argv)
    with open(out_path, 'w') as f:
        json.dump(rec, f)
    return 0


def run_session(cmd, log_path, timeout):
    """Start cmd in a session of its own, its output to log_path; returns
    the Popen. `end_session` waits for it and kills the whole session (the
    launcher's children too) at the timeout."""
    f = open(log_path, 'w')
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=f, stderr=subprocess.STDOUT,
                            start_new_session=True)
    proc.log_file, proc.deadline = f, time.monotonic() + timeout
    return proc


def end_session(proc):
    import signal
    try:
        proc.wait(timeout=max(1.0, proc.deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    finally:
        proc.log_file.close()
        try:   # whatever the session left behind
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return proc.returncode


def check_session(proc, rc, label):
    """Logs the session's `[seconds]` marks (and the end of its output
    when it failed); fails unless it exited 0."""
    with open(proc.log_file.name) as f:
        text = f.read()
    marks = [f'  {label}: {ln}' for ln in text.splitlines()
             if ln.startswith('[') and ' s] ' in ln]
    if marks:
        log('\n'.join(marks))
    if rc != 0:
        log(f'{label} (exit {rc}), the end of its output:\n{text[-6000:]}')
    check(rc == 0, f'{label} exited with {rc}')


def _close(ours, theirs, rtol, atol):
    return abs(ours - theirs) <= atol + rtol * abs(theirs)


def dp_nccl_start(work):
    """Phase 20 (b)'s session: `python -m torch.distributed.run
    --standalone --nproc_per_node 1 chip_smoke.py --dp-train ...` on
    synthetic JPEGs, a val set of DP_VAL_N images and the serve phase's
    PNGs (written first); its fit waits for OUT.json.go."""
    rng = np.random.RandomState(21)
    data = os.path.join(work, 'dp_data')
    write_train_images(data, TRAIN_BATCH * DP_NCCL_STEPS, rng)
    val_dir = os.path.join(work, 'dp_val')
    write_val_images(val_dir, rng, n=DP_VAL_N)
    write_images(os.path.join(work, 'in'), rng)
    run_dir = os.path.join(work, 'dp_nccl')
    out_json = os.path.join(work, 'dp_nccl.json')
    argv = ['-cn', 'big-lama', f'location.data_root_dir={data}',
            f'location.out_root_dir={work}', f'location.tb_dir={work}',
            f'location.pretrained_models={work}', f'run_dir={run_dir}',
            f'data.batch_size={TRAIN_BATCH}',
            f'data.train.out_size={TRAIN_SIZE}', 'data.num_workers=4',
            'trainer.kwargs.max_epochs=1',
            f'trainer.kwargs.limit_train_batches={DP_NCCL_STEPS}',
            'trainer.kwargs.log_every_n_steps=1',
            'trainer.kwargs.precision=bf16',
            'losses.resnet_pl.allow_random_weights=true', 'device=cuda',
            f'data.val.indir={val_dir}', 'data.val.img_suffix=.png',
            '+evaluator.fid=false', '~evaluator.integral_kind',
            'trainer.checkpoint_kwargs.monitor=val_ssim_total_mean']
    proc = run_session(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', '1', os.path.join(REPO, 'chip_smoke.py'),
         '--dp-train', out_json, *argv],
        os.path.join(work, 'dp_nccl.log'), DP_TIMEOUT)
    proc.run_dir, proc.out_json = run_dir, out_json
    return proc


def a_checks(work, one, spread, phase6_ms, t_a):
    """Phase 20 (a)'s checks and logs on the ranks' records (work/dp<r>.pt)
    and the one process's runs; returns rank 0's bf16 launches."""
    import torch
    ranks = [torch.load(os.path.join(work, f'dp{r}.pt'), weights_only=False)
             for r in range(DP_RANKS)]
    for i, c in enumerate(one['counts']):
        check(c == PER_TRAIN_STEP, f'phase 20 one process step {i}: '
              f'launches {c}, expected {PER_TRAIN_STEP}')
    for r, rank in enumerate(ranks):
        check(rank['backend'] == 'gloo', f'rank {r}: {rank["backend"]}')
        for precision, steps in (('fp32', DP_FP32_STEPS),
                                 ('bf16', DP_BF16_STEPS)):
            rec = rank[precision]
            check(len(rec['metrics']) == steps and all(rec['equal']),
                  f'phase 20 {precision} rank {r}: weights differ from rank '
                  f'0\'s after a step ({rec["equal"]})')
            check(rec['metrics'] == ranks[0][precision]['metrics'],
                  f'phase 20 {precision}: the ranks\' global metrics differ')
            for i, m in enumerate(rec['metrics']):
                check(all(math.isfinite(v) for v in m.values()),
                      f'phase 20 {precision} step {i}: non-finite {m}')
            for i, c in enumerate(rec['counts']):
                check(c == PER_TRAIN_STEP, f'phase 20 {precision} rank {r} '
                      f'step {i}: launches {c}, expected {PER_TRAIN_STEP}')
    # fp32: the ranks against the one process
    worst_m = max(abs(ours[k] - v) / max(abs(v), 1e-30)
                  for ours, theirs in zip(ranks[0]['fp32']['metrics'],
                                          one['metrics'])
                  for k, v in theirs.items())
    bn = {}   # when: (max |d| / its bound, |d|, |v| there, key), worst first
    for when in ('bn_stats_first', 'bn_stats'):
        stats, ours = one[when], ranks[0]['fp32'][when]
        check(stats and stats.keys() == ours.keys(), 'phase 20: BN keys')
        bn[when] = []
        for k, v in stats.items():
            d = (ours[k] - v).abs()
            r = d / (DP_STATS_TOL + DP_STATS_TOL * v.abs())
            i = int(r.argmax())
            bn[when].append((float(r[i]), float(d[i]), float(v.abs()[i]), k))
        bn[when].sort(reverse=True)
    log(f'phase 20 (a) fp32 SGD, {DP_RANKS} ranks x b{DP_BATCH} vs 1 process '
        f'x b{TRAIN_BATCH}, {DP_FP32_STEPS} steps: largest metric relative '
        f'difference {worst_m:.3e} (rtol {DP_RTOL}, atol {DP_ATOL}); '
        f'{len(bn["bn_stats"])} BN statistics, the largest |d| / ({DP_STATS_TOL}'
        f' + {DP_STATS_TOL} |v|) (|d|, |v|) as G first steps: ' + '; '.join(
            f'{k} {r:.3f} ({d:.2e}, {v:.2e})'
            for r, d, v, k in bn['bn_stats_first'][:4])
        + '; after step 1: ' + '; '.join(
            f'{k} {r:.3f} ({d:.2e}, {v:.2e})'
            for r, d, v, k in bn['bn_stats'][:4])
        + '; weights bit-equal across ranks after every step')
    for i, (ours, theirs) in enumerate(zip(ranks[0]['fp32']['metrics'],
                                           one['metrics'])):
        check(ours.keys() == theirs.keys(), f'phase 20 metrics {ours.keys()}')
        for k, v in theirs.items():
            check(_close(ours[k], v, DP_RTOL, DP_ATOL),
                  f'phase 20 fp32 step {i} {k}: 2 ranks {ours[k]} vs 1 '
                  f'process {v}')
    r, d, v, k = bn['bn_stats_first'][0]
    check(r <= 1, f'phase 20 fp32 BN {k} as G first steps: |d| {d:.3e} at '
          f'|v| {v:.3e}, outside {DP_STATS_TOL} + {DP_STATS_TOL} |v|')
    # after step 1: max |d| / (1 + |v|) over every statistic
    ours, floor = (max(float(((a[k] - v).abs() / (1 + v.abs())).max())
                       for k, v in one['bn_stats'].items())
                   for a in (ranks[0]['fp32']['bn_stats'], spread['bn_stats']))
    log(f'phase 20 (a) fp32 BN statistics after step 1: max |d| / (1 + |v|) '
        f'{ours:.3e}, the one process\'s own spread at images x (1 + '
        f'{DP_X_EPS} N(0, 1)) {floor:.3e} (ratio {ours / floor:.3f}, bound '
        f'{DP_FLOOR_FACTOR})')
    check(ours <= DP_FLOOR_FACTOR * floor, 'phase 20 fp32 BN statistics '
          f'after step 1: {ours:.3e} > {DP_FLOOR_FACTOR} x {floor:.3e}')
    bf = ranks[0]['bf16']
    for r, rank in enumerate(ranks):
        b = rank['bf16']
        per_step = [(len(c), sum(ms for _, _, ms in c),
                     sum(nb for _, nb, _ in c)) for c in b['collectives']]
        log(f'phase 20 (a) bf16 rank {r}: ms per step '
            + ', '.join(f'{t:.1f}' for t in b['ms'])
            + f' (step {DP_BF16_STEPS - 1} profiled); collectives a step '
            '(calls, host ms, MB): ' + ', '.join(
                f'{n} / {ms:.1f} / {nb / 2 ** 20:.1f}' for n, ms, nb in per_step)
            + f'; peak {b["peak_gib"]:.2f} GiB; losses step 0 -> '
            f'{DP_BF16_STEPS - 1}: gen_total {b["metrics"][0]["gen_total"]:.4f}'
            f' -> {b["metrics"][-1]["gen_total"]:.4f}, discr_total '
            f'{b["metrics"][0]["discr_total"]:.4f} -> '
            f'{b["metrics"][-1]["discr_total"]:.4f}')
        p = b['profile']
        log(f'phase 20 (a) bf16 rank {r} profiled step: wall {p["wall_ms"]:.1f}'
            ' ms, device busy ' + (
                'not measured' if p['device_ms'] is None else
                f'{p["device_ms"]:.1f} ms (idle share '
                f'{1 - p["device_ms"] / p["wall_ms"]:.3f})'))
    calls = bf['collectives'][1]
    small = [ms for _, nb, ms in calls if nb <= 1 << 16]
    big = [ms for _, nb, ms in calls if nb > 1 << 16]
    coll_ms = sum(ms for _, _, ms in calls)
    log(f'phase 20 (a) bf16 rank 0 step 1: {bf["ms"][1]:.1f} ms, of which in '
        f'collectives {coll_ms:.1f} ms (share {coll_ms / bf["ms"][1]:.3f}): '
        f'{len(small)} small all-reduces (BN statistics, metrics; <= 64 KiB) '
        f'{sum(small):.1f} ms, {len(big)} gradient buckets {sum(big):.1f} ms; '
        f'phase 6 b{TRAIN_BATCH} one process: {phase6_ms:.1f} ms per step; '
        f'(a) took {t_a:.1f} s')

    return {k: sum(c[k] for c in bf['counts']) for k in bf['counts'][0]}


def data_parallel(work, phase6_ms):
    """Phase 20: (a) DP_RANKS gloo ranks against one process, then their
    bf16 run; (b) one rank under torchrun on NCCL, its last.ckpt served,
    started with (a) and released when (a) ends. Returns the launches of
    (a)'s bf16 run (rank 0) and of (b)'s run."""
    import torch
    from lama_tpu_torch.training.trainer import InpaintingTrainer
    t0 = time.perf_counter()
    init = f'tcp://127.0.0.1:{free_port()}'
    procs = [run_session([sys.executable, os.path.join(REPO, 'chip_smoke.py'),
                          '--dp-worker', str(r), str(DP_RANKS), init, work],
                         os.path.join(work, f'dp{r}.log'), DP_TIMEOUT)
             for r in range(DP_RANKS)]
    # (b) starts now too and waits, its trainer built, until (a) has ended
    nccl = dp_nccl_start(work)
    try:   # every exit before (b) has ended ends its session at once
        try:   # meanwhile, the one process on the global batch, twice
            batches = dp_batches(DP_FP32_STEPS)
            rng = np.random.RandomState(22)
            moved = [((img * (1 + DP_X_EPS * rng.randn(*img.shape))).astype(
                np.float32), mask) for img, mask in batches]
            one, spread = (dp_steps(InpaintingTrainer(
                dp_config(work, 'fp32', TRAIN_BATCH, DP_SGD),
                os.path.join(work, f'dp_one{j}'), device='cuda'), b)
                for j, b in enumerate((batches, moved)))
            torch.cuda.empty_cache()
            mark('phase 20 (a): the one-process run has ended')
            wait_for(nccl.out_json + '.ready', DP_TIMEOUT)
        finally:   # (a)'s bf16 steps start once this exists
            open(os.path.join(work, 'dp_one.done'), 'w').close()
            rcs = [end_session(proc) for proc in procs]
        open(nccl.out_json + '.go', 'w').close()
        t1 = time.perf_counter()
        for r, (proc, rc) in enumerate(zip(procs, rcs)):
            check_session(proc, rc, f'phase 20 rank {r}')
        mark('phase 20 (a): the ranks have ended')
        gloo = a_checks(work, one, spread, phase6_ms, t1 - t0)
        check_session(nccl, end_session(nccl), 'phase 20 (b) torchrun')
    except BaseException:
        nccl.deadline = 0
        end_session(nccl)
        raise
    mark('phase 20 (b): the rank has ended')
    run_dir = nccl.run_dir
    with open(nccl.out_json) as f:
        rec = json.load(f)
    check(rec.get('backend') == 'nccl' and rec.get('world') == 1,
          f'phase 20 (b): backend {rec.get("backend")}, world '
          f'{rec.get("world")}')
    check(len(rec['metrics']) == DP_NCCL_STEPS and all(
        math.isfinite(v) for m in rec['metrics'] for v in m.values()),
        f'phase 20 (b): losses {rec["metrics"]}')
    for i, c in enumerate(rec['counts']):
        check(c == PER_TRAIN_STEP,
              f'phase 20 (b) step {i}: launches {c}, expected {PER_TRAIN_STEP}')
    n = rec['val_forwards']
    check(n > 0 and all(rec['val_counts'][k] == per * n
                        for k, per in PER_FORWARD.items()),
          f'phase 20 (b) validation: launches {rec["val_counts"]} in {n} '
          'forwards')
    val = rec['val_metrics']
    for key in ('val_ssim_total_mean', 'val_lpips_total_mean'):
        check(math.isfinite(val.get(key, float('nan'))),
              f'phase 20 (b) validation: {key} {val.get(key)}')
    check(os.path.isfile(os.path.join(run_dir, 'models', 'last.ckpt')),
          'phase 20 (b): no last.ckpt')
    serve_checkpoint(work, run_dir)
    timed = rec['ms'][TRAIN_WARMUP:]
    log(f'phase 20 (b) torchrun, 1 rank on NCCL (card {rec["card"]}), '
        f'b{TRAIN_BATCH} {TRAIN_SIZE}^2 bf16: {np.mean(timed):.1f} ms per '
        f'step (mean of {len(timed)} after {TRAIN_WARMUP} warm-up; all: '
        + ', '.join(f'{t:.1f}' for t in rec['ms'])
        + f'; phase 6, one process without a group: {phase6_ms:.1f}); '
        'collectives a step (calls, host ms): ' + ', '.join(
            f'{n} / {ms:.1f}' for n, ms in rec['collectives'])
        + f'; validation of {DP_VAL_N} images in {rec["val_seconds"]:.1f} s '
        f'(ssim {val["val_ssim_total_mean"]:.4f}, lpips '
        f'{val["val_lpips_total_mean"]:.4f}); (b) took '
        f'{time.perf_counter() - t1:.1f} s; phase 20 '
        f'{time.perf_counter() - t0:.1f} s')
    return dict(gloo=gloo, nccl={k: sum(c[k] for c in rec['counts'])
                                 for k in rec['counts'][0]})


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import lama_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card_line = card()
    mark('phase 2: build')
    build()
    mark('phase 3: kernels')
    gen = torch.Generator().manual_seed(0)
    rows = kernels_vs_plain(gen)
    kernel_gradients(gen, rows)
    fourier_unit_stages(gen, rows)
    gen_kwargs = big_lama_kwargs()
    gen_kwargs.pop('kind')
    from lama_tpu_torch.models import make_generator
    sd = random_state_dict(make_generator('ffc_resnet', **gen_kwargs), seed=0)
    with tempfile.TemporaryDirectory() as work:
        model_dir = os.path.join(work, 'model')
        write_model_dir(model_dir, dict(kind='ffc_resnet', **gen_kwargs), sd)
        mark('phase 4: serve')
        launches = serve(work, model_dir)
        mark('phase 5: refine')
        refine_launches = refine(work, model_dir)
        mark('phase 6: train')
        trained = train(work)
        mark('phase 18: exports, make_checkpoint')
        # phase 18 on phases 4 and 6's files
        t18 = time.perf_counter()
        exports = export_big_lama(work, model_dir, card_line)
        cli_secs = dict(export=time.perf_counter() - t18)
        cli_secs['make_checkpoint'] = make_checkpoint_cli(
            work, trained['bf16']['run_dir'])
    for row in rows:
        row['launches'] = launches[row['dtype']][row['name']]
        row['refine_launches'] = refine_launches[row['name']]
        row['train_launches'] = trained[row['dtype']]['launches'][row['name']]
    mark('phase 7: generator')
    gens = make_generators(gen_kwargs, sd)
    generator_vs_plain(gens)
    mark('phase 8: refine checks')
    refine_passes_vs_plain(gens)
    refine_gradient_vs_plain(gens)
    refine_step_split(gens['bf16', 'cuda'])
    mark('phase 9: throughput')
    throughput(gens, card_line)
    del gens
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        model_dir = os.path.join(work, 'model')
        write_model_dir(model_dir, dict(kind='ffc_resnet', **gen_kwargs), sd)
        mark('phase 13: evaluate')
        ev = evaluate(work, model_dir, card_line)
        mark('phase 14: segmentation')
        segmentation(work, ev, card_line)
        cli_secs['analyze_errors'] = analyze_errors_cli(work, ev)   # phase 18
    torch.cuda.empty_cache()

    # big-lama-regular: the GlobalGenerator, kernel 6 on its block convs
    reg_kwargs = big_lama_kwargs('big-lama-regular')
    reg_kind = reg_kwargs.pop('kind')
    mark('phases 10-12: big-lama-regular')
    reg_sd = random_state_dict(make_generator(reg_kind, **reg_kwargs), seed=1)
    with tempfile.TemporaryDirectory() as work:
        model_dir = os.path.join(work, 'model_regular')
        write_model_dir(model_dir, dict(kind=reg_kind, **reg_kwargs), reg_sd)
        reg_launches = serve(work, model_dir, REGULAR_PER_FORWARD,
                             'big-lama-regular')
        refine_refused(work, model_dir)
        reg_trained = train(work, 'big-lama-regular', REGULAR_TRAIN_STEPS,
                            REGULAR_PER_TRAIN_STEP)
        t18 = time.perf_counter()   # phase 18
        exports['regular_bf16'] = export_cli(
            os.path.join(work, 'x_regular'), model_dir, 'big-lama-regular',
            'bf16', REGULAR_PER_FORWARD, card_line)
        cli_secs['export'] += time.perf_counter() - t18
    gens = make_generators(reg_kwargs, reg_sd, reg_kind)
    generator_vs_plain(gens, 'big-lama-regular')
    throughput(gens, card_line, label='big-lama-regular')
    for row in rows:
        name = row['name']
        row['regular_launches'] = reg_launches[row['dtype']][name]
        row['regular_train_launches'] = \
            reg_trained[row['dtype']]['launches'][name]
        if REGULAR_PER_FORWARD[name] and not PER_FORWARD[name]:
            # kernel 6: its path is big-lama-regular's
            row['launches'] = row['regular_launches']
    del gens
    torch.cuda.empty_cache()

    mark('phase 15: the rest of training')
    with tempfile.TemporaryDirectory() as work:
        rest = rest_of_training(work)
    for row in rows:
        run_b = rest['B', row['dtype']]
        row['rest_train_launches'] = run_b['launches'][row['name']]
        row['rest_train_per_step'] = [c[row['name']] for c in run_b['counts']]
    torch.cuda.empty_cache()

    mark('phase 16: int8 serving')
    with tempfile.TemporaryDirectory() as work:
        int8_rows_ = int8_serving(work, gen_kwargs, sd, reg_kind, reg_kwargs,
                                  reg_sd, card_line)
    torch.cuda.empty_cache()

    mark('phase 17: the multidilated family and ffc_positions')
    with tempfile.TemporaryDirectory() as work:
        md = multidilated(work, reg_kwargs, card_line)
    for row in rows:
        name = row['name']
        row['md_launches'] = md['serve'][row['dtype']][name]
        row['md_train_launches'] = md['train'][name]
        row['ffc_positions_launches'] = md['ffc_positions'][name]
        if row['role'] == 'md_branch_b16':   # its path is ablv2_work_md's
            row['launches'] = row['md_launches']
        if row['role'] == 'lfu_b16':         # ffc_positions'
            row['launches'] = row['ffc_positions_launches']
    for row in int8_rows_:
        row['md_launches'] = md['int8'][row['name']]
    rows += int8_rows_
    torch.cuda.empty_cache()

    mark('phase 18: the device CLIs (their other parts ran beside phases '
         '6, 14 and 12)')
    with tempfile.TemporaryDirectory() as work:
        cli_secs.update(device_clis(work, gen_kwargs, sd))
    log(f'phase 18: {sum(cli_secs.values()):.1f} s (' + ', '.join(
        f'{k} {v:.1f}' for k, v in cli_secs.items()) + '); exports ' + ', '.join(
        f'{k} {v["bytes"]} bytes, max |d| {v["max_abs_diff"]:.2e}, ms '
        f'{v["ms"]:.3f} vs eager {v["eager_ms"]:.3f}'
        for k, v in exports.items()))

    mark('phase 19: the item-4 options and the 2560^2 image')
    opt = item4_options(card_line)
    for row in rows:
        row['phase19_launches'] = {k: v['counts'].get(row['dtype'], {}).get(
            row['name']) for k, v in opt.items()}
        if row['role'] == 'fu_b16_norm_backward':   # opt_norm's path
            row['launches'] = row['phase19_launches']['opt_norm']
    torch.cuda.empty_cache()

    mark('phase 20: data parallel')
    with tempfile.TemporaryDirectory() as work:
        dp = data_parallel(work, trained['bf16']['ms_per_step'])
    for row in rows:
        row['dp_gloo_launches'] = dp['gloo'].get(row['name'])
        row['dp_nccl_launches'] = dp['nccl'].get(row['name'])
    mark('done')
    log(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--dp-worker']:   # phase 20 (a)'s ranks
        sys.exit(dp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ['--dp-train']:    # phase 20 (b)'s rank
        sys.exit(dp_train(sys.argv[2:]))
    sys.exit(main())
