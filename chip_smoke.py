"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: compile dip_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. kernel parity: each seam kernel (fwd, fwd with the carry-in, dgrad,
     wgrad) against its plain PyTorch version at the five flagship seam
     shapes in bf16 and f32 and at one ragged shape, with times at the
     flagship shapes beside the plain version's and those of the one
     PyTorch call that computes the same function (cuDNN's conv, transposed
     conv and weight gradient, each first held to the plain version); every
     seam kernel also at seams that cut its tiles raggedly, at the
     'library' / restoration 'kate' seams (C, F = 16..128), timed there,
     and at activation maximization's seams (LR 4 and 8, C = F = 128),
     timed from a CUDA graph of launches; the fit axis of fwd, fwd with
     the carry-in, dgrad and wgrad (BatchEngine's launches: B fits' e,
     each fit's images through its own) at 8 fits of LR 32^2 and 2 fits of
     the top seam, each fit's slice against its plain version and bitwise
     the single-fit launch's, the B = 1 form bitwise today's, graph-timed
     beside B x one fit and the grouped library call;
     the data and weight gradients (whose reductions may be split) launched
     twice at every seam, the two results bitwise equal; the downsample
     kernel against its plain version at the SR geometries (x4 and x8 at HR
     384x576, a ragged batch, gauss12, box, preserve_size=False) and at the
     128-channel post-down of a 512^2 Skip's top scale, with times, and its
     bound at x4, x8 and 128 channels; the s2d pack (bitwise) at the
     five 'kate' seam cotangents, NHWC and channel-planar, ragged, and at
     activation maximization's two (graph-timed); the
     3x3 and 1x1 weight-gradient kernels at the 'kate' shapes in bf16 and
     f32, NHWC and channel-planar, and at ragged and narrow shapes,
     launched twice and bitwise equal, with times beside their plain
     versions' and cuDNN's (bf16 with the time of its operands' layout
     copies, which its time includes); and their fit axis (BatchEngine's
     conv_wgrad) at 8 fits of the top 'kate' shapes, one launch for the 8
     fits in bf16 and in f32, each fit bitwise its single-fit launch, timed
     beside 8 x one fit, the plain version and one grouped cuDNN weight
     gradient; the downsample kernel's row form (a row block with its halo
     rows, row pad 0, column pad p) against its plain version at the
     128-channel post-down (1,512,512,128), a 4-block Skip's top block and
     lanczos3, timed at the first;
  4. small-input reference: a 2-scale 128-channel skip net, forward and
     gradients on the card against the same net on the CPU: under an MSE
     at full resolution, and under the SR loss (x4 downsample, MSE at LR)
     with the seam's carry-in off and on; and with 128-channel skips,
     nearest upsampling and every weight gradient from the kernels, under
     the masked MSE; then the zoo's nets the same way under an MSE, every
     weight gradient from the kernels: UNet (deconv and bilinear up),
     ResNet, TextureNet (no noise: the draws differ by device), DCGAN
     (transposed convs, and upsample + conv);
  5. main paths, each through run_task for 30 steps, graphed (Engine.run:
     one eager step, then replays of the step's CUDA graph): the flagship
     denoising fit (tasks.denoise 'f16', 512^2) in bf16 and f32; the SR fit
     (tasks.super_resolve, HR 384x576) at x4 in bf16, f32 and bf16 with the
     carry-in, and at x8 in bf16; inpainting 'kate' (512^2, 128-channel
     skips) with the weight-gradient kernels on, in bf16 and f32, and off;
     inpainting 'library' (6 scales, weight jitter), restoration 'barbara'
     (50 % of the pixels) and restoration 'kate' (avg-pool downsampling),
     in bf16; [zoo] inpainting 'library' with its UNet (8-128 channels,
     more_layers 1, deconv up, instance norm) and its ResNet (8 blocks of
     32 channels) at 512^2, bf16 and f32, every weight gradient from the
     kernels.
     Launch counters, set to 0 just before each fit and read just after
     it, must equal what the model implies (a Skip's fused seams counted
     as Skip.forward decides them, fused_scales): every step went through
     the kernels (a capture launches nothing; each replay counts the
     captured step's launches);
  6. no host sync: three more eager steps per dtype of the flagship, in
     bf16 with a jitter schedule and with SGD, of the SR (x4, and x8 in
     bf16) and inpainting 'kate' fits (weight-gradient kernels and weight
     jitter on) under torch's sync debug mode, which raises on any call
     that waits for the device (Adam and SGD only: an L-BFGS step reads
     each line-search trial on the host by design);
  7. [graph] the flagship in bf16 and f32 under deterministic cuDNN: 10
     eager steps against Engine.run of 10 (one eager step, 9 replays) from
     the same seeds, every loss, param and the EMA bit for bit; both it/s;
  8. [queue] 8 flagship fits in bf16 through FitQueue, 30 steps each in
     chunks of 10, each on its own stream: losses finite and falling,
     params different across seeds, launch counts 8 x the fit's; the
     aggregate it/s beside the graphed b1 fit's, and the peak memory;
  9. [batch] BatchEngine over 8 flagship fits (Skip 5x128, bilinear seams)
     in bf16 and f32 at 512^2 and at 64^2 (with the carry-in), 30 graphed
     steps: losses falling, renders finite, the launches one fit's (each
     seam kernel once a seam for all 8), the fit-iterations/s beside a
     graphed b1 fit and the FitQueue b8; under deterministic cuDNN one
     batched step against 8 Engine steps from the same seeds (loss and
     gradients per fit at stated limits) and 10 eager batched steps against
     run() bit for bit; 3 batched steps with no host sync; then 8 'kate'
     fits (inpainting, 512^2, 128-channel skips) with conv_wgrad='all', in
     bf16 and f32, one batched step: each K5/K6 fit-axis call's every fit
     bitwise its single-fit launch, the launches exact (K5/K6 one fit's in
     both dtypes); and 8 flagship fits at 64^2 in f32 with optimizer
     'lbfgs' (10 graphed Adam warm-up steps, 10 eager L-BFGS steps, the
     line searches in lockstep): launches exact, losses falling, and each
     L-BFGS step held at the batched fit's state against its own Engine
     (loss, evaluations and, where the evaluations agree, the step itself
     at stated limits);
 10. [spatial] SpatialEngine at full width, its activations cut into row
     blocks over a mesh that repeats the one card: the flagship Skip 5x128
     in bf16 at 1024^2 over 4 blocks and in f32 at 512^2 over 2, the
     'library' UNet (bf16) and ResNet (f32) at 512^2 with conv_wgrad='all',
     get_net's TextureNet on a 512^2 denoising fit (bf16), dcgan() at its
     defaults from 62^2 to 256^2 (f32), each over 2 blocks, and the
     flagship with the lanczos2 post-down at 512^2 bf16 over 4: under
     deterministic cuDNN one step against Engine's from the same seed at
     [batch]'s f32 limits (and a bf16 fit's loss at the bf16 limit, its
     gradients against Engine's f32 step within 1.5x Engine's own bf16
     step's error there) and 10 eager
     steps against run() bit for bit, in the fit's dtype; 20
     graphed steps (loss falling, render finite, every kernel blocks x one
     fit's launches: K1-K4 at the seams, K5/K6 at each routed conv, K7 at
     each Lanczos post-down), it/s and peak memory beside the unsharded
     fit's; 3 sharded steps with no host sync; each fit's wall;
 11. [fleet] eval_sr_dataset_sharded over make_mesh() on three synthetic
     PNGs of two sizes, x4, under deterministic cuDNN: names, finite
     scores, one BatchEngine program per shape group, scores within 0.1 dB
     of eval_sr_dataset's with the same seeds after one step and within
     3 dB (its own run-to-run spread) after 40;
 12. [flash] flash/no-flash at 512^2 in bf16 (nearest up at the two top
     seams, bilinear below) under deterministic cuDNN from fixed seeds:
     loss falling, psnr_track rising, launch counts;
 13. [ckpt] the flagship in bf16 under deterministic cuDNN: 10 steps,
     saved, restored into a fresh state, 10 more, against 20
     uninterrupted, bit for bit;
 14. [lbfgs] the flagship with optimizer 'lbfgs' in bf16 and f32: 10 Adam
     warm-up steps (graphed), then 10 eager L-BFGS steps: the loss falls
     and is finite, and the seam kernels' launches are what the warm-up,
     the value-and-gradient evaluations and the render imply; evaluations
     and eager ms a step;
 15. [backbones] AlexNet-caffe (227^2), VGG19, VGG16 and the modified
     VGG19 (224^2) at full width with seeded random weights, card against
     CPU, TF32 off: the deepest conv or pool tap and the fc taps, and the
     gradient of the deepest tap's sum with respect to the image;
 16. [fi] feature inversion through run_task, 30 graphed steps, bf16 and
     f32: AlexNet fc6 at 227^2 (the notebook's recipe) and a Gram-matrix
     match at VGG19 conv3_1 at 224^2, the generator at 256^2, on a
     synthetic numpy image: loss falling, the render the classifier's crop,
     no seam launch (zero padding fuses none);
 17. [am] activation maximization through run_task, 30 graphed steps, bf16
     and f32, the recipe's jitter and weight jitter: AlexNet conv4 map 2
     ('maximize') and fc8 ('am_match', lr 1e-2): loss falling, the render
     the crop, K1 = 2 x 31 and K2, K3, K4 = 2 x 30 launches;
 18. [cli] `dip_tpu_torch.cli.main(["fit", "--task", "activation_max",
     "--num-iter", "30", "--log-every", "10"])` in this process, on its
     default device: returns 0, three falling loss lines, exact launches;
     then `eval-sr --fleet` on the [fleet] images: rc 0, each score finite;
 19. [examples] on stand-ins of the reference's data/ at full size
     (write_reference_standins, under build/): each of the nine examples'
     main(argv) in this process on its default device, 20 iterations
     (fit_batch: 8 fits at 256^2), in an empty directory: rc 0, finite
     loss or PSNR lines, its images written, and exactly the launches its
     fits imply;
 20. [recipes] `tools.reproduce --quick` over the 13 recipes in bf16, then
     in f32, on the stand-ins: finite records, K1-K4 launched by every
     recipe on a skip net and K7 by the SR ones; then `--quick-gate` in
     f32 and in bf16: every bf16 best within 0.75 dB of the f32 best (the
     PSNR floors, set on the reference's photos, printed beside the
     readings and not held here);
 21. [train] `tools.train_backbone --quick` under deterministic cuDNN from
     its fixed seeds: AlexNet trained 400 steps at
     batch 16 to a held-out accuracy of at least 0.9, its exported .pth
     reloaded through pretrained/convert.py bit for bit the trained
     state, and falling losses of feature inversion (fc6) and activation
     maximization (fc8 class 3) on it, 60 iterations each; each phase's
     wall is printed.
The last three lines are the card line, a JSON object of the kernels (each
with its launches on a main path, the seam kernels' fit-axis forms as rows
of their own with their launches in [batch], the weight gradients' fit
axis likewise, error, times, and the bound of this
run's shapes on an H100: bytes at 3.35 TB/s against operations at 989
TFLOP/s bf16 or 67 TFLOP/s f32 FMA; the weight gradients' rows give their
bf16 figures as the row's own, their f32 figures under "f32" and each
dtype's source under "sources"; the downsample's row gives SR x4 as its
own and x4, x8 and 128 channels under "shapes", its row form's row the
(1,512,512,128) block and the launches of [spatial]'s Lanczos Skip), and
{"ok": true,
"device": {...}}.
Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# max-normalised relative error max|kernel - plain| / max|plain|. f32 mode:
# identical bf16-rounded operands, f32 sums in another order. bf16 mode:
# the same, then one bf16 rounding of each result.
TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
FLAGSHIP_SEAMS = [(1, h, h, 128, 128) for h in (16, 32, 64, 128, 256)]
RAGGED_SEAM = (2, 12, 20, 8, 16)
# seams that cut the forward's and the weight gradient's tiles (8x16
# pixels, 128 columns, 64 channels) raggedly: h and w off the pixel tile, C
# off the channel tile and 4F off the column tile, and C and 4F off 8 (the
# synchronous staging)
FWD_RAGGED = [(1, 33, 47, 72, 40), (3, 9, 7, 24, 12), (2, 7, 9, 5, 3)]
# the seams of inpainting 'library' and restoration 'kate' at 512^2 below
# their 128-channel scales, (N, h, w, C, F)
LIBRARY_SEAMS = [(1, 256, 256, 16, 16), (1, 128, 128, 32, 16), (1, 64, 64, 64, 32),
                 (1, 32, 32, 128, 64)]
# activation maximization's seams: the inversion net at 256^2 with
# reflection padding fuses its two deepest decoder scales, LR 4 and 8
AM_SEAMS = [(1, h, h, 128, 128) for h in (4, 8)]
# the seam kernels' fit axis, (B, N, h, w, C, F): 8 fits at LR 32^2, and 2
# fits at the flagship's top seam
FIT_SEAMS = [(8, 1, 32, 32, 128, 128), (2, 1, 256, 256, 128, 128)]
# the H100 SXM's dense peaks (NVIDIA's data sheet): the least time of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
MAIN_STEPS = 30
GRAPH_STEPS = 10  # eager against graphed
LBFGS_WARMUP, LBFGS_STEPS = 10, 10
QUEUE_JOBS = 8
BATCH_FITS = 8  # [batch]
# [batch]: one batched step against the fits' own Engine steps, deterministic
# cuDNN: the loss's relative error, and every gradient's error over the
# fit's largest. Only the arithmetic's order differs (grouped cuDNN
# convolutions, reductions over a vmapped layout), but BN's one-pass moments
# (E[x^2] - mean^2) amplify an order difference by mean^2 / var, and the
# seam rounds its cotangent to bf16, where a last-bit difference moves an
# element by 2^-8 of itself: 2 flagship fits at 128^2 and 256^2 on the CPU
# in f32 read 6.7e-3 to 3.1e-2 (2.0e-3 to 6.1e-3 with the seam off, 7.7e-6
# for a 2-scale 8-channel net), the losses within 1.1e-4. bf16 rounds every
# activation too. A fit that read another fit's data would be off by O(1).
# The biases of the convs that feed a BN have a gradient of exactly zero in
# exact arithmetic (BN takes the mean out): what either side computes there
# is rounding noise, in bf16 up to 0.68 of the fit's largest gradient (read
# on an H100: PERF.md §6), so they are left out of the comparison.
BATCH_LOSS_TOL = {"bfloat16": 1e-2, None: 1e-3}
BATCH_GRAD_TOL = {"bfloat16": 1e-1, None: 5e-2}
# [batch] with conv_wgrad='all': BATCH_FITS 'kate' fits (inpainting, 512^2,
# 128-channel skips), one batched step a dtype, each fit's K5/K6 result
# bitwise its single-fit launch on its own slice
# [batch] L-BFGS: BATCH_FITS flagship fits at 64^2 in f32 (with the
# carry-in), LBFGS_WARMUP graphed Adam steps, then LBFGS_STEPS L-BFGS steps.
# Free runs of a batched fit and its own Engine part: on the CPU, 2 such
# fits read 3-10 % apart in loss within the 20 steps, and Adam at lr 0.01
# up to 84 % (hazard 5: +-lr steps on rounding noise). So each L-BFGS step
# is held at the batched fit's own state: its Engine, put at that state
# (params, EMA, step counters, jitter generators, L-BFGS memory), takes the
# step alone; its loss within BATCH_LOSS_TOL[None] of the batched fit's
# (2.1e-4 read on the CPU), and its evaluations equal in at least
# BATCH_LBFGS_SAME_EVALS of the LBFGS_STEPS steps of every fit (a Wolfe test
# whose margin lies below the rounding difference can go either way).
# Where the evaluations are equal, the step itself (the new params less the
# old, over all leaves: the direction from each fit's memory times its
# accepted t) is held too: its error over its largest element within
# BATCH_LBFGS_STEP_TOL. The step is the two-loop recursion's linear map of
# the gradient times t, so it carries the gradient's rounding difference
# (BATCH_GRAD_TOL[None]'s 5e-2; 4 such fits at 64^2 on the CPU read
# 1.6e-4 to 1.4e-2 over 10 steps); a direction from another fit's memory, a
# lost memory pair or another accepted trial is off by O(1).
BATCH_LBFGS_SIZE = 64
BATCH_LBFGS_SAME_EVALS = 8
BATCH_LBFGS_STEP_TOL = BATCH_GRAD_TOL[None]
# the weight-gradient kernels' fit axis (phase 3): BATCH_FITS fits at the
# top 'kate' shapes, (kernel, halo, one fit's x and g (H, W, C))
WGRAD_FIT_CASES = [("wgrad3x3_s1", 0, (514, 514, 128), (512, 512, 128)),
                   ("wgrad1x1", 0, (512, 512, 128), (512, 512, 128))]
# [spatial]: (net, compute dtype, image size, row blocks), each over a mesh
# that repeats the one card, SPATIAL_STEPS graphed steps: the flagship
# Skip, the 'library' UNet and ResNet of [zoo] (conv_wgrad='all'), get_net's
# TextureNet on the flagship's denoising fit, dcgan() at its defaults
# (input 62^2, output 256^2) on a 256^2 denoising fit, and the flagship
# with the lanczos2 post-down. One step of the sharded fit is held to
# Engine's from the same seed at [batch]'s f32 limits (BATCH_LOSS_TOL,
# BATCH_GRAD_TOL), and in a bf16 fit its loss at the bf16 limit: the blocks
# sum the norms' moments in another order, and the seam rounds its operands
# to bf16, so a last-bit difference moves an element by 2^-8 of itself (on
# the CPU with the seam on, f32: 9.7e-6 loss, 2.4e-3 gradients; bf16:
# 1.3e-4, 4.2e-2). A bf16 fit's gradients are held against Engine's f32
# step: within SPATIAL_BF16_FLOOR times Engine's own bf16 step's error there
# (the geometry's bf16 rounding floor). Two orders of bf16 sums can differ
# by as much as bf16 differs from f32 (on an H100, the lanczos2 Skip at
# 512^2 over 4 blocks in bf16: 1.13e-1 against Engine's bf16 step, whose
# floor read 1.67e-1), so [batch]'s bf16 limit of 1e-1 is below the noise
# there, while a missing halo or a block's wrong rows read O(1).
SPATIAL_BF16_FLOOR = 1.5
SPATIAL_FITS = [("flagship", "bfloat16", 1024, 4), ("flagship", None, 512, 2),
                ("library UNet", "bfloat16", 512, 2), ("library ResNet", None, 512, 2),
                ("texture_nets", "bfloat16", 512, 2), ("dcgan", None, 256, 2),
                ("flagship lanczos2", "bfloat16", 512, 4)]
SPATIAL_STEPS = 20
# [fleet]: HR sizes (multiples of 32) by name, two shapes; x4. Under
# deterministic cuDNN the fleet's scores after one step within FLEET_DB_1
# of the sequential evaluation's (the fits start alike: the batched
# forward's last bits alone), and after FLEET_STEPS within FLEET_DB, the
# sequential evaluation's own spread: at 40 steps on these images two of
# its runs with cuDNN's default algorithms read up to 2.9 dB apart (on an
# H100: PERF.md §6), the fits being that sensitive to the last bits
FLEET_IMAGES = {"a": (128, 128), "b": (128, 192), "c": (128, 128)}
FLEET_STEPS = 40
FLEET_DB_1, FLEET_DB = 0.1, 3.0
# Stand-ins for the reference's data/ (the card has no photos): file ->
# ((W, H) before the recipe's crop, PIL mode, the SYNTHETIC_SET image it
# shows), the reference's layout and sizes (SURVEY.md:137, RESULTS.md:21-39).
# A size that is not square is the centre of that image drawn square. The
# no-flash image is the flash one's scene under a warm, dim light falling
# off to one side, with sensor noise. Masks: lines of text for 'kate'
# (utils/masks.get_text_mask), one central hole for 'vase', rows of small
# holes for 'library'.
STANDINS = {
    "denoising/F16_GT.png": ((512, 512), "RGB", "disks"),
    "denoising/snail.jpg": ((384, 256), "RGB", "texture"),
    "inpainting/kate.png": ((512, 512), "RGB", "disks"),
    "inpainting/vase.png": ((320, 320), "RGB", "gradient"),
    "inpainting/library.png": ((704, 448), "RGB", "bands"),
    "restoration/barbara.png": ((512, 512), "L", "texture"),
    "sr/zebra_GT.png": ((584, 388), "RGB", "checker"),
    "flash_no_flash/cave01_00_flash.jpg": ((774, 706), "RGB", "bands"),
    "flash_no_flash/cave01_01_noflash.jpg": ((774, 706), "RGB", "bands"),
}
STANDIN_MASKS = {"inpainting/kate_mask.png": "inpainting/kate.png",
                 "inpainting/vase_mask.png": "inpainting/vase.png",
                 "inpainting/library_mask.png": "inpainting/library.png"}
KERNELS = {
    "fwd": ("dip_tpu_torch/csrc/up_conv_fwd.cu", "dip_tpu/ops/pallas_up_conv.py:233"),
    "fwd_carry": ("dip_tpu_torch/csrc/up_conv_fwd.cu", "dip_tpu/ops/pallas_up_conv.py:233"),
    "dgrad": ("dip_tpu_torch/csrc/up_conv_dgrad.cu", "dip_tpu/ops/pallas_up_conv.py:307"),
    "wgrad": ("dip_tpu_torch/csrc/up_conv_wgrad.cu", "dip_tpu/ops/pallas_up_conv.py:369"),
}
DOWNSAMPLE = ("dip_tpu_torch/csrc/resample.cu", "dip_tpu/ops/pallas_resample.py:119")
S2D = ("dip_tpu_torch/csrc/s2d.cu", "dip_tpu/ops/pallas_s2d.py:101")
# the conv weight gradients: bf16 runs the seam wgrad's mma.sync kernel (the
# kernels line's `source` and main figures), f32 runs csrc/wgrad.cu (the
# row's `f32` figures)
WGRAD_SOURCES = {torch.bfloat16: "dip_tpu_torch/csrc/up_conv_wgrad.cu",
                 torch.float32: "dip_tpu_torch/csrc/wgrad.cu"}
WGRAD = {"wgrad3x3_s1": (WGRAD_SOURCES[torch.bfloat16], "dip_tpu/ops/pallas_wgrad.py:153"),
         "wgrad1x1": (WGRAD_SOURCES[torch.bfloat16], "dip_tpu/ops/pallas_wgrad.py:210")}
# the seam cotangents of inpainting 'kate' at 512^2, (N, 2h, 2w, 128)
KATE_DZ = [(1, 2 * h, 2 * h, 128) for h in (16, 32, 64, 128, 256)]
AM_DZ = [(1, 2 * h, 2 * h, 128) for _, h, _, _, _ in AM_SEAMS]
S2D_RAGGED = [(2, 12, 20, 24), (1, 6, 10, 5)]
# weight gradients against their plain versions, max-normalised: f32 is
# true f32 on both sides (sums in another order); bf16 takes the same bf16
# operands and f32 sums on both sides, the tolerance of a bf16 result
WGRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (kernel, halo, x shape, g shape, layout): the 'kate' fit's shapes at
# 512^2 (its reflect-padded 3x3 convs at halo 0; the 1x1 skip, up and head
# convs), a zero-padded 3x3 in both layouts, ragged batches, channel counts
# off 8 (the synchronous and the 4-byte staging) and off 4 (the one-value
# sum passes), narrow outputs (Co <= 16), channel-planar inputs, and N = 2
# channel-planar
WGRAD_CASES = [
    ("wgrad3x3_s1", 0, (1, 514, 514, 128), (1, 512, 512, 128), "nhwc"),
    ("wgrad3x3_s1", 0, (1, 514, 514, 128), (1, 512, 512, 128), "planar"),
    ("wgrad3x3_s1", 0, (1, 258, 258, 128), (1, 256, 256, 128), "nhwc"),
    ("wgrad3x3_s1", 0, (1, 258, 258, 128), (1, 256, 256, 128), "planar"),
    ("wgrad3x3_s1", 1, (1, 256, 256, 128), (1, 256, 256, 128), "nhwc"),
    ("wgrad3x3_s1", 1, (2, 19, 23, 24), (2, 19, 23, 40), "nhwc"),
    ("wgrad3x3_s1", 1, (2, 19, 23, 20), (2, 19, 23, 12), "nhwc"),
    ("wgrad3x3_s1", 0, (1, 12, 15, 5), (1, 10, 13, 3), "planar"),
    ("wgrad3x3_s1", 1, (1, 256, 256, 128), (1, 256, 256, 128), "planar"),
    ("wgrad3x3_s1", 0, (2, 34, 70, 64), (2, 32, 68, 48), "planar"),
    ("wgrad1x1", 0, (1, 512, 512, 128), (1, 512, 512, 128), "nhwc"),
    ("wgrad1x1", 0, (1, 512, 512, 128), (1, 512, 512, 128), "planar"),
    ("wgrad1x1", 0, (1, 512, 512, 128), (1, 512, 512, 3), "nhwc"),
    ("wgrad1x1", 0, (1, 512, 512, 32), (1, 512, 512, 128), "nhwc"),
    ("wgrad1x1", 0, (1, 16, 16, 128), (1, 16, 16, 128), "nhwc"),
    ("wgrad1x1", 0, (3, 7, 9, 20), (3, 7, 9, 5), "nhwc"),
    ("wgrad1x1", 0, (1, 33, 70, 20), (1, 33, 70, 12), "planar"),
    ("wgrad1x1", 0, (1, 33, 70, 20), (1, 33, 70, 36), "planar"),
    ("wgrad1x1", 0, (2, 64, 128, 128), (2, 64, 128, 128), "planar"),
]
FIT_SIZE = 512  # the inpainting and restoration fits
ZOO_NETS = ("UNet", "ResNet")  # the [zoo] fits: inpainting 'library' with these nets
# the downsample kernel against its plain version: true f32 on both sides
# (FMA chains against banded f32 matmuls with TF32 off), sums in another order
DOWN_TOL = 1e-5
SR_HR = (384, 576)  # super-resolution.ipynb's zebra, cropped to a multiple of 32
# (N, H, W, C), factor, kernel_type, phase, preserve_size, kernel_width
DOWN_CASES = [
    ((1, *SR_HR, 3), 4, "lanczos2", 0.5, True, None),
    ((1, *SR_HR, 3), 8, "lanczos2", 0.5, True, None),
    ((2, 70, 45, 3), 3, "lanczos2", 0.5, True, None),
    ((1, *SR_HR, 3), 2, "gauss12", 0.0, True, None),
    ((1, *SR_HR, 3), 4, "box", 0.5, True, 4),
    ((1, *SR_HR, 3), 4, "lanczos2", 0.5, False, None),
    ((1, 512, 512, 128), 2, "lanczos2", 0.5, True, None),  # a 512^2 Skip's top post-down
]
# timed with their bounds: SR x4 (the row's own figures), SR x8, 128 channels
DOWN_TIMED = [DOWN_CASES[0], DOWN_CASES[1], DOWN_CASES[-1]]
# the downsample's row form (a row block that brings its halo rows, at row
# pad 0 and column pad p = (K - f) / 2), x2 phase 0.5: (1,512,512,128) (the
# row form's own figures), a 4-block 512^2 Skip's top block (128 rows and 3
# halo rows a side), and lanczos3 (5 a side)
DOWN_ROWS = [((1, 512, 512, 128), "lanczos2"), ((1, 134, 512, 128), "lanczos2"),
             ((1, 74, 256, 128), "lanczos3")]


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    a, b = a.float(), b.float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError("non-finite values in a kernel comparison")
    abs_err = (a - b).abs().max().item()
    return abs_err / max(b.abs().max().item(), 1e-30), abs_err


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """The device time of one call of `fn`: CUDA events around the replay
    of a CUDA graph that holds `reps` calls, so no host launch cost sits
    between them (a loop of calls shorter than their launch reads the
    host's pace, which time_ms does)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # device constants and shared-memory limits, before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    from dip_tpu_torch.bench import card_line

    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from dip_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {_build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def bound(ops: float, peak: str, nbytes: float) -> tuple[float, str]:
    """(least ms, what bounds it): `nbytes` moved once at the memory rate
    against `ops` operations at the peak of type `peak`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[peak]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def seam_bound(name: str, n: int, h: int, w: int, c: int, f: int,
               dtype: torch.dtype, fits: int = 1) -> tuple[float, str]:
    """The bound of a seam kernel at (N, h, w, C, F): 2*N*h*w*9*C*4F
    tensor-core operations (bf16 in both modes) against each input read and
    each output written once, xp, out and de in `dtype`, dzq bf16; with the
    fit axis, N counts every fit's images and e (or de) is `fits` kernels."""
    s = torch.finfo(dtype).bits // 8
    xp = n * (h + 2) * (w + 2) * c * s
    e = fits * 9 * c * 4 * f * s
    dzq = n * h * w * 4 * f * 2
    z = n * 4 * h * w * f * s
    nbytes = {"fwd": xp + e + z, "fwd_carry": xp + e + 2 * z, "dgrad": dzq + e + xp,
              "wgrad": xp + dzq + e}[name]
    return bound(2.0 * n * h * w * 9 * c * 4 * f, "bf16", nbytes)


def wgrad_bound(ks: int, x_shape, g_shape, dtype: torch.dtype) -> tuple[float, str]:
    """The bound of a ks x ks weight gradient of x (N,Hx,Wx,Ci) against g
    (N,H,W,Co): 2*N*H*W*ks*ks*Ci*Co operations of dtype's kind (tensor cores
    in bf16, FMA in f32) against x and g read once and dW written once in
    f32."""
    n, h, w, co = g_shape
    ci = x_shape[3]
    s = torch.finfo(dtype).bits // 8
    nbytes = s * (int(np.prod(x_shape)) + int(np.prod(g_shape))) + 4 * ks * ks * ci * co
    return bound(2.0 * n * h * w * ks * ks * ci * co,
                 "bf16" if dtype == torch.bfloat16 else "f32", nbytes)


# -- library yardsticks: the one PyTorch call that computes each seam
# kernel's function, timed beside it and used nowhere in the port. Their
# inputs are prepared once, outside any timed region: the operands rounded
# to bf16 as the seam's numerics do (a no-op in bf16), in the working dtype.

def library_weights(e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """e (3,3,C,4F) as (4F,C,3,3) conv weights: the forward's, output
    channel f*4+p*2+q (pixel_shuffle's order), and e's own column order
    (p*2+q)*F+f, which the phase-major dzq of dgrad and wgrad has."""
    w_nat = e.permute(3, 2, 0, 1)
    f4 = w_nat.shape[0]
    w_fwd = w_nat.reshape(4, f4 // 4, *w_nat.shape[1:]).transpose(0, 1).reshape(w_nat.shape)
    return w_fwd.contiguous(), w_nat.contiguous()


def fwd_library(xp: torch.Tensor, w_fwd: torch.Tensor,
                carry: torch.Tensor | None = None) -> torch.Tensor:
    """K1 (K1c with `carry`): cuDNN's conv of xp's NCHW view (N,C,h+2,w+2),
    then pixel_shuffle, the same phase -> HR interleave; NHWC view out."""
    z = F.pixel_shuffle(F.conv2d(xp.permute(0, 3, 1, 2), w_fwd), 2).permute(0, 2, 3, 1)
    return z if carry is None else z + carry


def dgrad_library(dzq: torch.Tensor, w_nat: torch.Tensor) -> torch.Tensor:
    """K2: the transposed conv of the phase-major dzq as NCHW, padding 0,
    gives (N,C,h+2,w+2) = dxp; NHWC view out."""
    return F.conv_transpose2d(dzq.permute(0, 3, 1, 2), w_nat).permute(0, 2, 3, 1)


def wgrad_library(xp: torch.Tensor, dzq: torch.Tensor) -> torch.Tensor:
    """K3: cuDNN's weight gradient of the conv xp -> dzq, as (3,3,C,4F)."""
    size = (dzq.shape[3], xp.shape[3], 3, 3)
    return torch.nn.grad.conv2d_weight(xp.permute(0, 3, 1, 2), size,
                                       dzq.permute(0, 3, 1, 2)).permute(2, 3, 1, 0)


def library_calls(xp, e, dzq, carry, dtype: torch.dtype) -> dict:
    """Each seam kernel's yardstick as a closure over its prepared inputs."""
    xr, er, dzr = (t.to(torch.bfloat16).to(dtype) for t in (xp, e, dzq))
    w_fwd, w_nat = library_weights(er)
    return {"fwd": lambda: fwd_library(xr, w_fwd),
            "fwd_carry": lambda: fwd_library(xr, w_fwd, carry),
            "dgrad": lambda: dgrad_library(dzr, w_nat),
            "wgrad": lambda: wgrad_library(xr, dzr)}


def seam_calls(H, xp, e, dzq, carry, dtype: torch.dtype) -> dict:
    """Each seam kernel's (kernel, plain version) calls on these inputs,
    through the seam module `H` (ops/hopper_up_conv of some checkout)."""
    return {"fwd": (lambda: H.fwd(xp, e), lambda: H.fwd_plain(xp, e)),
            "fwd_carry": (lambda: H.fwd(xp, e, carry), lambda: H.fwd_plain(xp, e, carry)),
            "dgrad": (lambda: H.dgrad(dzq, e, dtype), lambda: H.dgrad_plain(dzq, e, dtype)),
            "wgrad": (lambda: H.wgrad(xp, dzq), lambda: H.wgrad_plain(xp, dzq))}


def phase_kernel_parity(dev: torch.device) -> dict:
    from dip_tpu_torch.fit.engine import disable_tf32
    from dip_tpu_torch.ops import hopper_up_conv as H

    disable_tf32()  # as the Engine: the f32 yardsticks and plain versions run true f32
    stats = {k: {"max_abs_err": 0.0} for k in KERNELS}
    gen = torch.Generator(device=dev).manual_seed(0)
    # (shape, kernels held, timed): every kernel at the flagship and ragged
    # seams, at the seams that cut their tiles and at the 'library' seams;
    # timed at all but the ragged ones
    timed_seams = FLAGSHIP_SEAMS + LIBRARY_SEAMS + AM_SEAMS
    cases = [(s, tuple(KERNELS), s in timed_seams)
             for s in FLAGSHIP_SEAMS + [RAGGED_SEAM] + FWD_RAGGED + LIBRARY_SEAMS + AM_SEAMS]
    for dtype in (torch.bfloat16, torch.float32):
        for (n, h, w, c, f), names, timed in cases:
            xp = torch.randn((n, h + 2, w + 2, c), generator=gen, device=dev).to(dtype)
            e = (torch.randn((3, 3, c, 4 * f), generator=gen, device=dev) * 0.05).to(dtype)
            dzq = torch.randn((n, h, w, 4 * f), generator=gen, device=dev).to(torch.bfloat16)
            carry = torch.randn((n, 2 * h, 2 * w, f), generator=gen, device=dev).to(dtype)
            pairs = seam_calls(H, xp, e, dzq, carry, dtype)
            library = library_calls(xp, e, dzq, carry, dtype)
            for name in names:
                kern, plain = pairs[name]
                got, want, lib = kern(), plain(), library[name]()
                torch.cuda.synchronize()
                for who, out in (("kernel", got), ("library", lib)):
                    if out.shape != want.shape or out.dtype != want.dtype:
                        raise RuntimeError(f"{name} {who} {tuple(out.shape)} {out.dtype} vs "
                                           f"{tuple(want.shape)} {want.dtype}")
                rel, abs_err = rel_err(got, want)
                lib_rel, _ = rel_err(lib, want)
                if name in ("dgrad", "wgrad") and not torch.equal(kern(), got):
                    raise RuntimeError(f"{name} is not deterministic at {(n, h, w, c, f)}")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], abs_err)
                line = (f"[parity] {name:9s} {str(dtype)[6:]:8s} N={n} h={h} w={w} C={c} "
                        f"F={f}: rel {rel:.2e} abs {abs_err:.2e}, library rel {lib_rel:.2e}")
                if timed:
                    # the activation-maximization seams' launches are shorter
                    # than the host's cost of one: timed from a CUDA graph
                    small = (n, h, w, c, f) in AM_SEAMS
                    reps = 50 if small else 20 if h <= 64 else 5
                    timer = graph_ms if small else time_ms
                    ms, plain_ms = timer(kern, reps), timer(plain, reps)
                    lib_ms = timer(library[name], reps)
                    bound_ms, by = seam_bound(name, n, h, w, c, f, dtype)
                    line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                             f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})"
                             + (" [graph-timed]" if small else ""))
                    if (n, h, w, c, f) == FLAGSHIP_SEAMS[-1] and dtype == torch.bfloat16:
                        stats[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                           bound_ms=bound_ms, bound_by=by)
                log(line)
                if rel > TOL[dtype] or lib_rel > TOL[dtype]:
                    raise RuntimeError(f"{name} or its library yardstick disagrees with the "
                                       f"plain version: rel {rel:.3e}, {lib_rel:.3e} > "
                                       f"{TOL[dtype]}")
                del got, want, lib
            del xp, e, dzq, carry, pairs, library
    return stats


def fits_library_calls(xp, e, dzq, carry, dtype: torch.dtype, fits: int) -> dict:
    """Each seam kernel's fit-axis form as ONE grouped PyTorch call (groups
    = fits: fit b's channels through fit b's weights), on inputs prepared
    outside any timed region, with a map back to the kernel's layout:
    name -> (call, to the kernel's layout)."""
    g, hp, wp, c = xp.shape
    n, f4 = g // fits, e.shape[-1]
    xr, er, dzr = (t.to(torch.bfloat16).to(dtype) for t in (xp, e, dzq))

    def grouped(t):  # (B*N, H, W, K) -> (N, B*K, H, W)
        return t.reshape(fits, n, *t.shape[1:]).permute(1, 0, 4, 2, 3).reshape(
            n, fits * t.shape[3], t.shape[1], t.shape[2]).contiguous()

    def back(t):  # (N, B*K, H, W) -> (B*N, H, W, K)
        k = t.shape[1] // fits
        return t.reshape(n, fits, k, *t.shape[2:]).permute(1, 0, 3, 4, 2).reshape(
            fits * n, t.shape[2], t.shape[3], k)

    ws = [library_weights(er[b]) for b in range(fits)]
    w_fwd = torch.cat([w for w, _ in ws])
    w_nat = torch.cat([w for _, w in ws])
    xg, dzg, cg = grouped(xr), grouped(dzr), grouped(carry)
    size = (fits * f4, c, 3, 3)
    return {
        "fwd": (lambda: F.pixel_shuffle(F.conv2d(xg, w_fwd, groups=fits), 2), back),
        "fwd_carry": (lambda: F.pixel_shuffle(F.conv2d(xg, w_fwd, groups=fits), 2) + cg, back),
        "dgrad": (lambda: F.conv_transpose2d(dzg, w_nat, groups=fits), back),
        "wgrad": (lambda: torch.nn.grad.conv2d_weight(xg, size, dzg, groups=fits),
                  lambda t: t.reshape(fits, f4, c, 3, 3).permute(0, 3, 4, 2, 1)),
    }


def phase_fit_axis_parity(dev: torch.device) -> dict:
    """The seam kernels' fit axis (BatchEngine's launches) at FIT_SEAMS, in
    bf16 and f32: B fits' xp, e (B,3,3,C,4F), dzq and carry; each fit's
    slice of K1, K1c, K2 and K3 against the plain version of that fit alone
    at TOL, and bitwise equal to the single-fit launch on that fit's own
    tensors (a fit's bits do not depend on B); at B = 1 (e (1,3,3,C,4F)),
    every kernel bitwise equal to today's launch; K2 and K3 launched twice,
    bitwise equal. Graph-timed: the B fits' launch against B x the
    single-fit launch, and the grouped library call (groups = B). Returns
    name -> figures of the B = 2 top seam in bf16 (the kernels line's
    fit-axis rows), with every shape under "shapes"."""
    from dip_tpu_torch.fit.engine import disable_tf32
    from dip_tpu_torch.ops import hopper_up_conv as H

    disable_tf32()
    stats = {k: {"max_abs_err": 0.0, "shapes": []} for k in KERNELS}
    gen = torch.Generator(device=dev).manual_seed(7)
    for dtype in (torch.bfloat16, torch.float32):
        for fits, n, h, w, c, f in FIT_SEAMS:
            g = fits * n
            xp = torch.randn((g, h + 2, w + 2, c), generator=gen, device=dev).to(dtype)
            e = (torch.randn((fits, 3, 3, c, 4 * f), generator=gen, device=dev) * 0.05).to(dtype)
            dzq = torch.randn((g, h, w, 4 * f), generator=gen, device=dev).to(torch.bfloat16)
            carry = torch.randn((g, 2 * h, 2 * w, f), generator=gen, device=dev).to(dtype)
            xs, dzs, cs = xp.chunk(fits), dzq.chunk(fits), carry.chunk(fits)
            batched = seam_calls(H, xp, e, dzq, carry, dtype)
            batched["wgrad"] = (lambda: H.wgrad(xp, dzq, fits), None)
            single = [seam_calls(H, xs[b], e[b], dzs[b], cs[b], dtype) for b in range(fits)]
            one = seam_calls(H, xs[0], e[:1], dzs[0], cs[0], dtype)
            one["wgrad"] = (lambda: H.wgrad(xs[0], dzs[0], 1)[0], None)
            library = fits_library_calls(xp, e, dzq, carry, dtype, fits)
            for name in KERNELS:
                got = batched[name][0]()
                lib_call, lib_back = library[name]
                lib = lib_back(lib_call())
                torch.cuda.synchronize()
                parts = got.chunk(fits) if name != "wgrad" else list(got)
                rel = abs_err = lib_rel = 0.0
                same_bits = True
                lib_parts = lib.chunk(fits) if name != "wgrad" else list(lib)
                for b in range(fits):
                    want = single[b][name][1]()
                    r, a = rel_err(parts[b], want)
                    rel, abs_err = max(rel, r), max(abs_err, a)
                    lib_rel = max(lib_rel, rel_err(lib_parts[b].to(want.dtype), want)[0])
                    same_bits &= torch.equal(parts[b], single[b][name][0]())
                b1_bits = torch.equal(one[name][0](), single[0][name][0]())
                if name in ("dgrad", "wgrad") and not torch.equal(batched[name][0](), got):
                    raise RuntimeError(f"{name} with the fit axis is not deterministic")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], abs_err)
                reps = 20 if h <= 64 else 5
                ms = graph_ms(batched[name][0], reps)
                one_ms = graph_ms(single[0][name][0], reps)
                lib_ms = graph_ms(lib_call, reps)
                plain_ms = graph_ms(lambda: [s[name][1]() for s in single], max(1, reps // 4))
                bound_ms, by = seam_bound(name, g, h, w, c, f, dtype, fits)
                log(f"[parity] {name:9s} {str(dtype)[6:]:8s} fits B={fits} N={n} h={h} w={w} "
                    f"C={c} F={f}: per-fit rel {rel:.2e} abs {abs_err:.2e}, grouped library rel "
                    f"{lib_rel:.2e}; each fit's slice {'bitwise' if same_bits else 'NOT'} the "
                    f"single-fit launch's, B=1 form {'bitwise' if b1_bits else 'NOT'} today's "
                    f"| B fits {ms:.4f} ms against B x one fit {fits * one_ms:.4f} ms "
                    f"({fits} x {one_ms:.4f}), plain {plain_ms:.4f} ms, grouped library "
                    f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}) [graph-timed]")
                fig = dict(fits=fits, shape=[n, h, w, c, f], dtype=str(dtype)[6:], ms=ms,
                           single_fit_ms=one_ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=by)
                stats[name]["shapes"].append(fig)
                if (fits, n, h, w, c, f) == FIT_SEAMS[-1] and dtype == torch.bfloat16:
                    stats[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                       bound_ms=bound_ms, bound_by=by)
                if rel > TOL[dtype] or lib_rel > TOL[dtype]:
                    raise RuntimeError(f"{name} with the fit axis disagrees with the plain "
                                       f"version: rel {rel:.3e}, library {lib_rel:.3e}")
                if not (same_bits and b1_bits):
                    raise RuntimeError(f"{name}: a fit's bits depend on the batch")
                del got, lib, parts, lib_parts
            del xp, e, dzq, carry, batched, single, one, library
    return stats


def down_bound(shape, ksize: int, h_out: int, w_out: int) -> tuple[float, str]:
    """The downsample's bound at x (N,H,W,C): an H pass of K f32 FMA over
    every input column of each output row, then a W pass of K, against x
    read and the output written once."""
    n, _, w_in, c = shape
    ops = 2.0 * ksize * n * h_out * c * (w_in + w_out)
    return bound(ops, "f32", 4 * (int(np.prod(shape)) + n * h_out * w_out * c))


def down_calls(HR, R, case, gen, dev) -> tuple:
    """(kernel, plain version, K, h_out, w_out) of one DOWN_CASES entry on
    seeded inputs, through the downsample module `HR` (ops/hopper_resample
    of some checkout)."""
    shape, factor, ktype, phase, preserve, width = case
    x = torch.rand(shape, generator=gen, device=dev)
    spec = R._spec(factor, ktype, phase, width, None, None)
    pad, h_out, w_out = R._geometry(x.shape, spec, preserve)
    taps = R.device_const(R._profile, spec, torch.float32, dev)

    def kern():
        return HR.downsample_fused(x, taps, factor, pad, h_out, w_out)

    def plain():
        return R.downsample_plain(x, factor, ktype, phase, preserve, width)

    return kern, plain, taps.shape[0], h_out, w_out


def phase_downsample_parity(dev: torch.device) -> dict:
    """The downsample kernel against downsample_plain on the card; its
    times (the kernel's and the plain version's from a CUDA graph of
    launches, and the caller's pace) and bounds at DOWN_TIMED ("shapes";
    SR x4's also as the row's own figures)."""
    from dip_tpu_torch.ops import hopper_resample as HR
    from dip_tpu_torch.ops import resample as R

    stats = {"max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": []}
    gen = torch.Generator(device=dev).manual_seed(1)
    for case in DOWN_CASES:
        shape, factor, ktype, phase, preserve, _ = case
        kern, plain, ksize, h_out, w_out = down_calls(HR, R, case, gen, dev)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.shape != (shape[0], h_out, w_out, shape[3]):
            raise RuntimeError(f"downsample {tuple(got.shape)} vs {tuple(want.shape)}")
        rel, abs_err = rel_err(got, want)
        # a launch is shorter than the host's cost of one: device time from
        # a graph of launches, beside the caller's pace
        ms, plain_ms = graph_ms(kern, 100), graph_ms(plain, 20)
        caller_ms = time_ms(kern, 50)
        stats["max_abs_err"] = max(stats["max_abs_err"], abs_err)
        stats["max_rel_err"] = max(stats["max_rel_err"], rel)
        plan = HR.tile_plan(ksize, factor, shape[0], shape[3], h_out, w_out)
        line = (f"[parity] downsample {tuple(shape)} x{factor} {ktype} phase {phase} "
                f"preserve {preserve} -> {tuple(got.shape)} K={ksize}: tiles "
                f"{plan.tile_h}x{plan.tile_w}, {plan.cg} channels, {plan.blocks} blocks, "
                f"{plan.smem} B shared: rel {rel:.2e} abs {abs_err:.2e} | kernel {ms:.5f} ms "
                f"(caller {caller_ms:.4f} ms), plain {plain_ms:.4f} ms")
        if case in DOWN_TIMED:
            bound_ms, by = down_bound(shape, ksize, h_out, w_out)
            line += f", bound {bound_ms:.5f} ms ({by})"
            stats["shapes"].append({"shape": list(shape), "factor": factor, "ms": ms,
                                    "caller_ms": caller_ms, "plain_ms": plain_ms,
                                    "bound_ms": bound_ms, "bound_by": by})
            if case == DOWN_TIMED[0]:
                # no one PyTorch call: a strided conv needs the replication pad first
                stats.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                             bound_by=by)
        log(line)
        if rel > DOWN_TOL:
            raise RuntimeError(f"downsample disagrees with its plain version: "
                               f"rel {rel:.3e} > {DOWN_TOL}")
        del got, want
    return stats


def phase_downsample_rows_parity(dev: torch.device) -> dict:
    """The downsample kernel's row form (row pad 0, column pad p) against
    downsample_plain with the same pads, at DOWN_ROWS and DOWN_TOL; the
    first case timed (kernel and plain version from a CUDA graph of
    launches) with its bound, as the kernels line's row-form figures."""
    from dip_tpu_torch.ops import hopper_resample as HR
    from dip_tpu_torch.ops import resample as R

    stats = {"max_abs_err": 0.0}
    gen = torch.Generator(device=dev).manual_seed(2)
    for shape, ktype in DOWN_ROWS:
        x = torch.rand(shape, generator=gen, device=dev)
        spec = R._spec(2, ktype, 0.5, None, None, None)
        p = R._geometry(shape, spec, True)[0]
        h_out, w_out = R._out_size(shape, spec, (0, p))
        taps = R.device_const(R._profile, spec, torch.float32, dev)

        def kern():
            return HR.downsample_fused(x, taps, 2, (0, p), h_out, w_out)

        def plain():
            return R.downsample_plain(x, 2, ktype, 0.5, pads=(0, p))

        got, want = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.shape != (shape[0], h_out, w_out, shape[3]):
            raise RuntimeError(f"downsample rows {tuple(got.shape)} vs {tuple(want.shape)}")
        rel, abs_err = rel_err(got, want)
        stats["max_abs_err"] = max(stats["max_abs_err"], abs_err)
        line = (f"[parity] downsample row form {tuple(shape)} x2 {ktype} pads (0, {p}) -> "
                f"{tuple(got.shape)}: rel {rel:.2e} abs {abs_err:.2e}")
        if (shape, ktype) == DOWN_ROWS[0]:
            ms, plain_ms = graph_ms(kern, 100), graph_ms(plain, 20)
            bound_ms, by = down_bound(shape, taps.shape[0], h_out, w_out)
            stats.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                         bound_by=by, shape=list(shape))
            line += (f" | kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} "
                     f"ms ({by})")
        log(line)
        if rel > DOWN_TOL:
            raise RuntimeError(f"the downsample's row form disagrees with its plain version: "
                               f"rel {rel:.3e} > {DOWN_TOL}")
        del x, got, want
    return stats


def _layout(shape, layout: str, gen, dev, dtype) -> torch.Tensor:
    """A random NHWC tensor, contiguous, or channel-planar (the NHWC view
    of an NCHW-contiguous tensor)."""
    n, h, w, c = shape
    if layout == "planar":
        return torch.randn((n, c, h, w), generator=gen, device=dev).to(dtype).permute(0, 2, 3, 1)
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def phase_s2d_parity(dev: torch.device) -> dict:
    """The s2d pack against s2d_pack_plain, bitwise: the 'kate' seam
    cotangents f32 -> bf16 and bf16 -> bf16, NHWC and channel-planar (the
    layout the add after a seam hands back), and ragged channel counts."""
    from dip_tpu_torch.ops import hopper_s2d as S

    stats = {"max_abs_err": 0.0}
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [(shape, d, "nhwc") for shape in KATE_DZ + S2D_RAGGED + AM_DZ
             for d in (torch.float32, torch.bfloat16)]
    cases += [(KATE_DZ[-1], d, "planar") for d in (torch.float32, torch.bfloat16)]
    cases += [(S2D_RAGGED[0], torch.bfloat16, "planar")]
    for shape, dtype, layout in cases:
        dz = _layout(shape, layout, gen, dev, dtype)
        got, want = S.s2d_pack(dz, torch.bfloat16), S.s2d_pack_plain(dz, torch.bfloat16)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not got.is_contiguous():
            raise RuntimeError(f"s2d_pack {tuple(got.shape)} {got.dtype} vs "
                               f"{tuple(want.shape)} {want.dtype}")
        _, abs_err = rel_err(got, want)
        line = (f"[parity] s2d_pack {str(dtype)[6:]:8s}->bf16 {layout:6s} {tuple(shape)}: "
                f"abs {abs_err:.2e}")
        if shape[1] >= 256 or shape in AM_DZ:
            small = shape in AM_DZ  # timed from a CUDA graph, as the AM seams
            reps = 50 if small else 20 if shape[1] <= 256 else 10
            timer = graph_ms if small else time_ms
            ms = timer(lambda: S.s2d_pack(dz, torch.bfloat16), reps)
            plain_ms = timer(lambda: S.s2d_pack_plain(dz, torch.bfloat16), reps)
            line += f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            if small:
                b_ms, b_by = bound(0.0, "bf16", (dz.element_size() + 2) * dz.numel())
                line += f", bound {b_ms:.5f} ms ({b_by}) [graph-timed]"
            if shape == KATE_DZ[-1] and dtype == torch.bfloat16 and layout == "nhwc":
                # a pure permutation: bytes only. pixel_unshuffle orders the
                # channels (c, p, q), not (p, q, c), so no one call computes it
                bound_ms, by = bound(0.0, "bf16", 2 * dz.numel() * 2)
                stats.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                             bound_by=by)
        log(line)
        if not torch.equal(got, want):
            raise RuntimeError(f"s2d_pack is not bitwise its plain version ({abs_err:.3e})")
        stats["max_abs_err"] = max(stats["max_abs_err"], abs_err)
    return stats


def zoo_wgrad_calls(dev: torch.device) -> list[tuple]:
    """Every distinct weight-gradient kernel call of one step of the [zoo]
    fits (inpainting 'library' UNet and ResNet at 512^2, bf16 and f32,
    conv_wgrad='all'), recorded by taking that step with the two wrappers
    wrapped: (kernel, dtype, halo, x shape, x strides, g shape, g strides),
    in the order of first call. The calls also launch the kernels; no
    launch count is read across this."""
    from dip_tpu_torch.ops import hopper_wgrad as W

    seen: dict[tuple, None] = {}
    orig = W.wgrad3x3_s1, W.wgrad1x1

    def record(name, fn):
        def call(x, g, *halo):
            seen[(name, x.dtype, halo[0] if halo else 0, tuple(x.shape), x.stride(),
                  tuple(g.shape), g.stride())] = None
            return fn(x, g, *halo)
        return call

    W.wgrad3x3_s1, W.wgrad1x1 = record("wgrad3x3_s1", orig[0]), record("wgrad1x1", orig[1])
    try:
        for net_type in ZOO_NETS:
            for cd in ("bfloat16", None):
                spec = _masked_spec("inpaint", "library", cd, "all", net_type=net_type)
                engine, state, aux = _fit_parts(spec, dev)
                engine.step(state, aux)
                del engine, state, aux
    finally:
        W.wgrad3x3_s1, W.wgrad1x1 = orig
    return list(seen)


def _operand(shape, layout, gen, dev, dtype) -> torch.Tensor:
    """A random NHWC tensor: contiguous ('nhwc'), channel-planar ('planar',
    the NHWC view of an NCHW-contiguous tensor) or laid out with the
    strides `layout` gives."""
    if isinstance(layout, str):
        return _layout(shape, layout, gen, dev, dtype)
    t = torch.empty_strided(shape, layout, device=dev, dtype=dtype)
    return t.copy_(torch.randn(shape, generator=gen, device=dev))


def _layout_name(shape, layout) -> str:
    """'nhwc', 'planar', or the strides where they are neither."""
    if isinstance(layout, str):
        return layout
    n, h, w, c = shape
    named = {(h * w * c, w * c, c, 1): "nhwc", (c * h * w, w, 1, h * w): "planar"}
    return named.get(tuple(layout), f"strides {tuple(layout)}")


def phase_wgrad_parity(dev: torch.device) -> dict:
    """The 3x3 and 1x1 weight-gradient kernels against their plain
    versions, with times beside the plain version's and cuDNN's own weight
    gradient (what the kernel replaces on the path; TF32 off): at
    WGRAD_CASES in both dtypes, then at every call of a [zoo] step
    (zoo_wgrad_calls: the shapes, strides and dtypes that path gives the
    kernels). The bf16 kernel takes NHWC-dense operands: its timed lines
    also give the time of the copies that make them (part of its own
    time). Returns each kernel's figures at the top 'kate' shape, NHWC:
    bf16 as the row's own, f32 under "f32"."""
    from dip_tpu_torch.ops import hopper_wgrad as W

    stats = {k: {"max_abs_err": 0.0} for k in WGRAD}
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [(name, dtype, halo, xs, layout, gs, layout, False)
             for dtype in (torch.bfloat16, torch.float32)
             for name, halo, xs, gs, layout in WGRAD_CASES]
    zoo = zoo_wgrad_calls(dev)
    log(f"[parity] a [zoo] step's weight-gradient calls: {len(zoo)} distinct")
    cases += [(*call, True) for call in zoo]
    for name, dtype, halo, xs, x_layout, gs, g_layout, on_zoo in cases:
        x = _operand(xs, x_layout, gen, dev, dtype)
        g = _operand(gs, g_layout, gen, dev, dtype)
        label = (f"zoo x {_layout_name(xs, x_layout)}, g {_layout_name(gs, g_layout)}"
                 if on_zoo else x_layout)
        _hold_wgrad(W, name, halo, x, g, dtype, label, stats,
                    top=not on_zoo and x_layout == "nhwc")
        del x, g
    return stats


def _hold_wgrad(W, name: str, halo: int, x: torch.Tensor, g: torch.Tensor,
                dtype: torch.dtype, label: str, stats: dict, top: bool) -> None:
    """One case of phase_wgrad_parity: the kernel against its plain version
    at WGRAD_TOL, and deterministic; timed from 256^2, and its figures
    kept in `stats` at the top 'kate' shape if `top` (an NHWC case)."""
    xs, gs = tuple(x.shape), tuple(g.shape)
    ks = 3 if name == "wgrad3x3_s1" else 1
    if ks == 3:
        kern = lambda: W.wgrad3x3_s1(x, g, halo)  # noqa: E731
        plain = lambda: W.wgrad3x3_s1_plain(x, g, halo)  # noqa: E731
        copies = lambda: W._k5_operands(x, g, halo)  # noqa: E731
    else:
        kern = lambda: W.wgrad1x1(x, g)  # noqa: E731
        plain = lambda: W.wgrad1x1_plain(x, g)  # noqa: E731
        copies = lambda: (W._pad8(x), W._pad8(g))  # noqa: E731
    w_size = (gs[3], xs[3], ks, ks)

    def cudnn():
        return torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), w_size,
                                           g.permute(0, 3, 1, 2), 1, halo)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float32:
        raise RuntimeError(f"{name} {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)}")
    rel, abs_err = rel_err(got, want)
    again = kern()
    if not torch.equal(again, got):
        raise RuntimeError(f"{name} is not deterministic")
    stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], abs_err)
    line = (f"[parity] {name:11s} {str(dtype)[6:]:8s} halo {halo} {label:6s} x {xs} "
            f"g {gs}: rel {rel:.2e} abs {abs_err:.2e}")
    if xs[1] >= 256:
        reps = 5 if xs[1] >= 512 else 10
        ms, plain_ms, dnn_ms = time_ms(kern, reps), time_ms(plain, reps), time_ms(cudnn, reps)
        line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                 f"cudnn {dnn_ms:.4f} ms")
        if dtype == torch.bfloat16:
            line += f", of which the operands' layout copies {time_ms(copies, reps):.4f} ms"
        if top and (xs[1], xs[3], gs[3]) == (514 if ks == 3 else 512, 128, 128):
            bound_ms, by = wgrad_bound(ks, xs, gs, dtype)
            fig = dict(ms=ms, plain_ms=plain_ms, library_ms=dnn_ms, bound_ms=bound_ms,
                       bound_by=by)
            if dtype == torch.bfloat16:
                stats[name].update(fig)
            else:
                stats[name]["f32"] = fig
    log(line)
    if rel > WGRAD_TOL[dtype]:
        raise RuntimeError(f"{name} disagrees with its plain version: "
                           f"rel {rel:.3e} > {WGRAD_TOL[dtype]}")


def phase_wgrad_fit_axis_parity(dev: torch.device) -> dict:
    """K5 and K6 with the fit axis (BatchEngine's conv_wgrad launches) at
    WGRAD_FIT_CASES, BATCH_FITS fits, in bf16 and f32: one launch for the
    fits, each fit's dW against its plain version at WGRAD_TOL and bitwise
    the single-fit launch on that fit's own slice; deterministic. Timed:
    the fits' launch against BATCH_FITS x the single-fit launch, the plain
    version per fit, and one grouped cuDNN weight gradient (groups =
    BATCH_FITS). Returns each kernel's figures: bf16 as the row's own, f32
    under "f32"."""
    from dip_tpu_torch.ops import hopper_wgrad as W

    stats = {k: {"max_abs_err": 0.0} for k in WGRAD}
    gen = torch.Generator(device=dev).manual_seed(9)
    b = BATCH_FITS
    for dtype in (torch.bfloat16, torch.float32):
        for name, halo, xs, gs in WGRAD_FIT_CASES:
            ks = 3 if name == "wgrad3x3_s1" else 1
            x = torch.randn((b, *xs), generator=gen, device=dev).to(dtype)
            g = torch.randn((b, *gs), generator=gen, device=dev).to(dtype)
            args = (halo,) if ks == 3 else ()
            kern = lambda: getattr(W, name)(x, g, *args, b)  # noqa: E731
            one = lambda: getattr(W, name)(x[:1], g[:1], *args)  # noqa: E731
            plain = getattr(W, f"{name}_plain")
            plain_all = lambda: plain(x, g, *args, b)  # noqa: E731
            w_size = (b * gs[2], xs[2], ks, ks)
            xg = x.permute(1, 2, 0, 3).reshape(1, *xs[:2], b * xs[2]).permute(0, 3, 1, 2)
            gg = g.permute(1, 2, 0, 3).reshape(1, *gs[:2], b * gs[2]).permute(0, 3, 1, 2)

            def grouped():
                return torch.nn.grad.conv2d_weight(xg, w_size, gg, 1, halo, groups=b)

            before = W.LAUNCHES[name]
            got = kern()
            launches = W.LAUNCHES[name] - before
            want = plain_all()
            torch.cuda.synchronize()
            rel, abs_err = rel_err(got, want)
            same = all(torch.equal(got[i], getattr(W, name)(x[i:i + 1], g[i:i + 1], *args))
                       for i in range(b))
            if not torch.equal(kern(), got):
                raise RuntimeError(f"{name} with the fit axis is not deterministic")
            lib_rel = rel_err(grouped().reshape(b, gs[2], xs[2], ks, ks).permute(0, 3, 4, 2, 1),
                              want)[0]
            ms, one_ms = time_ms(kern, 5), time_ms(one, 5)
            plain_ms, lib_ms = time_ms(plain_all, 2), time_ms(grouped, 5)
            bound_ms, by = wgrad_bound(ks, (b, *xs), (b, *gs), dtype)
            log(f"[parity] {name:11s} {str(dtype)[6:]:8s} fits B={b} halo {halo} x {xs} g {gs} "
                f"a fit: rel {rel:.2e} abs {abs_err:.2e}, grouped cudnn rel {lib_rel:.2e}; "
                f"{launches} launch(es); "
                f"each fit's dW {'bitwise' if same else 'NOT'} the single-fit launch's | B "
                f"fits {ms:.4f} ms against B x one fit {b * one_ms:.4f} ms ({b} x "
                f"{one_ms:.4f}), plain {plain_ms:.4f} ms, grouped cudnn {lib_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({by})")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], abs_err)
            fig = dict(fits=b, ms=ms, single_fit_ms=one_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms, bound_by=by)
            if dtype == torch.bfloat16:
                stats[name].update(fig)
            else:
                stats[name]["f32"] = fig
            if rel > WGRAD_TOL[dtype]:
                raise RuntimeError(f"{name} with the fit axis disagrees with its plain "
                                   f"version: rel {rel:.3e}")
            if not same:
                raise RuntimeError(f"{name}: a fit's bits depend on the batch")
            if launches != 1:
                raise RuntimeError(f"{name} {dtype}: {launches} launches for {b} fits, not one")
            del x, g, xg, gg, got, want
    return stats


def phase_small_reference(dev: torch.device) -> None:
    """2-scale 128-channel skip nets at 32^2 (decoder seams at LR 8 and
    16): forward and all gradients on the card vs the CPU, same weights.
    The flagship's shape (4-channel skips, bilinear) under an MSE at full
    resolution, and under the SR loss (x4 downsample, then an MSE at LR
    8^2) with the seam's carry-in off and on, which holds the downsample
    kernel's adjoint and the carry's backward on the card; then the
    inpainting 'kate' shape (128-channel skips, nearest) with every
    weight gradient from the kernels, under the masked MSE."""
    from dip_tpu_torch.models import Skip
    from dip_tpu_torch.ops.losses import masked_mse
    from dip_tpu_torch.ops.resample import downsample

    flagship = dict(num_channels_skip=[4] * 2, upsample_mode="bilinear")
    kate = dict(num_channels_skip=[128] * 2, upsample_mode="nearest", conv_wgrad="all")
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.normal(size=(1, 32, 32, 8)).astype(np.float32)) * 0.1
    tgt = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32))
    tgt_lr = torch.from_numpy(rng.random((1, 8, 8, 3)).astype(np.float32))
    mask = torch.from_numpy((rng.random((1, 32, 32, 3)) > 0.3).astype(np.float32))

    def sr_loss(out, d):
        return torch.mean((downsample(out, 4, "lanczos2", 0.5, True) - tgt_lr.to(d)) ** 2)

    cases = (("mse at 32^2", flagship, False, lambda out, d: torch.mean((out - tgt.to(d)) ** 2)),
             ("sr x4 lanczos2, mse at 8^2", flagship, False, sr_loss),
             ("sr x4 lanczos2, mse at 8^2, seam carry", flagship, True, sr_loss),
             ("128-ch skips, nearest, conv_wgrad=all, masked mse", kate, False,
              lambda out, d: masked_mse(out, tgt.to(d), mask.to(d))))
    for what, cfg, carry, loss_of in cases:
        cpu, gpu = (Skip(num_input_channels=8, num_channels_down=[128] * 2,
                         num_channels_up=[128] * 2, pad="reflection", seam_carry=carry, **cfg)
                    for _ in range(2))
        cpu.reset_parameters(torch.Generator().manual_seed(3))
        gpu.load_state_dict(cpu.state_dict())
        gpu.to(dev)
        outs, grads = [], []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            out = model(z.to(d))
            loss = loss_of(out, d)
            grads.append([g.cpu() for g in torch.autograd.grad(loss, list(model.parameters()))])
            outs.append(out.detach().cpu())
        torch.cuda.synchronize()
        _, out_abs = rel_err(outs[1], outs[0])
        # each gradient's error against the largest gradient of the net: the
        # scale of a BN that feeds another BN has a gradient that is rounding
        # noise (exactly zero in exact arithmetic), so its own max is no norm
        g_max = max(g.abs().max().item() for g in grads[0])
        worst = max((g1 - g0).abs().max().item() for g0, g1 in zip(*grads)) / g_max
        log(f"[small] skip 2x128 @32^2, {what}: cuda vs cpu: out max abs {out_abs:.2e}, "
            f"grads max err / max grad {worst:.2e}")
        if out_abs > 2e-3 or worst > 2e-2:
            raise RuntimeError(f"small-input forward/gradients disagree with the CPU ({what})")


def zoo_small_nets() -> dict:
    """The zoo's nets at small sizes, every weight gradient from the
    kernels where the net has a stride-1 3x3 or 1x1 conv: name ->
    (model, input shape)."""
    from dip_tpu_torch.models import DCGAN, ResNet, TextureNet, UNet

    return {
        "unet deconv": (UNet(1, feature_scale=8, more_layers=1, upsample_mode="deconv",
                             norm_kind="instance", conv_wgrad="all"), (1, 64, 64, 1)),
        "unet bilinear": (UNet(3, feature_scale=16, upsample_mode="bilinear", concat_x=True,
                               norm_kind="batch", conv_wgrad="all"), (1, 32, 32, 3)),
        "resnet": (ResNet(1, num_blocks=8, num_channels=32, conv_wgrad="all"), (1, 32, 32, 1)),
        "texture_nets": (TextureNet(3, ratios=(8, 4, 2, 1), conv_wgrad="all"), (1, 32, 32, 3)),
        "dcgan convT": (DCGAN(2, ndf=32, num_ups=5), (1, 8, 8, 2)),
        "dcgan upsample": (DCGAN(2, ndf=32, num_ups=5, need_convT=False, conv_wgrad="all"),
                           (1, 8, 8, 2)),
    }


def phase_zoo_small_reference(dev: torch.device, names: list[str] | None = None) -> None:
    """The zoo's nets (zoo_small_nets, or those of `names`): forward and
    every gradient on the card against the same net on the CPU, same
    weights and input, under an MSE, TF32 off; the tolerances of
    phase_small_reference."""
    from dip_tpu_torch.fit.engine import disable_tf32

    disable_tf32()
    for name, (cpu, shape) in zoo_small_nets().items():
        if names is not None and name not in names:
            continue
        cpu.reset_parameters(torch.Generator().manual_seed(4))
        gpu = copy.deepcopy(cpu).to(dev)
        z = torch.from_numpy(np.random.default_rng(4).normal(size=shape).astype(np.float32))
        with torch.no_grad():
            tgt = torch.rand(cpu(z).shape, generator=torch.Generator().manual_seed(5))
        outs, grads = [], []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            out = model(z.to(d))
            loss = torch.mean((out - tgt.to(d)) ** 2)
            grads.append([g.cpu() for g in torch.autograd.grad(loss, list(model.parameters()))])
            outs.append(out.detach().cpu())
        torch.cuda.synchronize()
        _, out_abs = rel_err(outs[1], outs[0])
        g_max = max(g.abs().max().item() for g in grads[0])
        worst = max((g1 - g0).abs().max().item() for g0, g1 in zip(*grads)) / g_max
        log(f"[small] {name} {tuple(shape)} conv_wgrad={cpu.conv_wgrad}: cuda vs cpu: out max "
            f"abs {out_abs:.2e}, grads max err / max grad {worst:.2e}")
        if out_abs > 2e-3 or worst > 2e-2:
            raise RuntimeError(f"small-input forward/gradients disagree with the CPU ({name})")


def reset_counts() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    from dip_tpu_torch.ops import launches

    launches.reset()


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by kernel."""
    from dip_tpu_torch.ops import launches

    return launches.counts()


def wgrad_per_step(model) -> tuple[int, int]:
    """(3x3, 1x1) weight-gradient kernel launches per training step: the
    routing of models/blocks._conv2d over the model's own Convs, one launch
    for each stride-1 3x3 Conv (a stride-2 one with a post-down runs at
    stride 1) and each 1x1 Conv that a step runs on a conv part, under the
    model's conv_wgrad. Every Conv of the zoo's nets runs once a step on one
    tensor. A Skip whose every decoder scale takes the fused seam (true of
    the fits here) runs a decoder conv's conv part only on its skip branch,
    so a scale without a skip launches no kernel for that conv."""
    from dip_tpu_torch.models import Skip
    from dip_tpu_torch.models.blocks import Conv

    mode = getattr(model, "conv_wgrad", "off")  # the identity net has no conv
    if mode == "off":
        return 0, 0
    convs = [m for m in model.modules() if isinstance(m, Conv)]
    if isinstance(model, Skip):
        if any(k != 3 for k in model.k_up) or any(m not in ("nearest", "bilinear")
                                                   for m in model.up_modes):
            raise ValueError("the count assumes a fused seam at every decoder scale")
        n = len(model.ch_skip)
        # the decoder convs in creation order (models/skip.py): after the
        # encoder's convs (2 a scale, 3 with a skip), each scale's k_up conv
        # and, with need1x1_up, its 1x1
        first = sum(3 if c else 2 for c in model.ch_skip)
        step = 2 if model.need1x1_up else 1
        seam_only = {id(convs[first + step * j]) for j, i in enumerate(reversed(range(n)))
                     if not model.ch_skip[i]}
        convs = [c for c in convs if id(c) not in seam_only]
    runs = [c.kernel_size for c in convs if c.stride == 1 or c.post_down]
    return (runs.count(3) if mode in ("3x3", "all") else 0,
            runs.count(1) if mode in ("1x1", "all") else 0)


def input_size(spec) -> tuple[int, int]:
    """The (h, w) of the fit's z."""
    return tuple(spec.spatial_size or spec.net_input.shape[1:3])


def output_size(spec) -> tuple[int, int]:
    """The (h, w) of the fit's render: z's, but for DCGAN's (h + 2) * 2 at
    each of its 2x stages."""
    from dip_tpu_torch.models import DCGAN

    h, w = input_size(spec)
    if isinstance(spec.model, DCGAN):
        up = 2 ** len(spec.model.ups)
        return (h + 2) * up, (w + 2) * up
    return h, w


def fused_scales(model, size: tuple[int, int]) -> list[bool]:
    """Which decoder scales of a Skip take the fused seam on an input of
    `size`, scale 0 first, decided as Skip.forward decides: up_conv on,
    can_fuse_up2 of the scale's up mode, kernel, padding and LR size, and a
    skip part (if the scale has one) of twice that size. The sizes come
    from the encoder: a stride-2 conv of kernel k and padding (k-1)//2
    gives (h + 2*((k-1)//2) - k)//2 + 1; with an 'avg' or 'max' post-down
    the conv keeps h and the pool gives h//2. A scale that does not fuse
    upsamples, and crops to its skip."""
    from dip_tpu_torch.models.blocks import POST_DOWN
    from dip_tpu_torch.ops.up_conv import can_fuse_up2

    n = len(model.ch_skip)
    if not model.up_conv:
        return [False] * n
    h, w = size
    skip_sizes = []
    for i in range(n):
        skip_sizes.append((h, w))
        k, mode = model.k_down[i], model.down_modes[i]
        if mode == "stride":
            p = (k - 1) // 2
            h, w = (h + 2 * p - k) // 2 + 1, (w + 2 * p - k) // 2 + 1
        elif mode in POST_DOWN:  # the pools, and the Lanczos post-down's preserve-size pad
            h, w = h // 2, w // 2
        else:
            raise ValueError(f"the count does not follow downsample_mode {mode!r}")
    fused = [False] * n
    for i in reversed(range(n)):
        up = (2 * h, 2 * w)
        skip = skip_sizes[i] if model.ch_skip[i] else None
        fused[i] = (can_fuse_up2(model.up_modes[i], model.k_up[i], 1, model.pad, h, w)
                    and (skip is None or (model.fuse_concat and skip == up)))
        h, w = up if skip is None else (min(up[0], skip[0]), min(up[1], skip[1]))
    return fused


def post_downs(model) -> int:
    """The Lanczos post-downs of a forward: each a downsample launch."""
    from dip_tpu_torch.models.blocks import Conv

    return sum(1 for m in model.modules()
               if isinstance(m, Conv) and m.post_down in ("lanczos2", "lanczos3"))


def path_launches(spec, steps: int, downsample_per_step: int = 0) -> dict:
    """What a `steps`-step fit of `spec` and its render launch: each fused
    seam of a Skip (fused_scales) runs fwd (or fwd_carry where a skip
    branch hands it its carry), the s2d pack of dz, dgrad and wgrad a
    step, and fwd once more in the render (the zoo's other nets have no
    seam); the weight-gradient kernels as wgrad_per_step says; the
    downsample `downsample_per_step` times a step (an SR loss's) and once
    at each Lanczos post-down of every forward, the render's included."""
    from dip_tpu_torch.models import Skip

    model = spec.model
    fused = fused_scales(model, input_size(spec)) if isinstance(model, Skip) else []
    n_seams = sum(fused)
    carried = sum(1 for i, f in enumerate(fused) if f and model.ch_skip[i] and model.seam_carry)
    k3, k1 = wgrad_per_step(model)
    return {"fwd": (steps + 1) * (n_seams - carried), "fwd_carry": (steps + 1) * carried,
            "dgrad": steps * n_seams, "wgrad": steps * n_seams, "downsample":
            downsample_per_step * steps + post_downs(model) * (steps + 1),
            "s2d_pack": steps * n_seams,
            "wgrad3x3_s1": k3 * steps, "wgrad1x1": k1 * steps}


def run_fit(spec, dev: torch.device, card: str, prefix: str, tag: str, want: dict,
            rising: str | None) -> tuple[dict, float]:
    """One fit through run_task (on the card: one eager step, then replays
    of its CUDA graph), with every launch counter set to 0 just before it
    and read just after: its it/s (steps 11-30), loss, metrics and
    launches. Raises unless the loss is finite and falls, `rising` (a
    metric) rises, the render is finite and of the image's shape, and the
    launch counts equal `want`. Returns (launches, it/s)."""
    from dip_tpu_torch.fit.engine import tf32_flags
    from dip_tpu_torch.tasks.base import run_task

    marks: list[tuple[int, float]] = []
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    out, _, hist = run_task(spec, 0, device=dev,
                            callback=lambda it, h, s: marks.append((it, time.perf_counter())))
    delta = launch_counts()
    out = out.cpu()
    (i0, t0), (i1, t1) = marks[0], marks[-1]
    ips = (i1 - i0) / (t1 - t0)
    loss = hist["loss"]
    metrics = " | ".join(f"{k} {v[0]:.2f} -> {v[-1]:.2f} dB" for k, v in hist.items()
                         if k.startswith("psnr"))
    log(f"[{prefix}] {tag}: {ips:.2f} it/s, {1e3 / ips:.2f} ms/step (steps {i0 + 1}-{i1}) "
        f"| loss {loss[0]:.9g} -> {loss[-1]:.9g} | {metrics} | backtracked "
        f"{int(hist['backtracked'].sum()) if 'backtracked' in hist else '-'} | peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB | launches {delta} "
        f"| {tf32_flags()} | card {card}")
    if delta != want:
        raise RuntimeError(f"launch counts {delta} != {want}")
    if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
        raise RuntimeError(f"loss not finite and falling: {loss}")
    if rising is not None and not hist[rising][-1] > hist[rising][0]:
        raise RuntimeError(f"{rising} not rising: {hist[rising]}")
    want_shape = (1, *output_size(spec), spec.model.num_output_channels)
    if spec.postprocess is not None:  # e.g. the classifier's crop of FI / AM
        want_shape = tuple(spec.postprocess(torch.zeros(want_shape)).shape)
    if tuple(out.shape) != want_shape or not torch.isfinite(out).all():
        raise RuntimeError(f"bad output {tuple(out.shape)}, expected {want_shape}")
    return delta, ips


def _flagship_spec(cd: str | None, steps: int = MAIN_STEPS, log_every: int = 10,
                   size: int = 512):
    """The flagship denoising spec ('f16' at size^2, 512 by default) in
    compute dtype `cd`."""
    from dip_tpu_torch.bench import synthetic_noisy
    from dip_tpu_torch.tasks import denoise

    clean, noisy = synthetic_noisy(size)
    spec = denoise.task(noisy, "f16", gt=clean, num_iter=steps)
    return dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, compute_dtype=cd, log_every=log_every))


def phase_main_path(dev: torch.device, card: str) -> tuple[dict, float]:
    """The flagship fit in bf16 and f32; returns the launches of both and
    the bf16 fit's it/s."""
    total: dict = {}
    for cd in ("bfloat16", None):
        spec = _flagship_spec(cd)
        delta, ips = run_fit(spec, dev, card, "main", cd or "float32",
                             path_launches(spec, MAIN_STEPS), None)
        total = {k: total.get(k, 0) + v for k, v in delta.items()}
        if cd is not None:
            bf16_ips = ips
    return total, bf16_ips


def synthetic_sr(factor: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """(HR, LR): a (1, 384, 576, 3) smooth image with texture, made with
    numpy, and its factor x factor block mean. The recipe's LR comes from
    PIL's Lanczos resize, which the CPU tests cover; Pillow is not needed
    here."""
    h, w = SR_HR
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    hr = np.stack([np.sin(xx / 19) * np.cos(yy / 31) * 0.5 + 0.5,
                   np.cos((xx + yy) / 13) * 0.4 + 0.5,
                   (np.sin(xx / 5) * np.sin(yy / 7) * 0.2 + (xx + yy) / (h + w) * 0.6)],
                  axis=-1)
    hr = np.clip(hr + np.random.default_rng(0).random(hr.shape) * 0.05, 0, 1)
    lr = hr.reshape(h // factor, factor, w // factor, factor, 3).mean((1, 3))
    return hr[None].astype(np.float32), lr[None].astype(np.float32)


def _sr_spec(cd: str | None, carry: bool, factor: int = 4):
    from dip_tpu_torch.tasks import super_resolve

    hr, lr = synthetic_sr(factor)
    spec = super_resolve.task(lr, factor=factor, hr_gt=hr, num_iter=MAIN_STEPS)
    spec.model.seam_carry = carry
    return dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, compute_dtype=cd, log_every=10))


def phase_sr_path(dev: torch.device, card: str) -> dict:
    """The SR fit (HR 384x576, Skip 5x128) through run_task: x4 in bf16, in
    f32 and in bf16 with the seam's carry-in, and x8 (LR 48x72) in bf16:
    falling loss, rising psnr_lr, and the launch counts the code implies
    (one downsample in the loss and one in the metrics a step; its backward
    is PyTorch)."""
    log("[sr] LR observation: a factor x factor block mean of a synthetic HR image made "
        "with numpy (the recipe's PIL Lanczos LR is covered by the CPU tests)")
    total: dict = {}
    for cd, carry, factor in (("bfloat16", False, 4), (None, False, 4), ("bfloat16", True, 4),
                              ("bfloat16", False, 8)):
        spec = _sr_spec(cd, carry, factor)
        tag = f"x{factor} {cd or 'float32'}" + (" carry" if carry else "")
        delta, _ = run_fit(spec, dev, card, "sr", tag,
                           path_launches(spec, MAIN_STEPS, downsample_per_step=2),
                           "psnr_lr")
        total = {k: total.get(k, 0) + v for k, v in delta.items()}
    return total


def _masked_spec(task: str, preset: str, cd: str | None, wgrad: str, param_noise=None,
                 net_type: str = "skip"):
    """A 30-step inpainting or restoration spec on the synthetic image,
    with its mask (restoration: the Bernoulli mask of the preset's pixel
    fraction), conv_wgrad and, if given, param_noise; inpainting with the
    net of `net_type`."""
    from dip_tpu_torch.bench import synthetic_inpaint
    from dip_tpu_torch.tasks import inpaint, restore

    img, mask = synthetic_inpaint(FIT_SIZE)
    if task == "inpaint":
        spec = inpaint.task(img * mask, mask, preset, gt=img, num_iter=MAIN_STEPS,
                            net_type=net_type)
    else:
        keep = {"barbara": 0.5, "kate": 0.02}[preset]
        mask = restore.get_bernoulli_mask(img.shape[1:], 1 - keep)[None]
        spec = restore.task(img * mask, mask, preset, num_iter=MAIN_STEPS, gt=img)
    spec.model.conv_wgrad = wgrad
    over = dict(compute_dtype=cd, log_every=10)
    if param_noise is not None:
        over["param_noise"] = param_noise
    return dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, **over))


# (task, preset, compute dtype, conv_wgrad); 'kate' with the kernels off is
# the timing pair of 'kate' with them on
MASKED_FITS = [("inpaint", "kate", "bfloat16", "all"), ("inpaint", "kate", None, "all"),
               ("inpaint", "kate", "bfloat16", "off"), ("inpaint", "kate", None, "off"),
               ("inpaint", "library", "bfloat16", "all"),
               ("restore", "barbara", "bfloat16", "all"), ("restore", "kate", "bfloat16", "all")]


def phase_masked_paths(dev: torch.device, card: str) -> dict:
    """Inpainting and restoration through run_task at 512^2: falling loss,
    rising psnr_track (the PSNR on the observed pixels), a finite render,
    and the launch counts the model implies. Returns the launches of the
    'kate' bf16 fit with every weight gradient from the kernels."""
    log(f"[masked] images: a synthetic {FIT_SIZE}^2 numpy image; inpainting masks rows of "
        f"small blocks, restoration keeps a Bernoulli fraction of the pixels")
    first = None
    for task, preset, cd, wgrad in MASKED_FITS:
        spec = _masked_spec(task, preset, cd, wgrad)
        tag = f"{task} {preset} {cd or 'float32'} conv_wgrad={wgrad}" + (
            " param_noise" if spec.cfg.param_noise else "")
        delta, _ = run_fit(spec, dev, card, "masked", tag,
                           path_launches(spec, MAIN_STEPS), "psnr_track")
        first = first or delta
    return first


def phase_zoo_paths(dev: torch.device, card: str) -> None:
    """[zoo] Inpainting 'library' with its UNet and its ResNet through
    run_task at 512^2, bf16 and f32, every weight gradient from the
    kernels: falling loss, rising psnr_track, a finite render, and the K5
    and K6 launches the nets' Convs imply; the graphed it/s."""
    for net_type in ZOO_NETS:
        for cd in ("bfloat16", None):
            spec = _masked_spec("inpaint", "library", cd, "all", net_type=net_type)
            run_fit(spec, dev, card, "zoo", f"inpaint library {net_type} {cd or 'float32'} "
                    f"conv_wgrad=all", path_launches(spec, MAIN_STEPS), "psnr_track")


def _steps_without_sync(spec, dev: torch.device, what: str) -> None:
    """Engine.step only enqueues work: after one warm step, three steps
    under torch's sync debug mode, which raises on any call that makes the
    host wait for the device (a read of a device value, a copy from
    pageable host memory)."""
    from dip_tpu_torch.fit.engine import Engine
    from dip_tpu_torch.tasks.base import make_input, to_device

    eng = Engine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn, device=dev)
    state = eng.init_state(1, make_input(spec, torch.Generator().manual_seed(0), dev),
                           spec.extra_params)
    aux = to_device(spec.aux, dev)
    eng.step(state, aux)  # first step: device constants, optimizer state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.step(state, aux)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[sync] {what}: 3 steps made no host sync")


def phase_steps_without_sync(dev: torch.device) -> None:
    """The flagship step (jitter, EMA, backtracking), and in bf16 with a
    jitter schedule and with SGD; the SR step (the downsample kernel in the
    loss and the metrics, its PyTorch adjoint, the carry-in seams); and the
    inpainting 'kate' step with every weight gradient from the kernels and
    weight jitter on. Not L-BFGS: its line search reads each trial's Wolfe
    test on the host, which is why its steps run eagerly."""
    for cd in ("bfloat16", None):
        _steps_without_sync(_flagship_spec(cd), dev, f"flagship {cd or 'float32'}")
    for what, over in (("reg_noise_schedule ((2, 0.1), (3, 0.05))",
                        dict(reg_noise_schedule=((2, 0.1), (3, 0.05)))),
                       ("optimizer sgd", dict(optimizer="sgd"))):
        spec = _flagship_spec("bfloat16")
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, **over))
        _steps_without_sync(spec, dev, f"flagship bfloat16 {what}")
    for cd, carry, factor in (("bfloat16", True, 4), (None, False, 4), ("bfloat16", False, 8)):
        _steps_without_sync(_sr_spec(cd, carry, factor), dev,
                            f"sr x{factor} {cd or 'float32'}{' carry' if carry else ''}")
    for cd in ("bfloat16", None):
        _steps_without_sync(_masked_spec("inpaint", "kate", cd, "all", param_noise=True), dev,
                            f"inpaint kate {cd or 'float32'} conv_wgrad=all param_noise")


def _fit_parts(spec, dev: torch.device, seed: int = 0) -> tuple:
    """(engine, state, aux) of a fit of `spec` on a copy of its model,
    seeded as run_task seeds it."""
    from dip_tpu_torch.tasks.base import start_task

    return start_task(dataclasses.replace(spec, model=copy.deepcopy(spec.model)), seed,
                      device=dev)


def _differing(a, b) -> list[str]:
    """The names of the params and the EMA that differ in any bit between
    fit states a and b (Engine's, or a BatchEngine device's), each with its
    max abs difference."""
    pairs = [(k, a.params[k], b.params[k]) for k in a.params] + [("ema", a.ema_out, b.ema_out)]
    return [f"{k} ({(x - y).abs().max().item():.3e})" for k, x, y in pairs
            if not torch.equal(x, y)]


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms on and its autotuner off."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _steps_per_s(fn, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return steps / (time.perf_counter() - t0)


def phase_graph(dev: torch.device, card: str) -> None:
    """[graph] The flagship in bf16 and f32 under deterministic cuDNN:
    GRAPH_STEPS eager Engine.step calls, and Engine.run of GRAPH_STEPS
    steps (one eager step, then replays of the captured one) from the same
    seeds, equal bit for bit in every loss, param and the EMA; then
    GRAPH_STEPS more steps each way, timed."""
    with _deterministic_cudnn():
        for cd in ("bfloat16", None):
            spec = _flagship_spec(cd, GRAPH_STEPS, GRAPH_STEPS)
            eng_e, st_e, aux_e = _fit_parts(spec, dev)
            eager = torch.stack([eng_e.step(st_e, aux_e)[1]["loss"]
                                 for _ in range(GRAPH_STEPS)]).cpu()
            eng_g, st_g, aux_g = _fit_parts(spec, dev)
            _, hist = eng_g.run(st_g, aux_g)
            torch.cuda.synchronize()
            losses_equal = torch.equal(eager, torch.from_numpy(hist["loss"]))
            differ = _differing(st_e, st_g)

            def eager_steps():
                for _ in range(GRAPH_STEPS):
                    eng_e.step(st_e, aux_e)

            def replays():
                eng_g.run_chunk(st_g, aux_g, GRAPH_STEPS)
                eng_g.wait()

            ips_e, ips_g = _steps_per_s(eager_steps, GRAPH_STEPS), _steps_per_s(replays, GRAPH_STEPS)
            log(f"[graph] flagship {cd or 'float32'}, cudnn deterministic: {GRAPH_STEPS} eager "
                f"steps against run() ({GRAPH_STEPS - 1} replays): losses "
                f"{'bitwise equal' if losses_equal else 'DIFFER'}, params and EMA "
                f"{'bitwise equal' if not differ else 'DIFFER in ' + ', '.join(differ[:6])} "
                f"| loss {eager[0]:.5f} -> {eager[-1]:.5f} | eager {ips_e:.2f} it/s, graphed "
                f"{ips_g:.2f} it/s ({GRAPH_STEPS} more steps each) | card {card}")
            if not losses_equal or differ:
                raise RuntimeError("the graphed steps differ from the eager steps")


def phase_queue(dev: torch.device, card: str, b1_ips: float) -> float:
    """[queue] QUEUE_JOBS flagship fits in bf16 through FitQueue, MAIN_STEPS
    steps each in chunks of 10, seeds 0..QUEUE_JOBS-1 (the graphs captured
    one after another, then the chunks round-robin): every loss finite
    and falling, every render finite, the jobs' params pairwise different,
    and the launch counts QUEUE_JOBS x path_launches. Returns the aggregate
    fit-iterations/s."""
    from dip_tpu_torch.parallel import FitQueue

    spec = _flagship_spec("bfloat16")
    q = FitQueue()
    for i in range(QUEUE_JOBS):
        q.add(spec, i, name=f"img{i}", device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    res = q.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    delta = launch_counts()
    want = {k: QUEUE_JOBS * v for k, v in path_launches(spec, MAIN_STEPS).items()}
    first = next(iter(spec.model.state_dict()))
    weights = [r[1].params[first] for r in res.values()]
    same = [(i, j) for i in range(len(weights)) for j in range(i) if torch.equal(weights[i],
                                                                                  weights[j])]
    losses = {name: r[2]["loss"] for name, r in res.items()}
    log(f"[queue] {QUEUE_JOBS} flagship fits, bfloat16, {MAIN_STEPS} steps each, chunks of 10: "
        f"aggregate {QUEUE_JOBS * MAIN_STEPS / wall:.2f} it/s (wall {wall:.2f} s, each job's "
        f"eager first step and capture included) against graphed b1 {b1_ips:.2f} it/s | losses "
        + ", ".join(f"{v[0]:.4f}->{v[-1]:.4f}" for v in losses.values())
        + f" | jobs with equal {first}: {same or 'none'} | peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB | launches {delta} | card {card}")
    if delta != want:
        raise RuntimeError(f"launch counts {delta} != {want}")
    for name, (out, _, hist) in res.items():
        loss = hist["loss"]
        if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
            raise RuntimeError(f"{name}: loss not finite and falling: {loss}")
        if not torch.isfinite(out).all():
            raise RuntimeError(f"{name}: render not finite")
    if same:
        raise RuntimeError(f"jobs from different seeds ended with equal params: {same}")
    return QUEUE_JOBS * MAIN_STEPS / wall


def _batch_parts(spec, dev: torch.device, fits: int = BATCH_FITS):
    """(BatchEngine, state, auxs) of `fits` fits of the denoising `spec` on
    a copy of its model: fit i seeded as run_task(spec, i) seeds it (z from
    seed i, weights from i + 1), each on its own noisy image (the spec's
    clean image plus its own sigma-25 noise, numpy seed i)."""
    from dip_tpu_torch.parallel import BatchEngine
    from dip_tpu_torch.tasks.base import make_input

    beng = BatchEngine(copy.deepcopy(spec.model), spec.loss_fn, spec.cfg, spec.metrics_fn,
                       device=dev)
    clean = spec.aux["gt"][0].numpy()
    noisy = [np.clip(clean + np.random.default_rng(i).normal(scale=25 / 255, size=clean.shape),
                     0, 1).astype(np.float32) for i in range(fits)]
    auxs = {"noisy": torch.from_numpy(np.stack(noisy)[:, None]).to(dev),
            "gt": spec.aux["gt"].expand(fits, *spec.aux["gt"].shape).contiguous().to(dev)}
    zs = torch.stack([make_input(spec, torch.Generator().manual_seed(i), "cpu")
                      for i in range(fits)])
    return beng, beng.init_state([i + 1 for i in range(fits)], zs), auxs


def _batch_spec(cd: str | None, size: int, steps: int = MAIN_STEPS):
    """A [batch] spec: the flagship at size^2; at 64^2 with the seam's
    carry-in, so that K1c runs with the fit axis too."""
    spec = _flagship_spec(cd, steps, 10, size)
    spec.model.seam_carry = size != 512
    return spec


def phase_batch(dev: torch.device, card: str, b8_ips: float) -> dict:
    """[batch] BatchEngine over BATCH_FITS flagship fits at full width (Skip
    5x128, bilinear seams), bf16 and f32, at 512^2 and at 64^2 (there with
    the seam's carry-in), MAIN_STEPS graphed steps through BatchEngine.run:
    each fit's loss falling, each render finite, and the launches exactly
    ONE fit's path_launches (one launch of each seam kernel a seam for all
    the fits), counters set to 0 just before and read just after; the
    fit-iterations/s (steps 11-30) beside a graphed b1 fit of the same
    spec and the FitQueue b8 (512^2 bf16). Then, under deterministic cuDNN
    at 512^2: one eager batched step held per fit to BATCH_FITS Engine
    steps from the same seeds (loss within BATCH_LOSS_TOL relative, every
    gradient within BATCH_GRAD_TOL of the fit's largest), and GRAPH_STEPS
    eager batched steps against BatchEngine.run of as many (one eager step,
    replays) bit for bit; and three eager batched steps with no host sync.
    Returns the launches of all the runs, by counter."""
    from dip_tpu_torch.fit.engine import tf32_flags
    from dip_tpu_torch.tasks.base import start_task

    total: dict = {}
    for size, cd in ((512, "bfloat16"), (512, None), (64, "bfloat16"), (64, None)):
        tag = f"{size}^2 {cd or 'float32'}" + (" seam carry" if size != 512 else "")
        spec = _batch_spec(cd, size)
        _, b1_ips = run_fit(spec, dev, card, "batch", f"b1 reference, flagship {tag}",
                            path_launches(spec, MAIN_STEPS), None)
        beng, state, auxs = _batch_parts(spec, dev)
        marks: list[tuple[int, float]] = []
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        state, hist = beng.run(state, auxs, callback=lambda it, h, s: marks.append(
            (it, time.perf_counter())))
        out = beng.render(state)
        torch.cuda.synchronize(dev)
        delta = launch_counts()
        (i0, t0), (i1, t1) = marks[0], marks[-1]
        ips = BATCH_FITS * (i1 - i0) / (t1 - t0)
        loss = hist["loss"]
        want = path_launches(spec, MAIN_STEPS)
        log(f"[batch] {BATCH_FITS} fits, flagship {tag}, BatchEngine graphed: {ips:.2f} "
            f"fit-it/s ({ips / BATCH_FITS:.2f} batched steps/s, steps {i0 + 1}-{i1}) against "
            f"graphed b1 {b1_ips:.2f} it/s" + (f" and FitQueue b{QUEUE_JOBS} {b8_ips:.2f} it/s"
                                               if (size, cd) == (512, "bfloat16") else "")
            + " | losses " + ", ".join(f"{a:.4f}->{b:.4f}" for a, b in zip(loss[0], loss[-1]))
            + f" | peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB | launches "
            f"{delta} (one fit's: {want}) | {tf32_flags()} | card {card}")
        if delta != want:
            raise RuntimeError(f"batched launch counts {delta} != one fit's {want}")
        if not (np.isfinite(loss).all() and (loss[-1] < loss[0]).all()):
            raise RuntimeError(f"a batched fit's loss is not finite and falling: {loss}")
        if tuple(out.shape) != (BATCH_FITS, 1, size, size, 3) or not torch.isfinite(out).all():
            raise RuntimeError(f"bad batched render {tuple(out.shape)}")
        total = {k: total.get(k, 0) + v for k, v in delta.items()}
        del beng, state, auxs, out

    with _deterministic_cudnn():
        for cd in ("bfloat16", None):
            spec = _batch_spec(cd, 512, 1)
            beng, state, auxs = _batch_parts(spec, dev)
            got = beng.step(state, auxs)
            shard = state.shards[0]
            g_bat = {k: p.grad for k, p in shard.params.items()}
            # the biases of the convs that feed a BN: every conv of a Skip but
            # the last (BATCH_GRAD_TOL's note)
            noise = {f"convs.{j}.bias" for j in range(len(spec.model.convs) - 1)}
            worst_loss = worst_grad = worst_noise = 0.0
            for i in range(BATCH_FITS):
                one = dataclasses.replace(spec, aux={k: v[i].cpu() for k, v in auxs.items()},
                                          model=copy.deepcopy(spec.model))
                eng, st, aux = start_task(one, i, device=dev)
                _, m = eng.step(st, aux)
                g_max = max(p.grad.abs().max().item() for p in st.params.values())
                errs = {k: (g_bat[k][i] - p.grad).abs().max().item() / g_max
                        for k, p in st.params.items()}
                worst_grad = max([worst_grad] + [e for k, e in errs.items() if k not in noise])
                worst_noise = max([worst_noise] + [errs[k] for k in noise])
                worst_loss = max(worst_loss, abs(got["loss"][i].item() / m["loss"].item() - 1))
                del eng, st, aux
            tol_l, tol_g = BATCH_LOSS_TOL[cd], BATCH_GRAD_TOL[cd]
            log(f"[batch] flagship 512^2 {cd or 'float32'}, cudnn deterministic: one batched "
                f"step against {BATCH_FITS} Engine steps from the same seeds: loss max rel "
                f"{worst_loss:.2e} (limit {tol_l:.0e}), gradients max err / the fit's max "
                f"{worst_grad:.2e} (limit {tol_g:.0e}; the {len(noise)} BN-fed conv biases, "
                f"zero in exact arithmetic, {worst_noise:.2e}) | card {card}")
            if worst_loss > tol_l or worst_grad > tol_g:
                raise RuntimeError("a batched fit's step differs from its own Engine's")
            del beng, state, auxs, g_bat
        spec = _batch_spec("bfloat16", 512, GRAPH_STEPS)
        be_e, st_e, aux_e = _batch_parts(spec, dev)
        eager = torch.stack([be_e.step(st_e, aux_e)["loss"] for _ in range(GRAPH_STEPS)]).cpu()
        be_g, st_g, aux_g = _batch_parts(spec, dev)
        _, hist = be_g.run(st_g, aux_g)
        torch.cuda.synchronize(dev)
        same = torch.equal(eager, torch.from_numpy(hist["loss"]))
        differ = _differing(st_e.shards[0], st_g.shards[0])
        log(f"[batch] {BATCH_FITS} fits, flagship 512^2 bfloat16, cudnn deterministic: "
            f"{GRAPH_STEPS} eager batched steps against run() ({GRAPH_STEPS - 1} replays): "
            f"losses {'bitwise equal' if same else 'DIFFER'}, params and EMA "
            f"{'bitwise equal' if not differ else 'DIFFER in ' + ', '.join(differ[:6])}")
        if not same or differ:
            raise RuntimeError("the graphed batched steps differ from the eager ones")
        del be_e, st_e, aux_e, be_g, st_g, aux_g

    spec = _batch_spec("bfloat16", 64)
    beng, state, auxs = _batch_parts(spec, dev)
    beng.step(state, auxs)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            beng.step(state, auxs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    log(f"[sync] BatchEngine {BATCH_FITS} fits, flagship 64^2 bfloat16 seam carry: 3 batched "
        f"steps made no host sync")
    del beng, state, auxs
    wgrad, f32_wgrad = _batch_conv_wgrad(dev, card)
    for part in (wgrad, _batch_lbfgs(dev, card)):
        total = {k: total.get(k, 0) + v for k, v in part.items()}
    return total, f32_wgrad


def _batch_conv_wgrad(dev: torch.device, card: str) -> dict:
    """[batch] BATCH_FITS 'kate' fits (inpainting at 512^2, 128-channel
    skips) with conv_wgrad='all', bf16 and f32: one batched step and a
    render, each stride-1 3x3 and 1x1 conv's weight gradient from K5 / K6
    with the fit axis (hopper_wgrad.ConvFits). Each fit-axis call is held
    where it is made: every fit's dW bitwise the single-fit launch on that
    fit's own slice (those launches are taken back from the counters). The
    launches, counters set to 0 just before and read just after: the seam
    kernels, K5 and K6 one fit's in both dtypes (one launch for all the
    fits). Returns them, and apart the f32 fits' K5 and K6 launches."""
    from dip_tpu_torch.ops import hopper_wgrad as W
    from dip_tpu_torch.ops import launches as L
    from dip_tpu_torch.parallel import BatchEngine
    from dip_tpu_torch.tasks.base import make_input

    total: dict = {}
    real = {"wgrad3x3_s1": W.wgrad3x3_s1, "wgrad1x1": W.wgrad1x1}
    held = {"calls": 0, "differ": []}

    def k5(x, g, halo=1, fits=None):
        return _held_fit_axis("wgrad3x3_s1", real, held, L, x, g, fits, halo)

    def k6(x, g, fits=None):
        return _held_fit_axis("wgrad1x1", real, held, L, x, g, fits)

    for cd in ("bfloat16", None):
        spec = _masked_spec("inpaint", "kate", cd, "all")
        beng = BatchEngine(copy.deepcopy(spec.model), spec.loss_fn, spec.cfg, spec.metrics_fn,
                           device=dev)
        auxs = {k: v.expand(BATCH_FITS, *v.shape).contiguous().to(dev)
                for k, v in spec.aux.items()}
        zs = torch.stack([make_input(spec, torch.Generator().manual_seed(i), "cpu")
                          for i in range(BATCH_FITS)])
        state = beng.init_state([i + 1 for i in range(BATCH_FITS)], zs)
        held.update(calls=0, differ=[])
        W.wgrad3x3_s1, W.wgrad1x1 = k5, k6
        try:
            reset_counts()
            metrics = beng.step(state, auxs)
            out = beng.render(state)
            torch.cuda.synchronize(dev)
            delta = launch_counts()
        finally:
            W.wgrad3x3_s1, W.wgrad1x1 = real["wgrad3x3_s1"], real["wgrad1x1"]
        want = path_launches(spec, 1)
        loss = metrics["loss"].cpu().numpy()
        log(f"[batch] {BATCH_FITS} fits, inpaint 'kate' {FIT_SIZE}^2 {cd or 'float32'} "
            f"conv_wgrad='all', one batched step: {held['calls']} K5/K6 fit-axis calls, every "
            f"fit's dW {'bitwise' if not held['differ'] else 'NOT bitwise'} its single-fit "
            f"launch's | losses {', '.join(f'{v:.4f}' for v in loss)} | launches {delta} "
            f"(expected {want}) | card {card}")
        if held["differ"]:
            raise RuntimeError(f"a fit's K5/K6 result differs from its single-fit launch: "
                               f"{held['differ'][:4]}")
        if delta != want or held["calls"] == 0:
            raise RuntimeError(f"batched conv_wgrad launch counts {delta} != {want}")
        if not np.isfinite(loss).all() or not torch.isfinite(out).all():
            raise RuntimeError("a batched 'kate' fit is not finite")
        total = {k: total.get(k, 0) + v for k, v in delta.items()}
        if cd is None:
            f32_wgrad = {k: delta[k] for k in WGRAD}
        del beng, state, auxs, out
    return total, f32_wgrad


def _held_fit_axis(name: str, real: dict, held: dict, L, x, g, fits, *halo):
    """The wrapper `name` as the batched step calls it; where it has the fit
    axis, each fit's result against the single-fit launch on the fit's own
    slice, bitwise, those launches taken back from the counters."""
    if fits is None:
        return real[name](x, g, *halo)
    out = real[name](x, g, *halo, fits)
    before = L.counts()
    n = x.shape[0] // fits
    for b in range(fits):
        one = real[name](x[b * n:(b + 1) * n], g[b * n:(b + 1) * n], *halo)
        if not torch.equal(out[b], one):
            held["differ"].append(f"{name} fit {b} x {tuple(x.shape)} "
                                  f"({(out[b] - one).abs().max().item():.3e})")
    L.add({k: v - before[k] for k, v in L.counts().items()}, -1)
    held["calls"] += 1
    return out


def _lbfgs_snapshot(shard) -> dict:
    """What a BatchEngine device's L-BFGS step reads, copied: params, EMA,
    step counters, jitter generators' states, and BatchZoomLBFGS's memory."""
    st = shard.opt.state[shard.opt._params[0]]
    return {"params": {k: p.detach().clone() for k, p in shard.params.items()},
            "ema": shard.ema_out.clone(), "device_step": shard.device_step.clone(),
            "step": shard.step,
            "gens": [g.get_state() for g in shard.generators],
            "pgens": [g.get_state() for g in shard.param_generators or []],
            "memory": {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                       for k, v in st.items()}}


def _engine_at(spec, dev: torch.device, i: int, snap: dict, aux_i):
    """Fit i's own Engine (L-BFGS) at the batched fit's state `snap`."""
    from dip_tpu_torch.fit.lbfgs import ZoomLBFGS

    one = dataclasses.replace(spec, aux=aux_i, model=copy.deepcopy(spec.model))
    eng, st, aux = _fit_parts(one, dev, i)
    with torch.no_grad():
        for k, p in st.params.items():
            p.copy_(snap["params"][k][i])
    st.ema_out = snap["ema"][i].clone()
    st.device_step.copy_(snap["device_step"])
    st.step = snap["step"]
    st.generator.set_state(snap["gens"][i])
    if st.param_generator is not None:
        st.param_generator.set_state(snap["pgens"][i])
    st.opt = ZoomLBFGS(st.params.values())
    mem = snap["memory"]
    if mem and mem["count"] > 0:
        st.opt.state[st.opt._params[0]].update(
            count=mem["count"], x_prev=mem["x_prev"][i].clone(), g_prev=mem["g_prev"][i].clone(),
            dw=mem["dw"][:, i].clone(), du=mem["du"][:, i].clone(), rho=mem["rho"][:, i].clone())
    return eng, st, aux


def _batch_lbfgs(dev: torch.device, card: str) -> dict:
    """[batch] BATCH_FITS flagship fits at BATCH_LBFGS_SIZE^2 in f32 (with
    the carry-in) with optimizer 'lbfgs' through BatchEngine.run:
    LBFGS_WARMUP graphed Adam steps, then LBFGS_STEPS eager L-BFGS steps,
    each a lockstep round of the fits' line searches a trial. Launches
    exact (counters set to 0 just before, read just after): one fit's path
    for the warm-up steps and for every round of evaluations (each round
    one forward and backward of all the fits), and the render; each fit's
    loss finite and falling; ms a step and evaluations. Then, under
    deterministic cuDNN, the same fits step by step: before each L-BFGS
    step, every fit's own Engine is put at the batched fit's state (params,
    EMA, step counters, jitter generators, L-BFGS memory) and takes the
    step alone: its loss within BATCH_LOSS_TOL[None] of the batched fit's,
    its evaluations equal in at least BATCH_LBFGS_SAME_EVALS of the
    LBFGS_STEPS steps of every fit (a Wolfe test whose margin lies below
    the rounding difference can go either way), and in each step with
    equal evaluations the fit's step (new params less old) within
    BATCH_LBFGS_STEP_TOL of its Engine's, over the largest element.
    Returns the free run's launches."""
    spec = _batch_spec(None, BATCH_LBFGS_SIZE, LBFGS_STEPS)
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, optimizer="lbfgs", lbfgs_warmup=LBFGS_WARMUP, log_every=1))
    beng, state, auxs = _batch_parts(spec, dev)
    marks: list[float] = []
    reset_counts()
    state, hist = beng.run(state, auxs, callback=lambda it, h, s: marks.append(
        time.perf_counter()))
    out = beng.render(state)
    torch.cuda.synchronize(dev)
    delta = launch_counts()
    evals = hist["evals"]
    rounds = int(evals.max(axis=1).sum())
    want = path_launches(spec, LBFGS_WARMUP + rounds)
    loss = hist["loss"]
    ms = (marks[-1] - marks[0]) * 1e3 / (len(marks) - 1)
    log(f"[batch] {BATCH_FITS} fits, flagship {BATCH_LBFGS_SIZE}^2 float32 seam carry, "
        f"optimizer lbfgs: {LBFGS_WARMUP} graphed Adam warm-up steps, then {LBFGS_STEPS} "
        f"L-BFGS steps in {rounds} rounds of evaluations (a step's most of any fit; "
        f"evaluations per fit {evals.sum(axis=0).astype(int).tolist()}) | eager {ms:.2f} ms a "
        f"batched step (steps 2-{LBFGS_STEPS}) | losses "
        + ", ".join(f"{a:.4f}->{b:.4f}" for a, b in zip(loss[0], loss[-1]))
        + f" | launches {delta} | card {card}")
    if delta != want:
        raise RuntimeError(f"batched L-BFGS launch counts {delta} != {want}")
    if not (np.isfinite(loss).all() and (loss[-1] < loss[0]).all()):
        raise RuntimeError(f"a batched L-BFGS fit's loss is not finite and falling: {loss}")
    if not torch.isfinite(out).all():
        raise RuntimeError("a batched L-BFGS render is not finite")
    del beng, state, out

    with _deterministic_cudnn():
        beng, state, auxs = _batch_parts(spec, dev)
        part, shard = beng.parts[0], state.shards[0]
        aux = beng._split(auxs)[0]
        with part.on_device():
            part._warmup(shard, aux)
        worst, worst_step, where = 0.0, 0.0, ""
        same = np.zeros(BATCH_FITS, dtype=int)
        for j in range(LBFGS_STEPS):
            snap = _lbfgs_snapshot(shard)
            got = part.step(shard, aux)[1]
            got_loss, got_evals = got["loss"].cpu().numpy(), got["evals"].cpu().numpy()
            for i in range(BATCH_FITS):
                eng, st, aux_i = _engine_at(spec, dev, i, snap,
                                            {k: v[i].cpu() for k, v in auxs.items()})
                _, m = eng.step(st, aux_i)
                worst = max(worst, abs(got_loss[i] / m["loss"].item() - 1))
                if got_evals[i] == m["evals"].item():
                    same[i] += 1
                    old = snap["params"]
                    d_got = {k: shard.params[k][i] - old[k][i] for k in st.params}
                    d_own = {k: st.params[k] - old[k][i] for k in st.params}
                    top = max(v.abs().max().item() for v in d_own.values())
                    err, leaf = max(((d_got[k] - d_own[k]).abs().max().item() / top, k)
                                    for k in st.params)
                    if err > worst_step:
                        worst_step, where = err, f"step {j + 1}, fit {i}, {leaf}"
                del eng, st, aux_i
        tol = BATCH_LOSS_TOL[None]
        log(f"[batch] {BATCH_FITS} L-BFGS fits, cudnn deterministic: each of {LBFGS_STEPS} "
            f"batched L-BFGS steps against every fit's own Engine at the batched fit's state: "
            f"loss max rel {worst:.2e} (limit {tol:.0e}); steps with equal evaluations per fit "
            f"{same.tolist()} (at least {BATCH_LBFGS_SAME_EVALS} of {LBFGS_STEPS}); in those, "
            f"the step's error over its largest element {worst_step:.2e} ({where}; limit "
            f"{BATCH_LBFGS_STEP_TOL:.0e}) | card {card}")
        if (worst > tol or (same < BATCH_LBFGS_SAME_EVALS).any()
                or worst_step > BATCH_LBFGS_STEP_TOL):
            raise RuntimeError("a batched L-BFGS step differs from its fit's own Engine's")
    return delta


def _spatial_parts(spec, dev: torch.device, blocks: int, seed: int = 0) -> tuple:
    """(SpatialEngine, state, aux) of a fit of `spec` over Mesh([dev] *
    blocks) on a copy of its model, seeded as run_task seeds it."""
    from dip_tpu_torch.parallel.mesh import Mesh
    from dip_tpu_torch.parallel.spatial import SpatialEngine
    from dip_tpu_torch.tasks.base import make_input, to_device

    eng = SpatialEngine(copy.deepcopy(spec.model), spec.loss_fn, spec.cfg, spec.metrics_fn,
                        mesh=Mesh([dev] * blocks, axis="sp"))
    z = make_input(spec, torch.Generator().manual_seed(seed), eng.device)
    return eng, eng.init_state(seed + 1, z, spec.extra_params), to_device(spec.aux, eng.device)


def _spatial_spec(net: str, cd: str | None, size: int, steps: int, log_every: int):
    """The spec of a SPATIAL_FITS entry: `steps` steps, logged every
    `log_every`, in compute dtype `cd`."""
    from dip_tpu_torch.bench import synthetic_noisy
    from dip_tpu_torch.models import dcgan, get_net
    from dip_tpu_torch.tasks import denoise

    if net == "flagship":
        return _flagship_spec(cd, steps, log_every, size)
    if net.startswith("library "):
        spec = _masked_spec("inpaint", "library", cd, "all", net_type=net.split()[1])
    else:
        clean, noisy = synthetic_noisy(size)
        spec = denoise.task(noisy, "f16", gt=clean)
        if net == "flagship lanczos2":
            spec = dataclasses.replace(spec, model=get_net(
                32, "skip", "reflection", "bilinear", skip_n11=4, downsample_mode="lanczos2"))
        elif net == "texture_nets":
            spec = dataclasses.replace(spec, model=get_net(32, "texture_nets", "reflection",
                                                           "nearest"))
        elif net == "dcgan":
            spec = dataclasses.replace(spec, model=dcgan(), input_depth=2,
                                       spatial_size=(size // 4 - 2, size // 4 - 2))
        else:
            raise ValueError(f"unknown [spatial] net {net!r}")
    return dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, num_iter=steps, compute_dtype=cd, log_every=log_every))


def _norm_fed_biases(model) -> set[str]:
    """The conv biases that a norm follows: their exact gradient is 0 (a
    norm takes out a per-channel constant), so both sides read rounding
    noise there (the Skip's and TextureNet's every conv but the head,
    ResNet's neck, the convs of a UNet's normed double convs; DCGAN has no
    bias)."""
    import torch.nn as nn

    from dip_tpu_torch.models import ResNet, Skip, TextureNet, UNet

    if isinstance(model, (Skip, TextureNet)):
        return {f"convs.{j}.bias" for j in range(len(model.convs) - 1)}
    if isinstance(model, ResNet):
        return {"neck.bias"}
    if isinstance(model, UNet):
        return {f"{name}.convs.{j}.bias" for name, m in model.named_modules()
                if hasattr(m, "norms") for j, nrm in enumerate(m.norms)
                if not isinstance(nrm, nn.Identity) and m.convs[j].bias is not None}
    return set()


def _one_step(net: str, cd: str | None, size: int, blocks: int, dev: torch.device) -> tuple:
    """One step of a SPATIAL_FITS fit in compute dtype `cd`, over `blocks`
    row blocks (0: Engine, unsharded) from seed 0: (loss, every
    parameter's gradient in f32, the norm-fed conv biases)."""
    spec = _spatial_spec(net, cd, size, 1, 1)
    eng, st, aux = _spatial_parts(spec, dev, blocks) if blocks else _fit_parts(spec, dev)
    _, m = eng.step(st, aux)
    grads = {k: p.grad.float() for k, p in st.params.items()}
    return m["loss"].item(), grads, _norm_fed_biases(spec.model)


def _step_err(a: tuple, b: tuple) -> tuple[float, float, float]:
    """(loss rel, the largest gradient error over b's largest gradient
    outside the norm-fed biases, the same over those biases) of step a
    against step b."""
    (la, ga, noise), (lb, gb, _) = a, b
    g_max = max(v.abs().max().item() for v in gb.values())
    errs = {k: (ga[k] - v).abs().max().item() / g_max for k, v in gb.items()}
    return (abs(la / lb - 1), max(e for k, e in errs.items() if k not in noise),
            max([errs[k] for k in noise], default=0.0))


def _spatial_against_engine(net: str, size: int, cd: str | None, blocks: int,
                            dev: torch.device, tag: str, card: str) -> None:
    """[spatial] under deterministic cuDNN: one sharded step against
    Engine's from the same seed, and GRAPH_STEPS eager sharded steps
    against run() of as many, bit for bit, in the fit's dtype. The step is
    held in f32 at [batch]'s f32 limits (the norm-fed conv biases apart):
    there a fault reads O(1) and the order of sums ~1e-2. In bf16 the
    loss is held at [batch]'s bf16 limit, and the gradients against
    Engine's f32 step within SPATIAL_BF16_FLOOR times the geometry's bf16
    rounding floor (Engine's own bf16 step against its f32 step), which at
    512^2 over 4 blocks exceeds [batch]'s bf16 limit of 1e-1 (PERF.md §6):
    there two orders of bf16 sums differ by as much as bf16 differs from
    f32."""
    with _deterministic_cudnn():
        u32 = _one_step(net, None, size, 0, dev)
        loss32, grad32, noise32 = _step_err(_one_step(net, None, size, blocks, dev), u32)
        line = (f"[spatial] {tag}, cudnn deterministic: one sharded step against Engine's from "
                f"the same seed, f32: loss rel {loss32:.2e} (limit {BATCH_LOSS_TOL[None]:.0e}), "
                f"gradients max err / the largest {grad32:.2e} (limit "
                f"{BATCH_GRAD_TOL[None]:.0e}; the {len(u32[2])} norm-fed conv biases, zero in "
                f"exact arithmetic, {noise32:.2e})")
        loss16 = grad16 = floor = 0.0
        if cd is not None:
            u16 = _one_step(net, cd, size, 0, dev)
            s16 = _one_step(net, cd, size, blocks, dev)
            loss16, near16, noise16 = _step_err(s16, u16)
            grad16, floor = _step_err(s16, u32)[1], _step_err(u16, u32)[1]
            line += (f"; {cd}: loss rel {loss16:.2e} (limit {BATCH_LOSS_TOL[cd]:.0e}), "
                     f"gradients against Engine's f32 step {grad16:.2e} (limit "
                     f"{SPATIAL_BF16_FLOOR} x Engine's own {cd} step's {floor:.2e}), against "
                     f"Engine's {cd} step {near16:.2e} (the norm-fed biases {noise16:.2e})")
            del u16, s16
        log(line + f" | card {card}")
        if loss32 > BATCH_LOSS_TOL[None] or grad32 > BATCH_GRAD_TOL[None] or (
                cd is not None and (loss16 > BATCH_LOSS_TOL[cd]
                                    or grad16 > SPATIAL_BF16_FLOOR * floor)):
            raise RuntimeError("the sharded step differs from Engine's")
        del u32
        ten = _spatial_spec(net, cd, size, GRAPH_STEPS, GRAPH_STEPS)
        eng_e, st_e, aux_e = _spatial_parts(ten, dev, blocks)
        eager = torch.stack([eng_e.step(st_e, aux_e)[1]["loss"]
                             for _ in range(GRAPH_STEPS)]).cpu()
        eng_g, st_g, aux_g = _spatial_parts(ten, dev, blocks)
        _, hist = eng_g.run(st_g, aux_g)
        torch.cuda.synchronize(dev)
        same = torch.equal(eager, torch.from_numpy(hist["loss"]))
        differ = _differing(st_e, st_g)
        log(f"[spatial] {tag}, cudnn deterministic: {GRAPH_STEPS} eager sharded steps "
            f"against run() ({GRAPH_STEPS - 1} replays): losses "
            f"{'bitwise equal' if same else 'DIFFER'}, params and EMA "
            f"{'bitwise equal' if not differ else 'DIFFER in ' + ', '.join(differ[:6])}")
        if not same or differ:
            raise RuntimeError("the graphed sharded steps differ from the eager ones")


def phase_spatial(dev: torch.device, card: str) -> tuple[dict, dict]:
    """[spatial] SpatialEngine at each of SPATIAL_FITS, at full width, its
    activations cut into row blocks over a mesh that repeats the one card:
    one step against Engine's (held in f32; in bf16 the loss and the
    gradients against the rounding floor) and eager
    against graphed steps (_spatial_against_engine). Then SPATIAL_STEPS graphed steps: loss
    finite and falling, render finite and of the output's shape, each
    kernel launched exactly blocks x one fit's (path_launches: K1-K4 5 a
    step at the Skips' fused seams, K1 once more in the render; K5/K6 a
    step at each routed conv; K7 at each Lanczos post-down of every
    forward), counters set to 0 just before and read just after; its it/s
    and peak memory beside the unsharded fit's (run_fit); three eager steps
    with no host sync; each fit's wall time. Returns the launches of the
    graphed sharded runs, and apart those of the Lanczos Skip's."""
    from dip_tpu_torch.fit.engine import tf32_flags

    total: dict = {}
    lanczos: dict = {}
    for net, cd, size, blocks in SPATIAL_FITS:
        t_fit = time.perf_counter()
        fit = f"{net} {size}^2 {cd or 'float32'}"
        tag = f"{fit}, {blocks} row blocks on one card"
        _spatial_against_engine(net, size, cd, blocks, dev, tag, card)
        spec = _spatial_spec(net, cd, size, SPATIAL_STEPS, 10)
        _, b1_ips = run_fit(spec, dev, card, "spatial", f"unsharded reference, {fit}",
                            path_launches(spec, SPATIAL_STEPS), None)
        b1_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        eng, state, aux = _spatial_parts(spec, dev, blocks)
        marks: list[tuple[int, float]] = []
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        state, hist = eng.run(state, aux, callback=lambda it, h, s: marks.append(
            (it, time.perf_counter())))
        out = eng.render(state)
        torch.cuda.synchronize(dev)
        delta = launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        (i0, t0), (i1, t1) = marks[0], marks[-1]
        ips = (i1 - i0) / (t1 - t0)
        want = {k: blocks * v for k, v in path_launches(spec, SPATIAL_STEPS).items()}
        loss = hist["loss"]
        out_shape = (1, *output_size(spec), spec.model.num_output_channels)
        log(f"[spatial] {tag}, SpatialEngine graphed: {ips:.2f} it/s (steps {i0 + 1}-{i1}) "
            f"against the unsharded fit's {b1_ips:.2f} | peak {peak:.2f} GiB against "
            f"{b1_peak:.2f} (every block on one card: the peak is not expected to fall) | loss "
            f"{loss[0]:.6g} -> {loss[-1]:.6g} | launches {delta} ({blocks} x one fit's) | "
            f"{tf32_flags()} | card {card}")
        if delta != want:
            raise RuntimeError(f"sharded launch counts {delta} != {want}")
        if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
            raise RuntimeError(f"the sharded fit's loss is not finite and falling: {loss}")
        if tuple(out.shape) != out_shape or not torch.isfinite(out).all():
            raise RuntimeError(f"bad sharded render {tuple(out.shape)}, expected {out_shape}")
        total = {k: total.get(k, 0) + v for k, v in delta.items()}
        if post_downs(spec.model):
            lanczos = {k: lanczos.get(k, 0) + v for k, v in delta.items()}
        eng.step(state, aux)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                eng.step(state, aux)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize(dev)
        log(f"[sync] SpatialEngine {tag}: 3 sharded steps made no host sync")
        del eng, state, aux, out
        log(f"[spatial] {tag}: {time.perf_counter() - t_fit:.1f} s | card {card}")
    return total, lanczos


def synthetic_sr_png(path: Path, h: int, w: int, seed: int) -> None:
    """A smooth textured (h, w, 3) numpy image saved as a PNG."""
    from PIL import Image

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.sin(xx / 9 + seed) * np.cos(yy / 13) * 0.5 + 0.5,
                    np.cos((xx + yy) / 11) * 0.4 + 0.5,
                    np.sin(xx / 5) * np.sin(yy / 7) * 0.2 + (xx + yy) / (h + w) * 0.6], -1)
    img = img + np.random.default_rng(seed).random(img.shape) * 0.05
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


def fleet_images() -> Path:
    """FLEET_IMAGES as PNGs under build/ (made anew)."""
    d = Path("build") / "fleet_images"
    d.mkdir(parents=True, exist_ok=True)
    for old in d.glob("*.png"):
        old.unlink()
    for seed, (name, (h, w)) in enumerate(FLEET_IMAGES.items()):
        synthetic_sr_png(d / f"{name}.png", h, w, seed)
    return d


def _standin_size(name: str, scale: float) -> tuple[int, int]:
    """The (W, H) of stand-in `name`: STANDINS' at scale 1; else each side
    times `scale`, rounded to a multiple of 64 and at least 64 (256 for
    'library', whose 6-scale net reflection-pads its 5x5 convs by 2 down to
    1/64 of the image), which every recipe's crop and net take."""
    size = STANDINS[STANDIN_MASKS.get(name, name)][0]
    if scale == 1:
        return size
    least = 256 if "library" in name else 64
    return tuple(max(least, int(round(d * scale / 64)) * 64) for d in size)


def _standin_mask(name: str, w: int, h: int) -> np.ndarray:
    """(h, w) uint8 mask, 255 where the pixel is kept."""
    from dip_tpu_torch.utils.masks import get_text_mask

    if name.endswith("kate_mask.png"):
        keep = np.ones((h, w, 1), np.float32)
        for y in range(h // 12, h, h // 6):
            for x in (w // 16, w // 2 + w // 16):
                keep *= get_text_mask((h, w, 1), font_size=max(8, h // 16), xy=(x, y))
        return (keep[..., 0] * 255).astype(np.uint8)
    keep = np.full((h, w), 255, np.uint8)
    if name.endswith("vase_mask.png"):
        keep[h // 3:2 * h // 3, w // 3:2 * w // 3] = 0
    else:  # library: four rows of eight holes
        s = max(4, h // 16)
        for r in range(4):
            for c in range(8):
                y, x = (2 * r + 1) * h // 8 - s // 2, (2 * c + 1) * w // 16 - s // 2
                keep[y:y + s, x:x + s] = 0
    return keep


def write_reference_standins(root: Path, scale: float = 1) -> dict:
    """The reference's data/ layout under `root`, made anew from STANDINS
    and STANDIN_MASKS at their sizes times `scale` (_standin_size). The
    .jpg files are JPEG where this Pillow writes JPEG; elsewhere PNG data
    under the same names, which Pillow reads back by content. Returns
    {file: Pillow's format of it as read back}."""
    from PIL import Image, features

    from dip_tpu_torch.data.synthetic import synthetic_image

    jpeg = features.check("jpg")
    formats = {}
    for name, (_, mode, image) in STANDINS.items():
        w, h = _standin_size(name, scale)
        side = max(w, h)
        y0, x0 = (side - h) // 2, (side - w) // 2
        img = synthetic_image(image, side, 1 if mode == "L" else 3)[y0:y0 + h, x0:x0 + w]
        if "noflash" in name:
            xx = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
            light = (0.35 + 0.45 * (1 - xx)) * np.array([1.0, 0.8, 0.55], np.float32)
            noise = np.random.default_rng(5).normal(scale=0.03, size=img.shape)
            img = img * light + noise
        elif "flash" in name:
            img = img * np.array([0.95, 0.95, 1.0], np.float32)
        ar = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
        formats[name] = _save_standin(root / name, Image.fromarray(
            ar[..., 0] if mode == "L" else ar, mode), jpeg)
    for name in STANDIN_MASKS:
        w, h = _standin_size(name, scale)
        formats[name] = _save_standin(root / name, Image.fromarray(
            _standin_mask(name, w, h), "L"), jpeg)
    return formats


def _save_standin(path: Path, img, jpeg: bool) -> str:
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    img.save(path, format="JPEG" if jpeg and path.suffix == ".jpg" else "PNG")
    with Image.open(path) as back:
        if back.size != img.size or back.mode != img.mode:
            raise RuntimeError(f"{path} reads back as {back.size} {back.mode}")
        return back.format


def phase_fleet(dev: torch.device, card: str) -> None:
    """[fleet] eval_sr_dataset_sharded over make_mesh() (this card) on
    FLEET_IMAGES, x4, under deterministic cuDNN: the per-image names in
    sorted order with finite scores, one BatchEngine program per LR shape
    with the images of a group as sub-batches of the mesh's size, seeded
    seed + i + 1 (recorded from BatchEngine.init_state), and every score
    within FLEET_DB_1 of eval_sr_dataset's with the same seeds after one
    step and within FLEET_DB after FLEET_STEPS."""
    from dip_tpu_torch.eval import sr_eval
    from dip_tpu_torch.parallel import batch as pbatch, make_mesh

    d = fleet_images()
    mesh = make_mesh()
    names = sorted(FLEET_IMAGES)
    want_calls = []
    for shape in dict.fromkeys(FLEET_IMAGES[n] for n in names):
        group = [i for i, n in enumerate(names) if FLEET_IMAGES[n] == shape]
        group += [group[-1]] * (-len(group) % mesh.size)
        want_calls += [([i + 1 for i in group[lo:lo + mesh.size]], shape)
                       for lo in range(0, len(group), mesh.size)]
    init = pbatch.BatchEngine.init_state
    for steps, limit in ((1, FLEET_DB_1), (FLEET_STEPS, FLEET_DB)):
        calls = []

        def record(self, seeds, zs, extra_params=None):
            calls.append((list(seeds), tuple(zs.shape[2:4])))
            return init(self, seeds, zs, extra_params)

        pbatch.BatchEngine.init_state = record
        try:
            with _deterministic_cudnn():
                t0 = time.perf_counter()
                fleet = sr_eval.eval_sr_dataset_sharded(str(d), mesh, factor=4,
                                                        num_iter=steps, verbose=False)
                t_fleet = time.perf_counter() - t0
                pbatch.BatchEngine.init_state = init
                t0 = time.perf_counter()
                seq = sr_eval.eval_sr_dataset(str(d), factor=4, num_iter=steps, verbose=False,
                                              device=dev)
                t_seq = time.perf_counter() - t0
        finally:
            pbatch.BatchEngine.init_state = init
        gap = max(abs(fleet.per_image[n] - seq.per_image[n]) for n in names)
        log(f"[fleet] eval_sr_dataset_sharded over {mesh}, x4, {steps} steps, cudnn "
            f"deterministic, HR {list(FLEET_IMAGES.values())}: "
            + ", ".join(f"{n} {fleet.per_image[n]:.3f} dB (sequential {seq.per_image[n]:.3f})"
                        for n in names)
            + f" | max gap {gap:.4f} dB (limit {limit}) | BatchEngine programs (seeds, HR) "
            f"{calls} | fleet {t_fleet:.1f} s, sequential {t_seq:.1f} s | card {card}")
        if list(fleet.per_image) != names or not all(np.isfinite(list(fleet.per_image.values()))):
            raise RuntimeError(f"bad fleet scores {fleet.per_image}")
        if calls != want_calls:
            raise RuntimeError(f"the fleet's groups {calls} != {want_calls}")
        if gap > limit:
            raise RuntimeError(f"the fleet's scores are {gap:.3f} dB from the sequential eval's")


def synthetic_flash(size: int) -> tuple[np.ndarray, np.ndarray]:
    """(flash, no-flash) (1, size, size, 3), made with numpy: a textured
    scene under a cold, bright, flat light, and the same scene under a
    warm, dim light falling off to one side, with sensor noise."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    albedo = np.stack([0.5 + 0.3 * np.sin(xx * 23) * np.cos(yy * 17),
                       0.5 + 0.25 * np.cos((xx + yy) * 31),
                       0.45 + 0.2 * np.sin(xx * 57) * np.sin(yy * 41)], -1)
    flash = np.clip(albedo * np.array([0.95, 0.95, 1.0]), 0, 1)
    light = (0.35 + 0.45 * (1 - xx))[..., None] * np.array([1.0, 0.8, 0.55])
    noise = np.random.default_rng(5).normal(scale=0.03, size=albedo.shape)
    noflash = np.clip(albedo * light + noise, 0, 1)
    return flash[None].astype(np.float32), noflash[None].astype(np.float32)


def phase_flash(dev: torch.device, card: str) -> None:
    """[flash] Flash/no-flash at 512^2 in bf16 through run_task, MAIN_STEPS
    steps at the recipe's lr, under deterministic cuDNN from run_task's
    fixed seeds (numpy images, z and weights from CPU generators), so that
    every run reads the same: nearest up at the two top seams and bilinear
    below, all fused; the loss falls, psnr_track rises, the launch counts
    hold."""
    from dip_tpu_torch.tasks import flash_no_flash

    flash, noflash = synthetic_flash(FIT_SIZE)
    spec = flash_no_flash.task(flash, noflash, num_iter=MAIN_STEPS)
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, compute_dtype="bfloat16", log_every=10))
    with _deterministic_cudnn():
        run_fit(spec, dev, card, "flash", f"flash/no-flash {FIT_SIZE}^2 bfloat16 up modes "
                f"{spec.model.up_modes}, cudnn deterministic",
                path_launches(spec, MAIN_STEPS), "psnr_track")


def phase_checkpoint(dev: torch.device, card: str) -> None:
    """[ckpt] The flagship in bf16 under deterministic cuDNN: 10 steps,
    saved, restored into a fresh state and fit for 10 more, against 20
    steps uninterrupted: the losses, params and EMA bit for bit."""
    from dip_tpu_torch.fit.checkpoint import restore_fit_state, save_fit_state

    path = Path("build") / "chip_smoke_ckpt.pt"
    path.parent.mkdir(exist_ok=True)
    with _deterministic_cudnn():
        eng, whole, aux = _fit_parts(_flagship_spec("bfloat16", 20, 10), dev)
        _, h_whole = eng.run(whole, aux)
        half = _flagship_spec("bfloat16", 10, 10)
        eng1, first, aux1 = _fit_parts(half, dev)
        _, h1 = eng1.run(first, aux1)
        save_fit_state(str(path), first)
        eng2, resumed, aux2 = _fit_parts(half, dev)
        restore_fit_state(str(path), resumed)
        _, h2 = eng2.run(resumed, aux2)
        torch.cuda.synchronize()
    path.unlink()
    losses_equal = np.array_equal(np.concatenate([h1["loss"], h2["loss"]]), h_whole["loss"])
    differ = _differing(whole, resumed)
    log(f"[ckpt] flagship bfloat16, cudnn deterministic: 10 steps, save, restore into a fresh "
        f"state, 10 more, against 20 uninterrupted: losses "
        f"{'bitwise equal' if losses_equal else 'DIFFER'}, params and EMA "
        f"{'bitwise equal' if not differ else 'DIFFER in ' + ', '.join(differ[:6])}, "
        f"step {resumed.step} | card {card}")
    if not losses_equal or differ or resumed.step != 20:
        raise RuntimeError("the resumed fit differs from the uninterrupted one")


def phase_lbfgs(dev: torch.device, card: str) -> None:
    """[lbfgs] The flagship ('f16' at 512^2, full width) with optimizer
    'lbfgs' through run_task, bf16 and f32: LBFGS_WARMUP graphed Adam
    steps, then LBFGS_STEPS eager L-BFGS steps, a host callback after each.
    The loss falls over the L-BFGS steps and is finite, the render is
    finite, and the launch counts are those of LBFGS_WARMUP steps, one
    forward and backward a value-and-gradient evaluation, and the render;
    evaluations a step and the eager ms a step (steps 2 to LBFGS_STEPS)."""
    from dip_tpu_torch.tasks.base import run_task

    for cd in ("bfloat16", None):
        spec = _flagship_spec(cd, LBFGS_STEPS, 1)
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, optimizer="lbfgs", lbfgs_warmup=LBFGS_WARMUP))
        marks: list[float] = []
        reset_counts()
        out, state, hist = run_task(spec, 0, device=dev,
                                    callback=lambda it, h, s: marks.append(time.perf_counter()))
        delta = launch_counts()
        evals = int(hist["evals"].sum())
        want = path_launches(spec, LBFGS_WARMUP + evals)
        loss = hist["loss"]
        ms = (marks[-1] - marks[0]) * 1e3 / (len(marks) - 1)
        log(f"[lbfgs] flagship {cd or 'float32'}: {LBFGS_WARMUP} Adam warm-up steps, then "
            f"{LBFGS_STEPS} L-BFGS steps, {evals} evaluations (a step: "
            f"{' '.join(str(int(e)) for e in hist['evals'])}; mean {evals / LBFGS_STEPS:.2f}) "
            f"| eager {ms:.2f} ms/step (steps 2-{LBFGS_STEPS}), {ms * LBFGS_STEPS / evals:.2f} "
            f"ms/evaluation | loss {loss[0]:.5f} -> {loss[-1]:.5f} | launches {delta} | step "
            f"{state.step} | card {card}")
        if delta != want:
            raise RuntimeError(f"launch counts {delta} != {want}")
        if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
            raise RuntimeError(f"loss not finite and falling: {loss}")
        if state.step != LBFGS_WARMUP + LBFGS_STEPS or not torch.isfinite(out).all():
            raise RuntimeError(f"bad end of the L-BFGS fit: step {state.step}")


# [backbones]: each backbone at its classifier size and full width, and the
# taps held card against CPU: its deepest conv / pool tap and its fc taps
BACKBONE_TAPS = {"alexnet_caffe": ("conv5", "fc6", "fc8"),
                 "vgg19_caffe": ("relu4_4", "pool5", "fc6"),
                 "vgg16_caffe": ("relu4_3", "pool5", "fc6"),
                 "vgg19_pytorch_modified": ("relu4_4", "pool5", "fc6")}
# [fi]: (backbone, taps, statistic): the notebook's recipe (AlexNet fc6),
# and a Gram-matrix match at one VGG19 conv tap
FI_FITS = [("alexnet_caffe", ("fc6",), "features"), ("vgg19_caffe", ("conv3_1",), "gram_matrix")]
# [am]: (layer, unit): a conv map ('maximize', lr 1e-3) and a class logit
# ('am_match', lr 1e-2), AlexNet
AM_FITS = [("conv4", 2), ("fc8", 2)]


def phase_backbones(dev: torch.device) -> None:
    """[backbones] The four backbones at full width (AlexNet at 227^2, the
    VGGs at 224^2) with seeded random weights, on the card against the
    same net on the CPU, TF32 off: every tap of BACKBONE_TAPS on a
    preprocessed random image, each tap's error over its largest value
    within 2e-3 (phase 4's limit, max-normalised: caffe activations run to
    the thousands); and the gradient of the deepest tap's sum with respect
    to the image, held to the CPU's f64 gradient: the card's f32 within
    2e-2 of the largest (phase 4's limit) beyond the CPU's own f32 error.
    That gradient sums thousands of units' paths that mostly cancel, and
    through VGG19 the CPU's f32 gradient is itself 3.9e-2 from f64. The
    card in f64 is held to the CPU in f64 as well, taps and gradient within
    1e-9: the device path's arithmetic apart from f32's conditioning."""
    from dip_tpu_torch.fit.engine import disable_tf32, tf32_flags
    from dip_tpu_torch.pretrained.backbones import (default_imsize, get_backbone,
                                                    pytorch_preprocess, vgg_preprocess_caffe)

    disable_tf32()
    for name, taps in BACKBONE_TAPS.items():
        size = default_imsize(name)
        cpu = get_backbone(name)
        cpu.reset_parameters(torch.Generator().manual_seed(6))
        pre = pytorch_preprocess if name == "vgg19_pytorch_modified" else vgg_preprocess_caffe
        img = torch.rand((1, size, size, 3), generator=torch.Generator().manual_seed(7))
        outs, grads = [], []
        for d, dt in (("cpu", torch.float32), ("cpu", torch.float64), (dev, torch.float32),
                      (dev, torch.float64)):
            model = copy.deepcopy(cpu).to(d, dt)
            x = img.to(d, dt, copy=True).requires_grad_()
            acts = model(pre(x), taps)
            acts[taps[-1]].sum().backward()
            outs.append({t: a.detach().cpu() for t, a in acts.items()})
            grads.append(x.grad.cpu())
            del model
        torch.cuda.synchronize()
        errs = {t: rel_err(outs[2][t], outs[0][t])[0] for t in taps}
        g_cpu, _ = rel_err(grads[0].double(), grads[1])
        g_card, _ = rel_err(grads[2].double(), grads[1])
        f64 = max([rel_err(outs[3][t], outs[1][t])[0] for t in taps]
                  + [rel_err(grads[3], grads[1])[0]])
        log(f"[backbones] {name} {size}^2 (fc6 in {cpu.fc6.weight.shape[1]}): cuda vs cpu, "
            f"max err / max: " + ", ".join(f"{t} {e:.2e}" for t, e in errs.items())
            + f"; d sum({taps[-1]}) / d image against the cpu's f64: cuda f32 {g_card:.2e}, "
            f"cpu f32 {g_cpu:.2e}; cuda f64 vs cpu f64, taps and gradient {f64:.2e} | "
            f"{tf32_flags()}")
        if max(errs.values()) > 2e-3 or g_card > g_cpu + 2e-2 or f64 > 1e-9:
            raise RuntimeError(f"{name} on the card disagrees with the CPU")
        del cpu, outs, grads


def _with_cfg(spec, cd: str | None):
    return dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, num_iter=MAIN_STEPS, compute_dtype=cd, log_every=10))


def phase_fi(dev: torch.device, card: str) -> None:
    """[fi] Feature inversion through run_task, MAIN_STEPS graphed steps,
    bf16 and f32, each FI_FITS entry on a synthetic numpy content image
    of the classifier's size, the generator at 256^2: the loss finite and
    falling, the render the classifier's crop (227 or 224) and finite, and
    no seam launch (the recipe's zero-padded net fuses no seam)."""
    from dip_tpu_torch.data import synthetic_image
    from dip_tpu_torch.tasks import feature_inversion

    for backbone, layers, what in FI_FITS:
        fi = feature_inversion.FeatureInversion(backbone, layers, what=what, device=dev)
        content = synthetic_image("disks", fi.imsize)[None]
        for cd in ("bfloat16", None):
            spec = _with_cfg(fi.spec(content), cd)
            want = path_launches(spec, MAIN_STEPS)
            if any(want.values()):
                raise RuntimeError(f"feature inversion's net should fuse no seam: {want}")
            run_fit(spec, dev, card, "fi", f"{backbone} {'+'.join(layers)} {what} "
                    f"{fi.imsize}^2 (net {fi.imsize_net}^2) {cd or 'float32'}", want, None)
        del fi


def am_spec(layer: str, idx: int, cd: str | None, dev: torch.device):
    from dip_tpu_torch.tasks import activation_maximization

    return _with_cfg(activation_maximization.task(layer=layer, map_idx=idx, device=dev), cd)


def phase_am(dev: torch.device, card: str) -> None:
    """[am] Activation maximization through run_task, MAIN_STEPS graphed
    steps, bf16 and f32, with the recipe's jitter 0.03 and weight jitter,
    AlexNet at 227^2 under the inversion net at 256^2 (reflection pad):
    each AM_FITS entry's loss finite and falling, the render the crop and
    finite, and the seam kernels' launches exact: its two deepest decoder
    scales (LR 4 and 8, C = F = 128) fuse, so K1 = 2 x (steps + 1) and
    K2, K3, K4 = 2 x steps."""
    for layer, idx in AM_FITS:
        for cd in ("bfloat16", None):
            spec = am_spec(layer, idx, cd, dev)
            want = path_launches(spec, MAIN_STEPS)
            seams = {k: want[k] for k in ("fwd", "dgrad", "wgrad", "s2d_pack")}
            if seams != {"fwd": 2 * (MAIN_STEPS + 1), "dgrad": 2 * MAIN_STEPS,
                         "wgrad": 2 * MAIN_STEPS, "s2d_pack": 2 * MAIN_STEPS}:
                raise RuntimeError(f"the AM net should fuse two seams: {want}")
            run_fit(spec, dev, card, "am", f"alexnet {layer}[{idx}] {spec.name} lr "
                    f"{spec.cfg.lr} {cd or 'float32'}", want, None)


def phase_cli(dev: torch.device, card: str) -> None:
    """[cli] `dip_tpu_torch.cli.main(["fit", "--task", "activation_max",
    ...])` in this process on the card (its default device; no image, no
    Pillow): it returns 0, prints MAIN_STEPS / 10 finite, falling loss
    lines, and launches what the same spec implies. Then `eval-sr --fleet`
    on the [fleet] images over every CUDA device: it returns 0 and prints
    each image's finite score and the mean."""
    import io
    import re

    from dip_tpu_torch.cli.main import main as cli

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli(["fit", "--task", "activation_max", "--num-iter", str(MAIN_STEPS),
                  "--log-every", "10"])
    delta = launch_counts()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[cli] {line}")
    losses = [float(v) for v in re.findall(r"iter\s+\d+\s+loss (\S+)", text)]
    want = path_launches(am_spec("conv4", 2, None, dev), MAIN_STEPS)
    log(f"[cli] rc {rc} | losses {losses} | peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB | launches {delta} | card {card}")
    if rc != 0 or len(losses) != MAIN_STEPS // 10 or not np.isfinite(losses).all():
        raise RuntimeError(f"the CLI fit did not end well: rc {rc}, losses {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the CLI fit's loss did not fall: {losses}")
    if delta != want:
        raise RuntimeError(f"launch counts {delta} != {want}")

    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli(["eval-sr", "--dir", str(fleet_images()), "--factor", "4", "--num-iter",
                  str(FLEET_STEPS), "--fleet"])
    delta = launch_counts()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[cli] {line}")
    scores = {m[0]: float(m[1]) for m in re.findall(r"^(\w+): (\S+) dB$", text, re.M)}
    log(f"[cli] eval-sr --fleet: rc {rc} | scores {scores} | launches {delta} | card {card}")
    if rc != 0 or sorted(scores) != sorted(FLEET_IMAGES) or not np.isfinite(
            list(scores.values())).all() or "mean PSNR-Y:" not in text:
        raise RuntimeError(f"eval-sr --fleet did not end well: rc {rc}, scores {scores}")
    if delta["fwd"] == 0 or delta["downsample"] == 0:
        raise RuntimeError(f"eval-sr --fleet ran no kernel: {delta}")


EXAMPLE_STEPS = 20  # [examples]: iterations of each example
EXAMPLE_BATCH, EXAMPLE_SIZE = 8, 256  # fit_batch's --batch and --size
# [recipes]: the recipes without a skip net (no seam kernel) and those
# with the SR loss (the downsample kernel too)
ZOO_RECIPES = ("library_unet", "library_resnet")
SR_RECIPES = ("zebra4", "zebra8", "prior_effect")
TRAIN_ACC = 0.9  # [train]: the trained AlexNet's least held-out accuracy


def standins() -> Path:
    """The reference data's stand-ins (write_reference_standins) under
    build/, made anew, with Pillow's format of each file logged; the
    absolute path of their root."""
    root = (Path("build") / "reference_standins").resolve()
    formats = write_reference_standins(root)
    log(f"[standins] {root}: " + ", ".join(f"{k} {v}" for k, v in formats.items()))
    return root


def _inside(path: Path) -> contextlib.chdir:
    """`path`, made anew and empty, as the working directory."""
    import shutil

    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return contextlib.chdir(path)


def _call(prefix: str, fn, *args, **kw) -> tuple[object, str]:
    """fn(*args, **kw) with its standard output captured and logged line by
    line under `prefix`; returns (its result, the output)."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kw), buf.getvalue()
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[{prefix}] {line}")


def _numbers(lines: list[str]) -> list[float]:
    """The decimal numbers in `lines` (the values; an iteration count has
    no point), nan and inf included."""
    import re

    return [float(v) for line in lines for v in re.findall(r"-?(?:\d+\.\d+|nan|inf)", line)]


def example_runs(root: Path) -> list[tuple[str, list[str], list[str]]]:
    """(example, argv, the images it writes) of [examples], on the
    stand-ins under `root`, EXAMPLE_STEPS iterations each, on the default
    device."""
    img = {k: str(root / k) for k in [*STANDINS, *STANDIN_MASKS]}
    n = ["--num-iter", str(EXAMPLE_STEPS)]
    return [
        ("denoising", ["--image", img["denoising/F16_GT.png"], *n],
         ["denoised.png", "denoised_ema.png"]),
        ("inpainting", ["--image", img["inpainting/kate.png"], "--mask",
                        img["inpainting/kate_mask.png"], *n], ["inpainted.png"]),
        ("super_resolution", ["--image", img["sr/zebra_GT.png"], *n], ["sr.png"]),
        ("restoration", ["--image", img["restoration/barbara.png"], *n],
         ["restored.png", "observed.png"]),
        ("flash_no_flash", ["--flash", img["flash_no_flash/cave01_00_flash.jpg"], "--noflash",
                            img["flash_no_flash/cave01_01_noflash.jpg"], *n],
         ["flash_no_flash.png"]),
        ("sr_prior_effect", ["--image", img["sr/zebra_GT.png"], *n],
         ["prior_effect_skip.png", "prior_effect_identity.png"]),
        ("feature_inversion", ["--image", img["denoising/F16_GT.png"], *n], ["inverted.png"]),
        ("activation_maximization", n, ["activation_max.png"]),
        ("fit_batch", ["--batch", str(EXAMPLE_BATCH), "--size", str(EXAMPLE_SIZE), *n],
         [f"batch_out_{i}.png" for i in range(EXAMPLE_BATCH)]),
    ]


def example_launches(name: str, specs: list) -> dict:
    """What example `name` launches in EXAMPLE_STEPS iterations, given the
    specs it handed run_task: path_launches of each (an SR fit with two
    downsample launches a step); fit_batch's BatchEngine one fit's."""
    if name == "fit_batch":
        return path_launches(_flagship_spec(None, EXAMPLE_STEPS, 100, EXAMPLE_SIZE),
                             EXAMPLE_STEPS)
    want: dict = {}
    for spec in specs:
        sr = spec.name.startswith("sr/")
        for k, v in path_launches(spec, EXAMPLE_STEPS, 2 if sr else 0).items():
            want[k] = want.get(k, 0) + v
    return want


def phase_examples(dev: torch.device, card: str, root: Path) -> None:
    """[examples] Each of the nine examples' main(argv) in this process on
    its default device, on the stand-ins at full size, EXAMPLE_STEPS
    iterations (fit_batch: EXAMPLE_BATCH fits at EXAMPLE_SIZE^2; feature
    inversion and activation maximization on seeded random weights), each
    in an empty directory under build/examples: it returns 0, prints
    finite loss (or PSNR) lines, writes its images, and launches what its
    fits imply (example_launches), counters set to 0 just before and read
    just after it."""
    import importlib

    from PIL import Image

    t_phase = time.perf_counter()
    for name, argv, files in example_runs(root):
        mod = importlib.import_module(f"dip_tpu_torch.examples.{name}")
        specs: list = []
        real = getattr(mod, "run_task", None)
        if real is not None:
            def record(spec, *a, _real=real, **kw):
                specs.append(spec)
                return _real(spec, *a, **kw)

            mod.run_task = record
        reset_counts()
        t0 = time.perf_counter()
        try:
            with _inside(Path("build") / "examples" / name):
                rc, text = _call(f"examples {name}", mod.main, argv)
                delta = launch_counts()
                sizes = {f: Image.open(f).size for f in files if Path(f).exists()}
        finally:
            if real is not None:
                mod.run_task = real
        wall = time.perf_counter() - t0
        want = example_launches(name, specs)
        lines = [line for line in text.splitlines() if line.startswith("iter") or "PSNR-Y" in line]
        values = _numbers(lines)
        log(f"[examples] {name}: rc {rc} | {wall:.1f} s | {len(lines)} loss lines, "
            f"{len(values)} values | wrote {sizes} | launches {delta} | card {card}")
        if rc != 0 or not values or not np.isfinite(values).all():
            raise RuntimeError(f"example {name} did not end well: rc {rc}, {lines}")
        if len(sizes) != len(files):
            raise RuntimeError(f"example {name} wrote {sorted(sizes)}, not {files}")
        if delta != want:
            raise RuntimeError(f"example {name}: launch counts {delta} != {want}")
        if name == "denoising" and not all(delta[k] for k in ("fwd", "dgrad", "wgrad",
                                                              "s2d_pack")):
            raise RuntimeError(f"the denoising example ran no seam kernel: {delta}")
    log(f"[examples] phase wall {time.perf_counter() - t_phase:.1f} s | card {card}")


def _finite_record(rec: dict) -> bool:
    return all(np.isfinite(v) for v in rec.values()
               if isinstance(v, (int, float)) and not isinstance(v, bool))


def phase_recipes(dev: torch.device, card: str, root: Path) -> None:
    """[recipes] `reproduce --quick` (20 iterations of each of the 13
    recipes) in bf16, then in f32, on the stand-ins under `root` (as
    $DIP_REFERENCE_DATA), records to build/recipes: it returns 0, every
    record is finite, each recipe on a skip net launched K1-K4 and the SR
    ones K7 (counters set to 0 just before each recipe and read just after
    it). Then `reproduce --quick-gate` in f32 and then in bf16 (f16, kate
    and zebra4 at 1000, 1500 and 1000 iterations): every bf16 best within
    GATE_DELTA_DB of its f32 best. The gate's PSNR floors were set on the
    reference's photographs: each is printed beside its reading and held
    only by the tool (which exits 3 when one fails)."""
    import os
    import shutil
    from unittest import mock

    from dip_tpu_torch.tools import reproduce as rp

    t_phase = time.perf_counter()
    out = Path("build") / "recipes"
    shutil.rmtree(out, ignore_errors=True)
    run_recipe = rp.run_recipe
    runs: dict = {}

    def counted(r, name, *a, **kw):
        reset_counts()
        rec = run_recipe(r, name, *a, **kw)
        runs[(r.compute_dtype, name, rec["iters"])] = (rec, launch_counts())
        return rec

    rp.run_recipe = counted
    try:
        with mock.patch.dict(os.environ, {"DIP_REFERENCE_DATA": str(root)}):
            for cd in ("bfloat16", "float32"):
                rc, _ = _call("recipes", rp.main, ["--quick", "--compute-dtype", cd],
                              outdir=str(out))
                if rc != 0:
                    raise RuntimeError(f"reproduce --quick --compute-dtype {cd}: rc {rc}")
            t_quick = time.perf_counter() - t_phase
            for cd in ("float32", "bfloat16"):
                rc, _ = _call("recipes", rp.main, ["--quick-gate", "--compute-dtype", cd],
                              outdir=str(out))
                if rc not in (0, 3):  # 3: a floor or the budget failed, held below
                    raise RuntimeError(f"reproduce --quick-gate --compute-dtype {cd}: rc {rc}")
    finally:
        rp.run_recipe = run_recipe
    for (cd, name, iters), (rec, delta) in runs.items():
        log(f"[recipes] {name} {cd} {iters} iters: {rec['it_per_s']} it/s, {rec['seconds']} s "
            f"| " + ", ".join(f"{k} {v}" for k, v in rec.items() if "psnr" in k or "loss" in k
                              or k == "prior_effect_db")
            + f" | launches {delta} | card {card}")
        if not _finite_record(rec):
            raise RuntimeError(f"recipe {name} {cd}: a record is not finite: {rec}")
        seams = [delta[k] for k in ("fwd", "dgrad", "wgrad", "s2d_pack")]
        if name not in ZOO_RECIPES and not all(seams):
            raise RuntimeError(f"recipe {name} {cd} ran no seam kernel: {delta}")
        if name in SR_RECIPES and not delta["downsample"]:
            raise RuntimeError(f"recipe {name} {cd} ran no downsample kernel: {delta}")
    bad = []
    for name, (iters, key, floor) in rp.QUICK_GATE.items():
        f32 = runs[("float32", name, iters)][0]
        bf16 = runs[("bfloat16", name, iters)][0]
        delta_db = bf16.get("delta_vs_f32_db")
        log(f"[recipes] gate {name} {key}_best: bf16 {bf16[f'{key}_best']} f32 "
            f"{f32[f'{key}_best']} delta {delta_db} dB (budget -{rp.GATE_DELTA_DB}) | floor "
            f"{floor} (the reference's photos; not held on stand-ins) | card {card}")
        if delta_db is None or rp.gate_verdict(bf16[f"{key}_best"], floor, delta_db,
                                               "bfloat16")[1]:
            bad.append(name)
    wall = time.perf_counter() - t_phase
    log(f"[recipes] phase wall {wall:.1f} s (--quick bf16 + f32 {t_quick:.1f} s, gate "
        f"{wall - t_quick:.1f} s) | card {card}")
    if bad:
        raise RuntimeError(f"bf16 over the f32 budget of {rp.GATE_DELTA_DB} dB: {bad}")


def phase_train(dev: torch.device, card: str) -> None:
    """[train] `train_backbone --quick` on the default device under
    deterministic cuDNN (its seeds are fixed: the init's CPU generator and
    numpy's batches), so that every run reads the same: AlexNet trained 400
    steps at batch 16, exported, then feature inversion of fc6 and
    activation maximization of fc8 class 3, 60 iterations each, records to
    build/train: it returns 0, the held-out accuracy is at least
    TRAIN_ACC, the .pth reloads through pretrained/convert.py bit for bit
    the trained state (recorded at the export), and the FI loss and the AM
    objective fall. The AM closed loop is printed, not held."""
    import json as _json
    import shutil

    from dip_tpu_torch.pretrained.convert import load_torch_weights
    from dip_tpu_torch.tools import train_backbone as tb

    t0 = time.perf_counter()
    out = Path("build") / "train"
    shutil.rmtree(out, ignore_errors=True)
    export = tb.export_torch
    kept: dict = {}

    def keep(model, path):
        kept.update(path=path, state={k: v.detach().cpu().clone()
                                      for k, v in model.state_dict().items()})
        export(model, path)

    tb.export_torch = keep
    try:
        with _deterministic_cudnn():
            rc, _ = _call("train", tb.main, ["--quick"], outdir=str(out))
    finally:
        tb.export_torch = export
    fi, am = [_json.loads(line) for line in (out / "reproduce.jsonl").open()]
    converted = load_torch_weights(kept["path"])
    same = all(torch.equal(converted[k.split(".")[0]][k.split(".")[1]], v)
               for k, v in kept["state"].items())
    log(f"[train] rc {rc} | held-out accuracy {fi['backbone_test_acc']} (limit {TRAIN_ACC}) | "
        f".pth through convert.py bitwise the trained state: {same} ({len(kept['state'])} "
        f"tensors) | FI fc6 loss {fi['fi_loss_first']} -> {fi['fi_loss_final']} | AM fc8[3] "
        f"objective {am['am_loss_first']} -> {am['am_loss_final']} | closed loop argmax "
        f"{am['am_argmax']} (target {am['am_target']}) margin {am['am_margin']} gain "
        f"{am['am_logit_gain']} | {time.perf_counter() - t0:.1f} s | card {card}")
    if rc != 0 or fi["backbone_test_acc"] < TRAIN_ACC:
        raise RuntimeError(f"train_backbone: rc {rc}, accuracy {fi['backbone_test_acc']}")
    if not same or len(converted) != 8:
        raise RuntimeError("the exported .pth does not reload as the trained state")
    if not fi["fi_loss_final"] < fi["fi_loss_first"]:
        raise RuntimeError(f"feature inversion's loss did not fall: {fi}")
    if not am["am_loss_final"] < am["am_loss_first"]:
        raise RuntimeError(f"activation maximization's objective did not fall: {am}")


def _entry(name: str, src_rep: tuple[str, str], launches: int, stats: dict) -> dict:
    return {"name": name, "route": "cuda", "source": src_rep[0], "replaces": src_rep[1],
            "launches": launches, "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
            "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
            "bound_by": stats["bound_by"], "library_ms": stats["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dip_tpu_torch.fit.engine import disable_tf32

    dev = torch.device("cuda", 0)
    disable_tf32()
    card = phase_device()
    phase_build()
    stats = phase_kernel_parity(dev)
    fits = phase_fit_axis_parity(dev)
    down = phase_downsample_parity(dev)
    s2d = phase_s2d_parity(dev)
    wgrad = phase_wgrad_parity(dev)
    wgrad_fits = phase_wgrad_fit_axis_parity(dev)
    down_rows = phase_downsample_rows_parity(dev)
    phase_small_reference(dev)
    phase_zoo_small_reference(dev)
    launches, b1_ips = phase_main_path(dev, card)
    sr_launches = phase_sr_path(dev, card)
    masked_launches = phase_masked_paths(dev, card)
    phase_zoo_paths(dev, card)
    phase_steps_without_sync(dev)
    phase_graph(dev, card)
    b8_ips = phase_queue(dev, card, b1_ips)
    batch_launches, batch_f32_wgrad = phase_batch(dev, card, b8_ips)
    t0 = time.perf_counter()
    _, lanczos_launches = phase_spatial(dev, card)
    log(f"[spatial]: {time.perf_counter() - t0:.1f} s | card {card}")
    phase_fleet(dev, card)
    phase_flash(dev, card)
    phase_checkpoint(dev, card)
    phase_lbfgs(dev, card)
    phase_backbones(dev)
    phase_fi(dev, card)
    phase_am(dev, card)
    phase_cli(dev, card)
    t0 = time.perf_counter()
    root = standins()
    phase_examples(dev, card, root)
    phase_recipes(dev, card, root)
    phase_train(dev, card)
    log(f"[examples] + [recipes] + [train]: {time.perf_counter() - t0:.1f} s | card {card}")
    # each kernel's launches come from the main path that runs it: the
    # flagship fit for the seam's fwd, dgrad and wgrad and the s2d pack,
    # the SR fits for the carry-in forward and the downsample, the
    # inpainting 'kate' bf16 fit for the weight gradients
    kernels = [_entry(f"up_conv_{k}", src_rep,
                      (sr_launches if k == "fwd_carry" else launches)[k], stats[k])
               for k, src_rep in KERNELS.items()]
    # the fit axis (BatchEngine): launches from the [batch] fits (K1c's from
    # its 64^2 fits with the carry-in), figures at B = 2 on the top seam
    for k, src_rep in KERNELS.items():
        entry = _entry(f"up_conv_{k} (fit axis)", src_rep, batch_launches[k], fits[k])
        entry["shapes"] = fits[k]["shapes"]
        kernels.append(entry)
    entry = _entry("downsample_fused", DOWNSAMPLE, sr_launches["downsample"], down)
    entry["shapes"] = down["shapes"]
    kernels.append(entry)
    # its row form (row pad 0, the block's halo rows gathered): launches from
    # the [spatial] Skip with the lanczos2 post-down, figures at (1,512,512,128)
    entry = _entry("downsample_fused (row form)", DOWNSAMPLE, lanczos_launches["downsample"],
                   down_rows)
    entry["shape"] = down_rows["shape"]
    kernels.append(entry)
    kernels.append(_entry("s2d_pack", S2D, launches["s2d_pack"], s2d))
    for k, src_rep in WGRAD.items():
        entry = _entry(k, src_rep, masked_launches[k], wgrad[k])
        entry["sources"] = {str(d)[6:]: src for d, src in WGRAD_SOURCES.items()}
        entry["f32"] = wgrad[k]["f32"]
        kernels.append(entry)
    # the weight gradients' fit axis: launches from the [batch] 'kate' fits
    # with conv_wgrad='all', figures at B = 8 fits of the top 'kate' shape.
    # The row's launches are the bf16 fit-axis launches; the f32 fits' own
    # fit-axis launches are under "f32" with its times
    for k, src_rep in WGRAD.items():
        entry = _entry(f"{k} (fit axis)", src_rep, batch_launches[k] - batch_f32_wgrad[k],
                       wgrad_fits[k])
        entry["sources"] = {str(d)[6:]: src for d, src in WGRAD_SOURCES.items()}
        entry["f32"] = dict(wgrad_fits[k]["f32"], launches=batch_f32_wgrad[k])
        entry["fits"] = BATCH_FITS
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
